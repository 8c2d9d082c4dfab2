#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (clstm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's serving path — the path `clstmocr` runs — once at the full
width of the flagship `bidi` model (48 inputs, nhidden 100, 96 classes):

  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles the CUDA kernels from clstm_tpu_torch/csrc with nvcc;
  3. kernel against plain: the bidirectional LSTM inference kernel against
     its plain PyTorch loop on the card at B=256, T=1024, D=48, H=100
     (weights uniform ±0.3 from a numpy seed), for two length sets, plus a
     few odd shapes; padded frames must be exactly 0;
  4. timing: kernel and plain ms per batch at that shape;
  5. main path: a seeded bidi net is saved as .clstm, loaded through
     CLSTMOCR.load, and 64 synthetic line images go through
     cli.clstmocr.predict_pages and write_outputs; the kernel's launch count
     must rise, and the per-frame ids must agree with the plain path run on
     the same prepared batches.

Any failure raises, so the script exits non-zero. The last line is
{"ok": true, "device": {...}}; the line before it lists the kernels.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from clstm_tpu_torch.cli.clstmocr import predict_pages, write_outputs
from clstm_tpu_torch.io.proto import save_net
from clstm_tpu_torch.models.codec import Codec
from clstm_tpu_torch.models.hl import CLSTMOCR
from clstm_tpu_torch.models.prefab import make_net_init
from clstm_tpu_torch.ops import _build
from clstm_tpu_torch.ops.bidi_lstm_kernel import bidi_lstm_infer
from clstm_tpu_torch.ops.ctc import greedy_frames
from clstm_tpu_torch.ops.lstm import bidi_lstm_apply
from clstm_tpu_torch.utils.config import torch_device

B, T, D, H, C = 256, 1024, 48, 100, 96   # bench profile (bench.py:611-651)
TRUE_T = 900
# max |kernel - plain| over y. Both are f32 with the same operation per
# element, but the kernel sums [x|1]·W_in + h·Wh as one serial FMA chain
# while the plain loop adds a batched einsum to a cuBLAS bmm, and expf/tanhf
# differ from PyTorch's by an ulp or two. Each step's z differs by ~1e-6;
# the LSTM state is bounded (|h| < 1) and the forget gate contracts, so the
# difference stays near that level over 1024 steps instead of compounding.
# 1e-4 leaves two orders of margin over that and still catches any wrong
# gate, index or mask, which move y by 1e-2 or more.
TOL = 1e-4
# Share of valid frames whose argmax id must match the plain path. Ids
# differ only where the top two logits lie within ~1e-5 of each other.
ID_AGREE_MIN = 0.999
N_LINES = 64


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def uniform(rng, shape, lo, hi, dev):
    return torch.from_numpy(
        rng.uniform(lo, hi, shape).astype(np.float32)).to(dev)


def lstm_params(rng, d, h, dev):
    return {"Wx": uniform(rng, (d, 4 * h), -0.3, 0.3, dev),
            "Wh": uniform(rng, (h, 4 * h), -0.3, 0.3, dev),
            "b": uniform(rng, (4 * h,), -0.3, 0.3, dev)}


def compare(pf, pr, x, lengths):
    """Kernel vs plain on the same inputs -> max |Δy|; raises if a padded
    frame of the kernel's output is not exactly 0 or the error exceeds TOL."""
    with torch.no_grad():
        yk = bidi_lstm_infer(pf, pr, x, lengths)
        yp = bidi_lstm_apply(pf, pr, x, lengths)
    torch.cuda.synchronize()
    Bx, Tx, _ = x.shape
    L = (torch.full((Bx,), Tx, device=x.device) if lengths is None
         else lengths.long())
    pad = torch.arange(Tx, device=x.device)[None, :] >= L[:, None]
    if not bool((yk[pad] == 0.0).all()):
        raise AssertionError("kernel output is not exactly 0 on padded frames")
    if not bool(torch.isfinite(yk).all()):
        raise AssertionError("kernel output is not finite")
    err = float((yk - yp).abs().max())
    if not err <= TOL:
        raise AssertionError(f"kernel vs plain max|dy| {err:.3e} > {TOL:.0e}")
    return err


def time_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def synth_line(rng) -> np.ndarray:
    """A line image, ink strokes on white, in [0, 1]."""
    h = rng.randint(30, 61)
    w = rng.randint(60, 700)
    img = np.ones((h, w), np.float32)
    top, base = int(h * 0.3), int(h * 0.72)
    col = rng.randint(4, 12)
    while col < w - 12:
        cw = rng.randint(3, 10)
        kind = rng.randint(4)
        if kind == 0:        # vertical stem, sometimes an ascender
            img[top - rng.randint(0, top // 2 + 1):base, col:col + 2] = 0.05
        elif kind == 1:      # bowl
            img[top:top + 2, col:col + cw] = 0.1
            img[base - 2:base, col:col + cw] = 0.1
            img[top:base, col:col + 2] = 0.1
            img[top:base, col + cw - 2:col + cw] = 0.1
        elif kind == 2:      # solid blob
            img[top + 2:base - 2, col:col + cw] = 0.2
        # kind 3: a space
        col += cw + rng.randint(2, 7)
    img += rng.normal(0, 0.02, img.shape).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def main() -> int:
    # 1. Device.
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs only on a card")
    dev = torch_device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | devices {torch.cuda.device_count()}")

    # 2. Build.
    t0 = time.perf_counter()
    so = _build.build()
    _build.load_library()
    log(f"[build] {so.name} in {time.perf_counter() - t0:.2f} s")

    # 3. Kernel against plain at the bench profile, then odd shapes.
    rng = np.random.RandomState(0)
    pf, pr = lstm_params(rng, D, H, dev), lstm_params(rng, D, H, dev)
    x = uniform(rng, (B, T, D), 0.0, 1.0, dev)
    mixed = rng.randint(0, T + 1, B)
    mixed[0], mixed[1] = 0, T
    len_sets = {"all900": np.full(B, TRUE_T), "mixed": mixed}
    lens = {k: torch.from_numpy(v.astype(np.int32)).to(dev)
            for k, v in len_sets.items()}
    errs = {k: compare(pf, pr, x, v) for k, v in lens.items()}
    for k, e in errs.items():
        log(f"[kernel] B={B} T={T} D={D} H={H} lengths={k}: "
            f"max|dy| {e:.3e} (tol {TOL:.0e}), padded frames exactly 0")
    for (b, t, d, h) in ((5, 37, 3, 7), (3, 20, 49, 300), (9, 64, 48, 100)):
        spf, spr = lstm_params(rng, d, h, dev), lstm_params(rng, d, h, dev)
        sx = uniform(rng, (b, t, d), -1.0, 1.0, dev)
        sl = torch.from_numpy(rng.randint(0, t + 1, b).astype(np.int32)).to(dev)
        e1 = compare(spf, spr, sx, sl)
        e2 = compare(spf, spr, sx, None)
        log(f"[kernel] B={b} T={t} D={d} H={h}: max|dy| {e1:.3e} mixed "
            f"lengths, {e2:.3e} no lengths")

    # 4. Timing at the bench profile.
    L900 = lens["all900"]
    with torch.no_grad():
        k_ms = time_ms(lambda: bidi_lstm_infer(pf, pr, x, L900), 20)
        p_ms = time_ms(lambda: bidi_lstm_apply(pf, pr, x, L900), 3)
    log(f"[timing] {card} | bidi LSTM fwd B={B} T={T} D={D} H={H} "
        f"len={TRUE_T}: kernel {k_ms:.3f} ms/batch ({B / k_ms * 1e3:.0f} "
        f"lines/s), plain {p_ms:.3f} ms/batch ({B / p_ms * 1e3:.0f} lines/s)")

    # 5. Main path: .clstm save/load, clstmocr's predict_pages and outputs.
    gen = torch.Generator().manual_seed(0)
    spec, net = make_net_init("bidi", {"ninput": D, "nhidden": H,
                                       "noutput": C, "initial": 0.3}, gen)
    codec = Codec([0] + list(range(33, 33 + C - 1)))
    images = [synth_line(rng) for _ in range(N_LINES)]
    with tempfile.TemporaryDirectory() as tmp:
        model = os.path.join(tmp, "bidi.clstm")
        save_net(model, net, codec)
        ocr = CLSTMOCR(device="cuda")
        ocr.load(model)
        ocr.target_height = ocr.spec.iget("ninput", ocr.target_height)
        batches = []
        predict_batch = ocr.predict_batch

        def recording(xb, lb):
            ids, vals = predict_batch(xb, lb)
            batches.append((xb, lb, ids, vals))
            return ids, vals

        ocr.predict_batch = recording
        names = [os.path.join(tmp, f"line{i:03d}.png") for i in range(N_LINES)]
        bidi_lstm_infer.launches = 0
        t0 = time.perf_counter()
        results = predict_pages(ocr, images, device_preprocess=0)
        write_outputs(ocr, names, images, results, output="sidecar")
        torch.cuda.synchronize()
        e2e_s = time.perf_counter() - t0
        launches = bidi_lstm_infer.launches
        texts = [open(n[:-4] + ".txt", encoding="utf-8").read() for n in names]
    if launches < 1 or launches != len(batches):
        raise AssertionError(f"main path launched the kernel {launches} times "
                             f"for {len(batches)} batches")
    if len(batches) < 2:
        raise AssertionError("synthetic lines fell into fewer than 2 buckets")
    if sorted(results) != list(range(N_LINES)) or len(texts) != N_LINES:
        raise AssertionError("clstmocr did not answer every line")
    agree = total = 0
    for xb, lb, ids, vals in batches:
        if not (np.isfinite(vals).all() and ids.min() >= 0 and ids.max() < C):
            raise AssertionError("main path produced invalid frames")
        xt = torch.from_numpy(xb).to(dev)
        lt = torch.from_numpy(lb).to(dev)
        with torch.no_grad():
            par, soft = ocr.net.sub
            y = bidi_lstm_apply(par.sub[0].weights(),
                                par.sub[1].sub[0].weights(), xt, lt)
            pids, _ = greedy_frames(soft(y, lt))
        pids = pids.cpu().numpy()
        for r, L in enumerate(lb):
            agree += int((pids[r, :L] == ids[r, :L]).sum())
            total += int(L)
    share = agree / total
    log(f"[main] {N_LINES} lines in {len(batches)} width buckets "
        f"({', '.join(str(b[0].shape[1]) for b in batches)} frames), "
        f"{launches} kernel launches, {e2e_s:.3f} s end to end "
        f"({N_LINES / e2e_s:.1f} lines/s incl. host normalization); "
        f"frame ids agree with plain on {share:.6f} of {total} valid frames "
        f"(min {ID_AGREE_MIN})")
    if share < ID_AGREE_MIN:
        raise AssertionError(f"frame-id agreement {share:.6f} < {ID_AGREE_MIN}")

    # 6. Report.
    print(card)
    print(json.dumps({"kernels": [{
        "name": "bidi_lstm_fwd",
        "route": "cuda",
        "source": "clstm_tpu_torch/csrc/bidi_lstm_fwd.cu",
        "replaces": "clstm_tpu/ops/pallas_lstm.py:197",
        "launches": launches,
        "max_abs_err": max(errs.values()),
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
