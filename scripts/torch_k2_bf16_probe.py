#!/usr/bin/env python3
"""K2's bf16 reduction (csrc/bidi_lstm_bwd.cu,
clstm_lstm_bwd_reduce_bf16) on the card, alone.

    python3 scripts/torch_k2_bf16_probe.py [--time] [--k2-against SRC]
                                           [--staging-turns] [--ptxas]

Checks, at chip_smoke.py's BF16_ODD and ODD_SHAPES, the filter's shape and
the three bench layers (bidi; bidi2's two layers), with mixed lengths and
with none: the reduction with the plan of ops/bidi_lstm_kernel.py::
reduce_plan and, at the small shapes, with every tile width of dW and of
dx and with one frame range and one slice per range, each held to
chip_smoke.py's bf16 rule (its distance from the float64 recipe within
BF16_FACTOR of the plain bf16 version's, max and mean), bitwise equal to a
second call, dx in x's type and exactly 0 on padded frames, for x in f32
and in bf16, with dx and without; and that the C side sizes the scratch as
the plan does.

--time: chip_smoke.k2_bf16_turns (the four shapes the port runs it at,
each in turns with the einsums on bf16 operands and, with --k2-against,
with that source's bf16 reduction; bounds, plans, device time per
kernel), and at the filter's shape and bidi's the plan's frame split in
turns with two others. --staging-turns: the staging of x and y to whole
64-column tiles in turns with the same source staging them to 8-column
multiples (bidi, bidi2's layers). --ptxas: the registers, shared memory
and spills of each kernel of the source (nvcc -Xptxas -v). Prints the
card, a line per check and time, and a JSON line of the times last. Needs
one CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from clstm_tpu_torch.ops import _build  # noqa: E402
from clstm_tpu_torch.ops import bidi_lstm_kernel as bk  # noqa: E402
from clstm_tpu_torch.ops import lstm as lstm_ops  # noqa: E402

FILTER = (256, 32, 19, 100)
BIDI = (256, 1024, 48, 100)
BIDI2_L1 = (256, 1024, 48, 200)
BIDI2_L2 = (256, 1024, 400, 200)


def log(msg: str) -> None:
    print(msg, flush=True)


def streams(rng, shape, dev, lengths):
    """Seeded x [B,T,D] f32, y [B,T,2H] and dz [B,T,2,4H] bf16 (both 0 on
    padded frames, as K1 and the chain leave them), Wx2 [2,D,4H] f32."""
    B, T, D, H = shape
    x = torch.from_numpy(rng.uniform(-1, 1, (B, T, D)).astype(np.float32))
    y = torch.from_numpy(rng.uniform(-1, 1, (B, T, 2 * H)).astype(
        np.float32))
    dz = torch.from_numpy(rng.uniform(-1, 1, (B, T, 2, 4 * H)).astype(
        np.float32)) * 0.1
    wx = torch.from_numpy(rng.uniform(-0.1, 0.1, (2, D, 4 * H)).astype(
        np.float32))
    x, y, dz, wx = (t.to(dev) for t in (x, y, dz, wx))
    if lengths is not None:
        pad = cs.padded(lengths, B, T, dev)
        y[pad] = 0.0
        dz[pad] = 0.0
    return x, y.bfloat16(), dz.bfloat16(), wx


def reduce_with(plan, x, y, dz, wx, need_dx):
    """The bf16 reduction at a given plan (bk._reduce), its scratch sized
    for the plan's slices."""
    B, T, D = x.shape
    H = y.shape[-1] // 2
    plan = plan._replace(scratch=bk.reduce_scratch(B, T, D, H, plan.tt,
                                                   plan.spr))
    return bk._reduce(plan, x, y, dz, wx, need_dx, True)


def variants(shape):
    """The plan, and at the small shapes every tile width of dW and dx,
    one frame range, and ranges of one slice."""
    B, T, D, H = shape
    p = bk.device_reduce_plan(torch.device("cuda"), *shape)
    out = {"plan": p}
    if B * T > 4096:
        return out
    S = bk.reduce_slices(B, T, p.tt)
    for w in bk.RED_WIDTHS:
        out[f"nw={w}"] = p._replace(nw=w)
        out[f"nwd={w}"] = p._replace(nwd=w)
    out["one range"] = p._replace(spr=S)
    out["one slice a range"] = p._replace(spr=1)
    return out


def check(shape, lengths, label: str) -> dict:
    """Every variant against the plain bf16 version and the float64 recipe
    -> {variant: largest (kernel, plain) distance of dW and of dx}."""
    rng = np.random.RandomState(sum(shape))
    dev = torch.device("cuda")
    B, T, D, H = shape
    x, y, dz, wx = streams(rng, shape, dev, lengths)
    L = (torch.full((B,), T, dtype=torch.int32, device=dev)
         if lengths is None else lengths)
    lib = bk._kernel("clstm_lstm_bwd_bf16_scratch")
    res = {}
    for name, plan in variants(shape).items():
        n = lib(B, T, D, H, plan.tt, plan.spr, 0)
        if n != bk.reduce_scratch(B, T, D, H, plan.tt, plan.spr):
            raise AssertionError(f"{label} {name}: the C side counts {n} "
                                 "bytes of scratch, the plan another")
        worst = {}
        for xin, need_dx in ((x, True), (x.bfloat16(), True), (x, False)):
            got = [t for t in reduce_with(plan, xin, y, dz, wx, need_dx)
                   if t is not None]
            again = [t for t in reduce_with(plan, xin, y, dz, wx, need_dx)
                     if t is not None]
            with torch.no_grad():
                p = [t for t in lstm_ops.bidi_lstm_bwd_reduce_plain(
                    xin, y, dz, wx, need_dx, xz_bf16=True) if t is not None]
                r = [t for t in lstm_ops.bidi_lstm_bwd_reduce_plain(
                    xin.double(), y, dz, wx.double(), need_dx,
                    xz_bf16=True) if t is not None]
            if need_dx:
                if got[1].dtype != xin.dtype:
                    raise AssertionError(f"{label} {name}: dx is "
                                         f"{got[1].dtype}, x {xin.dtype}")
                if xin.dtype == torch.bfloat16:
                    r[1] = r[1].bfloat16().double()
            d, _ = cs.check_streams(
                f"{label} {name} (x {xin.dtype}, dx {need_dx})", got, again,
                L, (cs.F64_FLOOR, cs.BF16_ULP)[:len(got)], p, r,
                (False, True)[:len(got)])
            for i, v in d.items():
                key = ("dW", "dx")[i]
                worst[key] = cs.dist_max(worst.get(key, v), v)
        res[name] = worst
        log(f"[check] {label} {name} ({plan.nw}, tt {plan.tt}, spr "
            f"{plan.spr}, ranges {plan.ranges}, nwd {plan.nwd}): "
            + ", ".join(f"{k} {v[0]:.2e}/{v[1]:.2e} mean {v[2]:.2e}/"
                        f"{v[3]:.2e}" for k, v in worst.items())
            + " (kernel/plain from float64); two calls bitwise equal")
    return res


def split_turns(card: str) -> dict:
    """At the filter's shape and bidi's, the plan's frame split in turns
    with others: the fewest ranges that give >= 132 blocks (two waves,
    the second nearly empty) and half the plan's ranges -> {label:
    {"plan_ms": [..], "alt_ms": [..]}}."""
    dev = torch.device("cuda")
    out = {}
    for shape in (FILTER, BIDI):
        B, T, D, H = shape
        rng = np.random.RandomState(5)
        x, y, dz, wx = streams(rng, shape, dev, None)
        p = bk.device_reduce_plan(dev, *shape)
        S = bk.reduce_slices(B, T, p.tt)
        per = p.blocks // p.ranges
        fill = -(-bk.H100_SMS // per)
        alts = {"fewest ranges with >= 132 blocks": max(1, S // fill),
                "half the ranges": -(-S // max(1, p.ranges // 2))}
        for name, spr in alts.items():
            alt = p._replace(spr=spr, ranges=-(-S // spr))
            a_t, p_t = cs.in_turns(
                lambda: reduce_with(alt, x, y, dz, wx, False),
                lambda: reduce_with(p, x, y, dz, wx, False), 20)
            label = f"B={B} T={T} D={D} H={H} {name}"
            log(f"[split] {card} | {label}: in turns alt (spr {spr}, "
                f"{alt.ranges} ranges, {per * alt.ranges} blocks) "
                f"{a_t[0]:.4f}, plan (spr {p.spr}, {p.ranges} ranges, "
                f"{p.blocks} blocks) {p_t[0]:.4f}, {p_t[1]:.4f}, alt "
                f"{a_t[1]:.4f} ms")
            out[label] = {"alt_spr": spr, "alt_ms": a_t, "plan_ms": p_t}
    return out


def staging_turns(card: str) -> dict:
    """The staging's choice in turns: the current build (x and y staged to
    whole 64-column tiles, every x and h_prev box inside its rows) against
    the same source with both staged to 8-column multiples (the tiles past
    a row's end zero-filled by TMA), at bidi's and bidi2's shapes: outputs
    bitwise equal, ms in turns, device ms per kernel -> {label: row}."""
    src = (_build.SRC_DIR / "bidi_lstm_bwd.cu").read_text()
    for old, new in (("r.Dp = (int)round_up(D + 1, 64);",
                      "r.Dp = (int)round_up(D + 1, 8);"),
                     ("r.Hp = (int)round_up(H, 64);",
                      "r.Hp = (int)round_up(H, 8);"),
                     ("r.nx = r.Dp / 64;", "r.nx = (D + 64) / 64;"),
                     ("r.nm = r.nx + r.Hp / 64;",
                      "r.nm = r.nx + (H + 63) / 64;")):
        if old not in src:
            raise RuntimeError(f"staging_turns: {old!r} not in the source")
        src = src.replace(old, new)
    dev = torch.device("cuda")
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        cu, so = os.path.join(tmp, "k2_8.cu"), os.path.join(tmp, "k2_8.so")
        with open(cu, "w") as f:
            f.write(src)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                        "-I", str(_build.SRC_DIR), "-o",
                        so, cu], check=True, capture_output=True,
                       timeout=600)
        launch = bk.launcher(ctypes.CDLL(so))
    for shape, need_dx in ((BIDI, False), (BIDI2_L1, False),
                           (BIDI2_L2, True)):
        B, T, D, H = shape
        x, y, dz, wx = streams(np.random.RandomState(9), shape, dev, None)
        if D == 2 * H:
            x = x.bfloat16()
        plan = bk.device_reduce_plan(dev, B, T, D, H, 2)

        def eight():
            # The current plan's scratch, which holds the 8-column
            # build's smaller staged copies.
            return bk._reduce(plan, x, y, dz, wx, need_dx, True,
                              launch=launch)

        def cur():
            return bk._reduce(plan, x, y, dz, wx, need_dx, True)
        a, b = eight(), cur()
        if not all(u is None or torch.equal(u, v) for u, v in zip(a, b)):
            raise AssertionError(f"{shape}: the staging variants differ")
        e_t, c_t = cs.in_turns(eight, cur, 10)
        row = {"eight_ms": e_t, "ms": c_t}
        for key, fn in (("eight_kernels_ms", eight), ("kernels_ms", cur)):
            fn()
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    fn()
                torch.cuda.synchronize()
            row[key] = {cs.kernel_name(e.key): cs.device_us(e) / 5e3
                        for e in prof.key_averages() if cs.device_us(e) > 0}
        label = f"B={B} T={T} D={D} H={H} dx {need_dx}"
        log(f"[staging] {card} | {label}: in turns 8-column {e_t[0]:.4f}, "
            f"64-column {c_t[0]:.4f}, {c_t[1]:.4f}, 8-column {e_t[1]:.4f} "
            "ms; device ms per kernel, 8-column " + ", ".join(
                f"{k} {v:.4f}" for k, v in row["eight_kernels_ms"].items())
            + "; 64-column " + ", ".join(
                f"{k} {v:.4f}" for k, v in row["kernels_ms"].items()))
        out[label] = row
        del x, y, dz, wx, scratch
    return out


def ptxas() -> None:
    """nvcc -Xptxas -v of the K2 source: each kernel's registers, shared
    memory and spills."""
    src = _build.SRC_DIR / "bidi_lstm_bwd.cu"
    with tempfile.TemporaryDirectory() as tmp:
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas",
                              "-v", "-c", "-o", os.path.join(tmp, "k2.o"),
                              str(src)], capture_output=True, text=True,
                             timeout=600)
    lines = (res.stdout + res.stderr).splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and "bf16" in ln:
            log("[ptxas] " + " | ".join(
                [ln.split("'")[1][:60]] + [m.strip() for m in
                                           lines[i + 1:i + 4]]))
    if res.returncode:
        raise RuntimeError(res.stdout + res.stderr)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--time", action="store_true")
    ap.add_argument("--k2-against", metavar="SRC")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--staging-turns", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_k2_bf16_probe: needs a CUDA card")
    card = cs.card_line()
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    _build.load_library()
    if args.ptxas:
        ptxas()
    k2_against = (cs.load_against(args.k2_against) if args.k2_against
                  else None)
    rng = np.random.RandomState(3)
    dev = torch.device("cuda")
    for shape in cs.BF16_ODD + cs.ODD_SHAPES + (FILTER, BIDI, BIDI2_L1,
                                                BIDI2_L2):
        B, T = shape[:2]
        ml = rng.randint(0, T + 1, B).astype(np.int32)
        ml[-1] = T
        check(shape, torch.from_numpy(ml).to(dev), f"{shape} mixed")
        if B * T <= 4096:
            check(shape, None, f"{shape} none")
        torch.cuda.empty_cache()
    out = {"card": card}
    if args.time:
        out["timing"] = cs.k2_bf16_turns(dev, card, k2_against, True)
        out["split"] = split_turns(card)
    if args.staging_turns:
        out["staging"] = staging_turns(card)
    print(json.dumps(out, default=str))
    return 0


if __name__ == "__main__":
    sys.exit(main())
