#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (clstm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--k2-against SRC] [--fwd-against SRC]
                          [--ctc-against SRC]

Drives the port's serving path — the path `clstmocr` runs — and its training
path — CLSTMOCR.train_batch, a CTC training step — at the full width of the
flagship `bidi` model (48 inputs, nhidden 100, 96 classes) and of the deep
`bidi2` model of BASELINE config 4 (48 inputs, nhidden 200 in both layers,
400 classes), whose second layer takes the hoisted-projection kernel K4:

  1. device: requires CUDA; prints the card's name and power limit;
  2. build: compiles the CUDA kernels from clstm_tpu_torch/csrc with nvcc;
     prints the forward kernel's plan (cluster size, rows per cluster,
     where the weights live, clusters the card holds) at each timed forward
     shape;
  3. kernel against plain: the bidirectional LSTM inference kernel against
     its plain PyTorch loop on the card at B=256, T=1024, D=48, H=100
     (weights uniform ±0.3 from a numpy seed), for two length sets, plus a
     few odd shapes; padded frames must be exactly 0 and two calls bitwise
     equal; then K3, K1 and K4 in both modes at shapes across the plan's
     edges (FWD_ODD), with mixed, all-zero and no lengths;
  4. timing: kernel and plain ms per batch at that shape, and cuDNN's
     bidirectional nn.LSTM on the same batch in turns with the kernel;
  5. main path: a seeded bidi net is saved as .clstm, loaded through
     CLSTMOCR.load, and 64 synthetic line images go through
     cli.clstmocr.predict_pages and write_outputs, with the normalization on
     the host (device_preprocess=0) and then on the card (1, the default):
     each width bucket must launch K3 once, the per-frame ids must agree
     with the plain path run on the same prepared batches, and the card's
     per-line lengths must match the same prepare run on the CPU (all but
     one line in 64, by +-1); lines/s both ways (median and range of 7
     warm passes) and the device prepare's ms a bucket inside those passes
     (its span on the card, the host's time in it, and the card's busy
     time in one such call alone); predict_batch_images(sync=False) must
     return behind a long
     device sleep, that is without waiting for the card;
  6. K1 (LSTM forward with state) against its plain version at the bench
     profile (lengths all 900 and mixed 0..1024) and the odd shapes of 3:
     y, gates and cell; every stream exactly 0 on padded frames;
  7. K2 (backward chain and reduction) against their plain versions on the
     same inputs with a seeded cotangent, with and without dx; the
     reduction's dW and dx against float64 (catches one-pass TF32); two
     calls of each bitwise equal; the chain alone at H=700 and H=2048;
  8. K5, K6 and K6b (CTC alignment DP) against their plain versions at
     B=256, T=1024, S=81, at S=512, at an odd S and at every branch of
     their plan (ops/ctc_kernel.py::ctc_dp_plan: each S of S_BUCKETS, S=1,
     1025, and the wide branch at 2049, 4097 and 14,528, K6's widest),
     mixed lengths and target
     lengths with rows of length 0; two calls bitwise equal, K5 and K6b
     carrying their state over padded frames and K6's both NEG there; the
     aligned targets of the kernel path and of the unfused recipe (second
     direction by K6b) against the plain scan recipe computed in float64,
     at T=1024 and on long lines (B=64, T=2048 and 4096, where the f32
     recipe itself may pass the alarm: logged, ROADMAP Queue 3);
  9. training path: CLSTMOCR(device="cuda").createBidi, 5 train_batch steps
     on the bench batch (B=256, T=1024, 900 true frames, 40 characters,
     lr 1e-4, momentum 0.9) against the same 5 steps composed from the plain
     versions; K1, K2, K5, K6 must be launched; then train_utf8, save and
     load with the .state.npz sidecar, and predict from the reloaded model;
 10. learning check: the toy CTC transduction of tests/test_learning.py on
     the card (bidi, nhidden 16, 4 classes, B=8, T=24, 120 steps);
 11. timing: ms per train_batch step (kernels and plain), each kernel
     against its plain version and, in turns, K1 against cuDNN's forward
     with grad enabled and K2's reduction against the plain version's
     einsum; cuDNN's backward against K2; a torch.profiler breakdown of a
     kernel step (written to chiprun_out/profile_train_step.txt);
 12. K4 (the LSTM recurrence on a hoisted input projection), both modes,
     against its plain versions at bidi2's second layer (B=256, T=1024,
     D=400, H=200; lengths all 900 and mixed 0..1024) and odd shapes; the
     hoisted product against float64; K2 at that shape, with dx;
 13. timing at that shape: K4 (product and recurrence, and each alone)
     against K3 and K1, which compute the projection inside the recurrence,
     in turns; K2 there, its reduction in turns with the two einsums, and
     cuDNN's nn.LSTM at D=400 in turns with product + K4;
 14. bidi2 serving: a seeded config-4 net (createBidi(kind="bidi2")) saved
     as .clstm and run through predict_pages both ways; every width bucket
     must launch K3 (layer 1) and K4 (layer 2), frame ids and lengths as
     in 5;
 15. bidi2 training: 5 train_batch steps at the config-4 bench profile
     (bench.py:538-600: B=256, T=1024, 900 frames, S=81, 400 classes)
     against the plain steps, each step launching K1, K4, K2 on both layers,
     K5 and K6; ms per step, K2's reduction at layer 1 (D=48, H=200) in
     turns with the einsum, and a torch.profiler breakdown
     (chiprun_out/profile_train_step_bidi2.txt).
 16. the u8 pixel table (ops/preprocess.py U8_TABLE) on the card, bit for
     bit against numpy's k/255, and how many of the 256 values the card's
     ``x / 255.0`` gets wrong (a multiply by the reciprocal); the uint8 and
     float32 uploads must prepare to the same bits;
 17. clstmocrtrain: 1,024 synthetic training and 128 test lines (written as
     PNGs and read through the CLI's main when pillow is installed; else the
     CLI's loop over a cache built from the raw arrays, and a note that PNG
     decoding was not exercised), at full bidi width, device_preprocess=1,
     batch_size 32, automatic steps_per_dispatch, ntrain 4096, test_every
     and save_every 2048: K1, K2, K5 and K6 must be launched and a TESTERR
     line printed; the saved model must reload and predict the same ids;
     one batch of a block (B=32, its group's T bucket and merged S) through
     5 train_batch steps from the saved model against the same 5 steps
     composed from the plain versions, within the limits of 9; a
     k=4 block must equal 4 single steps bitwise, and the next must be
     enqueued behind a long device sleep without waiting for it; lines/s
     end to end and the card's idle share in the loop (torch.profiler,
     kernel activity).

With --k2-against SRC, every timed K2 shape also times the K2 built from
SRC in turns with the current one (against, current, current, against);
with --fwd-against SRC, the same for the forward kernel at K3 and K1
(bidi), K1 (bidi2 layer 1), K4 in both modes (bidi2 layer 2), and K3 with
the projection inside at D=400 and D=255 (H=200, the L2 plan); with
--ctc-against SRC, the same for K5, K6 and K6b at the bench shape, and
the bidi and bidi2 train_batch steps with that build's K5 and K6 in turns
with the current ones.

Any failure raises, so the script exits non-zero. The last line is
{"ok": true, "device": {...}}; the line before it lists the kernels, each
with bound_ms (the least time the card could take: the larger of its
matrix flop at 3xTF32's 165 TFLOP/s and its bytes at 3.35 TB/s, bound_by
naming which) and library_ms (a library call computing the same function,
timed in turns with the kernel, or null; K5, K6 and K6b also carry
per_frame_us, their time over the longest row's frames, and K6
ctc_loss_ms, F.ctc_loss forward and backward at the same B, T and S: a
yardstick of scale only, since it computes the CTC loss and not clstm's
lattice); the line before that the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from clstm_tpu_torch.cli import clstmocrtrain
from clstm_tpu_torch.cli.clstmocr import predict_pages, write_outputs
from clstm_tpu_torch.data.dataset import T_BUCKETS_FINE
from clstm_tpu_torch.data.device_cache import DeviceDataset
from clstm_tpu_torch.io.png import write_png
from clstm_tpu_torch.io.proto import save_net
from clstm_tpu_torch.models.codec import Codec
from clstm_tpu_torch.models.hl import CLSTMOCR
from clstm_tpu_torch.models.prefab import make_net_init
from clstm_tpu_torch.models.spec import apply_net
from clstm_tpu_torch.ops import _build
from clstm_tpu_torch.ops import bidi_lstm_kernel as bk
from clstm_tpu_torch.ops import ctc as ctc_ops
from clstm_tpu_torch.ops import lstm as lstm_ops
from clstm_tpu_torch.ops.bidi_lstm_kernel import (
    bidi_lstm_bwd_chain, bidi_lstm_bwd_reduce, bidi_lstm_fwd_state,
    bidi_lstm_fwd_state_xz, bidi_lstm_infer, bidi_lstm_infer_xz)
from clstm_tpu_torch.ops.ctc import decode_frames, greedy_frames, mktargets_ids
from clstm_tpu_torch.data.dataset import S_BUCKETS
from clstm_tpu_torch.ops import ctc_kernel as ck
from clstm_tpu_torch.ops.ctc_kernel import ctc_backward, ctc_both, ctc_forward
from clstm_tpu_torch.ops import preprocess
from clstm_tpu_torch.ops.lstm import bidi_lstm_apply
from clstm_tpu_torch.ops.seq import length_mask
from clstm_tpu_torch.train import (
    TrainState, gather_batch, make_train_step, sgd_update)
from clstm_tpu_torch.utils.config import to_device, torch_device

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
# clstmocr with device_preprocess=1: the card's per-line lengths against the
# same prepare run on the CPU. f32 sums in another order may move a
# knife-edge center column or ink spread by one pixel (the JAX package's
# own parity envelope, tests/test_preprocess.py), so at most one line in
# LEN_MISMATCH_LINES may differ, by one frame.
LEN_MISMATCH_LINES = 64
# Cycles of torch.cuda._sleep (~0.5 s at the H100's clock) that
# predict_batch_images(sync=False) must return behind: it returns in well
# under half the sleep only if it waited for nothing on the card.
NOSYNC_CYCLES = 10 ** 9
# clstmocr (phases 5 and 14): warm passes over the N_LINES lines, timed
# after the counted one; lines/s is their median, with their range.
E2E_PASSES = 7
# clstmocrtrain (phase 17): corpus sizes and the CLI's settings.
OCR_TRAIN, OCR_TEST = 1024, 128
OCR_ENV = {"device": "cuda", "device_preprocess": "1", "batch_size": "32",
           "steps_per_dispatch": "0", "ntrain": "4096", "test_every": "2048",
           "save_every": "2048", "report_every": "1024", "nhidden": str(H),
           "target_height": str(D), "randseed": "0", "mesh": "1"}
# K2 against plain, relative to max|plain| of each tensor. dz comes out of a
# 1024-step backward recurrence whose Dh the kernel sums by column ranges
# (the plain loop in one cuBLAS product); dW, dWh, db and dx are sums over
# ~230k frames, taken by the kernel in 3xTF32 on the tensor cores over
# fixed frame ranges plus a second pass, and by einsum in cuBLAS order. f32
# rounding of such sums stays near 1e-6 of the largest term; 1e-4 leaves
# two orders of margin and still catches a wrong gate, shift or mask (1e-2
# or more).
K2_RTOL = 1e-4
# K2's reduction against a float64 einsum on the same inputs, max|Δ| over
# max|f64| for dW and for dx: no further than F64_FACTOR times the plain
# f32 einsum's own distance, or F64_FLOOR where both are a few ulp (small
# shapes). One TF32 pass (a 10-bit mantissa) lands ~1e-4 away and fails
# this; 3xTF32 is f32-accurate (tests/test_torch_tf32_split.py).
F64_FACTOR = 2.0
F64_FLOOR = 2e-6
# K5/K6 against plain, |Δ| / max(1, |plain|) over valid (t < len,
# s < tlen) cells. Both run the same f32 recurrence; they differ only in
# the last ulp of log1p(exp(.)), and the lattice values reach ~-1e4.
DP_RTOL = 1e-5
# K5/K6/K6b at every branch of ctc_dp_plan (B, T, S): one warp a row (S <=
# 32), several at one state a lane (S <= 256), two states a lane (S =
# 1025), the wide branch (S = 2049, 4097 and 14,528, the widest K6 takes),
# and each S of S_BUCKETS at a small B; T below the frames in flight (T =
# 3).
CTC_PLAN_SHAPES = tuple((7, 60, s) for s in (1,) + S_BUCKETS + (1025,)) + (
    (3, 24, 2049), (2, 16, 4097), (2, 6, 14528), (5, 3, 81))
# Long lines: aligned targets at B=64 and these T (T_BUCKETS runs to 4096).
LONG_T = (2048, 4096)
# Aligned targets (probabilities in [1e-5, 1]) of the kernel path against
# the plain scan recipe in float64. In f32 the lattice itself is only as
# exact as its magnitude allows: |both| and lse reach ~5e3 at T=1024, one
# ulp there is ~5e-4, and exp(both - lse) turns that into a relative error
# of the same size. So the kernel path must be no further from float64 than
# ALIGN_FACTOR times the f32 plain recipe on the same batch (at least
# ALIGN_FLOOR), and never above the 2e-3 alarm of
# scripts/hw_parity_probe.py, the level at which reduced matmul precision
# once stalled training.
ALIGN_FACTOR = 2.0
ALIGN_FLOOR = 1e-5
ALIGN_ALARM = 2e-3
# Training path, kernels against plain from the same start. Step 1 runs on
# identical parameters: its loss must agree to STEP1_LOSS_RTOL (an f32 sum
# over ~230k frames in another order) and its update to STEP1_PARAM_RTOL of
# how far it moved the parameters (the gradients agree to ~2e-5 of their
# max, K2 above). At the bench setting (lr 1e-4, momentum 0.9, loss summed
# over 256 lines) the trajectory is unstable — the loss grows ~30x in four
# steps and the parameters move by ~20 from an init of ±0.01 — so an f32
# difference of 1e-7 at step 2 grows ~10x per step. Over 5 steps the loss
# must agree to LOSS_RTOL and the parameters to PARAM_RTOL of how far they
# moved.
STEP1_LOSS_RTOL = 1e-5
STEP1_PARAM_RTOL = 1e-4
LOSS_RTOL = 1e-3
PARAM_RTOL = 1e-3
NCHARS = 40             # bench.py:548-575: S = 2*40+1 = 81
# (B, T, D, H). K2's tiles are 32 frames (dW), 128 frames (dx) and 128x128
# outputs: these cross their edges, with rows shorter than a frame tile
# (so a tile spans rows and the h_prev shift meets a row boundary inside
# it), B·T not a multiple of a tile, D and H not multiples of 4, and D=1,
# H=1. H=300 takes the chain's 4-row plan with WhT in L2.
ODD_SHAPES = ((5, 37, 3, 7), (3, 20, 49, 300), (9, 64, 48, 100),
              (2, 9, 1, 1))
# K2's chain alone at widths whose plans hold one row per block (on the
# plain forward's state; K1 is not driven there).
CHAIN_WIDE = ((4, 40, 5, 700), (2, 12, 3, 2048))
# BASELINE config 4 (bench.py:26-27: bench_net=bidi2, nhidden 200, 400
# classes). Its second layer has D = 2·200 = 400 inputs, so D+1 > 256 and
# it takes the hoisted projection and K4 (hoists_projection).
H2, C2 = 200, 400
D2 = 2 * H2
ODD_K4 = ((3, 17, 130, 7), (5, 33, 401, 200))
# The forward kernel (K3, K1, K4 in both modes) at shapes across its plan's
# edges (ops/bidi_lstm_kernel.py::fwd_plan), each with mixed lengths (rows
# of length 0 and T), all lengths 0 and no lengths: H not a multiple of the
# cluster size (7, 201), B below the rows per cluster (1, 3) and not a
# multiple of them (17), T = 1, and H = 700 and 2048 on the L2 plan.
# Weights uniform ±min(0.3, 3/sqrt(H)): at H = 700 and 2048, ±0.3 makes the
# recurrence expand (f32 rounding then grows ~10x over 40 steps in the plain
# loop as in the kernel, both ~3x their distance from float64).
FWD_ODD = ((1, 33, 5, 7), (3, 20, 49, 201), (17, 40, 48, 200),
           (5, 1, 48, 100), (3, 17, 130, 7), (4, 40, 5, 700),
           (2, 12, 3, 2048))
# The hoisted product x·Wx + b in f32 against the same product in float64,
# max|Δ| over max|xz|: an f32 sum of 400 products rounds at ~1e-6 of the
# largest term, while TF32 (10-bit mantissa) would be ~1e-3 off. 1e-5
# tells the two apart (ROADMAP Queue 3, "CTC matmul precision").
XZ_RTOL = 1e-5
# Peaks of one H100 SXM (NVIDIA's data sheet, at 700 W) for bound_ms: HBM
# at 3.35 TB/s, and f32-accurate products at a third of the 495 TFLOP/s of
# TF32 (3xTF32). bound_ms is the larger of a kernel's matrix flop over
# this run's valid frames at that rate and its bytes (each input read
# once, each output written once) at the HBM rate.
HBM_BPS = 3.35e12
F32_MMA_FLOPS = 495e12 / 3


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


def lstm_params(rng, d, h, dev, scale=0.3):
    return {"Wx": uniform(rng, (d, 4 * h), -scale, scale, dev),
            "Wh": uniform(rng, (h, 4 * h), -scale, scale, dev),
            "b": uniform(rng, (4 * h,), -scale, scale, dev)}


def compare(pf, pr, x, lengths):
    """Kernel vs plain on the same inputs -> max |Δy|; raises if a padded
    frame of the kernel's output is not exactly 0 or the error exceeds TOL."""
    with torch.no_grad():
        yk = bidi_lstm_infer(pf, pr, x, lengths)
        yp = bidi_lstm_apply(pf, pr, x, lengths)
        if not torch.equal(yk, bidi_lstm_infer(pf, pr, x, lengths)):
            raise AssertionError("kernel: two calls differ")
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


def quantized(img: np.ndarray) -> np.ndarray:
    """``img`` rounded to k/255 values, as a PNG decode gives."""
    return (np.rint(img * 255.0) / np.float32(255.0)).astype(np.float32)


def stack2(pf: dict, pr: dict, name: str) -> torch.Tensor:
    return torch.stack([pf[name], pr[name]])


def padded(lengths, B: int, T: int, dev) -> torch.Tensor:
    """[B, T] bool, True on frames t >= len."""
    L = (torch.full((B,), T, device=dev) if lengths is None
         else lengths.long())
    return torch.arange(T, device=dev)[None, :] >= L[:, None]


def rel_err(k: torch.Tensor, p: torch.Tensor) -> float:
    """max |k - p| / max |p|."""
    return float((k - p).abs().max()) / max(float(p.abs().max()), 1e-30)


def require_finite(name: str, *ts) -> None:
    for t in ts:
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name}: kernel output is not finite")


def compare_k1(pf, pr, x, lengths):
    """K1 vs plain -> (max |Δ| over y, gates, cell; the plain streams).
    Raises if a padded frame of any kernel stream is not exactly 0 or the
    error exceeds TOL (the reason is K3's: same chain, same arithmetic)."""
    with torch.no_grad():
        got = bidi_lstm_fwd_state(pf, pr, x, lengths)
        want = lstm_ops.bidi_lstm_fwd_state_plain(pf, pr, x, lengths)
        if not all(map(torch.equal, got,
                       bidi_lstm_fwd_state(pf, pr, x, lengths))):
            raise AssertionError("K1: two calls differ")
    torch.cuda.synchronize()
    pad = padded(lengths, x.shape[0], x.shape[1], x.device)
    err = 0.0
    for name, k, p in zip(("y", "gates", "cell"), got, want):
        if not bool((k[pad] == 0.0).all()):
            raise AssertionError(f"K1 {name} is not exactly 0 on padded frames")
        require_finite(f"K1 {name}", k)
        err = max(err, float((k - p).abs().max()))
    if not err <= TOL:
        raise AssertionError(f"K1 vs plain max|d| {err:.3e} > {TOL:.0e}")
    return err, want


def reduce64(x, y, dz, Wx2):
    """K2's reduction in float64 on the same inputs (the plain version's
    einsums, operands cast up) -> (dW [2, D+1+H, 4H], dx [B, T, D])."""
    B, T, D = x.shape
    H = y.shape[-1] // 2
    x, y, dz = x.double(), y.double(), dz.double()
    h_prev = torch.stack([F.pad(y[:, :-1, :H], (0, 0, 1, 0)),
                          F.pad(y[:, 1:, H:], (0, 0, 0, 1))])
    a = torch.cat([torch.cat([x, x.new_ones((B, T, 1))], -1).expand(
        2, B, T, D + 1), h_prev], -1)
    return (torch.einsum("gbti,btgj->gij", a, dz),
            torch.einsum("btgj,gdj->btd", dz, Wx2.double()))


def compare_k2(pf, pr, x, lengths, state, gy):
    """K2 vs plain on the given forward streams: the chain on the same
    inputs, the reduction on the plain chain's dz, with and without dx;
    each kernel called twice must give bitwise equal results, and the
    reduction's dW and dx must be as close to float64 as F64_FACTOR/
    F64_FLOOR allow. Returns (chain rel, chain abs, {tensor: rel},
    reduction abs, {dW, dx: (kernel, plain) distance from float64})."""
    y, gates, cell = state
    Wh2, Wx2 = stack2(pf, pr, "Wh"), stack2(pf, pr, "Wx")
    D = x.shape[-1]
    with torch.no_grad():
        dz_k = bidi_lstm_bwd_chain(gates, cell, gy, Wh2, lengths)
        dz_p = lstm_ops.bidi_lstm_bwd_chain_plain(gates, cell, gy, Wh2,
                                                  lengths)
        if not torch.equal(dz_k, bidi_lstm_bwd_chain(gates, cell, gy, Wh2,
                                                     lengths)):
            raise AssertionError("K2 chain: two calls differ")
        torch.cuda.synchronize()
        pad = padded(lengths, x.shape[0], x.shape[1], x.device)
        if not bool((dz_k[pad] == 0.0).all()):
            raise AssertionError("K2 dz is not exactly 0 on padded frames")
        require_finite("K2 chain", dz_k)
        chain_rel = rel_err(dz_k, dz_p)
        chain_abs = float((dz_k - dz_p).abs().max())
        del dz_k
        red, red_abs, f64 = {}, 0.0, {}
        for need_dx in (True, False):
            dW_k, dx_k = bidi_lstm_bwd_reduce(x, y, dz_p, Wx2, need_dx)
            dW_p, dx_p = lstm_ops.bidi_lstm_bwd_reduce_plain(x, y, dz_p, Wx2,
                                                             need_dx)
            again = bidi_lstm_bwd_reduce(x, y, dz_p, Wx2, need_dx)
            if not (torch.equal(dW_k, again[0]) and (
                    dx_k is None or torch.equal(dx_k, again[1]))):
                raise AssertionError("K2 reduction: two calls differ")
            del again
            torch.cuda.synchronize()
            parts = {"dWx": (dW_k[:, :D], dW_p[:, :D]),
                     "db": (dW_k[:, D], dW_p[:, D]),
                     "dWh": (dW_k[:, D + 1:], dW_p[:, D + 1:])}
            if need_dx:
                parts["dx"] = (dx_k, dx_p)
                dW64, dx64 = reduce64(x, y, dz_p, Wx2)
                for name, k, p, r in (("dW", dW_k, dW_p, dW64),
                                      ("dx", dx_k, dx_p, dx64)):
                    f64[name] = (rel_err(k.double(), r),
                                 rel_err(p.double(), r))
                del dW64, dx64
            elif dx_k is not None:
                raise AssertionError("K2 reduction computed dx unasked")
            for name, (k, p) in parts.items():
                require_finite(f"K2 {name}", k)
                red[name] = max(red.get(name, 0.0), rel_err(k, p))
                red_abs = max(red_abs, float((k - p).abs().max()))
    worst = max(chain_rel, *red.values())
    if not worst <= K2_RTOL:
        raise AssertionError(f"K2 vs plain rel {worst:.3e} > {K2_RTOL:.0e} "
                             f"(chain {chain_rel:.3e}, {red})")
    for name, (k, p) in f64.items():
        if not k <= max(F64_FACTOR * p, F64_FLOOR):
            raise AssertionError(
                f"K2 {name} {k:.3e} from float64, plain f32 {p:.3e}: more "
                f"than {F64_FACTOR}x (floor {F64_FLOOR:.0e}): one-pass TF32?")
    return chain_rel, chain_abs, red, red_abs, f64


def f64_note(f64: dict) -> str:
    return "; vs float64 " + ", ".join(
        f"{n} kernel {k:.3e} plain {p:.3e}" for n, (k, p) in f64.items())


def bound(flop: float, nbytes: float):
    """(bound_ms, bound_by) for ``flop`` matrix flop and ``nbytes`` moved."""
    f_ms, b_ms = flop / F32_MMA_FLOPS * 1e3, nbytes / HBM_BPS * 1e3
    return (f_ms, "operations") if f_ms >= b_ms else (b_ms, "bytes")


def lstm_bound(kind: str, B, T, D, H, V, dx=False):
    """bound() of a bidi LSTM kernel at [B, T] with V valid frames: K3/K1
    (kind "fwd"/"fwd_state": z = [x|1]·W_in + h·Wh), K4 ("xz"/"xz_state":
    h·Wh on xz), K2's chain ("chain": Dh = dz·Whᵀ) or reduction
    ("reduce": dW, and dx when asked). f32 = 4 bytes."""
    G, BT = 4 * H, B * T
    state = 4 * BT * (2 * G + 2 * H)            # gates and cell written
    if kind in ("fwd", "fwd_state"):
        flop = 2 * V * 2 * (D + 1 + H) * G
        nbytes = 4 * (BT * D + 2 * (D + 1 + H) * G + BT * 2 * H + B)
    elif kind in ("xz", "xz_state"):
        flop = 2 * V * 2 * H * G
        nbytes = 4 * (BT * 2 * G + 2 * H * G + BT * 2 * H + B)
    elif kind == "chain":
        return bound(2 * V * 2 * G * H,
                     state + 4 * (BT * 2 * H + 2 * H * G + BT * 2 * G + B))
    else:
        flop = 2 * V * 2 * (D + 1 + H) * G + (V * 2 * 2 * G * D if dx else 0)
        nbytes = 4 * (BT * D + BT * 2 * H + BT * 2 * G + 2 * (D + 1 + H) * G
                      + (2 * D * G + BT * D if dx else 0))
    return bound(flop, nbytes + (state if kind.endswith("state") else 0))


def in_turns(fa, fb, reps: int):
    """ms per call of fa and fb, timed in turns a, b, b, a ->
    ([a, a], [b, b])."""
    a1, b1, b2, a2 = (time_ms(f, reps) for f in (fa, fb, fb, fa))
    return [a1, a2], [b1, b2]


def mean(v) -> float:
    return sum(v) / len(v)


def cudnn_lstm(pf: dict, pr: dict, dev) -> torch.nn.LSTM:
    """torch.nn.LSTM (cuDNN; TF32 off by torch_device) holding a bidi
    layer's weights: the library yardstick timed beside K3, K1 and K4, and
    never called by the port. The port's gate order is (i, f, o, g),
    PyTorch's (i, f, g, o); the port's one bias goes to bias_ih and
    bias_hh is 0."""
    D, G = pf["Wx"].shape
    H = G // 4
    perm = torch.cat([torch.arange(2 * H), torch.arange(3 * H, 4 * H),
                      torch.arange(2 * H, 3 * H)]).to(dev)
    lstm = torch.nn.LSTM(D, H, batch_first=True, bidirectional=True).to(dev)
    with torch.no_grad():
        for sfx, p in (("l0", pf), ("l0_reverse", pr)):
            getattr(lstm, f"weight_ih_{sfx}").copy_(p["Wx"][:, perm].t())
            getattr(lstm, f"weight_hh_{sfx}").copy_(p["Wh"][:, perm].t())
            getattr(lstm, f"bias_ih_{sfx}").copy_(p["b"][perm])
            getattr(lstm, f"bias_hh_{sfx}").zero_()
    return lstm


def packed(x, lengths):
    return torch.nn.utils.rnn.pack_padded_sequence(
        x, lengths.cpu(), batch_first=True, enforce_sorted=False)


def check_cudnn(lstm, px, y_ref, name: str) -> None:
    """The yardstick computes the layer: its output against ``y_ref``."""
    with torch.no_grad():
        y = torch.nn.utils.rnn.pad_packed_sequence(
            lstm(px)[0], batch_first=True, total_length=y_ref.shape[1])[0]
    err = float((y - y_ref).abs().max())
    if not err <= TOL:
        raise AssertionError(f"cuDNN yardstick of {name} is {err:.3e} off "
                             f"the kernel: weights mapped wrongly")


def cudnn_step(lstm, px, dx: bool):
    """The cuDNN yardstick's forward with grad enabled, and its forward
    followed by the backward to the weights (and the input with ``dx``), as
    two callables: the backward's time is their difference."""
    inp = px.data.detach().requires_grad_(dx)
    pin = torch.nn.utils.rnn.PackedSequence(inp, px.batch_sizes,
                                            px.sorted_indices,
                                            px.unsorted_indices)
    wrt = list(lstm.parameters()) + ([inp] if dx else [])

    def fwd():
        with torch.enable_grad():
            return lstm(pin)[0].data

    def fwd_bwd():
        out = fwd()
        return torch.autograd.grad(out, wrt, torch.ones_like(out))
    return fwd, fwd_bwd


def einsum_reduce(x, y, dz, Wx2, need_dx: bool):
    """The plain version's einsums alone, on operands built beforehand: the
    library yardstick of K2's reduction -> a callable."""
    B, T, D = x.shape
    H = y.shape[-1] // 2
    h_prev = torch.stack([F.pad(y[:, :-1, :H], (0, 0, 1, 0)),
                          F.pad(y[:, 1:, H:], (0, 0, 0, 1))])
    a = torch.cat([torch.cat([x, x.new_ones((B, T, 1))], -1).expand(
        2, B, T, D + 1), h_prev], -1).contiguous()

    def run():
        dW = torch.einsum("gbti,btgj->gij", a, dz)
        return dW, torch.einsum("btgj,gdj->btd", dz, Wx2) if need_dx else None
    return run


def load_k2_against(src: str):
    """``--k2-against SRC``: K2 built from another source with the same nvcc
    flags, to time in turns with the current K2 -> (chain, reduce) with the
    wrappers' signatures. SRC may have the current C interface (WhT padded
    to clstm_bidi_lstm_bwd_hp, a scratch size from
    clstm_bidi_lstm_bwd_scratch) or the earlier one (WhT unpadded
    [2, 4H, H], dW partials sized by clstm_bidi_lstm_bwd_nsplit(B, T)). No
    launch is counted."""
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "k2_against.so")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        so, src], check=True, capture_output=True, timeout=600)
        lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    current = hasattr(lib, "clstm_bidi_lstm_bwd_scratch")
    lib.clstm_bidi_lstm_bwd_chain.argtypes = [P] * 6 + [I] * 3 + [P]
    lib.clstm_bidi_lstm_bwd_reduce.argtypes = [P] * 7 + [I] * 4 + [P]
    if current:
        lib.clstm_bidi_lstm_bwd_hp.argtypes = [I]
        lib.clstm_bidi_lstm_bwd_scratch.argtypes = [I] * 4
        lib.clstm_bidi_lstm_bwd_scratch.restype = ctypes.c_longlong
    else:
        lib.clstm_bidi_lstm_bwd_nsplit.argtypes = [I] * 2

    def check(err):
        if err != 0:
            raise RuntimeError(f"K2 from {src}: CUDA error {err}")

    def chain(gates, cell, gy, Wh2, lengths):
        B, T, _, G = gates.shape
        H = G // 4
        dz = torch.empty_like(gates)
        hp = lib.clstm_bidi_lstm_bwd_hp(H) if current else H
        whT = torch.zeros((2, G, hp), dtype=torch.float32, device=gates.device)
        whT[:, :, :H] = Wh2.transpose(1, 2)
        check(lib.clstm_bidi_lstm_bwd_chain(
            0 if lengths is None else lengths.data_ptr(), gates.data_ptr(),
            cell.data_ptr(), gy.data_ptr(), whT.data_ptr(), dz.data_ptr(), B,
            T, H, torch.cuda.current_stream().cuda_stream))
        return dz

    def reduce(x, y, dz, Wx2, need_dx):
        B, T, D = x.shape
        H = y.shape[-1] // 2
        M, G = D + 1 + H, 4 * H
        n = (lib.clstm_bidi_lstm_bwd_scratch(B, T, D, H) if current
             else lib.clstm_bidi_lstm_bwd_nsplit(B, T) * 2 * M * G)
        scratch = torch.empty(n, dtype=torch.float32, device=x.device)
        dW = torch.empty((2, M, G), dtype=torch.float32, device=x.device)
        dx = torch.empty_like(x) if need_dx else None
        check(lib.clstm_bidi_lstm_bwd_reduce(
            x.data_ptr(), y.data_ptr(), dz.data_ptr(), Wx2.data_ptr(),
            scratch.data_ptr(), dW.data_ptr(), 0 if dx is None else
            dx.data_ptr(), B, T, D, H,
            torch.cuda.current_stream().cuda_stream))
        return dW, dx
    return chain, reduce


def load_fwd_against(src: str) -> dict:
    """``--fwd-against SRC``: the forward kernel built from another source
    with the same nvcc flags, to time in turns with the current one ->
    {"K3", "K1", "K4", "K4 state": a callable with the signature of
    bidi_lstm_infer, bidi_lstm_fwd_state, bidi_lstm_infer_xz,
    bidi_lstm_fwd_state_xz}. SRC may have the current C interface (weights
    interleaved by unit, a plan from fwd_plan with that library's own
    occupancy query) or the earlier one (wx [2,D,4H], wh [2,H,4H] and
    b [2,4H] as they are, no plan). No launch is counted."""
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "fwd_against.so")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        so, src], check=True, capture_output=True, timeout=600)
        lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    current = hasattr(lib, "clstm_bidi_lstm_fwd_clusters")
    n_ints = 8 if current else 4
    sigs = {"clstm_bidi_lstm_fwd": [P] * (5 if current else 6),
            "clstm_bidi_lstm_fwd_state": [P] * (7 if current else 8),
            "clstm_bidi_lstm_fwd_xz": [P] * 4,
            "clstm_bidi_lstm_fwd_xz_state": [P] * 6}
    for name, ptrs in sigs.items():
        ints = n_ints - (1 if name.startswith("clstm_bidi_lstm_fwd_xz") else 0)
        getattr(lib, name).argtypes = ptrs + [I] * ints + [P]
    if current:
        lib.clstm_bidi_lstm_fwd_clusters.argtypes = [I] * 8

    def lookup(name):
        return getattr(lib, name)

    def call(name, *args):
        err = getattr(lib, name)(*args,
                                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} from {src}: CUDA error {err}")

    def plan_args(B, D, H, hoist, state):
        p = bk.fwd_plan(B, D, H, hoist, state,
                        bk.card_clusters(lookup, D, H, hoist, state))
        return (p.C, p.rows, p.units, p.resident)

    def weights(pf, pr, with_x):
        if current:
            return bk.fwd_weights(pf, pr, with_x)
        return (stack2(pf, pr, "Wx").contiguous() if with_x else None,
                stack2(pf, pr, "Wh").contiguous())

    def run_x(state):
        def run(pf, pr, x, lengths):
            B, T, D = x.shape
            H = pf["Wh"].shape[0]
            y = torch.empty((B, T, 2 * H), device=x.device)
            out = [y]
            if state:
                out += [torch.empty((B, T, 2, 4 * H), device=x.device),
                        torch.empty((B, T, 2, H), device=x.device)]
            wx, wh = weights(pf, pr, True)
            ptrs = [wx.data_ptr(), wh.data_ptr()]
            if not current:
                b = stack2(pf, pr, "b").contiguous()
                ptrs.append(b.data_ptr())
            ints = [B, T, D, H] + (list(plan_args(B, D, H, False, state))
                                   if current else [])
            name = "clstm_bidi_lstm_fwd_state" if state else \
                "clstm_bidi_lstm_fwd"
            call(name, x.data_ptr(), 0 if lengths is None else
                 lengths.data_ptr(), *ptrs, *[o.data_ptr() for o in out],
                 *ints)
            return tuple(out) if state else y
        return run

    def run_xz(state):
        def run(pf, pr, xz, lengths):
            B, T, _, G = xz.shape
            H = G // 4
            y = torch.empty((B, T, 2 * H), device=xz.device)
            out = [y]
            if state:
                out += [torch.empty((B, T, 2, G), device=xz.device),
                        torch.empty((B, T, 2, H), device=xz.device)]
            _, wh = weights(pf, pr, False)
            ints = [B, T, H] + (list(plan_args(B, 0, H, True, state))
                                if current else [])
            call("clstm_bidi_lstm_fwd_xz_state" if state else
                 "clstm_bidi_lstm_fwd_xz", xz.data_ptr(),
                 0 if lengths is None else lengths.data_ptr(), wh.data_ptr(),
                 *[o.data_ptr() for o in out], *ints)
            return tuple(out) if state else y
        return run
    return {"K3": run_x(False), "K1": run_x(True), "K4": run_xz(False),
            "K4 state": run_xz(True)}


def load_ctc_against(src: str) -> dict:
    """``--ctc-against SRC``: the CTC DP kernels built from another source
    with the same nvcc flags, to time in turns with the current ones ->
    {"K5", "K6", "K6b": a callable with the signature of ctc_forward,
    ctc_both, ctc_backward}. SRC may have the current C interface (the plan
    of ctc_dp_plan after the shapes; it has clstm_ctc_smem) or the earlier
    one (no plan). No launch is counted."""
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "ctc_against.so")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        so, src], check=True, capture_output=True, timeout=600)
        lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    current = hasattr(lib, "clstm_ctc_smem")
    for name, ptrs in (("clstm_ctc_forward", 3), ("clstm_ctc_both", 6),
                       ("clstm_ctc_backward", 4)):
        getattr(lib, name).argtypes = ([P] * ptrs + [I] * (6 if current else 3)
                                       + [ctypes.c_float, P])

    def call(name, ptrs, shape, skip):
        plan = (ck.ctc_dp_plan(shape[0], shape[2])[:3] if current else ())
        err = getattr(lib, name)(*ptrs, *shape, *plan, skip,
                                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"{name} from {src}: CUDA error {err}")

    def k5(lm, lengths, skip=ctc_ops.SKIP):
        lr = torch.empty_like(lm)
        call("clstm_ctc_forward", (lm.data_ptr(), lengths.data_ptr(),
                                   lr.data_ptr()), lm.shape, skip)
        return lr

    def k6(lm, lr, lengths, tlens, skip=ctc_ops.SKIP):
        both = torch.empty_like(lm)
        lse = torch.empty((lm.shape[0], lm.shape[2]), device=lm.device)
        call("clstm_ctc_both", (lm.data_ptr(), lr.data_ptr(),
                                lengths.data_ptr(), tlens.data_ptr(),
                                both.data_ptr(), lse.data_ptr()), lm.shape,
             skip)
        return both, lse

    def k6b(lm, lengths, tlens, skip=ctc_ops.SKIP):
        rl = torch.empty_like(lm)
        call("clstm_ctc_backward", (lm.data_ptr(), lengths.data_ptr(),
                                    tlens.data_ptr(), rl.data_ptr()),
             lm.shape, skip)
        return rl
    return {"K5": k5, "K6": k6, "K6b": k6b}


def dp_err(k: torch.Tensor, p: torch.Tensor) -> float:
    """max |k - p| / max(1, |p|) over every cell (NEG cells equal in both
    give 0)."""
    return float(((k - p).abs() / p.abs().clamp(min=1.0)).max())


def step_turns(tocr, batch, ctc_against, reps: int, label: str,
               card: str) -> dict:
    """train_batch with the alignment's K5 and K6 taken from the
    --ctc-against build and with the current ones, timed in turns (against,
    current, current, against) on the host clock. Logs and returns
    {"against_ms": [..], "ms": [..]}."""
    def against():
        saved = ck.ctc_forward, ck.ctc_both
        ck.ctc_forward, ck.ctc_both = ctc_against["K5"], ctc_against["K6"]
        try:
            tocr.train_batch(batch)
        finally:
            ck.ctc_forward, ck.ctc_both = saved

    def current():
        tocr.train_batch(batch)
    o1, n1, n2, o2 = (host_ms(f, reps) for f in (against, current, current,
                                                 against))
    log(f"[against] {card} | {label} train_batch in turns (against's K5 and "
        f"K6, current, current, against's): {o1:.3f}, {n1:.3f}, {n2:.3f}, "
        f"{o2:.3f} ms/step")
    return {"against_ms": [o1, o2], "ms": [n1, n2]}


def ctc_loss_step(rng, dev):
    """F.ctc_loss forward and backward on seeded log-probabilities
    [T, B, C], NCHARS targets a row and TRUE_T frames: the B, T and S of K6
    at the bench shape -> a callable. A yardstick of scale only: it computes
    the CTC loss, not clstm's lattice, and the port never calls it."""
    lp = torch.log_softmax(torch.from_numpy(
        rng.normal(size=(T, B, C)).astype(np.float32)).to(dev), -1)
    lp.requires_grad_(True)
    tg = torch.from_numpy(rng.randint(1, C, size=(B, NCHARS))).to(dev)
    il = torch.full((B,), TRUE_T, dtype=torch.long, device=dev)
    tl = torch.full((B,), NCHARS, dtype=torch.long, device=dev)

    def run():
        with torch.enable_grad():
            return torch.autograd.grad(
                F.ctc_loss(lp, tg, il, tl, reduction="sum"), lp)
    return run


def against_turns(label: str, old, new, reps: int, card: str,
                  err=rel_err, tol: float = K2_RTOL) -> dict:
    """Time the kernel of --k2-against, --fwd-against or --ctc-against
    (old) and the current one (new) in turns old, new, new, old; both must
    agree, err(new, old) <= tol on every output (by default within K2_RTOL
    of max|old|). Logs and returns {"against_ms": [..], "ms": [..]}."""
    a, b = old(), new()
    torch.cuda.synchronize()
    for u, v in zip(a if isinstance(a, tuple) else (a,),
                    b if isinstance(b, tuple) else (b,)):
        if u is not None and not err(v, u) <= tol:
            raise AssertionError(f"{label}: the --*-against kernel and the "
                                 f"current one disagree ({err(v, u):.3e})")
    del a, b
    o, n = in_turns(old, new, reps)
    log(f"[against] {card} | {label} in turns (against, current, "
        f"current, against): {o[0]:.3f}, {n[0]:.3f}, {n[1]:.3f}, "
        f"{o[1]:.3f} ms")
    return {"against_ms": o, "ms": n}


def compare_fwd(pf, pr, x, lengths) -> float:
    """K3, K1 and K4 in both modes (on the hoisted product) against their
    plain versions on the same inputs -> max |Δ| over every stream. Raises
    if a padded frame of any kernel stream is not exactly 0, an output is
    not finite, the error exceeds TOL or two calls differ."""
    with torch.no_grad():
        y3 = bidi_lstm_infer(pf, pr, x, lengths, hoist=False)
        if not torch.equal(y3, bidi_lstm_infer(pf, pr, x, lengths,
                                               hoist=False)):
            raise AssertionError("K3: two calls differ")
        want = lstm_ops.bidi_lstm_fwd_state_plain(pf, pr, x, lengths)
    pad = padded(lengths, x.shape[0], x.shape[1], x.device)
    if not bool((y3[pad] == 0.0).all()):
        raise AssertionError("K3 y is not exactly 0 on padded frames")
    require_finite("K3", y3)
    err = float((y3 - want[0]).abs().max())
    del y3
    e1, _ = compare_k1(pf, pr, x, lengths)
    e4, _, _ = compare_k4(pf, pr, x, lengths)
    err = max(err, e1, e4)
    if not err <= TOL:
        raise AssertionError(f"forward kernel vs plain max|d| {err:.3e} > "
                             f"{TOL:.0e}")
    return err


def fwd_plan_of(dev, B, D, H, hoist, state) -> dict:
    """The forward kernel's plan on this card (ops/bidi_lstm_kernel.py::
    device_plan) as a dict; raises unless the kernel's own count of its
    shared memory agrees with the plan's."""
    p = bk.device_plan(dev, B, 0 if hoist else D, H, hoist, state)
    smem = bk._kernel("clstm_bidi_lstm_fwd_smem")(
        0 if hoist else D, H, int(hoist), p.C, p.rows, p.units, p.resident)
    if smem != p.smem:
        raise AssertionError(f"plan {p}: the kernel counts {smem} bytes of "
                             f"shared memory")
    return p._asdict()


def fwd_with_plan(state: bool, pf, pr, x, lengths, plan):
    """K3 (or K1 with ``state``) launched with the given plan (C, rows,
    units, resident) in place of the one fwd_plan picks, to time the plan's
    choice; not counted."""
    B, T, D = x.shape
    H = pf["Wh"].shape[0]
    out = [torch.empty((B, T, 2 * H), device=x.device)]
    if state:
        out += [torch.empty((B, T, 2, 4 * H), device=x.device),
                torch.empty((B, T, 2, H), device=x.device)]
    wx, wh = bk.fwd_weights(pf, pr, True)
    bk._launch("clstm_bidi_lstm_fwd_state" if state else
               "clstm_bidi_lstm_fwd", x.device, x.data_ptr(),
               0 if lengths is None else lengths.data_ptr(), wx.data_ptr(),
               wh.data_ptr(), *(o.data_ptr() for o in out), B, T, D, H,
               *plan)
    return out


def plan_turns(label: str, state: bool, pf, pr, x, lengths, alt,
               reps: int, card: str) -> dict:
    """K3 (K1 with ``state``) with fwd_plan's plan and with ``alt`` (C,
    rows, units, resident), timed in turns chosen, alt, alt, chosen; both
    must give the same bits (the sums do not depend on the plan). Logs and
    returns both."""
    p = bk.device_plan(x.device, x.shape[0], x.shape[2], pf["Wh"].shape[0],
                       False, state)
    chosen = (p.C, p.rows, p.units, p.resident)
    name = "K1" if state else "K3"
    with torch.no_grad():
        a = fwd_with_plan(state, pf, pr, x, lengths, chosen)
        b = fwd_with_plan(state, pf, pr, x, lengths, alt)
        if not all(map(torch.equal, a, b)):
            raise AssertionError(f"{label}: {name} plans {chosen} and {alt} "
                                 f"differ")
        del a, b
        c, o = in_turns(
            lambda: fwd_with_plan(state, pf, pr, x, lengths, chosen),
            lambda: fwd_with_plan(state, pf, pr, x, lengths, alt), reps)
    log(f"[plan] {card} | {label}: {name} with the plan (C, rows, units, "
        f"resident) {chosen} {c[0]:.3f}, {alt} {o[0]:.3f}, {o[1]:.3f}, "
        f"{chosen} {c[1]:.3f} ms in turns; bitwise equal")
    return {"plan": list(chosen), "ms": c, "other_plan": list(alt),
            "other_ms": o}


def compare_k4(pf, pr, x, lengths):
    """K4 in both modes vs its plain versions on the same hoisted product
    -> (max |Δ| over y of both modes, gates and cell; the product's max|Δ|
    against float64 over max|xz|; the plain state streams). Raises if a
    padded frame of any kernel stream is not exactly 0, or past TOL (K3's
    reason: the same recurrence and arithmetic, with z's first term read
    instead of summed) or XZ_RTOL."""
    with torch.no_grad():
        xz = lstm_ops.hoisted_projection(pf, pr, x)
        got = (bidi_lstm_infer_xz(pf, pr, xz, lengths),
               *bidi_lstm_fwd_state_xz(pf, pr, xz, lengths))
        want = lstm_ops.bidi_lstm_fwd_state_xz_plain(pf, pr, xz, lengths)
        again = (bidi_lstm_infer_xz(pf, pr, xz, lengths),
                 *bidi_lstm_fwd_state_xz(pf, pr, xz, lengths))
        if not all(map(torch.equal, got, again)):
            raise AssertionError("K4: two calls differ")
        del again
        want = (want[0], *want)
        Bx, Tx, Dx = x.shape
        w64 = torch.cat([pf["Wx"], pr["Wx"]], 1).double()
        b64 = torch.cat([pf["b"], pr["b"]]).double()
        xz64 = torch.addmm(b64, x.reshape(Bx * Tx, Dx).double(), w64)
        xz_rel = rel_err(xz.reshape(Bx * Tx, -1).double(), xz64)
        del xz, xz64
    torch.cuda.synchronize()
    pad = padded(lengths, Bx, Tx, x.device)
    err = 0.0
    for name, k, p in zip(("y", "y (state mode)", "gates", "cell"), got, want):
        if not bool((k[pad] == 0.0).all()):
            raise AssertionError(f"K4 {name} is not exactly 0 on padded frames")
        require_finite(f"K4 {name}", k)
        err = max(err, float((k - p).abs().max()))
    if not err <= TOL:
        raise AssertionError(f"K4 vs plain max|d| {err:.3e} > {TOL:.0e}")
    if not xz_rel <= XZ_RTOL:
        raise AssertionError(f"hoisted product vs float64 {xz_rel:.3e} > "
                             f"{XZ_RTOL:.0e}: reduced matmul precision?")
    return err, xz_rel, want[1:]


def lattice(rng, B, T, S, dev):
    """lmatch [B, T, S] (log of floored probabilities, NEG beyond each
    row's target length), mixed lengths and target lengths with rows of
    length 0."""
    lm = np.log(rng.rand(B, T, S).astype(np.float32) + 1e-3)
    lengths = rng.randint(0, T + 1, B).astype(np.int32)
    lengths[0], lengths[1] = 0, T
    tlens = rng.randint(1, S + 1, B).astype(np.int32)
    tlens[2 % B] = S
    for b in range(B):
        lm[b, :, tlens[b]:] = ctc_ops.NEG
    return tuple(torch.from_numpy(a).to(dev) for a in (lm, lengths, tlens))


def compare_ctc(lm, lengths, tlens):
    """K5, K6 and K6b vs plain -> (K5 rel, K5 abs, K6 rel, K6 abs, K6b rel,
    K6b abs) over valid cells (t < len, s < tlen; lse over s < tlen of rows
    with len > 0). K6 reads the plain lr, so each kernel is held on its
    own; K6b against the flip recipe, which fills the other cells
    differently. Raises unless each kernel gives equal bits on a second
    call, K5 carries its last state over frames t >= len (the initial one
    on rows of length 0), K6b its initial state, and K6's both is NEG
    there."""
    B, T, S = lm.shape
    dev = lm.device
    lr_k = ctc_forward(lm, lengths)
    lr_p = ctc_ops.ctc_forward_plain(lm, lengths)
    both_k, lse_k = ctc_both(lm, lr_p, lengths, tlens)
    both_p, lse_p = ctc_ops.ctc_both_plain(lm, lr_p, lengths, tlens)
    rl_k = ctc_backward(lm, lengths, tlens)
    rl_p = ctc_ops.ctc_backward_plain(lm, lengths, tlens)
    again = (ctc_forward(lm, lengths), *ctc_both(lm, lr_p, lengths, tlens),
             ctc_backward(lm, lengths, tlens))
    torch.cuda.synchronize()
    require_finite("K5", lr_k)
    require_finite("K6", both_k, lse_k)
    require_finite("K6b", rl_k)
    if not all(torch.equal(u, v) for u, v in
               zip((lr_k, both_k, lse_k, rl_k), again)):
        raise AssertionError(f"K5/K6/K6b at B={B} T={T} S={S}: two calls "
                             f"differ")
    L, TL = lengths.long(), tlens.long()
    col = torch.arange(S, device=dev)[None, :]
    sv = col < TL[:, None]                                          # [B,S]
    pad = padded(lengths, B, T, dev)
    m = (~pad)[:, :, None] & sv[:, None, :]
    ms = sv & (L[:, None] > 0)

    def errs(k, p, mask):
        d = (k - p).abs()[mask]
        if d.numel() == 0:
            return 0.0, 0.0
        return (float((d / p.abs()[mask].clamp(min=1.0)).max()),
                float(d.max()))

    r5, a5 = errs(lr_k, lr_p, m)
    rb, ab = errs(both_k, both_p, m)
    rl, al = errs(lse_k, lse_p, ms)
    r6b, a6b = errs(rl_k, rl_p, m)
    if not bool((both_k[pad] == ctc_ops.NEG).all()):
        raise AssertionError("K6 both is not NEG on padded frames")
    last = lr_k[torch.arange(B, device=dev), (L - 1).clamp(min=0)]
    v0 = ctc_ops.SKIP * col.float().expand(B, S)
    carried = torch.where((L > 0)[:, None], last, v0)[:, None, :].expand(
        B, T, S)[pad]
    u0 = torch.where(sv, ctc_ops.SKIP * (TL[:, None] - 1 - col).float(),
                     torch.full_like(v0, ctc_ops.NEG))
    if not (torch.equal(lr_k[pad], carried) and torch.equal(
            rl_k[pad], u0[:, None, :].expand(B, T, S)[pad])):
        raise AssertionError("K5/K6b do not carry their state over padded "
                             "frames")
    r6, a6 = max(rb, rl), max(ab, al)
    if not (r5 <= DP_RTOL and r6 <= DP_RTOL and r6b <= DP_RTOL):
        raise AssertionError(f"K5/K6/K6b vs plain rel {r5:.3e}/{r6:.3e}/"
                             f"{r6b:.3e} > {DP_RTOL:.0e}")
    return r5, a5, r6, a6, r6b, a6b


def ctc_plan_of(B: int, S: int) -> dict:
    """ctc_dp_plan(B, S), checked against the library: its shared memory,
    K6's and K5's, must be what clstm_ctc_smem computes for it (0 there: no
    kernel)."""
    fn = _build.load_library().clstm_ctc_smem
    fn.argtypes = [ctypes.c_int] * 5
    fn.restype = ctypes.c_longlong
    for both in (True, False):
        p = ck.ctc_dp_plan(B, S, both)
        got = fn(S, p.warps, p.states, p.prefetch, 2 if both else 1)
        if got != p.smem:
            raise AssertionError(f"CTC plan {p} at B={B} S={S}: the library "
                                 f"counts {got} bytes of shared memory")
    return ck.ctc_dp_plan(B, S)._asdict()


def ctc_with_plan(kind: str, plan, lm, lr, lengths, tlens):
    """K5, K6 or K6b launched with ``plan`` (W, K, P) in place of the one
    ctc_dp_plan picks, to time the plan's choice; not counted."""
    B_, T_, S_ = lm.shape
    out = torch.empty_like(lm)
    if kind == "K5":
        name, res = "clstm_ctc_forward", out
        ptrs = (lm.data_ptr(), lengths.data_ptr(), out.data_ptr())
    elif kind == "K6":
        lse = torch.empty((B_, S_), device=lm.device)
        name, res = "clstm_ctc_both", (out, lse)
        ptrs = (lm.data_ptr(), lr.data_ptr(), lengths.data_ptr(),
                tlens.data_ptr(), out.data_ptr(), lse.data_ptr())
    else:
        name, res = "clstm_ctc_backward", out
        ptrs = (lm.data_ptr(), lengths.data_ptr(), tlens.data_ptr(),
                out.data_ptr())
    ck._launch(name, ptrs, (B_, T_, S_, *plan), ctc_ops.SKIP, lm.device)
    return res


def ctc_plan_turns(label: str, lm, lr, lengths, tlens, alts, reps: int,
                   card: str) -> dict:
    """K5, K6 and K6b with ctc_dp_plan's plan and with each plan of
    ``alts`` (W, K, P), timed in turns chosen, alt, alt, chosen; both must
    give the same bits (each state's arithmetic does not depend on the
    plan). Logs and returns {"plan": .., "other_plans": {alt: {kind: {"ms",
    "other_ms"}}}}."""
    B_, _, S_ = lm.shape
    chosen = tuple(ck.ctc_dp_plan(B_, S_)[:3])
    out = {"plan": list(chosen), "other_plans": {}}
    for alt in alts:
        got = out["other_plans"][str(list(alt))] = {}
        for kind in ("K5", "K6", "K6b"):
            def run(plan, kind=kind):
                return ctc_with_plan(kind, plan, lm, lr, lengths, tlens)
            a, b = run(chosen), run(alt)
            if not all(map(torch.equal, a if kind == "K6" else (a,),
                           b if kind == "K6" else (b,))):
                raise AssertionError(f"{label}: {kind} plans {chosen} and "
                                     f"{alt} differ")
            del a, b
            c, o = in_turns(lambda: run(chosen), lambda: run(alt), reps)
            got[kind] = {"ms": c, "other_ms": o}
            log(f"[plan] {card} | {label}: {kind} with the plan (W, K, P) "
                f"{chosen} {c[0]:.4f}, {alt} {o[0]:.4f}, {o[1]:.4f}, "
                f"{chosen} {c[1]:.4f} ms in turns; bitwise equal")
    return out


def align_check(rng, B_, T_, lengths, dev, alarm: bool = True) -> dict:
    """Aligned targets of the kernel path, of the unfused recipe (second
    direction by K6b) and of the f32 plain recipe against the plain scan
    recipe in float64, on seeded posteriors over C classes and up to
    NCHARS characters (S = 2·NCHARS+1), with ``lengths`` [B_]. Raises above
    ALIGN_FACTOR x the f32 plain recipe's distance, and (with ``alarm``)
    above the alarm; returns the distances and K6b's launches. On long
    lines the f32 recipe itself passes the alarm (ROADMAP Queue 3): there
    the kernels are held to the f32 recipe and the alarm is logged."""
    S_ = 2 * NCHARS + 1
    probs = torch.softmax(torch.from_numpy(
        3 * rng.normal(size=(B_, T_, C)).astype(np.float32)).to(dev), dim=-1)
    tids = torch.from_numpy(np.stack(
        [mktargets_ids(rng.randint(1, C, size=rng.randint(0, NCHARS + 1)),
                       S_) for _ in range(B_)]).astype(np.int32)).to(dev)
    tlens = (tids != 0).sum(1).mul(2).add(1).clamp(max=S_).to(torch.int32)
    kw = dict(lengths=lengths, target_lengths=tlens)
    valid = ~padded(lengths, B_, T_, dev)
    aligned64 = ctc_ops.ctc_align_targets_batched(
        probs.double(), tids, fused=False, use_kernel=False, **kw)

    def off64(a):
        return float((a.double() - aligned64).abs()[valid].max())

    out = {"kernel": off64(ctc_ops.ctc_align_targets_batched(probs, tids,
                                                             **kw)),
           "plain32": off64(ctc_ops.ctc_align_targets_batched(
               probs, tids, fused=False, use_kernel=False, **kw))}
    reset_counts()
    unfused = ctc_ops.ctc_align_targets_batched(probs, tids, fused=False, **kw)
    torch.cuda.synchronize()
    out["k6b_launches"] = counts()["ctc_backward"]
    out["unfused"] = off64(unfused)
    out["tol"] = max(ALIGN_FACTOR * out["plain32"], ALIGN_FLOOR)
    log(f"[align] B={B_} T={T_} C={C} S={S_}: max|d aligned| vs float64 "
        f"plain: kernel path {out['kernel']:.3e}, unfused recipe with K6b "
        f"{out['unfused']:.3e} ({out['k6b_launches']} K6b launch), f32 plain "
        f"recipe {out['plain32']:.3e} (tol {out['tol']:.3e}, alarm "
        f"{ALIGN_ALARM:.0e})")
    if out["k6b_launches"] != 1:
        raise AssertionError(f"the unfused recipe launched K6b "
                             f"{out['k6b_launches']} times")
    out["above_alarm"] = not max(out["kernel"], out["unfused"]) <= ALIGN_ALARM
    if out["above_alarm"] and not alarm:
        log(f"[align] T={T_}: above the {ALIGN_ALARM:.0e} alarm, as the f32 "
            f"plain recipe ({out['plain32']:.3e}): the f32 lattice's fault on "
            f"long lines (ROADMAP Queue 3), not the kernels'")
    for name in ("kernel", "unfused"):
        e = out[name]
        if alarm and not e <= ALIGN_ALARM:
            raise AssertionError(f"{name} path at T={T_}: aligned targets "
                                 f"off by {e:.3e}: above the "
                                 f"{ALIGN_ALARM:.0e} precision alarm")
        if not e <= out["tol"]:
            raise AssertionError(f"{name} path at T={T_}: aligned targets "
                                 f"off by {e:.3e} > {out['tol']:.3e}")
    return out


def bench_batch(rng, dev, nclasses=C):
    """The bench batch of bench.py:548-575: x uniform [0, 1), 900 true
    frames of 1024, 40 characters per line (S = 81), on the card."""
    S = 2 * NCHARS + 1
    tids = np.stack([mktargets_ids(rng.randint(1, nclasses, size=NCHARS))
                     for _ in range(B)]).astype(np.int32)
    x = rng.rand(B, T, D).astype(np.float32)
    batch = {"x": x, "lengths": np.full(B, TRUE_T, np.int32),
             "targets": tids, "target_lengths": np.full(B, S, np.int32)}
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def plain_forward(net, x, lengths):
    """The net's bidi layers composed from plain versions -> (the softmax
    layer, its input): each bidi pair by bidi_lstm_apply, which is K3's
    plain version and, through its hoisted product, K4's."""
    *layers, soft = net.sub
    for par in layers:
        x = bidi_lstm_apply(par.sub[0].weights(), par.sub[1].sub[0].weights(),
                            x, lengths)
    return soft, x


def plain_train_step(net, velocity, batch, lr, momentum) -> float:
    """The training step of make_train_step(loss_kind="ctc",
    normalization="none") composed from the plain versions: autograd
    through the plain LSTM loops (K1, K4 and K2's reference), the alignment
    by the scan recipe with the flip recipe (K5, K6's), the same loss and
    SGD update."""
    x, lengths = batch["x"], batch["lengths"]
    net.zero_grad(set_to_none=True)
    soft, y = plain_forward(net, x, lengths)
    logits = soft.affine(y)
    with torch.no_grad():
        aligned = ctc_ops.ctc_align_targets_batched(
            torch.softmax(logits, dim=-1), batch["targets"],
            lengths=lengths, target_lengths=batch["target_lengths"],
            fused=False, use_kernel=False)
    mask = length_mask(lengths, x.shape[1])
    loss = torch.sum(-torch.sum(aligned * F.log_softmax(logits, dim=-1), -1)
                     * mask)
    loss.backward()
    sgd_update(net, velocity, {n: p.grad for n, p in net.named_parameters()},
               lr, momentum)
    return float(loss.detach())


def toy_ctc_batch(rng, dev, B=8, T=24, nsym=4, rep=3):
    """tests/test_learning.py's toy CTC transduction: a one-hot input
    string, each symbol over ``rep`` frames; the target is the string."""
    n = T // rep
    syms = rng.randint(1, nsym, size=(B, n))
    x = np.zeros((B, T, nsym), np.float32)
    for b in range(B):
        for i in range(n):
            x[b, i * rep:(i + 1) * rep, syms[b, i]] = 1.0
    tids = np.stack([mktargets_ids(r) for r in syms]).astype(np.int32)
    batch = {"x": x, "lengths": np.full(B, T, np.int32), "targets": tids,
             "target_lengths": np.full(B, 2 * n + 1, np.int32)}
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}, syms


def host_ms(fn, reps: int) -> float:
    """Mean ms per call on the host clock, each call ending synchronised,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def enqueue_ms(fn, reps: int) -> float:
    """Mean host ms of a call on an idle card, not waiting for the card:
    what the host takes to enqueue the call's work (the card idles when
    that is longer than the work), after one warm-up call."""
    fn()
    total = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        total += time.perf_counter() - t0
    torch.cuda.synchronize()
    return total * 1e3 / reps


DEVICE_KEY = "self_device_time_total"


def device_us(event) -> float:
    """Self device time of a profiler row, in us."""
    return getattr(event, DEVICE_KEY)


def kernel_name(key: str) -> str:
    """A profiler row's kernel name without its namespace and arguments,
    keeping template arguments (K1 and K4 are instances of one kernel)."""
    key = key.replace("void ", "", 1).replace("(anonymous namespace)::", "")
    return key.split("(")[0][:56]


COUNTED = (bidi_lstm_infer, bidi_lstm_fwd_state, bidi_lstm_infer_xz,
           bidi_lstm_fwd_state_xz, bidi_lstm_bwd_chain, bidi_lstm_bwd_reduce,
           ctc_forward, ctc_both, ctc_backward)


def reset_counts() -> None:
    for f in COUNTED:
        f.launches = 0


def counts() -> dict:
    return {f.__name__: f.launches for f in COUNTED}


def serve(model: str, images, dev, nclasses: int, tmp: str,
          device_preprocess: int) -> dict:
    """clstmocr's path on the card: load ``model``, run predict_pages and
    write_outputs over ``images`` once cold, then again with the launch
    counts reset just before and read just after, then E2E_PASSES times
    more, timed. Records each width bucket's prepared batch (the host's, or
    the card's prepare output) and its frame ids, and holds the ids against
    the plain path on the same batches; with the normalization on the card,
    also holds each line's length against the same prepare on the CPU and
    times the card's prepare per bucket inside the timed passes. Returns
    {launches, buckets (T per bucket), e2e_s (median of the timed passes),
    e2e_range (their min and max), cold_s, share (of valid frames whose ids
    agree), frames, and with device_preprocess prep_ms, prep_host_ms,
    prep_busy_ms (per prepare call), prep_share, len_mismatch, nosync_ms
    (host ms of predict_batch_images(sync=False) behind a device sleep) and
    sleep_ms}."""
    ocr = CLSTMOCR(device=dev)
    ocr.load(model)
    ocr.target_height = ocr.spec.iget("ninput", ocr.target_height)
    names = [os.path.join(tmp, f"line{i:03d}.png") for i in range(len(images))]

    def run():
        t0 = time.perf_counter()
        results = predict_pages(ocr, images,
                                device_preprocess=device_preprocess)
        write_outputs(ocr, names, images, results, output="sidecar")
        torch.cuda.synchronize()
        return results, time.perf_counter() - t0

    # A first run in a fresh model pays for one-time work (kernels loaded
    # at their first launch, pinned buffers, plans): timed apart as cold.
    cold_s = run()[1]
    batches = []      # (x, lengths, ids) per bucket, on the host
    preps = []        # (prepare inputs, options, outputs) per prepare call
    prepare = preprocess.prepare_batch_device
    if device_preprocess:
        def recording_prepare(imgs, hs, ws, **kw):
            out = prepare(imgs, hs, ws, **kw)
            preps.append(((imgs, hs, ws), kw, out))
            return out

        predict_images = ocr.predict_batch_images

        def recording_images(imgs, sync=True):
            n0 = len(preps)
            out = predict_images(imgs, sync=sync)
            mine = [p[2] for p in preps[n0:]]   # this bucket's chunks
            batches.append((torch.cat([x for x, _ in mine]),
                            torch.cat([ln for _, ln in mine]), out[0]))
            return out

        preprocess.prepare_batch_device = recording_prepare
        ocr.predict_batch_images = recording_images
    else:
        predict_batch = ocr.predict_batch

        def recording(xb, lb):
            ids, vals = predict_batch(xb, lb)
            batches.append((xb, lb, ids))
            return ids, vals

        ocr.predict_batch = recording
    try:
        reset_counts()
        results = run()[0]
        launches = counts()
    finally:
        preprocess.prepare_batch_device = prepare
        vars(ocr).pop("predict_batch_images", None)
        vars(ocr).pop("predict_batch", None)
    texts = [open(n[:-4] + ".txt", encoding="utf-8").read() for n in names]
    if len(batches) < 2:
        raise AssertionError("synthetic lines fell into fewer than 2 buckets")
    if sorted(results) != list(range(len(images))) or len(texts) != len(images):
        raise AssertionError("clstmocr did not answer every line")
    # The timed runs: E2E_PASSES warm passes, each prepare call bracketed
    # by CUDA events (its span on the card's timeline within the run) and
    # by the host's clock (the time the host spent enqueueing it).
    passes = []
    for _ in range(E2E_PASSES):
        spans = []

        def timed_prepare(imgs, hs, ws, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            t0 = time.perf_counter()
            ev[0].record()
            out = prepare(imgs, hs, ws, **kw)
            ev[1].record()
            spans.append((ev, time.perf_counter() - t0))
            return out

        if device_preprocess:
            preprocess.prepare_batch_device = timed_prepare
        try:
            wall = run()[1]
        finally:
            preprocess.prepare_batch_device = prepare
        passes.append({"wall_s": wall,
                       "prep_ms": [a.elapsed_time(b) for (a, b), _ in spans],
                       "prep_host_ms": [1e3 * h for _, h in spans]})
    walls = sorted(p["wall_s"] for p in passes)
    out = {"launches": launches, "e2e_s": float(np.median(walls)),
           "e2e_range": (walls[0], walls[-1]), "cold_s": cold_s,
           "buckets": [int(b[0].shape[1]) for b in batches]}
    agree = total = 0
    for xb, lb, ids in batches:
        xt = torch.as_tensor(xb).to(dev)
        lt = torch.as_tensor(lb).to(dev)
        lb = lt.cpu().numpy()
        ids = torch.as_tensor(ids).cpu().numpy()
        if not (ids.min() >= 0 and ids.max() < nclasses):
            raise AssertionError("main path produced invalid frames")
        with torch.no_grad():
            soft, y = plain_forward(ocr.net, xt, lt)
            pids, _ = greedy_frames(soft(y, lt))
        pids = pids.cpu().numpy()
        for r, L in enumerate(lb):
            agree += int((pids[r, :L] == ids[r, :L]).sum())
            total += int(L)
    if not all(np.isfinite(results[i][2]).all() for i in results):
        raise AssertionError("main path produced invalid frames")
    out["share"], out["frames"] = agree / total, total
    if out["share"] < ID_AGREE_MIN:
        raise AssertionError(f"frame-id agreement {out['share']:.6f} < "
                             f"{ID_AGREE_MIN}")
    if device_preprocess:
        mismatch = 0
        for inputs, kw, (_, lengths) in preps:
            _, cpu_len = prepare(*(t.cpu() for t in inputs), **kw)
            d = (lengths.cpu() - cpu_len).abs()
            if int(d.max()) > 1:
                raise AssertionError(f"card and CPU prepare disagree on a "
                                     f"length by {int(d.max())} frames")
            mismatch += int((d > 0).sum())
        if mismatch > max(1, len(images) // LEN_MISMATCH_LINES):
            raise AssertionError(f"{mismatch} of {len(images)} lengths differ "
                                 "between the card's prepare and the CPU's")
        # Per prepare call (a bucket here): the median over the timed passes
        # of its span on the card and of the host's time in it; the share
        # of each pass's wall time the spans take, median over passes; and
        # the card's busy time in one such call alone (profiler, kernel
        # activity): busy well under the span means the card waited for
        # the host between the prepare's kernels.
        out["prep_ms"] = list(np.median([p["prep_ms"] for p in passes], 0))
        out["prep_host_ms"] = list(np.median(
            [p["prep_host_ms"] for p in passes], 0))
        out["prep_share"] = float(np.median(
            [sum(p["prep_ms"]) / 1e3 / p["wall_s"] for p in passes]))
        with torch.no_grad():
            out["prep_busy_ms"] = []
            for inputs, kw, _ in preps:
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    prepare(*inputs, **kw)
                    torch.cuda.synchronize()
                out["prep_busy_ms"].append(sum(
                    device_us(e) for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3)
            torch.cuda.synchronize()
            sleep = torch.cuda.Event(enable_timing=True)
            woke = torch.cuda.Event(enable_timing=True)
            sleep.record()
            torch.cuda._sleep(NOSYNC_CYCLES)
            woke.record()
            t0 = time.perf_counter()
            ocr.predict_batch_images(images[:8], sync=False)
            out["nosync_ms"] = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            out["sleep_ms"] = sleep.elapsed_time(woke)
        if not out["nosync_ms"] < 0.5 * out["sleep_ms"]:
            raise AssertionError(
                f"predict_batch_images(sync=False) took {out['nosync_ms']:.1f}"
                f" ms behind a {out['sleep_ms']:.1f} ms device sleep: it "
                "waited for the card")
        out["len_mismatch"] = mismatch
    return out


def serve_line(tag: str, r: dict, dp: int) -> str:
    """One log line for a serve() run."""
    lo, hi = r["e2e_range"]
    line = (f"[{tag}] device_preprocess={dp}: {N_LINES} lines in "
            f"{len(r['buckets'])} width buckets ({', '.join(map(str, r['buckets']))}"
            f" frames), launches { {k: v for k, v in r['launches'].items() if v} }"
            f", {E2E_PASSES} warm passes: median {r['e2e_s']:.4f} s end to end "
            f"({N_LINES / r['e2e_s']:.1f} lines/s; range {lo:.4f}-{hi:.4f} s, "
            f"{N_LINES / hi:.1f}-{N_LINES / lo:.1f} lines/s); cold, the "
            f"model's first run, {r['cold_s']:.3f} s, "
            f"{N_LINES / r['cold_s']:.1f} lines/s; frame ids agree with plain on {r['share']:.6f} of "
            f"{r['frames']} valid frames (min {ID_AGREE_MIN})")
    if dp:
        def ms(v):
            return ", ".join(f"{m:.3f}" for m in v)

        line += (f"; device prepare a bucket, medians of the timed passes: "
                 f"span on the card {ms(r['prep_ms'])} ms (all buckets "
                 f"{100 * r['prep_share']:.1f}% of a pass's wall time), host "
                 f"time in it {ms(r['prep_host_ms'])} ms; card busy in one "
                 f"such call alone {ms(r['prep_busy_ms'])} ms"
                 f"; lengths vs the CPU's prepare: "
                 f"{r['len_mismatch']} of {N_LINES} differ by 1 (max "
                 f"{max(1, N_LINES // LEN_MISMATCH_LINES)}); "
                 f"predict_batch_images(sync=False) returned in "
                 f"{r['nosync_ms']:.2f} ms behind a {r['sleep_ms']:.1f} ms "
                 "device sleep")
    return line


def train_against_plain(tocr, plain, batch, lr, momentum, tag) -> dict:
    """5 train_batch steps of ``tocr`` with the launch counts reset just
    before and read just after, and the same 5 steps composed from the plain
    versions on ``plain`` (a TrainState holding the same start). Logs both
    under ``tag`` and raises unless they agree within the limits above;
    returns the launch counts of the 5 kernel steps."""
    p0 = [p.detach().clone() for p in tocr.net.parameters()]

    def params(net):
        return [p.detach().clone() for p in net.parameters()]

    reset_counts()
    t0 = time.perf_counter()
    k_losses = [float(tocr.train_batch(batch)["loss"])]
    k_p1 = params(tocr.net)
    k_losses += [float(tocr.train_batch(batch)["loss"]) for _ in range(4)]
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = counts()
    p_losses = [plain_train_step(plain.net, plain.velocity, batch, lr,
                                 momentum)]
    p_p1 = params(plain.net)
    p_losses += [plain_train_step(plain.net, plain.velocity, batch, lr,
                                  momentum) for _ in range(4)]

    def param_gap(a, b):
        """(max |a - b|, max |a - start|) over all parameters."""
        return (max(float((u - v).abs().max()) for u, v in zip(a, b)),
                max(float((u - w).abs().max()) for u, w in zip(a, p0)))

    dp1, moved1 = param_gap(k_p1, p_p1)
    dp, moved = param_gap(params(tocr.net), params(plain.net))
    rels = [abs(k - p) / abs(p) for k, p in zip(k_losses, p_losses)]
    log(f"[{tag}] 5 train_batch steps in {train_s:.3f} s; launches "
        f"{ {k: v for k, v in launches.items() if v} }; loss kernels "
        f"{[round(v, 3) for v in k_losses]} plain "
        f"{[round(v, 3) for v in p_losses]}, rel per step "
        f"{', '.join(f'{r:.2e}' for r in rels)}")
    log(f"[{tag}] step 1: loss rel {rels[0]:.3e} (tol {STEP1_LOSS_RTOL:.0e}),"
        f" params max|d| {dp1:.3e}, moved {moved1:.3e} (tol "
        f"{STEP1_PARAM_RTOL:.0e} of moved); 5 steps: loss rel {max(rels):.3e}"
        f" (tol {LOSS_RTOL:.0e}), params max|d| {dp:.3e}, moved {moved:.3e} "
        f"(tol {PARAM_RTOL:.0e} of moved)")
    if not all(np.isfinite(k_losses)):
        raise AssertionError("training loss is not finite")
    if not (rels[0] <= STEP1_LOSS_RTOL and max(rels) <= LOSS_RTOL):
        raise AssertionError("training loss disagrees with the plain path")
    if not (moved1 > 0 and dp1 <= STEP1_PARAM_RTOL * moved1
            and dp <= PARAM_RTOL * moved):
        raise AssertionError("parameters disagree with the plain path")
    return launches


def profile_steps(tocr, batch, card, fname, tag):
    """torch.profiler over 2 train_batch steps, after a warm-up step under
    the profiler (the second profiler run in one process lost its first
    kernel without it): the table goes to chiprun_out/``fname``; logs wall,
    device busy share and the top device rows per step."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    traced = []
    with torch.profiler.profile(
            activities=acts,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=2),
            on_trace_ready=lambda p: traced.append(p.key_averages())) as prof:
        for i in range(3):
            if i == 1:
                t0 = time.perf_counter()
            tocr.train_batch(batch)
            # The window opens and closes on an idle card: the host runs
            # ahead, and the warm-up step's kernels would fall inside it.
            if i != 1:
                torch.cuda.synchronize()
            if i == 2:
                wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
    avg = traced[0]
    # Kernel rows only: an autograd Function's row also carries, as its own
    # device time, the kernels it launched through ctypes, and the step
    # annotations come back as CUDA rows spanning the whole step.
    kernels_rows = [e for e in avg
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.key.startswith("ProfilerStep")]
    dev_ms = sum(device_us(e) for e in kernels_rows) / 1e3
    os.makedirs("chiprun_out", exist_ok=True)
    B_, T_ = batch["x"].shape[:2]
    with open(os.path.join("chiprun_out", fname), "w",
              encoding="utf-8") as f:
        f.write(f"{card}\n2 train_batch steps, B={B_} T={T_} "
                f"S={batch['targets'].shape[1]}; wall {wall_ms:.3f} ms, "
                f"device busy {dev_ms:.3f} ms\n")
        f.write(avg.table(sort_by=DEVICE_KEY, row_limit=25))
    top = sorted(kernels_rows, key=lambda e: -device_us(e))[:8]
    log(f"[{tag}] {card} | 2 train_batch steps: wall {wall_ms:.3f} ms, "
        f"device busy {dev_ms:.3f} ms ({100 * dev_ms / wall_ms:.1f}%); top "
        "per step: " + "; ".join(f"{kernel_name(e.key)} "
                                 f"{device_us(e) / 2e3:.3f} ms"
                                 for e in top))


def check_u8(dev, rng) -> int:
    """Phase 16: the u8 pixel table on the card against numpy's k/255, bit
    for bit, and the uint8 and float32 uploads of the same 8-bit lines
    prepared to the same bits. Returns how many of the 256 values the
    card's ``x / 255.0`` gets wrong."""
    ref = preprocess.U8_TABLE.view(np.int32)
    if not np.array_equal(
            preprocess.u8_table(dev).cpu().numpy().view(np.int32), ref):
        raise AssertionError("the u8 table on the card is not numpy's k/255")
    div = torch.arange(256, dtype=torch.float32, device=dev) / 255.0
    wrong = int((div.cpu().numpy().view(np.int32) != ref).sum())
    imgs = [quantized(synth_line(rng)) for _ in range(16)]
    buf, hs, ws = preprocess.pack_raw_images(imgs)
    if buf.dtype != np.uint8:
        raise AssertionError("8-bit lines did not pack as uint8")
    f32 = buf.astype(np.float32) / np.float32(255.0)
    hw = (to_device(hs, dev), to_device(ws, dev))
    xu, lu = preprocess.prepare_batch_device(to_device(buf, dev), *hw)
    xf, lf = preprocess.prepare_batch_device(to_device(f32, dev), *hw)
    if not (torch.equal(xu, xf) and torch.equal(lu, lf)):
        raise AssertionError("uint8 and float32 uploads prepare differently")
    log(f"[u8] the table is numpy's k/255 bit for bit on the card; the "
        f"card's x / 255.0 differs from it in {wrong} of 256 values; 16 "
        "lines prepare to the same bits from the uint8 and float32 uploads")
    return wrong


def write_corpus(path: str, images, texts) -> str:
    """Lines as PNGs with .gt.txt transcripts and a manifest (the training
    set layout of clstmocrtrain) -> the manifest's path."""
    os.makedirs(path)
    names = []
    for i, (img, text) in enumerate(zip(images, texts)):
        base = os.path.join(path, f"line_{i:05d}")
        write_png(base + ".png", img)
        with open(base + ".gt.txt", "w", encoding="utf-8") as f:
            f.write(text + "\n")
        names.append(base + ".png")
    with open(os.path.join(path, "manifest.txt"), "w") as f:
        f.write("\n".join(names) + "\n")
    return os.path.join(path, "manifest.txt")


def ocrtrain(dev, tmp: str) -> dict:
    """Phase 17: clstmocrtrain on a synthetic corpus (see the module
    docstring), launch counts reset just before the run and read just
    after. Returns {launches, lines_per_s, loop_s, run_s, trials, pil,
    busy_share (of the loop), block_enqueue_ms}."""
    rng = np.random.RandomState(7)
    letters = [chr(c) for c in range(97, 123)]

    def corpus(n):
        return ([quantized(synth_line(rng)) for _ in range(n)],
                ["".join(rng.choice(letters, rng.randint(5, 31)))
                 for _ in range(n)])

    train_set, test_set = corpus(OCR_TRAIN), corpus(OCR_TEST)
    save_name = os.path.join(tmp, "ocrtrain")
    env = dict(OCR_ENV, save_name=save_name, log_jsonl=save_name + ".jsonl")
    try:
        import PIL  # noqa: F401
        have_pil = True
    except ImportError:
        have_pil = False
    seen = {}
    loop = clstmocrtrain.train

    def timed_loop(ocr, codec, **kw):
        """The CLI's loop, timed, under kernel-activity tracing (the card's
        busy time; the host's own work is not traced)."""
        seen.update(kw, ocr=ocr, codec=codec)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            seen["trials"] = loop(ocr, codec, **kw)
            torch.cuda.synchronize()
            seen["loop_s"] = time.perf_counter() - t0
        seen["busy_s"] = sum(
            device_us(e) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA) / 1e6
        return seen["trials"]

    printed = io.StringIO()
    saved_env = {k: os.environ.get(k) for k in env}
    clstmocrtrain.train = timed_loop
    os.environ.update(env)
    try:
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            if have_pil:
                clstmocrtrain.main([
                    write_corpus(os.path.join(tmp, name), *data)
                    for name, data in (("train", train_set),
                                       ("test", test_set))])
            else:
                ocr = CLSTMOCR(device=dev)
                codec = Codec.build(train_set[1])
                ocr.createBidi(codec, H, seed=0)
                caches = [DeviceDataset.from_images(
                    imgs, texts, codec, device=dev, t_buckets=T_BUCKETS_FINE,
                    merge_sb=True) for imgs, texts in (train_set, test_set)]
                timed_loop(ocr, codec, save_name=save_name,
                           ntrain=int(env["ntrain"]),
                           batch_size=int(env["batch_size"]),
                           report_every=int(env["report_every"]),
                           save_every=int(env["save_every"]),
                           test_every=int(env["test_every"]),
                           log_jsonl=env["log_jsonl"], dcache=caches[0],
                           test_cache=caches[1])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = counts()
    finally:
        clstmocrtrain.train = loop
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    text = printed.getvalue()
    for ln in text.splitlines():
        log(f"[ocrtrain] | {ln}")
    if not have_pil:
        log("[ocrtrain] pillow is not installed: the corpus was built from "
            "raw arrays (DeviceDataset.from_images) and the CLI's loop "
            "driven directly; PNG decoding was not exercised")
    testerr = [float(ln.split()[2]) for ln in text.splitlines()
               if ln.startswith("TESTERR ")]
    if not testerr or not all(np.isfinite(e) and e >= 0 for e in testerr):
        raise AssertionError(f"clstmocrtrain printed no valid TESTERR line: "
                             f"{testerr}")
    want = ("bidi_lstm_fwd_state", "bidi_lstm_bwd_chain",
            "bidi_lstm_bwd_reduce", "ctc_forward", "ctc_both")
    if min(launches[k] for k in want) < 1:
        raise AssertionError(f"clstmocrtrain skipped a kernel: {launches}")
    ocr, codec = seen["ocr"], seen["codec"]
    dcache, test_cache = seen["dcache"], seen["test_cache"]
    last = save_name + "-last.clstm"

    def reload():
        m = CLSTMOCR(device=dev)
        m.load(last)
        return m

    batch = next(test_cache.epoch(int(env["batch_size"])))
    ids, _ = ocr.predict_batch(batch["x"], batch["lengths"])
    if not np.array_equal(ids, reload().predict_batch(batch["x"],
                                                      batch["lengths"])[0]):
        raise AssertionError("the saved model predicts other ids")
    # A k=4 block against 4 single steps over the same plan, from the
    # same saved state: the same kernels in the same order, bitwise.
    a, b = reload(), reload()
    blocks = (bl for bl in dcache.epoch_blocks(
        int(env["batch_size"]), 4, rng=np.random.RandomState(1), epochs=64)
        if bl["k"] == 4)
    block = next(blocks)
    j0 = block["j"]
    ma = a.train_batch_block(block)
    reps = [b.train_batch_refs({"group": block["group"],
                                "idx_all": block["idx_all"], "j": j0 + s,
                                "set_j": lambda j: None})["report"]
            for s in range(4)]
    same = torch.equal(ma["report_all"], torch.stack(reps)) and all(
        torch.equal(p, q) and torch.equal(a.state.velocity[n],
                                          b.state.velocity[n])
        for (n, p), q in zip(a.net.named_parameters(), b.net.parameters()))
    if not same:
        raise AssertionError("a k=4 block differs from 4 single steps")
    # The path's kernels at its own shapes (B=32, a T_BUCKETS_FINE bucket,
    # S merged over the group) against their plain versions: the block's
    # first batch, 5 kernel steps against 5 plain steps, both from the
    # saved model, within the limits of phase 9.
    g = block["group"]
    kocr = reload()
    plain_launches = train_against_plain(
        kocr, reload().state, gather_batch(g, block["idx_all"][j0]), kocr.lr,
        kocr.momentum, f"ocrtrain B={env['batch_size']} T={g['tb']} "
        f"S={g['sb']}")
    if min(plain_launches[k] for k in want) < 1:
        raise AssertionError(f"the steps against plain skipped a kernel: "
                             f"{plain_launches}")
    del kocr
    # The next block behind a device sleep: its steps must be enqueued
    # without waiting for the card (a copy from pageable memory inside a
    # step waits for every kernel queued before it).
    torch.cuda.synchronize()
    sleep = torch.cuda.Event(enable_timing=True)
    woke = torch.cuda.Event(enable_timing=True)
    sleep.record()
    torch.cuda._sleep(NOSYNC_CYCLES)
    woke.record()
    t0 = time.perf_counter()
    a.train_batch_block(next(blocks))
    nosync_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sleep_ms = sleep.elapsed_time(woke)
    if not nosync_ms < 0.5 * sleep_ms:
        raise AssertionError(f"a k=4 block took {nosync_ms:.1f} ms behind a "
                             f"{sleep_ms:.1f} ms device sleep: a step waited "
                             "for the card")
    # What such a copy costs: a device scalar made from a Python number
    # (as the CTC alignment once did every step) behind the sleep.
    torch.cuda._sleep(NOSYNC_CYCLES)
    t0 = time.perf_counter()
    torch.tensor(-1e30, device=dev)
    scalar_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    busy = seen["busy_s"] / seen["loop_s"]
    out = {"launches": {k: v for k, v in launches.items() if v},
           "trials": seen["trials"], "loop_s": seen["loop_s"],
           "run_s": run_s, "lines_per_s": seen["trials"] / seen["loop_s"],
           "pil": have_pil, "busy_share": busy if seen["busy_s"] else None,
           "block_enqueue_ms": nosync_ms, "pageable_scalar_ms": scalar_ms}
    log(f"[ocrtrain] {OCR_TRAIN} training and {OCR_TEST} test lines, bidi "
        f"48/{H}/{codec.size()}, B={env['batch_size']}, K="
        f"{clstmocrtrain.auto_steps_per_dispatch(int(env['batch_size']), int(env['save_every']), int(env['test_every']), True)}: "
        f"{seen['trials']} trials in {seen['loop_s']:.3f} s of loop "
        f"({out['lines_per_s']:.1f} lines/s end to end, tests and saves "
        f"included), {run_s:.3f} s with the corpus build "
        f"({'PNG decode and ' if have_pil else ''}prepare on the card); card "
        + (f"busy {1e3 * seen['busy_s']:.3f} ms of the loop "
           f"({100 * busy:.1f}%), idle {100 * (1 - busy):.1f}% (the host's "
           "share)" if seen["busy_s"] else
           "busy time not measured (no device rows)")
        + f"; launches {out['launches']}; TESTERR {testerr}; the saved model "
        "reloads and predicts the same ids; 5 steps on a batch of the path "
        "agree with the plain steps (above); a k=4 block equals 4 single "
        f"steps bitwise, and another returned in {nosync_ms:.2f} ms behind a "
        f"{sleep_ms:.1f} ms device sleep; torch.tensor(-1e30, device=cuda) "
        f"took {scalar_ms:.2f} ms behind the same sleep")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k2-against", metavar="SRC",
                    help="also build this K2 source (bidi_lstm_bwd.cu of this "
                    "or the earlier C interface) and time it in turns with "
                    "the current K2 at every timed K2 shape")
    ap.add_argument("--fwd-against", metavar="SRC",
                    help="also build this forward kernel source "
                    "(bidi_lstm_fwd.cu of this or the earlier C interface) "
                    "and time it in turns with the current one at the five "
                    "timed forward shapes (K3 and K1 at bidi, K1 at bidi2's "
                    "first layer, K4 in both modes at its second)")
    ap.add_argument("--ctc-against", metavar="SRC",
                    help="also build this CTC DP source (ctc_dp.cu of this or "
                    "the earlier C interface) and time its K5, K6 and K6b in "
                    "turns with the current ones at the bench shape")
    args = ap.parse_args(argv)
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
    k2_against = (load_k2_against(args.k2_against) if args.k2_against
                  else None)
    fwd_against = (load_fwd_against(args.fwd_against) if args.fwd_against
                   else None)
    ctc_against = (load_ctc_against(args.ctc_against) if args.ctc_against
                   else None)
    against, fwd_vs, ctc_vs = {}, {}, {}
    # The forward kernel's plan at each timed shape: cluster size C, rows
    # per cluster, units per CTA, which weights are resident in shared
    # memory (1 all, 2 Wh's, 0 none: read from L2), and how many clusters
    # the card holds at once (one wave when 2 x groups <= clusters).
    plans = {name: fwd_plan_of(dev, B, d, h, hoist, state)
             for name, d, h, hoist, state in (
                 ("K3 bidi", D, H, False, False),
                 ("K1 bidi", D, H, False, True),
                 ("K3 bidi2 layer 1", D, H2, False, False),
                 ("K1 bidi2 layer 1", D, H2, False, True),
                 ("K4 bidi2 layer 2", D2, H2, True, False),
                 ("K4 state bidi2 layer 2", D2, H2, True, True))}
    for name, p in plans.items():
        log(f"[plan] {name} B={B}: " + ", ".join(
            f"{k} {v}" for k, v in p.items()) + ("; one wave" if 2 *
                                                 p["groups"] <= p["clusters"]
                                                 else "; more than one wave"))

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
    odd = []
    for (b, t, d, h) in ODD_SHAPES:
        spf, spr = lstm_params(rng, d, h, dev), lstm_params(rng, d, h, dev)
        sx = uniform(rng, (b, t, d), -1.0, 1.0, dev)
        sl = torch.from_numpy(rng.randint(0, t + 1, b).astype(np.int32)).to(dev)
        odd.append((spf, spr, sx, sl))
        e1 = compare(spf, spr, sx, sl)
        e2 = compare(spf, spr, sx, None)
        log(f"[kernel] B={b} T={t} D={d} H={h}: max|dy| {e1:.3e} mixed "
            f"lengths, {e2:.3e} no lengths")
    # K3, K1 and K4 (both modes) at shapes across the plan's edges.
    for (b, t, d, h) in FWD_ODD:
        sc = min(0.3, 3.0 / h ** 0.5)
        spf, spr = lstm_params(rng, d, h, dev, sc), lstm_params(rng, d, h,
                                                                dev, sc)
        sx = uniform(rng, (b, t, d), -1.0, 1.0, dev)
        ml = rng.randint(0, t + 1, b).astype(np.int32)
        ml[0], ml[-1] = 0, t
        errs_ = {name: compare_fwd(spf, spr, sx, ls) for name, ls in (
            ("mixed", torch.from_numpy(ml).to(dev)),
            ("all 0", torch.zeros(b, dtype=torch.int32, device=dev)),
            ("none", None))}
        plan_ = {m: fwd_plan_of(dev, b, d, h, hoist, st) for m, hoist, st in
                 (("K3", False, False), ("K1", False, True),
                  ("K4", True, False), ("K4 state", True, True))}
        log(f"[forward] B={b} T={t} D={d} H={h} (weights ±{sc:.3g}): K3, K1, "
            f"K4 both modes max|d| " + ", ".join(
                f"{n} {e:.3e}" for n, e in errs_.items())
            + f" lengths (tol {TOL:.0e}); padded frames exactly 0; two calls "
            "bitwise equal; plans " + "; ".join(
                f"{m} C={q['C']} rows={q['rows']} "
                f"{('L2', 'resident', 'Wh resident')[q['resident']]}"
                for m, q in plan_.items()))

    # 4. Timing at the bench profile: K3 against its plain loop and, in
    # turns, against cuDNN's bidirectional LSTM on the same batch.
    L900 = lens["all900"]
    V900 = int(L900.sum())
    lstm = cudnn_lstm(pf, pr, dev)
    px = packed(x, L900)
    with torch.no_grad():
        check_cudnn(lstm, px, bidi_lstm_infer(pf, pr, x, L900), "K3")
        k3_t, k3_lib = in_turns(lambda: bidi_lstm_infer(pf, pr, x, L900),
                                lambda: lstm(px), 10)
        k_ms, k3_lib_ms = mean(k3_t), mean(k3_lib)
        p_ms = time_ms(lambda: bidi_lstm_apply(pf, pr, x, L900), 3)
        if fwd_against:
            fwd_vs["K3 bidi"] = against_turns(
                f"K3 B={B} T={T} D={D} H={H}",
                lambda: fwd_against["K3"](pf, pr, x, L900),
                lambda: bidi_lstm_infer(pf, pr, x, L900), 10, card)
    log(f"[timing] {card} | bidi LSTM fwd B={B} T={T} D={D} H={H} "
        f"len={TRUE_T}: kernel {k_ms:.3f} ms/batch ({B / k_ms * 1e3:.0f} "
        f"lines/s), plain {p_ms:.3f} ms/batch ({B / p_ms * 1e3:.0f} "
        f"lines/s); in turns K3 {k3_t[0]:.3f}, cuDNN nn.LSTM {k3_lib[0]:.3f},"
        f" {k3_lib[1]:.3f}, K3 {k3_t[1]:.3f} ms")

    # 5. Main path: .clstm save/load, clstmocr's predict_pages and outputs.
    gen = torch.Generator().manual_seed(0)
    spec, net = make_net_init("bidi", {"ninput": D, "nhidden": H,
                                       "noutput": C, "initial": 0.3}, gen)
    codec = Codec([0] + list(range(33, 33 + C - 1)))
    # k/255 pixels, as PNG decoding gives: the card's prepare takes the
    # uint8 upload.
    images = [quantized(synth_line(rng)) for _ in range(N_LINES)]
    with tempfile.TemporaryDirectory() as tmp:
        model = os.path.join(tmp, "bidi.clstm")
        save_net(model, net, codec)
        served = {dp: serve(model, images, dev, C, tmp, dp) for dp in (0, 1)}
    for dp, r in served.items():
        n = r["launches"]
        if n["bidi_lstm_infer"] != len(r["buckets"]) or n[
                "bidi_lstm_infer_xz"]:
            raise AssertionError(f"main path (device_preprocess={dp}) "
                                 f"launched {n} for {len(r['buckets'])} "
                                 "buckets: K3 once a bucket")
        log(serve_line("main", r, dp))
    launches = served[1]["launches"]["bidi_lstm_infer"]

    # 6. K1 against plain: bench profile (both length sets), odd shapes.
    k1_err, k1_state = 0.0, {}
    cases = [(f"B={B} T={T} D={D} H={H} lengths={k}", pf, pr, x, v)
             for k, v in lens.items()]
    cases += [(f"B={sx.shape[0]} T={sx.shape[1]} D={sx.shape[2]} "
               f"H={spf['Wh'].shape[0]} mixed lengths", spf, spr, sx, sl)
              for spf, spr, sx, sl in odd]
    for name, cpf, cpr, cx, cl in cases:
        e, k1_state[name] = compare_k1(cpf, cpr, cx, cl)
        k1_err = max(k1_err, e)
        log(f"[K1] {name}: max|d| over y, gates, cell {e:.3e} (tol {TOL:.0e}),"
            f" every stream exactly 0 on padded frames")

    # 7. K2 against plain on the same inputs, seeded cotangent in ±1; then
    # the chain's widest plans on the plain forward's state.
    k2 = {"chain_rel": 0.0, "chain_abs": 0.0, "red_rel": 0.0, "red_abs": 0.0}
    for (b, t, d, h) in CHAIN_WIDE:
        wpf, wpr = lstm_params(rng, d, h, dev, 0.1), lstm_params(rng, d, h,
                                                                 dev, 0.1)
        wx = uniform(rng, (b, t, d), -1.0, 1.0, dev)
        wl = torch.from_numpy(rng.randint(0, t + 1, b).astype(np.int32)).to(dev)
        with torch.no_grad():
            k1_state[f"B={b} T={t} D={d} H={h} mixed lengths"] = \
                lstm_ops.bidi_lstm_fwd_state_plain(wpf, wpr, wx, wl)
        cases.append((f"B={b} T={t} D={d} H={h} mixed lengths", wpf, wpr, wx,
                      wl))
    for name, cpf, cpr, cx, cl in cases:
        cB, cT = cx.shape[:2]
        cH = cpf["Wh"].shape[0]
        gy = uniform(rng, (cB, cT, 2 * cH), -1.0, 1.0, dev)
        cr, ca, red, ra, f64 = compare_k2(cpf, cpr, cx, cl, k1_state[name],
                                          gy)
        k2["chain_rel"] = max(k2["chain_rel"], cr)
        k2["chain_abs"] = max(k2["chain_abs"], ca)
        k2["red_rel"] = max(k2["red_rel"], *red.values())
        k2["red_abs"] = max(k2["red_abs"], ra)
        log(f"[K2] {name}: chain dz rel {cr:.3e}; reduction rel "
            + ", ".join(f"{n} {v:.3e}" for n, v in red.items())
            + f" (tol {K2_RTOL:.0e} of max|plain|){f64_note(f64)} (at most "
            f"{F64_FACTOR:g}x plain or {F64_FLOOR:.0e}); dz exactly 0 on "
            "padded frames; two calls bitwise equal")
    cases = cases[:len(cases) - len(CHAIN_WIDE)]
    del k1_state

    # 8. K5, K6 and K6b against plain at the bench shape, odd shapes and
    # every branch of their plan; aligned targets against float64 plain.
    k56 = [0.0] * 6
    ctc_plans = {}
    for (cb, ct, cs) in ((B, T, 2 * NCHARS + 1), (64, T, 512),
                         (37, 300, 13)) + CTC_PLAN_SHAPES:
        plan_ = ctc_plan_of(cb, cs)
        ctc_plans[f"B={cb} S={cs}"] = plan_
        errs56 = compare_ctc(*lattice(rng, cb, ct, cs, dev))
        k56 = [max(u, v) for u, v in zip(k56, errs56)]
        r5, a5, r6, a6, r6b, a6b = errs56
        log(f"[K5/K6/K6b] B={cb} T={ct} S={cs} mixed lengths incl. 0, plan "
            f"{plan_['warps']} warps x {plan_['states']} states (0: wide "
            f"branch), {plan_['prefetch']} frames in flight: K5 lr rel {r5:.3e} (abs {a5:.3e}), K6 both/lse rel "
            f"{r6:.3e} (abs {a6:.3e}), K6b rl rel {r6b:.3e} (abs {a6b:.3e}) "
            f"(tol {DP_RTOL:.0e}, valid cells); two calls bitwise equal; "
            f"padded frames carried (K5, K6b), NEG (K6)")
    S81 = 2 * NCHARS + 1
    aligns = {T: align_check(rng, B, T, lens["mixed"], dev)}
    k6b_launches = aligns[T]["k6b_launches"]
    for lt in LONG_T:
        ll = rng.randint(lt // 2, lt + 1, 64).astype(np.int32)
        ll[0] = lt
        aligns[lt] = align_check(rng, 64, lt, torch.from_numpy(ll).to(dev),
                                 dev, alarm=False)

    # 9. Training path at full width: 5 train_batch steps, kernels and plain.
    batch = bench_batch(np.random.RandomState(0), dev)
    tocr = CLSTMOCR(device="cuda")
    tocr.createBidi(codec, nhidden=H)
    tocr.setLearningRate(1e-4, 0.9)
    plain = TrainState.create(make_net_init(
        "bidi", {"ninput": D, "nhidden": H, "noutput": C}, device=dev)[1])
    with torch.no_grad():
        for p, q in zip(plain.net.parameters(), tocr.net.parameters()):
            p.copy_(q)
    train_launches = train_against_plain(tocr, plain, batch, 1e-4, 0.9,
                                         f"train B={B} T={T} S={S81}")
    if min(train_launches[f.__name__] for f in (
            bidi_lstm_fwd_state, bidi_lstm_bwd_chain, bidi_lstm_bwd_reduce,
            ctc_forward, ctc_both)) < 1:
        raise AssertionError(f"training path skipped a kernel: "
                             f"{train_launches}")
    del plain
    urng = np.random.RandomState(3)
    chars = [chr(c) for c in range(65, 91)]
    for _ in range(3):
        out = tocr.train_utf8(synth_line(urng),
                              "".join(urng.choice(chars, 12)))
        if not isinstance(out, str):
            raise AssertionError("train_utf8 did not return a string")
    with tempfile.TemporaryDirectory() as tmp:
        model = os.path.join(tmp, "trained.clstm")
        tocr.save(model)
        back = CLSTMOCR(device="cuda")
        back.load(model)
    if not back.state.step == tocr.state.step == 8:
        raise AssertionError(f"sidecar step {back.state.step}, trained "
                             f"{tocr.state.step}")
    with torch.no_grad():
        for (n, p), q in zip(tocr.net.named_parameters(),
                             back.net.parameters()):
            if not (torch.equal(p, q) and torch.equal(
                    tocr.state.velocity[n], back.state.velocity[n])):
                raise AssertionError(f"sidecar did not restore {n}")
    img = synth_line(urng)
    if back.predict_utf8(img) != tocr.predict_utf8(img):
        raise AssertionError("reloaded model predicts differently")
    log(f"[train] train_utf8 on 3 lines, save + load with the sidecar: step "
        f"{back.state.step}, params and velocity restored exactly, same "
        f"prediction {back.predict_utf8(img)!r}")

    # 10. Learning check: the toy CTC transduction on the card. How well it
    # learns in 120 steps depends on the init (seeds 0-3 decode 62, 16, 26
    # and 64 of 64 lines on CPU): seed 0 is one that learns.
    lspec, lnet = make_net_init(
        "bidi", {"ninput": 4, "nhidden": 16, "noutput": 4, "initial": 0.1},
        torch.Generator().manual_seed(0), dev)
    lstate = TrainState.create(lnet)
    lstep = make_train_step(lspec, lr=0.1, momentum=0.9, loss_kind="ctc",
                            normalization="batch")
    lrng = np.random.RandomState(1)
    llosses = []
    for _ in range(120):
        lstate, m = lstep(lstate, toy_ctc_batch(lrng, dev)[0])
        llosses.append(float(m["loss"]))
    correct = lines = 0
    for _ in range(8):
        tb, syms = toy_ctc_batch(lrng, dev)
        with torch.no_grad():
            ids, vals = greedy_frames(lnet(tb["x"], tb["lengths"]))
        ids, vals = ids.cpu().numpy(), vals.cpu().numpy()
        correct += sum(decode_frames(ids[r], vals[r]) == list(syms[r])
                       for r in range(len(syms)))
        lines += len(syms)
    log(f"[learn] toy CTC, 120 steps: loss {llosses[0]:.3f} -> "
        f"{llosses[-1]:.3f}, {correct}/{lines} fresh lines decoded correctly")
    if not (llosses[-1] < 0.5 * llosses[0] and correct >= lines // 2):
        raise AssertionError("the toy CTC task did not learn on the card")

    # 11. Timing at the bench shape.
    Lb, TLb = batch["lengths"], batch["target_lengths"]
    k_step = host_ms(lambda: tocr.train_batch(batch), 5)
    # lr 0: the plain step's update leaves the trained net as it is.
    vel0 = TrainState.create(tocr.net).velocity
    p_step = host_ms(lambda: plain_train_step(tocr.net, vel0, batch, 0.0,
                                              0.0), 2)
    log(f"[timing] {card} | train_batch B={B} T={T} S={S81}: kernels "
        f"{k_step:.3f} ms/step ({B / k_step * 1e3:.1f} lines/s), plain "
        f"{p_step:.3f} ms/step ({B / p_step * 1e3:.1f} lines/s)")
    log(f"[timing] {card} | train_batch B={B} T={T} S={S81}: the host "
        f"enqueues a step in "
        f"{enqueue_ms(lambda: tocr.train_batch(batch), 3):.3f} ms")
    steps_vs = {}
    if ctc_against:
        steps_vs["bidi"] = step_turns(tocr, batch, ctc_against, 5,
                                      f"bidi B={B} T={T} S={S81}", card)
    par = tocr.net.sub[0]
    tpf, tpr = par.sub[0].weights(), par.sub[1].sub[0].weights()
    bx = batch["x"]
    gy = uniform(rng, (B, T, 2 * H), -1.0, 1.0, dev)
    Wh2, Wx2 = stack2(tpf, tpr, "Wh").detach(), stack2(tpf, tpr, "Wx").detach()
    ms = {}
    with torch.no_grad():
        ys, gs, cs = bidi_lstm_fwd_state(tpf, tpr, bx, Lb)
        dz = bidi_lstm_bwd_chain(gs, cs, gy, Wh2, Lb)
        lm = torch.log(torch.gather(
            torch.softmax(torch.from_numpy(rng.normal(size=(B, T, C)).astype(
                np.float32)).to(dev), -1), 2,
            batch["targets"].long()[:, None, :].expand(B, T, S81)))
        lr = ctc_forward(lm, Lb)
        pairs = {
            "K1": (lambda: bidi_lstm_fwd_state(tpf, tpr, bx, Lb),
                   lambda: lstm_ops.bidi_lstm_fwd_state_plain(tpf, tpr, bx,
                                                              Lb)),
            "K2 chain": (lambda: bidi_lstm_bwd_chain(gs, cs, gy, Wh2, Lb),
                         lambda: lstm_ops.bidi_lstm_bwd_chain_plain(
                             gs, cs, gy, Wh2, Lb)),
            "K2 reduction": (
                lambda: bidi_lstm_bwd_reduce(bx, ys, dz, Wx2, False),
                lambda: lstm_ops.bidi_lstm_bwd_reduce_plain(bx, ys, dz, Wx2,
                                                            False)),
            "K5": (lambda: ctc_forward(lm, Lb),
                   lambda: ctc_ops.ctc_forward_plain(lm, Lb)),
            "K6": (lambda: ctc_both(lm, lr, Lb, TLb),
                   lambda: ctc_ops.ctc_both_plain(lm, lr, Lb, TLb)),
            "K6b": (lambda: ctc_backward(lm, Lb, TLb),
                    lambda: ctc_ops.ctc_backward_plain(lm, Lb, TLb)),
        }
        for name, (kf, pfn) in pairs.items():
            ms[name] = (time_ms(kf, 10), time_ms(pfn, 2))
        if ctc_against:
            for name, a_ in (("K5", (lm, Lb)), ("K6", (lm, lr, Lb, TLb)),
                             ("K6b", (lm, Lb, TLb))):
                ctc_vs[name] = against_turns(
                    f"{name} B={B} T={T} S={S81}",
                    lambda n=name, a_=a_: ctc_against[n](*a_),
                    pairs[name][0], 10, card, dp_err, DP_RTOL)
        ctc_loss_ms = time_ms(ctc_loss_step(rng, dev), 10)
        # The CTC plan's choices, each in turns with the next-best plans:
        # three warps of one state a lane against two of two and one of
        # three at S=81, and eight warps of two against sixteen of one at
        # S=512.
        g512 = torch.Generator(device=dev).manual_seed(5)
        lm512 = torch.log(torch.rand((B, T, 512), device=dev,
                                     generator=g512) + 1e-3)
        tl512 = torch.full((B,), 512, dtype=torch.int32, device=dev)
        ctc_plan_vs = {
            "S=81": ctc_plan_turns(f"B={B} T={T} S={S81}", lm, lr, Lb, TLb,
                                   ((2, 2, 8), (1, 3, 8)), 10, card),
            "S=512": ctc_plan_turns(f"B={B} T={T} S=512", lm512,
                                    ctc_forward(lm512, Lb), Lb, tl512,
                                    ((16, 1, 16),), 10, card)}
        del lm512
        dx_ms = time_ms(lambda: bidi_lstm_bwd_reduce(bx, ys, dz, Wx2, True),
                        10)
        # Library yardsticks in turns with the kernels: cuDNN's forward with
        # grad enabled against K1, the plain version's einsum on prebuilt
        # operands against K2's reduction, cuDNN's backward against K2.
        lstm = cudnn_lstm(tpf, tpr, dev)
        pbx = packed(bx, Lb)
        check_cudnn(lstm, pbx, ys, "K1")
        cu_fwd, cu_fwd_bwd = cudnn_step(lstm, pbx, False)
        k1_t, k1_lib = in_turns(pairs["K1"][0], cu_fwd, 10)
        red_t, red_lib = in_turns(pairs["K2 reduction"][0],
                                  einsum_reduce(bx, ys, dz, Wx2, False), 10)
        cu_bwd_ms = time_ms(cu_fwd_bwd, 10) - mean(k1_lib)
        lib = {"K1": mean(k1_lib), "K2 reduction": mean(red_lib)}
        ms["K1"] = (mean(k1_t), ms["K1"][1])
        ms["K2 reduction"] = (mean(red_t), ms["K2 reduction"][1])
        if fwd_against:
            fwd_vs["K1 bidi"] = against_turns(
                f"K1 B={B} T={T} D={D} H={H}",
                lambda: fwd_against["K1"](tpf, tpr, bx, Lb), pairs["K1"][0],
                10, card)
        # The plan's choice at bidi: the whole slice resident at C=2 against
        # Wh's alone at C=1, [Wx; b] read from L2.
        plan_vs = {f"{k} bidi": plan_turns(
            f"B={B} T={T} D={D} H={H}", k == "K1", tpf, tpr, bx, Lb,
            (1, 4, H, 2), 10, card) for k in ("K3", "K1")}
        if k2_against:
            against["chain H=100"] = against_turns(
                f"K2 chain B={B} T={T} H={H}",
                lambda: k2_against[0](gs, cs, gy, Wh2, Lb),
                pairs["K2 chain"][0], 10, card)
            against["reduction bidi"] = against_turns(
                f"K2 reduction B={B} T={T} D={D} H={H} (no dx)",
                lambda: k2_against[1](bx, ys, dz, Wx2, False),
                pairs["K2 reduction"][0], 10, card)
        del lstm, pbx, cu_fwd, cu_fwd_bwd
    for name, (km, pm) in ms.items():
        log(f"[timing] {card} | {name} at the bench shape: kernel {km:.3f} ms, "
            f"plain {pm:.3f} ms" + (f", library {lib[name]:.3f} ms"
                                    if name in lib else ""))
    log(f"[timing] {card} | K2 reduction with dx: kernel {dx_ms:.3f} ms")
    log(f"[timing] {card} | K5, K6, K6b per frame of the {TRUE_T}-frame "
        f"rows: " + ", ".join(f"{n} {ms[n][0] * 1e3 / TRUE_T:.4f} us"
                              for n in ("K5", "K6", "K6b"))
        + f"; F.ctc_loss forward + backward at B={B} T={T} S={S81} "
        f"{ctc_loss_ms:.3f} ms")
    log(f"[timing] {card} | in turns: K1 {k1_t[0]:.3f}, cuDNN fwd (grad) "
        f"{k1_lib[0]:.3f}, {k1_lib[1]:.3f}, K1 {k1_t[1]:.3f} ms; K2 "
        f"reduction {red_t[0]:.3f}, einsum {red_lib[0]:.3f}, "
        f"{red_lib[1]:.3f}, K2 reduction {red_t[1]:.3f} ms; cuDNN backward "
        f"{cu_bwd_ms:.3f} ms against K2 chain + reduction "
        f"{ms['K2 chain'][0] + ms['K2 reduction'][0]:.3f} ms")
    del ys, gs, cs, dz, lm, lr
    profile_steps(tocr, batch, card, "profile_train_step.txt", "profile")
    del tocr, back, batch

    # 12. K4 against plain at bidi2's second layer (weights ±0.1, so that
    # z = x·Wx + b + h·Wh over 600 terms stays off the gates' saturation),
    # then odd shapes; K2 there on K4's plain state, with and without dx.
    rng2 = np.random.RandomState(2)
    pf2 = lstm_params(rng2, D2, H2, dev, 0.1)
    pr2 = lstm_params(rng2, D2, H2, dev, 0.1)
    x2 = uniform(rng2, (B, T, D2), -1.0, 1.0, dev)
    k4_cases = [(f"B={B} T={T} D={D2} H={H2} lengths={k}", pf2, pr2, x2, v)
                for k, v in lens.items()]
    for (b, t, d, h) in ODD_K4:
        spf, spr = lstm_params(rng2, d, h, dev), lstm_params(rng2, d, h, dev)
        sx = uniform(rng2, (b, t, d), -1.0, 1.0, dev)
        sl = torch.from_numpy(rng2.randint(0, t + 1, b).astype(np.int32)).to(dev)
        k4_cases.append((f"B={b} T={t} D={d} H={h} mixed lengths", spf, spr,
                         sx, sl))
    k4_err, xz_rel = 0.0, 0.0
    k2h = {"chain_rel": 0.0, "red_rel": 0.0}
    k2h_f64 = {}
    for name, cpf, cpr, cx, cl in k4_cases:
        e, xr, state = compare_k4(cpf, cpr, cx, cl)
        k4_err, xz_rel = max(k4_err, e), max(xz_rel, xr)
        log(f"[K4] {name}: max|d| over y (both modes), gates, cell {e:.3e} "
            f"(tol {TOL:.0e}), every stream exactly 0 on padded frames; "
            f"hoisted product vs float64 {xr:.3e} of max|xz| (tol "
            f"{XZ_RTOL:.0e})")
        gy = uniform(rng2, (cx.shape[0], cx.shape[1], 2 * cpf["Wh"].shape[0]),
                     -1.0, 1.0, dev)
        cr, _, red, _, f64 = compare_k2(cpf, cpr, cx, cl, state, gy)
        k2h["chain_rel"] = max(k2h["chain_rel"], cr)
        k2h["red_rel"] = max(k2h["red_rel"], *red.values())
        if cx is x2:
            k2h_f64 = {n: max(k2h_f64.get(n, (0.0, 0.0)), v)
                       for n, v in f64.items()}
        log(f"[K2 hoisted] {name}: chain dz rel {cr:.3e}; reduction rel "
            + ", ".join(f"{n} {v:.3e}" for n, v in red.items())
            + f" (tol {K2_RTOL:.0e} of max|plain|){f64_note(f64)}; two "
            "calls bitwise equal")
        del state

    # 13. Timing at that shape: the hoisted product and K4 against K3 and
    # K1, which compute the projection inside the recurrence, in turns.
    L900 = lens["all900"]
    with torch.no_grad():
        xz2 = lstm_ops.hoisted_projection(pf2, pr2, x2)
        turns = [(hoist, time_ms(lambda: bidi_lstm_infer(
            pf2, pr2, x2, L900, hoist=hoist), 10))
            for hoist in (False, True, True, False)]
        proj_ms = time_ms(lambda: lstm_ops.hoisted_projection(pf2, pr2, x2),
                          10)
        k4_ms = time_ms(lambda: bidi_lstm_infer_xz(pf2, pr2, xz2, L900), 10)
        k4_plain = time_ms(
            lambda: lstm_ops.bidi_lstm_apply_xz(pf2, pr2, xz2, L900), 2)
        k1_2_ms = time_ms(lambda: bidi_lstm_fwd_state(pf2, pr2, x2, L900), 5)
        k4s_ms = time_ms(lambda: bidi_lstm_fwd_state_xz(pf2, pr2, xz2, L900),
                         5)
        k4s_plain = time_ms(lambda: lstm_ops.bidi_lstm_fwd_state_xz_plain(
            pf2, pr2, xz2, L900), 2)
        ys2, gs2, cs2 = bidi_lstm_fwd_state_xz(pf2, pr2, xz2, L900)
        gy2 = uniform(rng2, (B, T, 2 * H2), -1.0, 1.0, dev)
        Wh22, Wx22 = stack2(pf2, pr2, "Wh"), stack2(pf2, pr2, "Wx")
        dz2 = bidi_lstm_bwd_chain(gs2, cs2, gy2, Wh22, L900)
        k2h_ms = {
            "K2 chain": (
                time_ms(lambda: bidi_lstm_bwd_chain(gs2, cs2, gy2, Wh22, L900),
                        5),
                time_ms(lambda: lstm_ops.bidi_lstm_bwd_chain_plain(
                    gs2, cs2, gy2, Wh22, L900), 2)),
            "K2 reduction with dx": (
                time_ms(lambda: bidi_lstm_bwd_reduce(x2, ys2, dz2, Wx22, True),
                        5),
                time_ms(lambda: lstm_ops.bidi_lstm_bwd_reduce_plain(
                    x2, ys2, dz2, Wx22, True), 2)),
        }
        # Library yardsticks in turns: the plain version's two einsums on
        # prebuilt operands against the reduction with dx; cuDNN's LSTM at
        # D=400 (inference, and forward with grad) against the hoisted
        # product + K4 in each mode; cuDNN's backward against K2.
        red2_t, red2_lib = in_turns(
            lambda: bidi_lstm_bwd_reduce(x2, ys2, dz2, Wx22, True),
            einsum_reduce(x2, ys2, dz2, Wx22, True), 5)
        k2h_ms["K2 reduction with dx"] = (mean(red2_t),
                                          k2h_ms["K2 reduction with dx"][1])
        lstm2 = cudnn_lstm(pf2, pr2, dev)
        px2 = packed(x2, L900)
        check_cudnn(lstm2, px2, ys2, "K4")
        k4_t, k4_lib = in_turns(lambda: bidi_lstm_infer(
            pf2, pr2, x2, L900, hoist=True), lambda: lstm2(px2), 5)
        cu2_fwd, cu2_fwd_bwd = cudnn_step(lstm2, px2, True)
        k4s_t, k4s_lib = in_turns(lambda: bidi_lstm_fwd_state_xz(
            pf2, pr2, lstm_ops.hoisted_projection(pf2, pr2, x2), L900),
            cu2_fwd, 5)
        cu2_bwd_ms = time_ms(cu2_fwd_bwd, 5) - mean(k4s_lib)
        if fwd_against:
            fwd_vs["K4 bidi2 layer 2"] = against_turns(
                f"K4 B={B} T={T} H={H2}",
                lambda: fwd_against["K4"](pf2, pr2, xz2, L900),
                lambda: bidi_lstm_infer_xz(pf2, pr2, xz2, L900), 5, card)
            fwd_vs["K4 state bidi2 layer 2"] = against_turns(
                f"K4 state B={B} T={T} H={H2}",
                lambda: fwd_against["K4 state"](pf2, pr2, xz2, L900),
                lambda: bidi_lstm_fwd_state_xz(pf2, pr2, xz2, L900), 5, card)
            # K3 with the projection inside, on the L2 plan: at this layer
            # (D=400, the routing comparison above) and at the widest input
            # that does not hoist at H=200 (D=255).
            fwd_vs["K3 in-kernel projection D=400"] = against_turns(
                f"K3 B={B} T={T} D={D2} H={H2}",
                lambda: fwd_against["K3"](pf2, pr2, x2, L900),
                lambda: bidi_lstm_infer(pf2, pr2, x2, L900, hoist=False), 3,
                card)
        rngw = np.random.RandomState(5)
        pw, qw = (lstm_params(rngw, 255, H2, dev, 0.1),
                  lstm_params(rngw, 255, H2, dev, 0.1))
        xw = uniform(rngw, (B, T, 255), -1.0, 1.0, dev)
        if fwd_against:
            fwd_vs["K3 in-kernel projection D=255"] = against_turns(
                f"K3 B={B} T={T} D=255 H={H2}",
                lambda: fwd_against["K3"](pw, qw, xw, L900),
                lambda: bidi_lstm_infer(pw, qw, xw, L900), 3, card)
        # The L2 plan's choice at the widest input that does not hoist:
        # C=4 with 20 rows against C=8 with 40.
        plan_vs["K3 D=255 H=200"] = plan_turns(
            f"B={B} T={T} D=255 H={H2}", False, pw, qw, xw, L900,
            (8, 40, H2 // 8, 0), 3, card)
        del pw, qw, xw
        if k2_against:
            against["chain H=200"] = against_turns(
                f"K2 chain B={B} T={T} H={H2}",
                lambda: k2_against[0](gs2, cs2, gy2, Wh22, L900),
                lambda: bidi_lstm_bwd_chain(gs2, cs2, gy2, Wh22, L900), 5,
                card)
            against["reduction bidi2 layer 2"] = against_turns(
                f"K2 reduction with dx B={B} T={T} D={D2} H={H2}",
                lambda: k2_against[1](x2, ys2, dz2, Wx22, True),
                lambda: bidi_lstm_bwd_reduce(x2, ys2, dz2, Wx22, True), 5,
                card)
        del lstm2, px2, cu2_fwd, cu2_fwd_bwd
    k3_2 = [m for h, m in turns if not h]
    k4_2 = [m for h, m in turns if h]
    shape2 = f"B={B} T={T} D={D2} H={H2} len={TRUE_T}"
    log(f"[timing] {card} | inference at {shape2}, in turns (in-kernel, "
        f"hoisted, hoisted, in-kernel): " + ", ".join(
            f"{'hoisted product + K4' if h else 'K3'} {m:.3f} ms"
            for h, m in turns))
    log(f"[timing] {card} | {shape2}: hoisted product {proj_ms:.3f} ms "
        f"({2 * B * T * D2 * 8 * H2 / proj_ms / 1e9:.1f} TFLOP/s), K4 "
        f"recurrence {k4_ms:.3f} ms (plain {k4_plain:.3f}); state mode: K4 "
        f"{k4s_ms:.3f} ms (plain {k4s_plain:.3f}), K1 with the projection "
        f"inside {k1_2_ms:.3f} ms")
    for name, (km, pm) in k2h_ms.items():
        log(f"[timing] {card} | {name} at {shape2}: kernel {km:.3f} ms, "
            f"plain {pm:.3f} ms")
    log(f"[timing] {card} | {shape2}, in turns: K2 reduction with dx "
        f"{red2_t[0]:.3f}, einsums {red2_lib[0]:.3f}, {red2_lib[1]:.3f}, K2 "
        f"reduction {red2_t[1]:.3f} ms; product + K4 {k4_t[0]:.3f}, cuDNN "
        f"nn.LSTM {k4_lib[0]:.3f}, {k4_lib[1]:.3f}, product + K4 "
        f"{k4_t[1]:.3f} ms; product + K4 state {k4s_t[0]:.3f}, cuDNN fwd "
        f"(grad) {k4s_lib[0]:.3f}, {k4s_lib[1]:.3f}, product + K4 state "
        f"{k4s_t[1]:.3f} ms; cuDNN backward with dx {cu2_bwd_ms:.3f} ms "
        f"against K2 chain + reduction "
        f"{k2h_ms['K2 chain'][0] + k2h_ms['K2 reduction with dx'][0]:.3f} ms")
    if k2h_f64:
        log(f"[K2 hoisted] {shape2}{f64_note(k2h_f64)}")
    del xz2, ys2, gs2, cs2, gy2, dz2, x2

    # 14. bidi2 serving: the config-4 net saved as .clstm, clstmocr's path.
    codec2 = Codec([0] + [0x4E00 + i for i in range(C2 - 1)])
    maker = CLSTMOCR(device="cuda")
    maker.createBidi(codec2, H2, kind="bidi2", initial=0.3)
    with tempfile.TemporaryDirectory() as tmp:
        model2 = os.path.join(tmp, "bidi2.clstm")
        maker.save(model2, sidecar=False)
        served2 = {dp: serve(model2, images, dev, C2, tmp, dp)
                   for dp in (0, 1)}
    del maker
    for dp, r in served2.items():
        n, nb2 = r["launches"], len(r["buckets"])
        if not n["bidi_lstm_infer"] == n["bidi_lstm_infer_xz"] == nb2:
            raise AssertionError(f"bidi2 serving (device_preprocess={dp}): "
                                 f"{nb2} buckets, launches {n}: each bucket "
                                 "must launch K3 on layer 1 and K4 on layer 2")
        log(serve_line("bidi2 main", r, dp))
    served2 = served2[1]["launches"]

    # 15. bidi2 training at the config-4 bench profile (bench.py:538-600).
    batch2 = bench_batch(np.random.RandomState(0), dev, C2)
    tocr2 = CLSTMOCR(device="cuda")
    tocr2.createBidi(codec2, nhidden=H2, kind="bidi2")
    tocr2.setLearningRate(1e-4, 0.9)
    plain2 = TrainState.create(make_net_init(
        "bidi2", {"ninput": D, "nhidden": H2, "noutput": C2}, device=dev)[1])
    with torch.no_grad():
        for p, q in zip(plain2.net.parameters(), tocr2.net.parameters()):
            p.copy_(q)
    train2 = train_against_plain(tocr2, plain2, batch2, 1e-4, 0.9,
                                 f"train bidi2 B={B} T={T} S={S81} C={C2}")
    want2 = {"bidi_lstm_fwd_state": 5, "bidi_lstm_fwd_state_xz": 5,
             "bidi_lstm_bwd_chain": 10, "bidi_lstm_bwd_reduce": 10,
             "ctc_forward": 5, "ctc_both": 5}
    if {k: v for k, v in train2.items() if v} != want2:
        raise AssertionError(f"bidi2 training launches {train2}, want "
                             f"{want2}: K1 and K4 once a step, K2 on both "
                             f"layers, K5 and K6")
    del plain2
    k_step2 = host_ms(lambda: tocr2.train_batch(batch2), 5)
    vel2 = TrainState.create(tocr2.net).velocity
    p_step2 = host_ms(lambda: plain_train_step(tocr2.net, vel2, batch2, 0.0,
                                               0.0), 1)
    log(f"[timing] {card} | bidi2 train_batch B={B} T={T} S={S81} C={C2}: "
        f"kernels {k_step2:.3f} ms/step ({B / k_step2 * 1e3:.1f} lines/s), "
        f"plain {p_step2:.3f} ms/step ({B / p_step2 * 1e3:.1f} lines/s)")
    log(f"[timing] {card} | bidi2 train_batch: the host enqueues a step in "
        f"{enqueue_ms(lambda: tocr2.train_batch(batch2), 3):.3f} ms")
    if ctc_against:
        steps_vs["bidi2"] = step_turns(tocr2, batch2, ctc_against, 3,
                                       f"bidi2 B={B} T={T} S={S81} C={C2}",
                                       card)
    layer1 = tocr2.net.sub[0]
    with torch.no_grad():
        k1_l1 = time_ms(lambda: bidi_lstm_fwd_state(
            layer1.sub[0].weights(), layer1.sub[1].sub[0].weights(),
            batch2["x"], batch2["lengths"]), 5)
    log(f"[timing] {card} | K1 at bidi2's layer 1 B={B} T={T} D={D} H={H2} "
        f"len={TRUE_T}: {k1_l1:.3f} ms")
    # K2's reduction at layer 1 (D=48, H=200, no dx) on K1's state and the
    # chain's dz for a seeded cotangent, in turns with the einsum.
    with torch.no_grad():
        l1f, l1r = layer1.sub[0].weights(), layer1.sub[1].sub[0].weights()
        x1, L1 = batch2["x"], batch2["lengths"]
        if fwd_against:
            fwd_vs["K1 bidi2 layer 1"] = against_turns(
                f"K1 B={B} T={T} D={D} H={H2}",
                lambda: fwd_against["K1"](l1f, l1r, x1, L1),
                lambda: bidi_lstm_fwd_state(l1f, l1r, x1, L1), 5, card)
        # The plan's choice at bidi2's first layer: Wh's slice alone
        # resident at C=4 against the whole slice at C=8 (40 rows).
        plan_vs["K1 bidi2 layer 1"] = plan_turns(
            f"B={B} T={T} D={D} H={H2}", True, l1f, l1r, x1, L1,
            (8, 40, H2 // 8, 1), 5, card)
        y1, g1, c1 = bidi_lstm_fwd_state(l1f, l1r, x1, L1)
        Wx21 = stack2(l1f, l1r, "Wx").detach()
        dz1 = bidi_lstm_bwd_chain(g1, c1, uniform(rng2, (B, T, 2 * H2), -1.0,
                                                  1.0, dev),
                                  stack2(l1f, l1r, "Wh").detach(), L1)
        del g1, c1
        red1_t, red1_lib = in_turns(
            lambda: bidi_lstm_bwd_reduce(x1, y1, dz1, Wx21, False),
            einsum_reduce(x1, y1, dz1, Wx21, False), 5)
        red1_plain = time_ms(lambda: lstm_ops.bidi_lstm_bwd_reduce_plain(
            x1, y1, dz1, Wx21, False), 2)
        if k2_against:
            against["reduction bidi2 layer 1"] = against_turns(
                f"K2 reduction B={B} T={T} D={D} H={H2} (no dx)",
                lambda: k2_against[1](x1, y1, dz1, Wx21, False),
                lambda: bidi_lstm_bwd_reduce(x1, y1, dz1, Wx21, False), 5,
                card)
        del y1, dz1
    log(f"[timing] {card} | K2 reduction at bidi2's layer 1 B={B} T={T} "
        f"D={D} H={H2} len={TRUE_T}, in turns: kernel {red1_t[0]:.3f}, "
        f"einsum {red1_lib[0]:.3f}, {red1_lib[1]:.3f}, kernel "
        f"{red1_t[1]:.3f} ms; plain {red1_plain:.3f} ms")
    fwd2_ms = time_ms(lambda: apply_net(tocr2.net, batch2["x"],
                                        batch2["lengths"], inference=True), 5)
    log(f"[timing] {card} | bidi2 batched forward (K3, hoisted product, K4, "
        f"softmax) B={B} T={T} len={TRUE_T}: {fwd2_ms:.3f} ms/batch "
        f"({B / fwd2_ms * 1e3:.1f} lines/s)")
    profile_steps(tocr2, batch2, card, "profile_train_step_bidi2.txt",
                  "profile bidi2")

    del tocr2, batch2

    # 16. The u8 pixel table on the card.
    check_u8(dev, np.random.RandomState(4))

    # 17. clstmocrtrain at full bidi width on a synthetic corpus.
    with tempfile.TemporaryDirectory() as tmp:
        trained = ocrtrain(dev, tmp)

    # 18. Report. bound_ms from this run's shapes and valid frames (lengths
    # 900 at both bench shapes); library_ms a library call timed in turns
    # with the kernel above, or None where no one call computes the same
    # function.
    S81_bytes = 4 * B * T * S81
    entries = [
        ("bidi_lstm_fwd (K3)", "clstm_tpu_torch/csrc/bidi_lstm_fwd.cu",
         "clstm_tpu/ops/pallas_lstm.py:197", launches, max(errs.values()),
         None, (k_ms, p_ms), lstm_bound("fwd", B, T, D, H, V900), k3_lib_ms),
        ("bidi_lstm_fwd_state (K1)", "clstm_tpu_torch/csrc/bidi_lstm_fwd.cu",
         "clstm_tpu/ops/pallas_lstm.py:197",
         train_launches["bidi_lstm_fwd_state"], k1_err, None, ms["K1"],
         lstm_bound("fwd_state", B, T, D, H, V900), lib["K1"]),
        ("bidi_lstm_bwd_chain (K2)", "clstm_tpu_torch/csrc/bidi_lstm_bwd.cu",
         "clstm_tpu/ops/pallas_lstm.py:299",
         train_launches["bidi_lstm_bwd_chain"], k2["chain_abs"],
         k2["chain_rel"], ms["K2 chain"],
         lstm_bound("chain", B, T, D, H, V900), None),
        ("bidi_lstm_bwd_reduce (K2)", "clstm_tpu_torch/csrc/bidi_lstm_bwd.cu",
         "clstm_tpu/ops/pallas_lstm.py:299",
         train_launches["bidi_lstm_bwd_reduce"], k2["red_abs"],
         k2["red_rel"], ms["K2 reduction"],
         lstm_bound("reduce", B, T, D, H, V900), lib["K2 reduction"]),
        ("ctc_forward (K5)", "clstm_tpu_torch/csrc/ctc_dp.cu",
         "clstm_tpu/ops/pallas_ctc.py:41", train_launches["ctc_forward"],
         k56[1], k56[0], ms["K5"], bound(0, 2 * S81_bytes + 4 * B), None),
        ("ctc_both (K6)", "clstm_tpu_torch/csrc/ctc_dp.cu",
         "clstm_tpu/ops/pallas_ctc.py:88", train_launches["ctc_both"],
         k56[3], k56[2], ms["K6"],
         bound(0, 3 * S81_bytes + 4 * B * S81 + 8 * B), None),
        ("bidi_lstm_fwd_xz (K4)", "clstm_tpu_torch/csrc/bidi_lstm_fwd.cu",
         "clstm_tpu/ops/pallas_lstm.py:197", served2["bidi_lstm_infer_xz"],
         k4_err, None, (k4_ms, k4_plain),
         lstm_bound("xz", B, T, D2, H2, V900), mean(k4_lib)),
        ("bidi_lstm_fwd_xz_state (K4)",
         "clstm_tpu_torch/csrc/bidi_lstm_fwd.cu",
         "clstm_tpu/ops/pallas_lstm.py:197", train2["bidi_lstm_fwd_state_xz"],
         k4_err, None, (k4s_ms, k4s_plain),
         lstm_bound("xz_state", B, T, D2, H2, V900), mean(k4s_lib)),
        ("ctc_backward (K6b)", "clstm_tpu_torch/csrc/ctc_dp.cu",
         "clstm_tpu/ops/pallas_ctc.py:88", k6b_launches, k56[5], k56[4],
         ms["K6b"], bound(0, 2 * S81_bytes + 8 * B), None),
    ]
    # K4's rows also carry the product it runs on, the kernel with the
    # projection inside (K3, K1) at the same shape, and the hoisted total
    # that cuDNN's whole layer (library_ms) is set against; K1's and K2's
    # rows the other shapes the bidi2 step runs them at, K2's cuDNN's
    # backward against K2 whole and, with --k2-against, the in-turn times of
    # the other K2.
    extra = {"bidi_lstm_fwd (K3)": {
                 "plan": plans["K3 bidi"],
                 "bidi2_layer1_plan": plans["K3 bidi2 layer 1"]},
             "bidi_lstm_fwd_state (K1)": {
                 "plan": plans["K1 bidi"],
                 "plan_choice": plan_vs,
                 "bidi2_layer1": dict(zip(
                     ("ms", "bound_ms", "bound_by", "plan"),
                     (k1_l1, *lstm_bound("fwd_state", B, T, D, H2, V900),
                      plans["K1 bidi2 layer 1"])))},
             "bidi_lstm_fwd_xz (K4)": {
                 "plan": plans["K4 bidi2 layer 2"],
                 "hoisted_product_ms": proj_ms,
                 "in_kernel_projection_ms": mean(k3_2),
                 "hoisted_total_ms": mean(k4_t)},
             "bidi_lstm_fwd_xz_state (K4)": {
                 "plan": plans["K4 state bidi2 layer 2"],
                 "hoisted_product_ms": proj_ms,
                 "in_kernel_projection_ms": k1_2_ms,
                 "hoisted_total_ms": mean(k4s_t)},
             "bidi_lstm_bwd_chain (K2)": {
                 "k2_ms": ms["K2 chain"][0] + ms["K2 reduction"][0],
                 "cudnn_backward_ms": cu_bwd_ms,
                 "bidi2_layer2": dict(zip(
                     ("ms", "plain_ms", "bound_ms", "bound_by"),
                     (*k2h_ms["K2 chain"],
                      *lstm_bound("chain", B, T, D2, H2, V900)))),
                 "bidi2_layer2_k2_ms": k2h_ms["K2 chain"][0]
                 + k2h_ms["K2 reduction with dx"][0],
                 "bidi2_layer2_cudnn_backward_ms": cu2_bwd_ms},
             "bidi_lstm_bwd_reduce (K2)": {
                 "with_dx_ms": dx_ms,
                 "bidi2_layer1": dict(zip(
                     ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"),
                     (mean(red1_t), red1_plain, mean(red1_lib),
                      *lstm_bound("reduce", B, T, D, H2, V900)))),
                 "bidi2_layer2_dx": dict(zip(
                     ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                      "f64_rel"),
                     (*k2h_ms["K2 reduction with dx"], mean(red2_lib),
                      *lstm_bound("reduce", B, T, D2, H2, V900, dx=True),
                      k2h_f64)))}}
    plans["K3 D=400 in-kernel"] = fwd_plan_of(dev, B, D2, H2, False, False)
    plans["K3 D=255"] = fwd_plan_of(dev, B, 255, H2, False, False)
    extra["bidi_lstm_fwd (K3)"].update(
        {"in_kernel_D400_plan": plans["K3 D=400 in-kernel"],
         "D255_plan": plans["K3 D=255"]})
    for key, turns_ in fwd_vs.items():
        row = ("bidi_lstm_fwd (K3)" if key.startswith("K3") else
               "bidi_lstm_fwd_state (K1)" if key.startswith("K1") else
               "bidi_lstm_fwd_xz_state (K4)" if key.startswith("K4 state")
               else "bidi_lstm_fwd_xz (K4)")
        extra[row].setdefault("fwd_against", {})[key] = turns_
    for key, turns_ in against.items():
        row = ("bidi_lstm_bwd_chain (K2)" if key.startswith("chain")
               else "bidi_lstm_bwd_reduce (K2)")
        extra[row].setdefault("k2_against", {})[key] = turns_
    # The CTC rows: time per frame of the 900-frame rows, the plan, the
    # in-turn times of --ctc-against; K6's row the F.ctc_loss yardstick and
    # the aligned targets' distances from float64 at each T.
    for name, key in (("ctc_forward (K5)", "K5"), ("ctc_both (K6)", "K6"),
                      ("ctc_backward (K6b)", "K6b")):
        row = extra.setdefault(name, {})
        row["per_frame_us"] = ms[key][0] * 1e3 / TRUE_T
        row["plan"] = ctc_plans[f"B={B} S={S81}"]
        if key in ctc_vs:
            row["ctc_against"] = ctc_vs[key]
    extra["ctc_both (K6)"]["ctc_loss_ms"] = ctc_loss_ms
    extra["ctc_forward (K5)"]["plan_choice"] = ctc_plan_vs
    if steps_vs:
        extra["ctc_both (K6)"]["train_step_ctc_against"] = steps_vs
    extra["ctc_both (K6)"]["aligned_vs_float64"] = {
        str(t_): {k: v for k, v in a.items() if k != "k6b_launches"}
        for t_, a in aligns.items()}
    # The serving rows also carry clstmocr both ways (lines/s, launches,
    # the card's prepare per bucket); the training rows their launches in
    # the clstmocrtrain run.
    extra["bidi_lstm_fwd (K3)"]["clstmocr"] = {
        f"device_preprocess={dp}": dict(
            lines_per_s=N_LINES / r["e2e_s"],
            lines_per_s_range=[N_LINES / r["e2e_range"][1],
                               N_LINES / r["e2e_range"][0]],
            cold_lines_per_s=N_LINES / r["cold_s"],
            launches=r["launches"]["bidi_lstm_infer"],
            **({"prepare_span_ms": r["prep_ms"],
                "prepare_host_ms": r["prep_host_ms"],
                "prepare_busy_ms": r["prep_busy_ms"],
                "prepare_share": r["prep_share"]} if dp else {}))
        for dp, r in served.items()}
    for name, key in (("bidi_lstm_fwd_state (K1)", "bidi_lstm_fwd_state"),
                      ("bidi_lstm_bwd_chain (K2)", "bidi_lstm_bwd_chain"),
                      ("bidi_lstm_bwd_reduce (K2)", "bidi_lstm_bwd_reduce"),
                      ("ctc_forward (K5)", "ctc_forward"),
                      ("ctc_both (K6)", "ctc_both")):
        extra.setdefault(name, {})["clstmocrtrain_launches"] = \
            trained["launches"].get(key, 0)
    kernels = []
    for name, src, rep, n, err, rel, (km, pm), (bms, bby), lms in entries:
        e = {"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": n, "max_abs_err": err, "ms": km, "plain_ms": pm,
             "bound_ms": bms, "bound_by": bby, "library_ms": lms}
        if rel is not None:
            e["max_rel_err"] = rel
        e.update(extra.get(name, {}))
        kernels.append(e)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
