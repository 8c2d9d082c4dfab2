#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (clstm_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--k2-against SRC] [--fwd-against SRC]
                          [--ctc-against SRC] [--toy-seeds N]

Drives the port's serving path — the path `clstmocr` runs — and its training
path — CLSTMOCR.train_batch, a CTC training step — at the full width of the
flagship `bidi` model (48 inputs, nhidden 100, 96 classes) and of the deep
`bidi2` model of BASELINE config 4 (48 inputs, nhidden 200 in both layers,
400 classes), whose second layer takes the hoisted-projection kernel K4;
and the string-transduction path of BASELINE config 5 (`clstmfiltertrain`
and `clstmfilter` on a g2p corpus: 19 inputs, nhidden 100, 21 classes).
The LSTM kernels run in two precisions: strict f32 and the bf16 mode
(``xz_bf16``, the JAX package's production mode, the card's default when
no precision is asked for). The direct kernel checks of phases 3-8 and
12-13 hold the f32 kernels; the main paths (5, 9, 14, 15, 17, 21) run the
card's default, and 5, 9, 14, 15 and 21's steps the other mode as well,
each run with the launch counts reset just before and read just after;
phases 18-20 hold and time the bf16 kernels and run the learning check;
phase 24 drives the routes that run no LSTM kernel (the JAX package's
compute_dtype and fuse_bidi=False), the trace and display_every:

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
     each width bucket must launch K3 once (in the bf16 mode on the fwd16
     kernel in every bucket, launches16 == launches, and in f32 never),
     the per-frame ids must agree
     with the plain path run on the same prepared batches, and the card's
     per-line lengths must match the same prepare run on the CPU (all but
     one line in 64, by +-1); lines/s both ways (median and range of 7
     warm passes) and the device prepare's ms a bucket inside those passes
     (its span on the card, the host's time in it, and the card's busy
     time in one such call alone); predict_batch_images(sync=False) must
     return behind a long device sleep, that is without waiting for the
     card: on 8 lines in f32; in bf16 after one call on 8 lines, on a
     number of lines no call has run before;
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
     the card (bidi, nhidden 16, 4 classes, B=8, T=24, 120 steps), in both
     precisions from the same init (20 compares them); with --toy-seeds N
     also from the inits of seeds 1-N, logged only;
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
     must launch K3 (layer 1) and K4 (layer 2), on the fwd16 kernel as in
     5, frame ids and lengths as in 5;
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
     kernel activity);
 18. the bf16 kernels (K3, K1, K4 in both modes, K2's chain and reduction,
     with dx from f32 and from bf16 x, and without) against their plain bf16
     versions and the float64 evaluation of the same rounded recipe, at the
     bench profile (lengths 900 and mixed), bidi2's two layer shapes and
     BF16_ODD: each within BF16_FACTOR times the plain version's distance
     from float64, max|Δ| (floor BF16_ULP, F64_FLOOR for dW) and, on
     streams of MEAN_MIN_VALUES valid values or more, mean|Δ| (floor
     F64_FLOOR), padded frames exactly 0, two calls bitwise equal; planted
     controls: K3's float64 recipe with h left unrounded, and with the bias
     kept f32, put in the kernel's place at the bench shape, must fail that
     rule; the bf16 plans (fwd_plan with 2-byte elements) with the kernel's
     own count of their shared memory; K2's bf16 chain across its plan's
     edges (CHAIN16_EDGES: H of 1 to 2048, B of 1 to 1024, T of 1 to 70,
     mixed, all-zero and no lengths, the plan and, beside the L2 branch
     where it is the faster, the cluster plan), each plan logged with the
     kernel's own count of its shared memory; K1 and K4's state mode, and
     K3 and K4 inference, on the bf16 tensor-core kernel (fwd16_plan)
     across its plan's edges (FWD16_EDGES: H of 1 to 2048, B of 1 to 1024,
     T of 1 to 70, mixed, all-zero and no lengths, the plan and, beside the
     FMA kernel where fwd16_prefers_old, the fwd16 plan), each plan logged
     with the kernel's own count of its shared memory (the mode's
     instance), and the planted controls at bidi2's two layer shapes
     (lengths 900 and mixed), where that kernel runs both modes;
 19. each bf16 kernel timed in turns with its f32 mode at the bench shapes,
     and with its library call (cuDNN's nn.LSTM in bf16, the plain version's
     einsums on bf16 operands); train_batch in both modes in turns (11, 15);
     K2's bf16 reduction at its four shapes (K2_BF16_SHAPES) in turns with
     the einsums, with its plan, its bound and the host's enqueue time;
     K2's bf16 chain at its three shapes (CHAIN16_SHAPES) in turns with the
     branch its plan did not take (the L2 branch, the earlier bf16 chain,
     or the cluster plan); the fwd16 kernel at FWD16_SHAPES (bidi's K1,
     bidi2's K1 and K4 state, the filter's K1 at T=16 and 32) in turns with
     the FMA kernel's bf16 instance forced at its own plan and with cuDNN's
     bf16 nn.LSTM forward with grad, with its bound (and in the log a serial
     floor derived from an earlier run's cluster barrier), and its
     inference instances at FWD16_INFER_SHAPES (K3 and K4 at the same
     shapes) the same way, with cuDNN's forward without grad; the bidi
     and bidi2 bf16 train_batch steps in turns with K1 and K4 state on PR
     5's kernel (phases 11 and 15), whose profiles must name the fwd16
     kernel, and whose 5 bf16 steps (phases 9 and 15) must each launch it;
     bench.py's infer profile (make_predict_step, bf16, B=256, T=1024,
     lengths 900) of bidi and bidi2 with K3 and K4 on the FMA kernel and on
     the fwd16 kernel in turns, in lines/s (phases 11 and 15);
 20. the learning check, both modes from the same init on the same
     batches, at each init of LEARN_SEEDS: bidi at full width on a glyph
     corpus made in code (LEARN_*); f32 trains until its test CER is below
     half its start (N steps) and on to 2N, bf16 2N steps; bf16 passes at
     an init when its own CER halves by step N + LEARN_STEP_SLACK and its
     CER at 2N is at most f32's + LEARN_SLACK, and passes when it passes at
     every init (the earlier single point, the CERs at N, is logged; the
     toy task of 10 is a record). The script fails if bf16 is the card's
     default and the check did not pass;
 21. the filter path at full width (G2P_*, FILTER_*): the run-cmu g2p
     corpus of bench.py:269-345 built in code (4,096 training pairs, 512
     held-out words) on a TextDeviceDataset; K3, K1, K2, K5 and K6 against
     their plain versions on a gathered batch of each T bucket (16 and 32;
     one-hot x of 19 columns, B=256) and timed at T=32 with their library
     calls (the bf16 reduction with the einsums on bf16 operands); an input
     alphabet of BIG_ALPHABET symbols (B=256, T=32), where the layer
     hoists: K3 with the projection inside and K4 each against plain and
     against each other, K4 in both modes in turns, product + K4 in turns
     with cuDNN's nn.LSTM in each mode, and apply_net takes K4; 5
     train_batch_block steps from one .clstm against 5 plain steps at each
     T bucket, in both precisions (the limits of 9); clstmfiltertrain
     through its main (B=256, automatic K): K3, K1, K2, K5 and K6 must be
     launched and its TESTERR fall below half its first value; pairs/s
     (median and range of FILTER_PASSES warm passes of its train_blocks
     loop), the card's idle share in the first (torch.profiler, kernel
     activity) and the host's enqueue ms of a block; clstmfilter on the
     saved model: the batched output equals the batch_size=1 output line
     for line, K3 once a batch and once a line (on the fwd16 kernel where
     the call is past fwd16_prefers_old's window), its frame ids against
     the plain path; clstmfilter's batched run and a clstmfiltertrain pass
     in turns with that window kept and shut (fwd16_window_off; the shut
     turns must take the fwd16 kernel in every call), in strings/s and
     pairs/s;
 22. whether the native host I/O library (io/native.py: g++, png.h,
     libpng) builds on the machine, and so which PNG reader and line loader
     the OCR phases took; where it builds, read_png bit for bit against PIL
     on all 256 grey levels and prepare_line against the Python normalizer
     within tests/test_native.py's envelope;
 23. data parallelism (clstm_tpu_torch/parallel/): (a) a 1-rank NCCL group
     on the card: 3 make_parallel_train_step steps on the bench batch
     (bidi, the default precision) bitwise equal to make_train_step's, the
     all_reduce's ms a step from torch.profiler, and a K=4 parallel block
     returned behind a device sleep without waiting for the card; (b) two
     gloo ranks sharing cuda:0 (NCCL refuses two ranks on one card),
     started with spawn: 5 parallel steps of bidi and 3 of bidi2 (128 rows
     a rank, lr DP_LR) in both precisions against the same steps on one
     rank on the full batch (losses rtol 2e-4, parameters rtol 3e-4 and
     atol 2e-5, the JAX package's DP tolerances, plus DP_BF16_SLACK of the
     largest move in the bf16 mode, whose affine weight gradient each rank
     rounds to bf16 before the sum), K1, K2, K5, K6 (and K4 for bidi2)
     launched on each rank, the step's and one gloo all_reduce's ms; (c)
     clstmocrtrain (phase 17's corpus, B=32, K=64, 512 trials) and
     clstmfiltertrain (phase 21's corpus, B=256, K=64, 4 blocks) with
     mesh=2 device=cuda:0 against mesh=1 from one .clstm, weights within
     (b)'s limits, lines/s and pairs/s labelled as a check, not a scaling
     figure;
 24. the routes the JAX package sends to lax.scan on every backend, which
     the port runs in its plain loops on every device (no LSTM kernel), at
     full bidi width on the bench batch of 9, lr CD_LR: (a)
     make_train_step(compute_dtype=torch.bfloat16), CD_STEPS steps with no
     LSTM kernel launched and K5, K6 once a step; its step-1 loss and
     gradients against the same code on the CPU within CD_RATIO of the
     card's compute_dtype-vs-strict-f32 distance, which the planted recipe
     with dWh summed in f32 must fail; its warm steps in turns with the
     default kernel step; (b) fuse_bidi=False in strict f32 (train.py's
     losses with apply_net(fuse_bidi=False)): step 1 against the fused f32
     kernel step within 9's step-1 limits, no LSTM kernel, timed in turns
     with it; (c) make_forward(compute_dtype=torch.bfloat16) over the
     bench profile, timed; (d) utils/profiling.trace around one default
     step in a fresh process: the Chrome trace (chiprun_out/trace/) must
     name K1's, K2's, K5's and K6's kernels (the same trace in this
     process, late in the run, is logged: such a session lost its first
     kernel records), and Throughput over warm steps agree with their
     CUDA-event times within THROUGHPUT_RTOL; (e) clstmocrtrain on 17's
     corpus with display_every=DISPLAY_EVERY and with 0 (DISPLAY_ENV): the
     same TESTERR lines, the PNG written where matplotlib is (and not
     where it is not), and, with a device sleep queued right after a
     block, the next block starting in under half the sleep, the display
     drawn between;
 25. t_buckets=auto and compile_cache (AUTO_*): (a) the card's dispatch
     round trip (measure_dispatch_penalty_rows) and the two cost constants
     of auto_t_cuts on the bench batch, the default bidi step's padded
     frame-rows/s and the CTC alignment's ms per lattice cell over the
     step's ms per frame-row, beside the card's name and power limit; (b)
     auto_t_cuts on 17's training corpus with the CLI's hints, and
     DeviceDataset(t_buckets="auto") from host-prepared samples and from
     from_files holding exactly their groups; one train_batch step at a cut
     off T_BUCKETS_FINE against the plain step within 9's step-1 limits,
     K1, K2, K5 and K6 launched once each; (c) clstmocrtrain on 17's
     corpus (B=32, K=64, a quarter of its 64-epoch plan) with t_buckets
     fine, then auto: lines/s, groups, the card's idle share and
     TESTERR, K3, K1, K2, K5 and K6 launched in each run, and 17's no-wait
     check at an auto bucket; (d) two gloo ranks sharing cuda:0, their
     measured penalties forced apart, building one auto cache: both hold
     rank 0's groups and the plan guard passes; (e) compile_cache in fresh
     processes with nvcc hidden: phase 2's directory loads the library and
     runs K3 (seconds to the first kernel, beside 2's cold build), a new
     empty directory and "off" fail with "nvcc not found", and "off" leaves
     no directory behind.

With --k2-against SRC, every timed K2 shape also times the K2 built from
SRC in turns with the current one (against, current, current, against),
and where SRC has a bf16 reduction (PR 12's interface or the current
one), so do K2's bf16 reduction at its four shapes and the bidi, bidi2
and clstmfiltertrain bf16 steps with that build's reduction (and its bf16
chain); where SRC has a bf16 chain (clstm_bidi_lstm_bwd_chain_bf16), so
does K2's bf16 chain at its three shapes;
with --fwd-against SRC, the same for the forward kernel at K3 and K1
(bidi), K1 (bidi2 layer 1), K4 in both modes (bidi2 layer 2), and K3 with
the projection inside at D=400 and D=255 (H=200, the L2 plan), and where
SRC has the bf16 mode, its bf16 K1 and K4 state (its fwd16 kernel, or PR
5's kernel in sources before it) at phase 19's FWD16_SHAPES; with
--ctc-against SRC, the same for K5, K6 and K6b at the bench shape, and
the bidi and bidi2 train_batch steps with that build's K5 and K6 in turns
with the current ones.

Any failure raises, so the script exits non-zero. The last line is
{"ok": true, "device": {...}}; the line before it lists the kernels, the
bf16 mode's as rows of their own, each with bound_ms (the least time the
card could take: the larger of its matrix flop at 3xTF32's 165 TFLOP/s, or
989 TFLOP/s for the bf16 mode's bf16 operands, and its bytes at 3.35 TB/s,
bound_by naming which) and library_ms (a library call computing the same function,
timed in turns with the kernel, or null; K5, K6 and K6b also carry
per_frame_us, their time over the longest row's frames, and K6
ctc_loss_ms, F.ctc_loss forward and backward at the same B, T and S: a
yardstick of scale only, since it computes the CTC loss and not clstm's
lattice; the rows of the filter path's kernels carry "filter": their
launches per training step and in the clstmfiltertrain and clstmfilter
runs, and their time, plain time, bound and library call at the path's
shape); the line before that the card's name and power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import ctypes
import faulthandler
import functools
import io
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from clstm_tpu_torch.cli import clstmfilter, clstmfiltertrain, clstmocrtrain
from clstm_tpu_torch.cli.clstmocr import predict_pages, write_outputs
from clstm_tpu_torch.data import dataset as data_mod
from clstm_tpu_torch.data import device_cache
from clstm_tpu_torch.data.dataset import (
    OcrDataset, T_BUCKETS_FINE, auto_t_cuts, bucket_for)
from clstm_tpu_torch.data.device_cache import DeviceDataset, TextDeviceDataset
from clstm_tpu_torch.data.dataset import prepare_line
from clstm_tpu_torch.io import native
from clstm_tpu_torch.io.normalize import make_normalizer
from clstm_tpu_torch.io.png import read_png, write_png
from clstm_tpu_torch.io.proto import load_net, save_net
from clstm_tpu_torch.models.codec import Codec
from clstm_tpu_torch.models.hl import CLSTMOCR, CLSTMText
from clstm_tpu_torch.models.prefab import make_net_init
from clstm_tpu_torch.models.spec import CARD_DEFAULT_BF16, ApplyCtx, apply_net
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
from clstm_tpu_torch.ops.seq import flip_within_length, length_mask
from clstm_tpu_torch.parallel import (
    launch, make_mesh, make_parallel_multi_train_step,
    make_parallel_train_step)
from clstm_tpu_torch import train as train_mod
from clstm_tpu_torch.train import (
    _LOSSES, TrainState, gather_batch, loss_and_grads, make_forward,
    make_predict_step, make_train_step, sgd_update)
from clstm_tpu_torch.utils.metrics import levenshtein
from clstm_tpu_torch.utils.profiling import (
    SPANS, Throughput, kernel_counts, trace)
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
# The bf16 mode (xz_bf16=True, the JAX package's production mode; its
# rounding points in ops/lstm.py). Each bf16 kernel is held to the float64
# evaluation of the same rounded recipe (the plain versions with float64
# weights: every rounding point in place, the arithmetic in float64): its
# max|Δ| over max|float64| within BF16_FACTOR times the plain version's
# (the same recipe in f32), or, where both are a rounding flip or two,
# BF16_ULP (one bf16 ulp below 1; F64_FLOOR for the weight gradients, f32
# sums of exact products). A flip of one bf16 rounding, which any other
# order of an f32 sum can cause, moves a stream by an ulp and carries down
# the chain, so no fixed limit would tell a kernel's fault from the
# recipe's own noise. Its bounds take bf16 operands at the 989 TFLOP/s of
# the bf16 tensor cores.
BF16_FACTOR = 2.0
BF16_ULP = 2.0 ** -8
BF16_MMA_FLOPS = 989e12
# Beside the max, the mean: mean|Δ| over a stream's valid values, over
# max|float64|, within BF16_FACTOR times the plain version's (floor
# F64_FLOOR), where the stream holds at least MEAN_MIN_VALUES valid values
# (in fewer, one flip sets the mean). Both max distances are set by a flip
# of one bf16 rounding, so a kernel that left out a rounding point of the
# recipe (h fed to Wh unrounded, the bias kept f32) could keep its max
# within the rule; it moves far more values than the plain version's
# flips, and the mean shows it. The planted controls (``planted_controls``)
# check that the rule fails such a recipe at the bench shape.
MEAN_MIN_VALUES = 1 << 16
# The bf16 kernels at shapes across their plans (B, T, D, H): B of 1, 3
# and 17, T of 1 and 5, odd D (the wrapper pads x to an even width), D+1 >
# 128 (hoisted), H not a multiple of the cluster size, H = 700 on the L2
# plan and H = 2048 (the chain's one-row plan).
BF16_ODD = ((1, 5, 5, 7), (3, 1, 48, 100), (17, 5, 49, 201), (3, 5, 130, 7),
            (17, 1, 401, 200), (3, 5, 5, 700), (2, 5, 3, 2048))


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


def bound(flop: float, nbytes: float, peak: float = F32_MMA_FLOPS):
    """(bound_ms, bound_by) for ``flop`` matrix flop at ``peak`` and
    ``nbytes`` moved."""
    f_ms, b_ms = flop / peak * 1e3, nbytes / HBM_BPS * 1e3
    return (f_ms, "operations") if f_ms >= b_ms else (b_ms, "bytes")


def lstm_bound(kind: str, B, T, D, H, V, dx=False, esize=4):
    """bound() of a bidi LSTM kernel at [B, T] with V valid frames: K3/K1
    (kind "fwd"/"fwd_state": z = [x|1]·W_in + h·Wh), K4 ("xz"/"xz_state":
    h·Wh on xz), K2's chain ("chain": Dh = dz·Whᵀ) or reduction
    ("reduce": dW, and dx when asked). ``esize`` bytes for the streams and
    weights of the mode (4 f32, 2 bf16, whose products then run at the bf16
    tensor cores' peak); the gates and dW are f32 in both. The streams read
    count at the V valid frames (a padded frame's output is 0 and reads
    nothing), those written at all B·T (the padded zeros are written)."""
    G, BT, e = 4 * H, B * T, esize
    peak = F32_MMA_FLOPS if e == 4 else BF16_MMA_FLOPS

    def state(n):                               # gates and cell, n frames
        return n * 2 * (4 * G + e * H)
    if kind in ("fwd", "fwd_state"):
        flop = 2 * V * 2 * (D + 1 + H) * G
        nbytes = e * (V * D + 2 * (D + 1 + H) * G + BT * 2 * H) + 4 * B
    elif kind in ("xz", "xz_state"):
        flop = 2 * V * 2 * H * G
        nbytes = e * (V * 2 * G + 2 * H * G + BT * 2 * H) + 4 * B
    elif kind == "chain":
        return bound(2 * V * 2 * G * H,
                     state(V) + e * (V * 2 * H + 2 * H * G + BT * 2 * G)
                     + 4 * B, peak)
    else:
        flop = 2 * V * 2 * (D + 1 + H) * G + (V * 2 * 2 * G * D if dx else 0)
        nbytes = (e * (V * D + V * 2 * H + V * 2 * G
                       + (2 * D * G + BT * D if dx else 0))
                  + 4 * 2 * (D + 1 + H) * G)
    return bound(flop, nbytes + (state(BT) if kind.endswith("state") else 0),
                 peak)


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
    flags, to time in turns with the current K2 -> (chain, reduce,
    reduce_bf16, chain_bf16) with the wrappers' signatures (reduce_bf16,
    chain_bf16: the bf16 mode's reduction and chain; chain_bf16 is SRC's
    clstm_bidi_lstm_bwd_chain_bf16, the interface of every source with a
    bf16 mode: WhT in bf16 padded to clstm_bidi_lstm_bwd_hp, the L2
    branch of the current source; None where SRC has none). SRC may have the current C interface (WhT padded to
    clstm_bidi_lstm_bwd_hp, f32 scratch from clstm_bidi_lstm_bwd_scratch,
    the bf16 reduction taking reduce_plan's plan and sizing its scratch by
    clstm_bidi_lstm_bwd_bf16_scratch), PR 12's (the same f32 entries, the
    bf16 reduction on bf16 x and wx with clstm_bidi_lstm_bwd_scratch's f32
    scratch and dx_bf16) or the earlier one (WhT unpadded [2, 4H, H], dW
    partials sized by clstm_bidi_lstm_bwd_nsplit(B, T), no bf16 entries:
    reduce_bf16 is None). No launch is counted."""
    with tempfile.TemporaryDirectory() as tmp:
        so = os.path.join(tmp, "k2_against.so")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        so, src], check=True, capture_output=True, timeout=600)
        lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    current = hasattr(lib, "clstm_bidi_lstm_bwd_scratch")
    has_chain16 = hasattr(lib, "clstm_bidi_lstm_bwd_chain_bf16")
    plan16 = hasattr(lib, "clstm_bidi_lstm_bwd_bf16_scratch")
    has16 = hasattr(lib, "clstm_bidi_lstm_bwd_reduce_bf16")
    lib.clstm_bidi_lstm_bwd_chain.argtypes = [P] * 6 + [I] * 3 + [P]
    lib.clstm_bidi_lstm_bwd_reduce.argtypes = [P] * 7 + [I] * 4 + [P]
    if current:
        lib.clstm_bidi_lstm_bwd_hp.argtypes = [I]
        lib.clstm_bidi_lstm_bwd_scratch.argtypes = [I] * 4
        lib.clstm_bidi_lstm_bwd_scratch.restype = ctypes.c_longlong
    else:
        lib.clstm_bidi_lstm_bwd_nsplit.argtypes = [I] * 2
    if plan16:
        lib.clstm_bidi_lstm_bwd_reduce_bf16.argtypes = (
            [P, I] + [P] * 6 + [I] * 8 + [P])
    elif has16:
        lib.clstm_bidi_lstm_bwd_reduce_bf16.argtypes = (
            [P] * 7 + [I] * 5 + [P])
    if has_chain16:
        lib.clstm_bidi_lstm_bwd_chain_bf16.argtypes = [P] * 6 + [I] * 3 + [P]

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

    def reduce_bf16(x, y, dz, Wx2, need_dx):
        B, T, D = x.shape
        H = y.shape[-1] // 2
        M, G = D + 1 + H, 4 * H
        dev = x.device
        dW = torch.empty((2, M, G), dtype=torch.float32, device=dev)
        dx = torch.empty_like(x) if need_dx else None
        stream = torch.cuda.current_stream().cuda_stream
        if plan16:
            plan = bk.device_reduce_plan(dev, B, T, D, H)
            scratch = torch.empty(plan.scratch, dtype=torch.uint8,
                                  device=dev)
            wx = Wx2.contiguous()
            check(lib.clstm_bidi_lstm_bwd_reduce_bf16(
                x.data_ptr(), int(x.dtype == torch.bfloat16), y.data_ptr(),
                dz.data_ptr(), wx.data_ptr(), scratch.data_ptr(),
                dW.data_ptr(), 0 if dx is None else dx.data_ptr(), B, T, D,
                H, plan.nw, plan.tt, plan.spr, plan.nwd, stream))
            return dW, dx
        # PR 12's interface: x and wx in bf16, f32 scratch.
        scratch = torch.empty(lib.clstm_bidi_lstm_bwd_scratch(B, T, D, H),
                              dtype=torch.float32, device=dev)
        x16 = x.to(torch.bfloat16).contiguous()
        wx16 = Wx2.to(torch.bfloat16).contiguous()
        check(lib.clstm_bidi_lstm_bwd_reduce_bf16(
            x16.data_ptr(), y.data_ptr(), dz.data_ptr(), wx16.data_ptr(),
            scratch.data_ptr(), dW.data_ptr(),
            0 if dx is None else dx.data_ptr(), B, T, D, H,
            int(x.dtype == torch.bfloat16), stream))
        return dW, dx

    def chain_bf16(gates, cell, gy, Wh2, lengths):
        B, T, _, G = gates.shape
        H = G // 4
        dz = torch.empty((B, T, 2, G), dtype=torch.bfloat16,
                         device=gates.device)
        hp = lib.clstm_bidi_lstm_bwd_hp(H)
        whT = torch.zeros((2, G, hp), dtype=torch.bfloat16,
                          device=gates.device)
        whT[:, :, :H] = Wh2.transpose(1, 2)
        check(lib.clstm_bidi_lstm_bwd_chain_bf16(
            0 if lengths is None else lengths.data_ptr(), gates.data_ptr(),
            cell.data_ptr(), gy.data_ptr(), whT.data_ptr(), dz.data_ptr(), B,
            T, H, torch.cuda.current_stream().cuda_stream))
        return dz
    return (chain, reduce, reduce_bf16 if has16 else None,
            chain_bf16 if has_chain16 else None)


def load_fwd_against(src: str) -> dict:
    """``--fwd-against SRC``: the forward kernel built from another source
    with the same nvcc flags, to time in turns with the current one ->
    {"K3", "K1", "K4", "K4 state": a callable with the signature of
    bidi_lstm_infer, bidi_lstm_fwd_state, bidi_lstm_infer_xz,
    bidi_lstm_fwd_state_xz; and where SRC has the bf16 mode, "K3 bf16",
    "K1 bf16", "K4 bf16", "K4 state bf16": the same in the bf16 mode}. SRC
    may have the current C interface (weights interleaved by unit, a plan
    from fwd_plan with that library's own occupancy query) or the earlier
    one (wx [2,D,4H], wh [2,H,4H] and b [2,4H] as they are, no plan). Its
    bf16 K3, K1 and K4 (both modes) are its fwd16 kernel where it has one
    (at fwd16_plan with its own occupancy query), else its bf16 instances
    of the FMA kernel (sources from before the fwd16 kernel). A fwd16
    kernel without the inference instances (its queries take no mode) is
    refused. No launch is counted."""
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
    out = {"K3": run_x(False), "K1": run_x(True), "K4": run_xz(False),
           "K4 state": run_xz(True)}
    if not (current and hasattr(lib, "clstm_bidi_lstm_fwd_state_bf16")):
        return out
    has16 = hasattr(lib, "clstm_bidi_lstm_fwd16")
    if hasattr(lib, "clstm_bidi_lstm_fwd16_state") and not has16:
        raise ValueError(f"{src}: a fwd16 kernel without the inference "
                         "instances (an earlier C interface)")
    for name, ptrs in (("clstm_bidi_lstm_fwd_bf16", 5),
                       ("clstm_bidi_lstm_fwd_state_bf16", 7),
                       ("clstm_bidi_lstm_fwd_xz_bf16", 4),
                       ("clstm_bidi_lstm_fwd_xz_state_bf16", 6)):
        getattr(lib, name).argtypes = [P] * ptrs + [I] * (
            7 if "_xz" in name else 8) + [P]
    lib.clstm_bidi_lstm_fwd_bf16_clusters.argtypes = [I] * 8
    if has16:
        lib.clstm_bidi_lstm_fwd16_state.argtypes = [P] * 7 + [I] * 7 + [P]
        lib.clstm_bidi_lstm_fwd16_xz_state.argtypes = [P] * 6 + [I] * 6 + [P]
        lib.clstm_bidi_lstm_fwd16.argtypes = [P] * 5 + [I] * 7 + [P]
        lib.clstm_bidi_lstm_fwd16_xz.argtypes = [P] * 4 + [I] * 6 + [P]
        lib.clstm_bidi_lstm_fwd16_clusters.argtypes = [I] * 7

    def launch(name, device, *args):
        call(name, *args)

    def run16(kind):
        hoist, state = "xz" in kind, kind.endswith("state")

        def run(pf, pr, inp, lengths):
            B_, T_ = inp.shape[:2]
            H_ = pf["Wh"].shape[0]
            D_ = 0 if hoist else inp.shape[-1] + inp.shape[-1] % 2
            plan = bk.FWD16_NONE
            if has16:
                def q(C_, rows, units):
                    return lib.clstm_bidi_lstm_fwd16_clusters(
                        D_, H_, int(hoist), int(state), C_, rows, units)
                plan = bk.fwd16_plan(B_, T_, D_, H_, hoist, q, state=state)
            if not plan.C:
                plan = bk.fwd_plan(B_, D_, H_, hoist, state, bk.card_clusters(
                    lookup, D_, H_, hoist, state, 2), 2)
            return bk._fwd(kind, plan, pf, pr, inp, lengths, True, launch)
        return run
    out.update({"K3 bf16": run16("fwd"), "K1 bf16": run16("fwd_state"),
                "K4 bf16": run16("fwd_xz"),
                "K4 state bf16": run16("fwd_xz_state")})
    return out


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
    p = bk.FwdPlan(*plan, threads=0, smem=0, groups=0, clusters=0)
    out = bk._fwd("fwd_state" if state else "fwd", p, pf, pr, x, lengths,
                  False)
    return list(out) if state else [out]


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


class PlainBidiBF16(torch.autograd.Function):
    """A bidi layer in the bf16 mode composed from the plain versions, as
    _BidiLSTMTrain composes the kernels: forward bidi_lstm_fwd_state_plain
    (or the hoisted product and bidi_lstm_fwd_state_xz_plain), backward the
    plain chain and reduction. With float64 weights it is the float64
    evaluation of the same rounded recipe."""

    @staticmethod
    def forward(ctx, x, lengths, wxf, whf, bf, wxr, whr, br):
        pf = {"Wx": wxf, "Wh": whf, "b": bf}
        pr = {"Wx": wxr, "Wh": whr, "b": br}
        if bk.hoists_projection(x.shape[-1], whf.shape[0]):
            y, gates, cell = lstm_ops.bidi_lstm_fwd_state_xz_plain(
                pf, pr, lstm_ops.hoisted_projection(pf, pr, x, xz_bf16=True),
                lengths, xz_bf16=True)
        else:
            y, gates, cell = lstm_ops.bidi_lstm_fwd_state_plain(
                pf, pr, x, lengths, xz_bf16=True)
        ctx.save_for_backward(x, lengths, y, gates, cell, wxf, whf, wxr, whr)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, lengths, y, gates, cell, wxf, whf, wxr, whr = ctx.saved_tensors
        D = x.shape[-1]
        dz = lstm_ops.bidi_lstm_bwd_chain_plain(
            gates, cell, gy, torch.stack([whf, whr]), lengths, xz_bf16=True)
        dW, dx = lstm_ops.bidi_lstm_bwd_reduce_plain(
            x, y, dz, torch.stack([wxf, wxr]), ctx.needs_input_grad[0],
            xz_bf16=True)
        grads = [(dW[g, :D], dW[g, D + 1:], dW[g, D]) for g in (0, 1)]
        return (dx, None, *grads[0], *grads[1])


def plain_forward(net, x, lengths, bf16: bool = False):
    """The net's bidi layers composed from plain versions -> (the softmax
    layer, its input): each bidi pair by bidi_lstm_apply, which is K3's
    plain version and, through its hoisted product, K4's (f32); with
    ``bf16`` by PlainBidiBF16, in the arithmetic of the net's weights (f32,
    or float64 for the float64 reference)."""
    *layers, soft = net.sub
    for par in layers:
        pf, pr = par.sub[0].weights(), par.sub[1].sub[0].weights()
        if bf16:
            x = PlainBidiBF16.apply(x, lengths, pf["Wx"], pf["Wh"], pf["b"],
                                    pr["Wx"], pr["Wh"], pr["b"])
        else:
            x = bidi_lstm_apply(pf, pr, x, lengths)
    return soft, x


def plain_logits(soft, y, bf16: bool = False):
    """The softmax layer's logits from the plain path: f32, or with
    ``bf16`` the product of bf16-rounded operands in the weights' type plus
    the bias (the JAX package's _affine; autograd through the casts gives
    its gradients)."""
    if not bf16:
        return soft.affine(y)
    dt = soft.W.dtype
    return (y.to(torch.bfloat16).to(dt) @ soft.W.to(torch.bfloat16).to(dt)
            + soft.b)


def plain_train_step(net, velocity, batch, lr, momentum,
                     bf16: bool = False) -> float:
    """The training step of make_train_step(loss_kind="ctc",
    normalization="none") composed from the plain versions: autograd
    through the plain LSTM loops (K1, K4 and K2's reference; in the bf16
    mode the plain forward and backward of PlainBidiBF16), the alignment
    by the scan recipe with the flip recipe (K5, K6's), the same loss and
    SGD update, in the arithmetic of the net's weights."""
    x, lengths = batch["x"], batch["lengths"]
    net.zero_grad(set_to_none=True)
    soft, y = plain_forward(net, x, lengths, bf16)
    logits = plain_logits(soft, y, bf16)
    with torch.no_grad():
        aligned = ctc_ops.ctc_align_targets_batched(
            torch.softmax(logits, dim=-1), batch["targets"],
            lengths=lengths, target_lengths=batch["target_lengths"],
            fused=False, use_kernel=False)
    mask = length_mask(lengths, x.shape[1], logits.dtype)
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


def kernel_rows(rows) -> list:
    """The kernels' rows of a profiler table: its CUDA rows less the step
    annotations and the port's spans (utils/profiling.py SPANS), which come
    back as CUDA rows spanning the kernels under them."""
    return [e for e in rows
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("ProfilerStep") and e.key not in SPANS]


def kernel_name(key: str) -> str:
    """A profiler row's kernel name without its namespace and arguments,
    keeping template arguments (K1 and K4 are instances of one kernel)."""
    key = key.replace("void ", "", 1).replace("(anonymous namespace)::", "")
    return key.split("(")[0][:56]


COUNTED = (bidi_lstm_infer, bidi_lstm_fwd_state, bidi_lstm_infer_xz,
           bidi_lstm_fwd_state_xz, bidi_lstm_bwd_chain, bidi_lstm_bwd_reduce,
           ctc_forward, ctc_both, ctc_backward)


# The wrappers whose bf16 launches may take the tensor-core kernel
# (fwd16_plan): launches16 counts those.
COUNTED16 = (bidi_lstm_infer, bidi_lstm_fwd_state, bidi_lstm_infer_xz,
             bidi_lstm_fwd_state_xz)


def reset_counts() -> None:
    for f in COUNTED:
        f.launches = 0
    for f in COUNTED16:
        f.launches16 = 0


def counts16() -> dict:
    """Of each COUNTED16 wrapper's launches since the reset, those of the
    fwd16 kernel."""
    return {f.__name__: f.launches16 for f in COUNTED16}


def counts() -> dict:
    return {f.__name__: f.launches for f in COUNTED}


def fwd16_due(ts, d: int, h: int) -> int:
    """How many bf16 inference calls of a layer of input width d and h
    units, at the chain lengths ``ts``, take the fwd16 kernel: those past
    fwd16_prefers_old's window where a fwd16 plan fits (whether one fits
    depends on neither the batch nor the card's cluster count). For the
    filter's short buckets, which the window may keep on the FMA kernel."""
    hoist = bk.hoists_projection(d, h)
    dk = 0 if hoist else d + d % 2
    return sum(bool(bk.fwd16_plan(1, t, dk, h, hoist, state=False).C)
               for t in ts)


def serving_fwd16(tag: str, r: dict, names) -> None:
    """Raise unless every launch of each wrapper in ``names`` in a clstmocr
    serve() run (buckets of 128 frames and more at H = 100 or 200, past
    any window) was one of the fwd16 kernel in the bf16 mode
    (launches16 == launches), and none in f32. The expected count comes
    from the launches, not from the plan that routes them."""
    for name in names:
        got, n = r["launches16"][name], r["launches"][name]
        want = n if r["bf16"] else 0
        if not n or got != want:
            raise AssertionError(
                f"{tag}: {name} launched {n} times in {len(r['buckets'])} "
                f"buckets (T {r['buckets']}), {got} of them on the fwd16 "
                f"kernel; want {want}")


def ids_against_plain(net, batches, bf16: bool, nclasses: int,
                      dev) -> dict:
    """The frame ids a path served, held against the plain path on the same
    batches ((x, lengths, ids) each): in f32 equal on ID_AGREE_MIN of valid
    frames; in the bf16 mode the kernels' share of frames whose ids differ
    from the float64 evaluation of the same rounded recipe within
    BF16_FACTOR times the plain recipe's, or 1 - ID_AGREE_MIN where that is
    larger. Raises otherwise. -> {share (of valid frames equal to plain),
    frames, bf16, and in the bf16 mode off64, off64_tol}."""
    agree = total = 0
    off64 = [0, 0]    # frames whose ids differ from float64: kernels, plain
    net64 = copy.deepcopy(net).double() if bf16 else None
    for xb, lb, ids in batches:
        xt = torch.as_tensor(xb).to(dev)
        lt = torch.as_tensor(lb).to(dev)
        lb = lt.cpu().numpy()
        ids = torch.as_tensor(ids).cpu().numpy()
        if not (ids.min() >= 0 and ids.max() < nclasses):
            raise AssertionError("main path produced invalid frames")
        with torch.no_grad():
            soft, y = plain_forward(net, xt, lt, bf16)
            pids, _ = greedy_frames(plain_logits(soft, y, bf16))
            if bf16:
                soft64, y64 = plain_forward(net64, xt, lt, True)
                ids64 = greedy_frames(plain_logits(soft64, y64, True))[0]
                ids64 = ids64.cpu().numpy()
        pids = pids.cpu().numpy()
        for r, L in enumerate(lb):
            agree += int((pids[r, :L] == ids[r, :L]).sum())
            total += int(L)
            if bf16:
                off64[0] += int((ids[r, :L] != ids64[r, :L]).sum())
                off64[1] += int((pids[r, :L] != ids64[r, :L]).sum())
    out = {"share": agree / total, "frames": total, "bf16": bf16}
    if bf16:
        out["off64"] = [n / total for n in off64]
        out["off64_tol"] = max(BF16_FACTOR * out["off64"][1],
                               1 - ID_AGREE_MIN)
        if out["off64"][0] > out["off64_tol"]:
            raise AssertionError(
                f"frame ids differ from the float64 recipe on "
                f"{out['off64'][0]:.6f} of frames, the plain f32 recipe's on "
                f"{out['off64'][1]:.6f}: above {out['off64_tol']:.6f}")
    elif out["share"] < ID_AGREE_MIN:
        raise AssertionError(f"frame-id agreement {out['share']:.6f} < "
                             f"{ID_AGREE_MIN}")
    return out


def serve(model: str, images, dev, nclasses: int, tmp: str,
          device_preprocess: int, xz_bf16=None) -> dict:
    """clstmocr's path on the card: load ``model``, run predict_pages and
    write_outputs over ``images`` once cold, then again with the launch
    counts reset just before and read just after, then E2E_PASSES times
    more, timed. Records each width bucket's prepared batch (the host's, or
    the card's prepare output) and its frame ids, and holds the ids against
    the plain path on the same batches; with the normalization on the card,
    also holds each line's length against the same prepare on the CPU and
    times the card's prepare per bucket inside the timed passes. The model
    runs at the precision ``xz_bf16`` (None: the card's default); in the
    bf16 mode the ids are held to the float64 evaluation of the same
    rounded recipe (the kernels' share of frames that differ from it within
    BF16_FACTOR times the plain f32 recipe's, or 1 - ID_AGREE_MIN where
    that is larger). Returns
    {launches, launches16 (of the bf16 launches, the fwd16 kernel's),
    buckets (T per bucket), e2e_s (median of the timed passes),
    e2e_range (their min and max), cold_s, share (of valid frames whose ids
    agree), frames, and with device_preprocess prep_ms, prep_host_ms,
    prep_busy_ms (per prepare call), prep_share, len_mismatch, nosync_ms
    (host ms of predict_batch_images(sync=False) behind a device sleep),
    nosync_lines (the lines it took) and sleep_ms}."""
    ocr = CLSTMOCR(device=dev)
    ocr.load(model)
    ocr.xz_bf16 = xz_bf16
    bf16 = ApplyCtx(xz_bf16=xz_bf16).bf16(torch.empty(0, device=dev))
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
        launches, launches16 = counts(), counts16()
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
    out = {"launches": launches, "launches16": launches16,
           "e2e_s": float(np.median(walls)),
           "e2e_range": (walls[0], walls[-1]), "cold_s": cold_s,
           "buckets": [int(b[0].shape[1]) for b in batches]}
    if not all(np.isfinite(results[i][2]).all() for i in results):
        raise AssertionError("main path produced invalid frames")
    out.update(ids_against_plain(ocr.net, batches, bf16, nclasses, dev))
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
            # In the bf16 mode: one call at 8 lines first, so that the
            # mode's own first launches in this process (its kernel
            # instances, the bf16 casts) are behind it, then the measured
            # call at a batch size that neither it nor a served bucket ran:
            # a wait at every new shape fails the check (cuBLAS's bf16
            # products wait so, scripts/torch_blas_wait_probe.py: the mode
            # takes f32 products of its rounded operands). In f32 the call
            # at 8 lines is the measured one, as it was.
            n = 8
            if bf16:
                ocr.predict_batch_images(images[:n], sync=False)
                torch.cuda.synchronize()
                ran = {n} | {p[2][0].shape[0] for p in preps}
                n = min(set(range(n + 1, len(images) + 1)) - ran)
            sleep = torch.cuda.Event(enable_timing=True)
            woke = torch.cuda.Event(enable_timing=True)
            sleep.record()
            torch.cuda._sleep(NOSYNC_CYCLES)
            woke.record()
            t0 = time.perf_counter()
            ocr.predict_batch_images(images[:n], sync=False)
            out["nosync_ms"] = (time.perf_counter() - t0) * 1e3
            out["nosync_lines"] = n
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
    line = (f"[{tag}] {'bf16' if r['bf16'] else 'f32'} "
            f"device_preprocess={dp}: {N_LINES} lines in "
            f"{len(r['buckets'])} width buckets ({', '.join(map(str, r['buckets']))}"
            f" frames), launches { {k: v for k, v in r['launches'].items() if v} }"
            f" (fwd16 kernel { {k: v for k, v in r['launches16'].items() if v} })"
            f", {E2E_PASSES} warm passes: median {r['e2e_s']:.4f} s end to end "
            f"({N_LINES / r['e2e_s']:.1f} lines/s; range {lo:.4f}-{hi:.4f} s, "
            f"{N_LINES / hi:.1f}-{N_LINES / lo:.1f} lines/s); cold, the "
            f"model's first run, {r['cold_s']:.3f} s, "
            f"{N_LINES / r['cold_s']:.1f} lines/s; frame ids agree with plain on {r['share']:.6f} of "
            f"{r['frames']} valid frames"
            + (f"; differ from the float64 recipe on {r['off64'][0]:.6f} "
               f"(plain f32 {r['off64'][1]:.6f}, limit "
               f"{r['off64_tol']:.6f})" if r["bf16"] else
               f" (min {ID_AGREE_MIN})"))
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
                 f"predict_batch_images(sync=False) on {r['nosync_lines']} "
                 f"lines" + (" (after one call on 8)" if r["bf16"] else "")
                 + f" returned in {r['nosync_ms']:.2f} ms behind a "
                 f"{r['sleep_ms']:.1f} ms device sleep")
    return line


def f64_state(state: TrainState) -> TrainState:
    """A float64 copy of a TrainState: the float64 reference trajectory."""
    return TrainState(net=copy.deepcopy(state.net).double(),
                      velocity={k: v.double()
                                for k, v in state.velocity.items()},
                      step=state.step)


def train_against_plain(tocr, plain, batch, lr, momentum, tag,
                        kernel_step=None, batches=None,
                        steps: int = 5) -> dict:
    """``steps`` (5) train_batch steps of ``tocr`` on ``batch`` (or, given
    ``kernel_step``, its calls kernel_step(0..4), the steps of the path,
    on ``batches``, the 5 batches they train on) with the launch counts
    reset just before and read just after, and the same steps composed
    from the plain versions on ``plain`` (a TrainState holding the same
    start), in the precision ``tocr`` trains in. Logs both under ``tag`` and raises unless
    they agree: in f32 within the limits above; in the bf16 mode, where
    roundings to bf16 flip between any two orders of f32 sums, each of the
    four measures is held to the float64 evaluation of the same steps
    (``f64_state``): the kernels' distance from it within BF16_FACTOR times
    the plain f32 steps', or within the f32 limit where that is larger.
    Returns the launch counts of the kernel steps."""
    bf16 = ApplyCtx(xz_bf16=tocr.xz_bf16).bf16(batch["x"])
    batches = batches or [batch] * steps
    if kernel_step is None:
        def kernel_step(i):
            return tocr.train_batch(batches[i])
    p0 = [p.detach().clone() for p in tocr.net.parameters()]
    ref = f64_state(plain) if bf16 else None

    def params(net):
        return [p.detach().clone() for p in net.parameters()]

    reset_counts()
    t0 = time.perf_counter()
    k_losses = [float(kernel_step(0)["loss"])]
    k_p1 = params(tocr.net)
    k_losses += [float(kernel_step(i)["loss"]) for i in range(1, steps)]
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = counts()

    def run(state):
        losses = [plain_train_step(state.net, state.velocity, batches[0], lr,
                                   momentum, bf16)]
        first = params(state.net)
        losses += [plain_train_step(state.net, state.velocity, batches[i], lr,
                                    momentum, bf16) for i in range(1, steps)]
        return losses, first, params(state.net)
    p_losses, p_p1, p_p5 = run(plain)
    k_p5 = params(tocr.net)

    def param_gap(a, b, start=p0):
        """(max |a - b|, max |b - start|) over all parameters."""
        return (max(float((u.double() - v.double()).abs().max())
                    for u, v in zip(a, b)),
                max(float((v.double() - w.double()).abs().max())
                    for v, w in zip(b, start)))

    def measures(losses, p1, p5, want_losses, want_p1, want_p5):
        rels = [abs(k - p) / abs(p) for k, p in zip(losses, want_losses)]
        dp1, moved1 = param_gap(p1, want_p1)
        dp, moved = param_gap(p5, want_p5)
        return {"step1_loss": rels[0], "step1_params": dp1 / moved1,
                "loss": max(rels), "params": dp / moved}, rels, moved1
    limits = {"step1_loss": STEP1_LOSS_RTOL, "step1_params": STEP1_PARAM_RTOL,
              "loss": LOSS_RTOL, "params": PARAM_RTOL}
    if not bf16:
        got, rels, moved1 = measures(k_losses, k_p1, k_p5, p_losses, p_p1,
                                     p_p5)
        plain_off = None
    else:
        r_losses, r_p1, r_p5 = run(ref)
        got, rels, moved1 = measures(k_losses, k_p1, k_p5, r_losses, r_p1,
                                     r_p5)
        plain_off = measures(p_losses, p_p1, p_p5, r_losses, r_p1, r_p5)[0]
        limits = {k: max(BF16_FACTOR * plain_off[k], v)
                  for k, v in limits.items()}
    log(f"[{tag}] {'bf16' if bf16 else 'f32'}: {steps} steps in "
        f"{train_s:.3f} s; launches "
        f"{ {k: v for k, v in launches.items() if v} }; loss kernels "
        f"{[round(v, 3) for v in k_losses]} plain "
        f"{[round(v, 3) for v in p_losses]}, rel per step "
        f"{', '.join(f'{r:.2e}' for r in rels)}"
        + (" (against the float64 steps)" if bf16 else ""))
    log(f"[{tag}] " + ("against the float64 evaluation of the same bf16 "
                       "steps, kernels / plain f32 (limit): "
                       if bf16 else "kernels against plain (limit): ")
        + ", ".join(f"{k} {v:.3e}"
                    + (f" / {plain_off[k]:.3e}" if plain_off else "")
                    + f" ({limits[k]:.3e})" for k, v in got.items())
        + " (params: max|d| over how far the reference moved them)")
    if not all(np.isfinite(k_losses)):
        raise AssertionError("training loss is not finite")
    if not (moved1 > 0 and all(got[k] <= limits[k] for k in got)):
        raise AssertionError(f"the kernel steps disagree with the "
                             f"{'float64' if bf16 else 'plain'} steps: "
                             f"{got}, limits {limits}")
    return launches


def profile_steps(tocr, batch, card, fname, tag):
    """torch.profiler over 2 train_batch steps, after a warm-up step under
    the profiler (the second profiler run in one process lost its first
    kernel without it): the table goes to chiprun_out/``fname``; logs wall,
    device busy share and the top device rows per step. Returns {kernel:
    device ms per step}."""
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
    # device time, the kernels it launched through ctypes.
    kernels_rows = kernel_rows(avg)
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
    return {kernel_name(e.key): device_us(e) / 2e3 for e in kernels_rows}


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
            device_us(e) for e in kernel_rows(prof.key_averages())) / 1e6
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


def d64(p: dict) -> dict:
    return {k: v.detach().double() for k, v in p.items()}


def mean_rel(k: torch.Tensor, r: torch.Tensor, valid=None) -> float:
    """mean|k - r| over the values ``valid`` selects (a bool mask of k's
    leading dims; None: all), over max|r|."""
    d = (k - r).abs()
    d = d if valid is None else d[valid]
    return float(d.mean() / r.abs().max().clamp_min(1e-30))


def bf16_rel(name: str, k, p, r, floor: float, valid=None):
    """(kernel max, plain max, kernel mean, plain mean) distance of one
    stream from the float64 recipe ``r``: max|Δ| over max|float64|, and
    mean_rel over the valid values (``valid``, a bool mask of the leading
    dims, or None: all). Raises unless the kernel's max is within
    BF16_FACTOR times the plain version's or ``floor``, and, where the
    stream holds MEAN_MIN_VALUES valid values, its mean within BF16_FACTOR
    times the plain version's or F64_FLOOR."""
    r = r.double()
    k, p = k.double(), p.double()
    dk, dp = rel_err(k, r), rel_err(p, r)
    mk, mp = mean_rel(k, r, valid), mean_rel(p, r, valid)
    if not dk <= max(BF16_FACTOR * dp, floor):
        raise AssertionError(f"{name} is {dk:.3e} from the float64 recipe, "
                             f"the plain bf16 version {dp:.3e}: more than "
                             f"{BF16_FACTOR}x (floor {floor:.1e})")
    n = r.numel() if valid is None else int(valid.sum()) * (
        r[0, 0].numel() if valid.dim() == 2 else 1)
    if n >= MEAN_MIN_VALUES and not mk <= max(BF16_FACTOR * mp, F64_FLOOR):
        raise AssertionError(f"{name}: mean distance {mk:.3e} from the "
                             f"float64 recipe, the plain bf16 version "
                             f"{mp:.3e}: more than {BF16_FACTOR}x (floor "
                             f"{F64_FLOOR:.0e})")
    return dk, dp, mk, mp


def dist_max(a: tuple, b: tuple) -> tuple:
    """Two distance tuples of bf16_rel, each entry the larger."""
    return tuple(map(max, a, b))


def check_streams(name, got, again, lengths, floors, plain, ref,
                  framed=None):
    """A bf16 kernel's output streams: finite, bitwise equal to a second
    call, each within bf16_rel of the float64 recipe, and those that are
    [B, T, ...] (``framed``, by default all) exactly 0 on padded frames.
    Returns ({stream: (kernel, plain)}, max|kernel - plain|)."""
    torch.cuda.synchronize()
    dist, err = {}, 0.0
    framed = framed or (True,) * len(got)
    for i, (k, a, p, r, fl, fr) in enumerate(zip(got, again, plain, ref,
                                                 floors, framed)):
        tag = f"{name} stream {i}"
        if not torch.equal(k, a):
            raise AssertionError(f"{tag}: two calls differ")
        require_finite(tag, k)
        valid = None
        if fr:
            pad = padded(lengths, k.shape[0], k.shape[1], k.device)
            if not bool((k[pad] == 0).all()):
                raise AssertionError(f"{tag} is not exactly 0 on padded "
                                     "frames")
            valid = ~pad
        dist[i] = bf16_rel(tag, k, p, r, fl, valid)
        err = max(err, float((k.double() - p.double()).abs().max()))
    return dist, err


def compare_bf16_fwd(pf, pr, x, lengths):
    """K3, K1 and K4 in both modes (on the bf16 hoisted product of x), bf16,
    against their plain bf16 versions and the float64 recipe on the same
    inputs -> ({kernel: {stream: (kernel, plain) distance}}, max |kernel -
    plain| over every stream)."""
    L = (torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                    device=x.device) if lengths is None else lengths)
    q64f, q64r = d64(pf), d64(pr)
    out, err = {}, 0.0
    with torch.no_grad():
        plain = lstm_ops.bidi_lstm_fwd_state_plain(pf, pr, x, lengths,
                                                   xz_bf16=True)
        ref = lstm_ops.bidi_lstm_fwd_state_plain(q64f, q64r, x, lengths,
                                                 xz_bf16=True)

        def k3():
            return (bidi_lstm_infer(pf, pr, x, lengths, hoist=False,
                                    xz_bf16=True),)

        def k1():
            return bidi_lstm_fwd_state(pf, pr, x, lengths, xz_bf16=True)
        for name, fn, n in (("K3", k3, 1), ("K1", k1, 3)):
            out[name], e = check_streams(
                f"{name} bf16", fn(), fn(), L, (BF16_ULP,) * n, plain[:n],
                ref[:n])
            err = max(err, e)
        del plain, ref
        xz = lstm_ops.hoisted_projection(pf, pr, x, xz_bf16=True)
        plain = lstm_ops.bidi_lstm_fwd_state_xz_plain(pf, pr, xz, lengths,
                                                      xz_bf16=True)
        ref = lstm_ops.bidi_lstm_fwd_state_xz_plain(q64f, q64r, xz, lengths,
                                                    xz_bf16=True)

        def k4():
            return (bidi_lstm_infer_xz(pf, pr, xz, lengths, xz_bf16=True),)

        def k4s():
            return bidi_lstm_fwd_state_xz(pf, pr, xz, lengths, xz_bf16=True)
        for name, fn, n in (("K4", k4, 1), ("K4 state", k4s, 3)):
            out[name], e = check_streams(
                f"{name} bf16", fn(), fn(), L, (BF16_ULP,) * n, plain[:n],
                ref[:n])
            err = max(err, e)
    return out, err


@contextlib.contextmanager
def h_unrounded(B_: int, H_: int):
    """Within it the plain recipe leaves h unrounded before its recurrent
    product (ops/lstm.py::_op on the [2, B_, H_] h of ``_chain_plain``,
    the only operand of that shape where the input width is not H_); every
    other rounding point stays. Yields the count of h operands left
    unrounded."""
    op, hits = lstm_ops._op, [0]

    def patched(t, ct, bf16):
        if tuple(t.shape) == (2, B_, H_):
            hits[0] += 1
            return t.to(ct)
        return op(t, ct, bf16)
    lstm_ops._op = patched
    try:
        yield hits
    finally:
        lstm_ops._op = op


def planted_controls(pf, pr, x, lengths) -> dict:
    """K3's y from the float64 recipe with one rounding point left out, put
    in the kernel's place in bf16_rel against the float64 recipe and the
    plain bf16 version: "h unrounded" (h fed to Wh in float64), "bias f32"
    (the bias not rounded as a row of W_in). Each must fail the rule.
    Returns {fault: (max, plain max, mean, plain mean)}."""
    B_, T_, D_ = x.shape
    H_ = pf["Wh"].shape[0]
    if D_ == H_:
        raise ValueError("h_unrounded needs D != H")
    q64f, q64r = d64(pf), d64(pr)
    L = (torch.full((B_,), T_, dtype=torch.int32, device=x.device)
         if lengths is None else lengths)
    valid = ~padded(L, B_, T_, x.device)
    w = torch.cat([q64f["Wx"], q64r["Wx"]], 1).bfloat16().double()
    b = torch.cat([q64f["b"], q64r["b"]])
    x16 = x.reshape(B_ * T_, D_).bfloat16().double()
    out = {}
    with torch.no_grad():
        plain = bidi_lstm_apply(pf, pr, x, lengths, xz_bf16=True)
        ref = bidi_lstm_apply(q64f, q64r, x, lengths, xz_bf16=True)

        def xz(bias):
            return torch.addmm(bias, x16, w).reshape(B_, T_, 2, 4 * H_)
        # The same recipe through the xz path, every point in place, is the
        # reference itself: the controls below differ from it only where
        # they leave a point out.
        same = lstm_ops.bidi_lstm_apply_xz(
            q64f, q64r, xz(b.bfloat16().double()), lengths, xz_bf16=True)
        if not torch.equal(same, ref):
            raise AssertionError("the planted controls' recipe differs from "
                                 "the float64 recipe with no fault planted")
        with h_unrounded(B_, H_) as hits:
            y_h = lstm_ops.bidi_lstm_apply_xz(
                q64f, q64r, xz(b.bfloat16().double()), lengths, xz_bf16=True)
        if hits[0] != T_:
            raise AssertionError(f"h left unrounded at {hits[0]} of {T_} "
                                 "steps")
        y_b = lstm_ops.bidi_lstm_apply_xz(q64f, q64r, xz(b), lengths,
                                          xz_bf16=True)
        for fault, y in (("h unrounded", y_h), ("bias f32", y_b)):
            r, pd, rd = y.double(), plain.double(), ref.double()
            out[fault] = (rel_err(r, rd), rel_err(pd, rd),
                          mean_rel(r, rd, valid), mean_rel(pd, rd, valid))
            try:
                bf16_rel(f"planted {fault}", y, plain, ref, BF16_ULP, valid)
            except AssertionError:
                continue
            raise AssertionError(f"the bf16 rule passed K3's recipe with "
                                 f"{fault}: {out[fault]}")
    return out


def compare_bf16_k2(pf, pr, x, lengths, state, gy):
    """K2's chain and reduction, bf16, on the plain bf16 forward's state
    and a bf16 cotangent: against their plain bf16 versions and the float64
    recipe (the chain on the same inputs, the reduction on the plain
    chain's dz, with dx from x as it is and as bf16, and without dx) ->
    ({part: (kernel, plain) distance}, max |kernel - plain| of the chain,
    of the reduction)."""
    y, gates, cell = state
    L = (torch.full((x.shape[0],), x.shape[1], dtype=torch.int32,
                    device=x.device) if lengths is None else lengths)
    Wh2, Wx2 = stack2(pf, pr, "Wh"), stack2(pf, pr, "Wx")
    out = {}
    with torch.no_grad():
        dz_p = lstm_ops.bidi_lstm_bwd_chain_plain(gates, cell, gy, Wh2,
                                                  lengths, xz_bf16=True)
        dz_r = lstm_ops.bidi_lstm_bwd_chain_plain(
            gates, cell, gy, Wh2.double(), lengths, xz_bf16=True)

        def chain():
            return (bidi_lstm_bwd_chain(gates, cell, gy, Wh2, lengths,
                                        xz_bf16=True),)
        d, chain_err = check_streams("K2 chain bf16", chain(), chain(), L,
                                     (BF16_ULP,), (dz_p,), (dz_r,))
        out["dz"] = d[0]
        del dz_r
        red_err = 0.0
        for xin, need_dx in ((x, True), (x.bfloat16(), True), (x, False)):
            def red():
                return tuple(t for t in bidi_lstm_bwd_reduce(
                    xin, y, dz_p, Wx2, need_dx, xz_bf16=True)
                    if t is not None)
            p = [t for t in lstm_ops.bidi_lstm_bwd_reduce_plain(
                xin, y, dz_p, Wx2, need_dx, xz_bf16=True) if t is not None]
            r = [t for t in lstm_ops.bidi_lstm_bwd_reduce_plain(
                xin.double(), y, dz_p, Wx2.double(), need_dx,
                xz_bf16=True) if t is not None]
            if need_dx and xin.dtype == torch.bfloat16:
                # dx in x's type: the float64 recipe's sum of the two
                # halves rounded to bf16 as well.
                r[1] = r[1].bfloat16().double()
            got = red()
            if need_dx and got[1].dtype != xin.dtype:
                raise AssertionError("K2 reduction bf16: dx is not in x's "
                                     "type")
            d, e = check_streams(
                f"K2 reduction bf16 (x {xin.dtype}, dx {need_dx})", got,
                red(), L, (F64_FLOOR, BF16_ULP)[:len(got)], p, r,
                (False, True)[:len(got)])
            red_err = max(red_err, e)
            for i, v in d.items():
                key = ("dW", "dx")[i]
                out[key] = dist_max(out.get(key, v), v)
    return out, chain_err, red_err


def bf16_kernels(dev, card: str) -> dict:
    """The bf16 kernels against their plain bf16 versions and the float64
    recipe (phase 18), at the bench profile (bidi, B=256, T=1024, D=48,
    H=100), bidi2's two layer shapes (D=48 and D=400, H=200), each with
    lengths all 900 and mixed, and BF16_ODD with mixed and no lengths; then
    each timed in turns with its f32 mode (phase 19), with the library call
    (cuDNN's nn.LSTM in bf16, the plain version's einsums on bf16 operands)
    in turns as well. Returns the distances, errors and times."""
    rng = np.random.RandomState(11)
    res = {"dist": {}, "fwd_err": 0.0, "chain_err": 0.0, "red_err": 0.0,
           "ms": {}, "plans": {}}

    def merge(dist):
        for key, v in dist.items():
            res["dist"][key] = dist_max(res["dist"].get(key, v), v)

    def check(label, pf, pr, x, lengths):
        d, e = compare_bf16_fwd(pf, pr, x, lengths)
        res["fwd_err"] = max(res["fwd_err"], e)
        for k, v in d.items():
            merge({f"{k} {i}": dv for i, dv in v.items()})
        with torch.no_grad():
            state = lstm_ops.bidi_lstm_fwd_state_plain(pf, pr, x, lengths,
                                                       xz_bf16=True)
        gy = uniform(rng, (x.shape[0], x.shape[1], state[0].shape[-1]), -1.0,
                     1.0, dev).bfloat16()
        d2, ce, re_ = compare_bf16_k2(pf, pr, x, lengths, state, gy)
        res["chain_err"] = max(res["chain_err"], ce)
        res["red_err"] = max(res["red_err"], re_)
        merge({f"K2 {k}": v for k, v in d2.items()})
        def pair(v):
            return (f"{v[0]:.2e}/{v[1]:.2e} mean {v[2]:.2e}/{v[3]:.2e}")
        log(f"[bf16] {label}: float64 distance kernel/plain, max and mean "
            "(the larger over the streams) " + ", ".join(
                f"{k} " + pair(functools.reduce(dist_max, v.values()))
                for k, v in d.items()) + "; K2 " + ", ".join(
            f"{k} {pair(v)}" for k, v in d2.items())
            + f" (limit {BF16_FACTOR:g}x plain, floor {BF16_ULP:.2e}, dW "
            f"{F64_FLOOR:.0e}; mean floor {F64_FLOOR:.0e}, held from "
            f"{MEAN_MIN_VALUES} values); max|kernel - plain| forward "
            f"{e:.3e}, chain {ce:.3e}, reduction {re_:.3e}; padded frames "
            "exactly 0; two calls bitwise equal")

    L900 = torch.full((B,), TRUE_T, dtype=torch.int32, device=dev)
    mixed = rng.randint(0, T + 1, B).astype(np.int32)
    mixed[0], mixed[1] = 0, T
    lens = {"all900": L900, "mixed": torch.from_numpy(mixed).to(dev)}
    V900 = B * TRUE_T
    # bidi, then bidi2's layer 1 and layer 2.
    layers = {"bidi": (D, H, 0.3), "bidi2 layer 1": (D, H2, 0.1),
              "bidi2 layer 2": (D2, H2, 0.1)}
    weights = {}
    for name, (d, h, sc) in layers.items():
        pf, pr = lstm_params(rng, d, h, dev, sc), lstm_params(rng, d, h, dev,
                                                               sc)
        x = (uniform(rng, (B, T, d), 0.0, 1.0, dev) if d == D else
             uniform(rng, (B, T, d), -1.0, 1.0, dev))
        weights[name] = (pf, pr, x)
        for k, lv in lens.items():
            check(f"{name} B={B} T={T} D={d} H={h} lengths={k}", pf, pr, x,
                  lv)
        if name == "bidi":
            res["planted"] = planted_controls(pf, pr, x, L900)
            log(f"[bf16] planted controls, K3 at B={B} T={T} D={d} H={h} "
                f"lengths={TRUE_T}: the float64 recipe with a rounding "
                "point left out, in the kernel's place, max/plain max, mean/"
                "plain mean: " + ", ".join(
                    f"{f} {v[0]:.2e}/{v[1]:.2e}, {v[2]:.2e}/{v[3]:.2e}"
                    for f, v in res["planted"].items())
                + f"; each fails the rule ({BF16_FACTOR:g}x plain)")
        hoist = bk.hoists_projection(d, h)
        for st in (False, True):
            p = bk.device_plan(dev, B, 0 if hoist else d, h, hoist, st, 2)
            smem = bk._kernel("clstm_bidi_lstm_fwd_bf16_smem")(
                0 if hoist else d, h, int(hoist), p.C, p.rows, p.units,
                p.resident)
            if smem != p.smem:
                raise AssertionError(f"bf16 plan {p}: the kernel counts "
                                     f"{smem} bytes of shared memory")
            res["plans"][f"{name} {'state' if st else 'inference'}"] = \
                p._asdict()
            log(f"[plan] bf16 {name} {'K1/K4 state' if st else 'K3/K4'} "
                f"B={B}: " + ", ".join(f"{k} {v}" for k, v in
                                       p._asdict().items())
                + ("; one wave" if 2 * p.groups <= p.clusters else
                   "; more than one wave"))
    for (b, t, d, h) in BF16_ODD:
        sc = min(0.3, 3.0 / h ** 0.5)
        pf, pr = lstm_params(rng, d, h, dev, sc), lstm_params(rng, d, h, dev,
                                                               sc)
        x = uniform(rng, (b, t, d), -1.0, 1.0, dev)
        ml = rng.randint(0, t + 1, b).astype(np.int32)
        ml[-1] = t
        for lname, lv in (("mixed", torch.from_numpy(ml).to(dev)),
                          ("none", None)):
            check(f"B={b} T={t} D={d} H={h} lengths={lname}", pf, pr, x, lv)

    # Timing: each bf16 kernel in turns with its f32 mode at the bench
    # shapes, lengths 900, and with its library call.
    ms = res["ms"]
    with torch.no_grad():
        pf, pr, x = weights["bidi"]
        lstm = cudnn_lstm(pf, pr, dev)
        lstm16 = copy.deepcopy(lstm).to(torch.bfloat16)
        px16 = packed(x.bfloat16(), L900)
        check_cudnn(lstm, packed(x, L900),
                    bidi_lstm_infer(pf, pr, x, L900), "K3")
        f32_t, bf_t = in_turns(lambda: bidi_lstm_infer(pf, pr, x, L900),
                               lambda: bidi_lstm_infer(pf, pr, x, L900,
                                                       xz_bf16=True), 10)
        bf_t2, lib = in_turns(lambda: bidi_lstm_infer(pf, pr, x, L900,
                                                      xz_bf16=True),
                              lambda: lstm16(px16), 10)
        ms["K3"] = {"ms": mean(bf_t + bf_t2), "f32_ms": mean(f32_t),
                    "turns": [f32_t, bf_t], "library_ms": mean(lib),
                    "plain_ms": time_ms(lambda: bidi_lstm_apply(
                        pf, pr, x, L900, xz_bf16=True), 2),
                    "bound": lstm_bound("fwd", B, T, D, H, V900, esize=2)}
        cu_fwd16 = cudnn_step(lstm16, px16, False)[0]
        f32_t, bf_t = in_turns(
            lambda: bidi_lstm_fwd_state(pf, pr, x, L900),
            lambda: bidi_lstm_fwd_state(pf, pr, x, L900, xz_bf16=True), 10)
        bf_t2, lib = in_turns(
            lambda: bidi_lstm_fwd_state(pf, pr, x, L900, xz_bf16=True),
            cu_fwd16, 10)
        ms["K1"] = {"ms": mean(bf_t + bf_t2), "f32_ms": mean(f32_t),
                    "turns": [f32_t, bf_t], "library_ms": mean(lib),
                    "plain_ms": time_ms(
                        lambda: lstm_ops.bidi_lstm_fwd_state_plain(
                            pf, pr, x, L900, xz_bf16=True), 2),
                    "bound": lstm_bound("fwd_state", B, T, D, H, V900,
                                        esize=2)}
        y16, g16, c16 = bidi_lstm_fwd_state(pf, pr, x, L900, xz_bf16=True)
        y32, g32, c32 = bidi_lstm_fwd_state(pf, pr, x, L900)
        gy = uniform(rng, (B, T, 2 * H), -1.0, 1.0, dev)
        Wh2, Wx2 = stack2(pf, pr, "Wh"), stack2(pf, pr, "Wx")
        gy16 = gy.bfloat16()
        dz16 = bidi_lstm_bwd_chain(g16, c16, gy16, Wh2, L900, xz_bf16=True)
        dz32 = bidi_lstm_bwd_chain(g32, c32, gy, Wh2, L900)
        f32_t, bf_t = in_turns(
            lambda: bidi_lstm_bwd_chain(g32, c32, gy, Wh2, L900),
            lambda: bidi_lstm_bwd_chain(g16, c16, gy16, Wh2, L900,
                                        xz_bf16=True), 10)
        ms["K2 chain"] = {"ms": mean(bf_t), "f32_ms": mean(f32_t),
                          "turns": [f32_t, bf_t], "library_ms": None,
                          "plain_ms": time_ms(
                              lambda: lstm_ops.bidi_lstm_bwd_chain_plain(
                                  g16, c16, gy16, Wh2, L900, xz_bf16=True),
                              2),
                          "bound": lstm_bound("chain", B, T, D, H, V900,
                                              esize=2)}
        f32_t, bf_t = in_turns(
            lambda: bidi_lstm_bwd_reduce(x, y32, dz32, Wx2, False),
            lambda: bidi_lstm_bwd_reduce(x, y16, dz16, Wx2, False,
                                         xz_bf16=True), 10)
        bf_t2, lib = in_turns(
            lambda: bidi_lstm_bwd_reduce(x, y16, dz16, Wx2, False,
                                         xz_bf16=True),
            einsum_reduce(x.bfloat16(), y16, dz16, Wx2.bfloat16(), False), 10)
        ms["K2 reduction"] = {
            "ms": mean(bf_t + bf_t2), "f32_ms": mean(f32_t),
            "turns": [f32_t, bf_t], "library_ms": mean(lib),
            "plain_ms": time_ms(lambda: lstm_ops.bidi_lstm_bwd_reduce_plain(
                x, y16, dz16, Wx2, False, xz_bf16=True), 2),
            "bound": lstm_bound("reduce", B, T, D, H, V900, esize=2)}
        del lstm, lstm16, px16, y16, g16, c16, y32, g32, c32, dz16, dz32
        # bidi2's layer 2: K4 both modes, the chain at H=200, the reduction
        # with dx.
        pf, pr, x = weights["bidi2 layer 2"]
        xz16 = lstm_ops.hoisted_projection(pf, pr, x, xz_bf16=True)
        xz32 = lstm_ops.hoisted_projection(pf, pr, x)
        lstm = cudnn_lstm(pf, pr, dev)
        lstm16 = copy.deepcopy(lstm).to(torch.bfloat16)
        px16 = packed(x.bfloat16(), L900)
        for name, fn, kind in (("K4", bidi_lstm_infer_xz, "xz"),
                               ("K4 state", bidi_lstm_fwd_state_xz,
                                "xz_state")):
            f32_t, bf_t = in_turns(
                lambda: fn(pf, pr, xz32, L900),
                lambda: fn(pf, pr, xz16, L900, xz_bf16=True), 5)
            if name == "K4":
                whole = (lambda: bidi_lstm_infer(pf, pr, x, L900,
                                                 xz_bf16=True),
                         lambda: lstm16(px16))
                plain = lstm_ops.bidi_lstm_apply_xz
            else:
                whole = (lambda: bidi_lstm_fwd_state_xz(
                    pf, pr, lstm_ops.hoisted_projection(pf, pr, x,
                                                        xz_bf16=True),
                    L900, xz_bf16=True),
                    cudnn_step(lstm16, px16, False)[0])
                plain = lstm_ops.bidi_lstm_fwd_state_xz_plain
            tot, lib = in_turns(*whole, 5)
            ms[name] = {"ms": mean(bf_t), "f32_ms": mean(f32_t),
                        "turns": [f32_t, bf_t], "library_ms": mean(lib),
                        "hoisted_total_ms": mean(tot),
                        "plain_ms": time_ms(lambda: plain(
                            pf, pr, xz16, L900, xz_bf16=True), 1),
                        "bound": lstm_bound(kind, B, T, D2, H2, V900,
                                            esize=2)}
        ms["hoisted product"] = {
            "ms": time_ms(lambda: lstm_ops.hoisted_projection(
                pf, pr, x, xz_bf16=True), 10),
            "f32_ms": time_ms(lambda: lstm_ops.hoisted_projection(pf, pr, x),
                              10)}
        y16, g16, c16 = bidi_lstm_fwd_state_xz(pf, pr, xz16, L900,
                                               xz_bf16=True)
        y32, g32, c32 = bidi_lstm_fwd_state_xz(pf, pr, xz32, L900)
        del xz16, xz32, lstm, lstm16, px16
        gy = uniform(rng, (B, T, 2 * H2), -1.0, 1.0, dev)
        gy16 = gy.bfloat16()
        Wh2, Wx2 = stack2(pf, pr, "Wh"), stack2(pf, pr, "Wx")
        dz16 = bidi_lstm_bwd_chain(g16, c16, gy16, Wh2, L900, xz_bf16=True)
        dz32 = bidi_lstm_bwd_chain(g32, c32, gy, Wh2, L900)
        f32_t, bf_t = in_turns(
            lambda: bidi_lstm_bwd_chain(g32, c32, gy, Wh2, L900),
            lambda: bidi_lstm_bwd_chain(g16, c16, gy16, Wh2, L900,
                                        xz_bf16=True), 5)
        ms["K2 chain H=200"] = {
            "ms": mean(bf_t), "f32_ms": mean(f32_t), "turns": [f32_t, bf_t],
            "plain_ms": time_ms(lambda: lstm_ops.bidi_lstm_bwd_chain_plain(
                g16, c16, gy16, Wh2, L900, xz_bf16=True), 1),
            "bound": lstm_bound("chain", B, T, D2, H2, V900, esize=2)}
        x16 = x.bfloat16()
        f32_t, bf_t = in_turns(
            lambda: bidi_lstm_bwd_reduce(x, y32, dz32, Wx2, True),
            lambda: bidi_lstm_bwd_reduce(x16, y16, dz16, Wx2, True,
                                         xz_bf16=True), 5)
        bf_t2, lib = in_turns(
            lambda: bidi_lstm_bwd_reduce(x16, y16, dz16, Wx2, True,
                                         xz_bf16=True),
            einsum_reduce(x16, y16, dz16, Wx2.bfloat16(), True), 5)
        ms["K2 reduction with dx"] = {
            "ms": mean(bf_t + bf_t2), "f32_ms": mean(f32_t),
            "turns": [f32_t, bf_t], "library_ms": mean(lib),
            "plain_ms": time_ms(lambda: lstm_ops.bidi_lstm_bwd_reduce_plain(
                x16, y16, dz16, Wx2, True, xz_bf16=True), 1),
            "bound": lstm_bound("reduce", B, T, D2, H2, V900, dx=True,
                                esize=2)}
        del y16, g16, c16, y32, g32, c32, dz16, dz32, x16
    for name, m in ms.items():
        log(f"[timing] {card} | bf16 {name} at the bench shape (lengths "
            f"{TRUE_T}): {m['ms']:.3f} ms, f32 mode {m['f32_ms']:.3f} ms"
            + (f" (in turns f32, bf16, bf16, f32: "
               f"{m['turns'][0][0]:.3f}, {m['turns'][1][0]:.3f}, "
               f"{m['turns'][1][1]:.3f}, {m['turns'][0][1]:.3f})"
               if "turns" in m else "")
            + (f"; plain bf16 {m['plain_ms']:.3f} ms" if "plain_ms" in m
               else "")
            + (f"; library {m['library_ms']:.3f} ms" if m.get("library_ms")
               else "")
            + (f"; bound {m['bound'][0]:.3f} ms ({m['bound'][1]})"
               if "bound" in m else ""))
    return res


# K2's bf16 reduction at the four shapes the port runs it at (B, T, D, H,
# with dx): the filter path's (phase 21: FILTER_B = B, D=19, H=100, the
# T=32 bucket), bidi's, and
# bidi2's two layers (the second, D=400, with dx: its x is the first
# layer's output and needs a gradient).
K2_BF16_SHAPES = (((B, 32, 19, H), False), ((B, T, D, H), False),
                  ((B, T, D, H2), False), ((B, T, D2, H2), True))


def k2_bf16_turns(dev, card: str, k2_against=None,
                  profile: bool = False) -> dict:
    """K2's bf16 reduction at K2_BF16_SHAPES (lengths TRUE_T at T=1024,
    seeded lengths of 11-32 frames at the filter's shape; seeded streams,
    y and dz 0 on padded frames): the wrapper in turns with the plain
    version's einsums on bf16 operands (the library yardstick) and, with
    --k2-against, with that build's bf16 reduction (outputs within 2e-2 of
    max|old|: dx is rounded to bf16, so the two may differ by a flip); the
    host's enqueue ms of a call and of the einsums on an idle card (where
    it exceeds the card's time, the timed loop measures the host); the
    plain version's time, the bound at this run's valid frames, the plan
    (whose scratch must be what the C side counts), and with ``profile``
    the device time of each kernel it launches and of the einsums'
    (torch.profiler; a fresh process's, as scripts/torch_k2_bf16_probe.py
    runs it: late in a long process the profiler loses records). Returns
    {label: row}."""
    out = {}
    for (b, t, d, h), need_dx in K2_BF16_SHAPES:
        rng = np.random.RandomState(7)
        if t == T:
            L = torch.full((b,), TRUE_T, dtype=torch.int32, device=dev)
        else:
            L = torch.from_numpy(rng.randint(11, t + 1, b).astype(
                np.int32)).to(dev)
        pad = padded(L, b, t, dev)
        x = uniform(rng, (b, t, d), -1.0, 1.0, dev)
        if d == 2 * h:
            x = x.bfloat16()   # the first layer's output
        y = uniform(rng, (b, t, 2 * h), -1.0, 1.0, dev)
        dz = uniform(rng, (b, t, 2, 4 * h), -0.1, 0.1, dev)
        y[pad], dz[pad] = 0.0, 0.0
        y, dz = y.bfloat16(), dz.bfloat16()
        wx = uniform(rng, (2, d, 4 * h), -0.1, 0.1, dev)
        plan = bk.device_reduce_plan(dev, b, t, d, h)
        n = bk._kernel("clstm_bidi_lstm_bwd_bf16_scratch")(b, t, d, h,
                                                           plan.tt, plan.spr)
        if n != plan.scratch:
            raise AssertionError(f"K2 bf16 plan {plan}: the C side counts "
                                 f"{n} bytes of scratch")
        reps = 20 if t < T else 5

        def new():
            return bidi_lstm_bwd_reduce(x, y, dz, wx, need_dx, xz_bf16=True)
        lib_fn = einsum_reduce(x.bfloat16(), y, dz, wx.bfloat16(), need_dx)
        k_t, lib = in_turns(new, lib_fn, reps)
        label = f"B={b} T={t} D={d} H={h}" + (" dx" if need_dx else "")
        row = {"plan": plan._asdict(), "ms": k_t, "library_ms": lib,
               "bound": lstm_bound("reduce", b, t, d, h, int(L.sum()),
                                   dx=need_dx, esize=2),
               "plain_ms": time_ms(
                   lambda: lstm_ops.bidi_lstm_bwd_reduce_plain(
                       x, y, dz, wx, need_dx, xz_bf16=True), 2)}
        if k2_against and k2_against[2]:
            row["k2_against"] = against_turns(
                f"K2 reduction bf16 {label}",
                lambda: k2_against[2](x, y, dz, wx, need_dx), new, reps,
                card, tol=2e-2)
        row["enqueue_ms"] = enqueue_ms(new, reps)
        row["library_enqueue_ms"] = enqueue_ms(lib_fn, reps)
        per = ""
        if profile:
            for key, fn in (("kernels_ms", new), ("library_kernels_ms",
                                                   lib_fn)):
                fn()
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    for _ in range(reps):
                        fn()
                    torch.cuda.synchronize()
                row[key] = {kernel_name(e.key): device_us(e) / reps / 1e3
                            for e in prof.key_averages() if device_us(e) > 0}
            per = ("; device ms per kernel " + ", ".join(
                f"{k} {v:.4f}" for k, v in row["kernels_ms"].items())
                + f" (sum {sum(row['kernels_ms'].values()):.4f}); the "
                f"einsums' {sum(row['library_kernels_ms'].values()):.4f}")
        log(f"[timing] {card} | K2 reduction bf16 {label}: in turns kernel "
            f"{k_t[0]:.4f}, einsum {lib[0]:.4f}, {lib[1]:.4f}, kernel "
            f"{k_t[1]:.4f} ms; enqueue kernel {row['enqueue_ms']:.4f}, "
            f"einsum {row['library_enqueue_ms']:.4f} ms; plain "
            f"{row['plain_ms']:.3f} ms; bound {row['bound'][0]:.4f} ms "
            f"({row['bound'][1]}){per}; plan nw {plan.nw} tt {plan.tt} spr "
            f"{plan.spr} ranges {plan.ranges} blocks {plan.blocks} nwd "
            f"{plan.nwd}")
        out[label] = row
        del x, y, dz, wx
    return out


# K2's bf16 chain (ops/bidi_lstm_kernel.py::chain_plan) across its plan's
# edges (B, T, H): H of 1, 7 and 201 (not a multiple of the cluster size
# or of an 8-column n tile), 100 and 200 (the bench widths), 209 (two m16
# tiles a cluster at B=384), 700 and 2048 (no cluster holds a slice of Wh:
# the L2 branch); B of 1, 3, 17 (below and across 16 rows a cluster), 256,
# 384, 512 and 1024 (the plans of larger batches: C=2, C=1, 32 rows); T of
# 1 and a few frames. Each with mixed lengths (a row of length 0 and one of
# T), all lengths 0 and none, at the plan, and where that is the L2 branch
# although a cluster plan fits (chain_prefers_l2: 16-64 frames at H=100,
# 16 or more at H=64) also at that cluster plan.
CHAIN16_EDGES = ((1, 5, 1), (3, 1, 7), (17, 9, 100), (256, 1, 200),
                 (256, 4, 100), (33, 20, 100), (5, 70, 64), (3, 7, 201),
                 (17, 5, 201), (384, 2, 209),
                 (512, 2, 100), (512, 2, 200), (1024, 1, 100),
                 (1024, 2, 200), (4, 6, 700), (1, 1, 2048), (3, 4, 2048))
# The bf16 chain at the shapes the port runs it at (B, T, H, lengths): the
# filter path's (seeded lengths 11-32), bidi's, and bidi2's (both layers
# run the chain at H=200: it does not see D).
CHAIN16_SHAPES = (("filter", B, 32, H), ("bidi", B, T, H),
                  ("bidi2 layers 1 and 2", B, T, H2))


def chain_inputs(rng, b, t, h, lengths, dev):
    """Seeded inputs of K2's chain in the bf16 mode: gates [b,t,2,4h] f32
    (gi, gf, go in (0.02, 0.98), ci in (-0.96, 0.96)), cell [b,t,2,h] and
    gy [b,t,2h] bf16, each 0 on padded frames as K1 leaves them, and Wh2
    [2,h,4h] f32 uniform ±min(0.3, 3/sqrt(h))."""
    g = rng.uniform(0.02, 0.98, (b, t, 2, 4 * h)).astype(np.float32)
    g[..., 3 * h:] = 2 * g[..., 3 * h:] - 1
    c = rng.uniform(-1, 1, (b, t, 2, h)).astype(np.float32)
    gy = rng.uniform(-1, 1, (b, t, 2 * h)).astype(np.float32)
    sc = min(0.3, 3.0 / h ** 0.5)
    wh = rng.uniform(-sc, sc, (2, h, 4 * h)).astype(np.float32)
    g, c, gy, wh = (torch.from_numpy(v).to(dev) for v in (g, c, gy, wh))
    if lengths is not None:
        pad = padded(lengths, b, t, dev)
        g[pad], c[pad], gy[pad] = 0.0, 0.0, 0.0
    return g, c.bfloat16(), gy.bfloat16(), wh


def chain_plan_line(plan) -> str:
    """A chain plan as chip_smoke logs it."""
    if not plan.C:
        return "L2 branch (the L2 kernel)"
    return (", ".join(f"{k} {v}" for k, v in plan._asdict().items())
            + ("; one wave" if 2 * plan.groups <= plan.clusters else
               "; more than one wave"))


def chain_other(dev, b: int, t: int, h: int):
    """The branch the bf16 chain's plan at (b, t, h) did not take, where
    there is one: the L2 branch beside a cluster plan, and the cluster plan
    (chain_cluster_plan) beside the L2 branch where chain_prefers_l2. None
    where no cluster holds a slice of Wh."""
    if bk.device_chain_plan(dev, b, t, h).C:
        return bk.CHAIN_L2
    p = bk.chain_cluster_plan(b, h, bk.chain_clusters(dev, h))
    return p if p.C else None


def chain16_edges(dev) -> dict:
    """K2's bf16 chain at CHAIN16_EDGES (phase 18), with mixed, all-zero
    and no lengths, through the wrapper (the plan) and, where the plan is
    the L2 branch although a cluster plan fits (chain_prefers_l2), at that
    cluster plan: within BF16_FACTOR of the plain bf16 version's distance
    from float64 (max and, on enough values, mean), exactly 0 on padded
    frames, two calls bitwise equal; the plan's shared memory as the C side
    counts it. Returns {label: distances} and logs each plan."""
    rng = np.random.RandomState(21)
    out = {}
    for (b, t, h) in CHAIN16_EDGES:
        ml = rng.randint(0, t + 1, b).astype(np.int32)
        ml[0], ml[-1] = 0, t
        plan = bk.device_chain_plan(dev, b, t, h)
        plans = [("plan", plan)]
        other = chain_other(dev, b, t, h)
        if not plan.C and other is not None:
            plans.append(("cluster plan", other))
        for _, p in plans:
            if p.C:
                n = bk._kernel("clstm_bidi_lstm_bwd_chain16_smem")(
                    h, p.C, p.rows, p.units, p.ksplit)
                if n != p.smem:
                    raise AssertionError(f"chain plan {p}: the C side "
                                         f"counts {n} bytes")
        for lname, L in (("mixed", torch.from_numpy(ml).to(dev)),
                         ("all 0", torch.zeros(b, dtype=torch.int32,
                                               device=dev)),
                         ("none", None)):
            g, c, gy, wh = chain_inputs(rng, b, t, h, L, dev)
            Lr = (torch.full((b,), t, dtype=torch.int32, device=dev)
                  if L is None else L)
            with torch.no_grad():
                ref = lstm_ops.bidi_lstm_bwd_chain_plain(g, c, gy, wh, L,
                                                         xz_bf16=True)
                r = lstm_ops.bidi_lstm_bwd_chain_plain(g, c, gy, wh.double(),
                                                       L, xz_bf16=True)
            for which, p in plans:
                label = f"B={b} T={t} H={h} lengths={lname} {which}"

                def run():
                    if which == "plan":
                        return (bidi_lstm_bwd_chain(g, c, gy, wh, L,
                                                    xz_bf16=True),)
                    return (bk._chain(p, g, c, gy, wh, L, True),)
                d, e = check_streams(f"K2 chain bf16 {label}", run(), run(),
                                     Lr, (BF16_ULP,), (ref,), (r,))
                out[label] = d[0]
                log(f"[chain16] {label}: {chain_plan_line(p)}; float64 "
                    f"distance kernel/plain {d[0][0]:.2e}/{d[0][1]:.2e}, "
                    f"max|kernel - plain| {e:.2e}; padded frames exactly 0, "
                    "two calls bitwise equal")
    return out


def chain16_turns(dev, card: str, k2_against=None, reps=None) -> dict:
    """K2's bf16 chain at CHAIN16_SHAPES: the plan's kernel in turns with
    the branch it did not take (chain_other: the L2 branch of this build,
    WhT read from L2 or shared memory at every step, beside a cluster
    plan; the cluster plan beside the L2 branch) and, with --k2-against, with that build's bf16 chain (outputs
    within 2e-2 of max|old|: a flip of a bf16 rounding carries down the
    chain). Returns {label: row} with the plan, the times and the bound at
    this run's valid frames."""
    out = {}
    for label, b, t, h in CHAIN16_SHAPES:
        rng = np.random.RandomState(8)
        L = (torch.full((b,), TRUE_T, dtype=torch.int32, device=dev)
             if t == T else torch.from_numpy(
                 rng.randint(11, t + 1, b).astype(np.int32)).to(dev))
        g, c, gy, wh = chain_inputs(rng, b, t, h, L, dev)
        plan = bk.device_chain_plan(dev, b, t, h)
        other = chain_other(dev, b, t, h)
        n = reps or (20 if t < T else 5)

        def cur():
            return bidi_lstm_bwd_chain(g, c, gy, wh, L, xz_bf16=True)

        def alt():
            return bk._chain(other, g, c, gy, wh, L, True)
        e = rel_err(alt().float(), cur().float())
        if not e <= 2e-2:
            raise AssertionError(f"K2 chain bf16 {label}: the other branch "
                                 f"is {e:.3e} of max|dz| off")
        k_t, a_t = in_turns(cur, alt, n)
        row = {"plan": plan._asdict(), "ms": k_t,
               "other_branch": {"plan": other._asdict(), "ms": a_t},
               "bound": lstm_bound("chain", b, t, 0, h, int(L.sum()),
                                   esize=2),
               "enqueue_ms": enqueue_ms(cur, n)}
        if k2_against and k2_against[3]:
            row["k2_against"] = against_turns(
                f"K2 chain bf16 {label}",
                lambda: k2_against[3](g, c, gy, wh, L), cur, n, card,
                tol=2e-2)
        log(f"[timing] {card} | K2 chain bf16 {label} B={b} T={t} H={h}: "
            f"plan {chain_plan_line(plan)}; in turns plan {k_t[0]:.4f}, "
            f"{chain_plan_line(other)} {a_t[0]:.4f}, {a_t[1]:.4f}, plan "
            f"{k_t[1]:.4f} ms; enqueue {row['enqueue_ms']:.4f} ms; bound "
            f"{row['bound'][0]:.4f} ms ({row['bound'][1]})")
        out[label] = row
        del g, c, gy, wh
    return out


# K3, K1 and K4 in both modes on the bf16 tensor-core kernel
# (ops/bidi_lstm_kernel.py::fwd16_plan) across its plan's edges (B, T, D,
# H; D 0: K4 on the bf16 hoisted product): H of 1, 7 and 201
# (not a multiple of 8 or of the cluster size), 24 and 64, 100 and 200 (the
# bench widths), 209 (C=4 and two m16 tiles at B=384), 450 and 700 (K4 and
# K1: no plan fits, the FMA kernel), 2048; B of 1, 3, 17, 33 (below and
# across 16 rows a cluster), 256, 384, 512 and 1024 (the plans of larger
# batches: C=2, C=1, 32 rows); T of 1 to 70; odd D (padded) and D+1 past
# 128. Each with mixed lengths (a row of length 0 and one of T), all
# lengths 0 and none, through the wrapper (its plan) and, where the plan is
# the FMA kernel although a fwd16 plan fits (fwd16_prefers_old), also at
# that plan.
FWD16_EDGES = ((1, 5, 6, 1), (3, 1, 6, 7), (17, 9, 48, 100),
               (33, 20, 5, 201), (256, 1, 0, 200), (256, 4, 48, 100),
               (40, 12, 130, 64), (5, 70, 20, 64), (3, 7, 0, 201),
               (17, 5, 48, 24), (384, 2, 48, 209), (512, 2, 48, 100),
               (512, 2, 0, 200), (1024, 1, 48, 100), (1024, 2, 0, 200),
               (17, 5, 0, 450), (4, 6, 6, 700), (1, 1, 4, 2048),
               (3, 4, 0, 2048))
# K1 and K4's state mode at the shapes the port's bf16 training runs them
# at (label, B, T, D, H; D 0: K4's state mode on bidi2's layer 2, D=400):
# bidi's, bidi2's two layers, and the filter path's two T buckets (D=19,
# lengths as its buckets hold them).
FWD16_SHAPES = (("bidi K1", B, T, D, H), ("bidi2 layer 1 K1", B, T, D, H2),
                ("bidi2 layer 2 K4 state", B, T, 0, H2),
                ("filter T=16 K1", B, 16, 19, H),
                ("filter T=32 K1", B, 32, 19, H))
# K3 and K4 inference at the shapes the port serves (bench.py's infer
# profile: bidi, bidi2's two layers; clstmfilter's two T buckets).
FWD16_INFER_SHAPES = (("bidi K3", B, T, D, H),
                      ("bidi2 layer 1 K3", B, T, D, H2),
                      ("bidi2 layer 2 K4", B, T, 0, H2),
                      ("filter T=16 K3", B, 16, 19, H),
                      ("filter T=32 K3", B, 32, 19, H))
# Calls a turn of fwd16_turns at the short chains (5 at T=1024).
FWD16_TURN_REPS = 20
# The cluster barrier's round trip at C=3, measured by
# scripts/torch_k2_chain_probe.py in an earlier run (NVIDIA H100 80GB HBM3,
# 700.00 W), not by this script: a chain of T steps on clusters cannot take
# less than T of them. The serial floor derived from it is logged beside
# bound_ms and kept out of the kernels line, which holds only this run's
# measurements and bounds.
BARRIER_US = 0.731


def fwd16_plan_line(plan) -> str:
    """A fwd16 plan as chip_smoke logs it."""
    if not plan.C:
        return "the FMA kernel (fwd_plan)"
    return (", ".join(f"{k} {v}" for k, v in plan._asdict().items())
            + ("; one wave" if 2 * plan.groups <= plan.clusters else
               "; more than one wave"))


def fwd16_smem_checked(dev, d: int, h: int, plan, state: bool = True
                       ) -> None:
    """Raise unless the kernel's own count of a fwd16 plan's shared memory
    (clstm_bidi_lstm_fwd16_smem, the mode's instance) is the plan's."""
    if not plan.C:
        return
    hoist = d == 0
    n = bk._kernel("clstm_bidi_lstm_fwd16_smem")(
        0 if hoist else d + d % 2, h, int(hoist), int(state), plan.C,
        plan.rows, plan.units)
    if n != plan.smem:
        raise AssertionError(f"fwd16 plan {plan}: the kernel counts {n} "
                             f"bytes of shared memory")


def fwd16_inputs(rng, b, t, d, h, dev):
    """Seeded weights (uniform ±min(0.3, 3/sqrt(h))) and the kernel's input
    at (b, t, d, h): x [b, t, d] uniform ±1 for K1, or for d 0 (K4's state
    mode) the bf16 hoisted product of such an x of 8 columns ->
    (pf, pr, inp, hoist)."""
    sc = min(0.3, 3.0 / h ** 0.5)
    dx = d or 8
    pf, pr = lstm_params(rng, dx, h, dev, sc), lstm_params(rng, dx, h, dev,
                                                           sc)
    x = uniform(rng, (b, t, dx), -1.0, 1.0, dev)
    if d:
        return pf, pr, x, False
    return pf, pr, lstm_ops.hoisted_projection(pf, pr, x, xz_bf16=True), True


def fwd16_check(label, pf, pr, inp, hoist, L, plan=None, state=True):
    """K1 (K4's state mode with ``hoist``; without ``state`` K3, or K4
    inference) in the bf16 mode, through the wrapper or, given ``plan``,
    launched at it (bk._fwd), against the plain bf16 version and the
    float64 recipe: check_streams' rule, padded frames exactly 0, two calls
    bitwise equal -> (distances, max|kernel - plain|)."""
    kind = ("fwd_xz" if hoist else "fwd") + ("_state" if state else "")
    if state:
        plain_fn = (lstm_ops.bidi_lstm_fwd_state_xz_plain if hoist
                    else lstm_ops.bidi_lstm_fwd_state_plain)
        wrapper = bidi_lstm_fwd_state_xz if hoist else bidi_lstm_fwd_state
    else:
        def plain_fn(*a, **kw):
            fn = (lstm_ops.bidi_lstm_apply_xz if hoist
                  else lstm_ops.bidi_lstm_apply)
            return (fn(*a, **kw),)

        def wrapper(*a, **kw):
            if hoist:
                return (bidi_lstm_infer_xz(*a, **kw),)
            return (bidi_lstm_infer(*a, hoist=False, **kw),)
    b, t = inp.shape[:2]
    Lr = (torch.full((b,), t, dtype=torch.int32, device=inp.device)
          if L is None else L)
    with torch.no_grad():
        plain = plain_fn(pf, pr, inp, L, xz_bf16=True)
        ref = plain_fn(d64(pf), d64(pr), inp, L, xz_bf16=True)

        def run():
            if plan is None:
                return wrapper(pf, pr, inp, L, xz_bf16=True)
            out = bk._fwd(kind, plan, pf, pr, inp, L, True)
            return out if state else (out,)
        return check_streams(label, run(), run(), Lr,
                             (BF16_ULP,) * len(plain), plain, ref)


def fwd16_edges(dev) -> dict:
    """K1 and K4's state mode, then K3 and K4 inference, in the bf16 mode
    at FWD16_EDGES (phase 18), with mixed, all-zero and no lengths, through
    the wrapper and, where its plan is the FMA kernel although a fwd16 plan
    fits, at that plan: the bf16 rule, padded frames exactly 0, two calls
    bitwise equal; each plan logged with the kernel's own count of its
    shared memory. Returns {"dist": {label: distances}, "err": max|kernel -
    plain| of the state modes, "infer_err": of the inference modes}."""
    rng = np.random.RandomState(23)
    out, err = {}, {True: 0.0, False: 0.0}
    for (b, t, d, h) in FWD16_EDGES:
        pf, pr, inp, hoist = fwd16_inputs(rng, b, t, d, h, dev)
        dk = 0 if hoist else d + d % 2
        ml = rng.randint(0, t + 1, b).astype(np.int32)
        ml[0], ml[-1] = 0, t
        for state in (True, False):
            plan = bk.device_fwd16_plan(dev, b, t, dk, h, hoist, state=state)
            plans = [("plan", plan)]
            if not plan.C:
                other = bk.fwd16_cluster_plan(
                    b, dk, h, hoist,
                    bk.fwd16_clusters(dev, dk, h, hoist, state=state),
                    state=state)
                if other.C:
                    plans.append(("fwd16 plan", other))
            for _, p in plans:
                fwd16_smem_checked(dev, d, h, p, state)
            mode = (("K4 state" if hoist else "K1") if state
                    else ("K4" if hoist else "K3"))
            for lname, L in (("mixed", torch.from_numpy(ml).to(dev)),
                             ("all 0", torch.zeros(b, dtype=torch.int32,
                                                   device=dev)),
                             ("none", None)):
                for which, p in plans:
                    label = (f"{mode} B={b} T={t} D={d or '-'} H={h} "
                             f"lengths={lname} {which}")
                    dist, e = fwd16_check(f"bf16 {label}", pf, pr, inp,
                                          hoist, L, None if which == "plan"
                                          else p, state)
                    out[label] = functools.reduce(dist_max, dist.values())
                    err[state] = max(err[state], e)
                    log(f"[fwd16] {label}: {fwd16_plan_line(p)}; float64 "
                        f"distance kernel/plain (the larger over "
                        f"{'y, gates, cell' if state else 'y'}) "
                        f"{out[label][0]:.2e}/{out[label][1]:.2e}, mean "
                        f"{out[label][2]:.2e}/{out[label][3]:.2e}; "
                        f"max|kernel - plain| {e:.2e}; padded frames "
                        "exactly 0, two calls bitwise equal")
    return {"dist": out, "err": err[True], "infer_err": err[False]}


def fwd16_bench_planted(dev) -> dict:
    """The planted controls (planted_controls: the float64 recipe with h
    left unrounded, or the bias kept f32, in the kernel's place) at bidi2's
    two layer shapes, where the fwd16 kernel runs K1 and K4's state mode
    (bidi's is phase 18's own): each must fail the bf16 rule, lengths 900
    and mixed. Returns {shape: {fault: distances}}."""
    rng = np.random.RandomState(29)
    out = {}
    for name, d in (("bidi2 layer 1", D), ("bidi2 layer 2", D2)):
        pf, pr = lstm_params(rng, d, H2, dev, 0.1), lstm_params(rng, d, H2,
                                                                dev, 0.1)
        x = uniform(rng, (B, T, d), -1.0, 1.0, dev)
        mixed = rng.randint(0, T + 1, B).astype(np.int32)
        mixed[0], mixed[1] = 0, T
        for lname, L in (("900", torch.full((B,), TRUE_T, dtype=torch.int32,
                                             device=dev)),
                         ("mixed", torch.from_numpy(mixed).to(dev))):
            key = f"{name} lengths={lname}"
            out[key] = planted_controls(pf, pr, x, L)
            log(f"[fwd16] planted controls at {key} (B={B} T={T} D={d} "
                f"H={H2}), max/plain max, mean/plain mean: " + ", ".join(
                    f"{f} {v[0]:.2e}/{v[1]:.2e}, {v[2]:.2e}/{v[3]:.2e}"
                    for f, v in out[key].items())
                + f"; each fails the rule ({BF16_FACTOR:g}x plain)")
        del x
    return out


def fwd16_lengths(rng, b: int, t: int, dev) -> torch.Tensor:
    """Lengths of FWD16_SHAPES: TRUE_T at T=1024, else as a filter bucket
    holds them (uniform in [ceil(t/3), t], the first row t)."""
    if t == T:
        return torch.full((b,), TRUE_T, dtype=torch.int32, device=dev)
    ln = rng.randint(-(-t // 3), t + 1, b).astype(np.int32)
    ln[0] = t
    return torch.from_numpy(ln).to(dev)


def fwd16_turns(dev, card: str, fwd_against=None, reps=None,
                state: bool = True) -> dict:
    """K1 and K4's state mode in the bf16 mode at FWD16_SHAPES (phase 19),
    or without ``state`` K3 and K4 inference at FWD16_INFER_SHAPES: the
    fwd16 kernel (its plan, or its cluster plan where the plan is the FMA
    kernel) in turns with the FMA kernel's bf16 instance forced at its own plan
    (fwd_plan), both through bk._fwd, outputs within 2e-2 of max|old| (a
    flip of a bf16 rounding carries down the chain); the library call,
    cuDNN's bf16 nn.LSTM forward (with grad enabled for the state modes,
    without for inference), in turns with the
    fwd16 kernel; with --fwd-against, that build's bf16 kernel in turns
    with the current one; the plain version's time, the bound at this
    run's valid frames, and in the log the serial floor derived from an
    earlier run's barrier round trip (steps x BARRIER_US); each fwd16 plan
    logged with the kernel's own count of its shared memory.
    Returns {label: row}."""
    out = {}
    for label, b, t, d, h in FWD16_SHAPES if state else FWD16_INFER_SHAPES:
        rng = np.random.RandomState(9)
        hoist = d == 0
        dx = D2 if hoist else d
        sc = 0.3 if h == H else 0.1
        pf, pr = lstm_params(rng, dx, h, dev, sc), lstm_params(rng, dx, h,
                                                               dev, sc)
        x = uniform(rng, (b, t, dx), -1.0 if hoist else 0.0, 1.0, dev)
        L = fwd16_lengths(rng, b, t, dev)
        inp = (lstm_ops.hoisted_projection(pf, pr, x, xz_bf16=True)
               if hoist else x)
        kind = ("fwd_xz" if hoist else "fwd") + ("_state" if state else "")
        dk = 0 if hoist else d + d % 2
        plan = bk.device_fwd16_plan(dev, b, t, dk, h, hoist, state=state)
        new_plan = plan if plan.C else bk.fwd16_cluster_plan(
            b, dk, h, hoist,
            bk.fwd16_clusters(dev, dk, h, hoist, state=state), state=state)
        fwd16_smem_checked(dev, d, h, new_plan, state)
        old_plan = bk.device_plan(dev, b, dk, h, hoist, state, 2)
        n = reps or (FWD16_TURN_REPS if t < T else 5)

        def new():
            out_ = bk._fwd(kind, new_plan, pf, pr, inp, L, True)
            return out_ if state else (out_,)

        def old():
            out_ = bk._fwd(kind, old_plan, pf, pr, inp, L, True)
            return out_ if state else (out_,)
        with torch.no_grad():
            e = max(rel_err(u.float(), v.float())
                    for u, v in zip(new(), old()))
            if not e <= 2e-2:
                raise AssertionError(f"fwd16 {label}: the FMA kernel is "
                                     f"{e:.3e} of max off")
            k_t, o_t = in_turns(new, old, n)
            lstm16 = copy.deepcopy(cudnn_lstm(pf, pr, dev)).to(
                torch.bfloat16)
            px16 = packed(x.bfloat16(), L)
            k_t2, lib = in_turns(new, cudnn_step(lstm16, px16, False)[0]
                                 if state else lambda: lstm16(px16), n)
            if state:
                plain_fn = (lstm_ops.bidi_lstm_fwd_state_xz_plain if hoist
                            else lstm_ops.bidi_lstm_fwd_state_plain)
            else:
                plain_fn = (lstm_ops.bidi_lstm_apply_xz if hoist
                            else lstm_ops.bidi_lstm_apply)
            plain_ms = time_ms(lambda: plain_fn(pf, pr, inp, L, xz_bf16=True),
                               1 if t == T else 2)
            del lstm16, px16
        V = int(L.sum())
        row = {"plan": plan._asdict(), "fwd16_plan": new_plan._asdict(),
               "ms": k_t, "fma_ms": o_t, "fma_plan": old_plan._asdict(),
               "library_ms": lib, "ms_beside_library": k_t2,
               "plain_ms": plain_ms,
               "bound": lstm_bound(("xz" if hoist else "fwd")
                                   + ("_state" if state else ""), b, t, dx,
                                   h, V, esize=2),
               "enqueue_ms": enqueue_ms(new, n)}
        fa_key = (("K4" if hoist else "K1" if state else "K3")
                  + (" state" if hoist and state else "") + " bf16")
        if fwd_against and fwd_against.get(fa_key):
            fa = fwd_against[fa_key]

            def against():
                out_ = fa(pf, pr, inp, L)
                return out_ if state else (out_,)
            row["fwd_against"] = against_turns(
                f"fwd16 {label}", against, new, n, card, tol=2e-2)
        log(f"[timing] {card} | bf16 {label} B={b} T={t} D={dx} H={h}: plan "
            f"{fwd16_plan_line(plan)}; in turns fwd16 {k_t[0]:.4f}, FMA "
            f"kernel (C={old_plan.C} rows={old_plan.rows}) {o_t[0]:.4f}, "
            f"{o_t[1]:.4f}, fwd16 {k_t[1]:.4f} ms; cuDNN bf16 nn.LSTM fwd "
            f"({'grad' if state else 'no grad'}) {lib[0]:.4f}, {lib[1]:.4f} "
            f"in turns with fwd16 "
            f"{k_t2[0]:.4f}, {k_t2[1]:.4f}; plain {plain_ms:.3f} ms; bound "
            f"{row['bound'][0]:.4f} ms ({row['bound'][1]}), serial floor "
            f"{int(L.max()) * BARRIER_US / 1e3:.4f} ms (derived: "
            f"{int(L.max())} steps x {BARRIER_US} us, the barrier round trip "
            f"of scripts/torch_k2_chain_probe.py's earlier run); enqueue "
            f"{row['enqueue_ms']:.4f} ms")
        out[label] = row
        del pf, pr, x, inp
    return out


@contextlib.contextmanager
def fwd16_off():
    """Inside the block the bf16 mode's K3, K1 and K4 (both modes) take the
    FMA kernel (device_fwd16_plan gives no plan), as they did before the
    tensor-core kernel."""
    saved = bk.device_fwd16_plan
    bk.device_fwd16_plan = lambda *args, **kw: bk.FWD16_NONE
    try:
        yield
    finally:
        bk.device_fwd16_plan = saved


@contextlib.contextmanager
def fwd16_window_off():
    """Inside the block fwd16_prefers_old's window is shut: every bf16 call
    that a fwd16 plan fits takes the tensor-core kernel, the filter's T=16
    and 32 buckets too. The cached fwd16 plans are dropped on the way in
    and out."""
    def drop():
        for k in [k for k in bk._plans if k[0] == "fwd16"]:
            del bk._plans[k]
    saved = bk.fwd16_prefers_old
    bk.fwd16_prefers_old = lambda T, H: False
    drop()
    try:
        yield
    finally:
        bk.fwd16_prefers_old = saved
        drop()


def predict_turns(spec, net, dev, reps: int, label: str, card: str) -> dict:
    """bench.py's infer profile (bench.py:611-651) on the port:
    make_predict_step (the no-grad forward and the per-frame argmax) in the
    bf16 mode at B=256, T=1024, x uniform in [0, 1) from RandomState(0),
    lengths 900, with K3 and K4 on the FMA kernel (fwd16_off) and on the
    fwd16 kernel, timed in turns (FMA, fwd16, fwd16, FMA; CUDA events). One
    call of each counted first: the fwd16 run must launch every bidi layer
    on the fwd16 kernel, the FMA run none. Logs and returns {"fma_ms":
    [..], "ms": [..], "lines_per_s", "fma_lines_per_s", "launches16"}."""
    predict = make_predict_step(spec, xz_bf16=True)
    x = torch.from_numpy(np.random.RandomState(0).rand(B, T, D).astype(
        np.float32)).to(dev)
    L = torch.full((B,), TRUE_T, dtype=torch.int32, device=dev)

    def old():
        with fwd16_off():
            return predict(net, x, L)

    def new():
        return predict(net, x, L)
    with torch.no_grad():
        got = {}
        for key, fn in (("fma", old), ("fwd16", new)):
            reset_counts()
            fn()
            torch.cuda.synchronize()
            got[key] = (sum(counts().values()), sum(counts16().values()))
        if got["fma"][1] or not got["fwd16"][0] == got["fwd16"][1] >= 1:
            raise AssertionError(f"{label} predict: launches (all, fwd16) "
                                 f"{got}: the fwd16 run must take the fwd16 "
                                 f"kernel at every layer, the FMA run never")
        o, n = in_turns(old, new, reps)
    out = {"fma_ms": o, "ms": n, "lines_per_s": B / mean(n) * 1e3,
           "fma_lines_per_s": B / mean(o) * 1e3,
           "launches16": got["fwd16"][1]}
    log(f"[timing] {card} | {label} bench.py infer profile (make_predict_step,"
        f" bf16, B={B} T={T} len={TRUE_T}), in turns (K3/K4 on the FMA "
        f"kernel, fwd16, fwd16, FMA): {o[0]:.3f}, {n[0]:.3f}, {n[1]:.3f}, "
        f"{o[1]:.3f} ms/batch; {out['fma_lines_per_s']:.1f} -> "
        f"{out['lines_per_s']:.1f} lines/s; {got['fwd16'][1]} fwd16 "
        "launches a batch")
    return out


def fwd16_step_turns(tocr, batch, reps: int, label: str, card: str) -> dict:
    """train_batch in the bf16 mode with K1 and K4's state mode on the FMA
    kernel (fwd16_off) and on the fwd16 kernel, timed in turns (FMA,
    fwd16, fwd16, FMA) on the host clock; the model's precision is
    restored. Logs and returns {"fma_ms": [..], "ms": [..]}."""
    saved_mode = tocr.xz_bf16

    def old():
        with fwd16_off():
            tocr.train_batch(batch)

    def new():
        tocr.train_batch(batch)
    tocr.xz_bf16 = True
    try:
        o1, n1, n2, o2 = (host_ms(f, reps) for f in (old, new, new, old))
    finally:
        tocr.xz_bf16 = saved_mode
    log(f"[timing] {card} | {label} bf16 train_batch in turns (K1/K4 state "
        f"on the FMA kernel, fwd16, fwd16, FMA): {o1:.3f}, {n1:.3f}, "
        f"{n2:.3f}, {o2:.3f} ms/step")
    return {"fma_ms": [o1, o2], "ms": [n1, n2]}


@contextlib.contextmanager
def k2_against_reduce(k2_against):
    """Inside the block, the training step's K2 in the bf16 mode is the
    --k2-against build's: its reduction, and its chain where it has a bf16
    one (bidi_lstm_bwd_reduce and bidi_lstm_bwd_chain swapped in the
    wrapper's module, which the backward looks them up in)."""
    saved, saved_chain = bk.bidi_lstm_bwd_reduce, bk.bidi_lstm_bwd_chain

    def reduce(x, y, dz, Wx2, need_dx=True, xz_bf16=False):
        if not xz_bf16:
            return saved(x, y, dz, Wx2, need_dx)
        return k2_against[2](x, y, dz, Wx2.detach(), need_dx)

    def chain(gates, cell, gy, Wh2, lengths=None, xz_bf16=False):
        if not xz_bf16 or k2_against[3] is None:
            return saved_chain(gates, cell, gy, Wh2, lengths, xz_bf16)
        return k2_against[3](gates, cell, gy, Wh2.detach(), lengths)
    bk.bidi_lstm_bwd_reduce, bk.bidi_lstm_bwd_chain = reduce, chain
    try:
        yield
    finally:
        bk.bidi_lstm_bwd_reduce, bk.bidi_lstm_bwd_chain = saved, saved_chain


def k2_step_turns(tocr, batch, k2_against, reps: int, label: str,
                  card: str) -> dict:
    """train_batch in the bf16 mode with K2's bf16 reduction and chain
    taken from the --k2-against build and with the current ones, timed in
    turns (against,
    current, current, against) on the host clock; the model's precision is
    restored. Logs and returns {"against_ms": [..], "ms": [..]}."""
    saved_mode = tocr.xz_bf16

    def against():
        with k2_against_reduce(k2_against):
            tocr.train_batch(batch)

    def current():
        tocr.train_batch(batch)
    tocr.xz_bf16 = True
    try:
        o1, n1, n2, o2 = (host_ms(f, reps) for f in (against, current,
                                                     current, against))
    finally:
        tocr.xz_bf16 = saved_mode
    log(f"[against] {card} | {label} bf16 train_batch in turns (against's "
        f"K2 bf16 reduction and chain, current, current, against's): "
        f"{o1:.3f}, {n1:.3f}, "
        f"{n2:.3f}, {o2:.3f} ms/step")
    return {"against_ms": [o1, o2], "ms": [n1, n2]}


def toy_learning(dev, xz_bf16: bool, seed: int = 0):
    """Phase 10's toy CTC task (tests/test_learning.py's transduction; bidi,
    nhidden 16, 4 classes, B=8, T=24, 120 steps) at the precision
    ``xz_bf16`` from ``seed``'s init and the same batches -> (losses, lines
    decoded correctly of 64 fresh ones)."""
    lspec, lnet = make_net_init(
        "bidi", {"ninput": 4, "nhidden": 16, "noutput": 4, "initial": 0.1},
        torch.Generator().manual_seed(seed), dev)
    lstate = TrainState.create(lnet)
    lstep = make_train_step(lspec, lr=0.1, momentum=0.9, loss_kind="ctc",
                            normalization="batch", xz_bf16=xz_bf16)
    lrng = np.random.RandomState(1)
    losses = []
    for _ in range(120):
        lstate, m = lstep(lstate, toy_ctc_batch(lrng, dev)[0])
        losses.append(float(m["loss"]))
    predict = make_predict_step(lspec, xz_bf16=xz_bf16)
    correct = 0
    for _ in range(8):
        tb, syms = toy_ctc_batch(lrng, dev)
        ids, vals = predict(lnet, tb["x"], tb["lengths"])
        ids, vals = ids.cpu().numpy(), vals.cpu().numpy()
        correct += sum(decode_frames(ids[r], vals[r]) == list(syms[r])
                       for r in range(len(syms)))
    return losses, correct


# The learning check's OCR corpus, made in code (no fonts needed): LEARN_C
# classes (the blank and LEARN_C - 1 glyphs), each glyph a fixed random
# bitmap 48 rows high and 6-12 columns wide from the seed; a line is a
# random text of 5-15 glyphs with gaps of 1-3 columns and pixel noise. bidi
# at full width (48 inputs, nhidden 100) trains at B=32 with the CLI's
# defaults (lr 1e-4, momentum 0.9, loss summed over lines); the CER is
# taken on LEARN_TEST held-out lines every LEARN_EVERY steps.
LEARN_C, LEARN_B, LEARN_TEST, LEARN_EVERY = 40, 32, 128, 25
# The rule, from each of the inits LEARN_SEEDS, both modes on the same
# batches: f32 trains until its CER is below half its start (N steps; the
# check is void if that takes more than LEARN_MAX_S seconds), then to 2N;
# bf16 trains 2N steps. bf16 passes at an init if its own halving step is
# at most N + LEARN_STEP_SLACK and its CER at 2N at most f32's there plus
# LEARN_SLACK; the mode passes if it passes at every init. The earlier
# single point (bf16's CER at N against f32's + LEARN_SLACK, the steepest
# part of both curves) is logged beside it.
LEARN_SEEDS, LEARN_STEP_SLACK = (0, 1, 2), 50
LEARN_MAX_S, LEARN_SLACK = 120.0, 0.02


def glyph_lines(rng, glyphs, n):
    """``n`` lines of random texts over ``glyphs`` -> (x [n, T, 48] f32,
    lengths, texts as class-id lists): the time axis is the image width,
    ink 1 on 0, as the line prepare gives."""
    texts, cols = [], []
    for _ in range(n):
        ids = rng.randint(1, len(glyphs) + 1, rng.randint(5, 16))
        parts = [np.zeros((48, 4), np.float32)]
        for c in ids:
            parts += [glyphs[c - 1], np.zeros((48, rng.randint(1, 4)),
                                              np.float32)]
        parts.append(np.zeros((48, 4), np.float32))
        img = np.concatenate(parts, 1)
        img = np.clip(img + rng.normal(0, 0.1, img.shape), 0, 1)
        texts.append(list(ids))
        cols.append(img.T.astype(np.float32))
    T_ = max(c.shape[0] for c in cols)
    x = np.zeros((n, T_, 48), np.float32)
    for i, c in enumerate(cols):
        x[i, :c.shape[0]] = c
    return x, np.array([c.shape[0] for c in cols], np.int32), texts


def glyph_batch(step: int, glyphs, dev) -> dict:
    """Training batch ``step`` (the same in both runs): LEARN_B lines from a
    RandomState seeded by the step."""
    x, lengths, texts = glyph_lines(np.random.RandomState(1000 + step),
                                    glyphs, LEARN_B)
    S_ = 2 * max(len(t) for t in texts) + 1
    tids = np.stack([mktargets_ids(t, S_) for t in texts]).astype(np.int32)
    tlens = np.array([2 * len(t) + 1 for t in texts], np.int32)
    b = {"x": x, "lengths": lengths, "targets": tids, "target_lengths": tlens}
    return {k: to_device(v, dev) for k, v in b.items()}


def ocr_learning(dev) -> dict:
    """The learning check on the glyph corpus (phase 20): at each init of
    LEARN_SEEDS, f32 then bf16 (the rule above). Returns {"seeds": {seed:
    {"f32", "bf16": curves, "steps": N, "halved": {mode: halving step},
    "cer_at_n", "cer_at_2n", "verdict"}}, "verdict"}: "pass", "fail" or
    "void"."""
    grng = np.random.RandomState(20)
    glyphs = []
    for _ in range(LEARN_C - 1):
        w = grng.randint(6, 13)
        g = (grng.rand(48, w) < 0.35).astype(np.float32)
        g[:8], g[40:] = 0.0, 0.0
        glyphs.append(g)
    tx, tl, ttexts = glyph_lines(np.random.RandomState(21), glyphs,
                                 LEARN_TEST)
    tx, tl = to_device(tx, dev), to_device(tl, dev)
    args = {"ninput": 48, "nhidden": H, "noutput": LEARN_C}

    def test_cer(net, predict):
        ids, vals = predict(net, tx, tl)
        ids, vals = ids.cpu().numpy(), vals.cpu().numpy()
        errs = sum(levenshtein(t, decode_frames(ids[i, :tl_[i]],
                                                vals[i, :tl_[i]]))
                   for i, t in enumerate(ttexts))
        return errs / sum(len(t) for t in ttexts)
    tl_ = tl.cpu().numpy()

    def run(xz_bf16, seed, steps=None):
        """Train at ``xz_bf16`` from ``seed``'s init: ``steps`` steps, or
        (None) to the first evaluation whose CER is below half the start
        and then as far again. -> (curve, the first evaluation below half
        the start or None, the steps run, seconds)."""
        spec, net = make_net_init("bidi", args,
                                  torch.Generator().manual_seed(seed), dev)
        state = TrainState.create(net)
        step = make_train_step(spec, 1e-4, 0.9, loss_kind="ctc",
                               normalization="none", xz_bf16=xz_bf16)
        predict = make_predict_step(spec, xz_bf16=xz_bf16)
        curve = [(0, test_cer(net, predict))]
        t0 = time.perf_counter()
        i, halved, n = 0, None, steps
        while n is None or i < n:
            state, _ = step(state, glyph_batch(i, glyphs, dev))
            i += 1
            if i % LEARN_EVERY == 0:
                curve.append((i, test_cer(net, predict)))
                if halved is None and curve[-1][1] < 0.5 * curve[0][1]:
                    halved = i
                    if n is None:
                        n = 2 * i
                if n is None and time.perf_counter() - t0 > LEARN_MAX_S:
                    break
        return curve, halved, i, time.perf_counter() - t0

    out = {"seeds": {}}
    for seed in LEARN_SEEDS:
        f32_curve, n, _, f32_s = run(False, seed)
        r = out["seeds"][seed] = {"f32": f32_curve, "f32_s": f32_s,
                                  "steps": n}
        if n is None:
            r["verdict"] = "void"
            continue
        r["bf16"], nb, _, r["bf16_s"] = run(True, seed, 2 * n)
        r["halved"] = {"f32": n, "bf16": nb}
        r["cer_at_n"] = {m: dict(r[m])[n] for m in ("f32", "bf16")}
        r["cer_at_2n"] = {m: dict(r[m])[2 * n] for m in ("f32", "bf16")}
        r["single_point"] = ("pass" if r["cer_at_n"]["bf16"]
                             <= r["cer_at_n"]["f32"] + LEARN_SLACK
                             else "fail")
        r["verdict"] = ("pass" if nb is not None
                        and nb <= n + LEARN_STEP_SLACK
                        and r["cer_at_2n"]["bf16"]
                        <= r["cer_at_2n"]["f32"] + LEARN_SLACK else "fail")
    verdicts = [r["verdict"] for r in out["seeds"].values()]
    out["verdict"] = ("void" if "void" in verdicts else
                      "pass" if all(v == "pass" for v in verdicts)
                      else "fail")
    return out


def mode_turns(tocr, batch, reps: int, label: str, card: str) -> dict:
    """train_batch in strict f32 and in the bf16 mode, timed in turns (f32,
    bf16, bf16, f32) on the host clock (each call ends synchronised); the
    model's precision is restored. Logs and returns {"f32": [..],
    "bf16": [..]} ms per step."""
    saved = tocr.xz_bf16

    def at(mode):
        def run():
            tocr.xz_bf16 = mode
            tocr.train_batch(batch)
        return run
    try:
        a1, b1, b2, a2 = (host_ms(f, reps) for f in (at(False), at(True),
                                                     at(True), at(False)))
    finally:
        tocr.xz_bf16 = saved
    log(f"[timing] {card} | {label} train_batch in turns (f32, bf16, bf16, "
        f"f32): {a1:.3f}, {b1:.3f}, {b2:.3f}, {a2:.3f} ms/step")
    return {"f32": [a1, a2], "bf16": [b1, b2]}


# Phase 21, the filter path (BASELINE config 5's string-transduction half):
# clstmfiltertrain and clstmfilter at full width on the run-cmu g2p task of
# bench.py:269-345, built in code: FILTER_PAIRS distinct words of 3-9
# letters over G2P_LETTERS, mapped by G2P_RULES (digraphs to one symbol,
# other letters upper-cased), and FILTER_TEST more held out; bidi, nhidden
# 100 (the CLI's default), input_repeat 3, B=256, automatic K (64 at these
# cadences). Inputs run 9-27 frames (T buckets 16 and 32), outputs S
# buckets 16 and 32; the input alphabet is 19 wide with the blank.
G2P_RULES = {"th": "T", "ch": "C", "sh": "S", "ee": "i", "oo": "u",
             "ng": "N"}
G2P_LETTERS = "abcdefghilmnoprstu"
FILTER_PAIRS, FILTER_TEST, FILTER_B, FILTER_REPEAT = 4096, 512, 256, 3
# The CLI's settings for the run that must learn: its TESTERR must fall
# below half its first value (ntrain and lrate picked from a first run of
# scripts/torch_filter_learning_probe.py, PERF.md §4).
FILTER_ENV = {"batch_size": str(FILTER_B),
              "input_repeat": str(FILTER_REPEAT), "nhidden": str(H),
              "net": "bidi", "steps_per_dispatch": "0", "ntrain": "131072",
              "lrate": "1e-4", "test_every": "16384", "save_every": "16384",
              "report_every": "16384", "randseed": "0", "mesh": "1"}
# Warm passes of the CLI's train_blocks loop for pairs/s, each
# FILTER_PASS_BLOCKS full blocks; the first is traced for the idle share.
FILTER_PASSES, FILTER_PASS_BLOCKS = 5, 4
# clstmfilter's batched runs a turn of fwd16_prefers_old's window kept or
# shut (filter_serve; the median of their seconds).
FILTER_WINDOW_RUNS = 5
# The large-alphabet shape: an input alphabet of BIG_ALPHABET symbols makes
# D + 1 > 128 at H=100, so the layer hoists its projection and runs K4.
BIG_ALPHABET = 160


def g2p(word: str) -> str:
    out, i = [], 0
    while i < len(word):
        if word[i:i + 2] in G2P_RULES:
            out.append(G2P_RULES[word[i:i + 2]])
            i += 2
        else:
            out.append(word[i].upper())
            i += 1
    return "".join(out)


def g2p_corpus(n_train: int = FILTER_PAIRS, n_test: int = FILTER_TEST,
               seed: int = 0):
    """bench.py's g2p corpus: distinct words from RandomState(seed) ->
    (n_train training pairs, the next n_test words' pairs)."""
    rng = np.random.RandomState(seed)
    seen, pairs = set(), []
    while len(pairs) < n_train + n_test:
        w = "".join(G2P_LETTERS[rng.randint(len(G2P_LETTERS))]
                    for _ in range(rng.randint(3, 10)))
        if w not in seen:
            seen.add(w)
            pairs.append((w, g2p(w)))
    return pairs[:n_train], pairs[n_train:]


def write_tsv(path: str, pairs) -> str:
    with open(path, "w", encoding="utf-8") as f:
        f.writelines(f"{a}\t{b}\n" for a, b in pairs)
    return path


def filter_blocks(dcache, k: int) -> dict:
    """{T bucket: block}: the first full k-batch block (FILTER_B rows a
    batch) of a group at each T bucket the corpus fills."""
    out = {}
    for blk in dcache.epoch_blocks(FILTER_B, k, rng=np.random.RandomState(5),
                                   epochs=k):
        if blk["k"] == k and blk["group"]["tb"] not in out:
            out[blk["group"]["tb"]] = blk
    return out


def block_batch(blk, s: int) -> dict:
    """Batch ``s`` of a text block, gathered and expanded to one-hot frames
    as the step does."""
    g = blk["group"]
    return gather_batch(g, blk["idx_all"][blk["j"] + s], g["onehot"])


def path_lattice(rng, batch, ncls: int):
    """lmatch [B, T, S] of a batch's own targets under random posteriors
    over ``ncls`` classes, NEG past each row's target length."""
    tg, tl = batch["targets"].long(), batch["target_lengths"]
    B_, T_ = batch["x"].shape[:2]
    S_ = tg.shape[1]
    logits = torch.from_numpy(
        rng.randn(B_, T_, ncls).astype(np.float32)).to(tg.device)
    lm = F.log_softmax(logits, -1).gather(
        2, tg[:, None, :].expand(B_, T_, S_))
    valid = torch.arange(S_, device=tg.device)[None, None, :] < tl[:, None,
                                                                   None]
    return torch.where(valid, lm, torch.full_like(lm, ctc_ops.NEG)
                       ).contiguous()


def filter_kernels(dev, card: str, dcache, ncls: int) -> dict:
    """K3, K1, K2, K5 and K6 at the filter path's shapes, against their
    plain versions with the limits of phases 3-8: one gathered batch of
    each T bucket (one-hot x [256, T, 19], the path's lengths, targets and
    target lengths), weights ±0.3 from a seed. Timed at the T=32 batch:
    kernel, plain and library call, bound from the batch's valid frames.
    Then the large-alphabet shape (BIG_ALPHABET, B=256, T=32): K3 with the
    projection inside and K4 on the hoisted product, each against plain
    and against each other, and through apply_net the layer takes K4.
    Returns {"err": {kernel: max|Δ|}, "rel": .., "timing": {kernel: (ms,
    plain_ms, (bound_ms, bound_by), library_ms)}, "shapes"}."""
    rng = np.random.RandomState(9)
    D_ = dcache.groups[0]["onehot"]
    pf, pr = lstm_params(rng, D_, H, dev), lstm_params(rng, D_, H, dev)
    blocks = filter_blocks(dcache, 5)
    if sorted(blocks) != [16, 32]:
        raise AssertionError(f"the g2p corpus filled T buckets "
                             f"{sorted(blocks)}, not 16 and 32")
    err = dict.fromkeys(("K3", "K1", "K2 chain", "K2 reduction", "K5", "K6",
                         "K4"), 0.0)
    rel = dict.fromkeys(("K2 chain", "K2 reduction", "K5", "K6"), 0.0)
    timing, shapes, bf16 = {}, {}, {}
    for tb, blk in sorted(blocks.items()):
        b = block_batch(blk, 0)
        x, L = b["x"], b["lengths"]
        S_ = b["targets"].shape[1]
        err["K3"] = max(err["K3"], compare(pf, pr, x, L))
        e1, st = compare_k1(pf, pr, x, L)
        err["K1"] = max(err["K1"], e1)
        gy = uniform(rng, (FILTER_B, tb, 2 * H), -1.0, 1.0, dev)
        c_rel, c_abs, red, r_abs, f64 = compare_k2(pf, pr, x, L, st, gy)
        err["K2 chain"] = max(err["K2 chain"], c_abs)
        err["K2 reduction"] = max(err["K2 reduction"], r_abs)
        rel["K2 chain"] = max(rel["K2 chain"], c_rel)
        rel["K2 reduction"] = max(rel["K2 reduction"], *red.values())
        lm = path_lattice(rng, b, ncls)
        r5, a5, r6, a6, _, _ = compare_ctc(lm, L, b["target_lengths"])
        err["K5"], err["K6"] = max(err["K5"], a5), max(err["K6"], a6)
        rel["K5"], rel["K6"] = max(rel["K5"], r5), max(rel["K6"], r6)
        V_ = int(L.sum())
        shapes[tb] = {"B": FILTER_B, "T": tb, "D": D_, "H": H, "S": S_,
                      "valid_frames": V_}
        log(f"[filter kernels] B={FILTER_B} T={tb} D={D_} H={H} S={S_} "
            f"({V_} valid frames): K3 max|dy| {err['K3']:.3e}, K1 {e1:.3e} "
            f"(tol {TOL:.0e}); K2 chain rel {c_rel:.3e}, reduction rel "
            f"{max(red.values()):.3e} (tol {K2_RTOL:.0e}){f64_note(f64)}; "
            f"K5 rel {r5:.3e}, K6 {r6:.3e} (tol {DP_RTOL:.0e}); padded "
            "frames as contracted, two calls bitwise equal")
        if tb != 32:
            continue
        # Timing at the T=32 batch, the path's longer bucket.
        y, gates, cell = st
        Wh2, Wx2 = stack2(pf, pr, "Wh"), stack2(pf, pr, "Wx")
        with torch.no_grad():
            dz = bidi_lstm_bwd_chain(gates, cell, gy, Wh2, L)
            lr_ = ctc_forward(lm, L)
            lstm = cudnn_lstm(pf, pr, dev)
            px = packed(x, L)
            check_cudnn(lstm, px, bidi_lstm_infer(pf, pr, x, L), "K3")
            k3, lib3 = in_turns(lambda: bidi_lstm_infer(pf, pr, x, L),
                                lambda: lstm(px), 20)
            timing["K3"] = (mean(k3), time_ms(
                lambda: bidi_lstm_apply(pf, pr, x, L), 3),
                lstm_bound("fwd", FILTER_B, tb, D_, H, V_), mean(lib3))
            k1, lib1 = in_turns(lambda: bidi_lstm_fwd_state(pf, pr, x, L),
                                cudnn_step(lstm, px, False)[0], 20)
            timing["K1"] = (mean(k1), time_ms(
                lambda: lstm_ops.bidi_lstm_fwd_state_plain(pf, pr, x, L), 3),
                lstm_bound("fwd_state", FILTER_B, tb, D_, H, V_), mean(lib1))
            timing["K2 chain"] = (
                time_ms(lambda: bidi_lstm_bwd_chain(gates, cell, gy, Wh2, L),
                        20),
                time_ms(lambda: lstm_ops.bidi_lstm_bwd_chain_plain(
                    gates, cell, gy, Wh2, L), 3),
                lstm_bound("chain", FILTER_B, tb, D_, H, V_), None)
            kr, libr = in_turns(
                lambda: bidi_lstm_bwd_reduce(x, y, dz, Wx2, False),
                einsum_reduce(x, y, dz, Wx2, False), 20)
            timing["K2 reduction"] = (mean(kr), time_ms(
                lambda: lstm_ops.bidi_lstm_bwd_reduce_plain(x, y, dz, Wx2,
                                                            False), 3),
                lstm_bound("reduce", FILTER_B, tb, D_, H, V_), mean(libr))
            tl_ = b["target_lengths"]
            lat = 4 * FILTER_B * tb * S_
            timing["K5"] = (time_ms(lambda: ctc_forward(lm, L), 20),
                            time_ms(lambda: ctc_ops.ctc_forward_plain(lm, L),
                                    3),
                            bound(0, 2 * lat + 4 * FILTER_B), None)
            timing["K6"] = (time_ms(lambda: ctc_both(lm, lr_, L, tl_), 20),
                            time_ms(lambda: ctc_ops.ctc_both_plain(
                                lm, lr_, L, tl_), 3),
                            bound(0, 3 * lat + 4 * FILTER_B * S_
                                  + 8 * FILTER_B), None)
            # The bf16 mode (the card's default) of K3, K1 and K2 at the
            # same shape, in turns with f32.
            y16, g16, c16 = bidi_lstm_fwd_state(pf, pr, x, L, xz_bf16=True)
            gy16 = gy.bfloat16()
            dz16 = bidi_lstm_bwd_chain(g16, c16, gy16, Wh2, L, xz_bf16=True)
            for name, kind, fa, fb in (
                    ("K3", "fwd", lambda: bidi_lstm_infer(pf, pr, x, L),
                     lambda: bidi_lstm_infer(pf, pr, x, L, xz_bf16=True)),
                    ("K1", "fwd_state",
                     lambda: bidi_lstm_fwd_state(pf, pr, x, L),
                     lambda: bidi_lstm_fwd_state(pf, pr, x, L,
                                                 xz_bf16=True)),
                    ("K2 chain", "chain",
                     lambda: bidi_lstm_bwd_chain(gates, cell, gy, Wh2, L),
                     lambda: bidi_lstm_bwd_chain(g16, c16, gy16, Wh2, L,
                                                 xz_bf16=True)),
                    ("K2 reduction", "reduce",
                     lambda: bidi_lstm_bwd_reduce(x, y, dz, Wx2, False),
                     lambda: bidi_lstm_bwd_reduce(x, y16, dz16, Wx2, False,
                                                  xz_bf16=True))):
                f32_t, bf_t = in_turns(fa, fb, 20)
                bf16[name] = {"ms": mean(bf_t), "f32_ms": mean(f32_t),
                              "in_turns_f32_bf16": [f32_t, bf_t],
                              "bound": lstm_bound(kind, FILTER_B, tb, D_, H,
                                                  V_, esize=2)}
            # The bf16 reduction's library call: the plain version's
            # einsums on bf16 operands, in turns.
            kr16, lib16 = in_turns(
                lambda: bidi_lstm_bwd_reduce(x, y16, dz16, Wx2, False,
                                             xz_bf16=True),
                einsum_reduce(x.bfloat16(), y16, dz16, Wx2.bfloat16(),
                              False), 20)
            bf16["K2 reduction"].update(
                library_ms=mean(lib16), in_turns_kernel_library=[kr16,
                                                                 lib16])
            del y16, g16, c16, gy16, dz16
        del lstm, px, dz, st
    # The large-alphabet shape: K3 (projection inside) against K4's route.
    if not bk.hoists_projection(BIG_ALPHABET, H):
        raise AssertionError(f"D={BIG_ALPHABET} at H={H} does not hoist")
    words = [rng.randint(1, BIG_ALPHABET, rng.randint(3, 10))
             for _ in range(FILTER_B)]
    xb = np.zeros((FILTER_B, 32, BIG_ALPHABET), np.float32)
    for r, w in enumerate(words):
        for t, c in enumerate(w):
            xb[r, FILTER_REPEAT * t:FILTER_REPEAT * (t + 1), c] = 1.0
    xg = to_device(xb, dev)
    Lg = to_device(np.array([FILTER_REPEAT * len(w) for w in words],
                            np.int32), dev)
    gf, gr = (lstm_params(rng, BIG_ALPHABET, H, dev) for _ in range(2))
    e3 = compare(gf, gr, xg, Lg)
    e4, xz_rel, _ = compare_k4(gf, gr, xg, Lg)
    with torch.no_grad():
        xz = lstm_ops.hoisted_projection(gf, gr, xg)
        y3 = bidi_lstm_infer(gf, gr, xg, Lg)
        y4 = bidi_lstm_infer_xz(gf, gr, xz, Lg)
    e34 = float((y3 - y4).abs().max())
    if not e34 <= TOL:
        raise AssertionError(f"K3 against K4's route at D={BIG_ALPHABET}: "
                             f"max|dy| {e34:.3e} > {TOL:.0e}")
    err["K4"] = e4
    Vg = int(Lg.sum())
    with torch.no_grad():
        k4, k3b = in_turns(
            lambda: bidi_lstm_infer_xz(gf, gr, lstm_ops.hoisted_projection(
                gf, gr, xg), Lg),
            lambda: bidi_lstm_infer(gf, gr, xg, Lg), 20)
        # K4 in both modes in turns, and the whole layer (product + K4)
        # in turns with cuDNN's nn.LSTM, which computes the projection
        # inside, in each mode.
        xz16 = lstm_ops.hoisted_projection(gf, gr, xg, xz_bf16=True)
        k4_32, k4_16 = in_turns(
            lambda: bidi_lstm_infer_xz(gf, gr, xz, Lg),
            lambda: bidi_lstm_infer_xz(gf, gr, xz16, Lg, xz_bf16=True), 20)
        lstm = cudnn_lstm(gf, gr, dev)
        pxg = packed(xg, Lg)
        check_cudnn(lstm, pxg, y3, "K4's route")
        tot4, lib4 = in_turns(
            lambda: bidi_lstm_infer_xz(gf, gr, lstm_ops.hoisted_projection(
                gf, gr, xg), Lg), lambda: lstm(pxg), 20)
        lstm16 = copy.deepcopy(lstm).to(torch.bfloat16)
        px16 = packed(xg.bfloat16(), Lg)
        tot16, lib16 = in_turns(
            lambda: bidi_lstm_infer_xz(gf, gr, lstm_ops.hoisted_projection(
                gf, gr, xg, xz_bf16=True), Lg, xz_bf16=True),
            lambda: lstm16(px16), 20)
        timing["K4"] = (mean(k4_32),
                        time_ms(lambda: bidi_lstm_apply(gf, gr, xg, Lg), 3),
                        lstm_bound("xz", FILTER_B, 32, BIG_ALPHABET, H, Vg),
                        mean(lib4))
        bf16["K4"] = {"ms": mean(k4_16), "f32_ms": mean(k4_32),
                      "in_turns_f32_bf16": [k4_32, k4_16],
                      "bound": lstm_bound("xz", FILTER_B, 32, BIG_ALPHABET,
                                          H, Vg, esize=2),
                      "library_ms": mean(lib16),
                      "hoisted_total_ms": mean(tot16),
                      "in_turns_total_library": [tot16, lib16]}
        del lstm, lstm16, pxg, px16, xz16
    # Through the layer tree: a net on BIG_ALPHABET inputs takes K4.
    spec_g, net_g = make_net_init("bidi", {"ninput": BIG_ALPHABET,
                                           "nhidden": H, "noutput": ncls},
                                  torch.Generator().manual_seed(3), dev)
    reset_counts()
    with torch.no_grad():
        apply_net(net_g, xg, Lg, inference=True)
    routed = {k: v for k, v in counts().items() if v}
    if routed != {"bidi_lstm_infer_xz": 1}:
        raise AssertionError(f"a net on {BIG_ALPHABET} inputs launched "
                             f"{routed}, not K4 alone")
    shapes["large alphabet"] = {"B": FILTER_B, "T": 32, "D": BIG_ALPHABET,
                                "H": H, "valid_frames": Vg}
    log(f"[filter kernels] large alphabet B={FILTER_B} T=32 D={BIG_ALPHABET}"
        f" H={H} ({Vg} valid frames): K3 with the projection inside "
        f"max|dy| {e3:.3e}, K4 both modes {e4:.3e}, K3 against K4's route "
        f"{e34:.3e} (tol {TOL:.0e}), hoisted product {xz_rel:.3e} from "
        f"float64; apply_net took K4 ({routed}); in turns: product + K4 "
        f"{k4[0]:.4f}, {k4[1]:.4f}, K3 {k3b[0]:.4f}, {k3b[1]:.4f} ms")
    for name, (km, pm, (bms, bby), lms) in timing.items():
        log(f"[filter timing] {card} | {name}: {km:.4f} ms, plain "
            f"{pm:.3f} ms, bound {bms:.4f} ms ({bby})"
            + (f", library {lms:.4f} ms" if lms is not None else "")
            + (f"; bf16 in turns (f32, bf16, bf16, f32) "
               f"{bf16[name]['in_turns_f32_bf16'][0][0]:.4f}, "
               f"{bf16[name]['in_turns_f32_bf16'][1][0]:.4f}, "
               f"{bf16[name]['in_turns_f32_bf16'][1][1]:.4f}, "
               f"{bf16[name]['in_turns_f32_bf16'][0][1]:.4f} ms, bf16 bound "
               f"{bf16[name]['bound'][0]:.4f} ms"
               if name in bf16 else ""))
    return {"err": err, "rel": rel, "timing": timing, "shapes": shapes,
            "bf16": bf16, "big_k3_k4_ms": {"K4 route": k4, "K3": k3b},
            "big_k4_total_ms": {"f32": [tot4, lib4], "bf16": [tot16, lib16]}}


def filter_steps(dev, dcache, start: str, lr: float,
                 default_bf16: bool) -> dict:
    """5 train_batch_block steps (k=1 blocks, the CLI's step over the
    resident corpus) of a model loaded from ``start`` against the same 5
    steps composed from the plain versions, on the 5 batches of a block at
    each T bucket, in the card's default precision and the other, within
    phase 9's limits (train_against_plain). -> {(T, bf16): launches}."""
    out = {}
    for tb, blk in sorted(filter_blocks(dcache, 5).items()):
        g = blk["group"]
        batches = [block_batch(blk, s) for s in range(5)]
        for mode in (None, not default_bf16):
            kocr = CLSTMText(device=dev)
            kocr.load(start)
            kocr.setLearningRate(lr, 0.9)
            kocr.xz_bf16 = mode
            plain = CLSTMText(device=dev)
            plain.load(start)

            def step(s, kocr=kocr):
                return kocr.train_batch_block({
                    "group": g, "idx_all": blk["idx_all"],
                    "j": blk["j"] + s, "set_j": lambda j: None, "k": 1})
            got = train_against_plain(
                kocr, plain.state, batches[0], lr, 0.9,
                f"filter steps B={FILTER_B} T={tb} S={g['sb']} "
                f"D={g['onehot']}", kernel_step=step, batches=batches)
            want = {"bidi_lstm_fwd_state": 5, "bidi_lstm_bwd_chain": 5,
                    "bidi_lstm_bwd_reduce": 5, "ctc_forward": 5,
                    "ctc_both": 5}
            if {k: v for k, v in got.items() if v} != want:
                raise AssertionError(f"filter steps launched {got}, want "
                                     f"{want}")
            if set(kocr._multi_steps) != {(1, g["onehot"])}:
                raise AssertionError(f"filter steps built "
                                     f"{set(kocr._multi_steps)}")
            out[(tb, default_bf16 if mode is None else mode)] = got
            del kocr, plain
    return out


def filtertrain(dev, card: str, tmp: str, train_pairs, test_pairs,
                k2_against=None) -> dict:
    """clstmfiltertrain through its main on the g2p corpus (FILTER_ENV),
    launch counts reset just before and read just after; its TESTERR must
    fall below half its first value. Then FILTER_PASSES warm passes of its
    train_blocks loop on the trained model (FILTER_PASS_BLOCKS full blocks
    each; the first traced, kernel activity, for the card's idle share) for
    pairs/s, and the host's enqueue ms of one block on an idle card.
    Then a pass and a block's enqueue in each precision, in turns (f32,
    bf16, bf16, f32), and with --k2-against a bf16 pass with that build's
    K2 reduction and with the current one, in turns (against, current,
    current, against), and a bf16 pass each with fwd16_prefers_old's window
    kept and shut, in turns (kept, shut, shut, kept; the shut passes must
    launch K1 on the fwd16 kernel only). Returns {launches,
    window_pairs_per_s, testerr, pairs_per_s (median),
    pairs_per_s_range, busy_share, block_enqueue_ms, block_k, model (the
    saved best .clstm), run_s, cache_mb, groups, in_turns, and
    k2_against_pairs_per_s with --k2-against}."""
    save_name = os.path.join(tmp, "filter")
    env = dict(FILTER_ENV, device=dev.type, save_name=save_name,
               log_jsonl=save_name + ".jsonl")
    args = [write_tsv(os.path.join(tmp, "train.tsv"), train_pairs),
            write_tsv(os.path.join(tmp, "test.tsv"), test_pairs)]
    seen = {}
    loop = clstmfiltertrain.train_blocks

    def spy(model, dcache, test_pairs, **kw):
        seen.update(kw, model=model, dcache=dcache)
        return loop(model, dcache, test_pairs, **kw)

    printed = io.StringIO()
    saved_env = {k: os.environ.get(k) for k in env}
    clstmfiltertrain.train_blocks = spy
    os.environ.update(env)
    try:
        reset_counts()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            clstmfiltertrain.main(args)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = counts()
    finally:
        clstmfiltertrain.train_blocks = loop
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    text = printed.getvalue()
    for ln in text.splitlines():
        log(f"[filtertrain] | {ln}")
    testerr = [float(ln.split()[2]) for ln in text.splitlines()
               if ln.startswith("TESTERR ")]
    if len(testerr) < 2 or not all(np.isfinite(testerr)):
        raise AssertionError(f"clstmfiltertrain printed {testerr}")
    if not testerr[-1] < 0.5 * testerr[0]:
        raise AssertionError(f"clstmfiltertrain's TESTERR {testerr} did not "
                             "fall below half its first value")
    want = ("bidi_lstm_infer", "bidi_lstm_fwd_state", "bidi_lstm_bwd_chain",
            "bidi_lstm_bwd_reduce", "ctc_forward", "ctc_both")
    if min(launches[k] for k in want) < 1:
        raise AssertionError(f"clstmfiltertrain skipped a kernel: {launches}")
    mb = [float(ln.split()[3]) for ln in text.splitlines()
          if ln.startswith("# device cache:")]
    if not mb:
        raise AssertionError("clstmfiltertrain did not build the device "
                             "cache")
    model, dcache, block_k = seen["model"], seen["dcache"], seen["block_k"]

    def one_pass(seed: int, profile: bool = False):
        """One warm pass of the CLI's loop, FILTER_PASS_BLOCKS full blocks,
        no reports, tests or saves due -> (pairs/s, the card's busy share
        or None)."""
        kw = dict(seen, ntrain=FILTER_PASS_BLOCKS * block_k * FILTER_B,
                  report_every=1 << 30, save_every=1 << 30,
                  test_every=1 << 30, rng=np.random.RandomState(seed),
                  save_name=os.path.join(tmp, "pass"),
                  log=clstmfiltertrain._Log(""))
        kw.pop("model"), kw.pop("dcache")
        ctx = (torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) if profile
            else contextlib.nullcontext())
        with ctx as prof, contextlib.redirect_stdout(io.StringIO()):
            t0 = time.perf_counter()
            n = loop(model, dcache, None, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        if not profile:
            return n / dt, None
        dev_s = sum(device_us(e)
                    for e in kernel_rows(prof.key_averages())) / 1e6
        return n / dt, (dev_s / dt if dev_s else None)

    blocks = (b for b in dcache.epoch_blocks(
        FILTER_B, block_k, rng=np.random.RandomState(7), epochs=128)
        if b["k"] == block_k)

    def block_enqueue_ms() -> float:
        return enqueue_ms(lambda: model.train_batch_block(next(blocks),
                                                          k_max=block_k), 2)

    rate0, busy = one_pass(100, profile=True)
    rates = [rate0] + [one_pass(100 + p)[0] for p in range(1, FILTER_PASSES)]
    enq = block_enqueue_ms()
    # Both precisions in turns (f32, bf16, bf16, f32), a pass and a block's
    # enqueue each: the loop is the host's, and the modes launch different
    # work.
    turns = {False: [], True: []}
    for i, mode in enumerate((False, True, True, False)):
        model.xz_bf16 = mode
        turns[mode].append({"pairs_per_s": one_pass(200 + i)[0],
                            "block_enqueue_ms": block_enqueue_ms()})
    k2_vs = None
    if k2_against and k2_against[2]:
        model.xz_bf16 = True
        k2_vs = {"against": [], "current": []}
        for i, which in enumerate(("against", "current", "current",
                                   "against")):
            with (k2_against_reduce(k2_against) if which == "against"
                  else contextlib.nullcontext()):
                k2_vs[which].append(one_pass(300 + i)[0])
        log(f"[against] {card} | clstmfiltertrain bf16 pass in turns "
            f"(against's K2 bf16 reduction and chain, current, current, "
            f"against's): {k2_vs['against'][0]:.1f}, {k2_vs['current'][0]:.1f}, "
            f"{k2_vs['current'][1]:.1f}, {k2_vs['against'][1]:.1f} pairs/s")
    # fwd16_prefers_old's window kept and shut in turns (kept, shut, shut,
    # kept), a bf16 pass each: the filter's buckets (T=16, 32 at H=100)
    # take K1 on the FMA kernel or, shut, on the fwd16 kernel.
    model.xz_bf16 = True
    window = {"kept": [], "shut": []}
    for i, which in enumerate(("kept", "shut", "shut", "kept")):
        with (fwd16_window_off() if which == "shut"
              else contextlib.nullcontext()):
            reset_counts()
            window[which].append(one_pass(400 + i)[0])
            n, n16 = counts()["bidi_lstm_fwd_state"], counts16()[
                "bidi_lstm_fwd_state"]
        if which == "shut" and not n16 == n > 0:
            raise AssertionError(f"clstmfiltertrain with the window shut: "
                                 f"K1 on the fwd16 kernel {n16} of {n} times")
    model.xz_bf16 = None
    rates.sort()
    out = {"launches": {k: v for k, v in launches.items() if v},
           "window_pairs_per_s": window,
           "testerr": testerr, "pairs_per_s": float(np.median(rates)),
           "pairs_per_s_range": [rates[0], rates[-1]], "busy_share": busy,
           "block_enqueue_ms": enq, "block_k": block_k, "run_s": run_s,
           "model": save_name + ".clstm", "cache_mb": mb[0],
           "groups": [(g["tb"], g["sb"], g["n"]) for g in dcache.groups],
           "in_turns": {("bf16" if m else "f32"): v
                        for m, v in turns.items()}}
    if k2_vs:
        out["k2_against_pairs_per_s"] = k2_vs
    log(f"[filtertrain] {len(train_pairs)} training and {len(test_pairs)} "
        f"test pairs, bidi {dcache.groups[0]['onehot']}/{H}/"
        f"{model.codec.size()}, input_repeat {FILTER_REPEAT}, B={FILTER_B}, "
        f"K={block_k}, groups (T, S, n) {out['groups']}: the CLI ran in "
        f"{run_s:.3f} s; TESTERR {testerr}; launches {out['launches']}; "
        f"{FILTER_PASSES} warm passes of {FILTER_PASS_BLOCKS} blocks: "
        f"{out['pairs_per_s']:.1f} pairs/s (median; range "
        f"{rates[0]:.1f}-{rates[-1]:.1f}), card "
        + (f"busy {100 * busy:.1f}%, idle {100 * (1 - busy):.1f}% of the "
           "first pass" if busy else "busy time not measured")
        + f"; the host enqueues a block of {block_k} steps in {enq:.3f} ms "
        f"({enq / block_k:.3f} ms a step); in turns (f32, bf16, bf16, f32) "
        "pairs/s " + ", ".join(
            f"{turns[m][i]['pairs_per_s']:.1f}"
            for m, i in ((False, 0), (True, 0), (True, 1), (False, 1)))
        + ", block enqueue ms " + ", ".join(
            f"{turns[m][i]['block_enqueue_ms']:.3f}"
            for m, i in ((False, 0), (True, 0), (True, 1), (False, 1)))
        + "; bf16 with fwd16_prefers_old's window kept, shut, shut, kept "
        f"(K1 on the FMA kernel, fwd16, fwd16, FMA): {window['kept'][0]:.1f}"
        f", {window['shut'][0]:.1f}, {window['shut'][1]:.1f}, "
        f"{window['kept'][1]:.1f} pairs/s")
    return out


def filter_serve(dev, model_path: str, words) -> dict:
    """clstmfilter through its main on ``words``, batched (FILTER_B a batch)
    with the launch counts reset just before and read just after, then one
    line at a time (batch_size=1): the outputs must be equal line for line;
    each batch launches K3 once, each single line once. The frame ids of
    the batched run are held against the plain path on the same batches
    (ids_against_plain), K3's padded frames there must be exactly 0 and,
    in f32, K3 is held against its plain version (compare). In the bf16
    mode each call past fwd16_prefers_old's window (batched and single)
    must launch K3 on the fwd16 kernel (fwd16_due), none other. Returns
    {launches, launches16, launches_single, launches16_single, batches (T
    per batch), ids (the comparison), s, s_single, lines_per_s,
    lines_per_s_single, window_lines_per_s: the batched run in turns with
    fwd16_prefers_old's window kept and shut (kept, shut, shut, kept;
    FILTER_WINDOW_RUNS runs a turn; shut, every K3 call on the fwd16
    kernel)}."""
    recorded = []
    predict_batch = CLSTMText.predict_batch

    def recording(self, xb, lb):
        ids, vals = predict_batch(self, xb, lb)
        recorded.append((self, xb, lb, ids))
        return ids, vals

    def run(batch_size: str):
        env = {"load": model_path, "batch_size": batch_size,
               "device": dev.type}
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        stdin, out = sys.stdin, io.StringIO()
        sys.stdin = io.StringIO("".join(w + "\n" for w in words))
        try:
            reset_counts()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                clstmfilter.main([])
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            return out.getvalue().splitlines(), counts(), counts16(), dt
        finally:
            sys.stdin = stdin
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v

    run(str(FILTER_B))                      # cold: loads, first launches
    CLSTMText.predict_batch = recording
    try:
        lines, launches, launches16, dt = run(str(FILTER_B))
        batched, recorded[:] = recorded[:], []
        single, launches1, launches16_1, dt1 = run("1")
    finally:
        del CLSTMText.predict_batch
    single_ts, recorded = [int(r[1].shape[1]) for r in recorded], batched
    if len(lines) != len(words) or lines != single:
        bad = sum(a != b for a, b in zip(lines, single))
        raise AssertionError(f"clstmfilter: batched and single outputs "
                             f"differ on {bad} of {len(words)} lines")
    if launches["bidi_lstm_infer"] != len(recorded):
        raise AssertionError(f"clstmfilter launched K3 "
                             f"{launches['bidi_lstm_infer']} times for "
                             f"{len(recorded)} batches")
    if launches1["bidi_lstm_infer"] != len(words):
        raise AssertionError(f"clstmfilter batch_size=1 launched K3 "
                             f"{launches1['bidi_lstm_infer']} times for "
                             f"{len(words)} lines")
    model = recorded[0][0]
    bf16 = ApplyCtx(xz_bf16=model.xz_bf16).bf16(torch.empty(0, device=dev))
    d_in = model.net.sub[0].sub[0].weights()["Wx"].shape[0]
    h_net = model.net.sub[0].sub[0].weights()["Wh"].shape[0]
    for tag, ts, got in (
            ("batched", [int(r[1].shape[1]) for r in recorded], launches16),
            ("batch_size=1", single_ts, launches16_1)):
        want = fwd16_due(ts, d_in, h_net) if bf16 else 0
        if got["bidi_lstm_infer"] != want or sum(got.values()) != want:
            raise AssertionError(f"clstmfilter {tag}: the fwd16 kernel ran "
                                 f"{got} for {want} calls past the window")
    ids = ids_against_plain(model.net, [r[1:] for r in recorded], bf16,
                            model.codec.size(), dev)
    par = model.net.sub[0]
    pf, pr = par.sub[0].weights(), par.sub[1].sub[0].weights()
    k3 = 0.0
    for _, xb, lb, _ in recorded:
        xt, lt = to_device(xb, dev), to_device(lb, dev)
        if not bf16:
            k3 = max(k3, compare(pf, pr, xt, lt))
            continue
        with torch.no_grad():
            y = bidi_lstm_infer(pf, pr, xt, lt, xz_bf16=True)
        if not bool((y[padded(lt, *xt.shape[:2], dev)] == 0).all()):
            raise AssertionError("K3 (bf16) output is not exactly 0 on "
                                 "padded frames")
    # Batched, fwd16_prefers_old's window kept and shut in turns (kept,
    # shut, shut, kept), FILTER_WINDOW_RUNS runs of main a turn.
    window = {"kept": [], "shut": []}
    for which in ("kept", "shut", "shut", "kept"):
        with (fwd16_window_off() if which == "shut"
              else contextlib.nullcontext()):
            runs = [run(str(FILTER_B)) for _ in range(FILTER_WINDOW_RUNS)]
        if bf16 and which == "shut" and any(
                r[2]["bidi_lstm_infer"] != r[1]["bidi_lstm_infer"]
                for r in runs):
            raise AssertionError("clstmfilter with the window shut: K3 off "
                                 "the fwd16 kernel")
        window[which].append(
            len(words) / float(np.median([r[3] for r in runs])))
    out = {"launches": {k: v for k, v in launches.items() if v},
           "launches16": {k: v for k, v in launches16.items() if v},
           "window_lines_per_s": window,
           "launches_single": {k: v for k, v in launches1.items() if v},
           "launches16_single": {k: v for k, v in launches16_1.items()
                                 if v},
           "batches": [int(r[1].shape[1]) for r in recorded], "ids": ids,
           "k3_err": k3, "s": dt, "s_single": dt1,
           "lines_per_s": len(words) / dt,
           "lines_per_s_single": len(words) / dt1}
    log(f"[clstmfilter] {len(words)} held-out words, the saved model "
        f"({'bf16' if bf16 else 'f32'}): batched ({FILTER_B} a batch, T "
        f"{out['batches']}) {dt:.3f} s ({out['lines_per_s']:.1f} lines/s), "
        f"K3 launched {launches['bidi_lstm_infer']} times "
        f"({launches16['bidi_lstm_infer']} on the fwd16 kernel); one line at "
        f"a time {dt1:.3f} s ({out['lines_per_s_single']:.1f} lines/s), "
        f"{launches1['bidi_lstm_infer']} launches "
        f"({launches16_1['bidi_lstm_infer']} fwd16); outputs equal line for "
        f"line; frame ids equal to the plain path on {ids['share']:.6f} of "
        f"{ids['frames']} valid frames"
        + (f", K3 max|dy| {k3:.3e} against plain" if not bf16 else "")
        + "; K3's padded frames exactly 0; batched with fwd16_prefers_old's "
        f"window kept, shut, shut, kept ({FILTER_WINDOW_RUNS} runs a turn, "
        f"median): {window['kept'][0]:.1f}, {window['shut'][0]:.1f}, "
        f"{window['shut'][1]:.1f}, {window['kept'][1]:.1f} lines/s")
    return out


def native_check(dev, tmp: str) -> dict:
    """Phase 22: whether the native host I/O library (io/native.py, g++
    with libpng) builds here, and so which PNG reader and line loader the
    OCR phases took (read_images: native or PIL; OcrDataset.load_all:
    PrefetchLoader or the Python prepare). Where it builds, read_png is
    held bit for bit against PIL on all 256 grey levels and prepare_line
    against the Python normalizer within tests/test_native.py's envelope
    (mean |Δ| < 1e-3, under 1% of values off by more than 5e-3)."""
    built = native.available()
    out = {"built": built, "reason": native.missing_reason(),
           "reader": "native" if built else "PIL",
           "loader": "PrefetchLoader" if built else "Python prepare_line"}
    if not built:
        log(f"[native] the native I/O library does not build here "
            f"({out['reason'].splitlines()[0]}): the OCR phases read PNGs "
            "with PIL and load_all prepares on the host in Python")
        return out
    from PIL import Image
    grey = np.arange(256, dtype=np.uint8).reshape(16, 16)
    f = os.path.join(tmp, "levels.png")
    Image.fromarray(grey, mode="L").save(f)
    got, want = native.read_png(f), read_png(f)
    if not np.array_equal(got.view(np.uint32), want.view(np.uint32)):
        raise AssertionError("native read_png differs from PIL's")
    worst = 0.0
    for dewarp in ("none", "mean", "center"):
        img = quantized(synth_line(np.random.RandomState(11)))
        py = prepare_line(img, make_normalizer(dewarp, D), 16)
        nat = native.prepare_line(img, D, pad=16, dewarp=dewarp)
        if nat.shape != py.shape:
            raise AssertionError(f"native prepare_line ({dewarp}) shape "
                                 f"{nat.shape}, Python {py.shape}")
        d = np.abs(nat - py)
        if not (d.mean() < 1e-3 and (d > 5e-3).mean() < 0.01):
            raise AssertionError(f"native prepare_line ({dewarp}) off the "
                                 f"Python one: mean {d.mean():.3e}")
        worst = max(worst, float(d.mean()))
    out["prepare_mean_diff"] = worst
    log(f"[native] the native I/O library built: the OCR phases read PNGs "
        f"natively and load_all takes the PrefetchLoader; read_png equals "
        f"PIL's on all 256 grey levels, prepare_line within the envelope "
        f"(worst mean |d| {worst:.3e})")
    return out


# Phase 23, data parallelism (clstm_tpu_torch/parallel/): one NCCL rank on
# the card, then two gloo ranks sharing it (NCCL refuses two ranks on one
# device; gloo stages CUDA tensors through the host), started with spawn as
# the CLIs start them. Two ranks sharing one card give a check of the
# semantics, not a scaling figure. Tolerances: the JAX package's own for DP
# (tests/test_parallel.py:75-79 losses, tests/test_cli.py:282 parameters).
DP_LOSS_RTOL = 2e-4
DP_PARAM_RTOL, DP_PARAM_ATOL = 3e-4, 2e-5
# (net, nhidden, classes, parallel steps) at the bench batch (B=256, T=1024,
# 900 frames, S=81): 128 rows a rank.
DP_NETS = (("bidi", H, C, 5), ("bidi2", H2, C2, 3))
# The learning rate of (b). At bench.py's 1e-4 the bench batch's loss
# climbs 1.05e6 -> 2.9e7 in 4 steps, and that divergence magnifies a
# difference in the last bits of a sum ~1e3x a step: phase 9's kernel and
# plain f32 steps, the same math, drift 3.3e-4 apart by step 5. The
# tolerances above are for sums in another order, so (b) takes a step that
# does not diverge; its weights still move ~1e4x the parameter tolerance
# (logged), which a mean in place of the sum would halve.
DP_LR = 1e-6
# In the bf16 mode the affine layers' weight gradient is rounded to bf16
# (models/spec.py::_AffineBF16, the JAX package's casts), on each rank
# before the sum, where one rank rounds the full sum once: the two differ by
# up to a bf16 ulp of the gradient, 2^-8 of it. So the bf16 runs hold the
# parameters within the tolerances above plus DP_BF16_SLACK of the largest
# move of a parameter from its start; f32 runs take the tolerances alone.
DP_BF16_SLACK = 2.0 ** -8
DP_COUNTED = ("bidi_lstm_fwd_state", "bidi_lstm_bwd_chain",
              "bidi_lstm_bwd_reduce", "ctc_forward", "ctc_both")
# The CLIs on two ranks sharing cuda:0 against mesh=1 from one .clstm:
# clstmocrtrain on phase 17's corpus (B=32, K=64, 512 trials) and
# clstmfiltertrain on phase 21's g2p corpus (B=256, K=64, 4 blocks).
DP_OCR_ENV = {"device": "cuda:0", "device_preprocess": "1",
              "batch_size": "32", "steps_per_dispatch": "64",
              "ntrain": "512", "test_every": "512", "save_every": "512",
              "report_every": "256", "target_height": str(D),
              "randseed": "0"}
DP_FILTER_ENV = dict(FILTER_ENV, device="cuda:0", steps_per_dispatch="64",
                     ntrain=str(4 * 64 * FILTER_B), test_every="65536",
                     save_every="65536", report_every="16384")
DP_LABEL = "two ranks sharing one card: a check, not a scaling figure"


def dp_net(kind: str, h: int, ncls: int, dev):
    """The seeded net of a phase 23 run (the same on every rank)."""
    return make_net_init(kind, {"ninput": D, "nhidden": h, "noutput": ncls},
                         torch.Generator().manual_seed(0), dev)


def dp_params(net) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1) for p in net.parameters()])


def dp_check(tag: str, got: torch.Tensor, ref: torch.Tensor,
             start: torch.Tensor, bf16: bool) -> dict:
    """Parameters ``got`` against ``ref`` (both moved from ``start``) within
    DP_PARAM_RTOL and DP_PARAM_ATOL, plus DP_BF16_SLACK of the largest move
    in the bf16 mode; raises otherwise. -> the distances."""
    diff = (got - ref).abs()
    move = float((ref - start).abs().max())
    lim = DP_PARAM_ATOL + DP_PARAM_RTOL * ref.abs()
    slack = DP_BF16_SLACK * move if bf16 else 0.0
    over = float((diff - lim).max())
    if not over <= slack:
        raise AssertionError(
            f"{tag}: params off by up to {float(diff.max()):.3e}, "
            f"{over:.3e} over rtol {DP_PARAM_RTOL:g} atol {DP_PARAM_ATOL:g}"
            + (f" (bf16 slack {slack:.3e})" if bf16 else ""))
    return {"max_param_diff": float(diff.max()), "max_param_move": move,
            "over_f32_limit": over, "bf16_slack": slack}


def dp_note(d: dict) -> str:
    return (f"params max|d| {d['max_param_diff']:.3e} (largest move "
            f"{d['max_param_move']:.3e}; {d['over_f32_limit']:.3e} over rtol "
            f"{DP_PARAM_RTOL:g} atol {DP_PARAM_ATOL:g}"
            + (f", within the bf16 slack {d['bf16_slack']:.3e}"
               if d["bf16_slack"] else "") + ")")


def dp_worker(out: str, default_bf16: bool, mesh=None) -> int:
    """Phase 23 (b) on one of two gloo ranks sharing cuda:0: for each net of
    DP_NETS in both precisions, make_parallel_train_step's steps on the
    bench batch from the seeded init, the launch counts reset just before
    and read just after; the host ms of a step (median after the first)
    and of one all_reduce of a buffer of the step's size alone (median of
    5). Each rank writes its results to ``out``.RANK."""
    dev = mesh.device
    res = {}
    for kind, h, ncls, nsteps in DP_NETS:
        batch = bench_batch(np.random.RandomState(0), dev, ncls)
        for bf16 in (default_bf16, not default_bf16):
            spec, net = dp_net(kind, h, ncls, dev)
            state = TrainState.create(net)
            step = make_parallel_train_step(spec, mesh, DP_LR, 0.9,
                                            xz_bf16=bf16)
            torch.cuda.synchronize()
            mesh.barrier()
            reset_counts()
            losses, step_ms = [], []
            for _ in range(nsteps):
                t0 = time.perf_counter()
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
                step_ms.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            launches = counts()
            n = 1 + sum(p.numel() for p in net.parameters()) + 2 * B * T
            buf = torch.zeros(n, device=dev)
            ar = []
            for _ in range(5):
                torch.cuda.synchronize()
                mesh.barrier()
                t0 = time.perf_counter()
                mesh.all_reduce(buf)
                torch.cuda.synchronize()
                ar.append((time.perf_counter() - t0) * 1e3)
            res[(kind, bf16)] = {
                "losses": losses, "params": dp_params(net).cpu(),
                "launches": launches,
                "step_ms": float(np.median(step_ms[1:])),
                "all_reduce_ms": float(np.median(ar)), "buffer_floats": n}
            del state, step, net
    with open(f"{out}.{mesh.rank}", "wb") as f:
        pickle.dump(res, f)
    return 0


def dp_nccl(dev, tmp: str) -> dict:
    """Phase 23 (a): a 1-rank NCCL group on the card. make_parallel_train_step
    on the bench batch, 3 steps bitwise equal to make_train_step's from the
    same init (losses, reports, frame ids, parameters, velocity); the
    all_reduce's device time a step from torch.profiler; a K=4 parallel
    block enqueued behind a device sleep must return without waiting."""
    mesh = make_mesh(1, "cuda:0", rank=0,
                     init_method="file://" + os.path.join(tmp, "store"))
    if mesh.backend != "nccl":
        raise AssertionError(f"one rank on a card took {mesh.backend}")
    try:
        batch = bench_batch(np.random.RandomState(0), dev, C)
        spec, net_a = dp_net("bidi", H, C, dev)
        a, b = TrainState.create(net_a), TrainState.create(dp_net(
            "bidi", H, C, dev)[1])
        one = make_train_step(spec, 1e-4, 0.9)
        par = make_parallel_train_step(spec, mesh, 1e-4, 0.9)
        for s in range(3):
            a, ma = one(a, batch)
            b, mb = par(b, batch)
            for k in ("loss", "report", "frame_ids", "frame_vals"):
                if not torch.equal(ma[k], mb[k]):
                    raise AssertionError(f"1-rank NCCL step {s}: {k} differs "
                                         "from make_train_step's")
        for (n, p), q in zip(a.net.named_parameters(), b.net.parameters()):
            if not (torch.equal(p, q) and torch.equal(a.velocity[n],
                                                      b.velocity[n])):
                raise AssertionError(f"1-rank NCCL steps: {n} differs")
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                par(b, batch)
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages() if "nccl" in e.key.lower()]
        ar_dev = sum(device_us(e) for e in rows
                     if e.device_type == torch.autograd.DeviceType.CUDA)
        ar_host = sum(e.cpu_time_total for e in rows
                      if e.device_type == torch.autograd.DeviceType.CPU)
        step_ms = host_ms(lambda: par(b, batch), 3)
        group = {"x": batch["x"], "targets": batch["targets"],
                 "lengths": batch["lengths"],
                 "tlens": batch["target_lengths"]}
        idx_all = torch.arange(B, device=dev).repeat(8, 1)
        multi = make_parallel_multi_train_step(spec, mesh, 4, 1e-4, 0.9)
        multi(b, group, idx_all, 0)
        torch.cuda.synchronize()
        sleep = torch.cuda.Event(enable_timing=True)
        woke = torch.cuda.Event(enable_timing=True)
        sleep.record()
        torch.cuda._sleep(NOSYNC_CYCLES)
        woke.record()
        t0 = time.perf_counter()
        multi(b, group, idx_all, 4)
        nosync_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        sleep_ms = sleep.elapsed_time(woke)
        if not nosync_ms < 0.5 * sleep_ms:
            raise AssertionError(f"a K=4 parallel block took {nosync_ms:.1f} "
                                 f"ms behind a {sleep_ms:.1f} ms device "
                                 "sleep: a step waited for the card")
    finally:
        dist.destroy_process_group()
    nparams = sum(p.numel() for p in a.net.parameters())
    out = {"step_ms": step_ms, "all_reduce_device_ms": ar_dev / 3e3,
           "all_reduce_host_ms": ar_host / 3e3,
           "nccl_rows": sorted({kernel_name(e.key) for e in rows}),
           "buffer_floats": 1 + nparams + 2 * B * T,
           "block_enqueue_ms": nosync_ms, "sleep_ms": sleep_ms}
    log(f"[dp] (a) 1-rank NCCL on {dev}: 3 make_parallel_train_step steps "
        f"(bidi B={B} T={T} S={2 * NCHARS + 1}, the card's default "
        "precision) bitwise "
        f"equal to make_train_step's; step {step_ms:.3f} ms; the all_reduce "
        f"of {out['buffer_floats']} floats (loss, {nparams} gradient "
        f"values, the frames of 2·B·T) {out['all_reduce_device_ms']:.4f} ms "
        f"a step on the card, {out['all_reduce_host_ms']:.4f} ms on the "
        f"host (torch.profiler rows {out['nccl_rows']}); a K=4 parallel "
        f"block returned in {nosync_ms:.2f} ms behind a {sleep_ms:.1f} ms "
        "device sleep")
    return out


def dp_gloo(dev, tmp: str, default_bf16: bool) -> dict:
    """Phase 23 (b): dp_worker on two gloo ranks sharing cuda:0, held against
    the same steps on one rank on the full batch."""
    out = os.path.join(tmp, "dp")
    if launch(dp_worker, 2, (out, default_bf16), "cuda:0") != 0:
        raise AssertionError("the DP ranks returned non-zero")
    ranks = []
    for r in (0, 1):
        with open(f"{out}.{r}", "rb") as f:
            ranks.append(pickle.load(f))
    res = {}
    for kind, h, ncls, nsteps in DP_NETS:
        batch = bench_batch(np.random.RandomState(0), dev, ncls)
        for bf16 in (default_bf16, not default_bf16):
            spec, net = dp_net(kind, h, ncls, dev)
            start = dp_params(net).cpu()
            state = TrainState.create(net)
            step = make_train_step(spec, DP_LR, 0.9, xz_bf16=bf16)
            losses = []
            for _ in range(nsteps):
                state, m = step(state, batch)
                losses.append(float(m["loss"]))
            r0, r1 = (rk[(kind, bf16)] for rk in ranks)
            tag = f"{kind} {'bf16' if bf16 else 'f32'}"
            if not torch.equal(r0["params"], r1["params"]):
                raise AssertionError(f"DP {tag}: the ranks' params differ")
            if not np.allclose(r0["losses"], losses, rtol=DP_LOSS_RTOL,
                               atol=0):
                raise AssertionError(f"DP {tag}: losses {r0['losses']} "
                                     f"against one rank's {losses}")
            dist_ = dp_check(f"DP {tag}", r0["params"], dp_params(net).cpu(),
                             start, bf16)
            want = DP_COUNTED + (("bidi_lstm_fwd_state_xz",)
                                 if kind == "bidi2" else ())
            for r, rk in enumerate((r0, r1)):
                if min(rk["launches"][k] for k in want) < nsteps:
                    raise AssertionError(f"DP {tag}: rank {r} skipped a "
                                         f"kernel: {rk['launches']}")
            res[(kind, bf16)] = dict(
                dist_, steps=nsteps, lr=DP_LR, losses=r0["losses"],
                one_rank_losses=losses, **{
                "launches_per_step": [
                    {k: v / nsteps for k, v in rk["launches"].items() if v}
                    for rk in (r0, r1)],
                "step_ms": [r0["step_ms"], r1["step_ms"]],
                "all_reduce_ms": [r0["all_reduce_ms"], r1["all_reduce_ms"]],
                "buffer_floats": r0["buffer_floats"]})
            log(f"[dp] (b) 2 gloo ranks sharing cuda:0, {tag} (B={B}, "
                f"{B // 2} rows a rank), {nsteps} steps: losses "
                f"{r0['losses']} "
                f"against one rank's {losses} (rtol {DP_LOSS_RTOL:g}, lr "
                f"{DP_LR:g}), {dp_note(dist_)}, the ranks' params "
                "equal; launches a step on each rank "
                f"{res[(kind, bf16)]['launches_per_step']}; step "
                f"{r0['step_ms']:.2f} / {r1['step_ms']:.2f} ms (ranks 0/1), "
                f"one gloo all_reduce of {r0['buffer_floats']} floats "
                f"{r0['all_reduce_ms']:.3f} / {r1['all_reduce_ms']:.3f} ms "
                "(gloo stages CUDA tensors through the host, so it waits "
                f"for the card; {DP_LABEL})")
            del state, step, net
    return res


def dp_halves(dev) -> dict:
    """Why the bf16 runs need DP_BF16_SLACK: at the seeded init, the
    gradient of the bench batch against the sum of its two halves'
    gradients, in both modes, as max|Δ| / max|g| of the worst parameter."""
    batch = bench_batch(np.random.RandomState(0), dev, C)
    halves = [{k: v[r] for k, v in batch.items()}
              for r in (slice(0, B // 2), slice(B // 2, B))]
    out = {}
    for bf16 in (True, False):
        net = dp_net("bidi", H, C, dev)[1]
        full = loss_and_grads(net, batch, _LOSSES["ctc"], "none", bf16)[1]
        parts = [loss_and_grads(net, h, _LOSSES["ctc"], "none", bf16)[1]
                 for h in halves]
        rel = {n: float((full[n] - parts[0][n] - parts[1][n]).abs().max()
                        / full[n].abs().max()) for n in full}
        worst = max(rel, key=rel.get)
        out["bf16" if bf16 else "f32"] = {"worst": worst,
                                          "rel": rel[worst]}
    log(f"[dp] (b) why the bf16 slack: at the init, the bench batch's "
        f"gradient against its two halves' summed, worst parameter: bf16 "
        f"{out['bf16']['worst']} {out['bf16']['rel']:.3e}, f32 "
        f"{out['f32']['worst']} {out['f32']['rel']:.3e} (max|d| / max|g|; "
        "the bf16 mode rounds the affine layers' dW to bf16 on each part)")
    return out


def dp_cli(mod, name: str, args, env: dict, tmp: str, dev) -> dict:
    """One CLI run through its main with ``env`` -> its JSONL records, the
    saved model's parameters, the wall seconds and what it printed here
    (the ranks' rank 0 prints in its own process)."""
    save = os.path.join(tmp, name)
    env = dict(env, save_name=save, log_jsonl=save + ".jsonl")
    saved_env = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    printed = io.StringIO()
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            rc = mod.main(args)
        wall = time.perf_counter() - t0
    finally:
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    if rc != 0:
        raise AssertionError(f"{name}: main returned {rc}")
    with open(save + ".jsonl") as f:
        recs = [json.loads(ln) for ln in f]
    net = load_net(save + "-last.clstm", dev)[1]
    return {"recs": recs, "params": dp_params(net).cpu(), "wall_s": wall,
            "printed": printed.getvalue()}


def dp_clis(dev, tmp: str, ocr_dir: str, train_pairs, test_pairs,
            default_bf16: bool) -> dict:
    """Phase 23 (c): clstmocrtrain and clstmfiltertrain with mesh=2 on
    cuda:0 (two gloo ranks started by main) against mesh=1, from one
    .clstm each, in the card's default precision (the CLIs have no other):
    the same trials, final weights within (b)'s limits (dp_check)."""
    manifests = [os.path.join(ocr_dir, d, "manifest.txt")
                 for d in ("train", "test")]
    ocr = CLSTMOCR(target_height=D, device=dev)
    ocr.createBidi(OcrDataset(manifests[0], target_height=D).build_codec(),
                   H, seed=0)
    ocr_start = os.path.join(tmp, "ocr_start.clstm")
    ocr.save(ocr_start)
    icodec = Codec.build(a for a, _ in train_pairs)
    fcodec = Codec.build(b for _, b in train_pairs)
    flt = CLSTMText(input_repeat=FILTER_REPEAT, device=dev)
    flt.createBidi(icodec, fcodec, H, seed=0)
    flt_start = os.path.join(tmp, "filter_start.clstm")
    flt.save(flt_start)
    tsv = [write_tsv(os.path.join(tmp, f"{n}.tsv"), p)
           for n, p in (("train", train_pairs), ("test", test_pairs))]
    out = {}
    for cli, mod, args, env, start, rate, model in (
            ("clstmocrtrain", clstmocrtrain, manifests, DP_OCR_ENV,
             ocr_start, "lines_per_sec", ocr),
            ("clstmfiltertrain", clstmfiltertrain, tsv, DP_FILTER_ENV,
             flt_start, "pairs_per_sec", flt)):
        runs = {m: dp_cli(mod, f"{cli}-mesh{m}", args,
                          dict(env, load=start, mesh=str(m)), tmp, dev)
                for m in (1, 2)}
        one, two = runs[1], runs[2]
        if [r["trial"] for r in two["recs"]] != [r["trial"] for r in
                                                 one["recs"]]:
            raise AssertionError(f"{cli} mesh=2: other trials than mesh=1")
        if "data-parallel" in one["printed"]:
            raise AssertionError(f"{cli} mesh=1 ran data-parallel")
        dist_ = dp_check(f"{cli} mesh=2", two["params"], one["params"],
                         dp_params(model.net).cpu(), default_bf16)
        rates = {m: [r[rate] for r in runs[m]["recs"] if rate in r][-1]
                 for m in (1, 2)}
        trials = one["recs"][-1]["trial"]
        out[cli] = {"trials": trials, **dist_,
                    "rate_mesh1": rates[1], "rate_mesh2": rates[2],
                    "wall_s_mesh1": one["wall_s"],
                    "wall_s_mesh2": two["wall_s"],
                    "test": [[r.get("test_cer") for r in runs[m]["recs"]
                              if "test_cer" in r] for m in (1, 2)]}
        log(f"[dp] (c) {cli} from one .clstm, {trials} trials on cuda:0: "
            f"mesh=2 against mesh=1, {dp_note(dist_)}; test CER "
            f"{out[cli]['test']}; {rate.replace('_per_sec', '/s')} mesh=1 "
            f"{rates[1]:.1f}, mesh=2 {rates[2]:.1f} ({DP_LABEL}); wall "
            f"{one['wall_s']:.1f} s and {two['wall_s']:.1f} s with the "
            "corpus build (and the ranks' start for mesh=2)")
    return out


# Phase 24: the routes that run no LSTM kernel, at full bidi width on the
# bench batch (B=256, T=1024, 900 frames, S=81): the JAX package's
# compute_dtype (its scan recipe with bf16 operands; ops/lstm.py) and
# fuse_bidi=False (the literal Parallel(NPLSTM, Reversed(NPLSTM)) tree),
# which the JAX package sends to lax.scan on every backend and the port to
# its plain loops on every device; then utils/profiling.trace around a
# default step and clstmocrtrain with display_every. lr CD_LR: the bench
# batch diverges at bench.py's 1e-4 (ROADMAP.md Queue 3).
CD_LR = 1e-6
CD_STEPS = 3
# The card's compute_dtype step-1 loss and gradients against the same code
# on the CPU, on the same batch: the largest relative Frobenius distance
# over the loss and every gradient within CD_RATIO of the card's own
# distance between its compute_dtype and strict f32 gradients (the CPU
# tests' rule against the JAX package, tests/test_torch_compute_dtype.py);
# the planted recipe with dWh summed in f32 over the steps must fail it.
CD_RATIO = 0.1
# Warm steps of each route timed in turns with the default kernel step.
CD_TURNS = 2
LSTM_COUNTED = ("bidi_lstm_infer", "bidi_lstm_fwd_state",
                "bidi_lstm_infer_xz", "bidi_lstm_fwd_state_xz",
                "bidi_lstm_bwd_chain", "bidi_lstm_bwd_reduce")
# The symbols utils/profiling.trace must name in a default bidi step's
# trace: K1, K2's chain and reduction (bf16 or f32), K5, K6.
# The kernels a traced default step must name: K1, K2's chain and its dW
# kernel (of the card's default precision: the bf16 K1 runs on the tensor
# cores and the bf16 chain on clusters at bidi's width and T), K5, K6.
TRACE_SYMBOLS = ("fwd16_kernel" if CARD_DEFAULT_BF16 else
                 "bidi_lstm_fwd_kernel",
                 "bwd_chain16_kernel" if CARD_DEFAULT_BF16 else
                 "bwd_chain_kernel",
                 "bwd_dw_bf16_kernel" if CARD_DEFAULT_BF16 else
                 "bwd_dw_partial", "ctc_forward_kernel", "ctc_both_kernel")
THROUGHPUT_RTOL = 0.1
# clstmocrtrain with display_every on phase 17's corpus: blocks of up to 8
# batches (256 trials), so nearly every block crosses a display boundary.
# A device sleep of DISPLAY_SLEEP_CYCLES (~2 s), on an idle card, goes in
# before every block call that is the first at its T bucket, and before block
# DISPLAY_SLEEP_BLOCK or the first after it whose iteration draws the
# display and neither tests nor saves, so the host's render (matplotlib,
# ~0.1 s) fits in half of it.
DISPLAY_EVERY = 256
DISPLAY_ENV = dict(OCR_ENV, steps_per_dispatch="8")
DISPLAY_SLEEP_BLOCK = 4
DISPLAY_SLEEP_CYCLES = 4 * NOSYNC_CYCLES
# A quarter of that sleep: a slept block call still running then has the
# host's stacks dumped.
DISPLAY_DUMP_S = 0.5


def grad_group(loss, grads: dict) -> dict:
    """A step's loss and gradients as float64 CPU tensors, for distances."""
    g = {n: v.detach().double().cpu() for n, v in grads.items()}
    g["loss"] = loss.detach().double().cpu().reshape(1)
    return g


def group_dist(a: dict, b: dict) -> float:
    """Largest relative Frobenius distance of a from b over a group."""
    return max(float((a[k] - b[k]).norm() / max(float(b[k].norm()), 1e-30))
               for k in b)


class _RoundedForwardOnly(torch.autograd.Function):
    """h rounded to bf16 on the way in, its cotangent passed back as it
    came (f32): the scan's cast rounds it."""

    @staticmethod
    def forward(ctx, t, cd):
        return t.to(cd).float()

    @staticmethod
    def backward(ctx, g):
        return g, None


def planted_scan(f32_dwh: bool, unrounded_dh: bool):
    """ops/lstm.py::_bidi_scan with one rounding point of the backward
    moved: Wh read as one f32 copy over all steps (its gradient then sums in
    f32 and is rounded once), or the cotangent of the rounded h not
    rounded. The planted controls of phase 24 and of
    tests/test_torch_compute_dtype.py."""
    def scan(params_f, params_r, x, lengths, cd):
        B_, T_, _ = x.shape
        H_ = params_f["Wh"].shape[0]
        x2 = lstm_ops._cast(torch.stack([x, flip_within_length(x, lengths)]),
                            cd)
        Wx2 = lstm_ops._cast(torch.stack([params_f["Wx"], params_r["Wx"]]),
                             cd)
        b2 = torch.stack([params_f["b"], params_r["b"]]).float()
        xzs = (torch.einsum("gbtd,gdo->gbto", x2, Wx2)
               + b2[:, None, None, :]).unbind(2)
        Wh2 = torch.stack([params_f["Wh"], params_r["Wh"]]).to(cd)
        Wh_once = Wh2.float()
        valid = lstm_ops._valid(lengths, B_, T_, x.device)
        h = x.new_zeros((2, B_, H_))
        c = torch.zeros_like(h)
        outs = []
        for t in range(T_):
            hc = (_RoundedForwardOnly.apply(h, cd) if unrounded_dh
                  else lstm_ops._cast(h, cd))
            z = xzs[t] + torch.bmm(hc, Wh_once if f32_dwh else Wh2.float())
            h_new, c_new = lstm_ops._cell(z, c, H_)
            v = valid[t]
            c = torch.where(v, c_new, c)
            h = torch.where(v, h_new, h)
            outs.append(torch.where(v, h_new, torch.zeros_like(h_new)))
        hs = torch.stack(outs, dim=2)
        return torch.cat([hs[0], flip_within_length(hs[1], lengths)],
                         dim=-1).to(x.dtype)
    return scan


@contextlib.contextmanager
def unfused_losses():
    """train.py's losses with apply_net(fuse_bidi=False): make_train_step
    then runs the bidi pair as the literal layer tree (the JAX package's
    fuse_bidi is an apply_net flag; its steps take none)."""
    saved = train_mod.apply_net
    train_mod.apply_net = functools.partial(saved, fuse_bidi=False)
    try:
        yield
    finally:
        train_mod.apply_net = saved


def counted_steps(step, state, batch, n: int) -> tuple:
    """``n`` steps with the launch counts reset just before and read just
    after -> (losses, counts)."""
    reset_counts()
    losses = [float(step(state, batch)[1]["loss"]) for _ in range(n)]
    torch.cuda.synchronize()
    return losses, counts()


def route_turns(routes: dict, card: str) -> dict:
    """The steps of two routes {name: fn} timed in turns (a, b, b, a, ...),
    CD_TURNS of each, on the host clock, each step synchronised -> {name:
    median, range and each ms}."""
    (na, fa), (nb, fb) = routes.items()
    ts = {na: [], nb: []}
    for i in range(CD_TURNS):
        for n, f in ((na, fa), (nb, fb))[::1 if i % 2 == 0 else -1]:
            ts[n].append(host_ms(f, 1))
    out = {n: {"median_ms": float(np.median(v)), "range_ms": [min(v), max(v)],
               "ms": v} for n, v in ts.items()}
    log(f"[cd] {card} | in turns: " + "; ".join(
        f"{n} median {r['median_ms']:.3f} ms (range {r['range_ms'][0]:.3f}-"
        f"{r['range_ms'][1]:.3f})" for n, r in out.items()))
    return out


def no_lstm_kernel(tag: str, got: dict, nsteps: int) -> None:
    """The route launched no LSTM kernel, and K5 and K6 once a step."""
    lstm = {k: got[k] for k in LSTM_COUNTED if got[k]}
    if lstm or not got["ctc_forward"] == got["ctc_both"] == nsteps:
        raise AssertionError(f"{tag}: launches {got}: no LSTM kernel, K5 and "
                             f"K6 once a step")


def compute_dtype_steps(dev, card, spec, net0, batch) -> dict:
    """Phase 24 (a)-(c)."""
    loss_fn = _LOSSES["ctc"]
    on = copy.deepcopy

    def card_state():
        return TrainState.create(on(net0).to(dev))

    # (a) compute_dtype=bf16: CD_STEPS steps through make_train_step.
    cd_step = make_train_step(spec, CD_LR, 0.9, compute_dtype=torch.bfloat16)
    state = card_state()
    cd_losses, cd_counts = counted_steps(cd_step, state, batch, CD_STEPS)
    if not all(np.isfinite(cd_losses)):
        raise AssertionError(f"compute_dtype losses {cd_losses}")
    no_lstm_kernel("compute_dtype steps", cd_counts, CD_STEPS)
    # Step 1's loss and gradients: the card, the CPU (the same code), the
    # card in strict f32 (the kernels), the planted control on the card.
    cpu_batch = {k: v.cpu() for k, v in batch.items()}

    def grads(net, b, **mode):
        loss, g, _ = loss_and_grads(net, b, loss_fn, "none", **mode)
        return grad_group(loss, g)
    t0 = time.perf_counter()
    g_card = grads(on(net0).to(dev), batch, xz_bf16=None,
                   compute_dtype=torch.bfloat16)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    g_cpu = grads(on(net0), cpu_batch, xz_bf16=None,
                  compute_dtype=torch.bfloat16)
    t_cpu = time.perf_counter() - t0
    g_f32 = grads(on(net0).to(dev), batch, xz_bf16=False)
    saved = lstm_ops._bidi_scan
    lstm_ops._bidi_scan = planted_scan(f32_dwh=True,
                                           unrounded_dh=False)
    try:
        g_ctrl = grads(on(net0).to(dev), batch, xz_bf16=None,
                       compute_dtype=torch.bfloat16)
    finally:
        lstm_ops._bidi_scan = saved
    gap = group_dist(g_card, g_f32)
    d_cpu = group_dist(g_card, g_cpu)
    d_ctrl = group_dist(g_ctrl, g_cpu)
    per = {k: float((g_card[k] - g_cpu[k]).norm() / g_cpu[k].norm())
           for k in g_cpu}
    log(f"[cd] (a) compute_dtype=bf16, {CD_STEPS} make_train_step steps on "
        f"the bench batch (B={B} T={T} S={2 * NCHARS + 1}, lr {CD_LR:g}): "
        f"losses {[round(v, 3) for v in cd_losses]}; launches "
        f"{ {k: v for k, v in cd_counts.items() if v} } (no LSTM kernel); "
        f"step 1 against the same code on the CPU: largest relative "
        f"Frobenius distance over the loss and gradients {d_cpu:.3e}, the "
        f"card's compute_dtype-vs-strict-f32 distance {gap:.3e} (limit "
        f"{CD_RATIO:g}x: {CD_RATIO * gap:.3e}); the planted control (dWh "
        f"summed in f32) {d_ctrl:.3e} (must exceed the limit); per tensor "
        + ", ".join(f"{k} {v:.2e}" for k, v in per.items())
        + f"; step-1 gradients {t_card:.2f} s on the card, {t_cpu:.2f} s on "
        "the CPU")
    if not (gap > 0 and d_cpu <= CD_RATIO * gap):
        raise AssertionError(f"compute_dtype on the card is {d_cpu:.3e} from "
                             f"the CPU, over {CD_RATIO:g} x {gap:.3e}")
    if not d_ctrl > CD_RATIO * gap:
        raise AssertionError(f"the planted control ({d_ctrl:.3e}) passes the "
                             f"compute_dtype check ({CD_RATIO * gap:.3e})")
    del g_card, g_cpu, g_f32, g_ctrl
    kern_step = make_train_step(spec, CD_LR, 0.9)
    kstate = card_state()
    cd_t = route_turns({
        "compute_dtype=bf16 step": lambda: cd_step(state, batch),
        "default kernel step": lambda: kern_step(kstate, batch)}, card)

    # (b) fuse_bidi=False, strict f32, against the fused kernel step.
    f32_step = make_train_step(spec, CD_LR, 0.9, xz_bf16=False)
    ustate, fstate = card_state(), card_state()
    p0 = [p.detach().clone() for p in ustate.net.parameters()]
    with unfused_losses():
        u_losses, u_counts = counted_steps(f32_step, ustate, batch, 1)
    f_loss = float(f32_step(fstate, batch)[1]["loss"])
    gap_p = max(float((u.detach() - f.detach()).abs().max())
                for u, f in zip(ustate.net.parameters(),
                                fstate.net.parameters()))
    moved = max(float((f.detach() - s).abs().max())
                for f, s in zip(fstate.net.parameters(), p0))
    loss_rel = abs(u_losses[0] - f_loss) / abs(f_loss)
    with unfused_losses():
        u_more, u_counts3 = counted_steps(f32_step, ustate, batch,
                                          CD_STEPS - 1)
    no_lstm_kernel("fuse_bidi=False steps", u_counts, 1)
    no_lstm_kernel("fuse_bidi=False steps", u_counts3, CD_STEPS - 1)
    log(f"[cd] (b) fuse_bidi=False, strict f32: step 1 against the fused "
        f"kernel step (K1, K2, K5, K6): loss rel {loss_rel:.3e} (limit "
        f"{STEP1_LOSS_RTOL:.0e}), update max|d| {gap_p:.3e} over its move "
        f"{moved:.3e}: {gap_p / moved:.3e} (limit {STEP1_PARAM_RTOL:.0e}); "
        f"{CD_STEPS} steps launched "
        f"{ {k: u_counts[k] + u_counts3[k] for k in u_counts if u_counts[k] + u_counts3[k]} }"
        f" (no LSTM kernel); losses "
        f"{[round(v, 3) for v in u_losses + u_more]}")
    if not (loss_rel <= STEP1_LOSS_RTOL and moved > 0
            and gap_p / moved <= STEP1_PARAM_RTOL):
        raise AssertionError("fuse_bidi=False disagrees with the fused "
                             f"kernel step: loss {loss_rel:.3e}, update "
                             f"{gap_p / moved:.3e}")

    def unfused_one():
        with unfused_losses():
            f32_step(ustate, batch)
    u_t = route_turns({"fuse_bidi=False f32 step": unfused_one,
                       "fused f32 kernel step": lambda: f32_step(fstate,
                                                                 batch)},
                      card)
    del ustate, fstate

    # (c) make_forward(compute_dtype=bf16) over the bench profile.
    fwd = make_forward(spec, compute_dtype=torch.bfloat16)
    fnet = on(net0).to(dev)
    x, L = batch["x"], batch["lengths"]
    with torch.no_grad():
        reset_counts()
        probs = fwd(fnet, x, L)
        torch.cuda.synchronize()
        f_counts = counts()
        fwd_ms = host_ms(lambda: fwd(fnet, x, L), 3)
        kern_fwd_ms = host_ms(lambda: apply_net(fnet, x, L), 3)
    mask = length_mask(L, T).bool()
    sums = probs.sum(-1)[mask]
    if (any(f_counts[k] for k in LSTM_COUNTED) or tuple(probs.shape) != (
            B, T, C) or not bool(torch.isfinite(probs).all())
            or float((sums - 1).abs().max()) > 1e-4):
        raise AssertionError(f"make_forward(compute_dtype): launches "
                             f"{f_counts}, shape {tuple(probs.shape)}")
    log(f"[cd] {card} | (c) make_forward(compute_dtype=bf16) B={B} T={T} "
        f"len={TRUE_T}: {fwd_ms:.3f} ms/batch ({B / fwd_ms * 1e3:.1f} "
        f"lines/s; no LSTM kernel launched, posteriors finite and "
        f"normalised), the default no-grad forward (K3) {kern_fwd_ms:.3f} "
        "ms/batch")
    return {"cd_launches": cd_counts, "cd_losses": cd_losses,
            "cd_cpu_dist": d_cpu, "cd_gap": gap, "cd_control_dist": d_ctrl,
            "cd_grad_ms_card": t_card * 1e3, "cd_grad_s_cpu": t_cpu,
            "cd_turns": cd_t, "unfused_launches": {
                k: u_counts[k] + u_counts3[k] for k in u_counts},
            "unfused_step1_loss_rel": loss_rel,
            "unfused_step1_param_rel": gap_p / moved, "unfused_turns": u_t,
            "forward_ms": fwd_ms, "forward_default_ms": kern_fwd_ms,
            "forward_launches": f_counts}


def trace_worker(out: str) -> None:
    """Phase 24 (d) in a fresh process: one default bidi step (the bench
    batch, the init of seed 0) under utils/profiling.trace, after a warm
    step; writes the trace's path to ``out``."""
    dev = torch_device("cuda")
    spec, net = make_net_init("bidi", {"ninput": D, "nhidden": H,
                                       "noutput": C},
                              torch.Generator().manual_seed(0), dev)
    batch = bench_batch(np.random.RandomState(0), dev)
    step = make_train_step(spec, CD_LR, 0.9)
    state = TrainState.create(net)
    step(state, batch)
    torch.cuda.synchronize()
    with trace(os.path.join("chiprun_out", "trace")) as prof:
        step(state, batch)
    with open(out, "w") as f:
        f.write(prof.trace_path)


def trace_kernels(path: str) -> dict:
    """A Chrome trace -> which TRACE_SYMBOLS its kernel records name."""
    with open(path, encoding="utf-8") as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]
                 if e.get("cat") == "kernel"}
    return {s: any(s in n for n in names) for s in TRACE_SYMBOLS}


def traced_step(dev, card, spec, net0, batch) -> dict:
    """Phase 24 (d): utils/profiling.trace around one default bidi step (the
    card's default precision) in a fresh process, whose trace must name the
    kernels and hold as many kernel records as launches; the same in this
    process, late in the run, where trace must either hold every record or
    warn that it lost some (utils/profiling.py); Throughput over warm steps
    against their CUDA-event times."""
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "trace_path")
        proc = torch.multiprocessing.get_context("spawn").Process(
            target=trace_worker, args=(out,))
        proc.start()
        proc.join()
        if proc.exitcode != 0:
            raise AssertionError(f"the trace process exited {proc.exitcode}")
        with open(out) as f:
            path = f.read()
    named = trace_kernels(path)
    kernels, launches = kernel_counts(path)
    mb = os.path.getsize(path) / 1e6
    if not all(named.values()) or kernels < launches:
        raise AssertionError(f"the trace names no kernel for "
                             f"{[s for s, v in named.items() if not v]}, or "
                             f"holds {kernels} kernel records of {launches} "
                             "kernel launches")
    step = make_train_step(spec, CD_LR, 0.9)
    state = TrainState.create(copy.deepcopy(net0).to(dev))
    step(state, batch)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with trace(os.path.join("chiprun_out", "trace")) as prof:
            step(state, batch)
    late = trace_kernels(prof.trace_path)
    late_kernels, late_launches = prof.kernel_records, prof.kernel_launches
    lost_warned = any(issubclass(w.category, RuntimeWarning) and
                      f"{late_kernels} kernel records of {late_launches}"
                      in str(w.message) for w in caught)
    meter = Throughput()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(8)]
    for a, b in ev:
        a.record()
        step(state, batch)
        b.record()
        b.synchronize()
        meter.add(B)
    ms = [a.elapsed_time(b) for a, b in ev[1:]]
    event_rate = B / (sum(ms) / len(ms)) * 1e3
    rate = meter.rate()
    log(f"[trace] {card} | utils/profiling.trace around one default bidi "
        f"step in a fresh process: {path} ({mb:.2f} MB, {kernels} kernel "
        f"records, {launches} kernel launches) names "
        + ", ".join(TRACE_SYMBOLS) + f"; the same in this process, late in "
        f"the run: {late_kernels} kernel records of {late_launches} "
        f"launches ({'trace warned of the loss' if lost_warned else 'no warning'}"
        "), names "
        + (", ".join(k for k, v in late.items() if v) or "none")
        + f"; Throughput over 8 warm steps {rate:.1f} lines/s, their "
        f"CUDA-event times {event_rate:.1f} lines/s (mean "
        f"{sum(ms) / len(ms):.3f} ms a step; limit {THROUGHPUT_RTOL:.0%} "
        "apart)")
    if late_launches < 1 or lost_warned != (late_kernels < late_launches):
        raise AssertionError(f"trace kept {late_kernels} kernel records of "
                             f"{late_launches} launches and "
                             f"{'warned' if lost_warned else 'did not warn'}")
    if not abs(rate - event_rate) <= THROUGHPUT_RTOL * event_rate:
        raise AssertionError(f"Throughput {rate:.1f} against {event_rate:.1f}"
                             " lines/s")
    return {"trace_mb": mb, "kernel_records": kernels,
            "kernel_launches": launches,
            "late_session_kernel_records": late_kernels,
            "late_session_kernel_launches": late_launches,
            "throughput_lines_per_s": rate,
            "event_lines_per_s": event_rate, "step_ms": ms}


def display_runs(dev, tmp: str, ocr_dir: str) -> dict:
    """Phase 24 (e): clstmocrtrain on phase 17's corpus with display_every
    DISPLAY_EVERY and with 0, the same settings (DISPLAY_ENV): the PNG
    written where matplotlib is, the same TESTERR lines. In the display run
    the card is let go idle and a device sleep of DISPLAY_SLEEP_CYCLES
    queued just before every block call that is the first at its T bucket,
    and before block
    DISPLAY_SLEEP_BLOCK (or, if the block before it was slept or its
    iteration drew no display or read the card for a test or a save, the
    next block that qualifies). Each slept call must
    return in under half its sleep, and after the display block the loop
    must reach the next block call (the deferred report read and the
    display drawn in between) in under half its sleep. A slept call still
    running at a quarter of its sleep has the host's stacks dumped
    (faulthandler), so a failure names where the host waited."""
    from clstm_tpu_torch.utils import display as display_mod
    manifests = [os.path.join(ocr_dir, d, "manifest.txt")
                 for d in ("train", "test")]
    real = CLSTMOCR.train_batch_block
    seen = {"renders": 0, "reads": 0, "tb": [], "ms": [], "slept": {},
            "window": None, "display": None}
    dump = tempfile.TemporaryFile("w+")

    def counted(fn, key):
        def wrapped(*a, **kw):
            seen[key] += 1
            return fn(*a, **kw)
        return wrapped
    # The display is drawn by Display.render; a test (evaluate) or a save
    # reads the card, so a window that holds one is no display window.
    patched = ((display_mod.Display, "render", "renders"),
               (clstmocrtrain, "evaluate", "reads"),
               (CLSTMOCR, "save", "reads"))
    saved = [getattr(o, a) for o, a, _ in patched]

    def watched(self, *a, **kw):
        n, tb = len(seen["ms"]), int(a[0]["group"]["tb"])
        w, seen["window"] = seen["window"], None
        if w is not None:
            w["through_ms"] = (time.perf_counter() - w["t0"]) * 1e3
            if (seen["renders"] > w["renders0"]
                    and seen["reads"] == w["reads0"]):
                seen["display"] = w
        display = (seen["display"] is None and n >= DISPLAY_SLEEP_BLOCK
                   and n - 1 not in seen["slept"])
        slept = display or tb not in seen["tb"]
        if slept:
            # The card idle first: a call queued behind earlier blocks
            # blocks on the full launch queue instead, which is no wait
            # for a result (scripts/torch_bucket_wait_probe.py).
            torch.cuda.synchronize()
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            torch.cuda._sleep(DISPLAY_SLEEP_CYCLES)
            ev[1].record()
            dump.seek(0)
            dump.truncate()
            faulthandler.dump_traceback_later(DISPLAY_DUMP_S, file=dump)
        t = time.perf_counter()
        try:
            out = real(self, *a, **kw)
        finally:
            if slept:
                faulthandler.cancel_dump_traceback_later()
        ms = (time.perf_counter() - t) * 1e3
        seen["ms"].append(ms)
        seen["tb"].append(tb)
        if slept:
            dump.seek(0)
            seen["slept"][n] = {"tb": tb, "first_at_bucket": tb not in
                                seen["tb"][:-1], "events": ev, "ms": ms,
                                "stacks": dump.read()}
            if display:
                seen["window"] = {"n": n, "t0": t, "renders0":
                                  seen["renders"], "reads0": seen["reads"]}
        return out
    runs = {}
    for every in (0, DISPLAY_EVERY):
        if every:
            CLSTMOCR.train_batch_block = watched
            for (o, a, key), fn in zip(patched, saved):
                setattr(o, a, counted(fn, key))
        try:
            runs[every] = dp_cli(clstmocrtrain, f"display{every}", manifests,
                                 dict(DISPLAY_ENV, display_every=str(every)),
                                 tmp, dev)
        finally:
            CLSTMOCR.train_batch_block = real
            for (o, a, _), fn in zip(patched, saved):
                setattr(o, a, fn)
    dump.close()
    torch.cuda.synchronize()
    tests = {k: [ln for ln in r["printed"].splitlines()
                 if ln.startswith("TESTERR ")] for k, r in runs.items()}
    png = os.path.join(tmp, f"display{DISPLAY_EVERY}-display.png")
    slept = seen["slept"]
    for r in slept.values():
        a, b = r.pop("events")
        r["sleep_ms"] = a.elapsed_time(b)
    w = seen["display"]
    if w is not None:
        w = {"block": w["n"], "through_ms": w["through_ms"],
             "sleep_ms": slept[w["n"]]["sleep_ms"]}
    waited = {n: r for n, r in slept.items()
              if not r["ms"] < 0.5 * r["sleep_ms"]}
    loss_gap = max(abs(a["loss"] - b["loss"]) for a, b in zip(
        runs[0]["recs"], runs[DISPLAY_EVERY]["recs"]) if "loss" in a)
    log(f"[display] clstmocrtrain on phase 17's corpus, B="
        f"{DISPLAY_ENV['batch_size']}, K={DISPLAY_ENV['steps_per_dispatch']}"
        f", ntrain {DISPLAY_ENV['ntrain']}: display_every={DISPLAY_EVERY} "
        f"printed {tests[DISPLAY_EVERY]}, display_every=0 {tests[0]}; "
        f"matplotlib {'is' if display_mod.HAVE_MPL else 'is not'} installed, "
        f"{os.path.basename(png)} "
        f"{'written' if os.path.exists(png) else 'not written'}; "
        f"{seen['renders']} renders; block calls behind a device sleep "
        "(call: T bucket, host ms / sleep ms): " + ", ".join(
            f"{n}: {r['tb']}{' (first)' if r['first_at_bucket'] else ''}, "
            f"{r['ms']:.1f} / {r['sleep_ms']:.1f}"
            for n, r in slept.items())
        + (f"; after display block {w['block']} the next block call came "
           f"{w['through_ms']:.1f} ms after its {w['sleep_ms']:.1f} ms sleep "
           "(the deferred report read and the display drawn between)"
           if w else "")
        + f"; every block call's host ms: median "
        f"{float(np.median(seen['ms'])):.1f}, largest {max(seen['ms']):.1f} "
        f"(call {int(np.argmax(seen['ms']))} of {len(seen['ms'])}); largest "
        f"|loss difference| between the runs {loss_gap:.3e}")
    for n, r in waited.items():
        log(f"[display] block call {n} (T bucket {r['tb']}) waited for the "
            f"card: {r['ms']:.1f} ms behind a {r['sleep_ms']:.1f} ms sleep; "
            "the host's stacks at a quarter of the sleep:\n"
            + (r["stacks"] or "(none dumped)"))
    if tests[DISPLAY_EVERY] != tests[0] or not tests[0]:
        raise AssertionError("display_every changed the TESTERR lines")
    if os.path.exists(png) != display_mod.HAVE_MPL:
        raise AssertionError("the display PNG was not written where "
                             "matplotlib is, or was written where it is not")
    if waited:
        raise AssertionError(f"block calls {sorted(waited)} waited for the "
                             "card behind a device sleep")
    if w is None:
        raise AssertionError("no slept block of the display run drew the "
                             "display")
    if not w["through_ms"] < 0.5 * w["sleep_ms"]:
        raise AssertionError(f"the loop waited for the card: the block after "
                             f"the display came {w['through_ms']:.1f} ms "
                             f"after a {w['sleep_ms']:.1f} ms sleep")
    return {"testerr": tests[0], "matplotlib": display_mod.HAVE_MPL,
            "png_written": os.path.exists(png), "renders": seen["renders"],
            "display_window": w, "slept_calls": {
                n: {k: v for k, v in r.items() if k != "stacks"}
                for n, r in slept.items()},
            "block_host_ms": seen["ms"], "block_t_bucket": seen["tb"],
            "loss_gap": loss_gap,
            "wall_s": {k: r["wall_s"] for k, r in runs.items()}}


def phase24(dev, card, ocr_dir: str) -> dict:
    """Phase 24 (module docstring)."""
    t24 = time.perf_counter()
    spec, net0 = make_net_init("bidi", {"ninput": D, "nhidden": H,
                                        "noutput": C},
                               torch.Generator().manual_seed(0))
    batch = bench_batch(np.random.RandomState(0), dev)
    out = compute_dtype_steps(dev, card, spec, net0, batch)
    out["trace"] = traced_step(dev, card, spec, net0, batch)
    del batch
    with tempfile.TemporaryDirectory() as tmp:
        out["display"] = display_runs(dev, tmp, ocr_dir)
    out["seconds"] = time.perf_counter() - t24
    log(f"[cd] phase 24 passed in {out['seconds']:.1f} s")
    return out


# Phase 25: t_buckets=auto (data/dataset.py auto_t_cuts over the corpus's
# lengths, data/device_cache.py measure_dispatch_penalty_rows for the cost
# of a block call) through clstmocrtrain at full bidi width on phase 17's
# corpus, and compile_cache (utils/config.py enable_compile_cache: the
# directory of the kernels' library). AUTO_HINTS are the CLI's cost-model
# hints (cli/clstmocrtrain.py).
AUTO_HINTS = {"batch_size": 32, "epochs": 64, "k": 64}
# (a) warm reps of the bench step and of the CTC alignment.
AUTO_REPS = 5
# (c) clstmocrtrain in turns (AUTO_TURNS): B=32, K=64, ntrain a quarter of
# the 64-epoch plan the CLI builds (its K-blocks drawn in shuffled order
# over the groups, so the quarter samples every group by its size), one
# test at the end. 512 trials at K=64 would be a single clamped block of
# one group: one bucket's first use, nothing of the cuts.
AUTO_ENV = dict(OCR_ENV, steps_per_dispatch="64", ntrain=str(16 * OCR_TRAIN),
                test_every=str(16 * OCR_TRAIN),
                save_every=str(16 * OCR_TRAIN), report_every="4096")
# One turn of each: a turn takes ~21 s, most of it the CLI's corpus build,
# and the two modes' rates are a record here, not a check.
AUTO_TURNS = ("fine", "auto")
# (c) the kernels the CLI's path must launch: K3 in its test (evaluate),
# K1, K2, K5 and K6 in its steps.
AUTO_COUNTED = ("bidi_lstm_infer", "bidi_lstm_fwd_state",
                "bidi_lstm_bwd_chain", "bidi_lstm_bwd_reduce", "ctc_forward",
                "ctc_both")
# (d) the dispatch penalties forced on the two ranks; alone they give
# other cuts, and both ranks must build rank 0's.
AUTO_DP_PENALTIES = (0.0, 1e9)
# (e) a fresh process that loads the kernels' library from compile_cache
# and launches K3 once.
CACHE_CHILD = """
import time
t0 = time.perf_counter()
import os
import numpy as np
import torch
from clstm_tpu_torch.ops import _build
from clstm_tpu_torch.ops.bidi_lstm_kernel import bidi_lstm_infer
from clstm_tpu_torch.utils.config import enable_compile_cache
enable_compile_cache(os.environ["compile_cache"])
print("BUILD_DIR", _build.BUILD_DIR, flush=True)
dev = torch.device("cuda")
rng = np.random.RandomState(0)
p = {k: torch.from_numpy(rng.uniform(-0.1, 0.1, s).astype(np.float32)).to(
    dev) for k, s in (("Wx", (48, 400)), ("Wh", (100, 400)), ("b", (400,)))}
x = torch.from_numpy(rng.rand(2, 16, 48).astype(np.float32)).to(dev)
y = bidi_lstm_infer(p, p, x, torch.full((2,), 16, dtype=torch.int32,
                                        device=dev))
torch.cuda.synchronize()
print("FIRST_KERNEL", time.perf_counter() - t0, bidi_lstm_infer.launches,
      float(y.abs().sum()), flush=True)
"""


def auto_constants(dev, card: str) -> dict:
    """Phase 25 (a): the card's round trip of measure_dispatch_penalty_rows,
    and the two cost constants of auto_t_cuts on the bench batch in the
    default precision: the padded frame-rows a second of the bidi train
    step (B*T over its ms) and the CTC alignment's ms per lattice cell
    relative to a frame-row (its ms over the step's ms times S)."""
    rows = device_cache.measure_dispatch_penalty_rows(dev)
    rate = float(os.environ.get("bucket_dp_rows_per_sec",
                                device_cache.AUTO_ROWS_PER_SEC))
    batch = bench_batch(np.random.RandomState(0), dev)
    ocr = CLSTMOCR(device=dev)
    ocr.createBidi(Codec([0] + list(range(33, 33 + C - 1))), H, seed=0)
    ocr.setLearningRate(CD_LR, 0.9)
    step_ms = host_ms(lambda: ocr.train_batch(batch), AUTO_REPS)
    probs = torch.softmax(uniform(np.random.RandomState(1), (B, T, C), -3.0,
                                  3.0, dev), dim=-1)
    ctc_ms = time_ms(lambda: ctc_ops.ctc_align_targets_batched(
        probs, batch["targets"], lengths=batch["lengths"],
        target_lengths=batch["target_lengths"]), AUTO_REPS)
    S = batch["targets"].shape[1]
    out = {"dispatch_rows": rows, "dispatch_us": rows / rate * 1e6,
           "rows_per_sec_used": rate, "step_ms": step_ms, "ctc_ms": ctc_ms,
           "rows_per_sec": B * T / (step_ms / 1e3),
           "s_weight": ctc_ms / (step_ms * S), "S": S}
    log(f"[auto] (a) {card} | measure_dispatch_penalty_rows on the card: "
        f"round trip {out['dispatch_us']:.1f} us, {rows:.1f} frame-rows at "
        f"{rate:.4g} rows/s; the default bidi train step on the bench "
        f"batch (B={B}, T={T}, S={S}, lr {CD_LR:g}) {step_ms:.3f} ms: "
        f"{out['rows_per_sec']:.4g} padded frame-rows/s (the port's "
        f"AUTO_ROWS_PER_SEC {device_cache.AUTO_ROWS_PER_SEC:.4g}); the CTC "
        f"alignment (K5 + K6 and the lattice around them) {ctc_ms:.3f} ms: "
        f"s_weight {out['s_weight']:.4g} a lattice cell (the port's "
        f"AUTO_S_WEIGHT {data_mod.AUTO_S_WEIGHT:.4g})")
    return out


def groups_of(widths, cuts) -> list:
    """The T buckets a cache built on ``cuts`` holds for these widths."""
    return sorted({bucket_for(w, cuts) for w in widths})


def auto_groups(dev, tmp: str, ocr_dir: str, penalty: float) -> dict:
    """Phase 25 (b): auto_t_cuts over phase 17's training corpus with the
    CLI's hints and ``penalty``, printed; DeviceDataset(t_buckets="auto")
    from host-prepared samples and from_files (the normalization on the
    card) must hold exactly the groups of those cuts; one train_batch step
    on a batch of the largest group off T_BUCKETS_FINE against the plain
    step within phase 9's step-1 limits, launching K1, K2, K5 and K6 once
    each."""
    ds = OcrDataset(os.path.join(ocr_dir, "train", "manifest.txt"),
                    target_height=D)
    texts = ds.texts()
    codec = ds.build_codec()
    hints = dict(AUTO_HINTS, dispatch_penalty_rows=penalty)
    s_len = [2 * len(codec.encode(t)) + 1 for t in texts]
    est = [preprocess.estimate_out_T([im], D, ds.pad)
           for im in device_cache.read_images(ds.files)]
    samples = ds.load_all()
    widths = {"samples": [x.shape[0] for x, _ in samples],
              "from_files": est}
    cuts = {k: auto_t_cuts(w, s_lengths=s_len, **hints)
            for k, w in widths.items()}
    caches = {
        "samples": DeviceDataset(samples, codec, device=dev,
                                 t_buckets="auto", merge_sb=True,
                                 auto_hints=hints),
        "from_files": DeviceDataset.from_files(
            ds.files, texts, codec, device=dev, target_height=D, pad=ds.pad,
            t_buckets="auto", merge_sb=True, auto_hints=hints)}
    for k, dc in caches.items():
        got = [g["tb"] for g in dc.groups]
        if got != groups_of(widths[k], cuts[k]) or len(dc) != len(texts):
            raise AssertionError(f"auto cache ({k}) holds groups {got}, "
                                 f"its cuts give {cuts[k]}")
        log(f"[auto] (b) {k}: auto_t_cuts {list(cuts[k])} ({len(cuts[k])} "
            f"cuts, penalty {penalty:.1f} rows); the cache built on the card "
            f"holds exactly their {len(got)} groups, "
            f"{sum(t not in T_BUCKETS_FINE for t in got)} off "
            "T_BUCKETS_FINE: " + ", ".join(
                f"{g['tb']}x{g['sb']}: {g['n']}" for g in dc.groups))
    del caches["samples"], samples
    off = [g for g in caches["from_files"].groups
           if g["tb"] not in T_BUCKETS_FINE]
    if not off:
        raise AssertionError(f"no auto cut off T_BUCKETS_FINE: "
                             f"{cuts['from_files']}")
    g = max(off, key=lambda g: g["n"])
    idx = to_device(np.arange(AUTO_HINTS["batch_size"]) % g["n"], dev)
    batch = gather_batch(g, idx)
    start = os.path.join(tmp, "auto_start.clstm")
    maker = CLSTMOCR(target_height=D, device=dev)
    maker.createBidi(codec, H, seed=0)
    maker.save(start)
    models = []
    for _ in range(2):
        m = CLSTMOCR(target_height=D, device=dev)
        m.load(start)
        m.setLearningRate(1e-4, 0.9)
        models.append(m)
    launches = train_against_plain(
        models[0], models[1].state, batch, 1e-4, 0.9,
        f"auto B={AUTO_HINTS['batch_size']} T={g['tb']} S={g['sb']}",
        steps=1)
    once = {k: launches[k] for k in AUTO_COUNTED[1:]}
    if set(once.values()) != {1}:
        raise AssertionError(f"one step at T={g['tb']} launched {launches}")
    return {"cuts": {k: list(v) for k, v in cuts.items()},
            "step_shape": [AUTO_HINTS["batch_size"], g["tb"], g["sb"]],
            "step_launches": once, "est": est, "s_len": s_len}


def auto_turns(dev, tmp: str, ocr_dir: str) -> dict:
    """Phase 25 (c): clstmocrtrain on phase 17's corpus (AUTO_ENV) with
    t_buckets in the order AUTO_TURNS, each run with the launch counts
    reset just before and read just after, its loop timed under kernel
    tracing: lines/s, groups, the card's idle share, TESTERR. Then phase
    17's no-wait check at an auto bucket off T_BUCKETS_FINE: a k=4 block
    there, and the next block of its group behind a device sleep."""
    manifests = [os.path.join(ocr_dir, d, "manifest.txt")
                 for d in ("train", "test")]
    loop = clstmocrtrain.train
    block = CLSTMOCR.train_batch_block
    seen = {}

    def counted_block(self, blk, k_max=None, nvalid=None):
        """The block call, counting the padded frame-rows it trains (B x
        its T bucket a batch) and the valid frames among them."""
        nb = nvalid or blk["k"]
        seen["rows"] += nb * len(blk["host_lengths"][0]) * blk["group"]["tb"]
        seen["frames"] += sum(int(h.sum()) for h in blk["host_lengths"][:nb])
        return block(self, blk, k_max=k_max, nvalid=nvalid)

    def timed_loop(ocr, codec, **kw):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trials = loop(ocr, codec, **kw)
            torch.cuda.synchronize()
            seen["loop_s"] = time.perf_counter() - t0
        seen["busy_s"] = sum(
            device_us(e) for e in kernel_rows(prof.key_averages())) / 1e6
        seen.update(trials=trials, ocr=ocr, dcache=kw["dcache"])
        return trials

    runs = []
    clstmocrtrain.train = timed_loop
    CLSTMOCR.train_batch_block = counted_block
    try:
        for i, mode in enumerate(AUTO_TURNS):
            seen.update(rows=0, frames=0)
            reset_counts()
            r = dp_cli(clstmocrtrain, f"auto{i}-{mode}", manifests,
                       dict(AUTO_ENV, t_buckets=mode), tmp, dev)
            launches = counts()
            if min(launches[k] for k in AUTO_COUNTED) < 1:
                raise AssertionError(f"clstmocrtrain t_buckets={mode} "
                                     f"skipped a kernel: {launches}")
            testerr = [float(ln.split()[2]) for ln in r["printed"].splitlines()
                       if ln.startswith("TESTERR ")]
            if not testerr or not all(np.isfinite(testerr)):
                raise AssertionError(f"t_buckets={mode}: no valid TESTERR "
                                     f"line: {testerr}")
            dc = seen.pop("dcache")
            busy = seen["busy_s"] / seen["loop_s"]
            bsz = int(AUTO_ENV["batch_size"])
            # The padded frame-rows of the whole 64-epoch plan the CLI
            # builds over these groups: what the DP's model counts.
            plan_rows = sum(-(-g["n"] * 64 // bsz) * bsz * g["tb"]
                            for g in dc.groups)
            runs.append({
                "mode": mode, "groups": [g["tb"] for g in dc.groups],
                "trials": seen["trials"], "loop_s": seen["loop_s"],
                "lines_per_s": seen["trials"] / seen["loop_s"],
                "idle_share": 1.0 - busy, "busy_s": seen["busy_s"],
                "padded_rows": seen["rows"], "valid_frames": seen["frames"],
                "busy_ns_per_row": seen["busy_s"] / seen["rows"] * 1e9,
                "plan_padded_rows": plan_rows, "testerr": testerr,
                "wall_s": r["wall_s"],
                "launches": {k: launches[k] for k in AUTO_COUNTED}})
            log(f"[auto] (c) turn {i}: t_buckets={mode}, "
                f"{len(dc.groups)} groups {runs[-1]['groups']}; "
                f"{seen['trials']} trials in {seen['loop_s']:.3f} s of loop: "
                f"{runs[-1]['lines_per_s']:.1f} lines/s, the card idle "
                f"{100 * (1 - busy):.1f}% (busy {seen['busy_s']:.3f} s); "
                f"{seen['rows']} padded frame-rows trained, "
                f"{100 * seen['frames'] / seen['rows']:.1f}% of them valid, "
                f"{runs[-1]['busy_ns_per_row']:.1f} ns of card a row; the "
                f"whole 64-epoch plan holds {plan_rows} padded rows; "
                f"TESTERR {testerr}; wall {r['wall_s']:.1f} s with the corpus "
                f"build; launches {runs[-1]['launches']}")
            if mode == "auto":
                auto_dc, auto_ocr = dc, seen["ocr"]
            del dc
            seen.pop("ocr")
    finally:
        clstmocrtrain.train = loop
        CLSTMOCR.train_batch_block = block
    tb = next(g["tb"] for g in sorted(auto_dc.groups, key=lambda g: -g["n"])
              if g["tb"] not in T_BUCKETS_FINE and g["n"] * 64 >= 8 * 32)
    blocks = (bl for bl in auto_dc.epoch_blocks(
        AUTO_HINTS["batch_size"], 4, rng=np.random.RandomState(1), epochs=64)
        if bl["k"] == 4 and bl["group"]["tb"] == tb)
    auto_ocr.train_batch_block(next(blocks))
    torch.cuda.synchronize()
    sleep = torch.cuda.Event(enable_timing=True)
    woke = torch.cuda.Event(enable_timing=True)
    sleep.record()
    torch.cuda._sleep(NOSYNC_CYCLES)
    woke.record()
    t0 = time.perf_counter()
    auto_ocr.train_batch_block(next(blocks))
    nosync_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    sleep_ms = sleep.elapsed_time(woke)
    log(f"[auto] (c) at the auto bucket T={tb}: a k=4 block returned in "
        f"{nosync_ms:.2f} ms behind a {sleep_ms:.1f} ms device sleep")
    if not nosync_ms < 0.5 * sleep_ms:
        raise AssertionError(f"a k=4 block at the auto bucket T={tb} took "
                             f"{nosync_ms:.1f} ms behind a {sleep_ms:.1f} "
                             "ms device sleep: a step waited for the card")
    return {"runs": runs, "nosync": {"tb": tb, "block_ms": nosync_ms,
                                     "sleep_ms": sleep_ms}}


def auto_dp_worker(out: str, manifest: str, mesh=None) -> int:
    """Phase 25 (d) on one of two gloo ranks sharing cuda:0: each rank's
    dispatch measurement forced to AUTO_DP_PENALTIES[rank], the training
    cache built by from_files with t_buckets="auto" and the CLI's hints,
    then a 64-epoch plan of K=64 blocks (plan_guard); every rank's T
    buckets gathered by one all_reduce, which rank 0 writes to ``out``."""
    device_cache.measure_dispatch_penalty_rows = (
        lambda device=None, reps=5: AUTO_DP_PENALTIES[mesh.rank])
    ds = OcrDataset(manifest, target_height=D)
    dc = DeviceDataset.from_files(
        ds.files, ds.texts(), ds.build_codec(), device=mesh.device, mesh=mesh,
        target_height=D, pad=ds.pad, t_buckets="auto", merge_sb=True,
        auto_hints=AUTO_HINTS)
    nblocks = len(list(dc.epoch_blocks(AUTO_HINTS["batch_size"], 64,
                                       rng=np.random.RandomState(0),
                                       epochs=64)))
    tbs = torch.zeros((mesh.size, 32), dtype=torch.int64, device=mesh.device)
    tbs[mesh.rank, :len(dc.groups)] = torch.tensor(
        [g["tb"] for g in dc.groups], device=mesh.device)
    mesh.all_reduce(tbs)
    if mesh.main:
        with open(out, "wb") as f:
            pickle.dump({"tbs": tbs.cpu().numpy(), "blocks": nblocks}, f)
    return 0


def auto_dp(dev, tmp: str, ocr_dir: str, est, s_len) -> dict:
    """Phase 25 (d): auto_dp_worker on two gloo ranks sharing cuda:0. Both
    ranks must hold the groups of rank 0's penalty, which differ from rank
    1's own, and the plan guard must pass."""
    out = os.path.join(tmp, "auto_dp.pkl")
    rc = launch(auto_dp_worker, 2, (out, os.path.join(
        ocr_dir, "train", "manifest.txt")), "cuda:0")
    if rc != 0:
        raise AssertionError(f"the auto ranks returned {rc}")
    with open(out, "rb") as f:
        res = pickle.load(f)
    want = {p: groups_of(est, auto_t_cuts(est, s_lengths=s_len,
                                          dispatch_penalty_rows=p,
                                          **AUTO_HINTS))
            for p in AUTO_DP_PENALTIES}
    got = [[int(v) for v in row if v] for row in res["tbs"]]
    log(f"[auto] (d) mesh=2 (gloo, cuda:0), measured penalties forced to "
        f"{list(AUTO_DP_PENALTIES)}: rank groups {got}; alone rank 0's "
        f"penalty gives {want[AUTO_DP_PENALTIES[0]]}, rank 1's "
        f"{want[AUTO_DP_PENALTIES[1]]}; plan guard passed over "
        f"{res['blocks']} blocks")
    if want[AUTO_DP_PENALTIES[0]] == want[AUTO_DP_PENALTIES[1]]:
        raise AssertionError("the forced penalties give the same cuts: the "
                             "check would not tell the ranks apart")
    if got != [want[AUTO_DP_PENALTIES[0]]] * 2:
        raise AssertionError(f"the ranks built other groups: {got}")
    return {"rank_groups": got, "blocks": res["blocks"]}


def cache_child(compile_cache: str, tmpdir: str) -> subprocess.Popen:
    """CACHE_CHILD in a fresh process with ``compile_cache``, nvcc hidden: a
    PATH without it and CUDA_HOME an empty directory."""
    path = os.pathsep.join(
        d for d in os.environ.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "nvcc")))
    cuda_home = os.path.join(tmpdir, "empty_cuda_home")
    os.makedirs(cuda_home, exist_ok=True)
    child_tmp = os.path.join(tmpdir, "tmp")
    os.makedirs(child_tmp, exist_ok=True)
    env = dict(os.environ, PATH=path, CUDA_HOME=cuda_home,
               compile_cache=compile_cache, TMPDIR=child_tmp)
    return subprocess.Popen(
        [sys.executable, "-c", CACHE_CHILD], env=env, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def cache_runs(tmp: str, build_s: float, warm_dir: str) -> dict:
    """Phase 25 (e): compile_cache in fresh processes with nvcc hidden.
    ``warm_dir``, the directory phase 2 built into, must load the library
    and run one K3 call
    (a warm cache compiles nothing); a new empty directory under
    chiprun_out/ and "off" must fail with "nvcc not found" (the directory
    is honoured), and "off" must leave no directory behind."""
    t0 = time.perf_counter()
    warm = cache_child(warm_dir, os.path.join(tmp, "warm"))
    wout, werr = warm.communicate(timeout=300)
    warm_wall = time.perf_counter() - t0
    first = [ln.split() for ln in wout.splitlines()
             if ln.startswith("FIRST_KERNEL")]
    if warm.returncode != 0 or not first or first[0][2] != "1":
        raise AssertionError(f"the warm compile_cache run failed "
                             f"({warm.returncode}):\n{wout}\n{werr[-4000:]}")
    empty = os.path.join("chiprun_out", "compile_cache_empty")
    shutil.rmtree(empty, ignore_errors=True)
    os.makedirs(empty)
    cold = {name: (cache_child(cc, os.path.join(tmp, name)),
                   os.path.join(tmp, name, "tmp"))
            for name, cc in (("empty", os.path.abspath(empty)),
                             ("off", "off"))}
    fails = {}
    for name, (proc, child_tmp) in cold.items():
        out, err = proc.communicate(timeout=300)
        left = sorted(os.listdir(child_tmp))
        if proc.returncode == 0 or "nvcc not found" not in err:
            raise AssertionError(f"compile_cache={name} with nvcc hidden "
                                 f"did not fail on nvcc ({proc.returncode})"
                                 f":\n{out}\n{err[-4000:]}")
        if any(n.startswith("clstm_kernels_") for n in left):
            raise AssertionError(f"compile_cache={name} left {left} behind")
        fails[name] = {"rc": proc.returncode, "tmp_left": left}
    if os.listdir(empty):
        raise AssertionError(f"the empty compile_cache holds "
                             f"{os.listdir(empty)}")
    out = {"cold_build_s": build_s, "warm_first_kernel_s": float(first[0][1]),
           "warm_wall_s": warm_wall, "failed": fails}
    log(f"[auto] (e) compile_cache with nvcc hidden (PATH without it, "
        f"CUDA_HOME empty): phase 2's directory {warm_dir} loaded the library "
        f"and ran K3 once {out['warm_first_kernel_s']:.2f} s after the "
        f"process started ({warm_wall:.2f} s wall; phase 2's cold build "
        f"{build_s:.2f} s); an empty directory and off failed with "
        f"'nvcc not found' (rc {fails['empty']['rc']}, "
        f"{fails['off']['rc']}), off left nothing in its TMPDIR "
        f"({fails['off']['tmp_left']})")
    return out


def phase25(dev, card: str, ocr_dir: str, build_s: float,
            lib_dir: str) -> dict:
    """Phase 25 (module docstring)."""
    t25 = time.perf_counter()
    marks = [t25]
    out = {"constants": auto_constants(dev, card)}
    with tempfile.TemporaryDirectory() as tmp:
        marks.append(time.perf_counter())
        grp = auto_groups(dev, tmp, ocr_dir,
                          out["constants"]["dispatch_rows"])
        out["groups"] = {k: grp[k] for k in ("cuts", "step_shape",
                                             "step_launches")}
        marks.append(time.perf_counter())
        out["cli"] = auto_turns(dev, tmp, ocr_dir)
        marks.append(time.perf_counter())
        out["dp"] = auto_dp(dev, tmp, ocr_dir, grp["est"], grp["s_len"])
        marks.append(time.perf_counter())
        out["compile_cache"] = cache_runs(tmp, build_s, lib_dir)
        marks.append(time.perf_counter())
    out["seconds"] = marks[-1] - t25
    out["part_seconds"] = dict(zip("abcde", np.diff(marks).tolist()))
    log(f"[auto] {card} | phase 25 passed in {out['seconds']:.1f} s ("
        + ", ".join(f"({k}) {v:.1f}" for k, v in out["part_seconds"].items())
        + ")")
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
                    "first layer, K4 in both modes at its second) and, where "
                    "it has the bf16 mode, its bf16 K1 and K4 state at "
                    "FWD16_SHAPES")
    ap.add_argument("--ctc-against", metavar="SRC",
                    help="also build this CTC DP source (ctc_dp.cu of this or "
                    "the earlier C interface) and time its K5, K6 and K6b in "
                    "turns with the current ones at the bench shape")
    ap.add_argument("--toy-seeds", metavar="N", type=int, default=0,
                    help="also run phase 10's toy task from the inits of "
                    "seeds 1-N in both precisions and log how many lines "
                    "each decodes (a record, not a check)")
    args = ap.parse_args(argv)
    t_start = time.perf_counter()
    t_mark = [t_start]

    def phase_mark(phases: str) -> None:
        """Log the seconds phases took since the last mark (where a run's
        time goes)."""
        now = time.perf_counter()
        log(f"[time] phases {phases}: {now - t_mark[0]:.1f} s (run "
            f"{now - t_start:.1f} s)")
        t_mark[0] = now
    # 1. Device.
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs only on a card")
    dev = torch_device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    # The precision the port takes on the card when none is asked for
    # (models/spec.py::ApplyCtx).
    default_bf16 = ApplyCtx().bf16(torch.empty(0, device=dev))
    log(f"[device] default precision on the card: "
        f"{'bf16 (xz_bf16)' if default_bf16 else 'strict f32'}")
    log(f"[device] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | devices {torch.cuda.device_count()}")

    # 2. Build.
    t0 = time.perf_counter()
    so = _build.build()
    _build.load_library()
    build_s = time.perf_counter() - t0
    log(f"[build] {so.name} in {build_s:.2f} s")
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

    phase_mark("1-2")
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

    phase_mark("3-4")
    # 5. Main path: .clstm save/load, clstmocr's predict_pages and outputs.
    gen = torch.Generator().manual_seed(0)
    spec, net = make_net_init("bidi", {"ninput": D, "nhidden": H,
                                       "noutput": C, "initial": 0.3}, gen)
    codec = Codec([0] + list(range(33, 33 + C - 1)))
    # k/255 pixels, as PNG decoding gives: the card's prepare takes the
    # uint8 upload.
    images = [quantized(synth_line(rng)) for _ in range(N_LINES)]
    # The card's default precision (bf16) both ways, then the other mode
    # (strict f32) with the normalization on the card.
    with tempfile.TemporaryDirectory() as tmp:
        model = os.path.join(tmp, "bidi.clstm")
        save_net(model, net, codec)
        served = {dp: serve(model, images, dev, C, tmp, dp) for dp in (0, 1)}
        served_other = serve(model, images, dev, C, tmp, 1,
                             xz_bf16=not default_bf16)
    for dp, r in [*served.items(), (1, served_other)]:
        n = r["launches"]
        if n["bidi_lstm_infer"] != len(r["buckets"]) or n[
                "bidi_lstm_infer_xz"]:
            raise AssertionError(f"main path (device_preprocess={dp}) "
                                 f"launched {n} for {len(r['buckets'])} "
                                 "buckets: K3 once a bucket")
        # bf16: K3 on the fwd16 kernel in every bucket.
        serving_fwd16(f"main path (device_preprocess={dp})", r,
                      ("bidi_lstm_infer",))
        log(serve_line("main", r, dp))
    # K3's launches on the main path, per mode, and of the bf16 mode's,
    # those of the fwd16 kernel.
    k3_launches = {r["bf16"]: r["launches"]["bidi_lstm_infer"]
                   for r in (served[1], served_other)}
    k3_launches16 = [r["launches16"]["bidi_lstm_infer"]
                     for r in (served[1], served_other) if r["bf16"]][0]

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

    phase_mark("5-8")
    # 9. Training path at full width: 5 train_batch steps, kernels and plain.
    batch = bench_batch(np.random.RandomState(0), dev)
    # The card's default precision, then the other mode, from one start.
    tocr = CLSTMOCR(device="cuda")
    tocr.createBidi(codec, nhidden=H)
    tocr.setLearningRate(1e-4, 0.9)
    train_by_mode, fwd16_by_mode = {}, {}
    for mode in (None, not default_bf16):
        plain = TrainState.create(make_net_init(
            "bidi", {"ninput": D, "nhidden": H, "noutput": C},
            device=dev)[1])
        if mode is None:
            kocr = tocr
        else:
            kocr = CLSTMOCR(device="cuda")
            kocr.createBidi(codec, nhidden=H)
            kocr.setLearningRate(1e-4, 0.9)
            kocr.xz_bf16 = mode
        with torch.no_grad():
            for p, q in zip(plain.net.parameters(), kocr.net.parameters()):
                p.copy_(q)
        got = train_against_plain(kocr, plain, batch, 1e-4, 0.9,
                                  f"train B={B} T={T} S={S81}")
        bf16_run = default_bf16 if mode is None else mode
        fwd16_by_mode[bf16_run] = got16 = counts16()
        # The bf16 steps run K1 on the fwd16 kernel, once a step.
        if bf16_run and got16["bidi_lstm_fwd_state"] != 5:
            raise AssertionError(f"bf16 training launched K1 on the fwd16 "
                                 f"kernel {got16} times in 5 steps ({got})")
        if min(got[f.__name__] for f in (
                bidi_lstm_fwd_state, bidi_lstm_bwd_chain,
                bidi_lstm_bwd_reduce, ctc_forward, ctc_both)) < 1:
            raise AssertionError(f"training path skipped a kernel: {got}")
        train_by_mode[default_bf16 if mode is None else mode] = got
        del plain, kocr
    train_launches = train_by_mode[default_bf16]
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

    # 10. Learning check: the toy CTC transduction on the card, in both
    # modes from the same init and batches. How well it learns in 120 steps
    # depends on the init (seeds 0-3 decode 62, 16, 26 and 64 of 64 lines
    # on CPU): seed 0 is one that learns.
    toy = {m: toy_learning(dev, m) for m in (False, True)}
    for m, (llosses, correct) in toy.items():
        log(f"[learn] toy CTC, {'bf16' if m else 'f32'}, 120 steps: loss "
            f"{llosses[0]:.3f} -> {llosses[-1]:.3f}, {correct}/64 fresh "
            f"lines decoded correctly")
    llosses, correct = toy[default_bf16]
    if not (llosses[-1] < 0.5 * llosses[0] and correct >= 32):
        raise AssertionError("the toy CTC task did not learn on the card")
    # A record, not the rule: its outcome swings with any perturbation of
    # the run (ROADMAP Queue 3); phase 20's glyph corpus decides.
    log(f"[learn] toy CTC: bf16 decodes {toy[True][1]}, f32 {toy[False][1]}"
        f" of 64")
    # With --toy-seeds N: how far the outcome of this 120-step run moves
    # with the init alone, seeds 1-N in both modes (a record, not a limit).
    toy_seeds = {sd: [toy_learning(dev, m, sd)[1] for m in (False, True)]
                 for sd in range(1, args.toy_seeds + 1)}
    if toy_seeds:
        log(f"[learn] toy CTC at seeds 1-{args.toy_seeds}, lines decoded "
            "f32 / bf16: " + ", ".join(f"{sd}: {a} / {b}"
                                       for sd, (a, b) in toy_seeds.items()))

    # 11. Timing at the bench shape.
    Lb, TLb = batch["lengths"], batch["target_lengths"]
    k_step = host_ms(lambda: tocr.train_batch(batch), 5)
    step_modes = mode_turns(tocr, batch, 3, f"bidi B={B} T={T} S={S81}",
                            card)
    step_fwd16 = {"bidi": fwd16_step_turns(tocr, batch, 3,
                                           f"bidi B={B} T={T} S={S81}",
                                           card)}
    # Serving's forward at bench.py's infer profile, K3 on the fwd16 kernel
    # in turns with the FMA kernel.
    predict_fwd16 = {"bidi": predict_turns(tocr.spec, tocr.net, dev, 5,
                                           "bidi", card)}
    # lr 0: the plain step's update leaves the trained net as it is.
    vel0 = TrainState.create(tocr.net).velocity
    p_step = host_ms(lambda: plain_train_step(tocr.net, vel0, batch, 0.0,
                                              0.0), 1)
    log(f"[timing] {card} | train_batch B={B} T={T} S={S81}: kernels "
        f"{k_step:.3f} ms/step ({B / k_step * 1e3:.1f} lines/s), plain "
        f"{p_step:.3f} ms/step ({B / p_step * 1e3:.1f} lines/s)")
    log(f"[timing] {card} | train_batch B={B} T={T} S={S81}: the host "
        f"enqueues a step in "
        f"{enqueue_ms(lambda: tocr.train_batch(batch), 3):.3f} ms")
    steps_vs, k2_steps = {}, {}
    if ctc_against:
        steps_vs["bidi"] = step_turns(tocr, batch, ctc_against, 5,
                                      f"bidi B={B} T={T} S={S81}", card)
    if k2_against and k2_against[2]:
        k2_steps["bidi"] = k2_step_turns(tocr, batch, k2_against, 3,
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
            ms[name] = (time_ms(kf, 10), time_ms(pfn, 1))
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
    prof1 = profile_steps(tocr, batch, card, "profile_train_step.txt",
                          "profile")
    if default_bf16 and not any("fwd16_kernel" in k for k in prof1):
        raise AssertionError(f"the bf16 step's profile names no fwd16 "
                             f"kernel: {sorted(prof1)}")
    del tocr, back, batch

    phase_mark("9-11")
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
        served2_other = serve(model2, images, dev, C2, tmp, 1,
                              xz_bf16=not default_bf16)
    del maker
    for dp, r in [*served2.items(), (1, served2_other)]:
        n, nb2 = r["launches"], len(r["buckets"])
        if not n["bidi_lstm_infer"] == n["bidi_lstm_infer_xz"] == nb2:
            raise AssertionError(f"bidi2 serving (device_preprocess={dp}): "
                                 f"{nb2} buckets, launches {n}: each bucket "
                                 "must launch K3 on layer 1 and K4 on layer 2")
        serving_fwd16(f"bidi2 serving (device_preprocess={dp})", r,
                      ("bidi_lstm_infer", "bidi_lstm_infer_xz"))
        log(serve_line("bidi2 main", r, dp))
    # K4's (and K3's) launches on the bidi2 serving path, per mode.
    served2_by = {r["bf16"]: r for r in (served2[1], served2_other)}

    # 15. bidi2 training at the config-4 bench profile (bench.py:538-600).
    batch2 = bench_batch(np.random.RandomState(0), dev, C2)
    tocr2 = CLSTMOCR(device="cuda")
    tocr2.createBidi(codec2, nhidden=H2, kind="bidi2")
    tocr2.setLearningRate(1e-4, 0.9)
    want2 = {"bidi_lstm_fwd_state": 5, "bidi_lstm_fwd_state_xz": 5,
             "bidi_lstm_bwd_chain": 10, "bidi_lstm_bwd_reduce": 10,
             "ctc_forward": 5, "ctc_both": 5}
    train2_by, fwd16_by_mode2 = {}, {}
    for mode in (None, not default_bf16):
        plain2 = TrainState.create(make_net_init(
            "bidi2", {"ninput": D, "nhidden": H2, "noutput": C2},
            device=dev)[1])
        if mode is None:
            kocr = tocr2
        else:
            kocr = CLSTMOCR(device="cuda")
            kocr.createBidi(codec2, nhidden=H2, kind="bidi2")
            kocr.setLearningRate(1e-4, 0.9)
            kocr.xz_bf16 = mode
        with torch.no_grad():
            for p, q in zip(plain2.net.parameters(), kocr.net.parameters()):
                p.copy_(q)
        got = train_against_plain(kocr, plain2, batch2, 1e-4, 0.9,
                                  f"train bidi2 B={B} T={T} S={S81} C={C2}")
        bf16_run = default_bf16 if mode is None else mode
        fwd16_by_mode2[bf16_run] = got16 = counts16()
        # The bf16 steps run K1 (layer 1) and K4's state mode (layer 2) on
        # the fwd16 kernel, each once a step.
        if bf16_run and {k: v for k, v in got16.items() if v} != {
                "bidi_lstm_fwd_state": 5, "bidi_lstm_fwd_state_xz": 5}:
            raise AssertionError(f"bidi2 bf16 training launched the fwd16 "
                                 f"kernel {got16} times in 5 steps")
        if {k: v for k, v in got.items() if v} != want2:
            raise AssertionError(f"bidi2 training launches {got}, want "
                                 f"{want2}: K1 and K4 once a step, K2 on "
                                 f"both layers, K5 and K6")
        train2_by[default_bf16 if mode is None else mode] = got
        del plain2, kocr
    train2 = train2_by[False]
    k_step2 = host_ms(lambda: tocr2.train_batch(batch2), 5)
    vel2 = TrainState.create(tocr2.net).velocity
    p_step2 = host_ms(lambda: plain_train_step(tocr2.net, vel2, batch2, 0.0,
                                               0.0), 1)
    log(f"[timing] {card} | bidi2 train_batch B={B} T={T} S={S81} C={C2}: "
        f"kernels {k_step2:.3f} ms/step ({B / k_step2 * 1e3:.1f} lines/s), "
        f"plain {p_step2:.3f} ms/step ({B / p_step2 * 1e3:.1f} lines/s)")
    log(f"[timing] {card} | bidi2 train_batch: the host enqueues a step in "
        f"{enqueue_ms(lambda: tocr2.train_batch(batch2), 3):.3f} ms")
    step2_modes = mode_turns(tocr2, batch2, 2,
                             f"bidi2 B={B} T={T} S={S81} C={C2}", card)
    step_fwd16["bidi2"] = fwd16_step_turns(
        tocr2, batch2, 2, f"bidi2 B={B} T={T} S={S81} C={C2}", card)
    predict_fwd16["bidi2"] = predict_turns(tocr2.spec, tocr2.net, dev, 3,
                                           "bidi2", card)
    if ctc_against:
        steps_vs["bidi2"] = step_turns(tocr2, batch2, ctc_against, 3,
                                       f"bidi2 B={B} T={T} S={S81} C={C2}",
                                       card)
    if k2_against and k2_against[2]:
        k2_steps["bidi2"] = k2_step_turns(
            tocr2, batch2, k2_against, 2, f"bidi2 B={B} T={T} S={S81} C={C2}",
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
    prof2 = profile_steps(tocr2, batch2, card,
                          "profile_train_step_bidi2.txt", "profile bidi2")
    if default_bf16 and sum("fwd16_kernel" in k for k in prof2) < 2:
        raise AssertionError(f"the bidi2 bf16 step's profile names fewer "
                             f"than two fwd16 kernels (K1, K4 state): "
                             f"{sorted(prof2)}")

    del tocr2, batch2

    phase_mark("12-15")
    # 16. The u8 pixel table on the card.
    check_u8(dev, np.random.RandomState(4))

    # 17. clstmocrtrain at full bidi width on a synthetic corpus (kept for
    # phase 23).
    ocr_dir = tempfile.TemporaryDirectory()
    trained = ocrtrain(dev, ocr_dir.name)
    if not trained["pil"]:
        raise AssertionError("phase 23 trains clstmocrtrain on phase 17's "
                             "PNG corpus, which needs pillow")

    phase_mark("16-17")
    # 18-19. The bf16 kernels against their plain versions and float64, and
    # timed in turns with their f32 modes.
    b16 = bf16_kernels(dev, card)
    # K2's bf16 reduction at its four shapes, in turns with the einsums
    # and, with --k2-against, with that build's.
    k2_16 = k2_bf16_turns(dev, card, k2_against)
    # K2's bf16 chain across its plan's edges, then at its three shapes in
    # turns with the branch its plan did not take and, with --k2-against,
    # that build's chain.
    t18 = time.perf_counter()
    chain_edges = chain16_edges(dev)
    chain_16 = chain16_turns(dev, card, k2_against)
    log(f"[chain16] edges and turns in {time.perf_counter() - t18:.1f} s")
    # K3, K1 and K4 (both modes) on the fwd16 kernel across its plan's
    # edges, the planted controls at bidi2's layers, then K1 and K4 state
    # at their five shapes and K3 and K4 inference at theirs, each in turns
    # with the FMA kernel and cuDNN.
    t18 = time.perf_counter()
    f16_edges = fwd16_edges(dev)
    f16_planted = fwd16_bench_planted(dev)
    f16_turns = fwd16_turns(dev, card, fwd_against)
    f16_infer = fwd16_turns(dev, card, fwd_against, state=False)
    log(f"[fwd16] edges, planted controls and turns in "
        f"{time.perf_counter() - t18:.1f} s")

    phase_mark("18-19")
    # 20. The learning check of the bf16 mode against f32 on the glyph
    # corpus: it decides the card's default precision.
    learn = ocr_learning(dev)
    for seed, r in learn["seeds"].items():
        for m in ("f32", "bf16"):
            if m in r:
                log(f"[learn] glyph corpus, init {seed}, {m}: test CER by "
                    "step " + ", ".join(f"{i}: {c:.4f}" for i, c in r[m])
                    + f" ({r[m + '_s']:.1f} s)")
        if r["verdict"] == "void":
            log(f"[learn] init {seed}: the f32 CER did not halve within "
                f"{LEARN_MAX_S:.0f} s: the check is void")
            continue
        n = r["steps"]
        log(f"[learn] init {seed}: CER halved at step {r['halved']['f32']} "
            f"(f32), {r['halved']['bf16']} (bf16; at most N + "
            f"{LEARN_STEP_SLACK}); CER at 2N={2 * n} f32 "
            f"{r['cer_at_2n']['f32']:.4f}, bf16 {r['cer_at_2n']['bf16']:.4f} "
            f"(bf16 at most f32 + {LEARN_SLACK:g}): {r['verdict']}; the "
            f"earlier single point, CER at N={n}: f32 "
            f"{r['cer_at_n']['f32']:.4f}, bf16 {r['cer_at_n']['bf16']:.4f}: "
            f"{r['single_point']}")
    verdict = learn["verdict"]
    learned = verdict == "pass"
    log(f"[learn] the bf16 mode {'passes' if learned else 'does not pass'} "
        f"the learning check at inits {list(LEARN_SEEDS)} ({verdict}); the "
        f"toy task is a record ({toy[True][1]} / {toy[False][1]} lines, "
        f"bf16 / f32); the card's default is "
        f"{'bf16' if default_bf16 else 'f32'}")
    if default_bf16 and not learned:
        raise AssertionError("bf16 is the card's default but did not pass "
                             "the learning check")

    phase_mark("20")
    # 21. The filter path at full width: the g2p corpus, its kernels
    # against plain at the path's shapes (and K4 at a large alphabet), 5
    # steps against plain in both modes, clstmfiltertrain and clstmfilter.
    # 22. Whether the native I/O library built.
    train_pairs, test_pairs = g2p_corpus()
    icodec = Codec.build(a for a, _ in train_pairs)
    fcodec = Codec.build(b for _, b in train_pairs)
    fcache = TextDeviceDataset(train_pairs, icodec, fcodec,
                               input_repeat=FILTER_REPEAT, device=dev)
    fk = filter_kernels(dev, card, fcache, fcodec.size())
    with tempfile.TemporaryDirectory() as tmp:
        start = os.path.join(tmp, "start.clstm")
        maker = CLSTMText(input_repeat=FILTER_REPEAT, device=dev)
        maker.createBidi(icodec, fcodec, H, seed=0)
        maker.save(start)
        fsteps = filter_steps(dev, fcache, start, float(FILTER_ENV["lrate"]),
                              default_bf16)
        ftrain = filtertrain(dev, card, tmp, train_pairs, test_pairs,
                             k2_against)
        fserve = filter_serve(dev, ftrain["model"],
                              [a for a, _ in test_pairs])
        nat = native_check(dev, tmp)
    del fcache, maker

    phase_mark("21-22")
    # 23. Data parallelism: (a) one NCCL rank, (b) two gloo ranks sharing
    # the card against one rank, (c) both trainer CLIs with mesh=2.
    t23 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dp = {"nccl": dp_nccl(dev, tmp),
              "gloo": dp_gloo(dev, tmp, default_bf16),
              "halves": dp_halves(dev),
              "clis": dp_clis(dev, tmp, ocr_dir.name, train_pairs,
                              test_pairs, default_bf16)}
    dp["seconds"] = time.perf_counter() - t23
    log(f"[dp] phase 23 passed in {dp['seconds']:.1f} s")

    phase_mark("23")
    # 24. The routes with no LSTM kernel (compute_dtype, fuse_bidi=False),
    # the trace and the meter, clstmocrtrain with display_every.
    p24 = phase24(dev, card, ocr_dir.name)

    phase_mark("24")
    # 25. t_buckets=auto: the cost constants on the card, the cuts on
    # phase 17's corpus and the kernels at one, clstmocrtrain auto and fine
    # in turns, the ranks' agreement under mesh=2; compile_cache.
    p25 = phase25(dev, card, ocr_dir.name, build_s, str(so.parent))
    ocr_dir.cleanup()

    phase_mark("25")
    # 18. Report. bound_ms from this run's shapes and valid frames (lengths
    # 900 at both bench shapes); library_ms a library call timed in turns
    # with the kernel above, or None where no one call computes the same
    # function.
    S81_bytes = 4 * B * T * S81
    entries = [
        ("bidi_lstm_fwd (K3)", "clstm_tpu_torch/csrc/bidi_lstm_fwd.cu",
         "clstm_tpu/ops/pallas_lstm.py:197", k3_launches[False],
         max(errs.values()),
         None, (k_ms, p_ms), lstm_bound("fwd", B, T, D, H, V900), k3_lib_ms),
        ("bidi_lstm_fwd_state (K1)", "clstm_tpu_torch/csrc/bidi_lstm_fwd.cu",
         "clstm_tpu/ops/pallas_lstm.py:197",
         train_by_mode[False]["bidi_lstm_fwd_state"], k1_err, None, ms["K1"],
         lstm_bound("fwd_state", B, T, D, H, V900), lib["K1"]),
        ("bidi_lstm_bwd_chain (K2)", "clstm_tpu_torch/csrc/bidi_lstm_bwd.cu",
         "clstm_tpu/ops/pallas_lstm.py:299",
         train_by_mode[False]["bidi_lstm_bwd_chain"], k2["chain_abs"],
         k2["chain_rel"], ms["K2 chain"],
         lstm_bound("chain", B, T, D, H, V900), None),
        ("bidi_lstm_bwd_reduce (K2)", "clstm_tpu_torch/csrc/bidi_lstm_bwd.cu",
         "clstm_tpu/ops/pallas_lstm.py:299",
         train_by_mode[False]["bidi_lstm_bwd_reduce"], k2["red_abs"],
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
         "clstm_tpu/ops/pallas_lstm.py:197",
         served2_by[False]["launches"]["bidi_lstm_infer_xz"],
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
    # The bf16 mode's rows: launches from the main paths run in that mode
    # (K3 on clstmocr, K4 on bidi2's; K1, K4 state and K2 in the training
    # steps), max_abs_err the largest |kernel - plain bf16| of phase 18,
    # the times of phase 19 (bench shapes, lengths 900).
    bm = b16["ms"]
    fma = {"K1": f16_turns["bidi K1"],
           "K4 state": f16_turns["bidi2 layer 2 K4 state"],
           "K3": f16_infer["bidi K3"], "K4": f16_infer["bidi2 layer 2 K4"]}
    fwd_src = "clstm_tpu_torch/csrc/bidi_lstm_fwd.cu"
    bwd_src = "clstm_tpu_torch/csrc/bidi_lstm_bwd.cu"
    for name, src, rep, n, err, key in (
            ("bidi_lstm_fwd bf16 (K3)", fwd_src,
             "clstm_tpu/ops/pallas_lstm.py:197",
             k3_launches[True] - k3_launches16, b16["fwd_err"], "K3"),
            ("bidi_lstm_fwd_state bf16 (K1)", fwd_src,
             "clstm_tpu/ops/pallas_lstm.py:197",
             train_by_mode[True]["bidi_lstm_fwd_state"]
             - fwd16_by_mode[True]["bidi_lstm_fwd_state"], b16["fwd_err"],
             "K1"),
            ("bidi_lstm_fwd_xz bf16 (K4)", fwd_src,
             "clstm_tpu/ops/pallas_lstm.py:197",
             served2_by[True]["launches"]["bidi_lstm_infer_xz"]
             - served2_by[True]["launches16"]["bidi_lstm_infer_xz"],
             b16["fwd_err"], "K4"),
            ("bidi_lstm_fwd_xz_state bf16 (K4)", fwd_src,
             "clstm_tpu/ops/pallas_lstm.py:197",
             train2_by[True]["bidi_lstm_fwd_state_xz"]
             - fwd16_by_mode2[True]["bidi_lstm_fwd_state_xz"],
             b16["fwd_err"], "K4 state"),
            ("bidi_lstm_bwd_chain bf16 (K2)", bwd_src,
             "clstm_tpu/ops/pallas_lstm.py:299",
             train_by_mode[True]["bidi_lstm_bwd_chain"], b16["chain_err"],
             "K2 chain"),
            ("bidi_lstm_bwd_reduce bf16 (K2)", bwd_src,
             "clstm_tpu/ops/pallas_lstm.py:299",
             train_by_mode[True]["bidi_lstm_bwd_reduce"], b16["red_err"],
             "K2 reduction")):
        m = bm[key]
        if key in fma:
            # The FMA kernel, which the bf16 K3, K1 and K4 now take only
            # outside fwd16_plan: its time in turns with the fwd16 kernel.
            m = dict(m, ms=mean(fma[key]["fma_ms"]))
        entries.append((name, src, rep, n, err, None,
                        (m["ms"], m["plain_ms"]), m["bound"],
                        m.get("library_ms")))
    # The fwd16 kernel (K1 and K4's state mode in the bf16 mode on the
    # tensor cores): launches of the bf16 training steps (phases 9, 15), the
    # times of phase 19 at bidi's K1 and bidi2's K4 state, its largest
    # |kernel - plain bf16| of phase 18 (the bench shapes and its edges);
    # its inference instances (K3, K4): launches of the bf16 clstmocr runs
    # (phases 5, 14), the times of phase 19 at bidi's K3 and bidi2's K4.
    for name, label, n, r, e16 in (
            ("bidi_lstm_fwd16_state bf16 (K1)", "bidi K1",
             fwd16_by_mode[True]["bidi_lstm_fwd_state"],
             f16_turns["bidi K1"], f16_edges["err"]),
            ("bidi_lstm_fwd16_xz_state bf16 (K4)", "bidi2 layer 2 K4 state",
             fwd16_by_mode2[True]["bidi_lstm_fwd_state_xz"],
             f16_turns["bidi2 layer 2 K4 state"], f16_edges["err"]),
            ("bidi_lstm_fwd16 bf16 (K3)", "bidi K3", k3_launches16,
             f16_infer["bidi K3"], f16_edges["infer_err"]),
            ("bidi_lstm_fwd16_xz bf16 (K4)", "bidi2 layer 2 K4",
             served2_by[True]["launches16"]["bidi_lstm_infer_xz"],
             f16_infer["bidi2 layer 2 K4"], f16_edges["infer_err"])):
        entries.append((name, fwd_src, "clstm_tpu/ops/pallas_lstm.py:197", n,
                        max(b16["fwd_err"], e16), None,
                        (mean(r["ms"]), r["plain_ms"]), r["bound"],
                        mean(r["library_ms"])))
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
    def clstmocr_runs(bf16: bool, runs) -> dict:
        return {f"{'bidi2 ' if two else ''}device_preprocess={dp}": dict(
            lines_per_s=N_LINES / r["e2e_s"],
            lines_per_s_range=[N_LINES / r["e2e_range"][1],
                               N_LINES / r["e2e_range"][0]],
            cold_lines_per_s=N_LINES / r["cold_s"],
            launches=r["launches"]["bidi_lstm_infer"],
            launches16=r["launches16"],
            **({"prepare_span_ms": r["prep_ms"],
                "prepare_host_ms": r["prep_host_ms"],
                "prepare_busy_ms": r["prep_busy_ms"],
                "prepare_share": r["prep_share"]} if dp else {}))
            for two, dp, r in runs if r["bf16"] == bf16}
    serve_runs = [(False, dp, r) for dp, r in served.items()]
    serve_runs += [(False, 1, served_other)]
    serve_runs += [(True, dp, r) for dp, r in served2.items()]
    serve_runs += [(True, 1, served2_other)]
    extra["bidi_lstm_fwd (K3)"]["clstmocr"] = clstmocr_runs(False,
                                                            serve_runs)
    for name, key in (("bidi_lstm_fwd_state (K1)", "bidi_lstm_fwd_state"),
                      ("bidi_lstm_bwd_chain (K2)", "bidi_lstm_bwd_chain"),
                      ("bidi_lstm_bwd_reduce (K2)", "bidi_lstm_bwd_reduce"),
                      ("ctc_forward (K5)", "ctc_forward"),
                      ("ctc_both (K6)", "ctc_both")):
        extra.setdefault(name, {})["clstmocrtrain_launches"] = \
            trained["launches"].get(key, 0)
    for name, key, more in (
            ("bidi_lstm_fwd bf16 (K3)", "K3",
             {"plan": b16["plans"]["bidi inference"],
              "bidi2_layer1_plan": b16["plans"]["bidi2 layer 1 inference"],
              "clstmocr": clstmocr_runs(True, serve_runs)}),
            ("bidi_lstm_fwd_state bf16 (K1)", "K1",
             {"plan": b16["plans"]["bidi state"],
              "bidi2_layer1_plan": b16["plans"]["bidi2 layer 1 state"]}),
            ("bidi_lstm_fwd_xz bf16 (K4)", "K4",
             {"plan": b16["plans"]["bidi2 layer 2 inference"],
              "hoisted_product_ms": bm["hoisted product"]["ms"],
              "hoisted_product_f32_ms": bm["hoisted product"]["f32_ms"]}),
            ("bidi_lstm_fwd_xz_state bf16 (K4)", "K4 state",
             {"plan": b16["plans"]["bidi2 layer 2 state"]}),
            ("bidi_lstm_bwd_chain bf16 (K2)", "K2 chain",
             {"bidi2_layer2": dict(zip(
                 ("ms", "f32_ms", "plain_ms", "bound_ms", "bound_by"),
                 (bm["K2 chain H=200"]["ms"],
                  bm["K2 chain H=200"]["f32_ms"],
                  bm["K2 chain H=200"]["plain_ms"],
                  *bm["K2 chain H=200"]["bound"])))}),
            ("bidi_lstm_bwd_reduce bf16 (K2)", "K2 reduction",
             {"bidi2_layer2_dx": dict(zip(
                 ("ms", "f32_ms", "plain_ms", "library_ms", "bound_ms",
                  "bound_by"),
                 (bm["K2 reduction with dx"]["ms"],
                  bm["K2 reduction with dx"]["f32_ms"],
                  bm["K2 reduction with dx"]["plain_ms"],
                  bm["K2 reduction with dx"]["library_ms"],
                  *bm["K2 reduction with dx"]["bound"])))})):
        extra[name] = dict(more, f32_mode_ms=bm[key]["f32_ms"],
                           in_turns_f32_bf16=bm[key]["turns"],
                           **({"hoisted_total_ms":
                               bm[key]["hoisted_total_ms"]}
                              if "hoisted_total_ms" in bm[key] else {}))
    extra["bidi_lstm_fwd_state bf16 (K1)"]["f64_rel"] = {
        k: v for k, v in b16["dist"].items()
        if k.startswith(("K1", "K3", "K4"))}
    # The FMA kernel's bf16 rows: the bf16 times of phase 19's f32/bf16
    # turns were the fwd16 kernel's (the wrapper's plan), so they move to
    # its rows (and the bf16 clstmocr runs to its K3 row); these carry their
    # turns with it.
    for name, turns_, hoisted, new in (
            ("bidi_lstm_fwd_state bf16 (K1)", f16_turns, False,
             "bidi_lstm_fwd16_state bf16 (K1)"),
            ("bidi_lstm_fwd_xz_state bf16 (K4)", f16_turns, True,
             "bidi_lstm_fwd16_xz_state bf16 (K4)"),
            ("bidi_lstm_fwd bf16 (K3)", f16_infer, False,
             "bidi_lstm_fwd16 bf16 (K3)"),
            ("bidi_lstm_fwd_xz bf16 (K4)", f16_infer, True,
             "bidi_lstm_fwd16_xz bf16 (K4)")):
        extra[new] = {k: extra[name].pop(k) for k in (
            "f32_mode_ms", "in_turns_f32_bf16", "hoisted_total_ms",
            "clstmocr") if k in extra[name]}
        extra[name]["in_turns_with_fwd16"] = {
            k: {"fma_ms": v["fma_ms"], "fwd16_ms": v["ms"],
                "fma_plan": v["fma_plan"]} for k, v in turns_.items()
            if ("K4" in k) == hoisted}
    infer_edges = sum(k.startswith(("K3 ", "K4 B")) for k in f16_edges["dist"])
    extra["bidi_lstm_fwd16_state bf16 (K1)"].update(
        plan=f16_turns["bidi K1"]["plan"], shapes={
            k: v for k, v in f16_turns.items() if "K4" not in k},
        edge_cases_passed=len(f16_edges["dist"]) - infer_edges,
        planted=f16_planted, train_step_ms=step_fwd16)
    extra["bidi_lstm_fwd16_xz_state bf16 (K4)"].update(
        plan=f16_turns["bidi2 layer 2 K4 state"]["plan"],
        shapes={k: v for k, v in f16_turns.items() if "K4" in k})
    extra["bidi_lstm_fwd16 bf16 (K3)"].update(
        plan=f16_infer["bidi K3"]["plan"], shapes={
            k: v for k, v in f16_infer.items() if "K4" not in k},
        edge_cases_passed=infer_edges, planted=f16_planted,
        predict_ms=predict_fwd16)
    extra["bidi_lstm_fwd16_xz bf16 (K4)"].update(
        plan=f16_infer["bidi2 layer 2 K4"]["plan"],
        shapes={k: v for k, v in f16_infer.items() if "K4" in k},
        bidi2_launches16=served2_by[True]["launches16"])
    extra["bidi_lstm_bwd_chain bf16 (K2)"]["f64_rel"] = b16["dist"].get(
        "K2 dz")
    extra["bidi_lstm_bwd_reduce bf16 (K2)"]["f64_rel"] = {
        k: b16["dist"][k] for k in ("K2 dW", "K2 dx") if k in b16["dist"]}
    extra["bidi_lstm_bwd_reduce bf16 (K2)"]["shapes"] = k2_16
    # The bf16 chain's plan (chain_plan) at the bench shape, its times at
    # its three shapes in turns with the branch its plan did not take (and
    # --k2-against's chain), and how many edge cases it passed.
    extra["bidi_lstm_bwd_chain bf16 (K2)"].update(
        plan=chain_16["bidi"]["plan"], shapes=chain_16,
        edge_cases_passed=len(chain_edges))
    if k2_steps or "k2_against_pairs_per_s" in ftrain:
        extra["bidi_lstm_bwd_reduce bf16 (K2)"]["k2_against_steps"] = dict(
            k2_steps, clstmfiltertrain_pairs_per_s=ftrain.get(
                "k2_against_pairs_per_s"))
    extra["bidi_lstm_fwd_state bf16 (K1)"]["train_step_ms"] = {
        "bidi": step_modes, "bidi2": step2_modes}
    extra["bidi_lstm_fwd_state bf16 (K1)"]["learning"] = {
        "toy_decoded_of_64": {("bf16" if m else "f32"): v[1]
                              for m, v in toy.items()},
        "toy_seeds_f32_bf16": toy_seeds,
        "glyph_corpus": learn, "default_bf16": default_bf16}
    # The filter path (phase 21): each kernel's launches per training step
    # and in the clstmfiltertrain run, its time, plain time, bound and
    # library call at the path's T=32 shape (B=256, D=19, H=100; K4 at the
    # large alphabet), its largest |kernel - plain| there.
    fsteps_f32 = fsteps[(32, False)]
    for name, key, count in (
            ("bidi_lstm_fwd (K3)", "K3", "bidi_lstm_infer"),
            ("bidi_lstm_fwd_state (K1)", "K1", "bidi_lstm_fwd_state"),
            ("bidi_lstm_bwd_chain (K2)", "K2 chain", "bidi_lstm_bwd_chain"),
            ("bidi_lstm_bwd_reduce (K2)", "K2 reduction",
             "bidi_lstm_bwd_reduce"),
            ("ctc_forward (K5)", "K5", "ctc_forward"),
            ("ctc_both (K6)", "K6", "ctc_both"),
            ("bidi_lstm_fwd_xz (K4)", "K4", "bidi_lstm_infer_xz")):
        km, pm, (bms, bby), lms = fk["timing"][key]
        extra.setdefault(name, {})["filter"] = {
            "shape": fk["shapes"]["large alphabet" if key == "K4" else 32],
            "launches_per_step": fsteps_f32.get(count, 0) // 5,
            "clstmfiltertrain_launches": ftrain["launches"].get(count, 0),
            "clstmfilter_launches": fserve["launches"].get(count, 0),
            "ms": km, "plain_ms": pm, "bound_ms": bms, "bound_by": bby,
            "library_ms": lms, "max_abs_err": fk["err"][key]}
    fsteps_bf16 = fsteps[(32, True)]
    for name, key, count in (
            ("bidi_lstm_fwd bf16 (K3)", "K3", "bidi_lstm_infer"),
            ("bidi_lstm_fwd_state bf16 (K1)", "K1", "bidi_lstm_fwd_state"),
            ("bidi_lstm_bwd_chain bf16 (K2)", "K2 chain",
             "bidi_lstm_bwd_chain"),
            ("bidi_lstm_bwd_reduce bf16 (K2)", "K2 reduction",
             "bidi_lstm_bwd_reduce"),
            ("bidi_lstm_fwd_xz bf16 (K4)", "K4", "bidi_lstm_infer_xz")):
        m = fk["bf16"][key]
        extra[name]["filter"] = {
            "shape": fk["shapes"]["large alphabet" if key == "K4" else 32],
            "launches_per_step": fsteps_bf16.get(count, 0) // 5,
            "ms": m["ms"], "f32_ms": m["f32_ms"],
            "in_turns_f32_bf16": m["in_turns_f32_bf16"],
            "bound_ms": m["bound"][0], "bound_by": m["bound"][1],
            "library_ms": m.get("library_ms"),
            **({"hoisted_total_ms": m["hoisted_total_ms"]}
               if "hoisted_total_ms" in m else {})}
    extra["bidi_lstm_fwd (K3)"]["filter"]["clstmfilter"] = {
        k: fserve[k] for k in ("batches", "lines_per_s",
                               "lines_per_s_single", "launches_single")}
    extra["bidi_lstm_fwd_xz (K4)"]["filter"]["in_turns_k4_route_k3"] = \
        fk["big_k3_k4_ms"]
    extra["bidi_lstm_fwd_xz (K4)"]["filter"]["in_turns_total_cudnn"] = \
        fk["big_k4_total_ms"]
    extra["bidi_lstm_fwd_state (K1)"]["filter"]["clstmfiltertrain"] = {
        k: ftrain[k] for k in ("testerr", "pairs_per_s", "pairs_per_s_range",
                               "busy_share", "block_enqueue_ms", "block_k",
                               "cache_mb", "groups", "in_turns")}
    extra["bidi_lstm_fwd_state (K1)"]["native_io"] = nat
    # The data-parallel path (phase 23 b): each kernel's launches a step on
    # each of the two ranks, by net and precision, beside the step's ms and
    # the gloo all_reduce's; K1's row also carries (a) and (c).
    dp_rows = {"bidi_lstm_fwd_state": "bidi_lstm_fwd_state{} (K1)",
               "bidi_lstm_fwd_state_xz": "bidi_lstm_fwd_xz_state{} (K4)",
               "bidi_lstm_bwd_chain": "bidi_lstm_bwd_chain{} (K2)",
               "bidi_lstm_bwd_reduce": "bidi_lstm_bwd_reduce{} (K2)",
               "ctc_forward": "ctc_forward (K5)", "ctc_both": "ctc_both (K6)"}
    for (net_kind, bf16), r in dp["gloo"].items():
        tag = f"{net_kind} {'bf16' if bf16 else 'f32'}"
        for key, row in dp_rows.items():
            extra.setdefault(row.format(" bf16" if bf16 else ""), {}
                             ).setdefault("dp", {})[tag] = {
                "launches_per_step_per_rank": [
                    lp.get(key, 0) for lp in r["launches_per_step"]],
                "step_ms": r["step_ms"],
                "gloo_all_reduce_ms": r["all_reduce_ms"],
                "buffer_floats": r["buffer_floats"]}
    extra["bidi_lstm_fwd_state (K1)"]["dp_nccl_one_rank"] = dp["nccl"]
    extra["bidi_lstm_fwd_state (K1)"]["dp_halves_grad_rel"] = dp["halves"]
    extra["bidi_lstm_fwd_state (K1)"]["dp_clis"] = dict(
        dp["clis"], label=DP_LABEL, phase_seconds=dp["seconds"])
    # Phase 24: each kernel's launches a step on the routes that run none
    # of the LSTM kernels (K5 and K6 still once a step), in both modes'
    # rows; K1's row also carries the phase's checks and times.
    for name, key in (("bidi_lstm_fwd{} (K3)", "bidi_lstm_infer"),
                      ("bidi_lstm_fwd_state{} (K1)", "bidi_lstm_fwd_state"),
                      ("bidi_lstm_fwd_xz{} (K4)", "bidi_lstm_infer_xz"),
                      ("bidi_lstm_fwd_xz_state{} (K4)",
                       "bidi_lstm_fwd_state_xz"),
                      ("bidi_lstm_bwd_chain{} (K2)", "bidi_lstm_bwd_chain"),
                      ("bidi_lstm_bwd_reduce{} (K2)", "bidi_lstm_bwd_reduce"),
                      ("ctc_forward (K5)", "ctc_forward"),
                      ("ctc_both (K6)", "ctc_both"),
                      ("ctc_backward (K6b)", "ctc_backward")):
        for mode in {"", " bf16"} if "{}" in name else {""}:
            extra.setdefault(name.format(mode), {})[
                "launches_per_step_no_kernel_routes"] = {
                "compute_dtype": p24["cd_launches"][key] / CD_STEPS,
                "fuse_bidi_false": p24["unfused_launches"][key] / CD_STEPS}
    extra["bidi_lstm_fwd_state (K1)"]["phase24"] = {
        k: v for k, v in p24.items()
        if k not in ("cd_launches", "unfused_launches")}
    # Phase 25: each kernel's launches in the clstmocrtrain runs with
    # t_buckets=auto and fine, and in the one step at an auto cut; K1's row
    # also carries the phase's cuts, constants, rates and compile_cache.
    for name, key in (("bidi_lstm_fwd (K3)", "bidi_lstm_infer"),
                      ("bidi_lstm_fwd_state (K1)", "bidi_lstm_fwd_state"),
                      ("bidi_lstm_bwd_chain (K2)", "bidi_lstm_bwd_chain"),
                      ("bidi_lstm_bwd_reduce (K2)", "bidi_lstm_bwd_reduce"),
                      ("ctc_forward (K5)", "ctc_forward"),
                      ("ctc_both (K6)", "ctc_both")):
        extra.setdefault(name, {})["t_buckets"] = {
            "cli_launches": [[r["mode"], r["launches"][key]]
                             for r in p25["cli"]["runs"]],
            "auto_step_launches": p25["groups"]["step_launches"].get(key),
            "auto_step_shape": p25["groups"]["step_shape"]}
    extra["bidi_lstm_fwd_state (K1)"]["phase25"] = {
        k: p25[k] for k in ("constants", "compile_cache", "dp", "seconds",
                             "part_seconds")}
    extra["bidi_lstm_fwd_state (K1)"]["phase25"].update(
        cuts=p25["groups"]["cuts"], cli=p25["cli"])
    kernels = []
    for name, src, rep, n, err, rel, (km, pm), (bms, bby), lms in entries:
        e = {"name": name, "route": "cuda", "source": src, "replaces": rep,
             "launches": n, "max_abs_err": err, "ms": km, "plain_ms": pm,
             "bound_ms": bms, "bound_by": bby, "library_ms": lms}
        if rel is not None:
            e["max_rel_err"] = rel
        e.update(extra.get(name, {}))
        kernels.append(e)
    log(f"[done] every phase passed in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
