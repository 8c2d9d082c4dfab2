"""Bidirectional LSTM kernels: wrappers of ``csrc/bidi_lstm_fwd.cu`` and
``csrc/bidi_lstm_bwd.cu``, and the autograd entry point of training.

  bidi_lstm_infer       K3, replaces clstm_tpu/ops/pallas_lstm.py::
                        _fwd_kernel with emit_state=False (serving); it
                        sends a layer where ``hoists_projection`` holds to
                        K4 instead;
  bidi_lstm_fwd_state   K1, the same TPU kernel with emit_state=True: the
                        forward that also writes what the backward reads;
  bidi_lstm_infer_xz, bidi_lstm_fwd_state_xz
                        K4, the same TPU kernel with proj_in=True, in both
                        modes: the recurrence on the hoisted projection
                        (ops/lstm.py::hoisted_projection);
  fwd_plan              how those four split a layer over thread-block
                        clusters (device_plan: on this card);
  fwd16_plan            how the four run in the bf16 mode on the tensor
                        cores (device_fwd16_plan: on this card; the FMA
                        kernel at fwd_plan where it gives none);
  bidi_lstm_bwd_chain   K2's backward chain, replaces pallas_lstm.py::
                        _bwd_kernel (L391-430); in the bf16 mode on
                        thread-block clusters, Dh on bf16 tensor cores;
  chain_plan            how the chain splits a call (device_chain_plan:
                        on this card);
  bidi_lstm_bwd_reduce  K2's contractions dW, dWh and dx (the TPU kernel's
                        own body, L440-463), written by hand as well, on
                        the tensor cores in 3xTF32 (f32-accurate), and in
                        the bf16 mode on bf16 wgmma fed by TMA;
  reduce_plan           how the bf16 reduction splits its tiles and frames
                        (device_reduce_plan: on this card);
  bidi_lstm_train       a torch.autograd.Function: K1 (or the hoisted
                        projection and K4) forward, K2 backward (the custom
                        VJP of bidi_lstm_pallas).

Their plain versions are in ops/lstm.py (bidi_lstm_apply and the ``_plain``
functions). On CPU tensors each wrapper runs its plain version; on CUDA
tensors it launches its kernel or raises, and never falls back.

Each wrapper takes ``xz_bf16``, the JAX package's production mode
(pallas_lstm.py, ``xz_bf16=True``): the streams (x or xz, y, gates, cell,
gy, dz, dx) are bf16 and so are the weights the kernels read, every
product accumulates in f32, the gate math, carries and backward chain stay
f32, and the weight gradients come out f32 (the rounding points:
ops/lstm.py). A bf16 call launches the kernels' bf16 instances; it never
runs in f32 in their place.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from clstm_tpu_torch.ops.lstm import (
    bidi_lstm_apply, bidi_lstm_apply_xz, bidi_lstm_bwd_chain_plain,
    bidi_lstm_bwd_reduce_plain, bidi_lstm_fwd_state_plain,
    bidi_lstm_fwd_state_xz_plain, hoisted_projection)
from clstm_tpu_torch.utils.profiling import span

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argument types (pointers, ints, stream); all return int.
_SIGNATURES = {
    "clstm_bidi_lstm_fwd": [_P] * 5 + [_I] * 8 + [_P],
    "clstm_bidi_lstm_fwd_state": [_P] * 7 + [_I] * 8 + [_P],
    "clstm_bidi_lstm_fwd_xz": [_P] * 4 + [_I] * 7 + [_P],
    "clstm_bidi_lstm_fwd_xz_state": [_P] * 6 + [_I] * 7 + [_P],
    "clstm_bidi_lstm_fwd_smem": [_I] * 7,
    "clstm_bidi_lstm_fwd_clusters": [_I] * 8,
    "clstm_bidi_lstm_bwd_hp": [_I],
    "clstm_bidi_lstm_bwd_chain": [_P] * 6 + [_I] * 3 + [_P],
    "clstm_bidi_lstm_bwd_scratch": [_I] * 4,
    "clstm_bidi_lstm_bwd_reduce": [_P] * 7 + [_I] * 4 + [_P],
    # The bf16 mode's instances: the same arguments, bf16 streams and
    # weights; the reduction also takes whether dx is bf16.
    "clstm_bidi_lstm_fwd_bf16": [_P] * 5 + [_I] * 8 + [_P],
    "clstm_bidi_lstm_fwd_state_bf16": [_P] * 7 + [_I] * 8 + [_P],
    "clstm_bidi_lstm_fwd_xz_bf16": [_P] * 4 + [_I] * 7 + [_P],
    "clstm_bidi_lstm_fwd_xz_state_bf16": [_P] * 6 + [_I] * 7 + [_P],
    "clstm_bidi_lstm_fwd_bf16_smem": [_I] * 7,
    "clstm_bidi_lstm_fwd_bf16_clusters": [_I] * 8,
    "clstm_bidi_lstm_bwd_chain_bf16": [_P] * 6 + [_I] * 3 + [_P],
    # The bf16 reduction: x, whether x is bf16 (and dx then bf16), y, dz,
    # wx (f32), scratch, dw, dx; B, T, D, H and the plan (nw, tt, spr, nwd).
    "clstm_bidi_lstm_bwd_reduce_bf16": [_P, _I] + [_P] * 6 + [_I] * 8 + [_P],
    "clstm_bidi_lstm_bwd_bf16_scratch": [_I] * 6,
    # The bf16 chain on clusters: lengths, gates, cell, gy, Wh (bf16), dz;
    # B, T, H and the plan (C, rows, units, ksplit).
    "clstm_bidi_lstm_bwd_chain16": [_P] * 6 + [_I] * 7 + [_P],
    "clstm_bidi_lstm_bwd_chain16_smem": [_I] * 5,
    "clstm_bidi_lstm_bwd_chain16_clusters": [_I] * 5,
    # K1 and K4's state mode in the bf16 mode on the tensor cores: x (or
    # xz), lengths, [wx,] wh, y, gates, cell; B, T, [D,] H and the plan (C,
    # rows, units); K3 and K4 inference the same without gates and cell.
    # The plan's queries take (D, H, hoist, emit, C, rows, units).
    "clstm_bidi_lstm_fwd16_state": [_P] * 7 + [_I] * 7 + [_P],
    "clstm_bidi_lstm_fwd16_xz_state": [_P] * 6 + [_I] * 6 + [_P],
    "clstm_bidi_lstm_fwd16": [_P] * 5 + [_I] * 7 + [_P],
    "clstm_bidi_lstm_fwd16_xz": [_P] * 4 + [_I] * 6 + [_P],
    "clstm_bidi_lstm_fwd16_smem": [_I] * 7,
    "clstm_bidi_lstm_fwd16_clusters": [_I] * 7,
}
# Entry points that return a 64-bit count instead of a CUDA error.
_LONG = {"clstm_bidi_lstm_bwd_scratch", "clstm_bidi_lstm_fwd_smem",
         "clstm_bidi_lstm_fwd_bf16_smem", "clstm_bidi_lstm_bwd_bf16_scratch",
         "clstm_bidi_lstm_bwd_chain16_smem", "clstm_bidi_lstm_fwd16_smem"}
_fns: dict = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from clstm_tpu_torch.ops._build import load_library

        fn = getattr(load_library(), name)
        fn.argtypes = _SIGNATURES[name]
        fn.restype = ctypes.c_longlong if name in _LONG else ctypes.c_int
        _fns[name] = fn
    return fn


def _launch(name: str, device, *args) -> None:
    """Call a C entry point on the current stream of ``device``; raise on
    the CUDA error it returns."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = _kernel(name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _ptr(t: Optional[torch.Tensor]) -> int:
    return 0 if t is None else t.data_ptr()


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it if its data does not start on 16 bytes (the
    backward kernels stage it in 16-byte copies)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_tensor(name: str, t: torch.Tensor, shape, device,
                  dtype=torch.float32) -> None:
    if (tuple(t.shape) != tuple(shape) or t.dtype != dtype
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous {dtype} "
                         f"{tuple(shape)} tensor on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _stream_dtype(bf16: bool) -> torch.dtype:
    return torch.bfloat16 if bf16 else torch.float32


def _check_lengths(lengths: Optional[torch.Tensor], B: int, device) -> None:
    if lengths is not None and (
            lengths.shape != (B,) or lengths.dtype != torch.int32
            or lengths.device != device or not lengths.is_contiguous()):
        raise ValueError(f"lengths must be a contiguous int32 [{B}] tensor "
                         f"on {device}, got {lengths.dtype} "
                         f"{tuple(lengths.shape)} on {lengths.device}")


def _check_device(device) -> None:
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")


def _check(params_f: dict, params_r: dict, x: torch.Tensor,
           lengths: Optional[torch.Tensor], bf16: bool = False) -> None:
    """Raise on anything the forward kernels do not take: x float32, or in
    the bf16 mode float32 or bfloat16 (the output of a bf16 layer); the
    weights float32 in both modes."""
    ok = (torch.float32, torch.bfloat16) if bf16 else (torch.float32,)
    if x.dim() != 3 or x.dtype not in ok or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [B, T, D] tensor of "
                         f"{' or '.join(map(str, ok))}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    _check_device(x.device)
    B, T, D = x.shape
    H = params_f["Wh"].shape[0]
    want = {"Wx": (D, 4 * H), "Wh": (H, 4 * H), "b": (4 * H,)}
    for p in (params_f, params_r):
        for name, shape in want.items():
            w = p[name]
            if (tuple(w.shape) != shape or w.dtype != torch.float32
                    or w.device != x.device):
                raise ValueError(
                    f"{name} must be float32 {shape} on {x.device}, got "
                    f"{w.dtype} {tuple(w.shape)} on {w.device}")
    _check_lengths(lengths, B, x.device)


def _check_xz(params_f: dict, params_r: dict, xz: torch.Tensor,
              lengths: Optional[torch.Tensor], bf16: bool = False) -> None:
    """Raise on anything K4 does not take: xz float32, bfloat16 (the
    rounded product) in the bf16 mode."""
    dt = _stream_dtype(bf16)
    if (xz.dim() != 4 or xz.shape[2] != 2 or xz.dtype != dt
            or not xz.is_contiguous()):
        raise ValueError(f"xz must be a contiguous [B, T, 2, 4H] {dt} "
                         f"tensor, got {xz.dtype} {tuple(xz.shape)}")
    _check_device(xz.device)
    H = params_f["Wh"].shape[0]
    if xz.shape[3] != 4 * H:
        raise ValueError(f"xz has {xz.shape[3]} gate columns, Wh has {H} "
                         f"units")
    for p in (params_f, params_r):
        w = p["Wh"]
        if (tuple(w.shape) != (H, 4 * H) or w.dtype != torch.float32
                or w.device != xz.device):
            raise ValueError(f"Wh must be float32 {(H, 4 * H)} on "
                             f"{xz.device}, got {w.dtype} {tuple(w.shape)} "
                             f"on {w.device}")
    _check_lengths(lengths, xz.shape[0], xz.device)


def _mode(bf16: bool) -> dict:
    """The plain versions' keyword for the bf16 mode (none for f32)."""
    return {"xz_bf16": True} if bf16 else {}


def _stack(params_f: dict, params_r: dict, name: str) -> torch.Tensor:
    return torch.stack([params_f[name], params_r[name]]).detach().contiguous()


def hoists_projection(D: int, H: int) -> bool:
    """Whether a bidi layer of input width D and H units runs on a hoisted
    input projection (K4) instead of computing it inside the recurrence
    (K3, K1): D + 1 > ceil(H / 128)·128.

    This is the JAX package's rule (clstm_tpu/ops/pallas_lstm.py:836,
    ``dc > hp``), where 128 is the TPU's lane padding of H. The port keeps
    it so that the same layers take K4 in both packages (the second layer
    of ``bidi2``); whether the rule also picks the faster kernel on the card
    is measured in PERF.md §6.
    """
    return D + 1 > -(-H // 128) * 128


# The forward kernel's limits (csrc/bidi_lstm_fwd.cu): rows of a register
# tile (a cluster's rows are a multiple of them), threads and dynamic
# shared memory per CTA, cluster sizes (the portable ones), and the most
# rows one cluster takes.
FWD_RT = 4
FWD_THREADS = 512
SMEM_MAX = 232_448
CLUSTER_SIZES = (1, 2, 4, 8)
FWD_ROWS_MAX = 64
# Rows of a cluster past which the L2 plan prefers fewer CTAs per cluster
# to more rows.
FWD_L2_ROWS = 16
# Clusters of C CTAs, one CTA per SM, that an H100 SXM holds at once
# (cudaOccupancyMaxActiveClusters on an NVIDIA H100 80GB HBM3: the GPCs,
# not the 132 SMs, set them). fwd_plan's default where no card is asked.
H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 8: 15}


class FwdPlan(NamedTuple):
    """How the forward kernel splits a bidi layer: each direction's chain
    for a group of ``rows`` rows runs on a cluster of ``C`` CTAs; CTA c owns
    units [c·units, min(H, (c+1)·units)) with their four gate columns, in
    register tiles of one unit and 4 rows. ``resident`` 1: each CTA
    holds its weight slice in shared memory for the whole chain; 2: only
    its slice of Wh, and reads that of [Wx; b] from L2 at every step; 0:
    it reads both from L2. ``groups`` row groups per direction;
    ``clusters``: how many clusters of this plan the card holds at once
    (one wave when 2·groups <= clusters)."""
    C: int
    rows: int
    units: int
    resident: int
    threads: int
    smem: int
    groups: int
    clusters: int


def fwd_smem(D: int, H: int, rows: int, units: int, hoist: bool,
             resident: int, esize: int = 4) -> int:
    """Bytes of shared memory a CTA takes: the resident weights [H (+ D+1
    where ``resident`` is 1), units, 4] of ``esize`` bytes (4 f32, 2 bf16)
    rounded up to 16 bytes, h [2, H, rows] (f32 in both modes), the x ring
    [3, D, rows] of ``esize`` bytes (without the hoisted projection) and
    the row lengths (csrc/bidi_lstm_fwd.cu::smem_bytes)."""
    w = ((H + (0 if hoist or resident == 2 else D + 1)) * 4 * units
         if resident else 0)
    return (-(-esize * w // 16) * 16 + 4 * 2 * H * rows
            + (0 if hoist else esize * 3 * rows * D) + 4 * rows)


def fwd_threads(rows: int, units: int) -> int:
    """Threads of a CTA: two per tile (a unit's 4 gates for 4 rows), 16
    tiles to a warp."""
    return -(-units * (rows // FWD_RT) // 16) * 32


def fwd_plan(B: int, D: int, H: int, hoist: bool, state: bool,
             clusters=None, esize: int = 4) -> FwdPlan:
    """The forward kernel's plan for a layer of input width D (unused with
    ``hoist``: K4) and H units at batch B; ``state``: K1 or K4's state
    mode (the kernel instance whose occupancy ``clusters`` gives).

    The smallest C in CLUSTER_SIZES whose weight slice (Wh, and [Wx; b]
    without ``hoist``; else, where 4·(D+1) <= H, Wh's alone) fits in a CTA's
    shared memory with the rest at rows per cluster that let the clusters
    of both directions run in one wave (a multiple of 4, at most
    FWD_ROWS_MAX). Where no C does, the L2 plan: the weights read from L2,
    rows cut to what fits, at the C (that gives every CTA a unit) whose
    clusters run in one wave, with rows up to FWD_L2_ROWS, and then the
    smallest.
    ``clusters(C, resident, rows, units)`` gives how many clusters of a
    plan the card holds at once: on a card the kernel's occupancy query
    (``device_plan``), by default H100_CLUSTERS. ``esize`` is the bytes of
    a weight and stream element: 4, or 2 in the bf16 mode, where half the
    bytes may keep more resident at a smaller C (D is then even: the
    wrapper pads an odd input). Raises ValueError for a shape no plan
    takes (H above ~4096, or an input too wide for the x ring)."""
    if min(B, H) < 1 or (not hoist and D < 1):
        raise ValueError(f"no forward plan for B={B} D={D} H={H}")
    if clusters is None:
        def clusters(C, resident, rows, units):
            return H100_CLUSTERS[C]

    def rows_for(active: int) -> int:
        groups = max(1, active // 2)
        rows = -(-(-(-B // groups)) // FWD_RT) * FWD_RT
        return min(rows, FWD_ROWS_MAX)

    def fits(resident, rows, units) -> bool:
        return (fwd_threads(rows, units) <= FWD_THREADS and
                fwd_smem(D, H, rows, units, hoist, resident, esize)
                <= SMEM_MAX)

    def made(C, resident, rows, units) -> FwdPlan:
        return FwdPlan(C, rows, units, resident, fwd_threads(rows, units),
                       fwd_smem(D, H, rows, units, hoist, resident, esize),
                       -(-B // rows), int(clusters(C, resident, rows, units)))

    # Wh's slice alone resident, [Wx; b] read from L2 at every step, only
    # where [Wx; b] is at most a quarter of Wh: on the card it beat the
    # whole slice at the next cluster size at bidi2's first layer (D+1 =
    # 49, H = 200), and lost to the whole slice at bidi's (H = 100), where
    # those reads are twice the share (chip_smoke.py times both choices in
    # turns; PERF.md §6).
    wh_alone = not hoist and 4 * (D + 1) <= H
    for C in CLUSTER_SIZES:
        units = -(-H // C)
        if (C - 1) * units >= H:
            continue
        for resident in (1, 2) if wh_alone else (1,):
            rows = rows_for(H100_CLUSTERS[C])
            if not fits(resident, rows, units):
                continue
            # Rows from the card's own count at that plan: one wave, or the
            # next plan.
            p = made(C, resident, rows, units)
            if rows_for(p.clusters) != rows:
                rows = rows_for(p.clusters)
                if not fits(resident, rows, units):
                    continue
                p = made(C, resident, rows, units)
            return p
    # The L2 plan, per C the most rows that fit; of those, one wave first,
    # then rows up to FWD_L2_ROWS (each weight read from L2 feeds that many
    # rows), then the smaller C (fewer CTAs to hand h to: on the card C=4
    # with 20 rows beat C=8 with 40 at bidi2's widths, PERF.md §6).
    best, key = None, None
    for C in CLUSTER_SIZES:
        units = -(-H // C)
        if (C - 1) * units >= H:
            continue
        rows = rows_for(H100_CLUSTERS[C])
        while rows >= FWD_RT and not fits(0, rows, units):
            rows -= FWD_RT
        if rows < FWD_RT:
            continue
        p = made(C, 0, rows, units)
        k = (2 * p.groups <= p.clusters, min(rows, FWD_L2_ROWS), -C)
        if key is None or k > key:
            best, key = p, k
    if best:
        return best
    raise ValueError(f"no forward plan for B={B} D={D} H={H}: the h buffer "
                     f"or the x ring exceeds a CTA's shared memory")


# The bf16 mode's K3, K1 and K4 (both modes) on the tensor cores
# (csrc/bidi_lstm_fwd.cu: fwd16_kernel): rows of an m16 tile (a cluster
# takes one or two), threads of a CTA, the multiple of units a CTA owns (its
# h goes to its peers in 16-byte chunks of 8 units), the cluster sizes, and
# the shared memory a CTA may use beside its row lengths.
FWD16_M = 16
FWD16_ROWS = (16, 32)
FWD16_THREADS = 640
FWD16_WARPS = FWD16_THREADS // 32
FWD16_UNITS = 8
FWD16_CLUSTER_SIZES = (1, 2, 3, 4, 8)
FWD16_SMEM_MAX = SMEM_MAX - 4 * 2 * FWD16_M
# Where the FMA kernel (bidi_lstm_fwd_kernel at fwd_plan: h·Wh on the FMA
# pipes) beats the tensor-core kernel although a plan of it fits, read from
# the card with full and ragged lengths (scripts/torch_fwd16_probe.py
# --t-sweep; PERF.md §6): K1 and K4's state mode at B=256, K3 and K4
# inference at B=256 and 64 (a clstmocr bucket), which put their
# crossovers at the same chain lengths. Chains of at most FWD16_OLD_LONG_T
# frames at H <= FWD16_OLD_LONG_H (the filter's T=16 and 32 buckets at
# H=100), and of at most FWD16_OLD_SHORT_T at H <= FWD16_OLD_SHORT_H. The
# tensor-core kernel's step is a fixed latency chain; the FMA kernel's
# costs less at these sizes, where the host's enqueue of a call is as long
# as the card's work.
FWD16_OLD_LONG_T = 32
FWD16_OLD_LONG_H = 100
FWD16_OLD_SHORT_T = 16
FWD16_OLD_SHORT_H = 200


class Fwd16Plan(NamedTuple):
    """How the bf16 tensor-core kernel runs K3, K1 or K4 (either mode): each
    direction's chain for a group of ``rows`` rows (16 or 32: one or two
    m16 tiles) runs on a cluster of ``C`` CTAs; CTA c owns units [c·units,
    min(H, (c+1)·units)) with their four gate columns and keeps its columns
    of Wh (and of [Wx; b] for K1) in shared memory for the whole chain; z
    runs on bf16 mma.sync, the gate math on the accumulator fragments, and
    h goes to every CTA in 16-byte chunks (an all-gather) with one cluster
    barrier a step. ``smem``: bytes of shared memory a CTA takes;
    ``groups`` row groups per direction; ``clusters``: how many clusters of
    the plan the card holds at once (one wave when 2·groups <= clusters).
    C 0 (FWD16_NONE): the FMA kernel runs the call (fwd_plan)."""
    C: int
    rows: int
    units: int
    smem: int
    groups: int
    clusters: int


FWD16_NONE = Fwd16Plan(0, 0, 0, 0, 0, 0)


def fwd16_geometry(D: int, H: int, rows: int, units: int, hoist: bool, *,
                   state: bool) -> dict:
    """The shared-memory layout of a fwd16 CTA (csrc::geo16), in bytes: bw
    its columns of Wh and of [Wx; b] [N = 4·units][KH + KX + 8] bf16 (KH =
    H up to 16, KX = D+1 up to 16 or 0 with ``hoist``, k contiguous), ah
    the h operand [2][rows][KH + 8], ax the x ring [3][rows][KX + 8] or
    with ``hoist`` the xz ring [3][rows][4][units], and the output stage of
    each parity: gs the gates [2][rows][4·units + 2] f32 (rows 4·units + 2
    words apart, for its banks), hs h and cs c [2][rows][units] bf16. D is
    the kernel's x width (even). Without ``state`` (K3, K4 inference) gs
    and cs are 0: the stage holds h alone."""
    N, KH = 4 * units, _up(H, 16)
    KX = 0 if hoist else _up(D + 1, 16)
    g = {"N": N, "KH": KH, "KX": KX, "bw": N * (KH + KX + 8) * 2,
         "ah": 2 * rows * (KH + 8) * 2,
         "ax": 3 * rows * (4 * units if hoist else KX + 8) * 2,
         "gs": 2 * rows * (4 * units + 2) * 4 if state else 0,
         "hs": 2 * rows * units * 2,
         "cs": 2 * rows * units * 2 if state else 0}
    g["bytes"] = sum(g[k] for k in ("bw", "ah", "ax", "gs", "hs", "cs"))
    return g


def fwd16_ng(rows: int) -> int:
    """n tiles a warp takes at most (csrc::f16_ng): 2 at 16 rows, 1 at
    32."""
    return 2 if rows == FWD16_M else 1


def fwd16_smem(D: int, H: int, rows: int, units: int, hoist: bool,
               C: int, *, state: bool) -> int:
    """Bytes of dynamic shared memory a fwd16 CTA takes, 0 where the kernel
    takes no such plan (clstm_bidi_lstm_fwd16_smem counts the same): C in
    FWD16_CLUSTER_SIZES with every CTA owning a unit, rows in FWD16_ROWS,
    units a multiple of FWD16_UNITS whose n tiles (units/2) the warps take
    at most fwd16_ng each, D even (0 with ``hoist``), within
    FWD16_SMEM_MAX; ``state`` as fwd16_geometry."""
    if (C not in FWD16_CLUSTER_SIZES or rows not in FWD16_ROWS or H < 1
            or units < FWD16_UNITS or units % FWD16_UNITS
            or C * units < H or (C - 1) * units >= H
            or units // 2 > FWD16_WARPS * fwd16_ng(rows)
            or (not hoist and (D < 2 or D % 2))):
        return 0
    g = fwd16_geometry(D, H, rows, units, hoist, state=state)
    return g["bytes"] if g["bytes"] <= FWD16_SMEM_MAX else 0


def fwd16_units(H: int, C: int) -> int:
    """Units a CTA owns at cluster size C: ceil(H / C) rounded up to a
    multiple of FWD16_UNITS (the last CTA owns the rest); 0 where that
    leaves a CTA without a unit."""
    units = _up(-(-H // C), FWD16_UNITS)
    return units if (C - 1) * units < H else 0


def fwd16_prefers_old(T: int, H: int) -> bool:
    """Whether a chain of T frames and H units takes the FMA kernel although
    a fwd16 plan fits, in either mode: where that kernel was the faster on
    the card (FWD16_OLD_*)."""
    return ((T <= FWD16_OLD_LONG_T and H <= FWD16_OLD_LONG_H)
            or (T <= FWD16_OLD_SHORT_T and H <= FWD16_OLD_SHORT_H))


def fwd16_cluster_plan(B: int, D: int, H: int, hoist: bool, clusters=None,
                       *, state: bool, C: Optional[int] = None,
                       rows: Optional[int] = None) -> Fwd16Plan:
    """The fwd16 plan for a batch of B rows, x width D (the kernel's, even;
    unused with ``hoist``: K4) and H units; ``state``: K1 or K4's state
    mode, else K3 or K4 inference (whose CTA keeps no gates or cell stage).

    Of the plans that fit (C in FWD16_CLUSTER_SIZES, rows in FWD16_ROWS,
    fwd16_units, fwd16_smem), the one of fewest waves (2·groups over the
    clusters the card holds at once), then of least work a CTA and step
    (rows·units: its share of the product and of the gate math), then the
    smaller C (fewer CTAs to hand h to), then fewer rows: at B=256, H=100
    and 200, C=3 with 16 rows (32 clusters of 3 in one wave on an H100,
    which holds 39 of 3 and 30 of 4). FWD16_NONE where none fits.
    ``clusters(C, rows, units)`` gives how many clusters of a plan the
    card holds at once: on a card the occupancy query of the mode's
    instance (``fwd16_clusters``), by default H100_CLUSTERS. ``C`` and
    ``rows`` force a choice, for measurements (scripts/torch_fwd16_probe.py
    times the plans in turns)."""
    if min(B, H) < 1:
        raise ValueError(f"no fwd16 plan for B={B} H={H}")
    if clusters is None:
        def clusters(C, rows, units):
            return H100_CLUSTERS[C]
    d = 0 if hoist else D
    best, key = None, None
    for c in FWD16_CLUSTER_SIZES if C is None else (C,):
        units = fwd16_units(H, c)
        if not units:
            continue
        for r in FWD16_ROWS if rows is None else (rows,):
            smem = fwd16_smem(d, H, r, units, hoist, c, state=state)
            if not smem:
                continue
            groups = -(-B // r)
            n = int(clusters(c, r, units))
            k = (-(-2 * groups // n), r * units, c, r)
            if key is None or k < key:
                best, key = Fwd16Plan(c, r, units, smem, groups, n), k
    return best or FWD16_NONE


def fwd16_plan(B: int, T: int, D: int, H: int, hoist: bool,
               clusters=None, *, state: bool) -> Fwd16Plan:
    """The bf16 K1 (K4's state mode with ``hoist``; without ``state`` K3,
    or K4 inference with ``hoist``) plan for B rows of T frames, x width D
    (the kernel's, even) and H units: the cluster plan of
    fwd16_cluster_plan, or FWD16_NONE (the FMA kernel, fwd_plan) where none
    fits (H of several hundred with the x part, 700, 2048) or
    fwd16_prefers_old."""
    if min(B, T, H) < 1:
        raise ValueError(f"no fwd16 plan for B={B} T={T} H={H}")
    if fwd16_prefers_old(T, H):
        return FWD16_NONE
    return fwd16_cluster_plan(B, D, H, hoist, clusters, state=state)


def fwd16_weights(params_f: dict, params_r: dict, with_x: bool):
    """The fwd16 kernel's weights, both directions, bf16 and k contiguous:
    (wx [2, 4H, D'+1], row 4·u + g the column of gate g of unit u over the
    rows of Wx then b (an odd D gets a zero row before b, D' = D rounded up
    to even, as fwd_weights), or None; wh [2, 4H, H], the same rows of
    Wh)."""
    wx, wh = fwd_weights(params_f, params_r, with_x, True)

    def cols(w):       # [2, K, H, 4] -> [2, 4H, K]
        return w.flatten(2).transpose(1, 2).contiguous()
    return (cols(wx) if with_x else None), cols(wh)


def interleave_gates(w: torch.Tensor) -> torch.Tensor:
    """[..., 4H] in gate blocks (gi, gf, go, ci) -> [..., H, 4]: a unit's
    four gate columns side by side, the layout the forward kernel reads."""
    *lead, G = w.shape
    return w.reshape(*lead, 4, G // 4).transpose(-1, -2).contiguous()


def fwd_weights(params_f: dict, params_r: dict, with_x: bool,
                bf16: bool = False):
    """The forward kernel's weights, both directions: (wx [2, D+1, H, 4],
    the rows of Wx then b, or None; wh [2, H, H, 4]). With ``bf16`` both
    are rounded to bfloat16, and an odd D gets a zero row before b (the
    kernel's x stream is then padded to an even D, ``_x_bf16``)."""
    dt = _stream_dtype(bf16)
    wh = interleave_gates(_stack(params_f, params_r, "Wh")).to(dt)
    if not with_x:
        return None, wh
    rows = [_stack(params_f, params_r, "Wx")]
    if bf16 and rows[0].shape[1] % 2:
        rows.append(rows[0].new_zeros((2, 1, rows[0].shape[2])))
    rows.append(_stack(params_f, params_r, "b")[:, None])
    return interleave_gates(torch.cat(rows, 1)).to(dt).contiguous(), wh


def _x_bf16(x: torch.Tensor) -> torch.Tensor:
    """The bf16 forward kernel's x stream: x rounded to bfloat16, an odd D
    padded with a zero column (the kernel stages x in pairs of columns)."""
    x = x.to(torch.bfloat16)
    return (F.pad(x, (0, 1)) if x.shape[-1] % 2 else x).contiguous()


# K2's bf16 reduction (csrc/bidi_lstm_bwd.cu: bwd_dw_bf16_kernel,
# bwd_dx_bf16_kernel): the widths of its wgmma tiles (gate columns of dW,
# columns d of dx), the frames of a slice (one stage of its ring), the
# slices of fill a block pays before its first product (the cost model's),
# the SMs of an H100 SXM (reduce_plan's default where no card is asked),
# and the most bytes of dW partials a plan may take.
RED_WIDTHS = (64, 128, 200)
RED_SLICE = 64
RED_FILL = 4
H100_SMS = 132
RED_PARTIALS_MAX = 1 << 28


class ReducePlan(NamedTuple):
    """How the bf16 reduction splits a call. dW: tiles of ``nw`` gate
    columns, a block per pair of 64-row tiles of [x | 1 | 0..] and h_prev
    (one per warpgroup), column tile, direction and frame range. A slice is
    ``tt`` frames along T by 64/tt rows along B; a range is ``spr``
    consecutive slices (rows of T-slices, then rows of B), ``ranges`` of
    them, each summed into its own partial buffer (none with one range),
    ``blocks`` dW blocks in all. dx: tiles of 128 frames by ``nwd`` columns
    d. ``scratch``: bytes of the staged copies and the partials
    (reduce_scratch)."""
    nw: int
    tt: int
    spr: int
    ranges: int
    blocks: int
    nwd: int
    scratch: int


def tile_width(n: int) -> int:
    """The tile width of RED_WIDTHS for n columns: the fewest columns
    computed, then the widest tile."""
    return min(RED_WIDTHS, key=lambda w: (-(-n // w) * w, -w))


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def reduce_slices(B: int, T: int, tt: int) -> int:
    """Slices of a [B, T] batch: ceil(T / tt) along T times ceil(B / bb)
    along B, bb = RED_SLICE / tt."""
    return -(-T // tt) * -(-B // (RED_SLICE // tt))


def reduce_scratch(B: int, T: int, D: int, H: int, tt: int, spr: int) -> int:
    """Bytes of the bf16 reduction's scratch at a plan (the layout of
    csrc::red16; clstm_bidi_lstm_bwd_bf16_scratch counts the same): x
    staged as [x | 1 | 0..] in bf16 [B·T, roundup(D+1, 64)] and y per
    direction in bf16 [B·T, 2, roundup(H, 64)] (whole tiles: a TMA box
    that a row's end cuts is slower); dz per direction [B·T, 2,
    roundup(4H, 8)] where H is odd (a TMA box starts on a 16-byte boundary,
    and the reverse direction's gates start at 4H); wx in bf16 [2, D,
    roundup(4H, 64)]; and with more than one frame range the f32 dW
    partials [ranges, 2, D+1+H, 4H]; each 256-byte aligned."""
    N, G, M = B * T, 4 * H, D + 1 + H
    ranges = -(-reduce_slices(B, T, tt) // spr)
    return (_up(2 * N * _up(D + 1, 64), 256)
            + _up(2 * N * 2 * _up(H, 64), 256)
            + (_up(2 * N * 2 * _up(G, 8), 256) if H % 2 else 0)
            + _up(2 * 2 * D * _up(G, 64), 256)
            + (4 * ranges * 2 * M * G if ranges > 1 else 0))


@functools.lru_cache(maxsize=None)
def reduce_plan(B: int, T: int, D: int, H: int,
                sms: int = H100_SMS) -> ReducePlan:
    """The bf16 reduction's plan for x [B, T, D] and H units on a card of
    ``sms`` SMs (a dW block takes one SM: its ring is ~200 KB).

    ``tt``: T rounded up to a power of two, at most RED_SLICE, so that a
    slice stays within its rows and wastes least of T. ``nw``, ``nwd``:
    tile_width of 4H and of D. The frame ranges: of the splits into
    ``spr`` slices a range, the one of least modelled time, in slices of
    one block: whole waves of blocks (ceil(blocks / sms)) times spr +
    RED_FILL, plus the partials' bytes (written and read back by the sum)
    spread over the card at a block's rate of staging; ties to fewer
    ranges, and no more than RED_PARTIALS_MAX bytes of partials. So the
    blocks fill whole waves where the slices allow: at the filter's shape
    (B=256, T=32, D=19, H=100) 16 ranges of 512 frames, 128 blocks."""
    if min(B, T, D, H) < 1:
        raise ValueError(f"no reduction plan for B={B} T={T} D={D} H={H}")
    G, M = 4 * H, D + 1 + H
    nw, nwd = tile_width(G), tile_width(D)
    tt = min(RED_SLICE, 1 << (T - 1).bit_length())
    S = reduce_slices(B, T, tt)
    row_tiles = -(-(D + 1) // 64) + -(-H // 64)
    tiles = 2 * -(-row_tiles // 2) * -(-G // nw)
    slice_bytes = (2 + -(-nw // 64)) * RED_SLICE * 128
    part = 4 * 2 * M * G
    best = None
    for R in range(1, min(S, 8 * sms) + 1):
        spr = -(-S // R)
        ranges = -(-S // spr)
        if ranges != R:
            continue  # the split of a smaller R
        if ranges > 1 and ranges * part > RED_PARTIALS_MAX:
            break
        cost = (-(-tiles * ranges // sms) * (spr + RED_FILL)
                + (2 * ranges * part / (sms * slice_bytes)
                   if ranges > 1 else 0.0))
        if best is None or cost < best[0]:
            best = (cost, spr, ranges)
    _, spr, ranges = best
    return ReducePlan(nw, tt, spr, ranges, tiles * ranges, nwd,
                      reduce_scratch(B, T, D, H, tt, spr))


_sms: dict = {}


def device_reduce_plan(device, B: int, T: int, D: int,
                       H: int) -> ReducePlan:
    """reduce_plan on ``device``'s card (its SM count, asked once; an
    H100's elsewhere)."""
    sms = H100_SMS
    if device.type == "cuda":
        sms = _sms.get(device)
        if sms is None:
            sms = _sms[device] = torch.cuda.get_device_properties(
                device).multi_processor_count
    return reduce_plan(B, T, D, H, sms)


def staged_x(x: torch.Tensor) -> torch.Tensor:
    """x [B, T, D] as the bf16 reduction stages it (csrc::
    bwd_stage_kernel): [x | 1 | 0..] in bf16 [B, T, roundup(D+1, 64)], x
    rounded to bf16, column D the bias's ones. The kernel's dW rows 0..D
    are this copy's columns, so the bias row needs no case of its own."""
    B, T, D = x.shape
    xp = torch.zeros((B, T, _up(D + 1, 64)), dtype=torch.bfloat16,
                     device=x.device)
    xp[..., :D] = x
    xp[..., D] = 1.0
    return xp


# K2's bf16 chain on thread-block clusters (csrc/bidi_lstm_bwd.cu:
# bwd_chain16_kernel): rows of an m16 tile (a cluster takes one or two),
# threads of a CTA, the units of a row a thread takes (a quad), and the
# shared memory a CTA may use beside its row lengths.
CHAIN_M = 16
CHAIN_ROWS = (16, 32)
CHAIN_THREADS = 512
CHAIN_QUAD = 4
CHAIN_SMEM_MAX = SMEM_MAX - 4 * 2 * CHAIN_M
# Cluster sizes of the chain: with 16 rows a cluster, B=256 takes 32
# clusters, which an H100 holds of 3 CTAs but not of 4 (H100_CLUSTERS).
CHAIN_CLUSTER_SIZES = (1, 2, 3, 4, 8)
# Where the L2 branch (which keeps WhT in a block's shared memory up to
# H=143) beats a cluster plan on the card, at B=256 with a bucket's ragged
# lengths (PERF.md §6; scripts/torch_k2_chain_probe.py --t-sweep): chains
# of CHAIN_L2_MIN_T frames or more at H <= CHAIN_L2_LONG_H, and of up to
# CHAIN_L2_MAX_T frames at H <= CHAIN_L2_SHORT_H (the filter's T=32,
# H=100). Below CHAIN_L2_MIN_T frames a cluster plan wins at every width.
CHAIN_L2_MIN_T = 16
CHAIN_L2_MAX_T = 64
CHAIN_L2_LONG_H = 80
CHAIN_L2_SHORT_H = 100


class ChainPlan(NamedTuple):
    """How K2's chain runs a call. ``C`` 0: the L2 branch, the chain kernel
    of the f32 mode instantiated for bf16 (csrc::bwd_chain_kernel, WhT read
    from L2 at every step where it does not fit a block's shared memory),
    taken where no cluster holds a slice of Wh (H of several hundred, 700,
    2048), where it is the faster (chain_prefers_l2), and by the f32 mode
    always. Otherwise each direction's chain for a group of
    ``rows`` rows (16 or 32: one or two m16 tiles) runs on a cluster of C
    CTAs; CTA c owns units [c·units, min(H, (c+1)·units)) with their four
    gate columns and keeps its slice of Wh in shared memory for the whole
    chain; Dh = dz·Whᵀ runs on bf16 mma.sync, each CTA multiplying its own
    dz columns by its rows of Whᵀ, the k tiles split in ``ksplit`` ranges,
    and sending each peer its units' slice of that partial
    (reduce-scatter). ``smem``: bytes of shared memory a CTA takes;
    ``groups`` row groups per direction; ``clusters``: how many clusters of
    the plan the card holds at once (one wave when 2·groups <=
    clusters)."""
    C: int
    rows: int
    units: int
    ksplit: int
    smem: int
    groups: int
    clusters: int


CHAIN_L2 = ChainPlan(0, 0, 0, 0, 0, 0, 0)


def chain_geometry(H: int, C: int, rows: int, units: int,
                   ksplit: int = 1) -> dict:
    """The shared-memory layout of a chain16 CTA (csrc::geo16): K and N of
    its product and the bytes of its operands. B = its rows of Whᵀ
    [N = H up to 8][K + 8] bf16 (K = 4U up to 16, k contiguous), A its dz
    [rows][K + 8], the stage its product's partials of ksplit k ranges
    [ksplit][rows][N] f32, the partials its peers send it
    [2][C][rows][U] f32."""
    K, N = _up(4 * units, 16), _up(H, 8)
    b, a = N * (K + 8) * 2, rows * (K + 8) * 2
    stage, part = ksplit * rows * N * 4, 2 * C * rows * units * 4
    return {"K": K, "N": N, "b": b, "a": a, "stage": stage, "part": part,
            "bytes": b + a + stage + part}


def chain_smem(H: int, C: int, rows: int, units: int, ksplit: int = 1) -> int:
    """Bytes of dynamic shared memory a chain16 CTA takes, 0 where the
    kernel takes no such plan (clstm_bidi_lstm_bwd_chain16_smem counts the
    same): C in CHAIN_CLUSTER_SIZES with every CTA owning a unit, rows in
    CHAIN_ROWS, a quad of units a thread (rows·ceil(units / CHAIN_QUAD)
    within CHAIN_THREADS), ksplit from 1 to the k tiles, within
    CHAIN_SMEM_MAX."""
    if (C not in CHAIN_CLUSTER_SIZES or rows not in CHAIN_ROWS
            or min(H, units) < 1
            or C * units < H or (C - 1) * units >= H
            or rows * -(-units // CHAIN_QUAD) > CHAIN_THREADS
            or ksplit < 1):
        return 0
    g = chain_geometry(H, C, rows, units, ksplit)
    if ksplit > g["K"] // 16 or g["bytes"] > CHAIN_SMEM_MAX:
        return 0
    return g["bytes"]


def chain_ng(rows: int) -> int:
    """n tiles a warp of the chain's product takes together, sharing each
    A fragment it loads (csrc::ch_ng): 4 at 16 rows, 2 at 32."""
    return 4 // (rows // CHAIN_M)


def chain_ksplit(H: int, C: int, rows: int, units: int) -> int:
    """The k ranges the product is split in: as many as leave no warp of
    the CTA without a (group of chain_ng n tiles, k range) of it, at most
    the k tiles, fewer where their partials do not fit."""
    g = chain_geometry(H, C, rows, units)
    groups = -(-(g["N"] // 8) // chain_ng(rows))
    ks = max(1, min(g["K"] // 16, (CHAIN_THREADS // 32) // groups))
    while ks > 1 and not chain_smem(H, C, rows, units, ks):
        ks -= 1
    return ks


def chain_units(H: int, C: int) -> int:
    """Units a CTA owns at cluster size C: ceil(H / C), rounded up to a
    multiple of CHAIN_QUAD where H is one (then every quad of units is
    whole and aligned for vector accesses; the last CTA owns the rest). 0
    where that leaves a CTA without a unit."""
    units = -(-H // C)
    if H % CHAIN_QUAD == 0:
        units = _up(units, CHAIN_QUAD)
    return units if (C - 1) * units < H else 0


def chain_prefers_l2(T: int, H: int) -> bool:
    """Whether the bf16 chain of T frames and H units takes the L2 branch
    although a cluster plan fits: where the L2 branch was the faster on
    the card (CHAIN_L2_*)."""
    return T >= CHAIN_L2_MIN_T and (
        H <= CHAIN_L2_LONG_H
        or (H <= CHAIN_L2_SHORT_H and T <= CHAIN_L2_MAX_T))


def chain_cluster_plan(B: int, H: int, clusters=None,
                       C: Optional[int] = None,
                       rows: Optional[int] = None) -> ChainPlan:
    """The bf16 chain's cluster plan for a batch of B rows and H units.

    Of the cluster plans that fit (C in CHAIN_CLUSTER_SIZES, rows in
    CHAIN_ROWS, chain_units, chain_smem), the one of fewest waves (2·groups
    over the clusters the card holds at once), then of least work a CTA
    and step (rows·units: its phase A items and its share of the product),
    then the smaller C (fewer CTAs to hand Dh between), then fewer rows: at
    B=256, H=100 and 200, C=3 with 16 rows (32 clusters of 3 in one wave
    on an H100, which holds 39 of 3 and 30 of 4; in turns on the card it
    beat every other plan, PERF.md §6). CHAIN_L2 where none fits.
    ``clusters(C, rows, units, ksplit)`` gives how many clusters of a plan
    the card holds at once: on a card the kernel's occupancy query
    (``chain_clusters``), by default H100_CLUSTERS. ``C`` and ``rows``
    force a choice, for measurements (scripts/torch_k2_chain_probe.py
    times the plans in turns)."""
    if min(B, H) < 1:
        raise ValueError(f"no chain plan for B={B} H={H}")
    if clusters is None:
        def clusters(C, rows, units, ksplit):
            return H100_CLUSTERS[C]
    best, key = None, None
    for c in CHAIN_CLUSTER_SIZES if C is None else (C,):
        units = chain_units(H, c)
        if not units:
            continue
        for r in CHAIN_ROWS if rows is None else (rows,):
            ks = chain_ksplit(H, c, r, units)
            smem = chain_smem(H, c, r, units, ks)
            if not smem:
                continue
            groups = -(-B // r)
            n = int(clusters(c, r, units, ks))
            waves = -(-2 * groups // n)
            k = (waves, r * units, c, r)
            if key is None or k < key:
                best = ChainPlan(c, r, units, ks, smem, groups, n)
                key = k
    return best or CHAIN_L2


def chain_plan(B: int, T: int, H: int, es: int = 2,
               clusters=None) -> ChainPlan:
    """K2's chain plan for a batch of B rows of T frames and H units;
    ``es`` the bytes of its streams (4: the f32 mode, which keeps the L2
    kernel's own plan, csrc::choose_chain; 2: bf16, the cluster plan of
    chain_cluster_plan unless chain_prefers_l2)."""
    if min(B, T, H) < 1:
        raise ValueError(f"no chain plan for B={B} T={T} H={H}")
    if es != 2 or chain_prefers_l2(T, H):
        return CHAIN_L2
    return chain_cluster_plan(B, H, clusters)


_active: dict = {}
_plans: dict = {}


def card_clusters(lookup, D: int, H: int, hoist: bool, state: bool,
                  esize: int = 4):
    """``clusters`` for fwd_plan on the current card: the kernel's
    occupancy query (``clstm_bidi_lstm_fwd_clusters``, or its bf16
    instance's with ``esize`` 2, of the library that ``lookup`` looks entry
    points up in), cached."""
    name = ("clstm_bidi_lstm_fwd_bf16_clusters" if esize == 2
            else "clstm_bidi_lstm_fwd_clusters")

    def query(C, resident, rows, units):
        key = (lookup, torch.cuda.current_device(), D, H, hoist, state,
               C, resident, rows, units, esize)
        n = _active.get(key)
        if n is None:
            n = lookup(name)(D, H, int(hoist), int(state), C, rows, units,
                             resident)
            if n < 1:
                raise RuntimeError(f"the card holds no cluster of {C} CTAs "
                                   f"of {rows} rows and {units} units (the "
                                   f"occupancy query returned {n})")
            _active[key] = n
        return n
    return query


def device_plan(device, B: int, D: int, H: int, hoist: bool,
                state: bool, esize: int = 4) -> FwdPlan:
    """fwd_plan on ``device``'s card (its cluster occupancy), cached per
    device and shape."""
    key = (device, B, D, H, hoist, state, esize)
    p = _plans.get(key)
    if p is None:
        with torch.cuda.device(device):
            p = fwd_plan(B, D, H, hoist, state,
                         card_clusters(_kernel, D, H, hoist, state, esize),
                         esize)
        _plans[key] = p
    return p


def chain_clusters(device, H: int):
    """``clusters`` for chain_plan on ``device``'s card at H units: the
    chain16 kernel's occupancy query
    (``clstm_bidi_lstm_bwd_chain16_clusters``), cached."""
    def query(C, rows, units, ksplit):
        k = ("chain16", device, H, C, rows, units, ksplit)
        n = _active.get(k)
        if n is None:
            with (torch.cuda.device(device) if device.type == "cuda"
                  else contextlib.nullcontext()):
                n = _kernel("clstm_bidi_lstm_bwd_chain16_clusters")(
                    H, C, rows, units, ksplit)
            if n < 1:
                raise RuntimeError(
                    f"the card holds no cluster of {C} CTAs of the chain's "
                    f"plan ({rows} rows, {units} units; the occupancy query "
                    f"returned {n})")
            _active[k] = n
        return n
    return query


def device_chain_plan(device, B: int, T: int, H: int) -> ChainPlan:
    """chain_plan of the bf16 chain on ``device``'s card, cached per
    device and shape."""
    key = ("chain", device, B, T, H)
    p = _plans.get(key)
    if p is None:
        p = chain_plan(B, T, H, 2, chain_clusters(device, H))
        _plans[key] = p
    return p


def fwd16_clusters(device, D: int, H: int, hoist: bool, *, state: bool):
    """``clusters`` for fwd16_cluster_plan on ``device``'s card: the
    occupancy query of the fwd16 kernel's instance of the mode
    (``clstm_bidi_lstm_fwd16_clusters``), cached."""
    def query(C, rows, units):
        k = ("fwd16", device, D, H, hoist, state, C, rows, units)
        n = _active.get(k)
        if n is None:
            with (torch.cuda.device(device) if device.type == "cuda"
                  else contextlib.nullcontext()):
                n = _kernel("clstm_bidi_lstm_fwd16_clusters")(
                    0 if hoist else D, H, int(hoist), int(state), C, rows,
                    units)
            if n < 1:
                raise RuntimeError(
                    f"the card holds no cluster of {C} CTAs of the fwd16 "
                    f"plan ({rows} rows, {units} units; the occupancy query "
                    f"returned {n})")
            _active[k] = n
        return n
    return query


def device_fwd16_plan(device, B: int, T: int, D: int, H: int,
                      hoist: bool, *, state: bool) -> Fwd16Plan:
    """fwd16_plan on ``device``'s card, cached per device, shape and
    mode."""
    key = ("fwd16", device, B, T, D, H, hoist, state)
    p = _plans.get(key)
    if p is None:
        p = fwd16_plan(B, T, D, H, hoist,
                       fwd16_clusters(device, D, H, hoist, state=state),
                       state=state)
        _plans[key] = p
    return p


def _plan_args(p: FwdPlan) -> tuple:
    return p.C, p.rows, p.units, p.resident


def _fwd(kind: str, plan, params_f: dict, params_r: dict,
         inp: torch.Tensor, lengths: Optional[torch.Tensor], bf16: bool,
         launch=None):
    """One launch of the forward kernel in mode ``kind`` ("fwd" K3,
    "fwd_state" K1, "fwd_xz" K4, "fwd_xz_state" K4's state mode) at
    ``plan`` on checked CUDA inputs, uncounted (the wrappers count their
    own launches; measurements launch a forced plan here) -> y, or (y,
    gates, cell) in the state modes. A FwdPlan launches the FMA kernel
    (either precision), a Fwd16Plan the bf16 tensor-core kernel (any mode,
    bf16 only). An empty batch (B or T 0) launches nothing and
    returns empty outputs. ``launch(name, device, *args)`` calls the C
    entry point (by default ``_launch``; a measurement of another build
    passes its own)."""
    hoist, state = "xz" in kind, kind.endswith("state")
    dev = inp.device
    B, T = inp.shape[:2]
    H = params_f["Wh"].shape[0]
    dt = _stream_dtype(bf16)
    if not hoist and bf16:
        inp = _x_bf16(inp)
    D = 0 if hoist else inp.shape[-1]
    outs = [torch.empty((B, T, 2 * H), dtype=dt, device=dev)]
    if state:
        outs += [torch.empty((B, T, 2, 4 * H), dtype=torch.float32,
                             device=dev),
                 torch.empty((B, T, 2, H), dtype=dt, device=dev)]
    if not (B and T):
        return tuple(outs) if state else outs[0]
    shape = (B, T, H) if hoist else (B, T, D, H)
    if isinstance(plan, Fwd16Plan):
        if not (bf16 and plan.C):
            raise ValueError(f"the fwd16 kernel runs the bf16 mode, not "
                             f"{kind} in f32 or at {plan}")
        # Its x and xz stages copy 4- and 8-byte pieces.
        inp = _aligned(inp)
        wx, wh = fwd16_weights(params_f, params_r, not hoist)
        name = ("clstm_bidi_lstm_fwd16" + ("_xz" if hoist else "")
                + ("_state" if state else ""))
        args = (plan.C, plan.rows, plan.units)
    else:
        wx, wh = fwd_weights(params_f, params_r, not hoist, bf16)
        name = f"clstm_bidi_lstm_{kind}" + ("_bf16" if bf16 else "")
        args = _plan_args(plan)
    (launch or _launch)(name, dev, inp.data_ptr(), _ptr(lengths),
                        *([] if hoist else [wx.data_ptr()]), wh.data_ptr(),
                        *(o.data_ptr() for o in outs), *shape, *args)
    return tuple(outs) if state else outs[0]


def _fwd_launch(kind: str, counter, params_f: dict, params_r: dict,
                inp: torch.Tensor, lengths: Optional[torch.Tensor],
                bf16: bool):
    """Launch the forward kernel in mode ``kind`` (see _fwd) on x or xz
    (already checked) at the card's plan -> y, or (y, gates, cell) in the
    state modes: in the bf16 mode on the tensor-core kernel where
    device_fwd16_plan gives a plan, else the FMA kernel at device_plan's.
    An empty batch launches nothing; a launch adds one to
    ``counter.launches``, and one of the tensor-core kernel also to
    ``counter.launches16``."""
    hoist, state = "xz" in kind, kind.endswith("state")
    B, T = inp.shape[:2]
    if not (B and T):
        return _fwd(kind, None, params_f, params_r, inp, lengths, bf16)
    dev = inp.device
    H = params_f["Wh"].shape[0]
    D = 0 if hoist else inp.shape[-1] + (inp.shape[-1] % 2 if bf16 else 0)
    plan = (device_fwd16_plan(dev, B, T, D, H, hoist, state=state) if bf16
            else FWD16_NONE)
    if not plan.C:
        plan = device_plan(dev, B, D, H, hoist, state, 2 if bf16 else 4)
    out = _fwd(kind, plan, params_f, params_r, inp, lengths, bf16)
    if isinstance(plan, Fwd16Plan):
        counter.launches16 += 1
    counter.launches += 1
    return out


def bidi_lstm_infer(params_f: dict, params_r: dict, x: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None,
                    hoist: Optional[bool] = None,
                    xz_bf16: bool = False) -> torch.Tensor:
    """Inference forward of a bidi layer. x [B, T, D] f32, lengths [B]
    int32 or None (all T) -> y [B, T, 2H] f32: forward half then reverse
    half, exactly 0.0 where t >= len. With ``xz_bf16`` x may also be bf16
    and y is bf16.

    ``params_*`` hold the fused weights {"Wx" [D,4H], "Wh" [H,4H],
    "b" [4H]}. With ``hoist`` None the layer takes K4 on
    ``hoisted_projection`` where ``hoists_projection(D, H)`` holds and K3
    elsewhere; True or False picks one (for measurements). ``launches``
    counts K3's launches, ``bidi_lstm_infer_xz.launches`` K4's. With
    ``xz_bf16`` the launch takes the tensor-core kernel where
    ``device_fwd16_plan`` gives a plan (``launches16`` counts those), else
    the FMA kernel. No gradient flows through a CUDA launch: training runs
    ``bidi_lstm_train``.
    """
    _check(params_f, params_r, x, lengths, xz_bf16)
    if hoist is None:
        hoist = hoists_projection(x.shape[-1], params_f["Wh"].shape[0])
    if hoist:
        return bidi_lstm_infer_xz(
            params_f, params_r,
            hoisted_projection(params_f, params_r, x, **_mode(xz_bf16)),
            lengths, xz_bf16)
    if x.device.type == "cpu":
        return bidi_lstm_apply(params_f, params_r, x, lengths,
                               **_mode(xz_bf16))
    return _fwd_launch("fwd", bidi_lstm_infer, params_f, params_r, x,
                       lengths, xz_bf16)


def bidi_lstm_fwd_state(params_f: dict, params_r: dict, x: torch.Tensor,
                        lengths: Optional[torch.Tensor] = None,
                        xz_bf16: bool = False):
    """K1. As ``bidi_lstm_infer``, and also returns what K2 reads:
    (y [B, T, 2H], gates [B, T, 2, 4H], cell [B, T, 2, H]), f32 (y and
    cell bf16 with ``xz_bf16``), original time order per direction,
    exactly 0 on padded frames (see ops/lstm.py::bidi_lstm_fwd_state_plain).
    With ``xz_bf16`` the launch takes the tensor-core kernel where
    ``device_fwd16_plan`` gives a plan (``launches16`` counts those), else
    the FMA kernel; one launch a call either way.
    """
    _check(params_f, params_r, x, lengths, xz_bf16)
    if x.device.type == "cpu":
        return bidi_lstm_fwd_state_plain(params_f, params_r, x, lengths,
                                         **_mode(xz_bf16))
    return _fwd_launch("fwd_state", bidi_lstm_fwd_state, params_f, params_r,
                       x, lengths, xz_bf16)


def bidi_lstm_infer_xz(params_f: dict, params_r: dict, xz: torch.Tensor,
                       lengths: Optional[torch.Tensor] = None,
                       xz_bf16: bool = False) -> torch.Tensor:
    """K4, inference. xz [B, T, 2, 4H] f32 (ops/lstm.py::hoisted_projection,
    original time order; bf16, the rounded product, with ``xz_bf16``) ->
    y [B, T, 2H] of the same type, as ``bidi_lstm_infer``. Only ``Wh`` of
    the params is read (see ops/lstm.py::bidi_lstm_apply_xz). In the bf16
    mode it takes the tensor-core kernel as K3 does."""
    _check_xz(params_f, params_r, xz, lengths, xz_bf16)
    if xz.device.type == "cpu":
        return bidi_lstm_apply_xz(params_f, params_r, xz, lengths,
                                  **_mode(xz_bf16))
    return _fwd_launch("fwd_xz", bidi_lstm_infer_xz, params_f, params_r, xz,
                       lengths, xz_bf16)


def bidi_lstm_fwd_state_xz(params_f: dict, params_r: dict, xz: torch.Tensor,
                           lengths: Optional[torch.Tensor] = None,
                           xz_bf16: bool = False):
    """K4, state mode: as ``bidi_lstm_infer_xz``, and also returns gates
    [B, T, 2, 4H] and cell [B, T, 2, H] with K1's layout, type and zeros,
    which K2 reads unchanged (see ops/lstm.py::bidi_lstm_fwd_state_xz_plain).
    In the bf16 mode it takes the tensor-core kernel as K1 does.
    """
    _check_xz(params_f, params_r, xz, lengths, xz_bf16)
    if xz.device.type == "cpu":
        return bidi_lstm_fwd_state_xz_plain(params_f, params_r, xz, lengths,
                                            **_mode(xz_bf16))
    return _fwd_launch("fwd_xz_state", bidi_lstm_fwd_state_xz, params_f,
                       params_r, xz, lengths, xz_bf16)


def bidi_lstm_bwd_chain(gates: torch.Tensor, cell: torch.Tensor,
                        gy: torch.Tensor, Wh2: torch.Tensor,
                        lengths: Optional[torch.Tensor] = None,
                        xz_bf16: bool = False) -> torch.Tensor:
    """K2's chain. gates [B, T, 2, 4H], cell [B, T, 2, H] (K1's), gy
    [B, T, 2H] the cotangent of y, Wh2 [2, H, 4H] f32 -> dz [B, T, 2, 4H],
    exactly 0 on padded frames (see ops/lstm.py::bidi_lstm_bwd_chain_plain).
    The streams are f32; with ``xz_bf16`` cell, gy and dz are bf16 and the
    gates stay f32 (Wh2 stays f32 and is rounded here). The kernel and its
    plan come from ``device_chain_plan``: in the bf16 mode the chain on
    thread-block clusters where a cluster holds Wh, else the L2 kernel.
    """
    if gates.dim() != 4:
        raise ValueError(f"gates must be [B, T, 2, 4H], got "
                         f"{tuple(gates.shape)}")
    B, T, _, G = gates.shape
    H = G // 4
    dev = gates.device
    dt = _stream_dtype(xz_bf16)
    _check_device(dev)
    _check_tensor("gates", gates, (B, T, 2, 4 * H), dev)
    _check_tensor("cell", cell, (B, T, 2, H), dev, dt)
    _check_tensor("gy", gy, (B, T, 2 * H), dev, dt)
    _check_tensor("Wh2", Wh2, (2, H, 4 * H), dev)
    _check_lengths(lengths, B, dev)
    if dev.type == "cpu":
        return bidi_lstm_bwd_chain_plain(gates, cell, gy, Wh2, lengths,
                                         **_mode(xz_bf16))
    if B == 0 or T == 0:
        return torch.empty((B, T, 2, G), dtype=dt, device=dev)
    plan = device_chain_plan(dev, B, T, H) if xz_bf16 else CHAIN_L2
    dz = _chain(plan, gates, cell, gy, Wh2, lengths, xz_bf16)
    bidi_lstm_bwd_chain.launches += 1
    return dz


def _chain(plan: ChainPlan, gates, cell, gy, Wh2, lengths,
           xz_bf16: bool) -> torch.Tensor:
    """One launch of K2's chain at ``plan`` on checked CUDA inputs (see
    bidi_lstm_bwd_chain), uncounted: the wrapper counts its own launches,
    and measurements launch a forced plan here."""
    B, T, _, G = gates.shape
    H = G // 4
    dev = gates.device
    dz = torch.empty((B, T, 2, G), dtype=_stream_dtype(xz_bf16), device=dev)
    if plan.C:
        # The bf16 chain on clusters: Wh itself is its product's B operand.
        wh = Wh2.detach().to(torch.bfloat16).contiguous()
        gates, cell, gy = _aligned(gates), _aligned(cell), _aligned(gy)
        _launch("clstm_bidi_lstm_bwd_chain16", dev, _ptr(lengths),
                gates.data_ptr(), cell.data_ptr(), gy.data_ptr(),
                wh.data_ptr(), dz.data_ptr(), B, T, H, plan.C, plan.rows,
                plan.units, plan.ksplit)
        return dz
    # The L2 branch. WhT [2, 4H, Hp]: Wh transposed, each row zero-padded
    # to Hp units.
    hp = _kernel("clstm_bidi_lstm_bwd_hp")(H)
    whT = torch.zeros((2, 4 * H, hp), dtype=dz.dtype, device=dev)
    whT[:, :, :H] = Wh2.detach().transpose(1, 2)
    gates = _aligned(gates)
    _launch("clstm_bidi_lstm_bwd_chain" + ("_bf16" if xz_bf16 else ""), dev,
            _ptr(lengths), gates.data_ptr(), cell.data_ptr(), gy.data_ptr(),
            whT.data_ptr(), dz.data_ptr(), B, T, H)
    return dz


def bidi_lstm_bwd_reduce(x: torch.Tensor, y: torch.Tensor, dz: torch.Tensor,
                         Wx2: torch.Tensor, need_dx: bool = True,
                         xz_bf16: bool = False):
    """K2's contractions. x [B, T, D], y [B, T, 2H] (K1's), dz
    [B, T, 2, 4H], Wx2 [2, D, 4H] f32 -> (dW [2, D+1+H, 4H] f32, dx
    [B, T, D] or None): per direction the rows of dW are dWx, the bias row,
    dWh (see ops/lstm.py::bidi_lstm_bwd_reduce_plain). The sum over frames
    is deterministic: a fixed split and a fixed-order second pass. With
    ``xz_bf16`` y and dz are bf16, x f32 or bf16 (rounded to bf16 by the
    kernel's staging), the products take one bf16 tensor-core pass split
    by ``device_reduce_plan``, and dx comes out in x's type.
    """
    if x.dim() != 3:
        raise ValueError(f"x must be [B, T, D], got {tuple(x.shape)}")
    B, T, D = x.shape
    H = y.shape[-1] // 2
    dev = x.device
    dt = _stream_dtype(xz_bf16)
    _check_device(dev)
    _check_tensor("x", x, (B, T, D), dev,
                  x.dtype if xz_bf16 and x.dtype == torch.bfloat16 else
                  torch.float32)
    _check_tensor("y", y, (B, T, 2 * H), dev, dt)
    _check_tensor("dz", dz, (B, T, 2, 4 * H), dev, dt)
    _check_tensor("Wx2", Wx2, (2, D, 4 * H), dev)
    if dev.type == "cpu":
        return bidi_lstm_bwd_reduce_plain(x, y, dz, Wx2, need_dx,
                                          **_mode(xz_bf16))
    M, G = D + 1 + H, 4 * H
    dW = torch.empty((2, M, G), dtype=torch.float32, device=dev)
    dx = torch.empty_like(x) if need_dx else None
    if B == 0 or T == 0:
        return dW.zero_(), None if dx is None else dx.zero_()
    if xz_bf16:
        plan = device_reduce_plan(dev, B, T, D, H)
        scratch = torch.empty(plan.scratch, dtype=torch.uint8, device=dev)
        dz, wx = _aligned(dz), Wx2.detach().contiguous()
        _launch("clstm_bidi_lstm_bwd_reduce_bf16", dev, x.data_ptr(),
                int(x.dtype == torch.bfloat16), y.data_ptr(), dz.data_ptr(),
                wx.data_ptr(), scratch.data_ptr(), dW.data_ptr(), _ptr(dx),
                B, T, D, H, plan.nw, plan.tt, plan.spr, plan.nwd)
    else:
        scratch = torch.empty(
            _kernel("clstm_bidi_lstm_bwd_scratch")(B, T, D, H),
            dtype=torch.float32, device=dev)
        dz, wx = _aligned(dz), _aligned(Wx2.detach())
        _launch("clstm_bidi_lstm_bwd_reduce", dev, x.data_ptr(), y.data_ptr(),
                dz.data_ptr(), wx.data_ptr(), scratch.data_ptr(),
                dW.data_ptr(), _ptr(dx), B, T, D, H)
    bidi_lstm_bwd_reduce.launches += 1
    return dW, dx


class _BidiLSTMTrain(torch.autograd.Function):
    """K1 forward, K2 backward (the custom VJP of bidi_lstm_pallas). The six
    weight tensors come in separately, so autograd hands each gradient to
    its own module parameter; they are stacked inside only.

    Where ``hoists_projection(D, H)`` holds, the forward computes the
    hoisted projection here, inside the Function, and runs K4 on it; xz is
    freed before the backward. The backward is K2 as for any layer: K4
    stores K1's gates and cell, so K2 never reads z, and the gradients of
    Wx, b and x come from K2's own reduction, as they come from the TPU
    kernel's body under its custom VJP, not from autograd through the
    product. With ``bf16`` the forward and backward run in the bf16 mode:
    y is bf16, the weight gradients come out f32 and x's in x's type."""

    @staticmethod
    def forward(ctx, x, lengths, bf16, wxf, whf, bf, wxr, whr, br):
        pf = {"Wx": wxf, "Wh": whf, "b": bf}
        pr = {"Wx": wxr, "Wh": whr, "b": br}
        mode = _mode(bf16)
        with span("clstm.lstm.fwd"):
            if hoists_projection(x.shape[-1], whf.shape[0]):
                xz = hoisted_projection(pf, pr, x, **mode)
                y, gates, cell = bidi_lstm_fwd_state_xz(pf, pr, xz, lengths,
                                                        **mode)
                del xz
            else:
                y, gates, cell = bidi_lstm_fwd_state(pf, pr, x, lengths,
                                                     **mode)
        ctx.bf16 = bf16
        ctx.save_for_backward(x, lengths, y, gates, cell, wxf, whf, wxr, whr)
        return y

    @staticmethod
    def backward(ctx, gy):
        x, lengths, y, gates, cell, wxf, whf, wxr, whr = ctx.saved_tensors
        D = x.shape[-1]
        mode = _mode(ctx.bf16)
        # need_dx of the TPU kernel: x is training data unless it requires
        # a gradient, and then dx is not computed at all.
        need_dx = ctx.needs_input_grad[0]
        with span("clstm.lstm.bwd"):
            dz = bidi_lstm_bwd_chain(gates, cell,
                                     gy.to(y.dtype).contiguous(),
                                     torch.stack([whf, whr]), lengths, **mode)
            dW, dx = bidi_lstm_bwd_reduce(x, y, dz, torch.stack([wxf, wxr]),
                                          need_dx, **mode)
        grads = [(dW[g, :D], dW[g, D + 1:], dW[g, D]) for g in (0, 1)]
        return (dx, None, None, *grads[0], *grads[1])


def bidi_lstm_train(params_f: dict, params_r: dict, x: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None,
                    xz_bf16: bool = False) -> torch.Tensor:
    """Differentiable bidirectional LSTM, same value as ``bidi_lstm_infer``:
    K1 (or, where ``hoists_projection`` holds, the hoisted projection and
    K4) in the forward, K2 in the backward on a card, their plain versions
    on CPU tensors. Gradients flow to the six weight tensors and, when it
    requires one, to x. ``xz_bf16``: the bf16 mode (y bf16, gradients of
    the weights f32, of x in x's type)."""
    _check(params_f, params_r, x, lengths, xz_bf16)
    return _BidiLSTMTrain.apply(
        x, lengths, bool(xz_bf16), params_f["Wx"], params_f["Wh"],
        params_f["b"], params_r["Wx"], params_r["Wh"], params_r["b"])


# Kernel launches since the last reset (CPU calls do not count), in either
# mode.
bidi_lstm_infer.launches = 0
bidi_lstm_fwd_state.launches = 0
bidi_lstm_infer_xz.launches = 0
bidi_lstm_fwd_state_xz.launches = 0
bidi_lstm_bwd_chain.launches = 0
bidi_lstm_bwd_reduce.launches = 0
# Of the bf16 mode's forward launches, those of the tensor-core kernel
# (fwd16_plan).
bidi_lstm_infer.launches16 = 0
bidi_lstm_fwd_state.launches16 = 0
bidi_lstm_infer_xz.launches16 = 0
bidi_lstm_fwd_state_xz.launches16 = 0
