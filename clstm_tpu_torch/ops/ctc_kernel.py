"""CTC alignment DP kernels: wrappers of ``csrc/ctc_dp.cu``.

  ctc_forward  K5, replaces clstm_tpu/ops/pallas_ctc.py::_kernel
               (ctc_forward_pallas): the forward DP, lr [B, T, S];
  ctc_both     K6, replaces pallas_ctc.py::_bwd_kernel with fuse_both=True
               (ctc_both_pallas): the second DP direction without flips,
               both = lr + rl [B, T, S] and lse [B, S];
  ctc_backward K6b, replaces the same kernel with fuse_both=False
               (ctc_backward_pallas): the second DP direction alone, rl
               [B, T, S].

Their plain versions are ops/ctc.py::ctc_forward_plain, ctc_both_plain and
ctc_backward_plain (the flip recipe). On CPU tensors each wrapper runs its
plain version; on CUDA tensors it launches the kernel, laid out by
``ctc_dp_plan``, or raises, and never falls back. Any B, T >= 1 is taken,
and any S >= 1 whose block fits the card's shared memory: up to 14,528 in
K6 and 29,056 in K5 and K6b (no padding of S to 128 or of B to 8).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from clstm_tpu_torch.ops.ctc import (
    SKIP, ctc_backward_plain, ctc_both_plain, ctc_forward_plain)

# States per lane the register kernels are compiled for, each with the
# frames it keeps in flight (csrc/ctc_dp.cu::CTC_INSTANCES; checked against
# the library when it loads). The plan takes 1 or 2 (CTC_STATES); 3 is the
# one-warp layout at S=81, compiled to be timed in turns against the plan's
# choice (chip_smoke.py).
CTC_PREFETCH = {1: 16, 2: 8, 3: 8}
CTC_STATES = (1, 2)
# A row's warps at most: one block of 1,024 threads (csrc/ctc_dp.cu::
# MAX_WARPS).
CTC_MAX_WARPS = 32
# Warps a row takes at one state a lane before it takes two states a lane:
# on the card K5/K6/K6b ran faster on 8 warps of 2 states than on 16 of 1
# at S=512, and slower on 2 warps of 2 than on 3 of 1 at S=81
# (chip_smoke.py times both choices in turns; PERF.md §6).
CTC_ONE_STATE_WARPS = 8
# A block's shared memory at most (an H100; csrc/ctc_dp.cu::SMEM_MAX).
CTC_SMEM_MAX = 232_448
# The widest rows whose states fit in registers (32 warps of 2 states a
# lane); wider rows take the wide branch, states in shared memory.
CTC_REG_S_MAX = 32 * CTC_MAX_WARPS * CTC_STATES[-1]


def ctc_max_warps(states: int) -> int:
    """Warps a row may take at ``states`` per lane in a plan."""
    return CTC_ONE_STATE_WARPS if states == 1 else CTC_MAX_WARPS


def ctc_smem(S: int, warps: int, states: int, prefetch: int,
             both: bool = True) -> int:
    """Bytes of shared memory a block takes in K6 (``both``) or in K5 and
    K6b (csrc/ctc_dp.cu::smem_bytes): with the states in registers, a ring
    of ``prefetch`` frames of 32·warps·states floats for lmatch (and K6's
    for lr) and the edge slots between warps; in the wide branch (``states``
    0), the state double-buffered (and K6's running pair), S floats each."""
    rings = 2 if both else 1
    if states == 0:
        return 4 * 2 * rings * S
    return 4 * (rings * prefetch * 32 * warps * states + 2 * CTC_MAX_WARPS)


class CtcPlan(NamedTuple):
    """How the CTC DP kernels lay a batch out: each row on one block of
    ``warps`` warps, lane l of warp w holding the ``states`` contiguous
    states from (w·32 + l)·states in registers, ``prefetch`` frames of
    lmatch (and lr) in flight, copied into a ring in shared memory; or,
    with ``states`` and ``prefetch`` 0, the wide branch (the states in
    shared memory, thread i walking states i, i + 32·warps, ...).
    ``threads`` and ``blocks`` are the launch's, ``smem`` the bytes of
    shared memory a block takes."""
    warps: int
    states: int
    prefetch: int
    threads: int
    blocks: int
    smem: int


@functools.lru_cache(maxsize=None)
def ctc_dp_plan(B: int, S: int, both: bool = True) -> CtcPlan:
    """The DP kernels' plan for B rows of S states, in K6 (``both``) or in
    K5 and K6b: up to CTC_REG_S_MAX, the fewest states per lane (of
    CTC_STATES) whose warps, ceil(S / (32·states)), are at most
    ctc_max_warps, with that instance's frames in flight (CTC_PREFETCH);
    wider, the wide branch on CTC_MAX_WARPS warps. One row a block.
    Raises ValueError for B or S below 1 and where the block's shared
    memory would pass CTC_SMEM_MAX."""
    if B < 1 or S < 1:
        raise ValueError(f"no CTC DP plan for B={B} S={S}")
    states = next((k for k in CTC_STATES
                   if -(-S // (32 * k)) <= ctc_max_warps(k)), 0)
    warps = -(-S // (32 * states)) if states else CTC_MAX_WARPS
    prefetch = CTC_PREFETCH[states] if states else 0
    smem = ctc_smem(S, warps, states, prefetch, both)
    if smem > CTC_SMEM_MAX:
        raise ValueError(f"no CTC DP plan for S={S}: {smem} bytes of shared "
                         f"memory a block, above {CTC_SMEM_MAX}")
    return CtcPlan(warps, states, prefetch, 32 * warps, B, smem)


def _plan_args(B: int, S: int, both: bool) -> tuple:
    p = ctc_dp_plan(B, S, both)
    return p.warps, p.states, p.prefetch


def check_config(got) -> None:
    """Raise unless the library was built as this module assumes: ``got``
    is csrc/ctc_dp.cu::clstm_ctc_config's list (MAX_WARPS, SMEM_MAX, then
    each instance's states and frames in flight)."""
    want = [CTC_MAX_WARPS, CTC_SMEM_MAX,
            *(x for kp in CTC_PREFETCH.items() for x in kp)]
    if list(got) != want:
        raise RuntimeError(f"the CTC DP library was built with {list(got)}; "
                           f"ops/ctc_kernel.py assumes {want}")


_fns: dict = {}


def _kernel(name: str, npointers: int, nints: int):
    fn = _fns.get(name)
    if fn is None:
        from clstm_tpu_torch.ops._build import load_library

        lib = load_library()
        if not _fns:
            buf = (ctypes.c_int * 64)()
            check_config(buf[:lib.clstm_ctc_config(buf, 64)])
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * npointers + [ctypes.c_int] * nints
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(lmatch: torch.Tensor, lengths: torch.Tensor, lr=None) -> None:
    """Raise on anything the kernels do not take."""
    if (lmatch.dim() != 3 or lmatch.dtype != torch.float32
            or not lmatch.is_contiguous()):
        raise ValueError(f"lmatch must be a contiguous [B, T, S] float32 "
                         f"tensor, got {lmatch.dtype} {tuple(lmatch.shape)}")
    if lmatch.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {lmatch.device}")
    _check_ints("lengths", lengths, lmatch.shape[0], lmatch.device)
    if lr is not None and (lr.shape != lmatch.shape
                           or lr.dtype != torch.float32
                           or lr.device != lmatch.device
                           or not lr.is_contiguous()):
        raise ValueError(f"lr must be a contiguous float32 "
                         f"{tuple(lmatch.shape)} tensor on {lmatch.device}, "
                         f"got {lr.dtype} {tuple(lr.shape)} on {lr.device}")


def _check_ints(name: str, t: torch.Tensor, B: int, device) -> None:
    if (tuple(t.shape) != (B,) or t.dtype != torch.int32
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous int32 [{B}] tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _launch(name: str, ptrs, ints, skip: float, device) -> None:
    fn = _kernel(name, len(ptrs), len(ints))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*ptrs, *ints, skip, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def ctc_forward(lmatch: torch.Tensor, lengths: torch.Tensor,
                skip: float = SKIP) -> torch.Tensor:
    """lmatch [B, T, S] f32, lengths [B] int32 -> lr [B, T, S] f32, the
    log-alpha after each frame. Frames t >= len carry the state through, as
    the plain version does."""
    _check(lmatch, lengths)
    if lmatch.device.type == "cpu":
        return ctc_forward_plain(lmatch, lengths, skip)
    B, T, S = lmatch.shape
    lr = torch.empty_like(lmatch)
    if lmatch.numel() == 0:
        return lr
    _launch("clstm_ctc_forward",
            (lmatch.data_ptr(), lengths.data_ptr(), lr.data_ptr()),
            (B, T, S, *_plan_args(B, S, False)), skip, lmatch.device)
    ctc_forward.launches += 1
    return lr


def ctc_both(lmatch: torch.Tensor, lr: torch.Tensor, lengths: torch.Tensor,
             target_lengths: torch.Tensor, skip: float = SKIP):
    """lmatch, lr [B, T, S] f32; lengths, target_lengths [B] int32 ->
    (both [B, T, S], lse [B, S]) f32: both = lr + rl on frames t < len and
    NEG on the others; lse the logsumexp of both over time."""
    _check(lmatch, lengths, lr)
    B, T, S = lmatch.shape
    _check_ints("target_lengths", target_lengths, B, lmatch.device)
    if lmatch.device.type == "cpu":
        return ctc_both_plain(lmatch, lr, lengths, target_lengths, skip)
    both = torch.empty_like(lmatch)
    lse = torch.empty((B, S), dtype=torch.float32, device=lmatch.device)
    if lmatch.numel() == 0:
        return both, lse
    _launch("clstm_ctc_both",
            (lmatch.data_ptr(), lr.data_ptr(), lengths.data_ptr(),
             target_lengths.data_ptr(), both.data_ptr(), lse.data_ptr()),
            (B, T, S, *_plan_args(B, S, True)), skip, lmatch.device)
    ctc_both.launches += 1
    return both, lse


def ctc_backward(lmatch: torch.Tensor, lengths: torch.Tensor,
                 target_lengths: torch.Tensor,
                 skip: float = SKIP) -> torch.Tensor:
    """lmatch [B, T, S] f32; lengths, target_lengths [B] int32 -> rl
    [B, T, S] f32, the second DP direction. Equal to the flip recipe on
    valid cells (t < len, s < tlen); frames t >= len hold the initial
    state."""
    _check(lmatch, lengths)
    B, T, S = lmatch.shape
    _check_ints("target_lengths", target_lengths, B, lmatch.device)
    if lmatch.device.type == "cpu":
        return ctc_backward_plain(lmatch, lengths, target_lengths, skip)
    rl = torch.empty_like(lmatch)
    if lmatch.numel() == 0:
        return rl
    _launch("clstm_ctc_backward",
            (lmatch.data_ptr(), lengths.data_ptr(), target_lengths.data_ptr(),
             rl.data_ptr()),
            (B, T, S, *_plan_args(B, S, False)), skip, lmatch.device)
    ctc_backward.launches += 1
    return rl


# Kernel launches since the last reset (CPU calls do not count).
ctc_forward.launches = 0
ctc_both.launches = 0
ctc_backward.launches = 0
