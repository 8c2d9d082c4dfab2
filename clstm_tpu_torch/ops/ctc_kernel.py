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
ctc_backward_plain (the flip recipe). On CPU tensors each wrapper runs its plain version; on CUDA
tensors it launches the kernel or raises, and never falls back. Any B, T,
S >= 1 is taken (no padding of S to 128 or of B to 8).
"""

from __future__ import annotations

import ctypes

import torch

from clstm_tpu_torch.ops.ctc import (
    SKIP, ctc_backward_plain, ctc_both_plain, ctc_forward_plain)

_fns: dict = {}


def _kernel(name: str, npointers: int, nints: int):
    fn = _fns.get(name)
    if fn is None:
        from clstm_tpu_torch.ops._build import load_library

        fn = getattr(load_library(), name)
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
            (B, T, S), skip, lmatch.device)
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
            (B, T, S), skip, lmatch.device)
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
            (B, T, S), skip, lmatch.device)
    ctc_backward.launches += 1
    return rl


# Kernel launches since the last reset (CPU calls do not count).
ctc_forward.launches = 0
ctc_both.launches = 0
ctc_backward.launches = 0
