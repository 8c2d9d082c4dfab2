"""Bidirectional LSTM inference forward: wrapper of the CUDA kernel
``csrc/bidi_lstm_fwd.cu``.

It replaces the TPU kernel ``clstm_tpu/ops/pallas_lstm.py::_fwd_kernel``
with ``emit_state=False`` — what ``bidi_lstm_pallas(..., with_state=False)``
runs on the serving path. Same semantics as ``ops/lstm.py::bidi_lstm_apply``,
its plain version.

On CPU tensors the wrapper runs the plain version. On CUDA tensors it
launches the kernel or raises; it never falls back.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from clstm_tpu_torch.ops.lstm import bidi_lstm_apply

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from clstm_tpu_torch.ops._build import load_library

        fn = load_library().clstm_bidi_lstm_fwd
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(params_f: dict, params_r: dict, x: torch.Tensor,
           lengths: Optional[torch.Tensor]) -> None:
    """Raise on anything the kernel does not take."""
    if x.dim() != 3 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous [B, T, D] float32 tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
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
    if lengths is not None and (
            lengths.shape != (B,) or lengths.dtype != torch.int32
            or lengths.device != x.device or not lengths.is_contiguous()):
        raise ValueError(f"lengths must be a contiguous int32 [{B}] tensor "
                         f"on {x.device}, got {lengths.dtype} "
                         f"{tuple(lengths.shape)} on {lengths.device}")


def bidi_lstm_infer(params_f: dict, params_r: dict, x: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x [B, T, D] f32, lengths [B] int32 or None (all T) -> y [B, T, 2H]
    f32: forward half then reverse half, exactly 0.0 where t >= len.

    ``params_*`` hold the fused weights {"Wx" [D,4H], "Wh" [H,4H],
    "b" [4H]}. No gradient flows through the CUDA launch: the training
    kernels (forward with state, backward) are not ported yet.
    """
    _check(params_f, params_r, x, lengths)
    if x.device.type == "cpu":
        return bidi_lstm_apply(params_f, params_r, x, lengths)
    if x.device.type != "cuda":
        raise ValueError(f"bidi_lstm_infer: unsupported device {x.device}")
    B, T, D = x.shape
    H = params_f["Wh"].shape[0]
    y = torch.empty((B, T, 2 * H), dtype=torch.float32, device=x.device)
    if B == 0 or T == 0:
        return y
    wx = torch.stack([params_f["Wx"], params_r["Wx"]]).detach().contiguous()
    wh = torch.stack([params_f["Wh"], params_r["Wh"]]).detach().contiguous()
    b = torch.stack([params_f["b"], params_r["b"]]).detach().contiguous()
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), 0 if lengths is None else lengths.data_ptr(),
                 wx.data_ptr(), wh.data_ptr(), b.data_ptr(), y.data_ptr(),
                 B, T, D, H, stream)
    if err != 0:
        raise RuntimeError(f"bidi_lstm_fwd kernel launch failed: CUDA error "
                           f"{err}")
    bidi_lstm_infer.launches += 1
    return y


# Kernel launches since the last reset (CPU calls do not count).
bidi_lstm_infer.launches = 0
