"""The arithmetic every family's plain reference shares: f32 with TF32
off, and the lower precision the controls put in its place.

``rounding`` "fp8" rounds every operand of a product, and on the way back
every cotangent that reaches one, to float8 e4m3 with a per-tensor scale
(the tensor's largest magnitude at 448), products accumulating in f32.
"""

from __future__ import annotations

from typing import Callable

import torch


def set_strict_f32() -> None:
    """f32 products in f32: TF32 off for matmuls and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(t: torch.Tensor) -> torch.Tensor:
    amax = t.detach().abs().amax()
    s = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (t / s).to(torch.float8_e4m3fn).float() * s


class _Fp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return _fp8(t)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def rounder(rounding: str) -> Callable:
    """The operand rounding of a precision: "f32" none, "fp8" scaled e4m3."""
    if rounding == "f32":
        return lambda t: t
    if rounding == "fp8":
        return _Fp8.apply
    raise ValueError(f"unknown rounding {rounding!r}")
