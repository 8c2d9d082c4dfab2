"""Masked, batched sequence helpers (port of clstm_tpu/ops/seq.py).

A sequence batch is a dense, right-padded ``[B, T, D]`` tensor plus integer
``lengths[B]``. These helpers implement the mask/flip algebra that makes the
``Reversed`` combinator (clstm.cc ≈L800-1000) correct under right-padding.
"""

from __future__ import annotations

from typing import Optional

import torch


def length_mask(lengths: torch.Tensor, T: int,
                dtype=torch.float32) -> torch.Tensor:
    """[B] lengths -> [B, T] mask of 1.0 for valid steps, 0.0 for padding."""
    t = torch.arange(T, device=lengths.device)
    return (t[None, :] < lengths[:, None]).to(dtype)


def flip_within_length(x: torch.Tensor,
                       lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """Reverse each row of a right-padded [B, T, ...] batch *within its true
    length*, leaving the padding region in place: index j -> len-1-j for
    j < len, identity outside. Involutive."""
    T = x.shape[1]
    if lengths is None:
        return torch.flip(x, dims=(1,))
    j = torch.arange(T, device=x.device)[None, :]
    L = lengths.to(device=x.device, dtype=torch.long)[:, None]
    idx = torch.where(j < L, L - 1 - j, j)
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand(x.shape)
    return torch.gather(x, 1, idx)


def masked_zero(x: torch.Tensor,
                lengths: Optional[torch.Tensor]) -> torch.Tensor:
    """Zero out the padding region of a [B, T, ...] batch."""
    if lengths is None:
        return x
    m = length_mask(lengths, x.shape[1], x.dtype)
    return x * m.reshape(m.shape + (1,) * (x.ndim - 2))
