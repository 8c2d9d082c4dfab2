"""Nonlinearities (port of clstm_tpu/ops/nonlin.py).

Reference: the ``Nonlinearity`` enum {LIN, SIG, TANH, RELU} in
clstm_compute.h (≈L1-150, unverified).
"""

from __future__ import annotations

import torch

# Names match the reference enum spellings used in layer kinds
# (LinearLayer/SigmoidLayer/TanhLayer/ReluLayer).
NONLIN = ("LIN", "SIG", "TANH", "RELU")


def nonlin_apply(kind: str, x: torch.Tensor) -> torch.Tensor:
    """Apply a reference nonlinearity by name."""
    if kind == "LIN":
        return x
    if kind == "SIG":
        return torch.sigmoid(x)
    if kind == "TANH":
        return torch.tanh(x)
    if kind == "RELU":
        return torch.relu(x)
    raise ValueError(f"unknown nonlinearity: {kind!r}")
