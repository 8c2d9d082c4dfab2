"""Environment-variable configuration and the device the port runs on.

Reference: getienv/getsenv in utils.h (≈L1-250, unverified) — the
*entire* config system of the reference CLIs is env vars with inline
defaults (SURVEY.md §5), e.g. ``lrate=1e-4 nhidden=200 clstmocrtrain ...``.
Preserved verbatim for CLI compatibility (copy of clstm_tpu/utils/config.py
without the XLA compile cache, which has no PyTorch counterpart).
"""

from __future__ import annotations

import os

import torch


def getsenv(name: str, default: str = "") -> str:
    return os.environ.get(name, default)


def getienv(name: str, default: int = 0) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def torch_device(name) -> torch.device:
    """Resolve the device the port's state lives on.

    A CUDA device that is asked for and absent raises: the port never
    carries on on the CPU in its place.

    TF32 is switched off for matmuls and cuDNN here, where the port creates
    its device state: reduced matmul precision on the TPU once stalled
    training at 46% CER while every CPU test stayed green, and the port
    holds the card to the same f32 numerics as the CPU tests.
    """
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} was asked for but CUDA is not "
                           "available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev
