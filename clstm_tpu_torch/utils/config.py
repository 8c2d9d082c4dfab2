"""Environment-variable configuration and the device the port runs on.

Reference: getienv/getdenv/getsenv in utils.h (≈L1-250, unverified) — the
*entire* config system of the reference CLIs is env vars with inline
defaults (SURVEY.md §5), e.g. ``lrate=1e-4 nhidden=200 clstmocrtrain ...``.
Preserved verbatim for CLI compatibility (copy of clstm_tpu/utils/config.py
without the XLA compile cache, which has no PyTorch counterpart).
"""

from __future__ import annotations

import os

import numpy as np
import torch


def getsenv(name: str, default: str = "") -> str:
    return os.environ.get(name, default)


def getienv(name: str, default: int = 0) -> int:
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else default


def getdenv(name: str, default: float = 0.0) -> float:
    v = os.environ.get(name)
    return float(v) if v not in (None, "") else default


def getbenv(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    if v in (None, ""):
        return default
    return v.lower() not in ("0", "false", "no")


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


def to_device(a, device: torch.device) -> torch.Tensor:
    """A numpy array (or CPU tensor) -> a tensor on ``device``, without
    waiting for the card: on CUDA the bytes go through a pinned host buffer
    with a non-blocking copy, since a copy from pageable memory waits for
    every kernel queued on the stream before it returns."""
    t = torch.as_tensor(a)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class HostCopy:
    """A device tensor copied back to the host without waiting: on CUDA the
    copy goes into a pinned buffer on the current stream and an event marks
    its end; ``numpy()`` waits for that event alone, so the copy overlaps
    whatever the card and the host do in between."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type != "cuda":
            self._host = t.detach()
            return
        self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self._host.copy_(t.detach(), non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(t.device))

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()
