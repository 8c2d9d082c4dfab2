"""Environment-variable configuration and the device the port runs on.

Reference: getienv/getdenv/getsenv in utils.h (≈L1-250, unverified) — the
*entire* config system of the reference CLIs is env vars with inline
defaults (SURVEY.md §5), e.g. ``lrate=1e-4 nhidden=200 clstmocrtrain ...``.
Preserved verbatim for CLI compatibility (copy of clstm_tpu/utils/config.py;
its XLA compilation cache becomes the directory of the kernels' library).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from clstm_tpu_torch.utils.profiling import span


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


def enable_compile_cache(path: str = "") -> str:
    """Choose the directory the CUDA kernels' library is built into and
    loaded from (ops/_build.py BUILD_DIR): the port's counterpart of the
    JAX package's persistent compilation cache. A library there for the
    current sources and flags (its name carries their hash) is loaded
    without running nvcc.

    ``path``: "" uses $compile_cache, then the default, the package's
    ``_build/``; "off"/"0" builds into a temporary directory of this
    process, removed at exit; any other value is a directory, created here.
    Returns the directory in use ("" when off). Nothing is compiled here,
    and a call after the library is loaded changes only a later build:
    call it before the first kernel launch. The CLIs call it at startup."""
    import atexit
    import shutil
    import tempfile
    from pathlib import Path

    from clstm_tpu_torch.ops import _build

    path = path or getsenv("compile_cache", "")
    if path in ("off", "0"):
        tmp = tempfile.mkdtemp(prefix="clstm_kernels_")
        atexit.register(shutil.rmtree, tmp, True)
        _build.BUILD_DIR = Path(tmp)
        return ""
    if not path:
        _build.BUILD_DIR = _build.DEFAULT_BUILD_DIR
        return str(_build.BUILD_DIR)
    os.makedirs(path, exist_ok=True)
    _build.BUILD_DIR = Path(path)
    return path


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
        with span("clstm.report"):
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t.detach(), non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(t.device))

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            with span("clstm.report.wait"):
                self._event.synchronize()
        return self._host.numpy()
