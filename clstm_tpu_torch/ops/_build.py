"""Build and load the port's CUDA kernels: ``csrc/*.cu`` -> one shared
library with a plain C interface, compiled by ``nvcc`` for sm_90a and loaded
with ctypes. Each source is compiled by its own ``nvcc``, all started
together, and the objects are then linked.

The library is built at first use into ``BUILD_DIR``, by default
``clstm_tpu_torch/_build/`` (listed in .gitignore; utils/config.py
enable_compile_cache points it elsewhere), under a name that carries the hash
of the sources and the flags, so a change to any source rebuilds it. Only
sources in the package are compiled. Nothing is built when this module is
imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
DEFAULT_BUILD_DIR = _PKG / "_build"
BUILD_DIR = DEFAULT_BUILD_DIR
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def _sources() -> list:
    srcs = sorted(SRC_DIR.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
    return srcs


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libclstm_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them already exists.
    The output is written in a temporary directory and renamed into place,
    so a concurrent or interrupted build never leaves a partial library."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in _sources()]
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                for obj, src in zip(objs, _sources())]
        procs = []
        try:
            for cmd in cmds:
                procs.append(subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            for cmd, proc in zip(cmds, procs):
                output, _ = proc.communicate()
                _check_run(cmd, proc.returncode, output)
        finally:
            for proc in procs:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
        out = os.path.join(tmp, "lib.so")
        cmd = [nvcc, "-shared", "-o", out, *objs]
        res = subprocess.run(cmd, capture_output=True, text=True)
        _check_run(cmd, res.returncode, res.stdout + res.stderr)
        os.replace(out, so)
    return so


def _check_run(cmd: list, returncode: int, output: str) -> None:
    if returncode != 0:
        raise RuntimeError(f"nvcc failed ({returncode}):\n{' '.join(cmd)}\n"
                           f"{output}")


def load_library() -> ctypes.CDLL:
    """Build if needed, then load the kernels' library (once per process)."""
    global _lib
    if _lib is None:
        _lib = ctypes.CDLL(str(build()))
    return _lib
