"""ctypes binding of the native host-side I/O runtime (native/clstm_io.cc;
port of clstm_tpu/io/native.py).

PNG decode, line preparation (invert + dewarp + rescale + transpose + pad),
a threaded prefetch loader and levenshtein: the native counterparts of
io/png.py, io/normalize.py with data/dataset.py's prepare_line, and
utils/metrics.py. The JAX package finds a library built by ``make -C
native``; the port builds the same source itself with ``g++`` at first use
(the flags of native/Makefile), into ``clstm_tpu_torch/_build/`` under a
name that carries the hash of the source, the flags and the CPU that
``-march=native`` resolves to. The output is written under a temporary name
and renamed into place, so builds that run at once (test workers) leave one
whole library.

``available()`` is False only where ``g++``, ``png.h`` or libpng (with
zlib) is missing, and the callers then take the Python path; a compile that
fails with all of them present raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG.parent / "native" / "clstm_io.cc"
BUILD_DIR = _PKG / "_build"
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall")
LDLIBS = ("-lpng", "-lz", "-lpthread")
# Compiled and linked to tell a missing header or library (available() is
# False) from a fault in the source (the build raises).
_PROBE = "#include <png.h>\nint main() { return png_access_version_number() == 0; }\n"

_DEWARP_KINDS = {"none": 0, "no": 0, "mean": 1, "center": 2, "dewarp": 2}

_lib = None
_missing: Optional[str] = None   # why the library cannot be built here


def _gxx() -> Optional[str]:
    return shutil.which("g++")


def _target(gxx: str) -> str:
    """The cc1 command line of ``-march=native``: the CPU the code is
    built for, so a library built on another CPU is not taken."""
    res = subprocess.run([gxx, "-march=native", "-E", "-v", "-x", "c++",
                          os.devnull], capture_output=True, text=True)
    return "\n".join(ln for ln in res.stderr.splitlines() if "cc1" in ln)


def library_path(gxx: str, build_dir: Path = BUILD_DIR) -> Path:
    h = hashlib.sha256(" ".join(CXXFLAGS + LDLIBS).encode())
    h.update(SOURCE.read_bytes())
    h.update(_target(gxx).encode())
    return Path(build_dir) / f"libclstm_io-{h.hexdigest()[:16]}.so"


def _toolchain_missing(gxx: Optional[str], tmp: str) -> Optional[str]:
    """None when g++ builds and links a program against libpng, else why
    not."""
    if gxx is None:
        return "g++ not found"
    src = os.path.join(tmp, "probe.cc")
    with open(src, "w") as f:
        f.write(_PROBE)
    res = subprocess.run([gxx, src, "-o", os.path.join(tmp, "probe"),
                          *LDLIBS], capture_output=True, text=True)
    if res.returncode != 0:
        err = [ln for ln in res.stderr.splitlines()
               if "fatal error" in ln or "cannot find" in ln]
        return ("png.h or libpng missing: "
                + (err[0].strip() if err else res.stderr.strip()))
    return None


def build(build_dir: Path = BUILD_DIR) -> Optional[Path]:
    """Compile native/clstm_io.cc unless a library for it is there. -> the
    library's path, or None where the toolchain lacks g++, png.h or
    libpng. A failed compile with all of them present raises."""
    gxx = _gxx()
    if gxx is None:
        return None
    so = library_path(gxx, build_dir)
    if so.exists():
        return so
    Path(build_dir).mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        if _toolchain_missing(gxx, tmp) is not None:
            return None
        out = os.path.join(tmp, "lib.so")
        cmd = [gxx, *CXXFLAGS, "-shared", "-o", out, str(SOURCE), *LDLIBS]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"g++ failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(out, so)
    return so


def missing_reason() -> Optional[str]:
    """Why available() is False (None when it is True)."""
    available()
    return _missing


def _load():
    global _lib, _missing
    if _lib is not None or _missing is not None:
        return _lib
    so = build()
    if so is None:
        with tempfile.TemporaryDirectory() as tmp:
            _missing = _toolchain_missing(_gxx(), tmp) or "not built"
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:      # built elsewhere; libpng missing here
        _missing = f"cannot load {so.name}: {e}"
        return None
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.clstm_read_png.argtypes = [ctypes.c_char_p, ctypes.POINTER(fp), ip,
                                   ip]
    lib.clstm_read_png.restype = ctypes.c_int
    lib.clstm_write_png.argtypes = [ctypes.c_char_p, fp, ctypes.c_int,
                                    ctypes.c_int]
    lib.clstm_write_png.restype = ctypes.c_int
    lib.clstm_free.argtypes = [ctypes.c_void_p]
    lib.clstm_free.restype = None
    lib.clstm_levenshtein.argtypes = [i32p, ctypes.c_int, i32p, ctypes.c_int]
    lib.clstm_levenshtein.restype = ctypes.c_int
    lib.clstm_prepare_line.argtypes = [
        fp, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(fp), ip, ip]
    lib.clstm_prepare_line.restype = ctypes.c_int
    lib.clstm_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.clstm_loader_create.restype = ctypes.c_void_p
    lib.clstm_loader_get.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.POINTER(fp), ip, ip]
    lib.clstm_loader_get.restype = ctypes.c_int
    lib.clstm_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.clstm_loader_destroy.restype = None
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _take(buf, shape, free: bool) -> np.ndarray:
    """Copy a malloc'ed float buffer of ``shape`` out (and free it)."""
    out = np.ctypeslib.as_array(buf, shape=shape).copy() if all(shape) \
        else np.zeros(shape, np.float32)
    if free:
        _lib.clstm_free(buf)
    return out


def read_png(fname: str) -> np.ndarray:
    """PNG -> float32 grayscale [h, w] in [0, 1] (u8 / 255.0f)."""
    lib = _load()
    buf = ctypes.POINTER(ctypes.c_float)()
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.clstm_read_png(os.fsencode(fname), ctypes.byref(buf),
                          ctypes.byref(h), ctypes.byref(w)) != 0:
        raise IOError(f"native png decode failed: {fname}")
    return _take(buf, (h.value, w.value), True)


def write_png(fname: str, img: np.ndarray) -> None:
    lib = _load()
    a = np.ascontiguousarray(np.clip(img, 0.0, 1.0), np.float32)
    if a.ndim != 2:
        raise ValueError(f"write_png takes a [h, w] image, got {a.shape}")
    if lib.clstm_write_png(os.fsencode(fname),
                           a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           a.shape[0], a.shape[1]) != 0:
        raise IOError(f"native png encode failed: {fname}")


def levenshtein(a: Sequence[int], b: Sequence[int]) -> int:
    lib = _load()
    aa = np.ascontiguousarray(a, np.int32)
    bb = np.ascontiguousarray(b, np.int32)
    p = ctypes.POINTER(ctypes.c_int32)
    return lib.clstm_levenshtein(aa.ctypes.data_as(p), len(aa),
                                 bb.ctypes.data_as(p), len(bb))


def prepare_line(img: np.ndarray, target_height: int, pad: int = 16,
                 dewarp: str = "center") -> np.ndarray:
    """Native prepare_line: grayscale [h, w] -> model input [T, H]."""
    lib = _load()
    a = np.ascontiguousarray(img, np.float32)
    if a.ndim != 2:
        raise ValueError(f"prepare_line takes a [h, w] image, got {a.shape}")
    buf = ctypes.POINTER(ctypes.c_float)()
    T, H = ctypes.c_int(), ctypes.c_int()
    lib.clstm_prepare_line(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), a.shape[0],
        a.shape[1], target_height, pad, _DEWARP_KINDS[dewarp.lower()],
        ctypes.byref(buf), ctypes.byref(T), ctypes.byref(H))
    return _take(buf, (T.value, H.value), True)


class PrefetchLoader:
    """Threaded decode + prepare over a list of PNG paths.

    A native thread pool prepares the lines in file order; ``get(i)`` waits
    until line i is ready and returns its [T, H] float32 input. Use as a
    context manager.
    """

    def __init__(self, paths: List[str], target_height: int, pad: int = 16,
                 dewarp: str = "center", nthreads: int = 0):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"native library unavailable: "
                               f"{missing_reason()}")
        self._lib = lib
        self._n = len(paths)
        self._paths = (ctypes.c_char_p * len(paths))(
            *[os.fsencode(p) for p in paths])
        self._handle = lib.clstm_loader_create(
            self._paths, len(paths), target_height, pad,
            _DEWARP_KINDS[dewarp.lower()], nthreads)

    def __len__(self) -> int:
        return self._n

    def get(self, i: int) -> np.ndarray:
        if not 0 <= i < self._n:
            raise IndexError(i)
        buf = ctypes.POINTER(ctypes.c_float)()
        T, H = ctypes.c_int(), ctypes.c_int()
        if self._lib.clstm_loader_get(self._handle, i, ctypes.byref(buf),
                                      ctypes.byref(T), ctypes.byref(H)) != 0:
            raise IOError(f"loader: decode failed for line {i}")
        return _take(buf, (T.value, H.value), False)

    def close(self) -> None:
        if self._handle:
            self._lib.clstm_loader_destroy(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
