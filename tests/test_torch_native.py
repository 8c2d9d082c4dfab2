"""The port's ctypes binding of the native host I/O runtime
(clstm_tpu_torch/io/native.py, built from native/clstm_io.cc with g++ at
first use) against the port's Python path and the JAX package's, on CPU.

read_png must equal the PIL path bit for bit on all 256 grey levels (u8 /
255 rounded once, as numpy rounds it); prepare_line is held to the JAX
package's own envelope for its native library (tests/test_native.py: mean
|Δ| < 1e-3 and under 1% of values off by more than 5e-3, for argmax ties
of the center curve); the loader and OcrDataset.load_all must equal
per-line native prepares exactly.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest

from clstm_tpu.data.dataset import prepare_line as jprepare_line
from clstm_tpu.io.normalize import make_normalizer as jmake_normalizer
from clstm_tpu_torch.data.dataset import OcrDataset
from clstm_tpu_torch.data.device_cache import read_images
from clstm_tpu_torch.io import native
from clstm_tpu_torch.io.png import read_png as pil_read_png
from clstm_tpu_torch.utils.metrics import levenshtein

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_torch_native_builds_here():
    """g++, png.h and libpng are present here, so the library builds (a
    missing one is the only reason available() may be False)."""
    assert native.available(), native.missing_reason()
    assert native.missing_reason() is None


def test_torch_native_read_png_bit_equal_to_pil(tmp_path):
    from PIL import Image
    grey = np.arange(256, dtype=np.uint8).reshape(16, 16)
    f = str(tmp_path / "levels.png")
    Image.fromarray(grey, mode="L").save(f)
    got = native.read_png(f)
    want = pil_read_png(f)
    assert got.dtype == want.dtype == np.float32 and got.shape == (16, 16)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.array_equal(got, grey.astype(np.float32) / np.float32(255.0))
    out = str(tmp_path / "back.png")
    native.write_png(out, got)
    assert np.array_equal(pil_read_png(out), want)
    with pytest.raises(IOError):
        native.read_png(str(tmp_path / "missing.png"))


def test_torch_native_levenshtein_matches_metrics():
    rng = np.random.RandomState(0)
    for _ in range(40):
        a = list(rng.randint(0, 5, size=rng.randint(0, 30)))
        b = list(rng.randint(0, 5, size=rng.randint(0, 30)))
        assert native.levenshtein(a, b) == levenshtein(a, b)
    assert native.levenshtein([], []) == 0


def _test_image(h=60, w=300, seed=0):
    rng = np.random.RandomState(seed)
    img = np.ones((h, w), np.float32)
    centers = h / 2 + 6 * np.sin(2 * np.pi * np.arange(w) / (2 * w))
    for x in range(w):
        c = int(centers[x])
        img[c - 4:c + 4, x] = rng.rand(8) * 0.2
    return img


@pytest.mark.parametrize("dewarp", ["none", "mean", "center"])
def test_torch_native_prepare_line_matches_jax(dewarp):
    """The native prepare against the JAX package's Python prepare_line and
    normalizer, within tests/test_native.py's envelope."""
    for seed in (0, 1):
        img = _test_image(seed=seed)
        want = jprepare_line(img, jmake_normalizer(dewarp, 32), pad=8)
        got = native.prepare_line(img, 32, pad=8, dewarp=dewarp)
        assert got.shape == want.shape, (got.shape, want.shape)
        d = np.abs(got - want)
        assert d.mean() < 1e-3, d.mean()
        assert (d > 5e-3).mean() < 0.01, (d > 5e-3).mean()


@pytest.fixture(scope="module")
def lines(tmp_path_factory):
    from clstm_tpu_torch.data.lines import LineGenerator, make_dataset_dir
    tmp = tmp_path_factory.mktemp("native")
    gen = LineGenerator(seed=7, fontsize=(20, 24), charset="abc")
    return make_dataset_dir(str(tmp / "ds"), 6, gen=gen)


def test_torch_native_loader_and_load_all(lines, tmp_path):
    """PrefetchLoader (4 threads) and OcrDataset.load_all give, line for
    line, the native per-line prepare of the native decode, bitwise; the
    decoded images equal PIL's; a bad file raises at its get()."""
    ds = OcrDataset(lines, target_height=32, dewarp="center")
    want = [native.prepare_line(native.read_png(f), 32, pad=ds.pad,
                                dewarp="center") for f in ds.files]
    with native.PrefetchLoader(ds.files, 32, pad=ds.pad, dewarp="center",
                               nthreads=4) as loader:
        assert len(loader) == 6
        for i in range(6):
            assert np.array_equal(loader.get(i), want[i])
    loaded = ds.load_all(nthreads=3)
    assert [t for _, t in loaded] == ds.texts()
    for (x, _), w in zip(loaded, want):
        assert np.array_equal(x, w)
    for a, b in zip(read_images(ds.files), [pil_read_png(f)
                                            for f in ds.files]):
        assert np.array_equal(a, b)
    bad = tmp_path / "bad.png"
    bad.write_bytes(b"not a png")
    with native.PrefetchLoader([str(bad)], 32) as loader:
        with pytest.raises(IOError):
            loader.get(0)


def test_torch_native_concurrent_first_builds(tmp_path):
    """Two processes that build at once into an empty directory leave one
    whole library there (each writes under a temporary name and renames it
    into place) and nothing else; it loads and runs."""
    code = ("import sys\n"
            "from clstm_tpu_torch.io import native\n"
            "print(native.build(sys.argv[1]))\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=REPO, stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert outs[0] == outs[1]
    assert os.listdir(tmp_path) == [os.path.basename(outs[0])]
    lib = ctypes.CDLL(outs[0])
    a = (ctypes.c_int32 * 3)(1, 2, 3)
    b = (ctypes.c_int32 * 2)(1, 3)
    assert lib.clstm_levenshtein(a, 3, b, 2) == 1


def test_torch_native_gate(tmp_path, monkeypatch):
    """Without g++ the build gives None (available() False, the callers
    take the Python path); a source that fails to compile with the whole
    toolchain present raises."""
    monkeypatch.setattr(native, "_gxx", lambda: None)
    assert native.build(tmp_path / "a") is None
    monkeypatch.undo()
    broken = tmp_path / "broken.cc"
    broken.write_text('#include <png.h>\nextern "C" int f() { return }\n')
    monkeypatch.setattr(native, "SOURCE", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.build(tmp_path / "b")
