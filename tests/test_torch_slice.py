"""The port's serving slice — .clstm load, host normalization, width
buckets, batched forward, greedy decode, clstmocr — against the JAX package
on the same line images, on CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from clstm_tpu.cli import clstmocr as jcli  # noqa: E402
from clstm_tpu.models.codec import Codec as JCodec  # noqa: E402
from clstm_tpu.models.hl import CLSTMOCR as JOCR  # noqa: E402
from clstm_tpu.ops import ctc as jctc  # noqa: E402
from clstm_tpu.train import TrainState  # noqa: E402
from clstm_tpu_torch.cli import clstmocr as tcli  # noqa: E402
from clstm_tpu_torch.models.codec import Codec  # noqa: E402
from clstm_tpu_torch.models.hl import CLSTMOCR  # noqa: E402
from clstm_tpu_torch.ops import ctc as tctc  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def line_image(rng, h, w):
    """Ink strokes on white, in [0, 1]."""
    img = np.ones((h, w), np.float32)
    top, base = int(h * 0.3), int(h * 0.72)
    col = 4
    while col < w - 10:
        cw = rng.randint(2, 8)
        img[top:base, col:col + 2] = 0.1
        if rng.rand() < 0.5:
            img[top:top + 2, col:col + cw] = 0.1
        col += cw + rng.randint(2, 6)
    return np.clip(img + rng.normal(0, 0.02, img.shape), 0, 1).astype(np.float32)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """A JAX bidi OCR model with uniform ±0.5 numpy weights (argmax margins
    well above float noise), saved as .clstm and loaded by the port."""
    jocr = JOCR(target_height=48)
    jocr.createBidi(JCodec.build(["abcdefg"]), nhidden=8)
    rng = np.random.RandomState(0)
    params = jax.tree.map(
        lambda a: jnp.asarray(rng.uniform(-0.5, 0.5, a.shape), jnp.float32),
        jocr.state.params)
    jocr.state = TrainState.create(params)
    path = str(tmp_path_factory.mktemp("model") / "bidi.clstm")
    jocr.save(path, sidecar=False)
    tocr = CLSTMOCR(device="cpu")
    tocr.load(path)
    return jocr, tocr, path


@pytest.fixture(scope="module")
def images():
    rng = np.random.RandomState(1)
    return [line_image(rng, h, w) for h, w in
            ((40, 60), (32, 150), (55, 90), (48, 300), (36, 40))]


def test_torch_predict_pages_matches_jax(models, images):
    jocr, tocr, _ = models
    want = jcli.predict_pages(jocr, images, device_preprocess=0)
    got = tcli.predict_pages(tocr, images, device_preprocess=0)
    assert sorted(got) == sorted(want) == list(range(len(images)))
    widths = set()
    for i in range(len(images)):
        jcls, jpos, jvals, jscale = want[i]
        tcls, tpos, tvals, tscale = got[i]
        widths.add(len(tvals))
        assert tcls == jcls and tpos == jpos and tscale == jscale
        np.testing.assert_allclose(tvals, jvals, atol=1e-5)
        assert tocr.codec.decode(tcls) == jocr.codec.decode(jcls)
    assert len(widths) >= 2              # more than one width bucket ran
    assert any(got[i][0] for i in got)   # something was decoded


def test_torch_predict_batch_frames_match_jax(models, images):
    jocr, tocr, _ = models
    xs = [tocr.prepare(img) for img in images[:3]]
    T = max(x.shape[0] for x in xs)
    xb = np.zeros((3, T, 48), np.float32)
    lengths = np.array([x.shape[0] for x in xs], np.int32)
    for r, x in enumerate(xs):
        xb[r, :len(x)] = x
    jids, jvals = jocr.predict_batch(xb, lengths)
    tids, tvals = tocr.predict_batch(xb, lengths)
    for r, L in enumerate(lengths):
        np.testing.assert_array_equal(tids[r, :L], jids[r, :L])
        np.testing.assert_allclose(tvals[r, :L], jvals[r, :L], atol=1e-5)


def test_torch_single_line_api_matches_jax(models, images):
    jocr, tocr, _ = models
    for img in images[:3]:
        assert tocr.predict_utf8(img) == jocr.predict_utf8(img)
        jp, tp = jocr.predict(img), tocr.predict(img)
        assert [(c.i, c.x, c.c) for c in tp] == [(c.i, c.x, c.c) for c in jp]
        np.testing.assert_allclose([c.p for c in tp], [c.p for c in jp],
                                   atol=1e-5)


def test_torch_clstmocr_main_writes_sidecars(models, images, tmp_path,
                                             monkeypatch, capsys):
    from clstm_tpu_torch.io.png import read_png, write_png

    jocr, _, path = models
    files = []
    for i, img in enumerate(images[:3]):
        f = str(tmp_path / f"l{i}.png")
        write_png(f, img)
        files.append(f)
    monkeypatch.setenv("load", path)
    monkeypatch.setenv("device", "cpu")
    monkeypatch.setenv("output", "sidecar")
    monkeypatch.setenv("charseg", "1")
    assert tcli.main(files) == 0
    pngs = [read_png(f) for f in files]
    want = jcli.predict_pages(jocr, pngs, device_preprocess=0)
    for i, f in enumerate(files):
        with open(f[:-4] + ".txt", encoding="utf-8") as fh:
            assert fh.read() == jocr.codec.decode(want[i][0]) + "\n"
    assert capsys.readouterr().out.count("# ") == sum(
        len(want[i][0]) for i in range(len(files)))


def test_torch_clstmocr_refuses_unported_and_missing_device(models,
                                                            monkeypatch):
    _, tocr, path = models
    tocr.dewarp = "spline"          # no such normalizer, on either path
    for dp in (0, 1):
        with pytest.raises(ValueError, match="normalizer"):
            tcli.predict_pages(tocr, [np.ones((20, 30), np.float32)],
                               device_preprocess=dp)
    tocr.dewarp = "center"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("load", path)
    monkeypatch.delenv("device", raising=False)       # default: cuda
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["page.png"])
    with pytest.raises(RuntimeError, match="CUDA"):
        CLSTMOCR(device="cuda")


def test_torch_clstmocr_usage_without_load(monkeypatch, capsys):
    monkeypatch.delenv("load", raising=False)
    assert tcli.main([]) == 1
    assert "load=" in capsys.readouterr().out


def test_torch_greedy_and_decode_match_jax():
    rng = np.random.RandomState(2)
    probs = rng.dirichlet(np.ones(5), size=(3, 40)).astype(np.float32)
    probs[0, 5:9] = 0.2                    # ties: argmax takes the first
    tids, tvals = tctc.greedy_frames(torch.from_numpy(probs))
    jids, jvals = jctc.greedy_frames(jnp.asarray(probs))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(tvals.numpy(), np.asarray(jvals))
    for r in range(3):
        for pos in (False, True):
            assert (tctc.decode_frames(tids[r].numpy(), tvals[r].numpy(), pos)
                    == jctc.decode_frames(jids[r], jvals[r], pos))
        assert (tctc.trivial_decode(torch.from_numpy(probs[r]), 30, True)
                == jctc.trivial_decode(probs[r], 30, True))


def test_torch_codec_matches_jax():
    texts = ["hello world", "Grüße", "abc"]
    t, j = Codec.build(texts), JCodec.build(texts)
    assert t.codec == j.codec and t.size() == j.size()
    for s in ("hello", "zzz ü", ""):
        assert t.encode(s) == j.encode(s)
        assert t.decode(t.encode(s)) == j.decode(j.encode(s))
    assert t.dropped == j.dropped
    assert t.dropped_report() == j.dropped_report()
    with pytest.raises(KeyError):
        t.encode("q", strict=True)
    assert Codec([5, 0, 7]).codec == JCodec([5, 0, 7]).codec


def test_torch_port_imports_no_jax():
    """Every module of the port imports without JAX or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import clstm_tpu_torch\n"
        "for m in pkgutil.walk_packages(clstm_tpu_torch.__path__, "
        "'clstm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'clstm_tpu' or k.startswith('clstm_tpu.')]\n"
        "assert not bad, bad\n"
        "new = ('clstm_tpu_torch.io.native', "
        "'clstm_tpu_torch.cli.clstmfilter', "
        "'clstm_tpu_torch.cli.clstmfiltertrain')\n"
        "assert all(m in sys.modules for m in new), new\n"
        "print(len([k for k in sys.modules "
        "if k.startswith('clstm_tpu_torch.')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 35
