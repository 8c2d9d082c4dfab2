"""The port's on-device preprocessing (ops/preprocess.py) against the JAX
package's, on CPU: prepare_batch_device for each normalizer kind, the u8
upload, the host helpers, train-time augmentation from JAX's own draws, and
clstmocr's device_preprocess=1 path against JAX's on frame ids.

Tolerances are those of the JAX package's own parity envelope
(tests/test_preprocess.py): a line's length may differ by +-1 in at most 1
line of 10 (a knife-edge f32 center column or ink spread), the mean |dx| of
the lines of equal length is < 2e-4, and padded frames are exactly 0.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from clstm_tpu.cli import clstmocr as jcli  # noqa: E402
from clstm_tpu.data.lines import LineGenerator  # noqa: E402
from clstm_tpu.models.codec import Codec as JCodec  # noqa: E402
from clstm_tpu.models.hl import CLSTMOCR as JOCR  # noqa: E402
from clstm_tpu.ops import preprocess as jp  # noqa: E402
from clstm_tpu.train import TrainState as JTrainState  # noqa: E402
from clstm_tpu_torch.cli import clstmocr as tcli  # noqa: E402
from clstm_tpu_torch.models import prefab as tprefab  # noqa: E402
from clstm_tpu_torch.models.hl import CLSTMOCR  # noqa: E402
from clstm_tpu_torch.ops import preprocess as tp  # noqa: E402
from clstm_tpu_torch.ops.ctc import mktargets_ids  # noqa: E402
from clstm_tpu_torch.train import TrainState, make_train_step  # noqa: E402

TH, PAD = 48, 16
MEAN_DX = 2e-4          # tests/test_preprocess.py:60
LEN_MISMATCH_MAX = 1    # of 10 lines, each by at most 1 frame
# augment_lines from the same draws: the same f32 multiply-add and clip,
# maybe fused differently (1 ulp of values <= 1.5).
AUG_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run many small ops: one intra-op thread keeps them from
    spinning against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _u8(img):
    """An image rounded to k/255 values, as a PNG decode gives."""
    return (np.rint(img * 255.0).astype(np.float32) / np.float32(255.0))


@pytest.fixture(scope="module")
def lines():
    gen = LineGenerator(seed=11)
    return [gen.render(gen.random_text(6, 18)) for _ in range(10)]


def _both(images, kind, out_T=512):
    buf, hs, ws = jp.pack_raw_images(images)
    xj, lj = jp.prepare_batch_device(
        jnp.asarray(buf), jnp.asarray(hs), jnp.asarray(ws), kind=kind,
        target_height=TH, out_T=out_T, pad=PAD)
    xt, lt = tp.prepare_batch_device(
        torch.from_numpy(buf), torch.from_numpy(hs), torch.from_numpy(ws),
        kind=kind, target_height=TH, out_T=out_T, pad=PAD)
    return np.asarray(xj), np.asarray(lj), xt.numpy(), lt.numpy()


def _check_envelope(xj, lj, xt, lt):
    assert np.all(np.abs(lj.astype(int) - lt) <= 1), (lj, lt)
    same = lj == lt
    assert np.sum(~same) <= LEN_MISMATCH_MAX, (lj, lt)
    diffs = [np.abs(xt[i, :lt[i]] - xj[i, :lj[i]]).mean()
             for i in np.flatnonzero(same)]
    assert np.mean(diffs) < MEAN_DX, np.mean(diffs)
    for i in range(len(lt)):
        assert np.all(xt[i, lt[i]:] == 0.0)
    assert np.isfinite(xt).all()


@pytest.mark.parametrize("kind", ["none", "mean", "center"])
def test_torch_prepare_matches_jax(lines, kind):
    _check_envelope(*_both(lines, kind))


def test_torch_prepare_png_lines_match_jax(lines):
    """8-bit lines take the uint8 upload in both packages."""
    images = [_u8(im) for im in lines]
    assert jp.pack_raw_images(images)[0].dtype == np.uint8
    _check_envelope(*_both(images, "center"))


def test_torch_prepare_wide_lines_match_jax():
    """Buffers wider than 1536 columns take the grouped convolution in
    place of the per-line Toeplitz product, in both packages."""
    gen = LineGenerator(seed=3)
    images = [_u8(gen.render(gen.random_text(60, 90))) for _ in range(3)]
    assert max(im.shape[1] for im in images) > 1536
    _check_envelope(*_both(images, "center", out_T=4096))


def test_torch_prepare_u8_table_and_upload(lines):
    ref = np.arange(256, dtype=np.float32) / np.float32(255.0)
    table = tp.u8_table(torch.device("cpu")).numpy()
    np.testing.assert_array_equal(table.view(np.int32), ref.view(np.int32))
    images = [_u8(im) for im in lines[:4]]
    buf, hs, ws = tp.pack_raw_images(images)
    assert buf.dtype == np.uint8
    f32 = buf.astype(np.float32) / np.float32(255.0)
    args = (torch.from_numpy(hs), torch.from_numpy(ws))
    xu, lu = tp.prepare_batch_device(torch.from_numpy(buf), *args)
    xf, lf = tp.prepare_batch_device(torch.from_numpy(f32), *args)
    assert torch.equal(xu, xf) and torch.equal(lu, lf)
    with pytest.raises(ValueError):
        tp.prepare_batch_device(torch.from_numpy(buf).double(), *args)


def test_torch_prepare_padding_invariance(lines):
    """A bigger raw buffer (more zero padding) gives the same length and a
    near-identical line: the prepare honors (h, w), not the buffer."""
    im = lines[0]
    buf, h, w = tp.pack_raw_images([im])
    big = np.zeros((1, buf.shape[1] + 13, buf.shape[2] + 29), np.float32)
    big[0, :im.shape[0], :im.shape[1]] = im
    hw = (torch.from_numpy(h), torch.from_numpy(w))
    x1, l1 = tp.prepare_batch_device(torch.from_numpy(buf), *hw, out_T=512)
    x2, l2 = tp.prepare_batch_device(torch.from_numpy(big), *hw, out_T=512)
    assert int(l1[0]) == int(l2[0])
    assert float((x1 - x2).abs().mean()) < 5e-4


def test_torch_estimate_and_pack_match_jax(lines):
    images = lines + [_u8(im) for im in lines[:3]]
    for group in (images[:10], images[10:], images):
        for a, b in zip(tp.pack_raw_images(group), jp.pack_raw_images(group)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for th, pad in ((48, 16), (24, 0)):
            assert (tp.estimate_out_T(group, th, pad)
                    == jp.estimate_out_T(group, th, pad))


def _jax_draws(key, B, T, H, strength):
    """augment_lines' draws, as clstm_tpu/ops/preprocess.py:368-376 makes
    them."""
    k1, k2, k3, k4 = jax.random.split(key, 4)
    amp = 1.0 + 0.2 * strength * jax.random.uniform(
        k1, (B, 1, 1), minval=-1.0, maxval=1.0)
    noise = 0.05 * strength * jax.random.normal(k2, (B, T, H))
    max_t = max(int(round(4 * strength)), 0)
    max_h = max(int(round(2 * strength)), 0)
    sh_t = jax.random.randint(k3, (B,), -max_t, max_t + 1)
    sh_h = jax.random.randint(k4, (B,), -max_h, max_h + 1)
    return [torch.from_numpy(np.array(a)) for a in (amp, noise, sh_t, sh_h)]


@pytest.mark.parametrize("strength", [0.0, 1.0, 2.5])
def test_torch_augment_matches_jax_draws(strength):
    rng = np.random.RandomState(0)
    x = rng.rand(4, 64, 16).astype(np.float32)
    lengths = np.array([64, 40, 10, 1], np.int32)
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        want = np.asarray(jp.augment_lines(key, jnp.asarray(x),
                                           jnp.asarray(lengths), strength))
        got = tp.augment_lines_with(torch.from_numpy(x),
                                    torch.from_numpy(lengths),
                                    *_jax_draws(key, 4, 64, 16, strength))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=AUG_ATOL)


def test_torch_augment_invariants():
    """The port's own draws: strength 0 is the identity on valid frames,
    padding stays exactly zero, the output is bounded, a seed and step
    draw the same each time and other steps draw otherwise, and shifts are
    translations without wraparound."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(4, 64, 16).astype(np.float32))
    lengths = torch.tensor([64, 40, 10, 1], dtype=torch.int32)
    mask = (torch.arange(64)[None, :] < lengths[:, None])[..., None]

    def aug(step, strength=1.0, xx=x, ll=lengths):
        gen = tp.augment_generator(7, step, xx.device)
        return tp.augment_lines(gen, xx, ll, strength)

    torch.testing.assert_close(aug(0, 0.0), x * mask, rtol=0, atol=1e-6)
    y = aug(0)
    assert bool((y[~mask.expand_as(y)] == 0).all())
    assert float(y.min()) >= 0.0 and float(y.max()) <= 1.5
    assert torch.equal(y, aug(0))
    assert float((aug(1) - y).abs().max()) > 1e-3
    corner = torch.zeros(1, 32, 16)
    corner[0, 31, 15] = 1.0
    for step in range(32):
        z = aug(step, xx=corner, ll=torch.tensor([32], dtype=torch.int32))
        assert float(z[0, :8].max()) < 0.5 and float(z[0, :, :8].max()) < 0.5


def test_torch_train_step_with_augment_changes_loss():
    spec, net = tprefab.make_net_init(
        "bidi", {"ninput": 8, "nhidden": 8, "noutput": 6},
        torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    B, T = 4, 32
    batch = {"x": torch.from_numpy(rng.rand(B, T, 8).astype(np.float32)),
             "lengths": torch.tensor([32, 30, 20, 25], dtype=torch.int32),
             "targets": torch.from_numpy(np.stack(
                 [mktargets_ids(rng.randint(1, 6, size=3))
                  for _ in range(B)])),
             "target_lengths": torch.full((B,), 7, dtype=torch.int32)}

    def first_loss(augment):
        state = TrainState.create(
            tprefab.make_net_init(
                "bidi", {"ninput": 8, "nhidden": 8, "noutput": 6},
                torch.Generator().manual_seed(0))[1])
        step = make_train_step(spec, lr=1e-3, momentum=0.9, augment=augment)
        losses = [float(step(state, batch)[1]["loss"]) for _ in range(2)]
        return losses

    plain, aug, again = first_loss(0.0), first_loss(1.0), first_loss(1.0)
    assert np.isfinite(aug).all()
    assert aug[0] != plain[0]             # the batch was distorted
    assert aug[0] != aug[1]               # each step draws afresh
    assert aug == again                   # from (augment_seed, step)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """A JAX bidi OCR model with uniform ±0.5 weights (argmax margins well
    above f32 noise), saved as .clstm and loaded by the port."""
    jocr = JOCR(target_height=TH)
    jocr.createBidi(JCodec.build(["abcdefg"]), nhidden=8)
    rng = np.random.RandomState(0)
    jocr.state = JTrainState.create(jax.tree.map(
        lambda a: jnp.asarray(rng.uniform(-0.5, 0.5, a.shape), jnp.float32),
        jocr.state.params))
    path = str(tmp_path_factory.mktemp("model") / "bidi.clstm")
    jocr.save(path, sidecar=False)
    tocr = CLSTMOCR(device="cpu")
    tocr.load(path)
    return jocr, tocr


def test_torch_predict_pages_device_matches_jax(models, lines):
    """clstmocr's device_preprocess=1 path: per line the same width (but
    for the envelope's one line of ten) and, where it is the same, the
    same frame ids and decoded characters as JAX's."""
    jocr, tocr = models
    images = [_u8(im) for im in lines]
    want = jcli.predict_pages(jocr, images, device_preprocess=1)
    got = tcli.predict_pages(tocr, images)          # the default: 1
    assert sorted(got) == sorted(want) == list(range(len(images)))
    mismatch = 0
    for i in range(len(images)):
        jcls, jpos, jvals, jscale = want[i]
        tcls, tpos, tvals, tscale = got[i]
        if tscale != jscale:
            mismatch += 1
            continue
        assert (tcls, tpos) == (jcls, jpos)
        # The probabilities follow x, whose knife-edge center columns may
        # differ (the envelope above): 2e-4 seen at nhidden 8.
        np.testing.assert_allclose(tvals, jvals, atol=1e-3)
    assert mismatch <= LEN_MISMATCH_MAX
    ids, vals, lengths = tocr.predict_batch_images(images[:3])
    assert ids.shape == vals.shape and lengths.shape == (3,)


def test_torch_predict_batch_images_prepares_in_chunks(models, lines,
                                                       monkeypatch):
    """One bucket of more lines than PREPARE_CHUNK: the port prepares it in
    chunks of at most PREPARE_CHUNK lines (each packed at its own size) and
    predicts it as one batch; lengths and frame ids against JAX's
    predict_batch_images, which prepares all the lines in one call, within
    the envelope (each of the 10 lines appears 7 times)."""
    jocr, tocr = models
    images = [_u8(lines[i % len(lines)]) for i in range(tp.PREPARE_CHUNK + 6)]
    rows = []
    prepare = tp.prepare_batch_device

    def spy(imgs, *args, **kw):
        rows.append(imgs.shape[0])
        return prepare(imgs, *args, **kw)

    monkeypatch.setattr(tp, "prepare_batch_device", spy)
    ids, vals, lengths = tocr.predict_batch_images(images)
    assert rows == [tp.PREPARE_CHUNK, 6]
    jids, jvals, jlengths = jocr.predict_batch_images(images)
    assert ids.shape == jids.shape and lengths.shape == (len(images),)
    assert np.all(np.abs(lengths - jlengths) <= 1)
    same = np.flatnonzero(lengths == jlengths)
    assert len(images) - len(same) <= 7 * LEN_MISMATCH_MAX
    for i in same:
        L = lengths[i]
        np.testing.assert_array_equal(ids[i, :L], jids[i, :L])
        np.testing.assert_allclose(vals[i, :L], jvals[i, :L], atol=1e-3)
