"""The port's corpus pipeline — make_batches, pad_batch_rows, truncation
counts, the device-resident DeviceDataset with its epoch plans and its
from_files build with the normalization on the device — against the JAX
package's on CPU, and the K-step block against single steps.

Plans and batches are drawn from numpy RandomStates in both packages, so
they must be EQUAL for the same seed: same texts, lengths, targets and rows
in the same order. from_files prepares lines on the device in both, so its
lines are held to the prepare envelope of tests/test_preprocess.py (a width
+-1 in at most 1 line in 10, mean |dx| < 2e-4).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from clstm_tpu.data import dataset as jds  # noqa: E402
from clstm_tpu.data.device_cache import DeviceDataset as JDeviceDataset  # noqa: E402,E501
from clstm_tpu.data.lines import LineGenerator, make_dataset_dir  # noqa: E402
from clstm_tpu.models.codec import Codec as JCodec  # noqa: E402
from clstm_tpu_torch.data import dataset as tds  # noqa: E402
from clstm_tpu_torch.data.device_cache import DeviceDataset  # noqa: E402
from clstm_tpu_torch.models.codec import Codec  # noqa: E402
from clstm_tpu_torch.models.hl import CLSTMOCR  # noqa: E402
# auto_t_cuts' lattice weight in the JAX package: the port's default is
# the card's calibration, so the comparisons set it alike.
from test_torch_auto_cuts import JAX_S_WEIGHT  # noqa: E402

MEAN_DX = 2e-4
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run many small ops: one intra-op thread keeps them from
    spinning against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _samples(n=23, seed=0, width=(40, 400)):
    rng = np.random.RandomState(seed)
    texts = ["".join(rng.choice(list("abcdef "), size=rng.randint(3, 20)))
             for _ in range(n)]
    xs = [rng.rand(rng.randint(*width), 16).astype(np.float32)
          for _ in range(n)]
    return list(zip(xs, texts))


def _codecs(samples):
    texts = [t for _, t in samples]
    return Codec.build(texts), JCodec.build(texts)


def _np(v):
    return v.numpy() if torch.is_tensor(v) else np.asarray(v)


def _same_batch(a: dict, b: dict, keys=("x", "lengths", "targets",
                                         "target_lengths")):
    assert a["texts"] == b["texts"]
    for k in keys:
        np.testing.assert_array_equal(_np(a[k]), _np(b[k]), err_msg=k)


@pytest.mark.parametrize("buckets", ["default", "fine"])
def test_torch_make_batches_and_padding_match_jax(buckets):
    samples = _samples(n=40, seed=1, width=(40, 1400))
    tc, jc = _codecs(samples)
    tb = tds.T_BUCKETS_FINE if buckets == "fine" else tds.T_BUCKETS
    assert tds.T_BUCKETS_FINE == jds.T_BUCKETS_FINE
    got = list(tds.make_batches(samples, tc, 8, t_buckets=tb,
                                rng=np.random.RandomState(3)))
    want = list(jds.make_batches(samples, jc, 8, t_buckets=tb,
                                 rng=np.random.RandomState(3)))
    assert len(got) == len(want) > 4
    for a, b in zip(got, want):
        _same_batch(a, b)
        _same_batch(tds.pad_batch_rows(a, 8), jds.pad_batch_rows(b, 8))
    assert len(list(tds.make_batches(samples, tc, 8, drop_remainder=True))) \
        == len(list(jds.make_batches(samples, jc, 8, drop_remainder=True)))


def test_torch_truncation_counts_match_jax():
    samples = [(np.zeros((w, 4), np.float32), "ab" * n) for w, n in
               ((100, 3), (5000, 2), (4097, 200), (300, 256), (10, 1))]
    tc, jc = _codecs(samples)
    got = tds.count_truncations(samples, tc)
    assert got == jds.count_truncations(samples, jc) == (2, 2)
    assert tds.truncation_report(*got) == jds.truncation_report(*got)
    assert tds.truncation_report(0, 0) == ""


def _caches(samples, **kw):
    tc, jc = _codecs(samples)
    return DeviceDataset(samples, tc, device=CPU, **kw), JDeviceDataset(
        samples, jc, **kw)


@pytest.mark.parametrize("merge", [False, True])
def test_torch_cache_groups_and_epoch_match_jax(merge):
    kw = dict(t_buckets=tds.T_BUCKETS_FINE, merge_sb=True) if merge else {}
    t, j = _caches(_samples(n=31, seed=2, width=(40, 900)), **kw)
    assert len(t) == len(j) == 31 and t.nbytes == j.nbytes
    assert [(g["tb"], g["sb"], g["n"], g["texts"]) for g in t.groups] == [
        (g["tb"], g["sb"], g["n"], g["texts"]) for g in j.groups]
    for gt, gj in zip(t.groups, j.groups):
        for k in ("x", "targets", "lengths", "tlens", "host_lengths"):
            np.testing.assert_array_equal(_np(gt[k]), _np(gj[k]))
    for epoch in range(2):
        got = list(t.epoch(8, rng=np.random.RandomState(epoch)))
        want = list(j.epoch(8, rng=np.random.RandomState(epoch)))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same_batch(a, b, ("x", "lengths", "targets", "target_lengths",
                               "host_lengths"))


def _ref_key(ref):
    return (ref["group"]["tb"], ref["group"]["sb"], ref["texts"],
            list(np.asarray(ref["host_lengths"])))


def test_torch_epoch_refs_match_jax():
    t, j = _caches(_samples(n=27, seed=4))
    rt, rj = np.random.RandomState(5), np.random.RandomState(5)
    for _ in range(2):
        got = [_ref_key(r) for r in t.epoch_refs(4, rng=rt)]
        want = [_ref_key(r) for r in j.epoch_refs(4, rng=rj)]
        assert got == want and len(got) > 4


def _block_key(block):
    return (block["group"]["tb"], block["k"], block["nreal"],
            block["nreal_per"], block["texts"],
            [list(np.asarray(h)) for h in block["host_lengths"]])


@pytest.mark.parametrize("epochs,clamp_at", [(1, None), (3, None), (3, 2)])
def test_torch_epoch_blocks_match_jax(epochs, clamp_at):
    """Blocks over multi-epoch plans; with ``clamp_at``, the block there
    is clamped (its plan exhausted) in both, and later blocks of that plan
    must be skipped alike."""
    t, j = _caches(_samples(n=29, seed=6, width=(40, 700)),
                   t_buckets=tds.T_BUCKETS_FINE, merge_sb=True)
    rt, rj = np.random.RandomState(9), np.random.RandomState(9)
    got, want = [], []
    for n, (bt, bj) in enumerate(zip(
            t.epoch_blocks(4, 3, rng=rt, epochs=epochs),
            j.epoch_blocks(4, 3, rng=rj, epochs=epochs))):
        got.append(_block_key(bt))
        want.append(_block_key(bj))
        if n == clamp_at:
            bt["exhaust"]()
            bj["exhaust"]()
    assert got == want and len(got) > 3
    assert sum(b[2] for b in got) == (29 * epochs if clamp_at is None
                                      else sum(b[2] for b in want))


def test_torch_a_block_not_run_leaves_the_next_its_own_rows():
    """Blocks handed out and never run (a caller that picks one block of
    several, as the benchmark's check does) leave every later block of
    their plan its own rows: idx_all[j + s] holds the rows of its texts.
    Before, j was the device counter the run blocks write back, and a
    skipped block left the next one the rows it skipped."""
    samples = _samples(n=40, seed=6, width=(100, 120))   # one group
    codec = Codec.build([t for _, t in samples])
    cache = DeviceDataset(samples, codec, device=CPU,
                          t_buckets=tds.T_BUCKETS_FINE, merge_sb=True)

    def rows_texts(ref, s):
        g = ref["group"]
        return [g["texts"][i] for i in ref["idx_all"][ref["j"] + s].tolist()
                if i < g["n"]]
    n = 0
    for block in cache.epoch_blocks(2, 3, rng=np.random.RandomState(9)):
        assert [rows_texts(block, s) for s in range(block["k"])] == \
            block["texts"]
        n += 1
    assert n > 3


def _cache_key(c):
    return [(g["tb"], g["sb"], g["n"], g["texts"]) for g in c.groups]


@pytest.mark.parametrize("penalty", [0.0, 5e3, 1e9])
def test_torch_auto_buckets_match_jax(penalty, monkeypatch):
    """t_buckets="auto": the groups the DP's cuts give (T and S buckets,
    members in order, frames, targets, lengths) are the JAX package's for
    the same hints, merged over S as the CLI asks."""
    monkeypatch.setattr(tds, "AUTO_S_WEIGHT", JAX_S_WEIGHT)
    hints = dict(batch_size=4, epochs=64, k=8, dispatch_penalty_rows=penalty)
    t, j = _caches(_samples(n=37, seed=8, width=(30, 1500)),
                   t_buckets="auto", merge_sb=True, auto_hints=hints)
    assert _cache_key(t) == _cache_key(j) and len(t) == len(j) == 37
    assert t.nbytes == j.nbytes
    for gt, gj in zip(t.groups, j.groups):
        for k in ("x", "targets", "lengths", "tlens", "host_lengths"):
            np.testing.assert_array_equal(_np(gt[k]), _np(gj[k]))
    if penalty == 0.0:
        # Without a dispatch cost the DP cuts off the grids.
        assert {g["tb"] for g in t.groups} - set(tds.T_BUCKETS_FINE)


def test_torch_from_files_matches_jax(tmp_path):
    """Raw PNGs in, normalization on the device: the same groups, targets
    and lengths as the JAX package's from_files, lines within the prepare
    envelope."""
    gen = LineGenerator(seed=11)
    texts = [gen.random_sentence() for _ in range(12)]
    manifest = make_dataset_dir(str(tmp_path / "lines"), 12, gen=gen,
                                texts=texts)
    ds = tds.OcrDataset(manifest, target_height=32, dewarp="center")
    assert ds.texts() == texts
    tc, jc = Codec.build(texts), JCodec.build(texts)
    kw = dict(target_height=32, dewarp="center", pad=ds.pad, chunk_size=5,
              t_buckets=tds.T_BUCKETS_FINE, merge_sb=True)
    t = DeviceDataset.from_files(ds.files, texts, tc, device=CPU, **kw)
    j = JDeviceDataset.from_files(ds.files, texts, jc, **kw)
    assert len(t) == len(j) == 12 and t.nbytes == j.nbytes
    assert [(g["tb"], g["sb"], g["texts"]) for g in t.groups] == [
        (g["tb"], g["sb"], g["texts"]) for g in j.groups]
    mismatch, diffs = 0, []
    for gt, gj in zip(t.groups, j.groups):
        for k in ("targets", "tlens"):
            np.testing.assert_array_equal(_np(gt[k]), _np(gj[k]))
        xt, xj = _np(gt["x"]), _np(gj["x"])
        for i in range(gt["n"] + 1):
            lt, lj = int(gt["host_lengths"][i]), int(gj["host_lengths"][i])
            assert abs(lt - lj) <= 1 and lt == int(gt["lengths"][i])
            assert np.all(xt[i, lt:] == 0.0)
            if lt != lj:
                mismatch += 1
            elif lt:
                diffs.append(np.abs(xt[i, :lt] - xj[i, :lj]).mean())
        assert gt["host_lengths"][-1] == 0          # the sentinel row
    assert mismatch <= 1 and np.mean(diffs) < MEAN_DX, (mismatch, diffs)


def _ocr(codec, seed=1, nhidden=8):
    ocr = CLSTMOCR(target_height=16, dewarp="none", device=CPU)
    ocr.createBidi(codec, nhidden, seed=seed)
    ocr.setLearningRate(1e-3, 0.9)
    return ocr


def _params(ocr):
    return [p.detach().clone() for p in ocr.net.parameters()]


def test_torch_train_batch_block_equals_single_steps():
    """A k=4 block (train_batch_block) and 4 train_batch_refs steps over
    the same plan from the same state: the same steps in the same order,
    so the parameters and reports are bitwise equal."""
    rng = np.random.RandomState(0)
    samples = [(rng.rand(50, 16).astype(np.float32),
                "".join(rng.choice(list("abc "), size=6))) for _ in range(16)]
    codec = Codec.build([t for _, t in samples])
    ocr_b, ocr_r = _ocr(codec), _ocr(codec)
    dds = DeviceDataset(samples, codec, device=CPU)
    blocks = list(dds.epoch_blocks(4, 4))
    assert len(blocks) == 1 and blocks[0]["k"] == 4
    mb = ocr_b.train_batch_block(blocks[0])
    reports = [ocr_r.train_batch_refs(ref)["report"]
               for ref in DeviceDataset(samples, codec,
                                        device=CPU).epoch_refs(4)]
    assert len(reports) == 4
    assert torch.equal(mb["report_all"], torch.stack(reports))
    assert torch.equal(mb["loss"], reports[-1][0])
    for a, b in zip(_params(ocr_b), _params(ocr_r)):
        assert torch.equal(a, b)
    assert ocr_b.state.step == ocr_r.state.step == 4


def test_torch_clamped_block_runs_nvalid_steps():
    """nvalid runs only the first min(nvalid, k) batches: later report
    rows are zero, the state steps nvalid times, and the plan is marked
    exhausted so no later block of it is handed out."""
    rng = np.random.RandomState(0)
    samples = [(rng.rand(50, 16).astype(np.float32),
                "".join(rng.choice(list("abc "), size=6))) for _ in range(32)]
    codec = Codec.build([t for _, t in samples])
    ocr = _ocr(codec)
    gen = DeviceDataset(samples, codec, device=CPU).epoch_blocks(
        4, 3, rng=np.random.RandomState(0))
    first = next(gen)
    assert first["k"] == 3
    m = ocr.train_batch_block(first, k_max=3, nvalid=2)
    assert ocr.state.step == 2
    assert bool((m["report_all"][2] == 0).all())
    assert bool((m["report_all"][:2].abs().sum(1) > 0).all())
    assert torch.equal(m["report"], m["report_all"][1])
    assert list(gen) == []


def test_torch_epoch_refs_trajectory_matches_epoch():
    """epoch_refs + train_batch_refs and epoch + train_batch over the same
    seed: the same batches and the same steps, bitwise."""
    samples = _samples(n=19, seed=3, width=(40, 150))
    codec = Codec.build([t for _, t in samples])

    def run(use_refs):
        ocr = _ocr(codec, seed=0, nhidden=12)
        dds = DeviceDataset(samples, codec, device=CPU)
        rng = np.random.RandomState(7)
        for _ in range(2):
            for batch in (dds.epoch_refs(8, rng=rng) if use_refs
                          else dds.epoch(8, rng=rng)):
                m = (ocr.train_batch_refs(batch) if use_refs else
                     ocr.train_batch({k: batch[k] for k in (
                         "x", "lengths", "targets", "target_lengths")}))
        return _params(ocr), m["report"]

    (pa, ra), (pb, rb) = run(True), run(False)
    assert torch.equal(ra, rb)
    for a, b in zip(pa, pb):
        assert torch.equal(a, b)


def test_torch_from_files_auto_matches_jax(tmp_path, monkeypatch):
    """from_files with t_buckets="auto" solves the cuts over the host's
    width estimates, as the JAX package's: the same groups, targets and
    lengths; bucket_dp_rows_per_sec=0 makes both measured penalties 0."""
    monkeypatch.setattr(tds, "AUTO_S_WEIGHT", JAX_S_WEIGHT)
    monkeypatch.setenv("bucket_dp_rows_per_sec", "0")
    gen = LineGenerator(seed=12)
    texts = [gen.random_sentence() for _ in range(14)]
    manifest = make_dataset_dir(str(tmp_path / "lines"), 14, gen=gen,
                                texts=texts)
    ds = tds.OcrDataset(manifest, target_height=32, dewarp="center")
    tc, jc = Codec.build(texts), JCodec.build(texts)
    kw = dict(target_height=32, dewarp="center", pad=ds.pad, chunk_size=5,
              t_buckets="auto", merge_sb=True,
              auto_hints=dict(batch_size=4, epochs=64, k=8))
    t = DeviceDataset.from_files(ds.files, texts, tc, device=CPU, **kw)
    j = JDeviceDataset.from_files(ds.files, texts, jc, **kw)
    assert _cache_key(t) == _cache_key(j) and len(t) == 14
    for gt, gj in zip(t.groups, j.groups):
        for k in ("targets", "tlens"):
            np.testing.assert_array_equal(_np(gt[k]), _np(gj[k]))
        assert np.all(np.abs(gt["host_lengths"].astype(int)
                             - gj["host_lengths"]) <= 1)
