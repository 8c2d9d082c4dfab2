"""The port's string-transduction path against the JAX package's, on CPU:
make_text_batches, TextDeviceDataset with the one-hot expansion in the
step, CLSTMText (encode_input, its training steps, predict, the .clstm
file with icodec and input_repeat across packages), clstmfiltertrain on
each of its three paths and clstmfilter batched and single.

Both packages run the same steps on the same batches from one .clstm
file (the JAX package through lax.scan on CPU, the port through its
kernels' plain versions), so losses and weights are held to
tests/test_torch_train.py's STEP_RTOL/STEP_ATOL (f32 sums in another
order), plans, batches and decoded strings to equality.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from test_torch_train import STEP_ATOL, STEP_RTOL  # noqa: E402

from clstm_tpu.cli import clstmfilter as jfilter  # noqa: E402
from clstm_tpu.cli import clstmfiltertrain as jcli  # noqa: E402
from clstm_tpu.data import dataset as jds  # noqa: E402
from clstm_tpu.data.device_cache import TextDeviceDataset as JTextDD  # noqa: E402,E501
from clstm_tpu.io.proto import load_net as jload_net  # noqa: E402
from clstm_tpu.models.codec import Codec as JCodec  # noqa: E402
from clstm_tpu.models.hl import CLSTMText as JText  # noqa: E402
from clstm_tpu_torch.cli import clstmfilter as tfilter  # noqa: E402
from clstm_tpu_torch.cli import clstmfiltertrain as tcli  # noqa: E402
from clstm_tpu_torch.data import dataset as tds  # noqa: E402
from clstm_tpu_torch.data.device_cache import (  # noqa: E402
    DeviceDataset, TextDeviceDataset)
from clstm_tpu_torch.models.codec import Codec  # noqa: E402
from clstm_tpu_torch.models.hl import TEXT_ONE_BUCKETS, CLSTMText  # noqa: E402
from clstm_tpu_torch.train import gather_batch, onehot_frames  # noqa: E402

CPU = torch.device("cpu")
# A toy grapheme->phoneme task over 5 letters: 'ch' -> 'C', 'ee' -> 'I',
# every other letter maps to itself or its neighbour (bench.py's run-cmu
# task in small).
LETTERS = "acehs"
RULES = (("ch", "C"), ("ee", "I"), ("s", "z"))


def _g2p(word: str) -> str:
    for a, b in RULES:
        word = word.replace(a, b)
    return word


def _pairs(n=24, seed=0, lo=2, hi=8):
    rng = np.random.RandomState(seed)
    words = ["".join(rng.choice(list(LETTERS), size=rng.randint(lo, hi)))
             for _ in range(n)]
    return [(w, _g2p(w)) for w in words]


def _codecs(pairs):
    ins, outs = [a for a, _ in pairs], [b for _, b in pairs]
    return ((Codec.build(ins), Codec.build(outs)),
            (JCodec.build(ins), JCodec.build(outs)))


def _np(v):
    return v.numpy() if torch.is_tensor(v) else np.asarray(v)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Many small ops: one intra-op thread keeps them from spinning against
    the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("k", [1, 3])
def test_torch_make_text_batches_match_jax(k):
    pairs = _pairs(n=40, seed=1, lo=1, hi=12) + [("", "a")]
    (ti, to), (ji, jo) = _codecs(pairs)
    assert tds.TEXT_T_BUCKETS == jds.TEXT_T_BUCKETS
    got = list(tds.make_text_batches(pairs, ti, to, 8, input_repeat=k,
                                     rng=np.random.RandomState(2)))
    want = list(jds.make_text_batches(pairs, ji, jo, 8, input_repeat=k,
                                      rng=np.random.RandomState(2)))
    assert len(got) == len(want) > 4
    for a, b in zip(got, want):
        assert a["texts"] == b["texts"]
        for key in ("x", "lengths", "targets", "target_lengths"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
        pa, pb = tds.pad_batch_rows(a, 8), jds.pad_batch_rows(b, 8)
        np.testing.assert_array_equal(pa["x"], pb["x"])


@pytest.mark.parametrize("k", [1, 3])
def test_torch_text_device_dataset_matches_jax(k):
    """Groups array for array (int ids, -1 on padding and the sentinel
    row), nbytes, truncation counts (an input past 512 frames, an output
    past 255 characters) and the epoch blocks for one seed."""
    pairs = _pairs(n=37, seed=3, lo=1, hi=14)
    pairs += [("ace" * 60, "a"), ("ac", "e" * 300), ("", "a")]
    (ti, to), (ji, jo) = _codecs(pairs)
    t = TextDeviceDataset(pairs, ti, to, input_repeat=k, device=CPU)
    j = JTextDD(pairs, ji, jo, input_repeat=k)
    assert (t.t_truncated, t.s_truncated) == (j.t_truncated, j.s_truncated)
    assert (t.t_truncated, t.s_truncated) == ((1, 1) if k == 3 else (0, 1))
    assert t.nbytes == j.nbytes and len(t) == len(j) == len(pairs)
    assert [(g["tb"], g["sb"], g["n"], g["texts"], g["onehot"])
            for g in t.groups] == [(g["tb"], g["sb"], g["n"], g["texts"],
                                    g["onehot"]) for g in j.groups]
    for gt, gj in zip(t.groups, j.groups):
        for key in ("x", "targets", "lengths", "tlens", "host_lengths"):
            np.testing.assert_array_equal(_np(gt[key]), _np(gj[key]),
                                          err_msg=key)
        assert gt["x"].dtype == torch.int32
        assert (_np(gt["x"])[-1] == -1).all()
    rt, rj = np.random.RandomState(4), np.random.RandomState(4)
    got = [(b["group"]["tb"], b["k"], b["nreal_per"], b["texts"])
           for b in t.epoch_blocks(4, 3, rng=rt, epochs=3)]
    want = [(b["group"]["tb"], b["k"], b["nreal_per"], b["texts"])
            for b in j.epoch_blocks(4, 3, rng=rj, epochs=3)]
    assert got == want and len(got) > 3


def test_torch_onehot_of_padding_is_zero():
    """-1 (a padded frame, the sentinel row) expands to an exact zero frame,
    as jax.nn.one_hot(-1) does, where torch's one_hot raises; the gathered
    batch of a text group equals the host path's one-hot frames."""
    ids = np.array([[0, 3, -1, 2], [-1, -1, -1, -1]], np.int32)
    got = onehot_frames(torch.from_numpy(ids), 5)
    want = np.asarray(jax.nn.one_hot(jnp.asarray(ids), 5, dtype=jnp.float32))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[0, 2].any() and not got[1].any()
    with pytest.raises(RuntimeError):
        torch.nn.functional.one_hot(torch.from_numpy(ids).long(), 5)
    pairs = _pairs(n=5, seed=5)
    (ti, to), _ = _codecs(pairs)
    dds = TextDeviceDataset(pairs, ti, to, input_repeat=2, device=CPU)
    g = dds.groups[0]
    idx = torch.arange(g["n"] + 1)
    b = gather_batch(g, idx, g["onehot"])
    assert len(dds.groups) == 1 and g["texts"] == [b for _, b in pairs]
    for r, (a, _) in enumerate(pairs):
        x = tds.encode_onehot(ti.encode(a), ti.size(), 2)
        want = np.zeros((g["tb"], ti.size()), np.float32)
        want[:x.shape[0]] = x
        np.testing.assert_array_equal(b["x"][r].numpy(), want)
    assert not b["x"][-1].any()


@pytest.mark.parametrize("k", [1, 3])
def test_torch_encode_input_matches_jax(k):
    pairs = _pairs(n=6, seed=6)
    (ti, to), (ji, jo) = _codecs(pairs)
    t, j = CLSTMText(input_repeat=k, device=CPU), JText(input_repeat=k)
    t.icodec, j.icodec = ti, ji
    for s in ("", "a", "chess", "eech", "xyz"):
        np.testing.assert_array_equal(t.encode_input(s), j.encode_input(s))


def _models(tmp_path, pairs, k=3, nhidden=16, lr=1e-2):
    """A JAX CLSTMText saved as .clstm and loaded by both packages."""
    _, (ji, jo) = _codecs(pairs)
    j = JText(input_repeat=k)
    j.createBidi(ji, jo, nhidden, seed=0)
    path = str(tmp_path / "start.clstm")
    j.save(path)
    t = CLSTMText(device=CPU)
    t.load(path)
    jj = JText()
    jj.load(path)
    for m in (t, jj):
        assert m.input_repeat == k
        m.setLearningRate(lr, 0.9)
    return t, jj, path


def _assert_params_close(tnet, jparams):
    from clstm_tpu_torch.convert import params_to_numpy
    tl = jax.tree.leaves(params_to_numpy(tnet))
    jl = jax.tree.leaves(jparams)
    assert len(tl) == len(jl) == 8
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a, np.asarray(b), rtol=STEP_RTOL,
                                   atol=STEP_ATOL)


@pytest.mark.parametrize("how", ["refs", "block"])
def test_torch_text_steps_match_jax(tmp_path, how):
    """3 steps of train_batch_refs (or one k=3 train_batch_block) on a text
    group of the device cache, from one .clstm: the same losses and
    parameters as the JAX package's."""
    pairs = _pairs(n=30, seed=7, lo=3, hi=6)     # one (16, 16) group
    t, j, _ = _models(tmp_path, pairs)
    td = TextDeviceDataset(pairs, t.icodec, t.codec, input_repeat=3,
                           device=CPU)
    jd = JTextDD(pairs, j.icodec, j.codec, input_repeat=3)
    if how == "refs":
        tl, jl = [], []
        for rt, rj in list(zip(td.epoch_refs(8, rng=np.random.RandomState(0)),
                               jd.epoch_refs(8, rng=np.random.RandomState(0))
                               ))[:3]:
            tl.append(float(t.train_batch_refs(rt)["loss"]))
            jl.append(float(j.train_batch_refs(rj)["loss"]))
        assert set(t._cached_steps) == {t.icodec.size()}
    else:
        bt = next(td.epoch_blocks(8, 3, rng=np.random.RandomState(0),
                                  epochs=3))
        bj = next(jd.epoch_blocks(8, 3, rng=np.random.RandomState(0),
                                  epochs=3))
        assert bt["k"] == bj["k"] == 3
        tl = _np(t.train_batch_block(bt)["report_all"])[:, 0]
        jl = np.asarray(j.train_batch_block(bj)["report_all"])[:, 0]
        assert set(t._multi_steps) == {(3, t.icodec.size())}
    np.testing.assert_allclose(tl, jl, rtol=STEP_RTOL, atol=STEP_ATOL)
    assert t.state.step == 3 and len(tl) == 3
    _assert_params_close(t.net, j.state.params)


def test_torch_text_and_image_groups_take_own_steps(tmp_path):
    """One model trained in turns on a text group and on an image group
    (frames of the same width): each kind takes its own built step, so the
    image step equals train_batch on its gathered frames from the same
    state, and the text step train_batch on the one-hot frames."""
    import copy
    pairs = _pairs(n=8, seed=8)
    t, _, _ = _models(tmp_path, pairs, k=1)
    ni = t.icodec.size()
    td = TextDeviceDataset(pairs, t.icodec, t.codec, device=CPU)
    rng = np.random.RandomState(0)
    samples = [(rng.rand(rng.randint(5, 16), ni).astype(np.float32), b)
               for _, b in pairs]
    dd = DeviceDataset(samples, t.codec, t_buckets=tds.TEXT_T_BUCKETS,
                       device=CPU)
    for how in ("refs", "block"):
        for ds in (td, dd, td, dd):
            ref = (next(ds.epoch_refs(8)) if how == "refs"
                   else next(ds.epoch_blocks(8, 1)))
            g = ref["group"]
            twin = copy.deepcopy(t)
            batch = gather_batch(g, ref["idx_all"][ref["j"]],
                                 g.get("onehot", 0))
            want = twin.train_batch(batch)["report"]
            got = (t.train_batch_refs(ref) if how == "refs"
                   else t.train_batch_block(ref))["report"]
            assert torch.equal(got, want)
    assert set(t._cached_steps) == {0, ni}
    assert set(t._multi_steps) == {(1, 0), (1, ni)}


def test_torch_single_samples_take_text_buckets(monkeypatch):
    """CLSTMText.train / predict bucket a single sample with TEXT_T_BUCKETS
    up to 512 frames and T_BUCKETS past it (the JAX package takes
    T_BUCKETS: 128 frames for a short word); the outputs are the JAX
    package's."""
    assert TEXT_ONE_BUCKETS[:10] == tds.TEXT_T_BUCKETS
    assert TEXT_ONE_BUCKETS[10:] == tuple(t for t in tds.T_BUCKETS
                                          if t > 512)
    pairs = _pairs(n=10, seed=9)
    (ti, to), _ = _codecs(pairs)
    t = CLSTMText(input_repeat=3, device=CPU)
    t.createBidi(ti, to, 8)
    shapes = []
    real = t.predict_batch

    def spy(x, lengths):
        shapes.append(x.shape[1])
        return real(x, lengths)
    monkeypatch.setattr(t, "predict_batch", spy)
    t.predict("chess")               # 15 frames
    t.predict("ac" * 100)            # 600 frames
    assert shapes == [16, 768]
    seen = []
    step = t.train_batch
    monkeypatch.setattr(t, "train_batch",
                        lambda b: seen.append(b["x"].shape[1]) or step(b))
    t.train("acehsac", "aCz")        # 21 frames
    assert seen == [32]


def _write_tsv(path, pairs):
    with open(path, "w", encoding="utf-8") as f:
        for a, b in pairs:
            f.write(f"{a}\t{b}\n")
    return str(path)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A toy g2p corpus (64 training, 12 test pairs) and a JAX bidi filter
    net (nhidden 16, input_repeat 3) saved as .clstm with its sidecar."""
    tmp = tmp_path_factory.mktemp("filter")
    pairs = _pairs(n=76, seed=10)
    train = _write_tsv(tmp / "train.tsv", pairs[:64])
    test = _write_tsv(tmp / "test.tsv", pairs[64:])
    _, (ji, jo) = _codecs(pairs)
    j = JText(input_repeat=3)
    j.createBidi(ji, jo, 16, seed=0)
    start = str(tmp / "start.clstm")
    j.save(start)
    return tmp, train, test, start


ENV = {"ntrain": "48", "lrate": "1e-2", "momentum": "0.9",
       "report_every": "8", "save_every": "32", "test_every": "24",
       "randseed": "0", "mesh": "1", "compile_cache": "off",
       "device": "cpu"}


def _run(mod, name, tmp, args, monkeypatch, capsys, **env):
    for key, v in dict(ENV, **env).items():
        monkeypatch.setenv(key, v)
    monkeypatch.setenv("save_name", str(tmp / name))
    log = tmp / f"{name}.jsonl"
    if log.exists():
        log.unlink()
    monkeypatch.setenv("log_jsonl", str(log))
    assert mod.main(args) == 0
    out = capsys.readouterr().out
    recs = [json.loads(ln) for ln in log.read_text().splitlines()]
    return recs, out


@pytest.mark.parametrize("path", ["pairs", "host", "device"])
def test_torch_clstmfiltertrain_matches_jax(corpus, path, monkeypatch,
                                            capsys):
    """Both CLIs from one .clstm on the same corpus and seed: batch_size=1
    (the reference's pair-at-a-time loop), cache=host (host-built
    batches) and the device cache (K=2 blocks): the same report lines,
    losses and TESTERR values, and the same saved weights."""
    tmp, train, test, start = corpus
    env = {"pairs": dict(batch_size="1", ntrain="24"),
           "host": dict(batch_size="8", cache="host"),
           "device": dict(batch_size="8", steps_per_dispatch="2")}[path]
    runs = {name: _run(mod, f"{name}-{path}", tmp, [train, test],
                       monkeypatch, capsys, load=start, **env)
            for name, mod in (("jax", jcli), ("torch", tcli))}
    (jrecs, jout), (trecs, tout) = runs["jax"], runs["torch"]
    assert [r["trial"] for r in trecs] == [r["trial"] for r in jrecs]
    for a, b in zip(trecs, jrecs):
        assert a.keys() == b.keys()
        if "loss" in a:
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=STEP_RTOL,
                                       atol=STEP_ATOL)
        else:
            assert a["test_cer"] == b["test_cer"]

    def lines(out, prefixes):
        return [ln.split(" (")[0] for ln in out.splitlines()
                if ln.startswith(prefixes)]
    prefixes = ("TESTERR", "   TRU", "   INP", "#")
    assert [ln for ln in lines(tout, prefixes) if "loaded" not in ln] == [
        ln.replace("jax-", "torch-") for ln in lines(jout, prefixes)
        if "loaded" not in ln]
    assert len(lines(tout, ("TESTERR",))) == (1 if path == "pairs" else 2)
    if path == "device":
        assert "# device cache: 0.0 MB resident" in tout
    _, jp, _, _ = jload_net(str(tmp / f"jax-{path}-last.clstm"))
    _, tp, _, _ = jload_net(str(tmp / f"torch-{path}-last.clstm"))
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=STEP_RTOL, atol=STEP_ATOL)


@pytest.mark.parametrize("path", ["host", "device"])
def test_torch_clstmfiltertrain_mesh_matches_one_rank(corpus, path,
                                                      monkeypatch, capfd):
    """mesh=2: main starts two gloo ranks on the CPU (device=cpu, shared),
    rounds batch_size 7 up to 8, and trains host-built batches (cache=host,
    train_batch) or K=2 blocks over the device cache, each rank on its rows
    with the gradients summed; against mesh=1 at batch_size 8 from the same
    .clstm: the same trials, losses and TESTERR within the JAX package's DP
    tolerance (tests/test_cli.py), the same saved weights within rtol 3e-4,
    atol 2e-5."""
    tmp, train, test, start = corpus
    env = dict(load=start, **({"cache": "host"} if path == "host" else
                              {"steps_per_dispatch": "2"}))
    one, out1 = _run(tcli, f"m1-{path}", tmp, [train, test], monkeypatch,
                     capfd, batch_size="8", **env)
    two, out2 = _run(tcli, f"m2-{path}", tmp, [train, test], monkeypatch,
                     capfd, batch_size="7", mesh="2", OMP_NUM_THREADS="1",
                     **env)
    assert "# batch_size -> 8 (mesh 2)" in out2
    assert "# data-parallel over 2 devices" in out2
    assert "data-parallel" not in out1
    assert [r["trial"] for r in two] == [r["trial"] for r in one]
    for a, b in zip(two, one):
        assert a.keys() == b.keys()
        key = "loss" if "loss" in a else "test_cer"
        np.testing.assert_allclose(a[key], b[key], rtol=3e-4, atol=2e-5)
    _, p1, _, _ = jload_net(str(tmp / f"m1-{path}-last.clstm"))
    _, p2, _, _ = jload_net(str(tmp / f"m2-{path}-last.clstm"))
    for a, b in zip(jax.tree.leaves(p2), jax.tree.leaves(p1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=3e-4,
                                   atol=2e-5)


@pytest.mark.parametrize("batch_size", ["1", "64", "5"])
def test_torch_clstmfilter_matches_jax(corpus, batch_size, monkeypatch,
                                       capsys):
    """clstmfilter, stdin to stdout, on a JAX-saved model (weights of ±0.5,
    so most frames emit): the port's output equals the JAX package's line
    for line, batched (every line in one bucket pass, or batches of 5) and
    one line at a time."""
    import io
    tmp, _, _, _ = corpus
    model = str(tmp / "served.clstm")
    _, (ji, jo) = _codecs(_pairs(n=76, seed=10))
    j = JText(input_repeat=3)
    j.createBidi(ji, jo, 16, seed=2, initial=0.5)
    j.save(model, sidecar=False)
    words = [a for a, _ in _pairs(n=30, seed=12, lo=1, hi=20)] + ["", "x"]
    outs = {}
    for name, mod in (("jax", jfilter), ("torch", tfilter)):
        monkeypatch.setenv("load", model)
        monkeypatch.setenv("batch_size", batch_size)
        monkeypatch.setenv("device", "cpu")
        monkeypatch.setattr("sys.stdin", io.StringIO(
            "".join(w + "\n" for w in words)))
        assert mod.main([]) == 0
        outs[name] = capsys.readouterr().out.splitlines()
    assert len(outs["torch"]) == len(words)
    assert outs["torch"] == outs["jax"]
    assert any(outs["torch"])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_torch_filter_clstm_crosses_packages(tmp_path, writer):
    """A filter .clstm with an icodec and input_repeat=3, saved by either
    package, loads in the other with both codecs, input_repeat and equal
    predictions."""
    pairs = _pairs(n=12, seed=13)
    (ti, to), (ji, jo) = _codecs(pairs)
    path = str(tmp_path / "f.clstm")
    if writer == "jax":
        src = JText(input_repeat=3)
        src.createBidi(ji, jo, 8, seed=1, initial=0.5)
    else:
        src = CLSTMText(input_repeat=3, device=CPU)
        src.createBidi(ti, to, 8, seed=1, initial=0.5)
    src.save(path, sidecar=False)
    dst = CLSTMText(device=CPU) if writer == "jax" else JText()
    dst.load(path)
    assert dst.input_repeat == 3
    assert dst.spec.get("input_repeat") == "3"
    assert list(dst.icodec.codec) == list(src.icodec.codec)
    assert list(dst.codec.codec) == list(src.codec.codec)
    words = [a for a, _ in pairs]
    assert [dst.predict(w) for w in words] == [src.predict(w) for w in words]
    assert any(src.predict(w) for w in words)
