"""The port's clstmocrtrain (cli/clstmocrtrain.py) against the JAX
package's, on CPU: both CLIs start from the same JAX-saved .clstm, train on
the same synthetic corpus with the same seed, and must report the same
losses and test errors and save the same weights; the device_preprocess=1
path, display_every, the refusal of what is not ported, and the small
helpers the CLI uses (levenshtein, read_text, the line renderer).

Losses and weights after the run are held to tests/test_torch_train.py's
STEP_RTOL/STEP_ATOL: the same steps on the same batches, f32 sums in
another order than XLA's.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from test_torch_train import STEP_ATOL, STEP_RTOL  # noqa: E402

from clstm_tpu.cli import clstmocrtrain as jcli  # noqa: E402
from clstm_tpu.cli.clstmocr import predict_pages as jpredict_pages  # noqa: E402,E501
from clstm_tpu.data.lines import LineGenerator as JLineGenerator  # noqa: E402
from clstm_tpu.data.lines import make_dataset_dir as jmake_dataset_dir  # noqa: E402,E501
from clstm_tpu.io.proto import load_net as jload_net  # noqa: E402
from clstm_tpu.models.codec import Codec as JCodec  # noqa: E402
from clstm_tpu.models.hl import CLSTMOCR as JOCR  # noqa: E402
from clstm_tpu.utils import metrics as jmetrics  # noqa: E402
from clstm_tpu.utils import text as jtext  # noqa: E402
from clstm_tpu_torch.cli import clstmocrtrain as tcli  # noqa: E402
from clstm_tpu_torch.cli.clstmocr import predict_pages as tpredict_pages  # noqa: E402,E501
from clstm_tpu_torch.data.lines import LineGenerator, make_dataset_dir  # noqa: E402,E501
from clstm_tpu_torch.io.png import read_png  # noqa: E402
from clstm_tpu_torch.models.hl import CLSTMOCR  # noqa: E402
from clstm_tpu_torch.utils import metrics as tmetrics  # noqa: E402
from clstm_tpu_torch.utils import text as ttext  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run many small ops: one intra-op thread keeps them from
    spinning against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed=5):
    return JLineGenerator(seed=seed, fontsize=(20, 22), warp_amp=(0.0, 0.0),
                          noise=0.0, charset="abc")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """16 training and 4 test lines, and a JAX bidi model (nhidden 8)
    saved as .clstm with its .state.npz."""
    tmp = tmp_path_factory.mktemp("ocrtrain")
    gen = _gen()
    texts = [gen.random_text(2, 6) for _ in range(16)]
    train = jmake_dataset_dir(str(tmp / "train"), 16, gen=gen, texts=texts)
    test = jmake_dataset_dir(str(tmp / "test"), 4, gen=gen, texts=texts[:4])
    jocr = JOCR(target_height=24, dewarp="center")
    jocr.createBidi(JCodec.build(texts), nhidden=8, seed=0)
    start = str(tmp / "start.clstm")
    jocr.save(start)
    return tmp, train, test, start


ENV = {"ntrain": "40", "lrate": "1e-2", "momentum": "0.9",
       "report_every": "4", "save_every": "16", "test_every": "16",
       "target_height": "24", "dewarp": "center", "batch_size": "4",
       "randseed": "0", "mesh": "1", "compile_cache": "off",
       "device": "cpu", "device_preprocess": "0", "augment": "0"}


def _run(mod, name, tmp, args, monkeypatch, capsys, **env):
    for k, v in dict(ENV, **env).items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("save_name", str(tmp / name))
    log = tmp / f"{name}.jsonl"
    if log.exists():
        log.unlink()
    monkeypatch.setenv("log_jsonl", str(log))
    assert mod.main(args) == 0
    out = capsys.readouterr().out
    recs = [json.loads(ln) for ln in log.read_text().splitlines()]
    return recs, [ln for ln in out.splitlines() if ln.startswith("TESTERR")]


@pytest.mark.parametrize("k", ["1", "4"])
def test_torch_clstmocrtrain_matches_jax(corpus, k, monkeypatch, capsys):
    tmp, train, test, start = corpus
    runs = {name: _run(mod, f"{name}{k}", tmp, [train, test], monkeypatch,
                       capsys, load=start, steps_per_dispatch=k)
            for name, mod in (("jax", jcli), ("torch", tcli))}
    (jrecs, jtest), (trecs, ttest) = runs["jax"], runs["torch"]
    assert [r["trial"] for r in trecs] == [r["trial"] for r in jrecs]
    assert len([r for r in trecs if "loss" in r]) == 10
    for a, b in zip(trecs, jrecs):
        if "loss" in a:
            np.testing.assert_allclose(a["loss"], b["loss"], rtol=STEP_RTOL,
                                       atol=STEP_ATOL)
        else:
            assert a["test_cer"] == b["test_cer"]
    assert ttest == jtest and len(ttest) == 2
    _, jp, _, _ = jload_net(str(tmp / f"jax{k}-last.clstm"))
    _, tp, _, _ = jload_net(str(tmp / f"torch{k}-last.clstm"))
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=STEP_RTOL, atol=STEP_ATOL)


def test_torch_clstmocrtrain_device_preprocess(corpus, monkeypatch, capsys):
    """device_preprocess=1: the corpus is prepared on the device from the
    raw PNGs; blocks of the automatic K (here 4) train, report, test and
    save. The saved model reloads and predicts the trained model's ids
    bitwise, and the JAX package's clstmocr path (predict_pages with
    device_preprocess=1) on the same saved weights gives the same frame ids
    and characters, but for lines whose width is off by one (the prepare
    envelope of tests/test_torch_preprocess.py)."""
    tmp, train, test, _ = corpus
    trained = {}
    loop = tcli.train

    def spy(ocr, codec, **kw):
        trained["ocr"] = ocr
        return loop(ocr, codec, **kw)

    monkeypatch.setattr(tcli, "train", spy)
    recs, tests = _run(tcli, "dev", tmp, [train, test], monkeypatch, capsys,
                       device_preprocess="1", nhidden="8",
                       steps_per_dispatch="0", ntrain="32")
    losses = [r["loss"] for r in recs if "loss" in r]
    assert len(losses) == 8 and np.isfinite(losses).all()
    assert len(tests) == 2
    saved = str(tmp / "dev-last.clstm")
    a = CLSTMOCR(target_height=24, device="cpu")
    a.load(saved)
    assert a.state.step == 8
    imgs = [read_png(f) for f in open(test).read().split()]
    ia, va, la = a.predict_batch_images(imgs)
    it, vt, lt = trained["ocr"].predict_batch_images(imgs)
    assert np.array_equal(ia, it) and np.array_equal(va, vt)
    assert np.array_equal(la, lt)
    j = JOCR(target_height=24, dewarp="center")
    j.load(saved)
    want = jpredict_pages(j, imgs, device_preprocess=1)
    got = tpredict_pages(a, imgs)
    assert sorted(got) == sorted(want) == list(range(len(imgs)))
    off = [i for i in got if got[i][3] != want[i][3]]
    assert len(off) <= 1
    for i in set(got) - set(off):
        assert got[i][:2] == want[i][:2]


@pytest.mark.parametrize("env,item", [({"t_buckets": "auto"}, "item 5")])
def test_torch_clstmocrtrain_refuses_unported(corpus, monkeypatch, env,
                                              item):
    _, train, _, _ = corpus
    for k, v in dict(ENV, **env).items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match=item):
        tcli.main([train])


@pytest.mark.parametrize("k", ["1", "3"])
def test_torch_clstmocrtrain_mesh_matches_one_rank(corpus, k, monkeypatch,
                                                   capfd):
    """mesh=2: main starts two gloo ranks on the CPU (device=cpu, shared),
    rounds batch_size 3 up to 4, and trains blocks of k batches over the
    device cache, each rank gathering its rows; rank 0 prints, tests, logs
    and saves. Against mesh=1 at batch_size 4 from the same .clstm: the same
    trials, losses and test CER within the JAX package's DP tolerance
    (tests/test_cli.py), the same saved weights within rtol 3e-4, atol
    2e-5."""
    tmp, train, test, start = corpus
    one = _run(tcli, f"m1-{k}", tmp, [train, test], monkeypatch, capfd,
               load=start, steps_per_dispatch=k)
    two = _run(tcli, f"m2-{k}", tmp, [train, test], monkeypatch, capfd,
               load=start, steps_per_dispatch=k, mesh="2", batch_size="3",
               OMP_NUM_THREADS="1")
    (recs1, tests1), (recs2, tests2) = one, two
    assert [r["trial"] for r in recs2] == [r["trial"] for r in recs1]
    assert len(tests2) == len(tests1) == 2
    for a, b in zip(recs2, recs1):
        key = "loss" if "loss" in a else "test_cer"
        np.testing.assert_allclose(a[key], b[key], rtol=3e-4, atol=2e-5)
    _, p1, _, _ = jload_net(str(tmp / f"m1-{k}-last.clstm"))
    _, p2, _, _ = jload_net(str(tmp / f"m2-{k}-last.clstm"))
    for a, b in zip(jax.tree.leaves(p2), jax.tree.leaves(p1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=3e-4,
                                   atol=2e-5)


def test_torch_clstmocrtrain_mesh_with_augment_trains(corpus, monkeypatch,
                                                      capfd):
    """mesh=2 with augment=0.5: each rank draws its own augmentation stream
    (the step and the rank folded into the seed), so the run trains (finite
    losses, a test CER) but ends elsewhere than one rank with augment=0.5
    and than augment=0."""
    tmp, train, test, start = corpus
    runs = {}
    for name, env in (("aug0", {}), ("aug1", {"augment": "0.5"}),
                      ("aug2", {"augment": "0.5", "mesh": "2",
                                "OMP_NUM_THREADS": "1"})):
        recs, tests = _run(tcli, name, tmp, [train, test], monkeypatch,
                           capfd, load=start, **env)
        losses = [r["loss"] for r in recs if "loss" in r]
        assert losses and np.isfinite(losses).all() and len(tests) == 2
        _, runs[name], _, _ = jload_net(str(tmp / f"{name}-last.clstm"))
    for other in ("aug0", "aug1"):
        assert any(not np.allclose(np.asarray(a), np.asarray(b), rtol=1e-3,
                                   atol=1e-4)
                   for a, b in zip(jax.tree.leaves(runs["aug2"]),
                                   jax.tree.leaves(runs[other])))


def test_torch_clstmocrtrain_display_every(corpus, monkeypatch, capsys):
    """display_every=8: the dashboard PNG is written, the Display holds the
    losses of the deferred reports (the JSONL's) and the test CERs, and the
    run prints the same TESTERR lines and logs the same losses as
    display_every=0 (drawing reads nothing from the device)."""
    from clstm_tpu_torch.utils import display
    tmp, train, test, start = corpus
    seen = []

    class Spy(display.Display):
        def __init__(self, path):
            super().__init__(path)
            seen.append(self)

    monkeypatch.setattr(display, "Display", Spy)
    runs = {n: _run(tcli, f"disp{n}", tmp, [train, test], monkeypatch,
                    capsys, load=start, steps_per_dispatch="4",
                    display_every=n) for n in ("0", "8")}
    recs, tests = runs["8"]

    def logged(rs):
        return [(r["trial"], r.get("loss"), r.get("test_cer")) for r in rs]
    assert logged(recs) == logged(runs["0"][0])
    assert tests == runs["0"][1] and len(tests) == 2
    assert len(seen) == 1
    assert seen[0].losses == [r["loss"] for r in recs if "loss" in r]
    assert seen[0].test_errs == [r["test_cer"] for r in recs
                                 if "test_cer" in r]
    assert os.path.exists(str(tmp / "disp8-display.png")) == display.HAVE_MPL
    assert not os.path.exists(str(tmp / "disp0-display.png"))


def test_torch_clstmocrtrain_usage(capsys):
    assert tcli.main([]) == 1
    assert "ntrain=" in capsys.readouterr().out


def test_torch_metrics_and_text_match_jax(tmp_path):
    rng = np.random.RandomState(0)
    pairs = [("", ""), ("abc", ""), ("", "xy"), ("kitten", "sitting")]
    pairs += [("".join(rng.choice(list("abc"), rng.randint(0, 12))),
               "".join(rng.choice(list("abc"), rng.randint(0, 12))))
              for _ in range(20)]
    for a, b in pairs:
        assert tmetrics.levenshtein(a, b) == jmetrics.levenshtein(a, b)
        assert tmetrics.cer(a, b) == jmetrics.cer(a, b)
    for content in ("line\n", "line\r\n", "two\nlines", "", "x\n\n"):
        f = tmp_path / "t.gt.txt"
        f.write_bytes(content.encode())
        assert ttext.read_text(str(f)) == jtext.read_text(str(f))
    for s, sep in (("a  b c ", None), ("a,,b", ","), ("", None)):
        assert ttext.split(s, sep) == jtext.split(s, sep)


def test_torch_line_generator_matches_jax(tmp_path):
    """The same seed renders the same lines and writes the same corpus."""
    kw = dict(fontsize=(20, 26), warp_amp=(0.0, 6.0), noise=0.03)
    t, j = LineGenerator(seed=3, **kw), JLineGenerator(seed=3, **kw)
    for _ in range(3):
        assert t.random_sentence() == j.random_sentence()
        s = t.random_text(4, 9)
        assert s == j.random_text(4, 9)
        np.testing.assert_array_equal(t.render(s), j.render(s))
    mt = make_dataset_dir(str(tmp_path / "t"), 3, seed=4)
    mj = jmake_dataset_dir(str(tmp_path / "j"), 3, seed=4)
    ft, fj = open(mt).read().split(), open(mj).read().split()
    for a, b in zip(ft, fj):
        np.testing.assert_array_equal(read_png(a), read_png(b))
        assert (open(a[:-4] + ".gt.txt").read()
                == open(b[:-4] + ".gt.txt").read())
    assert os.path.basename(mt) == os.path.basename(mj)
