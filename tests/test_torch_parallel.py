"""The port's data parallelism (clstm_tpu_torch/parallel/) on CPU gloo ranks,
against the JAX package's on the virtual CPU mesh of tests/conftest.py.

The port's ranks are processes started with spawn (parallel/mesh.py::launch)
that import no JAX: this module imports JAX only inside the functions that
run the reference in the pytest process, so the ranks can import it for its
worker functions, and each worker asserts that JAX was never imported.
Inputs (JAX-drawn parameters as numpy, batches) go to the ranks in a pickle
and rank 0 writes its results back the same way. One spawn runs every check
of a group size (a spawn costs seconds), and the tests read its results.

Tolerances are the JAX package's own (tests/test_parallel.py,
tests/test_cli.py): losses rtol 2e-4, parameters after 3 steps rtol 2e-4 and
atol 1e-6 (f32 sums over the ranks' rows in another order); the K-step
blocks rtol 3e-4, atol 2e-5 (reports atol 2e-4).
"""

import os
import pickle
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from clstm_tpu_torch.convert import (  # noqa: E402
    params_from_numpy, params_to_numpy)
from clstm_tpu_torch.data.device_cache import DeviceDataset  # noqa: E402
from clstm_tpu_torch.models import prefab as tprefab  # noqa: E402
from clstm_tpu_torch.models.codec import Codec  # noqa: E402
from clstm_tpu_torch.models.hl import CLSTMOCR  # noqa: E402
from clstm_tpu_torch.ops.ctc import mktargets_ids  # noqa: E402
from clstm_tpu_torch.parallel import (  # noqa: E402
    launch, make_parallel_train_step, pmean_tree, psum_tree)
from clstm_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from clstm_tpu_torch.train import TrainState, make_train_step  # noqa: E402

LOSS_RTOL = 2e-4
PARAM_RTOL, PARAM_ATOL = 2e-4, 1e-6
BLOCK_RTOL, BLOCK_ATOL, REPORT_ATOL = 3e-4, 2e-5, 2e-4
NSYM, B, T = 4, 16, 12
BIDI = {"ninput": NSYM, "nhidden": 8, "noutput": NSYM, "initial": 0.2}
LSTM1 = {"ninput": NSYM, "nhidden": 6, "noutput": NSYM}


def _ctc_batch(rng, B, T, nsym, rep=3):
    """tests/test_parallel.py's batch: symbols held for ``rep`` frames."""
    n = T // rep
    syms = rng.randint(1, nsym, size=(B, n))
    x = np.zeros((B, T, nsym), np.float32)
    for b in range(B):
        for i in range(n):
            x[b, i * rep:(i + 1) * rep, syms[b, i]] = 1.0
    tids = np.zeros((B, 2 * n + 1), np.int32)
    tlens = np.zeros(B, np.int32)
    for b in range(B):
        ids = mktargets_ids(syms[b])
        tids[b, :len(ids)] = ids
        tlens[b] = len(ids)
    return {"x": x, "lengths": np.full(B, T, np.int32),
            "targets": tids, "target_lengths": tlens}


def _frames_batch(rng, B, T, nsym):
    """Per-frame targets: the input symbol delayed by one frame."""
    syms = rng.randint(0, nsym, size=(B, T))
    eye = np.eye(nsym, dtype=np.float32)
    return {"x": eye[syms], "lengths": np.full(B, T, np.int32),
            "y": eye[np.concatenate([np.zeros((B, 1), int), syms[:, :-1]],
                                    axis=1)]}


def _steps(case: dict, mesh, nsteps: int = 3) -> dict:
    """``nsteps`` training steps of one case, data-parallel over ``mesh``
    or on one rank (mesh None). -> losses, final params tree, the last
    step's frame ids/vals."""
    spec = tprefab.make_net(case["kind"], case["args"])
    state = TrainState.create(params_from_numpy(spec, case["params"]))
    opts = dict(loss_kind=case["loss_kind"],
                gradient_clip=case.get("clip", 0.0))
    step = (make_train_step(spec, 0.05, 0.9, **opts) if mesh is None else
            make_parallel_train_step(spec, mesh, 0.05, 0.9, **opts))
    batch = (case["batch"] if mesh is not None else
             {k: torch.from_numpy(v) for k, v in case["batch"].items()})
    losses = []
    for _ in range(nsteps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return {"losses": losses, "params": params_to_numpy(state.net),
            "frame_ids": m["frame_ids"].numpy(),
            "frame_vals": m["frame_vals"].numpy(),
            "report": m["report"].numpy()}


def _samples(seed: int, n: int = 20, h: int = 24, fixed: bool = False):
    rng = np.random.RandomState(seed)
    return [(rng.rand(60 if fixed else 60 + 5 * i, h).astype(np.float32),
             "abcd"[: 1 + (i % 4)]) for i in range(n)]


def _ocr(samples, mesh):
    codec = Codec.build([t for _, t in samples])
    ocr = CLSTMOCR(target_height=24, dewarp="none", device="cpu")
    ocr.createBidi(codec, 10, seed=0)
    ocr.setLearningRate(3e-3, 0.9)
    if mesh is not None:
        ocr.set_mesh(mesh)
    return ocr, DeviceDataset(samples, codec, device="cpu", mesh=mesh)


def _leaves(tree) -> list:
    return [tree["weights"][k] for k in sorted(tree["weights"])] + [
        a for s in tree["sub"] for a in _leaves(s)]


def _blocks(mesh, k=3, epochs=2) -> dict:
    """tests/test_parallel.py's block trajectory: K-step blocks over two
    epochs of a 20-line corpus, B=8."""
    ocr, dc = _ocr(_samples(0), mesh)
    r = np.random.RandomState(0)
    reports = [ocr.train_batch_block(block, k_max=k)["report_all"].numpy()
               for _ in range(epochs)
               for block in dc.epoch_blocks(8, k, rng=r, epochs=1)]
    return {"reports": reports, "params": params_to_numpy(ocr.net)}


def _nvalid(mesh, nvalid: int) -> dict:
    """A k=3 block run to ``nvalid``: its reports, the counter it returned
    and the params."""
    ocr, dc = _ocr(_samples(1, n=24, fixed=True), mesh)
    block = next(dc.epoch_blocks(8, 3, rng=np.random.RandomState(0)))
    got = {}
    block["set_j"] = lambda nj: got.update(j=nj)
    m = ocr.train_batch_block(block, k_max=3, nvalid=nvalid)
    return {"reports": m["report_all"].numpy(), "j": got["j"],
            "params": params_to_numpy(ocr.net)}


def _refs(mesh) -> dict:
    """train_batch_refs over one epoch of a 16-line corpus, B=8."""
    ocr, dc = _ocr(_samples(2, n=16), mesh)
    losses = [float(ocr.train_batch_refs(ref)["loss"])
              for ref in dc.epoch_refs(8, rng=np.random.RandomState(0))]
    return {"losses": losses, "params": params_to_numpy(ocr.net)}


def _predict(mesh) -> dict:
    """predict_batch of 7 rows (padded to the mesh inside)."""
    ocr, _ = _ocr(_samples(3, n=7), mesh)
    rng = np.random.RandomState(4)
    x = rng.rand(7, 40, 24).astype(np.float32)
    lengths = np.array([40, 31, 0, 12, 40, 7, 25], np.int32)
    ids, vals = ocr.predict_batch(x, lengths)
    return {"ids": ids, "vals": vals}


def _resume(mesh, tmp: str) -> dict:
    """Six train_batch steps in one run, against three, a save, a fresh
    model loaded from the file (with its .state.npz), set_mesh, and three
    more."""
    rng = np.random.RandomState(11)
    batches = [_ctc_batch(rng, 8, 24, NSYM) for _ in range(6)]
    batches = [dict(b, x=np.repeat(b["x"], 3, axis=2)[:, :, :12])
               for b in batches]
    codec = Codec.build(["abc"])

    def fresh():
        ocr = CLSTMOCR(target_height=12, dewarp="none", device="cpu")
        ocr.createBidi(codec, nhidden=8, seed=3)
        ocr.setLearningRate(1e-2, 0.9)
        ocr.set_mesh(mesh)
        return ocr

    ref = fresh()
    for b in batches:
        ref.train_batch(b)
    a = fresh()
    for b in batches[:3]:
        a.train_batch(b)
    f = os.path.join(tmp, "resume.clstm")
    a.save(f)
    b2 = CLSTMOCR(target_height=12, dewarp="none", device="cpu")
    b2.load(f)
    b2.setLearningRate(1e-2, 0.9)
    b2.set_mesh(mesh)
    step = b2.state.step
    for b in batches[3:]:
        b2.train_batch(b)
    return {"step_after_load": step, "ref": params_to_numpy(ref.net),
            "resumed": params_to_numpy(b2.net),
            "sidecar": os.path.exists(f + ".state.npz")}


def _guard(mesh) -> str:
    """Rank 1 draws one number more than rank 0 before the epoch plan."""
    _, dc = _ocr(_samples(5, n=16), mesh)
    rng = np.random.RandomState(0)
    if mesh.rank == 1:
        rng.rand()
    try:
        next(dc.epoch_blocks(8, 2, rng=rng))
    except RuntimeError as e:
        return str(e)
    return "no error"


AUTO_PENALTIES = (0.0, 1e9)     # each rank's own "measured" penalty
AUTO_HINTS = dict(batch_size=4, epochs=1, k=1)


def _auto_corpus():
    return _samples(6, n=40)


def _auto_cuts(mesh) -> np.ndarray:
    """t_buckets="auto" under the mesh, each rank measuring another dispatch
    penalty (AUTO_PENALTIES[rank]): every rank's groups' T buckets (one row
    a rank, gathered by one all_reduce) after an epoch of blocks, whose
    plan_guard raises if the ranks' groups differ."""
    from clstm_tpu_torch.data import device_cache
    measure = device_cache.measure_dispatch_penalty_rows
    device_cache.measure_dispatch_penalty_rows = (
        lambda device=None, reps=5: AUTO_PENALTIES[mesh.rank])
    try:
        samples = _auto_corpus()
        dc = DeviceDataset(samples, Codec.build([t for _, t in samples]),
                           device="cpu", mesh=mesh, t_buckets="auto",
                           merge_sb=True, auto_hints=AUTO_HINTS)
    finally:
        device_cache.measure_dispatch_penalty_rows = measure
    list(dc.epoch_blocks(4, 2, rng=np.random.RandomState(0)))
    tbs = torch.zeros((mesh.size, 32), dtype=torch.int64)
    tbs[mesh.rank, :len(dc.groups)] = torch.tensor([g["tb"]
                                                    for g in dc.groups])
    mesh.all_reduce(tbs)
    return tbs.numpy()


def _worker(job: str, out: str, mesh=None) -> int:
    """The ranks' program: every case of ``job`` on this rank; rank 0 writes
    the results. No JAX may be imported on the way."""
    assert "jax" not in sys.modules
    with open(job, "rb") as f:
        job = pickle.load(f)
    res = {"steps": {name: _steps(case, mesh)
                     for name, case in job["cases"].items()}}
    t = {"a": torch.full((3,), float(mesh.rank + 1)),
         "b": torch.tensor(2.0 * mesh.rank)}
    res["psum"] = {k: v.numpy() for k, v in psum_tree(t, mesh).items()}
    res["pmean"] = {k: v.numpy() for k, v in pmean_tree(t, mesh).items()}
    if job["hl"]:
        res["blocks"] = _blocks(mesh)
        res["nvalid"] = {n: _nvalid(mesh, n) for n in (3, 2)}
        res["refs"] = _refs(mesh)
        res["predict"] = _predict(mesh)
        res["resume"] = _resume(mesh, os.path.dirname(out))
        res["guard"] = _guard(mesh)
        res["auto_cuts"] = _auto_cuts(mesh)
    res["jax_imported"] = "jax" in sys.modules
    if mesh.main:
        with open(out, "wb") as f:
            pickle.dump(res, f)
    return 0


def _jax_cases():
    """The step cases, their params drawn by the JAX package's init."""
    import jax
    from clstm_tpu.models.prefab import make_net_init
    cases = {}
    for name, kind, args, loss_kind, clip, seed in (
            ("ctc", "bidi", BIDI, "ctc", 0.0, 0),
            ("frames", "bidi", BIDI, "frames", 0.0, 0),
            ("clip", "bidi", BIDI, "ctc", 0.5, 0),
            ("lstm1", "lstm1", LSTM1, "ctc", 0.0, 1)):
        _, params = make_net_init(kind, args, jax.random.PRNGKey(seed))
        rng = np.random.RandomState(seed)
        Bc, Tc = (8, 9) if kind == "lstm1" else (B, T)
        batch = (_frames_batch(rng, Bc, Tc, NSYM) if loss_kind == "frames"
                 else _ctc_batch(rng, Bc, Tc, NSYM))
        cases[name] = {"kind": kind, "args": args, "loss_kind": loss_kind,
                       "clip": clip, "batch": batch,
                       "params": jax.tree.map(np.asarray, params)}
    return cases


def _jax_steps(case: dict, n: int, nsteps: int = 3) -> dict:
    """The JAX package's make_parallel_train_step on an n-device virtual
    mesh from the same params and batch."""
    import jax
    from clstm_tpu.models.prefab import make_net
    from clstm_tpu.parallel.dp import make_parallel_train_step as jstep
    from clstm_tpu.parallel.mesh import make_mesh, replicate, shard_batch
    from clstm_tpu.train import TrainState as JState
    spec = make_net(case["kind"], case["args"])
    mesh = make_mesh(n)
    step = jstep(spec, mesh, 0.05, 0.9, loss_kind=case["loss_kind"],
                 gradient_clip=case["clip"], donate=False)
    state = replicate(JState.create(jax.tree.map(jax.numpy.asarray,
                                                 case["params"])), mesh)
    sb = shard_batch(case["batch"], mesh)
    losses = []
    for _ in range(nsteps):
        state, m = step(state, sb)
        losses.append(float(m["loss"]))
    return {"losses": losses,
            "params": jax.tree.map(np.asarray, state.params)}


@pytest.fixture(scope="module")
def cases():
    return _jax_cases()


def _spawn(n: int, cases: dict, tmp) -> dict:
    """One spawn of ``n`` gloo ranks on the CPU running every case (and,
    for 2 ranks, the CLSTMOCR checks). -> rank 0's results."""
    job, out = str(tmp / "job.pkl"), str(tmp / "out.pkl")
    with open(job, "wb") as f:
        pickle.dump({"cases": cases, "hl": n == 2}, f)
    with pytest.MonkeyPatch.context() as mp:
        # One intra-op thread a rank: tiny shapes, and the other test
        # workers share the cores.
        mp.setenv("OMP_NUM_THREADS", "1")
        assert launch(_worker, n, (job, out), "cpu") == 0
    with open(out, "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def ranks2(cases, tmp_path_factory):
    return _spawn(2, cases, tmp_path_factory.mktemp("dp2"))


@pytest.fixture(scope="module")
def ranks4(cases, tmp_path_factory):
    return _spawn(4, cases, tmp_path_factory.mktemp("dp4"))


def _close_trees(a, b, rtol, atol):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        np.testing.assert_allclose(x, y, rtol=rtol, atol=atol)


def _jax_leaves(tree) -> list:
    return [np.asarray(tree["weights"][k]) for k in sorted(tree["weights"])
            ] + [a for s in tree["sub"] for a in _jax_leaves(s)]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", ["ctc", "frames", "clip"])
def test_torch_dp_step_matches_jax_and_one_rank(request, cases, name, n):
    """3 DP steps on n ranks: the losses and parameters of the JAX
    package's DP step on an n-device mesh, and of the port's one-rank step
    on the full batch. A pmean in place of the sum would halve (n=2) or
    quarter (n=4) the update and fail both. "clip": the clip comes after
    the sum, so the clipped update is the one-rank clipped update."""
    got = request.getfixturevalue(f"ranks{n}")["steps"][name]
    want = _jax_steps(cases[name], n)
    one = _steps(cases[name], None)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=LOSS_RTOL)
    for a, b, c in zip(_leaves(got["params"]),
                       _jax_leaves(want["params"]), _leaves(one["params"]),
                       strict=True):
        np.testing.assert_allclose(a, b, rtol=PARAM_RTOL, atol=PARAM_ATOL)
        np.testing.assert_allclose(a, c, rtol=PARAM_RTOL, atol=PARAM_ATOL)


@pytest.mark.parametrize("n", [2, 4])
def test_torch_dp_frame_outputs_cover_full_batch(request, cases, n):
    """The DP step's frame outputs are the full batch's [B, T], row for row
    those of the one-rank step (lstm1, B=8, T=9), and its report is global
    row 0's."""
    got = request.getfixturevalue(f"ranks{n}")["steps"]["lstm1"]
    one = _steps(cases["lstm1"], None)
    assert got["frame_ids"].shape == (8, 9)
    np.testing.assert_array_equal(got["frame_ids"], one["frame_ids"])
    np.testing.assert_allclose(got["frame_vals"], one["frame_vals"],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got["report"], one["report"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("n", [2, 4])
def test_torch_psum_pmean_tree(request, n):
    res = request.getfixturevalue(f"ranks{n}")
    total = n * (n + 1) / 2
    np.testing.assert_array_equal(res["psum"]["a"], np.full(3, total))
    np.testing.assert_array_equal(res["psum"]["b"], n * (n - 1))
    np.testing.assert_allclose(res["pmean"]["a"], np.full(3, total / n))


@pytest.mark.parametrize("n", [2, 4])
def test_torch_dp_workers_import_no_jax(request, n):
    assert request.getfixturevalue(f"ranks{n}")["jax_imported"] is False


def test_torch_dp_multi_step_matches_one_rank_blocks(ranks2):
    """The K-step blocks on 2 ranks (each gathering its rows of the plan)
    against one rank on the same plan: every report and the params."""
    res = ranks2
    got, want = res["blocks"], _blocks(None)
    assert len(got["reports"]) == len(want["reports"]) > 2
    for a, b in zip(got["reports"], want["reports"]):
        np.testing.assert_allclose(a, b, rtol=BLOCK_RTOL, atol=REPORT_ATOL)
    _close_trees(got["params"], want["params"], BLOCK_RTOL, BLOCK_ATOL)


def test_torch_dp_multi_step_nvalid_clamps_and_skips(ranks2):
    """nvalid on the DP K-step: only the first nvalid batches touch the
    state, the counter advances by nvalid, later rows of report_all are
    zero; and each run matches one rank's."""
    res = ranks2
    r3, r2 = res["nvalid"][3], res["nvalid"][2]
    assert r3["j"] == 3 and r2["j"] == 2
    np.testing.assert_allclose(r2["reports"][:2], r3["reports"][:2],
                               rtol=1e-5)
    assert np.all(r2["reports"][2] == 0) and not np.all(r3["reports"][2] == 0)
    assert any(not np.allclose(a, b) for a, b in zip(
        _leaves(r2["params"]), _leaves(r3["params"])))
    for nv in (3, 2):
        want = _nvalid(None, nv)
        np.testing.assert_allclose(res["nvalid"][nv]["reports"],
                                   want["reports"], rtol=BLOCK_RTOL,
                                   atol=REPORT_ATOL)
        _close_trees(res["nvalid"][nv]["params"], want["params"],
                     BLOCK_RTOL, BLOCK_ATOL)


def test_torch_dp_train_batch_refs_routes_through_mesh(ranks2):
    """train_batch_refs under a mesh runs as a block of one, keeps the plan
    counter, and trains as one rank does."""
    res = ranks2
    got, want = res["refs"], _refs(None)
    assert len(got["losses"]) == len(want["losses"]) > 1
    assert np.isfinite(got["losses"]).all()
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=BLOCK_RTOL)
    _close_trees(got["params"], want["params"], BLOCK_RTOL, BLOCK_ATOL)


def test_torch_dp_predict_matches_one_rank(ranks2):
    """make_predict_step(mesh=) through predict_batch: 7 rows padded to the
    mesh, split over the ranks and put back together."""
    res = ranks2
    got, want = res["predict"], _predict(None)
    assert got["ids"].shape == want["ids"].shape == (7, 40)
    np.testing.assert_array_equal(got["ids"], want["ids"])
    np.testing.assert_allclose(got["vals"], want["vals"], rtol=1e-5,
                               atol=1e-6)


def test_torch_dp_resume_matches_uninterrupted(ranks2):
    """Save under a mesh (rank 0 writes, the others wait), load into a fresh
    model on each rank with the .state.npz sidecar, set a mesh, continue:
    the uninterrupted run's parameters, bitwise."""
    res = ranks2["resume"]
    assert res["sidecar"] and res["step_after_load"] == 3
    for a, b in zip(_leaves(res["resumed"]), _leaves(res["ref"]),
                    strict=True):
        np.testing.assert_array_equal(a, b)


def test_torch_dp_plan_guard_raises_on_extra_draw(ranks2):
    """One extra draw from one rank's RandomState: the epoch plan's
    checksums differ and both ranks raise."""
    assert "epoch plan differs across ranks" in ranks2["guard"]


def test_torch_dp_auto_cuts_agree_across_ranks(ranks2):
    """t_buckets="auto" on 2 ranks whose measured penalties differ (0 and
    1e9, which alone give other cuts): both ranks build rank 0's groups,
    the cuts of the JAX package's auto_t_cuts at rank 0's penalty, and the
    plan guard passes."""
    from clstm_tpu.data.dataset import auto_t_cuts
    from clstm_tpu_torch.data import dataset as tds
    samples = _auto_corpus()
    codec = Codec.build([t for _, t in samples])
    lengths = [x.shape[0] for x, _ in samples]
    s_lengths = [2 * len(codec.encode(t)) + 1 for _, t in samples]
    cuts = {p: auto_t_cuts(lengths, s_lengths=s_lengths,
                           dispatch_penalty_rows=p,
                           s_weight=tds.AUTO_S_WEIGHT, **AUTO_HINTS)
            for p in AUTO_PENALTIES}
    assert cuts[0.0] != cuts[1e9]
    want = sorted({tds.bucket_for(v, cuts[0.0]) for v in lengths})
    for row in ranks2["auto_cuts"]:
        assert [int(v) for v in row if v] == want


def test_torch_mesh_rules(monkeypatch):
    """mesh=N and the backend rule, without starting a group."""
    assert tmesh.mesh_size(0, "cpu") == 1
    assert tmesh.mesh_size(3, "cpu") == 3
    cpu = torch.device("cpu")
    assert tmesh.backend_for(cpu, False) == tmesh.backend_for(cpu, True) \
        == "gloo"
    assert tmesh.backend_for(torch.device("cuda", 0), False) == "nccl"
    assert tmesh.backend_for(torch.device("cuda", 0), True) == "gloo"
    assert tmesh.rank_device("cpu", 1, 2) == (cpu, True)
    assert tmesh.rank_device("cpu", 0, 1) == (cpu, False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.rank_device("cuda", 1, 2)
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.mesh_size(2, "cuda")
    m = tmesh.Mesh(rank=1, size=2, device=cpu, backend="gloo", group=None)
    assert m.rows(8) == slice(4, 8) and not m.main
    with pytest.raises(ValueError, match="divide"):
        m.rows(7)
    rows = tmesh.shard_rows({"x": np.arange(8), "texts": ["a"] * 8}, m)
    assert list(rows) == ["x"] and rows["x"].tolist() == [4, 5, 6, 7]
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torch.distributed environment"):
        tmesh.make_mesh(2, "cpu")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="WORLD_SIZE"):
        tmesh.run_ranks(lambda mesh: 0, (), 3, "cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tmesh.run_ranks(lambda mesh: 7 if mesh is None else 1, (), 0,
                           "cpu") == 7
