"""``compute_dtype`` (the JAX package's scan recipe with bf16 operands) in
the port against the JAX package, on CPU.

No kernel runs on this route in either package: the JAX package sends
``apply_net(..., compute_dtype=jnp.bfloat16)`` to ``lax.scan`` on every
backend, the port to its plain loops (ops/lstm.py) on every device. The
port's forward, loss and every gradient are held against JAX's, for
``bidi``, ``bidi2``, a lone NPLSTM and an affine stack, then 3
``make_train_step`` steps and a 2-rank gloo DP step against JAX's DP step.

The metric is the largest relative Frobenius distance over a group of
tensors (the forward's output and loss; the gradients; the losses and
parameter moves of the steps), held to RATIO of JAX's own bf16-vs-f32
distance over the same group on the same inputs: a recipe that rounds at
other points than the scan lands about a whole such distance away. Two
planted recipes must fail the same check: dWh accumulated in f32 over the
steps (the scan's transpose accumulates it in bf16), and the cotangent of
the rounded h passed back unrounded (the scan's cast rounds it to bf16).

JAX is imported only inside the functions that run the reference, so the
spawned DP ranks import this module for their worker without it.
"""

import pickle
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from clstm_tpu_torch.convert import (  # noqa: E402
    _arrays, params_from_numpy, params_to_numpy)
from clstm_tpu_torch.models import prefab as tprefab  # noqa: E402
from clstm_tpu_torch.models import spec as tspec  # noqa: E402
from clstm_tpu_torch.ops import lstm as tlstm  # noqa: E402
from clstm_tpu_torch.ops.ctc import mktargets_ids  # noqa: E402
from clstm_tpu_torch.parallel import (  # noqa: E402
    launch, make_parallel_train_step)
from clstm_tpu_torch.train import TrainState, make_train_step  # noqa: E402

# The port's distance from JAX's bf16 recipe over JAX's own bf16-vs-f32
# distance. A faithful recipe sits at 1e-5 to 1e-2 of it at these shapes
# (f32 sums in another order flip a bf16 rounding now and then); dh left
# unrounded lands at ~0.22, dWh accumulated in f32 at ~1.
RATIO = 0.1
LR, MOMENTUM = 0.1, 0.9

A = {"ninput": 8, "nhidden": 6, "noutput": 5, "initial": 0.3}
NETS = {
    "bidi": ("bidi", A),
    "bidi2": ("bidi2", A),
    "nplstm": ("NPLSTM", {"ninput": 8, "nhidden": 6, "initial": 0.3}),
    "affine": None,     # Stacked[TanhLayer 8->7, SoftmaxLayer 7->5]
}


def _spec(pkg_layer, pkg_make_net, name):
    """The spec of case ``name`` built by one package's own functions."""
    if NETS[name] is None:
        a = {"initial": 0.3}
        return pkg_layer("Stacked", 8, 5, {}, [
            pkg_layer("TanhLayer", 8, 7, a),
            pkg_layer("SoftmaxLayer", 7, 5, a)])
    kind, args = NETS[name]
    return pkg_make_net(kind, args)


def _jax_case(name: str, seed: int = 0):
    """(JAX spec, params as numpy, batch) of one case; the batch is
    x [3, 40, 8] in ±1, lengths with padding, a cotangent r of the
    output's shape."""
    import jax
    from clstm_tpu.models.prefab import make_net
    from clstm_tpu.models.spec import init_net, layer, noutput_of
    spec = _spec(layer, make_net, name)
    params = jax.tree.map(np.asarray, init_net(spec, jax.random.PRNGKey(seed)))
    rng = np.random.RandomState(seed)
    B, T = 3, 40
    x = rng.uniform(-1, 1, (B, T, 8)).astype(np.float32)
    lengths = np.array([T, 23, 7], np.int32)
    r = rng.uniform(-1, 1, (B, T, noutput_of(spec))).astype(np.float32)
    return spec, params, (x, lengths, r)


def _jax_forward_grads(spec, params, batch, cd):
    """JAX's apply_net(logits=True) under ``cd`` -> (y, loss, grads), the
    loss sum(y * r), as numpy."""
    import jax
    import jax.numpy as jnp
    from clstm_tpu.models.spec import apply_net
    x, lengths, r = (jnp.asarray(a) for a in batch)

    def loss(p):
        y = apply_net(spec, p, x, lengths, logits=True, compute_dtype=cd)
        return jnp.sum(y.astype(jnp.float32) * r), y
    (lv, y), g = jax.value_and_grad(loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))
    return (np.asarray(y, np.float32), np.float32(lv),
            jax.tree.map(np.asarray, g))


def _torch_forward_grads(name, params, batch, cd=torch.bfloat16):
    """The port's apply_net(logits=True, compute_dtype=cd) on the same
    weights -> (y, loss, grads by parameter name)."""
    spec = _spec(tspec.layer, tprefab.make_net, name)
    net = params_from_numpy(spec, params)
    x, lengths, r = (torch.from_numpy(a) for a in batch)
    y = tspec.apply_net(net, x, lengths, logits=True, compute_dtype=cd)
    loss = torch.sum(y.float() * r)
    loss.backward()
    return (y.detach().float().numpy(), loss.detach().numpy(),
            {n: p.grad.numpy() for n, p in net.named_parameters()}, net)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm((a - b).ravel())
                 / max(np.linalg.norm(b.ravel()), 1e-30))


def _dist(got: dict, want: dict) -> float:
    """Largest relative Frobenius distance over the tensors of a group."""
    return max(_rel(got[k], want[k]) for k in want)


def _compare(name: str):
    """-> {group: (port's distance from JAX bf16, JAX's bf16-vs-f32
    distance)} for the forward (y, loss) and the gradients."""
    import jax.numpy as jnp
    spec, params, batch = _jax_case(name)
    y16, l16, g16 = _jax_forward_grads(spec, params, batch, jnp.bfloat16)
    y32, l32, g32 = _jax_forward_grads(spec, params, batch, None)
    y, lv, grads, net = _torch_forward_grads(name, params, batch)
    want16, want32 = _arrays(net, g16), _arrays(net, g32)
    return {"forward": (_dist({"y": y, "loss": lv}, {"y": y16, "loss": l16}),
                        _dist({"y": y16, "loss": l16},
                              {"y": y32, "loss": l32})),
            "grads": (_dist(grads, want16), _dist(want16, want32))}


@pytest.mark.parametrize("name", list(NETS))
def test_torch_compute_dtype_apply_net_and_grads_match_jax(name):
    got = _compare(name)
    for group, (d, gap) in got.items():
        assert gap > 0, (group, gap)
        assert d <= RATIO * gap, (name, group, d, gap, d / gap)


@pytest.mark.parametrize("control", ["dwh_accumulated_in_f32",
                                     "dh_not_rounded"])
def test_torch_compute_dtype_planted_controls_fail(monkeypatch, control):
    """Each planted recipe, put in the port's place for the bidi pair, must
    fail the gradient check above (while the forward, which they leave as
    it is, passes)."""
    from chip_smoke import planted_scan
    monkeypatch.setattr(tlstm, "_bidi_scan", planted_scan(
        control == "dwh_accumulated_in_f32", control == "dh_not_rounded"))
    got = _compare("bidi")
    d, gap = got["forward"]
    assert d <= RATIO * gap, (d, gap)
    d, gap = got["grads"]
    assert d > RATIO * gap, (control, d, gap, d / gap)


def test_torch_compute_dtype_is_plain_and_refuses_xz_bf16():
    """No kernel wrapper is called on the route (a wrapper counts only the
    launches it makes on the card, so the spy is on the wrappers), and
    compute_dtype with xz_bf16=True raises, as the JAX package never
    combines them; so does a compute_dtype other than bf16."""
    calls = []
    names = ("bidi_lstm_train", "bidi_lstm_infer")
    saved = {n: getattr(tspec, n) for n in names}
    try:
        for n in names:
            setattr(tspec, n, lambda *a, _n=n, **k: calls.append(_n)
                    or saved[_n](*a, **k))
        spec, net = tprefab.make_net_init("bidi", A)
        x = torch.rand(2, 9, 8)
        tspec.apply_net(net, x, compute_dtype=torch.bfloat16).sum().backward()
        tspec.apply_net(net, x, compute_dtype=torch.bfloat16, inference=True)
        assert calls == []
        tspec.apply_net(net, x).sum().backward()
        assert calls == ["bidi_lstm_train"]
    finally:
        for n in names:
            setattr(tspec, n, saved[n])
    with pytest.raises(ValueError, match="compute_dtype"):
        tspec.apply_net(net, x, compute_dtype=torch.bfloat16, xz_bf16=True)
    with pytest.raises(ValueError, match="bfloat16"):
        tspec.apply_net(net, x, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="compute_dtype"):
        tlstm.bidi_lstm_apply(net.sub[0].sub[0].weights(),
                              net.sub[0].sub[1].sub[0].weights(), x,
                              xz_bf16=True, compute_dtype=torch.bfloat16)


# ---------------------------------------------------------------------------
# Training steps, one rank and data-parallel
# ---------------------------------------------------------------------------

NSYM, B, T = 4, 8, 12
BIDI = {"ninput": NSYM, "nhidden": 8, "noutput": NSYM, "initial": 0.3}


def _ctc_batch(rng, B, T, nsym, rep=3):
    """Symbols held for ``rep`` frames, their blank-interleaved targets."""
    n = T // rep
    syms = rng.randint(1, nsym, size=(B, n))
    x = np.zeros((B, T, nsym), np.float32)
    for b in range(B):
        for i in range(n):
            x[b, i * rep:(i + 1) * rep, syms[b, i]] = 1.0
    x += rng.uniform(-0.3, 0.3, x.shape).astype(np.float32)
    tids = np.stack([mktargets_ids(s) for s in syms]).astype(np.int32)
    return {"x": x, "lengths": np.array([T] * (B - 2) + [T - 3, T - 6],
                                        np.int32),
            "targets": tids, "target_lengths": np.full(B, 2 * n + 1,
                                                       np.int32)}


def _jax_start(seed: int = 0):
    import jax
    from clstm_tpu.models.prefab import make_net_init
    _, params = make_net_init("bidi", BIDI, jax.random.PRNGKey(seed))
    return (jax.tree.map(np.asarray, params),
            _ctc_batch(np.random.RandomState(seed), B, T, NSYM))


def _jax_steps(params, batch, cd, mesh_n: int = 0, nsteps: int = 3):
    """3 JAX steps under ``cd`` (make_train_step, or with ``mesh_n`` its
    DP step on that many virtual devices) -> losses, final params."""
    import jax
    import jax.numpy as jnp
    from clstm_tpu.models.prefab import make_net
    from clstm_tpu.train import TrainState as JState
    from clstm_tpu.train import make_train_step as jstep
    spec = make_net("bidi", BIDI)
    state = JState.create(jax.tree.map(jnp.asarray, params))
    if mesh_n:
        from clstm_tpu.parallel.dp import make_parallel_train_step as jdp
        from clstm_tpu.parallel.mesh import make_mesh, replicate, shard_batch
        mesh = make_mesh(mesh_n)
        step = jdp(spec, mesh, LR, MOMENTUM, compute_dtype=cd, donate=False)
        state, batch = replicate(state, mesh), shard_batch(batch, mesh)
    else:
        step = jstep(spec, LR, MOMENTUM, compute_dtype=cd)
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
    losses = []
    for _ in range(nsteps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return np.array(losses), jax.tree.map(np.asarray, state.params)


def _torch_steps(params, batch, mesh=None, nsteps: int = 3):
    """3 of the port's steps under compute_dtype=bf16 -> losses, final
    params tree."""
    spec = tprefab.make_net("bidi", BIDI)
    state = TrainState.create(params_from_numpy(spec, params))
    if mesh is None:
        step = make_train_step(spec, LR, MOMENTUM,
                               compute_dtype=torch.bfloat16)
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    else:
        step = make_parallel_train_step(spec, mesh, LR, MOMENTUM,
                                        compute_dtype=torch.bfloat16)
    losses = []
    for _ in range(nsteps):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return np.array(losses), params_to_numpy(state.net)


def _moves(params: dict, start: dict, net) -> dict:
    """Each parameter's move from the start, keyed by parameter name."""
    a, s = _arrays(net, params), _arrays(net, start)
    return {k: a[k] - s[k] for k in a}


def _check_steps(got, start, want16, want32):
    """Losses and parameter moves within RATIO of JAX's bf16-vs-f32
    distance."""
    net = params_from_numpy(tprefab.make_net("bidi", BIDI), start)
    g = dict(_moves(got[1], start, net), losses=got[0])
    w16 = dict(_moves(want16[1], start, net), losses=want16[0])
    w32 = dict(_moves(want32[1], start, net), losses=want32[0])
    d, gap = _dist(g, w16), _dist(w16, w32)
    assert gap > 0 and d <= RATIO * gap, (d, gap, d / gap)


def test_torch_compute_dtype_train_steps_match_jax():
    import jax.numpy as jnp
    params, batch = _jax_start()
    _check_steps(_torch_steps(params, batch), params,
                 _jax_steps(params, batch, jnp.bfloat16),
                 _jax_steps(params, batch, None))


def _dp_worker(job: str, out: str, mesh=None) -> int:
    """A rank's program: 3 DP steps under compute_dtype; rank 0 writes the
    result. No JAX may be imported on the way."""
    assert "jax" not in sys.modules
    with open(job, "rb") as f:
        params, batch = pickle.load(f)
    res = _torch_steps(params, batch, mesh)
    if mesh.main:
        with open(out, "wb") as f:
            pickle.dump((res, "jax" in sys.modules), f)
    return 0


def test_torch_compute_dtype_dp_step_matches_jax(tmp_path):
    """2 gloo ranks on the CPU against the JAX package's DP step on a
    2-device virtual mesh, both under compute_dtype=bf16; each rank takes
    its gradients in the recipe and the sum over the ranks is f32."""
    import jax.numpy as jnp
    params, batch = _jax_start(1)
    job, out = str(tmp_path / "job.pkl"), str(tmp_path / "out.pkl")
    with open(job, "wb") as f:
        pickle.dump((params, batch), f)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        assert launch(_dp_worker, 2, (job, out), "cpu") == 0
    with open(out, "rb") as f:
        got, jax_imported = pickle.load(f)
    assert not jax_imported
    _check_steps(got, params, _jax_steps(params, batch, jnp.bfloat16, 2),
                 _jax_steps(params, batch, None, 2))
