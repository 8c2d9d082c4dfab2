"""The port's training step against the JAX package, on CPU.

K1 and K2 (the bidi LSTM forward with state and its backward) run here as
their plain versions — ``bidi_lstm_train`` takes them for CPU tensors — and
are held against ``jax.grad`` of the TPU kernel they replace
(``bidi_lstm_pallas`` in interpret mode, strict f32) and against torch
autograd through ``bidi_lstm_apply``. The step, the loss modes, clipping,
the learning checks, the CLSTMOCR training API and the .state.npz sidecar
are held against the JAX package from the same converted TrainState.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from clstm_tpu import train as jtrain  # noqa: E402
from clstm_tpu_torch.data.synth import delayed_sequence_batch  # noqa: E402
from clstm_tpu.io.checkpoint import load_state as jload_state  # noqa: E402
from clstm_tpu.io.checkpoint import save_state as jsave_state  # noqa: E402
from clstm_tpu.models import prefab as jprefab  # noqa: E402
from clstm_tpu.models.codec import Codec as JCodec  # noqa: E402
from clstm_tpu.models.hl import CLSTMOCR as JOCR  # noqa: E402
from clstm_tpu.ops.ctc import mktargets_ids  # noqa: E402
from clstm_tpu.ops.pallas_lstm import bidi_lstm_pallas  # noqa: E402
from clstm_tpu_torch import train as ttrain  # noqa: E402
from clstm_tpu_torch.convert import (  # noqa: E402
    params_from_numpy, params_to_numpy, state_from_numpy, state_to_numpy)
from clstm_tpu_torch.io.checkpoint import load_state, save_state  # noqa: E402
from clstm_tpu_torch.models import prefab as tprefab  # noqa: E402
from clstm_tpu_torch.models.codec import Codec  # noqa: E402
from clstm_tpu_torch.models.hl import CLSTMOCR  # noqa: E402
from clstm_tpu_torch.ops import lstm as tlstm  # noqa: E402
from clstm_tpu_torch.ops.bidi_lstm_kernel import (  # noqa: E402
    bidi_lstm_bwd_chain, bidi_lstm_bwd_reduce, bidi_lstm_fwd_state,
    bidi_lstm_train)
from clstm_tpu_torch.ops.ctc import decode_frames  # noqa: E402

# Gradients: f32 sums over a few hundred terms in another order than the
# Pallas kernel's and XLA's; 1e-5 relative plus 1e-6 absolute is ~100 ulp
# of the largest entries, and a wrong gate or mask moves them by 1e-2.
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6
# Loss and parameters after 3 SGD steps from the same converted state: the
# per-step differences above, carried through lr 0.1 and momentum 0.9.
STEP_RTOL, STEP_ATOL = 1e-5, 1e-5
ARGS = {"ninput": 5, "nhidden": 6, "noutput": 4}


def _lstm_params(rng, D, H, scale=0.3):
    return {"Wx": rng.uniform(-scale, scale, (D, 4 * H)).astype(np.float32),
            "Wh": rng.uniform(-scale, scale, (H, 4 * H)).astype(np.float32),
            "b": rng.uniform(-scale, scale, (4 * H,)).astype(np.float32)}


def _bidi_setup(B=4, T=16, D=5, H=7, seed=0):
    rng = np.random.RandomState(seed)
    pf, pr = _lstm_params(rng, D, H), _lstm_params(rng, D, H)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    lengths = np.array([T, T - 3, 0, 1], np.int32)[:B]
    gy = rng.uniform(-1, 1, (B, T, 2 * H)).astype(np.float32)
    return pf, pr, x, lengths, gy


def _leaf(tree):
    return {k: torch.from_numpy(v).requires_grad_() for k, v in tree.items()}


def _torch_grads(fn, pf, pr, x, lengths, gy, need_dx):
    tf, tr = _leaf(pf), _leaf(pr)
    tx = torch.from_numpy(x).requires_grad_(need_dx)
    y = fn(tf, tr, tx, torch.from_numpy(lengths))
    (y * torch.from_numpy(gy)).sum().backward()
    return ({k: v.grad.numpy() for k, v in tf.items()},
            {k: v.grad.numpy() for k, v in tr.items()},
            tx.grad.numpy() if need_dx else None, y.detach().numpy())


# (D, H) of the gradient test. Besides the small net's shape they cross the
# edges of the card kernel's tiles (D+1+H and 4H against 128-wide output
# tiles, D and H not multiples of 4, D = H = 1), and (130, 7) takes the
# hoisted projection (D+1 > 128) in both packages: the plain K2 these pin
# to jax.grad is what chip_smoke.py holds the kernel against on the card.
GRAD_SHAPES = [(5, 7), (1, 1), (17, 33), (130, 7)]


# The small net's shape keeps its original test ids ("True", "False").
@pytest.mark.parametrize("need_dx,D,H", [
    pytest.param(need_dx, D, H, id=str(need_dx) if (D, H) == (5, 7)
                 else f"{need_dx}-{D}-{H}")
    for D, H in GRAD_SHAPES for need_dx in (True, False)])
def test_torch_bidi_grads_match_pallas_vjp_and_autograd(need_dx, D, H):
    """Plain K1/K2 behind the autograd Function against jax.grad of the TPU
    kernel (interpret mode, strict f32) and torch autograd of the loop."""
    pf, pr, x, lengths, gy = _bidi_setup(D=D, H=H)
    gf, gr, dx, y = _torch_grads(bidi_lstm_train, pf, pr, x, lengths, gy,
                                 need_dx)

    def loss(a, b, xx):
        return jnp.sum(bidi_lstm_pallas(a, b, xx, jnp.asarray(lengths), 8,
                                        True, False, need_dx) * gy)

    jpf = {k: jnp.asarray(v) for k, v in pf.items()}
    jpr = {k: jnp.asarray(v) for k, v in pr.items()}
    jgf, jgr, jdx = jax.grad(loss, argnums=(0, 1, 2))(jpf, jpr,
                                                      jnp.asarray(x))
    af, ar, adx, ay = _torch_grads(tlstm.bidi_lstm_apply, pf, pr, x, lengths,
                                   gy, need_dx)
    np.testing.assert_array_equal(y, ay)
    for got, want, auto in ((gf, jgf, af), (gr, jgr, ar)):
        for k in ("Wx", "Wh", "b"):
            np.testing.assert_allclose(got[k], np.asarray(want[k]),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL)
            np.testing.assert_allclose(got[k], auto[k], rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL)
    if need_dx:
        np.testing.assert_allclose(dx, np.asarray(jdx), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
        np.testing.assert_allclose(dx, adx, rtol=GRAD_RTOL, atol=GRAD_ATOL)
        assert (dx[2] == 0.0).all()                  # the row of length 0


def test_torch_bidi_state_streams_and_padding():
    """K1's plain state streams: y equals the inference forward, every
    stream is exactly 0 on padded frames, and gates/cell reproduce y."""
    pf, pr, x, lengths, _ = _bidi_setup()
    tf = {k: torch.from_numpy(v) for k, v in pf.items()}
    tr = {k: torch.from_numpy(v) for k, v in pr.items()}
    X, L = torch.from_numpy(x), torch.from_numpy(lengths)
    y, gates, cell = bidi_lstm_fwd_state(tf, tr, X, L)
    np.testing.assert_array_equal(y.numpy(),
                                  tlstm.bidi_lstm_apply(tf, tr, X, L).numpy())
    H = 7
    assert gates.shape == (4, 16, 2, 4 * H) and cell.shape == (4, 16, 2, H)
    for b, Lb in enumerate(lengths):
        for s in (y, gates, cell):
            assert (s[b, Lb:] == 0).all()
    h = torch.tanh(cell) * gates[..., 2 * H:3 * H]
    np.testing.assert_allclose(h.reshape(4, 16, 2 * H).numpy(), y.numpy(),
                               rtol=1e-6, atol=1e-7)


def test_torch_bidi_grads_unchanged_by_padding():
    """Padding length and padding contents add nothing to any gradient."""
    pf, pr, x, lengths, gy = _bidi_setup()
    base = _torch_grads(bidi_lstm_train, pf, pr, x, lengths, gy, True)
    rng = np.random.RandomState(9)
    x2 = np.concatenate([x, rng.normal(size=(4, 5, 5)).astype(np.float32)], 1)
    gy2 = np.concatenate([gy, rng.uniform(-1, 1, (4, 5, 14)).astype(np.float32)],
                         1)
    for b, Lb in enumerate(lengths):
        x2[b, Lb:] = rng.normal(size=x2[b, Lb:].shape) * 5
        gy2[b, Lb:] = rng.uniform(-3, 3, gy2[b, Lb:].shape)
    padded = _torch_grads(bidi_lstm_train, pf, pr, x2, lengths, gy2, True)
    for g0, g1 in zip(base[:2], padded[:2]):
        for k in g0:
            np.testing.assert_allclose(g1[k], g0[k], rtol=1e-6, atol=1e-7)
    for b, Lb in enumerate(lengths):
        np.testing.assert_allclose(padded[2][b, :Lb], base[2][b, :Lb],
                                   rtol=1e-6, atol=1e-7)
        assert (padded[2][b, Lb:] == 0).all()


def test_torch_bidi_train_wrappers_cpu_count_no_launch():
    pf, pr, x, lengths, gy = _bidi_setup()
    counters = (bidi_lstm_fwd_state, bidi_lstm_bwd_chain, bidi_lstm_bwd_reduce)
    before = [f.launches for f in counters]
    _torch_grads(bidi_lstm_train, pf, pr, x, lengths, gy, True)
    assert [f.launches for f in counters] == before
    with pytest.raises(ValueError):
        bidi_lstm_bwd_chain(torch.zeros(2, 3, 2, 8), torch.zeros(2, 3, 2, 2),
                            torch.zeros(2, 3, 5), torch.zeros(2, 2, 8))


# ---------------------------------------------------------------------------
# The training step against JAX
# ---------------------------------------------------------------------------

def _start(kind="bidi", args=ARGS, seed=0, scale=0.5):
    """JAX spec + a numpy-drawn params pytree, and the port's TrainState
    converted from it (velocity zero, step 0)."""
    spec, params = jprefab.make_net_init(kind, args, jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda a: rng.uniform(-scale, scale, a.shape).astype(np.float32),
        params)
    zeros = jax.tree.map(np.zeros_like, params)
    tstate = state_from_numpy(tprefab.make_net(kind, args), params, zeros, 0)
    return spec, jtrain.TrainState.create(jax.tree.map(jnp.asarray, params)), \
        tstate


def _ctc_batch(seed=1, B=4, T=12, D=5, C=4, S=7):
    rng = np.random.RandomState(seed)
    x = rng.rand(B, T, D).astype(np.float32)
    lengths = np.array([T, T - 3, 5, 1], np.int32)[:B]
    tids = np.zeros((B, S), np.int32)
    tlens = np.zeros(B, np.int32)
    for b in range(B):
        ids = mktargets_ids(rng.randint(1, C, size=(S - 1) // 2 - b % 2))
        tids[b, :len(ids)] = ids
        tlens[b] = len(ids)
    y = np.eye(C, dtype=np.float32)[rng.randint(0, C, (B, T))]
    return {"x": x, "lengths": lengths, "targets": tids,
            "target_lengths": tlens, "y": y}


def _assert_state_close(tstate, jstate):
    p, v, step = state_to_numpy(tstate)
    assert int(step) == int(jstate.step)
    for got, want in ((p, jstate.params), (v, jstate.velocity)):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=STEP_RTOL,
                                       atol=STEP_ATOL)


STEP_CASES = [("ctc", "none", 0.0), ("ctc", "len", 0.0), ("ctc", "batch", 0.0),
              ("frames", "none", 0.0), ("frames", "len", 0.0),
              ("frames", "batch", 0.0), ("ctc", "none", 0.5)]


@pytest.mark.parametrize("loss_kind,normalization,clip", STEP_CASES)
def test_torch_train_step_matches_jax(loss_kind, normalization, clip):
    spec, jstate, tstate = _start()
    batch = _ctc_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    kw = dict(loss_kind=loss_kind, normalization=normalization,
              gradient_clip=clip)
    jstep = jtrain.make_train_step(spec, 0.1, 0.9, donate=False, **kw)
    tstep = ttrain.make_train_step(tstate.net.spec, 0.1, 0.9, **kw)
    for i in range(3):
        lr = 0.1 if i < 2 else 0.05                # runtime lr, as setLearningRate
        jstate, jm = jstep(jstate, jb, lr, 0.9)
        tstate, tm = tstep(tstate, tb, lr, 0.9)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=STEP_RTOL)
        jl, jids, jvals = jtrain.unpack_report(jm["report"])
        tl, tids, tvals = ttrain.unpack_report(tm["report"])
        np.testing.assert_array_equal(tids, jids)
        np.testing.assert_allclose(tvals, jvals, rtol=STEP_RTOL,
                                   atol=STEP_ATOL)
        np.testing.assert_array_equal(tm["frame_ids"].numpy(),
                                      np.asarray(jm["frame_ids"]))
    _assert_state_close(tstate, jstate)


def test_torch_predict_and_forward_match_jax():
    spec, jstate, tstate = _start()
    batch = _ctc_batch()
    x, L = batch["x"], batch["lengths"]
    jids, jvals = jtrain.make_predict_step(spec)(jstate.params, jnp.asarray(x),
                                                 jnp.asarray(L))
    tids, tvals = ttrain.make_predict_step(tstate.net.spec)(
        tstate.net, torch.from_numpy(x), torch.from_numpy(L))
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_allclose(tvals.numpy(), np.asarray(jvals), rtol=1e-5)
    want = jtrain.make_forward(spec)(jstate.params, jnp.asarray(x),
                                     jnp.asarray(L))
    got = ttrain.make_forward(tstate.net.spec)(tstate.net, torch.from_numpy(x),
                                               torch.from_numpy(L))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-6)


def test_torch_clip_and_unpack_report():
    g = {"a": torch.full((4,), 100.0), "b": torch.full((3,), -50.0)}
    c = ttrain.clip_by_global_norm(g, 1.0)
    norm = float(torch.sqrt(sum(torch.sum(v ** 2) for v in c.values())))
    assert abs(norm - 1.0) < 1e-5
    g2 = {"a": torch.full((4,), 0.1)}
    np.testing.assert_allclose(ttrain.clip_by_global_norm(g2, 10.0)["a"].numpy(),
                               0.1, rtol=1e-6)
    rep = torch.tensor([2.5, 3, 0, 1, 0.5, 0.25, 0.125])
    loss, ids, vals = ttrain.unpack_report(rep, 2)
    assert loss == 2.5 and ids.tolist() == [3, 0] and ids.dtype == np.int64
    np.testing.assert_array_equal(vals, [0.5, 0.25])


def test_torch_unported_options_raise():
    """compute_dtype is ported (tests/test_torch_compute_dtype.py); what a
    step builder refuses is compute_dtype with xz_bf16=True, two precision
    modes the JAX package never combines."""
    spec = tprefab.make_net("bidi", ARGS)
    for make in (ttrain.make_train_step, ttrain.make_cached_train_step,
                 lambda s, **kw: ttrain.make_multi_train_step(s, 2, **kw),
                 ttrain.make_predict_step, ttrain.make_forward):
        make(spec, compute_dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="compute_dtype"):
            make(spec, compute_dtype=torch.bfloat16, xz_bf16=True)
    with pytest.raises(ValueError, match="normalization"):
        _, _, tstate = _start()
        b = {k: torch.from_numpy(v) for k, v in _ctc_batch().items()}
        ttrain.ctc_alignment_loss(tstate.net, b, normalization="bogus")
    with pytest.raises(ValueError, match="spec"):
        _, _, tstate = _start()
        ttrain.make_train_step(tprefab.make_net("lstm1", ARGS))(tstate, b)


def test_torch_state_conversion_round_trip_exact():
    spec, jstate, tstate = _start()
    rng = np.random.RandomState(3)
    vel = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32),
                       jstate.params)
    t = state_from_numpy(tstate.net.spec, jax.tree.map(np.asarray,
                                                      jstate.params), vel, 7)
    p, v, step = state_to_numpy(t)
    assert int(step) == 7 and step.dtype == np.int32
    for a, b in zip(jax.tree.leaves(v), jax.tree.leaves(vel)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(jstate.params)):
        np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(ValueError):
        state_from_numpy(tprefab.make_net("lstm1", ARGS), p, v, 0)


# ---------------------------------------------------------------------------
# Learning checks (ports of tests/test_learning.py configs 1 and 2)
# ---------------------------------------------------------------------------

def test_torch_lstm_learns_delayed_sequence():
    nsym, T, B = 5, 20, 16
    spec, params = jprefab.make_net_init(
        "lstm1", {"ninput": nsym, "nhidden": 32, "noutput": nsym,
                  "initial": 0.1}, jax.random.PRNGKey(0))
    net = params_from_numpy(tprefab.make_net(
        "lstm1", {"ninput": nsym, "nhidden": 32, "noutput": nsym,
                  "initial": 0.1}), jax.tree.map(np.asarray, params))
    state = ttrain.TrainState.create(net)
    step = ttrain.make_train_step(net.spec, lr=0.2, momentum=0.9,
                                  loss_kind="frames", normalization="batch")
    rng = np.random.RandomState(0)
    losses = []
    for _ in range(150):
        b = delayed_sequence_batch(rng, B, T, nsym, delay=1)
        batch = {k: torch.from_numpy(b[k]) for k in ("x", "y", "lengths")}
        state, metrics = step(state, batch)
        losses.append(float(metrics["loss"]))
    b = delayed_sequence_batch(rng, B, T, nsym, delay=1)
    ids, _ = ttrain.make_predict_step(net.spec)(
        state.net, torch.from_numpy(b["x"]), torch.from_numpy(b["lengths"]))
    acc = float((ids.numpy()[:, 1:] == b["classes"][:, 1:]).mean())
    assert acc > 0.9, (acc, losses[::30])
    assert losses[-1] < 0.25 * losses[0], losses[::30]


def toy_ctc_batch(rng, B=8, T=24, nsym=4, rep=3):
    """One-hot input string, each symbol over ``rep`` frames; the target is
    the string itself (tests/test_learning.py's toy CTC transduction)."""
    n = T // rep
    syms = rng.randint(1, nsym, size=(B, n))
    x = np.zeros((B, T, nsym), np.float32)
    for b in range(B):
        for i in range(n):
            x[b, i * rep:(i + 1) * rep, syms[b, i]] = 1.0
    S = 2 * n + 1
    tids = np.zeros((B, S), np.int32)
    tlens = np.zeros(B, np.int32)
    for b in range(B):
        ids = mktargets_ids(syms[b])
        tids[b, :len(ids)] = ids
        tlens[b] = len(ids)
    return {"x": x, "lengths": np.full(B, T, np.int32), "targets": tids,
            "target_lengths": tlens}, syms


def test_torch_ctc_training_learns_toy_transduction():
    nsym, B = 4, 8
    args = {"ninput": nsym, "nhidden": 16, "noutput": nsym, "initial": 0.1}
    _, params = jprefab.make_net_init("bidi", args, jax.random.PRNGKey(2))
    net = params_from_numpy(tprefab.make_net("bidi", args),
                            jax.tree.map(np.asarray, params))
    state = ttrain.TrainState.create(net)
    step = ttrain.make_train_step(net.spec, lr=0.1, momentum=0.9,
                                  loss_kind="ctc", normalization="batch")
    rng = np.random.RandomState(1)
    losses = []
    for _ in range(120):
        batch, _ = toy_ctc_batch(rng)
        state, metrics = step(state, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
        losses.append(float(metrics["loss"]))
    assert losses[-1] < 0.5 * losses[0], (losses[0], losses[-1])
    batch, syms = toy_ctc_batch(rng)
    ids, vals = ttrain.make_predict_step(net.spec)(
        state.net, torch.from_numpy(batch["x"]),
        torch.from_numpy(batch["lengths"]))
    correct = sum(decode_frames(ids[b].numpy(), vals[b].numpy())
                  == list(syms[b]) for b in range(B))
    assert correct >= B // 2, (correct, B)


# ---------------------------------------------------------------------------
# CLSTMOCR training API and the sidecar, across packages
# ---------------------------------------------------------------------------

def _line(rng, h=40, w=90):
    img = np.ones((h, w), np.float32)
    col = 4
    while col < w - 8:
        img[int(h * 0.3):int(h * 0.72), col:col + 2] = 0.1
        col += rng.randint(4, 9)
    return np.clip(img + rng.normal(0, 0.02, img.shape), 0, 1).astype(np.float32)


@pytest.fixture
def ocr_pair():
    """A JAX and a port CLSTMOCR with the same bidi weights (numpy ±0.3)."""
    jocr = JOCR(target_height=16)
    jocr.createBidi(JCodec.build(["abcde"]), nhidden=5)
    rng = np.random.RandomState(4)
    params = jax.tree.map(
        lambda a: rng.uniform(-0.3, 0.3, a.shape).astype(np.float32),
        jocr.state.params)
    jocr.state = jtrain.TrainState.create(jax.tree.map(jnp.asarray, params))
    tocr = CLSTMOCR(target_height=16, device="cpu")
    tocr.createBidi(Codec.build(["abcde"]), nhidden=5)
    assert tocr.spec == tocr.net.spec
    tocr.state = ttrain.TrainState.create(params_from_numpy(tocr.spec, params))
    for o in (jocr, tocr):
        o.setLearningRate(1e-2, 0.9)
    return jocr, tocr


def test_torch_create_bidi_train_utf8_matches_jax(ocr_pair):
    jocr, tocr = ocr_pair
    rng = np.random.RandomState(5)
    outs = []
    for gt in ("abc", "ed", "a"):
        img = _line(rng)
        got, want = tocr.train_utf8(img, gt), jocr.train_utf8(img, gt)
        assert got == want
        outs.append(got)
    assert tocr.state.step == 3
    _assert_state_close(tocr.state, jocr.state)
    assert tocr.predict_utf8(img) == jocr.predict_utf8(img)


def test_torch_sidecar_resumes_across_packages(ocr_pair, tmp_path):
    """A sidecar saved by JAX resumes in the port and gives the same next
    step, and one saved by the port resumes in JAX."""
    jocr, tocr = ocr_pair
    rng = np.random.RandomState(6)
    img = _line(rng)
    jocr.train_utf8(img, "abc")
    jpath = str(tmp_path / "j.clstm")
    jocr.save(jpath)
    resumed = CLSTMOCR(target_height=16, device="cpu")
    resumed.load(jpath)
    resumed.setLearningRate(1e-2, 0.9)
    _assert_state_close(resumed.state, jocr.state)
    img2 = _line(rng)
    assert resumed.train_utf8(img2, "de") == jocr.train_utf8(img2, "de")
    _assert_state_close(resumed.state, jocr.state)
    # And back: the port's sidecar into JAX.
    tpath = str(tmp_path / "t.clstm")
    resumed.save(tpath)
    assert os.path.exists(tpath + ".state.npz")
    back = JOCR(target_height=16)
    back.load(tpath)
    _assert_state_close(resumed.state, back.state)
    # The raw functions, both directions, on one file each.
    save_state(str(tmp_path / "s.npz"), resumed.state)
    js = jload_state(str(tmp_path / "s.npz"), back.state)
    _assert_state_close(resumed.state, js)
    jsave_state(str(tmp_path / "j.npz"), js)
    ts = load_state(str(tmp_path / "j.npz"), resumed.state)
    _assert_state_close(ts, js)


def test_torch_load_ignores_stale_sidecar(ocr_pair, tmp_path):
    _, tocr = ocr_pair
    path = str(tmp_path / "m.clstm")
    tocr.save(path)
    other = CLSTMOCR(target_height=16, device="cpu")
    other.createBidi(Codec.build(["abcdefgh"]), nhidden=3)
    other.save(str(tmp_path / "o.clstm"))
    os.replace(str(tmp_path / "o.clstm.state.npz"), path + ".state.npz")
    fresh = CLSTMOCR(target_height=16, device="cpu")
    with pytest.warns(UserWarning, match="stale"):
        fresh.load(path)
    assert fresh.state.step == 0
    for v in fresh.state.velocity.values():
        assert (v == 0).all()
    np.testing.assert_array_equal(
        jax.tree.leaves(params_to_numpy(fresh.net))[0],
        jax.tree.leaves(params_to_numpy(tocr.net))[0])
