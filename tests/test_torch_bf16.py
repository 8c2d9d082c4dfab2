"""The bf16 production mode of the bidi LSTM layer (``xz_bf16=True``),
against the JAX package on CPU.

On CPU tensors the port's wrappers take their kernels' plain versions,
which apply the JAX package's rounding points (ops/lstm.py). They are held
here against ``bidi_lstm_pallas(..., interpret=True, xz_bf16=True)``, the
TPU kernel's production mode run in interpret mode, and against the f32
``bidi_lstm_apply`` within the envelope the JAX package's own tests give
the mode (tests/test_pallas_lstm.py:54-60, 110-128). The affine layers in
the mode against JAX's ``_affine`` with bf16 operands; whole ``bidi`` and
``bidi2``-shaped nets, forward and one CTC training step, against the same
step composed from the JAX pieces; the default precision on CPU tensors;
the forward kernel's plan with 2-byte elements. Inputs come from numpy
seeds, weights through the convert functions.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from clstm_tpu.models import prefab as jprefab  # noqa: E402
from clstm_tpu.models.spec import ApplyCtx as JApplyCtx  # noqa: E402
from clstm_tpu.models.spec import _affine as jaffine  # noqa: E402
from clstm_tpu.ops import ctc as jctc  # noqa: E402
from clstm_tpu.ops.lstm import bidi_lstm_apply as jbidi  # noqa: E402
from clstm_tpu.ops.pallas_lstm import bidi_lstm_pallas  # noqa: E402
from clstm_tpu.ops.seq import length_mask as jmask  # noqa: E402
from clstm_tpu_torch import train as ttrain  # noqa: E402
from clstm_tpu_torch.convert import (  # noqa: E402
    params_from_numpy, params_to_numpy)
from clstm_tpu_torch.models import prefab as tprefab  # noqa: E402
from clstm_tpu_torch.models.spec import (  # noqa: E402
    Affine, ApplyCtx, NetSpec, Softmax, apply_net)
from clstm_tpu_torch.ops import bidi_lstm_kernel as bk  # noqa: E402
from clstm_tpu_torch.ops import lstm as tlstm  # noqa: E402

# Forward against the TPU kernel's bf16 mode: max |Δy| within one bf16 ulp
# below 1 (2^-8 = 3.9e-3) and mean |Δy| far below it. The two evaluate the
# same rounding points; f32 sums in another order flip a rounding now and
# then, and a flip moves y by one ulp.
Y_MAX, Y_MEAN = 4e-3, 2e-4
# Gradients: within 1e-2 of max|g| of the JAX package's bf16 gradients (the
# port stores the gates and the cell where JAX recomputes them from its
# stored pre-step state, so dz rounds at other values), and within the JAX
# package's own envelope of its f32 gradients, 3% of max|g|
# (tests/test_pallas_lstm.py:110-128).
G_BF16, G_F32 = 1e-2, 3e-2
# The affine: the same dot of bf16 operands in f32, summed in another order.
AFFINE_ATOL = 1e-6
# Whole nets, one CTC step from the same converted weights: the loss to 1e-4
# (f32 sums over frames of logits that agree to a few bf16 ulp of y), the
# updated parameters to 1e-2 of how far the step moved them (G_BF16: at
# step 1 the update is lr·g).
NET_LOSS_RTOL, NET_UPDATE_RTOL = 1e-4, 1e-2
# (B, T, D, H): the in-kernel projection (tests/test_pallas_lstm.py:13-18)
# and the hoisted one (:82-86, D+1 > 128).
SHAPES = {"in-kernel": (4, 16, 5, 7), "hoisted": (2, 8, 160, 7)}


def _params(rng, d, h, scale=0.3):
    return {"Wx": rng.uniform(-scale, scale, (d, 4 * h)).astype(np.float32),
            "Wh": rng.uniform(-scale, scale, (h, 4 * h)).astype(np.float32),
            "b": rng.uniform(-scale, scale, (4 * h,)).astype(np.float32)}


def _setup(route, seed=0):
    B, T, D, H = SHAPES[route]
    rng = np.random.RandomState(seed)
    pf, pr = _params(rng, D, H), _params(rng, D, H)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    lengths = np.array([T, T - 3, T // 2, 1][:B], np.int32)
    gy = rng.uniform(-1, 1, (B, T, 2 * H)).astype(np.float32)
    return pf, pr, x, lengths, gy


def _t(tree, grad=False):
    return {k: torch.from_numpy(v).requires_grad_(grad)
            for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _jax_bf16(pf, pr, x, lengths):
    return bidi_lstm_pallas(_j(pf), _j(pr), jnp.asarray(x),
                            jnp.asarray(lengths), 8, True, True)


# ---------------------------------------------------------------------------
# K3, K1, K4: the forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["K3", "K1", "K4", "K4 state"])
@pytest.mark.parametrize("route", list(SHAPES))
def test_torch_bf16_forward_matches_pallas_interpret(route, kernel):
    pf, pr, x, lengths, _ = _setup(route)
    want = np.asarray(_jax_bf16(pf, pr, x, lengths).astype(jnp.float32))
    tf, tr = _t(pf), _t(pr)
    X, L = torch.from_numpy(x), torch.from_numpy(lengths)
    assert bk.hoists_projection(x.shape[-1], pf["Wh"].shape[0]) == (
        route == "hoisted")
    with torch.no_grad():
        if kernel == "K3":
            y = bk.bidi_lstm_infer(tf, tr, X, L, xz_bf16=True)
        elif kernel == "K1":
            y, gates, cell = bk.bidi_lstm_fwd_state(tf, tr, X, L,
                                                    xz_bf16=True)
            assert gates.dtype == torch.float32
            assert cell.dtype == torch.bfloat16
        else:
            xz = tlstm.hoisted_projection(tf, tr, X, xz_bf16=True)
            assert xz.dtype == torch.bfloat16
            y = (bk.bidi_lstm_infer_xz(tf, tr, xz, L, xz_bf16=True)
                 if kernel == "K4" else
                 bk.bidi_lstm_fwd_state_xz(tf, tr, xz, L, xz_bf16=True)[0])
    assert y.dtype == torch.bfloat16
    d = np.abs(y.float().numpy() - want)
    assert d.max() <= Y_MAX and d.mean() <= Y_MEAN, (d.max(), d.mean())
    # Padded frames exactly 0 in both halves.
    for b, Lb in enumerate(lengths):
        assert not y[b, Lb:].float().abs().sum()


def test_torch_bf16_rounding_points_pinned():
    """The rounding points the TPU kernel has: the projection inside the
    kernel is not rounded, the hoisted one is, and the bias is rounded as a
    row of W_in. The recipe agrees with the TPU kernel to the last bit here;
    each mistake moves y further from it, at the in-kernel shape (D=5, H=7)
    and the hoisted one (D=160, H=7)."""
    for route in SHAPES:
        pf, pr, x, lengths, _ = _setup(route)
        want = np.asarray(_jax_bf16(pf, pr, x, lengths).astype(jnp.float32))
        tf, tr = _t(pf), _t(pr)
        X, L = torch.from_numpy(x), torch.from_numpy(lengths)
        inside = tlstm._projection(tf, tr, X, True)
        bias_f32 = _unrounded_bias(tf, tr, X)
        if route == "in-kernel":
            good = inside
            wrong = {"projection rounded": inside.bfloat16(),
                     "bias f32": bias_f32}
        else:
            good = tlstm.hoisted_projection(tf, tr, X, xz_bf16=True)
            wrong = {"hoisted projection not rounded": inside,
                     "bias f32": bias_f32.bfloat16()}

        def off(xz):
            with torch.no_grad():
                y = tlstm.bidi_lstm_apply_xz(tf, tr, xz, L, xz_bf16=True)
            return float(np.abs(y.float().numpy() - want).mean())
        right = off(good)
        assert right <= Y_MEAN
        for name, xz in wrong.items():
            assert off(xz) > right, name


def _unrounded_bias(tf, tr, X):
    """The in-kernel projection with bf16 x and Wx but an f32 bias."""
    B, T, D = X.shape
    w = torch.cat([tf["Wx"], tr["Wx"]], 1).bfloat16().float()
    b = torch.cat([tf["b"], tr["b"]])
    return torch.addmm(b, X.reshape(B * T, D).bfloat16().float(), w).reshape(
        B, T, 2, -1)


# ---------------------------------------------------------------------------
# K2: the gradients through the training Function
# ---------------------------------------------------------------------------

def _jax_grads(fn, pf, pr, x, lengths, gy):
    def loss(a, b, xx):
        y = fn(a, b, xx, jnp.asarray(lengths))
        return jnp.sum(y.astype(jnp.float32) * gy)
    return jax.grad(loss, argnums=(0, 1, 2))(_j(pf), _j(pr), jnp.asarray(x))


@pytest.mark.parametrize("route", list(SHAPES))
def test_torch_bf16_gradients_match_jax(route):
    pf, pr, x, lengths, gy = _setup(route)
    jb = _jax_grads(lambda a, b, xx, L: bidi_lstm_pallas(a, b, xx, L, 8, True,
                                                         True),
                    pf, pr, x, lengths, gy)
    jf = _jax_grads(jbidi, pf, pr, x, lengths, gy)
    tf, tr = _t(pf, True), _t(pr, True)
    X = torch.from_numpy(x).requires_grad_(True)
    y = bk.bidi_lstm_train(tf, tr, X, torch.from_numpy(lengths),
                           xz_bf16=True)
    assert y.dtype == torch.bfloat16
    (y.float() * torch.from_numpy(gy)).sum().backward()
    got = [(tf[k].grad, jb[0][k], jf[0][k]) for k in ("Wx", "Wh", "b")]
    got += [(tr[k].grad, jb[1][k], jf[1][k]) for k in ("Wx", "Wh", "b")]
    got.append((X.grad, jb[2], jf[2]))
    for g, want_bf16, want_f32 in got:
        assert g.dtype == torch.float32
        g = g.numpy()
        for want, tol in ((want_bf16, G_BF16), (want_f32, G_F32)):
            want = np.asarray(want)
            scale = np.abs(want).max()
            assert np.abs(g - want).max() <= tol * scale


def test_torch_bf16_padded_frames_add_nothing():
    """Padding contents and cotangents on padded frames change no gradient
    (the masks hold in bf16: dz is exactly 0 there)."""
    pf, pr, x, lengths, gy = _setup("in-kernel")
    L = torch.from_numpy(lengths)

    def grads(xv, gv):
        tf, tr = _t(pf, True), _t(pr, True)
        X = torch.from_numpy(xv).requires_grad_(True)
        y = bk.bidi_lstm_train(tf, tr, X, L, xz_bf16=True)
        (y.float() * torch.from_numpy(gv)).sum().backward()
        return [p.grad for p in (*tf.values(), *tr.values(), X)]

    x2, gy2 = x.copy(), gy.copy()
    for b, Lb in enumerate(lengths):
        x2[b, Lb:] = 7.0
        gy2[b, Lb:] = -3.0
    base, padded = grads(x, gy), grads(x2, gy2)
    for a, b in zip(base[:-1], padded[:-1]):
        assert torch.equal(a, b)
    for b, Lb in enumerate(lengths):
        assert torch.equal(base[-1][b, :Lb], padded[-1][b, :Lb])


def test_torch_bf16_wrappers_reject_mixtures():
    pf, pr, x, lengths, _ = _setup("in-kernel")
    tf, tr = _t(pf), _t(pr)
    X, L = torch.from_numpy(x), torch.from_numpy(lengths)
    with pytest.raises(ValueError):
        bk.bidi_lstm_infer(tf, tr, X.bfloat16(), L)          # f32 mode
    with pytest.raises(ValueError):
        bk.bidi_lstm_infer(_t(pf), {**tr, "Wh": tr["Wh"].bfloat16()}, X, L,
                           xz_bf16=True)                     # bf16 weight
    xz = tlstm.hoisted_projection(tf, tr, X)
    with pytest.raises(ValueError):
        bk.bidi_lstm_infer_xz(tf, tr, xz, L, xz_bf16=True)   # f32 xz
    y, gates, cell = bk.bidi_lstm_fwd_state(tf, tr, X, L, xz_bf16=True)
    Wh2 = torch.stack([tf["Wh"], tr["Wh"]])
    gy = torch.zeros_like(y)
    with pytest.raises(ValueError):
        bk.bidi_lstm_bwd_chain(gates, cell, gy.float(), Wh2, L, xz_bf16=True)
    with pytest.raises(ValueError):
        bk.bidi_lstm_bwd_chain(gates, cell, gy, Wh2, L)      # f32 mode
    dz = bk.bidi_lstm_bwd_chain(gates, cell, gy, Wh2, L, xz_bf16=True)
    assert dz.dtype == torch.bfloat16
    Wx2 = torch.stack([tf["Wx"], tr["Wx"]])
    with pytest.raises(ValueError):
        bk.bidi_lstm_bwd_reduce(X, y.float(), dz, Wx2, xz_bf16=True)
    dW, dx = bk.bidi_lstm_bwd_reduce(X, y, dz, Wx2, xz_bf16=True)
    assert dW.dtype == torch.float32 and dx.dtype == torch.float32
    dW2, dx2 = bk.bidi_lstm_bwd_reduce(X.bfloat16(), y, dz, Wx2, xz_bf16=True)
    assert torch.equal(dW, dW2) and dx2.dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# The affine layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16])
def test_torch_bf16_affine_matches_jax(x_dtype):
    """Softmax (logits and posteriors) and an Affine layer in the bf16 mode
    against JAX's _affine with bf16 operands, which computes the same dot
    (on the TPU it takes bf16 without being asked). Gradients as JAX's
    casts give them."""
    rng = np.random.RandomState(4)
    B, T, ni, no = 3, 5, 33, 11
    x = rng.normal(size=(B, T, ni)).astype(np.float32)
    W = rng.uniform(-0.3, 0.3, (ni, no)).astype(np.float32)
    b = rng.uniform(-0.3, 0.3, (no,)).astype(np.float32)
    g = rng.normal(size=(B, T, no)).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16 if x_dtype == torch.bfloat16
                               else jnp.float32)
    ctx = JApplyCtx(compute_dtype=jnp.bfloat16)

    def jz(Wv, bv, xv):
        return jaffine({"W": Wv, "b": bv}, xv, ctx)
    want = np.asarray(jz(jnp.asarray(W), jnp.asarray(b), jx))
    jg = jax.grad(lambda Wv, bv, xv: jnp.sum(jz(Wv, bv, xv) * g),
                  argnums=(0, 1, 2))(jnp.asarray(W), jnp.asarray(b), jx)
    for cls, kind in ((Softmax, "SoftmaxLayer"), (Affine, "TanhLayer")):
        layer = cls(NetSpec.make(kind, {"ninput": ni, "noutput": no}))
        with torch.no_grad():
            layer.W.copy_(torch.from_numpy(W))
            layer.b.copy_(torch.from_numpy(b))
        X = torch.from_numpy(x).to(x_dtype).requires_grad_(True)
        z = layer.affine(X, True)
        assert z.dtype == torch.float32
        assert np.abs(z.detach().numpy() - want).max() <= AFFINE_ATOL
        (z * torch.from_numpy(g)).sum().backward()
        for t, w in ((layer.W.grad, jg[0]), (layer.b.grad, jg[1]),
                     (X.grad, jg[2])):
            assert np.abs(t.float().numpy() - np.asarray(
                w.astype(jnp.float32))).max() <= 1e-6 * max(
                    1.0, float(np.abs(np.asarray(w.astype(jnp.float32))).max()))
        if cls is Softmax:
            with torch.no_grad():
                p = layer(X, None, ApplyCtx(xz_bf16=True))
                logits = layer(X, None, ApplyCtx(logits=True, xz_bf16=True))
            assert p.dtype == logits.dtype == torch.float32
            np.testing.assert_allclose(
                p.numpy(), np.asarray(jax.nn.softmax(jnp.asarray(want), -1)),
                rtol=0, atol=AFFINE_ATOL)
            assert np.abs(logits.numpy() - want).max() <= AFFINE_ATOL
        else:
            with torch.no_grad():
                out = layer(X, None, ApplyCtx(xz_bf16=True))
            assert out.dtype == x_dtype


# ---------------------------------------------------------------------------
# Whole nets: forward and one CTC step against the JAX pieces
# ---------------------------------------------------------------------------

NETS = {"bidi": {"ninput": 12, "nhidden": 8, "noutput": 9},
        # nhidden 64: the smallest whose layer 2 hoists (2·64 + 1 > 128).
        "bidi2": {"ninput": 12, "nhidden": 64, "noutput": 9}}


def _start(kind, seed=0, scale=0.2):
    args = NETS[kind]
    spec, params = jprefab.make_net_init(kind, args, jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda a: rng.uniform(-scale, scale, a.shape).astype(np.float32),
        params)
    net = params_from_numpy(tprefab.make_net(kind, args), params)
    return params, net


def _batch(kind, seed=1, B=4, T=12, S=7):
    rng = np.random.RandomState(seed)
    C = NETS[kind]["noutput"]
    x = rng.rand(B, T, NETS[kind]["ninput"]).astype(np.float32)
    lengths = np.array([T, T - 3, 5, 1], np.int32)[:B]
    tids = np.zeros((B, S), np.int32)
    tlens = np.zeros(B, np.int32)
    for b in range(B):
        ids = jctc.mktargets_ids(rng.randint(1, C, size=(S - 1) // 2 - b % 2))
        tids[b, :len(ids)] = ids
        tlens[b] = len(ids)
    return {"x": x, "lengths": lengths, "targets": tids,
            "target_lengths": tlens}


def _jax_logits(params, x, lengths):
    """The net composed from the JAX pieces of its production mode: each
    bidi layer by bidi_lstm_pallas (interpret mode, xz_bf16=True, no dx for
    the input layer), the softmax layer by _affine on bf16 operands."""
    *layers, soft = params["sub"]
    for i, par in enumerate(layers):
        pf = par["sub"][0]["weights"]
        pr = par["sub"][1]["sub"][0]["weights"]
        x = bidi_lstm_pallas(pf, pr, x, lengths, 8, True, True, i > 0)
    return jaffine(soft["weights"], x, JApplyCtx(compute_dtype=jnp.bfloat16))


@pytest.mark.parametrize("kind", list(NETS))
def test_torch_bf16_net_forward_and_step_match_jax(kind):
    params, net = _start(kind)
    batch = _batch(kind)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jp = jax.tree.map(jnp.asarray, params)
    want = np.asarray(jax.nn.softmax(_jax_logits(jp, jb["x"], jb["lengths"]),
                                     -1))
    got = apply_net(net, tb["x"], tb["lengths"], inference=True,
                    xz_bf16=True).numpy()
    valid = np.asarray(jmask(jb["lengths"], batch["x"].shape[1])) > 0
    assert np.abs(got - want)[valid].max() <= Y_MAX

    def loss(p):
        logits = _jax_logits(p, jb["x"], jb["lengths"]).astype(jnp.float32)
        probs = jax.nn.softmax(logits, -1)
        aligned = jax.lax.stop_gradient(jctc.ctc_align_targets_batched(
            jax.lax.stop_gradient(probs), jb["targets"], lengths=jb["lengths"],
            target_lengths=jb["target_lengths"]))
        mask = jmask(jb["lengths"], batch["x"].shape[1])
        return jnp.sum(-jnp.sum(aligned * jax.nn.log_softmax(logits, -1), -1)
                       * mask)
    lr = 0.01
    jloss, jg = jax.value_and_grad(loss)(jp)
    jnew = jax.tree.map(lambda p, g: p - lr * g, jp, jg)
    state = ttrain.TrainState.create(net)
    before = [p.detach().clone() for p in net.parameters()]
    step = ttrain.make_train_step(net.spec, lr, 0.9, loss_kind="ctc",
                                  normalization="none", xz_bf16=True)
    state, m = step(state, tb)
    assert abs(float(m["loss"]) - float(jloss)) <= NET_LOSS_RTOL * abs(
        float(jloss))
    got_tree = params_to_numpy(net)
    for (a, want_p, p0) in zip(jax.tree.leaves(got_tree),
                               jax.tree.leaves(jnew),
                               jax.tree.leaves(params)):
        moved = np.abs(np.asarray(want_p) - p0).max()
        assert np.abs(a - np.asarray(want_p)).max() <= NET_UPDATE_RTOL * moved
    assert any(not torch.equal(a, b) for a, b in zip(before, net.parameters()))


# ---------------------------------------------------------------------------
# The default precision
# ---------------------------------------------------------------------------

def test_torch_bf16_default_is_f32_on_cpu():
    """xz_bf16=None resolves to f32 on a CPU tensor (the JAX package's CPU
    path is lax.scan in f32), so every f32 parity test is unchanged; True
    gives the bf16 mode."""
    assert not ApplyCtx().bf16(torch.zeros(1))
    assert ApplyCtx(xz_bf16=True).bf16(torch.zeros(1))
    assert not ApplyCtx(xz_bf16=False).bf16(torch.zeros(1))
    _, net = _start("bidi")
    batch = _batch("bidi")
    X, L = torch.from_numpy(batch["x"]), torch.from_numpy(batch["lengths"])
    with torch.no_grad():
        default = apply_net(net, X, L)
        f32 = apply_net(net, X, L, xz_bf16=False)
        bf16 = apply_net(net, X, L, xz_bf16=True)
    assert torch.equal(default, f32) and not torch.equal(default, bf16)
    ocr_steps = [ttrain.make_train_step(net.spec, xz_bf16=v)
                 for v in (None, False)]
    losses = []
    for step in ocr_steps:
        _, fresh = _start("bidi")
        state = ttrain.TrainState.create(fresh)
        tb = {k: torch.from_numpy(v) for k, v in batch.items()}
        losses.append(float(step(state, tb)[1]["loss"]))
    assert losses[0] == losses[1]


def test_torch_bf16_clstmocr_mode_reaches_training():
    """CLSTMOCR.xz_bf16 set after a training step was built takes effect in
    training as it does in prediction: the next step runs in the new mode,
    bitwise as a step built in that mode from the same state."""
    from clstm_tpu_torch.models.codec import Codec
    from clstm_tpu_torch.models.hl import CLSTMOCR

    batch = _batch("bidi")
    ocrs = []
    for _ in range(3):
        o = CLSTMOCR(target_height=NETS["bidi"]["ninput"], device="cpu")
        o.createBidi(Codec.build(["abcdefgh"]), nhidden=8)
        o.setLearningRate(1e-2, 0.9)
        o.train_batch(batch)
        ocrs.append(o)
    switched, built, f32 = ocrs
    switched.xz_bf16 = True
    switched.train_batch(batch)
    step = ttrain.make_train_step(built.spec, built.lr, built.momentum,
                                  **{**built._step_options(),
                                     "xz_bf16": True})
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    built.state, _ = step(built.state, tb, built.lr, built.momentum)
    f32.train_batch(batch)
    pairs = list(zip(switched.net.parameters(), built.net.parameters(),
                     f32.net.parameters()))
    assert all(torch.equal(a, b) for a, b, _ in pairs)
    assert any(not torch.equal(a, c) for a, _, c in pairs)


# ---------------------------------------------------------------------------
# The forward kernel's plan with 2-byte elements
# ---------------------------------------------------------------------------

# The bench shapes in the bf16 mode (B, D, H, hoist) -> (C, rows, resident)
# with the H100's cluster counts: half the bytes of the f32 plans'
# weights let bidi run on one CTA a chain, bidi2's layer 1 keep its whole
# slice at C=2 (f32: Wh's alone at C=4) and layer 2 at C=2 (f32: C=4).
BF16_PLAN = {(256, 48, 100, False): (1, 4, 1), (256, 48, 200, False): (2, 8, 1),
             (256, 0, 200, True): (2, 8, 1)}


@pytest.mark.parametrize("shape", list(BF16_PLAN))
def test_torch_bf16_plan_bench_shapes(shape):
    B, D, H, hoist = shape
    for state in (False, True):
        p = bk.fwd_plan(B, D, H, hoist, state, esize=2)
        assert (p.C, p.rows, p.resident) == BF16_PLAN[shape]
        assert 2 * p.groups <= p.clusters
        assert p.smem == bk.fwd_smem(D, H, p.rows, p.units, hoist,
                                     p.resident, 2)
        # The same plan in f32 takes more shared memory or a larger C.
        f = bk.fwd_plan(B, D, H, hoist, state)
        assert f.C >= p.C


@pytest.mark.parametrize("B,D,H", [(5, 4, 7), (3, 50, 300), (17, 48, 201),
                                   (2, 2, 1), (4, 6, 700), (2, 4, 2048),
                                   (3, 130, 7)])
def test_torch_bf16_plan_covers_and_fits(B, D, H):
    for hoist in (False, True):
        d = 0 if hoist else D
        p = bk.fwd_plan(B, d, H, hoist, True, esize=2)
        assert p.smem == bk.fwd_smem(d, H, p.rows, p.units, hoist,
                                     p.resident, 2)
        assert p.smem <= bk.SMEM_MAX and p.threads <= bk.FWD_THREADS
        assert p.smem % 4 == 0
        assert p.groups * p.rows >= B > (p.groups - 1) * p.rows
        owned = [range(c * p.units, min(H, (c + 1) * p.units))
                 for c in range(p.C)]
        assert all(len(r) > 0 for r in owned)
        assert sorted(k for r in owned for k in r) == list(range(H))


def test_torch_bf16_smem_layout():
    """fwd_smem with 2-byte elements: the weights' bytes rounded up to 16
    (the f32 h buffer after them is read 16 bytes at a time), h f32, the x
    ring in bf16; with 4-byte elements the f32 layout."""
    D, H, rows, units = 48, 100, 4, 100
    w = (H + D + 1) * 4 * units
    assert bk.fwd_smem(D, H, rows, units, False, 1, 2) == (
        -(-2 * w // 16) * 16 + 8 * H * rows + 2 * 3 * rows * D + 4 * rows)
    assert bk.fwd_smem(D, H, rows, units, False, 1) == 4 * (
        w + 2 * H * rows + 3 * rows * D + rows)
    assert bk.fwd_smem(D, 7, 4, 7, False, 1, 2) % 16 == (
        4 * 2 * 7 * 4 + 2 * 3 * 4 * D + 16) % 16


def test_torch_bf16_fwd_weights_pad_odd_d():
    """The bf16 kernel's weights: rounded to bf16, interleaved by unit, a
    zero row before the bias for an odd D, which the x stream matches with a
    zero column."""
    rng = np.random.RandomState(5)
    D, H = 5, 3
    pf, pr = _t(_params(rng, D, H)), _t(_params(rng, D, H))
    wx, wh = bk.fwd_weights(pf, pr, True, bf16=True)
    assert wx.dtype == wh.dtype == torch.bfloat16
    assert wx.shape == (2, D + 2, H, 4)
    assert not wx[:, D].float().abs().sum()
    for d, p in enumerate((pf, pr)):
        for u in range(H):
            for g in range(4):
                assert torch.equal(wx[d, :D, u, g],
                                   p["Wx"][:, g * H + u].bfloat16())
                assert wx[d, D + 1, u, g] == p["b"][g * H + u].bfloat16()
    x = torch.from_numpy(rng.normal(size=(2, 3, D)).astype(np.float32))
    xb = bk._x_bf16(x)
    assert xb.shape == (2, 3, D + 1) and not xb[..., D].float().abs().sum()
    assert torch.equal(xb[..., :D], x.bfloat16())


# ---------------------------------------------------------------------------
# The launch counters
# ---------------------------------------------------------------------------

def _counted_calls(B, T, bf16):
    """Each wrapper with a kernel, on meta tensors of batch B and T frames:
    name -> a call of it."""
    D, H = 6, 5
    dt = torch.bfloat16 if bf16 else torch.float32

    def m(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device="meta")

    def w():
        return {"Wx": m(D, 4 * H), "Wh": m(H, 4 * H), "b": m(4 * H)}
    pf, pr = w(), w()
    x, xz = m(B, T, D), m(B, T, 2, 4 * H, dtype=dt)
    mode = {"xz_bf16": bf16}
    return {
        "bidi_lstm_infer": lambda: bk.bidi_lstm_infer(pf, pr, x, hoist=False,
                                                      **mode),
        "bidi_lstm_fwd_state": lambda: bk.bidi_lstm_fwd_state(pf, pr, x,
                                                              **mode),
        "bidi_lstm_infer_xz": lambda: bk.bidi_lstm_infer_xz(pf, pr, xz,
                                                            **mode),
        "bidi_lstm_fwd_state_xz": lambda: bk.bidi_lstm_fwd_state_xz(
            pf, pr, xz, **mode),
        "bidi_lstm_bwd_chain": lambda: bk.bidi_lstm_bwd_chain(
            m(B, T, 2, 4 * H), m(B, T, 2, H, dtype=dt), m(B, T, 2 * H,
                                                          dtype=dt),
            m(2, H, 4 * H), **mode),
        "bidi_lstm_bwd_reduce": lambda: bk.bidi_lstm_bwd_reduce(
            x, m(B, T, 2 * H, dtype=dt), m(B, T, 2, 4 * H, dtype=dt),
            m(2, D, 4 * H), **mode),
    }


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_torch_launch_counted_only_where_launched(bf16, monkeypatch):
    """Each wrapper adds one to its count where it launches its kernel and
    nowhere else: an empty batch (B = 0 or T = 0) launches nothing and
    counts nothing. The wrappers run on meta tensors with the C entry points
    replaced by a recorder, so the check needs no card."""
    launched = []
    monkeypatch.setattr(bk, "_check_device", lambda device: None)
    monkeypatch.setattr(bk, "_launch",
                        lambda name, device, *args: launched.append(
                            (name, args)))
    monkeypatch.setattr(bk, "_kernel", lambda name: lambda *args: 16)
    monkeypatch.setattr(
        bk, "device_plan", lambda device, B, D, H, hoist, state, esize,
        ndir: bk.fwd_plan(B, D, H, hoist, state, esize=esize, ndir=ndir))
    for name in _counted_calls(1, 1, bf16):
        monkeypatch.setattr(getattr(bk, name), "launches", 0)
    for B, T in ((0, 4), (3, 0)):
        for name, call in _counted_calls(B, T, bf16).items():
            call()
            assert getattr(bk, name).launches == 0, (name, B, T)
    assert not launched
    # Each wrapper's entry and its trailing mode arguments: the forward's
    # (hoist, emit, bf, dm) on the FMA kernel (T=4 is inside
    # fwd16_prefers_old's window), the L2 chain's (bf, dm), and in the bf16
    # mode the chain on thread-block clusters (chain_plan gives a cluster
    # plan at every width below several hundred units) and the bf16
    # reduction with dm; the f32 reduction takes no mode.
    bf = int(bf16)
    entry = {"bidi_lstm_infer": ("clstm_lstm_fwd", (0, 0, bf, 0)),
             "bidi_lstm_fwd_state": ("clstm_lstm_fwd", (0, 1, bf, 0)),
             "bidi_lstm_infer_xz": ("clstm_lstm_fwd", (1, 0, bf, 0)),
             "bidi_lstm_fwd_state_xz": ("clstm_lstm_fwd", (1, 1, bf, 0)),
             "bidi_lstm_bwd_chain": (("clstm_lstm_bwd_chain16", (0,)) if bf16
                                     else ("clstm_lstm_bwd_chain", (0, 0))),
             "bidi_lstm_bwd_reduce": (("clstm_lstm_bwd_reduce_bf16", (0,))
                                      if bf16 else
                                      ("clstm_lstm_bwd_reduce", ()))}
    for name, call in _counted_calls(3, 4, bf16).items():
        call()
        assert getattr(bk, name).launches == 1, name
        got, args = launched[-1]
        want, mode = entry[name]
        assert (got, args[len(args) - len(mode):]) == (want, mode), name
    assert len(launched) == 6
