"""The deep ``bidi2`` net and the hoisted-projection LSTM path (K4), and the
second CTC direction alone (K6b), against the JAX package, on CPU.

K4 and K6b run here as their plain versions — the wrappers take them for
CPU tensors — and are held against the TPU kernels they replace:
``bidi_lstm_pallas`` with its hoisted projection (D+1 > the lane-padded H)
and ``ctc_backward_pallas``, both in interpret mode, strict f32. The
``bidi2`` net at nhidden 64, the smallest width whose second layer hoists
(2·64 + 1 > 128), runs forward and three training steps against the JAX
package from the same converted weights; a spy on the plain versions shows
which layer took which route. Inputs come from numpy seeds.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from clstm_tpu import train as jtrain  # noqa: E402
from clstm_tpu.models import prefab as jprefab  # noqa: E402
from clstm_tpu.models.hl import CLSTMOCR as JOCR  # noqa: E402
from clstm_tpu.ops import ctc as jctc  # noqa: E402
from clstm_tpu.ops.pallas_ctc import ctc_backward_pallas  # noqa: E402
from clstm_tpu.ops.pallas_lstm import _hp_for, bidi_lstm_pallas  # noqa: E402
from clstm_tpu_torch import train as ttrain  # noqa: E402
from clstm_tpu_torch.cli import clstmocr as tcli  # noqa: E402
from clstm_tpu_torch.convert import (  # noqa: E402
    params_from_numpy, params_to_numpy, state_from_numpy, state_to_numpy)
from clstm_tpu_torch.models import prefab as tprefab  # noqa: E402
from clstm_tpu_torch.models.codec import Codec  # noqa: E402
from clstm_tpu_torch.models.hl import CLSTMOCR  # noqa: E402
from clstm_tpu_torch.ops import bidi_lstm_kernel as bk  # noqa: E402
from clstm_tpu_torch.ops import ctc as tctc  # noqa: E402
from clstm_tpu_torch.ops import lstm as tlstm  # noqa: E402
from clstm_tpu_torch.ops.ctc_kernel import ctc_backward  # noqa: E402

# y of the K4 plain route against the Pallas kernel: f32 with the input
# projection summed over 160 terms in another order (XLA's dot, torch's
# addmm); 2e-6 absolute is a few ulp of |y| < 1, a wrong gate or frame
# moves y by 1e-2.
Y_RTOL, Y_ATOL = 1e-5, 2e-6
# Gradients: f32 sums over the frames and the 160-wide input in another
# order; 1e-5 relative plus 1e-6 absolute is ~100 ulp of the largest
# entries (the tolerance of tests/test_torch_train.py).
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6
# bidi2 forward and 3 SGD steps from the same converted state: two stacked
# layers of the differences above, carried through lr 0.01, momentum 0.9.
NET_RTOL, NET_ATOL = 1e-5, 1e-5
# K6b's DP values reach ~-300 here; the recurrences agree to a few ulp
# per step (the tolerance of tests/test_torch_ctc.py).
DP_RTOL, DP_ATOL = 1e-5, 1e-5
B, T, D, H = 2, 8, 160, 7          # tests/test_pallas_lstm.py:82-107
LENGTHS = np.array([8, 5], np.int32)
NET_ARGS = {"ninput": 12, "nhidden": 64, "noutput": 9}


def _lstm_params(rng, d, h, scale=0.2):
    return {"Wx": rng.uniform(-scale, scale, (d, 4 * h)).astype(np.float32),
            "Wh": rng.uniform(-scale, scale, (h, 4 * h)).astype(np.float32),
            "b": rng.uniform(-scale, scale, (4 * h,)).astype(np.float32)}


def _hoisting_setup(seed=0):
    rng = np.random.RandomState(seed)
    pf, pr = _lstm_params(rng, D, H), _lstm_params(rng, D, H)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    gy = rng.uniform(-1, 1, (B, T, 2 * H)).astype(np.float32)
    return pf, pr, x, gy


def _t(tree, grad=False):
    return {k: torch.from_numpy(v).requires_grad_(grad) for k, v in tree.items()}


def _jnp(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


class _Spy:
    """Wraps the plain versions the wrappers call on CPU tensors and records
    the input width of each call, by route."""

    ROUTES = {"bidi_lstm_apply": "in-kernel", "bidi_lstm_fwd_state_plain":
              "in-kernel", "bidi_lstm_apply_xz": "hoisted",
              "bidi_lstm_fwd_state_xz_plain": "hoisted"}

    def __init__(self, monkeypatch):
        self.calls = []
        for name, route in self.ROUTES.items():
            monkeypatch.setattr(bk, name, self._wrap(getattr(bk, name), route))

    def _wrap(self, fn, route):
        def spy(params_f, params_r, inp, lengths=None):
            width = (inp.shape[-1] if route == "in-kernel"
                     else params_f["Wx"].shape[0])
            self.calls.append((route, width))
            return fn(params_f, params_r, inp, lengths)
        return spy


@pytest.mark.parametrize("d,h", [(48, 100), (200, 100), (48, 200), (400, 200),
                                 (127, 128), (128, 128), (128, 64), (255, 200),
                                 (256, 200), (160, 7)])
def test_torch_hoists_projection_matches_jax_rule(d, h):
    """The rule of pallas_lstm.py:836 (dc > hp) at the net shapes: bidi's
    layer (48, 100) and bidi2's layer 1 (48, 200) keep the projection in
    the kernel, bidi2's layer 2 (400, 200) hoists it."""
    assert bk.hoists_projection(d, h) == (d + 1 > _hp_for(h))
    named = {(48, 100): False, (200, 100): True, (48, 200): False,
             (400, 200): True}
    if (d, h) in named:
        assert bk.hoists_projection(d, h) == named[(d, h)]


def test_torch_hoists_projection_grid():
    for d in range(1, 520, 7):
        for h in (1, 7, 64, 100, 127, 128, 129, 200, 256, 257):
            assert bk.hoists_projection(d, h) == (d + 1 > _hp_for(h)), (d, h)


def test_torch_k4_forward_matches_pallas_interpret(monkeypatch):
    """The hoisted product plus K4's plain versions against the TPU
    kernel's hoisted path, and both modes against each other."""
    pf, pr, x, _ = _hoisting_setup()
    assert bk.hoists_projection(D, H)
    want = np.asarray(bidi_lstm_pallas(_jnp(pf), _jnp(pr), jnp.asarray(x),
                                       jnp.asarray(LENGTHS), 8, True, False))
    spy = _Spy(monkeypatch)
    tf, tr, X, L = _t(pf), _t(pr), torch.from_numpy(x), torch.from_numpy(LENGTHS)
    y = bk.bidi_lstm_infer(tf, tr, X, L)
    assert spy.calls == [("hoisted", D)]
    np.testing.assert_allclose(y.numpy(), want, rtol=Y_RTOL, atol=Y_ATOL)
    xz = tlstm.hoisted_projection(tf, tr, X)
    assert xz.shape == (B, T, 2, 4 * H) and xz.dtype == torch.float32
    np.testing.assert_allclose(
        xz.numpy(), np.einsum("btd,gdj->btgj", x.astype(np.float64),
                              np.stack([pf["Wx"], pr["Wx"]]))
        + np.stack([pf["b"], pr["b"]]), rtol=1e-5, atol=1e-5)
    ys, gates, cell = bk.bidi_lstm_fwd_state_xz(tf, tr, xz, L)
    np.testing.assert_array_equal(ys.numpy(), y.numpy())
    # K1's plain version computes the same product inside its own forward.
    k1 = tlstm.bidi_lstm_fwd_state_plain(tf, tr, X, L)
    for got, ref in zip((ys, gates, cell), k1):
        np.testing.assert_array_equal(got.numpy(), ref.numpy())
    for b, Lb in enumerate(LENGTHS):
        for s in (ys, gates, cell):
            assert (s[b, Lb:] == 0).all()
    h = torch.tanh(cell) * gates[..., 2 * H:3 * H]
    np.testing.assert_allclose(h.reshape(B, T, 2 * H).numpy(), y.numpy(),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("need_dx", [True, False])
def test_torch_k4_grads_match_pallas_vjp(need_dx, monkeypatch):
    """The port's autograd Function on the hoisting shape (hoisted product
    and K4's plain state mode forward, K2's plain backward) against
    jax.grad of the TPU kernel's hoisted path."""
    pf, pr, x, gy = _hoisting_setup(seed=1)
    spy = _Spy(monkeypatch)
    tf, tr = _t(pf, True), _t(pr, True)
    X = torch.from_numpy(x).requires_grad_(need_dx)
    y = bk.bidi_lstm_train(tf, tr, X, torch.from_numpy(LENGTHS))
    (y * torch.from_numpy(gy)).sum().backward()
    assert spy.calls == [("hoisted", D)]

    def loss(a, b_, xx):
        return jnp.sum(bidi_lstm_pallas(a, b_, xx, jnp.asarray(LENGTHS), 8,
                                        True, False, need_dx) * gy)

    jgf, jgr, jdx = jax.grad(loss, argnums=(0, 1, 2))(_jnp(pf), _jnp(pr),
                                                      jnp.asarray(x))
    for got, want in ((tf, jgf), (tr, jgr)):
        for k in ("Wx", "Wh", "b"):
            np.testing.assert_allclose(got[k].grad.numpy(), np.asarray(want[k]),
                                       rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                       err_msg=k)
    if need_dx:
        np.testing.assert_allclose(X.grad.numpy(), np.asarray(jdx),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)
        assert (X.grad[1, LENGTHS[1]:] == 0).all()
    else:
        assert X.grad is None


def test_torch_k4_wrappers_reject_and_count_no_cpu_launch():
    pf, pr, x, gy = _hoisting_setup()
    tf, tr, X, L = _t(pf), _t(pr), torch.from_numpy(x), torch.from_numpy(LENGTHS)
    counters = (bk.bidi_lstm_infer, bk.bidi_lstm_fwd_state,
                bk.bidi_lstm_infer_xz, bk.bidi_lstm_fwd_state_xz,
                bk.bidi_lstm_bwd_chain, bk.bidi_lstm_bwd_reduce)
    before = [f.launches for f in counters]
    xz = tlstm.hoisted_projection(tf, tr, X)
    bk.bidi_lstm_infer(tf, tr, X, L)
    bk.bidi_lstm_infer(tf, tr, X, L, hoist=False)
    bk.bidi_lstm_fwd_state_xz(tf, tr, xz, L)
    tg, tgr = _t(pf, True), _t(pr, True)
    (bk.bidi_lstm_train(tg, tgr, X, L) * torch.from_numpy(gy)).sum().backward()
    assert [f.launches for f in counters] == before
    bad = {"xz_3d": xz[:, :, 0], "xz_float64": xz.double(),
           "xz_wrong_gates": xz[..., :-1].contiguous(),
           "xz_noncontiguous": xz.transpose(0, 1).contiguous().transpose(0, 1)}
    for name, arg in bad.items():
        for fn in (bk.bidi_lstm_infer_xz, bk.bidi_lstm_fwd_state_xz):
            with pytest.raises(ValueError):
                fn(tf, tr, arg, L)
    with pytest.raises(ValueError):
        bk.bidi_lstm_infer_xz(tf, tr, xz, L.long())
    assert [f.launches for f in counters] == before


# ---------------------------------------------------------------------------
# The bidi2 net against JAX
# ---------------------------------------------------------------------------

def _bidi2_start(scale=0.2, seed=0):
    spec, params = jprefab.make_net_init("bidi2", NET_ARGS,
                                         jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda a: rng.uniform(-scale, scale, a.shape).astype(np.float32),
        params)
    zeros = jax.tree.map(np.zeros_like, params)
    tstate = state_from_numpy(tprefab.make_net("bidi2", NET_ARGS), params,
                              zeros, 0)
    return spec, jtrain.TrainState.create(jax.tree.map(jnp.asarray, params)), \
        tstate


def _bidi2_batch(seed=1, B=4, T=12, S=7):
    rng = np.random.RandomState(seed)
    C = NET_ARGS["noutput"]
    x = rng.rand(B, T, NET_ARGS["ninput"]).astype(np.float32)
    lengths = np.array([T, T - 3, 5, 1], np.int32)[:B]
    tids = np.zeros((B, S), np.int32)
    tlens = np.zeros(B, np.int32)
    for b in range(B):
        ids = jctc.mktargets_ids(rng.randint(1, C, size=(S - 1) // 2 - b % 2))
        tids[b, :len(ids)] = ids
        tlens[b] = len(ids)
    return {"x": x, "lengths": lengths, "targets": tids,
            "target_lengths": tlens}


def test_torch_bidi2_forward_matches_jax(monkeypatch):
    spec, jstate, tstate = _bidi2_start()
    batch = _bidi2_batch()
    x, L = batch["x"], batch["lengths"]
    spy = _Spy(monkeypatch)
    want = jtrain.make_forward(spec)(jstate.params, jnp.asarray(x),
                                     jnp.asarray(L))
    got = ttrain.make_forward(tstate.net.spec)(tstate.net, torch.from_numpy(x),
                                               torch.from_numpy(L))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=NET_RTOL, atol=NET_ATOL)
    jids, jvals = jtrain.make_predict_step(spec)(jstate.params, jnp.asarray(x),
                                                 jnp.asarray(L))
    tids, tvals = ttrain.make_predict_step(tstate.net.spec)(
        tstate.net, torch.from_numpy(x), torch.from_numpy(L))
    for r, Lr in enumerate(L):
        np.testing.assert_array_equal(tids[r, :Lr].numpy(),
                                      np.asarray(jids)[r, :Lr])
    np.testing.assert_allclose(tvals.numpy(), np.asarray(jvals),
                               rtol=NET_RTOL, atol=NET_ATOL)
    # Layer 1 (D=12) keeps its projection in the kernel, layer 2 (D=128,
    # H=64: 129 > 128) hoists it; once with gradients, once without.
    ninput, nh = NET_ARGS["ninput"], NET_ARGS["nhidden"]
    assert spy.calls == [("in-kernel", ninput), ("hoisted", 2 * nh)] * 2


def test_torch_bidi2_train_steps_match_jax(monkeypatch):
    spec, jstate, tstate = _bidi2_start()
    batch = _bidi2_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    jstep = jtrain.make_train_step(spec, 0.01, 0.9, donate=False,
                                   loss_kind="ctc", normalization="none")
    tstep = ttrain.make_train_step(tstate.net.spec, 0.01, 0.9,
                                   loss_kind="ctc", normalization="none")
    spy = _Spy(monkeypatch)
    for _ in range(3):
        jstate, jm = jstep(jstate, jb)
        tstate, tm = tstep(tstate, tb)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=NET_RTOL)
        np.testing.assert_array_equal(tm["frame_ids"].numpy(),
                                      np.asarray(jm["frame_ids"]))
    assert spy.calls == [("in-kernel", NET_ARGS["ninput"]),
                         ("hoisted", 2 * NET_ARGS["nhidden"])] * 3
    p, v, step = state_to_numpy(tstate)
    assert int(step) == int(jstate.step) == 3
    for got, want in ((p, jstate.params), (v, jstate.velocity)):
        assert jax.tree.structure(got) == jax.tree.structure(want)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=NET_RTOL,
                                       atol=NET_ATOL)


def test_torch_bidi2_convert_round_trip_exact():
    spec, jstate, tstate = _bidi2_start(seed=3)
    tree = jax.tree.map(np.asarray, jstate.params)
    back = params_to_numpy(params_from_numpy(tstate.net.spec, tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)
    layer2 = back["sub"][1]["sub"][0]["weights"]
    assert layer2["Wx"].shape == (2 * 64, 4 * 64)


def _codec400():
    """400 classes: the blank and 399 distinct code points, made in code."""
    return Codec([0] + [0x4E00 + 3 * i for i in range(399)])


def _line(rng, h=16, w=70):
    img = np.ones((h, w), np.float32)
    col = 3
    while col < w - 6:
        img[int(h * 0.3):int(h * 0.72), col:col + 2] = 0.1
        col += rng.randint(3, 8)
    return np.clip(img + rng.normal(0, 0.02, img.shape), 0, 1).astype(np.float32)


def test_torch_bidi2_400_classes_entry_points(tmp_path, monkeypatch):
    """createBidi(kind="bidi2") with a 400-class codec: train_batch,
    save/load with the sidecar, clstmocr, and the same file read by the
    JAX package predicts the same strings."""
    from clstm_tpu_torch.io.png import write_png

    codec = _codec400()
    assert codec.size() == 400
    ocr = CLSTMOCR(target_height=16, device="cpu")
    ocr.createBidi(codec, 8, kind="bidi2", initial=0.3)
    assert ocr.spec == ocr.net.spec and ocr.spec.iget("noutput") == 400
    ocr.setLearningRate(1e-3, 0.9)
    rng = np.random.RandomState(2)
    gt = "".join(chr(codec.codec[i]) for i in rng.randint(1, 400, 5))
    assert len(codec.encode(gt, strict=True)) == 5
    before = {n: p.detach().clone() for n, p in ocr.net.named_parameters()}
    out = ocr.train_utf8(_line(rng), gt)
    assert isinstance(out, str) and ocr.state.step == 1
    assert any(not torch.equal(before[n], p)
               for n, p in ocr.net.named_parameters())
    path = str(tmp_path / "bidi2.clstm")
    ocr.save(path)
    assert os.path.exists(path + ".state.npz")
    back = CLSTMOCR(target_height=16, device="cpu")
    back.load(path)
    assert back.spec == ocr.spec and back.codec.codec == codec.codec
    assert back.state.step == 1
    for (n, p), q in zip(ocr.net.named_parameters(), back.net.parameters()):
        assert torch.equal(p, q)
        assert torch.equal(ocr.state.velocity[n], back.state.velocity[n])
    images = [_line(rng, 16, w) for w in (40, 90, 150)]
    jocr = JOCR(target_height=16)
    jocr.load(path)
    for img in images:
        assert back.predict_utf8(img) == jocr.predict_utf8(img)
    files = []
    for i, img in enumerate(images):
        f = str(tmp_path / f"l{i}.png")
        write_png(f, img)
        files.append(f)
    monkeypatch.setenv("load", path)
    monkeypatch.setenv("device", "cpu")
    monkeypatch.setenv("output", "sidecar")
    assert tcli.main(files) == 0
    for f, img in zip(files, images):
        with open(f[:-4] + ".txt", encoding="utf-8") as fh:
            assert fh.read() == jocr.predict_utf8(img) + "\n"


# ---------------------------------------------------------------------------
# K6b: the second CTC direction alone
# ---------------------------------------------------------------------------

def _lattice(B_, T_, S, seed):
    rng = np.random.RandomState(seed)
    lmatch = np.log(rng.rand(B_, T_, S).astype(np.float32) + 1e-3)
    tlens = rng.randint(1, min(S, 40) + 1, size=B_).astype(np.int32)
    lengths = rng.randint(0, T_ + 1, size=B_).astype(np.int32)
    lengths[0], lengths[1] = T_, 0
    for b in range(B_):
        lmatch[b, :, tlens[b]:] = jctc.NEG
    return lmatch, lengths, tlens


def test_torch_k6b_plain_matches_pallas_interpret():
    """K6b's plain version (the flip recipe) against ctc_backward_pallas at
    the TPU's layout (S=128), on valid cells (t < len, s < tlen) only: the
    two fill padded cells differently, as tests/test_pallas_ctc.py:47-55
    notes."""
    lmatch, lengths, tlens = _lattice(8, 32, 128, seed=11)
    lm, L, TL = (torch.from_numpy(a) for a in (lmatch, lengths, tlens))
    before = ctc_backward.launches
    got = ctc_backward(lm, L, TL).numpy()
    assert ctc_backward.launches == before
    want = np.asarray(ctc_backward_pallas(jnp.asarray(lmatch),
                                          jnp.asarray(lengths),
                                          jnp.asarray(tlens), interpret=True))
    for b in range(8):
        np.testing.assert_allclose(got[b, :lengths[b], :tlens[b]],
                                   want[b, :lengths[b], :tlens[b]],
                                   rtol=DP_RTOL, atol=DP_ATOL,
                                   err_msg=f"row {b}")
    tvalid = torch.arange(32)[None, :] < L[:, None]
    for use_kernel in (None, True, False):
        np.testing.assert_array_equal(
            tctc._backward_dp(lm, tvalid, L, TL, -5.0, use_kernel).numpy(),
            got)
    with pytest.raises(ValueError):
        ctc_backward(lm, L, TL.long())
    assert ctc_backward.launches == before


def test_torch_align_unfused_routes_and_matches_jax():
    """The scan recipe (fused=False) with its second direction through the
    K6b wrapper (use_kernel=True: the plain version on CPU) equals the JAX
    scan recipe, as the fused path does."""
    rng = np.random.RandomState(12)
    Bq, Tq, C, S = 5, 20, 6, 9
    probs = rng.dirichlet(np.ones(C), size=(Bq, Tq)).astype(np.float32)
    lengths = np.array([20, 13, 7, 1, 0], np.int32)
    tids = np.zeros((Bq, S), np.int32)
    tlens = np.zeros(Bq, np.int32)
    for b in range(Bq):
        ids = jctc.mktargets_ids(rng.randint(1, C, size=rng.randint(0, 5)))
        tids[b, :len(ids)] = ids
        tlens[b] = len(ids)
    want = np.asarray(jctc.ctc_align_targets_batched(
        jnp.asarray(probs), jnp.asarray(tids), lengths=jnp.asarray(lengths),
        target_lengths=jnp.asarray(tlens), use_pallas=False))
    for use_kernel in (True, False):
        got = tctc.ctc_align_targets_batched(
            torch.from_numpy(probs), torch.from_numpy(tids),
            lengths=torch.from_numpy(lengths),
            target_lengths=torch.from_numpy(tlens), fused=False,
            use_kernel=use_kernel).numpy()
        for b, Lb in enumerate(lengths):
            np.testing.assert_allclose(got[b, :Lb], want[b, :Lb], rtol=0,
                                       atol=1e-5, err_msg=f"row {b}")
