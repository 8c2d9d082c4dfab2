"""The port's LSTM ops and sequence helpers against the JAX package, on CPU.

The bidirectional forward is held against the TPU kernel it replaces
(``bidi_lstm_pallas`` in interpret mode, strict f32, ``with_state=False``)
and against the JAX scan; inputs come from numpy so both packages see the
same numbers.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from clstm_tpu.ops import lstm as jlstm  # noqa: E402
from clstm_tpu.ops import nonlin as jnonlin  # noqa: E402
from clstm_tpu.ops import seq as jseq  # noqa: E402
from clstm_tpu.ops.pallas_lstm import bidi_lstm_pallas  # noqa: E402
from clstm_tpu_torch.ops import lstm as tlstm  # noqa: E402
from clstm_tpu_torch.ops import nonlin as tnonlin  # noqa: E402
from clstm_tpu_torch.ops import seq as tseq  # noqa: E402
from clstm_tpu_torch.ops.bidi_lstm_kernel import bidi_lstm_infer  # noqa: E402

# Tolerance of tests/test_pallas_lstm.py for the strict-f32 kernel.
RTOL, ATOL = 2e-5, 2e-6


def _params(rng, D, H, scale=0.3):
    return {"Wx": rng.uniform(-scale, scale, (D, 4 * H)).astype(np.float32),
            "Wh": rng.uniform(-scale, scale, (H, 4 * H)).astype(np.float32),
            "b": rng.uniform(-scale, scale, (4 * H,)).astype(np.float32)}


def _setup(B=4, T=16, D=5, H=7, seed=0):
    rng = np.random.RandomState(seed)
    pf, pr = _params(rng, D, H), _params(rng, D, H)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    lengths = np.array([T, T - 3, T // 2, 1], np.int32)[:B]
    return pf, pr, x, lengths


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def test_torch_bidi_matches_pallas_kernel_and_scan():
    pf, pr, x, lengths = _setup()
    got = tlstm.bidi_lstm_apply(_t(pf), _t(pr), torch.from_numpy(x),
                                torch.from_numpy(lengths)).numpy()
    want_kernel = np.asarray(bidi_lstm_pallas(
        _j(pf), _j(pr), jnp.asarray(x), jnp.asarray(lengths),
        8, True, False, True, False))
    want_scan = np.asarray(jlstm.bidi_lstm_apply(
        _j(pf), _j(pr), jnp.asarray(x), jnp.asarray(lengths)))
    np.testing.assert_allclose(got, want_kernel, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, want_scan, rtol=RTOL, atol=ATOL)
    # The wrapper runs the plain version on CPU tensors.
    wrapped = bidi_lstm_infer(_t(pf), _t(pr), torch.from_numpy(x),
                              torch.from_numpy(lengths)).numpy()
    np.testing.assert_array_equal(wrapped, got)


def test_torch_bidi_padding_zero_and_invariant():
    pf, pr, x, _ = _setup()
    lengths = np.array([16, 5, 0, 1], np.int32)
    y = tlstm.bidi_lstm_apply(_t(pf), _t(pr), torch.from_numpy(x),
                              torch.from_numpy(lengths)).numpy()
    want = np.asarray(jlstm.bidi_lstm_apply(
        _j(pf), _j(pr), jnp.asarray(x), jnp.asarray(lengths)))
    np.testing.assert_allclose(y, want, rtol=RTOL, atol=ATOL)
    for b, L in enumerate(lengths):
        assert (y[b, L:] == 0.0).all()
    assert (y[2] == 0.0).all()                    # the row with length 0
    # Padding contents do not reach valid frames.
    x2 = x.copy()
    for b, L in enumerate(lengths):
        x2[b, L:] = 7.0
    y2 = tlstm.bidi_lstm_apply(_t(pf), _t(pr), torch.from_numpy(x2),
                               torch.from_numpy(lengths)).numpy()
    np.testing.assert_array_equal(y2, y)


def test_torch_bidi_without_lengths():
    pf, pr, x, _ = _setup()
    got = bidi_lstm_infer(_t(pf), _t(pr), torch.from_numpy(x), None).numpy()
    want = np.asarray(jlstm.bidi_lstm_apply(_j(pf), _j(pr), jnp.asarray(x),
                                            None))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_torch_lstm_apply_matches_jax():
    pf, _, x, lengths = _setup(seed=3)
    for L in (lengths, None):
        got = tlstm.lstm_apply(
            _t(pf), torch.from_numpy(x),
            None if L is None else torch.from_numpy(L)).numpy()
        want = np.asarray(jlstm.lstm_apply(
            _j(pf), jnp.asarray(x), None if L is None else jnp.asarray(L)))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_torch_seq_helpers_match_jax():
    rng = np.random.RandomState(1)
    x = rng.normal(size=(3, 6, 2)).astype(np.float32)
    lengths = np.array([6, 2, 0], np.int32)
    tx, tl = torch.from_numpy(x), torch.from_numpy(lengths)
    jx, jl = jnp.asarray(x), jnp.asarray(lengths)
    for L_t, L_j in ((tl, jl), (None, None)):
        np.testing.assert_array_equal(
            tseq.flip_within_length(tx, L_t).numpy(),
            np.asarray(jseq.flip_within_length(jx, L_j)))
        np.testing.assert_array_equal(tseq.masked_zero(tx, L_t).numpy(),
                                      np.asarray(jseq.masked_zero(jx, L_j)))
    np.testing.assert_array_equal(tseq.length_mask(tl, 6).numpy(),
                                  np.asarray(jseq.length_mask(jl, 6)))


@pytest.mark.parametrize("kind", ["LIN", "SIG", "TANH", "RELU"])
def test_torch_nonlin_matches_jax(kind):
    x = np.linspace(-4, 4, 33, dtype=np.float32)
    np.testing.assert_allclose(
        tnonlin.nonlin_apply(kind, torch.from_numpy(x)).numpy(),
        np.asarray(jnonlin.nonlin_apply(kind, jnp.asarray(x))),
        rtol=1e-6, atol=1e-7)


def test_torch_nonlin_unknown_raises():
    with pytest.raises(ValueError):
        tnonlin.nonlin_apply("SOFTPLUS", torch.zeros(2))


def _bad_inputs():
    pf, pr, x, lengths = _setup()
    X, L = torch.from_numpy(x), torch.from_numpy(lengths)
    return {
        "x_float64": (pf, pr, X.double(), L),
        "x_noncontiguous": (pf, pr, X.transpose(0, 1).contiguous()
                            .transpose(0, 1), L),
        "x_2d": (pf, pr, X[0], L),
        "lengths_int64": (pf, pr, X, L.long()),
        "lengths_wrong_size": (pf, pr, X, L[:2]),
        "wx_wrong_shape": ({**pf, "Wx": pf["Wx"][:-1]}, pr, X, L),
        "wh_float64": (pf, {**pr, "Wh": pr["Wh"].astype(np.float64)}, X, L),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_torch_bidi_wrapper_rejects(case):
    pf, pr, x, lengths = _bad_inputs()[case]
    before = bidi_lstm_infer.launches
    with pytest.raises(ValueError):
        bidi_lstm_infer(_t(pf), _t(pr), x, lengths)
    assert bidi_lstm_infer.launches == before


def test_torch_bidi_wrapper_cpu_counts_no_launch():
    pf, pr, x, lengths = _setup()
    before = bidi_lstm_infer.launches
    bidi_lstm_infer(_t(pf), _t(pr), torch.from_numpy(x),
                    torch.from_numpy(lengths))
    assert bidi_lstm_infer.launches == before
