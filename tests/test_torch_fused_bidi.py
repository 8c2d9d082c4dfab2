"""The fused bidi execution (the kernels' route; their plain versions on
the CPU) against the literal Parallel(NPLSTM, Reversed(NPLSTM)) layer tree
(``fuse_bidi=False``), in the port and against the JAX package with
``fuse_bidi`` both ways: tests/test_fused_bidi.py's three tests, with its
tolerances (outputs rtol 2e-5, atol 2e-6; gradients rtol 1e-4, atol
1e-5)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from clstm_tpu.models.prefab import make_net_init  # noqa: E402
from clstm_tpu.models.spec import apply_net as japply  # noqa: E402
from clstm_tpu.ops.lstm import bidi_lstm_apply as jbidi  # noqa: E402
from clstm_tpu.ops.lstm import lstm_init as jinit  # noqa: E402
from clstm_tpu_torch.convert import _arrays, params_from_numpy  # noqa: E402
from clstm_tpu_torch.models import prefab as tprefab  # noqa: E402
from clstm_tpu_torch.models.spec import _is_bidi_pair, apply_net  # noqa: E402
from clstm_tpu_torch.ops.lstm import (  # noqa: E402
    bidi_lstm_apply, lstm_apply)
from clstm_tpu_torch.ops.seq import flip_within_length  # noqa: E402

Y_RTOL, Y_ATOL = 2e-5, 2e-6
G_RTOL, G_ATOL = 1e-4, 1e-5


def _np(tree):
    return jax.tree.map(np.array, tree)


def test_torch_bidi_kernel_matches_composition():
    D, H, B, T = 5, 7, 3, 11
    pf = _np(jinit(jax.random.PRNGKey(0), D, H, scale=0.3))
    pr = _np(jinit(jax.random.PRNGKey(1), D, H, scale=0.3))
    x = np.array(jax.random.normal(jax.random.PRNGKey(2), (B, T, D)))
    lengths = np.array([11, 6, 1], np.int32)
    tf = {k: torch.from_numpy(v) for k, v in pf.items()}
    tr = {k: torch.from_numpy(v) for k, v in pr.items()}
    X, L = torch.from_numpy(x), torch.from_numpy(lengths)

    fused = bidi_lstm_apply(tf, tr, X, L)
    yf = lstm_apply(tf, X, L)
    yr = flip_within_length(lstm_apply(tr, flip_within_length(X, L), L), L)
    ref = torch.cat([yf, yr], dim=-1)
    np.testing.assert_allclose(fused.numpy(), ref.numpy(), rtol=Y_RTOL,
                               atol=Y_ATOL)
    want = np.asarray(jbidi(pf, pr, jnp.asarray(x), jnp.asarray(lengths)))
    for got in (fused, ref):
        np.testing.assert_allclose(got.numpy(), want, rtol=Y_RTOL,
                                   atol=Y_ATOL)


def _port(kind, args, params):
    spec = tprefab.make_net(kind, args)
    return params_from_numpy(spec, params)


def test_torch_apply_net_fused_vs_unfused():
    args = {"ninput": 6, "nhidden": 5, "noutput": 4, "initial": 0.2}
    spec, params = make_net_init("bidi", args, jax.random.PRNGKey(3))
    params = _np(params)
    x = np.array(jax.random.normal(jax.random.PRNGKey(4), (2, 9, 6)))
    lengths = np.array([9, 4], np.int32)
    X, L = torch.from_numpy(x), torch.from_numpy(lengths)
    net = _port("bidi", args, params)
    assert _is_bidi_pair(net.sub[0].spec)
    ys, grads = {}, {}
    for fuse in (True, False):
        net.zero_grad()
        y = apply_net(net, X, L, fuse_bidi=fuse)
        torch.sum(y ** 2).backward()
        ys[fuse] = y.detach().numpy()
        grads[fuse] = {n: p.grad.clone().numpy()
                       for n, p in net.named_parameters()}
    jx, jl = jnp.asarray(x), jnp.asarray(lengths)
    for fuse in (True, False):
        want = np.asarray(japply(spec, params, jx, jl, fuse_bidi=fuse))
        np.testing.assert_allclose(ys[fuse], want, rtol=Y_RTOL, atol=Y_ATOL)
        jg = _arrays(net, _np(jax.grad(lambda p: jnp.sum(
            japply(spec, p, jx, jl, fuse_bidi=fuse) ** 2))(params)))
        for n, g in grads[fuse].items():
            np.testing.assert_allclose(g, jg[n], rtol=G_RTOL, atol=G_ATOL)
    np.testing.assert_allclose(ys[True], ys[False], rtol=Y_RTOL, atol=Y_ATOL)
    for n in grads[True]:
        np.testing.assert_allclose(grads[True][n], grads[False][n],
                                   rtol=G_RTOL, atol=G_ATOL)


def test_torch_bidi2_uses_fused_blocks(monkeypatch):
    """The fused route takes both bidi blocks of bidi2 (the wrappers are
    called twice with fuse_bidi=True, never with False), and both routes
    agree with each other and with the JAX package's."""
    from clstm_tpu_torch.models import spec as tspec
    args = {"ninput": 4, "nhidden": 3, "noutput": 4}
    spec, params = make_net_init("bidi2", args, jax.random.PRNGKey(5))
    params = _np(params)
    net = _port("bidi2", args, params)
    for sub in net.sub[:2]:
        assert _is_bidi_pair(sub.spec)
    x = np.array(jax.random.normal(jax.random.PRNGKey(6), (2, 7, 4)))
    lengths = np.array([7, 3], np.int32)
    X, L = torch.from_numpy(x), torch.from_numpy(lengths)
    calls = []
    infer = tspec.bidi_lstm_infer
    monkeypatch.setattr(tspec, "bidi_lstm_infer", lambda *a, **k: (
        calls.append(1), infer(*a, **k))[1])
    ys = {}
    for fuse in (True, False):
        calls.clear()
        ys[fuse] = apply_net(net, X, L, fuse_bidi=fuse,
                             inference=True).numpy()
        assert len(calls) == (2 if fuse else 0)
        want = np.asarray(japply(spec, params, jnp.asarray(x),
                                 jnp.asarray(lengths), fuse_bidi=fuse))
        np.testing.assert_allclose(ys[fuse], want, rtol=Y_RTOL, atol=Y_ATOL)
    np.testing.assert_allclose(ys[True], ys[False], rtol=Y_RTOL, atol=Y_ATOL)
