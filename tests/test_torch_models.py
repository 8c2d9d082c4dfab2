"""The port's layer tree, prefabs and weight conversion against the JAX
package, on CPU. Weights are drawn with numpy and carried into the port
through ``convert.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from clstm_tpu.models import prefab as jprefab  # noqa: E402
from clstm_tpu.models import spec as jspec  # noqa: E402
from clstm_tpu_torch.convert import params_from_numpy, params_to_numpy  # noqa: E402
from clstm_tpu_torch.models import prefab as tprefab  # noqa: E402
from clstm_tpu_torch.models import spec as tspec  # noqa: E402

KINDS = ["lstm1", "revlstm1", "bidi", "bidi2", "softmax", "linear", "sigmoid",
         "tanh", "relu"]
ARGS = {"ninput": 5, "nhidden": 6, "noutput": 4}


def spec_tuple(s):
    return (s.kind, s.attr, tuple(spec_tuple(c) for c in s.sub))


def numpy_params(kind, seed=0, scale=0.5):
    """JAX spec + params pytree with numpy weights uniform in ±scale."""
    spec, params = jprefab.make_net_init(kind, ARGS, jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)
    params = jax.tree.map(
        lambda a: rng.uniform(-scale, scale, a.shape).astype(np.float32),
        params)
    return spec, params


def batch(seed=1, B=3, T=9, D=5):
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 1, (B, T, D)).astype(np.float32)
    return x, np.array([T, 4, 1], np.int32)[:B]


@pytest.mark.parametrize("kind", KINDS)
def test_torch_prefab_spec_matches_jax(kind):
    assert spec_tuple(tprefab.make_net(kind, ARGS)) == spec_tuple(
        jprefab.make_net(kind, ARGS))


@pytest.mark.parametrize("kind", KINDS)
def test_torch_convert_round_trip_exact(kind):
    spec, params = numpy_params(kind)
    net = params_from_numpy(tprefab.make_net(kind, ARGS), params)
    back = params_to_numpy(net)
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("logits", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_torch_prefab_forward_matches_jax(kind, logits):
    spec, params = numpy_params(kind)
    net = params_from_numpy(tprefab.make_net(kind, ARGS), params)
    x, lengths = batch()
    want = np.asarray(jspec.apply_net(spec, params, jnp.asarray(x),
                                      jnp.asarray(lengths), logits=logits))
    got = tspec.apply_net(net, torch.from_numpy(x), torch.from_numpy(lengths),
                          logits=logits, inference=True)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-6)


def test_torch_softmax_returns_f32_and_sums_to_one():
    spec, params = numpy_params("bidi")
    net = params_from_numpy(tprefab.make_net("bidi", ARGS), params)
    x, lengths = batch()
    probs = tspec.apply_net(net, torch.from_numpy(x), torch.from_numpy(lengths))
    assert probs.dtype == torch.float32
    np.testing.assert_allclose(probs.detach().sum(-1).numpy(), 1.0, rtol=1e-5)
    soft = params_from_numpy(tprefab.make_net("softmax", ARGS),
                             numpy_params("softmax")[1])
    y = tspec.apply_net(soft, torch.from_numpy(x).double())
    assert y.dtype == torch.float32


def test_torch_bidi_cpu_gradient_flows():
    """On CPU tensors the bidi pair runs bidi_lstm_train with the plain
    versions of K1 and K2; grads match JAX's."""
    spec, params = numpy_params("bidi")
    net = params_from_numpy(tprefab.make_net("bidi", ARGS), params)
    x, lengths = batch()
    loss = tspec.apply_net(net, torch.from_numpy(x),
                           torch.from_numpy(lengths), logits=True).pow(2).sum()
    loss.backward()
    got = net.sub[0].sub[0].Wh.grad.numpy()
    g = jax.grad(lambda p: jnp.sum(jspec.apply_net(
        spec, p, jnp.asarray(x), jnp.asarray(lengths), logits=True) ** 2))(
            jax.tree.map(jnp.asarray, params))
    np.testing.assert_allclose(got, np.asarray(g["sub"][0]["sub"][0]["weights"]
                                               ["Wh"]), rtol=1e-4, atol=1e-5)


def test_torch_make_net_init_is_seeded():
    a = tprefab.make_net_init("bidi", {**ARGS, "initial": 0.2},
                              torch.Generator().manual_seed(5))[1]
    b = tprefab.make_net_init("bidi", {**ARGS, "initial": 0.2},
                              torch.Generator().manual_seed(5))[1]
    c = tprefab.make_net_init("bidi", {**ARGS, "initial": 0.2},
                              torch.Generator().manual_seed(6))[1]
    pa, pb, pc = (jax.tree.leaves(params_to_numpy(n)) for n in (a, b, c))
    for u, v in zip(pa, pb):
        np.testing.assert_array_equal(u, v)
    assert any((u != w).any() for u, w in zip(pa, pc))
    assert all(np.abs(u).max() <= 0.2 for u in pa)
    assert all(np.abs(u).max() > 0.0 for u in pa)


def test_torch_layer_errors():
    with pytest.raises(ValueError):
        tspec.make_layer("NoSuchLayer")
    with pytest.raises(KeyError):
        tprefab.make_net("bidi", {"ninput": 3})
    botched = tspec.build_net(tspec.make_layer("Botched"))
    with pytest.raises(NotImplementedError):
        tspec.apply_net(botched, torch.zeros(1, 2, 3))
    with pytest.raises(ValueError):
        params_from_numpy(tprefab.make_net("lstm1", ARGS),
                          numpy_params("bidi")[1])
