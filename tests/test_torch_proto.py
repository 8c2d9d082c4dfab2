"""The port's hand-written .clstm reader/writer against the JAX package's
protobuf-based one, on CPU."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from clstm_tpu.io import clstm_pb2  # noqa: E402
from clstm_tpu.io import proto as jproto  # noqa: E402
from clstm_tpu.models.codec import Codec as JCodec  # noqa: E402
from clstm_tpu.models.spec import apply_net as japply  # noqa: E402
from clstm_tpu_torch.convert import params_to_numpy  # noqa: E402
from clstm_tpu_torch.io import clstm_pb2 as tpb2  # noqa: E402
from clstm_tpu_torch.io import proto as tproto  # noqa: E402
from clstm_tpu_torch.models.codec import Codec  # noqa: E402
from clstm_tpu_torch.models.prefab import make_net_init  # noqa: E402
from clstm_tpu_torch.models.spec import apply_net  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
NAMES = ["bidi_tiny.clstm", "lstm1_tiny.clstm"]


def spec_tuple(s):
    return (s.kind, s.attr, tuple(spec_tuple(c) for c in s.sub))


def read(path):
    with open(path, "rb") as f:
        return f.read()


def assert_same_net(jloaded, tloaded):
    jspec, jparams, jcodec, jicodec = jloaded
    tspec, tnet, tcodec, ticodec = tloaded
    assert spec_tuple(tspec) == spec_tuple(jspec)
    a = jax.tree.leaves(jax.tree.map(np.asarray, jparams))
    b = jax.tree.leaves(params_to_numpy(tnet))
    assert len(a) == len(b)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
    for jc, tc in ((jcodec, tcodec), (jicodec, ticodec)):
        assert (jc is None) == (tc is None)
        if jc is not None:
            assert jc.codec == tc.codec


@pytest.mark.parametrize("name", NAMES)
def test_torch_golden_load_save_byte_identical(name, tmp_path):
    src = os.path.join(GOLDEN, name)
    spec, net, codec, icodec = tproto.load_net(src)
    out = str(tmp_path / name)
    tproto.save_net(out, net, codec, icodec)
    assert read(out) == read(src)
    assert_same_net(jproto.load_net(src), (spec, net, codec, icodec))


def test_torch_saved_model_loads_in_jax_and_back(tmp_path):
    spec, net = make_net_init("bidi", {"ninput": 6, "nhidden": 5,
                                       "noutput": 4, "initial": 0.3},
                              torch.Generator().manual_seed(3))
    ours = str(tmp_path / "ours.clstm")
    tproto.save_net(ours, net, Codec([0, 97, 98, 99]), Codec([0, 120]))
    jloaded = jproto.load_net(ours)
    assert_same_net(jloaded, tproto.load_net(ours))
    theirs = str(tmp_path / "theirs.clstm")
    jproto.save_net(theirs, jloaded[0], jloaded[1], codec=jloaded[2],
                    icodec=jloaded[3])
    assert read(theirs) == read(ours)


def test_torch_jax_saved_model_loads_in_port(tmp_path):
    from clstm_tpu.models.prefab import make_net_init as jmake_net_init

    spec, params = jmake_net_init("bidi2", {"ninput": 4, "nhidden": 3,
                                            "noutput": 5},
                                  jax.random.PRNGKey(7))
    theirs = str(tmp_path / "theirs.clstm")
    jproto.save_net(theirs, spec, params, codec=JCodec.build(["abcd"]))
    tloaded = tproto.load_net(theirs)
    assert_same_net(jproto.load_net(theirs), tloaded)
    ours = str(tmp_path / "ours.clstm")
    tproto.save_net(ours, tloaded[1], tloaded[2], tloaded[3])
    assert read(ours) == read(theirs)


def test_torch_golden_bidi_forward_matches_jax():
    src = os.path.join(GOLDEN, "bidi_tiny.clstm")
    jspec, jparams, _, _ = jproto.load_net(src)
    _, net, codec, _ = tproto.load_net(src)
    assert codec.size() == 4
    x = np.linspace(0, 1, 2 * 16 * 6, dtype=np.float32).reshape(2, 16, 6)
    lengths = np.array([16, 12], np.int32)
    want = np.asarray(japply(jspec, jparams, jnp.asarray(x),
                             jnp.asarray(lengths), inference=True))
    got = apply_net(net, torch.from_numpy(x), torch.from_numpy(lengths),
                    inference=True).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_torch_reader_accepts_packed_and_unpacked_numbers():
    """dim/codec written packed and value written unpacked parse the same
    as the canonical encoding, in both packages."""
    L, V = tpb2._len_field, tpb2._varint
    w = np.arange(6, dtype=np.float32).reshape(2, 3) - 2.5
    floats = b"".join(tpb2._tag(3, 5) + np.float32(v).tobytes()
                      for v in w.reshape(-1))
    array = (L(1, b"W1") + L(2, V(2) + V(3)) + floats)
    attrs = b"".join(L(3, L(1, k.encode()) + L(2, v.encode()))
                     for k, v in (("ninput", "2"), ("noutput", "2")))
    data = (L(1, b"SoftmaxLayer") + attrs + L(4, array)
            + L(6, V(0) + V(65) + V(66)))
    tnode = tpb2.NetworkProto()
    tnode.ParseFromString(data)
    codec, icodec = tnode.codec, tnode.icodec
    tree = params_to_numpy(tproto.net_of_proto(tnode))
    assert codec == [0, 65, 66] and icodec == []
    np.testing.assert_array_equal(tree["weights"]["b"], w[:, 0])
    np.testing.assert_array_equal(tree["weights"]["W"], w[:, 1:].T)
    node = clstm_pb2.NetworkProto()
    node.ParseFromString(data)
    assert list(node.codec) == codec
    assert list(node.weights[0].dim) == [2, 3]
    np.testing.assert_array_equal(np.asarray(node.weights[0].value,
                                             np.float32), w.reshape(-1))


@pytest.mark.parametrize("names", [("W",), ("w", "b"), ("w",)])
def test_torch_affine_weight_spellings(names, tmp_path):
    rng = np.random.RandomState(0)
    ref = rng.uniform(-1, 1, (3, 5)).astype(np.float32)   # [O, 1+D]
    node = clstm_pb2.NetworkProto()
    node.kind = "SoftmaxLayer"
    for k, v in (("ninput", "4"), ("noutput", "3")):
        kv = node.attribute.add()
        kv.key, kv.value = k, v
    arrays = ({"W": ref} if names == ("W",) else
              {"w": ref[:, 1:], "b": ref[:, 0]} if len(names) == 2 else
              {"w": ref[:, 1:]})
    for name, arr in arrays.items():
        a = node.weights.add()
        a.name = name
        a.dim.extend(arr.shape)
        a.value.extend(arr.reshape(-1).tolist())
    path = str(tmp_path / "affine.clstm")
    with open(path, "wb") as f:
        f.write(node.SerializeToString())
    assert_same_net(jproto.load_net(path), tproto.load_net(path))


def test_torch_reader_rejects_truncated_data():
    data = read(os.path.join(GOLDEN, "bidi_tiny.clstm"))
    with pytest.raises(ValueError):
        tpb2.NetworkProto().ParseFromString(data[:-7])


# (kind, args, codec texts, icodec texts): the OCR nets bidi and bidi2
# (BASELINE config 4's second layer) and the filter net of config 5 (a bidi
# net on one-hot input characters, with an input codec).
PROTO_NETS = {
    "bidi": ("bidi", {"ninput": 6, "nhidden": 5, "noutput": 4},
             ["abc"], ["xy"]),
    "bidi2": ("bidi2", {"ninput": 4, "nhidden": 3, "noutput": 5,
                        "nhidden2": 4}, ["abcd"], ["pq"]),
    "filter": ("bidi", {"ninput": 7, "nhidden": 4, "noutput": 6},
               ["tsha"], ["thesa "]),
}


def _both_nets(name):
    from clstm_tpu.models.prefab import make_net_init as jmake_net_init
    from clstm_tpu_torch.convert import params_from_numpy
    from clstm_tpu_torch.models.prefab import make_net

    kind, args, ctexts, itexts = PROTO_NETS[name]
    spec, params = jmake_net_init(kind, args, jax.random.PRNGKey(5))
    net = params_from_numpy(make_net(kind, args),
                            jax.tree.map(np.asarray, params))
    return ((spec, params, JCodec.build(ctexts), JCodec.build(itexts)),
            (net, Codec.build(ctexts), Codec.build(itexts)))


@pytest.mark.parametrize("name", sorted(PROTO_NETS))
def test_torch_proto_of_net_bytes_match_jax(name):
    """The port's message tree serializes to the JAX package's protobuf
    bytes, codec and icodec included, and JAX's ParseFromString reads it
    back to the same message."""
    (spec, params, jc, ji), (net, tc, ti) = _both_nets(name)
    want = jproto.proto_of_net(spec, params, codec=jc,
                               icodec=ji).SerializeToString()
    got = tproto.proto_of_net(net, tc, ti).SerializeToString()
    assert got == want
    back = clstm_pb2.NetworkProto()
    back.ParseFromString(got)
    assert back.SerializeToString() == want
    assert list(back.codec) == tc.codec and list(back.icodec) == ti.codec


@pytest.mark.parametrize("name", sorted(PROTO_NETS))
def test_torch_net_of_proto_reads_jax_messages(name):
    """net_of_proto on the JAX package's protobuf message gives JAX's spec
    and weights exactly; the port's own parse of the same bytes too."""
    (spec, params, jc, ji), _ = _both_nets(name)
    msg = jproto.proto_of_net(spec, params, codec=jc, icodec=ji)
    jspec, jparams = jproto.net_of_proto(msg)
    want = jax.tree.leaves(jax.tree.map(np.asarray, jparams))
    mine = tpb2.NetworkProto()
    mine.ParseFromString(msg.SerializeToString())
    for node in (msg, mine):
        net = tproto.net_of_proto(node)
        assert spec_tuple(net.spec) == spec_tuple(jspec)
        got = jax.tree.leaves(params_to_numpy(net))
        assert len(got) == len(want)
        for u, v in zip(got, want):
            np.testing.assert_array_equal(u, v)
    assert mine.codec == jc.codec and mine.icodec == ji.codec
