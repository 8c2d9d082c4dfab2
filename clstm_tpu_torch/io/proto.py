""".clstm model files: the module tree <-> its message tree
(io/clstm_pb2.py, written by hand without the protobuf package) <-> bytes
(port of clstm_tpu/io/proto.py).

``proto_of_net`` walks the module tree into a NetworkProto tree {kind,
attributes, named weight Arrays with dims, codec int arrays, subs};
``net_of_proto`` builds the module tree back from any object with those
fields, the port's messages or the JAX package's protobuf ones. save_net and
load_net go through both, so a file written here is byte-identical to one
the JAX package writes for the same weights.

Layout conversion (reference contract, SURVEY.md §3.3): each reference LSTM
gate matrix is the transposed [bias | input | recurrent] slice of the fused
weights, ``WGx = concat([b_g[:,None], Wx_g.T, Wh_g.T], 1)`` [H, 1+D+H], in
gate order WGI, WGF, WGO, WCI; an affine layer is ``W1 = [b | W.T]``
[O, 1+D]. The loader also accepts the ``W`` spelling and separate ``w``/``b``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from clstm_tpu_torch.convert import params_from_numpy, params_to_numpy
from clstm_tpu_torch.io import clstm_pb2
from clstm_tpu_torch.models.codec import Codec
from clstm_tpu_torch.models.spec import Layer, NetSpec, resolve_kind

# Layer kinds whose weights are a single affine (reference Full-style).
_AFFINE_KINDS = {"LinearLayer", "SigmoidLayer", "TanhLayer", "ReluLayer",
                 "SoftmaxLayer"}
AFFINE_WEIGHT_NAME = "W1"

_GATES = ("WGI", "WGF", "WGO", "WCI")  # the fused gate order of ops/lstm.py


def _node(spec: NetSpec, tree: dict) -> clstm_pb2.NetworkProto:
    """One NetworkProto (and its subs) from (spec, numpy params tree)."""
    kind = resolve_kind(spec.kind)
    node = clstm_pb2.NetworkProto(kind=kind)
    for k, v in spec.attr:
        node.attribute.add(key=k, value=v)
    w = tree["weights"]
    if kind == "NPLSTM":
        Wx, Wh, b = w["Wx"], w["Wh"], w["b"]
        H = Wh.shape[0]
        for g, name in enumerate(_GATES):
            s = slice(g * H, (g + 1) * H)
            ref = np.concatenate([b[s][:, None], Wx[:, s].T, Wh[:, s].T], axis=1)
            node.weights.add(name=name, dim=ref.shape, value=ref)
    elif kind in _AFFINE_KINDS:
        ref = np.concatenate([w["b"][:, None], w["W"].T], axis=1)  # [O, 1+D]
        node.weights.add(name=AFFINE_WEIGHT_NAME, dim=ref.shape, value=ref)
    else:
        for name, arr in w.items():
            node.weights.add(name=name, dim=arr.shape, value=arr)
    for s, t in zip(spec.sub, tree["sub"]):
        node.sub.append(_node(s, t))
    return node


def proto_of_net(net: Layer, codec: Optional[Codec] = None,
                 icodec: Optional[Codec] = None) -> clstm_pb2.NetworkProto:
    """The module tree (and its codecs, kept at the root) -> a NetworkProto
    tree in the reference layout."""
    node = _node(net.spec, params_to_numpy(net))
    if codec is not None:
        node.codec.extend(int(c) for c in codec.codec)
    if icodec is not None:
        node.icodec.extend(int(c) for c in icodec.codec)
    return node


def _spec_tree(node) -> Tuple[NetSpec, dict]:
    """A NetworkProto tree -> (spec, numpy params tree)."""
    kind = resolve_kind(node.kind)
    attr = {kv.key: kv.value for kv in node.attribute}
    subs = [_spec_tree(s) for s in node.sub]
    spec = NetSpec.make(kind, attr, [s for s, _ in subs])
    arrays = {a.name: np.asarray(a.value, np.float32).reshape(tuple(a.dim))
              for a in node.weights}
    weights = {}
    if kind == "NPLSTM":
        gates = [arrays[name] for name in _GATES]
        H = gates[0].shape[0]
        D = gates[0].shape[1] - 1 - H
        weights = {
            "Wx": np.concatenate([g[:, 1:1 + D].T for g in gates], axis=1),
            "Wh": np.concatenate([g[:, 1 + D:].T for g in gates], axis=1),
            "b": np.concatenate([g[:, 0] for g in gates])}
    elif kind in _AFFINE_KINDS:
        ref = next((arrays[n] for n in (AFFINE_WEIGHT_NAME, "W")
                    if n in arrays), None)
        if ref is not None:
            weights = {"W": ref[:, 1:].T, "b": ref[:, 0]}
        elif "w" in arrays:
            wa = arrays["w"]
            weights = {"W": wa.T,
                       "b": arrays.get("b", np.zeros(wa.shape[0], np.float32))}
        else:
            raise ValueError(f"{kind}: no affine weight array in "
                             f"{sorted(arrays)}")
    elif arrays:
        weights = arrays
    weights = {k: np.ascontiguousarray(v, np.float32) for k, v in weights.items()}
    return spec, {"weights": weights, "sub": [t for _, t in subs]}


def net_of_proto(node, device="cpu") -> Layer:
    """A NetworkProto tree (the port's messages, or any object with their
    fields, such as the JAX package's protobuf messages) -> the module tree
    on ``device``; its spec is ``.spec``."""
    return params_from_numpy(*_spec_tree(node), device)


# ---------------------------------------------------------------------------
# Files
# ---------------------------------------------------------------------------

def save_net(fname: str, net: Layer, codec: Optional[Codec] = None,
             icodec: Optional[Codec] = None) -> None:
    """Serialize a module tree (and its codecs) to a .clstm file."""
    data = proto_of_net(net, codec, icodec).SerializeToString()
    with open(fname, "wb") as f:
        f.write(data)


def load_net(fname: str, device="cpu"):
    """Load a .clstm file -> (spec, module tree on ``device``, codec,
    icodec); codec/icodec are None when absent from the file."""
    node = clstm_pb2.NetworkProto()
    with open(fname, "rb") as f:
        node.ParseFromString(f.read())
    net = net_of_proto(node, device)
    return (net.spec, net,
            Codec(list(node.codec)) if node.codec else None,
            Codec(list(node.icodec)) if node.icodec else None)
