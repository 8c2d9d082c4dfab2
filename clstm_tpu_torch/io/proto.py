""".clstm model files, read and written without a protobuf package (port of
clstm_tpu/io/proto.py + io/clstm_pb2.py).

The wire format is the proto2 schema ``clstm_tpu/io/clstm.proto``:

  NetworkProto { kind = 1 (string), name = 2 (string), attribute = 3
                 (KeyValue), weights = 4 (Array), sub = 5 (NetworkProto),
                 codec = 6 (int32), icodec = 7 (int32) }
  Array        { name = 1 (string), dim = 2 (int32), value = 3 (float,
                 packed) }
  KeyValue     { key = 1, value = 2 (strings) }

The writer emits fields in field-number order with ``dim``, ``codec`` and
``icodec`` unpacked, as proto2 serializes them, so a file written here is
byte-identical to one written through the protobuf package. The reader
accepts the packed and the unpacked encoding of every repeated number and
skips unknown fields.

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
from clstm_tpu_torch.models.codec import Codec
from clstm_tpu_torch.models.spec import Layer, NetSpec, resolve_kind

# Layer kinds whose weights are a single affine (reference Full-style).
_AFFINE_KINDS = {"LinearLayer", "SigmoidLayer", "TanhLayer", "ReluLayer",
                 "SoftmaxLayer"}
AFFINE_WEIGHT_NAME = "W1"

_GATES = ("WGI", "WGF", "WGO", "WCI")  # the fused gate order of ops/lstm.py

_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


# ---------------------------------------------------------------------------
# Wire encoding
# ---------------------------------------------------------------------------

def _varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64   # int32 negatives are sign-extended to 10 bytes
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint(field << 3 | wire)


def _len_field(field: int, payload: bytes) -> bytes:
    return _tag(field, _LEN) + _varint(len(payload)) + payload


def _int_fields(field: int, values) -> bytes:
    return b"".join(_tag(field, _VARINT) + _varint(int(v)) for v in values)


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    v = shift = 0
    while True:
        if i >= len(buf):
            raise ValueError("truncated varint in .clstm data")
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, i
        shift += 7


def _int32(v: int) -> int:
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def _fields(buf: bytes):
    """Yield (field number, wire type, value) over one message: an int for
    varints, bytes for every other wire type."""
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == _VARINT:
            v, i = _read_varint(buf, i)
        elif wire == _LEN:
            n, i = _read_varint(buf, i)
            v = buf[i:i + n]
            i += n
        elif wire in (_I64, _I32):
            n = 8 if wire == _I64 else 4
            v = buf[i:i + n]
            i += n
        else:
            raise ValueError(f"unsupported wire type {wire} in .clstm data")
        if i > len(buf):
            raise ValueError("truncated field in .clstm data")
        yield field, wire, v


def _ints(wire: int, v) -> list:
    """One repeated-int32 field occurrence, packed or not."""
    if wire == _VARINT:
        return [_int32(v)]
    out, i = [], 0
    while i < len(v):
        x, i = _read_varint(v, i)
        out.append(_int32(x))
    return out


def _floats(wire: int, v) -> np.ndarray:
    """One repeated-float field occurrence, packed or not."""
    if wire not in (_LEN, _I32):
        raise ValueError(f"float field with wire type {wire}")
    return np.frombuffer(bytes(v), dtype="<f4")


# ---------------------------------------------------------------------------
# Messages <-> (spec, numpy params tree)
# ---------------------------------------------------------------------------

def _array_bytes(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr, np.float32)
    out = _len_field(1, name.encode("utf-8")) + _int_fields(2, arr.shape)
    if arr.size:
        out += _len_field(3, arr.astype("<f4").reshape(-1).tobytes())
    return out


def _parse_array(buf: bytes) -> Tuple[str, np.ndarray]:
    name, dims, values = "", [], []
    for field, wire, v in _fields(buf):
        if field == 1:
            name = bytes(v).decode("utf-8")
        elif field == 2:
            dims += _ints(wire, v)
        elif field == 3:
            values.append(_floats(wire, v))
    flat = (np.concatenate(values) if values
            else np.zeros(0, np.float32)).astype(np.float32)
    return name, flat.reshape(tuple(dims))


def _net_bytes(spec: NetSpec, tree: dict, codec: Optional[Codec] = None,
               icodec: Optional[Codec] = None) -> bytes:
    """Serialize one NetworkProto from (spec, numpy params tree)."""
    kind = resolve_kind(spec.kind)
    out = _len_field(1, kind.encode("utf-8"))
    for k, v in spec.attr:
        out += _len_field(3, _len_field(1, k.encode("utf-8"))
                          + _len_field(2, v.encode("utf-8")))
    w = tree["weights"]
    if kind == "NPLSTM":
        Wx, Wh, b = w["Wx"], w["Wh"], w["b"]
        H = Wh.shape[0]
        for g, name in enumerate(_GATES):
            s = slice(g * H, (g + 1) * H)
            ref = np.concatenate([b[s][:, None], Wx[:, s].T, Wh[:, s].T], axis=1)
            out += _len_field(4, _array_bytes(name, ref))
    elif kind in _AFFINE_KINDS:
        ref = np.concatenate([w["b"][:, None], w["W"].T], axis=1)  # [O, 1+D]
        out += _len_field(4, _array_bytes(AFFINE_WEIGHT_NAME, ref))
    else:
        for name, arr in w.items():
            out += _len_field(4, _array_bytes(name, arr))
    for s, t in zip(spec.sub, tree["sub"]):
        out += _len_field(5, _net_bytes(s, t))
    if codec is not None:
        out += _int_fields(6, codec.codec)
    if icodec is not None:
        out += _int_fields(7, icodec.codec)
    return out


def _parse_net(buf: bytes):
    """Parse one NetworkProto -> (spec, numpy params tree, codec ids,
    icodec ids)."""
    kind, attr, arrays, subs, codec, icodec = None, {}, {}, [], [], []
    for field, wire, v in _fields(buf):
        if field == 1:
            kind = bytes(v).decode("utf-8")
        elif field == 3:
            kv = {f: bytes(x).decode("utf-8") for f, _, x in _fields(v)}
            attr[kv.get(1, "")] = kv.get(2, "")
        elif field == 4:
            name, arr = _parse_array(v)
            arrays[name] = arr
        elif field == 5:
            subs.append(_parse_net(v)[:2])
        elif field == 6:
            codec += _ints(wire, v)
        elif field == 7:
            icodec += _ints(wire, v)
    if kind is None:
        raise ValueError("NetworkProto without a kind")
    kind = resolve_kind(kind)
    spec = NetSpec.make(kind, attr, [s for s, _ in subs])
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
    return spec, {"weights": weights, "sub": [t for _, t in subs]}, codec, icodec


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def save_net(fname: str, net: Layer, codec: Optional[Codec] = None,
             icodec: Optional[Codec] = None) -> None:
    """Serialize a module tree (and its codecs) to a .clstm file."""
    data = _net_bytes(net.spec, params_to_numpy(net), codec, icodec)
    with open(fname, "wb") as f:
        f.write(data)


def load_net(fname: str, device="cpu"):
    """Load a .clstm file -> (spec, module tree on ``device``, codec,
    icodec); codec/icodec are None when absent from the file."""
    with open(fname, "rb") as f:
        spec, tree, codec, icodec = _parse_net(f.read())
    return (spec, params_from_numpy(spec, tree, device),
            Codec(codec) if codec else None,
            Codec(icodec) if icodec else None)
