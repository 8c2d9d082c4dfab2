"""The messages of the .clstm format, written by hand: the port reads and
writes them without the protobuf package (port of clstm_tpu/io/clstm_pb2.py,
which protoc generates from clstm_tpu/io/clstm.proto).

The proto2 schema:

  NetworkProto { kind = 1 (string), name = 2 (string), attribute = 3
                 (KeyValue), weights = 4 (Array), sub = 5 (NetworkProto),
                 codec = 6 (int32), icodec = 7 (int32) }
  Array        { name = 1 (string), dim = 2 (int32), value = 3 (float,
                 packed) }
  KeyValue     { key = 1, value = 2 (strings) }

Each class holds its fields as attributes: a repeated field is a list (a
repeated message field's list has protobuf's ``add()``), an unset optional
string is None, and ``Array.value`` is a float32 numpy array.
``SerializeToString()`` emits the fields in field-number order with ``dim``,
``codec`` and ``icodec`` unpacked and ``value`` packed, as proto2
serializes them, so the bytes equal the protobuf package's for the same
message. ``ParseFromString()`` replaces the message's fields, accepts the
packed and the unpacked encoding of every repeated number, skips unknown
fields and raises ValueError on truncated data.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

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


def _text(v) -> str:
    return bytes(v).decode("utf-8")


# ---------------------------------------------------------------------------
# Messages
# ---------------------------------------------------------------------------

class _Repeated(list):
    """A repeated message field: a list with protobuf's ``add()``."""

    def __init__(self, cls):
        super().__init__()
        self._cls = cls

    def add(self, **fields):
        msg = self._cls(**fields)
        self.append(msg)
        return msg


class KeyValue:
    """One string attribute of a layer."""

    def __init__(self, key: str = "", value: str = ""):
        self.key = key
        self.value = value

    def SerializeToString(self) -> bytes:
        return (_len_field(1, self.key.encode("utf-8"))
                + _len_field(2, self.value.encode("utf-8")))

    def ParseFromString(self, data: bytes) -> int:
        self.__init__()
        for field, _, v in _fields(data):
            if field == 1:
                self.key = _text(v)
            elif field == 2:
                self.value = _text(v)
        return len(data)


class Array:
    """One named weight array: its dims and its values, row-major."""

    def __init__(self, name=None, dim=(), value=()):
        self.name = name
        self.dim = [int(d) for d in dim]
        self.value = np.asarray(value, np.float32).reshape(-1)

    def SerializeToString(self) -> bytes:
        out = (b"" if self.name is None
               else _len_field(1, self.name.encode("utf-8")))
        out += _int_fields(2, self.dim)
        value = np.asarray(self.value, "<f4").reshape(-1)
        if value.size:
            out += _len_field(3, value.tobytes())
        return out

    def ParseFromString(self, data: bytes) -> int:
        self.__init__()
        values = []
        for field, wire, v in _fields(data):
            if field == 1:
                self.name = _text(v)
            elif field == 2:
                self.dim += _ints(wire, v)
            elif field == 3:
                values.append(_floats(wire, v))
        if values:
            self.value = np.concatenate(values).astype(np.float32)
        return len(data)


class NetworkProto:
    """One layer of a net: its kind, attributes, weights and sub-layers;
    the root also carries the codecs."""

    def __init__(self, kind: str = "", name=None):
        self.kind = kind
        self.name = name
        self.attribute = _Repeated(KeyValue)
        self.weights = _Repeated(Array)
        self.sub = _Repeated(NetworkProto)
        self.codec = []
        self.icodec = []

    def SerializeToString(self) -> bytes:
        out = _len_field(1, self.kind.encode("utf-8"))
        if self.name is not None:
            out += _len_field(2, self.name.encode("utf-8"))
        for field, msgs in ((3, self.attribute), (4, self.weights),
                            (5, self.sub)):
            for m in msgs:
                out += _len_field(field, m.SerializeToString())
        return out + _int_fields(6, self.codec) + _int_fields(7, self.icodec)

    def ParseFromString(self, data: bytes) -> int:
        self.__init__()
        kind = None
        for field, wire, v in _fields(data):
            if field == 1:
                kind = _text(v)
            elif field == 2:
                self.name = _text(v)
            elif field in (3, 4, 5):
                msgs = {3: self.attribute, 4: self.weights, 5: self.sub}[field]
                msgs.add().ParseFromString(v)
            elif field == 6:
                self.codec += _ints(wire, v)
            elif field == 7:
                self.icodec += _ints(wire, v)
        if kind is None:
            raise ValueError("NetworkProto without a kind")
        self.kind = kind
        return len(data)
