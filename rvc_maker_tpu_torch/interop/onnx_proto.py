"""Self-contained ONNX model (de)serialization — no `onnx` package needed.

A minimal protobuf wire-format codec plus the subset of the ONNX schema
(ModelProto and friends) that RVC models, MDX separation models, and the
exporters use.  Neither this package's machines nor the reference's
image ship the `onnx` package, so the codec is carried here.

A copy of `rvc_maker_tpu/interop/onnx_proto.py` (the port imports
nothing of the JAX package): a file that either package writes decodes
and re-encodes byte for byte in the other.

Messages are plain Python objects: scalar fields default to None (absent),
repeated fields to [].  `encode(msg)` -> bytes, `decode(cls, data)` -> msg.
"""

from __future__ import annotations

import struct

# ---------------------------------------------------------------------------
# wire primitives
# ---------------------------------------------------------------------------

_WIRE_VARINT = 0
_WIRE_64 = 1
_WIRE_LEN = 2
_WIRE_32 = 5


def _write_varint(out: bytearray, value: int) -> None:
    if value < 0:
        value &= (1 << 64) - 1  # two's-complement, 10 bytes
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift >= 70:
            raise ValueError("malformed varint")


def _signed(value: int) -> int:
    return value - (1 << 64) if value >= (1 << 63) else value


# ---------------------------------------------------------------------------
# declarative schema
# ---------------------------------------------------------------------------

class Field:
    __slots__ = ("name", "kind", "repeated", "msg")

    def __init__(self, name, kind, repeated=False, msg=None):
        self.name = name
        self.kind = kind  # int64|int32|uint64|float|double|string|bytes|msg
        self.repeated = repeated
        self.msg = msg  # message class for kind == "msg"


class Message:
    """Base: subclasses define FIELDS = {field_number: Field(...)}."""

    FIELDS: dict[int, Field] = {}

    def __init__(self, **kw):
        for f in self.FIELDS.values():
            setattr(self, f.name, [] if f.repeated else None)
        for k, v in kw.items():
            if not any(f.name == k for f in self.FIELDS.values()):
                raise TypeError(f"{type(self).__name__} has no field {k!r}")
            setattr(self, k, v)

    def __repr__(self):
        parts = []
        for f in self.FIELDS.values():
            v = getattr(self, f.name)
            if v not in (None, []):
                parts.append(f"{f.name}={v!r}")
        return f"{type(self).__name__}({', '.join(parts)})"


_VARINT_KINDS = ("int64", "int32", "uint64", "bool", "enum")


def _encode_scalar(out: bytearray, num: int, kind: str, value) -> None:
    if kind in _VARINT_KINDS:
        _write_varint(out, num << 3 | _WIRE_VARINT)
        _write_varint(out, int(value))
    elif kind == "float":
        _write_varint(out, num << 3 | _WIRE_32)
        out += struct.pack("<f", value)
    elif kind == "double":
        _write_varint(out, num << 3 | _WIRE_64)
        out += struct.pack("<d", value)
    elif kind in ("string", "bytes"):
        raw = value.encode("utf-8") if isinstance(value, str) else bytes(value)
        _write_varint(out, num << 3 | _WIRE_LEN)
        _write_varint(out, len(raw))
        out += raw
    else:  # pragma: no cover
        raise ValueError(f"unknown kind {kind}")


def encode(msg: Message) -> bytes:
    out = bytearray()
    for num, f in msg.FIELDS.items():
        value = getattr(msg, f.name)
        if value is None or (f.repeated and not value):
            continue
        if f.kind == "msg":
            items = value if f.repeated else [value]
            for item in items:
                sub = encode(item)
                _write_varint(out, num << 3 | _WIRE_LEN)
                _write_varint(out, len(sub))
                out += sub
        elif f.repeated and f.kind in _VARINT_KINDS:
            # proto3 packed encoding for repeated scalars
            packed = bytearray()
            for v in value:
                _write_varint(packed, int(v))
            _write_varint(out, num << 3 | _WIRE_LEN)
            _write_varint(out, len(packed))
            out += packed
        elif f.repeated and f.kind in ("float", "double"):
            fmt = "<f" if f.kind == "float" else "<d"
            packed = b"".join(struct.pack(fmt, v) for v in value)
            _write_varint(out, num << 3 | _WIRE_LEN)
            _write_varint(out, len(packed))
            out += packed
        elif f.repeated:
            for v in value:
                _encode_scalar(out, num, f.kind, v)
        else:
            _encode_scalar(out, num, f.kind, value)
    return bytes(out)


def _decode_value(f: Field, wire: int, data: bytes, pos: int):
    """Returns (value_or_list, new_pos). Packed scalars return a list."""
    if wire == _WIRE_VARINT:
        raw, pos = _read_varint(data, pos)
        if f and f.kind in ("int64", "int32"):
            raw = _signed(raw)
        return raw, pos
    if wire == _WIRE_64:
        val = struct.unpack_from("<d", data, pos)[0] if f and f.kind == "double" \
            else struct.unpack_from("<q", data, pos)[0]
        return val, pos + 8
    if wire == _WIRE_32:
        val = struct.unpack_from("<f", data, pos)[0] if f and f.kind == "float" \
            else struct.unpack_from("<i", data, pos)[0]
        return val, pos + 4
    if wire == _WIRE_LEN:
        size, pos = _read_varint(data, pos)
        chunk = data[pos:pos + size]
        pos += size
        if f is None:
            return chunk, pos
        if f.kind == "msg":
            return decode(f.msg, chunk), pos
        if f.kind == "string":
            return chunk.decode("utf-8", errors="surrogateescape"), pos
        if f.kind == "bytes":
            return chunk, pos
        # packed repeated scalars
        vals, p = [], 0
        if f.kind in _VARINT_KINDS:
            while p < len(chunk):
                raw, p = _read_varint(chunk, p)
                if f.kind in ("int64", "int32"):
                    raw = _signed(raw)
                vals.append(raw)
        else:
            fmt, width = ("<f", 4) if f.kind == "float" else ("<d", 8)
            while p < len(chunk):
                vals.append(struct.unpack_from(fmt, chunk, p)[0])
                p += width
        return vals, pos
    raise ValueError(f"unsupported wire type {wire}")


def decode(cls, data: bytes) -> Message:
    msg = cls()
    pos = 0
    while pos < len(data):
        key, pos = _read_varint(data, pos)
        num, wire = key >> 3, key & 7
        f = cls.FIELDS.get(num)
        value, pos = _decode_value(f, wire, data, pos)
        if f is None:
            continue  # unknown field: skipped (value already consumed)
        if f.repeated:
            tgt = getattr(msg, f.name)
            if isinstance(value, list):
                tgt.extend(value)
            else:
                tgt.append(value)
        else:
            setattr(msg, f.name, value)
    return msg


# ---------------------------------------------------------------------------
# ONNX schema subset (field numbers match onnx/onnx.proto)
# ---------------------------------------------------------------------------

class StringStringEntryProto(Message):
    FIELDS = {1: Field("key", "string"), 2: Field("value", "string")}


class OperatorSetIdProto(Message):
    FIELDS = {1: Field("domain", "string"), 2: Field("version", "int64")}


class TensorProto(Message):
    FIELDS = {
        1: Field("dims", "int64", repeated=True),
        2: Field("data_type", "int32"),
        4: Field("float_data", "float", repeated=True),
        5: Field("int32_data", "int32", repeated=True),
        6: Field("string_data", "bytes", repeated=True),
        7: Field("int64_data", "int64", repeated=True),
        8: Field("name", "string"),
        9: Field("raw_data", "bytes"),
        10: Field("double_data", "double", repeated=True),
        11: Field("uint64_data", "uint64", repeated=True),
        12: Field("doc_string", "string"),
    }


# TensorProto.DataType values
FLOAT, UINT8, INT8, UINT16, INT16, INT32, INT64 = 1, 2, 3, 4, 5, 6, 7
STRING, BOOL, FLOAT16, DOUBLE, UINT32, UINT64 = 8, 9, 10, 11, 12, 13
BFLOAT16 = 16


class TensorShapeDim(Message):
    FIELDS = {1: Field("dim_value", "int64"), 2: Field("dim_param", "string")}


class TensorShapeProto(Message):
    FIELDS = {1: Field("dim", "msg", repeated=True, msg=TensorShapeDim)}


class TypeProtoTensor(Message):
    FIELDS = {1: Field("elem_type", "int32"),
              2: Field("shape", "msg", msg=TensorShapeProto)}


class TypeProto(Message):
    FIELDS = {1: Field("tensor_type", "msg", msg=TypeProtoTensor)}


class ValueInfoProto(Message):
    FIELDS = {1: Field("name", "string"),
              2: Field("type", "msg", msg=TypeProto),
              3: Field("doc_string", "string")}


class AttributeProto(Message):
    FIELDS = {
        1: Field("name", "string"),
        2: Field("f", "float"),
        3: Field("i", "int64"),
        4: Field("s", "bytes"),
        5: Field("t", "msg", msg=TensorProto),
        7: Field("floats", "float", repeated=True),
        8: Field("ints", "int64", repeated=True),
        9: Field("strings", "bytes", repeated=True),
        10: Field("tensors", "msg", repeated=True, msg=TensorProto),
        13: Field("doc_string", "string"),
        20: Field("type", "int32"),
    }


# AttributeProto.AttributeType values
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR = 1, 2, 3, 4
ATTR_GRAPH, ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 5, 6, 7, 8


class NodeProto(Message):
    FIELDS = {
        1: Field("input", "string", repeated=True),
        2: Field("output", "string", repeated=True),
        3: Field("name", "string"),
        4: Field("op_type", "string"),
        5: Field("attribute", "msg", repeated=True, msg=AttributeProto),
        6: Field("doc_string", "string"),
        7: Field("domain", "string"),
    }


class GraphProto(Message):
    FIELDS = {
        1: Field("node", "msg", repeated=True, msg=NodeProto),
        2: Field("name", "string"),
        5: Field("initializer", "msg", repeated=True, msg=TensorProto),
        10: Field("doc_string", "string"),
        11: Field("input", "msg", repeated=True, msg=ValueInfoProto),
        12: Field("output", "msg", repeated=True, msg=ValueInfoProto),
        13: Field("value_info", "msg", repeated=True, msg=ValueInfoProto),
    }


# Subgraph attributes (If/Loop/Scan) need GraphProto inside AttributeProto;
# register after GraphProto exists.
AttributeProto.FIELDS[6] = Field("g", "msg", msg=GraphProto)
AttributeProto.FIELDS[11] = Field("graphs", "msg", repeated=True,
                                  msg=GraphProto)


class ModelProto(Message):
    FIELDS = {
        1: Field("ir_version", "int64"),
        2: Field("producer_name", "string"),
        3: Field("producer_version", "string"),
        4: Field("domain", "string"),
        5: Field("model_version", "int64"),
        6: Field("doc_string", "string"),
        7: Field("graph", "msg", msg=GraphProto),
        8: Field("opset_import", "msg", repeated=True,
                 msg=OperatorSetIdProto),
        14: Field("metadata_props", "msg", repeated=True,
                  msg=StringStringEntryProto),
    }


# ---------------------------------------------------------------------------
# numpy bridges
# ---------------------------------------------------------------------------

_NP_TO_ONNX = {
    "float32": FLOAT, "float64": DOUBLE, "float16": FLOAT16,
    "int64": INT64, "int32": INT32, "int16": INT16, "int8": INT8,
    "uint8": UINT8, "uint16": UINT16, "uint32": UINT32, "uint64": UINT64,
    "bool": BOOL, "bfloat16": BFLOAT16,
}

_ONNX_TO_NP = {
    FLOAT: "float32", DOUBLE: "float64", FLOAT16: "float16",
    INT64: "int64", INT32: "int32", INT16: "int16", INT8: "int8",
    UINT8: "uint8", UINT16: "uint16", UINT32: "uint32", UINT64: "uint64",
    BOOL: "bool",
}


def tensor_from_array(arr, name: str = "") -> TensorProto:
    import numpy as np

    # NOT ascontiguousarray: it promotes 0-d arrays to 1-d, which breaks
    # scalar initializers (Gather indices etc.)
    arr = np.asarray(arr, order="C")
    dt = _NP_TO_ONNX.get(arr.dtype.name)
    if dt is None:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    t = TensorProto(name=name or None, data_type=dt,
                    dims=list(arr.shape), raw_data=arr.tobytes())
    if not t.dims:
        t.dims = []
    return t


def array_from_tensor(t: TensorProto):
    import numpy as np

    dims = tuple(t.dims)
    if t.data_type == BFLOAT16:
        # stored as raw uint16 payloads; widen through float32
        if t.raw_data is not None:
            u16 = np.frombuffer(t.raw_data, dtype=np.uint16)
        else:
            u16 = np.asarray(t.int32_data, dtype=np.uint16)
        u32 = u16.astype(np.uint32) << 16
        return u32.view(np.float32).reshape(dims)
    np_dtype = np.dtype(_ONNX_TO_NP[t.data_type])
    if t.raw_data is not None and len(t.raw_data) > 0:
        return np.frombuffer(t.raw_data, dtype=np_dtype).reshape(dims).copy()
    if t.data_type == FLOAT and t.float_data:
        return np.asarray(t.float_data, np.float32).reshape(dims)
    if t.data_type == DOUBLE and t.double_data:
        return np.asarray(t.double_data, np.float64).reshape(dims)
    if t.data_type == INT64 and t.int64_data:
        return np.asarray(t.int64_data, np.int64).reshape(dims)
    if t.data_type in (INT32, INT16, INT8, UINT16, UINT8, BOOL,
                       FLOAT16) and t.int32_data:
        if t.data_type == FLOAT16:
            return (np.asarray(t.int32_data, np.uint16).view(np.float16)
                    .reshape(dims))
        return np.asarray(t.int32_data, np.int32).astype(np_dtype).reshape(dims)
    if t.data_type in (UINT32, UINT64) and t.uint64_data:
        return np.asarray(t.uint64_data, np.uint64).astype(np_dtype).reshape(dims)
    return np.zeros(dims, np_dtype)


def load_model(path_or_bytes) -> ModelProto:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return decode(ModelProto, bytes(path_or_bytes))
    with open(path_or_bytes, "rb") as fh:
        return decode(ModelProto, fh.read())


def save_model(model: ModelProto, path: str) -> None:
    with open(path, "wb") as fh:
        fh.write(encode(model))
