"""Minimal, dependency-free ONNX weight reader.

The reference tool ships its trained per-context CNNs as ONNX files
(models/{CpG,CHG,CHH}.onnx of the reference, exported by its
training/make-onnx.py with opset 11).  Users migrating from the reference
bring those artifacts, so the port imports them without the `onnx` package.
ONNX is plain protobuf; only the initializers (named weight tensors) and the
nodes are needed, which this module extracts with a small wire-format
parser.  A copy of the JAX package's reader (model/onnx_import.py there),
which the port keeps so that it imports nothing of that package.
"""
from __future__ import annotations

import struct
from typing import Iterator

import numpy as np

_WIRE_VARINT = 0
_WIRE_I64 = 1
_WIRE_LEN = 2
_WIRE_I32 = 5

# TensorProto.DataType -> numpy dtype
_ONNX_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _iter_fields(buf: memoryview) -> Iterator[tuple[int, int, object]]:
    """Yield (field_number, wire_type, value) over a protobuf message body."""
    pos = 0
    n = len(buf)
    while pos < n:
        key, pos = _read_varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == _WIRE_VARINT:
            val, pos = _read_varint(buf, pos)
        elif wire == _WIRE_LEN:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos:pos + ln]
            pos += ln
        elif wire == _WIRE_I64:
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == _WIRE_I32:
            val = buf[pos:pos + 4]
            pos += 4
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf: memoryview) -> tuple[str, np.ndarray]:
    """Parse a TensorProto: fields dims=1, data_type=2, float_data=4,
    int64_data=7, name=8, raw_data=9, int32_data=5, double_data=10."""
    dims: list[int] = []
    dtype_code = 1
    name = ""
    raw = None
    float_data: list[float] = []
    int_data: list[int] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1 and wire == _WIRE_VARINT:
            dims.append(val)
        elif field == 2:
            dtype_code = val
        elif field == 8:
            name = bytes(val).decode()
        elif field == 9:
            raw = bytes(val)
        elif field == 4:
            if wire == _WIRE_LEN:  # packed floats
                float_data.extend(struct.unpack(f"<{len(val)//4}f", bytes(val)))
            else:
                float_data.append(struct.unpack("<f", bytes(val))[0])
        elif field in (5, 7):
            if wire == _WIRE_LEN:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    int_data.append(v)
            else:
                int_data.append(val)
    dtype = _ONNX_DTYPES.get(dtype_code, np.float32)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=dtype)
    elif float_data:
        arr = np.asarray(float_data, dtype=dtype)
    else:
        arr = np.asarray(int_data, dtype=dtype)
    return name, arr.reshape(dims) if dims else arr


def _parse_attribute(buf: memoryview) -> tuple[str, object]:
    """AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8."""
    name = ""
    value: object = None
    ints: list[int] = []
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            name = bytes(val).decode()
        elif field == 2:
            value = struct.unpack("<f", bytes(val))[0]
        elif field == 3:
            value = val
        elif field == 4:
            value = bytes(val)
        elif field == 5:  # single tensor attribute (Constant nodes)
            _, value = _parse_tensor(val)
        elif field == 8:
            if wire == _WIRE_LEN:
                pos = 0
                while pos < len(val):
                    v, pos = _read_varint(val, pos)
                    ints.append(v)
            else:
                ints.append(val)
    if ints:
        value = ints
    return name, value


def _parse_node(buf: memoryview) -> dict:
    """NodeProto: input=1, output=2, name=3, op_type=4, attribute=5."""
    node = {"inputs": [], "outputs": [], "name": "", "op": "", "attrs": {}}
    for field, wire, val in _iter_fields(buf):
        if field == 1:
            node["inputs"].append(bytes(val).decode())
        elif field == 2:
            node["outputs"].append(bytes(val).decode())
        elif field == 3:
            node["name"] = bytes(val).decode()
        elif field == 4:
            node["op"] = bytes(val).decode()
        elif field == 5:
            aname, aval = _parse_attribute(val)
            node["attrs"][aname] = aval
    return node


def load_onnx_graph(path: str) -> tuple[dict[str, np.ndarray], list[dict]]:
    """Return (initializers, nodes-in-topological-order) for an ONNX model.

    ModelProto.graph = field 7; GraphProto.node = 1, initializer = 5.
    """
    with open(path, "rb") as f:
        data = memoryview(f.read())
    inits: dict[str, np.ndarray] = {}
    nodes: list[dict] = []
    for field, wire, val in _iter_fields(data):
        if field == 7 and wire == _WIRE_LEN:  # GraphProto
            for gfield, gwire, gval in _iter_fields(val):
                if gfield == 5 and gwire == _WIRE_LEN:  # TensorProto
                    name, arr = _parse_tensor(gval)
                    inits[name] = arr
                elif gfield == 1 and gwire == _WIRE_LEN:  # NodeProto
                    nodes.append(_parse_node(gval))
    return inits, nodes


def load_onnx_initializers(path: str) -> dict[str, np.ndarray]:
    return load_onnx_graph(path)[0]
