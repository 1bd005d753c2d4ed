"""Minimal dependency-free ONNX writer: .npz models -> ONNX.

Completes the interop loop: `import-model` brings reference ONNX artifacts
in; this exports trained-or-imported models back out as opset-11 graphs of
Conv(+bias)/Relu/Flatten/Gemm nodes with a dynamic batch dimension, the
shape contract the reference CPU runtime expects (mod_main.cpp:40-64 reads
rank-3 (B, kmer, feat) input and reshapes).

The bn0 scale/shift is emitted as a BatchNormalization node (gamma=scale,
beta=shift, mean=0, var=1-eps) so the graph structure mirrors the shipped
artifacts.  A copy of the JAX package's writer: both write the same bytes
for the same parameters (the producer field included), so a model exported
by either package is the same file.
"""
from __future__ import annotations

import struct

import numpy as np

_ONNX_FLOAT = 1
_ONNX_INT64 = 7


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field(num: int, wire: int) -> bytes:
    return _varint((num << 3) | wire)


def _len_field(num: int, payload: bytes) -> bytes:
    return _field(num, 2) + _varint(len(payload)) + payload


def _str_field(num: int, s: str) -> bytes:
    return _len_field(num, s.encode())


def _int_field(num: int, v: int) -> bytes:
    return _field(num, 0) + _varint(v)


def _tensor(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    if arr.dtype == np.float32:
        dt = _ONNX_FLOAT
    elif arr.dtype == np.int64:
        dt = _ONNX_INT64
    else:
        arr = arr.astype(np.float32)
        dt = _ONNX_FLOAT
    out = b""
    for d in arr.shape:
        out += _int_field(1, d)                    # dims
    out += _int_field(2, dt)                       # data_type
    out += _str_field(8, name)                     # name
    out += _len_field(9, arr.tobytes())            # raw_data
    return out


def _attr_ints(name: str, vals) -> bytes:
    body = _str_field(1, name)
    for v in vals:
        body += _int_field(8, v)
    body += _int_field(20, 7)                      # AttributeProto.type = INTS
    return body


def _attr_int(name: str, v: int) -> bytes:
    return _str_field(1, name) + _int_field(3, v) + _int_field(20, 2)


def _attr_float(name: str, v: float) -> bytes:
    return (_str_field(1, name) + _field(2, 5) + struct.pack("<f", v) +
            _int_field(20, 1))


def _node(op: str, inputs, outputs, attrs: bytes = b"", name: str = "") -> bytes:
    body = b""
    for i in inputs:
        body += _str_field(1, i)
    for o in outputs:
        body += _str_field(2, o)
    body += _str_field(3, name or f"{op}_{outputs[0]}")
    body += _str_field(4, op)
    if attrs:
        body += attrs
    return body


def _value_info(name: str, dims) -> bytes:
    """ValueInfoProto with dynamic ('B') first dim."""
    shape = b""
    for d in dims:
        if isinstance(d, str):
            dim = _str_field(3, d)                 # dim_param
        else:
            dim = _int_field(1, d)                 # dim_value
        shape += _len_field(1, dim)
    tensor_type = _int_field(1, _ONNX_FLOAT) + _len_field(2, shape)
    type_proto = _len_field(1, tensor_type)
    return _str_field(1, name) + _len_field(2, type_proto)


def export_onnx(params: dict, path: str, kmer: int = 401,
                in_features: int = 8, model_name: str = "DNAModNet") -> None:
    """Write an inference params pytree (model/cnn.py layout) as ONNX."""
    inits = []
    nodes = []

    # input (B, kmer, feat) -> transpose to channel-first
    nodes.append(_node("Transpose", ["input"], ["x_t"],
                       _len_field(5, _attr_ints("perm", [0, 2, 1]))))
    # bn0 as BatchNormalization with identity stats
    scale = np.asarray(params["bn0"]["scale"], np.float32)
    shift = np.asarray(params["bn0"]["shift"], np.float32)
    eps = 1e-5
    inits += [_tensor("bn0.gamma", scale),
              _tensor("bn0.beta", shift),
              _tensor("bn0.mean", np.zeros_like(scale)),
              _tensor("bn0.var", np.full_like(scale, 1.0 - eps))]
    nodes.append(_node(
        "BatchNormalization",
        ["x_t", "bn0.gamma", "bn0.beta", "bn0.mean", "bn0.var"],
        ["h0"], _len_field(5, _attr_float("epsilon", eps))))

    h = "h0"
    for i, conv in enumerate(params["convs"]):
        w = np.asarray(conv["w"], np.float32)       # (K, Cin, Cout) WIO
        b = np.asarray(conv["b"], np.float32)
        K = w.shape[0]
        stride = int(conv.get("stride", 2))
        pad = conv.get("pad", (1, 1))
        wn, bn_ = f"conv{i}.w", f"conv{i}.b"
        inits += [_tensor(wn, np.ascontiguousarray(w.transpose(2, 1, 0))),
                  _tensor(bn_, b)]
        attrs = (_len_field(5, _attr_ints("dilations", [1])) +
                 _len_field(5, _attr_int("group", 1)) +
                 _len_field(5, _attr_ints("kernel_shape", [K])) +
                 _len_field(5, _attr_ints("pads", [int(pad[0]), int(pad[1])])) +
                 _len_field(5, _attr_ints("strides", [stride])))
        cn = f"c{i}"
        nodes.append(_node("Conv", [h, wn, bn_], [cn], attrs))
        rn = f"r{i}"
        nodes.append(_node("Relu", [cn], [rn]))
        h = rn

    nodes.append(_node("Flatten", [h], ["flat"],
                       _len_field(5, _attr_int("axis", 1))))
    for i, fc in enumerate((params["fc1"], params["fc2"])):
        w = np.asarray(fc["w"], np.float32)         # (in, out)
        b = np.asarray(fc["b"], np.float32)
        wn, bn_ = f"fc{i + 1}.w", f"fc{i + 1}.b"
        inits += [_tensor(wn, np.ascontiguousarray(w.T)), _tensor(bn_, b)]
        attrs = _len_field(5, _attr_int("transB", 1))
        src = "flat" if i == 0 else "fcr1"
        dst = "fco1" if i == 0 else "output"
        nodes.append(_node("Gemm", [src, wn, bn_], [dst], attrs))
        if i == 0:
            nodes.append(_node("Relu", ["fco1"], ["fcr1"]))

    graph = b""
    for n in nodes:
        graph += _len_field(1, n)
    graph += _str_field(2, model_name)
    for t in inits:
        graph += _len_field(5, t)
    graph += _len_field(11, _value_info("input", ["B", kmer, in_features]))
    graph += _len_field(12, _value_info("output", ["B", 2]))

    opset = _str_field(1, "") + _int_field(2, 11)
    model = (_int_field(1, 7) +                     # ir_version
             _str_field(2, "hifimeth-tpu") +        # producer
             _len_field(7, graph) +
             _len_field(8, opset))
    with open(path, "wb") as f:
        f.write(model)
