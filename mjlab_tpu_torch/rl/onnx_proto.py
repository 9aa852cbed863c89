"""Minimal dependency-free ONNX protobuf writer.

A copy of mjlab_tpu/rl/onnx_proto.py (the port imports nothing of the JAX
package; the card's machine has no onnx package). The producer name stays
the JAX package's, so that both packages write the same bytes for the same
policy.

The reference exports deployment policies through torch.onnx + the `onnx`
package (reference src/mjlab/utils/lab_api/rl/exporter.py); neither is a
framework dependency here, so this module serializes the (tiny) policy-MLP
graphs directly in the ONNX protobuf wire format. Scope: feed-forward
graphs of Gemm / elementwise activations / Mul-Add-Sub-Div nodes with f32
initializers and string metadata_props — exactly what the exported policy
needs, parseable by onnxruntime and netron.

Field numbers follow onnx/onnx.proto (IR version 8, default opset 17).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

# -- protobuf wire primitives --


def _varint(n: int) -> bytes:
    out = bytearray()
    n &= (1 << 64) - 1
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(fieldnum: int, wire: int) -> bytes:
    return _varint((fieldnum << 3) | wire)


def _f_varint(fieldnum: int, value: int) -> bytes:
    return _tag(fieldnum, 0) + _varint(value)


def _f_bytes(fieldnum: int, data: bytes) -> bytes:
    return _tag(fieldnum, 2) + _varint(len(data)) + data


def _f_string(fieldnum: int, s: str) -> bytes:
    return _f_bytes(fieldnum, s.encode("utf-8"))


def _f_packed_int64(fieldnum: int, values) -> bytes:
    payload = b"".join(_varint(int(v)) for v in values)
    return _f_bytes(fieldnum, payload)


# -- ONNX messages --

FLOAT = 1  # TensorProto.DataType
INT64 = 7


def tensor(name: str, array: np.ndarray) -> bytes:
    arr = np.asarray(array)
    if np.issubdtype(arr.dtype, np.integer):
        a = np.ascontiguousarray(arr, dtype=np.int64)
        dt = INT64
    else:
        a = np.ascontiguousarray(arr, dtype=np.float32)
        dt = FLOAT
    msg = b""
    msg += _f_packed_int64(1, a.shape)  # dims
    msg += _f_varint(2, dt)  # data_type
    msg += _f_string(8, name)  # name
    msg += _f_bytes(9, a.tobytes())  # raw_data
    return msg


def _tensor_type(elem_type: int, shape) -> bytes:
    dims = b""
    for d in shape:
        if isinstance(d, str):
            dims += _f_bytes(1, _f_string(2, d))  # dim_param
        else:
            dims += _f_bytes(1, _f_varint(1, int(d)))  # dim_value
    shape_msg = dims
    tt = _f_varint(1, elem_type) + _f_bytes(2, shape_msg)
    return _f_bytes(1, tt)  # TypeProto.tensor_type


def value_info(name: str, shape) -> bytes:
    return _f_string(1, name) + _f_bytes(2, _tensor_type(FLOAT, shape))


@dataclass
class Node:
    op_type: str
    inputs: list[str]
    outputs: list[str]
    name: str = ""
    # attributes: {name: float|int|str}
    attrs: dict = field(default_factory=dict)

    def encode(self) -> bytes:
        msg = b""
        for i in self.inputs:
            msg += _f_string(1, i)
        for o in self.outputs:
            msg += _f_string(2, o)
        msg += _f_string(3, self.name or self.outputs[0])
        msg += _f_string(4, self.op_type)
        for k, v in self.attrs.items():
            a = _f_string(1, k)
            if isinstance(v, float):
                a += _tag(2, 5) + struct.pack("<f", v)  # f (fixed32)
                a += _f_varint(20, 1)  # type FLOAT
            elif isinstance(v, bool):
                a += _f_varint(3, int(v))
                a += _f_varint(20, 2)
            elif isinstance(v, int):
                a += _f_varint(3, v)
                a += _f_varint(20, 2)  # type INT
            elif isinstance(v, (list, tuple)):
                a += _f_packed_int64(8, v)  # ints
                a += _f_varint(20, 7)  # type INTS
            else:
                a += _f_bytes(4, str(v).encode())
                a += _f_varint(20, 3)  # type STRING
            msg += _f_bytes(5, a)
        return msg


def graph(
    nodes: list[Node],
    name: str,
    inputs: list[bytes],
    outputs: list[bytes],
    initializers: list[bytes],
) -> bytes:
    msg = b""
    for n in nodes:
        msg += _f_bytes(1, n.encode())
    msg += _f_string(2, name)
    for t in initializers:
        msg += _f_bytes(5, t)
    for vi in inputs:
        msg += _f_bytes(11, vi)
    for vi in outputs:
        msg += _f_bytes(12, vi)
    return msg


def model(
    graph_msg: bytes,
    metadata: dict[str, str] | None = None,
    producer: str = "mjlab_tpu",
    opset: int = 17,
) -> bytes:
    msg = b""
    msg += _f_varint(1, 8)  # ir_version 8
    msg += _f_string(2, producer)
    msg += _f_bytes(7, graph_msg)
    msg += _f_bytes(8, _f_varint(2, opset))  # opset_import {version}
    for k, v in (metadata or {}).items():
        entry = _f_string(1, k) + _f_string(2, v)
        msg += _f_bytes(14, entry)
    return msg


# -- tiny reader (round-trip tests) --


def parse_fields(data: bytes) -> list[tuple[int, int, bytes | int]]:
    """Decode one protobuf message level into (field, wire, value) items."""
    out = []
    i = 0
    while i < len(data):
        key = 0
        shift = 0
        while True:
            b = data[i]
            i += 1
            key |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                break
        fieldnum, wire = key >> 3, key & 7
        if wire == 0:
            v = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                v |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            out.append((fieldnum, wire, v))
        elif wire == 2:
            ln = 0
            shift = 0
            while True:
                b = data[i]
                i += 1
                ln |= (b & 0x7F) << shift
                shift += 7
                if not b & 0x80:
                    break
            out.append((fieldnum, wire, data[i : i + ln]))
            i += ln
        elif wire == 5:
            out.append((fieldnum, wire, data[i : i + 4]))
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
    return out
