"""Self-contained ONNX model reader/writer (protobuf wire format, no deps).

The reference ships its weights as three ONNX graphs inside ``model-bin.pt``
(``vietvoicetts/core/model.py:65-106``), but this image has
neither the ``onnx`` package nor ``onnxruntime``. ONNX files are ordinary
protobuf messages, so this module implements the small subset of the wire
format the conversion pipeline needs:

- **Reader**: ``parse_model(bytes)`` → :class:`OnnxModel` with graph nodes
  (op_type / inputs / outputs / attributes), initializers as numpy arrays,
  and typed graph inputs/outputs — enough to probe topology (``probe.py``)
  and map weights (``convert.py``).
- **Writer**: ``make_model`` / ``make_graph`` / ``make_node`` /
  ``make_tensor`` — enough to build miniature ONNX fixtures so the whole
  conversion + golden harness is testable offline, before the real tarball
  ever appears.

Field numbers follow onnx/onnx.proto (IR spec): ModelProto{ir_version=1,
graph=7, opset_import=8}; GraphProto{node=1, name=2, initializer=5,
input=11, output=12, value_info=13}; NodeProto{input=1, output=2, name=3,
op_type=4, attribute=5}; AttributeProto{name=1, f=2, i=3, s=4, t=5,
floats=7, ints=8, strings=9, type=20}; TensorProto{dims=1, data_type=2,
float_data=4, int32_data=5, string_data=6, int64_data=7, name=8, raw_data=9,
double_data=10, uint64_data=11}.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

__all__ = [
    "OnnxAttribute",
    "OnnxNode",
    "OnnxTensor",
    "OnnxValueInfo",
    "OnnxGraph",
    "OnnxModel",
    "parse_model",
    "make_tensor",
    "make_node",
    "make_value_info",
    "make_graph",
    "make_model",
]

# TensorProto.DataType → numpy. bfloat16 (16) has no numpy dtype: it is
# decoded by widening its 16 bits into float32 (exact), see _bf16_to_f32.
_DTYPES: Dict[int, Any] = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}
BFLOAT16 = 16

_NP_TO_ONNX = {np.dtype(v).name: k for k, v in _DTYPES.items()}


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """bfloat16 bit patterns (uint16) → float32: a bfloat16 is the top half
    of a float32, so the widening is exact."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


# ---------------------------------------------------------------------------
# Wire-format primitives
# ---------------------------------------------------------------------------


def _read_varint(buf, i: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7
        if shift > 70:
            raise ValueError("varint too long (corrupt protobuf)")


def _signed(v: int) -> int:
    """Interpret a varint as two's-complement int64."""
    return v - (1 << 64) if v >= 1 << 63 else v


def _fields(buf) -> Iterator[Tuple[int, int, Any]]:
    """Yield (field_number, wire_type, value) over one message's bytes."""
    view = memoryview(buf)
    i, n = 0, len(view)
    while i < n:
        tag, i = _read_varint(view, i)
        fno, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _read_varint(view, i)
        elif wt == 1:
            v = bytes(view[i : i + 8])
            i += 8
        elif wt == 2:
            ln, i = _read_varint(view, i)
            v = view[i : i + ln]
            i += ln
        elif wt == 5:
            v = bytes(view[i : i + 4])
            i += 4
        else:
            raise ValueError(f"unsupported wire type {wt} (field {fno})")
        yield fno, wt, v


def _packed_varints(buf, signed: bool = True) -> List[int]:
    view = memoryview(buf)
    out, i = [], 0
    while i < len(view):
        v, i = _read_varint(view, i)
        out.append(_signed(v) if signed else v)
    return out


def _write_varint(out: bytearray, v: int) -> None:
    if v < 0:
        v += 1 << 64  # two's-complement int64
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _emit(out: bytearray, fno: int, wt: int, payload) -> None:
    _write_varint(out, (fno << 3) | wt)
    if wt == 0:
        _write_varint(out, payload)
    elif wt == 2:
        _write_varint(out, len(payload))
        out.extend(payload)
    elif wt == 5:
        out.extend(payload)
    elif wt == 1:
        out.extend(payload)
    else:  # pragma: no cover
        raise ValueError(f"unsupported wire type {wt}")


def _emit_str(out: bytearray, fno: int, s: Union[str, bytes]) -> None:
    _emit(out, fno, 2, s.encode() if isinstance(s, str) else s)


# ---------------------------------------------------------------------------
# Typed views (reader)
# ---------------------------------------------------------------------------


@dataclass
class OnnxTensor:
    name: str
    dims: Tuple[int, ...]
    data_type: int
    array: Optional[np.ndarray]


@dataclass
class OnnxAttribute:
    name: str
    value: Any  # int | float | bytes | OnnxTensor | list[int] | list[float] | list[bytes]


@dataclass
class OnnxNode:
    op_type: str
    name: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any]


@dataclass
class OnnxValueInfo:
    name: str
    elem_type: Optional[int]
    # Each dim: int (static), str (symbolic), or None (unknown).
    shape: Optional[List[Union[int, str, None]]]


@dataclass
class OnnxGraph:
    name: str = ""
    nodes: List[OnnxNode] = field(default_factory=list)
    initializers: Dict[str, OnnxTensor] = field(default_factory=dict)
    inputs: List[OnnxValueInfo] = field(default_factory=list)
    outputs: List[OnnxValueInfo] = field(default_factory=list)


@dataclass
class OnnxModel:
    ir_version: int = 0
    opset: int = 0
    graph: OnnxGraph = field(default_factory=OnnxGraph)


def _parse_tensor(buf) -> OnnxTensor:
    dims: List[int] = []
    data_type = 0
    name = ""
    raw: Optional[bytes] = None
    typed: Dict[int, list] = {}
    for fno, wt, v in _fields(buf):
        if fno == 1:  # dims
            dims.extend(_packed_varints(v) if wt == 2 else [_signed(v)])
        elif fno == 2:
            data_type = v
        elif fno == 8:
            name = bytes(v).decode()
        elif fno == 9:
            raw = bytes(v)
        elif fno == 4:  # float_data (packed fixed32 or single)
            vals = typed.setdefault(4, [])
            if wt == 2:
                vals.extend(np.frombuffer(v, "<f4").tolist())
            else:
                vals.append(struct.unpack("<f", v)[0])
        elif fno == 10:  # double_data
            vals = typed.setdefault(10, [])
            if wt == 2:
                vals.extend(np.frombuffer(v, "<f8").tolist())
            else:
                vals.append(struct.unpack("<d", v)[0])
        elif fno in (5, 7, 11):  # int32 / int64 / uint64
            vals = typed.setdefault(fno, [])
            if wt == 2:
                vals.extend(_packed_varints(v, signed=fno != 11))
            else:
                vals.append(_signed(v) if fno != 11 else v)
        elif fno == 6:  # string_data
            typed.setdefault(6, []).append(bytes(v))

    shape = tuple(dims)
    np_dtype = _DTYPES.get(data_type)
    array: Optional[np.ndarray] = None
    if data_type == BFLOAT16:
        if raw is not None:
            array = _bf16_to_f32(np.frombuffer(raw, "<u2")).reshape(shape)
        elif 5 in typed:  # int32_data holds the bit patterns
            bits = np.asarray(typed[5], np.int64).astype(np.uint16)
            array = _bf16_to_f32(bits).reshape(shape)
    elif np_dtype is not None:
        if raw is not None:
            array = np.frombuffer(raw, np.dtype(np_dtype)).reshape(shape)
        elif 4 in typed and data_type == 1:
            array = np.asarray(typed[4], np.float32).reshape(shape)
        elif 10 in typed and data_type == 11:
            array = np.asarray(typed[10], np.float64).reshape(shape)
        elif 7 in typed and data_type == 7:
            array = np.asarray(typed[7], np.int64).reshape(shape)
        elif 11 in typed and data_type == 13:
            array = np.asarray(typed[11], np.uint64).reshape(shape)
        elif 5 in typed:
            # int32_data holds int32/16/8/bool and also f16/bf16 bit patterns.
            raw32 = np.asarray(typed[5], np.int64)
            if data_type == 10:
                array = raw32.astype(np.uint16).view(np.dtype(np_dtype)).reshape(shape)
            else:
                array = raw32.astype(np.dtype(np_dtype)).reshape(shape)
    return OnnxTensor(name=name, dims=shape, data_type=data_type, array=array)


def _parse_attribute(buf) -> OnnxAttribute:
    name = ""
    single: Dict[int, Any] = {}
    floats: List[float] = []
    ints: List[int] = []
    strings: List[bytes] = []
    for fno, wt, v in _fields(buf):
        if fno == 1:
            name = bytes(v).decode()
        elif fno == 2:
            single[2] = struct.unpack("<f", v)[0]
        elif fno == 3:
            single[3] = _signed(v)
        elif fno == 4:
            single[4] = bytes(v)
        elif fno == 5:
            single[5] = _parse_tensor(v)
        elif fno == 7:
            if wt == 2:
                floats.extend(np.frombuffer(v, "<f4").tolist())
            else:
                floats.append(struct.unpack("<f", v)[0])
        elif fno == 8:
            ints.extend(_packed_varints(v) if wt == 2 else [_signed(v)])
        elif fno == 9:
            strings.append(bytes(v))
    for key in (3, 2, 4, 5):
        if key in single:
            return OnnxAttribute(name, single[key])
    if ints:
        return OnnxAttribute(name, ints)
    if floats:
        return OnnxAttribute(name, floats)
    if strings:
        return OnnxAttribute(name, strings)
    return OnnxAttribute(name, None)


def _parse_node(buf) -> OnnxNode:
    inputs: List[str] = []
    outputs: List[str] = []
    name = ""
    op_type = ""
    attrs: Dict[str, Any] = {}
    for fno, _wt, v in _fields(buf):
        if fno == 1:
            inputs.append(bytes(v).decode())
        elif fno == 2:
            outputs.append(bytes(v).decode())
        elif fno == 3:
            name = bytes(v).decode()
        elif fno == 4:
            op_type = bytes(v).decode()
        elif fno == 5:
            a = _parse_attribute(v)
            attrs[a.name] = a.value
    return OnnxNode(op_type=op_type, name=name, inputs=inputs, outputs=outputs, attrs=attrs)


def _parse_value_info(buf) -> OnnxValueInfo:
    name = ""
    elem_type: Optional[int] = None
    shape: Optional[List[Union[int, str, None]]] = None
    for fno, _wt, v in _fields(buf):
        if fno == 1:
            name = bytes(v).decode()
        elif fno == 2:  # TypeProto
            for tfno, _twt, tv in _fields(v):
                if tfno != 1:  # tensor_type only
                    continue
                for sfno, _swt, sv in _fields(tv):
                    if sfno == 1:
                        elem_type = sv
                    elif sfno == 2:  # TensorShapeProto
                        shape = []
                        for dfno, _dwt, dv in _fields(sv):
                            if dfno != 1:
                                continue
                            dim: Union[int, str, None] = None
                            for xfno, _xwt, xv in _fields(dv):
                                if xfno == 1:
                                    dim = _signed(xv) if isinstance(xv, int) else xv
                                elif xfno == 2:
                                    dim = bytes(xv).decode()
                            shape.append(dim)
    return OnnxValueInfo(name=name, elem_type=elem_type, shape=shape)


def _parse_graph(buf) -> OnnxGraph:
    g = OnnxGraph()
    for fno, _wt, v in _fields(buf):
        if fno == 1:
            g.nodes.append(_parse_node(v))
        elif fno == 2:
            g.name = bytes(v).decode()
        elif fno == 5:
            t = _parse_tensor(v)
            g.initializers[t.name] = t
        elif fno == 11:
            g.inputs.append(_parse_value_info(v))
        elif fno == 12:
            g.outputs.append(_parse_value_info(v))
    return g


def parse_model(data: bytes) -> OnnxModel:
    """Parse a serialized ONNX ModelProto."""
    m = OnnxModel()
    for fno, _wt, v in _fields(data):
        if fno == 1:
            m.ir_version = v
        elif fno == 7:
            m.graph = _parse_graph(v)
        elif fno == 8:  # OperatorSetIdProto
            for ofno, _owt, ov in _fields(v):
                if ofno == 2:
                    m.opset = max(m.opset, _signed(ov) if isinstance(ov, int) else 0)
    return m


# ---------------------------------------------------------------------------
# Writer (fixture construction)
# ---------------------------------------------------------------------------


def make_tensor(name: str, array: np.ndarray) -> bytes:
    """Serialize a numpy array as a TensorProto (raw_data encoding)."""
    arr = np.ascontiguousarray(array)
    dtype_code = _NP_TO_ONNX.get(arr.dtype.name)
    if dtype_code is None:
        raise ValueError(f"unsupported dtype {arr.dtype}")
    out = bytearray()
    for d in arr.shape:
        _emit(out, 1, 0, d)
    _emit(out, 2, 0, dtype_code)
    _emit_str(out, 8, name)
    _emit(out, 9, 2, arr.tobytes())
    return bytes(out)


def _make_attribute(name: str, value) -> bytes:
    out = bytearray()
    _emit_str(out, 1, name)
    if isinstance(value, bool):
        value = int(value)
    if isinstance(value, int):
        _emit(out, 3, 0, value)
        _emit(out, 20, 0, 2)  # AttributeProto.INT
    elif isinstance(value, float):
        _emit(out, 2, 5, struct.pack("<f", value))
        _emit(out, 20, 0, 1)  # FLOAT
    elif isinstance(value, (str, bytes)):
        _emit_str(out, 4, value)
        _emit(out, 20, 0, 3)  # STRING
    elif isinstance(value, (list, tuple)) and all(isinstance(x, int) for x in value):
        for x in value:
            _emit(out, 8, 0, x)
        _emit(out, 20, 0, 7)  # INTS
    elif isinstance(value, (list, tuple)):
        for x in value:
            _emit(out, 7, 5, struct.pack("<f", float(x)))
        _emit(out, 20, 0, 6)  # FLOATS
    else:
        raise ValueError(f"unsupported attribute value {value!r}")
    return bytes(out)


def make_node(
    op_type: str,
    inputs: List[str],
    outputs: List[str],
    name: str = "",
    **attrs,
) -> bytes:
    out = bytearray()
    for s in inputs:
        _emit_str(out, 1, s)
    for s in outputs:
        _emit_str(out, 2, s)
    if name:
        _emit_str(out, 3, name)
    _emit_str(out, 4, op_type)
    for k, v in attrs.items():
        _emit(out, 5, 2, _make_attribute(k, v))
    return bytes(out)


def make_value_info(name: str, elem_type: int, shape) -> bytes:
    dims = bytearray()
    for d in shape:
        dim = bytearray()
        if isinstance(d, int):
            _emit(dim, 1, 0, d)
        else:
            _emit_str(dim, 2, str(d))
        _emit(dims, 1, 2, bytes(dim))
    tensor_type = bytearray()
    _emit(tensor_type, 1, 0, elem_type)
    _emit(tensor_type, 2, 2, bytes(dims))
    type_proto = bytearray()
    _emit(type_proto, 1, 2, bytes(tensor_type))
    out = bytearray()
    _emit_str(out, 1, name)
    _emit(out, 2, 2, bytes(type_proto))
    return bytes(out)


def make_graph(
    name: str,
    nodes: List[bytes],
    initializers: List[bytes],
    inputs: List[bytes] = (),
    outputs: List[bytes] = (),
) -> bytes:
    out = bytearray()
    for n in nodes:
        _emit(out, 1, 2, n)
    _emit_str(out, 2, name)
    for t in initializers:
        _emit(out, 5, 2, t)
    for vi in inputs:
        _emit(out, 11, 2, vi)
    for vi in outputs:
        _emit(out, 12, 2, vi)
    return bytes(out)


def make_model(graph: bytes, ir_version: int = 8, opset: int = 17) -> bytes:
    opset_id = bytearray()
    _emit_str(opset_id, 1, "")
    _emit(opset_id, 2, 0, opset)
    out = bytearray()
    _emit(out, 1, 0, ir_version)
    _emit(out, 7, 2, graph)
    _emit(out, 8, 2, bytes(opset_id))
    return bytes(out)
