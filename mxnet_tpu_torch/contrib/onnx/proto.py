"""Self-contained protobuf wire-format codec for the ONNX message subset,
the port's own copy of the JAX package's ``contrib/onnx/proto.py``.

No ``onnx`` wheel is needed: like the JAX package (and unlike the
reference, python/mxnet/contrib/onnx/, which imports the onnx package for
its protobuf classes) this module encodes and decodes the ONNX
serialization format directly.  Field numbers and types follow the public
ONNX schema (onnx/onnx.proto, Apache-2.0) and the protobuf encoding spec:

    ModelProto:   ir_version=1, producer_name=2, producer_version=3,
                  domain=4, model_version=5, doc_string=6, graph=7,
                  opset_import=8
    OperatorSetIdProto: domain=1, version=2
    GraphProto:   node=1, name=2, initializer=5, doc_string=10,
                  input=11, output=12, value_info=13
    NodeProto:    input=1, output=2, name=3, op_type=4, attribute=5,
                  doc_string=6, domain=7
    AttributeProto: name=1, f=2, i=3, s=4, t=5, floats=7, ints=8,
                  strings=9, type=20
                  (type enum: FLOAT=1, INT=2, STRING=3, TENSOR=4,
                   FLOATS=6, INTS=7, STRINGS=8)
    TensorProto:  dims=1, data_type=2, name=8, raw_data=9
    ValueInfoProto: name=1, type=2
    TypeProto:    tensor_type=1;  TypeProto.Tensor: elem_type=1, shape=2
    TensorShapeProto: dim=1;  Dimension: dim_value=1, dim_param=2

Only the fields the exporter/importer need are modelled; unknown fields
are skipped on decode (forward-compatible, as protobuf prescribes).

bfloat16: numpy has no such type, and the port adds no package for one.
A BFLOAT16 tensor travels as its raw 16-bit words, bit for
bit: :func:`make_tensor` takes a ``torch.bfloat16`` tensor (or a numpy
array whose dtype is named ``bfloat16``, which it reads as ``uint16``
words), and :func:`parse_tensor` hands a BFLOAT16 tensor out as a
``torch.bfloat16`` CPU tensor (``"array_is": "torch.bfloat16"``); every
other type comes out as a numpy array (``"array_is": "numpy"``).
"""
from __future__ import annotations

import struct
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

# --------------------------------------------------------------------------
# ONNX TensorProto.DataType <-> numpy
# --------------------------------------------------------------------------

FLOAT, UINT8, INT8, INT32, INT64, BOOL = 1, 2, 3, 6, 7, 9
FLOAT16, DOUBLE, BFLOAT16 = 10, 11, 16

_NP2ONNX = {
    np.dtype(np.float32): FLOAT,
    np.dtype(np.uint8): UINT8,
    np.dtype(np.int8): INT8,
    np.dtype(np.int32): INT32,
    np.dtype(np.int64): INT64,
    np.dtype(np.bool_): BOOL,
    np.dtype(np.float16): FLOAT16,
    np.dtype(np.float64): DOUBLE,
}
_ONNX2NP = {v: k for k, v in _NP2ONNX.items()}



def _is_bf16(dtype) -> bool:
    return dtype == torch.bfloat16 or str(dtype) in ("bfloat16",
                                                     "torch.bfloat16")


def np_to_onnx_dtype(dtype) -> int:
    """The TensorProto data type of a numpy dtype, a torch dtype or a
    dtype name; ``bfloat16`` (torch's, or a numpy dtype of that name) is
    BFLOAT16."""
    if _is_bf16(dtype):
        return BFLOAT16
    if isinstance(dtype, torch.dtype):
        dtype = str(dtype).replace("torch.", "")
    dt = np.dtype(dtype)
    if dt not in _NP2ONNX:
        raise ValueError(f"dtype {dt} has no ONNX TensorProto mapping")
    return _NP2ONNX[dt]


def onnx_to_np_dtype(code: int):
    """The numpy dtype of a TensorProto data type; BFLOAT16 has none
    (see :func:`onnx_dtype_name`)."""
    if code == BFLOAT16:
        raise ValueError("ONNX BFLOAT16 has no numpy dtype; its tensors "
                         "decode as torch.bfloat16 (parse_tensor)")
    if code not in _ONNX2NP:
        raise ValueError(f"ONNX data_type {code} unsupported")
    return _ONNX2NP[code]


def onnx_dtype_name(code: int) -> str:
    """The dtype name of a TensorProto data type (``bfloat16`` too)."""
    return "bfloat16" if code == BFLOAT16 else onnx_to_np_dtype(code).name


# --------------------------------------------------------------------------
# wire-format primitives (encode)
# --------------------------------------------------------------------------


def _varint(n: int) -> bytes:
    if n < 0:  # two's-complement 64-bit, 10-byte varint
        n &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def enc_int(field: int, value: int) -> bytes:
    return _tag(field, 0) + _varint(int(value))


def enc_bytes(field: int, value: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(value)) + value


def enc_str(field: int, value: str) -> bytes:
    return enc_bytes(field, value.encode("utf-8"))


def enc_float(field: int, value: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", float(value))


# --------------------------------------------------------------------------
# wire-format primitives (decode)
# --------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _signed64(n: int) -> int:
    return n - (1 << 64) if n >= (1 << 63) else n


def scan(buf: bytes):
    """Yield (field_number, wire_type, value) over one message's fields.
    value is int for varint/fixed wire types, bytes for length-delimited."""
    pos = 0
    while pos < len(buf):
        key, pos = _read_varint(buf, pos)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, pos = _read_varint(buf, pos)
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            v = buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            v = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        elif wt == 1:
            v = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        else:  # groups (3/4) don't occur in ONNX
            raise ValueError(f"unsupported wire type {wt}")
        yield field, wt, v


def _unpack_int64s(raw: bytes) -> List[int]:
    out, pos = [], 0
    while pos < len(raw):
        v, pos = _read_varint(raw, pos)
        out.append(_signed64(v))
    return out


# --------------------------------------------------------------------------
# ONNX message builders (encode side)
# --------------------------------------------------------------------------

# AttributeProto.AttributeType
_A_FLOAT, _A_INT, _A_STRING, _A_TENSOR = 1, 2, 3, 4
_A_FLOATS, _A_INTS, _A_STRINGS = 6, 7, 8


def _wire(array):
    """(shape, data type, little-endian bytes) of a numpy array or a
    torch tensor; bfloat16 as its 16-bit words."""
    if isinstance(array, torch.Tensor):
        t = array.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            words = t.view(torch.int16).numpy().view(np.uint16)
            return t.shape, BFLOAT16, words.astype("<u2").tobytes()
        array = t.numpy()
    array = np.ascontiguousarray(array)
    if array.dtype.name == "bfloat16":
        words = array.view(np.uint16)
        return array.shape, BFLOAT16, words.astype("<u2").tobytes()
    little = array.astype(array.dtype.newbyteorder("<"), copy=False)
    return array.shape, np_to_onnx_dtype(array.dtype), little.tobytes()


def make_tensor(name: str, array) -> bytes:
    shape, data_type, raw = _wire(array)
    body = b"".join(enc_int(1, d) for d in shape)
    body += enc_int(2, data_type)
    body += enc_str(8, name)
    body += enc_bytes(9, raw)
    return body


def make_attribute(name: str, value) -> bytes:
    body = enc_str(1, name)
    if isinstance(value, bool):
        body += enc_int(3, int(value)) + enc_int(20, _A_INT)
    elif isinstance(value, int):
        body += enc_int(3, value) + enc_int(20, _A_INT)
    elif isinstance(value, float):
        body += enc_float(2, value) + enc_int(20, _A_FLOAT)
    elif isinstance(value, str):
        body += enc_bytes(4, value.encode()) + enc_int(20, _A_STRING)
    elif isinstance(value, bytes):  # pre-encoded TensorProto
        body += enc_bytes(5, value) + enc_int(20, _A_TENSOR)
    elif isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            body += b"".join(enc_int(8, int(v)) for v in value)
            body += enc_int(20, _A_INTS)
        elif all(isinstance(v, (float, int, np.floating)) for v in value):
            body += b"".join(enc_float(7, float(v)) for v in value)
            body += enc_int(20, _A_FLOATS)
        elif all(isinstance(v, str) for v in value):
            body += b"".join(enc_bytes(9, v.encode()) for v in value)
            body += enc_int(20, _A_STRINGS)
        else:
            raise ValueError(f"attribute {name}: mixed list {value!r}")
    else:
        raise ValueError(f"attribute {name}: unsupported {type(value)}")
    return body


def make_node(op_type: str, inputs: Sequence[str], outputs: Sequence[str],
              name: str = "", **attrs) -> bytes:
    body = b"".join(enc_str(1, i) for i in inputs)
    body += b"".join(enc_str(2, o) for o in outputs)
    if name:
        body += enc_str(3, name)
    body += enc_str(4, op_type)
    for k in sorted(attrs):
        if attrs[k] is None:
            continue
        body += enc_bytes(5, make_attribute(k, attrs[k]))
    return body


def make_tensor_value_info(name: str, elem_type: int,
                           shape: Optional[Sequence[Union[int, str, None]]]
                           ) -> bytes:
    tensor = enc_int(1, elem_type)
    if shape is not None:
        dims = b""
        for d in shape:
            if isinstance(d, (int, np.integer)):
                dims += enc_bytes(1, enc_int(1, int(d)))
            else:  # symbolic / unknown
                dims += enc_bytes(1, enc_str(2, str(d or "?")))
        tensor += enc_bytes(2, dims)
    type_proto = enc_bytes(1, tensor)
    return enc_str(1, name) + enc_bytes(2, type_proto)


def make_graph(nodes: Sequence[bytes], name: str,
               inputs: Sequence[bytes], outputs: Sequence[bytes],
               initializers: Sequence[bytes] = ()) -> bytes:
    body = b"".join(enc_bytes(1, n) for n in nodes)
    body += enc_str(2, name)
    body += b"".join(enc_bytes(5, t) for t in initializers)
    body += b"".join(enc_bytes(11, i) for i in inputs)
    body += b"".join(enc_bytes(12, o) for o in outputs)
    return body


def make_model(graph: bytes, opset: int = 11, ir_version: int = 6,
               producer_name: str = "mxnet_tpu_torch",
               producer_version: str = "1.0") -> bytes:
    opset_id = enc_str(1, "") + enc_int(2, opset)
    return (enc_int(1, ir_version)
            + enc_str(2, producer_name)
            + enc_str(3, producer_version)
            + enc_bytes(7, graph)
            + enc_bytes(8, opset_id))


# --------------------------------------------------------------------------
# ONNX message parsers (decode side) — return plain dicts
# --------------------------------------------------------------------------


def parse_tensor(buf: bytes) -> Dict:
    dims, data_type, name, raw = [], FLOAT, "", None
    float_data, int32_data, int64_data, double_data = [], [], [], []
    for field, wt, v in scan(buf):
        if field == 1:
            if wt == 2:  # packed
                dims.extend(_unpack_int64s(v))
            else:
                dims.append(_signed64(v))
        elif field == 2:
            data_type = v
        elif field == 4:
            float_data.extend(struct.unpack(f"<{len(v)//4}f", v)
                              if wt == 2 else
                              [struct.unpack("<f", struct.pack("<I", v))[0]])
        elif field == 5:
            int32_data.extend(_unpack_int64s(v) if wt == 2 else [v])
        elif field == 7:
            int64_data.extend(_unpack_int64s(v) if wt == 2
                              else [_signed64(v)])
        elif field == 8:
            name = v.decode("utf-8")
        elif field == 9:
            raw = v
        elif field == 10:
            double_data.extend(struct.unpack(f"<{len(v)//8}d", v)
                               if wt == 2 else
                               [struct.unpack("<d", struct.pack("<Q", v))[0]])
    if data_type == BFLOAT16:
        # raw words, or (the spec's other form) one word per int32_data
        words = (np.frombuffer(raw, dtype="<u2") if raw is not None
                 else np.asarray(int32_data, dtype=np.uint16))
        arr = torch.from_numpy(words.astype(np.uint16).view(np.int16)
                               .reshape(dims).copy()).view(torch.bfloat16)
        return {"name": name, "dims": dims, "data_type": data_type,
                "array": arr, "array_is": "torch.bfloat16"}
    np_dtype = onnx_to_np_dtype(data_type)
    if raw is not None:
        arr = np.frombuffer(raw, dtype=np_dtype.newbyteorder("<"))
        arr = arr.astype(np_dtype).reshape(dims)
    elif float_data:
        arr = np.asarray(float_data, dtype=np_dtype).reshape(dims)
    elif int64_data:
        arr = np.asarray(int64_data, dtype=np_dtype).reshape(dims)
    elif int32_data:
        arr = np.asarray(int32_data, dtype=np_dtype).reshape(dims)
    elif double_data:
        arr = np.asarray(double_data, dtype=np_dtype).reshape(dims)
    else:
        arr = np.zeros(dims, dtype=np_dtype)
    return {"name": name, "dims": dims, "data_type": data_type,
            "array": arr, "array_is": "numpy"}


def parse_attribute(buf: bytes) -> Tuple[str, object]:
    name, atype = "", None
    f = i = s = t = None
    floats, ints, strings = [], [], []
    for field, wt, v in scan(buf):
        if field == 1:
            name = v.decode("utf-8")
        elif field == 2:
            f = struct.unpack("<f", struct.pack("<I", v))[0]
        elif field == 3:
            i = _signed64(v)
        elif field == 4:
            s = v
        elif field == 5:
            t = parse_tensor(v)
        elif field == 7:
            floats.extend(struct.unpack(f"<{len(v)//4}f", v) if wt == 2
                          else [struct.unpack("<f", struct.pack("<I", v))[0]])
        elif field == 8:
            ints.extend(_unpack_int64s(v) if wt == 2 else [_signed64(v)])
        elif field == 9:
            strings.append(v.decode("utf-8"))
        elif field == 20:
            atype = v
    if atype == _A_FLOAT:
        return name, f
    if atype == _A_INT:
        return name, i
    if atype == _A_STRING:
        return name, s.decode("utf-8") if s is not None else ""
    if atype == _A_TENSOR:
        return name, t
    if atype == _A_FLOATS:
        return name, list(floats)
    if atype == _A_INTS:
        return name, list(ints)
    if atype == _A_STRINGS:
        return name, strings
    # untyped writers: infer from which member is set
    for val in (i, f, s, t):
        if val is not None:
            return name, val
    return name, ints or floats or strings


def parse_node(buf: bytes) -> Dict:
    node = {"input": [], "output": [], "name": "", "op_type": "",
            "attrs": {}}
    for field, _, v in scan(buf):
        if field == 1:
            node["input"].append(v.decode("utf-8"))
        elif field == 2:
            node["output"].append(v.decode("utf-8"))
        elif field == 3:
            node["name"] = v.decode("utf-8")
        elif field == 4:
            node["op_type"] = v.decode("utf-8")
        elif field == 5:
            k, val = parse_attribute(v)
            node["attrs"][k] = val
    return node


def _parse_shape(buf: bytes) -> List[Union[int, str]]:
    shape = []
    for field, _, dim_buf in scan(buf):
        if field != 1:
            continue
        val: Union[int, str] = "?"
        for f2, _, v2 in scan(dim_buf):
            if f2 == 1:
                val = _signed64(v2) if isinstance(v2, int) else v2
            elif f2 == 2:
                val = v2.decode("utf-8")
        shape.append(val)
    return shape


def parse_value_info(buf: bytes) -> Dict:
    info = {"name": "", "elem_type": None, "shape": None}
    for field, _, v in scan(buf):
        if field == 1:
            info["name"] = v.decode("utf-8")
        elif field == 2:  # TypeProto
            for f2, _, v2 in scan(v):
                if f2 != 1:  # tensor_type
                    continue
                for f3, _, v3 in scan(v2):
                    if f3 == 1:
                        info["elem_type"] = v3
                    elif f3 == 2:
                        info["shape"] = _parse_shape(v3)
    return info


def parse_graph(buf: bytes) -> Dict:
    graph = {"node": [], "name": "", "initializer": [],
             "input": [], "output": [], "value_info": []}
    for field, _, v in scan(buf):
        if field == 1:
            graph["node"].append(parse_node(v))
        elif field == 2:
            graph["name"] = v.decode("utf-8")
        elif field == 5:
            graph["initializer"].append(parse_tensor(v))
        elif field == 11:
            graph["input"].append(parse_value_info(v))
        elif field == 12:
            graph["output"].append(parse_value_info(v))
        elif field == 13:
            graph["value_info"].append(parse_value_info(v))
    return graph


def parse_model(buf: bytes) -> Dict:
    model = {"ir_version": None, "producer_name": "", "graph": None,
             "opset": []}
    for field, _, v in scan(buf):
        if field == 1:
            model["ir_version"] = v
        elif field == 2:
            model["producer_name"] = v.decode("utf-8")
        elif field == 7:
            model["graph"] = parse_graph(v)
        elif field == 8:
            dom, ver = "", 0
            for f2, _, v2 in scan(v):
                if f2 == 1:
                    dom = v2.decode("utf-8")
                elif f2 == 2:
                    ver = v2
            model["opset"].append((dom, ver))
    return model
