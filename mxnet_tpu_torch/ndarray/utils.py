"""NDArray files: ``nd.save`` / ``nd.load``.

Counterpart of ``mxnet_tpu/ndarray/utils.py`` (the port's own copy of its
file format, so a file written by either package loads in the other, bit
for bit): one file holds a list of arrays or a str -> array map.

  * native:  magic ``MXTPND01`` | u64 header length | header JSON |
    raw payloads (bfloat16 as its raw 16-bit pattern, dtype in the
    header);
  * legacy MXNet 1.x, read and written (``save_legacy``):
        u64 0x112 | u64 reserved | u64 count | count records
        | u64 name count | name count * (u64 length | bytes)
    each dense record being
        u32 0xF993FAC9 (V2) | i32 stype (0, dense) | u32 ndim
        | i64 dims[ndim] (V1 files and pre-1.5 V2: u32)
        | i32 dev_type | i32 dev_id | i32 type flag | raw data

``load`` dispatches on the leading magic.  Arrays may be NDArrays or torch
tensors; a bfloat16 one is written through its bits
(``base.tensor_from_numpy`` reads them back).  ``load`` returns arrays on
``ctx``, the CPU unless the caller names a device: a file is host bytes,
and ``Parameter.set_data`` moves each value to its parameter's device.
"""
from __future__ import annotations

import json
import struct

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["save", "load", "save_legacy"]

_MAGIC = b"MXTPND01"

# legacy constants (MXNet src/ndarray/ndarray.cc NDArray::Save, c_api.cc
# MXNDArraySave, mshadow TypeFlag)
_LEGACY_LIST_MAGIC = 0x112
_LEGACY_V1_MAGIC = 0xF993FAC8
_LEGACY_V2_MAGIC = 0xF993FAC9
_LEGACY_DTYPES = {0: "float32", 1: "float64", 2: "float16", 3: "uint8",
                  4: "int32", 5: "int8", 6: "int64", 12: "bfloat16"}
_LEGACY_FLAGS = {v: k for k, v in _LEGACY_DTYPES.items()}


def _host(value):
    """(dtype name, C-contiguous numpy array) of an NDArray, a tensor or
    an array; a bfloat16 one as its uint16 bit pattern."""
    from .ndarray import NDArray

    if isinstance(value, NDArray):
        value = value._data
    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy().view(np.uint16)
        return str(t.dtype).replace("torch.", ""), t.numpy()
    arr = np.ascontiguousarray(value)
    if arr.dtype.name == "bfloat16":
        return "bfloat16", arr.view(np.uint16)
    return arr.dtype.name, arr


def _from_bytes(buf: bytes, dtype_name: str, shape, ctx) -> "NDArray":
    from ..base import tensor_from_numpy
    from .ndarray import NDArray

    if dtype_name == "bfloat16":
        bits = np.frombuffer(buf, dtype=np.int16).reshape(shape)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = tensor_from_numpy(np.frombuffer(buf, dtype=np.dtype(dtype_name))
                              .reshape(shape))
    dev = torch.device(ctx) if ctx is not None else torch.device("cpu")
    return NDArray(t.to(dev), ctx=dev)


def _named(data):
    """(names, arrays, keyed) of what ``save`` takes."""
    from .ndarray import NDArray

    if isinstance(data, (NDArray, torch.Tensor)):
        data = [data]
    if isinstance(data, dict):
        names = list(data.keys())
        return names, [data[k] for k in names], True
    if isinstance(data, (list, tuple)):
        return [str(i) for i in range(len(data))], list(data), False
    raise MXNetError("save expects an NDArray, a list or a dict of them")


def save(fname: str, data) -> None:
    """Write an array, a list of arrays or a str -> array dict in the
    native format."""
    names, arrays, keyed = _named(data)
    entries, payloads = [], []
    for name, value in zip(names, arrays):
        dtname, arr = _host(value)
        raw = arr.tobytes()
        entries.append({"name": name, "dtype": dtname,
                        "shape": list(arr.shape), "nbytes": len(raw)})
        payloads.append(raw)
    header = json.dumps({"keyed": keyed, "entries": entries}).encode()
    with open(fname, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        for p in payloads:
            f.write(p)


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def read(self, fmt: str):
        vals = struct.unpack_from("<" + fmt, self.buf, self.pos)
        self.pos += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    def raw(self, n: int) -> bytes:
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise MXNetError("legacy NDArray file truncated")
        self.pos += n
        return out


def _legacy_record(r: _Reader):
    """(dtype name, shape, raw bytes) of one dense legacy record.  The
    dims' width is not in the file: each candidate parse is checked
    against what follows it (plausible dims, device and type flag, a
    payload that fits), as the JAX reader does."""
    magic = r.read("I")
    if magic == _LEGACY_V2_MAGIC:
        if r.read("i") != 0:
            raise MXNetError("legacy sparse NDArray records are not "
                             "supported; re-save densely")
        dim_fmts = ("q", "I")
    elif magic == _LEGACY_V1_MAGIC:
        dim_fmts = ("I",)
    else:
        raise MXNetError(f"bad legacy NDArray magic {magic:#x}")
    ndim = r.read("I")
    if ndim > 32:
        raise MXNetError(f"implausible legacy ndim {ndim}")
    start = r.pos
    for fmt in dim_fmts:
        r.pos = start
        try:
            dims = [r.read(fmt) for _ in range(ndim)]
            dev_type, dev_id = r.read("ii")
            name = _LEGACY_DTYPES.get(r.read("i"))
        except struct.error:
            continue
        if name is None:
            continue
        count = int(np.prod(dims)) if dims else 1
        itemsize = 2 if name == "bfloat16" else np.dtype(name).itemsize
        if (all(0 <= d < (1 << 40) for d in dims)
                and 1 <= dev_type <= 16 and 0 <= dev_id < 4096
                and r.pos + count * itemsize <= len(r.buf)):
            return name, tuple(dims), r.raw(count * itemsize)
    raise MXNetError("cannot parse legacy NDArray record (unknown dim "
                     "width or type flag)")


def _load_legacy(buf: bytes, ctx):
    r = _Reader(buf)
    r.read("QQ")
    records = [_legacy_record(r) for _ in range(r.read("Q"))]
    names = [r.raw(r.read("Q")).decode() for _ in range(r.read("Q"))]
    nds = [_from_bytes(raw, name, shape, ctx) for name, shape, raw in records]
    if names:
        if len(names) != len(nds):
            raise MXNetError("legacy file: name/array count mismatch")
        return dict(zip(names, nds))
    return nds


def save_legacy(fname: str, data) -> None:
    """Write the MXNet 1.x format (what ``_load_legacy`` reads)."""
    names, arrays, keyed = _named(data)
    with open(fname, "wb") as f:
        f.write(struct.pack("<QQ", _LEGACY_LIST_MAGIC, 0))
        f.write(struct.pack("<Q", len(arrays)))
        for value in arrays:
            dtname, arr = _host(value)
            if dtname not in _LEGACY_FLAGS:
                raise MXNetError(f"dtype {dtname} has no legacy type flag")
            f.write(struct.pack("<IiI", _LEGACY_V2_MAGIC, 0, arr.ndim))
            for d in arr.shape:
                f.write(struct.pack("<q", d))
            f.write(struct.pack("<iii", 1, 0, _LEGACY_FLAGS[dtname]))
            f.write(arr.tobytes())
        f.write(struct.pack("<Q", len(names) if keyed else 0))
        for name in (names if keyed else []):
            b = name.encode()
            f.write(struct.pack("<Q", len(b)))
            f.write(b)


def load(fname: str, ctx=None):
    """The arrays of a native or legacy file: a list, or a dict when the
    file was written from one; on ``ctx`` (default: the CPU)."""
    with open(fname, "rb") as f:
        magic = f.read(8)
        if magic != _MAGIC:
            if (len(magic) == 8
                    and struct.unpack("<Q", magic)[0] == _LEGACY_LIST_MAGIC):
                return _load_legacy(magic + f.read(), ctx)
            raise MXNetError(f"{fname}: not an NDArray file")
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen).decode())
        out = [(e["name"], _from_bytes(f.read(e["nbytes"]), e["dtype"],
                                       tuple(e["shape"]), ctx))
               for e in header["entries"]]
    if header["keyed"]:
        return dict(out)
    return [nd for _, nd in out]
