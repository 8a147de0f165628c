"""RecordIO file format, the port's own copy of ``mxnet_tpu/recordio.py``.

``MXRecordIO``, ``MXIndexedRecordIO``, ``IRHeader``, ``pack`` /
``unpack`` and ``pack_img`` / ``unpack_img``.  The bytes are dmlc's, as
the JAX package writes them: ``[magic 0xced7230a u32][lrecord u32][data]
[pad to 4 B]``, ``lrecord`` holding the length in its low 29 bits and the
continuation flag in its upper 3; a packed record is the ``IfQQ`` header
(flag = the label's float count, label, id, id2), the label's f32 values
when the flag is positive, then the payload; the ``.idx`` sidecar is
``key\tposition`` lines.  A ``.rec`` written by either package reads
back in the other.  Pure Python: no torch here.
"""
from __future__ import annotations

import os
import struct
from collections import namedtuple

import numpy as np

from .base import MXNetError

__all__ = ["MXRecordIO", "MXIndexedRecordIO", "IRHeader", "pack", "unpack",
           "pack_img", "unpack_img"]

_MAGIC = 0xCED7230A
_CFLAG_BITS = 29
_LREC_MASK = (1 << _CFLAG_BITS) - 1

IRHeader = namedtuple("IRHeader", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def _encode_lrec(cflag: int, length: int) -> int:
    return (cflag << _CFLAG_BITS) | length


class MXRecordIO:
    """Sequential RecordIO reader/writer (reference ~L30)."""

    def __init__(self, uri: str, flag: str):
        self.uri = uri
        self.flag = flag
        self.fid = None
        self.open()

    def open(self):
        if self.flag == "w":
            self.fid = open(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            self.fid = open(self.uri, "rb")
            self.writable = False
        else:
            raise MXNetError(f"Invalid flag {self.flag}")
        self.is_open = True

    def close(self):
        if self.is_open:
            self.fid.close()
            self.is_open = False

    def __del__(self):
        try:
            self.close()
        except Exception:
            # interpreter teardown: the file object or its module may
            # already be finalized — nothing actionable at this point
            pass

    def __getstate__(self):
        is_open = self.is_open
        self.close()
        d = dict(self.__dict__)
        d["is_open"] = is_open
        del d["fid"]
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        is_open = d["is_open"]
        self.is_open = False
        self.fid = None
        if is_open:
            self.open()

    def reset(self):
        self.close()
        self.open()

    def write(self, buf: bytes):
        assert self.writable
        header = struct.pack("<II", _MAGIC, _encode_lrec(0, len(buf)))
        self.fid.write(header)
        self.fid.write(buf)
        pad = (4 - len(buf) % 4) % 4
        if pad:
            self.fid.write(b"\x00" * pad)

    def read(self):
        assert not self.writable
        header = self.fid.read(8)
        if len(header) < 8:
            return None
        magic, lrec = struct.unpack("<II", header)
        if magic != _MAGIC:
            raise MXNetError(f"{self.uri}: invalid RecordIO magic {magic:#x}")
        length = lrec & _LREC_MASK
        buf = self.fid.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self.fid.read(pad)
        return buf

    def tell(self):
        return self.fid.tell()


class MXIndexedRecordIO(MXRecordIO):
    """Indexed RecordIO with .idx sidecar (reference ~L150)."""

    def __init__(self, idx_path: str, uri: str, flag: str, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        super().__init__(uri, flag)

    def open(self):
        super().open()
        self.idx = {}
        self.keys = []
        if not self.writable and os.path.isfile(self.idx_path):
            with open(self.idx_path) as fin:
                for line in fin:
                    parts = line.strip().split("\t")
                    if len(parts) < 2:
                        continue
                    key = self.key_type(parts[0])
                    self.idx[key] = int(parts[1])
                    self.keys.append(key)

    def close(self):
        if not self.is_open:
            return
        if self.writable:
            with open(self.idx_path, "w") as fout:
                for key in self.keys:
                    fout.write(f"{key}\t{self.idx[key]}\n")
        super().close()

    def seek(self, idx):
        assert not self.writable
        self.fid.seek(self.idx[idx])

    def read_idx(self, idx):
        self.seek(idx)
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.idx[key] = pos
        self.keys.append(key)


def pack(header: IRHeader, s: bytes) -> bytes:
    """Pack a label header + payload (reference: recordio.py pack)."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        out = struct.pack(_IR_FORMAT, 0, float(header.label), header.id,
                          header.id2)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        out = struct.pack(_IR_FORMAT, label.size, 0.0, header.id, header.id2)
        out += label.tobytes()
    return out + s


def unpack(s: bytes):
    """Unpack a record into (IRHeader, payload)."""
    flag, label, id_, id2 = struct.unpack(_IR_FORMAT, s[:_IR_SIZE])
    s = s[_IR_SIZE:]
    if flag > 0:
        label = np.frombuffer(s[: flag * 4], dtype=np.float32)
        s = s[flag * 4:]
    header = IRHeader(flag, label, id_, id2)
    return header, s


def pack_img(header: IRHeader, img, quality: int = 95, img_fmt: str = ".jpg"):
    """Encode an image array (``image.imencode``) and pack it."""
    from . import image

    encoded = image.imencode(img, img_fmt, quality)
    return pack(header, encoded)


def unpack_img(s: bytes, iscolor: int = -1):
    header, img_bytes = unpack(s)
    from . import image

    img = image.imdecode(img_bytes, 1 if iscolor != 0 else 0, to_ndarray=False)
    return header, img
