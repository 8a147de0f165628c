"""The port's ``recordio`` against the JAX package's, byte for byte.

Both packages write the same records (raw payloads, packed records with
a scalar label, with a label vector, with ids, and packed JPEG images)
into .rec/.idx pairs: the files are equal byte for byte, and each
package reads the other's: sequentially, by index, and through
``unpack`` / ``unpack_img`` (decoded pixels equal).  The dmlc framing is
checked against its definition: magic 0xced7230a, the length in the
low 29 bits of ``lrecord``, payloads padded to 4 bytes.
"""
import pickle
import struct

import numpy as np
import pytest

from mxnet_tpu import recordio as jrec
from mxnet_tpu_torch import recordio as trec

cv2 = pytest.importorskip("cv2")


def _records(rec_mod):
    """(key, payload) of a mixed set of records, built by ``rec_mod``."""
    rng = np.random.RandomState(0)
    out = [(0, b""), (1, b"a"), (2, b"abcd"), (3, b"x" * 13)]
    out.append((4, rec_mod.pack(rec_mod.IRHeader(0, 3.5, 7, 9), b"payload")))
    label = rng.uniform(-1, 1, 6).astype(np.float32)
    out.append((5, rec_mod.pack(rec_mod.IRHeader(0, label, 11, 0), b"p" * 5)))
    img = rng.randint(0, 255, (20, 24, 3), np.uint8)
    out.append((6, rec_mod.pack_img(rec_mod.IRHeader(0, 2.0, 12, 0), img,
                                    quality=90)))
    return out


def _write(rec_mod, folder, name):
    rec, idx = str(folder / f"{name}.rec"), str(folder / f"{name}.idx")
    w = rec_mod.MXIndexedRecordIO(idx, rec, "w")
    for key, buf in _records(rec_mod):
        w.write_idx(key, buf)
    w.close()
    return rec, idx


@pytest.mark.parametrize("key", range(7))
def test_packed_records_equal(key):
    assert dict(_records(trec))[key] == dict(_records(jrec))[key]


def test_files_equal_byte_for_byte(tmp_path):
    trec_path, tidx = _write(trec, tmp_path, "port")
    jrec_path, jidx = _write(jrec, tmp_path, "jax")
    assert open(trec_path, "rb").read() == open(jrec_path, "rb").read()
    assert open(tidx).read() == open(jidx).read()


def test_framing_is_dmlc(tmp_path):
    path = str(tmp_path / "f.rec")
    w = trec.MXRecordIO(path, "w")
    for buf in (b"", b"abc", b"abcdefgh"):
        w.write(buf)
    w.close()
    raw = open(path, "rb").read()
    pos, lengths = 0, []
    while pos < len(raw):
        magic, lrec = struct.unpack("<II", raw[pos:pos + 8])
        assert magic == 0xCED7230A
        assert lrec >> 29 == 0
        n = lrec & ((1 << 29) - 1)
        lengths.append(n)
        pos += 8 + n + (4 - n % 4) % 4
    assert lengths == [0, 3, 8] and pos == len(raw) == 8 * 3 + 0 + 4 + 8


@pytest.mark.parametrize("writer,reader", [(jrec, trec), (trec, jrec)],
                         ids=["jax_to_port", "port_to_jax"])
def test_cross_package_reads(tmp_path, writer, reader):
    rec, idx = _write(writer, tmp_path, "w")
    want = _records(writer)
    seq = reader.MXRecordIO(rec, "r")
    for _, buf in want:
        assert seq.read() == buf
    assert seq.read() is None
    seq.close()
    r = reader.MXIndexedRecordIO(idx, rec, "r")
    assert r.keys == [k for k, _ in want]
    for key, buf in reversed(want):
        assert r.read_idx(key) == buf
    h, payload = reader.unpack(r.read_idx(4))
    assert (h.flag, h.label, h.id, h.id2, payload) == (0, 3.5, 7, 9,
                                                       b"payload")
    h, payload = reader.unpack(r.read_idx(5))
    assert h.flag == 6 and payload == b"p" * 5
    np.testing.assert_array_equal(h.label, writer.unpack(want[5][1])[0].label)
    h, img = reader.unpack_img(r.read_idx(6))
    _, want_img = writer.unpack_img(want[6][1])
    assert img.shape == (20, 24, 3)
    np.testing.assert_array_equal(img, want_img)
    r.close()


def test_reader_survives_pickling(tmp_path):
    rec, idx = _write(trec, tmp_path, "p")
    r = trec.MXIndexedRecordIO(idx, rec, "r")
    r2 = pickle.loads(pickle.dumps(r))
    assert r2.read_idx(3) == b"x" * 13
    r.reset()
    assert r.read() == b""


def test_bad_magic_and_flag_raise(tmp_path):
    path = tmp_path / "bad.rec"
    path.write_bytes(struct.pack("<II", 0x12345678, 0))
    r = trec.MXRecordIO(str(path), "r")
    with pytest.raises(trec.MXNetError, match="magic"):
        r.read()
    with pytest.raises(trec.MXNetError, match="flag"):
        trec.MXRecordIO(str(path), "x")
