"""``io.ImageRecordIter`` of the port against the JAX package's pure-Python
pipeline, on the CPU.

A seeded ``.rec`` / ``.idx`` pair of JPEG images of assorted sizes (smooth
content, labels 0..n-1 and a second label column) is written by the
port's ``recordio`` and ``cv2.imencode``, and read by both iterators with
one preprocessing thread each; the JAX iterator takes its pure-Python
path (``mxnet_tpu.io.native.available`` is patched to False, which
changes nothing in the package).  For the deterministic options (no
shuffle, no random crop or mirror: a center crop, ``resize``, mean / std
/ scale, ``label_width`` 1 and 2, ``round_batch`` on and off, a
``reset``) every batch's data and labels are equal, bit for bit: both
compute in f32 from the same decoded pixels.  The port's last short
batch reports its empty rows in ``pad`` (the JAX one says 0).

With shuffle, random crops and mirrors on three threads: the shapes,
every label once over an epoch, batches in the epoch's order, and every
image either the decoded one or its columns reversed, both seen.
"""
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import recordio
from mxnet_tpu_torch.base import MXNetError

N = 22


def _smooth(rng, h, w):
    """A seeded photo-like image: low-frequency noise upsampled."""
    import cv2

    small = rng.randint(0, 256, (4, 5, 3)).astype(np.uint8)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_CUBIC)


def _write(folder, sizes, seed=0):
    """``folder``/img.rec and img.idx: one JPEG a size, label [i, 100 + i]."""
    import cv2

    rng = np.random.RandomState(seed)
    rec = os.path.join(folder, "img.rec")
    writer = recordio.MXIndexedRecordIO(os.path.join(folder, "img.idx"),
                                        rec, "w")
    for i, (h, w) in enumerate(sizes):
        ok, buf = cv2.imencode(".jpg", _smooth(rng, h, w),
                               [int(cv2.IMWRITE_JPEG_QUALITY), 90])
        assert ok
        header = recordio.IRHeader(0, np.array([i, 100 + i], np.float32), i,
                                   0)
        writer.write_idx(i, recordio.pack(header, buf.tobytes()))
    writer.close()
    return rec


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    rng = np.random.RandomState(5)
    sizes = [(int(rng.randint(20, 40)), int(rng.randint(20, 40)))
             for _ in range(N)]
    return _write(str(tmp_path_factory.mktemp("rec")), sizes)


@pytest.fixture(autouse=True)
def _python_pipeline(monkeypatch):
    from mxnet_tpu.io import native

    monkeypatch.setattr(native, "available", lambda: False)


CASES = {
    "center_crop": dict(data_shape=(3, 24, 24), batch_size=4),
    "resize_normalize": dict(data_shape=(3, 20, 26), batch_size=5,
                             resize=30, mean_r=123.7, mean_g=116.3,
                             mean_b=103.5, std_r=58.4, std_g=57.1,
                             std_b=57.4, scale=0.5, round_batch=False),
    "labels_2": dict(data_shape=(3, 16, 16), batch_size=6, label_width=2,
                     round_batch=False),
    "upscale": dict(data_shape=(3, 36, 36), batch_size=8),
}


def _epoch(it, mx):
    out = []
    for b in it:
        out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_batches_equal_the_jax_pipeline(rec, case):
    kw = dict(CASES[case], preprocess_threads=1)
    jit = jmx.io.ImageRecordIter(path_imgrec=rec, **kw)
    tit = tmx.io.ImageRecordIter(path_imgrec=rec, ctx=tmx.cpu(), **kw)
    assert jit._native is None
    for _ in range(2):  # an epoch, then again after reset
        want, got = _epoch(jit, jmx), _epoch(tit, tmx)
        n = kw["batch_size"]
        assert len(got) == len(want) == (
            N // n if kw.get("round_batch", True) else -(-N // n))
        for (gd, gl, gpad), (wd, wl, _) in zip(got, want):
            assert gd.dtype == np.float32 and gd.shape == wd.shape == (
                (n,) + kw["data_shape"])
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gl, wl)
        short = N % n if not kw.get("round_batch", True) else 0
        assert got[-1][2] == ((n - short) % n)
        jit.reset()
        tit.reset()


def test_shuffled_random_epoch(tmp_path):
    h, w, n = 24, 32, 4
    path = _write(str(tmp_path), [(h, w)] * 16, seed=3)
    it = tmx.io.ImageRecordIter(
        path_imgrec=path, data_shape=(3, h, w), batch_size=n, shuffle=True,
        rand_crop=True, rand_mirror=True, preprocess_threads=3,
        prefetch_buffer=2, seed=7, ctx=tmx.cpu())
    reader = recordio.MXIndexedRecordIO(str(tmp_path / "img.idx"), path, "r")
    decoded = {}
    for k in reader.keys:
        header, buf = recordio.unpack(reader.read_idx(k))
        decoded[int(header.label[0])] = tmx.image.imdecode(
            buf, to_ndarray=False).astype(np.float32).transpose(2, 0, 1)
    for epoch in range(2):
        labels, flips = [], []
        for i, b in enumerate(it):
            data, lab = b.data[0].asnumpy(), b.label[0].asnumpy()
            assert data.shape == (n, 3, h, w) and lab.shape == (n, 1)
            order = [int(v) for v in lab[:, 0]]
            assert order == [int(k) for k in it._batches[i]]
            for img, label in zip(data, order):
                ref = decoded[label]
                plain = np.array_equal(img, ref)
                flipped = np.array_equal(img, ref[:, :, ::-1])
                assert plain or flipped
                flips.append(flipped and not plain)
            labels += order
        assert sorted(labels) == list(range(16))
        assert any(flips) and not all(flips)
        it.reset()


def test_batches_land_on_the_card_by_default(rec):
    import torch

    if torch.cuda.is_available():
        it = tmx.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 8, 8),
                                    batch_size=2)
        assert it.next().data[0].context == tmx.gpu(0)
    else:
        with pytest.raises(MXNetError, match="no CUDA device"):
            tmx.io.ImageRecordIter(path_imgrec=rec, data_shape=(3, 8, 8),
                                   batch_size=2)


def test_a_worker_error_reaches_next(tmp_path):
    path = _write(str(tmp_path), [(20, 20)] * 4)
    with open(path, "r+b") as f:  # spoil the second record's JPEG
        f.seek(os.path.getsize(path) // 2)
        f.write(b"\x00" * 64)
    it = tmx.io.ImageRecordIter(path_imgrec=path, data_shape=(3, 16, 16),
                                batch_size=4, ctx=tmx.cpu())
    with pytest.raises(Exception):
        it.next()


@pytest.mark.parametrize("label_shape", [(6,), (6, 1)])
def test_softmax_ce_loss_takes_the_iterators_labels(label_shape):
    """The iterator's (batch, 1) labels feed ``SoftmaxCrossEntropyLoss``
    as (batch,) ones do, as in the JAX package (its ``pick`` takes
    either)."""
    import torch

    rs = np.random.RandomState(4)
    pred = rs.randn(6, 5).astype(np.float32)
    label = rs.randint(0, 5, label_shape).astype(np.float32)
    want = jmx.gluon.loss.SoftmaxCrossEntropyLoss()(
        jmx.nd.array(pred), jmx.nd.array(label)).asnumpy()
    got = tmx.gluon.loss.SoftmaxCrossEntropyLoss()(
        torch.from_numpy(pred), torch.from_numpy(label)).numpy()
    assert got.shape == want.shape == (6,)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
