"""The port's ``gluon.data`` against the JAX package's, on the CPU.

Datasets (``SimpleDataset``, ``ArrayDataset``, ``transform``,
``transform_first``, ``filter``, ``take``, ``RecordFileDataset``,
``vision.ImageRecordDataset``, the synthetic ``MNIST`` / ``CIFAR``
fallbacks), samplers (under one numpy seed) and ``DataLoader`` give the
JAX package's items and batches exactly, with ``num_workers`` 0 and 2
(process workers through shared memory) and a thread pool; a worker
sees no card (``CUDA_VISIBLE_DEVICES`` empty), and batches land on the
loader's device.  The vision transforms match the JAX ones within 1e-5
of their scale (``Resize``'s antialiased bilinear within 1e-3 of 255).
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import nd as jnd
from mxnet_tpu import recordio as jrec
from mxnet_tpu.gluon import data as jdata
from mxnet_tpu.gluon.data.vision import transforms as jtf
import mxnet_tpu_torch as tm
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.gluon import data as tdata
from mxnet_tpu_torch.gluon.data.vision import transforms as ttf

CPU = tm.cpu()


def _np(x):
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


def _same(got, want):
    got, want = _np(got), _np(want)
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
        return
    np.testing.assert_array_equal(got, want)


def _arrays(n=11):
    rng = np.random.RandomState(0)
    return (rng.rand(n, 3, 4).astype(np.float32),
            rng.randint(0, 5, n).astype(np.int32))


def _double(x, y):
    return x * 2, y


def worker_env(samples):
    """A batchify_fn reporting what a worker process sees."""
    import torch as _torch

    return [np.stack([s[0] for s in samples]),
            np.array([os.environ.get("CUDA_VISIBLE_DEVICES", "unset") == ""
                      and not _torch.cuda.is_available()] * len(samples))]


def test_datasets_match():
    x, y = _arrays()
    t, j = tdata.ArrayDataset(x, y), jdata.ArrayDataset(x, y)
    assert len(t) == len(j) == 11
    for i in (0, 5, 10):
        _same(t[i], j[i])
    _same(tdata.ArrayDataset(list(y))[3], jdata.ArrayDataset(list(y))[3])
    tt, jt = t.transform(_double), j.transform(_double)
    _same(tt[4], jt[4])
    _same(t.transform(_double, lazy=False)[2], jt[2])
    _same(t.transform_first(lambda v: v + 1)[1],
          j.transform_first(lambda v: v + 1)[1])
    _same([v[1] for v in t.filter(lambda v: v[1] > 2)],
          [v[1] for v in j.filter(lambda v: v[1] > 2)])
    assert len(t.take(4)) == len(j.take(4)) == 4
    with pytest.raises(AssertionError):
        tdata.ArrayDataset(x, y[:3])


@pytest.mark.parametrize("last_batch", ["keep", "discard", "rollover"])
def test_samplers_match(last_batch):
    np.random.seed(3)
    t = list(tdata.BatchSampler(tdata.RandomSampler(10), 3, last_batch))
    t2 = tdata.BatchSampler(tdata.SequentialSampler(10, start=2), 4,
                            last_batch)
    np.random.seed(3)
    j = list(jdata.BatchSampler(jdata.RandomSampler(10), 3, last_batch))
    j2 = jdata.BatchSampler(jdata.SequentialSampler(10, start=2), 4,
                            last_batch)
    assert t == j
    assert list(t2) == list(j2) and len(t2) == len(j2)


@pytest.mark.parametrize("workers,thread_pool", [(0, False), (2, False),
                                                 (2, True)],
                         ids=["main", "processes", "threads"])
def test_dataloader_matches(workers, thread_pool):
    x, y = _arrays(13)
    kw = dict(batch_size=4, shuffle=True, last_batch="keep")
    np.random.seed(9)
    tl = tdata.DataLoader(tdata.ArrayDataset(x, y), num_workers=workers,
                          thread_pool=thread_pool, ctx=CPU, **kw)
    got = list(tl)
    np.random.seed(9)
    want = list(jdata.DataLoader(jdata.ArrayDataset(x, y), **kw))
    assert len(tl) == len(got) == len(want) == 4
    _same(got, want)
    for xb, yb in got:
        assert isinstance(xb, nd.NDArray) and xb.context == CPU
        assert yb.dtype == np.int32
    # a second epoch through the same (persistent) pool
    np.random.seed(1)
    again = list(tl)
    np.random.seed(1)
    _same(again, list(jdata.DataLoader(jdata.ArrayDataset(x, y), **kw)))


def test_worker_processes_see_no_card():
    x, y = _arrays(6)
    loader = tdata.DataLoader(tdata.ArrayDataset(x, y), batch_size=3,
                              num_workers=2, batchify_fn=worker_env, ctx=CPU)
    batches = list(loader)
    assert len(batches) == 2
    for xb, flag in batches:
        assert bool(flag.asnumpy().all())
        assert xb.context == CPU


def test_dataloader_argument_checks():
    x, y = _arrays(4)
    ds = tdata.ArrayDataset(x, y)
    with pytest.raises(tm.MXNetError):
        tdata.DataLoader(ds)
    with pytest.raises(tm.MXNetError):
        tdata.DataLoader(ds, batch_size=2, shuffle=True,
                         sampler=tdata.SequentialSampler(4), ctx=CPU)
    with pytest.raises(tm.MXNetError):
        tdata.DataLoader(ds, batch_size=2, ctx=CPU,
                         batch_sampler=tdata.BatchSampler(
                             tdata.SequentialSampler(4), 2))
    out = tdata.default_batchify_fn([(nd.array(x[0], ctx=CPU), 1),
                                     (nd.array(x[1], ctx=CPU), 2)])
    assert out[0].shape == (2, 3, 4) and out[0].context == CPU


def test_record_datasets_match(tmp_path):
    rec, idx = str(tmp_path / "r.rec"), str(tmp_path / "r.idx")
    w = jrec.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(2)
    for i in range(5):
        img = rng.randint(0, 255, (12, 10, 3), np.uint8)
        w.write_idx(i, jrec.pack_img(jrec.IRHeader(0, float(i), i, 0), img))
    w.close()
    t, j = tdata.RecordFileDataset(rec), jdata.RecordFileDataset(rec)
    assert len(t) == len(j) == 5 and t[3] == j[3]
    pytest.importorskip("cv2")
    from mxnet_tpu.gluon.data.vision import ImageRecordDataset as JIRD
    from mxnet_tpu_torch.gluon.data.vision import ImageRecordDataset as TIRD

    ti, ji = TIRD(rec), JIRD(rec)
    for i in (0, 4):
        (tx, ty), (jx, jy) = ti[i], ji[i]
        assert tx.context == CPU
        _same(tx, jx)
        assert ty == jy


@pytest.mark.parametrize("name", ["MNIST", "FashionMNIST", "CIFAR10",
                                  "CIFAR100"])
def test_synthetic_vision_datasets_match(tmp_path, name):
    from mxnet_tpu.gluon.data import vision as jv
    from mxnet_tpu_torch.gluon.data import vision as tv

    for train in (True, False):
        t = getattr(tv, name)(root=str(tmp_path), train=train)
        j = getattr(jv, name)(root=str(tmp_path), train=train)
        assert len(t) == len(j)
        for i in (0, len(j) - 1):
            (tx, ty), (jx, jy) = t[i], j[i]
            assert tx.context == CPU
            _same(tx, jx)
            assert ty == jy


def _hwc(seed=0, h=10, w=12):
    return np.random.RandomState(seed).randint(0, 255, (h, w, 3)).astype(
        np.uint8)


TRANSFORMS = {
    "to_tensor": (lambda m: m.ToTensor(), 0),
    "cast": (lambda m: m.Cast("float16"), 0),
    "normalize": (lambda m: m.Compose([m.ToTensor(), m.Normalize(
        (0.5, 0.4, 0.3), (0.2, 0.25, 0.3))]), 0),
    "center_crop": (lambda m: m.CenterCrop((6, 4)), 0),
    "flip_lr": (lambda m: m.RandomFlipLeftRight(), 0),
    "flip_tb": (lambda m: m.RandomFlipTopBottom(), 0),
    "brightness": (lambda m: m.RandomBrightness(0.3), 1),
    "contrast": (lambda m: m.RandomContrast(0.3), 1),
    "saturation": (lambda m: m.RandomSaturation(0.3), 1),
    "resize_down": (lambda m: m.Resize((7, 5)), 2),
    "resize_up": (lambda m: m.Resize(20), 2),
    "random_resized_crop": (lambda m: m.RandomResizedCrop(8), 2),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches(name):
    make, kind = TRANSFORMS[name]
    img = _hwc().astype(np.float32) if kind else _hwc()
    for seed in (0, 1, 2):
        np.random.seed(seed)
        got = make(ttf)(nd.array(img, ctx=CPU, dtype=img.dtype)).asnumpy()
        np.random.seed(seed)
        want = make(jtf)(jnd.array(img, dtype=img.dtype)).asnumpy()
        assert got.shape == want.shape and got.dtype == want.dtype
        atol = 1e-3 * 255 if kind == 2 else 1e-5 * max(
            float(np.abs(want.astype(np.float64)).max()), 1.0)
        np.testing.assert_allclose(got.astype(np.float64),
                                   want.astype(np.float64), atol=atol)
    # a batch (NHWC) through ToTensor and Resize
    batch = np.stack([_hwc(1), _hwc(2)]).astype(np.float32)
    if name in ("to_tensor", "resize_down"):
        got = make(ttf)(torch.from_numpy(batch)).numpy()
        want = make(jtf)(jnd.array(batch)).asnumpy()
        np.testing.assert_allclose(got, want, atol=1e-3 * 255)
