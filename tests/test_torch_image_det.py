"""The port's detection pipeline (``mxnet_tpu_torch/image/detection.py``)
against the JAX package's, on the CPU.

Each bbox-aware augmenter runs in both packages on the same image and
boxes after the same seeds of Python's ``random`` and numpy's global
generator: pixels and boxes equal (float pixels within 1e-5 of their
scale), and the generators in the same state afterwards.  Labels pack
and parse alike.  ``ImageDetIter`` over one .rec (written by the JAX
package) with ``CreateDetAugmenter`` as ``examples/train_detection.py``
builds it, and with every augmenter on, shuffled under one seed, gives
the JAX iterator's batches, batch for batch, labels padded with -1;
``reshape`` behaves alike.  Skipped without ``cv2``, as
``tests/test_image_det.py`` is.
"""
import random

import numpy as np
import pytest

from mxnet_tpu import image as jimg
from mxnet_tpu import recordio as jrec
from mxnet_tpu.image import detection as jdet
import mxnet_tpu_torch as tm
from mxnet_tpu_torch import image as timg
from mxnet_tpu_torch.image import detection as tdet

cv2 = pytest.importorskip("cv2")
CPU = tm.cpu()


def _objs(rng, n=3):
    xy = rng.uniform(0, 0.6, (n, 2))
    wh = rng.uniform(0.1, 0.4, (n, 2))
    return np.concatenate([rng.randint(0, 5, (n, 1)), xy, xy + wh],
                          1).astype(np.float32)


AUGS = {
    "flip": lambda m, i: m.DetHorizontalFlipAug(0.5),
    "crop": lambda m, i: m.DetRandomCropAug(),
    "crop_strict": lambda m, i: m.DetRandomCropAug(
        min_object_covered=0.7, area_range=(0.1, 0.5), max_attempts=5),
    "pad": lambda m, i: m.DetRandomPadAug(),
    "select": lambda m, i: m.DetRandomSelectAug(
        [m.DetRandomCropAug(), m.DetRandomPadAug()], skip_prob=0.3),
    "borrow": lambda m, i: m.DetBorrowAug(i.ColorJitterAug(0.2, 0.2, 0.2)),
    "force_resize": lambda m, i: m._DetForceResize((20, 26)),
}


@pytest.mark.parametrize("name", sorted(AUGS))
def test_det_augmenter_matches_under_one_seed(name):
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (36, 44, 3), np.uint8)
    out = {}
    for key, mod, imod in (("port", tdet, timg), ("jax", jdet, jimg)):
        random.seed(7)
        np.random.seed(7)
        aug = AUGS[name](mod, imod)
        lab = _objs(np.random.RandomState(1))
        res = []
        for _ in range(5):
            src, lab2 = aug(img.copy(), lab.copy())
            res.append((np.asarray(src), lab2))
        out[key] = (res, random.getstate(), np.random.get_state()[1].copy(),
                    aug.dumps())
    (got, tpy, tnp, tdump), (want, jpy, jnp_, jdump) = out["port"], out["jax"]
    assert tpy == jpy and tdump == jdump
    np.testing.assert_array_equal(tnp, jnp_)
    for (gs, gl), (ws, wl) in zip(got, want):
        assert gs.shape == ws.shape and gs.dtype == ws.dtype
        np.testing.assert_allclose(gs.astype(np.float64),
                                   ws.astype(np.float64),
                                   atol=1e-5 * max(float(np.abs(ws).max()), 1))
        np.testing.assert_array_equal(gl, wl)


def test_pack_and_parse_match():
    objs = _objs(np.random.RandomState(2), 4)
    flat = tdet.pack_det_label(objs)
    np.testing.assert_array_equal(flat, jdet.pack_det_label(objs))
    for f in (flat, flat[2:], np.concatenate([[4, 6, 0, 0], np.concatenate(
            [objs, np.ones((4, 1), np.float32)], 1).ravel()]),
              np.array([1.0]), np.concatenate([[2, 5], [-1, 0, 0, 1, 1],
                                               objs[0]])):
        got, gw = tdet._parse_det_label(f)
        want, ww = jdet._parse_det_label(f)
        assert gw == ww
        np.testing.assert_array_equal(got, want)


def _det_rec(tmp_path, n=9):
    rec, idx = str(tmp_path / "d.rec"), str(tmp_path / "d.idx")
    w = jrec.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(3)
    for i in range(n):
        img = cv2.resize(rng.randint(0, 255, (6, 6, 3), np.uint8),
                         (40 + 2 * i, 40), interpolation=cv2.INTER_LINEAR)
        objs = _objs(rng, 1 + i % 4)
        w.write_idx(i, jrec.pack_img(jrec.IRHeader(
            0, jdet.pack_det_label(objs), i, 0), img, quality=90))
    w.close()
    return rec


@pytest.mark.parametrize("aug_kw", [
    dict(rand_mirror=True, rand_crop=0.5, mean=True, std=True),
    dict(rand_mirror=True, rand_crop=0.7, rand_pad=0.5, brightness=0.2,
         contrast=0.2, saturation=0.2, hue=0.1, pca_noise=0.1, rand_gray=0.3,
         mean=True, std=True),
], ids=["train_detection", "every_augmenter"])
def test_image_det_iter_matches_batch_for_batch(tmp_path, aug_kw):
    rec = _det_rec(tmp_path)
    shape = (3, 32, 32)
    batches = {}
    for key, mod, kw in (("port", tdet, dict(ctx=CPU)), ("jax", jdet, {})):
        random.seed(11)
        np.random.seed(11)
        it = mod.ImageDetIter(batch_size=4, data_shape=shape,
                              path_imgrec=rec, shuffle=True,
                              aug_list=mod.CreateDetAugmenter(shape, **aug_kw),
                              **kw)
        batches[key] = ([(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                         for b in it], it)
    (got, tit), (want, jit_) = batches["port"], batches["jax"]
    assert len(got) == len(want) == 3
    assert tit.provide_label[0].shape == jit_.provide_label[0].shape \
        == (4, 4, 5)
    for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
        np.testing.assert_allclose(gd, wd, atol=1e-4)
        np.testing.assert_array_equal(gl, wl)
        assert gp == wp
    assert (want[-1][1] == -1).any()          # the -1 label padding is real
    assert want[-1][2] == 3                   # 9 images, batch 4: pad 3


def test_image_det_iter_default_augmenters_and_reshape(tmp_path):
    rec = _det_rec(tmp_path, n=4)
    it = tdet.ImageDetIter(batch_size=2, data_shape=(3, 16, 16),
                           path_imgrec=rec, ctx=CPU)
    jit_ = jdet.ImageDetIter(batch_size=2, data_shape=(3, 16, 16),
                             path_imgrec=rec)
    assert [a.dumps() for a in it.auglist] == [a.dumps()
                                                for a in jit_.auglist]
    b = it.next()
    assert b.data[0].context == CPU
    np.testing.assert_allclose(b.data[0].asnumpy(),
                               jit_.next().data[0].asnumpy(), atol=1e-4)
    for i in (it, jit_):
        i.reshape(data_shape=(3, 20, 20), label_shape=(6, 5))
    assert it.provide_data[0].shape == jit_.provide_data[0].shape
    assert it.provide_label[0].shape == jit_.provide_label[0].shape
    it.reset()
    jit_.reset()
    np.testing.assert_array_equal(it.next().label[0].asnumpy(),
                                  jit_.next().label[0].asnumpy())
    with pytest.raises(tm.MXNetError):
        it.draw_next()
