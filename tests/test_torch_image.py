"""The port's ``image`` module against the JAX package's, on the CPU.

Decode, encode and resize go through the same OpenCV calls, so they are
equal byte for byte.  Every augmenter is run in both packages on the
same image after the same seeds of Python's ``random`` and numpy's
global generator: the outputs are equal (float ones within 1e-5 of
their scale, the same float32 expressions), and so are the generators'
states afterwards, so the draws were the same in number and order.
``ImageIter`` over one .rec, shuffled under one seed, gives the JAX
iterator's batches; a batch is one copy onto the iterator's device.
"""
import random

import numpy as np
import pytest
import torch

from mxnet_tpu import image as jimg
from mxnet_tpu import nd as jnd
from mxnet_tpu import recordio as jrec
import mxnet_tpu_torch as tm
from mxnet_tpu_torch import image as timg
from mxnet_tpu_torch import nd

cv2 = pytest.importorskip("cv2")
CPU = tm.cpu()


def _img(h=40, w=52, seed=0):
    return np.random.RandomState(seed).randint(0, 255, (h, w, 3), np.uint8)


def test_decode_encode_resize_equal():
    img = _img()
    buf = timg.imencode(img, ".jpg", 85)
    assert buf == jimg.imencode(img, ".jpg", 85)
    assert timg.imencode(img, ".png") == jimg.imencode(img, ".png")
    for flag in (1, 0):
        got = timg.imdecode(buf, flag, to_ndarray=False)
        want = jimg.imdecode(buf, flag, to_ndarray=False)
        np.testing.assert_array_equal(got, want)
    arr = timg.imdecode(buf, ctx=CPU)
    assert isinstance(arr, nd.NDArray) and arr.context == CPU
    np.testing.assert_array_equal(arr.asnumpy(), jimg.imdecode(buf).asnumpy())
    np.testing.assert_array_equal(timg.imresize(img, 17, 23, 1),
                                  jimg.imresize(img, 17, 23, 1))
    out = timg.imresize(nd.array(img, ctx=CPU, dtype=np.uint8), 9, 7)
    assert isinstance(out, nd.NDArray) and out.shape == (7, 9, 3)
    np.testing.assert_array_equal(timg.resize_short(img, 30),
                                  jimg.resize_short(img, 30))
    with pytest.raises(tm.MXNetError):
        timg.imdecode(b"not an image", to_ndarray=False)


AUGS = {
    "resize": lambda m: m.ResizeAug(30),
    "force_resize": lambda m: m.ForceResizeAug((20, 24)),
    "random_crop": lambda m: m.RandomCropAug((32, 24)),
    "center_crop": lambda m: m.CenterCropAug((32, 24)),
    "random_sized_crop": lambda m: m.RandomSizedCropAug((24, 24), (0.08, 1.0),
                                                        (0.75, 1.33)),
    "flip": lambda m: m.HorizontalFlipAug(0.5),
    "cast": lambda m: m.CastAug(),
    "brightness": lambda m: m.BrightnessJitterAug(0.3),
    "contrast": lambda m: m.ContrastJitterAug(0.3),
    "saturation": lambda m: m.SaturationJitterAug(0.3),
    "hue": lambda m: m.HueJitterAug(0.2),
    "color_jitter": lambda m: m.ColorJitterAug(0.3, 0.3, 0.3),
    "lighting": lambda m: m.LightingAug(0.1, np.array([55.46, 4.794, 1.148]),
                                        np.array([[-0.5675, 0.7192, 0.4009],
                                                  [-0.5808, -0.0045, -0.814],
                                                  [-0.5836, -0.6948,
                                                   0.4203]])),
    "gray": lambda m: m.RandomGrayAug(0.5),
    "normalize": lambda m: m.ColorNormalizeAug(
        np.array([123.68, 116.28, 103.53]), np.array([58.395, 57.12, 57.375])),
    "random_order": lambda m: m.RandomOrderAug(
        [m.BrightnessJitterAug(0.2), m.ContrastJitterAug(0.2),
         m.HorizontalFlipAug(0.5)]),
}


def _run(mod, make, img, seed, reps=4):
    random.seed(seed)
    np.random.seed(seed)
    aug = make(mod)
    outs = [np.asarray(aug(img.copy())) for _ in range(reps)]
    return outs, aug, random.getstate(), np.random.get_state()[1].copy()


@pytest.mark.parametrize("name", sorted(AUGS))
def test_augmenter_matches_under_one_seed(name):
    img = _img()
    got, taug, tpy, tnp = _run(timg, AUGS[name], img, 3)
    want, jaug, jpy, jnp_ = _run(jimg, AUGS[name], img, 3)
    assert tpy == jpy
    np.testing.assert_array_equal(tnp, jnp_)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        scale = max(float(np.abs(w).max()), 1.0)
        np.testing.assert_allclose(g.astype(np.float64), w.astype(np.float64),
                                   atol=1e-5 * scale)
    assert taug.dumps() == jaug.dumps()


@pytest.mark.parametrize("kw", [
    dict(),
    dict(resize=40, rand_crop=True, rand_mirror=True, mean=True, std=True),
    dict(rand_resize=True, brightness=0.2, contrast=0.2, saturation=0.2,
         hue=0.1, pca_noise=0.1, rand_gray=0.2, mean=np.array([1.0, 2, 3])),
])
def test_create_augmenter_lists_match(kw):
    got = timg.CreateAugmenter((3, 24, 24), **kw)
    want = jimg.CreateAugmenter((3, 24, 24), **kw)
    assert [a.dumps() for a in got] == [a.dumps() for a in want]
    img = _img()
    for seed in (0, 1):
        random.seed(seed)
        np.random.seed(seed)
        t = img
        for a in got:
            t = a(t)
        random.seed(seed)
        np.random.seed(seed)
        j = img
        for a in want:
            j = a(j)
        np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=1e-3)


def _rec(tmp_path, n=7):
    rec, idx = str(tmp_path / "i.rec"), str(tmp_path / "i.idx")
    w = jrec.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(4)
    for i in range(n):
        img = rng.randint(0, 255, (28 + i, 30, 3), np.uint8)
        label = np.array([i, i * 0.5], np.float32)
        w.write_idx(i, jrec.pack_img(jrec.IRHeader(0, label, i, 0), img))
    w.close()
    return rec


def test_image_iter_matches(tmp_path):
    rec = _rec(tmp_path)
    kw = dict(batch_size=3, data_shape=(3, 24, 24), label_width=2,
              path_imgrec=rec, shuffle=True)
    random.seed(5)
    np.random.seed(5)
    tit = timg.ImageIter(aug_list=timg.CreateAugmenter(
        (3, 24, 24), rand_crop=True, rand_mirror=True), ctx=CPU, **kw)
    tb = [(b.data[0], b.label[0], b.pad) for b in tit]
    random.seed(5)
    np.random.seed(5)
    jit_ = jimg.ImageIter(aug_list=jimg.CreateAugmenter(
        (3, 24, 24), rand_crop=True, rand_mirror=True), **kw)
    jb = [(b.data[0], b.label[0], b.pad) for b in jit_]
    assert len(tb) == len(jb) == 3
    for (td, tl, tp), (jd, jl, jp) in zip(tb, jb):
        assert td.context == CPU and td.dtype == np.float32
        np.testing.assert_array_equal(td.asnumpy(), jd.asnumpy())
        np.testing.assert_array_equal(tl.asnumpy(), jl.asnumpy())
        assert tp == jp
    assert tit.provide_data[0].shape == (3, 3, 24, 24)
    with pytest.raises(StopIteration):
        tit.next()
    tit.reset()
    assert next(tit).data[0].shape == (3, 3, 24, 24)


def test_to_device_is_one_copy():
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    t = tm.context.to_device(arr, torch.device("cpu"))
    assert t.dtype == torch.float32 and t.shape == (3, 4)
    np.testing.assert_array_equal(t.numpy(), arr)
