"""Image decode and augmentation, the port's copy of
``mxnet_tpu/image/image.py``.

``imdecode`` / ``imencode`` / ``imread`` / ``imresize`` go through OpenCV
(``cv2``, imported at the call), as the JAX module does; the crops,
``color_normalize``, every ``Augmenter`` and ``CreateAugmenter`` work on
HWC numpy arrays on the host and draw from Python's ``random`` and
numpy's global generator in the JAX module's order, so a seeded run gives
the JAX package's pixels.  ``ImageIter`` assembles a batch in numpy and
makes one copy of it onto its device (``ctx``, default the card): from
pinned memory without blocking on a CUDA device.  NDArrays that
``imdecode`` / ``imresize`` return live on ``ctx`` (default the card);
pass ``to_ndarray=False`` for numpy.
"""
from __future__ import annotations

import os
import random as pyrandom
from typing import List, Optional

import numpy as np

from ..base import MXNetError

__all__ = ["imdecode", "imencode", "imread", "imresize", "resize_short",
           "fixed_crop", "center_crop", "random_crop", "color_normalize",
           "CreateAugmenter", "Augmenter", "ResizeAug", "ForceResizeAug",
           "RandomCropAug", "CenterCropAug", "HorizontalFlipAug", "CastAug",
           "BrightnessJitterAug", "ContrastJitterAug", "SaturationJitterAug",
           "HueJitterAug", "ColorJitterAug", "LightingAug", "RandomGrayAug",
           "ColorNormalizeAug", "ImageIter"]


def _cv2():
    import cv2

    return cv2


def _wrap(arr, to_ndarray=True, ctx=None):
    if not to_ndarray:
        return arr
    from .. import ndarray as nd

    return nd.array(arr, ctx=ctx, dtype=arr.dtype)



def imdecode(buf, flag=1, to_rgb=True, to_ndarray=True, ctx=None):
    """Decode an encoded image buffer to HWC uint8 (reference: mx.image.imdecode)."""
    cv2 = _cv2()
    arr = np.frombuffer(buf, dtype=np.uint8)
    img = cv2.imdecode(arr, cv2.IMREAD_COLOR if flag else
                       cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise MXNetError("imdecode failed: invalid image data")
    if flag and to_rgb:
        img = img[:, :, ::-1]
    if not flag:
        img = img[:, :, None]
    return _wrap(np.ascontiguousarray(img), to_ndarray, ctx)


def imencode(img, fmt=".jpg", quality=95):
    cv2 = _cv2()
    from ..ndarray import NDArray

    if isinstance(img, NDArray):
        img = img.asnumpy()
    bgr = img[:, :, ::-1] if img.shape[-1] == 3 else img
    params = [int(cv2.IMWRITE_JPEG_QUALITY), quality] if fmt in (".jpg", ".jpeg") else []
    ok, enc = cv2.imencode(fmt, bgr, params)
    if not ok:
        raise MXNetError("imencode failed")
    return enc.tobytes()


def imread(filename, flag=1, to_rgb=True, to_ndarray=True, ctx=None):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag, to_rgb, to_ndarray, ctx)


def imresize(src, w, h, interp=1):
    cv2 = _cv2()
    from ..ndarray import NDArray

    arr = src.asnumpy() if isinstance(src, NDArray) else src
    out = cv2.resize(arr, (w, h), interpolation=interp)
    if out.ndim == 2:
        out = out[:, :, None]
    return _wrap(out, isinstance(src, NDArray),
                 src.context if isinstance(src, NDArray) else None)


def resize_short(src, size, interp=2):
    from ..ndarray import NDArray

    arr = src.asnumpy() if isinstance(src, NDArray) else src
    h, w = arr.shape[:2]
    if h > w:
        new_w, new_h = size, int(size * h / w)
    else:
        new_w, new_h = int(size * w / h), size
    return imresize(src, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = src[y0: y0 + h, x0: x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp)
    return out


def center_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = size
    x0 = max((w - new_w) // 2, 0)
    y0 = max((h - new_h) // 2, 0)
    return fixed_crop(src, x0, y0, min(new_w, w), min(new_h, h), size,
                      interp), (x0, y0, new_w, new_h)


def random_crop(src, size, interp=2):
    h, w = src.shape[:2]
    new_w, new_h = min(size[0], w), min(size[1], h)
    x0 = pyrandom.randint(0, w - new_w)
    y0 = pyrandom.randint(0, h - new_h)
    return fixed_crop(src, x0, y0, new_w, new_h, size, interp), \
        (x0, y0, new_w, new_h)


def random_size_crop(src, size, area, ratio, interp=2):
    """Random crop with size/aspect jitter then resize (reference:
    image.py random_size_crop — the Inception/ResNet train crop)."""
    import math

    h, w = src.shape[:2]
    src_area = h * w
    if isinstance(area, (int, float)):
        area = (area, 1.0)
    for _ in range(10):
        target_area = pyrandom.uniform(area[0], area[1]) * src_area
        log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
        new_ratio = math.exp(pyrandom.uniform(*log_ratio))
        new_w = int(round(math.sqrt(target_area * new_ratio)))
        new_h = int(round(math.sqrt(target_area / new_ratio)))
        if new_w <= w and new_h <= h:
            x0 = pyrandom.randint(0, w - new_w)
            y0 = pyrandom.randint(0, h - new_h)
            return fixed_crop(src, x0, y0, new_w, new_h, size, interp), \
                (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


def color_normalize(src, mean, std=None):
    src = src - mean
    if std is not None:
        src = src / std
    return src


class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json

        # mean/std kwargs are ndarrays (reference: image.py Augmenter.dumps
        # converts them via tolist())
        return json.dumps([type(self).__name__, self._kwargs],
                          default=lambda o: o.tolist()
                          if isinstance(o, np.ndarray) else str(o))

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    """Random size + aspect crop (reference RandomSizedCropAug)."""

    def __init__(self, size, area, ratio, interp=2):
        super().__init__(size=size, area=area, ratio=ratio, interp=interp)
        self.size = size
        self.area = area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return random_size_crop(src, self.size, self.area, self.ratio,
                                self.interp)[0]


class RandomOrderAug(Augmenter):
    """Apply child augmenters in random order (reference RandomOrderAug)."""

    def __init__(self, ts):
        super().__init__()
        self.ts = list(ts)

    def dumps(self):
        """Embed child dumps (reference overrides dumps the same way)."""
        import json

        return json.dumps(["RandomOrderAug",
                           [json.loads(t.dumps()) for t in self.ts]])

    def __call__(self, src):
        order = list(self.ts)
        pyrandom.shuffle(order)
        for t in order:
            src = t(src)
        return src


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            return src[:, ::-1]
        return src


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        from ..ndarray.ndarray import NDArray, dtype_torch

        if isinstance(src, NDArray):
            return NDArray(src.data.to(dtype_torch(self.typ)),
                           ctx=src.context)
        return src.astype(self.typ)


def _as_float(src):
    return np.asarray(src, np.float32)


class BrightnessJitterAug(Augmenter):
    """src *= 1 + U(-b, b) (reference: image.py BrightnessJitterAug)."""

    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.brightness, self.brightness)
        return _as_float(src) * alpha


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast
        self._coef = np.array([[[0.299, 0.587, 0.114]]], np.float32)

    def __call__(self, src):
        src = _as_float(src)
        alpha = 1.0 + pyrandom.uniform(-self.contrast, self.contrast)
        gray = (src * self._coef).sum(axis=2, keepdims=True)
        return src * alpha + gray.mean() * (1 - alpha)


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation
        self._coef = np.array([[[0.299, 0.587, 0.114]]], np.float32)

    def __call__(self, src):
        src = _as_float(src)
        alpha = 1.0 + pyrandom.uniform(-self.saturation, self.saturation)
        gray = (src * self._coef).sum(axis=2, keepdims=True)
        return src * alpha + gray * (1 - alpha)


class HueJitterAug(Augmenter):
    """Rotate RGB about the gray axis by U(-hue, hue)*180deg (reference:
    image.py HueJitterAug yiq-rotation formulation)."""

    def __init__(self, hue):
        super().__init__(hue=hue)
        self.hue = hue
        self._tyiq = np.array([[0.299, 0.587, 0.114],
                               [0.596, -0.274, -0.321],
                               [0.211, -0.523, 0.311]], np.float32)
        self._ityiq = np.array([[1.0, 0.956, 0.621],
                                [1.0, -0.272, -0.647],
                                [1.0, -1.107, 1.705]], np.float32)

    def __call__(self, src):
        src = _as_float(src)
        alpha = pyrandom.uniform(-self.hue, self.hue)
        u, w = np.cos(alpha * np.pi), np.sin(alpha * np.pi)
        bt = np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]],
                      np.float32)
        t = self._ityiq @ bt @ self._tyiq
        return src @ t.T


class ColorJitterAug(Augmenter):
    def __init__(self, brightness, contrast, saturation):
        super().__init__(brightness=brightness, contrast=contrast,
                         saturation=saturation)
        self._augs = [a for a in (
            BrightnessJitterAug(brightness) if brightness else None,
            ContrastJitterAug(contrast) if contrast else None,
            SaturationJitterAug(saturation) if saturation else None) if a]

    def __call__(self, src):
        augs = list(self._augs)
        pyrandom.shuffle(augs)
        for a in augs:
            src = a(src)
        return src


class LightingAug(Augmenter):
    """PCA lighting noise (reference: image.py LightingAug / AlexNet)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, size=(3,)).astype(np.float32)
        rgb = (self.eigvec * alpha * self.eigval).sum(axis=1)
        return _as_float(src) + rgb.reshape(1, 1, 3)


class RandomGrayAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p
        self._coef = np.array([[[0.299, 0.587, 0.114]]], np.float32)

    def __call__(self, src):
        if pyrandom.random() < self.p:
            gray = (_as_float(src) * self._coef).sum(axis=2, keepdims=True)
            return np.broadcast_to(gray, src.shape).copy()
        return src


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32) if std is not None else None

    def __call__(self, src):
        return color_normalize(_as_float(src), self.mean, self.std)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Build the standard augmentation list (reference ~L800)."""
    auglist: List[Augmenter] = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        # Inception-style random area+aspect crop (implies rand_crop)
        auglist.append(RandomSizedCropAug(crop_size, (0.08, 1.0),
                                          (3 / 4.0, 4 / 3.0), inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        auglist.append(LightingAug(
            pca_noise,
            eigval=np.array([55.46, 4.794, 1.148]),
            eigvec=np.array([[-0.5675, 0.7192, 0.4009],
                             [-0.5808, -0.0045, -0.8140],
                             [-0.5836, -0.6948, 0.4203]])))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is not None or std is not None:
        if mean is True or mean is None:
            mean = np.array([123.68, 116.28, 103.53])
        if std is True or std is None:
            std = np.array([58.395, 57.12, 57.375])
        if mean is not False:
            auglist.append(ColorNormalizeAug(mean, std))
    auglist.append(CastAug())
    return auglist


class ImageIter:
    """Python image iterator over .rec or .lst files (reference ~L1000);
    batches land on ``ctx`` (default the card)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root="",
                 shuffle=False, aug_list=None, imglist=None, ctx=None,
                 **kwargs):
        from ..context import resolve_device
        from ..io import DataDesc

        self.ctx = resolve_device(ctx)
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._shuffle = shuffle
        self.auglist = aug_list if aug_list is not None else []
        self._records = None
        self._items = []
        if path_imgrec:
            from .. import recordio

            idx = os.path.splitext(path_imgrec)[0] + ".idx"
            self._records = recordio.MXIndexedRecordIO(idx, path_imgrec, "r")
            self._items = list(self._records.keys)
        elif path_imglist or imglist is not None:
            if path_imglist:
                with open(path_imglist) as fin:
                    for line in fin:
                        parts = line.strip().split("\t")
                        label = np.array(parts[1:-1], dtype=np.float32)
                        self._items.append((label, os.path.join(path_root,
                                                                parts[-1])))
            else:
                for entry in imglist:
                    self._items.append((np.asarray(entry[:-1], np.float32),
                                        os.path.join(path_root, entry[-1])))
        else:
            raise MXNetError("need path_imgrec, path_imglist, or imglist")
        self.provide_data = [DataDesc("data",
                                      (batch_size,) + self.data_shape)]
        self.provide_label = [DataDesc("softmax_label",
                                       (batch_size, label_width))]
        self.reset()

    def reset(self):
        self._order = list(range(len(self._items)))
        if self._shuffle:
            pyrandom.shuffle(self._order)
        self._cursor = 0

    def _read_one(self, i):
        from .. import recordio

        if self._records is not None:
            raw = self._records.read_idx(self._items[i])
            header, buf = recordio.unpack(raw)
            img = imdecode(buf, to_ndarray=False)
            label = np.atleast_1d(np.asarray(header.label, np.float32))
        else:
            label, path = self._items[i]
            img = imread(path, to_ndarray=False)
            label = np.atleast_1d(label)
        for aug in self.auglist:
            img = aug(img)
            from ..ndarray import NDArray

            if isinstance(img, NDArray):
                img = img.asnumpy()
        return img, label

    def _batch(self, batch, labels, **kw):
        """The host arrays as a DataBatch on ``ctx``."""
        from ..context import to_device
        from ..io import DataBatch
        from ..ndarray import NDArray

        return DataBatch(data=[NDArray(to_device(batch, self.ctx),
                                       ctx=self.ctx)],
                         label=[NDArray(to_device(labels, self.ctx),
                                        ctx=self.ctx)], **kw)

    def next(self):
        if self._cursor >= len(self._order):
            raise StopIteration
        c, h, w = self.data_shape
        batch = np.zeros((self.batch_size, c, h, w), np.float32)
        labels = np.zeros((self.batch_size, self.label_width), np.float32)
        pad = 0
        for slot in range(self.batch_size):
            if self._cursor >= len(self._order):
                pad += 1
                continue
            img, label = self._read_one(self._order[self._cursor])
            self._cursor += 1
            if img.shape[:2] != (h, w):
                img = imresize(img, w, h)
            batch[slot] = np.transpose(img.astype(np.float32), (2, 0, 1))
            labels[slot, :len(label)] = label[: self.label_width]
        return self._batch(batch, labels, pad=pad)

    def __next__(self):
        return self.next()

    def __iter__(self):
        return self
