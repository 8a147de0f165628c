"""Detection image iterator with bbox-aware augmentation, the port's copy
of ``mxnet_tpu/image/detection.py``: the Det* augmenter family
(DetBorrowAug, DetRandomSelectAug, DetHorizontalFlipAug, DetRandomCropAug
with its coverage constraints, DetRandomPadAug), CreateDetAugmenter,
``pack_det_label`` and ImageDetIter, the input path of the SSD-512 /
Faster-RCNN configs (BASELINE config 5).  The augmenters draw from
Python's ``random`` and numpy's global generator in the JAX module's
order; a batch is assembled in numpy and copied once onto the iterator's
device (``ctx``, default the card), as ``ImageIter`` does.

Label convention (the reference's packed det format): a flat label vector
  [header_width A, object_width B, (A-2 extra header values), obj0, obj1...]
where each object is [id, xmin, ymin, xmax, ymax, ...] with coordinates
normalized to [0, 1].  ImageDetIter.next() emits labels shaped
(batch, max_objects, object_width) padded with -1.
"""
from __future__ import annotations

import os
import random as pyrandom
from typing import List, Optional

import numpy as np

from ..base import MXNetError
from . import image as _img

__all__ = ["DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
           "CreateDetAugmenter", "ImageDetIter"]


class DetAugmenter:
    """Base detection augmenter: __call__(src, label) -> (src, label)."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json

        return json.dumps([type(self).__name__, self._kwargs],
                          default=lambda o: o.tolist()
                          if isinstance(o, np.ndarray) else str(o))

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Wrap a pixel-only Augmenter (labels pass through unchanged)."""

    def __init__(self, augmenter):
        super().__init__(augmenter=augmenter.dumps())
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Randomly apply one of `aug_list` (or skip) — reference ~L120."""

    def __init__(self, aug_list, skip_prob=0.0):
        super().__init__(skip_prob=skip_prob)
        self.aug_list = aug_list
        self.skip_prob = skip_prob

    def __call__(self, src, label):
        if pyrandom.random() < self.skip_prob or not self.aug_list:
            return src, label
        return pyrandom.choice(self.aug_list)(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Flip image AND boxes (xmin' = 1-xmax, xmax' = 1-xmin)."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if pyrandom.random() < self.p:
            src = src[:, ::-1]
            label = label.copy()
            tmp = 1.0 - label[:, 3]
            label[:, 3] = 1.0 - label[:, 1]
            label[:, 1] = tmp
        return src, label


def _box_coverage(crop, boxes):
    """Fraction of each box's area covered by `crop` [x0,y0,x1,y1]
    (the reference's object-coverage criterion — NOT IoU: a crop fully
    containing a small box must count as coverage 1.0)."""
    ix = np.maximum(
        0, np.minimum(crop[2], boxes[:, 2]) - np.maximum(crop[0], boxes[:, 0]))
    iy = np.maximum(
        0, np.minimum(crop[3], boxes[:, 3]) - np.maximum(crop[1], boxes[:, 1]))
    inter = ix * iy
    area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    return np.where(area_b > 0, inter / np.maximum(area_b, 1e-12), 0)


class DetRandomCropAug(DetAugmenter):
    """SSD-style constrained random crop (reference ~L200): sample crops
    until one achieves the min IoU with some ground-truth box; objects
    whose centers fall outside the crop are dropped, the rest re-clipped
    and re-normalized."""

    def __init__(self, min_object_covered=0.1, aspect_ratio_range=(0.75, 1.33),
                 area_range=(0.05, 1.0), min_eject_coverage=0.3,
                 max_attempts=50):
        super().__init__(min_object_covered=min_object_covered,
                         area_range=area_range)
        self.min_object_covered = min_object_covered
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.min_eject_coverage = min_eject_coverage
        self.max_attempts = max_attempts

    def _sample_crop(self):
        area = pyrandom.uniform(*self.area_range)
        ratio = pyrandom.uniform(*self.aspect_ratio_range)
        w = min(np.sqrt(area * ratio), 1.0)
        h = min(np.sqrt(area / ratio), 1.0)
        x0 = pyrandom.uniform(0, 1 - w)
        y0 = pyrandom.uniform(0, 1 - h)
        return np.array([x0, y0, x0 + w, y0 + h], np.float32)

    def __call__(self, src, label):
        if label.shape[0] == 0:
            return src, label
        boxes = label[:, 1:5]
        for _ in range(self.max_attempts):
            crop = self._sample_crop()
            coverage = _box_coverage(crop, boxes)
            if coverage.max() < self.min_object_covered:
                continue
            # keep objects whose center lies inside the crop AND that keep
            # at least min_eject_coverage of their area (reference eject
            # rule for heavily clipped boxes)
            cx = (boxes[:, 0] + boxes[:, 2]) / 2
            cy = (boxes[:, 1] + boxes[:, 3]) / 2
            keep = ((cx >= crop[0]) & (cx <= crop[2])
                    & (cy >= crop[1]) & (cy <= crop[3])
                    & (coverage >= self.min_eject_coverage))
            if not keep.any():
                continue
            new_label = label[keep].copy()
            w, h = crop[2] - crop[0], crop[3] - crop[1]
            new_label[:, 1] = np.clip((new_label[:, 1] - crop[0]) / w, 0, 1)
            new_label[:, 3] = np.clip((new_label[:, 3] - crop[0]) / w, 0, 1)
            new_label[:, 2] = np.clip((new_label[:, 2] - crop[1]) / h, 0, 1)
            new_label[:, 4] = np.clip((new_label[:, 4] - crop[1]) / h, 0, 1)
            ih, iw = src.shape[:2]
            x0, y0 = int(crop[0] * iw), int(crop[1] * ih)
            x1, y1 = max(int(crop[2] * iw), x0 + 1), max(int(crop[3] * ih),
                                                         y0 + 1)
            return src[y0:y1, x0:x1], new_label
        return src, label


class DetRandomPadAug(DetAugmenter):
    """Zoom-out: place the image on a larger canvas (reference ~L300)."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33), area_range=(1.0, 3.0),
                 max_attempts=50, pad_val=(127, 127, 127)):
        super().__init__(area_range=area_range)
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.pad_val = pad_val

    def __call__(self, src, label):
        area = pyrandom.uniform(*self.area_range)
        if area <= 1.0:
            return src, label
        h, w = src.shape[:2]
        scale = np.sqrt(area)
        new_h, new_w = int(h * scale), int(w * scale)
        y0 = pyrandom.randint(0, new_h - h)
        x0 = pyrandom.randint(0, new_w - w)
        canvas = np.empty((new_h, new_w, src.shape[2]), src.dtype)
        canvas[...] = np.asarray(self.pad_val, src.dtype)
        canvas[y0:y0 + h, x0:x0 + w] = src
        label = label.copy()
        label[:, 1] = (label[:, 1] * w + x0) / new_w
        label[:, 3] = (label[:, 3] * w + x0) / new_w
        label[:, 2] = (label[:, 2] * h + y0) / new_h
        label[:, 4] = (label[:, 4] * h + y0) / new_h
        return canvas, label


class _DetForceResize(DetAugmenter):
    def __init__(self, size, interp=1):
        super().__init__(size=size)
        self.size = size  # (w, h)
        self.interp = interp

    def __call__(self, src, label):
        return _img.imresize(src, self.size[0], self.size[1],
                             self.interp), label


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=1, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127)):
    """Standard detection augmentation list (reference ~L700)."""
    auglist: List[DetAugmenter] = []
    if resize > 0:
        auglist.append(DetBorrowAug(_img.ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        crop = DetRandomCropAug(min_object_covered, aspect_ratio_range,
                                (area_range[0], min(area_range[1], 1.0)),
                                min_eject_coverage, max_attempts)
        auglist.append(DetRandomSelectAug([crop], 1 - rand_crop))
    if rand_pad > 0:
        pad = DetRandomPadAug(aspect_ratio_range,
                              (max(area_range[0], 1.0), area_range[1]),
                              max_attempts, pad_val)
        auglist.append(DetRandomSelectAug([pad], 1 - rand_pad))
    auglist.append(_DetForceResize((data_shape[2], data_shape[1]),
                                   inter_method))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(
            _img.ColorJitterAug(brightness, contrast, saturation)))
    if hue:
        auglist.append(DetBorrowAug(_img.HueJitterAug(hue)))
    if pca_noise > 0:
        auglist.append(DetBorrowAug(_img.LightingAug(
            pca_noise, eigval=np.array([55.46, 4.794, 1.148]),
            eigvec=np.array([[-0.5675, 0.7192, 0.4009],
                             [-0.5808, -0.0045, -0.8140],
                             [-0.5836, -0.6948, 0.4203]]))))
    if rand_gray > 0:
        auglist.append(DetBorrowAug(_img.RandomGrayAug(rand_gray)))
    if mean is not None or std is not None:
        if mean is True or mean is None:
            mean = np.array([123.68, 116.28, 103.53])
        if std is True or std is None:
            std = np.array([58.395, 57.12, 57.375])
        auglist.append(DetBorrowAug(_img.ColorNormalizeAug(mean, std)))
    auglist.append(DetBorrowAug(_img.CastAug()))
    return auglist


def _parse_det_label(flat: np.ndarray):
    """Unpack the flat packed det label -> (objects, object_width)."""
    flat = np.asarray(flat, np.float32).ravel()
    if flat.size < 2:
        return np.zeros((0, 5), np.float32), 5
    header = int(flat[0])
    obj_w = int(flat[1])
    if header < 2 or obj_w < 5 or flat.size <= header:
        # unpacked form: flat list of 5-wide objects
        obj_w = 5
        n = flat.size // 5
        return flat[: n * 5].reshape(n, 5).copy(), 5
    body = flat[header:]
    n = body.size // obj_w
    objs = body[: n * obj_w].reshape(n, obj_w).copy()
    return objs[objs[:, 0] >= 0], obj_w


def pack_det_label(objects, header_width=2):
    """(N, W) objects -> flat packed label [A, B, objects...]."""
    objects = np.asarray(objects, np.float32)
    obj_w = objects.shape[1] if objects.ndim == 2 else 5
    return np.concatenate([
        np.array([header_width, obj_w], np.float32), objects.ravel()])


class ImageDetIter(_img.ImageIter):
    """Detection iterator (reference: image/detection.py ImageDetIter).

    Yields DataBatch with data (B, C, H, W) and label
    (B, max_objects, object_width) padded with -1.
    """

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root="", shuffle=False,
                 aug_list=None, imglist=None, ctx=None, **kwargs):
        super().__init__(batch_size=batch_size, data_shape=data_shape,
                         path_imgrec=path_imgrec, path_imglist=path_imglist,
                         path_root=path_root, shuffle=shuffle,
                         aug_list=[], imglist=imglist, ctx=ctx, **kwargs)
        self.auglist = (aug_list if aug_list is not None
                        else CreateDetAugmenter(data_shape))
        # scan a few records to size the label pad
        self._max_objects, self._obj_width = self._estimate_label_shape()
        from ..io import DataDesc

        self.provide_label = [DataDesc(
            "label", (batch_size, self._max_objects, self._obj_width))]

    def _estimate_label_shape(self):
        max_obj, obj_w = 1, 5
        for i in range(min(len(self._items), 100)):
            _img_arr, flat = self._read_raw(i)
            objs, w = _parse_det_label(flat)
            max_obj = max(max_obj, objs.shape[0])
            obj_w = max(obj_w, w)
        return max_obj, obj_w

    def _read_raw(self, i):
        from .. import recordio

        if self._records is not None:
            raw = self._records.read_idx(self._items[i])
            header, buf = recordio.unpack(raw)
            img = _img.imdecode(buf, to_ndarray=False)
            flat = np.atleast_1d(np.asarray(header.label, np.float32))
        else:
            flat, path = self._items[i]
            img = _img.imread(path, to_ndarray=False)
        return img, flat

    def next(self):
        if self._cursor >= len(self._order):
            raise StopIteration
        c, h, w = self.data_shape
        batch = np.zeros((self.batch_size, c, h, w), np.float32)
        labels = np.full((self.batch_size, self._max_objects,
                          self._obj_width), -1.0, np.float32)
        pad = 0
        for slot in range(self.batch_size):
            if self._cursor >= len(self._order):
                pad += 1
                continue
            img, flat = self._read_raw(self._order[self._cursor])
            self._cursor += 1
            objs, _ = _parse_det_label(flat)
            for aug in self.auglist:
                img, objs = aug(img, objs)
                from ..ndarray import NDArray

                if isinstance(img, NDArray):
                    img = img.asnumpy()
            if img.shape[:2] != (h, w):
                img = _img.imresize(img, w, h)
                if hasattr(img, "asnumpy"):
                    img = img.asnumpy()
            batch[slot] = np.transpose(np.asarray(img, np.float32), (2, 0, 1))
            n = min(objs.shape[0], self._max_objects)
            if n:
                labels[slot, :n, :objs.shape[1]] = objs[:n]
        return self._batch(batch, labels, pad=pad,
                           provide_data=self.provide_data,
                           provide_label=self.provide_label)

    def draw_next(self, *a, **k):
        raise MXNetError("draw_next requires display support; use next()")

    def reshape(self, data_shape=None, label_shape=None):
        from ..io import DataDesc

        if data_shape is not None:
            self.data_shape = tuple(data_shape)
            self.provide_data = [DataDesc(
                "data", (self.batch_size,) + self.data_shape)]
        if label_shape is not None:
            self._max_objects, self._obj_width = label_shape
            self.provide_label = [DataDesc(
                "label", (self.batch_size,) + tuple(label_shape))]
