"""``ImageRecordIter``, the RecordIO image pipeline: the port's copy of the
pure-Python path of ``mxnet_tpu/io/image_iter.py``.

``preprocess_threads`` worker threads take batches in turn from the
epoch's order (shuffled by the iterator's own ``random.Random(seed)``
with ``shuffle``) and, for each record, read it from the indexed ``.rec``
under a lock, ``imdecode`` it (OpenCV releases the interpreter lock),
``resize_short`` it to ``resize``, crop it to ``data_shape`` (a random
crop with ``rand_crop`` when the image is large enough, else a center
crop, then ``imresize`` if the crop fell short), mirror it with
probability 1/2 under ``rand_mirror`` and run the colour augmenters that
``brightness`` / ``contrast`` / ``saturation`` / ``random_h`` /
``random_s`` / ``random_l`` / ``pca_noise`` map to, as the JAX iterator
does (``image_iter.py:57-75``).  A batch waits in a queue of at most
``prefetch_buffer`` batches.

Departures: ``next`` returns the batches in the epoch's order whatever
the number of threads (the JAX iterator returns them in the order the
threads finish them); a last short batch (``round_batch=False``) reports
its empty rows in ``pad`` (the JAX one says 0).  The workers hand over
the images as HWC (``uint8`` unless a colour augmenter made them float),
and ``next`` makes one copy of the batch onto ``ctx`` (default the card;
pinned, without blocking) and there subtracts the mean, divides by the
std, scales and moves the channels first, in f32 as the JAX iterator's
numpy does, then casts to ``dtype``: (batch, *data_shape) data and
(batch, label_width) f32 labels, empty rows zero.
``shuffle_chunk_size`` and ``shuffle_chunk_seed`` belong to the native
pipeline (``mxnet_tpu/io/native.py``, not ported) and are accepted and
ignored, as the JAX pure-Python path ignores them.
"""
from __future__ import annotations

import os
import random as pyrandom
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..base import MXNetError
from .io import DataBatch, DataDesc, DataIter

__all__ = ["ImageRecordIter"]


class ImageRecordIter(DataIter):
    def __init__(self, path_imgrec=None, path_imgidx=None, data_shape=None,
                 batch_size=1, label_width=1, shuffle=False,
                 shuffle_chunk_size=0, preprocess_threads=4,
                 prefetch_buffer=4, rand_crop=False, rand_mirror=False,
                 resize=0, mean_r=0.0, mean_g=0.0, mean_b=0.0, std_r=1.0,
                 std_g=1.0, std_b=1.0, scale=1.0, seed=0, round_batch=True,
                 brightness=0.0, contrast=0.0, saturation=0.0, random_h=0,
                 random_s=0, random_l=0, pca_noise=0.0, shuffle_chunk_seed=0,
                 ctx=None, dtype="float32", **kwargs):
        from .. import recordio
        from ..context import resolve_device
        from ..image import ColorJitterAug, HueJitterAug, LightingAug
        from ..ndarray.ndarray import dtype_torch

        super().__init__(batch_size)
        if path_imgrec is None or data_shape is None:
            raise MXNetError("path_imgrec and data_shape are required")
        self.ctx = resolve_device(ctx)
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self._shuffle = shuffle
        self._threads = max(1, preprocess_threads)
        self._prefetch = max(1, prefetch_buffer)
        self._rand_crop = rand_crop
        self._rand_mirror = rand_mirror
        self._resize = resize
        self._mean = torch.tensor([mean_r, mean_g, mean_b],
                                  dtype=torch.float32, device=self.ctx)
        self._std = torch.tensor([std_r, std_g, std_b],
                                 dtype=torch.float32, device=self.ctx)
        self._scale = float(scale)
        self._color_augs = []
        b = brightness + random_l / 255.0
        s = saturation + random_s / 255.0
        if b or contrast or s:
            self._color_augs.append(ColorJitterAug(b, contrast, s))
        if random_h:
            self._color_augs.append(HueJitterAug(random_h / 180.0))
        if pca_noise > 0:
            self._color_augs.append(LightingAug(
                pca_noise, eigval=np.array([55.46, 4.794, 1.148]),
                eigvec=np.array([[-0.5675, 0.7192, 0.4009],
                                 [-0.5808, -0.0045, -0.8140],
                                 [-0.5836, -0.6948, 0.4203]])))
        self._dtype = dtype_torch(dtype)
        self._round_batch = round_batch
        self._rng = pyrandom.Random(seed)
        self._lock = threading.Lock()
        self.provide_data = [DataDesc("data",
                                      (batch_size,) + self.data_shape)]
        self.provide_label = [DataDesc("softmax_label",
                                       (batch_size, label_width))]
        if path_imgidx is None:
            path_imgidx = os.path.splitext(path_imgrec)[0] + ".idx"
        self._rec = recordio.MXIndexedRecordIO(path_imgidx, path_imgrec, "r")
        if not self._rec.keys:
            raise MXNetError(f"{path_imgidx}: empty or missing index")
        self._workers: List[threading.Thread] = []
        self._done = threading.Condition()
        self._ready: Dict[int, tuple] = {}
        self._start_epoch()

    # ------------------------------------------------------------------
    def _start_epoch(self):
        self._stop_workers()
        order = list(self._rec.keys)
        if self._shuffle:
            self._rng.shuffle(order)
        n = self.batch_size
        nbatch = (len(order) // n if self._round_batch
                  else (len(order) + n - 1) // n)
        self._batches = [order[i * n:(i + 1) * n] for i in range(nbatch)]
        self._ready = {}
        self._cursor = 0
        self._consumed = 0
        self._error: Optional[BaseException] = None
        self._stop = False
        # a worker holds a slot from taking a batch until ``next`` takes
        # it: at most ``prefetch_buffer`` batches are out at once
        self._slots = threading.Semaphore(self._prefetch)
        self._workers = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(self._threads)]
        for w in self._workers:
            w.start()

    def _stop_workers(self):
        self._stop = True
        for _ in self._workers:
            self._slots.release()
        for w in self._workers:
            w.join()
        self._workers = []

    def _assignment(self):
        with self._lock:
            if self._stop or self._cursor >= len(self._batches):
                return None, None
            i = self._cursor
            self._cursor += 1
            return i, self._batches[i]

    def _worker(self):
        try:
            while True:
                self._slots.acquire()
                i, keys = self._assignment()
                if keys is None:
                    return
                batch = self._batch(keys)
                with self._done:
                    self._ready[i] = batch
                    self._done.notify_all()
        except BaseException as exc:  # noqa: BLE001 - next() re-raises it
            with self._done:
                self._error = exc
                self._done.notify_all()

    def _batch(self, keys):
        """(HWC images, labels, empty rows) of one batch, on the host."""
        from .. import image as img_mod
        from .. import recordio

        c, h, w = self.data_shape
        images = np.zeros((self.batch_size, h, w, c),
                          np.float32 if self._color_augs else np.uint8)
        labels = np.zeros((self.batch_size, self.label_width), np.float32)
        for slot, key in enumerate(keys):
            with self._lock:
                raw = self._rec.read_idx(key)
            header, buf = recordio.unpack(raw)
            img = img_mod.imdecode(buf, to_ndarray=False)
            if self._resize:
                img = img_mod.resize_short(img, self._resize)
            if img.shape[0] != h or img.shape[1] != w:
                if (self._rand_crop and img.shape[0] >= h
                        and img.shape[1] >= w):
                    img = img_mod.random_crop(img, (w, h))[0]
                else:
                    img = img_mod.center_crop(img, (w, h))[0]
                if img.shape[:2] != (h, w):
                    img = img_mod.imresize(img, w, h)
            if self._rand_mirror and self._rng.random() < 0.5:
                img = img[:, ::-1]
            for aug in self._color_augs:
                img = aug(img)
            images[slot] = img
            lab = np.atleast_1d(np.asarray(header.label, np.float32))
            labels[slot, :len(lab)] = lab[:self.label_width]
        return images, labels, self.batch_size - len(keys)

    # ------------------------------------------------------------------
    def reset(self):
        self._start_epoch()

    def iter_next(self):
        return self._consumed < len(self._batches)

    def next(self):
        from ..context import to_device
        from ..ndarray import NDArray

        if self._consumed >= len(self._batches):
            raise StopIteration
        with self._done:
            while self._consumed not in self._ready and self._error is None:
                self._done.wait()
            if self._error is not None:
                raise self._error
            images, labels, pad = self._ready.pop(self._consumed)
        self._consumed += 1
        self._slots.release()
        x = to_device(images, self.ctx).to(torch.float32)
        x = ((x - self._mean) / self._std * self._scale).permute(0, 3, 1, 2)
        data = x.contiguous().to(self._dtype)
        if pad:
            data[self.batch_size - pad:] = 0  # empty rows hold zeros
        return DataBatch(data=[NDArray(data, ctx=self.ctx)],
                         label=[NDArray(to_device(labels, self.ctx),
                                        ctx=self.ctx)],
                         pad=pad, provide_data=self.provide_data,
                         provide_label=self.provide_label)
