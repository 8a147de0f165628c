"""Vision datasets, the port's copy of
``mxnet_tpu/gluon/data/vision/datasets.py`` (reference:
gluon/data/vision/datasets.py ~L1-400).  Items are host (CPU) NDArrays; a
``DataLoader`` moves whole batches to its device.

Zero-egress environment: datasets read from local files only (standard
IDX/pickle formats); if files are absent a deterministic synthetic fallback
with the same shapes/dtypes is generated so training scripts and tests run
anywhere.  The download(...) helpers of the reference are intentionally not
reproduced.
"""
from __future__ import annotations

import gzip
import os
import struct
from typing import Optional

import numpy as np

from ..dataset import ArrayDataset, Dataset


class _DownloadedDataset(Dataset):
    def __init__(self, root, train, transform):
        self._transform = transform
        self._train = train
        self._root = os.path.expanduser(root)
        self._data = None
        self._label = None
        self._get_data()

    def __getitem__(self, idx):
        from .... import ndarray as nd
        from ....context import cpu

        x = nd.array(self._data[idx], ctx=cpu(), dtype=self._data.dtype)
        y = self._label[idx]
        if self._transform is not None:
            return self._transform(x, y)
        return x, y

    def __len__(self):
        return len(self._label)

    def _get_data(self):
        raise NotImplementedError


def _synthetic(num, shape, num_classes, seed):
    rng = np.random.RandomState(seed)
    data = (rng.rand(num, *shape) * 255).astype(np.uint8)
    label = rng.randint(0, num_classes, num).astype(np.int32)
    return data, label


class MNIST(_DownloadedDataset):
    """MNIST from local IDX files, or synthetic fallback (28x28x1 uint8)."""

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "mnist"),
                 train=True, transform=None):
        self._train_data = ("train-images-idx3-ubyte.gz",
                            "train-labels-idx1-ubyte.gz")
        self._test_data = ("t10k-images-idx3-ubyte.gz",
                           "t10k-labels-idx1-ubyte.gz")
        self._num_synthetic = 2048
        super().__init__(root, train, transform)

    def _get_data(self):
        images, labels = self._train_data if self._train else self._test_data
        image_path = os.path.join(self._root, images)
        label_path = os.path.join(self._root, labels)
        if os.path.exists(image_path) and os.path.exists(label_path):
            with gzip.open(label_path, "rb") as fin:
                struct.unpack(">II", fin.read(8))
                label = np.frombuffer(fin.read(), dtype=np.uint8).astype(np.int32)
            with gzip.open(image_path, "rb") as fin:
                _, num, rows, cols = struct.unpack(">IIII", fin.read(16))
                data = np.frombuffer(fin.read(), dtype=np.uint8)
                data = data.reshape(num, rows, cols, 1)
        else:
            data, label = _synthetic(self._num_synthetic, (28, 28, 1), 10,
                                     seed=42 if self._train else 43)
        self._data = data
        self._label = label


class FashionMNIST(MNIST):
    def __init__(self, root=os.path.join("~", ".mxnet", "datasets",
                                         "fashion-mnist"), train=True,
                 transform=None):
        super().__init__(root, train, transform)


class CIFAR10(_DownloadedDataset):
    """CIFAR10 from local binary batches, or synthetic fallback (32x32x3)."""

    _num_classes = 10

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar10"),
                 train=True, transform=None):
        self._num_synthetic = 2048
        super().__init__(root, train, transform)

    def _get_data(self):
        files = ([f"data_batch_{i}.bin" for i in range(1, 6)] if self._train
                 else ["test_batch.bin"])
        paths = [os.path.join(self._root, f) for f in files]
        if all(os.path.exists(p) for p in paths):
            data_list, label_list = [], []
            row = 1 + 32 * 32 * 3 if self._num_classes == 10 else 2 + 32 * 32 * 3
            for path in paths:
                raw = np.fromfile(path, dtype=np.uint8).reshape(-1, row)
                label_list.append(raw[:, row - 3073].astype(np.int32))
                imgs = raw[:, row - 3072:].reshape(-1, 3, 32, 32)
                data_list.append(imgs.transpose(0, 2, 3, 1))
            self._data = np.concatenate(data_list)
            self._label = np.concatenate(label_list)
        else:
            self._data, self._label = _synthetic(
                self._num_synthetic, (32, 32, 3), self._num_classes,
                seed=44 if self._train else 45)


class CIFAR100(CIFAR10):
    _num_classes = 100

    def __init__(self, root=os.path.join("~", ".mxnet", "datasets", "cifar100"),
                 fine_label=False, train=True, transform=None):
        super().__init__(root, train, transform)


class ImageRecordDataset(Dataset):
    """Dataset over packed image RecordIO (reference: ImageRecordDataset)."""

    def __init__(self, filename, flag=1, transform=None):
        from ..dataset import RecordFileDataset
        self._record = RecordFileDataset(filename)
        self._flag = flag
        self._transform = transform

    def __len__(self):
        return len(self._record)

    def __getitem__(self, idx):
        from .... import image, recordio
        from ....context import cpu

        raw = self._record[idx]
        header, img = recordio.unpack(raw)
        x = image.imdecode(img, self._flag, ctx=cpu())
        y = header.label
        if self._transform is not None:
            return self._transform(x, y)
        return x, y
