"""Datasets, the port's copy of ``mxnet_tpu/gluon/data/dataset.py``
(reference: python/mxnet/gluon/data/dataset.py): items stay on the host;
a ``DataLoader`` moves whole batches to its device."""
from __future__ import annotations

import os
from typing import Callable, List, Optional

from ...base import MXNetError

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset", "RecordFileDataset"]


class Dataset:
    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def filter(self, fn):
        return SimpleDataset([x for x in self if fn(x)])

    def take(self, count):
        return SimpleDataset([self[i] for i in range(min(count, len(self)))])

    def transform(self, fn: Callable, lazy: bool = True) -> "Dataset":
        trans = _LazyTransformDataset(self, fn)
        if lazy:
            return trans
        return SimpleDataset([trans[i] for i in range(len(trans))])

    def transform_first(self, fn: Callable, lazy: bool = True) -> "Dataset":
        def base_fn(x, *args):
            if args:
                return (fn(x),) + args
            return fn(x)

        return self.transform(base_fn, lazy)


class SimpleDataset(Dataset):
    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class _LazyTransformDataset(Dataset):
    def __init__(self, data, fn):
        self._data = data
        self._fn = fn

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        item = self._data[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class ArrayDataset(Dataset):
    """Zip of array-likes (reference ~L150)."""

    def __init__(self, *args):
        assert len(args) > 0
        self._length = len(args[0])
        self._data = []
        for i, data in enumerate(args):
            assert len(data) == self._length, \
                f"All arrays must have the same length; got {len(data)} " \
                f"instead of {self._length} at position {i}"
            if isinstance(data, (list, tuple)):
                data = SimpleDataset(data)
            self._data.append(data)

    def __getitem__(self, idx):
        if len(self._data) == 1:
            return self._data[0][idx]
        return tuple(data[idx] for data in self._data)

    def __len__(self):
        return self._length


class RecordFileDataset(Dataset):
    """Dataset over a RecordIO (.rec/.idx) pair (reference ~L200)."""

    def __init__(self, filename: str):
        from ... import recordio

        idx_file = os.path.splitext(filename)[0] + ".idx"
        self._record = recordio.MXIndexedRecordIO(idx_file, filename, "r")

    def __getitem__(self, idx):
        return self._record.read_idx(self._record.keys[idx])

    def __len__(self):
        return len(self._record.keys)
