"""``sum`` and ``mean``, from ``mxnet_tpu/ops/reduce_ops.py``: MXNet's
axis attribute (None, an int or a tuple; () means every axis),
``keepdims`` and ``exclude`` (reduce over every axis but those)."""
from __future__ import annotations

import torch

from .registry import register


def _reduce(fn, x, axis=None, keepdims=False, exclude=False):
    if axis is None or axis == ():
        ax = None
    elif isinstance(axis, (list, tuple)):
        ax = tuple(axis)
    else:
        ax = (int(axis),)
    if exclude and ax is not None:
        ax = tuple(i for i in range(x.dim())
                   if i not in tuple(a % x.dim() for a in ax))
    if ax is None:
        ax = tuple(range(x.dim()))
    return fn(x, dim=ax, keepdim=keepdims)


for _name, _f in {"sum": torch.sum, "mean": torch.mean}.items():
    register(_name)(
        lambda x, axis=None, keepdims=False, exclude=False, _f=_f: _reduce(
            _f, x, axis, keepdims, exclude))
