"""Gluon utilities on the port's NDArrays.

Counterpart of ``mxnet_tpu/gluon/utils.py`` (reference
``python/mxnet/gluon/utils.py``): ``split_data`` / ``split_and_load``, the
data-parallel batch sharder over devices, and ``clip_global_norm``, which
rescales arrays in place so that their joint L2 norm is at most
``max_norm`` and returns the norm before the clip.
"""
from __future__ import annotations

import warnings
from typing import List

import numpy as np
import torch

from ..base import MXNetError

__all__ = ["split_data", "split_and_load", "clip_global_norm"]


def split_data(data, num_slice: int, batch_axis: int = 0,
               even_split: bool = True) -> List:
    """``num_slice`` slices of ``data`` along ``batch_axis``; with
    ``even_split=False`` the last takes the remainder."""
    size = data.shape[batch_axis]
    if size < num_slice:
        raise MXNetError(
            f"Too many slices: data with shape {data.shape} only has {size} "
            f"entries on axis {batch_axis} but {num_slice} slices requested")
    if even_split and size % num_slice != 0:
        raise MXNetError(
            f"data with shape {data.shape} cannot be evenly split into "
            f"{num_slice} slices along axis {batch_axis}")
    step = size // num_slice
    bounds = [(i * step, (i + 1) * step) for i in range(num_slice)]
    if not even_split:
        bounds[-1] = ((num_slice - 1) * step, size)
    return [_slice_axis(data, batch_axis, b, e) for b, e in bounds]


def _slice_axis(data, axis, begin, end):
    idx = [slice(None)] * data.ndim
    idx[axis] = slice(begin, end)
    idx = tuple(idx)
    from ..ndarray.ndarray import NDArray

    if isinstance(data, NDArray):
        return NDArray(data._data[idx], ctx=data.context)
    return data[idx]


def split_and_load(data, ctx_list, batch_axis: int = 0,
                   even_split: bool = True) -> List:
    """Shard a batch over devices: one NDArray per device of
    ``ctx_list`` (``torch.device``s, ``mx.gpu(i)``, ``mx.cpu()``)."""
    from ..ndarray.ndarray import NDArray, array

    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [piece.as_in_context(ctx) for piece, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm: float, check_isfinite: bool = True):
    """Rescale ``arrays`` in place so that their joint L2 norm (over f32
    copies) is at most ``max_norm``; returns that norm as a float."""
    if not arrays:
        raise MXNetError("clip_global_norm requires at least one array")
    total = None
    for arr in arrays:
        sq = torch.sum(torch.square(arr._data.to(torch.float32)))
        total = sq if total is None else total + sq
    norm = float(torch.sqrt(total))
    if check_isfinite and not np.isfinite(norm):
        warnings.warn("nan or inf is detected. Clipping results will be "
                      "undefined.", stacklevel=2)
    scale = max_norm / (norm + 1e-8)
    if scale < 1.0:
        for arr in arrays:
            arr._set_data(arr._data * scale)
    return norm
