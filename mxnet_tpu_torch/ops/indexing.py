"""Indexing ops, from ``mxnet_tpu/ops/indexing.py``: ``take`` (``mode``
clip or wrap), ``pick``, ``gather_nd``, ``scatter_nd``,
``_scatter_set_nd``, ``one_hot``, ``Embedding``, ``SequenceMask`` /
``SequenceLast`` / ``SequenceReverse`` (``use_sequence_length``, time on
``axis``), ``boolean_mask`` and ``ravel_multi_index`` /
``unravel_index`` (and their ``_`` spellings).

Indices arrive as floats, MXNet's habit, and are cast to integers.
``boolean_mask`` keeps the JAX op's static shape: the kept rows first,
in order, then zero rows up to the input's length.  ``gluon.nn.Embedding``
calls :func:`embedding`, so the layer and ``nd.Embedding`` are one
implementation.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register


def _clip_or_wrap(idx, n, mode):
    return torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)


@register("take")
def take(a, indices, axis=0, mode="clip"):
    axis = axis % a.dim()
    idx = _clip_or_wrap(indices.long(), a.shape[axis], mode)
    out = a.index_select(axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


@register("pick")
def pick(x, index, axis=-1, keepdims=False, mode="clip"):
    """x's elements at ``index`` along ``axis``; the index may lack the
    axis or keep it as size 1."""
    ax = axis % x.dim()
    idx = _clip_or_wrap(index.long(), x.shape[ax], mode)
    if idx.dim() == x.dim() - 1:
        idx = idx.unsqueeze(ax)
    picked = torch.gather(x, ax, idx)
    return picked if keepdims else picked.squeeze(ax)


@register("gather_nd")
def gather_nd(a, indices):
    return a[tuple(indices.long())]


@register("scatter_nd")
def scatter_nd(data, indices, shape=()):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(indices.long()), data)


@register("_scatter_set_nd")
def _scatter_set_nd(lhs, indices, rhs, shape=()):
    return lhs.index_put(tuple(indices.long()), rhs.to(lhs.dtype))


@register("one_hot", differentiable=False)
def one_hot(indices, depth=1, on_value=1.0, off_value=0.0, dtype="float32"):
    """A row of ``off_value`` with ``on_value`` at the index; an index
    outside [0, depth) gives a row of ``off_value``."""
    from ..ndarray.ndarray import dtype_torch
    from .nn import _onehot

    hot = _onehot(indices, depth, dtype_torch(dtype))
    return hot * (on_value - off_value) + off_value


@register("Embedding")
def embedding(data, weight, input_dim=None, output_dim=None, dtype="float32",
              sparse_grad=False):
    """Rows of ``weight`` by index, clipped to [0, vocab); the gradient
    scatters into ``weight`` (``torch.nn.functional.embedding``).  With
    ``sparse_grad`` under ``autograd.record()`` (outside a hybridized
    block's call) the weight's gradient is torch's sparse one, the looked-up
    rows only, which autograd writes into a row-sparse buffer."""
    from .. import autograd

    idx = data.long().clamp(0, weight.shape[0] - 1)
    sparse = bool(sparse_grad and autograd.is_recording()
                  and not autograd.is_traced())
    return torch.nn.functional.embedding(idx, weight, sparse=sparse)


def _time_mask(data, sequence_length, axis):
    """(T, B) or (B, T) bool mask of the valid steps, shaped to
    broadcast against ``data``."""
    steps = torch.arange(data.shape[axis], device=data.device)
    lengths = sequence_length.to(steps.dtype)
    if axis == 0:
        mask = steps[:, None] < lengths[None, :]
    else:
        mask = steps[None, :] < lengths[:, None]
    return mask.reshape(mask.shape + (1,) * (data.dim() - 2))


@register("SequenceMask")
def sequence_mask(data, sequence_length=None, use_sequence_length=False,
                  value=0.0, axis=0):
    if not use_sequence_length or sequence_length is None:
        return data
    return data.masked_fill(~_time_mask(data, sequence_length, axis), value)


@register("SequenceLast")
def sequence_last(data, sequence_length=None, use_sequence_length=False,
                  axis=0):
    if not use_sequence_length or sequence_length is None:
        return data.select(axis, -1)
    last = sequence_length.long() - 1
    dm = data.movedim(axis, 0)
    return dm[last, torch.arange(dm.shape[1], device=data.device)]


@register("SequenceReverse")
def sequence_reverse(data, sequence_length=None, use_sequence_length=False,
                     axis=0):
    if not use_sequence_length or sequence_length is None:
        return torch.flip(data, (axis,))
    dm = data.movedim(axis, 0)  # (T, B, ...)
    steps = torch.arange(dm.shape[0], device=data.device)[:, None]
    length = sequence_length.long()[None, :]
    idx = torch.where(steps < length, length - 1 - steps, steps)  # (T, B)
    idx = idx.reshape(idx.shape + (1,) * (dm.dim() - 2)).expand_as(dm)
    return torch.gather(dm, 0, idx).movedim(0, axis)


@register("boolean_mask", differentiable=False)
def boolean_mask(data, index, axis=0):
    """The rows where ``index`` is nonzero first, in order, then zero
    rows: the input's length, as the JAX op's static shape."""
    mask = index != 0
    order = torch.argsort((~mask).to(torch.int8), stable=True)
    gathered = data.index_select(axis, order)
    keep = torch.sort(mask.to(torch.int8)).values.flip(0)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    return gathered * keep.reshape(shape).to(data.dtype)


def _strides(shape):
    return np.concatenate([np.cumprod(np.asarray(shape)[::-1])[::-1][1:],
                           [1]]).astype(np.int64)


@register("_ravel_multi_index", differentiable=False)
def _ravel_multi_index(indices, shape=()):
    strides = torch.as_tensor(_strides(shape), device=indices.device)
    return (indices.long() * strides[:, None]).sum(0)


@register("_unravel_index", differentiable=False)
def _unravel_index(indices, shape=()):
    return torch.stack(torch.unravel_index(indices.long(), tuple(shape)))


@register("ravel_multi_index", differentiable=False)
def ravel_multi_index(indices, shape=()):
    return _ravel_multi_index(indices, shape=shape)


@register("unravel_index", differentiable=False)
def unravel_index(indices, shape=()):
    return _unravel_index(indices, shape=shape)
