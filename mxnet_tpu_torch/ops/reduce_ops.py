"""Reductions and ordering, from ``mxnet_tpu/ops/reduce_ops.py``:
``sum``, ``mean``, ``prod``, ``nansum``, ``nanprod``, ``max``, ``min``
(and ``sum_axis`` / ``max_axis`` / ``min_axis``) with MXNet's axis
attribute (None, an int or a tuple; () means every axis), ``keepdims``
and ``exclude`` (reduce over every axis but those); ``norm``,
``argmax`` / ``argmin`` / ``argmax_channel``, ``topk``, ``sort``,
``argsort`` and ``L2Normalization``.

Indices come back as float32 by default, as MXNet returns them.  Orders
follow the JAX ops: ``topk`` takes the lower index first among equal
values (``jax.lax.top_k``), and the descending ``argsort`` is the
stable ascending one reversed, as ``jnp.flip(jnp.argsort(x))`` is, so
equal values come out highest index first.
"""
from __future__ import annotations

import torch

from .registry import register


def _axes(x, axis=None, exclude=False):
    """The reduced axes as a tuple (every axis for None or ())."""
    if axis is None or axis == ():
        ax = None
    elif isinstance(axis, (list, tuple)):
        ax = tuple(a % x.dim() for a in axis)
    else:
        ax = (int(axis) % x.dim(),)
    if exclude and ax is not None:
        ax = tuple(i for i in range(x.dim()) if i not in ax)
    if ax is None:
        ax = tuple(range(x.dim()))
    return ax


def _prod(x, dim, keepdim):
    """``torch.prod`` over several axes (torch's takes one)."""
    if not dim:
        return x
    rest = [i for i in range(x.dim()) if i not in dim]
    moved = x.permute(*rest, *dim).reshape(
        *[x.shape[i] for i in rest], -1).prod(-1)
    if keepdim:
        for d in sorted(dim):
            moved = moved.unsqueeze(d)
    return moved


def _nanprod(x, dim, keepdim):
    return _prod(torch.where(torch.isnan(x), torch.ones_like(x), x), dim,
                 keepdim)


def _reduce(fn, x, axis=None, keepdims=False, exclude=False):
    return fn(x, dim=_axes(x, axis, exclude), keepdim=keepdims)


_REDUCERS = {
    "sum": torch.sum,
    "mean": torch.mean,
    "prod": _prod,
    "nansum": torch.nansum,
    "nanprod": _nanprod,
    "max": torch.amax,
    "min": torch.amin,
}
for _name, _f in _REDUCERS.items():
    register(_name)(
        lambda x, axis=None, keepdims=False, exclude=False, _f=_f: _reduce(
            _f, x, axis, keepdims, exclude))

register("sum_axis")(lambda x, axis=None, keepdims=False: _reduce(
    torch.sum, x, axis, keepdims))
register("max_axis")(lambda x, axis=None, keepdims=False: _reduce(
    torch.amax, x, axis, keepdims))
register("min_axis")(lambda x, axis=None, keepdims=False: _reduce(
    torch.amin, x, axis, keepdims))


@register("norm")
def norm(x, ord=2, axis=None, keepdims=False):
    ax = _axes(x, axis)
    if ord == 1:
        return torch.sum(torch.abs(x), dim=ax, keepdim=keepdims)
    return torch.sqrt(torch.sum(torch.square(x), dim=ax, keepdim=keepdims))


def _arg(fn, x, axis, keepdims):
    if axis is None or axis == ():
        return fn(x.reshape(-1)).float()
    out = fn(x, dim=int(axis), keepdim=keepdims)
    return out.float()


@register("argmax", differentiable=False)
def argmax(x, axis=None, keepdims=False):
    return _arg(torch.argmax, x, axis, keepdims)


@register("argmin", differentiable=False)
def argmin(x, axis=None, keepdims=False):
    return _arg(torch.argmin, x, axis, keepdims)


@register("argmax_channel", differentiable=False)
def argmax_channel(x):
    return torch.argmax(x, dim=1).float()


@register("topk", differentiable=False)
def topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False,
         dtype="float32"):
    """The k largest (smallest with ``is_ascend``) along ``axis`` (the
    flattened array for None); ``ret_typ`` ``indices``, ``value`` or
    ``both`` (values, indices)."""
    from ..ndarray.ndarray import dtype_torch

    if axis is None:
        xm, ax = x.reshape(-1), 0
    else:
        ax = axis
        xm = x.movedim(ax, -1)
    v, idx = torch.sort(xm, dim=-1, descending=not is_ascend, stable=True)
    v = v[..., :k].movedim(-1, ax)
    idx = idx[..., :k].movedim(-1, ax).to(dtype_torch(dtype))
    if ret_typ == "value":
        return v
    if ret_typ == "both":
        return v, idx
    return idx


@register("sort", differentiable=False)
def sort(x, axis=-1, is_ascend=True):
    out = torch.sort(x, dim=axis, stable=True).values
    return out if is_ascend else torch.flip(out, (axis,))


@register("argsort", differentiable=False)
def argsort(x, axis=-1, is_ascend=True, dtype="float32"):
    from ..ndarray.ndarray import dtype_torch

    idx = torch.argsort(x, dim=axis, stable=True)
    if not is_ascend:
        idx = torch.flip(idx, (axis,))
    return idx.to(dtype_torch(dtype))


@register("L2Normalization")
def l2_normalization(x, eps=1e-10, mode="instance"):
    if mode == "channel":
        red = (1,)
    elif mode == "spatial":
        red = tuple(range(2, x.dim()))
    else:
        red = tuple(range(1, x.dim()))
    return x / torch.sqrt(torch.sum(torch.square(x), dim=red, keepdim=True)
                          + eps)
