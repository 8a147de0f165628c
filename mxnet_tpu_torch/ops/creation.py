"""Creation ops, from ``mxnet_tpu/ops/creation.py``: ``_zeros``,
``_ones``, ``_full``, ``_arange`` (with ``repeat``), ``_eye``,
``_linspace``, ``zeros_like`` and ``ones_like``.  The zero-input ones
run under ``torch.device(ctx)`` (``registry._invoke_impl``), so their
tensors land on the caller's device."""
from __future__ import annotations

import torch

from .registry import register


def _dt(dtype):
    from ..ndarray.ndarray import dtype_torch

    return dtype_torch(dtype)


def _shape(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


@register("_zeros", differentiable=False)
def _zeros(shape=(), dtype="float32"):
    return torch.zeros(_shape(shape), dtype=_dt(dtype))


@register("_ones", differentiable=False)
def _ones(shape=(), dtype="float32"):
    return torch.ones(_shape(shape), dtype=_dt(dtype))


@register("_full", differentiable=False)
def _full(shape=(), value=0.0, dtype="float32"):
    return torch.full(_shape(shape), value, dtype=_dt(dtype))


@register("_arange", differentiable=False)
def _arange(start=0.0, stop=None, step=1.0, repeat=1, dtype="float32"):
    if stop is None:
        start, stop = 0.0, start
    arr = torch.arange(start, stop, step, dtype=torch.float64).to(_dt(dtype))
    if repeat != 1:
        arr = torch.repeat_interleave(arr, int(repeat))
    return arr


@register("_eye", differentiable=False)
def _eye(N=0, M=0, k=0, dtype="float32"):
    m = M if M else N
    rows = torch.arange(N)[:, None]
    cols = torch.arange(m)[None, :]
    return (cols - rows == k).to(_dt(dtype))


@register("_linspace", differentiable=False)
def _linspace(start=0.0, stop=1.0, num=50, endpoint=True, dtype="float32"):
    if endpoint:
        out = torch.linspace(start, stop, num, dtype=torch.float64)
    else:
        out = torch.linspace(start, stop, num + 1, dtype=torch.float64)[:-1]
    return out.to(_dt(dtype))


@register("zeros_like", differentiable=False)
def zeros_like(x):
    return torch.zeros_like(x)


@register("ones_like", differentiable=False)
def ones_like(x):
    return torch.ones_like(x)
