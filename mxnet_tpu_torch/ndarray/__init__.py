"""The ``nd`` namespace of the port.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``: ``array``, ``zeros``,
``ones``, and one function per registered op, generated from the op
registry at import time with the same positional-argument rules
(:func:`_make_stub`).  ``nd.contrib`` holds the ``_contrib_*`` ops under
their short names; ``save`` / ``load`` are the file format of
``ndarray/utils.py``.  Arrays are created on the card (``cuda:0``) unless
``ctx`` says otherwise, and creation raises without a card.
"""
from __future__ import annotations

import inspect

import torch

from .. import ops as _ops  # noqa: F401  (registers the ops)
from ..base import MXNetError
from ..context import resolve_device
from ..ops import registry as _reg
from .ndarray import NDArray, array, dtype_torch
from .utils import load, save, save_legacy
from . import contrib  # noqa: F401  (nd.contrib namespace)

__all__ = ["NDArray", "array", "zeros", "ones", "save", "load",
           "save_legacy"]


def zeros(shape, ctx=None, dtype=None, **kwargs) -> NDArray:
    dev = resolve_device(ctx)
    return NDArray(torch.zeros(_tup(shape), dtype=dtype_torch(
        dtype or "float32"), device=dev), ctx=dev)


def ones(shape, ctx=None, dtype=None, **kwargs) -> NDArray:
    dev = resolve_device(ctx)
    return NDArray(torch.ones(_tup(shape), dtype=dtype_torch(
        dtype or "float32"), device=dev), ctx=dev)


def _tup(shape):
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _make_stub(op):
    """``nd.<op>(*args, **kwargs)``: leading positional arguments fill the
    op's array parameters (non-NDArrays become arrays on the device of the
    NDArray inputs, or ``ctx``), the rest its attributes in order."""
    sig = inspect.signature(op.fn)
    params = list(sig.parameters.values())
    n_arr = 0
    for p in params:
        if p.default is p.empty and p.kind == p.POSITIONAL_OR_KEYWORD:
            n_arr += 1
    kw_names = [p.name for p in params if p.default is not p.empty]

    def stub(*args, **kwargs):
        out = kwargs.pop("out", None)
        ctx = kwargs.pop("ctx", None)
        kwargs.pop("name", None)  # symbol-compat no-op
        if ctx is None:
            ctx = next((a.context for a in args if isinstance(a, NDArray)),
                       None)
        inputs = []
        extra_kw = 0
        for a in args:
            if isinstance(a, NDArray):
                inputs.append(a)
            elif len(inputs) < n_arr:
                inputs.append(array(a, ctx=ctx))
            else:
                while extra_kw < len(kw_names) and kw_names[extra_kw] in kwargs:
                    extra_kw += 1
                if extra_kw >= len(kw_names):
                    raise MXNetError(
                        f"too many positional arguments for op {op.name}")
                kwargs[kw_names[extra_kw]] = a
                extra_kw += 1
        return _reg.invoke(op, inputs, out=out, ctx=ctx, **kwargs)

    stub.__name__ = op.name
    stub.__doc__ = op.__doc__
    return stub


def _populate():
    g = globals()
    for name in _reg.list_ops():
        g[name] = _make_stub(_reg.get_op(name))
        __all__.append(name)


_populate()
