"""The ``nd`` namespace of the port.

Counterpart of ``mxnet_tpu/ndarray/__init__.py``: ``array``, ``zeros``,
``ones``, ``full``, ``empty``, ``arange``, ``eye``, ``linspace``, and
one function per registered op, generated from the op registry at import
time with the same positional-argument rules (:func:`_make_stub`).
``nd.contrib`` holds the ``_contrib_*`` ops under their short names and
the control flow (``foreach``, ``while_loop``, ``cond``), ``nd.linalg``
the ``linalg_*`` ops under theirs, ``nd.random`` the samplers; the
random ops themselves stay out of ``nd``, as in the JAX package.
``Dropout`` reads the train flag of ``autograd`` and ``shuffle`` draws
from the device's generator; the ufuncs (``add``, ``subtract``, ...,
``equal``, ``logical_xor``, ``power``, ``hypot``) take arrays or
scalars.  ``save`` / ``load`` are the file format of
``ndarray/utils.py``.  ``nd.sparse`` holds the ``row_sparse`` and ``csr``
storage types; ``cast_storage`` converts between them and dense.
``waitall`` is ``engine.wait_all``.  Arrays are created on the card
(``cuda:0``) unless ``ctx`` (or a ``with`` Context scope) says
otherwise, and creation raises without a card.
"""
from __future__ import annotations

import inspect

import torch

from .. import engine as _engine
from .. import ops as _ops  # noqa: F401  (registers the ops)
from ..base import MXNetError
from ..context import (Context, current_context,  # noqa: F401
                       resolve_device)
from ..ops import registry as _reg
from .ndarray import NDArray, array, dtype_torch
from ..operator import Custom  # noqa: F401  (mx.nd.Custom)
from .utils import load, save, save_legacy
from . import contrib  # noqa: F401  (nd.contrib namespace)
from . import linalg  # noqa: F401  (nd.linalg namespace)
from . import random  # noqa: F401  (nd.random namespace)
from . import sparse  # noqa: F401  (nd.sparse namespace)
from .random import _dtname
from .sparse import CSRNDArray, RowSparseNDArray

__all__ = ["NDArray", "array", "zeros", "ones", "full", "empty", "arange",
           "eye", "linspace", "save", "load", "save_legacy", "waitall"]


def waitall():
    _engine.wait_all()


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


def full(shape, val, ctx=None, dtype=None, **kwargs) -> NDArray:
    return _reg.invoke_by_name("_full", [], ctx=ctx, shape=_tup(shape),
                               value=float(val), dtype=_dtname(dtype))


def empty(shape, ctx=None, dtype=None) -> NDArray:
    return zeros(shape, ctx=ctx, dtype=dtype)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None,
           dtype=None) -> NDArray:
    return _reg.invoke_by_name("_arange", [], ctx=ctx, start=start,
                               stop=stop, step=step, repeat=repeat,
                               dtype=_dtname(dtype))


def eye(N, M=0, k=0, ctx=None, dtype=None) -> NDArray:
    return _reg.invoke_by_name("_eye", [], ctx=ctx, N=N, M=M, k=k,
                               dtype=_dtname(dtype))


def linspace(start, stop, num, endpoint=True, ctx=None,
             dtype=None) -> NDArray:
    return _reg.invoke_by_name("_linspace", [], ctx=ctx, start=start,
                               stop=stop, num=num, endpoint=endpoint,
                               dtype=_dtname(dtype))


# ---------------------------------------------------------------------------
# special stubs: the train flag and the generator
# ---------------------------------------------------------------------------
def Dropout(data, p=0.5, mode="training", axes=(), cudnn_off=False, out=None,
            **kwargs):
    """Dropout in ``autograd``'s training mode (or ``mode="always"``),
    else the identity."""
    from .. import autograd

    training = kwargs.pop("training", None)
    if training is None:
        training = autograd.is_training() or mode == "always"
    if not training or p <= 0.0:
        return _reg.invoke_by_name("identity", [data], out=out)
    return _reg.invoke_by_name("Dropout", [data], out=out, p=p, mode=mode,
                               axes=tuple(axes), training=True)


def cast_storage(data, stype="default", out=None):
    """Convert between dense and sparse storage (``tostype``, always a new
    array); ``out`` of the target storage type receives the result."""
    res = data.tostype(stype)
    if res is data:
        res = data.copy()
    if out is not None:
        if out.stype != stype:
            raise MXNetError(f"cast_storage: out has stype {out.stype!r}, "
                             f"expected {stype!r}")
        if stype == "default":
            out._set_data(res._data)
        else:
            out._data = res._data
            out._aux = dict(res._aux)
            out._shape = res._shape
            out._version += 1
        return out
    return res


def onehot_encode(indices, out):
    """Legacy one-hot, written into ``out`` and returned."""
    return _reg.invoke_by_name("onehot_encode", [indices, out], out=out)


_SPECIAL = {"Dropout": Dropout, "onehot_encode": onehot_encode}
_SKIP_PREFIXES = ("_random_", "_sample_", "sample_")

# name -> (broadcast op, scalar op, reversed scalar op), as the JAX
# package's ufuncs: a scalar operand is the *_scalar op's attribute
_UFUNCS = {
    "add": ("broadcast_add", "_plus_scalar", "_plus_scalar"),
    "subtract": ("broadcast_sub", "_minus_scalar", "_rminus_scalar"),
    "multiply": ("broadcast_mul", "_mul_scalar", "_mul_scalar"),
    "divide": ("broadcast_div", "_div_scalar", "_rdiv_scalar"),
    "true_divide": ("broadcast_div", "_div_scalar", "_rdiv_scalar"),
    "mod": ("broadcast_mod", "_mod_scalar", "_rmod_scalar"),
    "power": ("broadcast_power", "_power_scalar", "_rpower_scalar"),
    "equal": ("broadcast_equal", "_equal_scalar", "_equal_scalar"),
    "not_equal": ("broadcast_not_equal", "_not_equal_scalar",
                  "_not_equal_scalar"),
    "greater": ("broadcast_greater", "_greater_scalar", "_lesser_scalar"),
    "greater_equal": ("broadcast_greater_equal", "_greater_equal_scalar",
                      "_lesser_equal_scalar"),
    "lesser": ("broadcast_lesser", "_lesser_scalar", "_greater_scalar"),
    "lesser_equal": ("broadcast_lesser_equal", "_lesser_equal_scalar",
                     "_greater_equal_scalar"),
    "logical_and": ("broadcast_logical_and", "_logical_and_scalar",
                    "_logical_and_scalar"),
    "logical_or": ("broadcast_logical_or", "_logical_or_scalar",
                   "_logical_or_scalar"),
    "logical_xor": ("broadcast_logical_xor", "_logical_xor_scalar",
                    "_logical_xor_scalar"),
}


def _make_ufunc(name, broadcast_op, scalar_op, rscalar_op):
    import numpy as np

    np_fn = getattr(np, {"lesser": "less", "lesser_equal": "less_equal"}
                    .get(name, name))

    def f(lhs, rhs):
        lnd, rnd = isinstance(lhs, NDArray), isinstance(rhs, NDArray)
        if lnd and rnd:
            return _reg.invoke_by_name(broadcast_op, [lhs, rhs])
        if lnd:
            return _reg.invoke_by_name(scalar_op, [lhs], scalar=float(rhs))
        if rnd:
            return _reg.invoke_by_name(rscalar_op, [rhs], scalar=float(lhs))
        return np_fn(lhs, rhs)

    f.__name__ = name
    return f


def hypot(lhs, rhs):
    """Element-wise hypot of arrays or scalars."""
    lnd, rnd = isinstance(lhs, NDArray), isinstance(rhs, NDArray)
    if lnd and rnd:
        return _reg.invoke_by_name("broadcast_hypot", [lhs, rhs])
    if lnd or rnd:
        arr, s = (lhs, rhs) if lnd else (rhs, lhs)
        return _reg.invoke_fn(lambda x: torch.hypot(x, torch.full_like(
            x, float(s))), [arr])
    import numpy as np

    return np.hypot(lhs, rhs)


def moveaxis(a, source, destination):
    return _reg.invoke_fn(lambda x: torch.movedim(x, source, destination),
                          [a])


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
        if name in _SPECIAL:
            g[name] = _SPECIAL[name]
        elif name.startswith(_SKIP_PREFIXES):
            continue
        else:
            g[name] = _make_stub(_reg.get_op(name))
        __all__.append(name)
    for name, ops in _UFUNCS.items():
        g[name] = _make_ufunc(name, *ops)
        __all__.append(name)
    for name in _reg.list_ops():
        if name.startswith("linalg_"):
            setattr(linalg, name[len("linalg_"):], g[name])
            linalg.__all__.append(name[len("linalg_"):])
    for alias, name in (("concat", "Concat"), ("concatenate", "Concat"),
                        ("flatten", "Flatten"), ("cast", "Cast"),
                        ("shuffle", "_shuffle")):
        g[alias] = g[name]
    __all__.extend(["hypot", "moveaxis", "shuffle", "concat", "concatenate",
                    "flatten", "cast"])


_populate()
