"""``mx.operator``: user-defined operators in Python, from
``mxnet_tpu/operator.py`` (MXNet's ``CustomOp`` / ``CustomOpProp`` /
``register``).

A ``CustomOpProp`` subclass registered under an ``op_type`` describes an
op (its arguments, outputs, auxiliary states and shapes) and creates its
``CustomOp``, whose ``forward`` and ``backward`` write NDArrays through
``assign``.  ``nd.Custom(*inputs, op_type=...)`` runs the op eagerly on
its inputs' device; under ``autograd.record()`` the call is one node of
torch's graph (``autograd.Function``, a ``torch.autograd.Function``
underneath) whose gradient is the user's ``backward``.  Called with torch
tensors (``F.Custom`` in a ``hybrid_forward``, a hybridized block's
``CachedOp``) it takes and gives tensors and runs eagerly too, as the
JAX docstring says a Custom op does inside a trace.
"""
from __future__ import annotations

import inspect
from typing import Dict, List, Type

import torch

from .base import MXNetError

__all__ = ["CustomOp", "CustomOpProp", "register",
           "get_all_registered_operators"]

_CUSTOM_OPS: Dict[str, Type["CustomOpProp"]] = {}


class CustomOp:
    """Base class of a user op: ``forward`` and ``backward`` write their
    results with ``assign``."""

    def forward(self, is_train, req, in_data, out_data, aux):
        raise NotImplementedError

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        raise NotImplementedError

    def assign(self, dst, req, src):
        """Write ``src`` into ``dst`` by ``req``: ``null`` skips, ``add``
        adds, ``write`` / ``inplace`` replace (in ``dst``'s dtype)."""
        if req in ("null", None):
            return
        value = src._data.to(dst._data.dtype)
        if req == "add":
            value = dst._data + value
        dst._set_data(value)


class CustomOpProp:
    """An op's description: arguments, outputs, auxiliary states, shape
    and type inference, and its ``CustomOp``."""

    def __init__(self, need_top_grad: bool = True):
        self.need_top_grad_ = need_top_grad

    def list_arguments(self) -> List[str]:
        return ["data"]

    def list_outputs(self) -> List[str]:
        return ["output"]

    def list_auxiliary_states(self) -> List[str]:
        return []

    def infer_shape(self, in_shape):
        return in_shape, [in_shape[0]], []

    def infer_type(self, in_type):
        return (in_type, [in_type[0]] * len(self.list_outputs()),
                [in_type[0]] * len(self.list_auxiliary_states()))

    def create_operator(self, ctx, in_shapes, in_dtypes) -> CustomOp:
        raise NotImplementedError

    def declare_backward_dependency(self, out_grad, in_data, out_data):
        deps = []
        if self.need_top_grad_:
            deps.extend(out_grad)
        deps.extend(in_data)
        deps.extend(out_data)
        return deps


def register(reg_name: str):
    """Decorator registering a ``CustomOpProp`` subclass as ``reg_name``."""

    def deco(prop_cls):
        if not issubclass(prop_cls, CustomOpProp):
            raise MXNetError("register expects a CustomOpProp subclass")
        _CUSTOM_OPS[reg_name] = prop_cls
        return prop_cls

    return deco


def get_all_registered_operators() -> List[str]:
    return sorted(_CUSTOM_OPS)


def _invoke_custom(op_type: str, inputs, **kwargs):
    """``nd.Custom`` on NDArrays: the prop made from the kwargs its
    constructor takes, the op created for the inputs' shapes and types,
    then one ``autograd.Function`` call."""
    from . import autograd
    from .ndarray import zeros

    prop_cls = _CUSTOM_OPS.get(op_type)
    if prop_cls is None:
        raise MXNetError(f"unknown custom op type {op_type!r}")
    accepted = inspect.signature(prop_cls.__init__).parameters
    prop = prop_cls(**{k: v for k, v in kwargs.items() if k in accepted})
    arg_names = prop.list_arguments()
    if len(inputs) != len(arg_names):
        raise MXNetError(f"custom op {op_type}: expected {len(arg_names)} "
                         f"inputs {arg_names}, got {len(inputs)}")
    ctx = inputs[0].context
    in_shapes = [list(x.shape) for x in inputs]
    _, out_shapes, aux_shapes = prop.infer_shape(in_shapes)
    op = prop.create_operator(ctx, in_shapes, [x.dtype for x in inputs])
    n_out = len(out_shapes)
    aux = [zeros(tuple(s), ctx=ctx) for s in aux_shapes]

    class _Fn(autograd.Function):
        def forward(self, *in_data):
            out_data = [zeros(tuple(s), ctx=ctx) for s in out_shapes]
            op.forward(is_train=autograd.is_training(),
                       req=["write"] * n_out, in_data=list(in_data),
                       out_data=out_data, aux=aux)
            self._saved = (list(in_data), out_data)
            return out_data[0] if n_out == 1 else tuple(out_data)

        def backward(self, *out_grad):
            in_data, out_data = self._saved
            in_grad = [zeros(x.shape, ctx=ctx, dtype=x.dtype)
                       for x in in_data]
            op.backward(req=["write"] * len(in_data),
                        out_grad=list(out_grad), in_data=in_data,
                        out_data=out_data, in_grad=in_grad, aux=aux)
            return in_grad[0] if len(in_grad) == 1 else tuple(in_grad)

    return _Fn()(*inputs)


def Custom(*args, op_type=None, **kwargs):
    """``mx.nd.Custom(*inputs, op_type='name', **op_kwargs)``: NDArrays
    (or array-likes) in, NDArrays out; torch tensors in, tensors out."""
    from .ndarray import NDArray, array

    if op_type is None:
        raise MXNetError("Custom requires op_type=")
    if any(isinstance(a, torch.Tensor) for a in args):
        out = _invoke_custom(op_type, [NDArray(a) for a in args], **kwargs)
        return (out._data if isinstance(out, NDArray)
                else tuple(o._data for o in out))
    inputs = [a if isinstance(a, NDArray) else array(a) for a in args]
    return _invoke_custom(op_type, inputs, **kwargs)
