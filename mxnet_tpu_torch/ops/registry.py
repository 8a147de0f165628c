"""Declarative operator registry and the single dispatch point.

Counterpart of ``mxnet_tpu/ops/registry.py``.  An :class:`Operator`'s
implementation is a torch function ``fn(*tensors, **attrs)``; the
``nd`` namespace is generated from the registry, and every call goes
through :func:`_invoke_impl`.

Departures from the JAX package, on purpose:

  * there is no trace.  The JAX package consults the fused-kernel pass only
    on its traced branch; the port runs eagerly and has one branch, so
    while a pass's scope is active every dispatch asks it for a
    substitute.  That changes which implementation runs, not what comes
    out;
  * gradients are torch's autograd, not a tape of the port's own: under
    ``autograd.record()`` an op runs with grad enabled, and outside it
    under ``torch.no_grad()``, so arrays with ``attach_grad`` build no
    graph unless recording (see ``autograd.py``);
  * no per-attribute ``jit`` cache and no typed attribute validation
    (``ops/params.validate_known``): PyTorch dispatches eagerly.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from ..base import MXNetError
from ..passes import hooks as _pass_hooks

__all__ = ["Operator", "register", "get_op", "invoke", "invoke_by_name",
           "list_ops"]

_OPS: Dict[str, "Operator"] = {}


class Operator:
    """A registered op: name, torch implementation, differentiability."""

    def __init__(self, name: str, fn: Callable, differentiable: bool = True,
                 doc: Optional[str] = None):
        self.name = name
        self.fn = fn
        self.differentiable = differentiable
        self.__doc__ = doc or fn.__doc__

    def __repr__(self):
        return f"<Operator {self.name}>"


def register(name: Optional[str] = None, differentiable: bool = True):
    """Decorator: register a torch function as an operator."""

    def deco(fn: Callable) -> Callable:
        opname = name or fn.__name__
        if opname in _OPS:
            raise MXNetError(f"op {opname!r} registered twice")
        _OPS[opname] = Operator(opname, fn, differentiable=differentiable)
        return fn

    return deco


def get_op(name: str) -> Operator:
    try:
        return _OPS[name]
    except KeyError:
        raise MXNetError(f"unknown operator {name!r}") from None


def list_ops() -> List[str]:
    return sorted(_OPS)


def invoke(op: Operator, inputs: Sequence, out=None, ctx=None, **attrs):
    """Execute ``op`` on NDArray inputs; returns an NDArray or a list of
    them.  ``ctx`` only places zero-input ops; otherwise outputs follow
    their inputs' device."""
    return _invoke_impl(op, inputs, out=out, ctx=ctx, **attrs)


def _invoke_impl(op: Operator, inputs: Sequence, out=None, ctx=None,
                 **attrs):
    from .. import autograd
    from ..context import resolve_device
    from ..ndarray.ndarray import NDArray

    # the pass-pipeline consultation: the one module global dispatch
    # reads, an empty tuple when no pass is active
    op_hooks = _pass_hooks._OP_HOOKS
    if op_hooks and inputs:
        for h in op_hooks:
            inputs = h.rewrite_inputs(op.name, inputs)
    tensors = [x._data for x in inputs]
    ctx = inputs[0].context if inputs else resolve_device(ctx)

    fn = op.fn
    if op_hooks and tensors:
        # fused-kernel substitution (passes/builtin.FusedKernelPass) for
        # the platform the inputs live on
        platform = tensors[0].device.type
        for h in op_hooks:
            alt = h.substitute(op.name, attrs, platform)
            if alt is not None:
                fn = alt

    recording = autograd.is_recording() and op.differentiable
    with torch.set_grad_enabled(recording):
        if tensors:
            outs = fn(*tensors, **attrs)
        else:
            with torch.device(ctx):
                outs = fn(**attrs)
    if recording:
        autograd.register_leaves(inputs)

    multi = isinstance(outs, (tuple, list))
    results = [NDArray(o, ctx=ctx) for o in (outs if multi else [outs])]
    if out is not None:
        if multi:
            raise MXNetError(
                f"out= not supported for multi-output op {op.name}")
        out._set_data(results[0]._data)
        return out
    return results if multi else results[0]


def invoke_by_name(name: str, inputs, out=None, **attrs):
    return invoke(get_op(name), inputs, out=out, **attrs)
