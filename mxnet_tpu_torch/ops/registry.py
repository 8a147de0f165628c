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
  * no per-attribute ``jit`` cache: PyTorch dispatches eagerly.  The
    typed attribute validation (``ops/params.validate_known``) that the
    JAX op runs on a cache miss runs here on the first dispatch of each
    attribute combination of a declared op (``Operator.checked``);
  * the port's layers call op functions without ``invoke``, so
    :func:`register` makes each function a profiler site of its op's
    name (``profiler.op_site``); ``invoke`` times the whole dispatch,
    and the function's site inside it records nothing.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from .. import profiler as _profiler
from ..base import MXNetError
from ..passes import hooks as _pass_hooks
from . import params as _params

__all__ = ["Operator", "register", "get_op", "invoke", "invoke_by_name",
           "invoke_fn", "list_ops"]

_OPS: Dict[str, "Operator"] = {}
_SCALARS = (bool, int, float, str, type(None))


def _attrs_key(attrs: dict):
    """``attrs`` as a set member, value types included (1 and True
    differ), or None when a value is not a scalar or a tuple of them."""
    items = []
    for k, v in attrs.items():
        if isinstance(v, tuple):
            types = tuple(type(e) for e in v)
            if not all(t in _SCALARS for t in types):
                return None
        elif type(v) in _SCALARS:
            types = type(v)
        else:
            return None
        items.append((k, v, types))
    return frozenset(items)


class Operator:
    """A registered op: name, torch implementation, differentiability;
    ``checked`` holds the attribute combinations already validated."""

    def __init__(self, name: str, fn: Callable, differentiable: bool = True,
                 doc: Optional[str] = None):
        self.name = name
        self.fn = fn
        self.differentiable = differentiable
        self.__doc__ = doc or fn.__doc__
        self.checked: set = set()

    def check_attrs(self, attrs: dict) -> None:
        """Typed validation of the declared attrs (``ops/params.py``) on
        the first sight of each combination, as the JAX op validates on
        a jit-cache miss; a combination holding another value than a
        scalar or a tuple of them is validated at every call."""
        key = _attrs_key(attrs)
        if key is not None and key in self.checked:
            return
        _params.validate_known(self.name, attrs)
        if key is not None:
            self.checked.add(key)

    def __repr__(self):
        return f"<Operator {self.name}>"


def register(name: Optional[str] = None, differentiable: bool = True):
    """Decorator: register a torch function as an operator; the function
    returned (and the Operator's ``fn``) is its profiler site."""

    def deco(fn: Callable) -> Callable:
        opname = name or fn.__name__
        if opname in _OPS:
            raise MXNetError(f"op {opname!r} registered twice")
        site = _profiler.op_site(opname, fn)
        _OPS[opname] = Operator(opname, site, differentiable=differentiable)
        return site

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
    their inputs' device.  While the profiler runs the dispatch is timed
    under the op's name."""
    if _profiler._running:
        return _profiler.timed_call(op.name, _invoke_impl, op, inputs,
                                    out=out, ctx=ctx, **attrs)
    return _invoke_impl(op, inputs, out=out, ctx=ctx, **attrs)


def _invoke_impl(op: Operator, inputs: Sequence, out=None, ctx=None,
                 **attrs):
    from .. import autograd, engine
    from ..context import resolve_device
    from ..ndarray.ndarray import NDArray

    if attrs and op.name in _params._DECLARED:
        op.check_attrs(attrs)
    # the pass-pipeline consultation, an empty tuple when no pass is
    # active (dispatch reads it and the declared ops' names, nothing
    # else of module state)
    op_hooks = _pass_hooks._OP_HOOKS
    if op_hooks and inputs:
        for h in op_hooks:
            inputs = h.rewrite_inputs(op.name, inputs)
    tensors = [x._data for x in inputs]
    ctx = inputs[0]._ctx if inputs else resolve_device(ctx)

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
    if engine.is_naive() and ctx.type == "cuda":
        torch.cuda.synchronize(ctx)
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


def invoke_fn(fn, inputs, out=None):
    """Run an ad-hoc torch function ``fn(*tensors)`` on NDArray inputs as
    an op runs (recorded under ``autograd.record()``), for closures whose
    arguments are no op's attributes: NDArray indexing, ``moveaxis``."""
    from .. import autograd
    from ..ndarray.ndarray import NDArray

    ctx = inputs[0]._ctx
    recording = autograd.is_recording()
    with torch.set_grad_enabled(recording):
        outs = fn(*[x._data for x in inputs])
    if recording:
        autograd.register_leaves(inputs)
    multi = isinstance(outs, (tuple, list))
    results = [NDArray(o, ctx=ctx) for o in (outs if multi else [outs])]
    if out is not None:
        out._set_data(results[0]._data)
        return out
    return results if multi else results[0]
