"""Gluon ``Block`` / ``HybridBlock`` and ``CachedOp``, on ``torch.nn.Module``.

Counterpart of ``mxnet_tpu/gluon/block.py``.  A Gluon block is a
``torch.nn.Module``; its Gluon ``Parameter``s (``gluon.parameter``) wrap
the module's own tensors.  It carries what Gluon's ``Block`` adds:

  * ``prefix`` / ``name`` / ``name_scope()``, with ``_BlockScope``'s
    per-hint counters (``mxnet_tpu/gluon/block.py:38-69``), so a net's
    Gluon names equal the JAX net's (``params``, ``collect_params``);
  * ``initialize``, ``save_parameters`` / ``load_parameters`` (structural
    names, ``_collect_params_with_prefix``; the file keeps Gluon's
    layouts), ``save_params`` / ``load_params`` (full names), ``cast``,
    ``register_child`` and ``hybridize``.  Forward hooks are torch's
    (``register_forward_hook(hook(block, args, out))``, Gluon's signature).

Two call conventions share the class:

  * called with torch tensors, a block is a ``torch.nn.Module``: grad mode,
    ``train()`` / ``eval()`` and autograd are torch's.  ``DataParallelStep``,
    the serving engine and the models' own forwards call it so;
  * called with NDArrays (at the outermost block), it follows MXNet: the
    forward runs in torch's grad mode only under ``autograd.record()``,
    the module's ``train()`` / ``eval()`` follow ``autograd.is_training()``
    (so Dropout and BatchNorm read MXNet's flag), the Parameters and the
    input arrays that have a gradient buffer become leaves of the port's
    autograd (``autograd.register_leaves``), and the outputs come back as
    NDArrays.
    Inside, the children are called with tensors.

``HybridBlock`` adds ``infer_shape``, which a layer's first call uses to
finish its deferred shapes (as ``_deferred_infer_shape`` does,
``mxnet_tpu/gluon/block.py:571-575``), ``hybrid_forward(F, x, **params)``
for blocks written in Gluon's style (``F`` is the op registry over
tensors), and ``hybridize``.  A hybridized block's NDArray calls go through
its :class:`CachedOp`.  Departure: the port has no trace, so the CachedOp
runs the forward eagerly; it keeps one entry per (train flag, input
signature), counted as the JAX one counts its traces, and is the place a
CUDA-graph replay of ``static_alloc`` / ``static_shape`` goes (ROADMAP
A.1).  ``export`` and ``SymbolBlock`` wait for ``symbol/`` (ROADMAP A.11).

:func:`cast` casts any ``torch.nn.Module`` (the port's models before they
were Gluon blocks used it, and still may).
"""
from __future__ import annotations

import re
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from .. import autograd
from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "CachedOp", "cast"]


class _BlockScope(threading.local):
    """Name-scope manager: the n-th block of a hint made in a scope is
    ``<scope prefix><hint><n>_``."""

    def __init__(self):
        self._current: Optional["Block"] = None
        self._counters: Dict[str, int] = {}

    def create(self, prefix, params, hint):
        current = self._current
        if current is None:
            if prefix is None:
                count = self._counters.get(hint, 0)
                self._counters[hint] = count + 1
                prefix = f"{hint}{count}_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._scope_counters.get(hint, 0)
            current._scope_counters[hint] = count + 1
            prefix = f"{hint}{count}_"
        if params is None:
            parent = current._params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current.prefix + prefix, params


_scope = _BlockScope()


class _NameScopeCtx:
    def __init__(self, block):
        self._block = block
        self._prev = None

    def __enter__(self):
        self._prev = _scope._current
        _scope._current = self._block
        return self

    def __exit__(self, *exc):
        _scope._current = self._prev
        return False


def _blocks_below(module: nn.Module):
    """The nearest Blocks under ``module``, through plain containers
    (``nn.ModuleList``)."""
    for child in module._modules.values():
        if child is None:
            continue
        if isinstance(child, Block):
            yield child
        else:
            yield from _blocks_below(child)


def _structural(module: nn.Module, prefix: str) -> Dict[str, Parameter]:
    if isinstance(module, Block):
        return module._collect_params_with_prefix(prefix)
    ret = {}
    for name, child in module._modules.items():
        if child is not None:
            ret.update(_structural(child, f"{prefix}.{name}"))
    return ret


def _unwrap(x):
    if isinstance(x, NDArray):
        return x._data
    if isinstance(x, (list, tuple)):
        return type(x)(_unwrap(v) for v in x)
    return x


def _wrap(x):
    if isinstance(x, torch.Tensor):
        return NDArray(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_wrap(v) for v in x)
    return x


def _has_nd(args, kwargs) -> bool:
    return (any(isinstance(a, NDArray) for a in args)
            or any(isinstance(v, NDArray) for v in kwargs.values()))


class _TensorOps:
    """``F`` of ``hybrid_forward`` in the port: the registered ops' torch
    functions by name (``F.FullyConnected``), then torch's."""

    def __getattr__(self, name):
        from ..ops import registry

        try:
            return registry.get_op(name).fn
        except MXNetError:
            return getattr(torch, name)


F = _TensorOps()


class Block(nn.Module):
    """Gluon's ``Block`` as a ``torch.nn.Module`` (see the module's
    docstring)."""

    def __init__(self, prefix: Optional[str] = None,
                 params: Optional[ParameterDict] = None):
        super().__init__()
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _scope.create(prefix, params,
                                                   self._alias())
        self._name = (self._prefix[:-1] if self._prefix.endswith("_")
                      else self._prefix)
        self._scope_counters: Dict[str, int] = {}
        self._reg_params: "OrderedDict[str, Parameter]" = OrderedDict()

    def _alias(self) -> str:
        return type(self).__name__.lower()

    @property
    def prefix(self) -> str:
        return self._prefix

    @property
    def name(self) -> str:
        return self._name

    @property
    def params(self) -> ParameterDict:
        return self._params

    def name_scope(self):
        return _NameScopeCtx(self)

    def __setattr__(self, name, value):
        if isinstance(value, Parameter):
            # a Parameter made in Gluon's style (self.w = self.params.get)
            # keeps its tensor under ``name``; the Gluon object stays in
            # ``_reg_params``
            self._reg_params[name] = value
            if value._owner is None:
                self.register_parameter(name, value._tensor())
            value._bind(self, name)
            return
        super().__setattr__(name, value)

    def _gluon_param(self, gname: str, attr: Optional[str] = None,
                     **kwargs) -> Parameter:
        """Get or make the Gluon Parameter ``gname`` of this block's
        ParameterDict and wrap it around the module's tensor ``attr``
        (default: ``gname``), which the layer made."""
        p = self._params.get(gname, **kwargs)
        p._bind(self, attr or gname)
        self._reg_params[gname] = p
        return p

    def register_child(self, block: nn.Module,
                       name: Optional[str] = None) -> None:
        self.add_module(name or str(len(self._modules)), block)

    # ------------------------------------------------------------------
    def collect_params(self, select: Optional[str] = None) -> ParameterDict:
        """This block's Parameters and every child's, by Gluon name;
        ``select`` is a regex the names must match."""
        ret = ParameterDict(self._params.prefix)
        if select is None:
            ret.update(self._params)
        else:
            pattern = re.compile(select)
            ret._params.update({k: v for k, v in self._params.items()
                                if pattern.match(k)})
        for child in _blocks_below(self):
            ret.update(child.collect_params(select))
        return ret

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False) -> None:
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def _mark_initialized(self) -> None:
        """Count every Parameter whose tensor holds values as initialized
        (the models' constructors fill their tensors themselves)."""
        for p in self.collect_params().values():
            p._inited = True
            p._deferred = None

    def _collect_params_with_prefix(self, prefix: str = "") \
            -> Dict[str, Parameter]:
        """Structural dot-names (``0.weight``, ``body.1.gamma``): the
        scope-independent names ``save_parameters`` writes."""
        if prefix:
            prefix += "."
        ret = {prefix + key: val for key, val in self._reg_params.items()}
        for name, child in self._modules.items():
            if child is not None:
                ret.update(_structural(child, prefix + name))
        return ret

    def save_parameters(self, filename: str,
                        deduplicate: bool = False) -> None:
        """Save the values by structural name, in Gluon's layouts."""
        from ..ndarray import utils

        arg_dict, seen = {}, set()
        for name, param in self._collect_params_with_prefix().items():
            if deduplicate and id(param) in seen:
                continue
            seen.add(id(param))
            arg_dict[name] = param._reduce()
        utils.save(filename, arg_dict)

    def load_parameters(self, filename: str, ctx=None, allow_missing=False,
                        ignore_extra=False, cast_dtype=False,
                        dtype_source="current") -> None:
        from ..ndarray import utils

        loaded = utils.load(filename)
        params = self._collect_params_with_prefix()
        if loaded and params and not any(k in params for k in loaded):
            # full names (save_params): through the ParameterDict
            self.collect_params().load(filename, ctx, allow_missing,
                                       ignore_extra,
                                       restore_prefix=self.prefix,
                                       loaded=loaded)
            return
        if not allow_missing:
            for name in params:
                if name not in loaded:
                    raise MXNetError(f"parameter {name} missing in "
                                     f"{filename}")
        for name, value in loaded.items():
            if name not in params:
                if ignore_extra:
                    continue
                raise MXNetError(f"parameter {name} in file not in model")
            params[name]._load_init(value, ctx, cast_dtype=cast_dtype)

    def save_params(self, filename: str) -> None:
        self.collect_params().save(filename, strip_prefix=self.prefix)

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False) -> None:
        self.load_parameters(filename, ctx, allow_missing, ignore_extra)

    def cast(self, dtype) -> "Block":
        """Cast every floating Parameter (BatchNorm's running stats too)
        to ``dtype`` in place."""
        return cast(self, dtype)

    def hybridize(self, active: bool = True, **kwargs) -> None:
        for child in _blocks_below(self):
            child.hybridize(active, **kwargs)

    # ------------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        if _has_nd(args, kwargs):
            return self._call_nd(args, kwargs)
        return super().__call__(*args, **kwargs)

    def _call_nd(self, args, kwargs):
        """The MXNet call convention (see the module's docstring)."""
        train = autograd.is_training()
        if self.training != train:
            self.train(train)
        recording = autograd.is_recording()
        if recording:
            autograd.register_leaves(
                p._view for p in self._leaf_params()
                if p.grad_req != "null"
                and (p._inited or p._deferred is not None))
            autograd.register_leaves(
                [a for a in args if isinstance(a, NDArray)]
                + [v for v in kwargs.values() if isinstance(v, NDArray)])
        targs = [_unwrap(a) for a in args]
        tkwargs = {k: _unwrap(v) for k, v in kwargs.items()}
        with torch.set_grad_enabled(recording):
            out = self._run(targs, tkwargs)
        return _wrap(out)

    def _leaf_params(self) -> List[Parameter]:
        return list(self.collect_params().values())

    def _run(self, args, kwargs):
        return nn.Module.__call__(self, *args, **kwargs)


class CachedOp:
    """The executor of a hybridized block's NDArray calls.

    The JAX ``CachedOp`` traces the forward into one jitted program per
    (train flag, input structure) and jax keeps one executable per input
    signature.  The port has no trace: each call runs the block's forward
    eagerly, and the CachedOp keeps one entry per (train flag, input
    signature) (``entries``), made on the first call with that signature
    and counted as the JAX one's traces are.  The Parameter list is
    collected once, on the first call, as the JAX one's is."""

    def __init__(self, block: "HybridBlock", flags: Dict[str, Any]):
        self.block = block
        self.flags = dict(flags)
        self.entries: Dict[Any, Dict[str, int]] = {}
        self._params: Optional[List[Parameter]] = None

    def params(self) -> List[Parameter]:
        if self._params is None:
            self._params = list(self.block.collect_params().values())
        return self._params

    @property
    def num_entries(self) -> int:
        return len(self.entries)

    def __call__(self, args, kwargs):
        key = (autograd.is_training(), _signature(args),
               _signature(sorted(kwargs.items())))
        entry = self.entries.get(key)
        if entry is None:
            entry = self.entries[key] = {"calls": 0}
        entry["calls"] += 1
        return nn.Module.__call__(self.block, *args, **kwargs)


def _signature(x):
    if isinstance(x, torch.Tensor):
        return (tuple(x.shape), x.dtype, x.device)
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    return x if x is None or isinstance(x, (int, float, str, bool)) \
        else type(x).__name__


class HybridBlock(Block):
    """A Block with ``hybridize`` and deferred shapes (see the module's
    docstring)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._flags: Dict[str, Any] = {}
        self._cached_op: Optional[CachedOp] = None

    def hybridize(self, active: bool = True, static_alloc: bool = False,
                  static_shape: bool = False, inline_limit: int = 2,
                  forward_bulk_size: Optional[int] = None,
                  backward_bulk_size: Optional[int] = None) -> None:
        self._active = active
        self._flags = {"static_alloc": static_alloc,
                       "static_shape": static_shape}
        self._cached_op = None
        super().hybridize(active, static_alloc=static_alloc,
                          static_shape=static_shape)

    def cast(self, dtype) -> "HybridBlock":
        self._cached_op = None
        return super().cast(dtype)

    def infer_shape(self, *args) -> None:
        """Set the deferred shapes from the first call's inputs; the
        layers override it."""
        raise MXNetError(
            f"{type(self).__name__} has deferred-initialized parameters but "
            "no infer_shape(); give the shapes or override infer_shape")

    def _deferred_infer_shape(self, *args) -> None:
        self.infer_shape(*args)
        for param in self._reg_params.values():
            if param._deferred is not None:
                param._finish_deferred_init()

    def _finish_deferred(self, *args) -> None:
        """At the top of a layer's forward: finish deferred shapes."""
        for param in self._reg_params.values():
            if param._deferred is not None:
                self._deferred_infer_shape(*args)
                return

    def _leaf_params(self) -> List[Parameter]:
        if self._active:
            return self._cached_op_for().params()
        return super()._leaf_params()

    def _cached_op_for(self) -> CachedOp:
        if self._cached_op is None:
            self._cached_op = CachedOp(self, self._flags)
        return self._cached_op

    def _run(self, args, kwargs):
        if self._active:
            return self._cached_op_for()(args, kwargs)
        return super()._run(args, kwargs)

    def forward(self, x, *args):
        """Gluon's dispatch: ``hybrid_forward(F, x, *args, **params)``
        with this block's Parameters' tensors."""
        self._finish_deferred(x, *args)
        params = {name: p._tensor() for name, p in self._reg_params.items()}
        return self.hybrid_forward(F, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


@torch.no_grad()
def cast(model: nn.Module, dtype) -> nn.Module:
    """Cast every floating parameter and buffer of ``model`` to ``dtype``
    (a torch dtype or its name, ``"bfloat16"``) in place, BatchNorm's
    running stats too, as the JAX package casts every parameter (aux
    states included); memory formats are kept, and so is each
    ``nn.Parameter`` object (its ``.data`` is swapped; its gradient buffer
    is dropped).  The Gluon Parameters of the blocks in ``model`` take the
    new dtype.  Returns ``model``."""
    from ..ndarray.ndarray import dtype_torch

    dtype = dtype_torch(dtype)
    for t in list(model.parameters()) + list(model.buffers()):
        if t.is_floating_point():
            t.grad = None
            t.data = t.data.to(dtype)
    name = str(dtype).replace("torch.", "")
    for m in model.modules():
        for p in getattr(m, "_reg_params", {}).values():
            if p.dtype not in ("int32", "int64", "uint8", "int8", "bool"):
                p.dtype = name
    return model
