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
    ``register_child`` and ``hybridize``.  Forward hooks keep Gluon's
    signatures (``register_forward_pre_hook(hook(block, args))``,
    ``register_forward_hook(hook(block, args, out))``) and run as
    torch's; inside a call with NDArrays they get NDArrays, on the block
    and on every block below it, as the JAX hooks do (their return value
    is then ignored, as there).

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
A.1).

A third call convention writes the graph: called with a ``Symbol``, a
``HybridBlock`` calls its ``hybrid_forward(F=mx.sym, x, ...,
**{name: param.var()})`` (a ``Block`` its ``forward``), so the layers
that define ``hybrid_forward`` (the JAX layers' own bodies) compose the JAX
package's graph.  ``export`` writes that graph and the parameters keyed
``arg:`` / ``aux:`` (the JAX files), and :class:`SymbolBlock` runs a graph
(``SymbolBlock.imports`` of either package's files) through the executor's
graph evaluation; its Parameters are leaves like any block's.

:func:`cast` casts any ``torch.nn.Module`` (the port's models before they
were Gluon blocks used it, and still may).
"""
from __future__ import annotations

import contextlib
import functools
import re
import threading
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import torch
from torch import nn

from .. import autograd
from .. import operator as _operator
from .. import profiler as _profiler
from ..base import MXNetError
from ..ndarray.ndarray import NDArray
from ..symbol.symbol import Symbol, build_graph_eval
from .parameter import Parameter, ParameterDict

__all__ = ["Block", "HybridBlock", "CachedOp", "SymbolBlock", "cast"]


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


def _arrays_in(x):
    """The NDArrays in ``x``, through lists and tuples (a recurrent
    layer's state list)."""
    if isinstance(x, NDArray):
        return [x]
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in _arrays_in(v)]
    return []


# how deep this thread is in calls made with NDArrays: the hooks of the
# blocks run inside one get NDArrays
_nd_call = threading.local()


def _gluon_hook(hook):
    """``hook`` as a torch hook: inside an NDArray call it gets NDArrays
    (the children are called with tensors), outside it is torch's."""
    @functools.wraps(hook)
    def run(module, *rest):
        if getattr(_nd_call, "depth", 0):
            hook(module, *(_wrap(r) for r in rest))
            return None
        return hook(module, *rest)

    return run


@contextlib.contextmanager
def _on_replicas(swap):
    """Each (Parameter, tensor) of ``swap``: the tensor stands in the
    owning module's slot for the call, the Parameter's own after it."""
    saved = []
    try:
        for p, t in swap:
            slots = (p._owner._parameters if p._attr in p._owner._parameters
                     else p._owner._buffers)
            saved.append((slots, p._attr, slots[p._attr]))
            slots[p._attr] = t
        yield
    finally:
        for slots, attr, t in reversed(saved):
            slots[attr] = t


def _has_nd(args, kwargs) -> bool:
    return (any(isinstance(a, NDArray) for a in args)
            or any(isinstance(v, NDArray) for v in kwargs.values()))


class _TensorOps:
    """``F`` of ``hybrid_forward`` in the port: the registered ops' torch
    functions by name (``F.FullyConnected``; ``F.concat``, ``flatten``
    and ``cast`` are ``Concat``, ``Flatten`` and ``Cast``, as in
    ``mx.sym`` and ``mx.nd``), then torch's.  ``F.Custom`` is
    ``nd.Custom``, which takes tensors too: a user op is no registered
    op, in the JAX package either."""

    _ALIASES = {"concat": "Concat", "flatten": "Flatten", "cast": "Cast"}
    Custom = staticmethod(_operator.Custom)

    def __getattr__(self, name):
        from ..ops import registry

        try:
            return registry.get_op(self._ALIASES.get(name, name)).fn
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

    def register_forward_pre_hook(self, hook, *args, **kwargs):
        return super().register_forward_pre_hook(_gluon_hook(hook), *args,
                                                 **kwargs)

    def register_forward_hook(self, hook, *args, **kwargs):
        return super().register_forward_hook(_gluon_hook(hook), *args,
                                             **kwargs)

    # ------------------------------------------------------------------
    def __call__(self, *args, **kwargs):
        if args and isinstance(args[0], Symbol):
            return self._call_symbol(*args, **kwargs)
        if _has_nd(args, kwargs):
            return self._call_nd(args, kwargs)
        return super().__call__(*args, **kwargs)

    def _call_symbol(self, *args, **kwargs):
        """The graph-writing call: ``forward`` on Symbols."""
        return self.forward(*args, **kwargs)

    def _call_nd(self, args, kwargs, run=None):
        """The MXNet call convention (see the module's docstring);
        ``run(*tensors, **tensors)`` replaces the forward (a recurrent
        cell's ``unroll``)."""
        train = autograd.is_training()
        # every module, not only this one: a child shared with another
        # block (a detector inside its loss block) may have been left in
        # the other mode by a call through that block
        if any(m.training != train for m in self.modules()):
            self.train(train)
        recording = autograd.is_recording()
        views, swap = self._replica_call(_arrays_in(list(args)
                                                    + list(kwargs.values())))
        if recording:
            autograd.register_leaves(
                views.get(id(p), p._view) for p in self._leaf_params()
                if p.grad_req != "null"
                and (p._inited or p._deferred is not None))
            autograd.register_leaves(_arrays_in(list(args)
                                                + list(kwargs.values())))
        targs = [_unwrap(a) for a in args]
        tkwargs = {k: _unwrap(v) for k, v in kwargs.items()}
        _nd_call.depth = getattr(_nd_call, "depth", 0) + 1
        try:
            with torch.set_grad_enabled(recording):
                with _on_replicas(swap):
                    out = (self._run(targs, tkwargs) if run is None
                           else run(*targs, **tkwargs))
        finally:
            _nd_call.depth -= 1
        return _wrap(out)

    def _replica_call(self, arrays):
        """For a call with NDArrays of a context that is not the first of
        the Parameters' device list: ({id(Parameter): that context's data
        view}, [(Parameter, that context's tensor)]); empty otherwise."""
        if not Parameter.any_replicas:
            return {}, []
        ctx = next((a.context for a in arrays), None)
        if ctx is None:
            return {}, []
        views, swap = {}, []
        for p in self._leaf_params():
            if p._replicas and p._owner is not None and ctx in p.list_ctx():
                i = p._index(ctx)
                if i:
                    views[id(p)] = p._replica_views[i - 1]
                    swap.append((p, p._replicas[i - 1]))
        return views, swap

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
        if _profiler._running:
            return _profiler.timed_call(
                f"CachedOp:{type(self.block).__name__}", self._run, args,
                kwargs)
        return self._run(args, kwargs)

    def _run(self, args, kwargs):
        # the block's ops run as the JAX CachedOp's traced ones: their
        # profiler sites record nothing inside the timed call, and an
        # Embedding's gradient stays dense (autograd.traced)
        with autograd.traced():
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

    def _call_symbol(self, *args, **kwargs):
        """``hybrid_forward`` with ``F = mx.sym`` and the Parameters as
        graph variables (``Parameter.var``)."""
        from .. import symbol as _sym

        params = {name: p.var() for name, p in self._reg_params.items()}
        return self.hybrid_forward(_sym, *args, **kwargs, **params)

    def export(self, path: str, epoch: int = 0, input_names=("data",)):
        """Write ``{path}-symbol.json`` and ``{path}-{epoch:04d}.params``:
        the graph of ``hybrid_forward`` over Symbols named
        ``input_names``, and every Parameter (Gluon layout) keyed
        ``aux:`` when the graph reads it as an auxiliary state, else
        ``arg:``.  Returns the graph's Symbol."""
        from .. import symbol as _sym
        from ..ndarray import utils

        out = self(*[_sym.var(n) for n in input_names])
        if isinstance(out, (list, tuple)):
            out = _sym.Group(out)
        out.save(f"{path}-symbol.json")

        aux_names = set(out.list_auxiliary_states())
        save_dict = {}
        for param in self.collect_params().values():
            if not param._inited:
                raise MXNetError(
                    f"export: parameter {param.name!r} is not initialized "
                    "(run one forward to resolve deferred shapes first)")
            key = (f"aux:{param.name}" if param.name in aux_names
                   else f"arg:{param.name}")
            save_dict[key] = param._reduce()
        utils.save(f"{path}-{epoch:04d}.params", save_dict)
        return out


class SymbolBlock(HybridBlock):
    """A block around a symbol graph (Gluon's ``SymbolBlock``).

    The graph's non-input arguments become Parameters (``grad_req``
    ``"write"``) and its auxiliary states Parameters with ``"null"``, by
    their graph names; their shapes come from shape inference at the
    first call when not loaded.  A call runs the graph eagerly
    (``symbol.build_graph_eval``) on the inputs' device, in the block's
    train mode (MXNet's flag on an NDArray call); in training, BatchNorm
    moves its moving stats in place.  Called with Symbols it splices its
    graph onto them by input name."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix="", params=params)
        from .. import symbol as _sym

        if isinstance(outputs, (list, tuple)):
            outputs = _sym.Group(outputs)
        if not isinstance(inputs, (list, tuple)):
            inputs = [inputs]
        self._sym = outputs
        self._sym_input_names = [s.name for s in inputs]
        arg_names = outputs.list_arguments()
        self._sym_aux_names = list(outputs.list_auxiliary_states())
        self._sym_param_names = [n for n in arg_names
                                 if n not in self._sym_input_names]
        for n in self._sym_param_names:
            self._reg_params[n] = self.params.get(
                n, grad_req="write", allow_deferred_init=True)
        for n in self._sym_aux_names:
            self._reg_params[n] = self.params.get(
                n, grad_req="null", allow_deferred_init=True)
        self._evals: Dict[bool, Any] = {}

    @staticmethod
    def imports(symbol_file, input_names, param_file=None, ctx=None):
        """A SymbolBlock of ``symbol_file``'s graph, its Parameters loaded
        from ``param_file`` (``arg:`` / ``aux:`` keys) onto ``ctx`` (the
        card unless the CPU is given)."""
        from .. import symbol as _sym
        from ..ndarray import utils

        sym = _sym.load(symbol_file)
        if isinstance(input_names, str):
            input_names = [input_names]
        ret = SymbolBlock(sym, [_sym.var(n) for n in input_names])
        if param_file is not None:
            raw = utils.load(param_file)
            for k, v in raw.items():
                tp, _, name = k.partition(":")
                name = name if tp in ("arg", "aux") else k
                if name in ret._reg_params:
                    ret._reg_params[name]._load_init(v, ctx=ctx)
        return ret

    def _infer_sym_param_shapes(self, *args):
        shapes = {n: tuple(a.shape)
                  for n, a in zip(self._sym_input_names, args)}
        arg_shapes, _, aux_shapes = self._sym.infer_shape(**shapes)
        for name, shp in zip(self._sym.list_arguments(), arg_shapes):
            if name in self._reg_params:
                self._reg_params[name]._set_shape_if_deferred(shp)
                self._reg_params[name]._finish_deferred_init()
        for name, shp in zip(self._sym_aux_names, aux_shapes):
            self._reg_params[name]._set_shape_if_deferred(shp)
            self._reg_params[name]._finish_deferred_init()

    def _call_symbol(self, x, *args):
        mapping = dict(zip(self._sym_input_names, [x, *args]))
        return self._sym(**mapping)

    def forward(self, x, *args):
        if any(p._deferred is not None for p in self._reg_params.values()):
            self._infer_sym_param_shapes(x, *args)
        for p in self._reg_params.values():
            p._check_initialized()
        fn = self._evals.get(self.training)
        if fn is None:
            fn = self._evals[self.training] = build_graph_eval(
                self._sym._entries, self.training)
        vals = dict(zip(self._sym_input_names, [x, *args]))
        vals.update({n: p._tensor() for n, p in self._reg_params.items()})
        outs = fn(vals)
        return outs[0] if len(outs) == 1 else list(outs)

    def hybrid_forward(self, F, *args, **kwargs):
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
