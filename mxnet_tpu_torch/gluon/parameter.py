"""Gluon ``Parameter`` / ``ParameterDict`` over torch tensors.

Counterpart of ``mxnet_tpu/gluon/parameter.py``.  A Gluon ``Parameter`` is
a name, a ``grad_req``, ``lr_mult`` / ``wd_mult``, an initializer and a
(possibly deferred) Gluon shape, wrapped around one torch tensor: the
``nn.Parameter`` (or, for BatchNorm's running stats, the buffer) that the
owning module holds under ``attr``, looked up on the module each time, so
``Module.to`` and ``cast`` never leave it stale.  A Parameter made on its
own (``ParameterDict.get`` outside a layer) owns an ``nn.Parameter``.

  * ``data()`` and ``grad()`` are NDArrays over that tensor and over its
    ``.grad``, sharing storage: what the Trainer, the kvstore or
    ``set_data`` writes into them is copied into the module's tensor in
    place, never rebinding it.  The gradient buffer is made (zeros) on
    first use, so a net that never trains through Gluon holds none;
  * ``lr_mult`` / ``wd_mult`` are also set as attributes of the
    ``nn.Parameter``, which is what ``parallel.DataParallelStep`` reads, so
    a net set up through Gluon trains the same under both;
  * ``grad_req="null"`` turns ``requires_grad`` off; ``write`` and ``add``
    are applied by ``autograd.backward`` (``add`` accumulates until
    ``zero_grad``);
  * a shape with a 0 (an input width not given) is deferred: the tensor
    is torch's ``UninitializedParameter`` (``UninitializedBuffer``) until
    the layer's first call infers the shape (``HybridBlock.infer_shape``)
    and the deferred ``initialize`` materializes and fills it.  Reading it
    before raises ``DeferredInitializationError``;
  * values cross the package boundary (initializers, ``set_data``, files)
    in Gluon's layout; the owning layer's ``from_gluon`` / ``to_gluon``
    hooks turn them into its own (an NHWC convolution's (O, kh, kw, I)
    weight is torch's OIHW in ``channels_last`` memory).

``grad_stype="row_sparse"`` (``Embedding(sparse_grad=True)``'s weight)
keeps the weight dense and gives it a ``RowSparseNDArray`` gradient
buffer, empty until ``autograd.backward`` writes the looked-up rows into
it (``zero_grad`` empties it again), as the JAX Parameter does; ``stype``
is recorded and the weight stays dense, as there.

A Parameter initialized on a device list (``ctx=[gpu(0), gpu(1)]``,
``[cpu(0), cpu(1)]``) keeps the module's tensor on the first context and
a copy of it on each other one (``list_data``, ``list_grad``,
``list_ctx``; ``data(ctx)`` / ``grad(ctx)`` pick one).  Distinct ``cpu(i)``
contexts are distinct copies, though torch has one CPU device.  A block
called with NDArrays of another context of the list runs on that
context's copies: each copy stands in its owning module's slot for the
call (``block._on_replicas``; ``torch.func.functional_call`` would not
run a block's replacement forward, such as a recurrent cell's
``unroll``), so its gradients land in that copy's buffer; ``set_data``
and the initializer write every copy.

Departure: the initializers draw from the CPU generator of ``random``,
not numpy's.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional

import numpy as np
import torch
from torch import nn
from torch.nn.parameter import UninitializedBuffer, UninitializedParameter

from ..base import MXNetError, tensor_from_numpy
from ..context import Context, default_device, resolve_device
from ..ndarray.ndarray import NDArray, dtype_torch

__all__ = ["Parameter", "Constant", "ParameterDict",
           "DeferredInitializationError"]

_UNINIT = (UninitializedParameter, UninitializedBuffer)


class DeferredInitializationError(MXNetError):
    """A Parameter read before its shape is known."""


def _shape_known(shape) -> bool:
    return shape is not None and all(s > 0 for s in shape)


def _dtype_name(dtype) -> str:
    return str(dtype_torch(dtype)).replace("torch.", "")


def one_device(ctx) -> torch.device:
    """The device of ``ctx`` (None, a device, or a list whose first entry
    counts); None is the card (``context.default_device``)."""
    if ctx is None:
        return default_device()
    if isinstance(ctx, (list, tuple)):
        if not ctx:
            raise MXNetError("an empty device list")
        ctx = ctx[0]
    dev = resolve_device(ctx)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def contexts(ctx) -> List[Context]:
    """``ctx`` (None, a context or device, or a list of them) as a list of
    Contexts; None is the card."""
    if ctx is None:
        return [Context.from_device(default_device())]
    if not isinstance(ctx, (list, tuple)):
        ctx = [ctx]
    if not ctx:
        raise MXNetError("an empty device list")
    out = [c if isinstance(c, Context)
           else Context.from_device(one_device(c)) for c in ctx]
    if len(set(out)) != len(out):
        raise MXNetError(f"a context appears twice in {out}")
    return out


def _as_tensor(data) -> torch.Tensor:
    if isinstance(data, NDArray):
        return data._data.detach()
    if isinstance(data, torch.Tensor):
        return data.detach()
    return tensor_from_numpy(np.asarray(data))


class _View(NDArray):
    """An NDArray over a tensor a Parameter resolves on each access;
    writes (``_set_data``) go into that tensor in place."""

    __slots__ = ("_param",)

    def __init__(self, param: "Parameter"):
        self._param = param
        self._version = 0
        self._grad = None
        self._grad_req = "write"

    def _tensor(self) -> torch.Tensor:
        raise NotImplementedError

    def __reduce__(self):
        # copied (``copy.deepcopy`` of a net) as the view of the copied
        # Parameter, never by reading the tensor through ``_data``
        return (type(self), (self._param,), (self._grad, self._grad_req))

    def __setstate__(self, state):
        self._grad, self._grad_req = state
        self._version = 0

    @property
    def _data(self):
        return self._tensor()

    @_data.setter
    def _data(self, new):
        self._set_data(new)

    @property
    def _ctx(self):
        return self._tensor().device

    def _set_data(self, new: torch.Tensor) -> None:
        with torch.no_grad():
            self._tensor().copy_(new)
        self._version += 1


class _DataView(_View):
    __slots__ = ()

    def _tensor(self):
        return self._param._tensor()


class _GradView(_View):
    __slots__ = ()

    def _tensor(self):
        return self._param._grad_tensor()


class _ReplicaView(_View):
    """The copy of a Parameter on context ``i`` (> 0) of its list."""
    __slots__ = ("_i",)

    def __init__(self, param: "Parameter", i: int):
        super().__init__(param)
        self._i = i

    def __reduce__(self):
        return (type(self), (self._param, self._i),
                (self._grad, self._grad_req))

    def _tensor(self):
        return self._param._replicas[self._i - 1]

    @property
    def context(self):
        return self._param.list_ctx()[self._i]

    ctx = context


class _ReplicaGradView(_ReplicaView):
    __slots__ = ()

    def _tensor(self):
        t = self._param._replicas[self._i - 1]
        if t.grad is None:
            t.grad = torch.zeros_like(t)
        return t.grad


class Parameter:
    # set once any Parameter holds copies on a device list: a block's
    # NDArray call looks for them only then
    any_replicas = False

    def __init__(self, name: str, grad_req: str = "write", shape=None,
                 dtype="float32", lr_mult: float = 1.0, wd_mult: float = 1.0,
                 init=None, allow_deferred_init: bool = False,
                 differentiable: bool = True, stype: str = "default",
                 grad_stype: str = "default"):
        if grad_req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {grad_req!r}")
        self.name = name
        self.shape = tuple(shape) if shape is not None else None
        self.dtype = _dtype_name(dtype)
        self.init = init
        self.allow_deferred_init = allow_deferred_init
        self.stype = stype
        self.grad_stype = grad_stype
        self._sparse_grad = None  # the row_sparse gradient buffer
        self._grad_req = grad_req if differentiable else "null"
        self._lr_mult = float(lr_mult)
        self._wd_mult = float(wd_mult)
        self._owner: Optional[nn.Module] = None
        self._attr: Optional[str] = None
        self._own = UninitializedParameter(
            requires_grad=self._grad_req != "null")
        self._inited = False
        self._deferred = None  # (init, device) awaiting the shape
        self._trainer = None
        self._view = _DataView(self)
        self._grad_view = _GradView(self)
        # a device list: its Contexts, and the copies on all but the first
        self._ctx_list: Optional[List[Context]] = None
        self._replicas: List[torch.Tensor] = []
        self._replica_views: List[_ReplicaView] = []
        self._sync_grad_state()

    def __repr__(self):
        return (f"Parameter {self.name} (shape={self.shape}, "
                f"dtype={self.dtype})")

    # ------------------------------------------------------------------
    # the tensor
    # ------------------------------------------------------------------
    def _tensor(self) -> torch.Tensor:
        if self._owner is not None:
            return getattr(self._owner, self._attr)
        return self._own

    def _bind(self, owner: nn.Module, attr: str) -> None:
        """Make the tensor ``owner.<attr>`` this Parameter's; a Parameter
        bound already (shared through ``params=``) puts its own tensor
        there instead."""
        if self._owner is not None and (self._owner is not owner
                                        or self._attr != attr):
            t = self._tensor()
            if isinstance(t, nn.Parameter):
                owner.register_parameter(attr, t)
            else:
                owner.register_buffer(attr, t)
            return
        self._owner, self._attr, self._own = owner, attr, None
        self._sync_grad_state()

    def _grad_tensor(self) -> torch.Tensor:
        t = self._tensor()
        if t.grad is None:
            t.grad = torch.zeros_like(t)
        return t.grad

    def _sync_grad_state(self) -> None:
        t = self._tensor()
        if isinstance(t, nn.Parameter):
            want = self._grad_req != "null"
            if t.requires_grad != want and (t.is_floating_point()
                                            or not want):
                t.requires_grad = want
            if not want:
                t.grad = None
            t.lr_mult, t.wd_mult = self._lr_mult, self._wd_mult
        for r, view in zip(self._replicas, self._replica_views):
            if isinstance(r, nn.Parameter):
                want = self._grad_req != "null"
                r.requires_grad = want and r.is_floating_point()
                if not want:
                    r.grad = None
                r.lr_mult, r.wd_mult = self._lr_mult, self._wd_mult
            view._grad_req = self._grad_req
            view._grad = (None if self._grad_req == "null" else
                          view._grad or _ReplicaGradView(self, view._i))
        grad = self._grad_view
        if self.grad_stype == "row_sparse":
            grad = self._sparse_grad_buffer(t)
        self._view._grad = None if self._grad_req == "null" else grad
        self._view._grad_req = self._grad_req

    def _sparse_grad_buffer(self, t: torch.Tensor):
        """The row_sparse gradient buffer on the tensor's device and in its
        dtype (None while the tensor is uninitialized)."""
        from ..ndarray.sparse import RowSparseNDArray

        if isinstance(t, _UNINIT):
            return None
        buf = self._sparse_grad
        if (buf is None or buf._ctx != t.device or buf._data.dtype != t.dtype
                or buf.shape != tuple(t.shape)):
            buf = self._sparse_grad = RowSparseNDArray(
                t.new_zeros((0,) + tuple(t.shape[1:])).detach(),
                {"indices": torch.zeros((0,), dtype=torch.int64,
                                        device=t.device)},
                tuple(t.shape), ctx=t.device)
        return buf

    def _from_gluon(self, value: torch.Tensor) -> torch.Tensor:
        hook = getattr(self._owner, "from_gluon", None)
        return value if hook is None else hook(self._attr, value)

    def _to_gluon(self, value: torch.Tensor) -> torch.Tensor:
        hook = getattr(self._owner, "to_gluon", None)
        return value if hook is None else hook(self._attr, value)

    @torch.no_grad()
    def _store(self, value: torch.Tensor) -> None:
        """Make ``value`` (in the tensor's layout, on its final device and
        dtype, owned by no one else) the tensor's contents: copied in
        place when it fits, else swapped in as the ``nn.Parameter``'s
        ``.data`` (the module keeps the same object) or as the buffer."""
        t = self._tensor()
        if isinstance(t, _UNINIT):
            t.materialize(value.shape, device=value.device, dtype=value.dtype)
            t = self._tensor()
        if (t.shape == value.shape and t.device == value.device
                and t.dtype == value.dtype and t.stride() == value.stride()):
            t.copy_(value)
        elif isinstance(t, nn.Parameter):
            t.grad = None
            t.data = value
        else:
            self._owner._buffers[self._attr] = value
        self._sync_grad_state()

    def _store_gluon(self, value: torch.Tensor, device) -> None:
        self._store(self._from_gluon(value).to(
            device=device, dtype=dtype_torch(self.dtype), copy=True))
        self._inited = True
        self._deferred = None
        self._sync_replicas()

    @torch.no_grad()
    def _sync_replicas(self) -> None:
        """One copy of the tensor on each context of the list but the
        first (fresh gradients), with the views over them."""
        ctxs = self._ctx_list or []
        t = self._tensor()
        self._replicas, self._replica_views = [], []
        for i, c in enumerate(ctxs[1:], start=1):
            r = t.detach().to(one_device(c), copy=True)
            if isinstance(t, nn.Parameter):
                r = nn.Parameter(r, requires_grad=t.requires_grad)
                r.lr_mult, r.wd_mult = self._lr_mult, self._wd_mult
            self._replicas.append(r)
            Parameter.any_replicas = True
            view = _ReplicaView(self, i)
            view._grad = (None if self._grad_req == "null"
                          else _ReplicaGradView(self, i))
            view._grad_req = self._grad_req
            self._replica_views.append(view)

    def _index(self, ctx) -> int:
        """The position of ``ctx`` in the context list (0 for None)."""
        if ctx is None:
            return 0
        c = ctx if isinstance(ctx, Context) else \
            Context.from_device(one_device(ctx))
        ctxs = self.list_ctx()
        for i, x in enumerate(ctxs):
            if x == c:
                return i
        raise MXNetError(f"parameter {self.name} not initialized on "
                         f"{ctx}; it lives on {ctxs}")

    def _gluon_data(self) -> torch.Tensor:
        """The value in Gluon's layout, a detached view."""
        self._check_initialized()
        return self._to_gluon(self._tensor().detach())

    # ------------------------------------------------------------------
    @property
    def grad_req(self) -> str:
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req: str):
        if req not in ("write", "add", "null"):
            raise MXNetError(f"invalid grad_req {req!r}")
        self._grad_req = req
        self._sync_grad_state()

    @property
    def lr_mult(self) -> float:
        return self._lr_mult

    @lr_mult.setter
    def lr_mult(self, value: float):
        self._lr_mult = float(value)
        self._sync_grad_state()

    @property
    def wd_mult(self) -> float:
        return self._wd_mult

    @wd_mult.setter
    def wd_mult(self, value: float):
        self._wd_mult = float(value)
        self._sync_grad_state()

    # ------------------------------------------------------------------
    # initialization
    # ------------------------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit: bool = False) -> None:
        """Fill the tensor by ``init`` (else the Parameter's own ``init``,
        else ``default_init``) on ``ctx`` (default: the card); with the
        shape unknown, defer to the first call."""
        if self._inited and not force_reinit:
            return
        ctxs = contexts(ctx)
        dev = one_device(ctxs[0])
        self._ctx_list = ctxs if len(ctxs) > 1 else None
        eff_init = init or self.init or default_init
        if not _shape_known(self.shape):
            if self.allow_deferred_init:
                self._deferred = (eff_init, dev)
                return
            raise MXNetError(
                f"cannot initialize {self.name}: shape {self.shape} unknown;"
                " set allow_deferred_init=True or give the full shape")
        self._init_impl(eff_init, dev)

    def _init_impl(self, eff_init, device) -> None:
        from .. import initializer as init_mod

        initializer = eff_init if isinstance(
            eff_init, (init_mod.Initializer, init_mod.Mixed)) \
            else init_mod.create(eff_init)
        self._store_gluon(initializer.init_array(self.name, self.shape),
                          device)

    def _finish_deferred_init(self) -> None:
        if self._deferred is None:
            return
        if not _shape_known(self.shape):
            raise DeferredInitializationError(
                f"parameter {self.name} shape still unknown")
        self._init_impl(*self._deferred)

    def _set_shape_if_deferred(self, shape) -> None:
        """Adopt an inferred Gluon shape, keeping the dims given."""
        if self.shape is None:
            self.shape = tuple(shape)
            return
        merged = []
        for have, got in zip(self.shape, shape):
            if have > 0 and got > 0 and have != got:
                raise MXNetError(
                    f"inferred shape {tuple(shape)} incompatible with "
                    f"declared {self.shape} for parameter {self.name}")
            merged.append(have if have > 0 else got)
        self.shape = tuple(merged)

    # ------------------------------------------------------------------
    # access
    # ------------------------------------------------------------------
    def _check_initialized(self, ctx=None) -> None:
        if not self._inited:
            if self._deferred is not None:
                raise DeferredInitializationError(
                    f"parameter {self.name} deferred (shape unknown yet)")
            raise MXNetError(f"parameter {self.name} has not been "
                             "initialized; call .initialize() first")
        if ctx is not None:
            self._index(ctx)

    def data(self, ctx=None) -> NDArray:
        self._check_initialized(ctx)
        i = self._index(ctx)
        return self._view if i == 0 else self._replica_views[i - 1]

    def list_data(self) -> List[NDArray]:
        self._check_initialized()
        return [self._view] + list(self._replica_views)

    def grad(self, ctx=None) -> NDArray:
        self._check_initialized(ctx)
        if self._grad_req == "null":
            raise MXNetError(f"parameter {self.name} has grad_req='null'")
        i = self._index(ctx)
        if i:
            if self.grad_stype == "row_sparse":
                raise MXNetError("a row_sparse gradient on a device list "
                                 "is not ported")
            return self._replica_views[i - 1]._grad
        if self.grad_stype == "row_sparse":
            return self._sparse_grad_buffer(self._tensor())
        return self._grad_view

    def list_grad(self) -> List[NDArray]:
        self._check_initialized()
        return [self.grad(c) for c in self.list_ctx()]

    def list_ctx(self) -> List[Context]:
        self._check_initialized()
        first = Context.from_device(self._tensor().device)
        if self._ctx_list is None:
            return [first]
        if self._ctx_list[0].device == self._tensor().device:
            return list(self._ctx_list)
        return [first] + list(self._ctx_list[1:])

    def set_data(self, data) -> None:
        """Overwrite the value (in Gluon's layout); on a Parameter not
        initialized yet this is its initialization, on its deferred
        device or the card."""
        value = _as_tensor(data)
        self.shape = tuple(value.shape)
        if self._inited:
            dev = self._tensor().device
        else:
            dev = self._deferred[1] if self._deferred else default_device()
        self._store_gluon(value, dev)

    def _reduce(self) -> torch.Tensor:
        return self._gluon_data()

    def _load_init(self, value, ctx=None, cast_dtype=False) -> None:
        """Load a value read from a file (always cast to the Parameter's
        dtype, as the JAX package does)."""
        shape = tuple(getattr(value, "shape", ()))
        if _shape_known(self.shape) and tuple(self.shape) != shape:
            raise MXNetError(f"parameter {self.name} shape {self.shape} != "
                             f"loaded {shape}")
        if ctx is not None and not self._inited:
            init = self._deferred[0] if self._deferred else None
            self._deferred = (init, one_device(ctx))
            ctxs = contexts(ctx)
            self._ctx_list = ctxs if len(ctxs) > 1 else None
        self.set_data(value)
        if ctx is not None and (self._tensor().device != one_device(ctx)
                                or contexts(ctx) != self.list_ctx()):
            self.reset_ctx(ctx)

    def zero_grad(self) -> None:
        t = self._tensor()
        if self._grad_req == "null":
            return
        if self.grad_stype == "row_sparse":
            buf = self._sparse_grad_buffer(t)
            if buf is not None:
                buf.zero()
        elif t.grad is not None:
            t.grad.zero_()
        for r in self._replicas:
            if r.grad is not None:
                r.grad.zero_()

    def reset_ctx(self, ctx) -> None:
        ctxs = contexts(ctx)
        self._check_initialized()
        self._ctx_list = ctxs if len(ctxs) > 1 else None
        self._store(self._tensor().detach().to(one_device(ctxs[0]),
                                               copy=True))
        self._sync_replicas()

    def cast(self, dtype) -> None:
        self.dtype = _dtype_name(dtype)
        if self._inited:
            self._store(self._tensor().detach().to(dtype_torch(dtype)))
            self._sync_replicas()

    def var(self):
        """The graph variable of this Parameter (its name, Gluon shape and
        dtype), for a block called with Symbols (``export``); one per
        Parameter, so a Parameter shared within a graph is one node."""
        from .. import symbol as _sym

        cached = getattr(self, "_var_sym", None)
        if cached is None:
            cached = _sym.var(self.name, shape=self.shape, dtype=self.dtype)
            self._var_sym = cached
        return cached


class _ConstInit:
    """Fills a Constant's value (an ``init_array`` look-alike)."""

    def __init__(self, value: torch.Tensor):
        self.value = value

    def init_array(self, name, shape, generator=None):
        return self.value.clone()


class Constant(Parameter):
    """A Parameter that is not learned (``grad_req="null"``), initialized
    to ``value``."""

    def __init__(self, name, value):
        t = _as_tensor(value)
        self.value = t
        super().__init__(name, grad_req="null", shape=t.shape,
                         dtype=t.dtype, init=None)
        self.init = _ConstInit(t)

    def _init_impl(self, eff_init, device) -> None:
        self._store_gluon(self.value, device)


class ParameterDict:
    """A prefix-scoped, ordered collection of Parameters."""

    def __init__(self, prefix: str = "",
                 shared: Optional["ParameterDict"] = None):
        self._prefix = prefix
        self._params: "OrderedDict[str, Parameter]" = OrderedDict()
        self._shared = shared

    @property
    def prefix(self) -> str:
        return self._prefix

    def __repr__(self):
        items = "\n".join(f"  {v}" for v in self._params.values())
        return f"ParameterDict '{self._prefix}' (\n{items}\n)"

    def __iter__(self):
        return iter(self._params)

    def __len__(self):
        return len(self._params)

    def __getitem__(self, key) -> Parameter:
        return self._params[key]

    def __contains__(self, key) -> bool:
        return key in self._params

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    def get(self, name: str, **kwargs) -> Parameter:
        """Get or create ``prefix + name``."""
        full = self._prefix + name
        param = self._get_impl(full)
        if param is None:
            param = Parameter(full, **kwargs)
            self._params[full] = param
        else:
            for k, v in kwargs.items():
                if k == "shape" and v is not None and param.shape is None:
                    param.shape = tuple(v)
                elif k == "init" and v is not None and param.init is None:
                    param.init = v
        return param

    def get_constant(self, name: str, value=None) -> Constant:
        full = self._prefix + name
        param = self._get_impl(full)
        if param is None:
            param = Constant(full, value)
            self._params[full] = param
        return param

    def _get_impl(self, full_name):
        if full_name in self._params:
            return self._params[full_name]
        if self._shared is not None and full_name in self._shared:
            self._params[full_name] = self._shared[full_name]
            return self._params[full_name]
        return None

    def update(self, other: "ParameterDict") -> None:
        for k, v in other.items():
            if k in self._params and self._params[k] is not v:
                raise MXNetError(f"duplicate parameter name {k}")
            self._params[k] = v

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False) -> None:
        """Initialize every Parameter; ``init`` (default ``Uniform(0.07)``)
        fills those without an initializer of their own."""
        from .. import initializer as init_mod

        default = init if init is not None else init_mod.Uniform(0.07)
        for param in self.values():
            param.initialize(None, ctx, default_init=default,
                             force_reinit=force_reinit)

    def zero_grad(self) -> None:
        for param in self.values():
            param.zero_grad()

    def reset_ctx(self, ctx) -> None:
        for param in self.values():
            param.reset_ctx(ctx)

    def setattr(self, name, value) -> None:
        for param in self.values():
            setattr(param, name, value)

    def save(self, filename: str, strip_prefix: str = "") -> None:
        from ..ndarray import utils

        arg_dict = {}
        for param in self.values():
            name = param.name
            if strip_prefix and name.startswith(strip_prefix):
                name = name[len(strip_prefix):]
            arg_dict[name] = param._reduce()
        utils.save(filename, arg_dict)

    def load(self, filename: str, ctx=None, allow_missing: bool = False,
             ignore_extra: bool = False, restore_prefix: str = "",
             loaded=None) -> None:
        from ..ndarray import utils

        if loaded is None:
            loaded = utils.load(filename)
        loaded = {restore_prefix + k: v for k, v in loaded.items()}
        if not allow_missing:
            for name in self.keys():
                if name not in loaded:
                    raise MXNetError(f"parameter {name} missing in "
                                     f"{filename}")
        for name, value in loaded.items():
            if name not in self._params:
                if ignore_extra:
                    continue
                raise MXNetError(f"parameter {name} in file not in model")
            self._params[name]._load_init(value, ctx)
