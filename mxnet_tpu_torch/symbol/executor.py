"""Executor: a bound symbolic graph.

Counterpart of ``mxnet_tpu/symbol/executor.py``.  ``bind`` captures the
argument arrays; ``forward`` runs the graph eagerly over the registry ops
(``symbol.build_graph_eval``), on the device of the arrays (``ctx``, the
card unless the CPU is given).  With ``is_train=True`` it records torch's
autograd, and only for the floating arguments whose ``grad_req`` is not
``"null"`` (each becomes a leaf for that run); ``backward`` takes
``torch.autograd.grad`` of the outputs (a cotangent of ones unless
``out_grads`` are given; a head such as ``SoftmaxOutput`` ignores it, as
in MXNet) and writes (``"write"``) or adds (``"add"``) it into the
pre-allocated gradient arrays in place, so their storage never moves.
``forward`` also copies its keyword inputs into the bound arrays in place.

Departure: the JAX executor jits a forward and a backward function; the
port has no trace, so it keeps the JAX executor's telemetry step records
but books no compile (``traced`` is never set).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..base import MXNetError
from .symbol import Symbol, build_graph_eval

__all__ = ["Executor"]


def _assign(arr, value) -> None:
    """Put ``value`` (an NDArray, tensor or array-like) into ``arr``: in
    place when the shape matches, else swapped in."""
    from ..ndarray import NDArray, array

    if isinstance(value, NDArray):
        t = value._data
    elif isinstance(value, torch.Tensor):
        t = value
    else:
        t = array(value, ctx=arr._ctx, dtype=arr.dtype)._data
    t = t.detach()
    if tuple(t.shape) == arr.shape:
        with torch.no_grad():
            arr._data.copy_(t)
    else:
        arr._set_data(t.to(device=arr._ctx, dtype=arr._data.dtype))


class Executor:
    def __init__(self, symbol: Symbol, ctx=None, args=None, args_grad=None,
                 grad_req="write", aux_states=None):
        from ..context import resolve_device

        self._symbol = symbol
        self._ctx = resolve_device(ctx)
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()

        self.arg_dict = _as_dict(args, arg_names, "args")
        self.aux_dict = _as_dict(aux_states, aux_names, "aux_states")
        self.grad_req: Dict[str, str] = _req_dict(grad_req, arg_names)
        self.grad_dict = _as_dict(args_grad, arg_names, "args_grad",
                                  partial=True)
        self.outputs: List = []
        self._eval: Dict[bool, object] = {}
        self._graph = None

    _tele_counter = 0

    def _tele_name(self) -> str:
        """This executor's telemetry key, made at its first record."""
        name = getattr(self, "_tele_key", None)
        if name is None:
            Executor._tele_counter += 1
            name = self._tele_key = (
                f"Executor:{self._symbol.name or 'sym'}"
                f"#{Executor._tele_counter}")
        return name

    # -- construction helpers ---------------------------------------------
    @classmethod
    def _simple_bind(cls, symbol: Symbol, ctx, grad_req, type_dict, shapes):
        from ..context import resolve_device
        from ..ndarray import zeros

        ctx = resolve_device(ctx)
        type_dict = type_dict or {}
        arg_names = symbol.list_arguments()
        aux_names = symbol.list_auxiliary_states()
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shapes)

        args = {}
        for name, shp in zip(arg_names, arg_shapes):
            dtype = type_dict.get(name, "float32")
            args[name] = zeros(shp, ctx=ctx, dtype=dtype)
        aux = {}
        for name, shp in zip(aux_names, aux_shapes):
            aux[name] = zeros(shp, ctx=ctx, dtype=type_dict.get(name,
                                                                "float32"))

        req = _req_dict(grad_req, arg_names)
        grads = {}
        for name in arg_names:
            if req.get(name, "null") != "null":
                grads[name] = zeros(args[name].shape, ctx=ctx,
                                    dtype=type_dict.get(name, "float32"))
        return cls(symbol, ctx=ctx, args=args, args_grad=grads,
                   grad_req=req, aux_states=aux)

    # -- forward -----------------------------------------------------------
    def forward(self, is_train: bool = False, **kwargs):
        import time as _time

        from ..ndarray import NDArray
        from .. import telemetry

        self._monitor_ran = True  # mx.Monitor: this executor ran

        for name, val in kwargs.items():
            if name not in self.arg_dict:
                raise MXNetError(f"unknown argument {name!r}")
            _assign(self.arg_dict[name], val)

        feed = {name: a._data for name, a in self.arg_dict.items()}
        feed.update({name: a._data for name, a in self.aux_dict.items()})
        leaves = {}
        if is_train:
            leaves = {name: feed[name].detach().requires_grad_(True)
                      for name, req in self.grad_req.items()
                      if req != "null" and name in feed
                      and feed[name].is_floating_point()}
            feed.update(leaves)
        fn = self._eval.get(is_train)
        if fn is None:
            fn = self._eval[is_train] = build_graph_eval(
                self._symbol._entries, is_train)

        t0 = _time.perf_counter()
        with torch.set_grad_enabled(bool(leaves)):
            outs = fn(feed)
        if telemetry.enabled():
            self._tele_steps = getattr(self, "_tele_steps", 0) + 1
            telemetry.record_step(self._tele_name(), step=self._tele_steps,
                                  wall_s=_time.perf_counter() - t0,
                                  traced=False)
        self.outputs = [NDArray(o.detach(), ctx=self._ctx) for o in outs]
        self._graph = (outs, leaves) if is_train else None
        return self.outputs

    # -- backward ----------------------------------------------------------
    def backward(self, out_grads=None):
        from ..ndarray import NDArray

        if self._graph is None:
            raise MXNetError("backward called before forward(is_train=True)")
        outs, leaves = self._graph
        self._graph = None
        if out_grads is None:
            ograds = [torch.ones_like(o) for o in outs]
        else:
            if isinstance(out_grads, NDArray):
                out_grads = [out_grads]
            ograds = [g._data for g in out_grads]
        pairs = [(o, g) for o, g in zip(outs, ograds) if o.requires_grad]
        names = [n for n in leaves if n in self.grad_dict]
        grads = [None] * len(names)
        if pairs and names:
            grads = torch.autograd.grad(
                [o for o, _ in pairs], [leaves[n] for n in names],
                grad_outputs=[g for _, g in pairs], allow_unused=True)
        with torch.no_grad():
            for name, g in zip(names, grads):
                tgt = self.grad_dict[name]._data
                if self.grad_req[name] == "add":
                    if g is not None:
                        tgt.add_(g)
                elif g is None:
                    tgt.zero_()
                else:
                    tgt.copy_(g)

    # -- accessors ---------------------------------------------------------
    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._symbol.list_arguments()]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n)
                for n in self._symbol.list_arguments()]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n]
                for n in self._symbol.list_auxiliary_states()]

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for name, val in (arg_params or {}).items():
            if name in self.arg_dict:
                _assign(self.arg_dict[name], val)
            elif not allow_extra_params:
                raise MXNetError(f"unknown arg param {name!r}")
        for name, val in (aux_params or {}).items():
            if name in self.aux_dict:
                _assign(self.aux_dict[name], val)
            elif not allow_extra_params:
                raise MXNetError(f"unknown aux param {name!r}")

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **shapes):
        """Rebind with new input shapes, carrying over the parameter and
        aux values whose shapes are unchanged."""
        new = Executor._simple_bind(self._symbol, self._ctx,
                                    self.grad_req, None, shapes)
        for name, arr in self.arg_dict.items():
            tgt = new.arg_dict.get(name)
            if tgt is not None and tgt.shape == arr.shape:
                _assign(tgt, arr)
        for name, arr in self.aux_dict.items():
            tgt = new.aux_dict.get(name)
            if tgt is not None and tgt.shape == arr.shape:
                _assign(tgt, arr)
        return new


def _as_dict(values, names, what, partial=False):
    from ..ndarray import NDArray

    if values is None:
        return {}
    if isinstance(values, dict):
        for k in values:
            if k not in names:
                raise MXNetError(f"{what}: unknown name {k!r}")
        return dict(values)
    values = list(values)
    if not partial and len(values) != len(names):
        raise MXNetError(f"{what}: expected {len(names)} arrays "
                         f"({names}), got {len(values)}")
    out = {}
    for name, v in zip(names, values):
        if v is not None:
            if not isinstance(v, NDArray):
                raise MXNetError(f"{what}: {name} is not an NDArray")
            out[name] = v
    return out


def _req_dict(grad_req, arg_names):
    if isinstance(grad_req, str):
        return {n: grad_req for n in arg_names}
    if isinstance(grad_req, (list, tuple)):
        return dict(zip(arg_names, grad_req))
    if isinstance(grad_req, dict):
        return {n: grad_req.get(n, "null") for n in arg_names}
    raise MXNetError("grad_req must be str, list, or dict")
