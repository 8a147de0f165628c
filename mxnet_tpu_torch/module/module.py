"""Module: the symbolic-era trainer over one bound Executor.

Counterpart of ``mxnet_tpu/module/module.py``.  ``bind`` makes one
executor on ``context`` (the card unless the CPU is given; a list takes its
first device, as the JAX Module does), with ``grad_req`` ``"null"`` for the
data and label inputs (unless ``inputs_need_grad``) and for
``fixed_param_names``.  ``init_params`` fills each parameter from
``arg_params`` / ``aux_params``, else from the variable's own ``__init__``
attribute (an ``mx.rnn`` LSTM's forget-gate bias), else from
``initializer`` (``Uniform(0.01)`` by default); values are copied into the
bound arrays in place.  ``update`` hands every (index, gradient, weight)
to the updater of ``optimizer.get_updater``: ``FusedUpdater.apply`` (one
multi-tensor call per group) unless ``MX_FUSED_UPDATE=0`` pins the
per-parameter updater.  ``update`` keeps the host at most
``MX_ASYNC_INFLIGHT`` (default 2) un-synced updates ahead of the card: it
admits a ``StepFence`` to the module's ``InflightRing`` after each update
and, past the window, first waits on the oldest (0 makes no fence);
``drain`` forces the window, and ``fit`` drains at each epoch's end.
``save_checkpoint`` / ``load`` are ``model``'s files, with the optimizer
states beside them.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..io.io import DataDesc
from ..symbol.executor import _assign
from .base_module import BaseModule

__all__ = ["Module"]


def _init_into(initializer, name, arr) -> None:
    """Fill ``arr`` in place by ``initializer``'s draw for ``name``."""
    _assign(arr, initializer.init_array(name, arr.shape))


class Module(BaseModule):
    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        from ..context import resolve_device

        self._symbol = symbol
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        ctx = context[0] if isinstance(context, (list, tuple)) else context
        self._context = resolve_device(ctx)
        arg_names = symbol.list_arguments()
        input_names = set(self._data_names) | set(self._label_names)
        self._param_names = [n for n in arg_names if n not in input_names]
        self._exec = None
        self._updater = None
        self._optimizer = None
        self._data_shapes = None
        self._label_shapes = None

    # -- binding -----------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        data_shapes = [_as_desc(d) for d in data_shapes]
        label_shapes = [_as_desc(l) for l in (label_shapes or [])]
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes

        shapes = {d.name: d.shape for d in data_shapes + label_shapes}
        self._inputs_need_grad = inputs_need_grad
        req = {}
        for name in self._symbol.list_arguments():
            if name in self._data_names:
                req[name] = grad_req if (inputs_need_grad
                                         and for_training) else "null"
            elif name in self._label_names:
                req[name] = "null"
            elif name in self._fixed_param_names or not for_training:
                req[name] = "null"
            else:
                req[name] = grad_req
        prev_exec = self._exec
        self._exec = self._symbol.simple_bind(ctx=self._context,
                                              grad_req=req, **shapes)
        if getattr(self, "_monitor", None) is not None:
            # force_rebind: keep the monitor on the live executor
            self._monitor.replace(prev_exec, self._exec)
        if shared_module is not None and shared_module._exec is not None:
            # share another module's arrays (BucketingModule): the same
            # NDArray objects
            for name, arr in shared_module._exec.arg_dict.items():
                if name in self._exec.arg_dict and name in self._param_names:
                    self._exec.arg_dict[name] = arr
            for name, arr in shared_module._exec.aux_dict.items():
                if name in self._exec.aux_dict:
                    self._exec.aux_dict[name] = arr
            for name, arr in shared_module._exec.grad_dict.items():
                if name in self._exec.grad_dict:
                    self._exec.grad_dict[name] = arr
        self.binded = True

    # -- parameters --------------------------------------------------------
    def install_monitor(self, mon) -> None:
        """Watch this module's executor arrays (``monitor``)."""
        if self._exec is None:
            raise MXNetError("bind() before install_monitor")
        self._monitor = mon
        mon.install(self._exec)

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False, allow_extra=False):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise MXNetError("call bind before init_params")
        preloaded = getattr(self, "_preloaded", None)
        if preloaded is not None and arg_params is None:
            arg_params, aux_params = preloaded
        from .. import initializer as _init
        from ..symbol.symbol import _topo_order

        default_init = initializer or _init.Uniform(0.01)
        # per-variable init attrs (an mx.rnn LSTMCell's forget-gate bias)
        # win over the module-level default
        var_inits = {}
        for node in _topo_order(self._symbol._entries):
            if node.is_variable():
                init_attr = (node.vattrs or {}).get("init")
                if init_attr is not None:
                    var_inits[node.name] = _init.create(init_attr)
        for name in self._param_names:
            arr = self._exec.arg_dict[name]
            if arg_params and name in arg_params:
                _assign(arr, arg_params[name])
            elif arg_params is not None and not allow_missing:
                raise MXNetError(
                    f"param {name!r} missing from arg_params "
                    f"(pass allow_missing=True to initialize it)")
            else:
                _init_into(var_inits.get(name, default_init), name, arr)
        for name, arr in self._exec.aux_dict.items():
            if aux_params and name in aux_params:
                _assign(arr, aux_params[name])
            elif aux_params is not None and not allow_missing:
                raise MXNetError(
                    f"aux state {name!r} missing from aux_params "
                    f"(pass allow_missing=True to initialize it)")
            else:
                _init_into(default_init, name, arr)
        self.params_initialized = True

    def get_params(self):
        arg = {n: self._exec.arg_dict[n].copyto(self._context)
               for n in self._param_names}
        aux = {n: a.copyto(self._context)
               for n, a in self._exec.aux_dict.items()}
        return arg, aux

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)

    # -- optimizer ---------------------------------------------------------
    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        if self.optimizer_initialized and not force_init:
            return
        from .. import optimizer as _opt

        if isinstance(optimizer, str):
            optimizer = _opt.create(optimizer, **dict(optimizer_params))
        self._optimizer = optimizer
        self._updater = _opt.get_updater(optimizer)
        states_file = getattr(self, "_preloaded_states", None)
        if states_file is not None:
            self.load_optimizer_states(states_file)
            self._preloaded_states = None
        self.optimizer_initialized = True

    # -- execution ---------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        if not self.binded:
            raise MXNetError("call bind before forward")
        if is_train is None:
            is_train = self.for_training
        feeds = {}
        for name, arr in zip(self._data_names, data_batch.data or []):
            feeds[name] = arr
        if data_batch.label:
            for name, arr in zip(self._label_names, data_batch.label):
                if name in self._exec.arg_dict:
                    feeds[name] = arr
        self._exec.forward(is_train=is_train, **feeds)

    def backward(self, out_grads=None):
        self._exec.backward(out_grads=out_grads)

    def update(self):
        if not self.optimizer_initialized:
            raise MXNetError("call init_optimizer before update")
        from ..parallel.async_loss import (InflightRing, StepFence,
                                           inflight_limit)

        limit = inflight_limit()
        if limit > 0:
            if getattr(self, "_inflight", None) is None:
                self._inflight = InflightRing("Module")
            self._inflight.make_room(limit)
        entries = []
        for i, name in enumerate(self._param_names):
            grad = self._exec.grad_dict.get(name)
            if grad is None:
                continue
            entries.append((i, grad, self._exec.arg_dict[name]))
        from ..optimizer.fused import FusedUpdater

        if isinstance(self._updater, FusedUpdater):
            # every parameter in one multi-tensor call per group
            info = self._updater.apply(entries)
            from .. import telemetry

            if telemetry.enabled() and info.get("n_fused"):
                telemetry.record_fused_update(
                    n_params=info["n_params"], n_buckets=0,
                    nbytes=sum(g._data.numel() * g._data.element_size()
                               for _i, g, _w in entries),
                    n_jitted_calls=info["n_groups"])
        else:
            for i, grad, weight in entries:
                self._updater(i, grad, weight)
        if limit > 0 and entries:
            self._update_count = getattr(self, "_update_count", 0) + 1
            self._inflight.admit(StepFence(
                [w for _i, _g, w in entries], step=self._update_count,
                executor="Module", ring=self._inflight))

    def drain(self) -> None:
        """Wait until every in-flight update has landed (before a
        checkpoint, at the end of ``fit``'s epoch)."""
        ring = getattr(self, "_inflight", None)
        if ring is not None:
            ring.drain()

    def get_outputs(self, merge_multi_context=True):
        return self._exec.outputs

    def get_input_grads(self, merge_multi_context=True):
        return [self._exec.grad_dict.get(n) for n in self._data_names]

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        eval_metric.update(labels, self.get_outputs())

    # -- checkpointing -----------------------------------------------------
    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        from ..model import save_checkpoint

        arg, aux = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg, aux)
        if save_optimizer_states and self._updater is not None:
            with open(f"{prefix}-{epoch:04d}.states", "wb") as f:
                f.write(self._updater.get_states())

    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        from ..model import load_checkpoint

        sym, arg, aux = load_checkpoint(prefix, epoch)
        mod = Module(sym, **kwargs)
        mod._preloaded = (arg, aux)
        mod._preloaded_states = (f"{prefix}-{epoch:04d}.states"
                                 if load_optimizer_states else None)
        return mod

    def load_optimizer_states(self, fname):
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def data_shapes(self):
        return self._data_shapes

    @property
    def label_shapes(self):
        return self._label_shapes

    @property
    def output_names(self):
        return self._symbol.list_outputs()

    @property
    def output_shapes(self):
        return [(n, tuple(o.shape)) for n, o in
                zip(self._symbol.list_outputs(), self._exec.outputs)]


def _as_desc(d):
    if isinstance(d, DataDesc):
        return d
    name, shape = d[0], d[1]
    return DataDesc(name=name, shape=tuple(shape))
