"""Gluon ``Trainer``.

Counterpart of ``mxnet_tpu/gluon/trainer.py``, with its kvstore decision
table (``trainer.py:84-114``): a ``KVStore`` instance is used (and,
unless ``update_on_kvstore=False``, updates the weights on push through
its updater, which ``step`` pulls back); a kvstore named by a string is
made only for more than one device or a ``dist`` type, so on one device
the Trainer applies its updater directly.  ``step(batch_size)`` sets the
optimizer's ``rescale_grad = scale / batch_size`` (``trainer.py:155``),
reduces the gradients through the kvstore if there is one, and updates.

The update takes the entries ``(index, grad, weight)`` of every Parameter
whose ``grad_req`` is not ``null`` — the NDArrays ``Parameter.grad()`` and
``.data()`` give, over the module's tensor and its ``.grad`` — and hands
them to ``FusedUpdater.apply`` in one batch (``trainer.py:279-285``), or
to the per-parameter ``Updater`` under ``MX_FUSED_UPDATE=0``; either
writes the new weights into the module's tensors in place.  A Parameter
still deferred (a net stepped before its first forward) raises, as in the
JAX package (``trainer.py:264-267``).  ``lr_mult`` / ``wd_mult`` come from
the Parameters (the optimizer's ``param_dict``).

Not ported: the in-flight ring and telemetry (ROADMAP A.6, A.10) and more
than one device (A.9); ``ignore_stale_grad`` is accepted and, as in the
JAX package, not checked.
"""
from __future__ import annotations

from typing import Dict, List

from ..base import MXNetError
from .. import kvstore as kvs_mod
from .. import optimizer as opt_mod
from .parameter import Parameter, ParameterDict

__all__ = ["Trainer"]


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None,
                 update_on_kvstore=None):
        if isinstance(params, dict):
            params = [params[k] for k in sorted(params.keys())]
        elif isinstance(params, ParameterDict):
            params = list(params.values())
        if not isinstance(params, (list, tuple)):
            raise MXNetError(
                "First argument must be a list or dict of Parameters")
        self._params: List[Parameter] = []
        self._param2idx: Dict[str, int] = {}
        for i, param in enumerate(params):
            if not isinstance(param, Parameter):
                raise MXNetError("First argument must contain Parameters, "
                                 f"got {type(param)}")
            self._param2idx[param.name] = i
            self._params.append(param)
            param._trainer = self
        self._compression_params = compression_params
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        self._kv_initialized = False
        self._kvstore = None
        self._update_on_kvstore = None
        self._updaters = None

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt_mod.Optimizer):
            if optimizer_params and set(optimizer_params) != {"rescale_grad"}:
                raise MXNetError("optimizer_params must be None if optimizer "
                                 "is an optimizer instance")
            self._optimizer = optimizer
            self._optimizer.param_dict = param_dict
        else:
            self._optimizer = opt_mod.create(optimizer, param_dict=param_dict,
                                             **optimizer_params)

    @property
    def optimizer(self) -> opt_mod.Optimizer:
        return self._optimizer

    @property
    def learning_rate(self) -> float:
        return self._optimizer.learning_rate

    def set_learning_rate(self, lr: float) -> None:
        self._optimizer.set_learning_rate(lr)

    # ------------------------------------------------------------------
    def _init_kvstore(self) -> None:
        kvstore = self._kvstore_params["kvstore"]
        update_on_kvstore = self._kvstore_params["update_on_kvstore"]
        kv = None
        if kvstore:
            if isinstance(kvstore, kvs_mod.KVStore):
                kv = kvstore
            elif "dist" in str(kvstore):
                kv = kvs_mod.create(kvstore)  # raises: ROADMAP A.9
        if kv is None:
            self._kvstore = None
            self._update_on_kvstore = False
            self._updaters = [opt_mod.get_updater(self._optimizer)]
        else:
            self._kvstore = kv
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            self._update_on_kvstore = (True if update_on_kvstore is None
                                       else update_on_kvstore)
            if self._update_on_kvstore:
                kv.set_updater(opt_mod.get_updater(self._optimizer))
            else:
                self._updaters = [opt_mod.get_updater(self._optimizer)]
            for i, param in enumerate(self._params):
                if param._inited:
                    kv.init(i, param.data())
        self._kv_initialized = True

    # ------------------------------------------------------------------
    def step(self, batch_size: int, ignore_stale_grad: bool = False) -> None:
        """Rescale the gradients by 1 / ``batch_size``, reduce them and
        update the weights."""
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self) -> None:
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            raise MXNetError("allreduce_grads() when parameters are updated "
                             "on kvstore is not supported")
        self._allreduce_grads()

    def _live(self):
        return [(i, p) for i, p in enumerate(self._params)
                if p.grad_req != "null"]

    def _allreduce_grads(self) -> None:
        if self._kvstore is None:
            return
        live = self._live()
        if not live:
            return
        for _i, p in live:
            p._check_initialized()
        self._kvstore.push([i for i, _p in live],
                           [p.list_grad() for _i, p in live])
        if not self._update_on_kvstore:
            for i, p in live:
                self._kvstore.pull(i, p.list_grad())

    def update(self, batch_size: int, ignore_stale_grad: bool = False) -> None:
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            raise MXNetError("update() when parameters are updated on "
                             "kvstore is not supported (call step())")
        self._optimizer.rescale_grad = self._scale / batch_size
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad: bool = False) -> None:
        from ..optimizer.fused import FusedUpdater

        entries = []
        for i, param in self._live():
            # a Parameter never initialized, or still deferred, raises
            param._check_initialized()
            if self._update_on_kvstore:
                self._kvstore.pull(i, param.list_data())
            else:
                entries.append((i, param.grad(), param.data()))
        if self._update_on_kvstore:
            return
        upd = self._updaters[0]
        if isinstance(upd, FusedUpdater):
            upd.apply(entries)
        else:
            for i, g, w in entries:
                upd(i, g, w)

    # ------------------------------------------------------------------
    def save_states(self, fname: str) -> None:
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=False)
        else:
            with open(fname, "wb") as f:
                f.write(self._updaters[0].get_states(dump_optimizer=False))

    def load_states(self, fname: str) -> None:
        if not self._kv_initialized:
            self._init_kvstore()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
        else:
            with open(fname, "rb") as f:
                states = f.read()
            for updater in self._updaters:
                updater.set_states(states)
                updater.optimizer = self._optimizer
