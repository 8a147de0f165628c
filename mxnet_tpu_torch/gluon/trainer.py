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

Under ``contrib.amp``, ``init_trainer`` sets ``_amp_loss_scaler`` and
``scale_loss`` sets ``_scale`` to the inverse loss scale, which the
rescale above divides back out.
``step`` returns without waiting for the card and keeps the host at most
``MX_ASYNC_INFLIGHT`` (default 2) un-synced steps ahead, as the fused
step does: each step admits a ``StepFence`` (an event behind the update
on the parameters' card) to the Trainer's ``InflightRing``, and a step
past the window first waits on the oldest.  ``MX_ASYNC_INFLIGHT=0`` makes
no fence; ``drain`` forces the window.  Each ``step`` ends with the JAX
Trainer's service hooks: a ``step`` event (``telemetry.record_step``, the
host wall of the call, ``inflight_depth`` and ``block_wait_ms``; the
first step is marked ``traced``), a heartbeat, and ``memwatch.on_step``.
A row-sparse gradient (``Embedding(sparse_grad=True)``) takes the
optimizer's lazy update through the per-parameter path; the kvstore
reduces it dense, and ``_row_sparse_pull`` pulls the whole value, as the
JAX Trainer does (``_contains_sparse_grad`` stays False there too).
Over a device list (Parameters initialized on ``[gpu(0), gpu(1)]``) or
with a ``dist`` kvstore, the Trainer makes its kvstore as the JAX one
does (``trainer.py:84-114``): ``allreduce_grads`` hands every live
Parameter's ``list_grad()`` to ``push_bucketed`` (``trainer.py:242``) and
pulls the sums back into each context's gradient, and the update runs one
updater per context; with ``update_on_kvstore`` the store's updater
applies the summed gradient and ``step`` pulls the weights into every
context.  ``ignore_stale_grad`` is accepted and, as in the JAX package,
not checked.
"""
from __future__ import annotations

import time
from typing import Dict, List

from ..base import MXNetError
from .. import kvstore as kvs_mod
from .. import memwatch, telemetry
from .. import optimizer as opt_mod
from ..parallel.async_loss import InflightRing, StepFence, inflight_limit
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
        self._contains_sparse_grad = False
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        # contrib.amp: init_trainer sets the loss scaler, scale_loss sets
        # _scale to its inverse for the next step's rescale
        self._amp_loss_scaler = None
        self._init_optimizer(optimizer, optimizer_params)
        self._kvstore_params = {"kvstore": kvstore,
                                "update_on_kvstore": update_on_kvstore}
        self._kv_initialized = False
        self._kvstore = None
        self._update_on_kvstore = None
        self._updaters = None
        self._step_count = 0
        self._inflight = None
        self._last_n_buckets = 0

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
        ctx_list = self._check_contexts()
        kv = None
        if kvstore:
            if isinstance(kvstore, kvs_mod.KVStore):
                kv = kvstore
            elif len(ctx_list) > 1 or "dist" in str(kvstore):
                kv = kvs_mod.create(kvstore)
        if kv is None:
            self._kvstore = None
            self._update_on_kvstore = False
        else:
            self._kvstore = kv
            if self._compression_params:
                kv.set_gradient_compression(self._compression_params)
            self._update_on_kvstore = (True if update_on_kvstore is None
                                       else update_on_kvstore)
            if self._update_on_kvstore:
                kv.set_updater(opt_mod.get_updater(self._optimizer))
            for i, param in enumerate(self._params):
                if param._inited:
                    kv.init(i, param.data(param.list_ctx()[0]))
        if not self._update_on_kvstore:
            self._updaters = [opt_mod.get_updater(self._optimizer)
                              for _ in range(max(len(ctx_list), 1))]
        self._kv_initialized = True

    def _check_contexts(self):
        """The device list of the first initialized Parameter."""
        for param in self._params:
            if param._inited:
                return param.list_ctx()
        return []

    def _row_sparse_pull(self, parameter, out, row_id, full_idx=False):
        """Dense, as the JAX Trainer's: the whole value."""
        if self._kvstore is not None:
            self._kvstore.pull(self._param2idx[parameter.name], out)

    # ------------------------------------------------------------------
    def step(self, batch_size: int, ignore_stale_grad: bool = False) -> None:
        """Rescale the gradients by 1 / ``batch_size``, reduce them and
        update the weights, within the in-flight window."""
        t0 = time.perf_counter()
        limit = inflight_limit()
        block_wait_s = 0.0
        if limit > 0:
            if self._inflight is None:
                self._inflight = InflightRing("Trainer")
            block_wait_s = self._inflight.make_room(limit)
        if not self._kv_initialized:
            self._init_kvstore()
        self._optimizer.rescale_grad = self._scale / batch_size
        self._allreduce_grads()
        self._update(ignore_stale_grad)
        self._step_count += 1
        depth = 0
        if limit > 0:
            fence = StepFence(
                [d for _i, p in self._live() if p._inited
                 for d in p.list_data()],
                step=self._step_count, executor="Trainer",
                ring=self._inflight)
            depth = self._inflight.admit(fence)
        if telemetry.enabled():
            # the first step pays the kvstore and updater set-up: keep it
            # out of the steady-state aggregates
            telemetry.record_step("Trainer", step=self._step_count,
                                  wall_s=time.perf_counter() - t0,
                                  samples=int(batch_size),
                                  traced=self._step_count == 1,
                                  inflight_depth=depth,
                                  block_wait_ms=round(block_wait_s * 1e3, 3))
            telemetry.heartbeat(self._step_count)
        # memory watchdog step boundary, after the dispatches
        memwatch.on_step(self._step_count)

    def drain(self) -> None:
        """Wait until every in-flight update has landed in the parameters
        (epoch end, before a checkpoint)."""
        if self._inflight is not None:
            self._inflight.drain()

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
        # flat buckets move many gradients a collective; the store holds
        # what per-key pushes would have made
        self._last_n_buckets = self._kvstore.push_bucketed(
            [i for i, _p in live], [p.list_grad() for _i, p in live])
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

        per_dev = [[] for _ in (self._updaters or [])]
        for i, param in self._live():
            # a Parameter never initialized, or still deferred, raises
            param._check_initialized()
            if self._update_on_kvstore:
                self._kvstore.pull(i, param.list_data())
                continue
            for entries, w, g in zip(per_dev, param.list_data(),
                                     param.list_grad()):
                entries.append((i, g, w))
        if self._update_on_kvstore:
            return
        for upd, entries in zip(self._updaters, per_dev):
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
