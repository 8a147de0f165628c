"""BaseModule: the symbolic-era training loop (counterpart of
``mxnet_tpu/module/base_module.py``): ``fit``'s epoch loop, ``score``,
``predict``, ``forward_backward`` and ``BatchEndParam``.
"""
from __future__ import annotations

import logging
import time
from collections import namedtuple

from ..base import MXNetError
from .. import metric as _metric

__all__ = ["BaseModule", "BatchEndParam"]

# `loss` (default None): an optional loss handle, see model.BatchEndParam
BatchEndParam = namedtuple("BatchEndParam",
                           ["epoch", "nbatch", "eval_metric", "locals",
                            "loss"])
BatchEndParam.__new__.__defaults__ = (None,)


class BaseModule:
    def __init__(self, logger=logging):
        self.logger = logger
        self.binded = False
        self.for_training = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- abstract interface (Module implements) ----------------------------
    def bind(self, *args, **kwargs):
        raise NotImplementedError

    def init_params(self, *args, **kwargs):
        raise NotImplementedError

    def init_optimizer(self, *args, **kwargs):
        raise NotImplementedError

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError

    def backward(self, out_grads=None):
        raise NotImplementedError

    def update(self):
        raise NotImplementedError

    def get_outputs(self):
        raise NotImplementedError

    def get_params(self):
        raise NotImplementedError

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError

    @property
    def symbol(self):
        return self._symbol

    # -- shared helpers -----------------------------------------------------
    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def score(self, eval_data, eval_metric, num_batch=None, reset=True,
              epoch=0, batch_end_callback=None):
        if not self.binded or not self.params_initialized:
            raise MXNetError("module must be binded and initialized")
        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        if reset:
            eval_data.reset()
        eval_metric.reset()
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
            if batch_end_callback is not None:
                param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                      eval_metric=eval_metric, locals=locals())
                for cb in _as_list(batch_end_callback):
                    cb(param)
        return eval_metric.get_name_value()

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True):
        from ..ndarray import concat

        if reset:
            eval_data.reset()
        out_batches = []
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            outs = [o.copy() for o in self.get_outputs()]
            pad = batch.pad or 0
            if pad:
                outs = [o[: o.shape[0] - pad] for o in outs]
            out_batches.append(outs)
        if not out_batches:
            return []
        num_outputs = len(out_batches[0])
        if merge_batches:
            merged = [concat(*[b[i] for b in out_batches], dim=0)
                      for i in range(num_outputs)]
            return merged[0] if num_outputs == 1 else merged
        return out_batches

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", optimizer="sgd",
            optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=None, arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None, sparse_row_id_fn=None):
        """The classic Module.fit epoch loop (reference ~L450-600)."""
        from .. import initializer as _init

        if num_epoch is None:
            raise MXNetError("num_epoch must be specified")
        if initializer is None:
            initializer = _init.Uniform(0.01)

        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)

        if not isinstance(eval_metric, _metric.EvalMetric):
            eval_metric = _metric.create(eval_metric)
        if validation_metric is None:
            validation_metric = eval_metric
        if monitor is not None:
            self.install_monitor(monitor)

        for epoch in range(begin_epoch, num_epoch):
            tic = time.perf_counter()
            eval_metric.reset()
            train_data.reset()
            for nbatch, data_batch in enumerate(train_data):
                if monitor is not None:
                    monitor.tic()
                self.forward_backward(data_batch)
                self.update()
                if monitor is not None:
                    monitor.toc_print()
                self.update_metric(eval_metric, data_batch.label)
                if batch_end_callback is not None:
                    param = BatchEndParam(epoch=epoch, nbatch=nbatch,
                                          eval_metric=eval_metric,
                                          locals=locals())
                    for cb in _as_list(batch_end_callback):
                        cb(param)
            drain = getattr(self, "drain", None)
            if drain is not None:
                # the epoch's end lands every in-flight update (and
                # surfaces a deferred failure) before params are read
                drain()
            for name, val in eval_metric.get_name_value():
                self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                             time.perf_counter() - tic)

            if epoch_end_callback is not None:
                arg_p, aux_p = self.get_params()
                for cb in _as_list(epoch_end_callback):
                    cb(epoch, self.symbol, arg_p, aux_p)

            if eval_data is not None:
                res = self.score(eval_data, validation_metric,
                                 batch_end_callback=eval_batch_end_callback,
                                 epoch=epoch)
                for name, val in res:
                    self.logger.info("Epoch[%d] Validation-%s=%f",
                                     epoch, name, val)


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]
