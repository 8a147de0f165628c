"""BucketingModule: per-bucket executors sharing parameters (counterpart
of ``mxnet_tpu/module/bucketing_module.py``).  One ``Module`` per bucket
key, made by ``sym_gen(key)`` on the first batch of that key; every bucket
binds the default bucket's parameter, gradient and aux NDArrays (the same
objects), so an update through any bucket is seen by all.  Each bucket's
Module keeps its own in-flight window; ``drain`` drains them all (the JAX
BucketingModule has no ``drain``, so its ``fit`` does not drain).
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from .base_module import BaseModule
from .module import Module

__all__ = ["BucketingModule"]


class BucketingModule(BaseModule):
    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None, group2ctxs=None, compression_params=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise MXNetError("default_bucket_key must be given")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._fixed_param_names = fixed_param_names
        self._buckets = {}
        self._curr_module = None
        self._curr_bucket_key = None
        self._opt_args = None

    @property
    def symbol(self):
        return self._curr_module.symbol if self._curr_module else None

    def _gen_module(self, bucket_key):
        sym, data_names, label_names = self._sym_gen(bucket_key)
        return Module(sym, data_names=data_names, label_names=label_names,
                      logger=self.logger, context=self._context,
                      fixed_param_names=self._fixed_param_names)

    def install_monitor(self, mon) -> None:
        """Watch every bucket's executor, including ones created later
        (reference: BucketingModule installs on all executor groups).
        May be called before bind(): bind installs on the default bucket.
        """
        self._monitor = mon
        for m in self._buckets.values():
            m.install_monitor(mon)

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            return
        self.for_training = for_training
        mod = self._gen_module(self._default_bucket_key)
        mod.bind(data_shapes, label_shapes, for_training=for_training,
                 grad_req=grad_req)
        self._buckets[self._default_bucket_key] = mod
        if getattr(self, "_monitor", None) is not None:
            mod.install_monitor(self._monitor)  # pre-bind install_monitor
        self._curr_module = mod
        self._curr_bucket_key = self._default_bucket_key
        self.binded = True

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        if not self.binded:
            raise MXNetError("call bind before switch_bucket")
        if bucket_key not in self._buckets:
            default_mod = self._buckets[self._default_bucket_key]
            mod = self._gen_module(bucket_key)
            mod.bind(data_shapes, label_shapes,
                     for_training=self.for_training,
                     shared_module=default_mod)
            mod.params_initialized = self.params_initialized
            mod._updater = default_mod._updater
            mod._optimizer = default_mod._optimizer
            mod.optimizer_initialized = default_mod.optimizer_initialized
            if getattr(self, "_monitor", None) is not None:
                mod.install_monitor(self._monitor)  # lazily created bucket
            self._buckets[bucket_key] = mod
        self._curr_module = self._buckets[bucket_key]
        self._curr_bucket_key = bucket_key

    def init_params(self, **kwargs):
        self._buckets[self._default_bucket_key].init_params(**kwargs)
        self.params_initialized = True
        for mod in self._buckets.values():
            mod.params_initialized = True

    def init_optimizer(self, **kwargs):
        default = self._buckets[self._default_bucket_key]
        default.init_optimizer(**kwargs)
        for mod in self._buckets.values():
            mod._updater = default._updater
            mod._optimizer = default._optimizer
            mod.optimizer_initialized = True
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        key = data_batch.bucket_key
        if key is None:
            key = self._curr_bucket_key
        default_mod = self._buckets[self._default_bucket_key]
        data_shapes = data_batch.provide_data or list(
            zip(default_mod.data_names,
                [d.shape for d in (data_batch.data or [])]))
        label_shapes = data_batch.provide_label or (
            list(zip(default_mod.label_names,
                     [l.shape for l in data_batch.label]))
            if data_batch.label else None)
        self.switch_bucket(key, data_shapes, label_shapes)
        self._curr_module.forward(data_batch, is_train=is_train)

    def backward(self, out_grads=None):
        self._curr_module.backward(out_grads)

    def update(self):
        self._curr_module.update()

    def drain(self) -> None:
        """Wait until every bucket module's in-flight updates have
        landed (each bucket's Module keeps its own window)."""
        for mod in self._buckets.values():
            mod.drain()

    def get_outputs(self, merge_multi_context=True):
        return self._curr_module.get_outputs()

    def get_params(self):
        return self._buckets[self._default_bucket_key].get_params()

    def set_params(self, arg_params, aux_params, **kwargs):
        self._buckets[self._default_bucket_key].set_params(
            arg_params, aux_params, **kwargs)
        self.params_initialized = True

    def update_metric(self, eval_metric, labels, pre_sliced=False):
        self._curr_module.update_metric(eval_metric, labels)

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        self._buckets[self._default_bucket_key].save_checkpoint(
            prefix, epoch, save_optimizer_states)
