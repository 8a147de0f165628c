"""The contrib layers, from ``mxnet_tpu/gluon/contrib/nn/__init__.py``.

``SyncBatchNorm`` is ``BatchNorm`` over axis 1 with ``num_devices``
accepted and unused: on one device its batch statistics are that
device's, as the JAX class's are in its per-device eager path, and in a
``DataParallelStep`` over several processes they are the global batch's
(the moments merged over the step's data axes,
``parallel/sync_batch_norm.py``), as the JAX fused step's are.  Every
``BatchNorm`` takes that route in such a step, so the two give the same
result.
``HybridConcurrent`` (and ``Concurrent``) runs each child on the same
input and concatenates the outputs along ``axis``; ``Identity`` returns
its input.  Each has ``hybrid_forward``, the JAX block's body, so it
exports the JAX graph.
"""
from __future__ import annotations

from ...block import HybridBlock
from ...nn.basic_layers import BatchNorm as _BatchNorm

__all__ = ["SyncBatchNorm", "HybridConcurrent", "Concurrent", "Identity"]


class SyncBatchNorm(_BatchNorm):
    def __init__(self, in_channels=0, num_devices=None, momentum=0.9,
                 epsilon=1e-5, center=True, scale=True,
                 use_global_stats=False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones", prefix=None,
                 params=None):
        super().__init__(in_channels=in_channels, axis=1, momentum=momentum,
                         epsilon=epsilon, center=center, scale=scale,
                         use_global_stats=use_global_stats,
                         beta_initializer=beta_initializer,
                         gamma_initializer=gamma_initializer,
                         running_mean_initializer=running_mean_initializer,
                         running_variance_initializer=(
                             running_variance_initializer),
                         prefix=prefix, params=params)


class HybridConcurrent(HybridBlock):
    """Each child on the same input, the outputs concatenated."""

    def __init__(self, axis=-1, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def hybrid_forward(self, F, x):
        out = [block(x) for block in self._modules.values()]
        return F.concat(*out, dim=self.axis)


class Concurrent(HybridConcurrent):
    pass


class Identity(HybridBlock):
    def hybrid_forward(self, F, x):
        return x
