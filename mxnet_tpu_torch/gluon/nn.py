"""The Gluon layer of ``mxnet_tpu/gluon/nn/basic_layers.py`` that needs
a kernel, as a ``torch.nn`` module.

``LayerNorm`` runs kernel K1 (``ops.kernels.layer_norm``) once on every
call, as ``mxnet_tpu/ops/nn.py``'s ``LayerNorm`` op does on the TPU: the
CUDA kernel for CUDA tensors, its plain version for CPU ones.  It goes
through ``LayerNormFunction``, so it has the gradient of the JAX
package's ``_ln_bwd`` on every device.  The other
layers the Transformer uses are torch's own: Gluon's
``Dense(flatten=False)`` is ``torch.nn.Linear`` (the weight is (out, in)
in both), ``Embedding`` and ``Dropout`` are ``torch.nn``'s.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.kernels import LayerNormFunction

__all__ = ["LayerNorm"]


class LayerNorm(nn.Module):
    """LayerNorm over the last axis; ``weight``/``bias`` are Gluon's
    ``gamma``/``beta``."""

    def __init__(self, in_channels: int, epsilon: float = 1e-5):
        super().__init__()
        self.eps = float(epsilon)
        self.weight = nn.Parameter(torch.ones(in_channels))
        self.bias = nn.Parameter(torch.zeros(in_channels))

    def forward(self, x):
        C = x.shape[-1]
        out = LayerNormFunction.apply(x.reshape(-1, C).contiguous(),
                                      self.weight, self.bias, self.eps)
        return out.reshape(x.shape)
