"""The Gluon layers of ``mxnet_tpu/gluon/nn/basic_layers.py`` the port's
models use, as ``torch.nn`` modules.

``LayerNorm`` runs kernel K1 (``ops.kernels.layer_norm``) once on every
call, as ``mxnet_tpu/ops/nn.py``'s ``LayerNorm`` op does on the TPU: the
CUDA kernel for CUDA tensors, its plain version for CPU ones.  It goes
through ``LayerNormFunction``, so it has the gradient of the JAX
package's ``_ln_bwd`` on every device.  The Transformer's other layers
are torch's own: Gluon's ``Dense(flatten=False)`` is ``torch.nn.Linear``
(the weight is (out, in) in both), ``Embedding`` and ``Dropout`` are
``torch.nn``'s.

The ResNet family's layers (``BatchNorm``, ``Dense``, ``Activation``,
``Flatten``, ``HybridSequential``) call the registered ops of
``ops/nn.py``, as the Gluon layers call ``F.<op>``.  Departures: a
layer's ``in_channels`` / ``in_units`` is given, not inferred at the
first call, and ``prefix`` is only the Gluon name the converter reads
(``gluon_prefix``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...ops import nn as _ops
from ...ops.kernels import LayerNormFunction

__all__ = ["LayerNorm", "BatchNorm", "Dense", "Activation", "Flatten",
           "HybridSequential"]


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


class BatchNorm(nn.Module):
    """Batch normalization over every axis but ``axis``; ``weight`` and
    ``bias`` are Gluon's ``gamma`` and ``beta``, ``running_mean`` and
    ``running_var`` buffers, not parameters, as Gluon's
    ``grad_req="null"`` aux states.

    In training mode it normalizes by the batch's statistics and moves
    the running ones as Gluon does (``basic_layers.py`` BatchNorm):
    ``running = running * momentum + batch_stat.astype(running.dtype) *
    (1 - momentum)`` with the biased f32 variance, each operation rounded
    in the running stats' dtype, on the device under ``no_grad``; there
    is no host sync.  In eval mode it normalizes by the running stats."""

    def __init__(self, in_channels: int, axis: int = 1,
                 momentum: float = 0.9, epsilon: float = 1e-5,
                 prefix: Optional[str] = None):
        super().__init__()
        self.axis = axis
        self.momentum = float(momentum)
        self.eps = float(epsilon)
        self.gluon_prefix = prefix
        self.weight = nn.Parameter(torch.ones(in_channels))
        self.bias = nn.Parameter(torch.zeros(in_channels))
        self.register_buffer("running_mean", torch.zeros(in_channels))
        self.register_buffer("running_var", torch.ones(in_channels))

    def forward(self, x):
        kw = dict(eps=self.eps, momentum=self.momentum, fix_gamma=False,
                  axis=self.axis)
        if not self.training:
            return _ops.batch_norm(x, self.weight, self.bias,
                                   self.running_mean, self.running_var,
                                   use_global_stats=True, **kw)
        out, mean, var = _ops.batch_norm(
            x, self.weight, self.bias, self.running_mean, self.running_var,
            output_mean_var=True, training=True, **kw)
        m = self.momentum
        with torch.no_grad():
            for run, stat in ((self.running_mean, mean),
                              (self.running_var, var)):
                run.mul_(m).add_(stat.to(run.dtype) * (1 - m))
        return out


class Dense(nn.Module):
    """y = x W^T + b through the ``FullyConnected`` op; ``flatten``
    collapses every axis after the first, as Gluon's default."""

    def __init__(self, units: int, in_units: int, use_bias: bool = True,
                 flatten: bool = True, prefix: Optional[str] = None):
        super().__init__()
        self.flatten = flatten
        self.gluon_prefix = prefix
        self.weight = nn.Parameter(torch.empty(units, in_units))
        self.bias = nn.Parameter(torch.zeros(units)) if use_bias else None

    def forward(self, x):
        args = (x, self.weight) + (() if self.bias is None else (self.bias,))
        return _ops.fully_connected(*args, num_hidden=self.weight.shape[0],
                                    no_bias=self.bias is None,
                                    flatten=self.flatten)


class Activation(nn.Module):
    def __init__(self, activation: str):
        super().__init__()
        self.act = activation

    def forward(self, x):
        return _ops.activation(x, self.act)


class Flatten(nn.Module):
    """(N, ...) -> (N, prod(...))."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class HybridSequential(nn.Sequential):
    """Gluon's ``HybridSequential``: an ordered container, run in order;
    ``add`` appends."""

    def add(self, *blocks: nn.Module) -> None:
        for b in blocks:
            self.append(b)
