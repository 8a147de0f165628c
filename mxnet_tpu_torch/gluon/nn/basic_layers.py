"""Gluon's basic layers (``mxnet_tpu/gluon/nn/basic_layers.py``) as
``HybridBlock``s, which are ``torch.nn`` modules: ``Sequential``,
``HybridSequential``, ``Dense``, ``Dropout``, ``BatchNorm``,
``Embedding``, ``LayerNorm``, ``Flatten``, ``Lambda``, ``HybridLambda``
and ``Activation``.

Each layer holds its weights as torch tensors under torch's names
(``weight``, ``bias``; BatchNorm's ``running_mean`` / ``running_var`` are
buffers, Gluon's ``grad_req="null"`` aux states) and wraps each in a Gluon
``Parameter`` under Gluon's name (LayerNorm's and BatchNorm's ``weight``
and ``bias`` are Gluon's ``gamma`` and ``beta``), so ``collect_params``
and the files give Gluon's names.  An input width left at 0
(``in_units``, ``in_channels``) is inferred at the first call
(``infer_shape``).

``LayerNorm`` runs kernel K1 (``ops.kernels.layer_norm``) once on every
call through ``LayerNormFunction``, as ``mxnet_tpu/ops/nn.py``'s
``LayerNorm`` op does on the TPU: the CUDA kernel for CUDA tensors, its
plain version for CPU ones, with the gradient of the JAX package's
``_ln_bwd``; it normalizes the last axis.  ``Dense(flatten=False)`` is
``torch.nn.functional.linear`` (the weight is (out, in) in both); with
``flatten`` it calls the ``FullyConnected`` op, and the other layers call
the registered ops of ``ops/nn.py``, as Gluon's layers call ``F.<op>``.
``Dropout`` is ``torch.nn.functional.dropout``, which draws from the
generator of its input's device (``random``).

Departures: the first positional argument of ``LayerNorm`` and
``BatchNorm`` is ``in_channels`` (the port's callers pass it so; Gluon's
is ``axis``); ``Embedding(sparse_grad=True)`` raises
(no ``nd.sparse``); ``Lambda`` / ``HybridLambda`` given a name call the
registered op of that name on tensors.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.nn.parameter import UninitializedBuffer, UninitializedParameter

from ...base import MXNetError
from ...ops import nn as _ops
from ...ops.kernels import LayerNormFunction
from ..block import Block, HybridBlock
from ..block import F as _F

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout",
           "BatchNorm", "Embedding", "LayerNorm", "Flatten", "Lambda",
           "HybridLambda", "Activation"]


def weight_tensor(shape, fill: Optional[float] = None) -> nn.Parameter:
    """An ``nn.Parameter`` of ``shape``, or torch's
    ``UninitializedParameter`` when a dim is still 0 (deferred)."""
    if any(s <= 0 for s in shape):
        return UninitializedParameter()
    t = torch.empty(shape)
    if fill is not None:
        t.fill_(fill)
    return nn.Parameter(t)


class _Container:
    """``add``, indexing, ``len`` and iteration of the sequential
    containers."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def __getitem__(self, key):
        layers = list(self._modules.values())[key]
        if isinstance(layers, list):
            net = type(self)(prefix=self._prefix)
            for layer in layers:
                net.register_child(layer)
            return net
        return layers

    def __len__(self):
        return len(self._modules)

    def __iter__(self):
        return iter(self._modules.values())


class Sequential(_Container, Block):
    """Blocks run in order."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, x, *args):
        for block in self._modules.values():
            x = block(x)
        return x


class HybridSequential(_Container, HybridBlock):
    """HybridBlocks run in order."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, x, *args):
        for block in self._modules.values():
            x = block(x)
        return x


class Dense(HybridBlock):
    """y = act(x W^T + b); ``flatten`` collapses every axis after the
    first, as Gluon's default."""

    def __init__(self, units: int, activation: Optional[str] = None,
                 use_bias: bool = True, flatten: bool = True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units: int = 0,
                 prefix: Optional[str] = None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self.flatten = flatten
        self.act = activation
        self.weight = weight_tensor((units, in_units))
        self._gluon_param("weight", shape=(units, in_units), dtype=dtype,
                          init=weight_initializer, allow_deferred_init=True)
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(units))
            self._gluon_param("bias", shape=(units,), dtype=dtype,
                              init=bias_initializer,
                              allow_deferred_init=True)
        else:
            self.bias = None

    def infer_shape(self, x, *args):
        in_units = (math.prod(x.shape[1:]) if self.flatten
                    else int(x.shape[-1]))
        self._reg_params["weight"]._set_shape_if_deferred(
            (self._units, in_units))

    def forward(self, x):
        self._finish_deferred(x)
        if not self.flatten:
            out = F.linear(x, self.weight, self.bias)
        else:
            args = (x, self.weight) + (() if self.bias is None
                                       else (self.bias,))
            out = _ops.fully_connected(*args, num_hidden=self._units,
                                       no_bias=self.bias is None,
                                       flatten=True)
        return out if self.act is None else _ops.activation(out, self.act)


class Dropout(HybridBlock):
    """Zeroes each element with probability ``rate`` in training mode and
    scales the rest by 1 / (1 - rate); ``axes`` share one mask along
    them."""

    def __init__(self, rate: float, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.rate = float(rate)
        self.axes = tuple(axes)

    def forward(self, x):
        if not self.training or self.rate == 0.0:
            return x
        if not self.axes:
            return F.dropout(x, self.rate, True)
        shape = [1 if i in self.axes or i - x.dim() in self.axes else s
                 for i, s in enumerate(x.shape)]
        mask = F.dropout(torch.ones(shape, dtype=x.dtype, device=x.device),
                         self.rate, True)
        return x * mask


class BatchNorm(HybridBlock):
    """Batch normalization over every axis but ``axis``.

    In training mode it normalizes by the batch's statistics and moves the
    running ones as Gluon does: ``running = running * momentum +
    batch_stat.astype(running.dtype) * (1 - momentum)`` with the biased f32
    variance, each operation rounded in the running stats' dtype, on the
    device under ``no_grad``; there is no host sync.  In eval mode (or
    with ``use_global_stats``) it normalizes by the running stats."""

    def __init__(self, in_channels: int = 0, axis: int = 1,
                 momentum: float = 0.9, epsilon: float = 1e-5,
                 center: bool = True, scale: bool = True,
                 use_global_stats: bool = False, beta_initializer="zeros",
                 gamma_initializer="ones", running_mean_initializer="zeros",
                 running_variance_initializer="ones",
                 prefix: Optional[str] = None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.axis = axis
        self.momentum = float(momentum)
        self.eps = float(epsilon)
        self.scale = scale
        self.use_global_stats = use_global_stats
        c = (in_channels,)
        self.weight = weight_tensor(c, 1.0)
        self.bias = weight_tensor(c, 0.0)
        deferred = in_channels <= 0
        self.register_buffer("running_mean", UninitializedBuffer()
                             if deferred else torch.zeros(c))
        self.register_buffer("running_var", UninitializedBuffer()
                             if deferred else torch.ones(c))
        self._gluon_param("gamma", "weight", shape=c,
                          init=gamma_initializer, allow_deferred_init=True,
                          grad_req="write" if scale else "null")
        self._gluon_param("beta", "bias", shape=c, init=beta_initializer,
                          allow_deferred_init=True,
                          grad_req="write" if center else "null")
        self._gluon_param("running_mean", shape=c,
                          init=running_mean_initializer, grad_req="null",
                          allow_deferred_init=True)
        self._gluon_param("running_var", shape=c,
                          init=running_variance_initializer,
                          grad_req="null", allow_deferred_init=True)

    def infer_shape(self, x, *args):
        c = (int(x.shape[self.axis]),)
        for p in self._reg_params.values():
            p._set_shape_if_deferred(c)

    def forward(self, x):
        self._finish_deferred(x)
        kw = dict(eps=self.eps, momentum=self.momentum,
                  fix_gamma=not self.scale, axis=self.axis)
        if not self.training or self.use_global_stats:
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


class Embedding(HybridBlock):
    """Rows of ``weight`` (input_dim, output_dim) by index; float indices
    (the JAX package's habit) are cast to integers."""

    def __init__(self, input_dim: int, output_dim: int, dtype="float32",
                 weight_initializer=None, sparse_grad: bool = False,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if sparse_grad:
            raise MXNetError("Embedding(sparse_grad=True) needs nd.sparse, "
                             "which the port does not have")
        self.input_dim, self.output_dim = input_dim, output_dim
        self.weight = nn.Parameter(torch.empty(input_dim, output_dim))
        self._gluon_param("weight", shape=(input_dim, output_dim),
                          dtype=dtype, init=weight_initializer)

    def forward(self, x):
        if x.is_floating_point():
            x = x.long()
        return F.embedding(x, self.weight)


class LayerNorm(HybridBlock):
    """LayerNorm over the last axis through kernel K1; ``weight`` /
    ``bias`` are Gluon's ``gamma`` / ``beta``."""

    def __init__(self, in_channels: int = 0, epsilon: float = 1e-5,
                 axis: int = -1, center: bool = True, scale: bool = True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 prefix: Optional[str] = None, params=None):
        super().__init__(prefix=prefix, params=params)
        if axis != -1:
            raise MXNetError("the port's LayerNorm normalizes the last axis "
                             f"(axis=-1), got axis={axis}")
        self.eps = float(epsilon)
        c = (in_channels,)
        self.weight = weight_tensor(c, 1.0)
        self.bias = weight_tensor(c, 0.0)
        self._gluon_param("gamma", "weight", shape=c,
                          init=gamma_initializer, allow_deferred_init=True,
                          grad_req="write" if scale else "null")
        self._gluon_param("beta", "bias", shape=c, init=beta_initializer,
                          allow_deferred_init=True,
                          grad_req="write" if center else "null")

    def infer_shape(self, x, *args):
        for p in self._reg_params.values():
            p._set_shape_if_deferred((int(x.shape[-1]),))

    def forward(self, x):
        self._finish_deferred(x)
        C = x.shape[-1]
        out = LayerNormFunction.apply(x.reshape(-1, C).contiguous(),
                                      self.weight, self.bias, self.eps)
        return out.reshape(x.shape)


class Flatten(HybridBlock):
    """(N, ...) -> (N, prod(...))."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


def _op_fn(function):
    return getattr(_F, function) if isinstance(function, str) else function


class Lambda(Block):
    """A Block around ``function(*tensors)`` (or the op of that name)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._func = _op_fn(function)

    def forward(self, *args):
        return self._func(*args)


class HybridLambda(HybridBlock):
    """A HybridBlock around ``function(F, *tensors)`` (or the op of that
    name, called on the tensors)."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        self._named = isinstance(function, str)
        self._func = _op_fn(function)

    def forward(self, *args):
        if self._named:
            return self._func(*args)
        return self._func(_F, *args)


class Activation(HybridBlock):
    def __init__(self, activation: str, prefix=None, params=None):
        self.act = activation
        super().__init__(prefix=prefix, params=params)

    def _alias(self):
        return self.act

    def forward(self, x):
        return _ops.activation(x, self.act)
