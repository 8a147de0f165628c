"""Gluon's basic layers (``mxnet_tpu/gluon/nn/basic_layers.py``) as
``HybridBlock``s, which are ``torch.nn`` modules: ``Sequential``,
``HybridSequential``, ``Dense``, ``Dropout``, ``BatchNorm``,
``Embedding``, ``LayerNorm``, ``GroupNorm``, ``InstanceNorm``,
``Flatten``, ``Lambda``, ``HybridLambda``, ``Activation`` and the
activation layers ``LeakyReLU``, ``PReLU``, ``ELU``, ``SELU``, ``Swish``
and ``GELU``.

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
``Dropout`` and ``Embedding`` call the ``Dropout`` and ``Embedding`` ops
(``ops/nn.py``, ``ops/indexing.py``), so the layers and ``nd.Dropout`` /
``nd.Embedding`` are one implementation; the mask is drawn from the
generator of the input's device (``random``).  ``GroupNorm`` and
``InstanceNorm`` take the JAX layers' arguments (``num_groups`` /
``axis`` first) and, as they do, keep ``center`` / ``scale`` for the
signature only.

Each layer also has ``hybrid_forward(F, x, **params)``, the JAX layer's
own body over ``F.<op>``: a block called with Symbols composes its graph
through it (``export``); with ``F`` the registry over tensors it computes
what ``forward`` does in inference (``Dropout`` is the identity there, as
the op is outside training).

Departures: the first positional argument of ``LayerNorm`` and
``BatchNorm`` is ``in_channels`` (the port's callers pass it so; Gluon's
is ``axis``); ``Lambda`` / ``HybridLambda`` given a name call the
registered op of that name on tensors.

Profiler sites: the layers call the op functions (each a site of its
registry op's name); ``LayerNorm`` (kernel K1) and ``Dense`` without
flattening (``F.linear``) call torch or the kernel themselves and are
sites of ``LayerNorm`` and ``FullyConnected``.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.nn.parameter import UninitializedBuffer, UninitializedParameter

from ...base import MXNetError
from ... import initializer as _init
from ... import profiler as _profiler
from ...ops import indexing as _indexing
from ...ops import nn as _ops
from ...precision import runtime as _prec
from ...ops.kernels import LayerNormFunction
from ..block import Block, HybridBlock
from ..block import F as _F

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout",
           "BatchNorm", "Embedding", "LayerNorm", "GroupNorm",
           "InstanceNorm", "Flatten", "Lambda", "HybridLambda", "Activation",
           "LeakyReLU", "PReLU", "ELU", "SELU", "Swish", "GELU"]

# profiler sites of the registry ops these layers stand for
# (``LayerNormFunction`` looked up at each call)
_linear_site = _profiler.op_site("FullyConnected", F.linear)
_layer_norm_site = _profiler.op_site(
    "LayerNorm", lambda *args: LayerNormFunction.apply(*args))


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

    def hybrid_forward(self, F, x, *args):
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
        twin = _prec.quant_entry(self)
        if twin is not None:
            # a quantized serving adapter's scope: the layer's int8 or
            # int4 twin replaces it
            return twin(x, self.bias)
        if not self.flatten:
            x, w, b = _prec.cast_inputs("FullyConnected", x, self.weight,
                                        self.bias)
            out = _linear_site(x, w, b)
        else:
            args = (x, self.weight) + (() if self.bias is None
                                       else (self.bias,))
            out = _ops.fully_connected(*args, num_hidden=self._units,
                                       no_bias=self.bias is None,
                                       flatten=True)
        return out if self.act is None else _ops.activation(out, self.act)

    def hybrid_forward(self, F, x, weight, bias=None):
        if bias is None:
            out = F.FullyConnected(x, weight, num_hidden=self._units,
                                   no_bias=True, flatten=self.flatten)
        else:
            out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                                   no_bias=False, flatten=self.flatten)
        if self.act:
            out = F.Activation(out, act_type=self.act)
        return out


class Dropout(HybridBlock):
    """Zeroes each element with probability ``rate`` in training mode and
    scales the rest by 1 / (1 - rate); ``axes`` share one mask along
    them."""

    def __init__(self, rate: float, axes=(), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.rate = float(rate)
        self.axes = tuple(axes)

    def forward(self, x):
        return _ops.dropout(x, p=self.rate, axes=self.axes,
                            training=self.training)

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self.rate, axes=self.axes)


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

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        # the graph's inference branch (an exported BatchNorm; the
        # executor trains it by batch statistics)
        return F.BatchNorm(
            x, gamma, beta, running_mean, running_var, eps=self.eps,
            momentum=self.momentum, fix_gamma=not self.scale,
            use_global_stats=True, output_mean_var=False, axis=self.axis,
            training=False)


class Embedding(HybridBlock):
    """Rows of ``weight`` (input_dim, output_dim) by index; float indices
    (the JAX package's habit) are cast to integers.  With ``sparse_grad``
    the weight's gradient is a ``RowSparseNDArray`` of the looked-up rows
    (``grad_stype="row_sparse"``), which the lazy optimizer updates read;
    the weight stays dense."""

    def __init__(self, input_dim: int, output_dim: int, dtype="float32",
                 weight_initializer=None, sparse_grad: bool = False,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.input_dim, self.output_dim = input_dim, output_dim
        self._sparse_grad = bool(sparse_grad)
        self.weight = nn.Parameter(torch.empty(input_dim, output_dim))
        self._gluon_param("weight", shape=(input_dim, output_dim),
                          dtype=dtype, init=weight_initializer,
                          grad_stype="row_sparse" if sparse_grad
                          else "default")

    def forward(self, x):
        return _indexing.embedding(x, self.weight,
                                   sparse_grad=self._sparse_grad)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, input_dim=self.input_dim,
                           output_dim=self.output_dim,
                           sparse_grad=self._sparse_grad)


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
        x, w, b = _prec.cast_inputs("LayerNorm", x, self.weight, self.bias)
        C = x.shape[-1]
        out = _layer_norm_site(x.reshape(-1, C).contiguous(), w, b,
                               self.eps)
        return out.reshape(x.shape)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=-1, eps=self.eps)


class _GroupedNorm(HybridBlock):
    """gamma / beta over the channel axis 1, deferred until the first
    call; the subclass names the op."""

    def __init__(self, in_channels, beta_initializer, gamma_initializer,
                 prefix, params):
        super().__init__(prefix=prefix, params=params)
        c = (in_channels,)
        self.weight = weight_tensor(c, 1.0)
        self.bias = weight_tensor(c, 0.0)
        self._gluon_param("gamma", "weight", shape=c, init=gamma_initializer,
                          allow_deferred_init=True)
        self._gluon_param("beta", "bias", shape=c, init=beta_initializer,
                          allow_deferred_init=True)

    def infer_shape(self, x, *args):
        for p in self._reg_params.values():
            p._set_shape_if_deferred((int(x.shape[1]),))


class GroupNorm(_GroupedNorm):
    """Normalization over groups of ``num_groups`` channels and the
    spatial axes, then a per-channel scale and shift."""

    def __init__(self, num_groups: int = 1, epsilon: float = 1e-5,
                 center: bool = True, scale: bool = True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels: int = 0, prefix=None, params=None):
        self._num_groups = num_groups
        self.eps = float(epsilon)
        super().__init__(in_channels, beta_initializer, gamma_initializer,
                         prefix, params)

    def forward(self, x):
        self._finish_deferred(x)
        return _ops.group_norm(x, self.weight, self.bias,
                               num_groups=self._num_groups, eps=self.eps)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.GroupNorm(x, gamma, beta, num_groups=self._num_groups,
                           eps=self.eps)


class InstanceNorm(_GroupedNorm):
    """Normalization of each sample's channel over its spatial axes."""

    def __init__(self, axis: int = 1, epsilon: float = 1e-5,
                 center: bool = True, scale: bool = False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels: int = 0, prefix=None, params=None):
        self.eps = float(epsilon)
        super().__init__(in_channels, beta_initializer, gamma_initializer,
                         prefix, params)

    def forward(self, x):
        self._finish_deferred(x)
        return _ops.instance_norm(x, self.weight, self.bias, eps=self.eps)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, eps=self.eps)


class Flatten(HybridBlock):
    """(N, ...) -> (N, prod(...))."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)

    def hybrid_forward(self, F, x):
        return F.Flatten(x)


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
        self._named = function if isinstance(function, str) else None
        self._func = _op_fn(function)

    def forward(self, *args):
        if self._named:
            return self._func(*args)
        return self._func(_F, *args)

    def hybrid_forward(self, F, *args):
        if self._named:
            return getattr(F, self._named)(*args)
        return self._func(F, *args)


class Activation(HybridBlock):
    def __init__(self, activation: str, prefix=None, params=None):
        self.act = activation
        super().__init__(prefix=prefix, params=params)

    def _alias(self):
        return self.act

    def forward(self, x):
        return _ops.activation(x, self.act)

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self.act)


class LeakyReLU(HybridBlock):
    """x where x >= 0, else alpha x."""

    def __init__(self, alpha: float, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def forward(self, x):
        return _ops.leaky_relu(x, act_type="leaky", slope=self._alpha)

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha)


class PReLU(HybridBlock):
    """LeakyReLU with a learned slope per channel (``alpha``, axis 1)."""

    def __init__(self, alpha_initializer=None, in_channels: int = 1,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        if alpha_initializer is None:
            alpha_initializer = _init.Constant(0.25)
        self.alpha = nn.Parameter(torch.full((in_channels,), 0.25))
        self._gluon_param("alpha", shape=(in_channels,),
                          init=alpha_initializer)

    def forward(self, x):
        return _ops.leaky_relu(x, self.alpha, act_type="prelu")

    def hybrid_forward(self, F, x, alpha):
        return F.LeakyReLU(x, alpha, act_type="prelu")


class ELU(HybridBlock):
    """x where x >= 0, else alpha (e^x - 1)."""

    def __init__(self, alpha: float = 1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._alpha = alpha

    def forward(self, x):
        return _ops.leaky_relu(x, act_type="elu", slope=self._alpha)

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="elu", slope=self._alpha)


class SELU(HybridBlock):
    def forward(self, x):
        return _ops.leaky_relu(x, act_type="selu")

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="selu")


class Swish(HybridBlock):
    """x sigmoid(beta x)."""

    def __init__(self, beta: float = 1.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._beta = beta

    def forward(self, x):
        return x * torch.sigmoid(self._beta * x)

    def hybrid_forward(self, F, x):
        return x * F.sigmoid(self._beta * x)


class GELU(HybridBlock):
    def forward(self, x):
        return _ops.leaky_relu(x, act_type="gelu")

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="gelu")
