"""Neural-network layer ops: the subset of ``mxnet_tpu/ops/nn.py`` the
imperative path and the ResNet family use, with the JAX package's
semantics.

``FullyConnected`` is ``torch.matmul`` (the JAX op is a plain
``dot_general``).  ``Convolution`` and ``Pooling`` go to torch's
convolution and pooling (cuDNN on the card), as the JAX ops go to XLA's;
``BatchNorm`` is ``torch.native_batch_norm`` (see :func:`batch_norm`).
None of the three reaches a Pallas kernel in the JAX package, so none has
a kernel here.  ``Convolution`` and ``Pooling`` are 2-D, NCHW or NHWC
(the layers the ResNet family uses).  NHWC keeps the JAX package's
tensors at the op's boundary: the data is (N, H, W, C) and the weight
(O, kh, kw, I); inside the op both are permuted views in torch's
channels-first order, which for a contiguous NHWC tensor is
``torch.channels_last`` memory, so nothing is copied.

``LayerNorm`` takes kernel K1 through ``LayerNormFunction`` on a CUDA
tensor, as the JAX op takes its Pallas kernel wherever it compiles
natively; elsewhere, and for ``output_mean_var`` or another axis, it is
the plain formula.
``_contrib_add_layer_norm`` is always plain: only the ``fused_kernels``
pass brings kernel K6 (``ops/kernels/registry.py``).
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from ..base import MXNetError
from ..precision import runtime as _amp
from .registry import register


def _pair(v, n):
    if v is None or v == ():
        return (0,) * n
    if isinstance(v, int):
        return (v,) * n
    return tuple(v)


def _nhwc(layout, op: str) -> bool:
    """True for NHWC, False for NCHW (or no layout); the ops are 2-D."""
    if layout in (None, "NCHW"):
        return False
    if layout == "NHWC":
        return True
    raise MXNetError(f"{op}: layout {layout!r} is not ported (NCHW, NHWC)")


def _to_channels_first(x, last: bool):
    """(N, H, W, C) -> a (N, C, H, W) view when ``last``; else ``x``."""
    return x.permute(0, 3, 1, 2) if last else x


def _from_channels_first(x, last: bool):
    """The inverse view of :func:`_to_channels_first`."""
    return x.permute(0, 2, 3, 1) if last else x


def _onehot(label, n: int, dtype):
    """(..., n) one-hot of integer labels in ``dtype``: all zeros for a
    label outside [0, n), as ``jax.nn.one_hot``."""
    cols = torch.arange(n, device=label.device)
    return (label.to(torch.int32).unsqueeze(-1) == cols).to(dtype)


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------
@register("FullyConnected")
def fully_connected(data, weight, *bias, num_hidden=None, no_bias=False,
                    flatten=True):
    """y = x W^T + b; weight (num_hidden, input_dim), as MXNet."""
    data, weight, *bias = _amp.cast_inputs("FullyConnected", data, weight,
                                           *bias)
    x = data
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    w = weight
    if data.dtype == torch.float16:  # fp16 accumulates in f32
        x, w = x.float(), w.float()
    y = torch.matmul(x, w.t())
    if data.dtype == torch.float16:
        y = y.to(data.dtype)
    if not no_bias and bias:
        y = y + bias[0]
    return y


@register("Convolution")
def convolution(data, weight, *bias, kernel=(), stride=(), dilate=(), pad=(),
                num_filter=1, num_group=1, no_bias=False, workspace=1024,
                cudnn_tune=None, cudnn_off=False, layout=None):
    """2-D convolution.  The weight follows the data's layout, as in
    MXNet: (O, I/g, kh, kw) for NCHW, (O, kh, kw, I/g) for NHWC; float16
    computes in f32 and rounds back, as the JAX op's safe accumulation.
    ``workspace`` and the ``cudnn_*`` attributes are accepted and
    ignored."""
    if len(kernel) != 2 or data.dim() != 4:
        raise MXNetError(f"Convolution: only 2-D is ported, got a "
                         f"{len(kernel)}-d kernel on {data.dim()}-d data")
    data, weight, *bias = _amp.cast_inputs("Convolution", data, weight,
                                           *bias)
    last = _nhwc(layout, "Convolution")
    x = _to_channels_first(data, last)
    w = _to_channels_first(weight, last)
    b = bias[0] if bias and not no_bias else None
    half = data.dtype == torch.float16
    if half:
        x, w = x.float(), w.float()
        b = None if b is None else b.float()
    out = F.conv2d(x, w, b, stride=_pair(stride or 1, 2),
                   padding=_pair(pad, 2), dilation=_pair(dilate or 1, 2),
                   groups=num_group)
    if half:
        out = out.to(data.dtype)
    return _from_channels_first(out, last)


def _window_sum(x, kernel, stride):
    """Sums over windows of a padded NCHW ``x``, exactly (no division)."""
    return F.avg_pool2d(x, kernel, stride, divisor_override=1)


@register("Pooling")
def pooling(data, kernel=(), pool_type="max", global_pool=False, stride=(),
            pad=(), pooling_convention="valid", count_include_pad=True,
            cudnn_off=False, p_value=2, layout=None):
    """2-D max, average or sum pooling, with the JAX op's windows:
    ``pooling_convention="full"`` pads the high side so that the last
    window covers the input (ceil mode, a window may lie in the
    padding), max pads with -inf and the sums with 0; an average divides
    by the window's size with ``count_include_pad``, else by its count of
    input elements."""
    if data.dim() != 4:
        raise MXNetError(f"Pooling: only 2-D is ported, got {data.dim()}-d "
                         f"data")
    last = _nhwc(layout, "Pooling")
    x = _to_channels_first(data, last)
    if global_pool:
        kernel, stride, pad = tuple(x.shape[2:]), (1, 1), (0, 0)
    kernel = _pair(kernel, 2)
    stride = _pair(stride or 1, 2)
    pad = _pair(pad, 2)
    if pool_type not in ("max", "avg", "sum"):
        raise MXNetError(f"pool_type {pool_type} is not ported")
    if global_pool and pool_type == "avg":
        return _from_channels_first(x.mean(dim=(2, 3), keepdim=True), last)
    hi = list(pad)
    if pooling_convention == "full":
        for i in range(2):
            size = x.shape[2 + i]
            n_out = math.ceil((size + 2 * pad[i] - kernel[i]) / stride[i]) + 1
            need = (n_out - 1) * stride[i] + kernel[i] - size - pad[i]
            hi[i] = max(need, pad[i])
    if pool_type == "max":
        if hi == list(pad) and all(2 * p <= k for p, k in zip(pad, kernel)):
            out = F.max_pool2d(x, kernel, stride, pad)  # -inf padding
        else:
            out = F.max_pool2d(_pad(x, pad, hi, -math.inf), kernel, stride)
        return _from_channels_first(out, last)
    summed = _window_sum(_pad(x, pad, hi, 0.0), kernel, stride)
    if pool_type == "sum":
        out = summed
    elif count_include_pad:
        out = summed / float(math.prod(kernel))
    else:
        ones = torch.ones_like(x[:1, :1])
        counts = _window_sum(_pad(ones, pad, hi, 0.0), kernel, stride)
        out = summed / counts
    return _from_channels_first(out, last)


def _pad(x, lo, hi, value):
    """``x`` padded by ``lo``/``hi`` on its spatial axes with ``value``."""
    widths = []
    for a, b in zip(reversed(lo), reversed(hi)):
        widths += [a, b]
    if not any(widths):
        return x
    return F.pad(x, widths, value=value)


# ---------------------------------------------------------------------------
# activations
# ---------------------------------------------------------------------------
@register("Activation")
def activation(data, act_type="relu"):
    if act_type == "relu":
        return torch.relu(data)
    if act_type == "sigmoid":
        return torch.sigmoid(data)
    if act_type == "tanh":
        return torch.tanh(data)
    if act_type == "softrelu":
        return torch.nn.functional.softplus(data)
    if act_type == "softsign":
        return data / (1 + data.abs())
    raise MXNetError(f"act_type {act_type}")


@register("LeakyReLU")
def leaky_relu(data, *gamma, act_type="leaky", slope=0.25, lower_bound=0.125,
               upper_bound=0.334):
    if act_type == "leaky":
        return torch.where(data >= 0, data, slope * data)
    if act_type == "elu":
        return torch.where(data >= 0, data, slope * torch.expm1(data))
    if act_type == "selu":
        alpha, scale = 1.6732632423543772, 1.0507009873554805
        return scale * torch.where(data >= 0, data,
                                   alpha * torch.expm1(data))
    if act_type == "gelu":
        return torch.nn.functional.gelu(data, approximate="none")
    if act_type == "prelu":
        g = gamma[0]
        shape = [1] * data.dim()
        if data.dim() > 1:
            shape[1] = g.numel()
        return torch.where(data >= 0, data, g.reshape(shape) * data)
    if act_type == "rrelu":
        mid = (lower_bound + upper_bound) / 2
        return torch.where(data >= 0, data, mid * data)
    raise MXNetError(f"act_type {act_type}")


# ---------------------------------------------------------------------------
# softmax family
# ---------------------------------------------------------------------------
@register("softmax")
def softmax(data, *length, axis=-1, temperature=None, dtype=None,
            use_length=False):
    x = data if temperature in (None, 1.0) else data / temperature
    return torch.softmax(x, dim=axis)


@register("log_softmax")
def log_softmax(data, axis=-1, temperature=None, dtype=None):
    x = data if temperature in (None, 1.0) else data / temperature
    return torch.log_softmax(x, dim=axis)


@register("softmax_cross_entropy")
def softmax_cross_entropy(data, label):
    """sum over every row of -log_softmax(data)[label], a scalar."""
    logp = torch.log_softmax(data, dim=-1)
    return torch.sum(-logp * _onehot(label, data.shape[-1], logp.dtype))


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------
@register("LayerNorm")
def layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    if (not output_mean_var and axis in (-1, data.dim() - 1)
            and data.dim() >= 2 and data.device.type == "cuda"):
        from .kernels import LayerNormFunction

        c = data.shape[-1]
        out = LayerNormFunction.apply(data.reshape(-1, c).contiguous(),
                                      gamma, beta, eps)
        return out.reshape(data.shape)
    x32 = data.float()
    mean = x32.mean(dim=axis, keepdim=True)
    var = (x32 - mean).square().mean(dim=axis, keepdim=True)
    inv = torch.rsqrt(var + eps)
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    out = (((x32 - mean) * inv).to(data.dtype) * gamma.reshape(shape)
           + beta.reshape(shape))
    if output_mean_var:
        return out, mean.squeeze(axis), var.squeeze(axis)
    return out


@register("BatchNorm")
def batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
               momentum=0.9, fix_gamma=True, use_global_stats=False,
               output_mean_var=False, axis=1, cudnn_off=False,
               training=False):
    """Batch normalization over every axis but ``axis``, a pure function
    as in the JAX package.  ``fix_gamma`` scales by 1.

    In training mode (and not ``use_global_stats``) it normalizes by the
    batch's f32 mean and biased variance and, with ``output_mean_var``,
    also returns them (for the caller's moving update; they carry no
    gradient).  ``torch.native_batch_norm`` computes that output (torch's
    fused kernel, or cuDNN's, on the card): it rounds the output to the
    data's dtype once, where the JAX expression casts the stats to the
    data's dtype first and rounds after each of its four operations; in
    f32 the two agree to rounding, in 16 bits to a few units in the last
    place.  The variance comes back from the saved inverse standard
    deviation, 1 / invstd^2 - eps, in f32.

    Otherwise it normalizes by ``moving_mean`` and ``moving_var`` with
    the JAX expression itself, ``(x - mean) * rsqrt(var + eps) * gamma +
    beta`` with every term cast to the data's dtype, differentiable in
    every input."""
    data, gamma, beta, moving_mean, moving_var = _amp.cast_inputs(
        "BatchNorm", data, gamma, beta, moving_mean, moving_var)
    axis = axis % data.dim()
    if training and not use_global_stats:
        x = data.movedim(axis, 1) if axis != 1 else data
        out, mean, invstd = torch.native_batch_norm(
            x, None if fix_gamma else gamma, beta, None, None, True, 0.0,
            eps)
        if axis != 1:
            out = out.movedim(1, axis)
        if output_mean_var:
            return out, mean.detach(), invstd.detach().pow(-2) - eps
        return out
    shape = [1] * data.dim()
    shape[axis] = data.shape[axis]
    dt = data.dtype
    g = torch.ones_like(gamma) if fix_gamma else gamma
    inv = torch.rsqrt(moving_var.reshape(shape) + eps).to(dt)
    out = ((data - moving_mean.reshape(shape).to(dt)) * inv
           * g.reshape(shape).to(dt) + beta.reshape(shape).to(dt))
    if output_mean_var:
        return out, moving_mean, moving_var
    return out


@register("_contrib_add_layer_norm")
def add_layer_norm(data, residual, gamma, beta, eps=1e-5):
    """Residual add + last-axis layer norm: LN(data + residual), as one
    op-class so the fused_kernels pass can substitute kernel K6; this
    stock implementation is plain torch."""
    x32 = data.float() + residual.float()
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    out_dtype = torch.promote_types(data.dtype, residual.dtype)
    shape = [1] * data.dim()
    shape[-1] = data.shape[-1]
    return (((x32 - mean) * inv).to(out_dtype) * gamma.reshape(shape)
            + beta.reshape(shape))
