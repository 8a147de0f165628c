"""Neural-network layer ops, from ``mxnet_tpu/ops/nn.py``, under its
names and attributes.

``FullyConnected`` is ``torch.matmul`` (the JAX op is a plain
``dot_general``).  ``Convolution``, ``Deconvolution`` and ``Pooling`` go
to torch's convolutions and pooling (cuDNN on the card), as the JAX ops
go to XLA's; ``BatchNorm`` is ``torch.native_batch_norm`` (see
:func:`batch_norm`).  None of them reaches a Pallas kernel in the JAX
package, so none has a kernel here.  They take 1, 2 or 3 spatial axes
(the rank of ``kernel``, or of the data for ``Pooling``), channels first
(NCW, NCHW, NCDHW) or last (NWC, NHWC, NDHWC).  A channel-last layout
keeps the JAX package's tensors at the op's boundary: the data is (N,
*spatial, C) and the weight (O, *k, I) ((I, *k, O/g) for
``Deconvolution``); inside the op both are views in torch's
channels-first order, which for a contiguous NHWC tensor is
``torch.channels_last`` memory, so nothing is copied.

``LayerNorm`` takes kernel K1 through ``LayerNormFunction`` on a CUDA
tensor, as the JAX op takes its Pallas kernel wherever it compiles
natively; elsewhere, and for ``output_mean_var`` or another axis, it is
the plain formula.
``_contrib_add_layer_norm`` is always plain: only the ``fused_kernels``
pass brings kernel K6 (``ops/kernels/registry.py``).

The rest are plain torch, as they are plain ``jnp`` in the JAX package:
the normalizations (``InstanceNorm``, ``GroupNorm``, ``LRN``),
``Dropout`` (drawn from a ``torch.Generator``, see :func:`dropout`),
``UpSampling`` / ``BilinearResize2D`` (``jax.image.resize``'s weights),
the legacy output ops (``SoftmaxOutput``, the regression outputs,
``MakeLoss``, ``SVMOutput``: ``torch.autograd.Function``s whose backward
ignores the incoming gradient, as MXNet's does), ``ctc_loss``
(``torch.nn.functional.ctc_loss`` after the blank and padding
conventions are mapped), ``Pad``, ``Crop``, ``moments``, ``im2col`` /
``col2im`` (strided slices of the padded input, any rank) and the packed
``RNN`` op (``rnn_ops``).
"""
from __future__ import annotations

import itertools
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


_LAYOUTS = {1: ("NCW", "NWC"), 2: ("NCHW", "NHWC"), 3: ("NCDHW", "NDHWC")}


def _channel_last(layout, n: int, op: str) -> bool:
    """True for the channel-last layout of ``n`` spatial axes, False for
    the channels-first one (or no layout); raise on anything else."""
    if n not in _LAYOUTS:
        raise MXNetError(f"{op}: {n} spatial axes; 1, 2 or 3 are supported")
    first, last = _LAYOUTS[n]
    if layout in (None, first):
        return False
    if layout == last:
        return True
    raise MXNetError(f"{op}: layout {layout!r} does not fit {n} spatial "
                     f"axes ({first} or {last})")


def _to_channels_first(x, last: bool):
    """(N, *spatial, C) -> a (N, C, *spatial) view when ``last``; else
    ``x``."""
    return x.movedim(-1, 1) if last else x


def _from_channels_first(x, last: bool):
    """The inverse view of :func:`_to_channels_first`."""
    return x.movedim(1, -1) if last else x


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


def _spatial_rank(data, kernel, op: str) -> int:
    n = len(kernel)
    if data.dim() != n + 2:
        raise MXNetError(f"{op}: a {n}-d kernel on {data.dim()}-d data")
    return n


@register("Convolution")
def convolution(data, weight, *bias, kernel=(), stride=(), dilate=(), pad=(),
                num_filter=1, num_group=1, no_bias=False, workspace=1024,
                cudnn_tune=None, cudnn_off=False, layout=None):
    """1-, 2- or 3-D convolution (the rank of ``kernel``).  The weight
    follows the data's layout, as in MXNet: (O, I/g, *k) channels first,
    (O, *k, I/g) channels last; float16 computes in f32 and rounds back,
    as the JAX op's safe accumulation.  ``workspace`` and the ``cudnn_*``
    attributes are accepted and ignored."""
    n = _spatial_rank(data, kernel, "Convolution")
    data, weight, *bias = _amp.cast_inputs("Convolution", data, weight,
                                           *bias)
    last = _channel_last(layout, n, "Convolution")
    x = _to_channels_first(data, last)
    w = _to_channels_first(weight, last)
    b = bias[0] if bias and not no_bias else None
    half = data.dtype == torch.float16
    if half:
        x, w = x.float(), w.float()
        b = None if b is None else b.float()
    conv = (F.conv1d, F.conv2d, F.conv3d)[n - 1]
    out = conv(x, w, b, stride=_pair(stride or 1, n), padding=_pair(pad, n),
               dilation=_pair(dilate or 1, n), groups=num_group)
    if half:
        out = out.to(data.dtype)
    return _from_channels_first(out, last)


def _window_sum(x, kernel, stride):
    """Sums over windows of a padded channels-first ``x``, exactly (no
    division); 1-D as 2-D over a unit height.  16-bit data sums in f32
    and rounds once, as torch's CUDA pooling does inside (its CPU 3-D
    pooling has no bf16 kernel)."""
    if x.dtype in (torch.bfloat16, torch.float16):
        return _window_sum(x.float(), kernel, stride).to(x.dtype)
    if len(kernel) == 1:
        return F.avg_pool2d(x.unsqueeze(2), (1,) + tuple(kernel),
                            (1,) + tuple(stride),
                            divisor_override=1).squeeze(2)
    pool = F.avg_pool2d if len(kernel) == 2 else F.avg_pool3d
    return pool(x, kernel, stride, divisor_override=1)


@register("Pooling")
def pooling(data, kernel=(), pool_type="max", global_pool=False, stride=(),
            pad=(), pooling_convention="valid", count_include_pad=True,
            cudnn_off=False, p_value=2, layout=None):
    """1-, 2- or 3-D max, average, sum or Lp pooling (the data's rank),
    with the JAX op's windows: ``pooling_convention="full"`` pads the
    high side so that the last window covers the input (ceil mode, a
    window may lie in the padding), max pads with -inf and the sums with
    0; an average divides by the window's size with
    ``count_include_pad``, else by its count of input elements; ``lp``
    is (the window's sum of |x| ** p_value) ** (1 / p_value)."""
    n = data.dim() - 2
    last = _channel_last(layout, n, "Pooling")
    x = _to_channels_first(data, last)
    if global_pool:
        kernel, stride, pad = tuple(x.shape[2:]), (1,) * n, (0,) * n
    kernel = _pair(kernel, n)
    stride = _pair(stride or 1, n)
    pad = _pair(pad, n)
    if pool_type not in ("max", "avg", "sum", "lp"):
        raise MXNetError(f"pool_type {pool_type}")
    if global_pool and pool_type == "avg":
        return _from_channels_first(
            x.mean(dim=tuple(range(2, n + 2)), keepdim=True), last)
    hi = list(pad)
    if pooling_convention == "full":
        for i in range(n):
            size = x.shape[2 + i]
            n_out = math.ceil((size + 2 * pad[i] - kernel[i]) / stride[i]) + 1
            need = (n_out - 1) * stride[i] + kernel[i] - size - pad[i]
            hi[i] = max(need, pad[i])
    if pool_type == "max":
        pool = (F.max_pool1d, F.max_pool2d, F.max_pool3d)[n - 1]
        if hi == list(pad) and all(2 * p <= k for p, k in zip(pad, kernel)):
            out = pool(x, kernel, stride, pad)  # -inf padding
        else:
            out = pool(_pad(x, pad, hi, -math.inf), kernel, stride)
        return _from_channels_first(out, last)
    if pool_type == "lp":
        # |x| with the JAX op's gradient at 0 (+1, where torch's abs has 0)
        mag = torch.where(x >= 0, x, -x)
        summed = _window_sum(_pad(mag ** p_value, pad, hi, 0.0), kernel,
                             stride)
        return _from_channels_first(summed ** (1.0 / p_value), last)
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


# ---------------------------------------------------------------------------
# the rest of ops/nn.py: deconvolution, normalizations, dropout, resizing,
# the legacy output ops, CTC, the spatial utilities and the packed RNN
# ---------------------------------------------------------------------------
@register("Deconvolution")
def deconvolution(data, weight, *bias, kernel=(), stride=(), dilate=(),
                  pad=(), adj=(), target_shape=(), num_filter=1, num_group=1,
                  no_bias=True, workspace=1024, cudnn_tune=None,
                  cudnn_off=False, layout=None):
    """1-, 2- or 3-D transposed convolution, out = (in - 1) s - 2 p + d (k
    - 1) + 1 + adj.  The weight is (C_in, C_out / g, *k) channels first,
    as MXNet's and torch's, and (C_in, *k, C_out / g) channels last."""
    n = _spatial_rank(data, kernel, "Deconvolution")
    if target_shape:
        raise NotImplementedError(
            "Deconvolution target_shape is not supported; give pad/adj "
            "explicitly (out = (in-1)*s - 2p + d*(k-1) + 1 + adj)")
    data, weight, *bias = _amp.cast_inputs("Deconvolution", data, weight,
                                           *bias)
    last = _channel_last(layout, n, "Deconvolution")
    x = _to_channels_first(data, last)
    w = _to_channels_first(weight, last)
    b = bias[0] if bias and not no_bias else None
    half = data.dtype == torch.float16
    if half:
        x, w = x.float(), w.float()
        b = None if b is None else b.float()
    conv = (F.conv_transpose1d, F.conv_transpose2d, F.conv_transpose3d)[n - 1]
    out = conv(x, w, b, stride=_pair(stride or 1, n), padding=_pair(pad, n),
               output_padding=_pair(adj or 0, n), groups=num_group,
               dilation=_pair(dilate or 1, n))
    if half:
        out = out.to(data.dtype)
    return _from_channels_first(out, last)


@register("softmin")
def softmin(data, axis=-1, temperature=None, dtype=None):
    x = data if temperature in (None, 1.0) else data / temperature
    return torch.softmax(-x, dim=axis)


@register("SoftmaxActivation")
def softmax_activation(data, mode="instance"):
    if mode == "channel":
        return torch.softmax(data, dim=1)
    return torch.softmax(data.reshape(data.shape[0], -1), dim=-1).reshape(
        data.shape)


@register("InstanceNorm")
def instance_norm(data, gamma, beta, eps=1e-3):
    data, gamma, beta = _amp.cast_inputs("InstanceNorm", data, gamma, beta)
    red = tuple(range(2, data.dim()))
    mean = data.mean(dim=red, keepdim=True)
    var = (data - mean).square().mean(dim=red, keepdim=True)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return ((data - mean) * torch.rsqrt(var + eps) * gamma.reshape(shape)
            + beta.reshape(shape))


@register("GroupNorm")
def group_norm(data, gamma, beta, num_groups=1, eps=1e-5):
    data, gamma, beta = _amp.cast_inputs("GroupNorm", data, gamma, beta)
    n, c = data.shape[:2]
    x = data.reshape((n, num_groups, c // num_groups) + data.shape[2:])
    red = tuple(range(2, x.dim()))
    mean = x.mean(dim=red, keepdim=True)
    var = (x - mean).square().mean(dim=red, keepdim=True)
    x = ((x - mean) * torch.rsqrt(var + eps)).reshape(data.shape)
    shape = (1, -1) + (1,) * (data.dim() - 2)
    return x * gamma.reshape(shape) + beta.reshape(shape)


@register("LRN")
def lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """x / (knorm + alpha / nsize * sum of x^2 over nsize channels)^beta."""
    sq = data.square()
    half = nsize // 2
    padded = F.pad(sq, (0, 0, 0, 0, half, half))
    window = sum(padded[:, i:i + data.shape[1]] for i in range(nsize))
    return data / torch.pow(knorm + alpha / nsize * window, beta)


@register("Dropout")
def dropout(data, p=0.5, mode="training", axes=(), training=False,
            cudnn_off=False, generator=None):
    """In training, zero each element with probability ``p`` and scale
    the rest by 1 / (1 - p); ``axes`` share one mask along them
    (variational dropout).  The mask is drawn from ``generator``, by
    default the generator of ``data``'s device (``random.generator``),
    never a key input as in the JAX op (see ``random_ops``).  On the
    CPU this is ``torch.nn.functional.dropout``'s arithmetic, mask
    included."""
    if not training or p <= 0.0:
        return data
    from .. import random as _rng

    g = generator if generator is not None else _rng.generator(data.device)
    shape = [1 if (i in axes or i - data.dim() in axes) else s
             for i, s in enumerate(data.shape)]
    keep = 1.0 - p
    if keep <= 0.0:
        return data * 0.0
    mask = torch.empty(shape, dtype=data.dtype, device=data.device)
    mask.bernoulli_(keep, generator=g).div_(keep)
    return data * mask


def _resize_weights(n_in, n_out, device):
    """(n_in, n_out) weights of ``jax.image.resize``'s ``bilinear``
    (``linear``) method, antialiased: a triangle kernel widened by the
    downscale factor, normalized, zero for samples outside the input."""
    scale = n_out / n_in
    kernel_scale = max(1.0 / scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32) + 0.5) / scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]
         ).abs() / kernel_scale
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def _resize_bilinear(data, height, width):
    """(N, C, H, W) -> (N, C, height, width), as ``jax.image.resize(...,
    method="bilinear")``: separable weights, f32 products."""
    _, _, h, w = data.shape
    wh = _resize_weights(h, height, data.device)
    ww = _resize_weights(w, width, data.device)
    out = torch.einsum("nchw,hH,wW->ncHW", data.float(), wh, ww)
    return out.to(data.dtype)


@register("UpSampling")
def upsampling(*inputs, scale=1, sample_type="nearest", num_args=1,
               num_filter=0, multi_input_mode="concat", workspace=512):
    data = inputs[0]
    n, c, h, w = data.shape
    if sample_type == "nearest":
        return data.repeat_interleave(scale, dim=2).repeat_interleave(
            scale, dim=3)
    return _resize_bilinear(data, h * scale, w * scale)


@register("BilinearResize2D")
def bilinear_resize_2d(data, height=1, width=1, scale_height=None,
                       scale_width=None, mode="size"):
    _, _, h, w = data.shape
    if scale_height is not None:
        height, width = int(h * scale_height), int(w * scale_width)
    return _resize_bilinear(data, height, width)


# ---------------------------------------------------------------------------
# the legacy output ops: their backward ignores the incoming gradient and
# emits the loss's own, as in MXNet and the JAX package
# ---------------------------------------------------------------------------
class _SoftmaxOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, attrs):
        out = torch.softmax(data, dim=1 if attrs["multi_output"] else -1)
        ctx.save_for_backward(out, label)
        ctx.attrs = attrs
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        a = ctx.attrs
        axis = 1 if a["multi_output"] else -1
        k = out.shape[axis]
        onehot = _onehot(label, k, out.dtype)
        if a["multi_output"]:
            onehot = onehot.movedim(-1, 1)
        if a["smooth_alpha"]:
            sa = a["smooth_alpha"]
            onehot = onehot * (1 - sa) + sa / (k - 1) * (1 - onehot)
        grad = out - onehot
        ignore = label != a["ignore_label"]
        if a["use_ignore"]:
            mask = ignore.to(out.dtype)
            if mask.dim() < grad.dim():
                mask = mask.unsqueeze(axis)
            grad = grad * mask
        scale = a["grad_scale"]
        if a["normalization"] == "valid" and a["use_ignore"]:
            scale = scale / ignore.sum().to(out.dtype).clamp_min(1.0)
        elif a["normalization"] == "batch":
            scale = scale / out.shape[0]
        return grad * scale, None, None


@register("SoftmaxOutput")
def softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                   use_ignore=False, multi_output=False, preserve_shape=False,
                   normalization="null", out_grad=False, smooth_alpha=0.0):
    """Softmax forward; backward (p - onehot(label)) * grad_scale,
    masked at ``ignore_label`` with ``use_ignore``, normalized by the
    batch or the valid count, with label smoothing ``smooth_alpha``."""
    data, = _amp.cast_inputs("SoftmaxOutput", data)
    attrs = dict(grad_scale=grad_scale, ignore_label=ignore_label,
                 use_ignore=use_ignore, multi_output=multi_output,
                 normalization=normalization, smooth_alpha=smooth_alpha)
    return _SoftmaxOutput.apply(data, label, attrs)


_TRANSFORMS = {"linear": lambda x: x, "mae": lambda x: x,
               "logistic": torch.sigmoid}
_RESIDUALS = {"linear": lambda o, l: o - l, "mae": lambda o, l: torch.sign(o - l),
              "logistic": lambda o, l: o - l}


class _RegressionOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, kind, grad_scale):
        out = _TRANSFORMS[kind](data)
        ctx.save_for_backward(out, label)
        ctx.kind, ctx.grad_scale = kind, grad_scale
        return out

    @staticmethod
    def backward(ctx, g):
        out, label = ctx.saved_tensors
        grad = _RESIDUALS[ctx.kind](out, label) * ctx.grad_scale
        return grad, None, None, None


def _regression_output(kind, data, label, grad_scale):
    return _RegressionOutput.apply(data, label.reshape(data.shape), kind,
                                   grad_scale)


@register("LinearRegressionOutput")
def linear_regression_output(data, label, grad_scale=1.0):
    return _regression_output("linear", data, label, grad_scale)


@register("MAERegressionOutput")
def mae_regression_output(data, label, grad_scale=1.0):
    return _regression_output("mae", data, label, grad_scale)


@register("LogisticRegressionOutput")
def logistic_regression_output(data, label, grad_scale=1.0):
    return _regression_output("logistic", data, label, grad_scale)


class _MakeLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grad_scale, valid_thresh, normalization):
        ctx.save_for_backward(x)
        ctx.attrs = (grad_scale, valid_thresh, normalization)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        grad_scale, valid_thresh, normalization = ctx.attrs
        if normalization == "valid":
            denom = (x > valid_thresh).sum().to(x.dtype).clamp_min(1.0)
        else:
            denom = float(x.shape[0]) if normalization == "batch" else 1.0
        return torch.full_like(g, grad_scale) / denom, None, None, None


@register("MakeLoss")
def make_loss(data, grad_scale=1.0, valid_thresh=0.0, normalization="null"):
    """Forward identity; backward ``grad_scale``, normalized by the batch
    size or the count of elements above ``valid_thresh``."""
    return _MakeLoss.apply(data, grad_scale, valid_thresh, normalization)


class _SVMOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, margin, reg, use_linear):
        ctx.save_for_backward(data, label)
        ctx.attrs = (margin, reg, use_linear)
        return data.view_as(data)

    @staticmethod
    def backward(ctx, g):
        data, label = ctx.saved_tensors
        margin, reg, use_linear = ctx.attrs
        x32 = data.float()
        onehot = _onehot(label, data.shape[-1], torch.float32)
        scores_y = (x32 * onehot).sum(-1, keepdim=True)
        viol = margin - scores_y + x32
        mask = ((viol > 0) & (onehot == 0)).float()
        grad = reg * mask if use_linear else 2.0 * reg * viol * mask
        grad = grad - onehot * grad.sum(-1, keepdim=True)
        return grad.to(data.dtype), None, None, None, None


@register("SVMOutput")
def svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
               use_linear=False):
    """Forward identity; backward the L1- or L2-SVM hinge gradient."""
    return _SVMOutput.apply(data, label, float(margin),
                            float(regularization_coefficient),
                            bool(use_linear))


# ---------------------------------------------------------------------------
# CTC loss
# ---------------------------------------------------------------------------
@register("ctc_loss")
def ctc_loss(data, label, *lengths, use_data_lengths=False,
             use_label_lengths=False, blank_label="first"):
    """Connectionist Temporal Classification loss, (N,), of (T, N, C)
    activations (softmax inside) and (N, Lmax) labels.  ``blank_label``
    ``first``: blank 0, labels 1..C-1, 0 pads; ``last``: blank C-1,
    labels 0..C-2, -1 pads.  Label lengths count the labels that are
    not padding unless ``use_label_lengths`` gives them; data lengths
    follow positionally with ``use_data_lengths``.  Computed by
    ``torch.nn.functional.ctc_loss`` on the log-softmax, in f32."""
    T, N, C = data.shape
    blank = 0 if blank_label == "first" else C - 1
    logp = torch.log_softmax(data.float(), dim=-1)
    li = 0
    if use_data_lengths:
        t_lens = lengths[li].long()
        li += 1
    else:
        t_lens = torch.full((N,), T, dtype=torch.long, device=data.device)
    lab = label.long()
    if use_label_lengths:
        l_lens = lengths[li].long()
    elif blank_label == "first":
        l_lens = (lab > 0).sum(1)
    else:
        l_lens = (lab >= 0).sum(1)
    lab = lab.clamp_min(0)
    loss = F.ctc_loss(logp, lab, t_lens, l_lens, blank=blank,
                      reduction="none", zero_infinity=False)
    return loss.to(data.dtype)


# ---------------------------------------------------------------------------
# legacy spatial utilities
# ---------------------------------------------------------------------------
@register("Pad")
def pad_op(data, mode="constant", pad_width=(), constant_value=0.0):
    """``pad_width`` is the flat (before, after) pair of every axis."""
    from .matrix import pad_array

    widths = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
              for i in range(data.dim())]
    return pad_array(data, widths, mode, constant_value)


@register("Crop")
def crop_op(*inputs, offset=(0, 0), h_w=(0, 0), num_args=1,
            center_crop=False):
    """(B, C, H, W) cropped to ``h_w``, or to a second input's spatial
    size."""
    data = inputs[0]
    if num_args == 2 and len(inputs) > 1:
        th, tw = inputs[1].shape[2], inputs[1].shape[3]
    else:
        th, tw = int(h_w[0]), int(h_w[1])
    H, W = data.shape[2], data.shape[3]
    if center_crop:
        y0, x0 = (H - th) // 2, (W - tw) // 2
    else:
        y0, x0 = int(offset[0]), int(offset[1])
    return data[:, :, y0:y0 + th, x0:x0 + tw]


@register("moments")
def moments(data, axes=None, keepdims=False):
    """Mean and variance over ``axes``, computed in f32."""
    ax = (tuple(int(a) for a in axes) if axes is not None
          else tuple(range(data.dim())))
    x32 = data.float()
    mean = x32.mean(dim=ax, keepdim=True)
    var = (x32 - mean).square().mean(dim=ax, keepdim=keepdims)
    if not keepdims:
        mean = mean.squeeze(ax)
    return mean.to(data.dtype), var.to(data.dtype)


def _window_geometry(kernel, stride, dilate, pad, padded):
    """(kernel, stride, dilate, pad, output sizes, the slices of each
    kernel position) of sliding windows over spatial sizes ``padded``."""
    n = len(kernel)
    kernel = tuple(int(k) for k in kernel)
    stride = _pair(stride or 1, n)
    dilate = _pair(dilate or 1, n)
    pad = _pair(pad or 0, n)
    padded = [padded[i] + 2 * pad[i] for i in range(n)]
    o_sp = [(padded[i] - (dilate[i] * (kernel[i] - 1) + 1)) // stride[i] + 1
            for i in range(n)]
    slices = [tuple(slice(k[i] * dilate[i],
                          k[i] * dilate[i] + (o_sp[i] - 1) * stride[i] + 1,
                          stride[i]) for i in range(n))
              for k in itertools.product(*(range(k) for k in kernel))]
    return pad, o_sp, slices


@register("im2col")
def im2col(data, kernel=(), stride=(), dilate=(), pad=()):
    """(B, C, *spatial) -> (B, C * prod(kernel), L), channel-major
    features then kernel positions in row-major order, any rank."""
    pad, o_sp, slices = _window_geometry(kernel, stride, dilate, pad,
                                         data.shape[2:])
    x = _pad(data, pad, pad, 0.0)
    cols = torch.stack([x[(slice(None), slice(None)) + sl] for sl in slices],
                       2)
    return cols.reshape(data.shape[0], -1, math.prod(o_sp))


@register("col2im")
def col2im(data, output_size=(), kernel=(), stride=(), dilate=(), pad=()):
    """The inverse of im2col: overlapping patches add into (B, C,
    *output_size), in f32."""
    out_sp = tuple(int(s) for s in output_size)
    pad, o_sp, slices = _window_geometry(kernel, stride, dilate, pad, out_sp)
    B = data.shape[0]
    cols = data.float().reshape((B, -1, len(slices)) + tuple(o_sp))
    out = cols.new_zeros((B, cols.shape[1])
                         + tuple(s + 2 * p for s, p in zip(out_sp, pad)))
    for j, sl in enumerate(slices):
        out[(slice(None), slice(None)) + sl] += cols[:, :, j]
    crop = tuple(slice(p, p + s) for p, s in zip(pad, out_sp))
    return out[(slice(None), slice(None)) + crop].to(data.dtype)


@register("RNN")
def rnn_op(data, parameters, state, *state_cell, state_size=0, num_layers=1,
           bidirectional=False, mode="lstm", p=0.0, state_outputs=False,
           projection_size=None, use_sequence_length=False,
           lstm_state_clip_min=None, lstm_state_clip_max=None,
           lstm_state_clip_nan=False):
    """The fused RNN over MXNet's packed flat parameter vector
    (``rnn_ops.rnn_packed_layout``), unpacked into views and run by
    ``_fused_rnn``; no dropout between layers (the op has no generator
    input, as the JAX op has no key)."""
    from .rnn_ops import _fused_rnn, rnn_packed_layout

    if use_sequence_length:
        raise MXNetError("RNN: use_sequence_length is not supported; mask "
                         "outputs with SequenceMask instead")
    if (lstm_state_clip_min is not None or lstm_state_clip_max is not None
            or projection_size is not None):
        raise MXNetError("RNN: lstm_state_clip_* / projection_size are not "
                         "supported")
    H = int(state_size)
    dirs = 2 if bidirectional else 1
    entries, _ = rnn_packed_layout(mode, data.shape[2], H, num_layers,
                                   bidirectional)
    by_key = {(l, d, g, k): (off, shp) for l, d, g, k, off, shp in entries}

    def take(key):
        off, shp = by_key[key]
        return parameters[off:off + math.prod(shp)].reshape(shp)

    weights = []
    for layer in range(num_layers):
        for d in range(dirs):
            weights.extend(take((layer, d, g, k)) for g, k in (
                ("i2h", "weight"), ("h2h", "weight"), ("i2h", "bias"),
                ("h2h", "bias")))
    cell = state_cell[0] if mode == "lstm" else torch.zeros_like(state)
    outs = _fused_rnn(data, state, cell, *weights, mode=mode, state_size=H,
                      num_layers=num_layers, bidirectional=bidirectional)
    if not state_outputs:
        return outs[0]
    return outs
