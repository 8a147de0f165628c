"""INT8 (and weight-only INT4) quantization ops.

Counterpart of ``mxnet_tpu/ops/quantization.py``, registered under its
names.  Values are quantized symmetrically about zero onto [-127, 127];
every quantized tensor travels with (min_range, max_range) f32 scalars,
thresh = max(|min|, |max|), scale = 127 / thresh.  Rounding is half to
even (``torch.round``, as ``jnp.round``) and every scale is the JAX op's
f32 expression, so the int8 and int32 outputs equal the JAX package's.

The int8 x int8 -> int32 product (:func:`int8_matmul`) is exact in both
packages.  The JAX package computes it with ``dot_general(...,
preferred_element_type=int32)``; on the card the port calls
``torch._int_mm`` (cuBLASLt), whose shape rules (more than 16 rows,
inner and output widths multiples of 8) it meets by zero padding, which
adds exact zeros; on the CPU it is an integer ``torch.matmul`` in int64.
An f32 matmul of int8 values would not be exact: 127^2 x 4096 > 2^24.
The quantized convolution computes in float64 (``F.conv2d``), exact
because every partial sum is an integer below 2^53.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from .registry import register

__all__ = ["quantize_v2", "dequantize", "requantize", "dequantize_int4",
           "quantized_fully_connected", "quantized_conv", "int8_matmul",
           "calib_thresh"]

_INT32_MAX = float(2 ** 31 - 1)


def _thresh(min_r, max_r):
    return torch.maximum(min_r.abs(), max_r.abs())


def calib_thresh(min_calib_range, max_calib_range) -> np.float32:
    """max(|min|, |max|, 1e-12) of a calibrated range in f32, on the host
    (the JAX op computes it from f32 scalars; numpy's f32 arithmetic
    rounds as the device's does)."""
    t = np.maximum(np.abs(np.float32(min_calib_range)),
                   np.abs(np.float32(max_calib_range)))
    return np.maximum(t, np.float32(1e-12))


def _full(value, device):
    """A 0-d f32 tensor filled on ``device`` (no host-to-device copy, so
    no host sync)."""
    return torch.full((), float(value), dtype=torch.float32, device=device)


@register("_contrib_quantize_v2", differentiable=False)
def quantize_v2(data, min_calib_range=None, max_calib_range=None,
                out_type="int8"):
    """f32 -> int8 with calibrated or on-the-fly ranges.  Returns
    (q_data, min_range, max_range)."""
    x = data.float()
    if min_calib_range is not None and max_calib_range is not None:
        t = calib_thresh(min_calib_range, max_calib_range)
        scale = float(np.float32(127.0) / t)
        t = _full(t, x.device)
    else:
        t = torch.clamp(_thresh(x.min(), x.max()), min=1e-12)
        scale = 127.0 / t
    q = torch.clamp(torch.round(x * scale), -127, 127).to(torch.int8)
    return q, -t, t


@register("_contrib_dequantize", differentiable=False)
def dequantize(data, min_range, max_range, out_type="float32"):
    """int8/int32 -> f32."""
    t = torch.clamp(_thresh(min_range, max_range), min=1e-12)
    if data.dtype == torch.int8:
        scale = t / 127.0
    else:  # int32 accumulator: the range covers the accumulated magnitude
        scale = t / _INT32_MAX
    return data.float() * scale


@register("_contrib_requantize", differentiable=False)
def requantize(data, min_range, max_range, min_calib_range=None,
               max_calib_range=None):
    """int32 accumulator -> int8."""
    t_in = torch.clamp(_thresh(min_range, max_range), min=1e-12)
    real = data.float() * (t_in / _INT32_MAX)
    if min_calib_range is not None and max_calib_range is not None:
        t_out = calib_thresh(min_calib_range, max_calib_range)
        scale = float(np.float32(127.0) / t_out)
        t_out = _full(t_out, real.device)
    else:
        t_out = torch.clamp(real.abs().max(), min=1e-12)
        scale = 127.0 / t_out
    q = torch.clamp(torch.round(real * scale), -127, 127).to(torch.int8)
    return q, -t_out, t_out


def _int32_range(t_data, t_weight):
    """(min, max) of the int32 accumulator in real units."""
    t = t_data * t_weight * (_INT32_MAX / (127.0 * 127.0))
    return -t, t


@register("_contrib_dequantize_int4", differentiable=False)
def dequantize_int4(packed, scales, group_size=32, cols=0):
    """Unpack 2-per-byte int4 weights and apply the group-wise scales.

    ``packed`` is uint8 (rows, padded_cols // 2), low nibble the even
    column (``contrib.quantization._quantize_weight_int4_np``'s layout);
    ``scales`` f16/f32 (rows, padded_cols // group_size).  Returns the
    f32 weight (rows, cols), ``cols`` slicing off the packer's padding."""
    lo = (packed & 0x0F).to(torch.int32)
    hi = (packed >> 4).to(torch.int32)
    # two's-complement nibbles in [-8, 7] (the quantized range is [-7, 7])
    lo = torch.where(lo > 7, lo - 16, lo)
    hi = torch.where(hi > 7, hi - 16, hi)
    rows = packed.shape[0]
    q = torch.stack([lo, hi], dim=-1).reshape(rows, -1)  # interleave
    g = int(group_size)
    w = (q.float().reshape(rows, -1, g)
         * scales.float()[..., None]).reshape(rows, -1)
    c = int(cols)
    return w[:, :c] if c and c != w.shape[1] else w


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul(x, w):
    """x (..., K) int8 times w (N, K) int8, transposed: (..., N) int32,
    exact."""
    lead, K, N = x.shape[:-1], x.shape[-1], w.shape[0]
    a = x.reshape(-1, K)
    M = a.shape[0]
    if a.device.type == "cuda":
        Mp, Kp, Np = max(32, _round_up(M, 8)), _round_up(K, 8), \
            _round_up(N, 8)
        if (Mp, Kp) != (M, K):
            a = F.pad(a, (0, Kp - K, 0, Mp - M))
        b = w if (Np, Kp) == (N, K) else F.pad(w, (0, Kp - K, 0, Np - N))
        out = torch._int_mm(a.contiguous(), b.contiguous().t())[:M, :N]
    else:
        out = (a.to(torch.int64) @ w.to(torch.int64).t()).to(torch.int32)
    return out.reshape(*lead, N)


def _fold_bias(acc, bias, t_d, t_w, shape):
    """``acc`` plus the f32 bias in int32 accumulator units."""
    acc_scale = (127.0 * 127.0) / torch.clamp(t_d * t_w, min=1e-12)
    b = torch.round(bias.float() * acc_scale).to(torch.int32)
    return acc + b.reshape(shape)


@register("_contrib_quantized_fully_connected", differentiable=False)
def quantized_fully_connected(data, weight, bias, min_data, max_data,
                              min_weight, max_weight, min_bias=None,
                              max_bias=None, num_hidden=None, no_bias=False,
                              flatten=True):
    """int8 x int8 -> int32 FC.  Returns (int32 out, min_out, max_out);
    the f32 bias is folded in int32 units."""
    x = data
    if flatten and x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    acc = int8_matmul(x, weight)
    t_d = _thresh(min_data, max_data)
    t_w = _thresh(min_weight, max_weight)
    mn, mx = _int32_range(t_d, t_w)
    if not no_bias and bias is not None:
        acc = _fold_bias(acc, bias, t_d, t_w, (-1,))
    return acc, mn, mx


@register("_contrib_quantized_conv", differentiable=False)
def quantized_conv(data, weight, bias, min_data, max_data, min_weight,
                   max_weight, min_bias=None, max_bias=None, kernel=(),
                   stride=(), dilate=(), pad=(), num_filter=1, num_group=1,
                   no_bias=False, layout=None):
    """int8 2-D convolution (NCHW, OIHW) with an exact int32 result."""
    n = len(kernel)
    stride = tuple(stride) if stride else (1,) * n
    dilate = tuple(dilate) if dilate else (1,) * n
    pad = tuple(pad) if pad else (0,) * n
    acc = F.conv2d(data.double(), weight.double(), stride=stride,
                   padding=pad, dilation=dilate,
                   groups=num_group).round().to(torch.int32)
    t_d = _thresh(min_data, max_data)
    t_w = _thresh(min_weight, max_weight)
    mn, mx = _int32_range(t_d, t_w)
    if not no_bias and bias is not None:
        acc = _fold_bias(acc, bias, t_d, t_w, (1, -1) + (1,) * n)
    return acc, mn, mx
