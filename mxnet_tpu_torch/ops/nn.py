"""Neural-network layer ops: the subset of ``mxnet_tpu/ops/nn.py`` the
imperative path uses, with the JAX package's semantics.

``FullyConnected`` is ``torch.matmul`` (the JAX op is a plain
``dot_general``).  ``LayerNorm`` takes kernel K1 through
``LayerNormFunction`` on a CUDA tensor, as the JAX op takes its Pallas
kernel wherever it compiles natively; elsewhere, and for
``output_mean_var`` or another axis, it is the plain formula.
``_contrib_add_layer_norm`` is always plain: only the ``fused_kernels``
pass brings kernel K6 (``ops/kernels/registry.py``).
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import register


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
