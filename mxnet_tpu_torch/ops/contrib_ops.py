"""Contrib operators: fused attention, the counterpart of
``mxnet_tpu/ops/contrib_ops.py::flash_attention_op``.

``_contrib_flash_attention`` takes q/k/v as (N, L, D) or (B, H, L, D).  On a
CUDA tensor it runs kernels K3-K5 (``ops.kernels.flash_attention``: f32,
head dims up to 128, zero-padded to 16/32/64/128; raising above), as the
JAX op runs its Pallas kernel wherever it compiles natively; on the CPU it
is the JAX op's dense composition.  The ring/Ulysses sequence-parallel
routes of the JAX op are not ported.
"""
from __future__ import annotations

import math

import torch

from .registry import register


def _dense_attention(q, k, v, causal, sm_scale):
    s = torch.einsum("nqd,nkd->nqk", q.float(), k.float()) * sm_scale
    if causal:
        lq, lk = q.shape[1], k.shape[1]
        keep = (torch.arange(lq, device=q.device)[:, None]
                >= torch.arange(lk, device=q.device)[None, :])
        s = torch.where(keep[None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("nqk,nkd->nqd", p, v.float()).to(q.dtype)


@register("_contrib_flash_attention")
def flash_attention_op(q, k, v, causal=False, sm_scale=None):
    """Fused softmax(q k^T * sm_scale) v; q/k/v (N, L, D) or (B, H, L, D)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cuda":
        from .kernels import flash_attention

        return flash_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(), causal=causal,
                               sm_scale=sm_scale)
    if q.dim() == 4:
        b, h = q.shape[:2]
        out = _dense_attention(q.reshape(b * h, *q.shape[2:]),
                               k.reshape(b * h, *k.shape[2:]),
                               v.reshape(b * h, *v.shape[2:]),
                               causal, sm_scale)
        return out.reshape(b, h, *out.shape[1:])
    return _dense_attention(q, k, v, causal, sm_scale)
