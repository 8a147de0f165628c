"""Contrib operators, from ``mxnet_tpu/ops/contrib_ops.py``: fused
attention, the interleaved self-attention products, adaptive average
pooling, deformable convolution (v1) and ``histogram``.

``_contrib_flash_attention`` takes q/k/v as (N, L, D) or (B, H, L, D).  On a
CUDA tensor it runs kernels K3-K5 (``ops.kernels.flash_attention``: f32,
head dims up to 128, zero-padded to 16/32/64/128; raising above), as the
JAX op runs its Pallas kernel wherever it compiles natively; on the CPU it
is the JAX op's dense composition.  The ring/Ulysses sequence-parallel
routes of the JAX op are not ported.

The rest are plain torch, as they are plain ``jnp`` in the JAX package:
``_contrib_AdaptiveAvgPooling2D`` through an integral image,
``_contrib_DeformableConvolution`` as a bilinearly sampled im2col volume
and one ``einsum``, and ``histogram`` (numpy's semantics, the last edge
inclusive) through ``bincount``.
"""
from __future__ import annotations

import math

import numpy as np
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


@register("_contrib_interleaved_matmul_selfatt_qk")
def interleaved_matmul_selfatt_qk(queries_keys_values, heads=1):
    """(L, B, 3 H D) interleaved q, k, v -> q k^T / sqrt(D), (B H, L, L)."""
    L, B, P = queries_keys_values.shape
    D = P // (3 * heads)
    x = queries_keys_values.reshape(L, B, heads, 3, D)
    q = x[:, :, :, 0].permute(1, 2, 0, 3).reshape(B * heads, L, D)
    k = x[:, :, :, 1].permute(1, 2, 0, 3).reshape(B * heads, L, D)
    return torch.einsum("nqd,nkd->nqk", q, k) / math.sqrt(D)


@register("_contrib_interleaved_matmul_selfatt_valatt")
def interleaved_matmul_selfatt_valatt(queries_keys_values, attention,
                                      heads=1):
    """``attention`` (B H, L, L) times the interleaved v -> (L, B, H D)."""
    L, B, P = queries_keys_values.shape
    D = P // (3 * heads)
    x = queries_keys_values.reshape(L, B, heads, 3, D)
    v = x[:, :, :, 2].permute(1, 2, 0, 3).reshape(B * heads, L, D)
    out = torch.einsum("nqk,nkd->nqd", attention, v)
    return out.reshape(B, heads, L, D).permute(2, 0, 1, 3).reshape(
        L, B, heads * D)


@register("_contrib_AdaptiveAvgPooling2D")
def adaptive_avg_pooling(data, output_size=1):
    """Cell (i, j) averages the input window [floor(i H / Ho),
    ceil((i + 1) H / Ho)) (and the same across), read off an integral
    image."""
    if isinstance(output_size, int):
        oh = ow = int(output_size)
    else:
        oh, ow = int(output_size[0]), int(output_size[-1])
    n, c, h, w = data.shape
    integ = torch.nn.functional.pad(
        data.float().cumsum(2).cumsum(3), (1, 0, 1, 0))
    hs = np.floor(np.arange(oh) * h / oh).astype(np.int64)
    he = np.ceil((np.arange(oh) + 1) * h / oh).astype(np.int64)
    ws = np.floor(np.arange(ow) * w / ow).astype(np.int64)
    we = np.ceil((np.arange(ow) + 1) * w / ow).astype(np.int64)
    area = torch.as_tensor(((he - hs)[:, None] * (we - ws)[None, :]).astype(
        np.float32), device=data.device)
    hs, he, ws, we = (torch.as_tensor(a, device=data.device)
                      for a in (hs, he, ws, we))
    s = (integ[:, :, he][:, :, :, we] - integ[:, :, hs][:, :, :, we]
         - integ[:, :, he][:, :, :, ws] + integ[:, :, hs][:, :, :, ws])
    return (s / area).to(data.dtype)


@register("histogram")
def histogram(data, *bin_arr, bin_cnt=None, range=None, bins=10):
    """(counts int32, edges f32): ``bin_cnt`` equal bins over ``range``
    (the data's min and max by default), or the edges in ``bin_arr``."""
    x = data.reshape(-1).float()
    if bin_arr:
        edges = bin_arr[0].float()
        nbins = edges.shape[0] - 1
        idx = torch.searchsorted(edges, x, right=True) - 1
        idx = torch.where(x == edges[-1], torch.full_like(idx, nbins - 1),
                          idx)
        valid = (idx >= 0) & (idx < nbins)
        counts = torch.bincount(idx[valid], minlength=nbins)
        return counts.to(torch.int32), edges
    cnt = int(bin_cnt if bin_cnt is not None else bins)
    if range is None:
        lo, hi = x.min(), x.max()
    else:
        lo = torch.tensor(float(range[0]), device=x.device)
        hi = torch.tensor(float(range[1]), device=x.device)
    span = torch.where(hi > lo, hi - lo, torch.ones_like(hi))
    idx = torch.floor((x - lo) / span * cnt).long().clamp(0, cnt - 1)
    valid = (x >= lo) & (x <= hi)
    counts = torch.bincount(idx[valid], minlength=cnt)
    edges = lo + (hi - lo) * torch.arange(cnt + 1, dtype=torch.float32,
                                          device=x.device) / cnt
    return counts.to(torch.int32), edges


def _bilinear_gather(img, y, x):
    """``img`` (C, H, W) at float coords y, x (equal shapes), zero
    outside."""
    c, h, w = img.shape
    y0, x0 = torch.floor(y), torch.floor(x)
    wy1, wx1 = y - y0, x - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1

    def at(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        yc = yy.long().clamp(0, h - 1)
        xc = xx.long().clamp(0, w - 1)
        v = img[:, yc, xc]
        return torch.where(inside, v, torch.zeros_like(v))

    return (at(y0, x0) * (wy0 * wx0) + at(y0, x0 + 1) * (wy0 * wx1)
            + at(y0 + 1, x0) * (wy1 * wx0) + at(y0 + 1, x0 + 1) * (wy1 * wx1))


@register("_contrib_DeformableConvolution")
def deformable_convolution(data, offset, weight, *bias, kernel=(3, 3),
                           stride=(1, 1), dilate=(1, 1), pad=(0, 0),
                           num_filter=1, num_group=1, num_deformable_group=1,
                           no_bias=False, workspace=1024, layout=None):
    """Deformable convolution v1 (Dai et al. 2017); ``offset`` (N, 2 dg kh
    kw, Ho, Wo), (y, x) per kernel tap."""
    kh, kw = kernel
    sh, sw = stride if stride else (1, 1)
    dh, dw = dilate if dilate else (1, 1)
    ph, pw = pad if pad else (0, 0)
    n, cin, h, w = data.shape
    h0 = (h + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    w0 = (w + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    dg = num_deformable_group
    dev = data.device
    x32 = data.float()
    off = offset.float().reshape(n, dg, kh * kw, 2, h0, w0)
    base_y = (torch.arange(h0, device=dev) * sh - ph)[:, None]
    base_x = (torch.arange(w0, device=dev) * sw - pw)[None, :]
    ky = (torch.arange(kh, device=dev) * dh)[:, None].repeat(1, kw).reshape(-1)
    kx = (torch.arange(kw, device=dev) * dw)[None, :].repeat(kh, 1).reshape(-1)
    y_pos = base_y[None, None] + ky[None, :, None, None] + off[:, :, :, 0]
    x_pos = base_x[None, None] + kx[None, :, None, None] + off[:, :, :, 1]
    cpg = cin // dg
    cols = torch.stack([
        torch.cat([_bilinear_gather(x32[b, g * cpg:(g + 1) * cpg],
                                    y_pos[b, g], x_pos[b, g])
                   for g in range(dg)], 0)
        for b in range(n)])  # (n, cin, K, h0, w0)
    wmat = weight.float().reshape(num_filter, cin // num_group, kh * kw)
    if num_group == 1:
        out = torch.einsum("nckhw,fck->nfhw", cols, wmat)
    else:
        cg, fg = cin // num_group, num_filter // num_group
        cols_g = cols.reshape(n, num_group, cg, kh * kw, h0, w0)
        wmat_g = wmat.reshape(num_group, fg, cg, kh * kw)
        out = torch.einsum("ngckhw,gfck->ngfhw", cols_g, wmat_g).reshape(
            n, num_filter, h0, w0)
    out = out.to(data.dtype)
    if not no_bias and bias:
        out = out + bias[0].reshape(1, -1, 1, 1)
    return out
