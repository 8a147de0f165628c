"""Spatial warping and sampling, from ``mxnet_tpu/ops/warp_ops.py``:
``GridGenerator``, ``BilinearSampler``, ``SpatialTransformer`` and the
FlowNet ``Correlation``.

``BilinearSampler`` is ``torch.nn.functional.grid_sample`` (bilinear,
zero padding, ``align_corners=True``: x = (g + 1) (W - 1) / 2, the JAX
op's mapping); the JAX op gathers the four neighbours itself, the same
arithmetic.  ``Correlation`` follows the JAX op's loop over the
displacement grid.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .registry import register


@register("BilinearSampler")
def bilinear_sampler(data, grid, cudnn_off=False):
    """data (B, C, H, W) sampled at ``grid`` (B, 2, Ho, Wo) in [-1, 1]
    (x first), zero outside."""
    g = grid.float().permute(0, 2, 3, 1)
    out = F.grid_sample(data.float(), g, mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out.to(data.dtype)


@register("GridGenerator")
def grid_generator(data, transform_type="affine", target_shape=(0, 0)):
    """affine: (B, 6) -> a normalized sampling grid (B, 2, H, W); warp:
    a pixel flow (B, 2, H, W) -> the normalized grid it points at."""
    dev = data.device
    if transform_type == "affine":
        H, W = int(target_shape[0]), int(target_shape[1])
        B = data.shape[0]
        theta = data.reshape(B, 2, 3).float()
        ys, xs = torch.meshgrid(torch.linspace(-1, 1, H, device=dev),
                                torch.linspace(-1, 1, W, device=dev),
                                indexing="ij")
        coords = torch.stack([xs, ys, torch.ones_like(xs)], 0).reshape(
            3, H * W)
        out = torch.einsum("bij,jk->bik", theta, coords)
        return out.reshape(B, 2, H, W).to(data.dtype)
    B, _, H, W = data.shape
    flow = data.float()
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    x = xs[None] + flow[:, 0]
    y = ys[None] + flow[:, 1]
    gx = 2 * x / max(W - 1, 1) - 1
    gy = 2 * y / max(H - 1, 1) - 1
    return torch.stack([gx, gy], 1).to(data.dtype)


@register("SpatialTransformer")
def spatial_transformer(data, loc, target_shape=(0, 0),
                        transform_type="affine", sampler_type="bilinear",
                        cudnn_off=False):
    """The affine grid of ``loc`` (B, 6), then bilinear sampling."""
    grid = grid_generator(loc, transform_type="affine",
                          target_shape=target_shape)
    return bilinear_sampler(data, grid)


@register("Correlation")
def correlation(data1, data2, kernel_size=1, max_displacement=1, stride1=1,
                stride2=1, pad_size=0, is_multiply=True):
    """(B, D*D, Ho, Wo), D = 2 floor(max_displacement / stride2) + 1: the
    channel mean of data1 times (or minus, in absolute value) data2
    shifted by each displacement, averaged over the kernel window."""
    k = int(kernel_size)
    pad = int(pad_size)
    rad = k // 2
    d_unit = int(max_displacement) // int(stride2)
    widths = (pad, pad, pad, pad)
    p1 = F.pad(data1.float(), widths)
    p2 = F.pad(data2.float(), widths)
    Hp, Wp = p1.shape[2], p1.shape[3]
    border = rad + int(max_displacement)
    Ho = (Hp - 2 * border + int(stride1) - 1) // int(stride1)
    Wo = (Wp - 2 * border + int(stride1) - 1) // int(stride1)
    dev = data1.device
    ys = border + torch.arange(Ho, device=dev) * int(stride1)
    xs = border + torch.arange(Wo, device=dev) * int(stride1)
    rows_all = torch.arange(Hp, device=dev)
    cols_all = torch.arange(Wp, device=dev)

    def window_mean(pm):
        acc = 0.0
        for dy in range(-rad, rad + 1):
            for dx in range(-rad, rad + 1):
                rows = (ys + dy).clamp(0, Hp - 1)
                cols = (xs + dx).clamp(0, Wp - 1)
                acc = acc + pm[:, rows][:, :, cols]
        return acc / (k * k)

    outs = []
    for dy in range(-d_unit, d_unit + 1):
        for dx in range(-d_unit, d_unit + 1):
            oy, ox = dy * int(stride2), dx * int(stride2)
            shifted = torch.roll(p2, (-oy, -ox), dims=(2, 3))
            if is_multiply:
                pm = (p1 * shifted).mean(1)
            else:
                pm = (p1 - shifted).abs().mean(1)
            r = rows_all + oy
            c = cols_all + ox
            valid = (((r >= 0) & (r < Hp))[:, None]
                     & ((c >= 0) & (c < Wp))[None, :])
            pm = torch.where(valid[None], pm, torch.zeros_like(pm))
            outs.append(window_mean(pm))
    return torch.stack(outs, 1).to(data1.dtype)
