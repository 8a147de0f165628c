"""Elementwise ops from ``mxnet_tpu/ops/elemwise.py``: the binary ones
the imperative path's heads and ``NDArray``'s ``+``/``*`` use
(broadcasting, and MXNet's ``elemwise_*``, the same math with equal
shapes), and ``smooth_l1``, which the detection losses take."""
from __future__ import annotations

import torch

from .registry import register

register("broadcast_add")(lambda a, b: torch.add(a, b))
register("broadcast_mul")(lambda a, b: torch.mul(a, b))
register("elemwise_add")(lambda a, b: torch.add(a, b))
register("elemwise_mul")(lambda a, b: torch.mul(a, b))


@register("smooth_l1")
def smooth_l1(x, scalar=1.0):
    """0.5 (s x)^2 where |x| < 1 / s^2, else |x| - 0.5 / s^2."""
    s2 = scalar * scalar
    return torch.where(torch.abs(x) < 1.0 / s2, 0.5 * s2 * torch.square(x),
                       torch.abs(x) - 0.5 / s2)
