"""``reshape``, from ``mxnet_tpu/ops/matrix.py``, with MXNet's special
codes 0 (keep), -1 (infer), -2 (copy the rest), -3 (merge two) and -4
(split one in two), and ``reverse``."""
from __future__ import annotations

import math

import torch

from .registry import register


@register("reshape")
def reshape(x, shape=None, reverse=False):
    if shape is None:
        return x
    src = list(x.shape)
    shape = list(shape)
    if reverse:
        src, shape = src[::-1], shape[::-1]
    out, i, j = [], 0, 0
    while j < len(shape):
        s = shape[j]
        if s == 0:
            out.append(src[i])
            i += 1
        elif s == -1:
            out.append(-1)
            i += 1
        elif s == -2:
            out.extend(src[i:])
            i = len(src)
        elif s == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif s == -4:
            a, b = shape[j + 1], shape[j + 2]
            if a == -1:
                a = src[i] // b
            if b == -1:
                b = src[i] // a
            out.extend([a, b])
            i += 1
            j += 2
        else:
            out.append(s)
            if i < len(src):
                i += 1
        j += 1
    if reverse:
        out = out[::-1]
    if out.count(-1) == 1:
        known = math.prod(d for d in out if d != -1) or 1
        out[out.index(-1)] = x.numel() // known
    return torch.reshape(x, tuple(out))
