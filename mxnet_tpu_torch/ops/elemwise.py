"""Binary elementwise ops the imperative path's heads and ``NDArray``'s
``+``/``*`` use, from ``mxnet_tpu/ops/elemwise.py``: broadcasting, and
MXNet's ``elemwise_*`` (the same math with equal shapes)."""
from __future__ import annotations

import torch

from .registry import register

register("broadcast_add")(lambda a, b: torch.add(a, b))
register("broadcast_mul")(lambda a, b: torch.mul(a, b))
register("elemwise_add")(lambda a, b: torch.add(a, b))
register("elemwise_mul")(lambda a, b: torch.mul(a, b))
