"""Errors and environment helpers (the port's own copy of the parts of
``mxnet_tpu/base.py`` it needs), and :func:`tensor_from_numpy`."""
from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["MXNetError", "env_int", "env_str", "tensor_from_numpy"]


class MXNetError(RuntimeError):
    """Error raised by the framework."""


def env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def env_str(name: str, default: str) -> str:
    return os.environ.get(name, default)


def tensor_from_numpy(value) -> torch.Tensor:
    """A CPU tensor with ``value``'s numbers and dtype.  numpy has no
    bfloat16: an array whose ``dtype.name`` is ``bfloat16`` (``ml_dtypes``,
    what the JAX package's ``net.cast("bfloat16")`` leaves) comes in bit
    for bit through int16, without importing ``ml_dtypes``."""
    value = np.ascontiguousarray(value)
    if value.dtype.name == "bfloat16":
        return torch.from_numpy(value.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(value.copy())
