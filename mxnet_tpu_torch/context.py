"""Devices.

The counterpart of ``mxnet_tpu/context.py``: ``cpu()`` and ``gpu(i)``
return ``torch.device``s.  ``default_device()`` is ``cuda:0`` and raises
when CUDA is unavailable: the port never drops to the CPU on its own —
a caller that wants the CPU says ``device="cpu"``.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "default_device", "resolve_device"]


def cpu() -> torch.device:
    return torch.device("cpu")


def gpu(device_id: int = 0) -> torch.device:
    return torch.device("cuda", device_id)


def default_device() -> torch.device:
    """``cuda:0``; raises when CUDA is unavailable."""
    if not torch.cuda.is_available():
        raise MXNetError(
            "no CUDA device is available; pass device=\"cpu\" to run on "
            "the CPU with the kernels' plain PyTorch versions")
    return gpu(0)


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, or :func:`default_device` when
    it is None."""
    return default_device() if device is None else torch.device(device)
