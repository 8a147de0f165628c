"""Devices.

The counterpart of ``mxnet_tpu/context.py``: ``cpu()`` and ``gpu(i)``
return ``torch.device``s.  ``default_device()`` is ``cuda:0`` and raises
when CUDA is unavailable: the port never drops to the CPU on its own —
a caller that wants the CPU says ``device="cpu"``.
"""
from __future__ import annotations

import torch

from .base import MXNetError

__all__ = ["cpu", "gpu", "default_device", "resolve_device", "to_device",
           "normalize_memory_stats"]


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


def to_device(arr, device: torch.device) -> torch.Tensor:
    """One copy of host (numpy) array ``arr`` onto ``device``: through
    pinned memory and without blocking on a CUDA device."""
    import numpy as np

    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def normalize_memory_stats(raw) -> dict:
    """The port's copy of ``mxnet_tpu.context.normalize_memory_stats``:
    an allocator-stats dict as ``{"bytes_in_use", "peak_bytes_in_use",
    "bytes_limit", "available"}``.  Anything without ``bytes_in_use``
    (the CPU has no allocator stats) is ``available=False`` with zeroed
    counters."""
    if not isinstance(raw, dict) or "bytes_in_use" not in raw:
        return {"bytes_in_use": 0, "peak_bytes_in_use": 0,
                "bytes_limit": 0, "available": False}

    def _int(key, default=0):
        try:
            return int(raw.get(key, default))
        except (TypeError, ValueError):
            return default

    in_use = _int("bytes_in_use")
    return {"bytes_in_use": in_use,
            "peak_bytes_in_use": _int("peak_bytes_in_use", in_use),
            "bytes_limit": _int("bytes_limit"),
            "available": True}

