"""Misc utilities, the counterpart of the JAX package's ``util.py`` (reference:
python/mxnet/util.py).  The card queries read torch:
``get_gpu_count`` is ``torch.cuda.device_count()`` and ``get_gpu_memory``
is ``torch.cuda.mem_get_info``."""
from __future__ import annotations

import os

import torch

__all__ = ["is_np_array", "is_np_shape", "set_np", "reset_np", "use_np",
           "makedirs", "get_gpu_count", "get_gpu_memory"]


def is_np_array() -> bool:
    """The 2.x numpy-array semantics switch; always False in 1.x."""
    return False


def is_np_shape() -> bool:
    return False


def set_np(shape=True, array=True):
    raise NotImplementedError(
        "mx.np semantics are a 2.x feature; this framework tracks the 1.x API")


def reset_np():
    pass


def use_np(func):
    return func


def makedirs(d):
    os.makedirs(d, exist_ok=True)


def get_gpu_count() -> int:
    """The cards torch sees (0 without CUDA)."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def get_gpu_memory(gpu_dev_id: int = 0):
    """(free, total) bytes of card ``gpu_dev_id``, from the driver
    (``torch.cuda.mem_get_info``); raises without a card."""
    from .context import gpu

    return torch.cuda.mem_get_info(gpu(gpu_dev_id).device)
