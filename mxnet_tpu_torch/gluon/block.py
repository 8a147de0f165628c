"""``cast``, the counterpart of ``mxnet_tpu/gluon/block.py``'s
``Block.cast``: the port's blocks are ``torch.nn`` modules, and the rest
of Gluon's ``Block`` is torch's."""
from __future__ import annotations

import torch

__all__ = ["cast"]


@torch.no_grad()
def cast(model: torch.nn.Module, dtype) -> torch.nn.Module:
    """Cast every floating parameter and buffer of ``model`` to ``dtype``
    (a torch dtype or its name, ``"bfloat16"``) in place, BatchNorm's
    running stats too, as the JAX package casts every parameter (aux
    states included); memory formats are kept.  Returns ``model``."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    for t in list(model.parameters()) + list(model.buffers()):
        if t.is_floating_point():
            t.data = t.data.to(dtype)
    return model
