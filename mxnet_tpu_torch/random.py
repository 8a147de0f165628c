"""``mx.random.seed``: the port's random state.

Counterpart of ``mxnet_tpu/random.py``.  MXNet keeps one generator per
device; so does torch, and the port uses torch's: ``torch.default_generator``
for the CPU and ``torch.cuda.default_generators[i]`` for card ``i``
(:func:`generator`).  ``seed(s, ctx="all")`` seeds every one of them,
``seed(s, ctx=device)`` the one of that device.  The initializers draw on
the CPU from the CPU generator (``initializer.Initializer.init_array``),
and ``gluon.nn.Dropout`` draws its mask from the generator of its input's
device, as ``torch.nn.functional.dropout`` does, so that
``torch.utils.checkpoint`` replays it.

Seeds do not carry across the two packages: the JAX package splits a key
chain and draws its initial weights from numpy's global state, so the same
seed gives other numbers there.
"""
from __future__ import annotations

import time
from typing import Optional

import torch

__all__ = ["seed", "generator"]


def generator(device="cpu") -> torch.Generator:
    """The generator of ``device`` (a ``Context``, a ``torch.device`` or
    its name)."""
    from .context import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        return torch.cuda.default_generators[
            dev.index if dev.index is not None else torch.cuda.current_device()]
    return torch.default_generator


def seed(seed_state: Optional[int] = None, ctx="all") -> None:
    """Seed the generator of ``ctx``, or of every device with ``"all"``;
    a seed of None takes the clock's."""
    if seed_state is None:
        seed_state = int(time.time() * 1e6) & 0x7FFFFFFF
    s = int(seed_state)
    if ctx == "all":
        torch.manual_seed(s)  # the CPU's and every card's
        return
    generator(ctx).manual_seed(s)
