"""Weight initializers, the counterpart of ``mxnet_tpu/initializer.py``:
``Xavier`` (uniform, over the average of the fans), ``Normal``,
``Constant``, ``Zero`` and ``One``,
and :func:`initialize`, which fills every parameter and buffer of a model
by its Gluon name as ``Initializer.init_array`` does: a name ending in
``gamma`` gets 1, ``beta`` 0, ``running_mean`` 0, ``running_var`` 1,
``bias`` 0, and anything else (a weight) the initializer's draw.

Draws come from an explicit CPU ``torch.Generator`` (the JAX package
draws from numpy's global state; seeds do not carry across the two), in
the parameter's Gluon shape, which is where Xavier takes its fans:
``fan_in = shape[1] * prod(shape[2:])``, ``fan_out = shape[0] *
prod(shape[2:])`` (``mxnet_tpu/initializer.py:159-176``).  An NHWC
convolution's Gluon weight is (O, kh, kw, I), so its fans differ from
the NCHW weight's (O, I, kh, kw): a quirk of the reference, carried
over.  The draw is then turned into the layer's own layout
(``convert.from_gluon_layout``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .base import MXNetError
from .convert import from_gluon_layout, gluon_name, gluon_shape

__all__ = ["Initializer", "Normal", "Constant", "Zero", "One", "Xavier",
           "initialize"]


class Initializer:
    """Fills an f32 CPU tensor of a Gluon shape, by the parameter's
    Gluon name."""

    def init_array(self, name: str, shape, generator=None) -> torch.Tensor:
        arr = torch.zeros(tuple(shape), dtype=torch.float32)
        if name.endswith("gamma") or "running_var" in name \
                or "moving_var" in name:
            arr.fill_(1.0)
        elif not (name.endswith(("beta", "bias")) or "running_mean" in name
                  or "moving_mean" in name):
            self._init_weight(name, arr, generator)
        return arr

    def _init_weight(self, name, arr, generator):
        raise NotImplementedError


class Normal(Initializer):
    def __init__(self, sigma: float = 0.01):
        self.sigma = float(sigma)

    def _init_weight(self, name, arr, generator):
        arr.normal_(0.0, self.sigma, generator=generator)


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = float(value)

    def _init_weight(self, name, arr, generator):
        arr.fill_(self.value)


class Zero(Constant):
    def __init__(self):
        super().__init__(0.0)


class One(Constant):
    def __init__(self):
        super().__init__(1.0)


class Xavier(Initializer):
    """U(-s, s) with s = sqrt(magnitude / ((fan_in + fan_out) / 2)): the
    JAX ``Xavier``'s defaults (``rnd_type="uniform"``,
    ``factor_type="avg"``)."""

    def __init__(self, magnitude: float = 3):
        self.magnitude = float(magnitude)

    def scale(self, shape) -> float:
        if len(shape) < 2:
            raise MXNetError(f"Xavier cannot initialize shape {tuple(shape)}")
        hw = math.prod(shape[2:])
        fan_in, fan_out = shape[1] * hw, shape[0] * hw
        return math.sqrt(self.magnitude / ((fan_in + fan_out) / 2.0))

    def _init_weight(self, name, arr, generator):
        s = self.scale(arr.shape)
        arr.uniform_(-s, s, generator=generator)


@torch.no_grad()
def initialize(model: torch.nn.Module, init: Initializer,
               generator: Optional[torch.Generator] = None) -> None:
    """Fill every floating parameter and buffer of ``model`` in place, in
    ``state_dict`` order, by its Gluon name (see the module's docstring);
    draws come from ``generator`` (a CPU one; torch's default generator
    when None)."""
    for key, t in model.state_dict(keep_vars=True).items():
        if not t.is_floating_point():
            continue
        arr = init.init_array(gluon_name(model, key),
                              gluon_shape(model, key, t), generator)
        t.copy_(from_gluon_layout(model, key, arr))
