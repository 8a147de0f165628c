"""Weight initializers, the counterpart of ``mxnet_tpu/initializer.py``:
the registry (``register`` / ``create``, by lower-case class name, with
``"zeros"`` and ``"ones"``), ``Uniform``, ``Normal``, ``Constant``,
``Zero``, ``One``, ``Xavier``, ``MSRAPrelu``, ``Orthogonal``, ``Bilinear``,
``LSTMBias`` and ``Mixed``; and :func:`initialize`, which fills every
parameter and buffer of a model by its Gluon name.

``Initializer.init_array(name, shape, generator)`` dispatches on the name
as the JAX ``Initializer.init_array`` does: a name ending in ``gamma``
gets ``_init_gamma`` (1), ``beta`` ``_init_beta`` (0), one holding
``running_mean`` / ``moving_mean`` 0, ``running_var`` / ``moving_var`` 1,
``bias`` ``_init_bias`` (0), and anything else (a weight) the
initializer's ``_init_weight`` draw.  Gluon's ``Parameter.initialize``
calls it (``gluon.parameter``).

Draws come from a CPU ``torch.Generator`` (the CPU's default generator,
which ``random.seed`` seeds, when None; the JAX package draws from numpy's
global state, so seeds do not carry across the two), in the parameter's
Gluon shape, which is where Xavier takes its fans: ``fan_in = shape[1] *
prod(shape[2:])``, ``fan_out = shape[0] * prod(shape[2:])``
(``mxnet_tpu/initializer.py:159-176``).  An NHWC convolution's Gluon
weight is (O, kh, kw, I), so its fans differ from the NCHW weight's
(O, I, kh, kw): a quirk of the reference, carried over.  The draw is then
turned into the layer's own layout (``convert.from_gluon_layout``).
"""
from __future__ import annotations

import json
import math
import re
from typing import Dict, Optional

import torch

from .base import MXNetError

__all__ = ["Initializer", "Uniform", "Normal", "Constant", "Zero", "One",
           "Xavier", "MSRAPrelu", "Orthogonal", "Bilinear", "LSTMBias",
           "Mixed", "register", "create", "initialize"]

_REGISTRY: Dict[str, type] = {}


def register(cls):
    _REGISTRY[cls.__name__.lower()] = cls
    return cls


def create(init, **kwargs) -> "Initializer":
    """An initializer from an instance, a registered name, the JSON of
    ``'["name", {kwargs}]'``, or None (``Uniform(0.07)``, Gluon's
    default)."""
    if init is None:
        return Uniform(0.07)
    if isinstance(init, (Initializer, Mixed)):
        return init
    if isinstance(init, str):
        if init.startswith("["):
            name, kw = json.loads(init)
            return create(name, **kw)
        try:
            return _REGISTRY[init.lower()](**kwargs)
        except KeyError:
            raise MXNetError(f"unknown initializer {init!r}") from None
    raise MXNetError(f"cannot create an initializer from {init!r}")


class Initializer:
    """Fills an f32 CPU tensor of a Gluon shape, by the parameter's
    Gluon name."""

    def init_array(self, name: str, shape, generator=None) -> torch.Tensor:
        arr = torch.zeros(tuple(shape), dtype=torch.float32)
        name = name or ""
        if name.endswith("gamma"):
            self._init_gamma(name, arr)
        elif name.endswith("beta"):
            self._init_beta(name, arr)
        elif "running_mean" in name or "moving_mean" in name:
            arr.zero_()
        elif "running_var" in name or "moving_var" in name:
            arr.fill_(1.0)
        elif name.endswith("bias"):
            self._init_bias(name, arr)
        else:
            self._init_weight(name, arr, generator)
        return arr

    def dumps(self) -> str:
        """'["name", {kwargs}]': the ``__init__`` attribute a symbol
        variable carries in a graph file (the JAX ``Initializer.dumps``)."""
        return json.dumps([type(self).__name__.lower(), dict(vars(self))])

    def _init_gamma(self, name, arr):
        arr.fill_(1.0)

    def _init_beta(self, name, arr):
        arr.zero_()

    def _init_bias(self, name, arr):
        arr.zero_()

    def _init_weight(self, name, arr, generator):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"


@register
class Uniform(Initializer):
    def __init__(self, scale: float = 0.07):
        self.scale = float(scale)

    def _init_weight(self, name, arr, generator):
        arr.uniform_(-self.scale, self.scale, generator=generator)


@register
class Normal(Initializer):
    def __init__(self, sigma: float = 0.01):
        self.sigma = float(sigma)

    def _init_weight(self, name, arr, generator):
        arr.normal_(0.0, self.sigma, generator=generator)


@register
class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def _init_weight(self, name, arr, generator):
        arr.copy_(torch.as_tensor(self.value, dtype=arr.dtype)
                  .broadcast_to(arr.shape))


@register
class Zero(Constant):
    def __init__(self):
        super().__init__(0.0)


@register
class One(Constant):
    def __init__(self):
        super().__init__(1.0)


@register
class Xavier(Initializer):
    """s = sqrt(magnitude / factor) over the fans of the Gluon shape;
    ``rnd_type`` "uniform" draws U(-s, s), "gaussian" N(0, s);
    ``factor_type`` "avg" (the mean of the fans), "in" or "out"."""

    def __init__(self, rnd_type: str = "uniform", factor_type: str = "avg",
                 magnitude: float = 3):
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def scale(self, shape) -> float:
        if len(shape) < 2:
            raise MXNetError(f"Xavier cannot initialize shape {tuple(shape)}")
        hw = math.prod(shape[2:])
        fan_in, fan_out = shape[1] * hw, shape[0] * hw
        factor = {"avg": (fan_in + fan_out) / 2.0, "in": fan_in,
                  "out": fan_out}.get(self.factor_type)
        if factor is None:
            raise MXNetError(f"incorrect factor type {self.factor_type!r}")
        return math.sqrt(self.magnitude / factor)

    def _init_weight(self, name, arr, generator):
        s = self.scale(arr.shape)
        if self.rnd_type == "uniform":
            arr.uniform_(-s, s, generator=generator)
        elif self.rnd_type == "gaussian":
            arr.normal_(0.0, s, generator=generator)
        else:
            raise MXNetError(f"unknown random type {self.rnd_type!r}")


@register
class MSRAPrelu(Xavier):
    def __init__(self, factor_type: str = "avg", slope: float = 0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))


@register
class Orthogonal(Initializer):
    """``scale`` times the orthonormal factor of the SVD of a uniform
    (or, with ``rand_type="normal"``, Gaussian) (nout, nin) draw."""

    def __init__(self, scale: float = 1.414, rand_type: str = "uniform"):
        self.scale = float(scale)
        self.rand_type = rand_type

    def _init_weight(self, name, arr, generator):
        nout, nin = arr.shape[0], math.prod(arr.shape[1:])
        tmp = torch.empty(nout, nin, dtype=torch.float64)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=generator)
        else:
            tmp.normal_(0.0, 1.0, generator=generator)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        arr.copy_((self.scale * q).reshape(arr.shape))


@register
class Bilinear(Initializer):
    """The bilinear upsampling kernel over the last two axes."""

    def _init_weight(self, name, arr, generator):
        shape = arr.shape
        f = math.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        i = torch.arange(arr.numel(), dtype=torch.float64)
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        w = (1 - (x / f - c).abs()) * (1 - (y / f - c).abs())
        arr.copy_(w.reshape(shape))


@register
class LSTMBias(Initializer):
    """Zeros, with ``forget_bias`` on the forget gate's quarter."""

    def __init__(self, forget_bias: float = 1.0):
        self.forget_bias = float(forget_bias)

    def _init_weight(self, name, arr, generator):
        arr.zero_()
        n = arr.shape[0] // 4
        arr[n:2 * n] = self.forget_bias

    def _init_bias(self, name, arr):
        self._init_weight(name, arr, None)


_REGISTRY["zeros"] = Zero
_REGISTRY["ones"] = One


class Mixed:
    """The initializer of the first pattern (``re.match``) the parameter's
    name matches."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise MXNetError("patterns and initializers must match")
        self.map = list(zip([re.compile(p) for p in patterns],
                            initializers))

    def init_array(self, name, shape, generator=None):
        for pat, init in self.map:
            if pat.match(name):
                return init.init_array(name, shape, generator)
        raise MXNetError(f"parameter {name} did not match any pattern")


@torch.no_grad()
def initialize(model: torch.nn.Module, init: Initializer,
               generator: Optional[torch.Generator] = None) -> None:
    """Fill every floating parameter and buffer of ``model`` in place, in
    ``state_dict`` order, by its Gluon name (see the module's docstring);
    draws come from ``generator`` (a CPU one; torch's default generator
    when None)."""
    from .convert import from_gluon_layout, gluon_name, gluon_shape

    for key, t in model.state_dict(keep_vars=True).items():
        if not t.is_floating_point():
            continue
        arr = init.init_array(gluon_name(model, key),
                              gluon_shape(model, key, t), generator)
        t.copy_(from_gluon_layout(model, key, arr))
