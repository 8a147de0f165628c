"""Elementwise ops, from ``mxnet_tpu/ops/elemwise.py``, under its names:
the unary math family, ``identity`` / ``_copy`` / ``stop_gradient`` /
``BlockGrad`` / ``make_loss``, ``clip``, ``add_n`` /
``ElementWiseSum``, ``Cast``, the broadcasting binaries (MXNet's
``elemwise_*`` are the same math with equal shapes), the comparisons
and logical ops (0/1 in the left input's dtype, not bool), the
``_*_scalar`` family behind the NDArray operator sugar (the reversed
``_r*_scalar`` too), ``smooth_l1``, ``digamma`` and the AMP overflow
checks ``all_finite`` / ``multi_all_finite``.

Scalars stay Python numbers, so torch's type promotion treats them as
the JAX package's weak-typed scalars do: a float array keeps its dtype,
an integer array against a fractional scalar becomes float32.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import register


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


_UNARY = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "hard_sigmoid": lambda x: torch.clamp(0.2 * x + 0.5, 0.0, 1.0),
    "softsign": lambda x: x / (1 + torch.abs(x)),
    "tanh": torch.tanh,
    "exp": torch.exp,
    "expm1": torch.expm1,
    "log": torch.log,
    "log2": torch.log2,
    "log10": torch.log10,
    "log1p": torch.log1p,
    "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt,
    "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "square": torch.square,
    "abs": torch.abs,
    "sign": torch.sign,
    "floor": torch.floor,
    "ceil": torch.ceil,
    "round": torch.round,
    "rint": torch.round,  # both round half to even
    "trunc": torch.trunc,
    "fix": torch.trunc,
    "negative": torch.neg,
    "reciprocal": lambda x: 1.0 / x,
    "erf": torch.erf,
    "erfinv": torch.erfinv,
    "gamma": lambda x: torch.exp(torch.lgamma(x)),
    "gammaln": torch.lgamma,
    "sin": torch.sin,
    "cos": torch.cos,
    "tan": torch.tan,
    "arcsin": torch.asin,
    "arccos": torch.acos,
    "arctan": torch.atan,
    "sinh": torch.sinh,
    "cosh": torch.cosh,
    "arcsinh": torch.asinh,
    "arccosh": torch.acosh,
    "arctanh": torch.atanh,
    "degrees": torch.rad2deg,
    "radians": torch.deg2rad,
    "logical_not": lambda x: (x == 0).to(x.dtype),
}

for _name, _f in _UNARY.items():
    register(_name)(lambda x, _f=_f: _f(x))

register("identity")(lambda x: x)
register("_copy")(lambda x: x.clone())
register("stop_gradient", differentiable=False)(lambda x: x.detach())
register("BlockGrad", differentiable=False)(lambda x: x.detach())
register("make_loss")(lambda x: x)


@register("clip")
def clip(x, a_min=None, a_max=None):
    return torch.clamp(x, a_min, a_max)


@register("add_n")
def add_n(*args, num_args=None):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


@register("ElementWiseSum")
def element_wise_sum(*args, num_args=None):
    return add_n(*args)


@register("Cast", differentiable=False)
def cast(x, dtype="float32"):
    from ..ndarray.ndarray import dtype_torch

    return x.to(dtype_torch(dtype))


# ---------------------------------------------------------------------------
# binary, broadcasting
# ---------------------------------------------------------------------------
_BINARY = {
    "add": torch.add,
    "sub": torch.sub,
    "mul": torch.mul,
    "div": torch.div,
    "mod": torch.remainder,  # the sign of the divisor, as jnp.mod
    "power": torch.pow,
    "maximum": torch.maximum,
    "minimum": torch.minimum,
    "hypot": torch.hypot,
}
for _name, _f in _BINARY.items():
    register("broadcast_" + _name)(lambda a, b, _f=_f: _f(a, b))

register("elemwise_add")(lambda a, b: torch.add(a, b))
register("elemwise_sub")(lambda a, b: torch.sub(a, b))
register("elemwise_mul")(lambda a, b: torch.mul(a, b))
register("elemwise_div")(lambda a, b: torch.div(a, b))
register("broadcast_plus")(lambda a, b: torch.add(a, b))
register("broadcast_minus")(lambda a, b: torch.sub(a, b))

_CMP = {
    "equal": torch.eq,
    "not_equal": torch.ne,
    "greater": torch.gt,
    "greater_equal": torch.ge,
    "lesser": torch.lt,
    "lesser_equal": torch.le,
    "logical_and": torch.logical_and,
    "logical_or": torch.logical_or,
    "logical_xor": torch.logical_xor,
}
for _name, _f in _CMP.items():
    # MXNet's comparisons return the input's dtype (1.0 / 0.0)
    register("broadcast_" + _name, differentiable=False)(
        lambda a, b, _f=_f: _f(a, b).to(a.dtype))


# ---------------------------------------------------------------------------
# scalar ops (the NDArray operator sugar)
# ---------------------------------------------------------------------------
def _scalar(x, s):
    """``s`` as a 0-d tensor of ``x``'s device in the dtype ``x op s``
    takes (for the torch functions without a Scalar overload); a fill,
    not a host-to-device copy, so it never syncs."""
    return torch.full((), s, dtype=torch.result_type(x, s), device=x.device)


register("_plus_scalar")(lambda x, scalar=0.0: x + scalar)
register("_minus_scalar")(lambda x, scalar=0.0: x - scalar)
register("_rminus_scalar")(lambda x, scalar=0.0: scalar - x)
register("_mul_scalar")(lambda x, scalar=1.0: x * scalar)
register("_div_scalar")(lambda x, scalar=1.0: x / scalar)
register("_rdiv_scalar")(lambda x, scalar=1.0: scalar / x)
register("_mod_scalar")(lambda x, scalar=1.0: torch.remainder(x, scalar))
register("_rmod_scalar")(
    lambda x, scalar=1.0: torch.remainder(_scalar(x, scalar), x))
register("_power_scalar")(lambda x, scalar=1.0: torch.pow(x, scalar))
register("_rpower_scalar")(lambda x, scalar=1.0: torch.pow(scalar, x))
register("_maximum_scalar")(
    lambda x, scalar=0.0: torch.maximum(x, _scalar(x, scalar)))
register("_minimum_scalar")(
    lambda x, scalar=0.0: torch.minimum(x, _scalar(x, scalar)))

for _name, _f in _CMP.items():
    register(f"_{_name}_scalar", differentiable=False)(
        lambda x, scalar=0.0, _f=_f: _f(x, _scalar(x, scalar)).to(x.dtype))


@register("smooth_l1")
def smooth_l1(x, scalar=1.0):
    """0.5 (s x)^2 where |x| < 1 / s^2, else |x| - 0.5 / s^2."""
    s2 = scalar * scalar
    return torch.where(torch.abs(x) < 1.0 / s2, 0.5 * s2 * torch.square(x),
                       torch.abs(x) - 0.5 / s2)


@register("digamma")
def digamma(x):
    return torch.digamma(x)


def _finite(arrays):
    ok = torch.ones((), dtype=torch.bool, device=arrays[0].device)
    for a in arrays:
        ok = ok & torch.isfinite(a.float()).all()
    return ok.to(torch.float32).reshape(1)


@register("all_finite", differentiable=False)
def all_finite(data, init_output=True):
    """1.0 when every element is finite, else 0.0, shape (1,).
    ``init_output=False`` (accumulate into ``out``) raises, as in the
    JAX package: check every array in one ``multi_all_finite``."""
    if not init_output:
        raise MXNetError("all_finite: init_output=False (accumulate into "
                         "out) is not supported; check all arrays in one "
                         "multi_all_finite call instead")
    return _finite([data])


@register("multi_all_finite", differentiable=False)
def multi_all_finite(*arrays, num_arrays=1, init_output=True):
    if not init_output:
        raise MXNetError("multi_all_finite: init_output=False is not "
                         "supported; pass all arrays in one call")
    return _finite(arrays)


@register("maximum")
def maximum(lhs, rhs):
    return torch.maximum(lhs, rhs)


@register("minimum")
def minimum(lhs, rhs):
    return torch.minimum(lhs, rhs)
