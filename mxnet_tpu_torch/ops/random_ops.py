"""Random sampling ops, from ``mxnet_tpu/ops/random_ops.py``, under its
names and attributes.

Departure, on purpose: each JAX op takes a key array as its first input,
split off the package's key chain.  The port's draw from a
``torch.Generator`` given as the ``generator`` attribute, by default the
generator of the output's device (``random.generator``, the one
``mx.random.seed`` seeds), so they have one input fewer: the
zero-input ones create on the device of the call's ``ctx``.  Seeds do
not carry across the packages (see ``random``): a seed gives the same
draws twice on one device, and the distributions (support, moments)
agree with the JAX ops'.
"""
from __future__ import annotations

import torch

from .registry import register


def _dt(dtype):
    from ..ndarray.ndarray import dtype_torch

    return dtype_torch(dtype)


def _gen(generator, device):
    from .. import random as _rng

    return generator if generator is not None else _rng.generator(device)


def _shape(shape):
    if shape is None:
        return ()
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _empty(shape, dtype):
    """A tensor on the device the call runs under (``torch.device``)."""
    return torch.empty(_shape(shape), dtype=_dt(dtype))


def _gamma(alpha, shape, g, device):
    conc = torch.full(_shape(shape), float(alpha), dtype=torch.float32,
                      device=device)
    return torch._standard_gamma(conc, generator=g)


@register("_random_uniform", differentiable=False)
def _random_uniform(low=0.0, high=1.0, shape=(), dtype="float32",
                    generator=None):
    out = _empty(shape, dtype)
    return out.uniform_(low, high, generator=_gen(generator, out.device))


@register("_random_normal", differentiable=False)
def _random_normal(loc=0.0, scale=1.0, shape=(), dtype="float32",
                   generator=None):
    out = _empty(shape, dtype)
    return out.normal_(loc, scale, generator=_gen(generator, out.device))


@register("_random_gamma", differentiable=False)
def _random_gamma(alpha=1.0, beta=1.0, shape=(), dtype="float32",
                  generator=None):
    out = _empty(shape, dtype)
    g = _gen(generator, out.device)
    return (beta * _gamma(alpha, shape, g, out.device)).to(out.dtype)


@register("_random_exponential", differentiable=False)
def _random_exponential(lam=1.0, shape=(), dtype="float32", generator=None):
    out = _empty(shape, dtype)
    return out.exponential_(1.0, generator=_gen(generator, out.device)) / lam


@register("_random_poisson", differentiable=False)
def _random_poisson(lam=1.0, shape=(), dtype="float32", generator=None):
    out = _empty(shape, dtype)
    rate = torch.full(out.shape, float(lam), device=out.device)
    return torch.poisson(rate, generator=_gen(generator, out.device)).to(
        out.dtype)


@register("_random_randint", differentiable=False)
def _random_randint(low=0, high=1, shape=(), dtype="int32", generator=None):
    out = _empty(shape, dtype)
    return torch.randint(int(low), int(high), out.shape, dtype=out.dtype,
                         device=out.device,
                         generator=_gen(generator, out.device))


def _gamma_poisson(r, p, shape, dtype, generator):
    """Poisson(Gamma(r) (1 - p) / p): the negative binomial's mixture."""
    out = _empty(shape, dtype)
    g = _gen(generator, out.device)
    lam = _gamma(r, shape, g, out.device) * (1 - p) / p
    return torch.poisson(lam, generator=g).to(out.dtype)


@register("_random_negative_binomial", differentiable=False)
def _random_negative_binomial(k=1, p=1.0, shape=(), dtype="float32",
                              generator=None):
    return _gamma_poisson(k, p, shape, dtype, generator)


@register("_random_generalized_negative_binomial", differentiable=False)
def _random_generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(),
                                          dtype="float32", generator=None):
    r = 1.0 / alpha
    return _gamma_poisson(r, r / (r + mu), shape, dtype, generator)


@register("_sample_multinomial", differentiable=False)
def _sample_multinomial(data, shape=(), get_prob=False, dtype="int32",
                        generator=None):
    """``shape[0]`` draws (with replacement) from each row of
    probabilities ``data``: (n,) for a vector, (B, n) for (B, K); with
    ``get_prob`` also each draw's log-probability."""
    n = int(shape[0]) if shape else 1
    probs = data.float().clamp_min(1e-30)
    out = torch.multinomial(probs, n, replacement=True,
                            generator=_gen(generator, data.device))
    if get_prob:
        logp = torch.log_softmax(torch.log(probs), dim=-1)
        return out.to(_dt(dtype)), torch.gather(logp, -1, out)
    return out.to(_dt(dtype))


@register("_shuffle", differentiable=False)
def _shuffle(data, generator=None):
    perm = torch.randperm(data.shape[0], device=data.device,
                          generator=_gen(generator, data.device))
    return data[perm]


def _sample(low_or_mu, shape, dtype, generator):
    s = _shape(shape)
    out = torch.empty(tuple(low_or_mu.shape) + s, dtype=_dt(dtype),
                      device=low_or_mu.device)
    return out, _gen(generator, out.device), (1,) * len(s)


@register("sample_uniform", differentiable=False)
def sample_uniform(low, high, shape=(), dtype="float32", generator=None):
    """Per-element bounds: out[i, ...] ~ U(low[i], high[i])."""
    out, g, tail = _sample(low, shape, dtype, generator)
    u = out.uniform_(0.0, 1.0, generator=g)
    lo = low.reshape(tuple(low.shape) + tail)
    return lo + u * (high.reshape(tuple(high.shape) + tail) - lo)


@register("sample_normal", differentiable=False)
def sample_normal(mu, sigma, shape=(), dtype="float32", generator=None):
    out, g, tail = _sample(mu, shape, dtype, generator)
    z = out.normal_(0.0, 1.0, generator=g)
    return (mu.reshape(tuple(mu.shape) + tail)
            + z * sigma.reshape(tuple(sigma.shape) + tail))
