"""The ``nd.random`` namespace, from ``mxnet_tpu/ndarray/random.py``:
``uniform``, ``normal``, ``randn``, ``randint``, ``gamma``,
``exponential``, ``poisson``, ``negative_binomial``,
``generalized_negative_binomial``, ``multinomial`` and ``shuffle``, each
over the op of ``ops/random_ops.py``.  The draws come from the generator
of the array's device (``mx.random.seed`` seeds it), where the JAX
functions take the next key of the package's chain."""
from __future__ import annotations

from ..ops import registry as _reg

__all__ = ["uniform", "normal", "randn", "randint", "gamma", "exponential",
           "poisson", "negative_binomial", "generalized_negative_binomial",
           "multinomial", "shuffle"]


def _dtname(dtype, default="float32"):
    if dtype is None:
        return default
    from .ndarray import dtype_torch

    return str(dtype_torch(dtype)).replace("torch.", "")


def _shape(shape):
    if shape is None:
        return ()
    return (shape,) if isinstance(shape, int) else tuple(shape)


def _arrays(a, b):
    """Two NDArrays on one device from NDArray-or-number bounds."""
    from .ndarray import NDArray, array

    a = a if isinstance(a, NDArray) else array(a, ctx=b.context)
    b = b if isinstance(b, NDArray) else array(b, ctx=a.context)
    return a, b


def uniform(low=0.0, high=1.0, shape=(), dtype=None, ctx=None, out=None,
            **kw):
    from .ndarray import NDArray

    if isinstance(low, NDArray) or isinstance(high, NDArray):
        low, high = _arrays(low, high)
        return _reg.invoke_by_name("sample_uniform", [low, high], out=out,
                                   shape=_shape(shape), dtype=_dtname(dtype))
    return _reg.invoke_by_name("_random_uniform", [], out=out, ctx=ctx,
                               low=low, high=high, shape=_shape(shape),
                               dtype=_dtname(dtype))


def normal(loc=0.0, scale=1.0, shape=(), dtype=None, ctx=None, out=None,
           **kw):
    from .ndarray import NDArray

    if isinstance(loc, NDArray) or isinstance(scale, NDArray):
        loc, scale = _arrays(loc, scale)
        return _reg.invoke_by_name("sample_normal", [loc, scale], out=out,
                                   shape=_shape(shape), dtype=_dtname(dtype))
    return _reg.invoke_by_name("_random_normal", [], out=out, ctx=ctx,
                               loc=loc, scale=scale, shape=_shape(shape),
                               dtype=_dtname(dtype))


def randn(*shape, dtype=None, ctx=None, loc=0.0, scale=1.0, **kw):
    return normal(loc=loc, scale=scale, shape=shape or (1,), dtype=dtype,
                  ctx=ctx)


def randint(low, high=None, shape=(), dtype=None, ctx=None, out=None, **kw):
    if high is None:
        low, high = 0, low
    return _reg.invoke_by_name("_random_randint", [], out=out, ctx=ctx,
                               low=int(low), high=int(high),
                               shape=_shape(shape),
                               dtype=_dtname(dtype, "int32"))


def gamma(alpha=1.0, beta=1.0, shape=(), dtype=None, ctx=None, out=None,
          **kw):
    return _reg.invoke_by_name("_random_gamma", [], out=out, ctx=ctx,
                               alpha=alpha, beta=beta, shape=_shape(shape),
                               dtype=_dtname(dtype))


def exponential(lam=1.0, shape=(), dtype=None, ctx=None, out=None, **kw):
    return _reg.invoke_by_name("_random_exponential", [], out=out, ctx=ctx,
                               lam=lam, shape=_shape(shape),
                               dtype=_dtname(dtype))


def poisson(lam=1.0, shape=(), dtype=None, ctx=None, out=None, **kw):
    return _reg.invoke_by_name("_random_poisson", [], out=out, ctx=ctx,
                               lam=lam, shape=_shape(shape),
                               dtype=_dtname(dtype))


def negative_binomial(k=1, p=1.0, shape=(), dtype=None, ctx=None, out=None,
                      **kw):
    return _reg.invoke_by_name("_random_negative_binomial", [], out=out,
                               ctx=ctx, k=k, p=p, shape=_shape(shape),
                               dtype=_dtname(dtype))


def generalized_negative_binomial(mu=1.0, alpha=1.0, shape=(), dtype=None,
                                  ctx=None, out=None, **kw):
    return _reg.invoke_by_name("_random_generalized_negative_binomial", [],
                               out=out, ctx=ctx, mu=mu, alpha=alpha,
                               shape=_shape(shape), dtype=_dtname(dtype))


def multinomial(data, shape=(), get_prob=False, dtype="int32", **kw):
    return _reg.invoke_by_name("_sample_multinomial", [data],
                               shape=_shape(shape) or (1,), get_prob=get_prob,
                               dtype=_dtname(dtype, "int32"))


def shuffle(data, **kw):
    return _reg.invoke_by_name("_shuffle", [data])
