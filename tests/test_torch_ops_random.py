"""The port's random ops (``mxnet_tpu_torch/ops/random_ops.py``, the
``Dropout`` op and ``nd.random``) against the JAX package's on the CPU.

Seeds do not carry across the packages (the JAX ops draw from a key, the
port's from a ``torch.Generator``), so parity is by distribution: each
op draws 20,000 samples in each package, from a seed of each package's
own; both must have the op's shape and dtype (up to the JAX package's
int64 -> int32), its support, and a mean and variance within five
standard errors (estimated from the sample) of the distribution's.  A
seed must give the same draws twice in the port, and another seed other
draws.
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.ops import registry as jreg
from mxnet_tpu_torch.ops import registry as treg

N = 20000

# op -> (attrs, mean, variance, support check)
SCALAR = {
    "_random_uniform": (dict(low=-1.0, high=3.0), 1.0, 16 / 12,
                        lambda x: (x >= -1).all() and (x < 3).all()),
    "_random_normal": (dict(loc=1.0, scale=2.0), 1.0, 4.0, None),
    "_random_gamma": (dict(alpha=2.5, beta=0.5), 1.25, 0.625,
                      lambda x: (x > 0).all()),
    "_random_exponential": (dict(lam=2.0), 0.5, 0.25,
                            lambda x: (x >= 0).all()),
    "_random_poisson": (dict(lam=3.0), 3.0, 3.0,
                        lambda x: (x >= 0).all() and (x == np.round(x)).all()),
    "_random_randint": (dict(low=-2, high=5), 1.0, 4.0,
                        lambda x: (x >= -2).all() and (x < 5).all()),
    "_random_negative_binomial": (
        dict(k=3, p=0.4), 4.5, 11.25,
        lambda x: (x >= 0).all() and (x == np.round(x)).all()),
    "_random_generalized_negative_binomial": (
        dict(mu=2.0, alpha=0.5), 2.0, 4.0,
        lambda x: (x >= 0).all() and (x == np.round(x)).all()),
}
OPS = tuple(SCALAR) + ("_sample_multinomial", "_shuffle", "sample_uniform",
                       "sample_normal")


def _jax(op, *inputs, seed=0, **attrs):
    out = jreg.get_op(op).fn(jax.random.PRNGKey(seed), *inputs, **attrs)
    return [np.asarray(o) for o in (out if isinstance(out, tuple)
                                    else (out,))]


def _port(op, *inputs, seed=0, **attrs):
    g = torch.Generator().manual_seed(seed)
    out = treg.get_op(op).fn(*[torch.from_numpy(np.asarray(a))
                               for a in inputs], generator=g, **attrs)
    return [o.numpy() for o in (out if isinstance(out, tuple) else (out,))]


def _moments_ok(x, mean, var, axis=None):
    x = np.asarray(x, np.float64)
    n = x.shape[0] if axis == 0 else x.size
    m = x.mean(axis=axis)
    v = x.var(axis=axis)
    m4 = ((x - x.mean(axis=axis, keepdims=axis is not None)) ** 4).mean(
        axis=axis)
    se_m = np.sqrt(v / n)
    se_v = np.sqrt(np.maximum(m4 - v ** 2, 1e-12) / n)
    return (np.abs(m - mean) < 5 * se_m).all() and \
        (np.abs(v - var) < 5 * se_v).all()


def _dtype_as_jax(a):
    return np.dtype(jax.dtypes.canonicalize_dtype(a.dtype))


DRAWS = [(op, "int32" if op == "_random_randint" else "float32")
         for op in SCALAR] + [("_random_poisson", "int32")]


@pytest.mark.parametrize("op,dtype", DRAWS, ids=[f"{o}-{d}" for o, d in DRAWS])
def test_scalar_distribution(op, dtype):
    attrs, mean, var, support = SCALAR[op]
    dt = {"dtype": dtype}
    j = _jax(op, shape=(N,), seed=3, **attrs, **dt)[0]
    t = _port(op, shape=(N,), seed=3, **attrs, **dt)[0]
    assert t.shape == j.shape == (N,)
    assert _dtype_as_jax(t) == j.dtype
    for x in (j, t):
        assert support is None or support(x)
        assert _moments_ok(x, mean, var)
    again = _port(op, shape=(N,), seed=3, **attrs, **dt)[0]
    np.testing.assert_array_equal(t, again)
    assert (_port(op, shape=(N,), seed=4, **attrs, **dt)[0] != t).any()


def test_sample_uniform_and_normal_per_element():
    low = np.array([0.0, -2.0, 5.0], np.float32)
    high = np.array([1.0, 2.0, 5.5], np.float32)
    for pkg in (_jax, _port):
        u = pkg("sample_uniform", low, high, shape=(N,), seed=1)[0]
        assert u.shape == (3, N)
        assert (u >= low[:, None]).all() and (u <= high[:, None]).all()
        assert _moments_ok(u.T, (low + high) / 2, (high - low) ** 2 / 12,
                           axis=0)
        z = pkg("sample_normal", low, high, shape=(N,), seed=1)[0]
        assert z.shape == (3, N)
        assert _moments_ok(z.T, low, high ** 2, axis=0)
    np.testing.assert_array_equal(
        _port("sample_normal", low, high, shape=(4,), seed=9)[0],
        _port("sample_normal", low, high, shape=(4,), seed=9)[0])


def test_multinomial_frequencies_and_log_probs():
    """Rows of draws at the rows' frequencies; with ``get_prob`` (which
    the JAX op supports on a vector only) each draw's log-probability."""
    p = np.array([[0.1, 0.2, 0.3, 0.4], [0.7, 0.0, 0.2, 0.1]], np.float32)
    for pkg in (_jax, _port):
        idx, = pkg("_sample_multinomial", p, shape=(N,), seed=2)
        assert idx.shape == (2, N) and idx.dtype == np.int32
        for row in range(2):
            freq = np.bincount(idx[row], minlength=4) / N
            se = np.sqrt(p[row] * (1 - p[row]) / N) + 1e-9
            assert (np.abs(freq - p[row]) < 5 * se + 1e-6).all()
        idx, logp = pkg("_sample_multinomial", p[0], shape=(N,),
                        get_prob=True, seed=2)
        assert idx.shape == logp.shape == (N,)
        np.testing.assert_allclose(logp, np.log(p[0][idx]), rtol=1e-5)
    one = _port("_sample_multinomial", p[0], shape=(5,), seed=2)[0]
    assert one.shape == (5,)
    np.testing.assert_array_equal(
        one, _port("_sample_multinomial", p[0], shape=(5,), seed=2)[0])


def test_shuffle_is_a_seeded_permutation_of_rows():
    data = np.arange(40, dtype=np.float32).reshape(20, 2)
    for pkg in (_jax, _port):
        out = pkg("_shuffle", data, seed=5)[0]
        assert out.shape == data.shape
        np.testing.assert_array_equal(np.sort(out[:, 0]), data[:, 0])
        np.testing.assert_array_equal(out[:, 1], out[:, 0] + 1)
    np.testing.assert_array_equal(_port("_shuffle", data, seed=5)[0],
                                  _port("_shuffle", data, seed=5)[0])


@pytest.mark.parametrize("axes", [(), (1,)])
def test_dropout_mask_rate_scale_and_axes(axes):
    """Kept at rate 1 - p, scaled by 1 / (1 - p), shared along ``axes``,
    in both packages; the port's mask repeats under one seed."""
    x = np.ones((400, 50), np.float32)
    j = np.asarray(jreg.get_op("Dropout").fn(
        jax.numpy.asarray(x), jax.random.PRNGKey(0), p=0.3, axes=axes,
        training=True))
    t = _port("Dropout", x, p=0.3, axes=axes, training=True, seed=0)[0]
    for out in (j, t):
        assert set(np.unique(out)) <= {0.0, np.float32(1 / 0.7)}
        kept = (out != 0).mean()
        assert abs(kept - 0.7) < 5 * np.sqrt(0.21 / out.size * (
            50 if axes else 1))
        if axes:
            assert (out == out[:, :1]).all()
    np.testing.assert_array_equal(
        t, _port("Dropout", x, p=0.3, axes=axes, training=True, seed=0)[0])


def test_nd_random_namespace():
    """The same calls in both packages: shapes and dtypes agree, and the
    port's draws repeat after ``mx.random.seed``."""
    cpu = tmx.cpu()
    calls = [("uniform", dict(low=0, high=2, shape=(3, 4))),
             ("normal", dict(loc=1, scale=0.5, shape=(5,))),
             ("randint", dict(low=0, high=10, shape=(6,))),
             ("gamma", dict(alpha=2.0, shape=(4,))),
             ("exponential", dict(lam=3.0, shape=(2, 2))),
             ("poisson", dict(lam=2.0, shape=(7,))),
             ("negative_binomial", dict(k=2, p=0.5, shape=(3,))),
             ("generalized_negative_binomial", dict(mu=1.0, alpha=0.5,
                                                    shape=(3,)))]
    for name, kw in calls:
        j = getattr(jmx.nd.random, name)(**kw)
        tmx.random.seed(7)
        t = getattr(tmx.nd.random, name)(ctx=cpu, **kw)
        tmx.random.seed(7)
        t2 = getattr(tmx.nd.random, name)(ctx=cpu, **kw)
        assert t.shape == j.shape, name
        assert _dtype_as_jax(t.asnumpy()) == np.dtype(j.dtype), name
        np.testing.assert_array_equal(t.asnumpy(), t2.asnumpy())
    assert tmx.nd.random.randn(2, 3, ctx=cpu).shape == (2, 3)
    lo = tmx.nd.array([0.0, 10.0], ctx=cpu)
    u = tmx.nd.random.uniform(lo, 11.0, shape=(100,))
    assert u.shape == (2, 100) and (u.asnumpy()[1] >= 10).all()
    p = tmx.nd.array([[0.5, 0.5, 0.0]], ctx=cpu)
    assert (tmx.nd.random.multinomial(p, shape=(50,)).asnumpy() < 2).all()
    s = tmx.nd.random.shuffle(tmx.nd.array(np.arange(10.0), ctx=cpu))
    assert sorted(s.asnumpy().tolist()) == list(range(10))
