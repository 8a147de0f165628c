"""Test utilities, the counterpart of the JAX
package's ``test_utils.py``
(reference: python/mxnet/test_utils.py: assert_almost_equal,
check_numeric_gradient ~L900, check_consistency ~L1300, rand_ndarray,
default_context, with_seed).

``check_consistency(fn, [mx.cpu(), mx.gpu(0)])`` is MXNet's own way to
check a GPU backend: ``fn`` runs once per context (inside ``with ctx:``,
on inputs placed there) and every result is held against the first
within the dtype tolerances of ``_dtype_tol``.  A bfloat16 result is
compared at bfloat16's tolerance although ``asnumpy`` hands it out as
float32 (numpy has no bfloat16).
"""
from __future__ import annotations

import functools
import logging
import os
import random as pyrandom

import numpy as np
import torch

from .base import MXNetError
from .context import Context, cpu

__all__ = ["default_context", "set_default_context", "assert_almost_equal",
           "almost_equal", "rand_ndarray", "rand_shape_nd", "with_seed",
           "check_numeric_gradient", "check_consistency", "same", "retry",
           "DummyIter", "get_mnist", "list_gpus"]

_default_ctx = None


def default_context() -> Context:
    """The test context: ``MXNET_TEST_DEVICE`` (cpu or gpu, default cpu),
    unless :func:`set_default_context` set one; ``gpu`` is ``gpu(0)``."""
    if _default_ctx is not None:
        return _default_ctx
    dev = os.environ.get("MXNET_TEST_DEVICE", "cpu")
    from . import context as ctx_mod

    return getattr(ctx_mod, dev)() if dev in ("cpu", "gpu") else cpu()


def set_default_context(ctx: Context):
    global _default_ctx
    _default_ctx = ctx


def _as_numpy(x):
    from .ndarray import NDArray

    if isinstance(x, NDArray):
        return x.asnumpy()
    return np.asarray(x)


def _dtype_name(x) -> str:
    """The element type of ``x`` by name; ``bfloat16`` for a bfloat16
    NDArray, whose ``asnumpy`` is float32."""
    from .ndarray import NDArray

    if isinstance(x, NDArray):
        return str(x.data.dtype).replace("torch.", "")
    return np.asarray(x).dtype.name


def same(a, b) -> bool:
    return np.array_equal(_as_numpy(a), _as_numpy(b))


def _dtype_tol(dtype):
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    return {
        "float16": (1e-2, 1e-2),
        "bfloat16": (2e-2, 2e-2),
        "float32": (1e-4, 1e-5),
        "float64": (1e-7, 1e-9),
    }.get(name, (0.0, 0.0))


def _get_tols(a, b, rtol, atol):
    rt_a, at_a = _dtype_tol(_dtype_name(a))
    rt_b, at_b = _dtype_tol(_dtype_name(b))
    return (rtol if rtol is not None else max(rt_a, rt_b),
            atol if atol is not None else max(at_a, at_b))


def almost_equal(a, b, rtol=None, atol=None, equal_nan=False) -> bool:
    rtol, atol = _get_tols(a, b, rtol, atol)
    return np.allclose(_as_numpy(a).astype(np.float64),
                       _as_numpy(b).astype(np.float64),
                       rtol=rtol, atol=atol, equal_nan=equal_nan)


def assert_almost_equal(a, b, rtol=None, atol=None, names=("a", "b"),
                        equal_nan=False):
    """Dtype-aware tolerance comparison (reference ~L500)."""
    rtol, atol = _get_tols(a, b, rtol, atol)
    np.testing.assert_allclose(
        _as_numpy(a).astype(np.float64), _as_numpy(b).astype(np.float64),
        rtol=rtol, atol=atol, equal_nan=equal_nan,
        err_msg=f"{names[0]} and {names[1]} differ (rtol={rtol}, atol={atol})")


def rand_shape_nd(ndim, dim=10):
    return tuple(np.random.randint(1, dim + 1, size=ndim))


def rand_ndarray(shape, stype="default", density=None, dtype=None, ctx=None,
                 scale=1.0):
    from . import ndarray as nd

    if stype != "default":
        raise MXNetError("sparse stypes are emulated; use default")
    arr = np.random.uniform(-scale, scale, shape)
    return nd.array(arr, ctx=ctx or default_context(),
                    dtype=dtype or np.float32)


def with_seed(seed=None):
    """Per-test RNG reseeding decorator; logs the seed on failure so runs
    are reproducible (reference: with_seed ~L200)."""

    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            this_seed = seed if seed is not None else np.random.randint(0, 2**31)
            np.random.seed(this_seed)
            pyrandom.seed(this_seed)
            from . import random as mx_random

            mx_random.seed(this_seed)
            try:
                return fn(*args, **kwargs)
            except Exception:
                logging.error("Test %s failed with seed %d", fn.__name__,
                              this_seed)
                raise

        return wrapper

    return decorator


def retry(n):
    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            for i in range(n):
                try:
                    return fn(*args, **kwargs)
                except AssertionError:
                    if i == n - 1:
                        raise
                    np.random.seed()

        return wrapper

    return decorator


def check_numeric_gradient(fn, inputs, eps=1e-3, rtol=1e-2, atol=None):
    """Finite-difference check of the autograd path (reference ~L900).

    fn: callable taking NDArrays -> scalar NDArray loss.
    inputs: list of NDArrays (grads attached here); central differences
    of ``eps`` move one element at a time, in float32, on the array's own
    device.
    """
    from . import autograd

    for x in inputs:
        x.attach_grad()
    with autograd.record():
        loss = fn(*inputs)
    loss.backward()
    analytic = [x.grad.asnumpy().copy() for x in inputs]

    for i, x in enumerate(inputs):
        base = x.asnumpy().astype(np.float64)
        numeric = np.zeros_like(base)
        flat = base.ravel()
        num_flat = numeric.ravel()
        dev, dtype = x.data.device, x.data.dtype

        def put():
            x._set_data(torch.from_numpy(
                base.astype(np.float32)).to(device=dev, dtype=dtype))

        for j in range(flat.size):
            orig = flat[j]
            flat[j] = orig + eps
            put()
            lp = float(fn(*inputs).asscalar())
            flat[j] = orig - eps
            put()
            lm = float(fn(*inputs).asscalar())
            flat[j] = orig
            put()
            num_flat[j] = (lp - lm) / (2 * eps)
        np.testing.assert_allclose(analytic[i], numeric, rtol=rtol,
                                   atol=atol or 1e-3,
                                   err_msg=f"gradient mismatch on input {i}")


def check_consistency(fn, ctx_list, inputs_np=None, rtol=None, atol=None):
    """Run ``fn`` under each context and compare outputs: the cpu-vs-gpu
    backend oracle (reference: check_consistency ~L1300, the main
    correctness harness for new device backends).  Returns the results
    as numpy arrays, the first context's first."""
    from . import ndarray as nd

    results, kinds = [], []
    for ctx in ctx_list:
        with ctx:
            args = [nd.array(a, ctx=ctx) for a in (inputs_np or [])]
            out = fn(*args)
            results.append(_as_numpy(out))
            kinds.append(_dtype_name(out))
    ref = results[0]
    for got, kind, ctx in zip(results[1:], kinds[1:], ctx_list[1:]):
        rt_a, at_a = _dtype_tol(kinds[0])
        rt_b, at_b = _dtype_tol(kind)
        rt = rtol if rtol is not None else max(rt_a, rt_b)
        at = atol if atol is not None else max(at_a, at_b)
        np.testing.assert_allclose(
            ref.astype(np.float64), got.astype(np.float64), rtol=rt, atol=at,
            err_msg=f"inconsistent results between {ctx_list[0]} and {ctx}")
    return results


class DummyIter:
    """Infinite repeat of one batch (reference: DummyIter): benchmarking
    without input-pipeline cost."""

    def __init__(self, real_iter):
        self.real_iter = real_iter
        self.provide_data = real_iter.provide_data
        self.provide_label = real_iter.provide_label
        self.batch_size = real_iter.batch_size
        self.the_batch = next(real_iter)

    def __iter__(self):
        return self

    def __next__(self):
        return self.the_batch

    next = __next__

    def reset(self):
        pass


def get_mnist():
    """MNIST as a dict of NCHW float32 arrays in [0, 1] and labels: the
    port's ``gluon.data.vision.MNIST`` (local IDX files, else its
    synthetic set; nothing is downloaded)."""
    from .gluon.data.vision import MNIST

    train = MNIST(train=True)
    test = MNIST(train=False)
    return {
        "train_data": train._data.transpose(0, 3, 1, 2).astype(np.float32) / 255,
        "train_label": train._label,
        "test_data": test._data.transpose(0, 3, 1, 2).astype(np.float32) / 255,
        "test_label": test._label,
    }


def list_gpus():
    """The ids of the cards torch sees."""
    return list(range(torch.cuda.device_count()
                      if torch.cuda.is_available() else 0))
