"""Kernel K7 of the port (per-row softmax cross-entropy) vs the JAX
package's ``softmax_cross_entropy``.

The same numpy logits and labels go through
``mxnet_tpu.ops.pallas.softmax_cross_entropy`` (the ``_sce_kernel`` Pallas
kernel in interpret mode on the CPU, with its ``_sce_bwd`` custom VJP) and
the port's plain version and ``SoftmaxCrossEntropyFunction``: the per-row
loss and the gradient of the logits at atol and rtol 1e-5 (f32 both
sides).  Cases: ``ignore_label=-1``; labels outside [0, C) (-5, -1, C, C +
7) with no ignore label, whose loss is the row's logsumexp and whose
one-hot is all zeros; C = 11 and an odd C above 1000.
"""
import ctypes
import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.pallas import softmax_cross_entropy as jax_sce
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.kernels import (SoftmaxCrossEntropyFunction, _build,
                                         softmax_cross_entropy,
                                         softmax_cross_entropy_bwd,
                                         softmax_cross_entropy_ref)

# the module (the package's name is the wrapper function)
sce_mod = importlib.import_module(
    "mxnet_tpu_torch.ops.kernels.softmax_cross_entropy")

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(n, c, kind, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, c) * 3).astype(np.float32)
    y = rng.randint(0, c, n)
    if kind == "ignore":
        y[rng.rand(n) < 0.5] = -1
    elif kind == "out_of_range":
        y[0::4], y[1::4], y[2::8], y[3::8] = -1, c, c + 7, -5
    g = rng.randn(n).astype(np.float32)
    return x, y.astype(np.int64), g


CASES = [(16, 11, "ignore", -1), (12, 11, "out_of_range", None),
         (10, 1003, "ignore", -1), (9, 1003, "out_of_range", None),
         (8, 1003, "valid", None)]


@pytest.mark.parametrize("n,c,kind,ignore", CASES)
def test_loss_matches_pallas_kernel(n, c, kind, ignore):
    x, y, _ = _case(n, c, kind, n * c)
    want = np.asarray(jax_sce(jnp.asarray(x), jnp.asarray(y.astype(np.int32)),
                              ignore))
    got = softmax_cross_entropy_ref(torch.from_numpy(x), torch.from_numpy(y),
                                    ignore)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    lse = np.log(np.exp(x.astype(np.float64)).sum(-1))
    live = (y >= 0) & (y < c)
    if ignore is not None:
        assert (got.numpy()[y == ignore] == 0).all()
    else:
        # a label outside [0, C) picks nothing: the loss is the logsumexp
        np.testing.assert_allclose(got.numpy()[~live], lse[~live], **TOL)


@pytest.mark.parametrize("n,c,kind,ignore", CASES)
def test_grad_matches_sce_bwd(n, c, kind, ignore):
    x, y, g = _case(n, c, kind, n + c)
    _, vjp = jax.vjp(lambda a: jax_sce(a, jnp.asarray(y.astype(np.int32)),
                                       ignore), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    leaf = torch.from_numpy(x).requires_grad_()
    before = softmax_cross_entropy.launches
    loss = SoftmaxCrossEntropyFunction.apply(leaf, torch.from_numpy(y),
                                             ignore)
    (got,) = torch.autograd.grad(loss, leaf, torch.from_numpy(g))
    assert softmax_cross_entropy.launches == before  # the CPU runs no kernel
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the closed form equals autograd through the plain version
    ref_leaf = torch.from_numpy(x).requires_grad_()
    (auto,) = torch.autograd.grad(
        softmax_cross_entropy_ref(ref_leaf, torch.from_numpy(y), ignore),
        ref_leaf, torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), auto.numpy(), **TOL)


def test_labels_of_any_integer_type():
    x, y, g = _case(6, 11, "ignore", 3)
    t = torch.from_numpy(x)
    want = softmax_cross_entropy(t, torch.from_numpy(y), -1)
    for dt in (torch.int32, torch.int16):
        torch.testing.assert_close(
            softmax_cross_entropy(t, torch.from_numpy(y).to(dt), -1), want)
    d = softmax_cross_entropy_bwd(t, torch.from_numpy(y).to(torch.int32),
                                  torch.from_numpy(g), -1)
    assert d.shape == t.shape and (d[torch.from_numpy(y) == -1] == 0).all()


def test_refuses_devices_without_a_kernel():
    x = torch.empty((4, 11), device="meta")
    y = torch.empty((4,), dtype=torch.int64, device="meta")
    with pytest.raises(MXNetError, match="no kernel"):
        softmax_cross_entropy(x, y, -1)


@pytest.mark.parametrize("bad,match", [
    (lambda x, y: (x.double(), y), "float32"),
    (lambda x, y: (x, y.float()), "integers"),
    (lambda x, y: (x, y[:-1]), "expected logits"),
    (lambda x, y: (x[:, ::2], y), "contiguous"),
])
def test_kernel_argument_checks(bad, match):
    """What the CUDA path refuses, checked before any launch."""
    x = torch.zeros(4, 11)
    y = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(MXNetError, match=match):
        sce_mod._check_args(*bad(x, y), -1)
    sce_mod._check_args(x, y, -1)


class _FakeFn:
    def __init__(self):
        self.argtypes = None
        self.restype = ctypes.c_int


class _FakeLib:
    def __getattr__(self, name):
        fn = _FakeFn()
        setattr(self, name, fn)
        return fn


def test_binding_matches_c_signature(monkeypatch):
    """Every argument of ``mx_softmax_cross_entropy`` is declared:
    pointers (the int64 labels included) and the stream as c_void_p, the
    ints (C, the ignore flag and label) as c_int."""
    text = (_build.CSRC / "softmax_cross_entropy.cu").read_text()
    params = re.search(r"\bint mx_softmax_cross_entropy\(([^)]*)\)",
                       text).group(1).split(",")
    want = [ctypes.c_void_p if ("*" in p or "cudaStream_t" in p)
            else ctypes.c_float if "float" in p else ctypes.c_int
            for p in params]
    assert want.count(ctypes.c_void_p) == 4
    fake = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda name: fake)
    sce_mod._lib()
    assert fake.mx_softmax_cross_entropy.argtypes == want
    assert "softmax_cross_entropy" in _build.SOURCES
