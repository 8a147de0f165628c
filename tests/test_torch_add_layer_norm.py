"""Kernel K6 of the port (the fused residual add + LayerNorm) vs the JAX
package's ``add_layer_norm``.

The same numpy inputs go through ``mxnet_tpu.ops.pallas.add_layer_norm``
(the ``_aln_kernel`` Pallas kernel, in interpret mode on the CPU, with
its ``_aln_bwd`` custom VJP) and the port's plain version and
``AddLayerNormFunction``: out, and dx, dres, dgamma and dbeta, at atol
and rtol 1e-5 (f32 on both sides, sums taken in another order).  Row
counts include ones that are not a multiple of 8 (the Pallas kernel's
row padding) or of 4 (K6's rows per block).
"""
import ctypes
import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.pallas import add_layer_norm as jax_add_layer_norm
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.kernels import (AddLayerNormFunction, _build,
                                         add_layer_norm, add_layer_norm_ref,
                                         layer_norm_ref)

# the module (the package's name is the K1 wrapper function)
layer_norm_mod = importlib.import_module(
    "mxnet_tpu_torch.ops.kernels.layer_norm")

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(n, c, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, c) * 2 + 0.5).astype(np.float32)
    r = rng.randn(n, c).astype(np.float32)
    g = rng.randn(c).astype(np.float32)
    b = rng.randn(c).astype(np.float32)
    dy = rng.randn(n, c).astype(np.float32)
    return x, r, g, b, dy


@pytest.mark.parametrize("n,c", [(6, 32), (37, 64), (13, 768)])
def test_add_layer_norm_matches_pallas_kernel(n, c):
    x, r, g, b, _ = _inputs(n, c, n * c)
    want = np.asarray(jax_add_layer_norm(jnp.asarray(x), jnp.asarray(r),
                                         jnp.asarray(g), jnp.asarray(b),
                                         1e-5))
    out, mu, rstd = add_layer_norm_ref(*map(torch.from_numpy, (x, r, g, b)))
    np.testing.assert_allclose(out.numpy(), want, **TOL)
    s = (x + r).astype(np.float64)
    np.testing.assert_allclose(mu.numpy(), s.mean(-1), **TOL)
    np.testing.assert_allclose(rstd.numpy(), 1 / np.sqrt(s.var(-1) + 1e-5),
                               **TOL)


@pytest.mark.parametrize("n,c", [(6, 32), (37, 64), (13, 768)])
def test_add_layer_norm_grad_matches_aln_bwd(n, c):
    x, r, g, b, dy = _inputs(n, c, n + c)
    out_j, vjp = jax.vjp(
        lambda a, rr, gg, bb: jax_add_layer_norm(a, rr, gg, bb, 1e-5),
        *map(jnp.asarray, (x, r, g, b)))
    want = [np.asarray(t) for t in vjp(jnp.asarray(dy))]

    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, r, g, b)]
    before = add_layer_norm.launches
    out = AddLayerNormFunction.apply(*leaves, 1e-5)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(dy))
    assert add_layer_norm.launches == before  # the CPU runs no kernel
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               **TOL)
    for name, a, w in zip(("dx", "dres", "dgamma", "dbeta"), got, want):
        np.testing.assert_allclose(a.numpy(), w, err_msg=name, **TOL)
    # the add hands the same cotangent to both of its inputs
    torch.testing.assert_close(got[0], got[1], rtol=0, atol=0)


def test_add_layer_norm_is_layer_norm_of_the_sum():
    x, r, g, b, _ = _inputs(9, 16, 1)
    got = add_layer_norm_ref(*map(torch.from_numpy, (x, r, g, b)))
    want = layer_norm_ref(torch.from_numpy(x + r), torch.from_numpy(g),
                          torch.from_numpy(b))
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w)


def test_add_layer_norm_refuses_devices_without_a_kernel():
    x = torch.empty((4, 32), device="meta")
    g = torch.empty((32,), device="meta")
    with pytest.raises(MXNetError, match="no kernel"):
        add_layer_norm(x, x, g, g)


class _FakeFn:
    def __init__(self):
        self.argtypes = None
        self.restype = ctypes.c_int


class _FakeLib:
    def __getattr__(self, name):
        fn = _FakeFn()
        setattr(self, name, fn)
        return fn


def test_add_layer_norm_binding_matches_c_signature(monkeypatch):
    """Every argument of ``mx_add_layer_norm`` is declared to ctypes
    with its C type: pointers and the stream as c_void_p, ints, the float
    eps."""
    text = (_build.CSRC / "layer_norm.cu").read_text()
    params = re.search(r"\bint mx_add_layer_norm\(([^)]*)\)",
                       text).group(1).split(",")
    want = [ctypes.c_void_p if ("*" in p or "cudaStream_t" in p)
            else ctypes.c_float if "float" in p else ctypes.c_int
            for p in params]
    fake = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda name: fake)
    layer_norm_mod._lib()
    assert fake.mx_add_layer_norm.argtypes == want
    assert fake.mx_add_layer_norm.restype is ctypes.c_int
