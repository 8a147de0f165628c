"""The port's kernel modules vs the JAX package's Pallas kernels.

Kernels K1 (row LayerNorm) and K2 (ragged paged decode attention) are
CUDA C++ and run only on the card; here, on the CPU, each wrapper takes
its plain PyTorch version, which is what these tests hold against the
JAX package's Pallas kernels run in interpret mode (as tests/test_pallas.py
and tests/test_serving.py run them).  The same numpy inputs, drawn from a
seed, go to both.  Tolerance rtol = atol = 1e-5: both compute in f32, with
sums taken in a different order.
"""
import ctypes
import importlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mxnet_tpu.ops.pallas import fused as jax_fused
from mxnet_tpu.ops.pallas.paged_attention import (
    paged_decode_attention as jax_paged_decode_attention)
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.kernels import (_build, layer_norm, layer_norm_ref,
                                         paged_decode_attention,
                                         paged_decode_attention_ref)

# the modules (the package's names are the wrapper functions)
layer_norm_mod = importlib.import_module(
    "mxnet_tpu_torch.ops.kernels.layer_norm")
paged_attention_mod = importlib.import_module(
    "mxnet_tpu_torch.ops.kernels.paged_attention")

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,c", [(5, 32), (300, 64), (8, 1024)])
def test_layer_norm_matches_pallas(n, c):
    rng = np.random.RandomState(n + c)
    x = (rng.randn(n, c) * 3 + 1).astype(np.float32)
    g = rng.randn(c).astype(np.float32)
    b = rng.randn(c).astype(np.float32)
    out_j, mu_j, rstd_j = (np.asarray(a) for a in jax_fused._ln_fwd_impl(
        jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), 1e-5))
    before = layer_norm.launches
    for fn in (layer_norm, layer_norm_ref):
        out, mu, rstd = fn(torch.from_numpy(x), torch.from_numpy(g),
                           torch.from_numpy(b), 1e-5)
        assert out.dtype == torch.float32 and mu.shape == (n,)
        np.testing.assert_allclose(out.numpy(), out_j, **TOL)
        np.testing.assert_allclose(mu.numpy(), mu_j[:, 0], **TOL)
        np.testing.assert_allclose(rstd.numpy(), rstd_j[:, 0], **TOL)
    # the CPU path is the plain version: no kernel launched, none counted
    assert layer_norm.launches == before


def _paged_inputs(seed, S, H, hd, ps, P, lengths):
    rng = np.random.RandomState(seed)
    N = 1 + S * P
    q = rng.randn(S, H, hd).astype(np.float32)
    kp = rng.randn(N, ps, H, hd).astype(np.float32)
    vp = rng.randn(N, ps, H, hd).astype(np.float32)
    # scattered pages: each slot's table row is a random set of pool pages
    table = (1 + rng.permutation(S * P)).reshape(S, P).astype(np.int32)
    return q, kp, vp, table, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("S,H,hd,ps,P,lengths", [
    # ragged, an inactive slot, one full last page (12 = 3 * 4), length 1
    (4, 4, 8, 4, 3, [5, 12, 0, 1]),
    # the Transformer-big head_dim, pages of 16, a slot longer than one page
    (3, 2, 64, 16, 3, [17, 48, 0]),
])
def test_paged_attention_matches_pallas(S, H, hd, ps, P, lengths):
    q, kp, vp, table, lens = _paged_inputs(7, S, H, hd, ps, P, lengths)
    want = np.asarray(jax_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lens)))
    before = paged_decode_attention.launches
    args = [torch.from_numpy(a) for a in (q, kp, vp, table, lens)]
    for fn in (paged_decode_attention, paged_decode_attention_ref):
        got = fn(*args).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        for s, L in enumerate(lens):
            if L == 0:
                assert (got[s] == 0).all(), "inactive slot must be zeros"
    assert paged_decode_attention.launches == before


def test_paged_attention_length_past_table_attends_whole_row():
    """A length beyond P * ps attends the whole table row, as the TPU
    kernel's loop over all P pages does."""
    q, kp, vp, table, _ = _paged_inputs(3, 2, 2, 8, 4, 2, [0, 0])
    lens = np.array([8, 50], np.int32)
    want = np.asarray(jax_paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(table),
        jnp.asarray(lens)))
    args = [torch.from_numpy(a) for a in (q, kp, vp, table)]
    got = paged_decode_attention_ref(*args, torch.from_numpy(lens)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    full = paged_decode_attention_ref(
        *args, torch.from_numpy(np.array([8, 8], np.int32))).numpy()
    np.testing.assert_array_equal(got[1], full[1])


def test_wrappers_refuse_devices_without_a_kernel():
    """Off the CPU a wrapper launches its kernel or raises; a device with
    no kernel raises instead of taking the plain version."""
    x = torch.empty((4, 32), device="meta")
    g = torch.empty((32,), device="meta")
    with pytest.raises(MXNetError, match="no kernel"):
        layer_norm(x, g, g)
    q = torch.empty((2, 2, 8), device="meta")
    kp = torch.empty((3, 4, 2, 8), device="meta")
    t = torch.empty((2, 1), dtype=torch.int32, device="meta")
    n = torch.empty((2,), dtype=torch.int32, device="meta")
    with pytest.raises(MXNetError, match="no kernel"):
        paged_decode_attention(q, kp, kp, t, n)


def test_build_without_nvcc_raises(monkeypatch):
    """A kernel that cannot be built raises; there is no fallback."""
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    monkeypatch.setenv("PATH", "/nonexistent-bin")
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR",
                        _build.BUILD_DIR / "nonexistent-test-dir")
    with pytest.raises(MXNetError, match="nvcc not found"):
        _build.load("layer_norm")
    assert not _build.BUILD_DIR.exists()


class _FakeFn:
    def __init__(self):
        self.argtypes = None
        self.restype = ctypes.c_int


class _FakeLib:
    def __getattr__(self, name):
        fn = _FakeFn()
        setattr(self, name, fn)
        return fn


def _c_argtypes(source: str, fn: str):
    """ctypes types of the parameters of C entry point ``fn`` in
    ``csrc/<source>.cu``: pointers and the stream are c_void_p."""
    text = (_build.CSRC / f"{source}.cu").read_text()
    params = re.search(rf"\bint {fn}\(([^)]*)\)", text).group(1)
    out = []
    for p in params.split(","):
        if "*" in p or "cudaStream_t" in p:
            out.append(ctypes.c_void_p)
        elif "float" in p:
            out.append(ctypes.c_float)
        else:
            out.append(ctypes.c_int)
    return out


@pytest.mark.parametrize("module,source,fn", [
    (layer_norm_mod, "layer_norm", "mx_layer_norm"),
    (paged_attention_mod, "paged_attention", "mx_paged_decode_attention"),
])
def test_ctypes_binding_matches_c_signature(monkeypatch, module, source, fn):
    """The wrapper declares every argument of the C entry point: without
    ``argtypes`` a float cannot pass and a pointer is cut to 32 bits."""
    fake = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda name: fake)
    module._lib()
    got = getattr(fake, fn)
    assert got.argtypes == _c_argtypes(source, fn)
    assert got.restype is ctypes.c_int
