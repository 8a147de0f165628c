"""The port's kernels at the dtypes and widths their Pallas kernels take,
against the JAX package in interpret mode.

Kernels K1-K7 take float32, bfloat16 and float16 inputs on the card, at
any LayerNorm width, any paged head dim and flash head dims up to 256.
Here, on the CPU, each wrapper runs its plain version, which is held
against the JAX function on the same numpy inputs (cast to the working
type on both sides): LayerNorm and add+LayerNorm in bf16 and f16 at C 30
and 8192, paged attention at hd 80 with an f32 q and bf16 pools, flash
attention in bf16 at D 256 and at D 200 (zero-padded to 256), with
gradients through ``jax.vjp``, and softmax cross-entropy on bf16 logits.

Tolerances: both sides compute in f32 and round once to the output type,
so a 16-bit output may differ by one unit in its last place where the f32
values straddle a rounding boundary: rtol is the type's epsilon (bf16
2^-7, f16 2^-10) with an absolute floor of 1e-6.  The gradients of flash
attention chain three products in f32 before their rounding, so they take
twice the epsilon with the f32 tests' absolute 1e-4.  f32 outputs (mu,
rstd, lse, the loss, paged attention with an f32 q) keep the f32 tests'
1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.pallas import fused as jax_fused
from mxnet_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention)
from mxnet_tpu.ops.pallas.paged_attention import (
    paged_decode_attention as jax_paged_decode_attention)
from mxnet_tpu_torch.ops.kernels import (AddLayerNormFunction,
                                         LayerNormFunction,
                                         SoftmaxCrossEntropyFunction,
                                         add_layer_norm, flash_attention,
                                         layer_norm, paged_decode_attention,
                                         softmax_cross_entropy)
from mxnet_tpu_torch.ops.kernels.flash_attention import pad_head_dim

F32_TOL = dict(rtol=1e-5, atol=1e-5)
TYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16, 2.0 ** -7),
         "float16": (torch.float16, jnp.float16, 2.0 ** -10)}


def _tol(name):
    return dict(rtol=TYPES[name][2], atol=1e-6)


def _to(a, name):
    """numpy f32 ``a`` as the torch and the jax array of type ``name``,
    the same values on both sides."""
    t = torch.from_numpy(a).to(TYPES[name][0])
    return t, jnp.asarray(t.float().numpy()).astype(TYPES[name][1])


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("name", sorted(TYPES))
@pytest.mark.parametrize("c", [30, 8192])
def test_layer_norm_16bit_matches_pallas(name, c):
    rng = np.random.RandomState(c)
    x = (rng.randn(3, c) * 2 + 0.5).astype(np.float32)
    g = rng.randn(c).astype(np.float32)
    b = rng.randn(c).astype(np.float32)
    xt, xj = _to(x, name)
    gt, gj = _to(g, name)
    bt, bj = _to(b, name)
    out_j, mu_j, rstd_j = jax_fused._ln_fwd_impl(xj, gj, bj, 1e-5)
    out, mu, rstd = layer_norm(xt, gt, bt)
    assert out.dtype == TYPES[name][0] and mu.dtype == torch.float32
    np.testing.assert_allclose(out.float().numpy(), _np(out_j), **_tol(name))
    np.testing.assert_allclose(mu.numpy(), _np(mu_j)[:, 0], **F32_TOL)
    np.testing.assert_allclose(rstd.numpy(), _np(rstd_j)[:, 0], **F32_TOL)


@pytest.mark.parametrize("name", sorted(TYPES))
@pytest.mark.parametrize("c", [30, 8192])
def test_add_layer_norm_16bit_matches_pallas(name, c):
    rng = np.random.RandomState(c + 1)
    x = (rng.randn(3, c) * 2 + 0.5).astype(np.float32)
    r = rng.randn(3, c).astype(np.float32)
    g = rng.randn(c).astype(np.float32)
    b = rng.randn(c).astype(np.float32)
    (xt, xj), (rt, rj), (gt, gj), (bt, bj) = (_to(a, name)
                                              for a in (x, r, g, b))
    out_j, mu_j, rstd_j = jax_fused._aln_fwd_impl(xj, rj, gj, bj, 1e-5)
    out, mu, rstd = add_layer_norm(xt, rt, gt, bt)
    assert out.dtype == TYPES[name][0]
    np.testing.assert_allclose(out.float().numpy(), _np(out_j), **_tol(name))
    np.testing.assert_allclose(mu.numpy(), _np(mu_j)[:, 0], **F32_TOL)
    np.testing.assert_allclose(rstd.numpy(), _np(rstd_j)[:, 0], **F32_TOL)


@pytest.mark.parametrize("fused", [False, True])
def test_layer_norm_bf16_gradients_match_custom_vjp(fused):
    """The plain backward of K1 and K6 in bf16 against ``_ln_bwd`` and
    ``_aln_bwd`` through ``jax.vjp``: dx (and dres) in x's type."""
    rng = np.random.RandomState(7 + fused)
    x, r, dy = (rng.randn(5, 30).astype(np.float32) for _ in range(3))
    g, b = rng.randn(30).astype(np.float32), rng.randn(30).astype(np.float32)
    (xt, xj), (rt, rj), (dyt, dyj) = (_to(a, "bfloat16") for a in (x, r, dy))
    gj, bj = jnp.asarray(g), jnp.asarray(b)
    if fused:
        _, vjp = jax.vjp(lambda a, c: jax_fused.add_layer_norm(a, c, gj, bj),
                         xj, rj)
        want = vjp(dyj)
        leaves = [xt.clone().requires_grad_(), rt.clone().requires_grad_()]
        out = AddLayerNormFunction.apply(*leaves, torch.from_numpy(g),
                                         torch.from_numpy(b), 1e-5)
    else:
        _, vjp = jax.vjp(lambda a: jax_fused.layer_norm(a, gj, bj), xj)
        want = vjp(dyj)
        leaves = [xt.clone().requires_grad_()]
        out = LayerNormFunction.apply(*leaves, torch.from_numpy(g),
                                      torch.from_numpy(b), 1e-5)
    got = torch.autograd.grad(out, leaves, dyt)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), _np(w),
                                   rtol=2 * TYPES["bfloat16"][2], atol=1e-4)


def test_paged_attention_hd80_f32_query_bf16_pools():
    """The JAX engine's bf16 serving: an f32 q over bf16 pools, at a head
    dim that is no power of two; out in q's type (f32)."""
    S, H, hd, ps, P = 3, 2, 80, 4, 3
    rng = np.random.RandomState(80)
    N = 1 + S * P
    q = rng.randn(S, H, hd).astype(np.float32)
    kp = rng.randn(N, ps, H, hd).astype(np.float32)
    vp = rng.randn(N, ps, H, hd).astype(np.float32)
    table = (1 + rng.permutation(S * P)).reshape(S, P).astype(np.int32)
    lens = np.array([5, 0, 12], np.int32)
    (kt, kj), (vt, vj) = _to(kp, "bfloat16"), _to(vp, "bfloat16")
    for scale in (None, 0.3):
        want = np.asarray(jax_paged_decode_attention(
            jnp.asarray(q), kj, vj, jnp.asarray(table), jnp.asarray(lens),
            sm_scale=scale))
        got = paged_decode_attention(torch.from_numpy(q), kt, vt,
                                     torch.from_numpy(table),
                                     torch.from_numpy(lens), sm_scale=scale)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
        assert (got[1] == 0).all()


@pytest.mark.parametrize("D", [256, 200])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_bf16_wide_heads_match_pallas(D, causal):
    """bf16 at D 256 (a kernel head dim) and D 200 (zero-padded to 256 by
    ``pad_head_dim``): out, lse and the three gradients."""
    rng = np.random.RandomState(D + causal)
    q, do = (rng.randn(2, 24, D).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(2, 20, D).astype(np.float32) for _ in range(2))
    (qt, qj), (kt, kj), (vt, vj), (dot, doj) = (_to(a, "bfloat16")
                                                for a in (q, k, v, do))
    assert pad_head_dim(qt, kt, vt)[0].shape[-1] == 256
    out_j, lse_j = jax_flash_attention(qj, kj, vj, causal=causal,
                                       return_lse=True)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c,
                                                         causal=causal),
                     qj, kj, vj)
    grads_j = vjp(doj)
    leaves = [t.clone().requires_grad_() for t in (qt, kt, vt)]
    out, lse = flash_attention(*leaves, causal=causal, return_lse=True)
    grads = torch.autograd.grad(out, leaves, dot)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    np.testing.assert_allclose(out.detach().float().numpy(), _np(out_j),
                               **_tol("bfloat16"))
    np.testing.assert_allclose(lse.numpy(), _np(lse_j), **F32_TOL)
    for name, a, w in zip("qkv", grads, grads_j):
        assert a.dtype == torch.bfloat16
        np.testing.assert_allclose(a.float().numpy(), _np(w), err_msg=name,
                                   rtol=2 * TYPES["bfloat16"][2], atol=1e-4)


@pytest.mark.parametrize("ignore", [None, -1])
def test_softmax_cross_entropy_bf16_logits_match_pallas(ignore):
    rng = np.random.RandomState(3)
    x = (rng.randn(9, 1001) * 2).astype(np.float32)
    y = rng.randint(0, 1001, 9)
    y[::3] = -1 if ignore is not None else 5
    xt, xj = _to(x, "bfloat16")
    want = np.asarray(jax_fused.softmax_cross_entropy(xj, jnp.asarray(y),
                                                      ignore))
    got = softmax_cross_entropy(xt, torch.from_numpy(y), ignore)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    g = rng.randn(9).astype(np.float32)
    _, vjp = jax.vjp(lambda a: jax_fused.softmax_cross_entropy(
        a, jnp.asarray(y), ignore), xj)
    (want_d,) = vjp(jnp.asarray(g))
    leaf = xt.clone().requires_grad_()
    SoftmaxCrossEntropyFunction.apply(leaf, torch.from_numpy(y),
                                      ignore).backward(torch.from_numpy(g))
    assert leaf.grad.dtype == torch.bfloat16
    np.testing.assert_allclose(leaf.grad.float().numpy(), _np(want_d),
                               **_tol("bfloat16"))
