"""The port's FlashAttention-2 vs the JAX package's Pallas kernels.

Kernels K3 (forward), K4 (dq) and K5 (dk, dv) are CUDA C++ and run only on
the card; here, on the CPU, ``flash_attention`` runs through
``FlashAttentionFunction`` with each kernel's plain version, and that is
held against ``mxnet_tpu.ops.pallas.flash_attention`` in interpret mode
(the Pallas ``_fwd_kernel``, ``_dq_kernel`` and ``_dkv_kernel``), with
gradients from ``jax.vjp``.  The same numpy inputs, drawn from a seed, go
to both.  Tolerances: out and lse atol = rtol = 1e-5, dq, dk and dv
1e-4; both compute in f32 with sums in another order, and the gradients
chain three products.  Head dims the kernels do not take (48, 80, 300)
run zero-padded and are held against the JAX function at their own D,
as are the wide ones the kernels take in chunks (320, 384).  The
kernels' precision plan (every product of K4 and K5 in 3xTF32 on the
tensor cores) is emulated on the f32 bit patterns and held against the
plain versions.
"""
import ctypes
import importlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention)
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops.kernels import (_build, flash_attention,
                                         flash_attention_dkv,
                                         flash_attention_dkv_ref,
                                         flash_attention_dq,
                                         flash_attention_dq_ref,
                                         flash_attention_fwd,
                                         flash_attention_ref)

fa_mod = importlib.import_module("mxnet_tpu_torch.ops.kernels.flash_attention")

OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
KERNELS = (flash_attention_fwd, flash_attention_dq, flash_attention_dkv)

CASES = [
    # N, Lq, Lk, D, causal
    (3, 16, 16, 16, False),
    (3, 16, 16, 16, True),
    (2, 19, 33, 64, False),    # Lq != Lk, neither a multiple of 8
    (2, 37, 37, 64, True),     # causal, not a multiple of 8
    (2, 40, 27, 16, True),     # causal with Lq > Lk
]


def _inputs(seed, shape_q, shape_k):
    rng = np.random.RandomState(seed)
    q = rng.randn(*shape_q).astype(np.float32)
    k = rng.randn(*shape_k).astype(np.float32)
    v = rng.randn(*shape_k).astype(np.float32)
    do = rng.randn(*shape_q).astype(np.float32)
    return q, k, v, do


def _jax_reference(q, k, v, do, causal):
    out, lse = jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   return_lse=True)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c,
                                                         causal=causal),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads = vjp(jnp.asarray(do))
    return np.asarray(out), np.asarray(lse), [np.asarray(g) for g in grads]


def _port(q, k, v, do, causal):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out, lse = flash_attention(tq, tk, tv, causal=causal, return_lse=True)
    grads = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(do))
    return out.detach().numpy(), lse.numpy(), [g.numpy() for g in grads]


@pytest.mark.parametrize("N,Lq,Lk,D,causal", CASES)
def test_flash_attention_matches_pallas(N, Lq, Lk, D, causal):
    q, k, v, do = _inputs(N * Lq + Lk + D, (N, Lq, D), (N, Lk, D))
    out_j, lse_j, grads_j = _jax_reference(q, k, v, do, causal)
    before = [fn.launches for fn in KERNELS]
    out, lse, grads = _port(q, k, v, do, causal)
    np.testing.assert_allclose(out, out_j, **OUT_TOL)
    np.testing.assert_allclose(lse, lse_j, **OUT_TOL)
    for name, g, gj in zip("qkv", grads, grads_j):
        np.testing.assert_allclose(g, gj, err_msg=f"d{name}", **GRAD_TOL)
    # the CPU path is the plain versions: no kernel launched, none counted
    assert [fn.launches for fn in KERNELS] == before


def test_flash_attention_4d_matches_pallas():
    """(B, H, L, D) inputs, as the JAX function takes them."""
    q, k, v, do = _inputs(11, (2, 3, 24, 16), (2, 3, 24, 16))
    out_j, lse_j, grads_j = _jax_reference(q, k, v, do, True)
    out, lse, grads = _port(q, k, v, do, True)
    assert out.shape == (2, 3, 24, 16) and lse.shape == (2, 3, 24)
    np.testing.assert_allclose(out, out_j, **OUT_TOL)
    np.testing.assert_allclose(lse, lse_j, **OUT_TOL)
    for g, gj in zip(grads, grads_j):
        np.testing.assert_allclose(g, gj, **GRAD_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_kernel_plain_versions_match_autograd_of_reference(causal):
    """The plain versions of K4 and K5 (what the card's kernels are held
    against) equal autograd through the dense reference, with a given
    sm_scale."""
    q, k, v, do = (torch.from_numpy(a) for a in
                   _inputs(5, (2, 21, 32), (2, 30, 32)))
    scale = 0.3
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    out, lse = flash_attention_ref(tq, tk, tv, causal, scale)
    want = torch.autograd.grad(out, (tq, tk, tv), do)
    delta = (do * out.detach()).sum(-1)
    dq = flash_attention_dq_ref(q, k, v, do, lse.detach(), delta, causal,
                                scale)
    dk, dv = flash_attention_dkv_ref(q, k, v, do, lse.detach(), delta,
                                     causal, scale)
    for got, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(got, w, rtol=1e-5, atol=1e-5)


def test_backward_honours_needs_input_grad(monkeypatch):
    """Only the kernels whose gradients are asked for run."""
    calls = []
    for name in ("flash_attention_dq", "flash_attention_dkv"):
        real = getattr(fa_mod, name)
        monkeypatch.setattr(fa_mod, name,
                            lambda *a, _r=real, _n=name: (calls.append(_n),
                                                          _r(*a))[1])
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(2, (1, 8, 16),
                                                       (1, 8, 16)))
    q.requires_grad_()
    flash_attention(q, k, v).sum().backward()
    assert calls == ["flash_attention_dq"]
    calls.clear()
    q.requires_grad_(False)
    v.requires_grad_()
    flash_attention(q, k, v).sum().backward()
    assert calls == ["flash_attention_dkv"]


def test_wrappers_refuse_devices_without_a_kernel():
    q = torch.empty((2, 8, 16), device="meta")
    lse = torch.empty((2, 8), device="meta")
    with pytest.raises(MXNetError, match="no kernel"):
        flash_attention_fwd(q, q, q)
    with pytest.raises(MXNetError, match="no kernel"):
        flash_attention_dq(q, q, q, q, lse, lse)
    with pytest.raises(MXNetError, match="no kernel"):
        flash_attention_dkv(q, q, q, q, lse, lse)


@pytest.mark.parametrize("change,match", [
    (dict(D=48), "head_dim"),
    (dict(D=300), "head_dim"),
    (dict(dtype=torch.float64), "float32"),
    (dict(k_len=7, v_len=9), "shape"),
    (dict(transpose=True), "contiguous"),
])
def test_kernel_argument_checks(change, match):
    """What the kernels do not take is refused before any launch."""
    D = change.get("D", 16)
    dtype = change.get("dtype", torch.float32)
    q = torch.zeros((2, 8, D), dtype=dtype)
    k = torch.zeros((2, change.get("k_len", 8), D), dtype=dtype)
    v = torch.zeros((2, change.get("v_len", 8), D), dtype=dtype)
    if change.get("transpose"):
        q = torch.zeros((2, D, 8)).transpose(1, 2)
    with pytest.raises(MXNetError, match=match):
        fa_mod._check("flash_attention_fwd", q, k, v=(v, tuple(k.shape)))


def _c_argtypes(fn: str):
    text = (_build.CSRC / "flash_attention.cu").read_text()
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


class _FakeFn:
    def __init__(self):
        self.argtypes = None
        self.restype = ctypes.c_int


class _FakeLib:
    def __getattr__(self, name):
        fn = _FakeFn()
        setattr(self, name, fn)
        return fn


@pytest.mark.parametrize("fn", ["mx_flash_attention_fwd",
                                "mx_flash_attention_dq",
                                "mx_flash_attention_dkv",
                                "mx_flash_attention_fwd_shape"])
def test_ctypes_binding_matches_c_signature(monkeypatch, fn):
    """Every argument of each C entry point is declared: without
    ``argtypes`` a float cannot pass and a pointer is cut to 32 bits."""
    fake = _FakeLib()
    monkeypatch.setattr(_build, "load", lambda name: fake)
    fa_mod._lib()
    got = getattr(fake, fn)
    assert got.argtypes == _c_argtypes(fn)
    assert got.restype is ctypes.c_int


def test_flash_attention_is_built_with_the_other_kernels():
    assert "flash_attention" in _build.SOURCES
    assert (_build.CSRC / "flash_attention.cu").exists()


# ---------------------------------------------------------------------------
# head dims outside {16, 32, 64, 128, 256}
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("D", [48, 80])
@pytest.mark.parametrize("causal", [False, True])
def test_padded_head_dim_matches_pallas(D, causal):
    """``flash_attention`` zero-pads a head dim the kernels do not take
    to the next one and slices back; through the plain versions here, out,
    lse and the three gradients still match the JAX function at D."""
    q, k, v, do = _inputs(D + int(causal), (2, 40, D), (2, 33, D))
    padded = fa_mod.pad_head_dim(*(torch.from_numpy(a) for a in (q, k, v)))
    assert all(t.shape[-1] == (64 if D == 48 else 128) for t in padded)
    out_j, lse_j, grads_j = _jax_reference(q, k, v, do, causal)
    out, lse, grads = _port(q, k, v, do, causal)
    assert out.shape == (2, 40, D)
    np.testing.assert_allclose(out, out_j, **OUT_TOL)
    np.testing.assert_allclose(lse, lse_j, **OUT_TOL)
    for name, g, gj in zip("qkv", grads, grads_j):
        assert g.shape == gj.shape
        np.testing.assert_allclose(g, gj, err_msg=f"d{name}", **GRAD_TOL)


def test_pad_head_dim_leaves_supported_and_large_dims():
    """Head dims a kernel takes stay as they are: {16, ..., 256} and the
    multiples of 64 above 256; any other D pads to the next of them."""
    for D in (16, 32, 64, 128, 256, 320, 384, 512):
        t = torch.zeros(1, 4, D)
        assert all(x is t for x in fa_mod.pad_head_dim(t, t, t))
    for D, to in ((200, 256), (257, 320), (300, 320), (450, 512)):
        t = torch.ones(1, 4, D)
        for x in fa_mod.pad_head_dim(t, t, t):
            assert x.shape == (1, 4, to)
            assert torch.equal(x[..., :D], t) and not x[..., D:].any()


# ---------------------------------------------------------------------------
# head dims above 256 (chunked over D on the card)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("D", [320, 384, 300])
@pytest.mark.parametrize("causal", [False, True])
def test_wide_head_dim_matches_pallas(D, causal):
    """At D > 256 (the kernels' chunked instantiation, 300 zero-padded to
    320) out, lse and the three gradients match the JAX function, which
    takes any D, through the plain versions here."""
    q, k, v, do = _inputs(D + 7 * int(causal), (2, 40, D), (2, 33, D))
    out_j, lse_j, grads_j = _jax_reference(q, k, v, do, causal)
    out, lse, grads = _port(q, k, v, do, causal)
    assert out.shape == (2, 40, D)
    np.testing.assert_allclose(out, out_j, **OUT_TOL)
    np.testing.assert_allclose(lse, lse_j, **OUT_TOL)
    for name, g, gj in zip("qkv", grads, grads_j):
        assert g.shape == gj.shape
        np.testing.assert_allclose(g, gj, err_msg=f"d{name}", **GRAD_TOL)


# ---------------------------------------------------------------------------
# the precision plan of K4 and K5: products in 3xTF32
# ---------------------------------------------------------------------------
def _tf32(x):
    """cvt.rna.tf32.f32 on the bits of f32 ``x``: round to 10 mantissa
    bits, ties away from zero (finite values)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x):
    """What the tensor cores read of an f32 register given as TF32: the
    10 high mantissa bits (the 13 low bits are dropped)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def _mm_tf32(a, b, passes):
    """a @ b with TF32 operands: one product of the rounded operands
    (``passes`` 1), or 3xTF32 (``passes`` 3) as K4 and K5 form it: each
    operand split as big = rna(x) and small = x - big, which the tensor
    cores truncate to TF32, and small big + big small + big big summed in
    f32."""
    a_big, b_big = _tf32(a), _tf32(b)
    if passes == 1:
        return a_big @ b_big
    a_small = _tf32_truncated(a - a_big)
    b_small = _tf32_truncated(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _grads_tf32(q, k, v, do, lse, delta, causal, scale, passes):
    """dq, dk, dv by the formulas of flash_attention_dq_ref and
    flash_attention_dkv_ref, every product in TF32 (``_mm_tf32``)."""
    qs = q * scale
    s = _mm_tf32(qs, k.transpose(-1, -2), passes)
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = s.masked_fill(~keep, -1e30)
    p = torch.exp(s - lse[..., None])
    dp = _mm_tf32(do, v.transpose(-1, -2), passes)
    ds = p * (dp - delta[..., None])
    dq = _mm_tf32(ds, k, passes) * scale
    dk = _mm_tf32(ds.transpose(-1, -2), qs, passes)
    dv = _mm_tf32(p.transpose(-1, -2), do, passes)
    return dq, dk, dv


# a tenth of chip_smoke.py's 1e-4 on dq, dk and dv
TF32X3_ATOL = 1e-5


@pytest.mark.parametrize("N,L,D", [(2, 128, 64), (2, 72, 128)])
@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_products_keep_f32_accuracy(N, L, D, causal):
    """The kernels' products are 3xTF32 on the tensor cores: emulated
    here, dq, dk and dv stay within a tenth of the card's tolerance of the
    f32 plain versions, while single-pass TF32 misses that bound."""
    q, k, v, do = (torch.from_numpy(a) for a in
                   _inputs(L + D + int(causal), (N, L, D), (N, L, D)))
    scale = 1.0 / np.sqrt(D)
    out, lse = flash_attention_ref(q, k, v, causal, scale)
    delta = (do * out).sum(-1)
    args = (q, k, v, do, lse, delta, causal, scale)
    want = (flash_attention_dq_ref(*args), *flash_attention_dkv_ref(*args))
    x3 = _grads_tf32(*args, passes=3)
    x1 = _grads_tf32(*args, passes=1)
    for name, got, w in zip(("dq", "dk", "dv"), x3, want):
        err = float((got - w).abs().max())
        assert err <= TF32X3_ATOL, (name, err)
    assert max(float((g - w).abs().max()) for g, w in zip(x1, want)) \
        > 10 * TF32X3_ATOL


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10  # TF32 keeps 10 mantissa bits
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + ulp, 3.0])
    assert torch.equal(_tf32(x), want)


# ---------------------------------------------------------------------------
# the precision plan of K3: its online softmax, products in 3xTF32
# ---------------------------------------------------------------------------
# keys per streamed K/V tile of K3 (Fwd<HD>::kBS in
# csrc/flash_attention.cu), 32 at every head dim
K3_TILE = 32
# a tenth of chip_smoke.py's 2e-5 on out and lse
FWD_TF32X3_ATOL = 2e-6
LOG2E = 1.4426950408889634


def _exp_k3(x):
    """K3's exp: exp2(x log2 e), the product rounded to f32."""
    return torch.exp2(x * LOG2E)


def _fwd_tf32(q, k, v, causal, scale, passes):
    """out and lse as K3 forms them: k and v stream in tiles of
    ``K3_TILE`` keys, zero-filled past Lk, through an online softmax
    (running max m, sum l, the accumulator rescaled by alpha = exp(m -
    m_new), exp as ``_exp_k3``), masked scores at -1e30, and every
    product in TF32
    (``_mm_tf32``): s = (q * scale) k_tile^T, then acc += p v_tile with
    p split as it comes out of the accumulator."""
    N, Lq, D = q.shape
    Lk, bs = k.shape[1], K3_TILE
    pad = -Lk % bs
    k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (k, v))
    qs = q * scale
    m = torch.full((N, Lq, 1), -1e30)
    l = torch.zeros(N, Lq, 1)
    acc = torch.zeros(N, Lq, D)
    qpos = torch.arange(Lq)[:, None]
    for k0 in range(0, Lk + pad, bs):
        s = _mm_tf32(qs, k[:, k0:k0 + bs].transpose(-1, -2), passes)
        kpos = k0 + torch.arange(bs)[None, :]
        keep = (kpos < Lk) & ((qpos >= kpos) if causal else True)
        s = s.masked_fill(~keep, -1e30)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = _exp_k3(s - m_new)
        alpha = _exp_k3(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _mm_tf32(p, v[:, k0:k0 + bs], passes)
        m = m_new
    safe_l = torch.where(l == 0.0, 1.0, l)
    return acc / safe_l, (m + torch.log(safe_l))[..., 0]


@pytest.mark.parametrize("N,Lq,Lk,D,causal", [
    (2, 128, 128, 64, False),
    (2, 128, 128, 64, True),
    (2, 72, 72, 128, True),
    (2, 200, 200, 128, True),
    (4, 130, 70, 32, True),     # Lq != Lk, a ragged last k tile
])
def test_3xtf32_forward_keeps_f32_accuracy(N, Lq, Lk, D, causal):
    """K3's online softmax with every product in 3xTF32, emulated tile by
    tile at its stream-tile width: out and lse stay within a tenth of the
    card's tolerance of the f32 plain version, while single-pass TF32
    misses the card's tolerance itself."""
    q, k, v, _ = (torch.from_numpy(a) for a in
                  _inputs(Lq + Lk + D + int(causal), (N, Lq, D), (N, Lk, D)))
    scale = 1.0 / np.sqrt(D)
    want = flash_attention_ref(q, k, v, causal, scale)
    errs = {}
    for passes in (3, 1):
        got = _fwd_tf32(q, k, v, causal, scale, passes)
        errs[passes] = [float((g - w).abs().max()) for g, w in zip(got, want)]
    assert max(errs[3]) <= FWD_TF32X3_ATOL, errs[3]
    assert max(errs[1]) > 10 * FWD_TF32X3_ATOL, errs[1]


def test_fwd_shape_refuses_head_dims_without_a_kernel(monkeypatch):
    """K3's launch shape is asked only at a head dim a kernel takes: 48
    and 300 are refused before the library is touched, 320 reaches it."""
    for D in (48, 300):
        with pytest.raises(MXNetError, match="head_dim"):
            fa_mod._fwd_shape(D)
    fake = _FakeLib()
    fake.mx_flash_attention_fwd_shape = lambda *args: 0
    monkeypatch.setattr(fa_mod, "_lib", lambda: fake)
    assert set(fa_mod._fwd_shape(320)) == {"rows", "threads", "smem_bytes",
                                           "blocks_per_sm"}
