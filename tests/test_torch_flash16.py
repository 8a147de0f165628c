"""The arithmetic of K3's, K4's and K5's 16-bit design vs the JAX
package's Pallas flash attention.

At bf16 and f16 inputs and head dims 64 and 128, the forward (K3), the dq
kernel (K4) and the dk/dv kernel (K5) run ``csrc/flash_attention_16.cu``:
products on the tensor cores from 16-bit operands, where the plain
versions (and the Pallas kernels) take every product in f32.  Those
kernels run only on the card, so their arithmetic is emulated here in
torch, step for step: the scores S = q k^T and dP = do v^T exact in f32
(16-bit products are exact in f32), P = exp(S * scale - m) and dS = P (dP
- delta) in f32, P and dS rounded to the input type before their
products, f32 sums, and out, dq, dk and dv rounded once to the input
type; lse and delta stay f32.  The same numpy inputs, drawn from a seed
and rounded to the type, go to the JAX ``flash_attention`` in interpret
mode (as its own tests run it), whose out, lse and gradients
(``jax.vjp``) are the reference.

Tolerance: ``ulp_ratio`` <= 0.5 on out, dq, dk and dv, half the card's
gate (``chip_smoke.py``: |got - want| at most two units in the last place
of want plus one unit at the tensor's largest value); lse within 2e-5, as
on the card.  Rounding P and dS moves each output by a fraction of a unit;
a planted fault (lse or S rounded to the input type) fails that gate.
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention)

fa_mod = importlib.import_module("mxnet_tpu_torch.ops.kernels.flash_attention")

EPS = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}
JNP = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}
ULP_TOL = 0.5
LSE_ATOL = 2e-5
NEG = -1e30


def ulp_ratio(got, want, eps):
    """max |got - want| / (2 eps |want| + eps max|want|), as chip_smoke.py
    computes it: <= 1 passes there."""
    g, w = got.float(), want.float()
    allow = 2 * eps * w.abs() + eps * float(w.abs().max()) + 1e-30
    return float(((g - w).abs() / allow).max())


def _inputs(seed, N, L, D, dtype):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.randn(N, L, D).astype(np.float32)).to(dtype)
            for _ in range(4)]


def _scores(q, k, causal, scale, s_type=torch.float32):
    """S * scale with the -1e30 masks; ``s_type`` rounds S first (a
    planted fault)."""
    s = (q.float() @ k.float().transpose(-1, -2)).to(s_type).float() * scale
    if causal:
        keep = torch.ones(s.shape[-2:], dtype=torch.bool).tril()
        s = s.masked_fill(~keep, NEG)
    return s


def emulate_fwd(q, k, v, causal, scale, s_type=torch.float32):
    """K3's 16-bit design: (out in q's dtype, lse f32)."""
    s = _scores(q, k, causal, scale, s_type)
    m = s.max(-1, keepdim=True).values
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    out = (p.to(q.dtype).float() @ v.float()) / l
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def emulate_dkv(q, k, v, do, lse, delta, causal, scale,
                lse_type=torch.float32):
    """K5's 16-bit design: (dk, dv) in the input type; ``lse_type`` rounds
    lse first (a planted fault)."""
    s = _scores(q, k, causal, scale)
    lse = lse.to(lse_type).float()
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p * torch.ones(s.shape[-2:]).tril()
    dp = do.float() @ v.float().transpose(-1, -2)
    ds = p * (dp - delta[..., None])
    dv = p.to(q.dtype).float().transpose(-1, -2) @ do.float()
    dk = (ds.to(q.dtype).float().transpose(-1, -2) @ q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


def emulate_dq(q, k, v, do, lse, delta, causal, scale,
               lse_type=torch.float32):
    """K4's 16-bit design: dq in the input type, dS rounded to it before
    dS k, the sum f32 and scaled once; ``lse_type`` rounds lse first (a
    planted fault)."""
    s = _scores(q, k, causal, scale)
    lse = lse.to(lse_type).float()
    p = torch.exp(s - lse[..., None])
    if causal:
        p = p * torch.ones(s.shape[-2:]).tril()
    dp = do.float() @ v.float().transpose(-1, -2)
    ds = p * (dp - delta[..., None])
    dq = (ds.to(q.dtype).float() @ k.float()) * scale
    return dq.to(q.dtype)


@functools.lru_cache(maxsize=None)
def _case(seed, N, L, D, causal, dtype):
    """The inputs of a case and the JAX function's out, lse, dq, dk and dv
    on them (each computed once: the planted faults reuse a case's)."""
    q, k, v, do = _inputs(seed, N, L, D, dtype)
    return (q, k, v, do), _jax_reference(q, k, v, do, causal, dtype)


def _jax_reference(q, k, v, do, causal, dtype):
    args = [jnp.asarray(t.float().numpy()).astype(JNP[dtype])
            for t in (q, k, v)]
    out, lse = jax_flash_attention(*args, causal=causal, return_lse=True)
    _, vjp = jax.vjp(lambda a, b, c: jax_flash_attention(a, b, c,
                                                         causal=causal),
                     *args)
    dq, dk, dv = vjp(jnp.asarray(do.float().numpy()).astype(JNP[dtype]))
    as_t = lambda x: torch.from_numpy(np.array(x.astype(jnp.float32)))
    return as_t(out), as_t(lse), as_t(dq), as_t(dk), as_t(dv)


def _ratios(seed, N, L, D, causal, dtype, s_type=torch.float32,
            lse_type=torch.float32):
    (q, k, v, do), (out_j, lse_j, dq_j, dk_j, dv_j) = _case(
        seed, N, L, D, causal, dtype)
    scale = 1.0 / np.sqrt(D)
    out, lse = emulate_fwd(q, k, v, causal, scale, s_type)
    delta = (do.float() * out.float()).sum(-1)
    dq = emulate_dq(q, k, v, do, lse, delta, causal, scale, lse_type)
    dk, dv = emulate_dkv(q, k, v, do, lse, delta, causal, scale, lse_type)
    eps = EPS[dtype]
    return ({"out": ulp_ratio(out, out_j, eps), "dq": ulp_ratio(dq, dq_j, eps),
             "dk": ulp_ratio(dk, dk_j, eps), "dv": ulp_ratio(dv, dv_j, eps)},
            float((lse - lse_j).abs().max()))


CASES = [(2, L, D) for L in (72, 128) for D in (64, 128)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("N,L,D", CASES)
def test_16bit_design_matches_pallas(N, L, D, causal, dtype):
    """P and dS rounded to the input type keep out, dq, dk and dv within
    half the card's ulp gate of the JAX function, and lse within 2e-5."""
    ratios, lse_err = _ratios(N * L + D + int(causal), N, L, D, causal,
                              dtype)
    assert all(r <= ULP_TOL for r in ratios.values()), ratios
    assert lse_err <= LSE_ATOL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bf16", "f16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("N,L,D", CASES)
def test_16bit_dq_within_the_card_gate_of_the_plain_version(N, L, D, causal,
                                                            dtype):
    """K4's design against the port's plain version, the comparison the
    card makes (``chip_smoke.py``: the kernel against
    ``flash_attention_dq_ref`` on the same lse and delta): dS rounded to
    the input type keeps dq within half the card's ulp gate."""
    q, k, v, do = _case(N * L + D + int(causal), N, L, D, causal, dtype)[0]
    scale = 1.0 / np.sqrt(D)
    out, lse = fa_mod.flash_attention_ref(q, k, v, causal, scale)
    delta = (do.float() * out.float()).sum(-1)
    want = fa_mod.flash_attention_dq_ref(q, k, v, do, lse, delta, causal,
                                         scale)
    got = emulate_dq(q, k, v, do, lse, delta, causal, scale)
    assert got.dtype == want.dtype == dtype
    assert ulp_ratio(got, want, EPS[dtype]) <= ULP_TOL


@pytest.mark.parametrize("fault", ["lse", "s"])
def test_planted_rounding_faults_break_the_bound(fault):
    """Rounding lse (before p = exp(s - lse)) or S (before the softmax) to
    bf16 fails the gate the design passes (every ratio <= 0.5 and lse
    within 2e-5).  lse rounded moves dq, dk and dv by most of a unit; S
    rounded moves lse by ~1e-3 and out by 0.4-0.55 of the bound."""
    dtype = torch.bfloat16
    kw = {"lse_type": dtype} if fault == "lse" else {"s_type": dtype}
    # the inputs of test_16bit_design_matches_pallas[2-128-64-False-bf16]
    ratios, lse_err = _ratios(2 * 128 + 64, 2, 128, 64, False, dtype, **kw)
    if fault == "lse":
        assert max(ratios["dk"], ratios["dv"]) > ULP_TOL, ratios
        assert ratios["dq"] > ULP_TOL, ratios
    else:
        assert lse_err > 10 * LSE_ATOL, lse_err


def test_design_routing():
    """The 16-bit design takes K3, K4 and K5 at bf16 and f16 and head dims
    64 and 128; every other (dtype, head dim), f32 included, keeps the f32
    core."""
    for dtype in (torch.bfloat16, torch.float16):
        for D in (64, 128):
            assert fa_mod._design(dtype, D) == "wgmma16"
        for D in (16, 32, 256, 320, 512):
            assert fa_mod._design(dtype, D) == "f32-core"
    for D in (16, 32, 64, 128, 256, 320):
        assert fa_mod._design(torch.float32, D) == "f32-core"


class _FakeLib:
    """Stands in for a kernel library: each entry point records its name
    and returns 0 (success)."""

    def __init__(self, calls):
        self.calls = calls

    def __getattr__(self, name):
        return lambda *args: self.calls.append(name) or 0


@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_wrapper_launches_the_design_entry(kernel, monkeypatch):
    """Each of K3's, K4's and K5's wrappers calls the entry point of the
    design ``_design`` names (the 16-bit source's ``mx_*16`` at bf16 and
    f16 and head dims 64 and 128, the f32 core's otherwise) and counts
    ``launches_wgmma16`` only for the 16-bit design.  The libraries and
    the device context are stand-ins: nothing is built or launched."""
    import contextlib
    import types

    from mxnet_tpu_torch.ops.kernels import _build

    calls = []
    monkeypatch.setattr(fa_mod, "_lib", lambda: _FakeLib(calls))
    monkeypatch.setattr(fa_mod, "_lib16", lambda: _FakeLib(calls))
    monkeypatch.setattr(fa_mod, "_on_cuda", lambda what, q: True)
    monkeypatch.setattr(_build, "check", lambda lib, err, what: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    fn = getattr(fa_mod, f"flash_attention_{kernel}")
    monkeypatch.setattr(fn, "launches", 0)
    monkeypatch.setattr(fn, "launches_wgmma16", 0)
    entry = {"fwd": "mx_flash_attention_fwd", "dq": "mx_flash_attention_dq",
             "dkv": "mx_flash_attention_dkv"}[kernel]
    wgmma16 = 0
    for i, (dtype, D) in enumerate([(torch.bfloat16, 64),
                                    (torch.float16, 128),
                                    (torch.bfloat16, 32),
                                    (torch.float32, 64)]):
        q, k, v, do = _inputs(i, 2, 24, D, dtype)
        if kernel == "fwd":
            fn(q, k, v)
        else:
            lse = torch.zeros(2, 24)
            fn(q, k, v, do, lse, lse.clone())
        design = fa_mod._design(dtype, D)
        wgmma16 += design == "wgmma16"
        assert calls[-1] == entry + ("16" if design == "wgmma16" else "")
        assert (fn.launches, fn.launches_wgmma16) == (i + 1, wgmma16)
    assert wgmma16 == 2


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU a 16-bit call runs the plain versions: nothing launched,
    no counter of either design moves."""
    q, k, v, do = _inputs(3, 2, 40, 64, torch.bfloat16)
    counters = [(fn, attr)
                for fn in (fa_mod.flash_attention_fwd,
                           fa_mod.flash_attention_dq,
                           fa_mod.flash_attention_dkv)
                for attr in ("launches", "launches_wgmma16")]
    before = [getattr(fn, attr) for fn, attr in counters]
    out, lse = fa_mod.flash_attention_fwd(q, k, v)
    want, want_lse = fa_mod.flash_attention_ref(q, k, v)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    delta = (do.float() * out.float()).sum(-1)
    dq = fa_mod.flash_attention_dq(q, k, v, do, lse, delta)
    assert torch.equal(dq, fa_mod.flash_attention_dq_ref(
        q, k, v, do, lse, delta, False, 1.0 / np.sqrt(64)))
    dk, dv = fa_mod.flash_attention_dkv(q, k, v, do, lse, delta)
    assert dk.dtype == dv.dtype == torch.bfloat16
    assert [getattr(fn, attr) for fn, attr in counters] == before


def test_design_launches_count_apart(monkeypatch):
    """A launch of the 16-bit design adds one to its wrapper's
    ``launches_wgmma16`` and nothing else; ``launches`` is counted by
    its own call, as for every kernel."""
    from mxnet_tpu_torch.ops.kernels import _build

    for fn in (fa_mod.flash_attention_fwd, fa_mod.flash_attention_dq,
               fa_mod.flash_attention_dkv):
        monkeypatch.setattr(fn, "launches", 5)
        monkeypatch.setattr(fn, "launches_wgmma16", 2)
        _build.count_launch(fn, "launches_wgmma16")
        assert (fn.launches, fn.launches_wgmma16) == (5, 3)
        _build.count_launch(fn)
        assert (fn.launches, fn.launches_wgmma16) == (6, 3)


def test_16bit_source_is_built_with_the_other_kernels():
    from mxnet_tpu_torch.ops.kernels import _build

    assert "flash_attention_16" in _build.SOURCES
    text = (_build.CSRC / "flash_attention_16.cu").read_text()
    for name in ("flash_fwd16", "flash_bwd_dq16", "flash_bwd_dkv16",
                 "mx_flash_attention_dq16", "wgmma.mma_async",
                 "cp.async.bulk.tensor", "setmaxnreg", "mbarrier"):
        assert name in text
