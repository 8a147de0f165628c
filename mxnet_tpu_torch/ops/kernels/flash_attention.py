"""FlashAttention-2: kernels K3 (forward), K4 (dq) and K5 (dk, dv) of
``csrc/flash_attention.cu``, their plain versions, and the
``torch.autograd.Function`` that joins them.

Counterpart of ``mxnet_tpu/ops/pallas/flash_attention.py``: softmax(q k^T
* sm_scale [causal]) v over q (N, Lq, D) and k, v (N, Lk, D), with q scaled
before the product, masked scores at -1e30 (keys at kpos >= Lk, and above
the diagonal qpos < kpos when causal), f32 math, and the row logsumexp
(N, Lq) saved for the backward.  The backward is the two-kernel FA2
scheme: p = exp(s - lse) is recomputed from the saved lse, and delta =
rowsum(do * out) is plain torch between the forward and the backward, as
``_bwd_impl`` computes it outside the Pallas kernels.  The TPU's 128-lane
lse padding and its padding of L to the block size have no counterpart:
the kernels check bounds instead.

Every wrapper takes its plain version for CPU tensors and launches its
kernel for CUDA tensors (float32, bfloat16 or float16, one type for q, k,
v and do; D in {16, 32, 64, 128, 256} or a multiple of 64 above 256;
contiguous and 16-byte aligned) or raises.  The kernels compute in f32
and round out, dq, dk and dv to the input type; lse and delta are f32.
Above 256 the kernels reduce the scores over D in chunks of 64 columns
and make one launch per 64 output columns.  :func:`flash_attention` takes
any D: it zero-pads q, k and v to the next head dim a kernel takes
(:func:`pad_head_dim`) and slices the results back.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ...base import MXNetError
from . import _build

__all__ = ["flash_attention", "flash_attention_ref", "flash_attention_fwd",
           "flash_attention_dq", "flash_attention_dkv",
           "flash_attention_dq_ref", "flash_attention_dkv_ref",
           "FlashAttentionFunction", "pad_head_dim"]

_NEG = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
# above 256 the kernels take any multiple of WIDE_STEP (their D chunk)
WIDE_STEP = 64


def _has_kernel(D: int) -> bool:
    return D in HEAD_DIMS or (D > HEAD_DIMS[-1] and D % WIDE_STEP == 0)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------
def _scale(q, sm_scale):
    """``sm_scale``, 1 / sqrt(D) when None (the JAX function's default)."""
    if sm_scale is None:
        return 1.0 / math.sqrt(q.shape[-1])
    return float(sm_scale)


def _scores(q, k, causal: bool, sm_scale: float):
    """(q * sm_scale) k^T in f32 with the -1e30 masks, and q * sm_scale."""
    qs = q.float() * sm_scale
    s = qs @ k.float().transpose(-1, -2)
    if causal:
        Lq, Lk = s.shape[-2:]
        keep = (torch.arange(Lq, device=s.device)[:, None]
                >= torch.arange(Lk, device=s.device)[None, :])
        s = s.masked_fill(~keep, _NEG)
    return s, qs


def flash_attention_ref(q, k, v, causal: bool = False, sm_scale=None):
    """Plain PyTorch version of K3: dense f32 attention over (N, L, D) ->
    (out in q's dtype, lse (N, Lq) f32).  Differentiable by autograd."""
    s, _ = _scores(q, k, causal, _scale(q, sm_scale))
    lse = torch.logsumexp(s, dim=-1)
    out = torch.exp(s - lse[..., None]) @ v.float()
    return out.to(q.dtype), lse


def _p_ds(q, k, v, do, lse, delta, causal, sm_scale):
    s, qs = _scores(q, k, causal, sm_scale)
    p = torch.exp(s - lse[..., None])
    dp = do.float() @ v.float().transpose(-1, -2)
    return p, p * (dp - delta[..., None]), qs


def flash_attention_dq_ref(q, k, v, do, lse, delta, causal: bool,
                           sm_scale: float):
    """Plain PyTorch version of K4:
    dq = sm_scale * (p * (do v^T - delta)) k."""
    _, ds, _ = _p_ds(q, k, v, do, lse, delta, causal, sm_scale)
    return ((ds @ k.float()) * sm_scale).to(q.dtype)


def flash_attention_dkv_ref(q, k, v, do, lse, delta, causal: bool,
                            sm_scale: float):
    """Plain PyTorch version of K5: dk = ds^T (q * sm_scale), dv = p^T do."""
    p, ds, qs = _p_ds(q, k, v, do, lse, delta, causal, sm_scale)
    dk = ds.transpose(-1, -2) @ qs
    dv = p.transpose(-1, -2) @ do.float()
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------
def _lib():
    lib = _build.load("flash_attention")
    fwd = lib.mx_flash_attention_fwd
    if fwd.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        # dtype, N, Lq, Lk, hd, causal, scale, stream
        tail = [i, i, i, i, i, i, f, p]
        fwd.argtypes = [p] * 5 + tail
        lib.mx_flash_attention_dq.argtypes = [p] * 7 + tail
        lib.mx_flash_attention_dkv.argtypes = [p] * 8 + tail
        lib.mx_flash_attention_fwd_shape.argtypes = [i] + [p] * 4
        for fn in (fwd, lib.mx_flash_attention_dq,
                   lib.mx_flash_attention_dkv,
                   lib.mx_flash_attention_fwd_shape):
            fn.restype = ctypes.c_int
    return lib


def _check(what: str, q, k, **others) -> int:
    """q (N, Lq, D), k (N, Lk, D); ``others`` name -> (tensor, shape), in
    q's dtype, or (tensor, shape, dtype).  Returns q's dtype code."""
    if q.dim() != 3 or k.dim() != 3:
        raise MXNetError(f"{what}: expected q (N, Lq, D) and k (N, Lk, D), "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    N, _, D = q.shape
    if not _has_kernel(D):
        raise MXNetError(f"{what}: the kernel takes head_dim in {HEAD_DIMS} "
                         f"or a multiple of {WIDE_STEP} above "
                         f"{HEAD_DIMS[-1]}, got {D}")
    code = _build.dtype_code(q, what, "q")
    want = {"q": (q, tuple(q.shape)), "k": (k, (N, k.shape[1], D)), **others}
    for name, spec in want.items():
        t, shape = spec[:2]
        dtype = spec[2] if len(spec) > 2 else q.dtype
        if t.device != q.device:
            raise MXNetError(f"{what}: {name} on {t.device}, q on {q.device}")
        if t.dtype != dtype:
            raise MXNetError(f"{what}: the kernel takes {name} as {dtype}, "
                             f"got {t.dtype}")
        if tuple(t.shape) != shape:
            raise MXNetError(f"{what}: {name} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise MXNetError(f"{what}: {name} must be contiguous and 16-byte "
                             "aligned")
    return code


def _on_cuda(what: str, q) -> bool:
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise MXNetError(f"{what}: no kernel for device {q.device}")
    return True


def flash_attention_fwd(q, k, v, causal: bool = False, sm_scale=None):
    """(out, lse) of attention over q (N, Lq, D), k/v (N, Lk, D), as
    :func:`flash_attention_ref`.  CPU tensors take the plain version; CUDA
    tensors launch K3 on the current stream or raise."""
    sm_scale = _scale(q, sm_scale)
    if not _on_cuda("flash_attention_fwd", q):
        return flash_attention_ref(q, k, v, causal, sm_scale)
    dt = _check("flash_attention_fwd", q, k, v=(v, tuple(k.shape)))
    N, Lq, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((N, Lq), dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.mx_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), dt, N, Lq, k.shape[1], D, int(causal), sm_scale,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out, lse


def _bwd_check(what, q, k, v, do, lse, delta) -> int:
    N, Lq, _ = q.shape
    f32 = torch.float32
    return _check(what, q, k, v=(v, tuple(k.shape)), do=(do, tuple(q.shape)),
                  lse=(lse, (N, Lq), f32), delta=(delta, (N, Lq), f32))


def flash_attention_dq(q, k, v, do, lse, delta, causal: bool = False,
                       sm_scale=None):
    """dq of the attention, from do, the forward's lse and delta =
    rowsum(do * out).  CPU tensors take :func:`flash_attention_dq_ref`;
    CUDA tensors launch K4 or raise."""
    sm_scale = _scale(q, sm_scale)
    if not _on_cuda("flash_attention_dq", q):
        return flash_attention_dq_ref(q, k, v, do, lse, delta, causal,
                                      sm_scale)
    dt = _bwd_check("flash_attention_dq", q, k, v, do, lse, delta)
    N, Lq, D = q.shape
    dq = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.mx_flash_attention_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dt, N, Lq,
            k.shape[1], D, int(causal), sm_scale,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "flash_attention_dq")
    flash_attention_dq.launches += 1
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, causal: bool = False,
                        sm_scale=None):
    """(dk, dv) of the attention.  CPU tensors take
    :func:`flash_attention_dkv_ref`; CUDA tensors launch K5 or raise."""
    sm_scale = _scale(q, sm_scale)
    if not _on_cuda("flash_attention_dkv", q):
        return flash_attention_dkv_ref(q, k, v, do, lse, delta, causal,
                                       sm_scale)
    dt = _bwd_check("flash_attention_dkv", q, k, v, do, lse, delta)
    N, Lq, D = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.mx_flash_attention_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dt, N, Lq, k.shape[1], D, int(causal), sm_scale,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "flash_attention_dkv")
    flash_attention_dkv.launches += 1
    return dk, dv


def _fwd_shape(D: int) -> dict:
    """K3's launch shape at head dim D, as the kernel's source sets it:
    q ``rows`` and ``threads`` of a block, its dynamic shared memory
    (``smem_bytes``) and ``blocks_per_sm``, the blocks an SM of the
    current card holds.  A forward over N heads of Lq rows launches
    N * ceil(Lq / rows) blocks.  Needs a card; a diagnostic for
    ``chip_smoke.py`` that no path of the port calls."""
    if not _has_kernel(D):
        raise MXNetError(f"_fwd_shape: no kernel at head_dim {D} (it takes "
                         f"{HEAD_DIMS} or a multiple of {WIDE_STEP} above "
                         f"{HEAD_DIMS[-1]})")
    lib = _lib()
    vals = [ctypes.c_int(0) for _ in range(4)]
    err = lib.mx_flash_attention_fwd_shape(
        D, *(ctypes.byref(x) for x in vals))
    _build.check(lib, err, "_fwd_shape")
    return dict(zip(("rows", "threads", "smem_bytes", "blocks_per_sm"),
                    (x.value for x in vals)))


flash_attention_fwd.launches = 0
flash_attention_dq.launches = 0
flash_attention_dkv.launches = 0


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------
class FlashAttentionFunction(torch.autograd.Function):
    """out, lse = FlashAttentionFunction.apply(q, k, v, causal, sm_scale):
    K3 forward; K4 and K5 backward (each only when its inputs need a
    gradient).  lse is not differentiable."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sm_scale):
        out, lse = flash_attention_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * out.float()).sum(-1)
        args = (q, k, v, do, lse, delta, ctx.causal, ctx.sm_scale)
        dq = dk = dv = None
        if ctx.needs_input_grad[0]:
            dq = flash_attention_dq(*args)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dk, dv = flash_attention_dkv(*args)
        return dq, dk, dv, None, None


def pad_head_dim(q, k, v):
    """(q, k, v) zero-padded along D to the next head dim a kernel takes:
    the next in ``HEAD_DIMS`` up to 256, above it the next multiple of
    ``WIDE_STEP``; as they are when D is one already.  Zero columns leave
    q k^T and the lse unchanged, give out zero columns and, through the
    pad's autograd, slice dq, dk and dv back to D."""
    D = q.shape[-1]
    to = next((h for h in HEAD_DIMS if h >= D),
              -(-D // WIDE_STEP) * WIDE_STEP)
    if to == D:
        return q, k, v
    return tuple(torch.nn.functional.pad(t, (0, to - D)) for t in (q, k, v))


def flash_attention(q, k, v, causal: bool = False, sm_scale=None,
                    return_lse: bool = False):
    """Fused attention softmax(q k^T * sm_scale [causal]) v, differentiable
    in q, k and v.  q: (N, Lq, D) or (B, H, Lq, D); k, v likewise with Lk.
    ``sm_scale`` defaults to 1 / sqrt(D).  A D the kernels do not take
    runs zero-padded (:func:`pad_head_dim`); strided inputs (the heads
    of a batch of one, split from a fused projection) are copied
    contiguous first, as the kernels read them.  ``return_lse``
    also returns the row logsumexp (N, Lq) or (B, H, Lq) in f32 (not
    differentiable)."""
    q4 = q.dim() == 4
    if q4:
        b, h = q.shape[:2]
        q, k, v = (t.reshape(b * h, *t.shape[2:]) for t in (q, k, v))
    q, k, v = (t.contiguous() for t in (q, k, v))
    D = q.shape[-1]
    sm_scale = _scale(q, sm_scale)
    out, lse = FlashAttentionFunction.apply(*pad_head_dim(q, k, v),
                                            bool(causal), sm_scale)
    out = out[..., :D]
    if q4:
        out = out.reshape(b, h, *out.shape[1:])
        lse = lse.reshape(b, h, lse.shape[-1])
    return (out, lse) if return_lse else out
