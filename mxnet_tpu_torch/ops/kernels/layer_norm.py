"""Row LayerNorm over the last axis: kernel K1 (``csrc/layer_norm.cu``)
and its plain version; and the fused residual add + LayerNorm, kernel K6
in the same source, and its plain version.

Counterpart of ``mxnet_tpu/ops/pallas/fused.py::layer_norm`` (the
``_ln_kernel`` Pallas kernel): f32 mean and rstd by the two-pass formula
``var = mean((x - mu)^2)``, then ``(x - mu) * rstd * gamma + beta`` in
x's type.  Both versions also return ``mu`` and ``rstd`` (f32, (N,)).
The kernels take x (and K6's res, of its own type) in float32, bfloat16
or float16 and any C, with any alignment; gamma and beta of any float
type are read as f32, as the Pallas kernels upcast them.

:class:`LayerNormFunction` gives K1 a gradient: its forward is
:func:`layer_norm` and saves x, gamma, mu and rstd; its backward is
:func:`layer_norm_bwd`, plain torch on every device, as the JAX package's
backward (``fused.py::_ln_bwd``) is a ``jnp`` expression under
``custom_vjp`` and not a Pallas kernel.

K6 is the counterpart of ``fused.py::add_layer_norm`` (the ``_aln_kernel``
Pallas kernel): LN(x + res) with the sum formed in f32 and never written
out, ``out`` in x's type, mu and rstd f32 (N,).
:class:`AddLayerNormFunction` gives it the gradient of ``_aln_bwd``
(:func:`add_layer_norm_bwd`, plain torch): the same ``ds`` to x and res.
"""
from __future__ import annotations

import ctypes

import torch

from ...base import MXNetError
from . import _build

__all__ = ["layer_norm", "layer_norm_ref", "layer_norm_bwd",
           "LayerNormFunction", "add_layer_norm", "add_layer_norm_ref",
           "add_layer_norm_bwd", "AddLayerNormFunction"]


def layer_norm_ref(x, gamma, beta, eps: float = 1e-5):
    """Plain PyTorch version: x (N, C), gamma/beta (C,) ->
    (out (N, C) in x's dtype, mu (N,) f32, rstd (N,) f32)."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    xc = xf - mu
    var = (xc * xc).mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + eps)
    out = xc * rstd * gamma.float() + beta.float()
    return out.to(x.dtype), mu[:, 0], rstd[:, 0]


def _lib():
    lib = _build.load("layer_norm")
    fn = lib.mx_layer_norm
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, i, p, p, p, p, p, i, i, f, p]
        fn.restype = ctypes.c_int
        aln = lib.mx_add_layer_norm
        aln.argtypes = [p, i, p, i, p, p, p, p, p, i, i, f, p]
        aln.restype = ctypes.c_int
    return lib


def _check_args(x, gamma, beta, res=None, what: str = "layer_norm"):
    """Check the operands; return (x's dtype code, res's or 0, gamma and
    beta as contiguous f32, which is what the kernel reads of them)."""
    if x.dim() != 2:
        raise MXNetError(f"{what}: x must be (N, C), got {tuple(x.shape)}")
    C = x.shape[1]
    if C == 0:
        raise MXNetError(f"{what}: C must be positive")
    args = [("x", x, tuple(x.shape)), ("gamma", gamma, (C,)),
            ("beta", beta, (C,))]
    if res is not None:
        args.append(("res", res, tuple(x.shape)))
    for name, t, shape in args:
        if t.device != x.device:
            raise MXNetError(f"{what}: {name} on {t.device}, x on "
                             f"{x.device}")
        if not t.dtype.is_floating_point:
            raise MXNetError(f"{what}: {name} must be floating point, got "
                             f"{t.dtype}")
        if tuple(t.shape) != shape:
            raise MXNetError(f"{what}: {name} has shape "
                             f"{tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise MXNetError(f"{what}: {name} must be contiguous")
    x_dt = _build.dtype_code(x, what, "x")
    res_dt = 0 if res is None else _build.dtype_code(res, what, "res")
    return (x_dt, res_dt, gamma.to(torch.float32).contiguous(),
            beta.to(torch.float32).contiguous())


def layer_norm(x, gamma, beta, eps: float = 1e-5):
    """Row LayerNorm of x (N, C) -> (out, mu, rstd), as
    :func:`layer_norm_ref`.  CPU tensors take the plain version; CUDA
    tensors launch K1 on the current stream or raise."""
    if x.device.type == "cpu":
        return layer_norm_ref(x, gamma, beta, eps)
    if x.device.type != "cuda":
        raise MXNetError(f"layer_norm: no kernel for device {x.device}")
    x_dt, _, g32, b32 = _check_args(x, gamma, beta)
    lib = _lib()
    N, C = x.shape
    out = torch.empty_like(x)
    mu = torch.empty((N,), dtype=torch.float32, device=x.device)
    rstd = torch.empty((N,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.mx_layer_norm(
            x.data_ptr(), x_dt, g32.data_ptr(), b32.data_ptr(),
            out.data_ptr(), mu.data_ptr(), rstd.data_ptr(), N, C,
            float(eps), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "layer_norm")
    layer_norm.launches += 1
    return out, mu, rstd


layer_norm.launches = 0


def layer_norm_bwd(x, gamma, mu, rstd, g):
    """(dx, dgamma, dbeta) of the row LayerNorm from the forward's mu and
    rstd, the closed form of ``fused.py::_ln_bwd``."""
    xf, gf = x.float(), g.float()
    xhat = (xf - mu[:, None]) * rstd[:, None]
    dgamma = (gf * xhat).sum(0)
    dbeta = gf.sum(0)
    dxhat = gf * gamma.float()[None, :]
    c = x.shape[-1]
    dx = rstd[:, None] / c * (c * dxhat - dxhat.sum(-1, keepdim=True)
                              - xhat * (dxhat * xhat).sum(-1, keepdim=True))
    return dx.to(x.dtype), dgamma.to(gamma.dtype), dbeta.to(gamma.dtype)


class LayerNormFunction(torch.autograd.Function):
    """out = LayerNormFunction.apply(x, gamma, beta, eps) over x (N, C):
    one :func:`layer_norm` call (K1 on CUDA tensors) forward,
    :func:`layer_norm_bwd` backward."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        out, mu, rstd = layer_norm(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mu, rstd)
        return out

    @staticmethod
    def backward(ctx, g):
        x, gamma, mu, rstd = ctx.saved_tensors
        dx, dgamma, dbeta = layer_norm_bwd(x, gamma, mu, rstd, g)
        return dx, dgamma, dbeta, None


# ---------------------------------------------------------------------------
# K6: fused residual add + LayerNorm
# ---------------------------------------------------------------------------
def add_layer_norm_ref(x, res, gamma, beta, eps: float = 1e-5):
    """Plain PyTorch version of K6: LN(x + res) with the sum in f32 ->
    (out (N, C) in x's dtype, mu (N,) f32, rstd (N,) f32)."""
    s = x.float() + res.float()
    out, mu, rstd = layer_norm_ref(s, gamma, beta, eps)
    return out.to(x.dtype), mu, rstd


def add_layer_norm(x, res, gamma, beta, eps: float = 1e-5):
    """LN(x + res) over rows of x, res (N, C) -> (out, mu, rstd), as
    :func:`add_layer_norm_ref`.  CPU tensors take the plain version; CUDA
    tensors launch K6 on the current stream or raise."""
    if x.device.type == "cpu":
        return add_layer_norm_ref(x, res, gamma, beta, eps)
    if x.device.type != "cuda":
        raise MXNetError(f"add_layer_norm: no kernel for device {x.device}")
    x_dt, res_dt, g32, b32 = _check_args(x, gamma, beta, res=res,
                                         what="add_layer_norm")
    lib = _lib()
    N, C = x.shape
    out = torch.empty_like(x)
    mu = torch.empty((N,), dtype=torch.float32, device=x.device)
    rstd = torch.empty((N,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.mx_add_layer_norm(
            x.data_ptr(), x_dt, res.data_ptr(), res_dt, g32.data_ptr(),
            b32.data_ptr(), out.data_ptr(), mu.data_ptr(), rstd.data_ptr(), N,
            C, float(eps), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "add_layer_norm")
    add_layer_norm.launches += 1
    return out, mu, rstd


add_layer_norm.launches = 0


def add_layer_norm_bwd(x, res, gamma, mu, rstd, g):
    """(dx, dres, dgamma, dbeta) of LN(x + res), the closed form of
    ``fused.py::_aln_bwd``: the add hands the same ds to both inputs."""
    s = x.float() + res.float()
    ds, dgamma, dbeta = layer_norm_bwd(s, gamma, mu, rstd, g)
    return ds.to(x.dtype), ds.to(res.dtype), dgamma, dbeta


class AddLayerNormFunction(torch.autograd.Function):
    """out = AddLayerNormFunction.apply(x, res, gamma, beta, eps) over
    x, res (N, C): one :func:`add_layer_norm` call (K6 on CUDA tensors)
    forward, :func:`add_layer_norm_bwd` backward."""

    @staticmethod
    def forward(ctx, x, res, gamma, beta, eps):
        out, mu, rstd = add_layer_norm(x, res, gamma, beta, eps)
        ctx.save_for_backward(x, res, gamma, mu, rstd)
        return out

    @staticmethod
    def backward(ctx, g):
        x, res, gamma, mu, rstd = ctx.saved_tensors
        dx, dres, dgamma, dbeta = add_layer_norm_bwd(x, res, gamma, mu,
                                                     rstd, g)
        return dx, dres, dgamma, dbeta, None
