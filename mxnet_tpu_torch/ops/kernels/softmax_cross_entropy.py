"""Per-row softmax cross-entropy: kernel K7
(``csrc/softmax_cross_entropy.cu``), its plain version, and the
``torch.autograd.Function`` that gives it a gradient.

Counterpart of ``mxnet_tpu/ops/pallas/fused.py::softmax_cross_entropy``
(the ``_sce_kernel`` Pallas kernel): for logits (N, C) and integer labels
(N,), ``loss = logsumexp(logits) - logits[label]`` in f32, 0 where the
label equals ``ignore_label``.  The kernel reads float32, bfloat16 or
float16 logits and computes in f32, as the Pallas kernel upcasts them.  A label outside [0, C) picks nothing, so
its loss is the row's logsumexp, as ``cols == y`` matches no column in the
Pallas kernel.  Labels are cast to int64 (the JAX package casts them to
int32).

:class:`SoftmaxCrossEntropyFunction` has the gradient of ``_sce_bwd``
(:func:`softmax_cross_entropy_bwd`, plain torch on every device, as the
JAX backward is a ``jnp`` expression, not a Pallas kernel):
``(softmax(x) - onehot(label)) * g``, zero on ignored rows, where the
one-hot of a label outside [0, C) is all zeros.
"""
from __future__ import annotations

import ctypes

import torch

from ...base import MXNetError
from . import _build

__all__ = ["softmax_cross_entropy", "softmax_cross_entropy_ref",
           "softmax_cross_entropy_bwd", "SoftmaxCrossEntropyFunction"]

_INT32 = (-2 ** 31, 2 ** 31 - 1)


def _onehot(labels, C: int, device):
    """(N, C) bool: column == label; all False for a label outside
    [0, C) (``F.one_hot`` would raise on it)."""
    return torch.arange(C, device=device)[None, :] == labels.long()[:, None]


def softmax_cross_entropy_ref(logits, labels, ignore_label=None):
    """Plain PyTorch version of K7: logits (N, C), labels (N,) ->
    loss (N,) f32."""
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    picked = torch.where(_onehot(labels, x.shape[-1], x.device), x,
                         0.0).sum(-1)
    loss = lse - picked
    if ignore_label is not None:
        loss = torch.where(labels.long() == int(ignore_label), 0.0, loss)
    return loss


def _lib():
    lib = _build.load("softmax_cross_entropy")
    fn = lib.mx_softmax_cross_entropy
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, i, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def _check_args(logits, labels, ignore_label) -> int:
    """Check the operands; return the logits' dtype code."""
    what = "softmax_cross_entropy"
    if logits.dim() != 2 or labels.dim() != 1 \
            or labels.shape[0] != logits.shape[0]:
        raise MXNetError(f"{what}: expected logits (N, C) and labels (N,), "
                         f"got {tuple(logits.shape)} and "
                         f"{tuple(labels.shape)}")
    if labels.device != logits.device:
        raise MXNetError(f"{what}: labels on {labels.device}, logits on "
                         f"{logits.device}")
    if not logits.is_contiguous():
        raise MXNetError(f"{what}: logits must be contiguous")
    if labels.dtype.is_floating_point or labels.dtype == torch.bool:
        raise MXNetError(f"{what}: labels must be integers, got "
                         f"{labels.dtype}")
    if logits.shape[1] > _INT32[1]:
        raise MXNetError(f"{what}: C = {logits.shape[1]} does not fit int32")
    if ignore_label is not None \
            and not _INT32[0] <= int(ignore_label) <= _INT32[1]:
        raise MXNetError(f"{what}: ignore_label {ignore_label} does not fit "
                         "int32")
    return _build.dtype_code(logits, what, "logits")


def softmax_cross_entropy(logits, labels, ignore_label=None):
    """Per-row -log softmax(logits)[label] -> (N,) f32, as
    :func:`softmax_cross_entropy_ref`.  CPU tensors take the plain
    version; CUDA tensors launch K7 on the current stream or raise."""
    if logits.device.type == "cpu":
        return softmax_cross_entropy_ref(logits, labels, ignore_label)
    if logits.device.type != "cuda":
        raise MXNetError(f"softmax_cross_entropy: no kernel for device "
                         f"{logits.device}")
    dt = _check_args(logits, labels, ignore_label)
    lib = _lib()
    N, C = logits.shape
    labels = labels.to(torch.int64).contiguous()
    loss = torch.empty((N,), dtype=torch.float32, device=logits.device)
    with torch.cuda.device(logits.device):
        err = lib.mx_softmax_cross_entropy(
            logits.data_ptr(), dt, labels.data_ptr(), loss.data_ptr(), N, C,
            int(ignore_label is not None),
            0 if ignore_label is None else int(ignore_label),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, "softmax_cross_entropy")
    _build.count_launch(softmax_cross_entropy)
    return loss


softmax_cross_entropy.launches = 0


def softmax_cross_entropy_bwd(logits, labels, g, ignore_label=None):
    """d loss / d logits for the cotangent g (N,), the closed form of
    ``fused.py::_sce_bwd``, in logits' dtype."""
    x = logits.float()
    onehot = _onehot(labels, x.shape[-1], x.device)
    d = (torch.softmax(x, dim=-1) - onehot.float()) * g.float()[:, None]
    if ignore_label is not None:
        d = torch.where((labels.long() == int(ignore_label))[:, None], 0.0, d)
    return d.to(logits.dtype)


class SoftmaxCrossEntropyFunction(torch.autograd.Function):
    """loss = SoftmaxCrossEntropyFunction.apply(logits, labels,
    ignore_label): one :func:`softmax_cross_entropy` call (K7 on CUDA
    tensors) forward, :func:`softmax_cross_entropy_bwd` backward;
    differentiable in logits only."""

    @staticmethod
    def forward(ctx, logits, labels, ignore_label):
        loss = softmax_cross_entropy(logits, labels, ignore_label)
        ctx.save_for_backward(logits, labels)
        ctx.ignore_label = ignore_label
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        return (softmax_cross_entropy_bwd(logits, labels, g,
                                          ctx.ignore_label), None, None)
