"""The Gluon loss the training path uses, as a ``torch.nn`` module.

Counterpart of ``mxnet_tpu/gluon/loss.py::SoftmaxCrossEntropyLoss`` with a
sparse label: ``-log_softmax(pred)[label]`` along ``axis`` (``pick`` with
``keepdims``), then the mean over every axis but the first (the batch
axis).  Labels may be float (the JAX package's habit of passing token ids
as f32); they are cast to integers.  The dense-label, ``from_logits``,
``weight`` and ``batch_axis`` options are not ported.

On 16-bit logits the log-softmax rounds where ``jax.nn.log_softmax``
does in that dtype (``mxnet_tpu/gluon/loss.py:78``): x - max, exp, the
sum (accumulated in f32), log and the difference each round to the
logits' dtype; torch's fused ``log_softmax`` would round once.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["SoftmaxCrossEntropyLoss"]


def log_softmax(x, axis: int = -1):
    """``jax.nn.log_softmax`` with its roundings in ``x``'s dtype."""
    if x.dtype not in (torch.bfloat16, torch.float16):
        return torch.log_softmax(x, dim=axis)
    shifted = x - x.amax(dim=axis, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=axis,
                                                      keepdim=True))


class SoftmaxCrossEntropyLoss(nn.Module):
    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, pred, label):
        pred = log_softmax(pred, self.axis)
        index = label.long().unsqueeze(self.axis % pred.dim())
        loss = -pred.gather(self.axis, index)
        return loss.mean(dim=list(range(1, loss.dim())))
