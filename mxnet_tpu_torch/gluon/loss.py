"""The Gluon loss the training path uses, as a ``torch.nn`` module.

Counterpart of ``mxnet_tpu/gluon/loss.py::SoftmaxCrossEntropyLoss`` with a
sparse label: ``-log_softmax(pred)[label]`` along ``axis`` (``pick`` with
``keepdims``), then the mean over every axis but the first (the batch
axis).  Labels may be float (the JAX package's habit of passing token ids
as f32); they are cast to integers.  The dense-label, ``from_logits``,
``weight`` and ``batch_axis`` options are not ported.
"""
from __future__ import annotations

import torch
from torch import nn

__all__ = ["SoftmaxCrossEntropyLoss"]


class SoftmaxCrossEntropyLoss(nn.Module):
    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, pred, label):
        pred = torch.log_softmax(pred, dim=self.axis)
        index = label.long().unsqueeze(self.axis % pred.dim())
        loss = -pred.gather(self.axis, index)
        return loss.mean(dim=list(range(1, loss.dim())))
