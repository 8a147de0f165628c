"""Gluon losses (``mxnet_tpu/gluon/loss.py``) as ``HybridBlock``s over
torch tensors.

Each loss computes the JAX class's expression, applies ``sample_weight``
(broadcast) and the scalar ``weight`` (``_apply_weighting``,
``mxnet_tpu/gluon/loss.py:18``) and takes the mean over every axis but
``batch_axis``, so a batch gives one value per sample (TripletLoss and
CosineEmbeddingLoss return theirs unweighted by a mean, as there).
Called with NDArrays under ``autograd.record()`` a loss is a node of the
port's autograd, and ``loss.backward()`` seeds ones over the batch, as
MXNet does: ``Trainer.step(batch_size)`` then divides by the batch size.

``SoftmaxCrossEntropyLoss`` on 16-bit logits rounds where
``jax.nn.log_softmax`` does in that dtype (``mxnet_tpu/gluon/loss.py:78``):
x - max, exp, the sum (accumulated in f32), log and the difference each
round to the logits' dtype (:func:`log_softmax`); torch's fused
``log_softmax`` would round once.  Labels may be float (the JAX package's
habit of passing class ids as f32); a sparse label is cast to integers.
``CTCLoss`` is not ported (ROADMAP).
"""
from __future__ import annotations

import torch
from torch.nn import functional as F

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SoftmaxCrossEntropyLoss",
           "SoftmaxCELoss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "KLDivLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss",
           "CosineEmbeddingLoss", "log_softmax"]


def log_softmax(x, axis: int = -1):
    """``jax.nn.log_softmax`` with its roundings in ``x``'s dtype."""
    if x.dtype not in (torch.bfloat16, torch.float16):
        return torch.log_softmax(x, dim=axis)
    shifted = x - x.amax(dim=axis, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=axis,
                                                      keepdim=True))


def _apply_weighting(loss, weight=None, sample_weight=None):
    if sample_weight is not None:
        loss = loss * sample_weight
    if weight is not None:
        loss = loss * weight
    return loss


def _softrelu(x):
    return F.softplus(x)


class Loss(HybridBlock):
    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def _batch_mean(self, loss):
        """The mean over every axis but ``batch_axis``."""
        axes = [a for a in range(loss.dim())
                if a != self._batch_axis % max(loss.dim(), 1)]
        return loss.mean(dim=axes) if axes else loss

    def __repr__(self):
        return (f"{type(self).__name__}(batch_axis={self._batch_axis}, "
                f"w={self._weight})")


class L2Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(label.reshape(pred.shape) - pred)
        loss = _apply_weighting(loss, self._weight / 2, sample_weight)
        return self._batch_mean(loss)


class L1Loss(Loss):
    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(label.reshape(pred.shape) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._batch_mean(loss)


class SoftmaxCrossEntropyLoss(Loss):
    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self.axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = log_softmax(pred, self.axis)
        if self._sparse_label:
            index = label.long().unsqueeze(self.axis % pred.dim())
            loss = -pred.gather(self.axis, index)
        else:
            loss = -(pred * label.reshape(pred.shape)).sum(
                dim=self.axis, keepdim=True)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._batch_mean(loss)


SoftmaxCELoss = SoftmaxCrossEntropyLoss


class SigmoidBinaryCrossEntropyLoss(Loss):
    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def forward(self, pred, label, sample_weight=None, pos_weight=None):
        label = label.reshape(pred.shape)
        if not self._from_sigmoid:
            if pos_weight is None:
                # max(x, 0) - x z + log(1 + exp(-|x|))
                loss = (torch.relu(pred) - pred * label
                        + _softrelu(-pred.abs()))
            else:
                log_weight = 1 + (pos_weight - 1) * label
                loss = (pred - pred * label + log_weight
                        * (_softrelu(-pred.abs()) + torch.relu(-pred)))
        else:
            eps = 1e-12
            if pos_weight is None:
                loss = -(torch.log(pred + eps) * label
                         + torch.log(1.0 - pred + eps) * (1.0 - label))
            else:
                loss = -(torch.log(pred + eps) * label * pos_weight
                         + torch.log(1.0 - pred + eps) * (1.0 - label))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._batch_mean(loss)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self.axis = axis

    def forward(self, pred, label, sample_weight=None):
        if not self._from_logits:
            pred = log_softmax(pred, self.axis)
        loss = label * (torch.log(label + 1e-12) - pred)
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._batch_mean(loss)


class HuberLoss(Loss):
    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def forward(self, pred, label, sample_weight=None):
        loss = torch.abs(label.reshape(pred.shape) - pred)
        loss = torch.where(loss > self._rho, loss - 0.5 * self._rho,
                           (0.5 / self._rho) * torch.square(loss))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._batch_mean(loss)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.relu(self._margin - pred * label.reshape(pred.shape))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._batch_mean(loss)


class SquaredHingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, label, sample_weight=None):
        loss = torch.square(torch.relu(
            self._margin - pred * label.reshape(pred.shape)))
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._batch_mean(loss)


class LogisticLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._label_format = label_format

    def forward(self, pred, label, sample_weight=None):
        label = label.reshape(pred.shape)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0
        loss = torch.relu(pred) - pred * label + _softrelu(-pred.abs())
        loss = _apply_weighting(loss, self._weight, sample_weight)
        return self._batch_mean(loss)


class TripletLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, pred, positive, negative, sample_weight=None):
        d = (torch.square(positive.reshape(pred.shape) - pred)
             - torch.square(negative.reshape(pred.shape) - pred))
        axes = [a for a in range(d.dim()) if a != self._batch_axis]
        loss = torch.relu(d.sum(dim=axes) + self._margin)
        return _apply_weighting(loss, self._weight, sample_weight)


class CosineEmbeddingLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, margin=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def forward(self, input1, input2, label, sample_weight=None):
        input1 = input1.reshape(input2.shape)
        cos = (input1 * input2).sum(dim=-1) / (
            torch.linalg.vector_norm(input1, dim=-1)
            * torch.linalg.vector_norm(input2, dim=-1) + 1e-12)
        label = label.reshape(cos.shape)
        loss = torch.where(label == 1, 1.0 - cos,
                           torch.relu(cos - self._margin))
        return _apply_weighting(loss, self._weight, sample_weight)
