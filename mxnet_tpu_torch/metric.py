"""Evaluation metrics: the port's own copy of ``mxnet_tpu/metric.py``
(numpy only, as there): ``EvalMetric``, ``Accuracy``, ``TopKAccuracy``,
``F1``, ``MAE``, ``MSE``, ``RMSE``, ``CrossEntropy``,
``NegativeLogLikelihood``, ``Perplexity``, ``PearsonCorrelation``,
``Loss``, ``CustomMetric``, ``CompositeEvalMetric`` and
``register`` / ``create``.  Labels and predictions may be NDArrays,
torch tensors (on any device; bfloat16 reads as float32) or numpy arrays;
each is read to the host through numpy.
"""
from __future__ import annotations

import math
from typing import List, Optional

import numpy as np
import torch

from .base import MXNetError

__all__ = ["EvalMetric", "Accuracy", "TopKAccuracy", "F1", "MAE", "MSE",
           "RMSE", "CrossEntropy", "NegativeLogLikelihood", "Perplexity",
           "PearsonCorrelation", "Loss", "CustomMetric",
           "CompositeEvalMetric", "register", "create"]

_REGISTRY = {}


def register(cls):
    _REGISTRY[cls.__name__.lower()] = cls
    return cls


def create(metric, *args, **kwargs):
    if callable(metric):
        return CustomMetric(metric, *args, **kwargs)
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, list):
        composite = CompositeEvalMetric()
        for child in metric:
            composite.add(create(child, *args, **kwargs))
        return composite
    if isinstance(metric, str):
        try:
            return _REGISTRY[metric.lower()](*args, **kwargs)
        except KeyError:
            raise MXNetError(f"unknown metric {metric!r}") from None
    raise MXNetError(f"cannot create metric from {metric!r}")


def _to_numpy(x):
    from .ndarray.ndarray import NDArray

    if isinstance(x, NDArray):
        return x.asnumpy()
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return np.asarray(x)


def check_label_shapes(labels, preds, shape=False):
    if not shape:
        label_shape, pred_shape = len(labels), len(preds)
    else:
        label_shape, pred_shape = labels.shape, preds.shape
    if label_shape != pred_shape:
        raise MXNetError(
            f"Shape of labels {label_shape} does not match shape of "
            f"predictions {pred_shape}")


class EvalMetric:
    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._kwargs = kwargs
        self.reset()

    def __str__(self):
        return f"EvalMetric: {dict(zip(*self.get()))}"

    def update(self, labels, preds):
        raise NotImplementedError

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, self.sum_metric / self.num_inst)

    def get_name_value(self):
        name, value = self.get()
        if not isinstance(name, list):
            name = [name]
        if not isinstance(value, list):
            value = [value]
        return list(zip(name, value))

    def update_dict(self, label, pred):
        if self.output_names is not None:
            pred = [pred[name] for name in self.output_names]
        else:
            pred = list(pred.values())
        if self.label_names is not None:
            label = [label[name] for name in self.label_names]
        else:
            label = list(label.values())
        self.update(label, pred)


@register
class Accuracy(EvalMetric):
    def __init__(self, axis=1, name="accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, axis=axis)
        self.axis = axis

    def update(self, labels, preds):
        labels = labels if isinstance(labels, list) else [labels]
        preds = preds if isinstance(preds, list) else [preds]
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            label = _to_numpy(label)
            pred = _to_numpy(pred)
            if pred.ndim > label.ndim:
                pred = np.argmax(pred, axis=self.axis)
            pred = pred.astype(np.int32).ravel()
            label = label.astype(np.int32).ravel()
            check_label_shapes(label, pred, shape=True)
            self.sum_metric += int((pred == label).sum())
            self.num_inst += len(label)


@register
class TopKAccuracy(EvalMetric):
    def __init__(self, top_k=1, name="top_k_accuracy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, top_k=top_k)
        self.top_k = top_k
        assert top_k > 1, "Use Accuracy if top_k is no more than 1"
        self.name += f"_{top_k}"

    def update(self, labels, preds):
        labels = labels if isinstance(labels, list) else [labels]
        preds = preds if isinstance(preds, list) else [preds]
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            pred = _to_numpy(pred)
            label = _to_numpy(label).astype(np.int32)
            assert pred.ndim == 2, "Predictions should be 2 dims"
            topk_idx = np.argsort(pred, axis=1)[:, -self.top_k:]
            hits = (topk_idx == label.reshape(-1, 1)).any(axis=1)
            self.sum_metric += int(hits.sum())
            self.num_inst += len(label)


@register
class F1(EvalMetric):
    def __init__(self, name="f1", output_names=None, label_names=None,
                 average="macro"):
        super().__init__(name, output_names, label_names)
        self.average = average
        self.reset_stats()

    def reset_stats(self):
        self._tp = 0.0
        self._fp = 0.0
        self._fn = 0.0

    def reset(self):
        super().reset()
        if hasattr(self, "average"):
            self.reset_stats()

    @staticmethod
    def _f1_score(tp, fp, fn):
        precision = tp / (tp + fp) if tp + fp > 0 else 0.0
        recall = tp / (tp + fn) if tp + fn > 0 else 0.0
        return (2 * precision * recall / (precision + recall)
                if precision + recall > 0 else 0.0)

    def update(self, labels, preds):
        labels = labels if isinstance(labels, list) else [labels]
        preds = preds if isinstance(preds, list) else [preds]
        for label, pred in zip(labels, preds):
            pred = _to_numpy(pred)
            label = _to_numpy(label).astype(np.int32)
            if pred.ndim > 1:
                pred = np.argmax(pred, axis=-1)
            pred = pred.astype(np.int32)
            if not np.all(np.isin(label, [0, 1])):
                raise MXNetError("F1 currently only supports binary classification.")
            tp = int(((pred == 1) & (label == 1)).sum())
            fp = int(((pred == 1) & (label == 0)).sum())
            fn = int(((pred == 0) & (label == 1)).sum())
            if self.average == "macro":
                # mean of per-batch F1 (reference default)
                self.sum_metric += self._f1_score(tp, fp, fn)
                self.num_inst += 1
            else:  # micro: global counts
                self._tp += tp
                self._fp += fp
                self._fn += fn
                self.sum_metric = self._f1_score(self._tp, self._fp, self._fn)
                self.num_inst = 1


@register
class MAE(EvalMetric):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels = labels if isinstance(labels, list) else [labels]
        preds = preds if isinstance(preds, list) else [preds]
        for label, pred in zip(labels, preds):
            label = _to_numpy(label)
            pred = _to_numpy(pred)
            if label.ndim == 1:
                label = label.reshape(label.shape[0], 1)
            if pred.ndim == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += float(np.abs(label - pred).mean())
            self.num_inst += 1


@register
class MSE(EvalMetric):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels = labels if isinstance(labels, list) else [labels]
        preds = preds if isinstance(preds, list) else [preds]
        for label, pred in zip(labels, preds):
            label = _to_numpy(label)
            pred = _to_numpy(pred)
            if label.ndim == 1:
                label = label.reshape(label.shape[0], 1)
            if pred.ndim == 1:
                pred = pred.reshape(pred.shape[0], 1)
            self.sum_metric += float(((label - pred) ** 2).mean())
            self.num_inst += 1


@register
class RMSE(MSE):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.sqrt(self.sum_metric / self.num_inst))


@register
class CrossEntropy(EvalMetric):
    def __init__(self, eps=1e-12, name="cross-entropy", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names, eps=eps)
        self.eps = eps

    def update(self, labels, preds):
        labels = labels if isinstance(labels, list) else [labels]
        preds = preds if isinstance(preds, list) else [preds]
        for label, pred in zip(labels, preds):
            label = _to_numpy(label).ravel()
            pred = _to_numpy(pred)
            assert label.shape[0] == pred.shape[0]
            prob = pred[np.arange(label.shape[0]), label.astype(np.int64)]
            self.sum_metric += float((-np.log(prob + self.eps)).sum())
            self.num_inst += label.shape[0]


@register
class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps=1e-12, name="nll-loss", output_names=None,
                 label_names=None):
        super().__init__(eps, name, output_names, label_names)


@register
class Perplexity(EvalMetric):
    def __init__(self, ignore_label=None, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, output_names, label_names,
                         ignore_label=ignore_label)
        self.ignore_label = ignore_label
        self.axis = axis

    def update(self, labels, preds):
        labels = labels if isinstance(labels, list) else [labels]
        preds = preds if isinstance(preds, list) else [preds]
        loss = 0.0
        num = 0
        for label, pred in zip(labels, preds):
            label = _to_numpy(label)
            pred = _to_numpy(pred)
            assert label.size == pred.size / pred.shape[-1]
            label = label.reshape(-1).astype(np.int64)
            pred = pred.reshape(-1, pred.shape[-1])
            probs = pred[np.arange(label.shape[0]), label]
            if self.ignore_label is not None:
                ignore = (label == self.ignore_label)
                probs = np.where(ignore, 1.0, probs)
                num -= int(ignore.sum())
            loss -= float(np.log(np.maximum(1e-10, probs)).sum())
            num += label.shape[0]
        self.sum_metric += loss
        self.num_inst += num

    def get(self):
        if self.num_inst == 0:
            return (self.name, float("nan"))
        return (self.name, math.exp(self.sum_metric / self.num_inst))


@register
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, labels, preds):
        labels = labels if isinstance(labels, list) else [labels]
        preds = preds if isinstance(preds, list) else [preds]
        for label, pred in zip(labels, preds):
            label = _to_numpy(label).ravel()
            pred = _to_numpy(pred).ravel()
            self.sum_metric += float(np.corrcoef(pred, label)[0, 1])
            self.num_inst += 1


@register
class Loss(EvalMetric):
    """Dummy metric for mean of (already computed) loss values."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)

    def update(self, _, preds):
        preds = preds if isinstance(preds, list) else [preds]
        for pred in preds:
            loss = float(_to_numpy(pred).sum())
            self.sum_metric += loss
            self.num_inst += int(np.prod(_to_numpy(pred).shape)) or 1


class CustomMetric(EvalMetric):
    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
        super().__init__(name, output_names, label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        labels = labels if isinstance(labels, list) else [labels]
        preds = preds if isinstance(preds, list) else [preds]
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            reval = self._feval(_to_numpy(label), _to_numpy(pred))
            if isinstance(reval, tuple):
                sum_metric, num_inst = reval
                self.sum_metric += sum_metric
                self.num_inst += num_inst
            else:
                self.sum_metric += reval
                self.num_inst += 1


class CompositeEvalMetric(EvalMetric):
    def __init__(self, metrics=None, name="composite", output_names=None,
                 label_names=None):
        super().__init__(name, output_names, label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def get_metric(self, index):
        return self.metrics[index]

    def update_dict(self, labels, preds):
        for metric in self.metrics:
            metric.update_dict(labels, preds)

    def update(self, labels, preds):
        for metric in self.metrics:
            metric.update(labels, preds)

    def reset(self):
        for metric in getattr(self, "metrics", []):
            metric.reset()

    def get(self):
        names, values = [], []
        for metric in self.metrics:
            name, value = metric.get()
            if isinstance(name, str):
                name = [name]
            if isinstance(value, (float, int)):
                value = [value]
            names.extend(name)
            values.extend(value)
        return (names, values)


# short aliases like the reference
_REGISTRY["acc"] = Accuracy
_REGISTRY["top_k_accuracy"] = TopKAccuracy
_REGISTRY["top_k_acc"] = TopKAccuracy
_REGISTRY["ce"] = CrossEntropy
_REGISTRY["nll_loss"] = NegativeLogLikelihood
_REGISTRY["pearsonr"] = PearsonCorrelation
