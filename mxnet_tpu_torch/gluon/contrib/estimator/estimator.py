"""The Gluon ``Estimator``, from
``mxnet_tpu/gluon/contrib/estimator/estimator.py``: ``fit`` and
``evaluate`` over a net, a Gluon loss and a ``gluon.Trainer`` (Adam at
1e-3 unless one is given), with the event handlers of
``event_handler.py``.

``fit`` adds the default handlers the JAX ``fit`` adds, in its order: a
``StoppingHandler`` (the ``epochs`` / ``batches`` budget), a
``MetricHandler`` over the train metrics and the train loss, a
``ValidationHandler`` when ``val_data`` is given and a
``LoggingHandler``; then every handler is sorted by its ``priority``
(metrics and validation -1000, logging 1000, the rest 0).  Each batch is
``autograd.record()`` -> forward -> loss -> ``backward`` ->
``trainer.step(batch size along batch_axis)``.  A batch is a
``DataBatch`` or a (data, label) pair; a pair not yet on a device goes
to the estimator's ``context``.
"""
from __future__ import annotations

from ....base import MXNetError
from ....context import current_context
from ....metric import Accuracy, EvalMetric, Loss
from ... import Trainer
from ...loss import Loss as GluonLoss
from .event_handler import (BatchBegin, BatchEnd, EpochBegin, EpochEnd,
                            LoggingHandler, MetricHandler, StoppingHandler,
                            TrainBegin, TrainEnd, ValidationHandler)

__all__ = ["Estimator"]


class Estimator:
    """Train and evaluate a Gluon net with pluggable event handlers."""

    def __init__(self, net, loss, metrics=None, initializer=None,
                 trainer=None, context=None):
        self.net = net
        if not isinstance(loss, GluonLoss):
            raise MXNetError("loss must be a gluon Loss instance")
        self.loss = loss
        if metrics is None:
            metrics = [Accuracy()]
        elif isinstance(metrics, EvalMetric):
            metrics = [metrics]
        self.train_metrics = list(metrics)
        self.train_loss_metric = Loss(f"train {type(loss).__name__.lower()}")
        # independent deep copies (name, axis, every setting kept), so
        # validation updates never mix into the train metrics
        import copy

        self.val_metrics = [copy.deepcopy(m) for m in self.train_metrics]
        for m in self.val_metrics:
            m.reset()
        self.val_loss_metric = Loss(f"val {type(loss).__name__.lower()}")

        self.context = context or current_context()
        params = self.net.collect_params()
        # no-op on already-initialized parameters (initialize only touches
        # uninitialized params unless force_reinit)
        self.net.initialize(init=initializer, ctx=self.context)
        self.trainer = trainer or Trainer(params, "adam",
                                          {"learning_rate": 1e-3})

    # ------------------------------------------------------------------
    def _batch_arrays(self, batch):
        from .... import ndarray as nd

        if hasattr(batch, "data"):  # DataBatch
            return batch.data[0], batch.label[0]
        data, label = batch[0], batch[1]
        if not hasattr(data, "context"):
            data = nd.array(data, ctx=self.context)
        if not hasattr(label, "context"):
            label = nd.array(label, ctx=self.context)
        return data, label

    def evaluate(self, val_data, batch_axis=0):
        """Run validation, updating the val metrics; returns {name:
        value}."""
        for metric in self.val_metrics:
            metric.reset()
        self.val_loss_metric.reset()
        for batch in val_data:
            data, label = self._batch_arrays(batch)
            pred = self.net(data)
            loss = self.loss(pred, label)
            for metric in self.val_metrics:
                metric.update(label, pred)
            self.val_loss_metric.update(0, loss)
        if hasattr(val_data, "reset"):
            val_data.reset()
        return {m.get()[0]: m.get()[1]
                for m in self.val_metrics + [self.val_loss_metric]}

    def fit(self, train_data, val_data=None, epochs=None, event_handlers=None,
            batches=None, batch_axis=0):
        """Train for ``epochs`` (or ``batches``) with the event
        handlers."""
        from .... import autograd

        if epochs is None and batches is None:
            epochs = 1
        handlers = self._prepare_handlers(val_data, event_handlers,
                                          epochs, batches)
        train_begin, epoch_begin, batch_begin, batch_end, epoch_end, \
            train_end = self._categorize(handlers)
        stop_handlers = [h for h in handlers
                         if hasattr(h, "stop_training")]

        for h in train_begin:
            h.train_begin(self)
        stop = any(h.stop_training for h in stop_handlers)
        while not stop:
            for h in epoch_begin:
                h.epoch_begin(self)
            for batch in train_data:
                for h in batch_begin:
                    h.batch_begin(self, batch=batch)
                data, label = self._batch_arrays(batch)
                with autograd.record():
                    pred = self.net(data)
                    loss = self.loss(pred, label)
                loss.backward()
                batch_size = data.shape[batch_axis]
                self.trainer.step(batch_size)
                self.train_loss_metric.update(0, loss)
                for h in batch_end:
                    h.batch_end(self, batch=batch, pred=pred, label=label,
                                loss=loss)
                if any(h.stop_training for h in stop_handlers):
                    stop = True
                    break
            if hasattr(train_data, "reset"):
                train_data.reset()
            for h in epoch_end:
                h.epoch_end(self)
            if any(h.stop_training for h in stop_handlers):
                stop = True
        for h in train_end:
            h.train_end(self)

    # ------------------------------------------------------------------
    def _prepare_handlers(self, val_data, event_handlers, epochs, batches):
        handlers = list(event_handlers or [])
        if not any(isinstance(h, StoppingHandler) for h in handlers):
            handlers.append(StoppingHandler(max_epoch=epochs,
                                            max_batch=batches))
        if not any(isinstance(h, MetricHandler) for h in handlers):
            handlers.append(MetricHandler(
                self.train_metrics + [self.train_loss_metric]))
        if val_data is not None and not any(
                isinstance(h, ValidationHandler) for h in handlers):
            handlers.append(ValidationHandler(val_data, self.evaluate))
        if not any(isinstance(h, LoggingHandler) for h in handlers):
            handlers.append(LoggingHandler(
                metrics=self.train_metrics + [self.train_loss_metric]))
        handlers.sort(key=lambda h: getattr(h, "priority", 0))
        return handlers

    def _categorize(self, handlers):
        return ([h for h in handlers if isinstance(h, TrainBegin)],
                [h for h in handlers if isinstance(h, EpochBegin)],
                [h for h in handlers if isinstance(h, BatchBegin)],
                [h for h in handlers if isinstance(h, BatchEnd)],
                [h for h in handlers if isinstance(h, EpochEnd)],
                [h for h in handlers if isinstance(h, TrainEnd)])
