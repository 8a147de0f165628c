"""The Estimator's event handlers, from
``mxnet_tpu/gluon/contrib/estimator/event_handler.py``: the six event
mixins (``TrainBegin`` ... ``BatchEnd``) and ``StoppingHandler``,
``MetricHandler``, ``ValidationHandler``, ``LoggingHandler`` (logger
``mxnet_tpu_torch.estimator``), ``CheckpointHandler`` (``<prefix>-epochN``
/ ``-batchN`` / ``-best`` ``.params`` through ``save_parameters`` and
``.states`` through ``Trainer.save_states``, at most ``max_checkpoints``
kept, resumable) and ``EarlyStoppingHandler``."""
from __future__ import annotations

import logging
import os
import time

__all__ = ["TrainBegin", "TrainEnd", "EpochBegin", "EpochEnd", "BatchBegin",
           "BatchEnd", "StoppingHandler", "MetricHandler",
           "ValidationHandler", "LoggingHandler", "CheckpointHandler",
           "EarlyStoppingHandler"]


class TrainBegin:
    def train_begin(self, estimator, *args, **kwargs):
        pass


class TrainEnd:
    def train_end(self, estimator, *args, **kwargs):
        pass


class EpochBegin:
    def epoch_begin(self, estimator, *args, **kwargs):
        pass


class EpochEnd:
    def epoch_end(self, estimator, *args, **kwargs):
        pass


class BatchBegin:
    def batch_begin(self, estimator, *args, **kwargs):
        pass


class BatchEnd:
    def batch_end(self, estimator, *args, **kwargs):
        pass


class StoppingHandler(TrainBegin, BatchEnd, EpochEnd):
    """Stop training at max_epoch or max_batch."""

    def __init__(self, max_epoch=None, max_batch=None):
        self.max_epoch = max_epoch
        self.max_batch = max_batch
        self.current_batch = 0
        self.current_epoch = 0
        self.stop_training = False

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0
        # a zero budget means "don't train" (e.g. resume-and-evaluate)
        self.stop_training = self.max_epoch == 0 or self.max_batch == 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.max_batch is not None and self.current_batch >= self.max_batch:
            self.stop_training = True

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.max_epoch is not None and self.current_epoch >= self.max_epoch:
            self.stop_training = True


class MetricHandler(EpochBegin, BatchEnd):
    """Reset metrics at epoch start, update per batch."""

    def __init__(self, metrics):
        self.metrics = metrics or []
        self.priority = -1000

    def epoch_begin(self, estimator, *args, **kwargs):
        for metric in self.metrics:
            metric.reset()

    def batch_end(self, estimator, *args, **kwargs):
        pred = kwargs["pred"]
        label = kwargs["label"]
        loss = kwargs["loss"]
        from ....metric import Loss

        for metric in self.metrics:
            if isinstance(metric, Loss):
                metric.update(0, loss)
            else:
                metric.update(label, pred)


class ValidationHandler(TrainBegin, BatchEnd, EpochEnd):
    """Run validation on an interval."""

    def __init__(self, val_data, eval_fn, epoch_period=1, batch_period=None,
                 priority=-1000):
        self.val_data = val_data
        self.eval_fn = eval_fn
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.current_batch = 0
        self.current_epoch = 0
        self.priority = priority

    def train_begin(self, estimator, *args, **kwargs):
        self.current_batch = 0
        self.current_epoch = 0

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and self.current_batch % self.batch_period == 0:
            self.eval_fn(val_data=self.val_data)

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self.eval_fn(val_data=self.val_data)


class LoggingHandler(TrainBegin, TrainEnd, EpochBegin, EpochEnd, BatchEnd):
    """Periodic train logging."""

    def __init__(self, log_interval="epoch", metrics=None):
        self.log_interval = log_interval
        self.metrics = metrics or []
        self.batch_index = 0
        self.current_epoch = 0
        self.processed_samples = 0
        self.logger = logging.getLogger("mxnet_tpu_torch.estimator")
        self.priority = 1000

    def train_begin(self, estimator, *args, **kwargs):
        self.train_start = time.perf_counter()
        self.logger.info("Training begin")

    def train_end(self, estimator, *args, **kwargs):
        t = time.perf_counter() - self.train_start
        self.logger.info("Training finished in %.3fs", t)

    def epoch_begin(self, estimator, *args, **kwargs):
        self.epoch_start = time.perf_counter()
        self.batch_index = 0
        self.processed_samples = 0

    def epoch_end(self, estimator, *args, **kwargs):
        t = time.perf_counter() - self.epoch_start
        msg = f"Epoch[{self.current_epoch}] finished in {t:.3f}s: "
        for m in self.metrics:
            name, value = m.get()
            msg += f"{name}: {value:.4f} "
        self.logger.info(msg)
        self.current_epoch += 1

    def batch_end(self, estimator, *args, **kwargs):
        if isinstance(self.log_interval, int):
            batch = kwargs.get("batch")
            if batch is not None:
                self.processed_samples += batch.data[0].shape[0] \
                    if hasattr(batch, "data") else len(batch[0])
            self.batch_index += 1
            if self.batch_index % self.log_interval == 0:
                msg = f"Epoch[{self.current_epoch}] Batch[{self.batch_index}] "
                for m in self.metrics:
                    name, value = m.get()
                    msg += f"{name}: {value:.4f} "
                self.logger.info(msg)


class CheckpointHandler(TrainBegin, BatchEnd, EpochEnd):
    """Save model (and trainer states) periodically; optionally keep only
    the best by a monitored metric."""

    def __init__(self, model_dir, model_prefix="model", monitor=None,
                 verbose=0, save_best=False, mode="auto", epoch_period=1,
                 batch_period=None, max_checkpoints=5,
                 resume_from_checkpoint=False):
        self.model_dir = model_dir
        self.model_prefix = model_prefix
        self.monitor = monitor
        self.verbose = verbose
        self.save_best = save_best
        self.epoch_period = epoch_period
        self.batch_period = batch_period
        self.max_checkpoints = max_checkpoints
        self.resume_from_checkpoint = resume_from_checkpoint
        self.current_epoch = 0
        self.current_batch = 0
        self.best = None
        self._saved = []  # rolling (non-best) checkpoint prefixes
        self.logger = logging.getLogger("mxnet_tpu_torch.estimator")
        if mode == "min" or (mode == "auto" and monitor is not None
                             and "loss" in monitor.get()[0]):
            self._improved = lambda new, best: new < best
        else:
            self._improved = lambda new, best: new > best

    def train_begin(self, estimator, *args, **kwargs):
        import glob
        import re

        os.makedirs(self.model_dir, exist_ok=True)
        self.current_epoch = 0
        self.current_batch = 0
        self._saved = []
        if self.resume_from_checkpoint:
            # adopt pre-existing rolling checkpoints so pruning and epoch
            # numbering continue instead of restarting (a fresh run in the
            # same dir must NOT adopt: pruning would delete its own saves)
            existing = sorted(
                (c for c in glob.glob(os.path.join(
                    self.model_dir, f"{self.model_prefix}-*.params"))
                 if not c.endswith("-best.params")), key=os.path.getmtime)
            self._saved = [c[:-len(".params")] for c in existing]
            latest = self._latest_checkpoint()
            if latest is not None:
                estimator.net.load_parameters(latest + ".params")
                if (estimator.trainer is not None
                        and os.path.exists(latest + ".states")):
                    estimator.trainer.load_states(latest + ".states")
                # continue epoch numbering from the LOADED checkpoint's
                # tag; if the newest file is a batch-period checkpoint,
                # use the MOST RECENTLY WRITTEN epoch tag (mtime order, not
                # max number: stale higher-epoch files from an older run
                # must not win)
                m = re.search(r"epoch(\d+)$", latest)
                if m:
                    self.current_epoch = int(m.group(1))
                else:
                    stamped = [
                        (os.path.getmtime(c + ".params"), int(em.group(1)))
                        for c in self._saved
                        for em in [re.search(r"epoch(\d+)$", c)] if em]
                    if stamped:
                        self.current_epoch = max(stamped)[1]
                if self.verbose:
                    self.logger.info("resumed from %s", latest)

    def _latest_checkpoint(self):
        import glob

        cands = glob.glob(os.path.join(
            self.model_dir, f"{self.model_prefix}-*.params"))
        cands = [c for c in cands if not c.endswith("-best.params")]
        if not cands:
            return None
        return max(cands, key=os.path.getmtime)[:-len(".params")]

    def _save(self, estimator, tag):
        prefix = os.path.join(self.model_dir, f"{self.model_prefix}-{tag}")
        estimator.net.save_parameters(prefix + ".params")
        if estimator.trainer is not None:
            estimator.trainer.save_states(prefix + ".states")
        if self.verbose:
            self.logger.info("saved checkpoint %s", prefix)
        if tag != "best":
            self._saved.append(prefix)
            while (self.max_checkpoints
                   and len(self._saved) > self.max_checkpoints):
                old = self._saved.pop(0)
                for suffix in (".params", ".states"):
                    try:
                        os.remove(old + suffix)
                    except OSError:
                        pass

    def batch_end(self, estimator, *args, **kwargs):
        self.current_batch += 1
        if self.batch_period and self.current_batch % self.batch_period == 0:
            self._save(estimator, f"batch{self.current_batch}")

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        if self.epoch_period and self.current_epoch % self.epoch_period == 0:
            self._save(estimator, f"epoch{self.current_epoch}")
        if self.save_best and self.monitor is not None:
            _, value = self.monitor.get()
            if self.best is None or self._improved(value, self.best):
                self.best = value
                self._save(estimator, "best")


class EarlyStoppingHandler(TrainBegin, EpochEnd, TrainEnd):
    """Stop when a monitored metric stops improving."""

    def __init__(self, monitor, min_delta=0, patience=0, mode="auto",
                 baseline=None):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.baseline = baseline
        self.wait = 0
        self.stopped_epoch = 0
        self.current_epoch = 0
        self.stop_training = False
        name = monitor.get()[0] if monitor is not None else ""
        if mode == "min" or (mode == "auto" and "loss" in name):
            self._improved = lambda new, best: new < best - min_delta
        else:
            self._improved = lambda new, best: new > best + min_delta
        self.best = baseline

    def train_begin(self, estimator, *args, **kwargs):
        self.wait = 0
        self.stop_training = False
        self.current_epoch = 0
        self.stopped_epoch = 0
        self.best = self.baseline  # a second fit() starts fresh

    def epoch_end(self, estimator, *args, **kwargs):
        self.current_epoch += 1
        _, value = self.monitor.get()
        if self.best is None or self._improved(value, self.best):
            self.best = value
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                self.stopped_epoch = self.current_epoch
                self.stop_training = True

    def train_end(self, estimator, *args, **kwargs):
        if self.stopped_epoch:
            logging.getLogger("mxnet_tpu_torch.estimator").info(
                "Early stopping at epoch %d", self.stopped_epoch)
