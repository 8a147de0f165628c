"""Training callbacks (counterpart of ``mxnet_tpu/callback.py``):
``do_checkpoint``, ``log_train_metric``, ``Speedometer``, ``ProgressBar``,
``LogValidationMetricsCallback``.  ``Speedometer`` also records each report
in the port's ``telemetry`` when the recorder is on."""
from __future__ import annotations

import logging
import time

__all__ = ["Speedometer", "do_checkpoint", "log_train_metric",
           "ProgressBar", "LogValidationMetricsCallback"]


def do_checkpoint(prefix, period=1):
    """Epoch-end callback saving module checkpoints (reference ~L30)."""
    from . import model

    period = int(max(1, period))

    def _callback(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            model.save_checkpoint(prefix, iter_no + 1, sym, arg, aux)

    return _callback


def log_train_metric(period, auto_reset=False):
    def _callback(param):
        if param.nbatch % period == 0 and param.eval_metric is not None:
            name_value = param.eval_metric.get_name_value()
            for name, value in name_value:
                logging.info("Iter[%d] Batch[%d] Train-%s=%f", param.epoch,
                             param.nbatch, name, value)
            if auto_reset:
                param.eval_metric.reset()

    return _callback


class Speedometer:
    """Log training speed + metrics every `frequent` batches (reference ~L100).

    Speed math uses time.perf_counter(), not time.time(): wall-clock is not
    monotonic (NTP slews, manual clock steps), and a backwards step across
    the measurement window produced negative or absurd samples/sec.  When
    the telemetry recorder is active, each report is also recorded there.

    Lazy-loss aware: when ``param.loss`` carries an async handle
    (``parallel.AsyncLoss`` / an unforced array), it is forced to a host
    scalar ONLY here, at display cadence — a training loop feeding the
    Speedometer never pays a per-step device round-trip for logging.
    """

    def __init__(self, batch_size, frequent=50, auto_reset=True):
        self.batch_size = batch_size
        self.frequent = frequent
        self.init = False
        self.tic = 0
        self.last_count = 0
        self.auto_reset = auto_reset

    def __call__(self, param):
        from . import telemetry

        count = param.nbatch
        if self.last_count > count:
            self.init = False
        self.last_count = count

        if self.init:
            if count % self.frequent == 0:
                speed = (self.frequent * self.batch_size
                         / (time.perf_counter() - self.tic))
                # the ONLY place the (possibly async) loss is forced
                loss = getattr(param, "loss", None)
                loss_txt = ""
                if loss is not None:
                    import numpy as _np

                    loss_txt = "\tloss=%f" % float(
                        _np.asarray(loss).mean())
                if telemetry.enabled():
                    telemetry.record("speedometer", epoch=param.epoch,
                                     batch=count,
                                     samples_per_sec=round(speed, 2))
                if param.eval_metric is not None:
                    name_value = param.eval_metric.get_name_value()
                    if self.auto_reset:
                        param.eval_metric.reset()
                    msg = "Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                    msg += "\t%s=%f" * len(name_value)
                    logging.info(msg + loss_txt, param.epoch, count, speed,
                                 *sum(name_value, ()))
                else:
                    logging.info(
                        "Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                        + loss_txt, param.epoch, count, speed)
                self.tic = time.perf_counter()
        else:
            self.init = True
            self.tic = time.perf_counter()


class ProgressBar:
    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        count = param.nbatch
        filled_len = int(round(self.bar_len * count / float(self.total)))
        percents = int(round(100.0 * count / float(self.total)))
        prog_bar = "=" * filled_len + "-" * (self.bar_len - filled_len)
        logging.info("[%s] %s%s", prog_bar, percents, "%")


class LogValidationMetricsCallback:
    def __call__(self, param):
        if param.eval_metric is None:
            return
        for name, value in param.eval_metric.get_name_value():
            logging.info("Epoch[%d] Validation-%s=%f", param.epoch, name, value)
