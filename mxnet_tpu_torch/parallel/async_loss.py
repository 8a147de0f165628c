"""Lazy loss handles and the bounded in-flight dispatch window.

Counterpart of ``mxnet_tpu/parallel/async_loss.py``.  torch queues each
card's work on a stream and returns at once, so a training loop that does
not read its loss back never waits on the card; what bounds the host is
this module:

  * :class:`AsyncLoss` -- the lazy handle ``DataParallelStep.step()``
    returns: the loss as a device scalar and, on a CUDA device, a
    ``torch.cuda.Event`` recorded on the current stream behind the step's
    work.  ``float()`` / ``.asnumpy()`` / ``.wait()`` synchronize on the
    event and read the value once.
  * :class:`StepFence` -- the same for executors that update buffers in
    place and have no scalar (``gluon.Trainer``, ``module.Module``): it
    records an event on each card the update ran on and holds no tensor.
  * :class:`InflightRing` -- the window.  ``MX_ASYNC_INFLIGHT`` (default
    2) caps how many dispatched, unforced steps may be pending; admitting
    one more first waits on the oldest.  ``MX_ASYNC_INFLIGHT=0`` forces
    every step at dispatch.
  * :func:`drain_all` -- force every pending handle in the process; the
    preemption handler (``fault.install_preemption_handler``) calls it
    before its final snapshot.

The window changes when the host sees results, never what is computed:
losses and weights are bit for bit the same at every window size.  A
failure that surfaces when a handle is forced (a CUDA error is raised by
the next synchronization, not at dispatch) is re-raised as an
``MXNetError`` naming the step that dispatched the work.  Failures in the
step's Python code raise at dispatch, where they happen (the JAX step
defers what its compiled program raises).  The JAX module's superstep
handles (``StackedAsyncLoss``, ``SuperstepLossView``) wait with A.1's
captured step (ROADMAP A.6).
"""
from __future__ import annotations

import contextlib
import os
import threading
import time
import weakref
from collections import deque
from typing import Optional

import numpy as np
import torch

from .. import memwatch
from .. import telemetry
from ..base import MXNetError

__all__ = ["AsyncLoss", "AsyncResult", "StepFence", "InflightRing",
           "inflight_limit", "drain_all"]

_DEFAULT_INFLIGHT = 2

# every ring in the process, so the preemption path can drain pending work
# it never saw dispatched (weak: a dropped step is not kept alive)
_live_rings: "weakref.WeakSet[InflightRing]" = weakref.WeakSet()
_rings_lock = threading.Lock()


def inflight_limit() -> int:
    """The window size, re-read from ``MX_ASYNC_INFLIGHT`` on every call;
    0 means synchronous (force at dispatch)."""
    try:
        return max(0, int(os.environ.get("MX_ASYNC_INFLIGHT",
                                         _DEFAULT_INFLIGHT)))
    except (TypeError, ValueError):
        return _DEFAULT_INFLIGHT


def _record_event(device: torch.device):
    """An event recorded on ``device``'s current stream, behind the work
    queued there; None off the card."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


class _PendingHandle:
    """One dispatched, unforced step.  Subclasses define ``_force()``."""

    def __init__(self, step: int, executor: str,
                 ring: Optional["InflightRing"] = None):
        self._step = int(step)
        self._executor = executor
        self._ring = ring
        self._forced = False
        self._host = None
        self._exc: Optional[BaseException] = None

    @property
    def step(self) -> int:
        """The step number at dispatch (names the step in errors)."""
        return self._step

    @property
    def forced(self) -> bool:
        return self._forced

    def _force(self):
        raise NotImplementedError

    def wait(self, _span: bool = True):
        """Block until the step's result is on the host and return it;
        re-raise (wrapped, naming the dispatching step) what forcing it
        raised.  Later calls return the cached value (or raise again).
        ``_span=False`` skips the ``loss_wait`` span for a caller that
        records the same interval under its own span."""
        if self._forced:
            if self._exc is not None:
                raise self._exc
            return self._host
        with (telemetry.span("loss_wait", paired=True,
                             executor=self._executor, step=self._step)
              if _span else contextlib.nullcontext()):
            t0 = time.perf_counter()
            try:
                self._host = self._force()
                return self._host
            except Exception as exc:
                if memwatch.is_resource_exhausted(exc):
                    memwatch.emit_oom_report(
                        executor=self._executor, step=self._step,
                        inflight_depth=(self._ring.depth
                                        if self._ring is not None else 0))
                self._exc = MXNetError(
                    f"async step {self._step} dispatched by "
                    f"{self._executor} failed at deferred readback: {exc}")
                raise self._exc from exc
            finally:
                self._forced = True
                if self._ring is not None:
                    self._ring.discard(self)
                telemetry.record_block_wait(self._executor,
                                            time.perf_counter() - t0)

    def __repr__(self):
        state = "forced" if self._forced else "pending"
        return (f"<{type(self).__name__} step={self._step} "
                f"executor={self._executor!r} {state}>")


class AsyncLoss(_PendingHandle):
    """Lazy scalar loss.  ``float()``, ``np.asarray()``, ``.asnumpy()``,
    ``.asscalar()``, ``.item()`` and ``.wait()`` all force the readback."""

    def __init__(self, value, step: int = 0, executor: str = "",
                 ring: Optional["InflightRing"] = None, host_fn=None):
        super().__init__(step, executor, ring)
        if isinstance(value, torch.Tensor):
            value = value.detach()
            self._event = _record_event(value.device)
        else:
            self._event = None
        self._value = value
        self._host_fn = host_fn

    def _force(self):
        value, self._value = self._value, None  # drop the device reference
        event, self._event = self._event, None
        if event is not None:
            event.synchronize()
        if self._host_fn is not None:
            value = self._host_fn(value)
        if isinstance(value, torch.Tensor):
            if value.dtype == torch.bfloat16:
                value = value.float()
            value = value.cpu().numpy()
        return np.asarray(value)

    def asnumpy(self) -> np.ndarray:
        return np.asarray(self.wait())

    def asscalar(self):
        return self.asnumpy().item()

    def item(self):
        return self.asscalar()

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    def __bool__(self):
        return bool(self.asscalar())

    def __array__(self, dtype=None, *args, **kwargs):
        out = self.asnumpy()
        return out if dtype is None else out.astype(dtype)


class AsyncResult(AsyncLoss):
    """A lazy device-to-host handle over any tensor, with the forcing,
    ring and error rules of :class:`AsyncLoss`; the result is the raw
    ``np.ndarray``."""


class StepFence(_PendingHandle):
    """A pending handle over in-place buffer updates: an event recorded on
    each card that ``arrays`` (tensors or NDArrays) live on, behind the
    update; waiting synchronizes on them.  It holds no tensor."""

    def __init__(self, arrays, step: int, executor: str,
                 ring: Optional["InflightRing"] = None):
        super().__init__(step, executor, ring)
        devices = {a.device if isinstance(a, torch.Tensor) else a._ctx
                   for a in arrays}
        self._events = [ev for ev in map(_record_event, devices)
                        if ev is not None]

    def _force(self):
        events, self._events = self._events, []
        for ev in events:
            ev.synchronize()
        return None


def _pending_arrays(ring):
    """memwatch provider: the device scalars unforced handles hold."""
    with ring._lock:
        handles = list(ring._pending)
    return [v for v in (getattr(h, "_value", None) for h in handles)
            if isinstance(v, torch.Tensor)]


class InflightRing:
    """Bounded ring of pending handles for one executor.

    ``make_room(limit)`` waits (oldest first) until fewer than ``limit``
    handles are pending -- the only place the pipeline waits.  ``admit()``
    registers a freshly dispatched handle and returns the depth, which
    telemetry reports as ``inflight_depth``."""

    def __init__(self, executor: str):
        self._executor = executor
        self._pending: deque = deque()
        self._lock = threading.Lock()
        with _rings_lock:
            _live_rings.add(self)
        memwatch.register("inflight", self, _pending_arrays)

    def discard(self, handle) -> None:
        """Drop a handle the consumer forced out of band (``float(loss)``)."""
        with self._lock:
            try:
                self._pending.remove(handle)
            except ValueError:
                pass

    def _oldest_over(self, limit: int):
        with self._lock:
            while self._pending and self._pending[0].forced:
                self._pending.popleft()
            if len(self._pending) < max(1, limit):
                return None
            return self._pending[0]

    def make_room(self, limit: int, wait_span: bool = True) -> float:
        """Make a free slot; returns the seconds spent waiting (0.0 when
        the ring was not full).  ``wait_span=False`` suppresses the inner
        waits' ``loss_wait`` spans for a caller that records the returned
        interval as its own ``block_wait`` span."""
        waited = 0.0
        while True:
            oldest = self._oldest_over(limit)
            if oldest is None:
                return waited
            t0 = time.perf_counter()
            oldest.wait(_span=wait_span)  # discards itself from the ring
            waited += time.perf_counter() - t0

    def admit(self, handle) -> int:
        with self._lock:
            self._pending.append(handle)
            return len(self._pending)

    @property
    def depth(self) -> int:
        with self._lock:
            return sum(1 for h in self._pending if not h.forced)

    def drain(self) -> None:
        """Force every pending handle, oldest first (epoch end, shutdown,
        checkpoint); raises the first deferred failure it hits."""
        if self.depth == 0:
            return
        with telemetry.span("inflight_drain", paired=True,
                            executor=self._executor):
            while True:
                with self._lock:
                    while self._pending and self._pending[0].forced:
                        self._pending.popleft()
                    if not self._pending:
                        return
                    oldest = self._pending[0]
                oldest.wait()


def drain_all():
    """Drain every live ring in the process (the preemption path).
    Best effort: deferred failures are collected and returned, not
    raised -- the caller is about to snapshot and exit.  (The JAX function
    first flushes buffered superstep groups; the port has none.)"""
    errors = []
    with _rings_lock:
        rings = list(_live_rings)
    for ring in rings:
        try:
            ring.drain()
        except Exception as exc:  # noqa: BLE001 — survey, don't die
            errors.append(exc)
    return errors
