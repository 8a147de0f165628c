"""Continuous-batching request scheduler.

Counterpart of ``mxnet_tpu/serving/scheduler.py`` (the prefix cache is
not ported yet).  Requests enter a bounded FIFO queue and are admitted
into fixed decode *slots* BETWEEN decode steps: a finished request frees
its slot (and its KV pages) at the next stream boundary and a waiting
request joins mid-flight.  The queue bound (``MX_SERVE_QUEUE``) is the
backpressure surface: a full queue rejects loudly.

Policy is plain FCFS: requests admit in arrival order while (a) a slot is
free and (b) the paged KV pool can grant at least one page.
"""
from __future__ import annotations

import itertools
from collections import deque
from typing import List, Optional

import numpy as np

from ..base import MXNetError, env_int

__all__ = ["Request", "TokenStream", "ContinuousBatchingScheduler",
           "queue_bound"]

_ids = itertools.count()


def queue_bound() -> int:
    """Request-queue bound, re-read from ``MX_SERVE_QUEUE`` per call
    (default 256; 0 = unbounded)."""
    return max(0, env_int("MX_SERVE_QUEUE", 256))


class TokenStream:
    """Per-request output: tokens append as the engine reads them back
    at stream cadence; ``finished`` flips when the request completes
    (EOS or token budget)."""

    def __init__(self):
        self.tokens: List[int] = []
        self.finished = False
        self.finish_reason: Optional[str] = None

    def append(self, tok: int) -> None:
        self.tokens.append(int(tok))

    def finish(self, reason: str) -> None:
        self.finished = True
        self.finish_reason = reason

    def asarray(self) -> np.ndarray:
        return np.asarray(self.tokens, np.int32)

    def __len__(self):
        return len(self.tokens)


class Request:
    """One greedy decode request.

    ``tokens`` is the prompt — the source sentence for the seq2seq
    Transformer (prefill = encode).  Generation starts from ``bos_id``
    and stops at ``eos_id`` or after ``max_new_tokens``.
    ``preemptions`` counts the engine's recompute preemptions."""

    def __init__(self, tokens, max_new_tokens: int, bos_id: int,
                 eos_id: int, request_id: Optional[str] = None):
        self.tokens = np.asarray(tokens, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        self.bos_id = int(bos_id)
        self.eos_id = int(eos_id)
        self.id = request_id if request_id is not None \
            else f"req{next(_ids)}"
        self.stream = TokenStream()
        self.preemptions = 0

    def __repr__(self):
        return (f"<Request {self.id} prompt={len(self.tokens)} "
                f"max_new={self.max_new_tokens} out={len(self.stream)}"
                f"{' done' if self.stream.finished else ''}>")


class ContinuousBatchingScheduler:
    """Bounded FIFO of waiting requests + the admission policy."""

    def __init__(self, bound: Optional[int] = None):
        self._bound = bound
        self._q: deque = deque()

    @property
    def bound(self) -> int:
        return queue_bound() if self._bound is None else self._bound

    @property
    def depth(self) -> int:
        return len(self._q)

    def submit(self, request: Request) -> Request:
        """Enqueue a request; raises MXNetError when the queue is full."""
        bound = self.bound
        if bound and len(self._q) >= bound:
            raise MXNetError(
                f"serving queue full ({len(self._q)}/{bound} waiting): "
                "raise MX_SERVE_QUEUE or shed load upstream")
        self._q.append(request)
        return request

    def requeue(self, request: Request) -> None:
        """Return a preempted request to the HEAD of the queue; the bound
        does not apply (preemption is the engine's doing)."""
        self._q.appendleft(request)

    def pop_ready(self, free_slots: int, pages_free: int) -> List[Request]:
        """FCFS admissions for this stream boundary: up to ``free_slots``
        requests, stopping when the pool cannot grant a first page to the
        next head-of-line request (no skip-ahead)."""
        out: List[Request] = []
        budget = pages_free
        while self._q and len(out) < free_slots and budget >= 1:
            out.append(self._q.popleft())
            budget -= 1  # the first page; later pages grow per burst
        return out
