"""Continuous-batching request scheduler.

Counterpart of ``mxnet_tpu/serving/scheduler.py``.  Requests enter a
bounded FIFO queue and are admitted into fixed decode *slots* BETWEEN
decode steps: a finished request frees its slot (and its KV pages) at the
next stream boundary and a waiting request joins mid-flight.  The queue
bound (``MX_SERVE_QUEUE``) is the backpressure surface: a full queue
rejects loudly.

Policy is plain FCFS: requests admit in arrival order while (a) a slot is
free and (b) the paged KV pool can grant at least one page.

:func:`prefix_key` and :class:`PrefixCache` index the engine's reusable
prefill work (copy-on-write prefix pages and cached encoder rows); the
keys are content hashes, equal to the JAX package's for the same parts.
"""
from __future__ import annotations

import hashlib
import itertools
import time
from collections import OrderedDict, deque
from typing import List, Optional

import numpy as np

from ..base import MXNetError, env_int

__all__ = ["Request", "TokenStream", "ContinuousBatchingScheduler",
           "queue_bound", "PrefixCache", "prefix_key"]

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

    def __iter__(self):
        return iter(self.tokens)


class Request:
    """One decode request.

    ``tokens`` is the prompt — the source sentence for the seq2seq
    Transformer (prefill = encode).  Generation starts from ``bos_id``
    and stops at ``eos_id`` or after ``max_new_tokens``.

    Sampling: ``temperature`` 0.0 (the default) is greedy, token for
    token the greedy engine's; > 0 samples from the temperature-scaled
    distribution, truncated by ``top_k`` (0 = off) and nucleus ``top_p``
    (1.0 = off).  ``seed`` pins the request's random stream: the same
    request with the same seed gives the same tokens across engines,
    restarts, slot assignments and preemptions (the stream is a function
    of the seed and the decode position only).

    ``prefix`` (optional int32 tokens) is a forced decoder prefix: the
    engine teacher-forces it into the slot's KV pages before free decode
    starts and, with the prefix cache on, shares those pages between
    requests with the same (source, bos, prefix).  ``session``,
    ``trace_id``, ``parent_span_id`` and ``sampled`` are the JAX
    request's routing and trace context, carried as given.

    Breadcrumbs the engine stamps: ``preemptions`` (recompute
    preemptions), ``prefix_hit`` (None = no prefix-cache lookup) and
    ``generation_at_admit``.  SLO stamps (``time.perf_counter``):
    ``t_submit``, ``t_queue_start`` (the start of the current queue
    residence, re-stamped by a requeue), ``t_admit``, ``t_first_token``
    (the stream boundary that read the first token back), ``prefill_ms``
    and ``queue_ms_acc`` (queue residence summed over admissions)."""

    def __init__(self, tokens, max_new_tokens: int, bos_id: int,
                 eos_id: int, request_id: Optional[str] = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: Optional[int] = None,
                 prefix=None, session: Optional[str] = None,
                 trace_id: Optional[str] = None, parent_span_id: int = 0,
                 sampled: bool = True):
        self.tokens = np.asarray(tokens, np.int32).reshape(-1)
        self.max_new_tokens = int(max_new_tokens)
        if self.max_new_tokens < 1:
            raise MXNetError("max_new_tokens must be >= 1")
        self.bos_id = int(bos_id)
        self.eos_id = int(eos_id)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        if self.temperature < 0.0:
            raise MXNetError("temperature must be >= 0 (0 = greedy)")
        if self.top_k < 0:
            raise MXNetError("top_k must be >= 0 (0 = off)")
        if not (0.0 < self.top_p <= 1.0):
            raise MXNetError("top_p must be in (0, 1] (1.0 = off)")
        self.seed = None if seed is None else int(seed)
        self.prefix = (np.zeros((0,), np.int32) if prefix is None
                       else np.asarray(prefix, np.int32).reshape(-1))
        self.session = session
        self.trace_id = trace_id
        self.parent_span_id = int(parent_span_id)
        self.sampled = bool(sampled)
        self.preemptions = 0
        self.prefix_hit: Optional[bool] = None
        self.generation_at_admit: Optional[int] = None
        self.id = request_id if request_id is not None \
            else f"req{next(_ids)}"
        self.stream = TokenStream()
        self.t_submit: Optional[float] = None
        self.t_queue_start: Optional[float] = None
        self.t_admit: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.prefill_ms: float = 0.0
        self.queue_ms_acc: float = 0.0

    @property
    def ttft_ms(self) -> float:
        """Submission to the first token's readback, ms (0 until both
        stamps exist); a preempted request's counts from its first
        submission."""
        if self.t_submit is None or self.t_first_token is None:
            return 0.0
        return (self.t_first_token - self.t_submit) * 1e3

    @property
    def queue_wait_ms(self) -> float:
        return self.queue_ms_acc

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
        request.t_submit = time.perf_counter()
        request.t_queue_start = request.t_submit
        self._q.append(request)
        return request

    def requeue(self, request: Request) -> None:
        """Return a preempted request to the HEAD of the queue; the bound
        does not apply (preemption is the engine's doing)."""
        request.t_queue_start = time.perf_counter()
        self._q.appendleft(request)

    def pop_ready(self, free_slots: int, pages_free: int,
                  page_size: Optional[int] = None) -> List[Request]:
        """FCFS admissions for this stream boundary: up to ``free_slots``
        requests, stopping when the pool cannot grant a first page to the
        next head-of-line request (no skip-ahead).  Each admitted request
        gets its ``t_admit`` stamp and its queue leg added to
        ``queue_ms_acc``.  ``page_size`` is the JAX signature's; the
        policy reserves one page per admission whatever its size."""
        out: List[Request] = []
        budget = pages_free
        while self._q and len(out) < free_slots and budget >= 1:
            req = self._q.popleft()
            req.t_admit = time.perf_counter()
            if req.t_queue_start is not None:
                req.queue_ms_acc += (req.t_admit - req.t_queue_start) * 1e3
            out.append(req)
            budget -= 1  # the first page; later pages grow per burst
        return out


# ---------------------------------------------------------------------------
# prefix cache index
# ---------------------------------------------------------------------------
def prefix_key(*parts) -> str:
    """Stable content-hash key for a prefix-cache entry.  Parts are ints,
    strings or int arrays (token vectors); the digest depends on content
    only, so it survives restarts and equals the JAX package's."""
    h = hashlib.sha1()
    for p in parts:
        if isinstance(p, np.ndarray):
            h.update(b"a" + np.ascontiguousarray(p, np.int64).tobytes())
        else:
            h.update(b"s" + repr(p).encode())
        h.update(b"\x00")
    return h.hexdigest()


class PrefixCache:
    """LRU content-hash index over reusable prefill work (host-side
    bookkeeping only; payloads are opaque here).

    ``"pages"`` entries point at KV pages of the engine's
    :class:`~.paged_cache.PagedKVCache` that hold a teacher-forced
    decoder prefix (a hit adopts or copies them instead of re-ingesting);
    ``"prefill"`` entries hold device copies of the prefill's per-slot
    rows (the encoder memory of a source), so a repeated source skips the
    encoder.  Every entry is stamped with the engine's weight generation,
    and ``invalidate_stale`` drops older ones.  ``put`` bounds the index
    at ``max_entries`` (LRU); the engine calls ``pop_lru("pages")`` under
    pool pressure before it preempts a live request.  Dropped entries are
    returned to the caller, which frees the pages they hold."""

    def __init__(self, max_entries: int = 64):
        self.max_entries = max(1, int(max_entries))
        self._entries: "OrderedDict[str, dict]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def __len__(self):
        return len(self._entries)

    def get(self, key: str, generation: int) -> Optional[dict]:
        """Look ``key`` up; a hit only for an entry of ``generation``
        (an older entry counts as a miss, and ``put`` replaces it)."""
        e = self._entries.get(key)
        if e is not None and e["generation"] == generation:
            self._entries.move_to_end(key)
            e["uses"] += 1
            self.hits += 1
            return e
        self.misses += 1
        return None

    def put(self, key: str, kind: str, generation: int,
            payload: dict) -> List[dict]:
        """Insert or replace an entry; returns the entries the LRU bound
        displaced (and any same-key predecessor) for the caller to
        release."""
        dropped = []
        old = self._entries.pop(key, None)
        if old is not None:
            dropped.append(old)
        self._entries[key] = {"key": key, "kind": kind,
                              "generation": int(generation),
                              "payload": payload, "uses": 0}
        while len(self._entries) > self.max_entries:
            _, e = self._entries.popitem(last=False)
            dropped.append(e)
        return dropped

    def pop_lru(self, kind: Optional[str] = None) -> Optional[dict]:
        """Drop and return the least recently used entry (of ``kind``,
        when given)."""
        for key, e in self._entries.items():
            if kind is None or e["kind"] == kind:
                return self._entries.pop(key)
        return None

    def invalidate_stale(self, generation: int) -> List[dict]:
        """Drop every entry not of ``generation``; returns them."""
        stale = [k for k, e in self._entries.items()
                 if e["generation"] != generation]
        return [self._entries.pop(k) for k in stale]
