"""Continuous-batching inference engine: one decode step shared by ragged
in-flight requests.

Counterpart of ``mxnet_tpu/serving/engine.py``.  The hot loop runs one
decode step over ``S`` fixed decode *slots*; every input keeps its shape
from step to step — per-slot positions, page tables and lengths are
tensor VALUES — so mixed-length requests arriving mid-flight share one
step.  Prefill (the encoder, for the seq2seq Transformer) runs once per
admission over the source padded to a fixed length.

Dispatch follows the JAX engine's burst semantics: ``_dispatch_step``
chains device state to device state and returns the step's token tensor
without waiting for it; ``stream_every`` steps are dispatched before one
host readback of all their tokens (``_consume``), which does the
scheduler bookkeeping (EOS frees the slot's KV pages at once; waiting
requests join mid-flight).  Nothing on the dispatch path calls
``.item()`` or ``.cpu()``.

The front door, each part off by default as in the JAX engine:

  * ``sampling=True``: temperature / top-k / top-p per request, with a
    per-request seeded stream (``sampling.py``); a temperature-0 request
    takes the greedy selection, token for token the greedy engine's.
  * ``spec_k=K``: speculative decoding.  A host draft (``NGramDraft`` by
    default) proposes up to K tokens a slot; one verify dispatch
    teacher-forces them through K + 1 decode bodies and keeps the longest
    prefix the target agrees with, plus a correction or bonus token.
  * ``prefix_cache=True``: a request's forced decoder ``prefix`` is
    teacher-forced once (ingest dispatches of ``_prefix_chunk`` bodies)
    and its KV pages shared copy-on-write with later requests of the
    same (source, bos, prefix); a repeated source reuses its encoder
    rows.  ``serve_beam`` runs ``Transformer.translate`` per request
    group.

Runtime services, as in the JAX engine: ``swap_weights`` stages a
checkpoint's parameters off the decode path, verifies them and flips them
in place at a stream boundary (``weight_generation`` counts the flips);
the engine reports to the port's telemetry recorder (``serve_request``,
``serve_state``, ``serve_prefix``, ``spec_verify``, ``serve_preempt``,
``weight_swap`` and the ``serve_*`` spans, with the JAX engine's fields)
and registers its pools and slot state (``serving``) and staged weights
(``staging``) with ``memwatch``.  Spans around a dispatch measure host
enqueue time; only a stream boundary's readback synchronises.

Any model servable here implements :class:`ServingAdapter`;
:class:`TransformerAdapter` serves ``models.transformer.Transformer`` on
the paged KV cache, whose self-attention is kernel K2 and whose
LayerNorms are kernel K1.  Every decode body, verify and ingest ones
included, runs 3 K1 and 1 K2 launches per decoder layer.
"""
from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import memwatch, telemetry
from ..base import MXNetError
from ..context import resolve_device
from . import sampling as _sampling
from .paged_cache import (PagedKVCache, PagedStepCache, page_coords,
                          pages_for, torch_dtype)
from .scheduler import (ContinuousBatchingScheduler, PrefixCache, Request,
                        prefix_key)
from .speculative import NGramDraft, traced_propose

__all__ = ["ServingAdapter", "TransformerAdapter", "ServingEngine"]


# ---------------------------------------------------------------------------
# the cached-decode interface
# ---------------------------------------------------------------------------
class ServingAdapter:
    """What a model must expose to be served.

    ``num_layers``/``num_heads``/``head_dim`` size the paged KV pools."""

    num_layers = 0
    num_heads = 1
    head_dim = 1

    def extra_state(self, slots: int, device, dtype=torch.float32):
        """Adapter-owned device state with a leading slot dim (e.g. the
        encoder memory per slot), its floating state in ``dtype`` (the
        engine's).  OrderedDict name -> tensor."""
        raise NotImplementedError

    def prefill_src(self, request: Request):
        """Padded (1, Ts) int32 numpy prefill input for ``request``."""
        raise NotImplementedError

    def prefill(self, src):
        """(1, Ts) tokens -> dict of extra-state rows (each (1, ...)) to
        install into the request's slot."""
        raise NotImplementedError

    def install(self, state, slot: int, request: Request) -> None:
        """Per-slot state at admission, after the engine has set
        tok = bos, pos = 0 and the prefill rows."""

    def validate(self, request: Request) -> None:
        """Reject a request this adapter cannot serve (raise MXNetError)
        at submit time."""

    def max_positions(self) -> Optional[int]:
        """The largest decode position the model can represent, or None
        for unbounded."""
        return None

    def decode_logits(self, tok, pos, table, pages, rows, lengths, extra,
                      pools):
        """Decode ONE position for every slot up to the logits: returns
        (S, V) logits with the KV write applied (the pools are updated in
        place)."""
        raise NotImplementedError

    def advance_extra(self, extra, nxt, pos) -> None:
        """Apply the chosen tokens ``nxt`` to adapter extra state (in
        place).  The Transformer's extra state (the encoder memory) does
        not change per step; speculative verify never calls this."""

    def decode(self, tok, pos, table, pages, rows, lengths, extra, pools):
        """Greedy decode of ONE position for every slot: the argmax over
        log-softmax of :meth:`decode_logits` (the JAX engine's
        selection, token for token).  Returns (S,) int32."""
        logits = self.decode_logits(tok, pos, table, pages, rows, lengths,
                                    extra, pools)
        nxt = _greedy(logits)
        self.advance_extra(extra, nxt, pos)
        return nxt


def _greedy(logits):
    """The greedy selection, argmax over log-softmax — the one op
    sequence every greedy lane takes, so lanes agree bit for bit."""
    return torch.argmax(torch.log_softmax(logits, dim=-1),
                        dim=-1).to(torch.int32)


class TransformerAdapter(ServingAdapter):
    """``models.transformer.Transformer`` seq2seq decode on the paged KV
    cache.  Prefill = the encoder over the source padded to
    ``src_max_len``; decode = ``Transformer._decode_step``.  The model is
    put in eval mode: serving never runs dropout."""

    def __init__(self, model, src_max_len: int):
        self.model = model.eval()
        self.src_max = int(src_max_len)
        sa = model.decoder.layers[0].self_attn
        self.num_layers = len(model.decoder.layers)
        self.num_heads = sa.num_heads
        self.head_dim = sa.head_dim

    def max_positions(self):
        return self.model.pos.max_length

    def extra_state(self, slots, device, dtype=torch.float32):
        # mem in the engine's dtype, as the JAX adapter keeps it; the
        # decoder promotes it to its weights' type where it reads it
        return OrderedDict(
            mem=torch.zeros((slots, self.src_max, self.model.units),
                            dtype=dtype, device=device),
            src_keep=torch.zeros((slots, self.src_max), dtype=torch.bool,
                                 device=device))

    def validate(self, request):
        if request.tokens.shape[0] > self.src_max:
            raise MXNetError(
                f"request {request.id} source length "
                f"{request.tokens.shape[0]} > adapter src_max_len "
                f"{self.src_max}")

    def prefill_src(self, request):
        row = np.full((1, self.src_max), self.model.pad_id, np.int32)
        row[0, :request.tokens.shape[0]] = request.tokens
        return row

    def prefill(self, src):
        mem, src_keep = self.model._encode_h(src)
        return {"mem": mem, "src_keep": src_keep}

    def decode_logits(self, tok, pos, table, pages, rows, lengths, extra,
                      pools):
        caches = [PagedStepCache(k, v, table, pages, rows, lengths)
                  for k, v in pools]
        return self.model._decode_step(tok, pos, extra["mem"],
                                       extra["src_keep"], caches)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------
class _Active:
    """Host bookkeeping of one occupied slot."""

    __slots__ = ("req", "pos", "done", "seq")

    def __init__(self, req: Request, seq: int):
        self.req = req
        self.pos = 0      # mirrors the slot's DEVICE position counter
        self.done = False
        self.seq = seq    # admission order (preemption evicts youngest)


class ServingEngine:
    """Fixed-slot continuous-batching engine (module docstring).

    The defaults are the JAX engine's: 8 slots, pages of 16 rows, a pool
    in which every slot can reach ``max_len`` (``pool_pages=None``), a
    token readback every 4 steps, sampling, speculation and the prefix
    cache off, 64 prefix entries, the queue bound of ``MX_SERVE_QUEUE``
    (``queue_bound=None``).  ``device`` defaults to
    :func:`context.default_device` (``cuda:0``; raises without CUDA).
    ``dtype`` ("float32", "bfloat16" or "float16", as the JAX engine's)
    is the type of the KV pools and of the adapter's floating state (the
    Transformer's encoder memory); the model's weights and the queries
    stay as they are, and kernel K2 reads the pools in their type.

    ``burst_times`` collects (dispatches, seconds) per burst, from the
    first dispatch to the end of the burst's token readback; a verify
    burst is one dispatch."""

    def __init__(self, adapter: ServingAdapter, slots: int = 8,
                 page_size: int = 16, pool_pages: Optional[int] = None,
                 max_len: int = 64, stream_every: int = 4, device=None,
                 dtype: str = "float32",
                 queue_bound: Optional[int] = None, sampling: bool = False,
                 spec_k: int = 0, draft=None, prefix_cache: bool = False,
                 prefix_entries: int = 64):
        self._adapter = adapter
        self._device = resolve_device(device)
        self._dtype = torch_dtype(dtype)
        self._sampling = bool(sampling)
        self._spec_k = max(0, int(spec_k))
        self._draft = draft
        if self._spec_k and self._draft is None:
            self._draft = NGramDraft()
        self._prefix = (PrefixCache(prefix_entries) if prefix_cache
                        else None)
        self._prefix_chunk = 8
        # the label of the decode program in statusz (the JAX engine's
        # quantized adapters name theirs)
        self._precision = "fp32"
        # zero-downtime weight hot-swap: verified new weights wait in
        # _staging (device tensors in the module's layouts) until the run
        # loop flips them in at a stream boundary; the generation stamps
        # prefix-cache entries
        self._staging: Dict[str, torch.Tensor] = {}
        self._swap_pending: Optional[dict] = None
        self._swap_lock = threading.Lock()
        # held by run() for its whole loop: an idle flip on the caller's
        # thread never overlaps a run loop's dispatches
        self._run_lock = threading.Lock()
        self._running = False
        self._weight_generation = 0
        self._S = int(slots)
        self._ps = int(page_size)
        self._max_len = int(max_len)
        self._stream_every = max(1, int(stream_every))
        cap = adapter.max_positions()
        if cap is not None and self._max_len > cap:
            raise MXNetError(
                f"engine max_len {self._max_len} > the model's "
                f"max_positions {cap} (positional table) — out-of-table "
                "positions would silently clamp; lower max_len or build "
                "the model with a larger max_length")
        n_pages = pool_pages if pool_pages is not None \
            else self._S * pages_for(self._max_len, self._ps) + 1
        self._cache = PagedKVCache(
            adapter.num_layers, n_pages, self._ps, adapter.num_heads,
            adapter.head_dim, device=self._device, dtype=self._dtype)
        # table wide enough that positions overrun by a full burst (a
        # request finishing mid-burst keeps decoding until the stream
        # boundary) land on zero -> the trash page, never a live page; a
        # verify overruns by up to K + 1 positions, and a prefix ingest
        # writes _prefix_chunk positions past every live slot's pos, so
        # the widest of the three (a narrower table would clamp those
        # writes onto the slot's last live page)
        overrun = max(self._stream_every, self._spec_k + 1,
                      self._prefix_chunk)
        self._P = pages_for(self._max_len + overrun, self._ps)
        self._sched = ContinuousBatchingScheduler(queue_bound)
        self._slots: List[Optional[_Active]] = [None] * self._S
        self._arrivals: List = []  # (arrive_at_step, request), sorted
        self._step_n = 0
        self._admit_seq = 0
        self._last_nprop = None
        self._spec_proposed = 0  # lifetime draft tokens proposed
        self._spec_accepted = 0  # lifetime draft tokens accepted
        self.burst_times: List[Tuple[int, float]] = []

        dev = self._device
        state = OrderedDict(
            tok=torch.zeros((self._S, 1), dtype=torch.int32, device=dev),
            pos=torch.zeros((self._S,), dtype=torch.int32, device=dev),
            table=torch.zeros((self._S, self._P), dtype=torch.int32,
                              device=dev))
        # per-slot sampling state exists only when sampling is on; rng is
        # the request's stream key (sampling.seed_key)
        self._samp_names: List[str] = []
        if self._sampling:
            state["temp"] = torch.zeros((self._S,), dtype=torch.float32,
                                        device=dev)
            state["topk"] = torch.zeros((self._S,), dtype=torch.int32,
                                        device=dev)
            state["topp"] = torch.zeros((self._S,), dtype=torch.float32,
                                        device=dev)
            state["rng"] = torch.zeros((self._S,), dtype=torch.int64,
                                       device=dev)
            self._samp_names = ["temp", "topk", "topp", "rng"]
        extra = adapter.extra_state(self._S, dev, self._dtype)
        self._extra_names = list(extra)
        state.update(extra)
        self._state = state
        # census categories: the pools and slot state are the engine's
        # resident footprint; the staged swap weights (the transient 2x
        # window) read empty again after the flip
        memwatch.register("serving", self, lambda eng: (
            list(eng._state.values())
            + [t for pair in eng._cache.pools for t in pair]))
        memwatch.register("staging", self,
                          lambda eng: list(eng._staging.values()))

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def submit(self, request: Request) -> Request:
        plen = int(request.prefix.size)
        if plen + request.max_new_tokens > self._max_len:
            raise MXNetError(
                f"request {request.id} prefix {plen} + max_new_tokens "
                f"{request.max_new_tokens} > engine max_len "
                f"{self._max_len}")
        if request.temperature > 0 and not self._sampling:
            raise MXNetError(
                f"request {request.id} asks for temperature "
                f"{request.temperature} but this engine was built "
                "greedy-only — construct ServingEngine(sampling=True)")
        self._adapter.validate(request)
        return self._sched.submit(request)

    def serve(self, requests, arrival_steps=None) -> Dict[str, np.ndarray]:
        """Decode ``requests`` to completion; returns {id: tokens}.

        ``arrival_steps`` (optional, aligned with ``requests``) delays
        request i until the engine's decode-step counter reaches that
        value — mid-flight joins.  Arrival 0/None submits at once."""
        requests = list(requests)
        if arrival_steps is None:
            arrival_steps = [0] * len(requests)
        base = self._step_n
        for req, at in zip(requests, arrival_steps):
            if at:
                self._arrivals.append((base + int(at), req))
            else:
                self.submit(req)
        self._arrivals.sort(key=lambda p: p[0])
        self.run()
        return {r.id: r.stream.asarray() for r in requests}

    def swap_weights(self, ckpt_dir: str,
                     step: Optional[int] = None) -> int:
        """Zero-downtime weight hot-swap: load a checkpoint's parameters
        (by structural name, ``checkpoint.load_checkpoint_state``) into a
        STAGING copy on the engine's device, verify them, and flip them
        into the served parameters at the next stream boundary: requests
        in flight finish against one consistent weight set, and the KV
        pools and page tables are untouched.

        Verified before anything is published: the checkpoint's SHA-256
        digests (torn or corrupt steps are invisible), full parameter
        coverage, and the structure fingerprint (names, shapes, dtypes,
        adapter) over the staged tensors, which must equal the served
        one.  A mismatch is a LOUD rejection (``MXNetError``) and the
        engine keeps serving the old weights.

        The flip writes in place (``copy_`` under ``no_grad``), so no
        parameter's address changes.  It happens only on the run-loop
        thread at a stream boundary (between bursts, or as the loop
        starts or ends), or here at once when the engine is idle; either
        way before any request admitted after this call returns.
        Returns the checkpoint step swapped in; telemetry records a
        ``weight_swap`` event (staged bytes, verify and flip ms,
        generation)."""
        from .. import checkpoint as ckpt_mod

        t0 = time.perf_counter()
        state = ckpt_mod.load_checkpoint_state(ckpt_dir, step=step)
        if state is None:
            raise MXNetError(
                f"swap_weights: no valid checkpoint in {ckpt_dir!r} — "
                "keeping the current weights")
        snap = state["params"]
        staging: Dict[str, torch.Tensor] = {}
        try:
            served = self._served_params()
            for sname, p in served.items():
                if sname not in snap:
                    raise MXNetError(
                        f"swap_weights: checkpoint step {state['step']} "
                        f"is missing parameter {sname!r} — rejected, "
                        "keeping the current weights")
                staging[sname] = p._from_gluon(
                    ckpt_mod._tensor_of(snap[sname]))
            cur = memwatch.fingerprint(self._structure_parts(
                {n: p._tensor() for n, p in served.items()}))
            new = memwatch.fingerprint(self._structure_parts(staging))
            if new != cur:
                raise MXNetError(
                    f"swap_weights: checkpoint step {state['step']} has "
                    "a different structure fingerprint (parameter "
                    "shapes/dtypes or adapter changed) — rejected, "
                    "keeping the current weights")
            staging = {n: t.to(served[n]._tensor().device)
                       for n, t in staging.items()}
        except MXNetError as e:
            staging.clear()
            telemetry.record("weight_swap", executor="ServingEngine",
                             rejected=True, reason=str(e),
                             generation=self._weight_generation)
            raise
        verify_ms = (time.perf_counter() - t0) * 1e3
        with self._swap_lock:
            self._staging = staging
            self._swap_pending = {
                "step": int(state["step"]),
                "staged_bytes": int(sum(t.numel() * t.element_size()
                                        for t in staging.values())),
                "verify_ms": verify_ms,
            }
        if not self._running and self._run_lock.acquire(blocking=False):
            # idle engine: no stream boundary will come around — flip now
            # (a run loop starting or ending meanwhile flips it itself)
            try:
                self._apply_pending_swap()
            finally:
                self._run_lock.release()
        return int(state["step"])

    def _served_params(self) -> Dict[str, object]:
        """Structural name -> Parameter of the adapter's model."""
        model = getattr(self._adapter, "model", None)
        if model is None or not hasattr(model,
                                        "_collect_params_with_prefix"):
            raise MXNetError("swap_weights needs an adapter exposing .model "
                             "as a Gluon block")
        return model._collect_params_with_prefix()

    def _structure_parts(self, tensors: Dict[str, torch.Tensor]):
        """Restart-stable structural identity of a weight set: names,
        shapes, dtypes, the adapter and model classes — no object ids."""
        model = getattr(self._adapter, "model", None)
        return (("ServingEngine", type(self._adapter).__name__,
                 type(model).__name__ if model is not None else "")
                + tuple((n, tuple(t.shape), str(t.dtype))
                        for n, t in sorted(tensors.items())))

    def _apply_pending_swap(self) -> None:
        """Flip staged weights into the served parameters (a stream
        boundary of the run loop, or ``swap_weights`` on an idle
        engine): an in-place copy into every parameter's tensor."""
        with self._swap_lock:
            pending, staging = self._swap_pending, self._staging
            self._swap_pending = None
            if pending is None:
                return
        t0 = time.perf_counter()
        served = self._served_params()
        # grad mode is per thread: an idle flip runs on the caller's
        with torch.no_grad():
            for name, t in staging.items():
                served[name]._tensor().copy_(t)
        self._weight_generation += 1
        # every cached prefix was stamped with the generation it was
        # computed under; older entries drop (and release their pages)
        # before the next admission can fork them
        if self._prefix is not None:
            dropped = self._prefix.invalidate_stale(self._weight_generation)
            for e in dropped:
                self._release_prefix_entry(e)
            if dropped:
                telemetry.record(
                    "serve_prefix_invalidate", executor="ServingEngine",
                    dropped=len(dropped),
                    generation=self._weight_generation)
        # the staging census category reads empty after the flip
        self._staging = {}
        telemetry.record_weight_swap(
            generation=self._weight_generation,
            staged_bytes=pending["staged_bytes"],
            verify_ms=pending["verify_ms"],
            flip_ms=(time.perf_counter() - t0) * 1e3,
            step=pending["step"])

    @property
    def weight_generation(self) -> int:
        """How many hot-swaps have been applied (0 = boot weights)."""
        return self._weight_generation

    @torch.no_grad()
    def run(self, max_steps: int = 1_000_000) -> None:
        """Drive the engine until queue, arrivals and slots are empty."""
        with self._run_lock:
            self._running = True
            try:
                # a swap staged while no loop was live flips before any
                # admission
                self._apply_pending_swap()
                self._run_loop(max_steps)
            finally:
                self._running = False
                # ... and one staged as the loop ended
                self._apply_pending_swap()

    def _run_loop(self, max_steps: int) -> None:
        guard = 0
        spins = 0
        while True:
            self._pump_arrivals()
            self._admit_ready()
            active = sum(1 for m in self._slots if m is not None)
            if not active:
                if self._arrivals:
                    # idle: fast-forward the step clock to the next
                    # join
                    self._step_n = max(self._step_n,
                                       self._arrivals[0][0])
                    continue
                if self._sched.depth:
                    # all slots free, none admitted: tolerate ONE
                    # spin — a concurrent submit (the replica
                    # server's handler threads) can land between
                    # _admit_ready and the depth check; a request
                    # that truly cannot fit fails again next pass
                    spins += 1
                    if spins > 1:
                        raise MXNetError(
                            "serving queue non-empty but no request "
                            "admissible (pool/config too small?)")
                    continue
                break
            spins = 0
            spec = self._spec_k > 0
            want = self._spec_k + 1 if spec else self._stream_every
            burst = self._ensure_pages(want)
            # request ids decoding THIS burst, captured before the
            # consume evicts finished ones
            burst_ids = [(m.req.id, m.req.trace_id, m.req.sampled)
                         for m in self._slots
                         if m is not None and not m.done]
            t0 = time.perf_counter()
            if spec and burst == self._spec_k + 1:
                # one verify dispatch per boundary; per-slot accepted
                # counts are device values
                tout, counts = self._dispatch_spec()
                t_stream0 = time.perf_counter()
                self._consume_spec(tout, counts)
                dispatches = 1
            else:
                # plain path (also the fallback when pool pressure or
                # a near-budget request shrinks the burst below K + 1)
                handles = [self._dispatch_step() for _ in range(burst)]
                t_stream0 = time.perf_counter()
                self._consume(handles)
                dispatches = burst
            t_stream1 = time.perf_counter()
            self.burst_times.append((dispatches, t_stream1 - t0))
            # one serve_decode span per in-flight request (dispatch
            # through readback) and one serve_stream span for the
            # readback boundary, at burst cadence
            if telemetry.spans_enabled():
                for rid, tid, samp in burst_ids:
                    if tid is not None and not samp:
                        continue  # head-based sampling dropped it
                    telemetry.record_span(
                        "serve_decode", t0, t_stream1,
                        request_id=rid, steps=burst,
                        **({"trace_id": tid} if tid else {}))
                telemetry.record_span("serve_stream", t_stream0,
                                      t_stream1,
                                      active_slots=len(burst_ids),
                                      queue_depth=self._sched.depth)
            telemetry.record_serve_state(queue_depth=self._sched.depth,
                                         active_slots=active,
                                         precision=self._precision)
            if self._swap_pending is not None:
                # the stream boundary IS the swap point: this burst's
                # tokens are consumed, nothing is in flight
                self._apply_pending_swap()
            guard += burst
            if guard > max_steps:
                raise MXNetError(
                    f"serving run exceeded {max_steps} decode "
                    "steps (runaway request set?)")

    @property
    def step_count(self) -> int:
        return self._step_n

    @property
    def pages_free(self) -> int:
        return self._cache.pages_free

    @property
    def num_pages(self) -> int:
        return self._cache.num_pages

    @property
    def pool_bytes(self) -> int:
        """Bytes of the KV pools on the device (every layer's K and V)."""
        return sum(t.numel() * t.element_size()
                   for pair in self._cache.pools for t in pair)

    # ------------------------------------------------------------------
    # the hot dispatch bodies: no host syncs
    # ------------------------------------------------------------------
    def _decode_body(self):
        st = self._state
        tok, pos, table = st["tok"], st["pos"], st["table"]
        lengths = pos + 1  # rows valid incl. the one written this step
        pages, rows = page_coords(table, pos, self._ps)
        extra = {k: st[k] for k in self._extra_names}
        pools = self._cache.pools
        if not self._sampling:
            nxt = self._adapter.decode(tok, pos, table, pages, rows,
                                       lengths, extra, pools)
        else:
            logits = self._adapter.decode_logits(tok, pos, table, pages,
                                                 rows, lengths, extra, pools)
            nxt = self._select_token(logits)
            self._adapter.advance_extra(extra, nxt, pos)
        st["tok"] = nxt.reshape(self._S, 1)
        st["pos"] = pos + 1
        return nxt

    def _select_token(self, logits):
        """Token selection under sampling.  Temperature-0 slots take the
        greedy body's exact op sequence, chosen per slot by ``where``, so
        a greedy request in a sampling engine emits the greedy engine's
        tokens; sampling slots take Gumbel-argmax over the filtered
        logits, with the noise of their (key, position) counter."""
        st = self._state
        greedy = _greedy(logits)
        temp = st["temp"]
        filt = _sampling._filter_logits(logits, temp, st["topk"],
                                        st["topp"])
        g = _sampling._gumbel_rows(st["rng"], 2 * st["pos"].long(),
                                   filt.shape[-1])
        sampled = torch.argmax(filt + g, dim=-1).to(torch.int32)
        return torch.where(temp > 0, sampled, greedy)

    def _dispatch_step(self):
        """Dispatch ONE decode step: device state chains to device state;
        the step's (S,) token tensor is returned without waiting for
        it."""
        toks = self._decode_body()
        self._step_n += 1
        return toks

    # ------------------------------------------------------------------
    # teacher-forced multi-position bodies: speculative verify and prefix
    # ingest.  Each runs ``steps`` decode bodies in a row; per-slot
    # proposal counts and ingest lengths are device values.
    #
    # KV safety: body j writes position pos + j BEFORE it attends
    # pos + j + 1 rows, so rows past a slot's accepted or ingested count
    # hold teacher-forced garbage — but the next dispatch starts at the
    # slot's new pos and rewrites each such row before it is attended.
    # Writes past a slot's granted pages land on the zero table entry,
    # the trash page.
    # ------------------------------------------------------------------
    def _chain_logits(self, feed, steps: int):
        """Run ``steps`` decode bodies, teacher-forcing ``feed[:, j]`` at
        position pos + j; returns the list of (S, V) logits."""
        st = self._state
        pos, table = st["pos"], st["table"]
        extra = {k: st[k] for k in self._extra_names}
        out = []
        for j in range(steps):
            pos_j = pos + j
            pages, rows = page_coords(table, pos_j, self._ps)
            out.append(self._adapter.decode_logits(
                feed[:, j:j + 1], pos_j, table, pages, rows, pos_j + 1,
                extra, self._cache.pools))
        return out

    def _verify_body(self, draft, nprop):
        """Teacher-force [tok, d_1..d_K] through K + 1 decode bodies,
        accept the longest draft prefix the target agrees with (argmax
        equality under greedy; u < p(d) under sampling), emit a
        correction or bonus token at the first disagreement, and advance
        per-slot state by the accepted count, a device value.  Returns
        (tout (S, K+1) int32: the accepted drafts, then the emitted
        token, then zeros; counts (S,) int32 = accepted + 1)."""
        K, S = self._spec_k, self._S
        st = self._state
        tok, pos = st["tok"], st["pos"]
        d = draft                                          # (S, K)
        logits_l = self._chain_logits(torch.cat([tok, d], dim=1), K + 1)
        greedy = torch.stack([_greedy(lg) for lg in logits_l], dim=1)
        kclip = torch.clamp(nprop, 0, K)
        dev = greedy.device
        jj = torch.arange(K, dtype=torch.int32, device=dev)[None, :]
        dl = d.long()
        if self._sampling:
            temp = st["temp"]
            lg = torch.stack(logits_l, dim=1)              # (S, K+1, V)
            V = lg.shape[-1]
            filt = _sampling._filter_logits(
                lg.reshape(S * (K + 1), V),
                temp.repeat_interleave(K + 1),
                st["topk"].repeat_interleave(K + 1),
                st["topp"].repeat_interleave(K + 1)).reshape(S, K + 1, V)
            ctr = 2 * (pos.long()[:, None]
                       + torch.arange(K + 1, device=dev)[None, :])
            key = st["rng"][:, None].expand(S, K + 1)
            u = _sampling._uniform_rows(key[:, :K], ctr[:, :K] + 1)
            gum = _sampling._gumbel_rows(key, ctr, V)      # (S, K+1, V)
            probs = torch.softmax(filt, dim=-1)
            pd = probs[:, :K].gather(-1, dl[..., None])[..., 0]
            # a deterministic draft (q a point mass): accept w.p. p(d)
            ok = torch.where(temp[:, None] > 0, u < pd, d == greedy[:, :K])
        else:
            ok = d == greedy[:, :K]
        valid = jj < kclip[:, None]
        accept = torch.cumprod((ok & valid).to(torch.int32), dim=1)
        a = accept.sum(dim=1).to(torch.int32)              # (S,)
        al = a.long()[:, None]
        tau = greedy.gather(1, al)[:, 0]
        if self._sampling:
            sampled = torch.argmax(filt + gum, dim=-1).to(torch.int32)
            # resample on rejection: p with the rejected draft token
            # removed (q is a point mass, so max(0, p - q) renormalized
            # is p zeroed at d)
            resampled = torch.argmax(
                filt[:, :K].scatter(-1, dl[..., None], float("-inf"))
                + gum[:, :K], dim=-1).to(torch.int32)
            resampled = torch.cat([resampled, sampled[:, K:]], dim=1)
            rejected = a < kclip
            tau_s = torch.where(rejected[:, None], resampled,
                                sampled).gather(1, al)[:, 0]
            tau = torch.where(temp > 0, tau_s, tau)
        dpad = torch.cat([d, torch.zeros((S, 1), dtype=torch.int32,
                                         device=dev)], dim=1)
        jj1 = torch.arange(K + 1, dtype=torch.int32, device=dev)[None, :]
        tout = torch.where(jj1 < a[:, None], dpad,
                           torch.where(jj1 == a[:, None], tau[:, None],
                                       torch.zeros_like(dpad)))
        counts = a + 1
        st["tok"] = tau[:, None].to(torch.int32)
        st["pos"] = pos + counts
        return tout, counts

    def _ingest_body(self, feed, n):
        """Teacher-force up to ``_prefix_chunk`` prefix tokens per slot
        into the paged KV cache (per-slot ragged length ``n``; n = 0
        slots only get garbage writes the decode loop rewrites before it
        attends them, or the trash page).  The logits are discarded."""
        self._chain_logits(feed, self._prefix_chunk)
        st = self._state
        st["pos"] = st["pos"] + torch.clamp(n, 0, self._prefix_chunk)

    def _propose(self):
        """Host-side draft proposals for every live slot: (S, K) int32
        token matrix + (S,) proposal counts (0 for empty slots and for
        requests the draft has nothing for)."""
        K = self._spec_k
        draft = np.zeros((self._S, K), np.int32)
        nprop = np.zeros((self._S,), np.int32)
        for slot, meta in enumerate(self._slots):
            if meta is None or meta.done:
                continue
            toks = list(traced_propose(self._draft, meta.req,
                                       meta.req.stream.tokens, K))[:K]
            if toks:
                draft[slot, :len(toks)] = toks
                nprop[slot] = len(toks)
        return draft, nprop

    def _to_device(self, arr):
        return torch.from_numpy(arr).to(self._device, non_blocking=True)

    def _dispatch_spec(self):
        """Dispatch ONE verify step (K drafts checked + one token emitted
        per slot); the (S, K+1) tokens and (S,) counts are returned
        without waiting for them."""
        draft, nprop = self._propose()
        self._last_nprop = nprop
        out = self._verify_body(self._to_device(draft),
                                self._to_device(nprop))
        self._step_n += 1
        return out

    def _consume_spec(self, tout, counts):
        """Stream boundary of a verify dispatch: one readback of the
        (S, K+1) tokens and the per-slot counts.  Row layout per slot:
        the accepted drafts, then the correction or bonus token, then
        padding."""
        both = torch.cat([tout, counts[:, None]], dim=1).cpu().numpy()
        tout, counts = both[:, :-1], both[:, -1]
        proposed = int(self._last_nprop.sum()) \
            if self._last_nprop is not None else 0
        accepted = 0
        for slot, meta in enumerate(self._slots):
            if meta is None:
                continue
            c = int(counts[slot])
            meta.pos += c  # device pos advanced by the accepted count
            if meta.done:
                continue
            req = meta.req
            accepted += max(0, c - 1)
            for i in range(c):
                tok = int(tout[slot, i])
                req.stream.append(tok)
                if req.t_first_token is None:
                    req.t_first_token = time.perf_counter()
                if tok == req.eos_id:
                    meta.done = True
                    req.stream.finish("eos")
                    break
                if len(req.stream) >= req.max_new_tokens:
                    meta.done = True
                    req.stream.finish("length")
                    break
        self._spec_proposed += proposed
        self._spec_accepted += accepted
        # the verify boundary is per burst: name the sampled traces that
        # shared it
        tids = [m.req.trace_id for m in self._slots
                if m is not None and m.req.trace_id and m.req.sampled]
        telemetry.record_spec_verify(
            proposed=proposed, accepted=accepted,
            **({"trace_ids": tids} if tids else {}))
        for slot, meta in enumerate(self._slots):
            if meta is not None and meta.done:
                self._finish(slot, meta)

    # ------------------------------------------------------------------
    # host-side scheduling (stream boundaries only)
    # ------------------------------------------------------------------
    def _pump_arrivals(self):
        while self._arrivals and self._arrivals[0][0] <= self._step_n:
            _, req = self._arrivals.pop(0)
            self.submit(req)

    def _admit_ready(self) -> int:
        free = [i for i, m in enumerate(self._slots) if m is None]
        if not free or not self._sched.depth:
            return 0
        ready = self._sched.pop_ready(len(free), self._cache.pages_free,
                                      self._ps)
        n = 0
        for i, (slot, req) in enumerate(zip(free, ready)):
            if self._admit(slot, req):
                n += 1
                continue
            # the pool cannot hold this request's prefix now: it and the
            # rest go back to the queue head in order, it first (requeue
            # prepends, so walk backwards)
            for r in reversed(ready[i:]):
                self._sched.requeue(r)
            break
        return n

    def _admit(self, slot: int, req: Request) -> bool:
        st = self._state
        if req.generation_at_admit is None:
            req.generation_at_admit = self._weight_generation
        # the queue leg of the request's span tree, from the scheduler's
        # stamps (t_queue_start: a requeue's leg starts at the requeue)
        if req.t_queue_start is not None and req.t_admit is not None \
                and telemetry.spans_enabled() \
                and (req.trace_id is None or req.sampled):
            telemetry.record_span(
                "serve_queue", req.t_queue_start, req.t_admit,
                request_id=req.id,
                **({"trace_id": req.trace_id} if req.trace_id else {}))
        self._cache.annotate(
            slot, request_id=req.id,
            **({"trace_id": req.trace_id} if req.trace_id else {}))
        self._prefill_into(slot, req, self._adapter.prefill_src(req))
        st["tok"][slot, 0] = req.bos_id
        st["pos"][slot] = 0
        if self._sampling:
            self._install_sampling(slot, req)
        self._adapter.install(st, slot, req)
        self._admit_seq += 1
        meta = _Active(req, self._admit_seq)
        self._slots[slot] = meta
        if req.prefix.size and not self._install_prefix(slot, meta, req):
            self._rollback_admit(slot, req)
            return False
        return True

    def _prefill_into(self, slot: int, req: Request, src) -> None:
        """Run (or reuse) the prefill for one admission and install its
        rows.  With the prefix cache on, a repeated prefill input reuses
        a cached device copy of its rows (the encoder memory of a
        repeated source)."""
        st = self._state
        pkey = (prefix_key("prefill", src) if self._prefix is not None
                else None)
        if pkey is not None:
            e = self._prefix.get(pkey, self._weight_generation)
            if e is not None:
                for name, row in e["payload"]["rows"].items():
                    st[name][slot] = row
                req.prefill_ms = 0.0
                if req.prefix_hit is None:
                    req.prefix_hit = True
                telemetry.record_serve_prefix(
                    kind="prefill", hit=True, tokens=int(req.tokens.size),
                    request_id=req.id, **self._trace_kw(req))
                return
        t0 = time.perf_counter()
        rows = self._adapter.prefill(torch.from_numpy(src).to(self._device))
        t1 = time.perf_counter()
        # dispatch wall, as the JAX engine stamps it
        req.prefill_ms = round((t1 - t0) * 1e3, 3)
        if telemetry.spans_enabled() \
                and (req.trace_id is None or req.sampled):
            telemetry.record_span("serve_prefill", t0, t1,
                                  request_id=req.id, **self._trace_kw(req))
        rows = {name: row[0] for name, row in rows.items()}
        for name, row in rows.items():
            st[name][slot] = row
        if pkey is not None:
            for d in self._prefix.put(pkey, "prefill",
                                      self._weight_generation,
                                      {"rows": rows, "owner": None}):
                self._release_prefix_entry(d)
            req.prefix_hit = False
            telemetry.record_serve_prefix(
                kind="prefill", hit=False, tokens=int(req.tokens.size),
                request_id=req.id, **self._trace_kw(req))

    @staticmethod
    def _trace_kw(req: Request) -> dict:
        return {"trace_id": req.trace_id} if req.trace_id else {}

    def _install_sampling(self, slot: int, req: Request) -> None:
        """Per-slot sampling state at admission.  The stream key is a
        function of the request's seed alone, so a re-admission after a
        preemption re-derives the same stream."""
        st = self._state
        st["temp"][slot] = req.temperature
        st["topk"][slot] = req.top_k
        st["topp"][slot] = req.top_p
        if req.seed is None:
            # stamped on the request so a preemption re-derives the
            # same stream (deterministic re-decode, like greedy)
            req.seed = int.from_bytes(os.urandom(4), "little")
        st["rng"][slot] = _sampling.seed_key(req.seed)

    # ------------------------------------------------------------------
    # prefix cache: copy-on-write page forks + teacher-forced ingest
    # ------------------------------------------------------------------
    def _install_prefix(self, slot: int, meta: _Active,
                        req: Request) -> bool:
        """Put the request's forced decoder prefix into the slot's KV
        pages: fork a cached entry's pages (hit) or teacher-force the
        tokens through ingest dispatches and register the result (miss).
        Returns False when the pool cannot hold the prefix even after
        dropping cache entries; the caller rolls the admission back."""
        T = int(req.prefix.size)
        key = (prefix_key(req.tokens, req.bos_id, req.prefix)
               if self._prefix is not None else None)
        if key is not None:
            e = self._prefix.get(key, self._weight_generation)
            if e is not None and self._fork_from_entry(slot, e, req):
                meta.pos = T
                if req.prefix_hit is None:
                    req.prefix_hit = True
                telemetry.record_serve_prefix(
                    kind="pages", hit=True, tokens=T, request_id=req.id,
                    **self._trace_kw(req))
                return True
        need = pages_for(T, self._ps) - len(self._cache.owned(slot))
        if not self._alloc_prefix_pages(slot, need):
            return False
        self._set_table(slot)
        self._ingest_prefix(slot, req)
        meta.pos = T
        if key is not None:
            self._register_prefix(slot, key, T)
            req.prefix_hit = False
            telemetry.record_serve_prefix(
                kind="pages", hit=False, tokens=T, request_id=req.id,
                **self._trace_kw(req))
        return True

    def _set_table(self, slot) -> None:
        self._state["table"][slot] = torch.from_numpy(
            self._cache.table_row(slot, self._P))

    def _copy_page(self, src: int, dst: int) -> None:
        """Device copy of one page, every layer's K and V."""
        for kp, vp in self._cache.pools:
            kp[dst] = kp[src]
            vp[dst] = vp[src]

    def _fork_from_entry(self, slot: int, e: dict, req: Request) -> bool:
        """Copy-on-write fork: adopt the entry's FULL pages (shared and
        refcounted; never written again, since the slot's first write
        lands at pos >= the prefix length) and copy the partial tail page
        into a private page the slot keeps writing.  The forked slot
        decodes over the exact rows the cold ingest wrote."""
        st = self._state
        T = int(e["payload"]["len"])
        pages = e["payload"]["pages"]
        full, tail = T // self._ps, T % self._ps
        if full:
            self._cache.adopt(slot, pages[:full])
        if tail:
            got = self._cache.alloc(slot, 1)
            if got is None and self._drop_one_prefix_entry():
                got = self._cache.alloc(slot, 1)
            if not got:
                self._cache.free_slot(slot)  # release the adoption
                st["table"][slot] = 0
                return False
            self._copy_page(pages[full], got[0])
        self._set_table(slot)
        st["pos"][slot] = T
        st["tok"][slot, 0] = int(req.prefix[-1])
        return True

    def _register_prefix(self, slot: int, key: str, T: int) -> None:
        """After a cold ingest: share the slot's full prefix pages into a
        cache entry and give the entry a private COPY of the partial tail
        page (the slot keeps writing its own tail at pos >= T; the
        entry's copy must stay frozen)."""
        full, tail = T // self._ps, T % self._ps
        self._admit_seq += 1  # unique owner key per registration
        ek = f"prefix:{key[:16]}:{self._admit_seq}"
        slot_pages = self._cache.owned(slot)
        entry_pages = list(slot_pages[:full])
        if full:
            self._cache.adopt(ek, entry_pages)
        if tail:
            got = self._cache.alloc(ek, 1)
            if got is None:
                # no room for the tail copy: register no partial entry
                self._cache.free_slot(ek)
                return
            self._copy_page(slot_pages[full], got[0])
            entry_pages.append(got[0])
        for d in self._prefix.put(key, "pages", self._weight_generation,
                                  {"owner": ek, "pages": entry_pages,
                                   "len": T}):
            self._release_prefix_entry(d)

    def _ingest_prefix(self, slot: int, req: Request) -> None:
        """Teacher-force [bos, p_1..p_{T-1}] into the slot's KV pages in
        ``_prefix_chunk``-sized ingest dispatches; afterwards the slot
        sits at pos = T with tok = p_T, the state T forced greedy steps
        would have left, so the continuation is the slow way's."""
        T = int(req.prefix.size)
        t0 = time.perf_counter()
        feed_seq = np.concatenate(
            [[req.bos_id], req.prefix[:-1]]).astype(np.int32)
        Kc = self._prefix_chunk
        done = 0
        while done < T:
            n = min(Kc, T - done)
            feed = np.zeros((self._S, Kc), np.int32)
            feed[slot, :n] = feed_seq[done:done + n]
            nvec = np.zeros((self._S,), np.int32)
            nvec[slot] = n
            self._ingest_body(self._to_device(feed), self._to_device(nvec))
            done += n
        self._state["tok"][slot, 0] = int(req.prefix[-1])
        if telemetry.spans_enabled() \
                and (req.trace_id is None or req.sampled):
            telemetry.record_span(
                "serve_ingest", t0, time.perf_counter(),
                request_id=req.id, tokens=T, **self._trace_kw(req))

    def _alloc_prefix_pages(self, slot: int, n: int) -> bool:
        """Allocate ``n`` pages for a prefix, dropping LRU cache entries
        under pool pressure (cached prefixes are recomputable; a live
        request costs a full re-decode)."""
        if n <= 0:
            return True
        while self._cache.alloc(slot, n) is None:
            if not self._drop_one_prefix_entry():
                return False
        return True

    def _drop_one_prefix_entry(self) -> bool:
        if self._prefix is None:
            return False
        e = self._prefix.pop_lru("pages")
        if e is None:
            return False
        self._release_prefix_entry(e)
        telemetry.record("serve_prefix_evict", executor="ServingEngine",
                         key=e["key"][:12], tokens=e["payload"]["len"])
        return True

    def _release_prefix_entry(self, e: dict) -> None:
        owner = e["payload"].get("owner")
        if owner is not None:
            self._cache.free_slot(owner)

    def _clear_slot_state(self, slot: int) -> None:
        """Free the slot's pages and zero its table, position, extra and
        sampling state."""
        st = self._state
        self._cache.free_slot(slot)
        st["table"][slot] = 0
        st["pos"][slot] = 0
        for name in self._extra_names + self._samp_names:
            st[name][slot] = 0

    def _rollback_admit(self, slot: int, req: Request) -> None:
        """Undo a partial admission (the prefix did not fit): the slot
        reads empty again; the caller parks the request at the queue head,
        like a preemption before any decode."""
        self._clear_slot_state(slot)
        self._state["tok"][slot] = 0
        self._slots[slot] = None
        req.t_admit = None
        req.prefill_ms = 0.0

    def _ensure_pages(self, burst: int) -> int:
        """Grow page tables so every active, unfinished slot can decode
        ``burst`` more positions; shrinks the burst when the pool runs
        dry.  Under real pool pressure (some slot cannot advance even one
        step) a cached prefix entry is dropped first; then the
        YOUNGEST-admitted request is preempted back to the queue head
        (recompute preemption — decode is deterministic, sampling too,
        so re-decoding reproduces its tokens) until the survivors can
        advance; a single request that cannot fit at all is a
        configuration error and raises."""
        while True:
            feas = self._grow_tables(burst)
            if feas > 0:
                return feas
            if self._drop_one_prefix_entry():
                continue
            cands = [(m.seq, slot, m) for slot, m in enumerate(self._slots)
                     if m is not None and not m.done]
            if len(cands) <= 1:
                raise MXNetError(
                    "paged KV pool cannot hold even one in-flight "
                    "request — raise pool_pages (or lower max_len); "
                    f"pool {self._cache.num_pages} pages of "
                    f"{self._ps} tokens")
            _, slot, meta = max(cands)
            self._preempt(slot, meta)

    def _grow_tables(self, burst: int) -> int:
        """One growth pass; returns the feasible burst (0 = some slot is
        starved)."""
        feas = burst
        for slot, meta in enumerate(self._slots):
            if meta is None or meta.done:
                continue
            rem = meta.req.max_new_tokens - len(meta.req.stream)
            want = min(burst, rem)
            need_pages = pages_for(meta.pos + want, self._ps)
            have = len(self._cache.owned(slot))
            if need_pages > have:
                if self._cache.alloc(slot, need_pages - have) is None:
                    # pool can't cover the whole growth: grab what's left
                    while (self._cache.pages_free
                           and len(self._cache.owned(slot)) < need_pages):
                        self._cache.alloc(slot, 1)
                self._set_table(slot)
            cap = self._cache.capacity_rows(slot)
            if cap - meta.pos < want:
                feas = min(feas, cap - meta.pos)
        return max(0, feas)

    def _evict(self, slot: int) -> None:
        """Free the slot's pages, zero its device state and empty it."""
        self._clear_slot_state(slot)
        self._slots[slot] = None

    def _preempt(self, slot: int, meta: _Active):
        """Evict a request mid-decode under pool pressure: its pages free
        NOW, and it returns to the queue HEAD to recompute from scratch
        (its stream resets; its TTFT re-stamps, still measured from the
        first submission)."""
        self._evict(slot)
        req = meta.req
        req.stream.tokens.clear()
        req.t_admit = None
        req.t_first_token = None
        req.prefill_ms = 0.0
        req.preemptions += 1
        telemetry.record("serve_preempt", request_id=req.id,
                         decoded=meta.pos, **self._trace_kw(req))
        self._sched.requeue(req)

    def _consume(self, handles):
        """Stream boundary: ONE host readback of the burst's tokens, then
        append to per-request streams, finish and evict completed
        requests so their pages free at once."""
        toks = torch.stack(handles).cpu().numpy()  # (burst, S)
        for row in toks:
            for slot, meta in enumerate(self._slots):
                if meta is None:
                    continue
                meta.pos += 1  # device pos advanced for every slot
                if meta.done:
                    continue
                req = meta.req
                tok = int(row[slot])
                req.stream.append(tok)
                if req.t_first_token is None:
                    # stream-boundary resolution: the burst's tokens land
                    # together, so TTFT stamps when the first one is
                    # host-visible
                    req.t_first_token = time.perf_counter()
                if tok == req.eos_id:
                    meta.done = True
                    req.stream.finish("eos")
                elif len(req.stream) >= req.max_new_tokens:
                    meta.done = True
                    req.stream.finish("length")
        for slot, meta in enumerate(self._slots):
            if meta is not None and meta.done:
                self._finish(slot, meta)

    def _finish(self, slot: int, meta: _Active) -> None:
        """Evict a completed request and record its ``serve_request``
        event, with the tail cause attributed from its breadcrumbs in the
        JAX engine's order: a preemption, then a weight-swap crossing,
        then a prefix-cache miss."""
        self._evict(slot)
        req = meta.req
        now = time.perf_counter()
        decode_ms = max(0.0, (now - req.t_admit) * 1e3
                        - req.prefill_ms) if req.t_admit else 0.0
        total_ms = ((now - req.t_submit) * 1e3
                    if req.t_submit is not None else None)
        if req.preemptions:
            cause = "preempt"
        elif (req.generation_at_admit is not None
              and req.generation_at_admit != self._weight_generation):
            cause = "swap"
        elif req.prefix_hit is False:
            cause = "cache_miss"
        else:
            cause = "none"
        telemetry.record_serve_request(
            queue_wait_ms=req.queue_wait_ms, prefill_ms=req.prefill_ms,
            decode_ms=round(decode_ms, 3), tokens=len(req.stream),
            ttft_ms=round(req.ttft_ms, 3),
            total_ms=round(total_ms, 3) if total_ms is not None else None,
            request_id=req.id, reason=req.stream.finish_reason,
            precision=self._precision, cause=cause,
            preemptions=req.preemptions,
            **({"trace_id": req.trace_id, "sampled": req.sampled}
               if req.trace_id else {}))

    # ------------------------------------------------------------------
    # introspection + batched beam serving
    # ------------------------------------------------------------------
    def statusz_snapshot(self) -> dict:
        """Engine status for a /statusz page: plain attribute reads, the
        JAX engine's keys."""
        snap = {
            "slots": self._S,
            "active_slots": sum(1 for m in self._slots if m is not None),
            "queue_depth": self._sched.depth,
            "queue_bound": self._sched.bound,
            "steps": self._step_n,
            "weight_generation": self._weight_generation,
            "precision": self._precision,
            "sampling": bool(self._sampling),
            "spec_k": self._spec_k,
            "max_len": self._max_len,
            "pages_free": self._cache.pages_free,
            "pages_total": self._cache.num_pages,
        }
        if self._prefix is not None:
            snap["prefix_entries"] = len(self._prefix)
            snap["prefix_hits"] = self._prefix.hits
            snap["prefix_misses"] = self._prefix.misses
        if self._spec_k:
            snap["spec_proposed"] = self._spec_proposed
            snap["spec_accepted"] = self._spec_accepted
        return snap

    def serve_beam(self, requests, beam_size: int = 4, alpha: float = 0.6,
                   sync_every: int = 8) -> Dict[str, np.ndarray]:
        """Batched beam serving: decode ``requests`` with the model's
        device-resident beam search (``translate``) in ONE batch per
        (bos, eos) group, and return {id: tokens} trimmed as the greedy
        engine streams them (bos dropped, cut just after eos).  No
        continuous batching or mid-flight joins; each request gets a
        ``beam_size``-wide search."""
        model = getattr(self._adapter, "model", None)
        if model is None or not hasattr(model, "translate"):
            raise MXNetError(
                "serve_beam needs an adapter exposing .model with "
                "translate() (the seq2seq TransformerAdapter)")
        requests = list(requests)
        groups: Dict[tuple, List[Request]] = {}
        for req in requests:
            if req.temperature > 0 or req.prefix.size:
                raise MXNetError(
                    f"request {req.id}: beam serving is search, not "
                    "sampling — temperature/prefix don't apply")
            groups.setdefault((req.bos_id, req.eos_id), []).append(req)
        out: Dict[str, np.ndarray] = {}
        for (bos, eos), grp in groups.items():
            t0 = time.perf_counter()
            src_w = max(int(r.tokens.size) for r in grp)
            src = np.zeros((len(grp), src_w), np.int32)
            for i, r in enumerate(grp):
                src[i, :r.tokens.size] = r.tokens
            max_new = max(r.max_new_tokens for r in grp)
            hyp = model.translate(
                torch.from_numpy(src).to(self._device), bos_id=bos,
                eos_id=eos, max_len=max_new + 1, beam_size=beam_size,
                alpha=alpha, sync_every=sync_every, page_size=self._ps)
            ms = round((time.perf_counter() - t0) * 1e3, 3)
            for i, r in enumerate(grp):
                toks = list(hyp[i, 1:])  # column 0 is bos
                if eos in toks:
                    toks = toks[:toks.index(eos) + 1]
                toks = toks[:r.max_new_tokens]
                for t in toks:
                    r.stream.append(t)
                r.stream.finish("eos" if (toks and toks[-1] == eos)
                                else "length")
                out[r.id] = r.stream.asarray()
                telemetry.record_serve_request(
                    queue_wait_ms=0.0, prefill_ms=0.0, decode_ms=ms,
                    tokens=len(toks), ttft_ms=ms, total_ms=ms,
                    request_id=r.id, reason=r.stream.finish_reason,
                    precision=self._precision, beam=beam_size)
        return out
