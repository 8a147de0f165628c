"""Continuous-batching inference engine: one decode step shared by ragged
in-flight requests.

Counterpart of ``mxnet_tpu/serving/engine.py`` (greedy decoding only).
The hot loop runs one decode step over ``S`` fixed decode *slots*; every
input keeps its shape from step to step — per-slot positions, page
tables and lengths are tensor VALUES — so mixed-length requests arriving
mid-flight share one step.  Prefill (the encoder, for the seq2seq
Transformer) runs once per admission over the source padded to a fixed
length.

Dispatch follows the JAX engine's burst semantics: ``_dispatch_step``
chains device state to device state and returns the step's token tensor
without waiting for it; ``stream_every`` steps are dispatched before one
host readback of all their tokens (``_consume``), which does the
scheduler bookkeeping (EOS frees the slot's KV pages at once; waiting
requests join mid-flight).  Nothing on the dispatch path calls
``.item()`` or ``.cpu()``.

Any model servable here implements :class:`ServingAdapter`;
:class:`TransformerAdapter` serves ``models.transformer.Transformer`` on
the paged KV cache, whose self-attention is kernel K2 and whose
LayerNorms are kernel K1.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..base import MXNetError
from ..context import resolve_device
from .paged_cache import (PagedKVCache, PagedStepCache, page_coords,
                          pages_for, torch_dtype)
from .scheduler import ContinuousBatchingScheduler, Request

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

    def decode(self, tok, pos, table, pages, rows, lengths, extra, pools):
        """Greedy decode of ONE position for every slot: the argmax over
        log-softmax of :meth:`decode_logits` (the JAX engine's
        selection, token for token).  Returns (S,) int32."""
        logits = self.decode_logits(tok, pos, table, pages, rows, lengths,
                                    extra, pools)
        return torch.argmax(torch.log_softmax(logits, dim=-1),
                            dim=-1).to(torch.int32)


class TransformerAdapter(ServingAdapter):
    """``models.transformer.Transformer`` seq2seq decode on the paged KV
    cache.  Prefill = the encoder over the source padded to
    ``src_max_len``; decode = ``Transformer._decode_step``, greedy.  The
    model is put in eval mode: serving never runs dropout."""

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
    in which every slot can reach ``max_len`` (``pool_pages=None``), and
    a token readback every 4 steps.  ``device`` defaults to
    :func:`context.default_device` (``cuda:0``; raises without CUDA).
    ``dtype`` ("float32", "bfloat16" or "float16", as the JAX engine's)
    is the type of the KV pools and of the adapter's floating state (the
    Transformer's encoder memory); the model's weights and the queries
    stay as they are, and kernel K2 reads the pools in their type.

    ``burst_times`` collects (steps, seconds) per dispatch burst, from
    the first dispatch to the end of the burst's token readback."""

    def __init__(self, adapter: ServingAdapter, slots: int = 8,
                 page_size: int = 16, pool_pages: Optional[int] = None,
                 max_len: int = 64, stream_every: int = 4, device=None,
                 dtype: str = "float32"):
        self._adapter = adapter
        self._device = resolve_device(device)
        self._dtype = torch_dtype(dtype)
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
        # boundary) land on zero -> the trash page, never a live page
        self._P = pages_for(self._max_len + self._stream_every, self._ps)
        self._sched = ContinuousBatchingScheduler()
        self._slots: List[Optional[_Active]] = [None] * self._S
        self._arrivals: List = []  # (arrive_at_step, request), sorted
        self._step_n = 0
        self._admit_seq = 0
        self.burst_times: List[Tuple[int, float]] = []

        dev = self._device
        state = OrderedDict(
            tok=torch.zeros((self._S, 1), dtype=torch.int32, device=dev),
            pos=torch.zeros((self._S,), dtype=torch.int32, device=dev),
            table=torch.zeros((self._S, self._P), dtype=torch.int32,
                              device=dev))
        extra = adapter.extra_state(self._S, dev, self._dtype)
        self._extra_names = list(extra)
        state.update(extra)
        self._state = state

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def submit(self, request: Request) -> Request:
        if request.max_new_tokens > self._max_len:
            raise MXNetError(
                f"request {request.id} max_new_tokens "
                f"{request.max_new_tokens} > engine max_len "
                f"{self._max_len}")
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

    @torch.no_grad()
    def run(self, max_steps: int = 1_000_000) -> None:
        """Drive the engine until queue, arrivals and slots are empty."""
        guard = 0
        while True:
            self._pump_arrivals()
            self._admit_ready()
            if not any(m is not None for m in self._slots):
                if self._arrivals:
                    # idle: fast-forward the step clock to the next join
                    self._step_n = max(self._step_n, self._arrivals[0][0])
                    continue
                if self._sched.depth:
                    raise MXNetError(
                        "serving queue non-empty but no request "
                        "admissible (pool/config too small?)")
                break
            burst = self._ensure_pages(self._stream_every)
            t0 = time.perf_counter()
            handles = [self._dispatch_step() for _ in range(burst)]
            self._consume(handles)
            self.burst_times.append((burst, time.perf_counter() - t0))
            guard += burst
            if guard > max_steps:
                raise MXNetError(f"serving run exceeded {max_steps} decode "
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
    # the hot dispatch body: no host syncs
    # ------------------------------------------------------------------
    def _decode_body(self):
        st = self._state
        tok, pos, table = st["tok"], st["pos"], st["table"]
        lengths = pos + 1  # rows valid incl. the one written this step
        pages, rows = page_coords(table, pos, self._ps)
        extra = {k: st[k] for k in self._extra_names}
        nxt = self._adapter.decode(tok, pos, table, pages, rows, lengths,
                                   extra, self._cache.pools)
        st["tok"] = nxt.reshape(self._S, 1)
        st["pos"] = pos + 1
        return nxt

    def _dispatch_step(self):
        """Dispatch ONE decode step: device state chains to device state;
        the step's (S,) token tensor is returned without waiting for
        it."""
        toks = self._decode_body()
        self._step_n += 1
        return toks

    # ------------------------------------------------------------------
    # host-side scheduling (stream boundaries only)
    # ------------------------------------------------------------------
    def _pump_arrivals(self):
        while self._arrivals and self._arrivals[0][0] <= self._step_n:
            _, req = self._arrivals.pop(0)
            self.submit(req)

    def _admit_ready(self) -> None:
        free = [i for i, m in enumerate(self._slots) if m is None]
        if not free or not self._sched.depth:
            return
        ready = self._sched.pop_ready(len(free), self._cache.pages_free)
        for slot, req in zip(free, ready):
            self._admit(slot, req)

    def _admit(self, slot: int, req: Request) -> None:
        st = self._state
        self._prefill_into(slot, self._adapter.prefill_src(req))
        st["tok"][slot, 0] = req.bos_id
        st["pos"][slot] = 0
        self._admit_seq += 1
        self._slots[slot] = _Active(req, self._admit_seq)

    def _prefill_into(self, slot: int, src) -> None:
        """Run the prefill for one admission and install its rows."""
        st = self._state
        rows = self._adapter.prefill(
            torch.from_numpy(src).to(self._device))
        for name, row in rows.items():
            st[name][slot] = row[0]

    def _ensure_pages(self, burst: int) -> int:
        """Grow page tables so every active, unfinished slot can decode
        ``burst`` more positions; shrinks the burst when the pool runs
        dry.  Under real pool pressure (some slot cannot advance even one
        step) the YOUNGEST-admitted request is preempted back to the
        queue head (recompute preemption — greedy decode is
        deterministic, so re-decoding reproduces its tokens) until the
        survivors can advance; a single request that cannot fit at all
        is a configuration error and raises."""
        while True:
            feas = self._grow_tables(burst)
            if feas > 0:
                return feas
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
        st = self._state
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
                st["table"][slot] = torch.from_numpy(
                    self._cache.table_row(slot, self._P))
            cap = self._cache.capacity_rows(slot)
            if cap - meta.pos < want:
                feas = min(feas, cap - meta.pos)
        return max(0, feas)

    def _evict(self, slot: int) -> None:
        """Free the slot's pages, zero its device state and empty it."""
        st = self._state
        self._cache.free_slot(slot)
        st["table"][slot] = 0
        st["pos"][slot] = 0
        for name in self._extra_names:
            st[name][slot] = 0
        self._slots[slot] = None

    def _preempt(self, slot: int, meta: _Active):
        """Evict a request mid-decode under pool pressure: its pages free
        NOW, and it returns to the queue HEAD to recompute from scratch
        (its stream resets)."""
        self._evict(slot)
        req = meta.req
        req.stream.tokens.clear()
        req.preemptions += 1
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
                if tok == req.eos_id:
                    meta.done = True
                    req.stream.finish("eos")
                elif len(req.stream) >= req.max_new_tokens:
                    meta.done = True
                    req.stream.finish("length")
        for slot, meta in enumerate(self._slots):
            if meta is not None and meta.done:
                self._evict(slot)
