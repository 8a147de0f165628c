"""Runtime telemetry: step metrics, retrace detection, heartbeats, and a
flight recorder.

The counterpart of ``mxnet_tpu/telemetry.py`` (stdlib only), kept as the
port's own copy: the port's process-wide recorder is a second recorder,
not the JAX package's.  Event kinds, field names, file names and metric
names are the JAX module's letter for letter, so ``tools/trace_report.py``,
``tools/serve_report.py``, ``tools/mem_report.py`` and ``tools/launch.py``
read the port's streams unchanged.  What reports into it:

  * step events (the Gluon ``Trainer``): wall time, first-call vs
    steady-state steps, samples/sec;
  * **retrace detection**: an executor reports its call signature; more
    than ``MX_TELEMETRY_RETRACE_LIMIT`` distinct signatures warns once
    (then at each doubling), naming the newest;
  * collective and fused-update events;
  * checkpoint lifecycle events (save/load durations, digest fallbacks)
    from ``checkpoint.py``;
  * serving events from ``serving/engine.py`` and ``serving/router.py``
    (``serve_request``, ``serve_state``, ``serve_prefix``,
    ``spec_verify``, ``weight_swap``, ``serve_failover``, ...);
  * **per-rank heartbeat files** (step + timestamp, atomically renamed)
    that the ``tools/launch.py`` supervisor polls.

Disabled (no ``MX_TELEMETRY_DIR``) the recorder no-ops: ``record*()`` and
``heartbeat()`` return at once.  ``MX_TELEMETRY_RETRACE_LIMIT=0`` turns
retrace detection off.

On-disk layout under ``MX_TELEMETRY_DIR`` (one stream per rank; the
filename patterns are mirrored in tools/launch.py)::

    rank-<R>.jsonl        append-only event stream, one JSON object/line:
                          {"t": <unix sec>, "kind": "...", "rank": R, ...}
    heartbeat-<R>.json    {"rank": R, "step": S, "time": <unix sec>,
                          "pid": P, "restart": K} — atomically replaced at
                          most every MX_HEARTBEAT_SEC seconds

Events buffer in memory (bounded) and a daemon thread flushes them every
``MX_TELEMETRY_FLUSH_SEC`` seconds; the last ``RING_SIZE`` events also live
in an in-process ring (the flight recorder) surfaced by ``summary()`` /
``flight_tail()``.

**Spans**: ``span(name, **attrs)`` emits nested span events stamped with
the per-process monotonic clock (``mono``); ``paired=True`` emits
``span_begin``/``span_end`` pairs for blocking regions.  A ``clock_anchor``
event (a ``(time.time(), perf_counter())`` pair written at enable() and on
every flush) lets ``export_chrome_trace`` and ``tools/trace_report.py``
merge per-rank files onto one wall timeline.  Spans measure the HOST: a
span around a CUDA dispatch measures enqueue time, not device time; only
a readback (a stream boundary) synchronises.  ``MX_TELEMETRY_SPANS=0`` is
the kill switch.  ``render_prometheus(mode)`` renders an OpenMetrics
exposition of the ``summary()`` rollups behind two sinks:
``export_prometheus(path)`` (a file snapshot, ``mode="atexit"``) and the
live per-rank HTTP endpoint of ``mxnet_tpu_torch.metrics_server``
(``MX_METRICS_PORT``; ``mode="live"``).  ``MX_TRACE_EXPORT`` (default off)
runs the file exports at process exit.
"""
from __future__ import annotations

import atexit
import itertools
import json
import logging
import math
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["enabled", "enable", "disable", "record", "record_step",
           "record_collective", "record_fused_update", "record_block_wait",
           "record_serve_request", "record_serve_state",
           "record_serve_cause", "recent_requests",
           "heartbeat", "note_signature", "summary", "flight_tail", "flush",
           "reset", "rank", "event_path", "heartbeat_path", "RING_SIZE",
           "span", "record_span", "spans_enabled", "export_chrome_trace",
           "export_prometheus", "render_prometheus", "health_snapshot",
           "stale_after_sec"]

_LOG = logging.getLogger("mxnet_tpu_torch.telemetry")

# flight-recorder depth (in-process ring; the supervisor reads the JSONL
# file's tail instead, so this only bounds summary()/flight_tail())
RING_SIZE = 256
# nudge the flusher thread awake when this many events are pending, so
# serialization + disk I/O happen OFF the hot path (span tracing at ~10
# events/step would otherwise pay an inline flush every dozen steps)
_FLUSH_PENDING_MAX = 128
# hard backstop: if the flusher thread cannot keep up (or died), the
# recording thread flushes inline rather than growing memory unbounded
_FLUSH_PENDING_HARD = 4096
# distinct jit signatures one executor may accumulate before the retrace
# warning fires (override: MX_TELEMETRY_RETRACE_LIMIT)
_RETRACE_LIMIT_DEFAULT = 5


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def event_path(directory: str, rank_id: int) -> str:
    """Per-rank JSONL event stream path (mirrored in tools/launch.py)."""
    return os.path.join(directory, f"rank-{rank_id}.jsonl")


def heartbeat_path(directory: str, rank_id: int) -> str:
    """Per-rank heartbeat file path (mirrored in tools/launch.py)."""
    return os.path.join(directory, f"heartbeat-{rank_id}.json")


def rank() -> int:
    """This process's gang rank (0 for single-process runs)."""
    try:
        return int(os.environ.get("MX_PROC_ID",
                                  os.environ.get("DMLC_WORKER_ID", "0")))
    except (TypeError, ValueError):
        return 0


# ---------------------------------------------------------------------------
# recorder state
# ---------------------------------------------------------------------------
class _State:
    """All mutable recorder state in one bag so reset() is atomic."""

    def __init__(self):
        self.lock = threading.RLock()
        # serializes the actual file append: flush() may run concurrently
        # on the daemon flusher, an inline >=128-pending flush, and
        # atexit — interleaved write(2) calls would tear JSONL lines
        self.write_lock = threading.Lock()
        self.dir: Optional[str] = None
        self.rank: int = 0
        self.enabled = False
        self.ring: deque = deque(maxlen=RING_SIZE)
        # pending holds raw event DICTS: json serialization happens at
        # flush time (flusher thread / atexit), not on the hot path
        self.pending: List[dict] = []
        self.counts: Dict[str, int] = {}
        # executor -> {count, first_ms, total_ms, samples, bytes}
        self.steps: Dict[str, Dict[str, float]] = {}
        self.coll = {"count": 0, "bytes": 0, "total_ms": 0.0,
                     "compile_ms": 0.0}
        self.fused = {"count": 0, "n_params": 0, "n_buckets": 0,
                      "bytes": 0, "jitted_calls": 0}
        # serving rollups (docs/SERVING.md §SLO telemetry): per-request
        # aggregates + a bounded reservoir of end-to-end latencies for
        # the rolling p50/p99, + the queue/slot gauges the engine stamps
        # at every stream boundary
        self.serve = {"requests": 0, "tokens": 0, "queue_wait_ms": 0.0,
                      "prefill_ms": 0.0, "decode_ms": 0.0,
                      "lat_ms": deque(maxlen=512),
                      "ttft_ms": deque(maxlen=512),
                      "slo_ttft": 0, "slo_tpot": 0,
                      "queue_depth": 0, "active_slots": 0,
                      # precision label of the serving engine's compiled
                      # decode program (fp32 / int8 — docs/PRECISION.md)
                      "precision": "fp32",
                      # zero-downtime hot-swap counters: which weight
                      # generation is serving and how many swaps applied
                      # (docs/SERVING.md §Weight hot-swap)
                      "weight_generation": 0, "weight_swaps": 0,
                      # prefix-cache counters (docs/SERVING.md §Prefix
                      # cache): hits/misses across both entry kinds +
                      # how many prefix tokens skipped recompute
                      "prefix_hits": 0, "prefix_misses": 0,
                      "prefix_tokens_reused": 0,
                      # speculative decoding (§Speculative decoding):
                      # lifetime draft tokens proposed/accepted — the
                      # acceptance rate IS the speedup lever
                      "spec_rounds": 0, "spec_proposed": 0,
                      "spec_accepted": 0,
                      # request-tracing cause attribution (docs/
                      # OBSERVABILITY.md §Request tracing): completed
                      # requests bucketed by attributed tail cause
                      # (preempt/swap/cache_miss/failover/none) + one
                      # exemplar trace id per cause — the prometheus
                      # exemplar stand-in, bounded at one series/cause
                      "causes": {}, "cause_exemplars": {}}
        # newest completed requests (request_id/trace_id/cause/latency):
        # the per-rank /tracez ring metrics_server serves, sized by
        # MX_RQTRACE_TRACEZ_K at enable() (default 32)
        self.serve_recent: deque = deque(maxlen=32)
        # newest in-flight dispatch-window depth any executor reported
        # (record_step's inflight_depth field) — a /healthz input
        self.inflight_depth = 0
        self.ckpt = {"saves": 0, "save_ms": 0.0, "save_bytes": 0,
                     "loads": 0, "load_ms": 0.0, "fallbacks": 0}
        # executor -> {"sigs": set, "traces": int, "warned_at": int,
        #              "last_sig": str}
        self.retraces: Dict[str, Dict[str, Any]] = {}
        # span name -> {count, total_ms, max_ms}
        self.spans: Dict[str, Dict[str, float]] = {}
        self.flusher: Optional[threading.Thread] = None
        # record() sets this when pending crosses _FLUSH_PENDING_MAX so
        # the flusher wakes immediately instead of at its next cadence
        self.flush_wake = threading.Event()
        self.flush_sec = 1.0
        self.hb_interval = 5.0
        self.hb_last = 0.0
        self.hb_wall = 0.0
        self.hb_step = -1


_state = _State()


def enabled() -> bool:
    return _state.enabled


def enable(directory: Optional[str] = None) -> None:
    """Attach the JSONL sink (and heartbeats).  With no argument, reads
    ``MX_TELEMETRY_DIR``; a missing/empty directory leaves the recorder
    disabled.  Idempotent; safe to call from any thread."""
    directory = directory or os.environ.get("MX_TELEMETRY_DIR")
    if not directory:
        return
    with _state.lock:
        if _state.enabled and _state.dir == directory:
            return
        os.makedirs(directory, exist_ok=True)
        _state.dir = directory
        _state.rank = rank()
        _state.flush_sec = max(0.05, _env_float("MX_TELEMETRY_FLUSH_SEC", 1.0))
        _state.hb_interval = max(0.0, _env_float("MX_HEARTBEAT_SEC", 5.0))
        k = max(1, int(_env_float("MX_RQTRACE_TRACEZ_K", 32)))
        if k != _state.serve_recent.maxlen:
            _state.serve_recent = deque(_state.serve_recent, maxlen=k)
        _state.enabled = True
        if _state.flusher is None:
            _state.flusher = threading.Thread(
                target=_flusher_loop, name="mx-telemetry-flush", daemon=True)
            _state.flusher.start()
    record("start", pid=os.getpid(),
           restart=int(os.environ.get("MX_RESTART_COUNT", "0") or 0))
    # wall<->monotonic anchor: the merge key export_chrome_trace /
    # trace_report use to put every rank's mono-stamped spans on one wall
    # timeline (re-emitted on each flush — see flush())
    record("clock_anchor", wall=round(time.time(), 6),
           mono=round(time.perf_counter(), 6))


def disable() -> None:
    """Detach the sink (pending events are flushed first)."""
    flush()
    with _state.lock:
        _state.enabled = False


def reset() -> None:
    """Drop all aggregates, ring contents, and retrace history (tests)."""
    global _state
    flush()
    with _state.lock:
        fl = _state.flusher
        _state = _State()
        _state.flusher = fl  # one flusher thread per process is plenty


def _flusher_loop() -> None:
    while True:
        _state.flush_wake.wait(_state.flush_sec)
        _state.flush_wake.clear()
        try:
            flush()
        except Exception:  # a full disk must not kill the training process
            pass


def flush() -> None:
    """Append pending events to this rank's JSONL file.  Every batch ends
    with a fresh ``clock_anchor`` line (wall + monotonic pair): anchors are
    re-emitted so a merged-trace reader always finds one near the events it
    aligns, tolerating rank start-time skew and wall-clock steps."""
    st = _state
    # write_lock brackets snapshot + serialize + append: two concurrent
    # flushes (flusher thread vs the 4096-pending backstop or atexit)
    # must not reorder batches on disk — a span_begin landing after its
    # span_end would silently drop the pair from every trace consumer.
    # record() never touches write_lock, so the hot path is unaffected.
    with st.write_lock:
        with st.lock:
            if not st.pending or st.dir is None:
                return
            events, st.pending = st.pending, []
            path = event_path(st.dir, st.rank)
            rank_id = st.rank
        lines = []
        for ev in events:
            try:
                lines.append(json.dumps(ev) + "\n")
            except (TypeError, ValueError):
                ev = {k: (v if isinstance(v, (int, float, str, bool,
                                              type(None)))
                          else str(v)) for k, v in ev.items()}
                lines.append(json.dumps(ev) + "\n")
        wall = time.time()
        lines.append(json.dumps(
            {"t": round(wall, 4), "kind": "clock_anchor", "rank": rank_id,
             "wall": round(wall, 6),
             "mono": round(time.perf_counter(), 6)}) + "\n")
        try:
            with open(path, "a") as f:
                f.write("".join(lines))
        except OSError as e:
            _LOG.warning("telemetry flush to %s failed: %s", path, e)


atexit.register(flush)


# ---------------------------------------------------------------------------
# span tracing
# ---------------------------------------------------------------------------
_SPAN_IDS = itertools.count(1)
_span_local = threading.local()  # per-thread nesting stack of span ids


def spans_enabled() -> bool:
    """Spans ride the recorder: on whenever telemetry is on, unless
    ``MX_TELEMETRY_SPANS=0`` kills them (the knob exists so a production
    run can keep step events + heartbeats while dropping the ~8 extra
    events per step the span layer adds)."""
    if not _state.enabled:
        return False
    return os.environ.get("MX_TELEMETRY_SPANS", "1").lower() not in (
        "0", "false", "off")


class _NullSpan:
    """Shared no-op context manager: span() allocates nothing when off."""

    __slots__ = ()

    span_id = 0  # parity with _Span: propagation call sites need an int

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


_NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_name", "_attrs", "_id", "_t0", "_parent", "_depth",
                 "_paired")

    def __init__(self, name: str, attrs: dict, paired: bool):
        self._name = name
        self._attrs = attrs
        self._paired = paired
        self._id = 0

    @property
    def span_id(self) -> int:
        """This span's id once entered (0 before) — what the Router puts
        in the outgoing ``X-MX-Trace`` ``parent=`` field so a replica can
        name its upstream span."""
        return self._id

    def __enter__(self):
        stack = getattr(_span_local, "stack", None)
        if stack is None:
            stack = _span_local.stack = []
        self._id = next(_SPAN_IDS)
        self._parent = stack[-1] if stack else 0
        self._depth = len(stack)
        stack.append(self._id)
        self._t0 = time.perf_counter()
        if self._paired:
            # mono is THE ordering/merge key (export_chrome_trace aligns
            # it to the gang wall timeline via the clock_anchor events);
            # the event's own "t" stays the wall stamp for humans reading
            # raw JSONL
            record("span_begin", name=self._name, span=self._id,
                   parent=self._parent, depth=self._depth,
                   tid=threading.get_ident(),
                   mono=round(self._t0, 6), **self._attrs)
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = time.perf_counter()
        dur_ms = (t1 - self._t0) * 1e3
        stack = getattr(_span_local, "stack", None)
        if stack and stack[-1] == self._id:
            stack.pop()
        elif stack and self._id in stack:
            # a nested span leaked past its parent's exit (exception taking
            # a non-local path): unwind to self so nesting self-heals
            del stack[stack.index(self._id):]
        with _state.lock:
            agg = _state.spans.setdefault(
                self._name, {"count": 0, "total_ms": 0.0, "max_ms": 0.0})
            agg["count"] += 1
            agg["total_ms"] += dur_ms
            agg["max_ms"] = max(agg["max_ms"], dur_ms)
        if self._paired:
            end = dict(name=self._name, span=self._id,
                       tid=threading.get_ident(), mono=round(t1, 6),
                       dur_ms=round(dur_ms, 3))
            if exc_type is not None:
                end["error"] = exc_type.__name__
            record("span_end", **end)
        else:
            # one complete event for the whole region: half the event
            # volume of a begin/end pair — the hot-path per-step form
            ev = dict(name=self._name, span=self._id, parent=self._parent,
                      depth=self._depth, tid=threading.get_ident(),
                      mono=round(self._t0, 6), dur_ms=round(dur_ms, 3),
                      **self._attrs)
            if exc_type is not None:
                ev["error"] = exc_type.__name__
            record("span", **ev)
        return False


def record_span(name: str, t0: float, t1: float, **attrs) -> None:
    """Retroactively emit one completed span from a measured
    ``perf_counter`` interval — the zero-cost-when-idle form for hot-path
    waits that usually DON'T happen (a non-blocking ``make_room``): the
    caller times the interval with two perf_counter reads and records a
    span only when it actually waited, instead of paying events per step
    for a 0ms fact.  Emitted with correct nesting metadata (parent = the
    caller's current open span) so the merged trace renders it exactly
    like a ``span()`` region."""
    if not spans_enabled():
        return
    dur_ms = (t1 - t0) * 1e3
    sid = next(_SPAN_IDS)
    stack = getattr(_span_local, "stack", None)
    parent = stack[-1] if stack else 0
    depth = len(stack) if stack else 0
    record("span", name=name, span=sid, parent=parent, depth=depth,
           tid=threading.get_ident(), mono=round(t0, 6),
           dur_ms=round(dur_ms, 3), **attrs)
    with _state.lock:
        agg = _state.spans.setdefault(
            name, {"count": 0, "total_ms": 0.0, "max_ms": 0.0})
        agg["count"] += 1
        agg["total_ms"] += dur_ms
        agg["max_ms"] = max(agg["max_ms"], dur_ms)


def span(name: str, paired: bool = False, **attrs):
    """Context manager tracing one nested timing region, carrying a span
    id, the parent span's id, nesting ``depth``, the thread id, and the
    monotonic clock — everything ``export_chrome_trace`` /
    ``tools/trace_report.py`` need to rebuild the gang timeline.  Returns
    a shared no-op object when spans are off, so hot paths pay one env
    check when disabled.

    By default the whole region lands as ONE complete ``span`` event at
    exit (half the event volume — the per-step hot-path form).
    ``paired=True`` emits ``span_begin``/``span_end`` events instead: use
    it for regions that BLOCK (device waits, collectives, checkpoint
    I/O), where a crashed/hung rank's flight-recorder tail must show the
    still-open ``span_begin`` — "died inside X" is the post-mortem
    answer.  (``paired`` is reserved; it cannot be used as an attr name.)

    Spans measure HOST wall between enter and exit: around an async CUDA
    dispatch that is dispatch cost, not device time (the same contract as
    ``record_step`` — see its docstring)."""
    if not spans_enabled():
        return _NULL_SPAN
    return _Span(name, attrs, paired)


# ---------------------------------------------------------------------------
# event recording
# ---------------------------------------------------------------------------
def record(kind: str, **fields) -> None:
    """Record one event.  No-op unless the recorder is enabled.

    Span begin/end events skip the in-process flight ring: at ~8 per step
    they would evict the step/collective/checkpoint history the ring
    exists to preserve for post-mortems.  They still hit the JSONL sink
    (the analysis surface) and the ``summary()`` span aggregates."""
    if not _state.enabled:
        return
    ev = {"t": round(time.time(), 4), "kind": kind, "rank": _state.rank}
    ev.update(fields)
    with _state.lock:
        _state.counts[kind] = _state.counts.get(kind, 0) + 1
        if not kind.startswith("span"):
            _state.ring.append(ev)
        _state.pending.append(ev)
        n_pending = len(_state.pending)
    if n_pending >= _FLUSH_PENDING_MAX:
        if n_pending >= _FLUSH_PENDING_HARD or _state.flusher is None:
            flush()  # backstop: never let a stalled flusher grow memory
        else:
            _state.flush_wake.set()  # serialization + I/O off the hot path


def record_step(executor: str, step: int, wall_s: float,
                samples: Optional[int] = None, transfer_bytes: int = 0,
                traced: bool = False, h2d_overlapped: int = 0,
                **fields) -> None:
    """One executor step.  ``traced=True`` marks a first-call/retrace step
    whose wall time includes trace+compile; those are aggregated separately
    so steady-state samples/sec is not polluted by compile time.

    ``wall_s`` is the python-side wall of the step call — the recorder
    deliberately does NOT block_until_ready (forcing a device sync per
    step would serialize the dispatch pipeline the observability layer is
    meant to leave undisturbed).  Under async dispatch a single step's
    wall is dispatch cost, not device time; over a sustained loop the
    dispatch queue backpressures and per-step walls converge to true step
    cadence, so the AGGREGATES (mean_exec_ms, samples_per_sec over many
    steps) are meaningful while the first few per-step numbers undercount.
    For exact per-program device times use mx.profiler (its timed_call
    blocks by design).

    ``h2d_overlapped`` counts the subset of ``transfer_bytes`` that a
    device prefetcher staged in the background (already resident when the
    step ran) — the async-pipeline overlap evidence.  Extra async fields
    travel via ``**fields``: ``inflight_depth`` (pending window depth
    after this dispatch) and ``block_wait_ms`` (time this dispatch spent
    blocked because the window was full)."""
    if not _state.enabled:
        return
    wall_ms = wall_s * 1e3
    with _state.lock:
        st = _state.steps.setdefault(executor, _new_step_agg())
        st["count"] += 1
        if traced:
            st["compile_count"] += 1
            st["compile_ms"] += wall_ms
        else:
            st["exec_ms"] += wall_ms
            if samples:
                st["samples"] += int(samples)
        st["bytes"] += int(transfer_bytes)
        st["overlap_bytes"] += int(h2d_overlapped)
        if "inflight_depth" in fields:
            _state.inflight_depth = int(fields["inflight_depth"])
    ev = dict(executor=executor, step=int(step), wall_ms=round(wall_ms, 3),
              traced=bool(traced), **fields)
    if samples is not None:
        ev["samples"] = int(samples)
        if wall_s > 0:
            ev["samples_per_sec"] = round(samples / wall_s, 2)
    if transfer_bytes:
        ev["transfer_bytes"] = int(transfer_bytes)
    if h2d_overlapped:
        ev["h2d_overlapped"] = int(h2d_overlapped)
    record("step", **ev)


def _new_step_agg() -> Dict[str, float]:
    return {"count": 0, "compile_count": 0, "compile_ms": 0.0,
            "exec_ms": 0.0, "samples": 0, "bytes": 0,
            "overlap_bytes": 0, "block_wait_ms": 0.0}


def record_block_wait(executor: str, wall_s: float) -> None:
    """Host time spent BLOCKED on the device for one executor: a forced
    readback (``AsyncLoss.wait``), a full in-flight window, or a fence
    sync.  Aggregate-only (no per-event line — a hot loop forces every
    step); ``summary()['steps'][executor]['block_wait_ms']`` is the
    rollup that shows how much wall time the host truly lost to the
    device, the before/after number for the async pipeline."""
    if not _state.enabled or wall_s <= 0:
        return
    with _state.lock:
        st = _state.steps.setdefault(executor, _new_step_agg())
        st["block_wait_ms"] += wall_s * 1e3


def record_collective(op: str, nbytes: int, wall_s: float,
                      traced: bool = False, **fields) -> None:
    """One collective (kvstore reduce, global allreduce, ...).

    ``traced=True`` marks a first-use call whose wall includes the
    first-call setup of the collective; it aggregates into
    ``compile_ms`` so comm cost is never conflated with compile cost."""
    if not _state.enabled:
        return
    with _state.lock:
        _state.coll["count"] += 1
        _state.coll["bytes"] += int(nbytes)
        if traced:
            _state.coll["compile_ms"] += wall_s * 1e3
        else:
            _state.coll["total_ms"] += wall_s * 1e3
    record("collective", op=op, nbytes=int(nbytes),
           wall_ms=round(wall_s * 1e3, 3), traced=bool(traced), **fields)


def record_fused_update(n_params: int, n_buckets: int, nbytes: int,
                        n_jitted_calls: int, **fields) -> None:
    """One fused optimizer step (docs/PERFORMANCE.md): how many params
    updated, through how many gradient buckets and jitted update calls —
    the before/after evidence that the O(n_params) dispatch storm
    collapsed to O(1).  Aggregated under ``summary()['fused_update']``."""
    if not _state.enabled:
        return
    with _state.lock:
        f = _state.fused
        f["count"] += 1
        f["n_params"] += int(n_params)
        f["n_buckets"] += int(n_buckets)
        f["bytes"] += int(nbytes)
        f["jitted_calls"] += int(n_jitted_calls)
    record("fused_update", n_params=int(n_params), n_buckets=int(n_buckets),
           nbytes=int(nbytes), n_jitted_calls=int(n_jitted_calls), **fields)


def _slo_ms(name: str) -> float:
    """A latency SLO threshold in ms; 0/unset/garbage = no SLO."""
    return max(0.0, _env_float(name, 0.0))


def record_serve_request(queue_wait_ms: float = 0.0,
                         prefill_ms: float = 0.0, decode_ms: float = 0.0,
                         tokens: int = 0, ttft_ms: float = 0.0,
                         total_ms: Optional[float] = None,
                         **fields) -> None:
    """One COMPLETED serving request (mxnet_tpu_torch.serving.engine): how
    long it queued, the prefill dispatch wall, the decode wall, how
    many tokens it produced, and the submission->first-token wall
    (``ttft_ms``, queue wait included — the user-visible TTFT, stamped
    at stream-boundary resolution).  End-to-end
    latency (the SLO number) is ``total_ms`` when the caller measured
    the true submit->finish wall (the serving engine does — a PREEMPTED
    request's discarded first service period must count toward its
    latency even though its per-leg fields cover only the last
    admission), else the sum of the three legs; bounded reservoirs of
    the newest 512 latencies/TTFTs back the rolling p50/p99 in
    ``summary()['serving']`` and the ``mx_serve_*`` gauges in
    :func:`render_prometheus`.  Per-request events land in the flight
    ring, so a gang post-mortem tail shows the last served requests.

    SLO accounting (docs/SERVING.md §SLO telemetry): with
    ``MX_SERVE_SLO_TTFT_MS`` / ``MX_SERVE_SLO_TPOT_MS`` set (>0), a
    request whose TTFT exceeds the former or whose time-per-output-token
    (decode wall / tokens) exceeds the latter bumps
    ``mx_serve_slo_violations_total{stage=...}`` and leaves a
    ``serve_slo_violation`` event naming the request.

    Request tracing (docs/OBSERVABILITY.md §Request tracing): ``trace_id``
    and ``cause`` travel in ``**fields`` onto the event; a non-``none``
    cause also bumps the per-cause counter behind
    ``mx_serve_request_cause_total`` and replaces that cause's exemplar
    (newest trace id + latency — bounded at one series per cause).  Every
    completed request additionally lands in the /tracez recent ring."""
    if not _state.enabled:
        return
    latency = (float(total_ms) if total_ms is not None else
               float(queue_wait_ms) + float(prefill_ms) + float(decode_ms))
    slo_ttft = _slo_ms("MX_SERVE_SLO_TTFT_MS")
    slo_tpot = _slo_ms("MX_SERVE_SLO_TPOT_MS")
    tpot_ms = float(decode_ms) / tokens if tokens else 0.0
    violations = []
    if slo_ttft and float(ttft_ms) > slo_ttft:
        violations.append(("ttft", round(float(ttft_ms), 3), slo_ttft))
    if slo_tpot and tpot_ms > slo_tpot:
        violations.append(("tpot", round(tpot_ms, 3), slo_tpot))
    cause = str(fields.get("cause") or "none")
    trace_id = fields.get("trace_id")
    with _state.lock:
        sv = _state.serve
        sv["requests"] += 1
        sv["tokens"] += int(tokens)
        sv["queue_wait_ms"] += float(queue_wait_ms)
        sv["prefill_ms"] += float(prefill_ms)
        sv["decode_ms"] += float(decode_ms)
        sv["lat_ms"].append(latency)
        if ttft_ms:
            sv["ttft_ms"].append(float(ttft_ms))
        for stage, _v, _t in violations:
            sv[f"slo_{stage}"] += 1
        if cause != "none":
            sv["causes"][cause] = sv["causes"].get(cause, 0) + 1
            if trace_id:
                sv["cause_exemplars"][cause] = {
                    "trace_id": str(trace_id),
                    "latency_ms": round(latency, 3)}
        _state.serve_recent.append({
            "t": round(time.time(), 3),
            "request_id": fields.get("request_id"),
            "trace_id": trace_id,
            "cause": cause,
            "latency_ms": round(latency, 3),
            "ttft_ms": round(float(ttft_ms), 3),
            "tokens": int(tokens),
            "reason": fields.get("reason"),
            "slo_violated": [stage for stage, _v, _t in violations]})
    record("serve_request", queue_wait_ms=round(queue_wait_ms, 3),
           prefill_ms=round(prefill_ms, 3), decode_ms=round(decode_ms, 3),
           latency_ms=round(latency, 3), tokens=int(tokens),
           ttft_ms=round(float(ttft_ms), 3), **fields)
    for stage, value_ms, threshold_ms in violations:
        record("serve_slo_violation", stage=stage, value_ms=value_ms,
               threshold_ms=threshold_ms,
               request_id=fields.get("request_id"),
               trace_id=trace_id)


def record_serve_cause(cause: str, trace_id: Optional[str] = None,
                       latency_ms: float = 0.0, **fields) -> None:
    """Attribute a tail cause OUTSIDE the engine's completion path — the
    Router calls this for ``failover`` (the engine never sees the dead
    replica's request) — bumping the same per-cause counter/exemplar
    ``record_serve_request`` feeds, plus a ``serve_cause`` event for the
    merged trace."""
    if not _state.enabled:
        return
    cause = str(cause)
    with _state.lock:
        sv = _state.serve
        sv["causes"][cause] = sv["causes"].get(cause, 0) + 1
        if trace_id:
            sv["cause_exemplars"][cause] = {
                "trace_id": str(trace_id),
                "latency_ms": round(float(latency_ms), 3)}
    record("serve_cause", cause=cause, trace_id=trace_id,
           latency_ms=round(float(latency_ms), 3), **fields)


def recent_requests() -> List[dict]:
    """The newest completed serving requests (trace id, attributed cause,
    latency — oldest first), bounded by ``MX_RQTRACE_TRACEZ_K``: the
    per-rank half of the /tracez surface (metrics_server serves it;
    the Router serves its own cross-replica view)."""
    with _state.lock:
        return [dict(r) for r in _state.serve_recent]


def record_serve_state(queue_depth: int, active_slots: int,
                       precision: Optional[str] = None) -> None:
    """Queue-depth / active-slot gauges, stamped by the serving engine
    at every stream boundary (aggregate-only: no per-boundary event —
    one boundary per few decode steps would drown the flight ring).
    ``precision`` labels which dtype program is serving (fp32/int8 —
    surfaces as ``mx_serve_precision_info`` and in
    ``summary()['serving']``)."""
    if not _state.enabled:
        return
    with _state.lock:
        _state.serve["queue_depth"] = int(queue_depth)
        _state.serve["active_slots"] = int(active_slots)
        if precision is not None:
            _state.serve["precision"] = str(precision)


def record_weight_swap(generation: int, staged_bytes: int = 0,
                       verify_ms: float = 0.0, flip_ms: float = 0.0,
                       **fields) -> None:
    """One APPLIED serving weight hot-swap (docs/SERVING.md §Weight
    hot-swap): bumps the swap counter, publishes the new generation
    gauge (``mx_serve_weight_generation``) and records a ``weight_swap``
    event carrying staged bytes plus verify/flip wall.  Rejected swaps
    record a plain ``weight_swap`` event with ``rejected=True`` at the
    call site instead — they never advance the generation."""
    if not _state.enabled:
        return
    with _state.lock:
        _state.serve["weight_generation"] = int(generation)
        _state.serve["weight_swaps"] += 1
    record("weight_swap", generation=int(generation),
           staged_bytes=int(staged_bytes),
           verify_ms=round(float(verify_ms), 3),
           flip_ms=round(float(flip_ms), 3), **fields)


def record_serve_prefix(kind: str, hit: bool, tokens: int = 0,
                        **fields) -> None:
    """One prefix-cache lookup (mxnet_tpu_torch.serving.engine — docs/
    SERVING.md §Prefix cache).  ``kind`` is the entry family ("pages"
    for forked KV pages, "prefill" for reused prefill rows); a hit adds
    ``tokens`` to the reused-token counter (prefill/ingest work skipped).
    Aggregate-only counters + one flight-ring event per lookup — cheap
    at serving cadence (one lookup per admission, never per step)."""
    if not _state.enabled:
        return
    with _state.lock:
        sv = _state.serve
        sv["prefix_hits" if hit else "prefix_misses"] += 1
        if hit:
            sv["prefix_tokens_reused"] += int(tokens)
    record("serve_prefix", entry_kind=str(kind), hit=bool(hit),
           tokens=int(tokens), **fields)


def record_spec_verify(proposed: int, accepted: int, **fields) -> None:
    """One speculative verify boundary (mxnet_tpu_torch.serving.engine —
    docs/SERVING.md §Speculative decoding): how many draft tokens the
    boundary proposed across slots and how many the target accepted.
    The lifetime acceptance rate (accepted/proposed) surfaces in
    ``summary()['serving']['spec']`` and ``mx_serve_spec_accept_rate`` —
    it is the whole speedup story: every accepted token is a decode
    step the engine never dispatched."""
    if not _state.enabled:
        return
    with _state.lock:
        sv = _state.serve
        sv["spec_rounds"] += 1
        sv["spec_proposed"] += int(proposed)
        sv["spec_accepted"] += int(accepted)
    record("spec_verify", proposed=int(proposed), accepted=int(accepted),
           **fields)


def _percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile over an ascending list (stdlib-only —
    telemetry must not import numpy)."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(math.ceil(q / 100.0 * len(sorted_vals))) - 1))
    return sorted_vals[idx]


def record_checkpoint(event: str, step: int, wall_s: float = 0.0,
                      nbytes: int = 0, **fields) -> None:
    """Checkpoint lifecycle: event in {save, load, fallback}."""
    if not _state.enabled:
        return
    with _state.lock:
        c = _state.ckpt
        if event == "save":
            c["saves"] += 1
            c["save_ms"] += wall_s * 1e3
            c["save_bytes"] += int(nbytes)
        elif event == "load":
            c["loads"] += 1
            c["load_ms"] += wall_s * 1e3
        elif event == "fallback":
            c["fallbacks"] += 1
    ev = dict(step=int(step), **fields)
    if wall_s:
        ev["wall_ms"] = round(wall_s * 1e3, 3)
    if nbytes:
        ev["nbytes"] = int(nbytes)
    record(f"checkpoint_{event}", **ev)


# ---------------------------------------------------------------------------
# heartbeats
# ---------------------------------------------------------------------------
def heartbeat(step: int, force: bool = False) -> None:
    """Write this rank's heartbeat file (atomic rename), rate-limited to
    one write per ``MX_HEARTBEAT_SEC``.  No-op when telemetry is disabled.

    The reported step is MONOTONIC (max over all reports): several layers
    heartbeat with their own counters — e.g. after a supervised restart
    the restored AsyncCheckpointer reports the global step while a fresh
    Trainer counts from 1 — and the supervisor's "last heartbeat at step
    S" diagnosis must not flap between them."""
    if not _state.enabled or _state.dir is None:
        return
    now = time.monotonic()
    with _state.lock:
        if not force and _state.hb_last and \
                now - _state.hb_last < _state.hb_interval:
            return
        _state.hb_last = now
        # wall stamp of the newest beat: export_prometheus derives the
        # mx_heartbeat_age_seconds gauge from it
        _state.hb_wall = time.time()
        step = _state.hb_step = max(int(step), _state.hb_step)
        directory, rank_id = _state.dir, _state.rank
    payload = {"rank": rank_id, "step": int(step),
               "time": round(time.time(), 3), "pid": os.getpid(),
               "restart": int(os.environ.get("MX_RESTART_COUNT", "0") or 0)}
    path = heartbeat_path(directory, rank_id)
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)  # readers never see a torn heartbeat
    except OSError as e:
        _LOG.warning("heartbeat write to %s failed: %s", path, e)


# ---------------------------------------------------------------------------
# retrace detection
# ---------------------------------------------------------------------------
def _retrace_limit() -> int:
    try:
        return int(os.environ.get("MX_TELEMETRY_RETRACE_LIMIT",
                                  _RETRACE_LIMIT_DEFAULT))
    except (TypeError, ValueError):
        return _RETRACE_LIMIT_DEFAULT


def retrace_enabled() -> bool:
    """Retrace detection runs by default (even without a telemetry sink —
    it exists for runs nobody instrumented); ``MX_TELEMETRY_RETRACE_LIMIT=0``
    is the kill switch for hot loops where even the per-call signature
    build must go."""
    return _retrace_limit() > 0


# an executor name past this many registry entries folds into one shared
# overflow bucket: a script that builds a fresh executor per batch must
# not grow the registry forever — and since each such instance contributes
# its (distinct-shaped) first signature to the SAME bucket, the storm the
# per-instance keys would hide is detected there instead
_RETRACE_REGISTRY_MAX = 1024
_OVERFLOW_KEY = "<executor-churn-overflow>"


def note_signature(executor: str, signature) -> bool:
    """Report one executor call's jit signature (shapes/dtypes/static args).

    Returns True when the signature is NEW for this executor — i.e. the
    executor sees this input signature for the first time.  When an executor
    accumulates more than the retrace limit of distinct signatures, emits a
    rate-limited warning naming the newest signature (then again only each
    time the count doubles — a storm logs a handful of lines, not one per
    step)."""
    if not retrace_enabled():
        return False
    with _state.lock:
        if (executor not in _state.retraces
                and len(_state.retraces) >= _RETRACE_REGISTRY_MAX):
            executor = _OVERFLOW_KEY
        ent = _state.retraces.setdefault(
            executor, {"sigs": set(), "traces": 0, "warned_at": 0,
                       "last_sig": ""})
        if signature in ent["sigs"]:
            return False
        if len(ent["sigs"]) >= 4096:
            # bounded memory even in a storm: evict one (arbitrary) stored
            # signature rather than dropping the NEW one — a pipeline that
            # churns past the cap and then stabilizes must find its final
            # signature in the set, not be re-counted as a fresh trace
            # (and re-warned) on every remaining step of the run
            ent["sigs"].pop()
        ent["sigs"].add(signature)
        ent["traces"] += 1
        # truncate at store time: summary() embeds last_sig verbatim into
        # bench records and dumps() output — a multi-KB feed signature
        # must not ride along whole
        ent["last_sig"] = str(signature)[:400]
        n = ent["traces"]
        limit = _retrace_limit()
        warn = n > limit and (ent["warned_at"] == 0
                              or n >= 2 * ent["warned_at"])
        if warn:
            ent["warned_at"] = n
    if warn:
        _LOG.warning(
            "executor %s has traced %d distinct signatures (retrace limit "
            "%d); newest: %s.  Every new input shape/dtype forces a new "
            "trace or capture — the classic silent 10x slowdown.  Pad or "
            "bucket inputs to stable shapes (see docs/OBSERVABILITY.md).",
            executor, n, limit, str(signature)[:400])
        record("retrace", executor=executor, traces=n,
               signature=str(signature)[:400])
    return True


# ---------------------------------------------------------------------------
# rollups
# ---------------------------------------------------------------------------
def flight_tail(k: int = 20) -> List[dict]:
    """The last k events recorded in this process (newest last)."""
    with _state.lock:
        return list(_state.ring)[-k:]


def _serving_rollup() -> dict:
    """summary()['serving'] block (caller holds _state.lock)."""
    sv = _state.serve
    lat = sorted(sv["lat_ms"])
    ttft = sorted(sv["ttft_ms"])
    return {
        "requests": sv["requests"],
        "tokens": sv["tokens"],
        "queue_wait_ms": round(sv["queue_wait_ms"], 3),
        "prefill_ms": round(sv["prefill_ms"], 3),
        "decode_ms": round(sv["decode_ms"], 3),
        "p50_latency_ms": round(_percentile(lat, 50), 3),
        "p99_latency_ms": round(_percentile(lat, 99), 3),
        "p50_ttft_ms": round(_percentile(ttft, 50), 3),
        "p99_ttft_ms": round(_percentile(ttft, 99), 3),
        "slo_violations": {"ttft": sv["slo_ttft"], "tpot": sv["slo_tpot"]},
        "queue_depth": sv["queue_depth"],
        "active_slots": sv["active_slots"],
        "precision": sv.get("precision", "fp32"),
        "weight_generation": sv.get("weight_generation", 0),
        "weight_swaps": sv.get("weight_swaps", 0),
        "prefix_cache": {
            "hits": sv.get("prefix_hits", 0),
            "misses": sv.get("prefix_misses", 0),
            "tokens_reused": sv.get("prefix_tokens_reused", 0),
            "hit_rate": round(
                sv.get("prefix_hits", 0)
                / max(1, sv.get("prefix_hits", 0)
                      + sv.get("prefix_misses", 0)), 4),
        },
        "spec": {
            "rounds": sv.get("spec_rounds", 0),
            "proposed": sv.get("spec_proposed", 0),
            "accepted": sv.get("spec_accepted", 0),
            "accept_rate": round(
                sv.get("spec_accepted", 0)
                / max(1, sv.get("spec_proposed", 0)), 4),
        },
        "causes": dict(sv.get("causes", {})),
        "cause_exemplars": {k: dict(v) for k, v in
                            sv.get("cause_exemplars", {}).items()},
    }


def summary() -> dict:
    """JSON-serializable rollup of everything recorded so far.  Works even
    when the recorder is disabled (retrace tracking is always on)."""
    with _state.lock:
        steps = {}
        for name, st in _state.steps.items():
            exec_count = st["count"] - st["compile_count"]
            row = {
                "count": st["count"],
                "compile_count": st["compile_count"],
                "compile_ms": round(st["compile_ms"], 3),
                "exec_ms": round(st["exec_ms"], 3),
                "transfer_bytes": st["bytes"],
                "h2d_overlapped_bytes": st.get("overlap_bytes", 0),
                "block_wait_ms": round(st.get("block_wait_ms", 0.0), 3),
            }
            if exec_count > 0:
                row["mean_exec_ms"] = round(st["exec_ms"] / exec_count, 3)
            if st["samples"] and st["exec_ms"] > 0:
                row["samples_per_sec"] = round(
                    st["samples"] / (st["exec_ms"] / 1e3), 2)
            steps[name] = row
        retraces = {
            name: {"traces": ent["traces"], "last_signature": ent["last_sig"]}
            for name, ent in _state.retraces.items()
        }
        out = {
            "enabled": _state.enabled,
            "rank": _state.rank if _state.enabled else rank(),
            "dir": _state.dir,
            "events": dict(_state.counts),
            "steps": steps,
            "collectives": {
                "count": _state.coll["count"],
                "bytes": _state.coll["bytes"],
                "total_ms": round(_state.coll["total_ms"], 3),
                "compile_ms": round(_state.coll["compile_ms"], 3),
            },
            "checkpoints": {k: (round(v, 3) if isinstance(v, float) else v)
                            for k, v in _state.ckpt.items()},
            "fused_update": dict(_state.fused),
            "serving": _serving_rollup(),
            "spans": {
                name: {"count": agg["count"],
                       "total_ms": round(agg["total_ms"], 3),
                       "max_ms": round(agg["max_ms"], 3)}
                for name, agg in _state.spans.items()
            },
            "retraces": retraces,
            "inflight_depth": _state.inflight_depth,
            "restart_count": int(
                os.environ.get("MX_RESTART_COUNT", "0") or 0),
        }
    return out


# ---------------------------------------------------------------------------
# health (metrics_server /healthz; the same staleness rule the
# tools/launch.py supervisor applies to heartbeat FILES)
# ---------------------------------------------------------------------------
def stale_after_sec() -> float:
    """Seconds without a heartbeat before this rank counts as stale:
    several missed beats, floored so sub-second test configs don't flag
    healthy processes on a loaded host (mirrored in tools/launch.py
    _HeartbeatMonitor — keep in sync)."""
    return max(2.0, 5.0 * max(0.0, _env_float("MX_HEARTBEAT_SEC", 5.0)))


def health_snapshot() -> dict:
    """Liveness verdict from the recorder's locked rollups only (no torch,
    no device sync — the /healthz contract): heartbeat age vs the
    supervisor's staleness rule, the last heartbeat step, the gang
    restart count, and the in-flight dispatch depth.  ``healthy`` is
    False only when heartbeats were flowing and then stopped; a process
    that never heartbeat (telemetry off, or startup) reports
    ``heartbeat_age_s: None`` and stays healthy — liveness of the HTTP
    thread itself is then the only claim being made."""
    stale_after = stale_after_sec()
    with _state.lock:
        hb_wall = _state.hb_wall
        hb_step = _state.hb_step
        inflight = _state.inflight_depth
        sv_depth = _state.serve["queue_depth"]
        sv_slots = _state.serve["active_slots"]
        on = _state.enabled
    age = max(0.0, time.time() - hb_wall) if hb_wall else None
    reasons = []
    if age is not None and age > stale_after:
        reasons.append(f"last heartbeat {age:.1f}s ago "
                       f"(stale after {stale_after:.1f}s)")
    return {
        "healthy": not reasons,
        "reasons": reasons,
        "telemetry_enabled": on,
        "rank": _state.rank if on else rank(),
        "heartbeat_age_s": round(age, 3) if age is not None else None,
        "stale_after_s": round(stale_after, 3),
        "last_step": hb_step if hb_step >= 0 else None,
        "restart_count": int(os.environ.get("MX_RESTART_COUNT", "0") or 0),
        "inflight_depth": inflight,
        "serve_queue_depth": sv_depth,
        "serve_active_slots": sv_slots,
        "pid": os.getpid(),
        "time": round(time.time(), 3),
    }


# ---------------------------------------------------------------------------
# exporters (docs/OBSERVABILITY.md §Tracing & analysis)
# ---------------------------------------------------------------------------
def _iter_rank_files(directory: str):
    """(rank, path) for every rank-<R>.jsonl under ``directory``."""
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return
    for name in names:
        if name.startswith("rank-") and name.endswith(".jsonl"):
            try:
                r = int(name[len("rank-"):-len(".jsonl")])
            except ValueError:
                continue
            yield r, os.path.join(directory, name)


def _load_rank_events(path: str) -> List[dict]:
    events = []
    try:
        with open(path, errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue  # torn final line of a SIGKILLed rank
                if isinstance(ev, dict):
                    events.append(ev)
    except OSError:
        pass
    return events


def _mono_offset(events: List[dict], rank_id) -> float:
    """Fallback wall - perf_counter offset for an old-format stream with
    NO ``clock_anchor`` events (anchored streams align to the nearest
    preceding anchor in export_chrome_trace instead): derived from the
    first mono-stamped event's own wall stamp, with a warning —
    alignment then absorbs that event's record->flush latency."""
    for e in events:
        if "mono" in e and "t" in e:
            _LOG.warning(
                "rank %s stream has no clock_anchor events (old-format "
                "file?): aligning its spans from event wall stamps — "
                "cross-rank timeline may be skewed by flush latency",
                rank_id)
            return float(e["t"]) - float(e["mono"])
    return 0.0


def export_chrome_trace(directory: Optional[str] = None,
                        out: Optional[str] = None) -> Optional[str]:
    """Merge every rank's JSONL stream under ``directory`` (default: the
    live recorder's dir) into ONE Chrome/Perfetto trace-event JSON at
    ``out`` (default ``<directory>/trace.json``) and return its path.

    Layout: one track (pid) per rank, named ``rank R``; paired
    ``span_begin``/``span_end`` events become nested B/E duration events
    per thread (only COMPLETED spans are emitted, so every B has a
    matching E), complete-form ``span`` events become "X" slices (ts +
    dur — written at exit, so a synthesized pair could mis-order on a µs
    tie; X slices cannot be imbalanced); collectives become per-rank "X"
    complete events chained across ranks by flow events
    (``s``/``t``/``f`` sharing an id per occurrence of each op), so the
    gang-wide shape of an allreduce is one connected arrow in the
    Perfetto UI.  Monotonic span stamps align to the shared wall timeline
    via each rank's ``clock_anchor`` offset.

    Request tracing (docs/OBSERVABILITY.md §Request tracing): serving
    spans whose args carry a ``trace_id`` and whose name is a
    cross-process hop anchor (the Router's ``serve_dispatch``, the
    replica's ``serve_handle``) are chained by per-trace flow events —
    one connected arrow from the router's dispatch slice into the
    replica's request tree, exactly like the collective flows but keyed
    on the trace id instead of the occurrence index (two DIFFERENT
    processes, not the same op on every rank).  Returns None when no
    rank stream exists."""
    directory = directory or _state.dir
    if not directory:
        return None
    flush()  # this process's own stream must include the latest events
    trace: List[dict] = []
    coll_occurrence: Dict[Any, int] = {}  # op -> running flow id per rank
    # trace_id -> [(ts_mid, pid, tid, stream_idx)] of its hop-anchor
    # slices across ALL streams; becomes one flow chain per request
    req_flow: Dict[str, List[tuple]] = {}
    flow_anchors = ("serve_dispatch", "serve_handle")
    any_events = False
    for rank_id, path in _iter_rank_files(directory):
        events = _load_rank_events(path)
        if not events:
            continue
        any_events = True
        # supervised restarts APPEND to the same rank file, so one stream
        # can hold several perf_counter epochs; a single whole-stream
        # offset would shift one epoch's spans by the inter-process-start
        # delta.  Track the NEAREST PRECEDING anchor in file order
        # instead: anchors are re-emitted per flush, so every epoch's
        # events follow an anchor of their own epoch.
        anchor_offs = [float(e["wall"]) - float(e["mono"]) for e in events
                       if e.get("kind") == "clock_anchor"
                       and "wall" in e and "mono" in e]
        offset = (anchor_offs[0] if anchor_offs
                  else _mono_offset(events, rank_id))
        trace.append({"ph": "M", "name": "process_name", "pid": rank_id,
                      "tid": 0, "args": {"name": f"rank {rank_id}"}})
        open_spans: Dict[Any, dict] = {}
        tids: Dict[Any, int] = {}
        n_coll: Dict[str, int] = {}
        def span_args(begin: dict) -> dict:
            args = {k: v for k, v in begin.items()
                    if k not in ("t", "kind", "rank", "name", "span",
                                 "parent", "depth", "tid", "mono",
                                 "dur_ms")}
            args["span_id"] = begin.get("span")
            return args

        for idx, ev in enumerate(events):
            kind = ev.get("kind")
            if kind == "clock_anchor" and "wall" in ev and "mono" in ev:
                offset = float(ev["wall"]) - float(ev["mono"])
            elif kind == "span_begin" and "span" in ev:
                # remember the stream index: record() appends under one
                # lock, so file order IS true chronological order within
                # a rank — the only tiebreak that can never invert a
                # span's own B/E pair on a µs ts tie (depth-based keys
                # sorted a zero-width nested span's E before its B)
                ev["_idx"] = idx
                open_spans[ev["span"]] = ev
            elif kind == "span_end" and ev.get("span") in open_spans:
                # paired form -> B/E pair, each carrying its source
                # record's stream index so the stable ts sort below
                # reconstructs enter/exit order exactly on ties
                begin = open_spans.pop(ev["span"])
                begin_idx = begin.pop("_idx", idx)
                tid = tids.setdefault(begin.get("tid"), len(tids))
                ts0 = (float(begin["mono"]) + offset) * 1e6
                ts1 = (float(ev["mono"]) + offset) * 1e6
                trace.append({"ph": "B", "name": begin.get("name", "?"),
                              "pid": rank_id, "tid": tid,
                              "ts": ts0, "args": span_args(begin),
                              "_sub": begin_idx})
                trace.append({"ph": "E", "name": begin.get("name", "?"),
                              "pid": rank_id, "tid": tid,
                              "ts": max(ts1, ts0), "_sub": idx})
                if begin.get("trace_id") and \
                        begin.get("name") in flow_anchors:
                    req_flow.setdefault(str(begin["trace_id"]), []).append(
                        ((ts0 + max(ts1, ts0)) / 2.0, rank_id, tid,
                         begin_idx))
            elif kind == "span" and "mono" in ev:
                # complete form -> ph "X" (ts + dur).  These are written
                # at EXIT, so their file order is child-before-parent; a
                # synthesized B/E pair could land child-B-before-parent-B
                # on a µs tie and unbalance the track.  X events carry
                # their extent and cannot be imbalanced; Perfetto nests
                # them natively.
                tid = tids.setdefault(ev.get("tid"), len(tids))
                ts_x = (float(ev["mono"]) + offset) * 1e6
                dur_x = max(float(ev.get("dur_ms", 0.0)) * 1e3, 0.001)
                trace.append({"ph": "X", "name": ev.get("name", "?"),
                              "pid": rank_id, "tid": tid,
                              "ts": ts_x, "dur": dur_x,
                              "args": span_args(ev),
                              "_sub": idx})
                if ev.get("trace_id") and ev.get("name") in flow_anchors:
                    req_flow.setdefault(str(ev["trace_id"]), []).append(
                        (ts_x + dur_x / 2.0, rank_id, tid, idx))
            elif kind == "mem":
                # per-rank counter track: category bytes render as a
                # stacked area series under the span timeline (Perfetto
                # ph "C"); sampled off the hot path so ts is the wall
                # stamp, like collectives
                cats = ev.get("categories") or {}
                args = {}
                for cat, row in cats.items():
                    args[cat] = (row.get("nbytes", 0)
                                 if isinstance(row, dict) else row)
                if not args:
                    args = {"live_bytes": ev.get("live_bytes", 0)}
                trace.append({"ph": "C", "name": "memory", "pid": rank_id,
                              "tid": 0,
                              "ts": float(ev.get("t", 0.0)) * 1e6,
                              "args": args})
            elif kind == "collective":
                op = str(ev.get("op", "collective"))
                occ = n_coll.get(op, 0)
                n_coll[op] = occ + 1
                tid = tids.setdefault(None, len(tids))
                dur = max(float(ev.get("wall_ms", 0.0)) * 1e3, 1.0)
                # record_collective stamps the event AFTER the op, so its
                # wall stamp is the END; the slice starts wall_ms earlier
                ts = (float(ev.get("t", 0.0))
                      - float(ev.get("wall_ms", 0.0)) / 1e3) * 1e6
                trace.append({"ph": "X", "name": op, "pid": rank_id,
                              "tid": tid, "ts": ts, "dur": dur,
                              "args": {"nbytes": ev.get("nbytes"),
                                       "traced": ev.get("traced")}})
                # flow: the occ-th <op> on every rank is the same logical
                # collective; chain the ranks with one flow id
                flow_id = hash((op, occ)) & 0x7FFFFFFF
                first = coll_occurrence.setdefault((op, occ), rank_id)
                ph = "s" if first == rank_id else "t"
                trace.append({"ph": ph, "cat": "collective", "name": op,
                              "id": flow_id, "pid": rank_id, "tid": tid,
                              "ts": ts + dur / 2, "bp": "e"})
    # one flow chain per traced request: s on its earliest hop anchor
    # (the router's dispatch slice), t on each later one (the replica's
    # handle slice — two on a failover re-dispatch, still ONE chain)
    for trace_key, pts in req_flow.items():
        if len(pts) < 2:
            continue  # a single-process trace has nothing to link
        pts.sort()
        flow_id = hash(("rqtrace", trace_key)) & 0x7FFFFFFF
        for i, (ts_mid, pid_, tid_, sub) in enumerate(pts):
            trace.append({"ph": "s" if i == 0 else "t", "cat": "request",
                          "name": trace_key, "id": flow_id, "pid": pid_,
                          "tid": tid_, "ts": ts_mid, "bp": "e",
                          "_sub": sub})
    if not any_events:
        return None
    # chronological, with the _sub stream-index key breaking µs ts ties
    # (per-rank file order is true chronological order, so B/E nesting
    # and each pair's own B-before-E survive zero-width spans)
    meta = [e for e in trace if e["ph"] == "M"]
    rest = sorted((e for e in trace if e["ph"] != "M"),
                  key=lambda e: (e["ts"], e.get("_sub", 0)))
    if rest:
        t0 = min(e["ts"] for e in rest)
        for e in rest:
            e["ts"] = round(e["ts"] - t0, 3)
            e.pop("_sub", None)
    out = out or os.path.join(directory, "trace.json")
    # the supervisor's post-mortem re-export may target a directory no
    # rank ever created (SIGKILLed gang -> no atexit export ran)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    payload = {"traceEvents": meta + rest, "displayTimeUnit": "ms"}
    tmp = f"{out}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, out)
    return out


def _prom_escape(value: str) -> str:
    return str(value).replace("\\", r"\\").replace('"', r'\"')


def render_prometheus(mode: str = "live") -> str:
    """Render this process's ``summary()`` + memwatch rollups as ONE
    OpenMetrics text exposition ending in ``# EOF`` — the single
    formatter shared by BOTH sinks: :func:`export_prometheus` (file
    snapshot, ``mode="atexit"``) and the live
    ``mxnet_tpu_torch.metrics_server``
    ``/metrics`` endpoint (``mode="live"``).  Every render stamps
    ``mx_export_timestamp_seconds`` and ``mx_export_mode{mode=...}`` so a
    dashboard can tell a dead rank's last atexit snapshot from a live
    scrape.  Reads the recorder's locked rollups only: no torch, no device
    sync, safe from any thread at any time (including concurrently with
    a flush)."""
    s = summary()
    rank_lbl = f'rank="{s["rank"]}"'
    lines: List[str] = []

    def gauge(name, value, labels="", kind="gauge"):
        lines.append(f"# TYPE {name} {kind}")
        lbl = f"{{{rank_lbl}{',' if labels else ''}{labels}}}"
        lines.append(f"{name}{lbl} {value}")

    def per_key(name, rows, field, label_key, kind="counter", scale=1):
        lines.append(f"# TYPE {name} {kind}")
        for key, row in sorted(rows.items()):
            v = row[field] * scale if scale != 1 else row[field]
            lines.append(
                f'{name}{{{rank_lbl},{label_key}="{_prom_escape(key)}"}} '
                f"{v}")

    # export provenance first: a scraper (or the launch.py gang merge)
    # derives per-rank staleness from the timestamp, and the mode label
    # says whether these numbers are a live process or a final snapshot
    gauge("mx_export_timestamp_seconds", round(time.time(), 3))
    lines.append("# TYPE mx_export_mode gauge")
    lines.append(f'mx_export_mode{{{rank_lbl},'
                 f'mode="{_prom_escape(mode)}"}} 1')
    steps = s["steps"]
    per_key("mx_step_total", steps, "count", "executor")
    per_key("mx_step_compile_total", steps, "compile_count", "executor")
    per_key("mx_step_compile_ms_total", steps, "compile_ms", "executor")
    per_key("mx_step_exec_ms_total", steps, "exec_ms", "executor")
    per_key("mx_step_block_wait_ms_total", steps, "block_wait_ms",
            "executor")
    per_key("mx_step_transfer_bytes_total", steps, "transfer_bytes",
            "executor")
    lines.append("# TYPE mx_step_samples_per_sec gauge")
    for key, row in sorted(steps.items()):
        if "samples_per_sec" in row:
            lines.append(
                f'mx_step_samples_per_sec{{{rank_lbl},'
                f'executor="{_prom_escape(key)}"}} '
                f'{row["samples_per_sec"]}')
    c = s["collectives"]
    gauge("mx_collective_total", c["count"], kind="counter")
    gauge("mx_collective_bytes_total", c["bytes"], kind="counter")
    gauge("mx_collective_ms_total", c["total_ms"], kind="counter")
    if c["total_ms"] > 0:
        gauge("mx_collective_bytes_per_sec",
              round(c["bytes"] / (c["total_ms"] / 1e3), 1))
    ck = s["checkpoints"]
    gauge("mx_checkpoint_saves_total", ck["saves"], kind="counter")
    gauge("mx_checkpoint_save_ms_total", ck["save_ms"], kind="counter")
    gauge("mx_checkpoint_loads_total", ck["loads"], kind="counter")
    gauge("mx_checkpoint_fallbacks_total", ck["fallbacks"], kind="counter")
    sv = s["serving"]
    if sv["requests"] or sv["queue_depth"] or sv["active_slots"] \
            or sv.get("weight_swaps"):
        gauge("mx_serve_requests_total", sv["requests"], kind="counter")
        gauge("mx_serve_tokens_total", sv["tokens"], kind="counter")
        gauge("mx_serve_queue_wait_ms_total", sv["queue_wait_ms"],
              kind="counter")
        gauge("mx_serve_decode_ms_total", sv["decode_ms"], kind="counter")
        gauge("mx_serve_latency_p50_ms", sv["p50_latency_ms"])
        gauge("mx_serve_latency_p99_ms", sv["p99_latency_ms"])
        gauge("mx_serve_ttft_p50_ms", sv["p50_ttft_ms"])
        gauge("mx_serve_ttft_p99_ms", sv["p99_ttft_ms"])
        lines.append("# TYPE mx_serve_slo_violations_total counter")
        for stage in ("ttft", "tpot"):
            lines.append(
                f'mx_serve_slo_violations_total{{{rank_lbl},'
                f'stage="{stage}"}} {sv["slo_violations"][stage]}')
        gauge("mx_serve_queue_depth", sv["queue_depth"])
        gauge("mx_serve_active_slots", sv["active_slots"])
        # hot-swap generation gauge + applied-swap counter: which weight
        # set is serving, and how many flips it took to get there
        gauge("mx_serve_weight_generation",
              sv.get("weight_generation", 0))
        gauge("mx_serve_weight_swaps_total", sv.get("weight_swaps", 0),
              kind="counter")
        # info-style precision label (a NEW gauge, not a new label on
        # the existing series — label-set changes break scrapers)
        lines.append("# TYPE mx_serve_precision_info gauge")
        lines.append(
            f'mx_serve_precision_info{{{rank_lbl},'
            f'precision="{_prom_escape(sv.get("precision", "fp32"))}"}} 1')
        pc = sv.get("prefix_cache", {})
        if pc.get("hits") or pc.get("misses"):
            gauge("mx_serve_prefix_hits_total", pc["hits"], kind="counter")
            gauge("mx_serve_prefix_misses_total", pc["misses"],
                  kind="counter")
            gauge("mx_serve_prefix_tokens_reused_total",
                  pc["tokens_reused"], kind="counter")
            gauge("mx_serve_prefix_hit_rate", pc["hit_rate"])
        sp = sv.get("spec", {})
        if sp.get("rounds"):
            gauge("mx_serve_spec_rounds_total", sp["rounds"],
                  kind="counter")
            gauge("mx_serve_spec_proposed_total", sp["proposed"],
                  kind="counter")
            gauge("mx_serve_spec_accepted_total", sp["accepted"],
                  kind="counter")
            gauge("mx_serve_spec_accept_rate", sp["accept_rate"])
        # request-tracing cause attribution: per-cause counter + one
        # exemplar-style gauge per cause carrying the NEWEST trace id as
        # a label (bounded cardinality: one series per cause, the trace
        # id label rewrites in place — the poor-man's OpenMetrics
        # exemplar, since the text exposition has no native ones)
        causes = sv.get("causes", {})
        if causes:
            lines.append("# TYPE mx_serve_request_cause_total counter")
            for cause, n in sorted(causes.items()):
                lines.append(
                    f'mx_serve_request_cause_total{{{rank_lbl},'
                    f'cause="{_prom_escape(cause)}"}} {n}')
            ex = sv.get("cause_exemplars", {})
            if ex:
                lines.append(
                    "# TYPE mx_serve_request_exemplar_latency_ms gauge")
                for cause, row in sorted(ex.items()):
                    lines.append(
                        f'mx_serve_request_exemplar_latency_ms{{'
                        f'{rank_lbl},cause="{_prom_escape(cause)}",'
                        f'trace_id="{_prom_escape(row["trace_id"])}"}} '
                        f'{row["latency_ms"]}')
    per_key("mx_span_total", s["spans"], "count", "span", kind="counter")
    per_key("mx_span_ms_total", s["spans"], "total_ms", "span",
            kind="counter")
    per_key("mx_span_max_ms", s["spans"], "max_ms", "span", kind="gauge")
    lines.append("# TYPE mx_retrace_signatures gauge")
    for key, row in sorted(s["retraces"].items()):
        lines.append(
            f'mx_retrace_signatures{{{rank_lbl},'
            f'executor="{_prom_escape(key)}"}} {row["traces"]}')
    if _state.hb_wall:
        gauge("mx_heartbeat_age_seconds",
              round(max(0.0, time.time() - _state.hb_wall), 3))
    gauge("mx_restart_count", s["restart_count"])
    # memory watchdog gauges (docs/OBSERVABILITY.md §Memory): lazy import
    # — memwatch rides on this module, never the other way around
    try:
        from . import memwatch as _memwatch

        ms = _memwatch.summary()
        if ms["samples"]:
            gauge("mx_mem_samples_total", ms["samples"], kind="counter")
            gauge("mx_mem_watermark_bytes", ms["watermark_bytes"])
            lines.append("# TYPE mx_mem_category_bytes gauge")
            for cat, nb in sorted(ms["categories"].items()):
                lines.append(
                    f'mx_mem_category_bytes{{{rank_lbl},'
                    f'category="{_prom_escape(cat)}"}} {nb}')
            gauge("mx_mem_leak_detected",
                  1 if ms["leak"]["active"] else 0)
        if ms["compiles"]["count"]:
            gauge("mx_mem_compile_total", ms["compiles"]["count"],
                  kind="counter")
            gauge("mx_mem_compile_ms_total", ms["compiles"]["wall_ms"],
                  kind="counter")
            gauge("mx_mem_compile_cache_hits_total",
                  ms["compiles"].get("cache_hits", 0), kind="counter")
    except Exception:  # the exposition must land even if memwatch breaks
        pass
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


def export_prometheus(path: Optional[str] = None) -> Optional[str]:
    """Write an OpenMetrics text snapshot (one :func:`render_prometheus`
    render, ``mode="atexit"``) to ``path`` (default ``<telemetry
    dir>/metrics-<rank>.prom``) and return the path — the file-sink half
    of the formatter: point a node exporter textfile collector at it.
    For pull-based scraping of a LIVE process use
    ``mxnet_tpu_torch.metrics_server`` (MX_METRICS_PORT), which serves the
    same exposition with ``mode="live"``."""
    if path is None:
        if not _state.dir:
            return None
        path = os.path.join(_state.dir, f"metrics-{_state.rank}.prom")
    body = render_prometheus(mode="atexit")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(body)
    os.replace(tmp, path)  # scrapers never see a torn snapshot
    return path


def _trace_export_target() -> Optional[str]:
    """MX_TRACE_EXPORT: unset/0/false = off (the default — exporting reads
    back every rank's stream, not something to pay unasked); 1/true =
    export into MX_TELEMETRY_DIR; any other value = target directory."""
    raw = os.environ.get("MX_TRACE_EXPORT", "").strip()
    if not raw or raw.lower() in ("0", "false", "off"):
        return None
    if raw.lower() in ("1", "true", "on"):
        return _state.dir
    return raw


def _export_at_exit() -> None:
    """Best-effort per-process export.  Rank 0's merge here can race peer
    ranks that are still running (their final flush lands after the
    read); under tools/launch.py the supervisor re-runs the merge after
    every rank is reaped and overwrites this trace.json with the
    authoritative one.  Unsupervised single-rank runs have no race."""
    target = _trace_export_target()
    if not target or not _state.dir:
        return
    try:
        os.makedirs(target, exist_ok=True)
        export_prometheus(
            os.path.join(target, f"metrics-{_state.rank}.prom"))
        # every rank snapshots its own metrics; only rank 0 merges the
        # gang trace (all ranks racing one trace.json would tear it)
        if _state.rank == 0:
            export_chrome_trace(_state.dir,
                                out=os.path.join(target, "trace.json"))
    except Exception as e:  # export must never turn a clean exit dirty
        _LOG.warning("MX_TRACE_EXPORT failed: %s", e)


# LIFO atexit: this runs BEFORE the flush registered above, so
# _export_at_exit's own flush() call covers the final pending events
atexit.register(_export_at_exit)


# attach the sink at import when the launcher/user exported the env
# (workers inherit the variable from tools/launch.py's environment
# pass-through)
enable()
