"""Device-memory observability: a sampler, category attribution, a leak
detector and the OOM post-mortem.

The counterpart of ``mxnet_tpu/memwatch.py``, riding the port's telemetry
recorder (``telemetry.py``) and writing the JAX module's events (``mem``,
``mem_leak``, ``oom_report``) with its fields, so ``tools/mem_report.py``
reads them unchanged:

  * **sampler** — ``on_step()`` / ``on_checkpoint()`` are called at step
    boundaries and checkpoint save/load, never inside a dispatch.  Every
    ``MX_MEMWATCH_EVERY`` (default 10) observations it records one
    ``mem`` event: the category census below plus the allocator's
    counters (``device_memory``), with watermark tracking;
  * **category attribution** — components *weakly* register providers
    (``register(category, obj, fn)``): the serving engine (its pools and
    slot state, ``serving``; staged swap weights, ``staging``),
    ``AsyncCheckpointer`` (queued host snapshots, ``checkpoint``).  torch
    has no list of live tensors, so the census walks the providers'
    tensors only and attributes each *storage* once, by
    ``untyped_storage().data_ptr()`` (never by ``id()``: views and
    re-wrapped tensors share a storage).  On the card the rest of
    ``torch.cuda.memory_allocated()`` is ``other``; numpy arrays count as
    host bytes.  The garbage collector is never walked;
  * **leak detector** — a sliding window (``MX_MEMWATCH_LEAK_WINDOW``,
    default 12 samples) of census totals; strictly monotonic growth
    across the whole window above a noise floor warns ONCE (re-armed when
    growth stops), naming the top-growing category, and records a
    ``mem_leak`` event;
  * **OOM post-mortem** — a path that catches a device OOM
    (``is_resource_exhausted``: ``torch.cuda.OutOfMemoryError`` or the
    ``RESOURCE_EXHAUSTED`` text of an injected fault) calls
    ``emit_oom_report()``: one ``oom_report`` event, flushed before the
    error re-raises.

The port compiles no executables, so the JAX module's compile accounting
(``note_compile``, ``_analyze``, ``shape_structs``) has no counterpart;
``summary()["compiles"]`` stays zero.  ``fingerprint`` stays: the
serving engine's swap gate hashes structures with it.

Enabled whenever the telemetry recorder is enabled; ``MX_MEMWATCH=0`` is
the kill switch.  Sampling reads allocator counters and tensor metadata
only: it never synchronises the card.
"""
from __future__ import annotations

import hashlib
import logging
import os
import threading
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from . import telemetry
from .context import normalize_memory_stats

__all__ = ["enabled", "register", "census", "device_memory", "sample",
           "on_step", "on_checkpoint", "fingerprint", "emit_oom_report",
           "is_resource_exhausted", "peak_bytes", "summary", "reset"]

_LOG = logging.getLogger("mxnet_tpu_torch.memwatch")

_DEFAULT_EVERY = 10
_DEFAULT_LEAK_WINDOW = 12
# leak floor: the census total must grow by at least this much across the
# whole window before the monotonic trend is worth a warning
_LEAK_MIN_GROWTH = 1 << 16


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def enabled() -> bool:
    """On whenever telemetry is on, unless ``MX_MEMWATCH=0``."""
    if not telemetry.enabled():
        return False
    return os.environ.get("MX_MEMWATCH", "1").lower() not in (
        "0", "false", "off")


def _every() -> int:
    return max(1, _env_int("MX_MEMWATCH_EVERY", _DEFAULT_EVERY))


def _leak_window() -> int:
    return max(2, _env_int("MX_MEMWATCH_LEAK_WINDOW", _DEFAULT_LEAK_WINDOW))


# ---------------------------------------------------------------------------
# state
# ---------------------------------------------------------------------------
class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.step_calls = 0
        self.samples = 0
        self.watermark = 0            # max observed device/census bytes
        self.window: List[Tuple[int, Dict[str, int]]] = []
        self.leak_active = False
        self.leak_category: Optional[str] = None
        self.leak_events = 0
        self.last_categories: Dict[str, int] = {}
        self.oom_reported = False


_state = _State()

# providers survive reset(): registration happens at object construction
# (dead weakrefs are pruned at census time and as the list doubles)
_providers: List[Tuple[str, "weakref.ref", Callable]] = []
_providers_lock = threading.Lock()
_providers_prune_at = 64


def reset() -> None:
    """Drop aggregates and the window (tests).  Registered providers are
    kept: their objects are still alive."""
    global _state
    _state = _State()


# ---------------------------------------------------------------------------
# category registration + census
# ---------------------------------------------------------------------------
def register(category: str, obj: Any, fn: Callable[[Any], Any]) -> None:
    """Weakly register ``fn(obj) -> iterable of arrays`` as the provider
    of ``category``'s arrays.  ``fn`` runs at sample time and may return
    torch tensors, NDArrays (their ``._data``) or numpy arrays (host
    bytes, e.g. queued checkpoint snapshots).  Dropping ``obj`` retires
    the provider."""
    global _providers_prune_at
    with _providers_lock:
        _providers.append((category, weakref.ref(obj), fn))
        if len(_providers) >= _providers_prune_at:
            _providers[:] = [(c, r, f) for c, r, f in _providers
                             if r() is not None]
            _providers_prune_at = max(64, 2 * len(_providers))


def _live_providers():
    with _providers_lock:
        alive = [(c, r, f) for c, r, f in _providers if r() is not None]
        _providers[:] = alive
        return list(alive)


def _cuda_live() -> bool:
    """Whether this process has touched the card (never initialises it)."""
    return torch.cuda.is_available() and torch.cuda.is_initialized()


def census() -> dict:
    """Categorized census of the registered providers' arrays:
    ``{"total_bytes", "live_count", "categories": {cat: {count, nbytes}},
    "host_bytes": {cat: bytes}}``.  Each tensor storage counts once, in
    the first category that names it; on the card the rest of
    ``torch.cuda.memory_allocated()`` is ``other``."""
    seen: Dict[Tuple[str, int], str] = {}
    categories: Dict[str, Dict[str, int]] = {}
    host_bytes: Dict[str, int] = {}
    cuda_bytes: Dict[int, int] = {}
    for category, ref, fn in _live_providers():
        obj = ref()
        if obj is None:
            continue
        try:
            arrs = list(fn(obj) or ())
        except Exception:  # a torn-down provider must not kill sampling
            continue
        for a in arrs:
            data = getattr(a, "_data", a)  # NDArray -> its tensor
            if isinstance(data, np.ndarray):
                host_bytes[category] = (host_bytes.get(category, 0)
                                        + int(data.nbytes))
                continue
            if not isinstance(data, torch.Tensor):
                continue
            storage = data.untyped_storage()
            key = (str(data.device), storage.data_ptr())
            if key in seen:
                continue
            seen[key] = category
            nb = int(storage.nbytes())
            row = categories.setdefault(category, {"count": 0, "nbytes": 0})
            row["count"] += 1
            row["nbytes"] += nb
            if data.device.type == "cuda":
                idx = data.device.index or 0
                cuda_bytes[idx] = cuda_bytes.get(idx, 0) + nb
    total = sum(row["nbytes"] for row in categories.values())
    count = sum(row["count"] for row in categories.values())
    if _cuda_live():
        rest = 0
        for idx in range(torch.cuda.device_count()):
            rest += max(0, int(torch.cuda.memory_allocated(idx))
                        - cuda_bytes.get(idx, 0))
        if rest:
            categories["other"] = {"count": 0, "nbytes": rest}
            total += rest
    return {"total_bytes": total, "live_count": count,
            "categories": categories, "host_bytes": host_bytes}


def _cuda_stats(idx: int) -> dict:
    """Card ``idx``'s allocator counters in the raw shape
    ``normalize_memory_stats`` takes: current and peak allocated bytes
    (``torch.cuda.memory_stats``) and the card's total memory."""
    stats = torch.cuda.memory_stats(idx)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(idx).total_memory}


def device_memory() -> dict:
    """Summed normalized allocator counters over the cards:
    ``{"available", "bytes_in_use", "peak_bytes_in_use", "bytes_limit",
    "devices": n}``.  ``available=False`` on the CPU (no allocator
    stats), as the JAX module reports on XLA:CPU."""
    out = {"available": False, "bytes_in_use": 0, "peak_bytes_in_use": 0,
           "bytes_limit": 0, "devices": 1}
    if not _cuda_live():
        return out
    out["devices"] = 0
    for idx in range(torch.cuda.device_count()):
        try:
            norm = normalize_memory_stats(_cuda_stats(idx))
        except Exception:
            norm = normalize_memory_stats(None)
        out["devices"] += 1
        if norm["available"]:
            out["available"] = True
            out["bytes_in_use"] += norm["bytes_in_use"]
            out["peak_bytes_in_use"] += norm["peak_bytes_in_use"]
            out["bytes_limit"] += norm["bytes_limit"]
    return out


# ---------------------------------------------------------------------------
# sampling + leak detection
# ---------------------------------------------------------------------------
def on_step(step: Optional[int] = None) -> None:
    """Step-boundary observation: samples every ``MX_MEMWATCH_EVERY``-th
    call (``Trainer.step``, ``AsyncCheckpointer.step``)."""
    if not enabled():
        return
    with _state.lock:
        _state.step_calls += 1
        due = _state.step_calls % _every() == 0
    if due:
        sample("step", step=step)


def on_checkpoint(event: str, step: Optional[int] = None) -> None:
    """Checkpoint save/load boundary: always samples."""
    if not enabled():
        return
    sample(f"checkpoint_{event}", step=step)


def sample(site: str, step: Optional[int] = None) -> Optional[dict]:
    """Take one memory sample now: census + allocator counters -> one
    ``mem`` event; feeds the watermark and the leak window.  Returns the
    event fields (None when disabled)."""
    if not enabled():
        return None
    try:
        c = census()
    except Exception as e:  # the watchdog must never kill the run
        _LOG.warning("memwatch census failed: %s", e)
        return None
    dev = device_memory()
    in_use = dev["bytes_in_use"] if dev["available"] else c["total_bytes"]
    leak = None
    with _state.lock:
        _state.samples += 1
        _state.watermark = max(_state.watermark, in_use, c["total_bytes"])
        watermark = _state.watermark
        _state.last_categories = {
            cat: row["nbytes"] for cat, row in c["categories"].items()}
        win = _state.window
        win.append((c["total_bytes"], dict(_state.last_categories)))
        w = _leak_window()
        if len(win) > w:
            del win[:-w]
        if len(win) == w:
            totals = [t for t, _cats in win]
            growing = all(b > a for a, b in zip(totals, totals[1:]))
            growth = totals[-1] - totals[0]
            if growing and growth > _LEAK_MIN_GROWTH:
                if not _state.leak_active:
                    _state.leak_active = True
                    _state.leak_events += 1
                    first_cats, last_cats = win[0][1], win[-1][1]
                    deltas = {cat: last_cats.get(cat, 0)
                              - first_cats.get(cat, 0)
                              for cat in set(first_cats) | set(last_cats)}
                    top = max(deltas, key=deltas.get) if deltas else "other"
                    _state.leak_category = top
                    leak = {"category": top, "growth_bytes": growth,
                            "window": w,
                            "category_growth_bytes": deltas.get(top, 0)}
            else:
                # growth stopped: re-arm so a later real leak warns again
                _state.leak_active = False
    ev: Dict[str, Any] = {
        "site": site,
        "live_bytes": c["total_bytes"],
        "live_count": c["live_count"],
        "watermark_bytes": watermark,
        "categories": c["categories"],
    }
    if step is not None:
        ev["step"] = int(step)
    if dev["available"]:
        ev["bytes_in_use"] = dev["bytes_in_use"]
        ev["peak_bytes_in_use"] = dev["peak_bytes_in_use"]
        ev["bytes_limit"] = dev["bytes_limit"]
    if c["host_bytes"]:
        ev["host_bytes"] = c["host_bytes"]
    telemetry.record("mem", **ev)
    if leak is not None:
        _LOG.warning(
            "memwatch: attributed memory grew monotonically across the "
            "last %d samples (+%d bytes); top-growing category: %s "
            "(+%d bytes).  If this trend continues the run will run out "
            "of device memory — check for accumulating references.",
            leak["window"], leak["growth_bytes"], leak["category"],
            leak["category_growth_bytes"])
        telemetry.record("mem_leak", total_bytes=c["total_bytes"], **leak)
    return ev


def peak_bytes() -> int:
    """Best-effort process peak device bytes: the allocator's summed
    peak where there is one, else the census watermark."""
    dev = device_memory()
    if dev["available"]:
        with _state.lock:
            _state.watermark = max(_state.watermark,
                                   dev["peak_bytes_in_use"])
            return _state.watermark
    try:
        total = census()["total_bytes"]
    except Exception:
        total = 0
    with _state.lock:
        _state.watermark = max(_state.watermark, total)
        return _state.watermark


def fingerprint(parts: Any) -> str:
    """Stable structural fingerprint: sha256 over the repr of
    shapes/dtypes/configuration, never object ids, so the same structure
    maps to the same fingerprint in a restarted process."""
    return hashlib.sha256(repr(parts).encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# OOM post-mortem
# ---------------------------------------------------------------------------
def is_resource_exhausted(exc: BaseException) -> bool:
    """Does this exception look like a device OOM?  A
    ``torch.cuda.OutOfMemoryError``, or the ``RESOURCE_EXHAUSTED`` text
    of the JAX package's errors and of the ``oom:step=N`` fault."""
    oom_cls = getattr(torch.cuda, "OutOfMemoryError", None)
    if oom_cls is not None and isinstance(exc, oom_cls):
        return True
    return "RESOURCE_EXHAUSTED" in str(exc)


def emit_oom_report(executor: str = "", step: Optional[int] = None,
                    inflight_depth: Optional[int] = None) -> None:
    """Record and FLUSH one ``oom_report`` event (last watermark, a fresh
    census with the largest category named, the in-flight depth), once
    per process; never raises.  ``top_executables`` is empty: the port
    compiles none."""
    try:
        if not enabled():
            return
        with _state.lock:
            if _state.oom_reported:
                return
            _state.oom_reported = True
            watermark = _state.watermark
        try:
            c = census()
        except Exception:
            c = {"total_bytes": 0, "live_count": 0, "categories": {},
                 "host_bytes": {}}
        cats = {cat: row["nbytes"] for cat, row in c["categories"].items()}
        largest = max(cats, key=cats.get) if cats else None
        ev: Dict[str, Any] = {
            "executor": executor,
            "watermark_bytes": max(watermark, c["total_bytes"]),
            "live_bytes": c["total_bytes"],
            "live_count": c["live_count"],
            "categories": cats,
            "largest_category": largest,
            "top_executables": [],
        }
        if step is not None:
            ev["step"] = int(step)
        if inflight_depth is not None:
            ev["inflight_depth"] = int(inflight_depth)
        dev = device_memory()
        if dev["available"]:
            ev["bytes_in_use"] = dev["bytes_in_use"]
            ev["bytes_limit"] = dev["bytes_limit"]
        telemetry.record("oom_report", **ev)
        # the process is about to die on the re-raise: land it on disk now
        telemetry.flush()
    except Exception:
        # the post-mortem must never mask the original error
        pass


# ---------------------------------------------------------------------------
# rollup
# ---------------------------------------------------------------------------
def summary() -> dict:
    """JSON-serializable rollup (the ``mx_mem_*`` gauges derive from it);
    the JAX module's keys, ``compiles`` always zero."""
    with _state.lock:
        return {
            "enabled": enabled(),
            "samples": _state.samples,
            "watermark_bytes": _state.watermark,
            "categories": dict(_state.last_categories),
            "leak": {"active": _state.leak_active,
                     "category": _state.leak_category,
                     "events": _state.leak_events},
            "compiles": {"count": 0, "wall_ms": 0.0, "cache_hits": 0},
            "oom_reported": _state.oom_reported,
        }
