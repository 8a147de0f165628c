"""The profiler facade: ``set_config`` / ``start`` / ``stop`` / ``dump`` and
the per-op aggregate table of ``dumps``.

Counterpart of ``mxnet_tpu/profiler.py``.  ``start()`` / ``stop()``
bracket a ``torch.profiler.profile`` of the host (CPU activity) and, with
a card, of the device (CUDA activity); each ``start()`` / ``resume()``
writes one numbered segment, a Chrome trace JSON file
(``<trace dir>/segment-NNN.json``), as the JAX profiler writes one trace
directory a segment.  ``scope`` and ``Task`` are
``torch.profiler.record_function`` ranges.

The aggregate table counts work where it is issued, as the JAX package's
does: the registry's ``invoke``, a hybridized block's ``CachedOp``
(``"CachedOp:<class>"``) and the training step (its ``profile_label``).
The port's Gluon layers and models call the op functions without the
registry, so every registered op function is a site too
(:func:`op_site`, applied by ``ops.registry.register``), and so are the
few layers that call a kernel or torch directly (``LayerNorm``,
``FullyConnected`` without flattening, ``_contrib_flash_attention``).
Each profiled call counts once, under the outermost site: a call inside
another profiled call (an op inside a ``CachedOp``, a registry op's
function under ``invoke``) is not recorded, as the JAX package records
no op traced inside a compiled call.  A profiled call runs what an
unprofiled one runs (the kernel on the card), then synchronizes the
device of its result before it reads the clock.  With the profiler
stopped a site adds one Python call and one boolean check to the call
it wraps (``chip_smoke.py``'s profile_bert and train_sparse_lm measure
what that costs a training step).
"""
from __future__ import annotations

import functools
import json
import os
import threading
import time

import torch

from .base import MXNetError

__all__ = ["set_config", "start", "stop", "dump", "dumps", "pause", "resume",
           "scope", "Task", "Frame", "Marker", "state", "reset_stats",
           "record_op", "timed_call", "is_recording", "op_site"]

_config = {"filename": "profile.json", "profile_all": False,
           "trace_dir": None}
# the one flag every site reads: True between start() and stop()
_running = False
_segments: list = []
_prof = None  # the live torch.profiler.profile of the current segment
_tls = threading.local()  # .inside: a profiled call is on this thread

# name -> [calls, total s, min s, max s, peak bytes]
_aggregate: dict = {}
_lock = threading.Lock()


def is_recording() -> bool:
    """True while op timings are collected (between start and stop)."""
    return _running


def record_op(name: str, seconds: float, memory: int = 0) -> None:
    """Record one execution of ``name``; ``memory`` is the peak device
    bytes seen for the call (``profile_memory``), the aggregate keeps the
    largest."""
    with _lock:
        ent = _aggregate.get(name)
        if ent is None:
            _aggregate[name] = [1, seconds, seconds, seconds, memory]
        else:
            ent[0] += 1
            ent[1] += seconds
            ent[2] = min(ent[2], seconds)
            ent[3] = max(ent[3], seconds)
            ent[4] = max(ent[4], memory)


def reset_stats() -> None:
    with _lock:
        _aggregate.clear()


def _profile_memory_on() -> bool:
    return bool(_config.get("profile_memory") or _config.get("profile_all"))


def _cuda_devices(obj, found):
    """The CUDA devices of the tensors in ``obj`` (tensors, NDArrays and
    nests of lists, tuples and dicts)."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            found.add(obj.device)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _cuda_devices(x, found)
    elif isinstance(obj, dict):
        for x in obj.values():
            _cuda_devices(x, found)
    else:
        data = getattr(obj, "_data", None)
        if isinstance(data, torch.Tensor):
            _cuda_devices(data, found)
    return found


def timed_call(name: str, fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)``, wait for the devices of its result and
    record the wall time under ``name``; a call made inside another
    profiled call on this thread is run and not recorded."""
    if getattr(_tls, "inside", False):
        return fn(*args, **kwargs)
    _tls.inside = True
    try:
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        for dev in _cuda_devices(result, set()):
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
    finally:
        _tls.inside = False
    mem = 0
    if _profile_memory_on():
        from . import memwatch

        try:
            mem = memwatch.peak_bytes()
        except Exception:
            mem = 0
    record_op(name, dt, memory=mem)
    return result


def op_site(name: str, fn):
    """``fn`` as a profiler site named ``name``: called as is while the
    profiler is stopped, through :func:`timed_call` while it runs."""

    @functools.wraps(fn)
    def site(*args, **kwargs):
        if not _running:
            return fn(*args, **kwargs)
        return timed_call(name, fn, *args, **kwargs)

    return site


def set_config(**kwargs):
    """Takes the reference's keywords (``profile_all``,
    ``profile_symbolic``, ``profile_imperative``, ``profile_memory``,
    ``profile_api``, ``filename``, ...); ``filename`` names the trace
    directory ``<filename without extension>_torch_trace``."""
    _config.update(kwargs)
    if "filename" in kwargs:
        _config["trace_dir"] = (os.path.splitext(kwargs["filename"])[0]
                                + "_torch_trace")


def _trace_dir():
    if _config["trace_dir"] is None:
        _config["trace_dir"] = "mxnet_tpu_torch_profile"
    return _config["trace_dir"]


# tiny kernels each segment starts with on the current card (see _prime)
PRIME_KERNELS = 512


def _prime(dev):
    """Launch PRIME_KERNELS one-element adds on ``dev`` (the current
    card), in a ``mx.profiler.prime`` range, and wait for them.  A new
    ``torch.profiler`` session on a card loses some of the first device
    events it records, more the older the process (``chip_smoke.py``'s
    profile_bert counts them in a session without this); the loss falls
    on these adds, and the kernels after them are all listed.  Their
    launches are in the segment's trace, not in the aggregate."""
    buf = torch.zeros(1, device=dev)
    with torch.profiler.record_function("mx.profiler.prime"):
        for _ in range(PRIME_KERNELS):
            buf.add_(0)
        if buf.is_cuda:
            torch.cuda.synchronize(dev)


def start():
    """Begin a trace segment and the aggregate's collection."""
    global _running, _prof
    from torch.profiler import ProfilerActivity, profile

    if _running:
        return
    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    _prof = profile(activities=acts)
    _prof.start()
    if cuda:
        _prime(torch.device("cuda", torch.cuda.current_device()))
    _running = True


def stop():
    """End the segment: its Chrome trace is written as the next numbered
    file of the trace directory."""
    global _running, _prof
    if not _running:
        return
    _running = False
    prof, _prof = _prof, None
    prof.stop()
    os.makedirs(_trace_dir(), exist_ok=True)
    path = os.path.join(_trace_dir(), f"segment-{len(_segments):03d}.json")
    prof.export_chrome_trace(path)
    _segments.append(path)


def state():
    return "running" if _running else "stopped"


def pause():
    """Suspend tracing; ``resume()`` continues into a fresh segment."""
    stop()


def resume():
    start()


def dump(finished=True, profile_process="worker"):
    """Stop a running profile and return the trace segment files written
    so far, one per ``start()`` / ``resume()``."""
    if _running:
        stop()
    return list(_segments)


def dumps(reset=False, format="table", sort_by="total", ascending=False):
    """The ranked per-op aggregate: ``format="table"`` (with the trace
    location and the telemetry rollup) or ``"json"`` (a list of rows:
    name, count, total_ms, avg_ms, min_ms, max_ms, and peak_mem_bytes when
    memory was profiled); ``sort_by`` total, count, avg, min or max."""
    if format not in ("table", "json"):
        raise MXNetError(f"unsupported dumps format {format!r}")
    with _lock:
        items = [(n, tuple(e)) for n, e in _aggregate.items()]
    if not items:
        if format == "json":
            return json.dumps([])
        return (f"profile trace directory: {_trace_dir()}\n"
                "(no per-op stats recorded — run ops between profiler."
                "start() and stop())" + _telemetry_rollup_lines())
    key = {"total": lambda e: e[1][1], "count": lambda e: e[1][0],
           "avg": lambda e: e[1][1] / e[1][0], "min": lambda e: e[1][2],
           "max": lambda e: e[1][3]}.get(sort_by, lambda e: e[1][1])
    rows = sorted(items, key=key, reverse=not ascending)
    has_mem = any(m for _n, (_c, _t, _mn, _mx, m) in rows)
    if format == "json":
        out = [dict({"name": n, "count": c, "total_ms": t * 1e3,
                     "avg_ms": t / c * 1e3, "min_ms": mn * 1e3,
                     "max_ms": mx * 1e3},
                    **({"peak_mem_bytes": m} if has_mem else {}))
               for n, (c, t, mn, mx, m) in rows]
        if reset:
            reset_stats()
        return json.dumps(out)
    name_w = max(24, max(len(n) for n, _ in rows) + 2)
    header = (f"{'Name':<{name_w}}{'Calls':>8}{'Total(ms)':>12}"
              f"{'Avg(ms)':>10}{'Min(ms)':>10}{'Max(ms)':>10}")
    if has_mem:
        header += f"{'Peak(MB)':>10}"
    lines = ["Profile Statistics:", header,
             "-" * (name_w + 50 + (10 if has_mem else 0))]
    for name, (count, total, mn, mx, mem) in rows:
        line = (f"{name:<{name_w}}{count:>8}{total * 1e3:>12.3f}"
                f"{total / count * 1e3:>10.3f}{mn * 1e3:>10.3f}"
                f"{mx * 1e3:>10.3f}")
        if has_mem:
            line += f"{mem / 1e6:>10.2f}"
        lines.append(line)
    lines.append(f"\nprofile trace directory: {_trace_dir()}")
    if len(_segments) > 1:
        lines.append("trace segments: " + ", ".join(_segments))
    lines.append(_telemetry_rollup_lines().lstrip("\n"))
    if reset:
        reset_stats()
    return "\n".join(lines)


def _telemetry_rollup_lines() -> str:
    """The runtime-telemetry rollup that ``dumps()`` appends."""
    from . import telemetry

    return "\n\nTelemetry rollup:\n" + json.dumps(telemetry.summary(),
                                                  sort_keys=True)


class scope:
    """A named range in the trace (reference: ``profiler.scope``)."""

    def __init__(self, name="<unk>", append_mode=False):
        self._name = name
        self._ctx = None

    def __enter__(self):
        self._ctx = torch.profiler.record_function(self._name)
        self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        self._ctx.__exit__(*exc)
        return False


class Task:
    """A named range opened by ``start()`` and closed by ``stop()``
    (reference: ``profiler.Task``)."""

    def __init__(self, domain=None, name="task"):
        self.name = name
        self._ctx = None

    def start(self):
        self._ctx = torch.profiler.record_function(self.name)
        self._ctx.__enter__()

    def stop(self):
        if self._ctx is not None:
            self._ctx.__exit__(None, None, None)
            self._ctx = None


Frame = Task
Marker = Task

if os.environ.get("MXNET_PROFILER_AUTOSTART", "0").lower() in (
        "1", "true", "yes", "on"):
    start()
