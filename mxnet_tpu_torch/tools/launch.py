"""Launch and supervise a gang of worker processes on this host, one per
card.

The port's copy of the JAX package's ``tools/launch.py``: the same command
line, exports, exit-code semantics and supervisor, importable without the
package (the standard library only)::

    python -m mxnet_tpu_torch.tools.launch -n 4 --launcher local \\
        python -m mxnet_tpu_torch.tools.multigpu_smoke

Each worker gets ``MX_COORDINATOR`` (127.0.0.1 and a free port),
``MX_NUM_PROCS``, ``MX_PROC_ID``, ``MX_LOCAL_RANK``, ``MX_RESTART_COUNT``
and the reference spellings ``DMLC_ROLE``, ``DMLC_PS_ROOT_URI``,
``DMLC_PS_ROOT_PORT``, ``DMLC_NUM_WORKER``, ``DMLC_NUM_SERVER`` and
``DMLC_WORKER_ID``; ``--force-cpu`` adds ``MX_FORCE_CPU=1`` (a gloo group
on the CPU).  The workers' lines are copied to this process's streams with
a ``[rank N]`` prefix.  A worker that exits non-zero brings the others down
(SIGTERM, then SIGKILL after ``--term-timeout`` seconds).

The supervisor: ``--max-restarts`` re-spawns a failed gang on a fresh port
with exponential ``--restart-backoff`` (workers resume from their newest
valid checkpoint; exit 83, ``fault.EXIT_PREEMPTED``, is a preemption);
``--elastic`` shrinks an exhausted gang by its culprits down to
``--min-workers``, ``--initial-workers`` starts it degraded and
``--regrow-after`` grows it back one rank at a time; ``MX_ELASTIC=1`` goes
to every incarnation and ``MX_PREV_NUM_PROCS`` to the first after a
resize.  Under ``MX_TELEMETRY_DIR`` a monitor watches the heartbeats, keeps
the survivors' ``/statusz`` and ``/healthz`` when a rank dies, and prints
each rank's flight-recorder tail, OOM report and the gang's trace and
serving reports (``trace_report.py`` and ``serve_report.py`` beside this
file, run as subprocesses); ``--metrics-port`` serves the merged gang
``/metrics`` and ``/healthz``, ``--serve-port`` exports ``MX_SERVE_PORT``.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

__all__ = ["main", "launch", "launch_local", "EXIT_PREEMPTED"]


# Exit code a worker uses after a SIGTERM-triggered final checkpoint
# ("clean preemption").  Kept in sync with fault.py EXIT_PREEMPTED by value:
# this launcher must stay importable without torch or the package.
EXIT_PREEMPTED = 83

# flight-recorder events echoed per rank when a gang dies
FLIGHT_TAIL_EVENTS = 8


def _tee(stream, sink, prefix: str) -> None:
    """Copy worker output to our own stream, one line at a time, with a
    `[rank N]` prefix so interleaved gang logs stay attributable."""
    try:
        for line in iter(stream.readline, ""):
            sink.write(prefix + line)
            sink.flush()
    except ValueError:  # stream closed under us during teardown
        pass
    finally:
        try:
            stream.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# telemetry (telemetry.py writes these files; the filename patterns are
# duplicated here because this launcher must stay importable without
# torch or the package — keep in sync with telemetry.event_path /
# telemetry.heartbeat_path)
# ---------------------------------------------------------------------------
def _flight_tail(tdir: str, rank: int, k: int = FLIGHT_TAIL_EVENTS):
    """Last k events of a rank's telemetry stream, rendered for humans:
    span begin/end pairs collapse into ONE ``"kind": "span"`` line
    carrying the duration (the raw pair would burn two slots of an
    8-event tail on one fact), clock_anchor bookkeeping lines are
    dropped, and an unmatched span_begin survives as-is — an OPEN span in
    a dead rank's tail is exactly the "died inside X" post-mortem clue.
    A span_end whose begin scrolled off the raw window renders as a
    collapsed span line by itself (the end alone carries name + dur_ms).
    Non-span lines pass through verbatim."""
    path = os.path.join(tdir, f"rank-{rank}.jsonl")
    try:
        with open(path, errors="replace") as f:
            # read enough raw lines that k survives the collapsing
            raw = [line.rstrip("\n") for line in deque(f, maxlen=8 * k)]
    except OSError:
        return []
    rendered = []  # (span id or None, text line)
    begins = {}    # span id -> index into rendered (pending span_begin)
    for line in raw:
        try:
            ev = json.loads(line)
        except ValueError:
            rendered.append((None, line))
            continue
        if not isinstance(ev, dict):
            rendered.append((None, line))
            continue
        kind = ev.get("kind")
        if kind == "clock_anchor":
            continue
        if kind == "span":
            # complete hot-path span: strip the merge-key plumbing so the
            # 8-event tail spends its width on the facts
            merged = {k: v for k, v in ev.items()
                      if k not in ("span", "parent", "depth", "tid",
                                   "mono")}
            rendered.append((None, json.dumps(merged)))
        elif kind == "span_begin" and "span" in ev:
            begins[ev["span"]] = len(rendered)
            rendered.append((ev["span"], line))
        elif kind == "span_end" and ev.get("span") in begins:
            idx = begins.pop(ev["span"])
            begin_ev = json.loads(rendered[idx][1])
            merged = {"t": begin_ev.get("t"), "kind": "span",
                      "rank": ev.get("rank"), "name": ev.get("name"),
                      "dur_ms": ev.get("dur_ms")}
            merged.update({kk: vv for kk, vv in begin_ev.items()
                           if kk not in ("t", "kind", "rank", "name",
                                         "span", "parent", "depth", "tid",
                                         "mono")})
            if "error" in ev:
                merged["error"] = ev["error"]
            rendered[idx] = (None, json.dumps(merged))
        elif kind == "span_end":
            # begin fell off the raw window; the end alone still carries
            # the fact (name + dur_ms) — render it as a collapsed span
            # so e.g. a multi-second checkpoint_save finishing right
            # before death isn't silently absent from the tail
            merged = {k2: v for k2, v in ev.items()
                      if k2 not in ("span", "parent", "depth", "tid",
                                    "mono")}
            merged["kind"] = "span"
            rendered.append((None, json.dumps(merged)))
        else:
            rendered.append((None, line))
    return [text for _sid, text in rendered[-k:]]


def _fmt_mb(n) -> str:
    try:
        return f"{float(n) / 1e6:.1f}MB"
    except (TypeError, ValueError):
        return "?"


def _oom_report(tdir: str, rank: int):
    """The newest ``oom_report`` event in a rank's stream, if any —
    memwatch (memwatch.py) records + flushes one before an
    out-of-memory error re-raises, so a rank that died OOM carries its
    own post-mortem (largest live-array category, watermark, in-flight
    depth, top executables)."""
    path = os.path.join(tdir, f"rank-{rank}.jsonl")
    try:
        with open(path, errors="replace") as f:
            raw = deque(f, maxlen=512)
    except OSError:
        return None
    found = None
    for line in raw:
        try:
            ev = json.loads(line)
        except ValueError:
            continue
        if isinstance(ev, dict) and ev.get("kind") == "oom_report":
            found = ev
    return found


def _print_oom_report(ev: dict, rank: int) -> None:
    cats = ev.get("categories") or {}
    largest = ev.get("largest_category")
    parts = [f"launch.py: rank {rank} OOM post-mortem"
             + (f" (step {ev['step']})" if ev.get("step") is not None
                else "") + ":"]
    if largest:
        parts.append(f"largest live-array category {largest} "
                     f"({_fmt_mb(cats.get(largest, 0))} of "
                     f"{_fmt_mb(ev.get('live_bytes', 0))} live);")
    parts.append(f"watermark {_fmt_mb(ev.get('watermark_bytes', 0))};")
    if ev.get("inflight_depth") is not None:
        parts.append(f"inflight depth {ev['inflight_depth']};")
    if ev.get("bytes_limit"):
        parts.append(f"device limit {_fmt_mb(ev['bytes_limit'])};")
    top = ev.get("top_executables") or []
    if top:
        t = top[0]
        weight = (t.get("temp_bytes") or t.get("bytes_accessed")
                  or t.get("arg_bytes") or 0)
        parts.append(f"top executable {t.get('executor')}"
                     f"[{t.get('fingerprint')}] ({_fmt_mb(weight)})")
    print(" ".join(parts).rstrip(";"), file=sys.stderr)


def _print_trace_report(tdir: str) -> None:
    """Run trace_report.py (beside this file) over the telemetry dir and
    echo its gang-wide analysis (straggler flags, step breakdown,
    collective bandwidth) into the supervisor's stderr next to the flight
    tails.
    Subprocess on purpose: the report is stdlib-only and must not be able
    to wedge the supervisor even if the telemetry dir is garbage."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "trace_report.py")
    if not os.path.isfile(script):
        return
    try:
        res = subprocess.run([sys.executable, script, tdir],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        print(f"launch.py: trace report failed: {e}", file=sys.stderr)
        return
    body = (res.stdout or "").strip()
    if body:
        print("launch.py: gang trace report:", file=sys.stderr)
        for line in body.splitlines():
            print(f"  {line}", file=sys.stderr)
    if res.returncode == 3:
        print("launch.py: trace report flagged anomalies (exit 3) — see "
              "above", file=sys.stderr)


def _serving_streams_present(tdir: str) -> bool:
    """Whether any telemetry stream under ``tdir`` carries serving
    events/spans (the ``serve_`` vocabulary).  Bounded scan — the
    supervisor must not slurp multi-GB streams just to decide whether
    to run serve_report."""
    try:
        names = sorted(os.listdir(tdir))
    except OSError:
        return False
    for name in names:
        if not (name.startswith("rank-") and name.endswith(".jsonl")):
            continue
        try:
            with open(os.path.join(tdir, name), "rb") as f:
                if b'"serve_' in f.read(262_144):
                    return True
        except OSError:
            continue
    return False


def _print_serve_report(tdir: str) -> None:
    """Run serve_report.py (beside this file) over the telemetry dir and
    echo the per-request tail attribution — most importantly the
    UNFINISHED request trees ("died inside X", fleet edition) — next to
    the flight tails.  Subprocess + timeout for the same reason as
    _print_trace_report: stdlib-only, must not wedge the supervisor."""
    script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "serve_report.py")
    if not os.path.isfile(script):
        return
    try:
        res = subprocess.run([sys.executable, script, tdir],
                             capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        print(f"launch.py: serve report failed: {e}", file=sys.stderr)
        return
    body = (res.stdout or "").strip()
    if body:
        print("launch.py: serving request report:", file=sys.stderr)
        for line in body.splitlines():
            print(f"  {line}", file=sys.stderr)
    if res.returncode == 3:
        print("launch.py: serve report flagged SLO violations (exit 3) "
              "— see above", file=sys.stderr)


def _reexport_trace(tdir) -> None:
    """Re-merge the gang Chrome trace after EVERY rank has been reaped.

    With MX_TRACE_EXPORT on, rank 0's own atexit hook merges the gang
    trace at rank 0's process exit — but peer ranks may still be running
    (rank 0 finishing first is the NORMAL case when another rank is the
    straggler), so that merge can read their streams mid-write and drop
    exactly the straggler tail the trace exists to show.  The supervisor
    owns the only moment the files are known complete, so it re-runs the
    merge and overwrites rank 0's best-effort trace.json.  Subprocess on
    purpose (like _print_trace_report): the exporter lives in
    the package's telemetry, whose import pulls in torch, which must not
    be able to wedge the supervisor."""
    raw = os.environ.get("MX_TRACE_EXPORT", "").strip()
    if not tdir or not raw or raw.lower() in ("0", "false", "off"):
        return
    target = tdir if raw.lower() in ("1", "true", "on") else raw
    env = dict(os.environ)
    # the child must neither re-race the export from its own atexit nor
    # attach a recorder that pollutes the run's streams (empty
    # MX_TELEMETRY_DIR leaves telemetry disabled at import)
    env.pop("MX_TRACE_EXPORT", None)
    env["MX_TELEMETRY_DIR"] = ""
    code = ("import sys\n"
            "from mxnet_tpu_torch import telemetry\n"
            "telemetry.export_chrome_trace(sys.argv[1], out=sys.argv[2])\n")
    try:
        res = subprocess.run(
            [sys.executable, "-c", code, tdir,
             os.path.join(target, "trace.json")],
            capture_output=True, text=True, timeout=120, env=env)
    except (OSError, subprocess.TimeoutExpired) as e:
        print(f"launch.py: gang trace re-export failed: {e}",
              file=sys.stderr)
        return
    if res.returncode != 0:
        print("launch.py: gang trace re-export failed: "
              f"{(res.stderr or '').strip()[-500:]}", file=sys.stderr)


# ---------------------------------------------------------------------------
# gang metrics plane (metrics_server.py serves the per-rank
# endpoints and writes metrics-port-<R>.json portfiles next to the
# heartbeats; the filename pattern is duplicated here because this
# launcher must stay importable without torch or the package — keep in sync
# with metrics_server.portfile_path)
# ---------------------------------------------------------------------------
SCRAPE_TIMEOUT = 2.0


def _rank_endpoint(tdir, rank):
    """http://host:port for a rank's live metrics endpoint (from its
    portfile), or None when the rank never advertised one.  The
    portfile's ``host`` is the connectable address the rank bound
    (MX_METRICS_HOST; wildcard binds advertise loopback) — hardcoding
    127.0.0.1 would break the whole supervisor plane for a
    specific-NIC bind."""
    try:
        with open(os.path.join(tdir, f"metrics-port-{rank}.json")) as f:
            rec = json.load(f)
        port = int(rec["port"])
        host = str(rec.get("host") or "127.0.0.1")
    except (OSError, ValueError, KeyError, TypeError):
        return None
    return f"http://{host}:{port}"


def _http_get(url, timeout=SCRAPE_TIMEOUT):
    """(status, body) for a GET, or (None, error string) when the
    endpoint is unreachable.  5xx bodies are read, not raised — a 503
    /healthz verdict carries the diagnosis."""
    try:
        with urllib.request.urlopen(url, timeout=timeout) as resp:
            return resp.status, resp.read().decode("utf-8", "replace")
    except urllib.error.HTTPError as e:
        try:
            return e.code, e.read().decode("utf-8", "replace")
        except OSError:
            return e.code, ""
    except (OSError, ValueError) as e:
        return None, str(e)


def _scrape_ranks(tdir, num, route, timeout=SCRAPE_TIMEOUT):
    """{rank: (status, body) or (None, reason)} — all ranks scraped
    CONCURRENTLY, so one merged request costs ~one SCRAPE_TIMEOUT even
    when several wedged ranks accept TCP and stall: a sequential walk of
    an 8-rank gang could take 8x the timeout, blowing the Prometheus
    scrape deadline exactly during the incident being observed."""
    out = {}
    threads = []
    for rank in range(num):
        base = _rank_endpoint(tdir, rank)
        if base is None:
            out[rank] = (None, "no metrics portfile")
            continue

        def fetch(rank=rank, base=base):
            out[rank] = _http_get(f"{base}{route}", timeout=timeout)

        t = threading.Thread(target=fetch, daemon=True)
        t.start()
        threads.append(t)
    deadline = time.monotonic() + timeout + 1.0
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    for rank in range(num):
        out.setdefault(rank, (None, "scrape thread timed out"))
    return out


def _merge_expositions(per_rank):
    """Merge per-rank OpenMetrics bodies ({rank: body or None}) into ONE
    gang exposition: rank samples pass through (they already carry
    rank="R" labels) but are REGROUPED by metric family — the
    OpenMetrics content type promises each family is one uninterrupted
    block, and strict parsers (Prometheus, promtool) reject interleaved
    families, which naive rank-by-rank concatenation produces the
    moment two ranks are up.  Each rank contributes an ``up`` gauge
    (1 = scraped, 0 = endpoint down/unreachable) and an
    ``mx_scrape_staleness_seconds`` gauge measuring DATA age: the rank's
    own ``mx_heartbeat_age_seconds`` when present — a wedged training
    loop stops heartbeating, so this grows even while the rank's HTTP
    thread keeps answering with fresh render timestamps — else the age
    of its ``mx_export_timestamp_seconds`` stamp (meaningful for a
    never-heartbeat process: how old the exposition itself is)."""
    out = ["# TYPE up gauge"]
    staleness = {}
    now = time.time()
    for rank in sorted(per_rank):
        body = per_rank[rank]
        out.append(f'up{{rank="{rank}"}} {1 if body is not None else 0}')
        if body is None:
            continue
        hb_age = export_age = None
        for line in body.splitlines():
            try:
                if line.startswith("mx_heartbeat_age_seconds"):
                    hb_age = max(0.0, float(line.split()[-1]))
                elif line.startswith("mx_export_timestamp_seconds"):
                    export_age = max(0.0, now - float(line.split()[-1]))
            except (ValueError, IndexError):
                pass
        if hb_age is not None:
            staleness[rank] = hb_age
        elif export_age is not None:
            staleness[rank] = export_age
    if staleness:
        out.append("# TYPE mx_scrape_staleness_seconds gauge")
        for rank, age in sorted(staleness.items()):
            out.append(f'mx_scrape_staleness_seconds{{rank="{rank}"}} '
                       f"{round(age, 3)}")
    # family name -> [type line, sample, sample, ...] in first-seen order
    families = {}
    for rank in sorted(per_rank):
        body = per_rank[rank]
        if body is None:
            continue
        for line in body.splitlines():
            if not line or line.startswith("# EOF"):
                continue  # ONE terminator, appended below
            if line.startswith("# TYPE "):
                parts = line.split()
                name = parts[2] if len(parts) > 2 else line
                families.setdefault(name, [line])
                continue
            if line.startswith("#"):
                continue
            name = line.split("{", 1)[0].split(" ", 1)[0]
            families.setdefault(name, []).append(line)
    for lines in families.values():
        out.extend(lines)
    out.append("# EOF")
    return "\n".join(out) + "\n"


class _GangMetricsServer:
    """The supervisor's merged gang ``/metrics`` (+ ``/healthz``):
    scrape-on-demand over every rank's discovered portfile endpoint, so
    one Prometheus target covers the whole gang and a dead rank flips
    its ``up`` gauge within one scrape interval.  Stdlib-only, daemon
    threads, and inert when the telemetry dir (portfile home) is
    unknown."""

    def __init__(self, tdir, num_workers, port):
        self.tdir = tdir
        self.num = num_workers  # supervisor updates on elastic resize
        outer = self

        class Handler(BaseHTTPRequestHandler):
            server_version = "mxnet-tpu-gang-metrics/1"

            def do_GET(self):  # noqa: N802 (http.server contract)
                route = self.path.split("?", 1)[0].rstrip("/") or "/"
                if route in ("/", "/metrics"):
                    code, ctype, body = outer.merged_metrics()
                elif route == "/healthz":
                    code, ctype, body = outer.merged_healthz()
                else:
                    code, ctype, body = (404, "text/plain; charset=utf-8",
                                         f"no such route {route!r}; try "
                                         "/metrics /healthz\n")
                payload = body.encode("utf-8", "replace")
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def log_message(self, fmt, *args):
                pass  # scrapes must not interleave with [rank N] logs

        # MX_METRICS_HOST (same knob the per-rank endpoint honors): the
        # merged endpoint is the one DESIGNED to be the external scrape
        # target — a cross-host Prometheus needs 0.0.0.0 here, while the
        # per-rank scrapes stay on 127.0.0.1 via the portfiles
        host = os.environ.get("MX_METRICS_HOST", "127.0.0.1")
        self._server = ThreadingHTTPServer((host, port), Handler)
        self._server.daemon_threads = True
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="gang-metrics", daemon=True)
        self._thread.start()

    def merged_metrics(self):
        scraped = _scrape_ranks(self.tdir, self.num, "/metrics")
        per_rank = {rank: (text if status == 200 else None)
                    for rank, (status, text) in scraped.items()}
        return (200,
                "application/openmetrics-text; version=1.0.0; "
                "charset=utf-8",
                _merge_expositions(per_rank))

    def merged_healthz(self):
        ranks = {}
        all_ok = True
        for rank, (status, text) in sorted(
                _scrape_ranks(self.tdir, self.num, "/healthz").items()):
            if status is None:
                ranks[rank] = {"healthy": False,
                               "reasons": [f"endpoint unreachable: {text}"]}
                all_ok = False
                continue
            try:
                ranks[rank] = json.loads(text)
            except ValueError:
                ranks[rank] = {"healthy": False,
                               "reasons": ["unparseable /healthz body"]}
            if not ranks[rank].get("healthy"):
                all_ok = False
        body = json.dumps({"healthy": all_ok,
                           "ranks": {str(r): v for r, v in ranks.items()}})
        return (200 if all_ok else 503, "application/json", body + "\n")

    def close(self):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)


class _HeartbeatMonitor:
    """Poll per-rank heartbeat files so a hung/slow rank is diagnosed
    ("rank 2 last heartbeat 45s ago at step 130") BEFORE the gang is torn
    down, and echo each rank's flight-recorder tail after a failure.
    Inert when MX_TELEMETRY_DIR is unset."""

    def __init__(self, num_workers: int, env_extra=None):
        # workers see env_extra OVERLAID on our environ (_spawn_gang), so
        # the monitor must resolve the telemetry config the same way — a
        # programmatic launch_local(env_extra={"MX_TELEMETRY_DIR": ...})
        # must not leave the supervisor blind
        env = dict(os.environ)
        env.update(env_extra or {})
        self.dir = env.get("MX_TELEMETRY_DIR") or None
        try:
            hb = float(env.get("MX_HEARTBEAT_SEC", "5") or 5.0)
        except ValueError:
            hb = 5.0
        # several missed beats = stale; floor keeps sub-second test
        # configs from flagging healthy ranks on a loaded host
        self.stale_after = max(2.0, 5.0 * hb)
        self.num = num_workers
        self._stale = set()
        self._next_poll = 0.0
        self._gang_start = 0.0
        # rank -> parsed /statusz body captured by snapshot_statusz()
        # while the rank was still alive (before any kill), and the
        # /healthz verdict string captured at the same live moment —
        # diagnose() runs after every rank is reaped, when a live probe
        # could only ever say "endpoint unreachable"
        self._statusz = {}
        self._healthz = {}

    def gang_started(self) -> None:
        """Called at each (re)spawn: heartbeats older than this incarnation
        are leftovers of the previous gang, not evidence of a hung rank."""
        self._gang_start = time.time()
        self._stale.clear()
        # pre-teardown snapshots belong to ONE incarnation: a later
        # crash must not print a previous gang's state as its own
        self._statusz.clear()
        self._healthz.clear()
        # drop the previous incarnation's metrics portfiles too: the OS
        # can hand a dead rank's ephemeral port to ANOTHER rank of the
        # new gang, and a scrape through the stale file would attribute
        # that rank's exposition to the wrong (possibly dead) rank.
        # Workers rewrite their portfile at import.  Same hygiene for
        # the on-disk statusz-<R>.json snapshots: a reader of the final
        # post-mortem must not find a previous incarnation's state.
        if self.dir is not None:
            try:
                for name in os.listdir(self.dir):
                    if (name.startswith("metrics-port-")
                            or name.startswith("serve-port-")
                            or name.startswith("statusz-")) and \
                            name.endswith(".json"):
                        try:
                            os.unlink(os.path.join(self.dir, name))
                        except OSError:
                            pass
            except OSError:
                pass

    def _read(self, rank: int):
        try:
            with open(os.path.join(self.dir,
                                   f"heartbeat-{rank}.json")) as f:
                rec = json.load(f)
        except (OSError, ValueError):
            return None
        return rec if isinstance(rec, dict) else None

    def any_started(self) -> bool:
        """Whether any rank of THIS incarnation has heartbeat yet — arms
        the elastic regrow countdown on observed worker progress rather
        than on spawn (imports + rendezvous + restore would otherwise eat
        a fixed-from-spawn deadline).  Always False without telemetry."""
        if self.dir is None:
            return False
        for rank in range(self.num):
            rec = self._read(rank)
            if rec is not None and \
                    float(rec.get("time", 0.0)) >= self._gang_start:
                return True
        return False

    def poll(self) -> None:
        """Called from the supervision loop while the gang is alive;
        reports each staleness episode once (and recovery resets it)."""
        if self.dir is None:
            return
        now = time.monotonic()
        if now < self._next_poll:
            return
        self._next_poll = now + max(1.0, self.stale_after / 4.0)
        for rank in range(self.num):
            rec = self._read(rank)
            if rec is None:
                continue  # not started yet / no telemetry in the worker
            if float(rec.get("time", 0.0)) < self._gang_start:
                continue  # previous incarnation's heartbeat
            age = time.time() - float(rec.get("time", 0.0))
            if age > self.stale_after:
                if rank not in self._stale:
                    self._stale.add(rank)
                    # the one moment the distinction is live: a hung
                    # PROCESS keeps answering /healthz (503, stale
                    # heartbeat); a dead ENDPOINT refuses the connection
                    verdict = self._healthz_verdict(rank)
                    self._healthz[rank] = verdict
                    print(f"launch.py: rank {rank} last heartbeat "
                          f"{age:.1f}s ago at step {rec.get('step')} — "
                          f"suspect hung/slow rank; /healthz: {verdict}",
                          file=sys.stderr)
            else:
                self._stale.discard(rank)

    @staticmethod
    def _render_verdict(status, text) -> str:
        """One-line /healthz verdict from a (status, body) probe result
        — 'hung process' (stale heartbeat, endpoint answering) and
        'dead endpoint' (nothing listening) are different post-mortems
        and the supervisor log must distinguish them."""
        if status is None:
            return f"endpoint unreachable ({text})"
        try:
            snap = json.loads(text)
        except ValueError:
            return f"endpoint answered {status} with unparseable body"
        verdict = "ok" if snap.get("healthy") else \
            "; ".join(snap.get("reasons") or ["unhealthy"])
        return (f"{verdict} (HTTP {status}, step {snap.get('last_step')}, "
                f"inflight {snap.get('inflight_depth')})")

    def _healthz_verdict(self, rank) -> str:
        base = _rank_endpoint(self.dir, rank)
        if base is None:
            return "no live endpoint (MX_METRICS_PORT off or no portfile)"
        return self._render_verdict(*_http_get(f"{base}/healthz",
                                               timeout=1.0))

    def snapshot_statusz(self) -> None:
        """Snapshot /statusz from every rank whose endpoint still
        answers — called BEFORE the supervisor kills anything, so the
        survivors' live state (last steps, flight tails, in-flight
        depth) is preserved exactly as it was when a peer died.  Full
        bodies land in ``statusz-<R>.json`` next to the heartbeats;
        diagnose() echoes the one-line digest.  Both routes scrape all
        ranks CONCURRENTLY (_scrape_ranks): this runs on the teardown
        path, where several wedged ranks probed serially would delay
        SIGTERM by num_ranks x timeout right in the middle of the
        incident."""
        if self.dir is None:
            return
        healthz = _scrape_ranks(self.dir, self.num, "/healthz", timeout=1.0)
        statusz = _scrape_ranks(self.dir, self.num, "/statusz", timeout=1.0)
        for rank in range(self.num):
            status, text = healthz.get(rank, (None, "?"))
            if (status, text) != (None, "no metrics portfile"):
                # captured NOW, while an answer still means something —
                # by diagnose() time every rank is reaped and a live
                # probe can only say "endpoint unreachable"
                self._healthz.setdefault(
                    rank, self._render_verdict(status, text))
            status, text = statusz.get(rank, (None, ""))
            if status != 200:
                continue
            try:
                self._statusz[rank] = json.loads(text)
            except ValueError:
                continue
            try:
                with open(os.path.join(self.dir,
                                       f"statusz-{rank}.json"), "w") as f:
                    f.write(text)
            except OSError:
                pass

    def diagnose(self) -> None:
        """After a gang death: last heartbeat per rank + the live
        /healthz verdict + flight tail + the gang-wide trace report
        (straggler flags, step breakdown)."""
        if self.dir is None:
            return
        saw_events = False
        for rank in range(self.num):
            rec = self._read(rank)
            if rec is not None:
                age = time.time() - float(rec.get("time", 0.0))
                # prefer the verdict captured while the rank was alive
                # (poll's stale callout or the pre-teardown snapshot);
                # a live probe now only distinguishes "endpoint already
                # gone" from "endpoint outlived the process"
                verdict = self._healthz.get(rank) or \
                    self._healthz_verdict(rank)
                print(f"launch.py: rank {rank} last heartbeat {age:.1f}s "
                      f"ago at step {rec.get('step')}; /healthz: "
                      f"{verdict}", file=sys.stderr)
            snap = self._statusz.get(rank)
            if snap is not None:
                health = snap.get("health") or {}
                print(f"launch.py: rank {rank} pre-teardown /statusz "
                      f"(statusz-{rank}.json): step "
                      f"{health.get('last_step')}, inflight "
                      f"{health.get('inflight_depth')}, "
                      f"{len(snap.get('flight') or [])} flight events",
                      file=sys.stderr)
            tail = _flight_tail(self.dir, rank)
            if tail:
                saw_events = True
                print(f"launch.py: flight recorder tail (rank {rank}, "
                      f"last {len(tail)} events):", file=sys.stderr)
                for line in tail:
                    print(f"  {line}", file=sys.stderr)
                if any('"checkpoint_fallback"' in line for line in tail):
                    # a restore skipped a torn/corrupt step — point at
                    # the offline shard/digest audit for the WHY
                    print("launch.py: checkpoint fallback detected — "
                          "run tools/ckpt_report.py <ckpt-dir> to audit "
                          "shard files and digests", file=sys.stderr)
            # a rank that died on RESOURCE_EXHAUSTED left a memory
            # post-mortem — echo WHY next to the flight tail's WHERE
            oom = _oom_report(self.dir, rank)
            if oom is not None:
                _print_oom_report(oom, rank)
        if saw_events:
            _print_trace_report(self.dir)
            if _serving_streams_present(self.dir):
                # serving fleet post-mortem: the per-request view —
                # which requests never finished and inside which span
                # they died — is the serving analogue of the flight tail
                _print_serve_report(self.dir)


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn_gang(num_workers: int, command, env_extra, force_cpu: bool,
                port: int, restart_count: int):
    """Spawn the gang with piped stdout/stderr, teeing every line to our
    own streams under a `[rank N]` prefix.  Returns (procs, tee_threads).

    PYTHONUNBUFFERED keeps worker output line-granular through the pipe —
    a SIGKILLed rank must not take its last (block-buffered) lines of
    diagnosis down with it."""
    procs = []
    tees = []
    for rank in range(num_workers):
        env = dict(os.environ)
        env.update(env_extra or {})
        env["PYTHONUNBUFFERED"] = "1"
        env.update({
            "MX_COORDINATOR": f"127.0.0.1:{port}",
            "MX_NUM_PROCS": str(num_workers),
            "MX_PROC_ID": str(rank),
            "MX_LOCAL_RANK": str(rank),
            # which gang incarnation this is (0 = first attempt) — read by
            # fault.py's if-restart= qualifier and by worker logic
            # that must behave differently after a supervised restart
            "MX_RESTART_COUNT": str(restart_count),
            # reference spellings (kvstore rank/num_workers, user scripts)
            "DMLC_ROLE": "worker",
            "DMLC_PS_ROOT_URI": "127.0.0.1",
            "DMLC_PS_ROOT_PORT": str(port),
            "DMLC_NUM_WORKER": str(num_workers),
            "DMLC_NUM_SERVER": "0",
            "DMLC_WORKER_ID": str(rank),
        })
        if force_cpu:
            env["MX_FORCE_CPU"] = "1"
        p = subprocess.Popen(command, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True,
                             errors="replace", bufsize=1)
        procs.append(p)
        for stream, sink in ((p.stdout, sys.stdout), (p.stderr, sys.stderr)):
            t = threading.Thread(target=_tee,
                                 args=(stream, sink, f"[rank {rank}] "),
                                 daemon=True)
            t.start()
            tees.append(t)
    return procs, tees


def _terminate_gang(procs, term_timeout: float = 10.0) -> None:
    """SIGTERM every live worker, wait up to term_timeout for the gang to
    exit (workers may be writing a final preemption checkpoint), then
    SIGKILL stragglers.  ALWAYS reaps — no zombies, whether we get here
    from a worker crash, restart teardown, or KeyboardInterrupt."""
    for p in procs:
        if p.poll() is None:
            try:
                p.send_signal(signal.SIGTERM)
            except OSError:
                pass
    deadline = time.monotonic() + term_timeout
    for p in procs:
        if p.poll() is not None:
            continue
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            # a rank blocked in a native collective never sees SIGTERM's
            # python-level handler; escalate
            try:
                p.kill()
            except OSError:
                pass
    for p in procs:
        try:
            p.wait(timeout=10.0)
        except subprocess.TimeoutExpired:  # pragma: no cover — kill() sent
            pass


def _wait_gang(procs, term_timeout: float, monitor=None, regrow_after=None):
    """Poll ALL workers: a crash in any rank (not just the first) must fan
    out SIGTERM immediately, or the peers block forever in collectives
    waiting for the dead rank.  Returns ``(rc, planned)``: rc is the
    first non-zero exit code (the *cause*, not the exit of SIGTERMed
    peers), else 0; all procs reaped.  `monitor` (a _HeartbeatMonitor)
    is polled so a stale rank is called out while the gang still looks
    alive.

    ``regrow_after`` (seconds) is the elastic supervisor's planned-resize
    trigger: after that long of healthy running the gang is SIGTERMed
    (workers take their preemption checkpoints) and ``planned=True`` is
    returned — a regrow, not a failure.  With telemetry heartbeats
    available the countdown arms at the first beat of THIS incarnation
    (imports/rendezvous/restore must not eat the budget); without, it
    counts from spawn."""
    rc = 0
    deadline = None
    if regrow_after is not None and (monitor is None or monitor.dir is None):
        deadline = time.monotonic() + regrow_after
    alive = list(procs)
    while alive:
        if regrow_after is not None and deadline is None \
                and monitor.any_started():
            deadline = time.monotonic() + regrow_after
        if (deadline is not None and regrow_after is not None and rc == 0
                and len(alive) == len(procs)
                and time.monotonic() >= deadline):
            if monitor is not None:
                monitor.snapshot_statusz()
            _terminate_gang(alive, term_timeout)
            return 0, True
        for p in list(alive):
            r = p.poll()
            if r is None:
                continue
            alive.remove(p)
            if r != 0 and rc == 0:
                rc = r
                # survivors' live state BEFORE any kill: the statusz
                # snapshot is the only record of what the still-running
                # ranks were doing when the culprit died
                if monitor is not None:
                    monitor.snapshot_statusz()
                _terminate_gang(alive, term_timeout)
        if alive:
            if monitor is not None:
                monitor.poll()
            time.sleep(0.05)
    return rc, False


def _culprit_count(codes) -> int:
    """How many ranks of a dead gang look like the CAUSE rather than the
    teardown consequence: a SIGTERMed peer exits EXIT_PREEMPTED (handled
    preemption) or -SIGTERM/-SIGKILL (escalation), everything else —
    injected crashes (57), tracebacks (1), sys.exit(n) — is a culprit.
    At least 1: something killed the gang even if every exit looks like
    a consequence (e.g. a whole-gang preemption storm)."""
    culprits = sum(
        1 for c in codes
        if c not in (0, EXIT_PREEMPTED, -signal.SIGTERM, -signal.SIGKILL))
    return max(1, culprits)


def launch_local(num_workers: int, command, env_extra=None,
                 force_cpu: bool = False, max_restarts: int = 0,
                 term_timeout: float = 10.0, backoff: float = 1.0,
                 elastic: bool = False, min_workers: int = 1,
                 initial_workers=None, regrow_after: float = 0.0,
                 metrics_port=None) -> int:
    """Spawn num_workers processes of `command` on this host and supervise
    the gang: on any worker death the remaining ranks are torn down
    (SIGTERM, bounded wait, SIGKILL) and — up to max_restarts times — the
    whole gang is re-spawned on a FRESH coordinator port with exponential
    backoff, workers resuming from their latest valid checkpoint
    (``checkpoint.py``).  Returns 0, or the last failure's exit code
    after printing the per-rank exit history.

    Elastic mode (``elastic=True``): ``num_workers`` becomes the TARGET
    world size and exhausting the restart budget no longer fails the job —
    the supervisor **shrinks**
    instead, re-rendezvousing the surviving ranks on a fresh port with a
    reduced ``MX_NUM_PROCS`` (one rank dropped per culprit of the last
    attempt, floor ``min_workers``) and a fresh restart budget.  The old
    world size is exported as ``MX_PREV_NUM_PROCS`` so workers know to
    rebuild their mesh/kvstore/step and reshard their checkpoint on
    restore.  ``initial_workers`` starts the gang below target (a fleet
    that came up degraded), and ``regrow_after > 0`` re-admits rank slots
    ONE at a time: after that many seconds of HEALTHY running below target
    the gang is deliberately preempted (SIGTERM → final checkpoints) and
    re-spawned one rank larger — a returned host joining back on
    probation.  The countdown re-arms at every world size below target,
    so growth steps +1 until the target is reached, and re-arms again
    whenever a LATER culprit shrinks the gang below target a second time
    (grow → shrink → grow cycles converge instead of sticking at the
    shrunken size).  A re-admitted rank that keeps dying simply shrinks
    the gang again (probation loop).  Only when the budget is exhausted
    AT ``min_workers`` does the job fail.

    ``metrics_port`` (``--metrics-port``) serves a merged gang
    ``/metrics`` on that port (0 = ephemeral, logged): the supervisor
    discovers each rank's live endpoint via its ``metrics-port-<R>.json`` portfile under
    ``MX_TELEMETRY_DIR``, scrapes them on demand, and re-serves one
    exposition with per-rank ``up``/``mx_scrape_staleness_seconds``
    gauges; workers get ``MX_METRICS_PORT=0`` exported (ephemeral,
    unless the caller already pinned one)."""
    monitor = _HeartbeatMonitor(num_workers, env_extra)
    gang_metrics = None
    if metrics_port is not None:
        if monitor.dir is None:
            print("launch.py: --metrics-port needs MX_TELEMETRY_DIR (the "
                  "portfile home) — gang /metrics disabled", file=sys.stderr)
        else:
            try:
                gang_metrics = _GangMetricsServer(monitor.dir, num_workers,
                                                  metrics_port)
            except OSError as e:
                # observability must not take the launch down: same
                # policy as the per-rank endpoint's failed-bind warning
                print(f"launch.py: gang /metrics failed to bind port "
                      f"{metrics_port}: {e} — gang metrics disabled",
                      file=sys.stderr)
            else:
                print(f"launch.py: gang /metrics on "
                      f"http://127.0.0.1:{gang_metrics.port}/metrics "
                      "(merged per-rank scrape + up/staleness gauges)",
                      file=sys.stderr)
    try:
        return _supervise(num_workers, command, env_extra, force_cpu,
                          max_restarts, term_timeout, backoff, elastic,
                          min_workers, initial_workers, regrow_after,
                          monitor, gang_metrics)
    finally:
        if gang_metrics is not None:
            gang_metrics.close()


def _supervise(num_workers, command, env_extra, force_cpu, max_restarts,
               term_timeout, backoff, elastic, min_workers, initial_workers,
               regrow_after, monitor, gang_metrics):
    incarnation = 0      # cumulative MX_RESTART_COUNT across resizes
    attempt = 0          # restart budget used at the CURRENT world size
    target = num_workers
    world = min(target, max(1, int(initial_workers or target)))
    prev_world = None
    history = []  # (incarnation, world, [per-rank exit codes])
    while True:
        port = _free_port()
        monitor.num = world
        monitor.gang_started()
        if gang_metrics is not None:
            gang_metrics.num = world
        spawn_env = dict(env_extra or {})
        if gang_metrics is not None and "MX_METRICS_PORT" not in spawn_env \
                and not os.environ.get("MX_METRICS_PORT"):
            # workers bind ephemeral ports and advertise them via
            # portfiles; the supervisor's merged endpoint is the one
            # stable scrape target
            spawn_env["MX_METRICS_PORT"] = "0"
        if elastic:
            spawn_env["MX_ELASTIC"] = "1"
            if prev_world is not None and prev_world != world:
                # workers record the telemetry `resize` event and reshard
                # their restored checkpoints off this export
                spawn_env["MX_PREV_NUM_PROCS"] = str(prev_world)
        procs, tees = _spawn_gang(world, command, spawn_env, force_cpu,
                                  port, incarnation)
        # the resize export marks the FIRST incarnation after a resize
        # only — a later same-size restart is not a resize
        prev_world = None
        regrow = (regrow_after if (elastic and regrow_after > 0
                                   and world < target) else None)
        try:
            rc, planned = _wait_gang(procs, term_timeout, monitor,
                                     regrow_after=regrow)
        except KeyboardInterrupt:
            _terminate_gang(procs, term_timeout)
            return 130
        # drain the tee threads so every worker line lands BEFORE the
        # supervisor's own diagnosis/history output
        for t in tees:
            t.join(timeout=5.0)
        history.append((incarnation, world, [p.returncode for p in procs]))
        if planned:
            # regrow: the gang was healthy below target long enough —
            # preemption checkpoints are on disk, re-admit ONE rank slot
            # (not the full target in one jump: a partially-recovered
            # fleet re-checks stability at each size, and a re-admitted
            # host that is still bad costs one probation step, not a
            # full-gang thrash).  The countdown re-arms at the top of
            # the loop while world < target, so growth continues +1 at
            # a time — and re-starts from scratch whenever a later
            # culprit shrinks the gang below target again.
            prev_world, world = world, min(target, world + 1)
            incarnation += 1
            attempt = 0
            print(f"launch.py: growing gang {prev_world} -> {world} ranks "
                  f"(stable for {regrow_after:.1f}s below target "
                  f"{target}); re-rendezvous on a fresh port",
                  file=sys.stderr)
            continue
        if rc == 0:
            # every rank is reaped: the trace files are complete, so the
            # authoritative gang-wide merge happens HERE (rank 0's atexit
            # merge may have raced still-running peers)
            _reexport_trace(monitor.dir)
            return 0
        monitor.diagnose()
        if attempt >= max_restarts:
            if elastic and world > min_workers:
                codes = [p.returncode for p in procs]
                new_world = max(min_workers, world - _culprit_count(codes))
                prev_world, world = world, new_world
                incarnation += 1
                attempt = 0
                print(f"launch.py: restart budget exhausted at world size "
                      f"{prev_world}; shrinking gang {prev_world} -> "
                      f"{world} ranks (elastic resize), fresh restart "
                      f"budget, re-rendezvous in {backoff:.1f}s",
                      file=sys.stderr)
                time.sleep(backoff)
                continue
            _reexport_trace(monitor.dir)
            if max_restarts > 0 or elastic:
                print(f"launch.py: giving up after {len(history)} attempts; "
                      "per-rank exit history:", file=sys.stderr)
                for inc, w, codes in history:
                    print("  attempt %d (world %d): %s" % (inc, w, " ".join(
                        f"rank{i}={c}" + (
                            "(preempted)" if c == EXIT_PREEMPTED else "")
                        for i, c in enumerate(codes))), file=sys.stderr)
            return rc
        attempt += 1
        incarnation += 1
        delay = backoff * (2 ** (attempt - 1))
        cause = ("worker preempted" if rc == EXIT_PREEMPTED
                 else "worker died")
        print(f"launch.py: {cause} (exit {rc}); restarting gang "
              f"({attempt}/{max_restarts}) on a fresh port in {delay:.1f}s",
              file=sys.stderr)
        time.sleep(delay)


def launch(command, n: int, force_cpu: bool = False,
           term_timeout: float = 10.0, **kwargs) -> int:
    """Run ``command`` as ``n`` workers under the supervisor (``kwargs``
    are :func:`launch_local`'s); returns the gang's exit code."""
    return launch_local(n, list(command), force_cpu=force_cpu,
                        term_timeout=term_timeout, **kwargs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Launch and supervise a gang of mxnet_tpu_torch "
                    "workers, one per card of this host.")
    ap.add_argument("-n", "--num-workers", type=int, required=True,
                    help="number of worker processes")
    ap.add_argument("-s", "--num-servers", type=int, default=0,
                    help="accepted for reference CLI compat; ignored "
                         "(no parameter-server role in the SPMD design)")
    ap.add_argument("--launcher", default="local",
                    choices=["local", "ssh", "mpi", "sge", "yarn"])
    ap.add_argument("--force-cpu", action="store_true",
                    help="pin workers to the CPU backend (testing)")
    ap.add_argument("--max-restarts", type=int, default=0, metavar="N",
                    help="on any worker death, tear the gang down and "
                         "re-spawn it (fresh coordinator port, exponential "
                         "backoff) up to N times; workers resume from "
                         "their latest valid checkpoint")
    ap.add_argument("--term-timeout", type=float, default=10.0, metavar="S",
                    help="seconds to wait after SIGTERM before SIGKILL "
                         "when tearing down a gang (covers the final "
                         "preemption checkpoint)")
    ap.add_argument("--restart-backoff", type=float, default=1.0,
                    metavar="S", help="base of the exponential restart "
                                      "backoff (S, 2S, 4S, ...)")
    ap.add_argument("--elastic", action="store_true",
                    help="elastic gang resize: when the restart budget is "
                         "exhausted, SHRINK the gang to the surviving "
                         "ranks (reduced MX_NUM_PROCS, MX_PREV_NUM_PROCS "
                         "exported, fresh budget) instead of failing; "
                         "workers reshard their checkpoints on restore")
    ap.add_argument("--min-workers", type=int, default=1, metavar="M",
                    help="elastic shrink floor: the job only fails once "
                         "the budget is exhausted at M ranks (default 1)")
    ap.add_argument("--initial-workers", type=int, default=None,
                    metavar="M", help="elastic: start the gang at M < N "
                                      "ranks (a fleet that came up "
                                      "degraded); pairs with "
                                      "--regrow-after to grow toward -n")
    ap.add_argument("--metrics-port", type=int, default=None, metavar="P",
                    help="serve a merged gang /metrics (+ /healthz) on "
                         "port P (0 = ephemeral, logged at startup): "
                         "per-rank live endpoints are discovered via "
                         "metrics-port-<R>.json portfiles under "
                         "MX_TELEMETRY_DIR and re-served as one "
                         "exposition with per-rank up/staleness gauges")
    ap.add_argument("--serve-port", type=int, default=None, metavar="P",
                    help="export MX_SERVE_PORT=P to workers (0 = "
                         "ephemeral): serving replicas bind P+rank and "
                         "advertise serve-port-<R>.json portfiles under "
                         "MX_TELEMETRY_DIR for router discovery")
    ap.add_argument("--regrow-after", type=float, default=0.0, metavar="S",
                    help="elastic: after S seconds of healthy running "
                         "below the -n target, preempt the gang (final "
                         "checkpoints) and re-spawn ONE rank larger, "
                         "repeating (with a fresh countdown at each "
                         "size) until the target is reached; re-arms "
                         "after any later shrink — the grow half of the "
                         "resize (default 0 = never)")
    ap.add_argument("command", nargs=argparse.REMAINDER,
                    help="command to run on every worker")
    args = ap.parse_args(argv)
    command = list(args.command)
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        ap.error("no worker command given")
    if args.launcher != "local":
        ap.error(f"launcher {args.launcher!r} is cluster bring-up; supply "
                 "MX_COORDINATOR/MX_NUM_PROCS/MX_PROC_ID via your scheduler "
                 "(pod spec) instead — see module docstring")
    if args.num_servers:
        print("launch.py: -s/--num-servers ignored (no parameter-server "
              "role)",
              file=sys.stderr)
    if args.max_restarts < 0:
        ap.error("--max-restarts must be >= 0")
    if args.metrics_port is not None and args.metrics_port < 0:
        ap.error("--metrics-port must be >= 0 (0 = ephemeral)")
    if args.serve_port is not None and args.serve_port < 0:
        ap.error("--serve-port must be >= 0 (0 = ephemeral)")
    if args.min_workers < 1 or args.min_workers > args.num_workers:
        ap.error("--min-workers must be in [1, num-workers]")
    if args.initial_workers is not None and not (
            args.min_workers <= args.initial_workers <= args.num_workers):
        ap.error("--initial-workers must be in [min-workers, num-workers]")
    if (args.initial_workers is not None or args.regrow_after > 0) \
            and not args.elastic:
        ap.error("--initial-workers/--regrow-after require --elastic")
    env_extra = None
    if args.serve_port is not None:
        # workers read MX_SERVE_PORT at ReplicaServer construction;
        # N binds N+rank, 0 = ephemeral + portfile advertisement
        env_extra = {"MX_SERVE_PORT": str(args.serve_port)}
    return launch_local(args.num_workers, command, env_extra=env_extra,
                        force_cpu=args.force_cpu,
                        max_restarts=args.max_restarts,
                        term_timeout=args.term_timeout,
                        backoff=args.restart_backoff,
                        elastic=args.elastic,
                        min_workers=args.min_workers,
                        initial_workers=args.initial_workers,
                        regrow_after=args.regrow_after,
                        metrics_port=args.metrics_port)


if __name__ == "__main__":
    sys.exit(main())
