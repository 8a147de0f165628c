"""Live per-rank metrics endpoint.

The counterpart of ``mxnet_tpu/metrics_server.py``: one stdlib-only
(``http.server`` + daemon thread) HTTP endpoint per rank over the port's
telemetry recorder, enabled via ``MX_METRICS_PORT``:

  unset / empty / ``off``   endpoint disabled (the default — nothing
                            binds, nothing to pay);
  ``0`` / ``auto``          bind an EPHEMERAL port and write it to a
                            portfile next to the heartbeat
                            (``metrics-port-<rank>.json`` under
                            ``MX_TELEMETRY_DIR``) so the tools/launch.py
                            supervisor discovers it for the gang merge;
  ``N`` (> 0)               bind ``N + rank`` — the rank offset keeps a
                            single-host gang from colliding on one port
                            (rank 0 gets exactly N).  The portfile is
                            still written when a telemetry dir exists.

Routes (all served from the telemetry recorder's LOCKED ROLLUPS only —
the handler never touches a torch tensor and never synchronises the
card; tests/test_torch_router.py checks the handler's source for it):

  ``/metrics``   the current ``telemetry.summary()`` + ``memwatch``
                 rollups through the SAME OpenMetrics formatter the
                 atexit file export uses (``telemetry.render_prometheus``
                 — one formatter, two sinks), stamped
                 ``mx_export_mode{mode="live"}``;
  ``/healthz``   200/503 JSON verdict from heartbeat age (the
                 supervisor's staleness rule), last step, restart count
                 and in-flight depth (``telemetry.health_snapshot``);
  ``/statusz``   the summary JSON + memwatch summary + the
                 flight-recorder tail — the "what was this rank doing"
                 one-shot for humans and for the supervisor's
                 pre-teardown snapshot.  The serving block includes the
                 weight hot-swap generation/counters
                 (``summary()['serving']['weight_generation']``);
  ``/tracez``    the last K completed serving requests (trace id,
                 attributed cause, latency, SLO verdicts) from the
                 recorder's bounded ring — the per-rank half of the
                 router's fleet-level ``/tracez``.

The server binds ``MX_METRICS_HOST`` (default ``127.0.0.1``; set
``0.0.0.0`` to expose it to a cross-host scraper) and runs on daemon
threads: it can never hold the process open, and a request can never
block the training/serving loop (shared state is only ever read under
the recorder's locks).
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from . import telemetry

__all__ = ["enabled", "port", "start", "stop", "maybe_start",
           "portfile_path"]

_LOG = logging.getLogger("mxnet_tpu_torch.metrics_server")

OPENMETRICS_CONTENT_TYPE = \
    "application/openmetrics-text; version=1.0.0; charset=utf-8"


def portfile_path(directory: str, rank_id: int) -> str:
    """Per-rank portfile path (mirrored in tools/launch.py)."""
    return os.path.join(directory, f"metrics-port-{rank_id}.json")


def _config_port() -> Optional[int]:
    """MX_METRICS_PORT -> base port (0 = ephemeral) or None (disabled)."""
    raw = os.environ.get("MX_METRICS_PORT", "").strip().lower()
    if not raw or raw in ("off", "false", "none"):
        return None
    if raw in ("0", "auto", "ephemeral"):
        return 0
    try:
        p = int(raw)
    except ValueError:
        p = -1  # non-integer garbage: same disabled-with-warning path
    if p <= 0:  # "0"/"auto" already matched above; negatives are invalid
        _LOG.warning("MX_METRICS_PORT=%r is not a port; metrics endpoint "
                     "disabled", raw)
        return None
    return p


class _Handler(BaseHTTPRequestHandler):
    """Route handler: everything reachable from here is rollup-only — no
    torch tensor, no host readback of device values."""

    server_version = "mxnet-tpu-torch-metrics/1"

    def do_GET(self):  # noqa: N802 (http.server contract)
        route = self.path.split("?", 1)[0].rstrip("/") or "/"
        if route in ("/", "/metrics"):
            self._metrics()
        elif route == "/healthz":
            self._healthz()
        elif route == "/statusz":
            self._statusz()
        elif route == "/tracez":
            self._tracez()
        else:
            self._send(404, "text/plain; charset=utf-8",
                       f"no such route {route!r}; try /metrics /healthz "
                       "/statusz /tracez\n")

    def _metrics(self):
        self._send(200, OPENMETRICS_CONTENT_TYPE,
                   telemetry.render_prometheus(mode="live"))

    def _healthz(self):
        snap = telemetry.health_snapshot()
        self._send(200 if snap["healthy"] else 503,
                   "application/json", json.dumps(snap) + "\n")

    def _statusz(self):
        body = {
            "summary": telemetry.summary(),
            "flight": telemetry.flight_tail(32),
            "health": telemetry.health_snapshot(),
            "export_mode": "live",
            "time": round(time.time(), 3),
        }
        try:
            from . import memwatch as _memwatch

            body["memwatch"] = _memwatch.summary()
        except Exception:  # statusz must render even if memwatch breaks
            body["memwatch"] = None
        self._send(200, "application/json", json.dumps(body) + "\n")

    def _tracez(self):
        # the per-rank half of the router's /tracez: the recorder's
        # bounded ring of recently COMPLETED requests with their trace
        # ids and attributed causes — rollup-only, like the other routes
        body = {
            "recent": telemetry.recent_requests(),
            "time": round(time.time(), 3),
        }
        self._send(200, "application/json", json.dumps(body) + "\n")

    def _send(self, code: int, ctype: str, body: str):
        payload = body.encode("utf-8", "replace")
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def log_message(self, fmt, *args):
        # scrapes at 1 Hz must not spam the worker's stderr next to the
        # [rank N]-prefixed training logs; debug level keeps them findable
        _LOG.debug("%s %s", self.address_string(), fmt % args)


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.server: Optional[ThreadingHTTPServer] = None
        self.thread: Optional[threading.Thread] = None
        self.port: int = 0
        self.portfile: Optional[str] = None


_state = _State()


def enabled() -> bool:
    """Whether this process is currently serving /metrics."""
    return _state.server is not None


def port() -> int:
    """The bound port (0 when the endpoint is off)."""
    return _state.port


def _write_portfile(bound_port: int, host: str) -> Optional[str]:
    directory = os.environ.get("MX_TELEMETRY_DIR")
    if not directory:
        return None  # nowhere to advertise: endpoint still serves
    rank_id = telemetry.rank()
    path = portfile_path(directory, rank_id)
    # advertise a CONNECTABLE host: a wildcard bind is reachable on
    # loopback; a specific MX_METRICS_HOST (e.g. the host NIC) is not
    # necessarily on 127.0.0.1, so the supervisor must dial it as bound
    payload = {"rank": rank_id, "port": bound_port,
               "host": "127.0.0.1" if host in ("0.0.0.0", "::", "") else host,
               "pid": os.getpid(), "time": round(time.time(), 3)}
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        os.makedirs(directory, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)  # the supervisor never sees a torn portfile
    except OSError as e:
        _LOG.warning("metrics portfile write to %s failed: %s", path, e)
        return None
    return path


def start(base_port: Optional[int] = None) -> bool:
    """Start the endpoint (idempotent).  ``base_port`` overrides
    ``MX_METRICS_PORT`` (0 = ephemeral); returns True when a server is
    running after the call."""
    if base_port is None:
        base_port = _config_port()
        if base_port is None:
            return False
    host = os.environ.get("MX_METRICS_HOST", "127.0.0.1")
    bind_port = base_port + telemetry.rank() if base_port else 0
    with _state.lock:
        if _state.server is not None:
            return True
        try:
            server = ThreadingHTTPServer((host, bind_port), _Handler)
        except OSError as e:
            # a dead endpoint must not take training down with it
            _LOG.warning("metrics endpoint failed to bind %s:%d: %s",
                         host, bind_port, e)
            return False
        server.daemon_threads = True
        thread = threading.Thread(target=server.serve_forever,
                                  name="mx-metrics-server", daemon=True)
        thread.start()
        _state.server = server
        _state.thread = thread
        _state.port = server.server_address[1]
        _state.portfile = _write_portfile(_state.port, host)
    _LOG.info("metrics endpoint serving on %s:%d (/metrics /healthz "
              "/statusz)", host, _state.port)
    return True


def stop() -> None:
    """Shut the endpoint down and remove the portfile (tests; workers
    normally just exit — daemon threads die with the process and the
    supervisor treats an unreachable endpoint as down)."""
    with _state.lock:
        server, thread = _state.server, _state.thread
        portfile = _state.portfile
        _state.server = _state.thread = _state.portfile = None
        _state.port = 0
    if server is not None:
        server.shutdown()
        server.server_close()
    if thread is not None:
        thread.join(timeout=5.0)
    if portfile:
        try:
            os.unlink(portfile)
        except OSError:
            pass


def maybe_start() -> bool:
    """Start iff ``MX_METRICS_PORT`` enables it — called when
    ``mxnet_tpu_torch`` is imported (workers inherit the variable from
    tools/launch.py)."""
    if _config_port() is None:
        return False
    return start()
