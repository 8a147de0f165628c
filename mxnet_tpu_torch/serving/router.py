"""Serving front door: per-replica HTTP servers + a multi-replica
router.

The counterpart of ``mxnet_tpu/serving/router.py`` (the port's own copy;
routes, bodies, headers, portfiles and events are the JAX module's).
Two stdlib-only pieces (``http.server`` + daemon threads, the
metrics_server pattern — no framework, nothing to install):

  * :class:`ReplicaServer` fronts ONE :class:`~.engine.ServingEngine`:
    it owns a dedicated engine-driver thread (the ONLY thread that ever
    touches the card — HTTP handlers just build
    :class:`~.scheduler.Request` objects, submit, and poll the request's
    host-side ``TokenStream.finished`` flag, so a handler never reads a
    torch tensor or synchronises the card; tests/test_torch_router.py
    checks the handlers' source for it).  It advertises itself by
    writing ``serve-port-<rank>.json`` next to the metrics portfiles
    (atomic tmp+rename; tools/launch.py cleans them up the same way).

  * :class:`Router` is the client-facing load balancer: it discovers
    replicas from those portfiles, health-polls their ``/healthz``,
    dispatches each ``/generate`` to the healthy replica with the
    fewest outstanding requests, and pins ``session`` ids to a replica
    (affinity keeps a conversation's prefix-cache pages hot on one
    engine — the COW prefix cache is per-replica).  A replica that
    drops mid-request is marked dead and the request FAILS OVER to the
    next healthy replica (decoding restarts — greedy/seeded decode is
    deterministic, so the client sees identical tokens, just later).
    ``/admin/drain`` takes a replica out of rotation gracefully
    (in-flight requests finish; health polling re-adds it after
    ``/admin/undrain``) — composing with ``--elastic`` rescale and
    weight hot-swap: drain, swap/restart, undrain, no dropped requests.
    A request that reaches a replica which began draining after the
    Router picked it goes to another replica (the JAX module's Router
    passes that 503 through to the client).

Routes (replica): ``POST /generate``, ``GET /statusz``, ``GET
/healthz``, ``POST /admin/drain``, ``POST /admin/undrain``.
Routes (router): the same, plus drain/undrain take ``?rank=N``.

``/generate`` body (JSON): ``prompt`` (list of token ids, required),
``max_new_tokens``, ``bos_id``/``eos_id`` (default to the replica's
configured pair), ``temperature``/``top_k``/``top_p``/``seed``
(defaults from ``MX_SERVE_TEMPERATURE`` / ``MX_SERVE_TOP_K`` /
``MX_SERVE_TOP_P`` — applied at this HTTP layer, never inside the
engine), ``prefix`` (forced decoder prefix; prefix-cache candidate),
``session`` (router affinity key), ``timeout_s``.  Response:
``{"request_id", "tokens", "finish_reason", "replica", ...}``.

**Request tracing**: the Router
mints a trace context per /generate — ``trace_id`` (16 hex chars), the
id of its open ``serve_route`` span, and a head-sampling bit
(``MX_RQTRACE_SAMPLE``, default 1.0) — and propagates it to the replica
in the ``X-MX-Trace`` header (``<trace_id>;parent=<span>;sampled=<0|1>``).
The replica threads it into the :class:`~.scheduler.Request` so every
engine span/event carries the trace id; the router wraps the whole
dispatch residence in a paired ``serve_route`` span and each attempt in
a ``serve_dispatch`` span (a failover is ONE trace with TWO dispatch
spans).  Unsampled requests skip span emission on the hot path but the
router still measures them — on an error or TTFT SLO breach the spans
are recorded retroactively (``late_sampled``), so the tail is never
lost.  ``GET /tracez`` shows the last K completed request trees
(``MX_RQTRACE_TRACEZ_K``) and every in-flight request with its open
span.  ``MX_RQTRACE=0`` switches the whole subsystem off.
"""
from __future__ import annotations

import json
import logging
import os
import random
import threading
import time
import urllib.error
import urllib.request
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

from .. import telemetry
from ..base import MXNetError
from .scheduler import Request

__all__ = ["ReplicaServer", "Router", "serve_portfile_path",
           "discover_replicas", "TRACE_HEADER", "rqtrace_enabled",
           "mint_trace", "format_trace_header", "parse_trace_header"]

_LOG = logging.getLogger("mxnet_tpu_torch.serving.router")


def serve_portfile_path(directory: str, rank_id: int) -> str:
    """Per-replica portfile path (mirrored in tools/launch.py)."""
    return os.path.join(directory, f"serve-port-{rank_id}.json")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def discover_replicas(directory: str) -> List[dict]:
    """Parse every ``serve-port-*.json`` in ``directory`` (torn/garbage
    files are skipped — the atomic rename means they're transient)."""
    out = []
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return out
    for name in names:
        if not (name.startswith("serve-port-") and name.endswith(".json")):
            continue
        try:
            with open(os.path.join(directory, name)) as f:
                p = json.load(f)
            out.append({"rank": int(p["rank"]), "host": str(p["host"]),
                        "port": int(p["port"])})
        except (OSError, ValueError, KeyError, TypeError):
            continue
    return out


# ---------------------------------------------------------------------------
# trace context
# ---------------------------------------------------------------------------
TRACE_HEADER = "X-MX-Trace"


def rqtrace_enabled() -> bool:
    """Request tracing rides the front door by default; ``MX_RQTRACE=0``
    is the kill switch (spans, /tracez bookkeeping and header
    propagation all stop — the bench lever for the <2% overhead gate)."""
    return os.environ.get("MX_RQTRACE", "1").lower() not in (
        "0", "false", "off")


def mint_trace(sample: Optional[float] = None) -> Optional[dict]:
    """A fresh trace context ``{"trace_id", "sampled"}`` — or None with
    ``MX_RQTRACE=0``.  Head-based sampling: the bit is decided HERE,
    once, and propagated, so one request is either traced on every hop
    or on none (``MX_RQTRACE_SAMPLE``, default 1.0).  Trace ids are 16
    hex chars of ``os.urandom`` — no coordination, no clock."""
    if not rqtrace_enabled():
        return None
    rate = _env_float("MX_RQTRACE_SAMPLE", 1.0) if sample is None \
        else float(sample)
    sampled = rate >= 1.0 or (rate > 0.0 and random.random() < rate)
    return {"trace_id": os.urandom(8).hex(), "sampled": sampled}


def format_trace_header(trace_id: str, parent_span_id: int = 0,
                        sampled: bool = True) -> str:
    return f"{trace_id};parent={int(parent_span_id)};" \
           f"sampled={1 if sampled else 0}"


def parse_trace_header(value: Optional[str]) -> Optional[dict]:
    """Parse an ``X-MX-Trace`` header into ``{"trace_id", "parent",
    "sampled"}``; garbage (wrong field count, non-int parent) returns
    None — an upstream that speaks a different dialect downgrades to
    untraced, never to a 500."""
    if not value:
        return None
    parts = value.strip().split(";")
    trace_id = parts[0].strip()
    if not trace_id or len(trace_id) > 64:
        return None
    out = {"trace_id": trace_id, "parent": 0, "sampled": True}
    for part in parts[1:]:
        key, _, raw = part.strip().partition("=")
        if key == "parent":
            try:
                out["parent"] = int(raw)
            except ValueError:
                return None
        elif key == "sampled":
            out["sampled"] = raw.strip() not in ("0", "false")
    return out


def _sampling_defaults() -> dict:
    """Fleet-wide sampling defaults, applied when a /generate body omits
    the field — an explicit body value
    always wins, and ``temperature: 0`` still means greedy."""
    return {"temperature": _env_float("MX_SERVE_TEMPERATURE", 0.0),
            "top_k": _env_int("MX_SERVE_TOP_K", 0),
            "top_p": _env_float("MX_SERVE_TOP_P", 1.0)}


def _send(handler, code: int, body, ctype: str = "application/json"):
    if not isinstance(body, (str, bytes)):
        body = json.dumps(body) + "\n"
    payload = body if isinstance(body, bytes) \
        else body.encode("utf-8", "replace")
    handler.send_response(code)
    handler.send_header("Content-Type", ctype)
    handler.send_header("Content-Length", str(len(payload)))
    handler.end_headers()
    handler.wfile.write(payload)


def _read_body(handler) -> bytes:
    """Read the whole request body.  Every POST reads it before it
    answers, whatever the route: a server that closes its socket with
    unread bytes in it sends a reset, which can reach the client before
    the answer does."""
    n = int(handler.headers.get("Content-Length") or 0)
    return handler.rfile.read(n) if n else b""


def _parse_json_body(raw: bytes) -> dict:
    body = json.loads((raw or b"{}").decode("utf-8"))
    if not isinstance(body, dict):
        raise ValueError("body must be a JSON object")
    return body


class _ReplicaHandler(BaseHTTPRequestHandler):
    """One replica's route handler: handlers submit Requests and poll
    host-side stream flags — they never touch a torch tensor, never
    force a device sync (the engine-driver thread owns the card)."""

    server_version = "mxnet-tpu-torch-replica/1"

    def do_GET(self):  # noqa: N802 (http.server contract)
        rep: "ReplicaServer" = self.server.replica  # type: ignore
        route = self.path.split("?", 1)[0].rstrip("/") or "/"
        if route in ("/", "/statusz"):
            _send(self, 200, rep.statusz())
        elif route == "/healthz":
            snap = rep.healthz()
            _send(self, 200 if snap["ok"] else 503, snap)
        else:
            _send(self, 404, {"error": f"no such route {route!r}"})

    def do_POST(self):  # noqa: N802
        rep: "ReplicaServer" = self.server.replica  # type: ignore
        route = self.path.split("?", 1)[0].rstrip("/")
        raw = _read_body(self)
        if route == "/generate":
            self._generate(rep, raw)
        elif route == "/admin/drain":
            rep.drain()
            _send(self, 200, {"draining": True, "rank": rep.rank})
        elif route == "/admin/undrain":
            rep.undrain()
            _send(self, 200, {"draining": False, "rank": rep.rank})
        else:
            _send(self, 404, {"error": f"no such route {route!r}"})

    def _generate(self, rep: "ReplicaServer", raw: bytes):
        if rep.draining:
            _send(self, 503, {"error": "replica draining",
                              "rank": rep.rank})
            return
        try:
            body = _parse_json_body(raw)
        except (ValueError, UnicodeDecodeError) as e:
            _send(self, 400, {"error": f"bad JSON body: {e}"})
            return
        trace = parse_trace_header(self.headers.get(TRACE_HEADER))
        try:
            result = rep.generate(body, trace=trace)
        except MXNetError as e:
            # backpressure (queue full) and validation errors are the
            # client's 4xx/503, never a replica crash
            code = 503 if "queue full" in str(e) else 400
            _send(self, code, {"error": str(e), "rank": rep.rank})
            return
        except TimeoutError as e:
            _send(self, 504, {"error": str(e), "rank": rep.rank})
            return
        _send(self, 200, result)

    def log_message(self, fmt, *args):
        _LOG.debug("%s %s", self.address_string(), fmt % args)


class ReplicaServer:
    """HTTP front for one ServingEngine (one replica of the fleet).

    The engine runs on a private driver thread; handler threads only
    submit/poll.  ``bos_id``/``eos_id`` are the defaults a /generate
    body may override per request."""

    def __init__(self, engine, bos_id: int, eos_id: int,
                 port: Optional[int] = None, host: Optional[str] = None,
                 rank: Optional[int] = None,
                 directory: Optional[str] = None):
        self.engine = engine
        self.bos_id = int(bos_id)
        self.eos_id = int(eos_id)
        self.rank = telemetry.rank() if rank is None else int(rank)
        self._host = host if host is not None \
            else os.environ.get("MX_SERVE_HOST", "127.0.0.1")
        if port is None:
            base = _env_int("MX_SERVE_PORT", 0)
            port = base + self.rank if base > 0 else 0
        self._bind_port = int(port)
        self._dir = directory if directory is not None \
            else os.environ.get("MX_TELEMETRY_DIR")
        self._server: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._drive_thread: Optional[threading.Thread] = None
        self._portfile: Optional[str] = None
        self._wake = threading.Condition()
        self._stop = False
        self.draining = False
        self._outstanding = 0
        self._error: Optional[str] = None
        self.port = 0

    # ---- lifecycle ---------------------------------------------------
    def start(self) -> "ReplicaServer":
        server = ThreadingHTTPServer((self._host, self._bind_port),
                                     _ReplicaHandler)
        server.daemon_threads = True
        server.replica = self  # type: ignore[attr-defined]
        self._server = server
        self.port = server.server_address[1]
        self._http_thread = threading.Thread(
            target=server.serve_forever, daemon=True,
            name=f"mx-serve-http-{self.rank}")
        self._http_thread.start()
        self._drive_thread = threading.Thread(
            target=self._drive, daemon=True,
            name=f"mx-serve-engine-{self.rank}")
        self._drive_thread.start()
        self._portfile = self._write_portfile()
        _LOG.info("replica %d serving on %s:%d", self.rank, self._host,
                  self.port)
        return self

    def stop(self) -> None:
        with self._wake:
            self._stop = True
            self._wake.notify_all()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._drive_thread is not None:
            self._drive_thread.join(timeout=10.0)
        if self._portfile:
            try:
                os.unlink(self._portfile)
            except OSError:
                pass
            self._portfile = None

    def _write_portfile(self) -> Optional[str]:
        if not self._dir:
            return None
        path = serve_portfile_path(self._dir, self.rank)
        host = self._host
        payload = {"rank": self.rank, "port": self.port,
                   "host": "127.0.0.1" if host in ("0.0.0.0", "::", "")
                   else host,
                   "pid": os.getpid(), "time": round(time.time(), 3)}
        tmp = f"{path}.tmp-{os.getpid()}"
        try:
            os.makedirs(self._dir, exist_ok=True)
            with open(tmp, "w") as f:
                json.dump(payload, f)
            os.replace(tmp, path)  # the router never sees a torn file
        except OSError as e:
            _LOG.warning("serve portfile write to %s failed: %s", path, e)
            return None
        return path

    # ---- engine driver (the only thread that touches the card) -------
    def _drive(self) -> None:
        while True:
            with self._wake:
                while not self._stop and not self.engine._sched.depth:
                    self._wake.wait(timeout=0.5)
                if self._stop:
                    return
            try:
                self.engine.run()
            except Exception as e:  # noqa: BLE001 — surface via /healthz
                self._error = f"{type(e).__name__}: {e}"
                _LOG.exception("replica %d engine loop died", self.rank)
                return

    # ---- handler-side operations (host-only) -------------------------
    def generate(self, body: dict, trace: Optional[dict] = None) -> dict:
        """Build + submit one Request and poll it to completion.

        ``trace`` is the parsed ``X-MX-Trace`` context the Router
        propagated; a direct client (no header) gets a replica-minted
        one so single-replica deployments still trace.  Sampled requests
        run inside a paired ``serve_handle`` span (the replica-side root
        of the request tree — its open begin is the "died inside X"
        clue); unsampled ones are measured anyway and the span recorded
        retroactively on an error or TTFT SLO breach."""
        defaults = _sampling_defaults()
        prompt = body.get("prompt")
        if not isinstance(prompt, list) or not prompt:
            raise MXNetError("/generate body needs a non-empty 'prompt' "
                             "list of token ids")
        if trace is None:
            trace = mint_trace()
        tid = trace["trace_id"] if trace else None
        sampled = bool(trace.get("sampled", True)) if trace else True
        upstream = int(trace.get("parent", 0)) if trace else 0
        req = Request(
            prompt,
            max_new_tokens=int(body.get("max_new_tokens", 16)),
            bos_id=int(body.get("bos_id", self.bos_id)),
            eos_id=int(body.get("eos_id", self.eos_id)),
            request_id=body.get("request_id"),
            temperature=float(body.get("temperature",
                                       defaults["temperature"])),
            top_k=int(body.get("top_k", defaults["top_k"])),
            top_p=float(body.get("top_p", defaults["top_p"])),
            seed=body.get("seed"),
            prefix=body.get("prefix"),
            session=body.get("session"),
            trace_id=tid, parent_span_id=upstream, sampled=sampled)
        timeout_s = float(body.get("timeout_s", 120.0))
        if tid and sampled and telemetry.spans_enabled():
            with telemetry.span("serve_handle", paired=True,
                                trace_id=tid, request_id=req.id,
                                replica=self.rank,
                                upstream_span=upstream):
                self._serve_wait(req, timeout_s)
        else:
            t0 = time.perf_counter()
            try:
                self._serve_wait(req, timeout_s)
            except BaseException as e:
                if tid:  # always-sample the tail: errors keep their span
                    telemetry.record_span(
                        "serve_handle", t0, time.perf_counter(),
                        trace_id=tid, request_id=req.id,
                        replica=self.rank, late_sampled=True,
                        error=type(e).__name__)
                raise
            slo = _env_float("MX_SERVE_SLO_TTFT_MS", 0.0)
            if tid and slo > 0 and req.ttft_ms > slo:
                telemetry.record_span(
                    "serve_handle", t0, time.perf_counter(),
                    trace_id=tid, request_id=req.id, replica=self.rank,
                    late_sampled=True, slo_stage="ttft")
        out = {"request_id": req.id,
               "tokens": [int(t) for t in req.stream],
               "finish_reason": req.stream.finish_reason,
               "replica": self.rank,
               "generation": self.engine.weight_generation,
               "session": req.session,
               "ttft_ms": round(req.ttft_ms, 3),
               "queue_wait_ms": round(req.queue_wait_ms, 3)}
        if tid:
            out["trace_id"] = tid
            out["sampled"] = sampled
        return out

    def _serve_wait(self, req: Request, timeout_s: float) -> None:
        with self._wake:  # handler threads count concurrently
            self._outstanding += 1
        try:
            self.engine.submit(req)
            with self._wake:
                self._wake.notify_all()
            deadline = time.monotonic() + timeout_s
            while not req.stream.finished:
                if self._error:
                    raise MXNetError(
                        f"replica engine died: {self._error}")
                if time.monotonic() >= deadline:
                    raise TimeoutError(
                        f"request {req.id} not finished after "
                        f"{timeout_s:.0f}s")
                time.sleep(0.002)
        finally:
            with self._wake:
                self._outstanding -= 1

    def drain(self) -> None:
        self.draining = True
        telemetry.record("serve_drain", executor="ReplicaServer",
                         rank=self.rank)

    def undrain(self) -> None:
        self.draining = False
        telemetry.record("serve_undrain", executor="ReplicaServer",
                         rank=self.rank)

    def healthz(self) -> dict:
        return {"ok": self._error is None and not self.draining,
                "draining": self.draining, "error": self._error,
                "rank": self.rank, "outstanding": self._outstanding}

    def statusz(self) -> dict:
        return {"rank": self.rank, "draining": self.draining,
                "outstanding": self._outstanding, "error": self._error,
                "engine": self.engine.statusz_snapshot(),
                "time": round(time.time(), 3)}


class _RouterHandler(BaseHTTPRequestHandler):
    """Router routes — host-only by construction (pure HTTP relay +
    host-side bookkeeping)."""

    server_version = "mxnet-tpu-torch-router/1"

    def do_GET(self):  # noqa: N802
        router: "Router" = self.server.router  # type: ignore
        route = self.path.split("?", 1)[0].rstrip("/") or "/"
        if route in ("/", "/statusz"):
            _send(self, 200, router.statusz())
        elif route == "/healthz":
            snap = router.healthz()
            _send(self, 200 if snap["ok"] else 503, snap)
        elif route == "/tracez":
            _send(self, 200, router.tracez())
        else:
            _send(self, 404, {"error": f"no such route {route!r}"})

    def do_POST(self):  # noqa: N802
        router: "Router" = self.server.router  # type: ignore
        route, _, query = self.path.partition("?")
        route = route.rstrip("/")
        raw = _read_body(self)
        if route == "/generate":
            try:
                body = _parse_json_body(raw)
            except (ValueError, UnicodeDecodeError) as e:
                _send(self, 400, {"error": f"bad JSON body: {e}"})
                return
            code, payload = router.dispatch(body)
            _send(self, code, payload)
        elif route in ("/admin/drain", "/admin/undrain"):
            rank = None
            for part in query.split("&"):
                if part.startswith("rank="):
                    try:
                        rank = int(part[5:])
                    except ValueError:
                        pass
            if rank is None:
                _send(self, 400, {"error": "need ?rank=N"})
                return
            ok = router.set_drain(rank, route.endswith("/drain"))
            _send(self, 200 if ok else 404,
                  {"rank": rank, "draining": route.endswith("/drain"),
                   "ok": ok})
        else:
            _send(self, 404, {"error": f"no such route {route!r}"})

    def log_message(self, fmt, *args):
        _LOG.debug("%s %s", self.address_string(), fmt % args)


class Router:
    """Load-balancing front door over N replica servers.

    Discovery is portfile-based (``serve-port-*.json`` under
    ``directory``) and re-runs at every health poll, so replicas added
    by an ``--elastic`` rescale join rotation automatically and dead
    ones fall out.  Dispatch policy: session affinity first (an id seen
    before goes back to its replica while that replica is healthy —
    keeping its prefix-cache pages hot), otherwise least outstanding
    requests among healthy, undrained replicas."""

    def __init__(self, directory: str, port: Optional[int] = None,
                 host: Optional[str] = None,
                 health_sec: Optional[float] = None):
        self.directory = directory
        self._host = host if host is not None \
            else os.environ.get("MX_SERVE_HOST", "127.0.0.1")
        self._bind_port = _env_int("MX_SERVE_ROUTER_PORT", 0) \
            if port is None else int(port)
        self.health_sec = _env_float("MX_SERVE_HEALTH_SEC", 2.0) \
            if health_sec is None else float(health_sec)
        self._lock = threading.Lock()
        # rank -> {rank, host, port, url, healthy, draining, outstanding}
        self._replicas: Dict[int, dict] = {}
        self._sessions: Dict[str, int] = {}
        self._server: Optional[ThreadingHTTPServer] = None
        self._http_thread: Optional[threading.Thread] = None
        self._health_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.port = 0
        self.dispatched = 0
        self.failovers = 0
        # /tracez surfaces (§Request tracing): trace_id -> in-flight
        # request with its currently open span, + a bounded ring of the
        # last K completed request trees (attempt list = the span tree's
        # dispatch children, failovers included)
        self._inflight: Dict[str, dict] = {}
        self._completed: deque = deque(
            maxlen=max(1, _env_int("MX_RQTRACE_TRACEZ_K", 32)))
        self.refresh()

    # ---- lifecycle ---------------------------------------------------
    def start(self) -> "Router":
        server = ThreadingHTTPServer((self._host, self._bind_port),
                                     _RouterHandler)
        server.daemon_threads = True
        server.router = self  # type: ignore[attr-defined]
        self._server = server
        self.port = server.server_address[1]
        self._http_thread = threading.Thread(
            target=server.serve_forever, daemon=True,
            name="mx-serve-router-http")
        self._http_thread.start()
        self._health_thread = threading.Thread(
            target=self._health_loop, daemon=True,
            name="mx-serve-router-health")
        self._health_thread.start()
        _LOG.info("router serving on %s:%d over %d replica(s)",
                  self._host, self.port, len(self._replicas))
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._health_thread is not None:
            self._health_thread.join(timeout=5.0)

    # ---- replica set -------------------------------------------------
    def refresh(self) -> None:
        """Re-discover replicas from portfiles: new ranks join rotation
        (healthy until a probe says otherwise), vanished ranks drop."""
        found = {r["rank"]: r for r in discover_replicas(self.directory)}
        with self._lock:
            for rank, info in found.items():
                cur = self._replicas.get(rank)
                url = f"http://{info['host']}:{info['port']}"
                if cur is None or cur["url"] != url:
                    self._replicas[rank] = {
                        "rank": rank, "url": url, "healthy": True,
                        "draining": False, "outstanding": 0}
            for rank in list(self._replicas):
                if rank not in found:
                    del self._replicas[rank]

    def _health_loop(self) -> None:
        while not self._stop.wait(self.health_sec):
            self.refresh()
            for rep in self.replicas():
                self._probe(rep)

    def _probe(self, rep: dict) -> None:
        try:
            with urllib.request.urlopen(rep["url"] + "/healthz",
                                        timeout=2.0) as resp:
                snap = json.load(resp)
            healthy, draining = True, bool(snap.get("draining"))
        except urllib.error.HTTPError as e:
            # 503 = alive but draining/erroring: keep it out of rotation
            # without forgetting it (undrain brings it straight back)
            try:
                snap = json.load(e)
            except (ValueError, OSError):
                snap = {}
            healthy, draining = False, bool(snap.get("draining"))
        except (OSError, ValueError):
            healthy, draining = False, False
        with self._lock:
            cur = self._replicas.get(rep["rank"])
            if cur is not None:
                cur["healthy"] = healthy
                cur["draining"] = draining

    def replicas(self) -> List[dict]:
        with self._lock:
            return [dict(r) for r in self._replicas.values()]

    # ---- dispatch ----------------------------------------------------
    def _pick(self, session: Optional[str], exclude) -> Optional[dict]:
        with self._lock:
            live = [r for r in self._replicas.values()
                    if r["healthy"] and not r["draining"]
                    and r["rank"] not in exclude]
            if not live:
                return None
            if session is not None:
                rank = self._sessions.get(session)
                for r in live:
                    if r["rank"] == rank:
                        return r
            pick = min(live, key=lambda r: (r["outstanding"], r["rank"]))
            if session is not None:
                # (re)pin — a failed-over session sticks to its NEW home
                self._sessions[session] = pick["rank"]
            return pick

    def dispatch(self, body: dict):
        """Route one /generate body; returns (http_code, payload).
        Connection-level failures mark the replica dead and fail the
        request over; HTTP-level errors (4xx validation, 503 back-
        pressure) are the replica's verdict and pass through.

        Tracing (§Request tracing): mints the trace context, wraps the
        whole residence in a paired ``serve_route`` span whose id rides
        the outgoing header as ``parent=``, tracks the request in the
        /tracez in-flight table, and archives it to the completed ring
        on the way out.  A failed-over request stays ONE trace — its
        attempt list (and span tree) just grows a second dispatch."""
        trace = mint_trace()
        if trace is None:  # MX_RQTRACE=0: the untraced fast path
            return self._dispatch_attempts(body, None, 0, None)
        tid = trace["trace_id"]
        entry = {"trace_id": tid, "request_id": body.get("request_id"),
                 "session": body.get("session"),
                 "sampled": trace["sampled"], "open_span": "serve_route",
                 "replica": None, "started": round(time.time(), 3),
                 "attempts": []}
        with self._lock:
            self._inflight[tid] = entry
        t0 = time.perf_counter()
        code, payload = None, None
        try:
            if trace["sampled"] and telemetry.spans_enabled():
                with telemetry.span(
                        "serve_route", paired=True, trace_id=tid,
                        request_id=body.get("request_id"),
                        session=body.get("session")) as sp:
                    code, payload = self._dispatch_attempts(
                        body, trace, sp.span_id, entry)
            else:
                code, payload = self._dispatch_attempts(
                    body, trace, 0, entry)
        finally:
            self._finish_trace(trace, entry, code, payload, t0,
                               time.perf_counter())
        return code, payload

    def _dispatch_attempts(self, body: dict, trace: Optional[dict],
                           parent_span: int, entry: Optional[dict]):
        """The pick→POST→failover loop (one iteration per attempt)."""
        session = body.get("session")
        timeout_s = float(body.get("timeout_s", 120.0))
        raw = json.dumps(body).encode("utf-8")
        headers = {"Content-Type": "application/json"}
        tid = trace["trace_id"] if trace else None
        sampled = bool(trace.get("sampled", True)) if trace else False
        if trace is not None:
            headers[TRACE_HEADER] = format_trace_header(
                tid, parent_span, sampled)
        tried: set = set()
        while True:
            rep = self._pick(session, tried)
            if rep is None:
                return 503, {"error": "no healthy replica available",
                             "tried": sorted(tried)}
            tried.add(rep["rank"])
            req = urllib.request.Request(
                rep["url"] + "/generate", data=raw, headers=headers)
            attempt = {"rank": rep["rank"], "t0": time.perf_counter(),
                       "t1": None, "ms": 0.0, "error": None}
            if entry is not None:
                with self._lock:
                    entry["open_span"] = "serve_dispatch"
                    entry["replica"] = rep["rank"]
                    entry["attempts"].append(attempt)
            with self._lock:
                cur = self._replicas.get(rep["rank"])
                if cur is not None:
                    cur["outstanding"] += 1
            try:
                with urllib.request.urlopen(req,
                                            timeout=timeout_s) as resp:
                    payload = json.load(resp)
                self.dispatched += 1
                payload["routed_to"] = rep["rank"]
                return 200, payload
            except urllib.error.HTTPError as e:
                try:
                    payload = json.load(e)
                except (ValueError, OSError):
                    payload = {"error": f"replica HTTP {e.code}"}
                payload["routed_to"] = rep["rank"]
                attempt["error"] = f"HTTP {e.code}"
                if e.code == 503 and payload.get("error") == \
                        "replica draining":
                    # the replica began draining after the pick (a drain
                    # forwards to the replica before the local flag
                    # flips): out of rotation now, the request elsewhere
                    with self._lock:
                        cur = self._replicas.get(rep["rank"])
                        if cur is not None:
                            cur["draining"] = True
                    continue
                return e.code, payload
            except (urllib.error.URLError, OSError) as e:
                # connection-level death: mark dead, fail over
                with self._lock:
                    cur = self._replicas.get(rep["rank"])
                    if cur is not None:
                        cur["healthy"] = False
                self.failovers += 1
                attempt["error"] = str(e)[:200]
                telemetry.record("serve_failover", executor="Router",
                                 rank=rep["rank"], error=str(e)[:200],
                                 trace_id=tid)
                telemetry.record_serve_cause(
                    "failover", trace_id=tid, rank=rep["rank"])
                _LOG.warning("replica %d unreachable (%s); failing over",
                             rep["rank"], e)
            finally:
                attempt["t1"] = time.perf_counter()
                attempt["ms"] = (attempt["t1"] - attempt["t0"]) * 1e3
                if tid and sampled:
                    attrs = {"trace_id": tid, "replica": rep["rank"]}
                    if attempt["error"]:
                        attrs["error"] = attempt["error"]
                    telemetry.record_span("serve_dispatch",
                                          attempt["t0"], attempt["t1"],
                                          **attrs)
                with self._lock:
                    cur = self._replicas.get(rep["rank"])
                    if cur is not None:
                        cur["outstanding"] = max(
                            0, cur["outstanding"] - 1)

    def _finish_trace(self, trace: dict, entry: dict,
                      code: Optional[int], payload, t0: float,
                      t1: float) -> None:
        """Archive one traced dispatch: /tracez completed-ring entry +
        retroactive span emission for an UNSAMPLED request that erred or
        breached the TTFT SLO (always-sample the tail)."""
        tid = trace["trace_id"]
        ttft = float(payload.get("ttft_ms", 0.0)) \
            if isinstance(payload, dict) else 0.0
        if isinstance(payload, dict):
            payload.setdefault("trace_id", tid)
        slo = _env_float("MX_SERVE_SLO_TTFT_MS", 0.0)
        breach = slo > 0 and ttft > slo
        errorish = code is None or code >= 500
        if not trace["sampled"] and (errorish or breach) \
                and telemetry.spans_enabled():
            telemetry.record_span(
                "serve_route", t0, t1, trace_id=tid,
                request_id=entry["request_id"], late_sampled=True,
                code=code)
            for a in entry["attempts"]:
                attrs = {"trace_id": tid, "replica": a["rank"],
                         "late_sampled": True}
                if a["error"]:
                    attrs["error"] = a["error"]
                telemetry.record_span("serve_dispatch", a["t0"],
                                      a["t1"] or t1, **attrs)
        done = {"trace_id": tid, "request_id": entry["request_id"]
                if entry["request_id"] is not None else
                (payload.get("request_id")
                 if isinstance(payload, dict) else None),
                "session": entry["session"], "code": code,
                "latency_ms": round((t1 - t0) * 1e3, 3),
                "ttft_ms": round(ttft, 3), "replica": entry["replica"],
                "sampled": trace["sampled"], "slo_breach": breach,
                "attempts": [{"rank": a["rank"],
                              "ms": round(a["ms"], 3),
                              "error": a["error"]}
                             for a in entry["attempts"]]}
        with self._lock:
            self._inflight.pop(tid, None)
            self._completed.append(done)

    # ---- admin + introspection ---------------------------------------
    def set_drain(self, rank: int, draining: bool) -> bool:
        """Forward drain/undrain to a replica and mirror the flag
        locally so rotation updates immediately (the health poll would
        get there eventually)."""
        with self._lock:
            rep = self._replicas.get(rank)
            url = rep["url"] if rep is not None else None
        if url is None:
            return False
        verb = "drain" if draining else "undrain"
        try:
            req = urllib.request.Request(f"{url}/admin/{verb}", data=b"")
            with urllib.request.urlopen(req, timeout=5.0):
                pass
        except (urllib.error.URLError, OSError) as e:
            _LOG.warning("drain forward to replica %d failed: %s",
                         rank, e)
            return False
        with self._lock:
            rep = self._replicas.get(rank)
            if rep is not None:
                rep["draining"] = draining
        return True

    def healthz(self) -> dict:
        reps = self.replicas()
        healthy = [r["rank"] for r in reps
                   if r["healthy"] and not r["draining"]]
        return {"ok": bool(healthy), "healthy": healthy,
                "replicas": len(reps)}

    def statusz(self) -> dict:
        with self._lock:
            sessions = len(self._sessions)
        return {"replicas": self.replicas(), "sessions": sessions,
                "dispatched": self.dispatched,
                "failovers": self.failovers,
                "health_sec": self.health_sec,
                "time": round(time.time(), 3)}

    def tracez(self) -> dict:
        """The /tracez payload (§Request tracing): the last K completed
        request trees (newest last; attempt list = dispatch spans,
        failovers included) and every in-flight request with its open
        span + elapsed — the fleet edition of the flight recorder's
        "died inside X" clue."""
        now = time.perf_counter()
        with self._lock:
            completed = [dict(c) for c in self._completed]
            inflight = []
            for e in self._inflight.values():
                open_t0 = (e["attempts"][-1]["t0"] if e["attempts"]
                           and e["open_span"] == "serve_dispatch"
                           else None)
                inflight.append({
                    "trace_id": e["trace_id"],
                    "request_id": e["request_id"],
                    "session": e["session"], "sampled": e["sampled"],
                    "open_span": e["open_span"],
                    "replica": e["replica"],
                    "started": e["started"],
                    "open_span_elapsed_ms": round(
                        (now - open_t0) * 1e3, 3)
                    if open_t0 is not None else None,
                    "attempts": len(e["attempts"])})
        return {"enabled": rqtrace_enabled(),
                "sample": _env_float("MX_RQTRACE_SAMPLE", 1.0),
                "k": self._completed.maxlen,
                "in_flight": inflight, "completed": completed,
                "time": round(time.time(), 3)}
