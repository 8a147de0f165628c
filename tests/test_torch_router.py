"""The port's serving front door: ``Router`` over the fake-worker fleet of
tests/test_router.py (case for case), ``ReplicaServer`` over a real
engine on the CPU — its ``/generate`` responses equal to the JAX
package's ``ReplicaServer`` serving the same tiny net (carried by
``convert.py``), one Router in front of both — the metrics endpoint, and
a source-text check that the HTTP handlers never touch a torch tensor.
"""
import ast
import inspect
import json
import os
import re
import textwrap
import urllib.error
import urllib.request

import pytest

from test_router import _FakeWorker, _post, _post_get

from mxnet_tpu_torch import metrics_server, telemetry
from mxnet_tpu_torch.serving import (ReplicaServer, Request, Router,
                                     ServingEngine, TransformerAdapter,
                                     discover_replicas, serve_portfile_path)
from mxnet_tpu_torch.serving import router as router_mod

PAD, BOS, EOS = 0, 1, 2
CFG = dict(units=32, hidden_size=64, num_heads=4, num_layers=2,
           max_length=48, dropout=0.0)


@pytest.fixture
def fleet(tmp_path):
    d = str(tmp_path)
    workers = [_FakeWorker(d, r) for r in range(2)]
    router = Router(d, port=0, health_sec=60.0)
    yield d, workers, router
    router.stop()
    for w in workers:
        try:
            w.kill()
        except Exception:
            pass


# ---------------------------------------------------------------------------
# the Router cases of tests/test_router.py
# ---------------------------------------------------------------------------
def test_portfile_discovery_skips_torn_files(tmp_path):
    d = str(tmp_path)
    _FakeWorker(d, 0)
    _FakeWorker(d, 3)
    with open(os.path.join(d, "serve-port-9.json"), "w") as f:
        f.write('{"rank": 9, "po')  # torn mid-write
    with open(os.path.join(d, "metrics-port-0.json"), "w") as f:
        f.write("{}")  # another family, ignored
    got = discover_replicas(d)
    assert sorted(r["rank"] for r in got) == [0, 3]
    assert all(r["host"] == "127.0.0.1" and r["port"] > 0 for r in got)


def test_session_affinity_pins_conversation(fleet):
    _, workers, router = fleet
    router.start()
    outs = [_post(router.port, {"prompt": [5, 6], "session": "conv-a"})
            for _ in range(4)]
    homes = {o["routed_to"] for o in outs}
    assert len(homes) == 1
    home = homes.pop()
    assert all(o["replica"] == home for o in outs)
    assert len(workers[home].seen) == 4
    outs_b = [_post(router.port, {"prompt": [7], "session": "conv-b"})
              for _ in range(3)]
    assert len({o["routed_to"] for o in outs_b}) == 1


def test_sessionless_requests_balance_by_outstanding(fleet):
    _, workers, router = fleet
    with router._lock:
        router._replicas[0]["outstanding"] = 5
    code, payload = router.dispatch({"prompt": [3]})
    assert code == 200 and payload["routed_to"] == 1
    with router._lock:
        router._replicas[1]["outstanding"] = 9
    code, payload = router.dispatch({"prompt": [3]})
    assert code == 200 and payload["routed_to"] == 0


def test_replica_death_fails_over_and_repins_session(fleet):
    d, workers, router = fleet
    router.start()
    first = _post(router.port, {"prompt": [4], "session": "s"})
    home = first["routed_to"]
    workers[home].kill()
    out = _post(router.port, {"prompt": [4, 4], "session": "s"})
    other = 1 - home
    assert out["routed_to"] == other
    assert out["tokens"] == [other, 4, 4]
    assert router.failovers == 1
    dead = [r for r in router.statusz()["replicas"] if r["rank"] == home][0]
    assert dead["healthy"] is False
    again = _post(router.port, {"prompt": [4], "session": "s"})
    assert again["routed_to"] == other
    workers[other].kill()
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(router.port, {"prompt": [4]})
    assert ei.value.code == 503
    assert "no healthy replica" in json.load(ei.value)["error"]
    # the failed-over request is one trace with two dispatch attempts
    tz = _post_get(router.port, "/tracez")
    attempts = [c["attempts"] for c in tz["completed"]
                if len(c["attempts"]) == 2]
    assert attempts and attempts[0][0]["error"]


def test_vanished_portfile_drops_replica_on_refresh(fleet):
    _, workers, router = fleet
    assert sorted(r["rank"] for r in router.replicas()) == [0, 1]
    workers[1].kill()
    os.unlink(workers[1].portfile)
    router.refresh()
    assert [r["rank"] for r in router.replicas()] == [0]
    code, payload = router.dispatch({"prompt": [8]})
    assert code == 200 and payload["routed_to"] == 0


def test_drain_undrain_through_router(fleet):
    _, workers, router = fleet
    router.start()
    assert router.set_drain(0, True)
    assert workers[0].draining is True
    router._probe({"rank": 0, "url": f"http://127.0.0.1:{workers[0].port}"})
    for _ in range(4):
        assert _post(router.port, {"prompt": [2]})["routed_to"] == 1
    assert router.set_drain(0, False)
    router._probe({"rank": 0, "url": f"http://127.0.0.1:{workers[0].port}"})
    live = {r["rank"]: r for r in router.replicas()}
    assert live[0]["healthy"] and not live[0]["draining"]
    assert not router.set_drain(7, True), "unknown rank refused"
    # the same through the router's own admin route
    _post(router.port, {}, path="/admin/drain?rank=1")
    assert workers[1].draining is True


def _post_late_body(port, path, body=b"{}"):
    """POST ``path`` with the body sent 0.3 s after the headers, as a
    client that writes them apart may.  Returns (whether an answer came
    before the body, the answer's status code).  A handler that answers
    without reading its body closes the socket with the body unread,
    which sends a reset that can destroy the answer in flight."""
    import select
    import socket
    import time

    with socket.create_connection(("127.0.0.1", port), timeout=30) as s:
        s.sendall(f"POST {path} HTTP/1.1\r\nHost: 127.0.0.1\r\n"
                  f"Content-Type: application/json\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n".encode())
        time.sleep(0.3)
        early = bool(select.select([s], [], [], 0)[0])
        try:
            s.sendall(body)
        except OSError:
            pass
        got = b""
        try:
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    break
                got += chunk
        except ConnectionResetError:
            pass
    return early, int(got.split(b"\r\n", 1)[0].split()[1])


@pytest.mark.parametrize("path,code", [("/admin/drain?rank=1", 200),
                                       ("/admin/undrain?rank=1", 200),
                                       ("/admin/drain", 400),
                                       ("/generate", 200),
                                       ("/no/such/route", 404)])
def test_router_reads_the_body_before_it_answers(fleet, path, code):
    _, _, router = fleet
    router.start()
    body = b'{"prompt": [3]}' if path == "/generate" else b"{}"
    assert _post_late_body(router.port, path, body) == (False, code)


def test_http_errors_pass_through_without_failover(fleet):
    _, workers, router = fleet
    code, payload = router.dispatch({"prompt": [1], "boom": True})
    assert code == 400
    assert payload["error"] == "synthetic validation"
    assert router.failovers == 0
    assert all(r["healthy"] for r in router.replicas())


class _DrainingReplica:
    """A replica that began draining after the Router picked it: every
    /generate answers 503 "replica draining" (what ``ReplicaServer``
    answers while draining)."""

    def __init__(self, directory, rank):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
        import threading

        self.hits = 0
        outer = self

        class H(BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802
                outer.hits += 1
                n = int(self.headers.get("Content-Length") or 0)
                self.rfile.read(n)
                raw = json.dumps({"error": "replica draining",
                                  "rank": rank}).encode()
                self.send_response(503)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def log_message(self, fmt, *args):
                pass

        self._server = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self._server.daemon_threads = True
        threading.Thread(target=self._server.serve_forever,
                         daemon=True).start()
        with open(serve_portfile_path(directory, rank), "w") as f:
            json.dump({"rank": rank, "host": "127.0.0.1",
                       "port": self._server.server_address[1]}, f)

    def kill(self):
        self._server.shutdown()
        self._server.server_close()


def test_request_reaching_a_draining_replica_goes_elsewhere(tmp_path):
    """A drain forwards to the replica before the Router's own flag
    flips, so a request picked in between meets a draining replica: it
    goes to another replica, whose answer the client gets, and the
    session re-pins there.  No replica is marked dead."""
    d = str(tmp_path)
    draining = _DrainingReplica(d, 0)
    live = _FakeWorker(d, 1)
    router = Router(d, port=0, health_sec=60.0)
    try:
        code, payload = router.dispatch({"prompt": [3, 4], "session": "s"})
        assert draining.hits == 1  # rank 0 won the tie, and answered 503
        assert code == 200 and payload["routed_to"] == 1
        assert payload["tokens"] == [1, 3, 4]
        assert router.failovers == 0
        reps = {r["rank"]: r for r in router.replicas()}
        assert reps[0]["draining"] and reps[0]["healthy"]
        code, payload = router.dispatch({"prompt": [5], "session": "s"})
        assert code == 200 and payload["routed_to"] == 1
        assert draining.hits == 1
    finally:
        router.stop()
        draining.kill()
        live.kill()


# ---------------------------------------------------------------------------
# ReplicaServer over a real engine
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def nets():
    """A tiny JAX Transformer and its port twin, carried by name."""
    import mxnet_tpu as mx
    from mxnet_tpu import nd
    from mxnet_tpu.models.transformer import Transformer as JaxTransformer
    from mxnet_tpu_torch.convert import from_mxnet_tpu_params
    from mxnet_tpu_torch.models.transformer import Transformer

    mx.random.seed(0)
    jnet = JaxTransformer(16, **CFG)
    jnet.initialize(mx.init.Xavier())
    jnet(nd.array([[3, 4, 5, 0, 0]], dtype="int32"),
         nd.array([[BOS, 3, 4, 5, 0, 0]], dtype="int32"))
    tnet = Transformer(16, device="cpu", init_weights=False, **CFG)
    from_mxnet_tpu_params(tnet, {k: p.data().asnumpy() for k, p in
                                 jnet.collect_params().items()}, jnet.prefix)
    return jnet, tnet


def _port_engine(tnet, **kw):
    return ServingEngine(TransformerAdapter(tnet, src_max_len=6), slots=2,
                         page_size=4, max_len=12, stream_every=4,
                         device="cpu", **kw)


def _jax_engine(jnet):
    from mxnet_tpu.serving import ServingEngine as JaxEngine
    from mxnet_tpu.serving import TransformerAdapter as JaxAdapter

    return JaxEngine(JaxAdapter(jnet, src_max_len=6), slots=2, page_size=4,
                     max_len=12, stream_every=4)


PROMPTS = [[5, 6, 7], [3, 9], [12, 4, 4, 8], [7]]


def test_replica_server_end_to_end(nets, tmp_path, monkeypatch):
    """HTTP /generate equals an in-process serve(); the sampling defaults
    apply at the HTTP layer; /statusz and /healthz answer from host
    state; the portfile advertises the server and goes with it."""
    _, tnet = nets
    prompt = PROMPTS[0]
    want = _port_engine(tnet, sampling=True).serve(
        [Request(prompt, max_new_tokens=6, bos_id=BOS, eos_id=EOS,
                 request_id="w")])["w"]
    rep = ReplicaServer(_port_engine(tnet, sampling=True), bos_id=BOS,
                        eos_id=EOS, port=0, rank=0,
                        directory=str(tmp_path)).start()
    try:
        out = _post(rep.port, {"prompt": prompt, "max_new_tokens": 6})
        assert out["tokens"] == [int(t) for t in want]
        assert out["finish_reason"] == "length"
        assert out["generation"] == 0 and out["ttft_ms"] > 0
        got = discover_replicas(str(tmp_path))
        assert [(r["rank"], r["port"]) for r in got] == [(0, rep.port)]
        monkeypatch.setenv("MX_SERVE_TEMPERATURE", "0.9")
        hot = _post(rep.port, {"prompt": prompt, "max_new_tokens": 6,
                               "seed": 3})
        assert hot["tokens"] != out["tokens"]
        monkeypatch.delenv("MX_SERVE_TEMPERATURE")
        snap = _post_get(rep.port, "/statusz")
        assert snap["rank"] == 0 and snap["engine"]["slots"] == 2
        assert snap["engine"]["sampling"] is True
        assert _post_get(rep.port, "/healthz")["ok"] is True
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(rep.port, {"prompt": []})
        assert ei.value.code == 400
    finally:
        rep.stop()
    assert not os.path.exists(serve_portfile_path(str(tmp_path), 0))


@pytest.mark.parametrize("path,code", [("/admin/drain", 200),
                                       ("/generate", 503),
                                       ("/admin/undrain", 200),
                                       ("/no/such/route", 404)])
def test_replica_reads_the_body_before_it_answers(nets, tmp_path, path,
                                                  code):
    """Each route answers only once its body is in, draining or not."""
    _, tnet = nets
    rep = ReplicaServer(_port_engine(tnet), bos_id=BOS, eos_id=EOS, port=0,
                        rank=0, directory=str(tmp_path)).start()
    try:
        if path == "/generate":
            rep.drain()
        assert _post_late_body(rep.port, path,
                               b'{"prompt": [5, 6]}') == (False, code)
    finally:
        rep.stop()


def test_port_and_jax_replicas_answer_alike(nets, tmp_path):
    """A port ReplicaServer and a JAX ReplicaServer over the same weights:
    equal /generate responses, directly and through one Router in front
    of both (sessions pinned to each)."""
    from mxnet_tpu.serving import ReplicaServer as JaxReplicaServer

    jnet, tnet = nets
    d = str(tmp_path)
    treps = ReplicaServer(_port_engine(tnet), bos_id=BOS, eos_id=EOS,
                          port=0, rank=0, directory=d).start()
    jreps = JaxReplicaServer(_jax_engine(jnet), bos_id=BOS, eos_id=EOS,
                             port=0, rank=1, directory=d).start()
    router = Router(d, port=0, health_sec=60.0).start()
    try:
        keep = ("tokens", "finish_reason", "generation")
        for p in PROMPTS:
            body = {"prompt": p, "max_new_tokens": 7}
            t = _post(treps.port, body)
            j = _post(jreps.port, body)
            assert {k: t[k] for k in keep} == {k: j[k] for k in keep}
        # one session pinned to each replica, every prompt sent in both
        with router._lock:
            router._sessions.update({"port": 0, "jax": 1})
        by_rank = {}
        for i, p in enumerate(PROMPTS * 2):
            out = _post(router.port, {"prompt": p, "max_new_tokens": 7,
                                      "session": ("port", "jax")[i // 4]})
            by_rank.setdefault(tuple(p), {})[out["routed_to"]] = \
                out["tokens"]
        for p, outs in by_rank.items():
            assert len(set(map(tuple, outs.values()))) == 1, p
        assert {r for outs in by_rank.values() for r in outs} == {0, 1}
    finally:
        router.stop()
        treps.stop()
        jreps.stop()


# ---------------------------------------------------------------------------
# the metrics endpoint
# ---------------------------------------------------------------------------
def test_metrics_server_routes(tmp_path, monkeypatch):
    telemetry.reset()
    monkeypatch.setenv("MX_TELEMETRY_DIR", str(tmp_path))
    telemetry.enable(str(tmp_path))
    telemetry.record_serve_request(tokens=5, ttft_ms=3.0, total_ms=9.0,
                                   request_id="r0", trace_id="ab",
                                   cause="none")
    telemetry.record_weight_swap(generation=2, staged_bytes=10)
    try:
        assert metrics_server.start(0)
        port = metrics_server.port()
        with open(metrics_server.portfile_path(str(tmp_path), 0)) as f:
            assert json.load(f)["port"] == port
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=10) as r:
            body = r.read().decode()
        assert 'mx_serve_weight_generation{rank="0"} 2' in body
        assert 'mx_export_mode{rank="0",mode="live"} 1' in body
        assert body.endswith("# EOF\n")
        assert _post_get(port, "/healthz")["healthy"] is True
        st = _post_get(port, "/statusz")
        assert st["summary"]["serving"]["weight_generation"] == 2
        assert st["memwatch"]["samples"] == 0
        assert _post_get(port, "/tracez")["recent"][0]["trace_id"] == "ab"
    finally:
        metrics_server.stop()
        telemetry.reset()
    assert not os.path.exists(
        metrics_server.portfile_path(str(tmp_path), 0))


# ---------------------------------------------------------------------------
# handlers stay off the card
# ---------------------------------------------------------------------------
# what a handler thread may run: the routes and everything they call
HOST_ONLY = [
    router_mod._ReplicaHandler, router_mod._RouterHandler,
    router_mod._send, router_mod._read_body, router_mod._parse_json_body,
    router_mod.parse_trace_header, router_mod.mint_trace,
    router_mod._sampling_defaults,
    ReplicaServer.generate, ReplicaServer._serve_wait, ReplicaServer.drain,
    ReplicaServer.undrain, ReplicaServer.healthz, ReplicaServer.statusz,
    Router.dispatch, Router._dispatch_attempts, Router._finish_trace,
    Router._pick, Router.set_drain, Router.healthz, Router.statusz,
    Router.tracez, Router.replicas,
    ServingEngine.submit, ServingEngine.statusz_snapshot,
    TransformerAdapter.validate,
    metrics_server._Handler,
    telemetry.render_prometheus, telemetry.health_snapshot,
    telemetry.summary, telemetry.recent_requests, telemetry.flight_tail,
]
CARD = re.compile(r"\btorch\b|\.cpu\(|\.cuda\(|\.item\(|\.numpy\(|"
                  r"asnumpy|synchronize|\.tolist\(|\.to\(|_state\[|\._data")


def test_handlers_touch_no_torch_tensor():
    """The source of every route handler, and of every function a handler
    calls into, names no torch tensor operation: a handler never reads a
    device value or synchronises the card (the engine-driver thread owns
    it)."""
    for obj in HOST_ONLY:
        src = textwrap.dedent(inspect.getsource(obj))
        tree = ast.parse(src)
        code = "\n".join(
            ast.get_source_segment(src, node) or ""
            for node in ast.walk(tree)
            if isinstance(node, (ast.Call, ast.Attribute, ast.Name,
                                 ast.Subscript)))
        hits = CARD.findall(code)
        assert not hits, f"{obj.__qualname__} touches {hits}"
    # and the check has teeth
    bad = "def f(eng):\n    return eng._state['tok'].cpu()\n"
    assert CARD.findall(bad)
