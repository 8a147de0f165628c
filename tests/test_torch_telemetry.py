"""The port's telemetry recorder against the JAX package's.

The same sequence of calls goes into ``mxnet_tpu.telemetry`` and
``mxnet_tpu_torch.telemetry``, each recorder with its own directory; the
JSONL events must match once the clocks and the process-wide ids are
dropped, and so must ``summary()``, ``health_snapshot()``, the series of
``render_prometheus()`` and the non-time fields of the reports
``tools/trace_report.py`` and ``tools/serve_report.py`` print.
"""
import json
import os
import subprocess
import sys

import pytest

from mxnet_tpu import telemetry as jtel
from mxnet_tpu_torch import telemetry as ttel

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# clocks, durations and the per-process counters of span and thread ids
TIME_KEYS = {"t", "mono", "wall", "pid", "tid", "span", "parent", "dur_ms",
             "wall_ms", "time"}
# where each recorder writes
PATH_KEYS = {"dir", "streams"}


@pytest.fixture
def both():
    jtel.reset()
    ttel.reset()
    yield jtel, ttel
    jtel.reset()
    ttel.reset()


def _drive(tel, directory):
    """One fixed sequence over every recording entry point."""
    tel.enable(directory)
    tel.record_step("Trainer", step=1, wall_s=0.5, samples=32, traced=True)
    for s in (2, 3, 4):
        tel.record_step("Trainer", step=s, wall_s=0.01 * s, samples=32)
    tel.record_collective("device_allreduce", nbytes=4096, wall_s=0.002)
    tel.record_fused_update(n_params=10, n_buckets=2, nbytes=4000,
                            n_jitted_calls=2, step=4)
    tel.record_checkpoint("save", step=4, wall_s=0.05, nbytes=8192)
    tel.record_checkpoint("fallback", step=5, reason="digest-or-meta")
    tel.note_signature("ExecA", ("sig", 1))
    tel.note_signature("ExecA", ("sig", 1))
    with tel.span("outer", stage="a"):
        with tel.span("inner", paired=True, k=3):
            pass
    tel.record_span("serve_queue", 1.0, 1.25, request_id="r0")
    for i in range(3):
        tel.record_serve_request(
            queue_wait_ms=1.0 + i, prefill_ms=2.0, decode_ms=10.0 * (i + 1),
            tokens=8 + i, ttft_ms=5.0 + i, total_ms=20.0 + i,
            request_id=f"r{i}", reason="length", precision="fp32",
            cause="none" if i else "cache_miss", preemptions=0,
            trace_id=f"{i:016x}", sampled=True)
    tel.record_serve_cause("failover", trace_id="00000000000000ff", rank=1)
    tel.record_serve_state(queue_depth=3, active_slots=2, precision="fp32")
    tel.record_weight_swap(generation=1, staged_bytes=1 << 20,
                           verify_ms=3.0, flip_ms=0.5, step=7)
    tel.record_serve_prefix(kind="pages", hit=True, tokens=5,
                            request_id="r1")
    tel.record_serve_prefix(kind="prefill", hit=False, tokens=4,
                            request_id="r2")
    tel.record_spec_verify(proposed=8, accepted=5, trace_ids=["a"])
    tel.record("serve_preempt", request_id="r3", decoded=4)
    tel.heartbeat(4, force=True)
    tel.flush()


def _events(tel, directory):
    with open(tel.event_path(directory, 0)) as f:
        events = [json.loads(line) for line in f]
    return [{k: v for k, v in e.items() if k not in TIME_KEYS}
            for e in events if e["kind"] != "clock_anchor"]


def _strip(obj):
    """``obj`` without its clocks: wall, age and duration fields."""
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if k not in TIME_KEYS | PATH_KEYS
                and not k.endswith(("_ms", "_sec", "_s", "_age"))}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def test_event_streams_match(both, tmp_path):
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    _drive(jtel, jd)
    _drive(ttel, td)
    je, te = _events(jtel, jd), _events(ttel, td)
    assert [e["kind"] for e in je] == [e["kind"] for e in te]
    assert je == te
    kinds = {e["kind"] for e in te}
    assert {"step", "collective", "checkpoint_save", "span", "span_begin",
            "serve_request", "weight_swap", "serve_prefix",
            "spec_verify"} <= kinds
    with open(ttel.heartbeat_path(td, 0)) as f:
        hb_t = json.load(f)
    with open(jtel.heartbeat_path(jd, 0)) as f:
        hb_j = json.load(f)
    assert _strip(hb_t) == _strip(hb_j)


def test_summary_health_and_prometheus_match(both, tmp_path):
    _drive(jtel, str(tmp_path / "jax"))
    _drive(ttel, str(tmp_path / "torch"))
    assert _strip(ttel.summary()) == _strip(jtel.summary())
    assert _strip(ttel.health_snapshot()) == _strip(jtel.health_snapshot())

    def series(text):
        out = []
        for line in text.splitlines():
            if line.startswith("# TYPE") or line == "# EOF":
                out.append(line)
            elif line and not line.startswith("#"):
                out.append(line.rsplit(" ", 1)[0])  # name and labels
        return out

    tp, jp = ttel.render_prometheus(), jtel.render_prometheus()
    assert series(tp) == series(jp)
    for name in ("mx_serve_requests_total", "mx_serve_tokens_total",
                 "mx_serve_ttft_p50_ms", "mx_serve_weight_generation",
                 "mx_serve_weight_swaps_total"):
        assert any(s.startswith(name) for s in series(tp)), name
    assert 'mx_serve_weight_generation{rank="0"} 1' in tp


def _report(tool, *args):
    out = subprocess.run([sys.executable, os.path.join("tools", tool),
                          *args, "--json"], cwd=_REPO, capture_output=True,
                         text=True, timeout=120)
    return out.returncode, json.loads(out.stdout) if out.stdout else None


def test_report_tools_read_both_streams_alike(both, tmp_path):
    jd, td = str(tmp_path / "jax"), str(tmp_path / "torch")
    _drive(jtel, jd)
    _drive(ttel, td)
    for tool in ("trace_report.py", "serve_report.py"):
        rc_t, rep_t = _report(tool, td)
        rc_j, rep_j = _report(tool, jd)
        assert rc_t == rc_j == 0, (tool, rc_t, rc_j)
        assert _strip(rep_t) == _strip(rep_j), tool


def test_chrome_trace_export(both, tmp_path):
    td = str(tmp_path / "torch")
    _drive(ttel, td)
    out = ttel.export_chrome_trace(td, out=str(tmp_path / "trace.json"))
    with open(out) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"outer", "inner", "serve_queue"} <= names


def test_disabled_recorder_is_a_no_op(both):
    assert not ttel.enabled()
    ttel.record_step("x", step=1, wall_s=0.1)
    ttel.record_serve_request(tokens=3, request_id="r")
    ttel.heartbeat(1)
    assert ttel.summary()["events"] == {}
    assert ttel.flight_tail() == []
    # the two recorders are separate
    assert jtel._state is not ttel._state


def test_trainer_step_events_match_jax(both, tmp_path, monkeypatch):
    """``gluon.Trainer.step`` reports a ``step`` event, a heartbeat and a
    memwatch step boundary in both packages alike."""
    import numpy as np

    import mxnet_tpu as jmx
    from mxnet_tpu import autograd as jag
    from mxnet_tpu import gluon as jgluon
    from mxnet_tpu import memwatch as jmem
    from mxnet_tpu import nd as jnd
    import mxnet_tpu_torch as tmx
    from mxnet_tpu_torch import autograd as tag
    from mxnet_tpu_torch import gluon as tgluon
    from mxnet_tpu_torch import memwatch as tmem
    from mxnet_tpu_torch import nd as tnd

    monkeypatch.setenv("MX_MEMWATCH_EVERY", "2")
    # the port has no in-flight window yet (ROADMAP A.6): none in JAX
    monkeypatch.setenv("MX_ASYNC_INFLIGHT", "0")
    x = np.random.RandomState(0).randn(4, 3).astype(np.float32)
    y = np.zeros((4, 2), np.float32)
    runs = {}
    for name, mx, gluon, ag, nd, tel, mem, ctx in (
            ("jax", jmx, jgluon, jag, jnd, jtel, jmem, jmx.cpu()),
            ("torch", tmx, tgluon, tag, tnd, ttel, tmem, tmx.cpu())):
        d = str(tmp_path / name)
        mem.reset()
        tel.enable(d)
        net = gluon.nn.Dense(2, in_units=3)
        net.initialize(mx.init.Normal(0.5), ctx=ctx)
        trainer = gluon.Trainer(net.collect_params(), "sgd",
                                {"learning_rate": 0.1})
        for _ in range(4):
            with ag.record():
                loss = gluon.loss.L2Loss()(net(nd.array(x, ctx=ctx)),
                                           nd.array(y, ctx=ctx))
            loss.backward()
            trainer.step(4)
        tel.flush()
        # samples_per_sec is a rate of the host clock
        runs[name] = ([{k: v for k, v in e.items() if k != "samples_per_sec"}
                       for e in _events(tel, d) if e["kind"] == "step"],
                      mem.summary()["samples"],
                      os.path.exists(tel.heartbeat_path(d, 0)))
        mem.reset()
    assert runs["torch"] == runs["jax"]
    steps, samples, heartbeat = runs["torch"]
    assert [e["step"] for e in steps] == [1, 2, 3, 4]
    assert steps[0]["traced"] is True and samples == 2 and heartbeat
