"""The port's ``mx.profiler`` against the JAX package's.

The four cases of ``tests/test_profiler.py`` run against the port as
written there (the table's header and columns, the ranked json rows,
``CachedOp:<class>``, ``reset``, "no per-op stats").  Then one Gluon
training step, hybridized and not, profiled in both packages: the same
row names with the same call counts (the port's layers call their ops
without the registry, so each op function is a site; a call through the
registry counts once; a hybridized block is one ``CachedOp`` row with no
op rows from inside it, as the JAX package traces those).  Times are
not compared: they are each package's own wall clock.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon, nd, profiler
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import DataParallelStep

CPU = mx.cpu()
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _stopped():
    yield
    profiler.stop()
    profiler.reset_stats()


def _resnet_ish():
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Conv2D(8, 3, padding=1), gluon.nn.BatchNorm(),
            gluon.nn.Activation("relu"), gluon.nn.MaxPool2D(2),
            gluon.nn.GlobalAvgPool2D(), gluon.nn.Dense(10))
    net.initialize(mx.init.Xavier(), ctx=CPU)
    return net


def test_dumps_ranks_ops_for_model_step(tmp_path):
    profiler.reset_stats()
    profiler.set_config(filename=str(tmp_path / "prof.json"),
                        profile_all=True)
    net = _resnet_ish()
    x = nd.array(np.random.rand(2, 3, 16, 16).astype(np.float32), ctx=CPU)
    net(x)  # resolve deferred init outside the profile window
    profiler.start()
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    y = nd.array(np.random.randint(0, 10, 2).astype(np.float32), ctx=CPU)
    with autograd.record():
        loss = loss_fn(net(x), y)
    loss.backward()
    profiler.stop()
    table = profiler.dumps()
    assert "Profile Statistics" in table
    for op_name in ("Convolution", "BatchNorm", "Pooling", "FullyConnected"):
        assert op_name in table, table
    assert "Calls" in table and "Total(ms)" in table
    rows = json.loads(profiler.dumps(format="json"))
    totals = [r["total_ms"] for r in rows]
    assert totals == sorted(totals, reverse=True), totals
    counts = [r["count"] for r in json.loads(
        profiler.dumps(format="json", sort_by="count", ascending=True))]
    assert counts == sorted(counts)
    # one trace segment, a Chrome trace of the window
    seg = profiler.dump()
    assert os.path.dirname(seg[-1]) == str(tmp_path / "prof_torch_trace")
    with open(seg[-1]) as f:
        assert json.load(f)["traceEvents"]
    profiler.set_config(profile_all=False)


def test_dumps_includes_cached_op(tmp_path):
    profiler.reset_stats()
    profiler.set_config(filename=str(tmp_path / "prof2.json"))
    net = _resnet_ish()
    net.hybridize()
    x = nd.array(np.random.rand(2, 3, 16, 16).astype(np.float32), ctx=CPU)
    net(x)  # the first call outside the window
    profiler.start()
    net(x)
    profiler.stop()
    table = profiler.dumps(reset=True)
    assert "CachedOp:HybridSequential" in table
    assert "no per-op stats" in profiler.dumps()


def test_profiled_cached_op_with_nested_outputs(tmp_path):
    cell = gluon.rnn.LSTMCell(8, input_size=4)
    cell.initialize(mx.init.Xavier(), ctx=CPU)
    cell.hybridize()
    x = nd.array(np.random.rand(2, 4).astype(np.float32), ctx=CPU)
    states = cell.begin_state(2, ctx=CPU)
    cell(x, states)
    profiler.set_config(filename=str(tmp_path / "prof3.json"))
    profiler.start()
    out, new_states = cell(x, states)
    profiler.stop()
    assert "CachedOp:LSTMCell" in profiler.dumps(reset=True)
    assert np.isfinite(out.asnumpy()).all()
    assert len(new_states) == 2


def test_stats_not_collected_when_stopped():
    profiler.reset_stats()
    x = nd.array(np.random.rand(4, 4).astype(np.float32), ctx=CPU)
    (x + x).asnumpy()
    _resnet_ish()(nd.array(np.random.rand(1, 3, 8, 8).astype(np.float32),
                           ctx=CPU))
    assert "no per-op stats" in profiler.dumps()
    assert profiler.dumps(format="json") == "[]"
    assert profiler.state() == "stopped" and not profiler.is_recording()


# ---------------------------------------------------------------------------
# the same step in both packages
# ---------------------------------------------------------------------------
def _text_net(pkg, port):
    g = pkg.gluon
    net = g.nn.HybridSequential(prefix="pt_")
    with net.name_scope():
        net.add(g.nn.Embedding(20, 8),
                g.nn.LayerNorm(in_channels=8) if port else g.nn.LayerNorm(),
                g.nn.Dense(16, flatten=False, activation="relu",
                           **({"in_units": 8} if port else {})),
                g.nn.Dense(4, flatten=False,
                           **({"in_units": 16} if port else {})))
    return net


def _conv_net(pkg, port):
    g = pkg.gluon
    net = g.nn.HybridSequential(prefix="pc_")
    with net.name_scope():
        net.add(g.nn.Conv2D(8, 3, padding=1), g.nn.Activation("relu"),
                g.nn.MaxPool2D(2), g.nn.Dense(10))
    return net


def _profiled_rows(pkg, port, build, x, hybrid, tmp_path):
    kw = {"ctx": pkg.cpu()} if port else {}
    net = build(pkg, port)
    net.initialize(pkg.init.Xavier(), **kw)
    if hybrid:
        net.hybridize()
    xn = pkg.nd.array(x, **kw)
    net(xn)
    prof = pkg.profiler
    prof.reset_stats()
    prof.set_config(filename=str(tmp_path / f"pp{int(port)}.json"))
    prof.start()
    with pkg.autograd.record():
        out = net(xn)
        loss = (out * out).mean()
    loss.backward()
    prof.stop()
    return sorted((r["name"], r["count"]) for r in json.loads(
        prof.dumps(format="json", reset=True)))


@pytest.mark.parametrize("hybrid", [False, True])
@pytest.mark.parametrize("kind", ["text", "conv"])
def test_rows_and_counts_equal_jax(kind, hybrid, tmp_path):
    rng = np.random.RandomState(0)
    build, x = ((_text_net, rng.randint(0, 20, (2, 5)).astype(np.float32))
                if kind == "text" else
                (_conv_net, rng.rand(2, 3, 8, 8).astype(np.float32)))
    got = _profiled_rows(mx, True, build, x, hybrid, tmp_path)
    want = _profiled_rows(jmx, False, build, x, hybrid, tmp_path)
    assert got == want
    names = {n for n, _ in got}
    if hybrid:
        assert "CachedOp:HybridSequential" in names
        assert not names & {"FullyConnected", "Convolution", "Embedding"}


def test_step_is_one_row_and_kernel_sites_count_once(tmp_path):
    """``DataParallelStep`` is one ``FusedStep:<class>`` row (the JAX
    step's label), and an op reached through the registry and its
    function is counted once."""
    net = _text_net(mx, True)
    net.initialize(mx.init.Xavier(), ctx=CPU)
    step = DataParallelStep(net, gluon.loss.L2Loss(), optimizer="sgd",
                            device=CPU)
    x = np.random.RandomState(1).randint(0, 20, (2, 5)).astype(np.float32)
    y = np.zeros((2, 5, 4), np.float32)
    step.step(x, y)
    profiler.set_config(filename=str(tmp_path / "step.json"))
    profiler.start()
    step.step(x, y)
    a = nd.array(np.ones((3, 8), np.float32), ctx=CPU)
    nd.LayerNorm(a, nd.ones((8,), ctx=CPU), nd.zeros((8,), ctx=CPU))
    profiler.stop()
    rows = {r["name"]: r["count"]
            for r in json.loads(profiler.dumps(format="json"))}
    assert rows == {"FusedStep:HybridSequential": 1, "LayerNorm": 1}


def test_scope_task_pause_resume_segments(tmp_path):
    profiler.set_config(filename=str(tmp_path / "seg.json"))
    profiler.start()
    with profiler.scope("outer"):
        task = profiler.Task(name="inner")
        task.start()
        (nd.ones((2, 2), ctx=CPU) * 2).asnumpy()
        task.stop()
    profiler.pause()
    assert profiler.state() == "stopped"
    profiler.resume()
    assert profiler.state() == "running"
    (nd.ones((2, 2), ctx=CPU) + 1).asnumpy()
    segs = profiler.dump()
    # numbered across the process, as the JAX profiler numbers them
    n = len(segs)
    assert [os.path.basename(s) for s in segs[-2:]] == [
        f"segment-{n - 2:03d}.json", f"segment-{n - 1:03d}.json"]
    with open(segs[-2]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"outer", "inner"} <= names
    assert "trace segments:" in profiler.dumps()
    assert profiler.Frame is profiler.Task and profiler.Marker is profiler.Task
    with pytest.raises(MXNetError, match="unsupported dumps format"):
        profiler.dumps(format="csv")


def test_autostart_from_the_environment(tmp_path):
    code = ("import mxnet_tpu_torch as mx; print(mx.profiler.state()); "
            "mx.profiler.stop()")
    env = dict(os.environ, MXNET_PROFILER_AUTOSTART="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=dict(env, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "running"


def test_segment_starts_with_the_prime(monkeypatch, tmp_path):
    """With a card, ``start()`` opens the torch.profiler session and then
    launches the prime (PRIME_KERNELS one-element adds in a
    ``mx.profiler.prime`` range), before any op is recorded; the prime's
    ops are in the trace and not in the aggregate."""
    import torch

    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(profiler, "_prime", lambda dev: calls.append(
        (str(dev), profiler._prof is not None, profiler.is_recording())))
    profiler.set_config(filename=str(tmp_path / "p.json"))
    profiler.reset_stats()
    real = torch.profiler.profile
    monkeypatch.setattr(torch.profiler, "profile", lambda activities: real(
        activities=[torch.profiler.ProfilerActivity.CPU]))
    profiler.start()
    profiler.stop()
    assert calls == [("cuda:0", True, False)]
    monkeypatch.undo()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        profiler._prime(torch.device("cpu"))
    names = [e.name for e in prof.events()]
    assert names.count("mx.profiler.prime") == 1
    assert names.count("aten::add_") == profiler.PRIME_KERNELS
    assert json.loads(profiler.dumps(format="json")) == []
