"""The port's memory watchdog: the census over registered torch tensors,
the leak detector, and the OOM post-mortem, whose events carry the JAX
package's fields (``tools/mem_report.py`` reads both)."""
import gc
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mxnet_tpu import memwatch as jmem
from mxnet_tpu import telemetry as jtel
from mxnet_tpu_torch import memwatch, telemetry
from mxnet_tpu_torch.context import normalize_memory_stats

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def tele(tmp_path, monkeypatch):
    monkeypatch.setenv("MX_MEMWATCH_EVERY", "1")
    telemetry.reset()
    memwatch.reset()
    telemetry.enable(str(tmp_path / "torch"))
    yield str(tmp_path / "torch")
    telemetry.reset()
    memwatch.reset()


class _Holder:
    def __init__(self, *tensors):
        self.tensors = list(tensors)


def _events(directory, kind):
    telemetry.flush()
    with open(telemetry.event_path(directory, 0)) as f:
        return [e for e in map(json.loads, f) if e["kind"] == kind]


def test_census_counts_registered_cpu_tensors(tele):
    gc.collect()  # providers of earlier tests' dead objects retire
    base = memwatch.census()["total_bytes"]
    a = torch.zeros((64, 32), dtype=torch.float32)
    b = torch.zeros((100,), dtype=torch.bfloat16)
    c = torch.zeros((7, 3), dtype=torch.int32)
    w = _Holder(a, b)
    o = _Holder(c, a[:8])            # a view of a: its storage counts once
    h = _Holder(np.zeros((5,), np.float64))
    memwatch.register("weights", w, lambda x: x.tensors)
    memwatch.register("opt", o, lambda x: x.tensors)
    memwatch.register("host", h, lambda x: x.tensors)
    cen = memwatch.census()
    assert cen["categories"]["weights"] == {
        "count": 2, "nbytes": a.nbytes + b.nbytes}
    assert cen["categories"]["opt"] == {"count": 1, "nbytes": c.nbytes}
    assert cen["host_bytes"] == {"host": 40}
    assert cen["total_bytes"] - base == a.nbytes + b.nbytes + c.nbytes
    assert "other" not in cen["categories"]  # no card in use
    del w
    assert "weights" not in memwatch.census()["categories"]


def test_sample_event_fields_match_jax(tele, tmp_path):
    gc.collect()
    base = memwatch.census()["total_bytes"]
    keep = _Holder(torch.ones(1024))
    memwatch.register("probe", keep, lambda x: x.tensors)
    ev = memwatch.sample("step", step=3)
    assert ev["categories"]["probe"]["nbytes"] == 4096
    assert ev["live_bytes"] - base == 4096
    assert ev["watermark_bytes"] == ev["live_bytes"]
    jd = str(tmp_path / "jax")
    jtel.reset()
    jmem.reset()
    try:
        jtel.enable(jd)
        jev = jmem.sample("step", step=3)
    finally:
        jtel.reset()
        jmem.reset()
    # the CPU has no allocator stats in either package
    assert set(ev) == set(jev)
    assert memwatch.device_memory()["available"] is False
    assert normalize_memory_stats(None)["available"] is False
    assert normalize_memory_stats({"bytes_in_use": 5}) == {
        "bytes_in_use": 5, "peak_bytes_in_use": 5, "bytes_limit": 0,
        "available": True}
    assert memwatch.summary()["samples"] == 1
    assert memwatch.peak_bytes() == ev["live_bytes"]


def test_leak_detector_fires_on_a_growing_provider(tele, monkeypatch):
    monkeypatch.setenv("MX_MEMWATCH_LEAK_WINDOW", "4")
    grow = _Holder()
    memwatch.register("cache", grow, lambda x: x.tensors)
    for _ in range(6):
        grow.tensors.append(torch.zeros(1 << 16))  # 256 KiB a step
        memwatch.on_step()
    leaks = _events(tele, "mem_leak")
    assert len(leaks) == 1  # warns once while the growth lasts
    assert leaks[0]["category"] == "cache" and leaks[0]["window"] == 4
    assert memwatch.summary()["leak"]["active"] is True
    out = subprocess.run([sys.executable, "tools/mem_report.py", tele,
                          "--json", "--window", "4"], cwd=_REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 3, out.stderr  # the leak is an anomaly
    assert json.loads(out.stdout)["anomalies"]


def test_steady_provider_reports_clean(tele):
    keep = _Holder(torch.zeros(4096))
    memwatch.register("serving", keep, lambda x: x.tensors)
    for _ in range(14):
        memwatch.on_step()
    assert not _events(tele, "mem_leak")
    out = subprocess.run([sys.executable, "tools/mem_report.py", tele,
                          "--json"], cwd=_REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    rep = json.loads(out.stdout)
    assert rep["num_ranks"] == 1 and not rep["anomalies"]


def test_oom_report_fields_match_jax(tele, tmp_path):
    gc.collect()
    keep = _Holder(torch.zeros(1 << 20))  # the largest category here
    memwatch.register("probe", keep, lambda x: x.tensors)
    err = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 2.00 GiB")
    assert memwatch.is_resource_exhausted(err)
    assert memwatch.is_resource_exhausted(
        RuntimeError("RESOURCE_EXHAUSTED: injected"))
    assert not memwatch.is_resource_exhausted(RuntimeError("other"))
    memwatch.emit_oom_report(executor="ServingEngine", step=7,
                             inflight_depth=2)
    memwatch.emit_oom_report(executor="ServingEngine", step=8)  # once only
    reports = _events(tele, "oom_report")
    assert len(reports) == 1
    rep = reports[0]
    assert rep["largest_category"] == "probe" and rep["step"] == 7
    assert rep["categories"]["probe"] == 4 << 20
    jd = str(tmp_path / "jax")
    jtel.reset()
    jmem.reset()
    try:
        jtel.enable(jd)
        jmem.emit_oom_report(executor="ServingEngine", step=7,
                             inflight_depth=2)
        with open(jtel.event_path(jd, 0)) as f:
            jrep = [e for e in map(json.loads, f)
                    if e["kind"] == "oom_report"][0]
    finally:
        jtel.reset()
        jmem.reset()
    assert set(rep) == set(jrep)
    assert memwatch.summary()["oom_reported"] is True


def test_disabled_without_recorder():
    telemetry.reset()
    memwatch.reset()
    assert not memwatch.enabled()
    assert memwatch.sample("step") is None
    memwatch.emit_oom_report()
    assert memwatch.summary()["samples"] == 0
    assert memwatch.fingerprint(("a", (1, 2))) == jmem.fingerprint(
        ("a", (1, 2)))
