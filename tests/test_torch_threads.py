"""What two serving replicas in one process need from the port: kernel
launch counts that add up across threads, one build per source however
many threads ask for it first, and the run loop's one-spin tolerance for
a request submitted from another thread between admission and the queue
check."""
import importlib
import sys
import threading
import time

import numpy as np
import pytest
import torch

from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.models.transformer import Transformer
from mxnet_tpu_torch.ops.kernels import _build
from mxnet_tpu_torch.serving import Request, ServingEngine, TransformerAdapter

THREADS = 8
# the modules (the package's attributes of these names are the wrappers)
ln_mod = importlib.import_module("mxnet_tpu_torch.ops.kernels.layer_norm")
pa_mod = importlib.import_module(
    "mxnet_tpu_torch.ops.kernels.paged_attention")


def test_launch_counts_exact_from_8_threads(monkeypatch):
    """The plain path from 8 threads, each call counted the way a kernel
    launch is (``_build.count_launch``): the totals are exact."""
    calls = 400

    def counted(wrapper, ref):
        def run(*a, **k):
            _build.count_launch(wrapper)
            return ref(*a, **k)
        return run

    monkeypatch.setattr(ln_mod, "layer_norm_ref",
                        counted(ln_mod.layer_norm, ln_mod.layer_norm_ref))
    monkeypatch.setattr(pa_mod, "paged_decode_attention_ref",
                        counted(pa_mod.paged_decode_attention,
                                pa_mod.paged_decode_attention_ref))
    monkeypatch.setattr(ln_mod.layer_norm, "launches", 0)
    monkeypatch.setattr(pa_mod.paged_decode_attention, "launches", 0)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 16, generator=g)
    gamma, beta = torch.ones(16), torch.zeros(16)
    q = torch.randn(2, 2, 8, generator=g)
    kp = torch.randn(3, 4, 2, 8, generator=g)
    vp = torch.randn(3, 4, 2, 8, generator=g)
    table = torch.tensor([[1, 2], [2, 0]], dtype=torch.int32)
    lengths = torch.tensor([5, 3], dtype=torch.int32)
    want_ln = ln_mod.layer_norm_ref(x, gamma, beta)[0]
    ln_mod.layer_norm.launches = 0
    barrier = threading.Barrier(THREADS)
    errors = []

    def work():
        try:
            barrier.wait()
            for _ in range(calls):
                out = ln_mod.layer_norm(x, gamma, beta)[0]
                pa_mod.paged_decode_attention(q, kp, vp, table, lengths)
            assert torch.equal(out, want_ln)
        except BaseException as e:  # noqa: BLE001 — reported below
            errors.append(e)

    threads = [threading.Thread(target=work) for _ in range(THREADS)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as possible
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert ln_mod.layer_norm.launches == THREADS * calls
    assert pa_mod.paged_decode_attention.launches == THREADS * calls


def test_first_build_runs_once_across_threads(monkeypatch):
    """Eight first uses of one source at once run nvcc once: the sources
    still to build are read under the build lock."""
    started = []

    def fake_start(name):
        started.append(name)
        time.sleep(0.05)  # every other thread queues on the lock meanwhile
        return f"/nonexistent/{name}.so", None

    monkeypatch.setattr(_build, "_start", fake_start)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    monkeypatch.setattr(_build, "_libs", {})
    barrier = threading.Barrier(THREADS)
    got = []

    def first_use():
        barrier.wait()
        got.append(_build.load("probe_source"))

    threads = [threading.Thread(target=first_use) for _ in range(THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert started == ["probe_source"]
    assert got == [("lib", "/nonexistent/probe_source.so")] * THREADS


def _engine(**kw):
    net = Transformer(16, units=32, hidden_size=64, num_heads=4,
                      num_layers=1, max_length=32, dropout=0.0, device="cpu",
                      generator=torch.Generator().manual_seed(0))
    return ServingEngine(TransformerAdapter(net, src_max_len=6), slots=2,
                         page_size=4, max_len=12, device="cpu", **kw)


def _req(rid):
    return Request(np.array([3, 4, 5], np.int32), max_new_tokens=6,
                   bos_id=1, eos_id=2, request_id=rid)


def test_run_tolerates_one_spin_for_a_concurrent_submit():
    """A request submitted from another thread after ``_admit_ready``
    found the queue empty, but before the depth check, is served on the
    next pass instead of raising."""
    eng = _engine()
    want = _engine().serve([_req("ref")])["ref"]
    late = _req("late")
    orig = eng._admit_ready
    fired = []

    def admit_then_submit():
        n = orig()
        if not fired:
            fired.append(True)
            t = threading.Thread(target=eng.submit, args=(late,))
            t.start()
            t.join(timeout=60)
            assert not t.is_alive()
        return n

    eng._admit_ready = admit_then_submit
    eng.run()
    assert fired and late.stream.finished
    np.testing.assert_array_equal(late.stream.asarray(), want)
    assert not eng._running


def test_run_still_raises_when_nothing_can_be_admitted():
    """The spin is tolerated once: a request no pass can admit (a pool
    without a free page) still raises."""
    eng = _engine(pool_pages=2)  # the trash page and one more
    assert eng._cache.alloc("hog", 1)  # now no page is free
    eng.submit(_req("stuck"))
    with pytest.raises(MXNetError, match="no request admissible"):
        eng.run()
    assert not eng._running
