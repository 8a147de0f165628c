"""The port's ``Context``, ``engine`` and the NDArray names scripts call
first, against the JAX package's, in one process.

Held to the JAX package: ``Context``'s equality, repr, fields and the
``with`` scope (which also places new arrays), ``cpu_pinned``,
``memory_stats`` on the CPU, ``nd.waitall`` / ``mx.waitall`` raising a
deferred failure after waiting on everything, ``MXNET_ENGINE_TYPE``'s
naive engine, and ``NDArray.T``, ``stype``, ``tostype``, ``version`` and
``wait_to_write``.  Departures held here: a port ``Context`` also equals
(and hashes as) the ``torch.device`` it names, and ``current_context()``
is ``gpu(0)`` outside a scope.  Everything is exact.
"""
import gc
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import engine as tengine
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.context import Context, resolve_device

CPU = tmx.cpu()


def _contexts(mx):
    return [mx.cpu(), mx.cpu(0), mx.cpu(1), mx.gpu(), mx.gpu(0), mx.gpu(1),
            mx.cpu_pinned(), mx.Context("cpu_shared", 2)]


def test_context_identity_matches_jax():
    js, ts = _contexts(jmx), _contexts(tmx)
    for j, t in zip(js, ts):
        assert isinstance(t, tmx.Context)
        assert repr(t) == repr(j) and str(t) == str(j) and f"{t}" == f"{j}"
        assert (t.device_type, t.device_id) == (j.device_type, j.device_id)
    for (j1, t1) in zip(js, ts):
        for (j2, t2) in zip(js, ts):
            assert (t1 == t2) == (j1 == j2), (t1, t2)
            assert (t1 != t2) == (j1 != j2), (t1, t2)
            if t1 == t2:
                assert hash(t1) == hash(t2)
    assert len(set(ts)) == len(set(js)) == 6
    for mx in (jmx, tmx):
        with pytest.raises(mx.MXNetError if mx is jmx else MXNetError):
            mx.Context("quantum", 0)
    assert tmx.Context(tmx.gpu(1)) == tmx.gpu(1)
    for t in ts:
        back = pickle.loads(pickle.dumps(t))
        assert back == t and repr(back) == repr(t)
        assert (back.device_type, back.device_id) == (t.device_type,
                                                      t.device_id)


def test_context_meets_torch_devices():
    """Departure: a Context is the torch device it names to torch."""
    assert tmx.cpu() == torch.device("cpu") == tmx.cpu_pinned()
    assert tmx.gpu(1) == torch.device("cuda", 1) != tmx.cpu()
    assert torch.device("cpu") == tmx.cpu()
    assert {torch.device("cpu"): 1}[tmx.cpu()] == 1
    assert {tmx.gpu(0): 2}[torch.device("cuda", 0)] == 2
    assert (tmx.cpu().type, tmx.cpu().index) == ("cpu", None)
    assert (tmx.gpu(1).type, tmx.gpu(1).index) == ("cuda", 1)
    assert torch.device(tmx.gpu(1)) == torch.device("cuda", 1)
    assert torch.zeros(2, device=tmx.cpu()).device.type == "cpu"
    assert torch.ones(2).to(tmx.cpu_pinned()).device.type == "cpu"
    assert resolve_device(tmx.cpu()) == torch.device("cpu")
    assert resolve_device("cpu") == resolve_device(torch.device("cpu"))
    arr = tnd.ones((2, 3), ctx=CPU)
    assert arr.context == CPU and isinstance(arr.context, Context)
    assert arr.as_in_context(tmx.cpu()) is arr
    assert tnd.array(np.ones(2), ctx=tmx.cpu_pinned()).context == CPU
    if not torch.cuda.is_available():
        assert tmx.num_gpus() == 0
        for ctx in (tmx.gpu(0), tmx.gpu(3)):
            with pytest.raises(MXNetError, match="no CUDA device"):
                resolve_device(ctx)
            with pytest.raises(MXNetError, match="no CUDA device"):
                tnd.zeros((2,), ctx=ctx)


def test_with_scope_matches_jax():
    for mx in (jmx, tmx):
        outer = mx.current_context()
        with mx.cpu(1) as c:
            assert c == mx.cpu(1) and mx.current_context() == mx.cpu(1)
            with mx.cpu_pinned():
                assert mx.current_context() == mx.cpu_pinned()
            assert mx.current_context() == mx.cpu(1)
        assert mx.current_context() == outer
    # outside a scope the port's context is the card (JAX's, the host)
    assert tmx.current_context() == tmx.gpu(0)
    assert tmx.nd.current_context() == tmx.gpu(0)
    with tmx.cpu():
        assert tnd.zeros((2,)).context == CPU
        assert tnd.array([1.0, 2.0]).context == CPU
        assert tmx.default_device() == torch.device("cpu")


def test_memory_stats_on_the_cpu_match_jax():
    assert tmx.cpu().memory_stats() == jmx.cpu().memory_stats()
    assert tmx.cpu().memory_stats()["available"] is False
    tmx.cpu().empty_cache()


class _Failing(tnd.NDArray):
    """An array whose device work failed: waiting on it raises."""
    __slots__ = ()

    def wait_to_read(self):
        raise RuntimeError("deferred boom")


class _JFailing(jnd.NDArray):
    __slots__ = ()

    def wait_to_read(self):
        raise RuntimeError("deferred boom")


def test_waitall_raises_a_deferred_failure(monkeypatch):
    """``nd.waitall`` and ``mx.waitall`` wait on everything and then raise
    the first failure, as the JAX barrier does: a failed array's (the JAX
    package tracks every array; the port, arrays given to
    ``engine.track``), and on the card a CUDA error that the device's
    synchronization raises; once the failure is gone the barrier
    passes."""
    for mx, make in ((jmx, lambda: _JFailing(jnd.ones((2,))._data)),
                     (tmx, lambda: _Failing(torch.zeros(2)))):
        nd = mx.nd
        good = nd.ones((3,), **({"ctx": CPU} if mx is tmx else {}))
        bad = make()
        if mx is tmx:
            tengine.track(bad)
        for barrier in (nd.waitall, mx.waitall):
            with pytest.raises(RuntimeError, match="deferred boom"):
                barrier()
        del bad
        gc.collect()
        nd.waitall()
        mx.waitall()
        assert good.asnumpy().tolist() == [1.0, 1.0, 1.0]
    synced = []

    def synchronize(i):
        synced.append(i)
        if i == 0:
            raise RuntimeError("CUDA error: an illegal memory access")

    for name, value in (("is_available", lambda: True),
                        ("is_initialized", lambda: True),
                        ("device_count", lambda: 2),
                        ("synchronize", synchronize)):
        monkeypatch.setattr(torch.cuda, name, value)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tmx.nd.waitall()
    assert synced == [0, 1]  # every card waited on before the raise


def test_naive_engine_runs_the_same_ops(monkeypatch):
    a = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    base = (tnd.array(a, ctx=CPU) * 2 + 1).asnumpy()
    assert not tengine.is_naive() and not jmx.engine.is_naive()
    for eng in (tengine, jmx.engine):
        monkeypatch.setattr(eng, "_ENGINE_TYPE", eng._ENGINE_TYPE)
        eng.set_engine_type("NaiveEngine")
        assert eng.is_naive()
    naive = (tnd.array(a, ctx=CPU) * 2 + 1).asnumpy()
    jnaive = (jnd.array(a) * 2 + 1).asnumpy()
    np.testing.assert_array_equal(naive, base)
    np.testing.assert_array_equal(naive, jnaive)


def test_ndarray_surface_matches_jax():
    a = np.random.RandomState(1).randn(3, 4).astype(np.float32)
    j, t = jnd.array(a), tnd.array(a, ctx=CPU)
    np.testing.assert_array_equal(t.T.asnumpy(), j.T.asnumpy())
    assert t.T.shape == j.T.shape == (4, 3)
    assert t.stype == j.stype == "default"
    assert t.tostype("default") is t and j.tostype("default") is j
    for stype in ("csr", "row_sparse"):
        ts, js = t.tostype(stype), j.tostype(stype)
        assert ts.stype == js.stype == stype
        np.testing.assert_array_equal(ts.asnumpy(), js.asnumpy())
    with pytest.raises(MXNetError, match="unknown storage"):
        t.tostype("dense")
    t.wait_to_write()
    j.wait_to_write()
    assert t.version == j.version == 0
    j[:] = 1.0
    t[:] = 1.0
    assert t.version == j.version == 1
    jo, to = jnd.zeros((3, 4)), tnd.zeros((3, 4), ctx=CPU)
    j.copyto(jo)
    t.copyto(to)
    assert to.version == jo.version == 1
    np.testing.assert_array_equal(to.asnumpy(), jo.asnumpy())


def test_top_level_names_match_jax():
    import mxnet_tpu_torch.models as tmodels
    from mxnet_tpu_torch import kvstore, optimizer, parallel

    assert tmx.NDArray is tnd.NDArray and tmx.KVStore is kvstore.KVStore
    assert tmx.lr_scheduler is optimizer.lr_scheduler
    assert tmx.parallel is parallel and tmx.models is tmodels
    assert tmx.contrib.amp is not None and tmx.engine is tengine
    assert tmx.current_context is tmx.context.current_context
    assert tmodels.bert_base is tmodels.bert.bert_base
    assert tmodels.label_smoothed_ce is tmodels.transformer.label_smoothed_ce
