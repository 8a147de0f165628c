"""The port's in-flight window against the JAX package's, in one process.

The one-process cases of ``tests/test_async_step.py``, each run on the
port (``device="cpu"``) and, where it drives a step, on the JAX
``DataParallelStep`` over a one-device CPU mesh: the losses and weights
are bit for bit the same across windows 0, 1 and 2 (and within 1e-6 of
the JAX step's, f32 sums in another order); the lazy handle and sync
mode; the window's bound; ``DevicePrefetchIter``'s epoch-end drain; a
deferred failure (a raising readback, or an event whose synchronize
raises as a CUDA error would) names the dispatching step; ``drain_all``
on the preemption path; the Trainer's and the Module's windows (bounded,
drained, no fence at 0, the same weights at every window).  Departure
held here: a failure in the step's Python code raises at dispatch.
"""
import jax
import numpy as np
import pytest
import torch

from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.parallel import DataParallelStep as JaxStep
from mxnet_tpu.parallel import local_mesh

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch import telemetry
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.parallel import (AsyncLoss, DataParallelStep,
                                      InflightRing, StepFence, drain_all,
                                      inflight_limit)
from mxnet_tpu_torch.parallel import async_loss as al

CPU = tmx.cpu()
RNG = np.random.RandomState(0)
W0 = {"weight": RNG.randn(4, 4).astype(np.float32) * 0.5,
      "bias": RNG.randn(4).astype(np.float32) * 0.1}
BATCHES = [(RNG.rand(8, 4).astype(np.float32),
            RNG.rand(8, 4).astype(np.float32)) for _ in range(8)]


@pytest.fixture
def tele(tmp_path):
    telemetry.reset()
    telemetry.enable(str(tmp_path / "tele"))
    yield telemetry
    telemetry.flush()
    telemetry.reset()


def _dense(gluon, ctx=None):
    net = gluon.nn.Dense(4, in_units=4, prefix="dense_")
    net.initialize(**({"ctx": ctx} if ctx is not None else {}))
    for name, p in net.collect_params().items():
        p.set_data(W0[name.split("_", 1)[1]])
    return net


def _build(optimizer="sgd"):
    return DataParallelStep(_dense(tgluon, CPU), tgluon.loss.L2Loss(),
                            optimizer=optimizer,
                            optimizer_params={"learning_rate": 0.1},
                            device=CPU)


def _run(monkeypatch, limit, n=6):
    monkeypatch.setenv("MX_ASYNC_INFLIGHT", str(limit))
    step = _build()
    handles = [step.step(x, y) for x, y in BATCHES[:n]]
    depth = step.inflight_depth
    step.drain()
    assert step.inflight_depth == 0
    weights = {k: v.detach().clone() for k, v in step.block.state_dict()
               .items()}
    return [h.asnumpy() for h in handles], weights, depth


def test_losses_and_weights_bitwise_identical_across_window_sizes(
        monkeypatch):
    sync_l, sync_w, depth0 = _run(monkeypatch, 0)
    assert depth0 == 0
    for limit in (1, 2):
        losses, weights, depth = _run(monkeypatch, limit)
        assert depth == limit
        for a, b in zip(sync_l, losses):
            assert np.array_equal(a, b), (limit, sync_l, losses)
        for k in sync_w:
            assert torch.equal(sync_w[k], weights[k]), (limit, k)
    jnet = _dense(jgluon)
    jstep = JaxStep(jnet, jgluon.loss.L2Loss(),
                    mesh=local_mesh(devices=[jax.devices("cpu")[0]]),
                    optimizer="sgd",
                    optimizer_params={"learning_rate": 0.1})
    jl = [jstep.step(jnd.array(x), jnd.array(y)) for x, y in BATCHES[:6]]
    jstep.drain()
    np.testing.assert_allclose(np.array(sync_l), [h.asnumpy() for h in jl],
                               rtol=1e-6)
    for name, a in jstep.params.items():
        np.testing.assert_allclose(
            sync_w[name.split("_", 1)[1]].numpy(), np.asarray(a),
            rtol=0, atol=1e-6, err_msg=name)


def test_step_returns_lazy_handle_and_sync_mode_forces(monkeypatch):
    monkeypatch.setenv("MX_ASYNC_INFLIGHT", "2")
    step = _build()
    x, y = BATCHES[0]
    h = step.step(x, y)
    assert isinstance(h, AsyncLoss) and h.step == 1
    # the CPU runs each op as it is called: nothing forced the handle
    assert not h.forced and step.inflight_depth == 1
    v = float(h)
    assert h.forced and np.isfinite(v)
    assert step.inflight_depth == 0
    assert float(np.asarray(h)) == v == h.asscalar() == h.item()
    assert int(h) == int(v) and bool(h) is bool(v)
    monkeypatch.setenv("MX_ASYNC_INFLIGHT", "0")
    assert inflight_limit() == 0
    h2 = step.step(x, y)
    assert isinstance(h2, AsyncLoss) and h2.forced and h2.step == 2
    assert step.inflight_depth == 0
    monkeypatch.setenv("MX_ASYNC_INFLIGHT", "junk")
    assert inflight_limit() == 2


def test_window_never_exceeds_limit(tele, monkeypatch):
    monkeypatch.setenv("MX_ASYNC_INFLIGHT", "2")
    step = _build()
    for x, y in BATCHES:
        step.step(x, y)
        assert step.inflight_depth <= 2
    events = [e for e in tele.flight_tail(50) if e["kind"] == "step"]
    depths = [e["inflight_depth"] for e in events]
    assert len(depths) == 8 and max(depths) == 2, depths
    assert [e["step"] for e in events] == list(range(1, 9))
    assert events[0]["traced"] and not events[1]["traced"]
    step.drain()
    assert step.inflight_depth == 0
    row = [v for k, v in tele.summary()["steps"].items()
           if k.startswith("DataParallelStep:Dense#")][0]
    assert row["count"] == 8 and row["block_wait_ms"] >= 0.0
    names = set(tele.summary()["spans"])
    assert {"train_step", "input_stage", "dispatch"} <= names


def test_drain_on_epoch_end_via_device_prefetcher(monkeypatch):
    monkeypatch.setenv("MX_ASYNC_INFLIGHT", "4")
    step = _build()
    rng = np.random.RandomState(0)
    it = tmx.io.NDArrayIter(rng.rand(32, 4).astype(np.float32),
                            rng.rand(32, 4).astype(np.float32),
                            batch_size=8, ctx=CPU)
    dit = tmx.io.DevicePrefetchIter(it, step)
    n = 0
    for b in dit:
        step.step(b.data[0], b.label[0])
        n += 1
        assert step.inflight_depth <= 4
    assert n == 4
    assert step.inflight_depth == 0
    dit.reset()
    assert sum(1 for _ in dit) == 4 and step.inflight_depth == 0


class _BadEvent:
    """Stands for a CUDA event behind failed work: synchronize raises."""

    def synchronize(self):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")


def test_deferred_error_names_dispatching_step():
    def boom(_value):
        raise RuntimeError("kaboom")

    ring = InflightRing("X")
    h = AsyncLoss(object(), step=7, executor="DataParallelStep:Net#9",
                  ring=ring, host_fn=boom)
    ring.admit(h)
    with pytest.raises(MXNetError) as ei:
        h.wait()
    msg = str(ei.value)
    assert "step 7" in msg and "DataParallelStep:Net#9" in msg
    assert "kaboom" in msg
    with pytest.raises(MXNetError):
        float(h)
    assert ring.depth == 0
    ring2 = InflightRing("Y")
    bad = AsyncLoss(object(), step=1, executor="Y", ring=ring2, host_fn=boom)
    ring2.admit(bad)
    with pytest.raises(MXNetError):
        ring2.make_room(1)
    assert ring2.depth == 0 and ring2.make_room(1) == 0.0
    # the card's path: the event recorded behind the step raises
    ring3 = InflightRing("Z")
    h3 = AsyncLoss(torch.tensor(1.5), step=4, executor="Z", ring=ring3)
    h3._event = _BadEvent()
    ring3.admit(h3)
    with pytest.raises(MXNetError, match="async step 4 dispatched by Z.*"
                                         "illegal memory access"):
        ring3.drain()
    assert ring3.depth == 0
    fence = StepFence([torch.zeros(2)], step=5, executor="F", ring=ring3)
    fence._events = [_BadEvent()]
    ring3.admit(fence)
    with pytest.raises(MXNetError, match="async step 5 dispatched by F"):
        fence.wait()


def test_python_failures_raise_at_dispatch(monkeypatch):
    """Departure: a failure in the step's own code (here a label of the
    wrong shape) raises at ``step``, at any window."""
    for limit in ("0", "2"):
        monkeypatch.setenv("MX_ASYNC_INFLIGHT", limit)
        step = _build()
        with pytest.raises(RuntimeError):
            step.step(BATCHES[0][0], np.zeros((3, 2), np.float32))
        assert step.inflight_depth == 0 and step.num_update == 0


def test_drain_all_preemption_path(monkeypatch):
    monkeypatch.setenv("MX_ASYNC_INFLIGHT", "4")
    step = _build()
    for x, y in BATCHES[:3]:
        step.step(x, y)
    assert step.inflight_depth == 3
    assert drain_all() == []
    assert step.inflight_depth == 0
    ring = InflightRing("Z")
    ring.admit(AsyncLoss(object(), step=3, executor="Z", ring=ring,
                         host_fn=lambda v: (_ for _ in ()).throw(
                             RuntimeError("dead"))))
    errs = drain_all()
    assert len(errs) == 1 and "step 3" in str(errs[0])
    assert ring.depth == 0
    assert al._pending_arrays(ring) == []


def _trainer_run(monkeypatch, limit, tele=None, n=5):
    monkeypatch.setenv("MX_ASYNC_INFLIGHT", str(limit))
    net = _dense(tgluon, CPU)
    trainer = tgluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.01})
    loss_fn = tgluon.loss.L2Loss()
    depths = []
    for x, y in BATCHES[:n]:
        with tag.record():
            loss = loss_fn(net(tnd.array(x, ctx=CPU)), tnd.array(y, ctx=CPU))
        loss.backward()
        trainer.step(8)
        depths.append(0 if trainer._inflight is None
                      else trainer._inflight.depth)
    trainer.drain()
    return trainer, depths, {k: v.detach().clone()
                             for k, v in net.state_dict().items()}


def test_trainer_window_bounded_and_drains(tele, monkeypatch):
    trainer, depths, w2 = _trainer_run(monkeypatch, 2)
    assert depths == [1, 2, 2, 2, 2]
    steps = [e["inflight_depth"] for e in tele.flight_tail(50)
             if e["kind"] == "step" and e["executor"] == "Trainer"]
    assert steps == [1, 2, 2, 2, 2]
    assert trainer._inflight.depth == 0
    _, _, w0 = _trainer_run(monkeypatch, 0)
    for k in w0:
        assert torch.equal(w0[k], w2[k]), k


def test_trainer_sync_mode_adds_no_fences(monkeypatch):
    trainer, depths, _ = _trainer_run(monkeypatch, 0, n=1)
    assert trainer._inflight is None and depths == [0]
    trainer.drain()


def _module_run(monkeypatch, limit, bucketing=False):
    monkeypatch.setenv("MX_ASYNC_INFLIGHT", str(limit))
    sym = tmx.sym
    data, label = sym.var("data"), sym.var("softmax_label")
    out = sym.LinearRegressionOutput(
        sym.FullyConnected(data, num_hidden=4, name="fc"), label)
    args = {"fc_weight": tnd.array(W0["weight"], ctx=CPU),
            "fc_bias": tnd.array(W0["bias"], ctx=CPU)}
    if bucketing:
        mod = tmx.mod.BucketingModule(
            lambda key: (out, ("data",), ("softmax_label",)),
            default_bucket_key=8, context=CPU)
    else:
        mod = tmx.mod.Module(out, context=CPU)
    mod.bind(data_shapes=[("data", (8, 4))],
             label_shapes=[("softmax_label", (8, 4))])
    mod.init_params(arg_params=args)
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1})
    depths = []
    inner = mod._buckets[8] if bucketing else mod
    for x, y in BATCHES[:4]:
        mod.forward_backward(tmx.io.DataBatch([tnd.array(x, ctx=CPU)],
                                              [tnd.array(y, ctx=CPU)]))
        mod.update()
        ring = getattr(inner, "_inflight", None)
        depths.append(0 if ring is None else ring.depth)
    mod.drain()
    ring = getattr(inner, "_inflight", None)
    assert ring is None or ring.depth == 0
    arg, _ = mod.get_params()
    return depths, {k: v.asnumpy() for k, v in arg.items()}, ring


@pytest.mark.parametrize("bucketing", [False, True])
def test_module_window_and_drain(monkeypatch, bucketing):
    depths, w2, ring = _module_run(monkeypatch, 2, bucketing)
    assert depths == [1, 2, 2, 2] and ring is not None
    depths0, w0, ring0 = _module_run(monkeypatch, 0, bucketing)
    assert depths0 == [0, 0, 0, 0] and ring0 is None
    for k in w0:
        assert np.array_equal(w0[k], w2[k]), k
