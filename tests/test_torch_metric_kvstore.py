"""The port's ``metric`` and ``kvstore`` against the JAX package's.

Every metric is fed the same numpy labels and predictions (two batches,
``RandomState(0)``) in both packages, the port's as torch tensors and
NDArrays, the JAX one's as its NDArrays; the values agree within
``rtol=1e-6`` (both compute in numpy float64 from the same f32 inputs).
The kvstore is held to the JAX store on the same pushes: a list pushed
for one key is summed, pulls copy the stored value out, an installed
optimizer updates on push, and its states round-trip through a file;
exact in f32 for sums of two, ``rtol=1e-6`` through the optimizer.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import kvstore as jkv
from mxnet_tpu import metric as jmetric
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import kvstore as tkv
from mxnet_tpu_torch import metric as tmetric
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.base import MXNetError

CPU = tmx.cpu()
RNG = np.random.RandomState(0)
N, C = 12, 5
PROBS = [RNG.dirichlet(np.ones(C), N).astype(np.float32) for _ in range(2)]
CLASSES = [RNG.randint(0, C, N).astype(np.float32) for _ in range(2)]
REG_PRED = [RNG.randn(N, 3).astype(np.float32) for _ in range(2)]
REG_LABEL = [RNG.randn(N, 3).astype(np.float32) for _ in range(2)]
BIN_PRED = [RNG.dirichlet(np.ones(2), N).astype(np.float32)
            for _ in range(2)]
BIN_LABEL = [RNG.randint(0, 2, N).astype(np.float32) for _ in range(2)]
LOSSES = [RNG.rand(N).astype(np.float32) for _ in range(2)]


def _feval(label, pred):
    return float(np.abs(label - pred.argmax(-1)).mean())


METRICS = {
    "accuracy": (("accuracy",), {}, CLASSES, PROBS),
    "top_k": (("top_k_accuracy",), {"top_k": 3}, CLASSES, PROBS),
    "f1": (("f1",), {}, BIN_LABEL, BIN_PRED),
    "f1_micro": (("f1",), {"average": "micro"}, BIN_LABEL, BIN_PRED),
    "mae": (("mae",), {}, REG_LABEL, REG_PRED),
    "mse": (("mse",), {}, REG_LABEL, REG_PRED),
    "rmse": (("rmse",), {}, REG_LABEL, REG_PRED),
    "ce": (("ce",), {}, CLASSES, PROBS),
    "nll": (("nll_loss",), {}, CLASSES, PROBS),
    "perplexity": (("perplexity",), {"ignore_label": None}, CLASSES, PROBS),
    "pearson": (("pearsonr",), {}, REG_LABEL, REG_PRED),
    "loss": (("loss",), {}, LOSSES, LOSSES),
    "custom": ((_feval,), {"name": "cm"}, CLASSES, PROBS),
    "composite": ((["acc", "ce"],), {}, CLASSES, PROBS),
}


def _run(mod, args, kw, labels, preds, wrap):
    m = mod.create(*args, **kw)
    for lab, pred in zip(labels, preds):
        m.update([wrap(lab)], [wrap(pred)])
    return m.get()


@pytest.mark.parametrize("case", sorted(METRICS))
def test_metric_matches_jax(case):
    args, kw, labels, preds = METRICS[case]
    name_j, want = _run(jmetric, args, kw, labels, preds, jnd.array)
    for wrap in (torch.from_numpy, lambda a: tnd.array(a, ctx=CPU)):
        name_t, got = _run(tmetric, args, kw, labels, preds, wrap)
        assert name_t == name_j
        np.testing.assert_allclose(got, want, rtol=1e-6)


def test_metric_reset_and_registry():
    m = tmetric.create("acc")
    assert isinstance(m, tmetric.Accuracy)
    m.update(tnd.array(CLASSES[0], ctx=CPU), tnd.array(PROBS[0], ctx=CPU))
    assert m.num_inst == N
    m.reset()
    assert m.num_inst == 0 and np.isnan(m.get()[1])
    assert isinstance(tmetric.create(["acc", "mse"]),
                      tmetric.CompositeEvalMetric)
    with pytest.raises(MXNetError):
        tmetric.create("no_such_metric")
    bf16 = torch.from_numpy(PROBS[0]).to(torch.bfloat16)
    m.update([torch.from_numpy(CLASSES[0])], [bf16])
    assert m.num_inst == N


def _pair(store_type="device"):
    return jkv.create(store_type), tkv.create(store_type)


def test_kvstore_push_of_a_list_sums_it():
    jk, tk = _pair()
    a, b, c = (RNG.randn(4, 3).astype(np.float32) for _ in range(3))
    jk.init("w", jnd.array(a))
    tk.init("w", tnd.array(a, ctx=CPU))
    jk.push("w", [jnd.array(b), jnd.array(c)])
    tk.push("w", [tnd.array(b, ctx=CPU), tnd.array(c, ctx=CPU)])
    jout, tout = jnd.zeros((4, 3)), tnd.zeros((4, 3), ctx=CPU)
    jk.pull("w", out=jout)
    tk.pull("w", out=tout)
    np.testing.assert_array_equal(tout.asnumpy(), jout.asnumpy())
    np.testing.assert_array_equal(tout.asnumpy(), b + c)
    assert tk.type == "device" and tk.rank == 0 and tk.num_workers == 1


def test_kvstore_multi_key_pushpull_and_row_sparse_pull():
    jk, tk = _pair("local")
    vals = [RNG.randn(3).astype(np.float32) for _ in range(2)]
    jk.init([0, 1], [jnd.array(v) for v in vals])
    tk.init([0, 1], [tnd.array(v, ctx=CPU) for v in vals])
    upd = [RNG.randn(3).astype(np.float32) for _ in range(2)]
    touts = [tnd.zeros((3,), ctx=CPU) for _ in range(2)]
    jouts = [jnd.zeros((3,)) for _ in range(2)]
    jk.pushpull([0, 1], [jnd.array(u) for u in upd], out=jouts)
    tk.pushpull([0, 1], [tnd.array(u, ctx=CPU) for u in upd], out=touts)
    for t, j in zip(touts, jouts):
        np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())
    rs = tnd.zeros((3,), ctx=CPU)
    tk.row_sparse_pull(1, out=rs, row_ids=tnd.array([0], ctx=CPU))
    np.testing.assert_array_equal(rs.asnumpy(), upd[1])
    with pytest.raises(MXNetError):
        tk.pull(7, out=rs)


@pytest.mark.parametrize("fused", ["1", "0"])
def test_kvstore_set_optimizer_updates_on_push_and_states_round_trip(
        fused, monkeypatch, tmp_path):
    monkeypatch.setenv("MX_FUSED_UPDATE", fused)
    jk, tk = _pair()
    w0 = [RNG.randn(5).astype(np.float32) for _ in range(2)]
    grads = [[RNG.randn(5).astype(np.float32) for _ in range(2)]
             for _ in range(3)]
    for k, (mod, nd, kv) in enumerate(((jmx, jnd, jk), (tmx, tnd, tk))):
        ctx = {"ctx": CPU} if mod is tmx else {}
        kv.set_optimizer(mod.optimizer.create("adam", learning_rate=0.1))
        kv.init([0, 1], [nd.array(w, **ctx) for w in w0])
        for step, g in enumerate(grads):
            if step == 2:  # the states survive a save and load
                fname = str(tmp_path / f"states{k}")
                kv.save_optimizer_states(fname)
                kv.load_optimizer_states(fname)
            kv.push([0, 1], [nd.array(x, **ctx) for x in g])
    outs = []
    for nd, kv, ctx in ((jnd, jk, {}), (tnd, tk, {"ctx": CPU})):
        o = [nd.zeros((5,), **ctx) for _ in range(2)]
        kv.pull([0, 1], out=o)
        outs.append([x.asnumpy() for x in o])
    for t, j in zip(*outs):
        np.testing.assert_allclose(t, j, rtol=1e-6)


def test_kvstore_spanning_devices_raises():
    for name in ("nccl", "dist_sync", "dist_async"):
        with pytest.raises(MXNetError, match="A.9"):
            tkv.create(name)
    with pytest.raises(MXNetError, match="unknown"):
        tkv.create("nope")
    with pytest.raises(MXNetError, match="no updater"):
        tkv.create("local").save_optimizer_states("unused")
