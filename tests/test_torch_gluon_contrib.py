"""``gluon.contrib`` against the JAX package on the CPU: the contrib
layers (``SyncBatchNorm`` on one device, ``HybridConcurrent``,
``Concurrent``, ``Identity``), the contrib cells (the nine convolutional
recurrences, ``LSTMPCell``, ``VariationalDropoutCell``) unrolled from the
same weights and states, and the ``Estimator`` with each handler from
the same weights on the same batches.

Tolerances: outputs and states atol 1e-5 (f32, a few steps); the
Estimator's per-batch losses rtol 1e-5 and its final weights atol 1e-5
(SGD, four steps); handler counts, orders, file names and stop epochs
exactly.
"""
import logging
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from torch_fresh_names import fresh_jax_names  # noqa: F401

CPU = tmx.cpu()
ATOL = 1e-5


def carry(jblock, tblock):
    tblock.initialize(ctx=CPU)
    got = tblock.collect_params()
    for name, p in jblock.collect_params().items():
        got[name].set_data(tmx.nd.array(p.data().asnumpy(), ctx=CPU))


def arr(mx, a):
    return (tmx.nd.array(a, ctx=CPU, dtype=a.dtype) if mx is tmx
            else jmx.nd.array(a, dtype=a.dtype))


# ---------------------------------------------------------------------------
# contrib layers
# ---------------------------------------------------------------------------
def test_sync_batchnorm_is_batchnorm_on_one_device():
    x = np.random.RandomState(0).randn(4, 3, 5, 5).astype(np.float32)
    outs = {}
    for mx in (jmx, tmx):
        bn = mx.gluon.contrib.nn.SyncBatchNorm(in_channels=3, num_devices=1,
                                               prefix="sbn_")
        bn.initialize(**({"ctx": CPU} if mx is tmx else {}))
        with mx.autograd.record():
            y = bn(arr(mx, x))
        stats = {k.split("_", 1)[1]: p.data().asnumpy()
                 for k, p in bn.collect_params().items()}
        outs[mx.__name__] = (y.asnumpy(), stats)
    (ty, ts), (jy, js) = outs["mxnet_tpu_torch"], outs["mxnet_tpu"]
    np.testing.assert_allclose(ty, jy, atol=ATOL, rtol=0)
    assert sorted(ts) == sorted(js)
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], atol=ATOL, rtol=0)


@pytest.mark.parametrize("cls", ["HybridConcurrent", "Concurrent"])
def test_concurrent_and_identity_match_jax_and_export(tmp_path, cls):
    import json

    x = np.random.RandomState(1).randn(2, 6).astype(np.float32)
    blocks, outs = {}, {}
    for mx in (jmx, tmx):
        cnn = mx.gluon.contrib.nn
        net = getattr(cnn, cls)(axis=-1, prefix="conc_")
        with net.name_scope():
            net.add(mx.gluon.nn.Dense(4, in_units=6),
                    mx.gluon.nn.Dense(3, in_units=6), cnn.Identity())
        if mx is jmx:
            net.initialize(jmx.init.Xavier())
        else:
            carry(blocks["mxnet_tpu"], net)
        blocks[mx.__name__] = net
        outs[mx.__name__] = net(arr(mx, x)).asnumpy()
    assert outs["mxnet_tpu_torch"].shape == (2, 13)
    np.testing.assert_allclose(outs["mxnet_tpu_torch"], outs["mxnet_tpu"],
                               atol=ATOL, rtol=0)
    graphs = []
    for name, net in blocks.items():
        net.export(str(tmp_path / name), 0)
        g = json.load(open(tmp_path / f"{name}-symbol.json"))
        graphs.append([(n["op"], n["name"] if n["op"] == "null" else None,
                        n["inputs"]) for n in g["nodes"]])
    assert graphs[0] == graphs[1]


# ---------------------------------------------------------------------------
# contrib cells
# ---------------------------------------------------------------------------
CONV = [(d, kind) for d in (1, 2, 3) for kind in ("RNN", "LSTM", "GRU")]


def _unroll(mx, cell, x, states):
    out, st = cell.unroll(x.shape[1], arr(mx, x), layout="NTC",
                          merge_outputs=True,
                          begin_state=[arr(mx, s) for s in states])
    return out.asnumpy(), [s.asnumpy() for s in st]


def _pair(make):
    jcell = make(jmx)
    jcell.initialize(jmx.init.Xavier())
    tcell = make(tmx)
    return jcell, tcell


def _compare(jcell, tcell, x, states):
    want = _unroll(jmx, jcell, x, states)
    carry(jcell, tcell)
    got = _unroll(tmx, tcell, x, states)
    np.testing.assert_allclose(got[0], want[0], atol=ATOL, rtol=0)
    for g, w in zip(got[1], want[1]):
        np.testing.assert_allclose(g, w, atol=ATOL, rtol=0)


@pytest.mark.parametrize("dims,kind", CONV)
def test_conv_cells_unroll_like_jax(dims, kind):
    spatial = (6, 5, 4)[:dims]
    name = f"Conv{dims}D{kind}Cell"

    def make(mx):
        return getattr(mx.gluon.contrib.rnn, name)(
            (3,) + spatial, 4, 3, 3, i2h_pad=1, prefix="convc_")

    jcell, tcell = _pair(make)
    assert type(tcell).__name__ == name
    rng = np.random.RandomState(dims)
    x = rng.randn(2, 3, 3, *spatial).astype(np.float32)
    states = [rng.randn(*s["shape"]).astype(np.float32)
              for s in tcell.state_info(2)]
    assert [s["shape"] for s in tcell.state_info(2)] == \
        [s["shape"] for s in jcell.state_info(2)]
    _compare(jcell, tcell, x, states)


def test_lstmp_cell_unrolls_like_jax():
    def make(mx):
        return mx.gluon.contrib.rnn.LSTMPCell(8, 5, input_size=4,
                                              prefix="lstmp_")

    jcell, tcell = _pair(make)
    rng = np.random.RandomState(7)
    x = rng.randn(2, 4, 4).astype(np.float32)
    states = [rng.randn(2, 5).astype(np.float32),
              rng.randn(2, 8).astype(np.float32)]
    _compare(jcell, tcell, x, states)


def test_lstmp_cell_infers_its_input_size():
    cell = tmx.gluon.contrib.rnn.LSTMPCell(8, 5, prefix="lstmpd_")
    cell.initialize(ctx=CPU)
    x = np.zeros((2, 3, 6), np.float32)
    states = [np.zeros((2, 5), np.float32), np.zeros((2, 8), np.float32)]
    out, _ = _unroll(tmx, cell, x, states)
    assert out.shape == (2, 3, 5)
    assert cell.collect_params()["lstmpd_i2h_weight"].shape == (32, 6)


def test_variational_dropout_cell():
    """At rate 0 it is its base cell (against JAX); in training its masks
    are drawn once and shared by every step (a zeroed input column stays
    zeroed), and ``reset`` draws anew."""
    def make(mx):
        base = mx.gluon.rnn.GRUCell(6, input_size=5, prefix="vd_")
        return mx.gluon.contrib.rnn.VariationalDropoutCell(base, 0.0, 0.0,
                                                           0.0)

    jcell, tcell = _pair(make)
    rng = np.random.RandomState(8)
    x = rng.randn(2, 3, 5).astype(np.float32)
    states = [rng.randn(2, 6).astype(np.float32)]
    _compare(jcell, tcell, x, states)

    cell = tmx.gluon.contrib.rnn.VariationalDropoutCell(
        tmx.gluon.rnn.DropoutCell(0.0), drop_inputs=0.5)
    ones = np.ones((4, 6, 32), np.float32)
    with tmx.autograd.train_mode():
        out, _ = _unroll(tmx, cell, ones, [])
        first = cell._masks["inputs"].clone()
        assert np.all(out == out[:, :1]), "one mask for every step"
        assert 0.3 < float((out == 0).mean()) < 0.7
        _unroll(tmx, cell, ones, [])
    assert not torch.equal(first, cell._masks["inputs"])


# ---------------------------------------------------------------------------
# the Estimator
# ---------------------------------------------------------------------------
def _batches(n=4, b=8, seed=9):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, 10).astype(np.float32),
             rng.randint(0, 3, b).astype(np.float32)) for _ in range(n)]


def _estimator(mx, jnet=None):
    net = mx.gluon.nn.HybridSequential(prefix="est_")
    with net.name_scope():
        net.add(mx.gluon.nn.Dense(16, activation="relu", in_units=10),
                mx.gluon.nn.Dense(3, in_units=16))
    if jnet is None:
        net.initialize(jmx.init.Xavier())
    else:
        carry(jnet, net)
    trainer = mx.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
    est = mx.gluon.contrib.estimator.Estimator(
        net, mx.gluon.loss.SoftmaxCrossEntropyLoss(), trainer=trainer,
        context=mx.cpu())
    return est


class _Recorder:
    def __init__(self, mx):
        base = mx.gluon.contrib.estimator
        rec = self

        class Rec(base.BatchEnd, base.EpochEnd):
            def batch_end(self, estimator, *args, **kwargs):
                rec.losses.append(float(kwargs["loss"].mean().asscalar()))

            def epoch_end(self, estimator, *args, **kwargs):
                rec.epochs += 1

        self.losses, self.epochs, self.handler = [], 0, Rec()


def _data(mx, batches):
    return [(arr(mx, d), arr(mx, lb)) for d, lb in batches]


def _fit_both(train, val, make_handlers=(), **fit_kw):
    jest = _estimator(jmx)
    test = _estimator(tmx, jest.net)
    res = {}
    for mx, est in ((jmx, jest), (tmx, test)):
        rec = _Recorder(mx)
        handlers = [rec.handler] + [h(mx) for h in make_handlers]
        est.fit(_data(mx, train), val_data=_data(mx, val) if val else None,
                event_handlers=handlers, **fit_kw)
        res[mx.__name__] = (est, rec, handlers)
    return res["mxnet_tpu"], res["mxnet_tpu_torch"]


def test_fit_and_evaluate_match_jax():
    batches, val = _batches(), _batches(2, seed=10)
    (jest, jrec, _), (test, trec, _) = _fit_both(batches, val, epochs=2)
    assert len(trec.losses) == 8 and trec.epochs == 2
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=1e-5)
    for name, p in jest.net.collect_params().items():
        np.testing.assert_allclose(
            test.net.collect_params()[name].data().asnumpy(),
            p.data().asnumpy(), atol=ATOL, rtol=0)
    tval = test.evaluate(_data(tmx, val))
    jval = jest.evaluate(_data(jmx, val))
    assert sorted(tval) == sorted(jval)
    for k in jval:
        np.testing.assert_allclose(tval[k], jval[k], rtol=1e-5)
    for m_t, m_j in zip(test.train_metrics + [test.train_loss_metric],
                        jest.train_metrics + [jest.train_loss_metric]):
        assert m_t.get()[0] == m_j.get()[0]
        np.testing.assert_allclose(m_t.get()[1], m_j.get()[1], rtol=1e-5)


def test_default_handlers_in_the_jax_order():
    names = {}
    for mx in (jmx, tmx):
        est = _estimator(mx, None if mx is jmx else _estimator(jmx).net)
        hs = est._prepare_handlers([1], [], 2, None)
        names[mx.__name__] = [type(h).__name__ for h in hs]
    assert names["mxnet_tpu_torch"] == names["mxnet_tpu"] == [
        "MetricHandler", "ValidationHandler", "StoppingHandler",
        "LoggingHandler"]


def test_stopping_and_validation_handlers():
    evals = {}

    def counting_validation(mx):
        h = mx.gluon.contrib.estimator.ValidationHandler(
            [], lambda val_data: evals.setdefault(mx.__name__, []).append(1),
            epoch_period=None, batch_period=3)
        return h

    batches = _batches()
    (jest, jrec, _), (test, trec, _) = _fit_both(
        batches, [], batches=7, make_handlers=[counting_validation])
    assert len(trec.losses) == len(jrec.losses) == 7
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=1e-5)
    assert len(evals["mxnet_tpu_torch"]) == len(evals["mxnet_tpu"]) == 2


def test_logging_handler_lines(caplog):
    counts = {}
    for mx, logger in ((jmx, "mxnet_tpu.estimator"),
                       (tmx, "mxnet_tpu_torch.estimator")):
        est = _estimator(mx, None if mx is jmx else _estimator(jmx).net)
        caplog.clear()
        with caplog.at_level(logging.INFO, logger=logger):
            est.fit(_data(mx, _batches()), epochs=2, event_handlers=[
                mx.gluon.contrib.estimator.LoggingHandler(
                    log_interval=2, metrics=est.train_metrics)])
        counts[mx.__name__] = [r.getMessage().split(" ")[0]
                               for r in caplog.records]
    assert counts["mxnet_tpu_torch"] == counts["mxnet_tpu"]
    assert counts["mxnet_tpu_torch"].count("Epoch[0]") == 3


def test_checkpoint_handler_files_resume_and_load(tmp_path):
    files = {}
    for mx in (jmx, tmx):
        folder = tmp_path / mx.__name__
        est = _estimator(mx, None if mx is jmx else _estimator(jmx).net)
        monitor = est.train_loss_metric
        ck = mx.gluon.contrib.estimator.CheckpointHandler(
            str(folder), "m", monitor=monitor, save_best=True,
            batch_period=3, max_checkpoints=2)
        est.fit(_data(mx, _batches()), epochs=2, event_handlers=[ck])
        files[mx.__name__] = sorted(os.listdir(folder))
        resumed = mx.gluon.contrib.estimator.CheckpointHandler(
            str(folder), "m", resume_from_checkpoint=True)
        est2 = _estimator(mx, None if mx is jmx else _estimator(jmx).net)
        resumed.train_begin(est2)
        assert resumed.current_epoch == 2
    assert files["mxnet_tpu_torch"] == files["mxnet_tpu"]
    assert "m-best.params" in files["mxnet_tpu_torch"]
    # the port's last checkpoint loads back into a fresh net
    net = _estimator(tmx, _estimator(jmx).net).net
    net.load_parameters(str(tmp_path / "mxnet_tpu_torch" / "m-epoch2.params"),
                        ctx=CPU)
    assert all(np.isfinite(p.data().asnumpy()).all()
               for p in net.collect_params().values())


def test_early_stopping_handler_stops_where_jax_does():
    stopped = {}
    for mx in (jmx, tmx):
        est = _estimator(mx, None if mx is jmx else _estimator(jmx).net)
        acc = est.train_metrics[0]
        es = mx.gluon.contrib.estimator.EarlyStoppingHandler(
            acc, min_delta=10.0, patience=1, mode="max")
        rec = _Recorder(mx)
        est.fit(_data(mx, _batches()), epochs=6,
                event_handlers=[es, rec.handler])
        stopped[mx.__name__] = (es.stopped_epoch, rec.epochs)
    assert stopped["mxnet_tpu_torch"] == stopped["mxnet_tpu"] == (2, 2)
