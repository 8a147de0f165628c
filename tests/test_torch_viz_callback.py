"""``visualization``, ``callback``, ``model`` and ``monitor`` of the port
against the JAX package's on the CPU: ``print_summary``'s text equal
(digits of auto-named nodes aside), ``plot_network``'s graph (or its
``graphviz`` gate), the callbacks' log lines (speeds aside), and
``do_checkpoint`` files read by the other package; ``Monitor``'s statistics
over one executor equal.
"""
import logging
import re

import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from torch_sym_parity import OUT_TOL, nd_array, uncounted


def _convnet(mx):
    sym = mx.sym
    h = sym.Convolution(sym.Variable("data"), name="c1", kernel=(3, 3),
                        num_filter=8, pad=(1, 1))
    h = sym.Activation(h, act_type="relu")
    h = sym.Pooling(h, kernel=(2, 2), stride=(2, 2), pool_type="max")
    h = sym.BatchNorm(h, name="bn")
    return sym.FullyConnected(h, name="fc", num_hidden=10)


@pytest.mark.parametrize("shape", [None, {"data": (1, 3, 8, 8)}])
def test_print_summary_text_equal(capsys, monkeypatch, shape):
    texts = []
    for mx in (tmx, jmx):
        # fresh auto-name counters: a counter's width pads its column, and
        # each package's count depends on the tests run before in its process
        monkeypatch.setattr(mx.symbol.symbol, "_UID", {})
        mx.visualization.print_summary(_convnet(mx), shape=shape)
        texts.append(capsys.readouterr().out)
    assert uncounted(texts[0].splitlines()) == uncounted(
        texts[1].splitlines())
    assert "c1 (Convolution)" in texts[0] and "Total params:" in texts[0]
    if shape is not None:
        # conv 8*3*3*3 + 8, bn 8 + 8, fc 10*(8*4*4) + 10
        assert "Total params: 1530" in texts[0]


def test_plot_network():
    out = [mx.visualization.plot_network(mx.sym.Activation(
        mx.sym.FullyConnected(mx.sym.Variable("data"), name="f",
                              num_hidden=4), act_type="relu", name="a"))
           if _has_graphviz() else None for mx in (tmx, jmx)]
    if out[0] is None:
        with pytest.raises(tmx.MXNetError, match="graphviz"):
            tmx.visualization.plot_network(tmx.sym.Variable("data"))
        return
    assert out[0].source == out[1].source
    assert "f" in out[0].source


def _has_graphviz():
    try:
        import graphviz  # noqa: F401
    except ImportError:
        return False
    return True


def _fit_logs(mx, caplog, callbacks, epoch_end=None):
    rs = np.random.RandomState(0)
    X = rs.randn(32, 6).astype(np.float32)
    Y = rs.randint(0, 3, 32).astype(np.float32)
    kw = {"ctx": mx.cpu()} if mx is tmx else {}
    it = mx.io.NDArrayIter(X, Y, batch_size=4, **kw)
    fc = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=3,
                               name="fc")
    mod = mx.mod.Module(mx.sym.SoftmaxOutput(fc, name="softmax"),
                        context=mx.cpu())
    w = {"fc_weight": rs.randn(3, 6).astype(np.float32) * 0.3,
         "fc_bias": np.zeros(3, np.float32)}
    caplog.clear()
    with caplog.at_level(logging.INFO):
        mod.fit(it, num_epoch=2, batch_end_callback=callbacks,
                epoch_end_callback=epoch_end, eval_data=it,
                eval_end_callback=None,
                arg_params={k: nd_array(mx, v) for k, v in w.items()},
                optimizer_params={"learning_rate": 0.1})
    # speeds and wall times differ between runs; the rest is equal
    return [re.sub(r"(Speed: |Time cost=)[0-9.]+", r"\1#", r.getMessage())
            for r in caplog.records if r.name == "root"]


def test_callbacks_log_lines_equal(caplog):
    lines = []
    for mx in (tmx, jmx):
        cbs = [mx.callback.Speedometer(4, frequent=3, auto_reset=False),
               mx.callback.log_train_metric(2),
               mx.callback.ProgressBar(8),
               mx.callback.LogValidationMetricsCallback()]
        lines.append(_fit_logs(mx, caplog, cbs))
    assert lines[0] == lines[1]
    assert any("Speed: #" in m for m in lines[0])
    assert any("Train-accuracy" in m for m in lines[0])


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_do_checkpoint_crosses(tmp_path, caplog, writer, reader):
    pkgs = {"port": tmx, "jax": jmx}
    wmx, rmx = pkgs[writer], pkgs[reader]
    prefix = str(tmp_path / "ck")
    _fit_logs(wmx, caplog, None, epoch_end=wmx.callback.do_checkpoint(
        prefix, period=2))
    sym, arg, aux = rmx.model.load_checkpoint(prefix, 2)
    assert sym.list_arguments() == ["data", "fc_weight", "fc_bias",
                                    "softmax_label"]
    warg, _ = wmx.model.load_params(prefix, 2)
    for k, v in warg.items():
        np.testing.assert_array_equal(arg[k].asnumpy(), v.asnumpy())


def test_monitor_stats_equal():
    rs = np.random.RandomState(1)
    feeds = {"data": rs.randn(4, 6).astype(np.float32),
             "fc_weight": rs.randn(3, 6).astype(np.float32),
             "fc_bias": rs.randn(3).astype(np.float32)}
    got = []
    for mx in (tmx, jmx):
        exe = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=3,
                                    name="fc").simple_bind(ctx=mx.cpu(),
                                                           data=(4, 6))
        mon = mx.Monitor(interval=1, sort=True)
        mon.install(exe)
        mon.tic()
        exe.forward(is_train=True, **feeds)
        exe.backward()
        got.append(mon.toc())
    assert [(s, n) for s, n, _ in got[0]] == [(s, n) for s, n, _ in got[1]]
    np.testing.assert_allclose([float(v) for *_x, v in got[0]],
                               [float(v) for *_x, v in got[1]], **OUT_TOL)
