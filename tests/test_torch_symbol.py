"""The port's ``mx.sym`` against the JAX package's on the CPU: every case of
``tests/test_symbol.py`` built in both packages by one function (graph
names, ``infer_shape`` / ``infer_type`` and the argument lists exactly,
executor outputs rtol 1e-5 / atol 1e-6, gradients within 1e-5 of their max
abs, ``torch_sym_parity``); the graph file both ways (a JAX-written
``-symbol.json`` runs in the port with the JAX outputs, a port-written one
in the JAX package); a JAX graph's PRNG key inputs dropped on load; the
``RNN`` shape rule against the JAX ``infer_shape``.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from torch_sym_parity import (OUT_TOL, assert_same_run, both, nd_array,
                              run_graph)

RNG = np.random.RandomState(0)


def _mlp(mx):
    sym = mx.sym
    data = sym.Variable("data")
    fc1 = sym.FullyConnected(data, num_hidden=16, name="fc1")
    act1 = sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = sym.FullyConnected(act1, num_hidden=4, name="fc2")
    return sym.SoftmaxOutput(fc2, name="softmax")


def _conv_bn(mx):
    sym = mx.sym
    conv = sym.Convolution(sym.Variable("data"), kernel=(3, 3),
                           num_filter=8, pad=(1, 1), name="conv1")
    bn = sym.BatchNorm(conv, name="bn1")
    return sym.Pooling(bn, kernel=(2, 2), stride=(2, 2), pool_type="max")


def test_list_arguments_order():
    for mx in (tmx, jmx):
        net = _mlp(mx)
        assert net.list_arguments() == [
            "data", "fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias",
            "softmax_label"]
        assert net.list_outputs() == ["softmax_output"]


def test_infer_shape_auto_params():
    t, j = (_mlp(mx).infer_shape(data=(8, 10)) for mx in (tmx, jmx))
    assert t == j
    assert t[1] == [(8, 4)] and t[2] == []


def test_mlp_train_step_matches():
    x = RNG.rand(8, 10).astype(np.float32)
    label = RNG.randint(0, 4, 8).astype(np.float32)
    w = {"fc1_weight": RNG.randn(16, 10).astype(np.float32) * 0.3,
         "fc1_bias": RNG.randn(16).astype(np.float32) * 0.1,
         "fc2_weight": RNG.randn(4, 16).astype(np.float32) * 0.3,
         "fc2_bias": RNG.randn(4).astype(np.float32) * 0.1}
    t, j = both(_mlp, {"data": (8, 10)},
                dict(w, data=x, softmax_label=label))
    assert_same_run(t, j)


def test_infer_shape_conv_batchnorm():
    t, j = (_conv_bn(mx).infer_shape(data=(2, 3, 8, 8)) for mx in (tmx, jmx))
    assert t == j
    assert _conv_bn(tmx).list_auxiliary_states() == ["bn1_moving_mean",
                                                     "bn1_moving_var"]


def test_conv_batchnorm_train_matches():
    feeds = {"data": RNG.rand(2, 3, 8, 8).astype(np.float32),
             "conv1_weight": RNG.randn(8, 3, 3, 3).astype(np.float32) * 0.2,
             "conv1_bias": RNG.randn(8).astype(np.float32) * 0.1,
             "bn1_gamma": 1 + RNG.rand(8).astype(np.float32),
             "bn1_beta": RNG.randn(8).astype(np.float32) * 0.1}
    t, j = both(_conv_bn, {"data": (2, 3, 8, 8)}, feeds,
                out_grads=[RNG.randn(2, 8, 4, 4).astype(np.float32)])
    assert_same_run(t, j)


def test_executor_forward_matches_nd():
    x = RNG.rand(4, 5).astype(np.float32)
    w = RNG.rand(3, 5).astype(np.float32)
    b = RNG.rand(3).astype(np.float32)

    def build(mx):
        return mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=3,
                                     name="fc")

    t, j = both(build, {"data": (4, 5)},
                {"data": x, "fc_weight": w, "fc_bias": b}, is_train=False,
                backward=False)
    assert_same_run(t, j)
    np.testing.assert_allclose(t["outputs"][0], x @ w.T + b, rtol=1e-5)


def test_executor_backward_grads():
    def build(mx):
        sym = mx.sym
        return sym.sum(sym.square(sym.Variable("data") * sym.Variable("w")))

    xv = np.array([1.0, 2.0, 3.0], np.float32)
    wv = np.array([0.5, -1.0, 2.0], np.float32)
    t, j = both(build, {"data": (3,), "w": (3,)}, {"data": xv, "w": wv})
    assert_same_run(t, j)
    np.testing.assert_allclose(t["grads"]["w"], 2 * wv * xv * xv, rtol=1e-5)


def test_softmax_output_backward():
    def build(mx):
        return mx.sym.SoftmaxOutput(mx.sym.Variable("data"), name="softmax")

    x = np.array([[1.0, 2.0, 3.0], [0.0, 0.0, 0.0]], np.float32)
    label = np.array([2, 0], np.float32)
    t, j = both(build, {"data": (2, 3)}, {"data": x, "softmax_label": label},
                grad_req={"data": "write"},
                out_grads=[RNG.randn(2, 3).astype(np.float32)])
    assert_same_run(t, j)
    onehot = np.eye(3, dtype=np.float32)[label.astype(int)]
    np.testing.assert_allclose(t["grads"]["data"], t["outputs"][0] - onehot,
                               rtol=1e-4, atol=1e-6)


def test_json_round_trip_both_ways(tmp_path):
    feeds = {"data": RNG.rand(2, 6).astype(np.float32)}
    for writer, reader in ((tmx, jmx), (jmx, tmx), (tmx, tmx)):
        fname = str(tmp_path / f"{writer.__name__}-net-symbol.json")
        net = _mlp(writer)
        net.save(fname)
        loaded = reader.sym.load(fname)
        assert loaded.list_arguments() == net.list_arguments()
        assert loaded.list_outputs() == net.list_outputs()
        assert (loaded.infer_shape(data=(2, 6))
                == net.infer_shape(data=(2, 6)))
    # the same file, run in both packages, gives one output
    fname = str(tmp_path / "mxnet_tpu-net-symbol.json")
    arrays = {n: RNG.randn(*s).astype(np.float32) * 0.3 for n, s in zip(
        _mlp(tmx).list_arguments(), _mlp(tmx).infer_shape(data=(2, 6))[0])
        if n not in ("data", "softmax_label")}
    outs = [run_graph(mx, lambda m: m.sym.load(fname), {"data": (2, 6)},
                      dict(arrays, **feeds), is_train=False,
                      backward=False)["outputs"][0] for mx in (tmx, jmx)]
    np.testing.assert_allclose(outs[0], outs[1], **OUT_TOL)


def test_group_and_getitem():
    def build(mx):
        a, b = mx.sym.Variable("a"), mx.sym.Variable("b")
        return mx.sym.Group([a + b, a * b])

    t, j = both(build, {"a": (1,), "b": (1,)},
                {"a": np.array([2.0], np.float32),
                 "b": np.array([3.0], np.float32)}, grad_req="null",
                is_train=False, backward=False)
    assert_same_run(t, j)
    assert [o[0] for o in t["outputs"]] == [5.0, 6.0]
    g = build(tmx)
    assert g[0].list_outputs() == g.list_outputs()[:1]
    assert len(g.list_outputs()) == 2


def test_compose():
    def build(mx):
        net1 = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=4,
                                     name="fc1")
        net2 = mx.sym.Activation(mx.sym.Variable("data2"), act_type="relu",
                                 name="act")
        return net2(data2=net1)

    t, j = (build(mx).list_arguments() for mx in (tmx, jmx))
    assert t == j
    assert "data" in t and "fc1_weight" in t and "data2" not in t


def test_scalar_arith_and_internals():
    def build(mx):
        return (mx.sym.Variable("a") + 1.0) * 2.0

    t, j = both(build, {"a": (1,)}, {"a": np.array([3.0], np.float32)},
                grad_req="null", is_train=False, backward=False)
    assert_same_run(t, j)
    assert t["outputs"][0][0] == 8.0
    ti, ji = (_mlp(mx).get_internals().list_outputs() for mx in (tmx, jmx))
    assert ti == ji and "fc1_output" in ti


def test_grad_req_add():
    def build(mx):
        return mx.sym.sum(mx.sym.Variable("data") * mx.sym.Variable("w"))

    xv = np.array([1.0, 2.0], np.float32)
    t, j = both(build, {"data": (2,), "w": (2,)},
                {"data": xv, "w": np.ones(2, np.float32)},
                grad_req={"w": "add", "data": "null"}, steps=2)
    assert_same_run(t, j)
    np.testing.assert_allclose(t["grads"]["w"], 2 * xv)


def test_name_prefix_scope():
    names = []
    for mx in (tmx, jmx):
        with mx.name.Prefix("stage1_"):
            s = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=4)
        with mx.name.Prefix("p_"):
            s2 = mx.sym.FullyConnected(mx.sym.Variable("data"),
                                       num_hidden=4, name="fc9")
        names.append((s.list_outputs()[0].rstrip("0123456789_output"),
                      s2.list_outputs(), s.list_arguments()[1:] and [
                          a.startswith("stage1_") for a in
                          s.list_arguments()[1:]]))
    assert names[0] == names[1]
    assert names[0][0].startswith("stage1_fullyconnected")
    assert names[0][1] == ["fc9_output"]


def test_attr_scope_on_variables():
    got = []
    for mx in (tmx, jmx):
        with mx.AttrScope(__lr_mult__="0.1", group="encoder"):
            v = mx.sym.Variable("w")
            with mx.AttrScope(group="decoder"):
                v2 = mx.sym.Variable("w2")
        with mx.AttrScope(group="a"):
            v3 = mx.sym.Variable("w3", attr={"group": "b"})
        got.append([s._entries[0][0].vattrs for s in (v, v2, v3)])
        with pytest.raises(ValueError):
            mx.AttrScope(x=1)
    assert got[0] == got[1]
    assert got[0][0]["lr_mult"] == 0.1
    assert got[0][1]["attr"]["group"] == "decoder"
    assert got[0][2]["attr"]["group"] == "b"


def test_attr_scope_reuse_and_op_nodes():
    got = []
    for mx in (tmx, jmx):
        scope = mx.AttrScope(group="g")
        with scope:
            with scope:
                s = mx.sym.FullyConnected(mx.sym.Variable("d"),
                                          num_hidden=2)
        after = mx.sym.Variable("w_after")._entries[0][0].vattrs["attr"]
        got.append((after, s._entries[0][0].vattrs, s.list_attr()))
    assert got[0] == got[1]
    assert got[0][1]["attr"]["group"] == "g" and "group" not in got[0][0]


@pytest.mark.parametrize("case", range(6))
def test_sym_ufunc_scalar_dispatch(case):
    def build(mx):
        a, b = mx.sym.Variable("a"), mx.sym.Variable("b")
        return [mx.sym.power(a, b), mx.sym.power(a, 2),
                mx.sym.equal(a, 2.0), mx.sym.greater_equal(2, a),
                mx.sym.logical_and(a - 1, b), mx.sym.mod(b, 2)][case]

    expect = [[1, 4, 3], [1, 4, 9], [0, 1, 0], [1, 1, 0], [0, 1, 1],
              [1, 0, 1]][case]
    vals = {"a": np.array([1., 2., 3.], np.float32),
            "b": np.array([3., 2., 1.], np.float32)}
    names = build(tmx).list_arguments()
    t, j = both(build, {k: (3,) for k in names}, {k: vals[k] for k in names},
                grad_req="null", is_train=False, backward=False)
    assert_same_run(t, j)
    np.testing.assert_allclose(t["outputs"][0], expect)
    assert tmx.sym.load_json(build(tmx).tojson()).list_arguments() == names


def test_infer_type_of_typed_variables():
    def build(mx):
        a = mx.sym.Variable("a", shape=(2, 3), dtype="float32")
        b = mx.sym.Variable("b", shape=(3, 4), dtype="float32")
        return mx.sym.dot(a, b)

    t, j = (build(mx) for mx in (tmx, jmx))
    assert ([[None if d is None else np.dtype(d) for d in ds]
             for ds in t.infer_type()]
            == [[None if d is None else np.dtype(d) for d in ds]
                for ds in j.infer_type()])
    assert t.infer_type()[1] == [np.dtype("float32")]
    assert t.infer_shape() == j.infer_shape()


def test_jax_key_inputs_dropped_on_load(tmp_path):
    # a JAX graph gives _shuffle a PRNG key variable; the port's op takes
    # none, so the port's graph has no such argument
    jsym = jmx.sym._shuffle(data=jmx.sym.Variable("data"), name="shuf")
    assert jsym.list_arguments() == ["shuf_key", "data"]
    fname = str(tmp_path / "shuffle-symbol.json")
    jsym.save(fname)
    tsym = tmx.sym.load(fname)
    assert tsym.list_arguments() == ["data"]
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    out = tsym.bind(tmx.cpu(), {"data": nd_array(tmx, x)},
                    grad_req="null").forward()[0].asnumpy()
    np.testing.assert_array_equal(np.sort(out[:, 0]), x[:, 0])


@pytest.mark.parametrize("mode,bidirectional", [("lstm", False),
                                                ("gru", True)])
def test_rnn_shape_rule_matches_jax(mode, bidirectional):
    def build(mx):
        v = mx.sym.Variable
        cell = [v("cell")] if mode == "lstm" else []
        return mx.sym.RNN(v("data"), v("params"), v("state"), *cell,
                          state_size=6, num_layers=2, mode=mode,
                          bidirectional=bidirectional, state_outputs=True,
                          name="rnn")

    t, j = (build(mx) for mx in (tmx, jmx))
    assert t.list_arguments() == j.list_arguments()
    got = t.infer_shape(data=(5, 3, 4))
    assert got == j.infer_shape(data=(5, 3, 4))
    assert got[1][0] == (5, 3, 12 if bidirectional else 6)
