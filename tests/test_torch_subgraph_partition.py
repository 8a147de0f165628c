"""The six subgraph-partition cases of ``tests/test_quantization_subgraph.py``
(the chain claim, the merge, execution, the unsupported-node and
merge-then-poison rules, ``MXNET_SUBGRAPH_BACKEND``), each run in the
port and in the JAX package with the same graph and the same numpy
values: the partitioned graphs have the same op sequence and claimed
region sizes, and the bound results agree within rtol 1e-5 (f32, the
same ops fused or not).
"""
import json

import numpy as np

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from torch_fresh_names import fresh_jax_names  # noqa: F401

BOTH = (jmx, tmx)


def _nd(mx, a):
    a = np.asarray(a, np.float32)
    return tmx.nd.array(a, ctx=tmx.cpu()) if mx is tmx else jmx.nd.array(a)


def _bind(mx, s, args, aux=None):
    kw = {"ctx": tmx.cpu()} if mx is tmx else {}
    exe = s.bind(args={k: _nd(mx, v) for k, v in args.items()},
                 aux_states=None if aux is None else {
                     k: _nd(mx, v) for k, v in aux.items()},
                 grad_req="null", **kw)
    return [o.asnumpy() for o in exe.forward()]


def _shape(part):
    js = json.loads(part.tojson())
    return ([n["op"] for n in js["nodes"]],
            [int(n["attrs"]["num_nodes"]) for n in js["nodes"]
             if n["op"] == "_subgraph"])


def _both(case):
    return {mx.__name__: case(mx) for mx in BOTH}


def _same(res, rtol=1e-5):
    (tshape, touts), (jshape, jouts) = res["mxnet_tpu_torch"], \
        res["mxnet_tpu"]
    assert tshape == jshape
    assert len(touts) == len(jouts)
    for a, b in zip(touts, jouts):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=1e-6)
    return tshape


def test_partition_claims_compute_chain():
    def case(mx):
        sym = mx.sym
        h = sym.FullyConnected(sym.Variable("data"), name="fc1",
                               num_hidden=8)
        h = sym.Activation(h, act_type="relu")
        h = sym.FullyConnected(h, name="fc2", num_hidden=4)
        return _shape(mx.subgraph.partition(sym.softmax(h), "default")), []

    ops, sizes = _same(_both(case))
    assert ops.count("_subgraph") == 1 and sizes == [4]


def test_partition_extends_past_merge():
    x = np.random.RandomState(12).randn(2, 3)

    def case(mx):
        sym = mx.sym
        a = sym.Variable("a")
        out = sym.relu(sym.relu(a) + sym.sigmoid(a))
        part = mx.subgraph.partition(out, "default")
        got = _bind(mx, part, {"a": x})
        np.testing.assert_allclose(got[0], _bind(mx, out, {"a": x})[0],
                                   rtol=1e-6)
        return _shape(part), got

    ops, sizes = _same(_both(case))
    assert sizes == [4]  # relu, sigmoid, add, relu


def test_partition_executes_same_results():
    args = {"data": np.random.RandomState(7).rand(4, 6),
            "fcp1_weight": np.random.RandomState(8).rand(8, 6),
            "fcp1_bias": np.zeros(8),
            "fcp2_weight": np.random.RandomState(9).rand(3, 8),
            "fcp2_bias": np.zeros(3)}

    def case(mx):
        sym = mx.sym
        h = sym.FullyConnected(sym.Variable("data"), name="fcp1",
                               num_hidden=8)
        h = sym.Activation(h, act_type="relu")
        out = sym.FullyConnected(h, name="fcp2", num_hidden=3)
        part = mx.subgraph.partition(out, "default")
        got = _bind(mx, part, args)
        np.testing.assert_allclose(got[0], _bind(mx, out, args)[0],
                                   rtol=1e-5)
        return _shape(part), got

    _same(_both(case))


def test_partition_respects_unsupported_node():
    def case(mx):
        sym = mx.sym
        h = sym.FullyConnected(sym.Variable("data"), name="fcs1",
                               num_hidden=8)
        h = sym.Activation(h, act_type="relu")
        h = sym.BatchNorm(h, name="bns1")
        h = sym.FullyConnected(h, name="fcs2", num_hidden=4)
        out = sym.Activation(h, act_type="relu")
        return _shape(mx.subgraph.partition(out, "default")), []

    ops, _ = _same(_both(case))
    assert ops.count("_subgraph") == 2 and "BatchNorm" in ops


def test_partition_merge_then_poison_regression():
    rng = np.random.RandomState(13)
    args = {"a": rng.rand(2, 3), "b": rng.rand(2, 3),
            "bn_poison_gamma": np.ones(3), "bn_poison_beta": np.zeros(3)}
    aux = {"bn_poison_moving_mean": np.zeros(3),
           "bn_poison_moving_var": np.ones(3)}

    def case(mx):
        sym = mx.sym
        n1 = sym.relu(sym.Variable("a"))
        n2 = sym.relu(sym.Variable("b"))
        n3 = sym.BatchNorm(n2, name="bn_poison")
        out = sym.Group([n1, n3 + (n1 + n2)])
        part = mx.subgraph.partition(out, "default")
        outs = _bind(mx, part, args, aux)
        assert all(np.isfinite(o).all() for o in outs)
        return _shape(part), outs

    ops, _ = _same(_both(case))
    assert "BatchNorm" in ops


def test_env_backend_hook(monkeypatch):
    monkeypatch.setenv("MXNET_SUBGRAPH_BACKEND", "default")
    args = {"data": np.random.RandomState(10).rand(2, 6),
            "fce_weight": np.random.RandomState(11).rand(4, 6),
            "fce_bias": np.zeros(4)}

    def case(mx):
        assert mx.subgraph.env_backend() == "default"
        sym = mx.sym
        out = sym.Activation(sym.FullyConnected(sym.Variable("data"),
                                                name="fce", num_hidden=4),
                             act_type="relu")
        got = _bind(mx, out, args)
        assert np.isfinite(got[0]).all()
        return ([], []), got

    _same(_both(case))
