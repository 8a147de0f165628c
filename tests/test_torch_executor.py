"""The port's ``Executor`` against the JAX package's on the CPU: ``bind``
with lists and dicts, the accessors, ``grad_req`` write / add / null, the
gradient arrays written in place (their storage never moves), outputs and
gradients of the main path's ops (``LayerNorm``, ``_contrib_flash_attention``
through the kernels' plain versions), BatchNorm's moving stats over two
training steps, ``copy_params_from``, ``reshape``, ``eval``, ``Dropout``'s
two modes, and a graph partitioned by the default subgraph backend.
Tolerances: ``torch_sym_parity``'s.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.base import MXNetError
from torch_sym_parity import (OUT_TOL, assert_same_run, both, nd_array,
                              run_graph)

RNG = np.random.RandomState(1)


def _attention_block(mx):
    """LayerNorm -> qkv -> flash attention -> proj: a transformer layer's
    kernel ops as the exported BERT graph spells them."""
    sym = mx.sym
    x = sym.LayerNorm(sym.Variable("data"), name="ln", eps=1e-5)
    qkv = sym.FullyConnected(x, num_hidden=48, flatten=False, name="qkv")
    q, k, v = sym.split(qkv, num_outputs=3, axis=-1)
    heads = [sym.Reshape(sym.transpose(sym.Reshape(
        t, shape=(0, 0, -4, 2, 8)), axes=(0, 2, 1, 3)), shape=(-3, 0, 0))
        for t in (q, k, v)]
    out = sym._contrib_flash_attention(*heads, causal=False)
    out = sym.Reshape(sym.transpose(sym.Reshape(
        out, shape=(-4, -1, 2, 0, 0)), axes=(0, 2, 1, 3)), shape=(0, 0, -3))
    return sym.FullyConnected(out, num_hidden=16, flatten=False,
                              name="proj")


def test_kernel_ops_forward_backward_match():
    feeds = {"data": RNG.randn(2, 5, 16).astype(np.float32),
             "ln_gamma": 1 + 0.1 * RNG.randn(16).astype(np.float32),
             "ln_beta": 0.1 * RNG.randn(16).astype(np.float32),
             "qkv_weight": 0.3 * RNG.randn(48, 16).astype(np.float32),
             "qkv_bias": 0.1 * RNG.randn(48).astype(np.float32),
             "proj_weight": 0.3 * RNG.randn(16, 16).astype(np.float32),
             "proj_bias": 0.1 * RNG.randn(16).astype(np.float32)}
    t, j = both(_attention_block, {"data": (2, 5, 16)}, feeds,
                out_grads=[RNG.randn(2, 5, 16).astype(np.float32)])
    assert_same_run(t, j)


def test_grad_arrays_written_in_place():
    def build(mx):
        return mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=3,
                                     name="fc")

    for req in ("write", "add"):
        exe = build(tmx).simple_bind(ctx=tmx.cpu(), grad_req=req,
                                     data=(4, 5))
        ptrs = {k: v._data.data_ptr() for k, v in exe.grad_dict.items()}
        for _ in range(2):
            exe.forward(is_train=True,
                        data=RNG.rand(4, 5).astype(np.float32))
            exe.backward()
        assert {k: v._data.data_ptr()
                for k, v in exe.grad_dict.items()} == ptrs


def test_null_grad_req_and_accessors():
    def build(mx):
        return mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=3,
                                     name="fc")

    w = RNG.rand(3, 5).astype(np.float32)
    b = RNG.rand(3).astype(np.float32)
    x = RNG.rand(4, 5).astype(np.float32)
    got = []
    for mx in (tmx, jmx):
        args = [nd_array(mx, a) for a in (x, w, b)]
        grads = [None, nd_array(mx, np.zeros_like(w)),
                 nd_array(mx, np.zeros_like(b))]
        exe = build(mx).bind(mx.cpu(), args, args_grad=grads,
                             grad_req=["null", "write", "write"])
        exe.forward(is_train=True)
        exe.backward()
        got.append((sorted(exe.arg_dict), sorted(exe.grad_dict),
                    [a.shape for a in exe.arg_arrays],
                    [g is None for g in exe.grad_arrays],
                    sorted(exe.output_dict),
                    exe.grad_dict["fc_weight"].asnumpy()))
    for a, b_ in zip(got[0][:5], got[1][:5]):
        assert a == b_
    np.testing.assert_allclose(got[0][5], got[1][5], **OUT_TOL)


def test_backward_before_train_forward_raises():
    for mx, err in ((tmx, MXNetError), (jmx, jmx.base.MXNetError)):
        exe = mx.sym.sum(mx.sym.Variable("a")).simple_bind(
            ctx=mx.cpu(), a=(2,))
        exe.forward(is_train=False, a=np.ones(2, np.float32))
        with pytest.raises(err):
            exe.backward()


def test_batchnorm_moving_stats_two_steps():
    def build(mx):
        return mx.sym.BatchNorm(mx.sym.Variable("data"), momentum=0.8,
                                fix_gamma=False, name="bn")

    feeds = {"data": RNG.randn(6, 4, 3).astype(np.float32) * 2 + 1,
             "bn_gamma": 1 + RNG.rand(4).astype(np.float32),
             "bn_beta": RNG.randn(4).astype(np.float32)}
    t, j = both(build, {"data": (6, 4, 3)}, feeds, steps=2,
                out_grads=[RNG.randn(6, 4, 3).astype(np.float32)])
    assert_same_run(t, j)
    assert np.abs(t["aux_values"]["bn_moving_mean"]).max() > 0.1


def test_copy_params_from_and_reshape():
    def build(mx):
        fc = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=3,
                                   name="fc")
        return mx.sym.Activation(fc, act_type="tanh")

    params = {"fc_weight": RNG.randn(3, 5).astype(np.float32),
              "fc_bias": RNG.randn(3).astype(np.float32)}
    x = RNG.rand(6, 5).astype(np.float32)
    outs = []
    for mx in (tmx, jmx):
        exe = build(mx).simple_bind(ctx=mx.cpu(), data=(4, 5))
        exe.copy_params_from({k: nd_array(mx, v)
                              for k, v in params.items()})
        with pytest.raises(Exception):
            exe.copy_params_from({"nope": nd_array(mx, x)})
        exe.copy_params_from({"nope": nd_array(mx, x)},
                             allow_extra_params=True)
        new = exe.reshape(data=(6, 5))
        outs.append(new.forward(is_train=False, data=x)[0].asnumpy())
    np.testing.assert_allclose(outs[0], outs[1], **OUT_TOL)
    np.testing.assert_allclose(
        outs[0], np.tanh(x @ params["fc_weight"].T + params["fc_bias"]),
        rtol=1e-5, atol=1e-6)


def test_symbol_eval():
    outs = []
    for mx in (tmx, jmx):
        a, b = mx.sym.Variable("a"), mx.sym.Variable("b")
        out = mx.sym.broadcast_mul(a, b) - 1.0
        outs.append(out.eval(ctx=mx.cpu(), a=nd_array(mx, [[1., 2.]]),
                             b=nd_array(mx, [[3.], [4.]]))[0].asnumpy())
    np.testing.assert_array_equal(outs[0], outs[1])


def test_dropout_modes():
    def build(mx):
        return mx.sym.Dropout(mx.sym.Variable("data"), p=0.5, name="drop")

    x = np.ones((64, 64), np.float32)
    t, j = both(build, {"data": x.shape}, {"data": x}, is_train=False,
                backward=False, grad_req="null")
    assert_same_run(t, j)
    np.testing.assert_array_equal(t["outputs"][0], x)
    tmx.random.seed(3)
    out = run_graph(tmx, build, {"data": x.shape}, {"data": x},
                    out_grads=[x])
    y, g = out["outputs"][0], out["grads"]["data"]
    assert set(np.unique(y)) == {0.0, 2.0}
    np.testing.assert_array_equal(g, y)  # d(x * mask)/dx = mask
    assert 0.4 < (y == 0).mean() < 0.6


def test_default_subgraph_partition_runs():
    def build(mx):
        fc = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=8,
                                   name="fc1")
        act = mx.sym.Activation(fc, act_type="relu")
        fc2 = mx.sym.FullyConnected(act, num_hidden=3, name="fc2")
        return mx.sym.SoftmaxOutput(fc2, name="softmax").optimize_for(
            "default")

    parts = [[n.op for n in mx.symbol.symbol._topo_order(
        build(mx)._entries) if not n.is_variable()] for mx in (tmx, jmx)]
    assert parts[0] == parts[1] and "_subgraph" in parts[0]
    feeds = {"data": RNG.rand(4, 6).astype(np.float32),
             "fc1_weight": RNG.randn(8, 6).astype(np.float32),
             "fc1_bias": RNG.randn(8).astype(np.float32),
             "fc2_weight": RNG.randn(3, 8).astype(np.float32),
             "fc2_bias": RNG.randn(3).astype(np.float32),
             "softmax_label": np.array([0, 1, 2, 1], np.float32)}
    outs = []
    for mx in (tmx, jmx):
        # a partitioned graph binds its arrays (no shape inference runs
        # through a claimed region, in either package)
        exe = build(mx).bind(mx.cpu(), {k: nd_array(mx, v)
                                        for k, v in feeds.items()},
                             grad_req="null")
        outs.append(exe.forward()[0].asnumpy())
    np.testing.assert_allclose(outs[0], outs[1], **OUT_TOL)
