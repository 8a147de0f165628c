"""``HybridBlock.export`` and ``SymbolBlock`` against the JAX package on the
CPU: the cases of ``tests/test_symbol_block.py``; the files both ways (a
port export imported by the JAX ``SymbolBlock`` and the reverse, equal
outputs and gradients); a small BERT's port export node for node the JAX
export of the same config (op, attributes, input wiring, variable names;
op-node name counters may differ); and every exportable layer's
``hybrid_forward`` on tensors equal to its torch ``forward`` (inference).
Tolerances: outputs rtol 1e-5 / atol 1e-6, gradients within 1e-5 of their
max abs.
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.models.bert import bert_small as jbert_small
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.block import F as TF
from mxnet_tpu_torch.models import bert as tbert
from mxnet_tpu_torch.models import transformer as ttr
from torch_sym_parity import OUT_TOL, assert_grads_close, nd_array

CPU = tmx.cpu()
RNG = np.random.RandomState(2)


def _net(mx):
    nn = mx.gluon.nn
    net = nn.HybridSequential()
    with net.name_scope():
        net.add(nn.Dense(16, activation="relu"))
        net.add(nn.Dense(4))
    return net


def _port_net():
    net = _net(tmx)
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    net(nd_array(tmx, RNG.rand(2, 8).astype(np.float32)))
    return net


def test_export_emits_symbol_json(tmp_path):
    net = _port_net()
    path = str(tmp_path / "net")
    out_sym = net.export(path, 0)
    assert isinstance(out_sym, tmx.sym.Symbol)
    args = tmx.sym.load(f"{path}-symbol.json").list_arguments()
    assert args[0] == "data" and all(a.endswith(("weight", "bias"))
                                     for a in args[1:])


def test_symbolblock_imports_matches_original(tmp_path):
    net = _port_net()
    x = nd_array(tmx, RNG.rand(3, 8).astype(np.float32))
    path = str(tmp_path / "net")
    net.export(path, 0)
    sb = tmx.gluon.SymbolBlock.imports(f"{path}-symbol.json", ["data"],
                                       f"{path}-0000.params", ctx=CPU)
    np.testing.assert_allclose(sb(x).asnumpy(), net(x).asnumpy(), **OUT_TOL)


def _sb_run(mx, path, x):
    """Output and parameter gradients of ``SymbolBlock.imports`` of
    ``path`` on ``x`` (sum of the output as the loss)."""
    sb = mx.gluon.SymbolBlock.imports(f"{path}-symbol.json", ["data"],
                                      f"{path}-0000.params", ctx=mx.cpu())
    xa = nd_array(mx, x)
    with mx.autograd.record():
        out = sb(xa)
        loss = out.sum()
    loss.backward()
    grads = {p.name: p.grad(mx.cpu()).asnumpy()
             for p in sb.collect_params().values() if p.grad_req != "null"}
    return out.asnumpy(), grads


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_symbolblock_files_cross_and_train(tmp_path, writer):
    x = RNG.rand(4, 8).astype(np.float32)
    path = str(tmp_path / "net")
    if writer == "port":
        _port_net().export(path, 0)
    else:
        net = _net(jmx)
        net.initialize(jmx.init.Xavier())
        net(jmx.nd.array(x))
        net.export(path, 0)
    t_out, t_grads = _sb_run(tmx, path, x)
    j_out, j_grads = _sb_run(jmx, path, x)
    np.testing.assert_allclose(t_out, j_out, **OUT_TOL)
    assert_grads_close(t_grads, j_grads)
    assert any(np.abs(g).sum() > 0 for g in t_grads.values())


def test_export_with_batchnorm(tmp_path):
    outs = []
    x = RNG.rand(2, 3, 8, 8).astype(np.float32)
    path = str(tmp_path / "cnn")
    for mx in (tmx, jmx):
        nn = mx.gluon.nn
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Conv2D(4, kernel_size=3, padding=1))
            net.add(nn.BatchNorm())
            net.add(nn.Activation("relu"))
        if mx is tmx:
            net.initialize(mx.init.Xavier(), ctx=CPU)
            y_ref = net(nd_array(mx, x)).asnumpy()
            net.export(path, 0)
        sb = mx.gluon.SymbolBlock.imports(f"{path}-symbol.json", ["data"],
                                          f"{path}-0000.params",
                                          ctx=mx.cpu())
        assert sb._sym.list_auxiliary_states()[0].endswith("running_mean")
        outs.append(sb(nd_array(mx, x)).asnumpy())
    np.testing.assert_allclose(outs[0], y_ref, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(outs[0], outs[1], **OUT_TOL)


def _bert_pair(tmp_path):
    """bert_small (2 layers, 64 wide) in both packages with the JAX net's
    weights, each exported: the two paths."""
    prefix = "bertformlm0_"
    jn = jbert_small(dropout=0.0, prefix=prefix)
    jn.initialize(jmx.init.Normal(0.02))
    x = RNG.randint(0, 512, (2, 16)).astype(np.float32)
    jn(jmx.nd.array(x))
    jpath, tpath = str(tmp_path / "jbert"), str(tmp_path / "tbert")
    jn.export(jpath, 0)
    tn = tbert.bert_small(dropout=0.0, device="cpu", prefix=prefix)
    sd = tmx.nd.load(f"{jpath}-0000.params")
    for p in tn.collect_params().values():
        p.set_data(sd[f"arg:{p.name}"])
    tn.export(tpath, 0)
    return jpath, tpath, x, tn


def test_bert_export_node_for_node(tmp_path):
    jpath, tpath, x, tn = _bert_pair(tmp_path)
    J = json.load(open(f"{jpath}-symbol.json"))
    T = json.load(open(f"{tpath}-symbol.json"))

    def key(n):
        return (n["op"], n["name"] if n["op"] == "null" else None,
                n.get("attrs"), [i[:2] for i in n["inputs"]])

    assert [key(n) for n in T["nodes"]] == [key(n) for n in J["nodes"]]
    assert T["heads"] == J["heads"] and T["arg_nodes"] == J["arg_nodes"]
    assert T["attrs"] == J["attrs"]
    ops = [n["op"] for n in T["nodes"]]
    assert ops.count("LayerNorm") == 6
    assert ops.count("_contrib_flash_attention") == 2
    # the files' parameters: same keys, same values
    jp, tp = jmx.nd.load(f"{jpath}-0000.params"), tmx.nd.load(
        f"{tpath}-0000.params")
    assert sorted(jp) == sorted(tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k].asnumpy(), jp[k].asnumpy())


def test_bert_export_runs_in_both(tmp_path):
    jpath, tpath, x, tn = _bert_pair(tmp_path)
    want = tn(torch.from_numpy(x.astype(np.int32))).detach().numpy()
    for path in (tpath, jpath):
        t_out, t_grads = _sb_run(tmx, path, x)
        j_out, j_grads = _sb_run(jmx, path, x)
        np.testing.assert_allclose(t_out, j_out, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(t_out, want, rtol=1e-5, atol=1e-5)
        assert_grads_close(t_grads, j_grads)


def _seq():
    seq = tnn.HybridSequential()
    seq.add(tnn.Dense(8, activation="relu"), tnn.Dense(3))
    return seq


_X2, _X3 = (3, 10), (2, 5, 16)
_IMG, _TOK = (2, 4, 8, 8), (2, 6)
# name -> (the layer's factory, its input's shape); every exportable layer
_LAYERS = {
    "dense": (lambda: tnn.Dense(6, activation="tanh"), _X2),
    "dense_noflat": (lambda: tnn.Dense(6, flatten=False, use_bias=False),
                     _X3),
    "dropout": (lambda: tnn.Dropout(0.3), _X2),
    "batchnorm": (lambda: tnn.BatchNorm(), _IMG),
    "embedding": (lambda: tnn.Embedding(50, 7), _TOK),
    "layernorm": (lambda: tnn.LayerNorm(), _X3),
    "groupnorm": (lambda: tnn.GroupNorm(num_groups=2), _IMG),
    "instancenorm": (lambda: tnn.InstanceNorm(), _IMG),
    "flatten": (lambda: tnn.Flatten(), _IMG),
    "hybridlambda_named": (lambda: tnn.HybridLambda("tanh"), _X2),
    "hybridlambda_fn": (lambda: tnn.HybridLambda(
        lambda F, x: F.relu(x) * 2), _X2),
    "activation": (lambda: tnn.Activation("sigmoid"), _X2),
    "leakyrelu": (lambda: tnn.LeakyReLU(0.1), _X2),
    "prelu": (lambda: tnn.PReLU(), _X2),
    "elu": (lambda: tnn.ELU(0.7), _X2),
    "selu": (lambda: tnn.SELU(), _X2),
    "swish": (lambda: tnn.Swish(1.5), _X2),
    "gelu": (lambda: tnn.GELU(), _X2),
    "conv_nchw": (lambda: tnn.Conv2D(5, 3, padding=1, activation="relu"),
                  _IMG),
    "conv_nhwc": (lambda: tnn.Conv2D(5, 3, strides=2, layout="NHWC"),
                  (2, 8, 8, 4)),
    "maxpool": (lambda: tnn.MaxPool2D(2), _IMG),
    "avgpool": (lambda: tnn.AvgPool2D(3, strides=2, padding=1), _IMG),
    "globalavgpool": (lambda: tnn.GlobalAvgPool2D(), _IMG),
    "globalmaxpool": (lambda: tnn.GlobalMaxPool2D(), _IMG),
    "conv1d": (lambda: tnn.Conv1D(5, 3, padding=1, groups=5,
                                  activation="relu"), (2, 5, 9)),
    "conv3d_ndhwc": (lambda: tnn.Conv3D(3, 2, layout="NDHWC"),
                     (2, 4, 5, 6, 4)),
    "conv2d_transpose": (lambda: tnn.Conv2DTranspose(3, 3, strides=2,
                                                     output_padding=1),
                         _IMG),
    "maxpool1d": (lambda: tnn.MaxPool1D(3, ceil_mode=True), (2, 4, 10)),
    "avgpool3d": (lambda: tnn.AvgPool3D(2, padding=1,
                                        count_include_pad=False),
                  (2, 4, 5, 6, 4)),
    "globalmaxpool1d": (lambda: tnn.GlobalMaxPool1D(layout="NWC"),
                        (2, 10, 4)),
    "hybridsequential": (_seq, _X2),
    "mha": (lambda: ttr.MultiHeadAttention(16, 2), _X3),
    "ffn": (lambda: ttr.PositionwiseFFN(16, 32), _X3),
    "ffn_relu": (lambda: ttr.PositionwiseFFN(16, 32, activation="relu"),
                 _X3),
    "encoder_cell": (lambda: ttr.TransformerEncoderCell(16, 32, 2), _X3),
    "pos_embed": (lambda: ttr.PositionalEmbedding(9, 16), _X3),
    "encoder": (lambda: ttr.TransformerEncoder(2, 16, 32, 2), _X3),
    "bert_model": (lambda: tbert.BERTModel(50, 16, 32, 2, 2, 12,
                                           dropout=0.0), _TOK),
    "bert_mlm": (lambda: tbert.BERTForMLM(50, 16, 32, 2, 2, 12, dropout=0.0,
                                          device="cpu"), _TOK),
}


@pytest.mark.parametrize("case", sorted(_LAYERS))
def test_layer_hybrid_forward_equals_forward(case):
    make, shape = _LAYERS[case]
    layer = make()
    rs = np.random.RandomState(len(case))
    if shape == _TOK:
        xt = torch.from_numpy(rs.randint(0, 50, shape).astype(np.int32))
    else:
        xt = torch.from_numpy(rs.randn(*shape).astype(np.float32))
    if not all(p._inited for p in layer.collect_params().values()):
        layer.initialize(tmx.init.Uniform(0.3), ctx=CPU)
    layer.eval()
    with torch.no_grad():
        want = layer(xt)
        params = {n: p._gluon_data() for n, p in layer._reg_params.items()}
        got = layer.hybrid_forward(TF, xt, **params)
    want = want if isinstance(want, (tuple, list)) else [want]
    got = got if isinstance(got, (tuple, list)) else [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_symbolblock_nd_call_records_leaves(tmp_path):
    net = _port_net()
    path = str(tmp_path / "net")
    net.export(path, 0)
    sb = tmx.gluon.SymbolBlock.imports(f"{path}-symbol.json", "data",
                                       f"{path}-0000.params", ctx=CPU)
    x = nd_array(tmx, RNG.rand(4, 8).astype(np.float32))
    with tag.record():
        loss = (sb(x) * 2).sum()
    loss.backward()
    p = sb.collect_params()[next(iter(sb.collect_params()))]
    assert p.grad().asnumpy().any()
    # the symbolic call splices the graph onto new inputs
    spliced = sb(tmx.sym.var("x2"))
    assert spliced.list_arguments()[0] == "x2"
