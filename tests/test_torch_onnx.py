"""Every case of ``tests/test_onnx.py`` held on the port's ``contrib.onnx``
(CPU): the wire-format codec (bfloat16 without any numpy bfloat16 type:
torch.bfloat16 in, torch.bfloat16 out), export -> import round trips
through the port's own ``import_model`` / ``import_to_gluon`` with the
JAX tests' tolerances, the importer's diagnostics (Split sizes, Constant
forms) and the int8 QDQ export against its numpy replay.

Two cases hold the port to the correct result where the JAX converters
are wrong: an initializer read both statically (a Reshape's shape) and as
a tensor stays a param, and a graph that reads BatchNorm's output 1 or 2
is refused at export (the exported BatchNormalization has one output).
"""
import os

import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import nd, sym
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import onnx as onnx_mxnet
from mxnet_tpu_torch.contrib.onnx import proto as P

CPU = mx.cpu()


# --------------------------------------------------------------------------
# codec
# --------------------------------------------------------------------------


def test_proto_attribute_roundtrip():
    cases = [("axis", -1), ("alpha", 0.25), ("mode", "constant"),
             ("pads", [0, 1, 2, 3]), ("scales", [1.0, 0.5]),
             ("names", ["a", "b"])]
    for name, val in cases:
        got_name, got = P.parse_attribute(P.make_attribute(name, val))
        assert got_name == name
        if isinstance(val, float):
            assert abs(got - val) < 1e-6
        elif isinstance(val, list) and isinstance(val[0], float):
            assert np.allclose(got, val)
        else:
            assert got == val


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "int64",
                                   "uint8", "bool", "float16"])
def test_proto_tensor_roundtrip(dtype):
    rng = np.random.RandomState(0)
    arr = (rng.rand(3, 4) * 10).astype(dtype)
    parsed = P.parse_tensor(P.make_tensor("t", arr))
    assert parsed["name"] == "t" and parsed["array_is"] == "numpy"
    np.testing.assert_array_equal(parsed["array"], arr)


def test_proto_tensor_bfloat16():
    """bfloat16 travels as its 16-bit words: a torch.bfloat16 tensor in,
    a torch.bfloat16 tensor with the same bits out."""
    arr = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3) * 1.5
    parsed = P.parse_tensor(P.make_tensor("t", arr))
    assert parsed["data_type"] == P.BFLOAT16
    assert parsed["array_is"] == "torch.bfloat16"
    assert parsed["array"].dtype == torch.bfloat16
    np.testing.assert_array_equal(parsed["array"].float().numpy(),
                                  arr.float().numpy())
    assert torch.equal(parsed["array"].view(torch.int16),
                       arr.view(torch.int16))
    assert P.onnx_dtype_name(P.BFLOAT16) == "bfloat16"
    assert P.np_to_onnx_dtype(torch.bfloat16) == P.BFLOAT16


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------


def _fill_params(s, input_shapes, seed=0):
    rng = np.random.RandomState(seed)
    shapes, _, aux_shapes = s.infer_shape(**input_shapes)
    params = {}
    for name, shp in zip(s.list_arguments(), shapes):
        if name in input_shapes:
            continue
        params[name] = nd.array(rng.randn(*shp).astype("float32") * 0.1,
                                ctx=CPU)
    for name, shp in zip(s.list_auxiliary_states(), aux_shapes):
        base = np.abs(rng.randn(*shp).astype("float32")) * 0.1
        params[name] = nd.array(base + (1.0 if "var" in name else 0.0),
                                ctx=CPU)
    return params


def _forward(s, params, feeds):
    shapes = {k: v.shape for k, v in feeds.items()}
    ex = s.simple_bind(ctx=CPU, grad_req="null", **shapes)
    for k, v in params.items():
        (ex.aux_dict if k in ex.aux_dict else ex.arg_dict)[k][:] = v
    for k, v in feeds.items():
        ex.arg_dict[k][:] = nd.array(v, ctx=CPU, dtype=v.dtype)
    return [o.asnumpy() for o in ex.forward(is_train=False)]


def _data_names(s, params):
    return [n for n in s.list_arguments() if n not in params]


def _roundtrip(s, params, feeds, atol=1e-5, tmp=None):
    path = os.path.join(tmp, "m.onnx")
    onnx_mxnet.export_model(
        s, params, [feeds[k].shape for k in _data_names(s, params)],
        np.float32, path)
    sym2, arg2, aux2 = onnx_mxnet.import_model(path, ctx=CPU)
    y1 = _forward(s, params, feeds)
    y2 = _forward(sym2, {**arg2, **aux2}, feeds)
    assert len(y1) == len(y2)
    for a, b in zip(y1, y2):
        np.testing.assert_allclose(a, b, atol=atol, rtol=1e-5)


# --------------------------------------------------------------------------
# export/import round trips
# --------------------------------------------------------------------------


def test_conv_bn_pool_fc_roundtrip(tmp_path):
    data = sym.Variable("data")
    c = sym.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1),
                        name="conv1")
    b = sym.BatchNorm(c, name="bn1")
    a = sym.Activation(b, act_type="relu", name="relu1")
    p = sym.Pooling(a, kernel=(2, 2), stride=(2, 2), pool_type="max",
                    name="pool1")
    f = sym.FullyConnected(p, num_hidden=10, name="fc1")
    s = sym.softmax(f, name="sm")
    feeds = {"data": np.random.RandomState(1).rand(2, 3, 8, 8)
             .astype("float32")}
    _roundtrip(s, _fill_params(s, {"data": (2, 3, 8, 8)}), feeds,
               tmp=str(tmp_path))


def test_elemwise_concat_clip_roundtrip(tmp_path):
    x = sym.Variable("x")
    a = sym.clip(x * 2.0 + 1.0, a_min=-1.0, a_max=1.0, name="cl")
    b = sym.LeakyReLU(x - 0.5, act_type="leaky", slope=0.1, name="lr")
    s = sym.Concat(a, b, dim=1, name="cat")
    feeds = {"x": np.random.RandomState(2).randn(2, 4).astype("float32")}
    _roundtrip(s, {}, feeds, tmp=str(tmp_path))


def test_reshape_transpose_reduce_roundtrip(tmp_path):
    x = sym.Variable("x")
    r = sym.Reshape(x, shape=(0, -1), name="rs")
    t = sym.transpose(r, axes=(1, 0), name="tr")
    s = sym.sum(t, axis=0, keepdims=False, name="sm")
    feeds = {"x": np.random.RandomState(3).rand(2, 3, 4).astype("float32")}
    _roundtrip(s, {}, feeds, tmp=str(tmp_path))


def test_global_pool_dropout_flatten_roundtrip(tmp_path):
    data = sym.Variable("data")
    c = sym.Convolution(data, kernel=(1, 1), num_filter=4, name="c")
    g = sym.Pooling(c, pool_type="avg", global_pool=True, name="gap")
    fl = sym.Flatten(g, name="fl")
    dp = sym.Dropout(fl, p=0.5, name="dp")  # identity at inference
    s = sym.FullyConnected(dp, num_hidden=3, name="fc")
    feeds = {"data": np.random.RandomState(4).rand(2, 2, 5, 5)
             .astype("float32")}
    _roundtrip(s, _fill_params(s, {"data": (2, 2, 5, 5)}), feeds,
               tmp=str(tmp_path))


def test_split_multi_output_roundtrip(tmp_path):
    x = sym.Variable("x")
    parts = sym.SliceChannel(x, num_outputs=2, axis=1, name="sp")
    s = sym.Group([parts[0] * 2.0, parts[1] + 1.0])
    feeds = {"x": np.random.RandomState(5).rand(2, 4).astype("float32")}
    _roundtrip(s, {}, feeds, tmp=str(tmp_path))


def test_fix_gamma_exported_as_ones(tmp_path):
    """fix_gamma=True (op default) must export scale=1 regardless of the
    stored gamma array: the op ignores it, so the file must too."""
    data = sym.Variable("data")
    s = sym.BatchNorm(sym.Convolution(data, kernel=(1, 1), num_filter=2,
                                      no_bias=True, name="c"),
                      fix_gamma=True, name="bn")
    params = _fill_params(s, {"data": (1, 2, 3, 3)})
    params["bn_gamma"][:] = nd.array(np.full((2,), 7.0, np.float32),
                                     ctx=CPU)
    path = str(tmp_path / "m.onnx")
    onnx_mxnet.export_model(s, params, [(1, 2, 3, 3)], np.float32, path)
    with open(path, "rb") as f:
        graph = P.parse_model(f.read())["graph"]
    gamma = [t for t in graph["initializer"] if t["name"] == "bn_gamma"]
    np.testing.assert_array_equal(gamma[0]["array"],
                                  np.ones((2,), np.float32))


def test_unsupported_op_raises_with_name(tmp_path):
    x = sym.Variable("x")
    s = sym.Correlation(x, x, name="corr")
    with pytest.raises(MXNetError, match="Correlation"):
        onnx_mxnet.export_model(s, _fill_params(s, {"x": (1, 2, 6, 6)}),
                                [(1, 2, 6, 6)], np.float32,
                                str(tmp_path / "m.onnx"))


def test_deconvolution_roundtrip(tmp_path):
    data = sym.Variable("data")
    dc = sym.Deconvolution(data, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                           adj=(1, 1), num_filter=4, no_bias=False,
                           name="dc")
    s = sym.Activation(dc, act_type="relu", name="r")
    feeds = {"data": np.random.RandomState(9).rand(2, 3, 5, 5)
             .astype("float32")}
    _roundtrip(s, _fill_params(s, {"data": (2, 3, 5, 5)}), feeds,
               tmp=str(tmp_path))


def test_get_model_metadata(tmp_path):
    x = sym.Variable("x")
    s = sym.FullyConnected(x, num_hidden=3, name="fc")
    params = _fill_params(s, {"x": (2, 5)})
    path = str(tmp_path / "m.onnx")
    onnx_mxnet.export_model(s, params, [(2, 5)], np.float32, path)
    meta = onnx_mxnet.get_model_metadata(path)
    assert meta["input_tensor_data"] == [("x", (2, 5))]
    assert meta["output_tensor_data"][0][0] == "fc"
    assert tuple(meta["output_tensor_data"][0][1]) == (2, 3)


def test_import_to_gluon(tmp_path):
    data = sym.Variable("data")
    f = sym.FullyConnected(data, num_hidden=4, name="fc1")
    s = sym.Activation(f, act_type="tanh", name="t1")
    params = _fill_params(s, {"data": (2, 3)})
    feeds = {"data": np.random.RandomState(6).rand(2, 3).astype("float32")}
    y_ref = _forward(s, params, feeds)[0]
    path = str(tmp_path / "m.onnx")
    onnx_mxnet.export_model(s, params, [(2, 3)], np.float32, path)
    net = onnx_mxnet.import_to_gluon(path, ctx=CPU)
    y = net(nd.array(feeds["data"], ctx=CPU)).asnumpy()
    np.testing.assert_allclose(y, y_ref, atol=1e-6)


def test_import_to_gluon_defaults_to_the_card(tmp_path):
    """With no ctx the params go to the card, which the CPU sandbox does
    not have: the import raises and names the CPU, never falls back."""
    x = sym.Variable("x")
    s = sym.FullyConnected(x, num_hidden=3, name="fc")
    path = str(tmp_path / "m.onnx")
    onnx_mxnet.export_model(s, _fill_params(s, {"x": (2, 5)}), [(2, 5)],
                            np.float32, path)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is valid here")
    with pytest.raises(MXNetError, match="cpu"):
        onnx_mxnet.import_to_gluon(path)


def test_mini_transformer_roundtrip(tmp_path):
    """Transformer-family ops through ONNX: Embedding->Gather (int32
    graph input, params keep float32), LayerNorm decomposition, per-
    position FC (MatMul path), batch_dot with transpose_b, scaled softmax,
    slice_axis, reduction."""
    V, D, T, B = 16, 8, 6, 2
    tokens = sym.Variable("tokens", dtype="int32")
    emb = sym.Embedding(tokens, input_dim=V, output_dim=D, name="emb")
    ln = sym.LayerNorm(emb, name="ln")
    q = sym.FullyConnected(ln, num_hidden=D, flatten=False, name="q")
    k = sym.FullyConnected(ln, num_hidden=D, flatten=False, name="k")
    v = sym.FullyConnected(ln, num_hidden=D, flatten=False, name="v")
    scores = sym.batch_dot(q, k, transpose_b=True, name="scores")
    att = sym.softmax(scores * (1.0 / np.sqrt(D)), axis=-1, name="att")
    ctxv = sym.batch_dot(att, v, name="ctx")
    first = sym.slice_axis(ctxv, axis=1, begin=0, end=3, name="sl")
    s = sym.sum(first, axis=-1, keepdims=False, name="out")

    rng = np.random.RandomState(0)
    shapes, _, _ = s.infer_shape(tokens=(B, T))
    params = {}
    for name, shp in zip(s.list_arguments(), shapes):
        if name == "tokens":
            continue
        params[name] = nd.array(rng.randn(*shp).astype("float32") * 0.3,
                                ctx=CPU)
    tok = rng.randint(0, V, (B, T)).astype("int32")

    path = str(tmp_path / "m.onnx")
    onnx_mxnet.export_model(s, params, [(B, T)], np.int32, path)
    meta = onnx_mxnet.get_model_metadata(path)
    assert meta["input_tensor_data"] == [("tokens", (B, T))]
    sym2, arg2, aux2 = onnx_mxnet.import_model(path, ctx=CPU)
    y1 = _forward(s, params, {"tokens": tok})[0]
    y2 = _forward(sym2, {**arg2, **aux2}, {"tokens": tok})[0]
    np.testing.assert_allclose(y1, y2, atol=1e-5, rtol=1e-5)


def test_where_broadcast_axis_expand_dims_roundtrip(tmp_path):
    x = sym.Variable("x")
    m = sym.expand_dims(x, axis=1, name="ed")          # (B,1,C)
    bcast = sym.broadcast_axis(m, axis=1, size=3, name="ba")  # (B,3,C)
    cond = sym._greater_scalar(bcast, scalar=0.0)
    s = sym.where(cond, bcast, bcast * 0.1, name="out")
    feeds = {"x": np.random.RandomState(8).randn(2, 4).astype("float32")}
    _roundtrip(s, {}, feeds, tmp=str(tmp_path))


def _export_net(net, d, name, shapes, dtype):
    net.export(os.path.join(d, name), 0,
               input_names=tuple(shapes) if isinstance(shapes, dict)
               else ("data",))
    return onnx_mxnet.export_model(
        os.path.join(d, f"{name}-symbol.json"),
        os.path.join(d, f"{name}-0000.params"),
        shapes, dtype, os.path.join(d, f"{name}.onnx"))


def test_bert_small_roundtrip(tmp_path):
    """BERT through ONNX: Embedding, slice_like (position table),
    LayerNorm, per-position FCs, split-heads Reshapes with -4 codes,
    _contrib_flash_attention (exported as its dense decomposition) and
    gelu (Erf decomposition), at static export shapes."""
    from mxnet_tpu_torch.models import bert_small

    net = bert_small(init_weights=False)
    net.initialize(mx.init.Normal(0.02), ctx=CPU)
    net.eval()
    tok = np.random.RandomState(0).randint(0, 512, (2, 12)).astype("int32")
    y_ref = net(nd.array(tok, ctx=CPU, dtype="int32")).asnumpy()
    path = _export_net(net, str(tmp_path), "bert", [(2, 12)], np.int32)
    sym2, arg2, aux2 = onnx_mxnet.import_model(path, ctx=CPU)
    y2 = _forward(sym2, {**arg2, **aux2}, {"data": tok})[0]
    np.testing.assert_allclose(y_ref, y2, atol=2e-5, rtol=1e-4)


def test_seq2seq_transformer_roundtrip(tmp_path):
    """Encoder-decoder Transformer through ONNX: multi-input export (dict
    shapes), padding masks via not_equal/broadcast_like, the ops-built
    causal tril (ones_like/makediag/cumsum/where), shared embeddings, and
    the dense flash-attention decomposition."""
    from mxnet_tpu_torch.models.transformer import Transformer

    net = Transformer(vocab_size=32, units=16, hidden_size=32,
                      num_layers=2, num_heads=2, max_length=24,
                      tie_embeddings=False, init_weights=False)
    net.initialize(mx.init.Xavier(), ctx=CPU)
    net.eval()
    rng = np.random.RandomState(0)
    src = rng.randint(3, 32, (2, 7)).astype("int32")
    tgt = rng.randint(3, 32, (2, 5)).astype("int32")
    y_ref = net(nd.array(src, ctx=CPU, dtype="int32"),
                nd.array(tgt, ctx=CPU, dtype="int32")).asnumpy()
    path = _export_net(net, str(tmp_path), "tf",
                       {"src": (2, 7), "tgt": (2, 5)}, np.int32)
    sym2, arg2, aux2 = onnx_mxnet.import_model(path, ctx=CPU)
    y2 = _forward(sym2, {**arg2, **aux2}, {"src": src, "tgt": tgt})[0]
    np.testing.assert_allclose(y_ref, y2, atol=1e-5, rtol=1e-4)


def test_bert_import_to_gluon(tmp_path):
    """ONNX BERT -> SymbolBlock via import_to_gluon: parameter binding by
    initializer name at model scale, int32 token inputs."""
    from mxnet_tpu_torch.models import bert_small

    net = bert_small(num_layers=1, init_weights=False)
    net.initialize(mx.init.Normal(0.02), ctx=CPU)
    net.eval()
    tok = np.random.RandomState(3).randint(0, 512, (2, 8)).astype("int32")
    y_ref = net(nd.array(tok, ctx=CPU, dtype="int32")).asnumpy()
    path = _export_net(net, str(tmp_path), "b", [(2, 8)], np.int32)
    g = onnx_mxnet.import_to_gluon(path, ctx=CPU)
    y2 = g(nd.array(tok, ctx=CPU, dtype="int32"))
    y2 = (y2[0] if isinstance(y2, (list, tuple)) else y2).asnumpy()
    np.testing.assert_allclose(y_ref, y2, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("name,classes", [("resnet18_v1", 47),
                                          ("mobilenetv2_0.25", 12)])
def test_vision_roundtrip(name, classes, tmp_path):
    """ResNet-18 and MobileNet-v2 (the JAX file's slow-tier cases)."""
    from mxnet_tpu_torch.gluon.model_zoo import vision

    net = vision.get_model(name, classes=classes)
    net.initialize(mx.init.Xavier(), ctx=CPU)
    net.eval()
    x = np.random.RandomState(0).rand(1, 3, 64, 64).astype("float32")
    y_ref = net(nd.array(x, ctx=CPU)).asnumpy()
    path = _export_net(net, str(tmp_path), "v", [(1, 3, 64, 64)],
                       np.float32)
    sym2, arg2, aux2 = onnx_mxnet.import_model(path, ctx=CPU)
    y2 = _forward(sym2, {**arg2, **aux2}, {"data": x})[0]
    np.testing.assert_allclose(y_ref, y2, atol=1e-4, rtol=1e-4)


# --------------------------------------------------------------------------
# importer diagnostics: malformed/unsupported nodes raise a descriptive
# MXNetError instead of importing a silently wrong graph
# --------------------------------------------------------------------------
F32 = P.np_to_onnx_dtype(np.float32)


def _import_raw(nodes, inputs, outputs, initializers=()):
    from mxnet_tpu_torch.contrib.onnx.onnx2mx import import_onnx_model

    graph = P.make_graph(nodes, "g", inputs, outputs,
                         initializers=initializers)
    return import_onnx_model(P.make_model(graph), ctx=CPU)


def _ab():
    return [P.make_tensor_value_info("a", F32, None),
            P.make_tensor_value_info("b", F32, None)]


def _x24():
    return [P.make_tensor_value_info("x", F32, (2, 4))]


def test_split_uneven_sizes_raises():
    node = P.make_node("Split", ["x"], ["a", "b"], name="sp",
                       axis=1, split=[1, 3])
    with pytest.raises(MXNetError, match=r"uneven split sizes \[1, 3\]"):
        _import_raw([node], _x24(), _ab())


def test_split_even_sizes_imports():
    node = P.make_node("Split", ["x"], ["a", "b"], name="sp",
                       axis=1, split=[2, 2])
    sym2, arg2, _aux = _import_raw([node], _x24(), _ab())
    x = np.random.RandomState(0).rand(2, 4).astype(np.float32)
    outs = _forward(sym2, arg2, {"x": x})
    np.testing.assert_allclose(outs[0], x[:, :2])
    np.testing.assert_allclose(outs[1], x[:, 2:])


def test_split_opset13_uneven_input_sizes_raises():
    node = P.make_node("Split", ["x", "sp_sizes"], ["a", "b"], name="sp",
                       axis=1)
    with pytest.raises(MXNetError, match=r"uneven split sizes \[1, 3\]"):
        _import_raw([node], _x24(), _ab(), initializers=[P.make_tensor(
            "sp_sizes", np.array([1, 3], dtype=np.int64))])


def test_split_opset13_even_input_sizes_imports():
    node = P.make_node("Split", ["x", "sp_sizes"], ["a", "b"], name="sp",
                       axis=1)
    sym2, arg2, _aux = _import_raw(
        [node], _x24(), _ab(), initializers=[P.make_tensor(
            "sp_sizes", np.array([2, 2], dtype=np.int64))])
    assert "sp_sizes" not in arg2  # read statically only
    x = np.random.RandomState(0).rand(2, 4).astype(np.float32)
    outs = _forward(sym2, arg2, {"x": x})
    np.testing.assert_allclose(outs[0], x[:, :2])
    np.testing.assert_allclose(outs[1], x[:, 2:])


def test_split_opset13_runtime_input_sizes_still_imports():
    node = P.make_node("Split", ["x", "sp_sizes"], ["a", "b"], name="sp",
                       axis=1)
    sym2, arg2, _aux = _import_raw(
        [node],
        _x24() + [P.make_tensor_value_info(
            "sp_sizes", P.np_to_onnx_dtype(np.int64), (2,))],
        _ab())
    x = np.random.RandomState(0).rand(2, 4).astype(np.float32)
    outs = _forward(sym2, arg2, {"x": x})
    np.testing.assert_allclose(outs[0], x[:, :2])
    np.testing.assert_allclose(outs[1], x[:, 2:])


def test_constant_nontensor_value_raises():
    node = P.make_node("Constant", [], ["c"], name="k", value_float=1.5)
    add = P.make_node("Add", ["x", "c"], ["y"], name="add")
    with pytest.raises(MXNetError, match=r"Constant node 'c'.*value_float"):
        _import_raw([node, add], [P.make_tensor_value_info("x", F32, (2,))],
                    [P.make_tensor_value_info("y", F32, None)])


# --------------------------------------------------------------------------
# the two JAX-converter flaws, held to the correct result
# --------------------------------------------------------------------------


def test_initializer_read_statically_and_as_a_tensor_stays_a_param():
    """"s" is a Reshape's static shape AND a tensor added to the output:
    it must stay a param (the JAX const() drops it, and the graph then
    binds without its value)."""
    shape = np.array([4, 2], np.int64)
    nodes = [P.make_node("Reshape", ["x", "s"], ["r"], name="rs"),
             P.make_node("Cast", ["s"], ["sf"], name="cs", to=F32),
             P.make_node("Add", ["r", "sf"], ["y"], name="add")]
    sym2, arg2, _aux = _import_raw(
        nodes, [P.make_tensor_value_info("x", F32, (2, 4))],
        [P.make_tensor_value_info("y", F32, None)],
        initializers=[P.make_tensor("s", shape)])
    assert "s" in arg2
    np.testing.assert_array_equal(arg2["s"].asnumpy(), shape)
    x = np.random.RandomState(0).rand(2, 4).astype(np.float32)
    out = _forward(sym2, arg2, {"x": x})[0]
    np.testing.assert_allclose(out, x.reshape(4, 2) + shape.astype(
        np.float32))


@pytest.mark.parametrize("oidx", [1, 2])
def test_batchnorm_mean_or_var_read_refused_at_export(oidx, tmp_path):
    """A node reading BatchNorm's batch mean (1) or variance (2): the
    exported BatchNormalization has only output 0, so the export raises
    (the JAX exporter writes a graph with a dangling input)."""
    data = sym.Variable("data")
    bn = sym.BatchNorm(data, name="bn")
    node = bn._entries[0][0]  # the graph entry of output oidx, as a
    stat = sym.Symbol([(node, oidx)])  # graph file's [node, oidx] spells it
    s = sym.Group([bn, stat * 2.0])
    params = _fill_params(bn, {"data": (2, 3, 4, 4)})
    with pytest.raises(MXNetError, match=f"output {oidx} of BatchNorm"):
        onnx_mxnet.export_model(s, params, [(2, 3, 4, 4)], np.float32,
                                str(tmp_path / "m.onnx"))
    # the same graph reading output 0 only exports and round-trips
    s0 = bn * 2.0
    feeds = {"data": np.random.RandomState(1).rand(2, 3, 4, 4)
             .astype(np.float32)}
    _roundtrip(s0, params, feeds, tmp=str(tmp_path))


# ---------------------------------------------------------------------------
# quantized-graph export
# ---------------------------------------------------------------------------
def _quantized_mlp():
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.contrib.quantization import quantize_net

    mx.random.seed(0)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(16, activation="relu", in_units=8),
            gluon.nn.Dense(4, in_units=16))
    net.initialize(mx.init.Xavier(), ctx=CPU)
    x = np.random.RandomState(0).rand(8, 8).astype(np.float32)
    qnet = quantize_net(net, calib_data=[nd.array(x, ctx=CPU)],
                        calib_mode="naive")
    return qnet, x


def run_qdq_graph(graph, x):
    """Numpy interpretation of the exported QDQ node set: the oracle the
    file's bytes are checked against (``tests/test_onnx.py``'s)."""
    vals = {"data": x}
    for t in graph["initializer"]:
        vals[t["name"]] = t["array"]
    for n in graph["node"]:
        i = [vals[k] for k in n["input"]]
        op = n["op_type"]
        if op == "QuantizeLinear":
            vals[n["output"][0]] = np.clip(
                np.round(i[0] / i[1]), -128, 127).astype(np.int8)
        elif op == "DequantizeLinear":
            vals[n["output"][0]] = i[0].astype(np.float32) * i[1]
        elif op == "Gemm":
            w = i[1].T if n["attrs"].get("transB") else i[1]
            vals[n["output"][0]] = i[0] @ w + i[2]
        elif op == "MatMul":
            vals[n["output"][0]] = i[0] @ i[1]
        elif op == "Add":
            vals[n["output"][0]] = i[0] + i[1]
        elif op == "Relu":
            vals[n["output"][0]] = np.maximum(i[0], 0)
        elif op == "Flatten":
            vals[n["output"][0]] = i[0].reshape(i[0].shape[0], -1)
        else:
            raise AssertionError(f"unexpected op {op}")
    return vals[graph["output"][0]["name"]]


def test_export_quantized_qdq_structure_and_numerics(tmp_path):
    """The QDQ export carries QuantizeLinear / DequantizeLinear + int8
    weight initializers, and a numpy replay of the file's graph matches
    the int8 net within one scale step."""
    qnet, x = _quantized_mlp()
    qref = qnet(nd.array(x, ctx=CPU)).asnumpy()
    p = onnx_mxnet.export_quantized_net(qnet, (8, 8),
                                        str(tmp_path / "q.onnx"))
    model = P.parse_model(open(p, "rb").read())
    g = model["graph"]
    ops = [n["op_type"] for n in g["node"]]
    assert ops.count("QuantizeLinear") == 2       # one per quantized layer
    assert ops.count("DequantizeLinear") == 4     # activation + weight
    assert ops.count("Gemm") == 2 and "Relu" in ops
    int8_inits = [t for t in g["initializer"]
                  if t["array"].dtype == np.int8 and t["array"].ndim == 2]
    assert len(int8_inits) == 2, "weights must persist as int8"
    out = run_qdq_graph(g, x)
    np.testing.assert_allclose(out, qref, atol=1e-2)


def test_export_quantized_dequant_fallback_roundtrips(tmp_path):
    qnet, x = _quantized_mlp()
    qref = qnet(nd.array(x, ctx=CPU)).asnumpy()
    p = onnx_mxnet.export_quantized_net(qnet, (8, 8),
                                        str(tmp_path / "qd.onnx"),
                                        mode="dequant")
    model = P.parse_model(open(p, "rb").read())
    ops = [n["op_type"] for n in model["graph"]["node"]]
    assert "QuantizeLinear" not in ops  # pure f32 surface
    gnet = onnx_mxnet.import_to_gluon(p, ctx=CPU)
    out = gnet(nd.array(x, ctx=CPU)).asnumpy()
    np.testing.assert_allclose(out, qref, atol=5e-2)


def test_export_quantized_qdq_requires_calibrated_scales(tmp_path):
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.contrib.quantization import quantize_net

    mx.random.seed(0)
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(4, in_units=8))
    net.initialize(mx.init.Xavier(), ctx=CPU)
    qnet = quantize_net(net, calib_mode="none")
    with pytest.raises(MXNetError, match="calib_mode='none'"):
        onnx_mxnet.export_quantized_net(qnet, (2, 8),
                                        str(tmp_path / "x.onnx"))
    p = onnx_mxnet.export_quantized_net(qnet, (2, 8),
                                        str(tmp_path / "x.onnx"),
                                        mode="dequant")
    assert os.path.exists(p)
    with pytest.raises(MXNetError, match="mode"):
        onnx_mxnet.export_quantized_net(qnet, (2, 8),
                                        str(tmp_path / "y.onnx"),
                                        mode="qlinear")
