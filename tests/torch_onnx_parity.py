"""Helpers of the ONNX parity tests (``test_torch_onnx_parity.py``,
``test_torch_onnx_cross.py``): the graphs of ``tests/test_onnx.py`` built
by the port (a Symbol, or a net's ``HybridBlock.export`` files) with
seeded weights, both packages' ``export_model`` on that one graph file,
and each package's importer run on the CPU."""


import numpy as np
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from mxnet_tpu.contrib import onnx as jonnx
from mxnet_tpu_torch.contrib import onnx as tonnx
from mxnet_tpu_torch.contrib.onnx import proto as TP

CPU = tmx.cpu()
TOL = {"default": dict(atol=1e-5, rtol=1e-5),
       "bert": dict(atol=2e-5, rtol=1e-4),
       "seq2seq": dict(atol=1e-5, rtol=1e-4)}


def _weights(sym, input_shapes, seed=0):
    """Seeded params for a port Symbol, as _fill_params of test_onnx.py."""
    rng = np.random.RandomState(seed)
    shapes, _, aux_shapes = sym.infer_shape(**input_shapes)
    params = {}
    for name, shp in zip(sym.list_arguments(), shapes):
        if name not in input_shapes:
            params[name] = rng.randn(*shp).astype("float32") * 0.1
    for name, shp in zip(sym.list_auxiliary_states(), aux_shapes):
        base = np.abs(rng.randn(*shp).astype("float32")) * 0.1
        params[name] = base + (1.0 if "var" in name else 0.0)
    return params


def _save(tmp_path, sym, params, aux):
    """One graph file and one params file (``arg:`` / ``aux:`` keys)."""
    path = str(tmp_path / "g")
    sym.save(f"{path}-symbol.json")
    tmx.nd.save(f"{path}-0000.params",
                {(f"aux:{k}" if k in aux else f"arg:{k}"):
                 tmx.nd.array(v, ctx=CPU) for k, v in params.items()})
    return f"{path}-symbol.json", f"{path}-0000.params"


def _conv_bn(mx):
    sym = mx.sym
    data = sym.Variable("data")
    c = sym.Convolution(data, kernel=(3, 3), num_filter=8, pad=(1, 1),
                        name="conv1")
    b = sym.BatchNorm(c, name="bn1")
    a = sym.Activation(b, act_type="relu", name="relu1")
    p = sym.Pooling(a, kernel=(2, 2), stride=(2, 2), pool_type="max",
                    name="pool1")
    f = sym.FullyConnected(p, num_hidden=10, name="fc1")
    return sym.softmax(f, name="sm")


MINI = {"V": 16, "D": 8, "T": 6, "B": 2}


def _mini_transformer(mx):
    sym = mx.sym
    V, D = MINI["V"], MINI["D"]
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
    return sym.sum(first, axis=-1, keepdims=False, name="out")


def _symbol_case(build, shapes, feeds, dtype, tmp_path):
    sym = build(tmx)
    params = _weights(sym, shapes)
    aux = set(sym.list_auxiliary_states())
    files = _save(tmp_path, sym, params, aux)
    ex = sym.simple_bind(ctx=CPU, grad_req="null", **shapes)
    for k, v in params.items():
        (ex.aux_dict if k in aux else ex.arg_dict)[k][:] = \
            tmx.nd.array(v, ctx=CPU)
    for k, v in feeds.items():
        ex.arg_dict[k][:] = tmx.nd.array(v, ctx=CPU, dtype=v.dtype)
    want = [o.asnumpy() for o in ex.forward(is_train=False)]
    return files, [shapes[k] for k in sym.list_arguments()
                   if k in shapes], dtype, feeds, want


def _net_case(make, names, feeds, dtype, tmp_path):
    """A port net initialized from a seed, exported: its files, its
    input shapes, its eager output."""
    net = make()
    tmx.random.seed(0)
    net.initialize(tmx.init.Normal(0.02), ctx=CPU)
    net.eval()
    inputs = [tmx.nd.array(feeds[n], ctx=CPU, dtype=feeds[n].dtype)
              for n in names]
    with torch.no_grad():
        want = net(*inputs)
    want = want if isinstance(want, (list, tuple)) else [want]
    path = str(tmp_path / "net")
    net.export(path, 0, input_names=names)
    shapes = ({n: feeds[n].shape for n in names} if len(names) > 1
              else [feeds[names[0]].shape])
    return ((f"{path}-symbol.json", f"{path}-0000.params"), shapes, dtype,
            feeds, [w.asnumpy() for w in want])


def _bert_small():
    from mxnet_tpu_torch.models import bert_small

    return bert_small(init_weights=False, prefix="bertformlm0_")


def _seq2seq():
    from mxnet_tpu_torch.models.transformer import Transformer

    return Transformer(vocab_size=32, units=16, hidden_size=32,
                       num_layers=2, num_heads=2, max_length=24,
                       tie_embeddings=False, init_weights=False,
                       prefix="transformer0_")


def _zoo(name, **kw):
    from mxnet_tpu_torch.gluon.model_zoo import vision

    return lambda: vision.get_model(name, **kw)


def _case(name, tmp_path):
    rng = np.random.RandomState(0)
    if name == "conv_bn_pool_fc":
        x = rng.rand(2, 3, 8, 8).astype(np.float32)
        return _symbol_case(_conv_bn, {"data": x.shape}, {"data": x},
                            np.float32, tmp_path)
    if name == "mini_transformer":
        tok = rng.randint(0, MINI["V"], (MINI["B"], MINI["T"])).astype(
            np.int32)
        return _symbol_case(_mini_transformer, {"tokens": tok.shape},
                            {"tokens": tok}, np.int32, tmp_path)
    if name == "bert_small":
        tok = rng.randint(0, 512, (2, 12)).astype(np.int32)
        return _net_case(_bert_small, ("data",), {"data": tok}, np.int32,
                         tmp_path)
    if name == "seq2seq":
        src = rng.randint(3, 32, (2, 7)).astype(np.int32)
        tgt = rng.randint(3, 32, (2, 5)).astype(np.int32)
        return _net_case(_seq2seq, ("src", "tgt"), {"src": src, "tgt": tgt},
                         np.int32, tmp_path)
    x = rng.rand(1, 3, 64, 64).astype(np.float32)
    make = (_zoo("resnet18_v1", classes=47) if name == "resnet18_v1"
            else _zoo("mobilenetv2_0.25", classes=12))
    return _net_case(make, ("data",), {"data": x}, np.float32, tmp_path)


CASES = ("conv_bn_pool_fc", "mini_transformer", "bert_small", "seq2seq",
         "resnet18_v1", "mobilenetv2_0.25")


def both(name, tmp_path):
    (sym_f, par_f), shapes, dtype, feeds, want = _case(name, tmp_path)
    jpath = jonnx.export_model(sym_f, par_f, shapes, dtype,
                               str(tmp_path / "jax.onnx"))
    tpath = tonnx.export_model(sym_f, par_f, shapes, dtype,
                               str(tmp_path / "port.onnx"))
    return jpath, tpath, feeds, want


def decoded(path):
    with open(path, "rb") as f:
        return TP.parse_model(f.read())


def run_port(path, feeds):
    sym, arg, aux = tonnx.import_model(path, ctx=CPU)
    ex = sym.simple_bind(ctx=CPU, grad_req="null",
                         **{k: v.shape for k, v in feeds.items()})
    for k, v in {**arg, **aux}.items():
        (ex.aux_dict if k in ex.aux_dict else ex.arg_dict)[k][:] = v
    for k, v in feeds.items():
        ex.arg_dict[k][:] = tmx.nd.array(v, ctx=CPU, dtype=v.dtype)
    return [o.asnumpy() for o in ex.forward(is_train=False)]


def run_jax(path, feeds):
    sym, arg, aux = jonnx.import_model(path)
    ex = sym.simple_bind(ctx=jmx.cpu(),
                         **{k: v.shape for k, v in feeds.items()})
    for k, v in {**arg, **aux}.items():
        (ex.aux_dict if k in ex.aux_dict else ex.arg_dict)[k][:] = v
    for k, v in feeds.items():
        ex.arg_dict[k][:] = jmx.nd.array(v, dtype=v.dtype)
    return [o.asnumpy() for o in ex.forward(is_train=False)]
