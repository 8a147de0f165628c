"""The port's Gluon core against the JAX package's, in one process.

Nets are built in both packages under an explicit prefix (the name-scope
counters are per package, so two packages in one process count apart);
weights are drawn by the JAX package and carried by name (numpy only);
inputs come from numpy's ``RandomState``.  Covered: Parameter names and
Gluon shapes (LeNet, the MLP, a 2-layer BERT, a 2 + 2-layer
Transformer, ResNet-50 v1b in both layouts), the structural names ``save_parameters`` writes, files written
by either package loaded by the other bit for bit (NHWC convolution
weights included, ``nd.save`` in both formats, bfloat16 through its
bits), deferred shapes, hybridized forwards and the ``CachedOp`` entry
counts, the two call conventions of a block, every ported loss (forward
and input gradient), the initializers, ``random.seed`` and the
Parameter / ParameterDict API.

Tolerances: forwards and losses in f32 within ``rtol=1e-5, atol=1e-6``
(sums in another order), BERT logits within ``atol=1e-5`` (as
``tests/test_torch_bert.py``), gradients of the losses within
``rtol=1e-5, atol=1e-7``; files and deterministic initializers exact.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon.model_zoo.vision import resnet as jresnet
from mxnet_tpu.models import bert_small as jax_bert_small

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import gluon_name
from mxnet_tpu_torch.gluon.parameter import DeferredInitializationError
from mxnet_tpu_torch.models.bert import bert_small
from mxnet_tpu_torch.models.resnet import resnet50_v1b

FWD = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-5, atol=1e-7)
CPU = tmx.cpu()
RNG = np.random.RandomState(0)
IMAGES = RNG.randn(16, 1, 28, 28).astype(np.float32)


def lenet(gluon, prefix="net_", layout="NCHW"):
    net = gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(gluon.nn.Conv2D(20, 5, activation="relu", layout=layout),
                gluon.nn.MaxPool2D(2, 2, layout=layout),
                gluon.nn.Conv2D(50, 5, activation="relu", layout=layout),
                gluon.nn.MaxPool2D(2, 2, layout=layout), gluon.nn.Flatten(),
                gluon.nn.Dense(500, activation="relu"), gluon.nn.Dense(10))
    return net


def mlp(gluon, prefix="net_"):
    net = gluon.nn.HybridSequential(prefix=prefix)
    with net.name_scope():
        net.add(gluon.nn.Flatten(), gluon.nn.Dense(128, activation="relu"),
                gluon.nn.Dense(64, activation="relu"), gluon.nn.Dense(10))
    return net


def _images(layout):
    return IMAGES if layout == "NCHW" else IMAGES.transpose(0, 2, 3, 1).copy()


def _jax(build, layout="NCHW"):
    net = build(jgluon) if build is mlp else build(jgluon, layout=layout)
    net.initialize(jmx.init.Xavier(), ctx=jmx.cpu())
    net(jnd.array(_images(layout), ctx=jmx.cpu()))
    return net


def _port(build, jnet, layout="NCHW"):
    net = build(tgluon) if build is mlp else build(tgluon, layout=layout)
    net.initialize(ctx=CPU)
    params = net.collect_params()
    for k, p in jnet.collect_params().items():
        params[k].set_data(p.data().asnumpy())
    return net


# ---------------------------------------------------------------------------
# names and shapes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["lenet", "mlp"])
def test_names_and_gluon_shapes_match_jax(kind):
    build = {"lenet": lenet, "mlp": mlp}[kind]
    jnet = _jax(build)
    tnet = build(tgluon)
    tnet.initialize(tmx.init.Xavier(), ctx=CPU)
    tnet(tnd.array(IMAGES, ctx=CPU))
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert list(tp.keys()) == list(jp.keys())
    assert [tp[k].shape for k in tp] == [tuple(jp[k].shape) for k in jp]
    assert (list(tnet._collect_params_with_prefix())
            == list(jnet._collect_params_with_prefix()))


def test_bert_names_shapes_and_structure_match_jax():
    jnet = jax_bert_small(dropout=0.0, prefix="m_")
    jnet.initialize(jmx.init.Normal(0.02))
    jnet(jnd.array(RNG.randint(0, 512, (2, 8)), dtype="int32"))
    tnet = bert_small(dropout=0.0, device="cpu", prefix="m_")
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert list(tp.keys()) == list(jp.keys())
    assert all(tp[k].shape == tuple(jp[k].shape) for k in tp)
    assert (list(tnet._collect_params_with_prefix())
            == list(jnet._collect_params_with_prefix()))
    # the names convert.from_mxnet_tpu_params maps are the same names
    assert [tnet.prefix + gluon_name(tnet, k) for k in tnet.state_dict()] \
        == list(tp.keys())


@pytest.mark.parametrize("tie", [True, False])
def test_transformer_names_match_jax(tie):
    from mxnet_tpu.models.transformer import Transformer as JaxTransformer
    from mxnet_tpu_torch.models.transformer import Transformer

    cfg = dict(units=32, hidden_size=64, num_heads=4, num_layers=2,
               max_length=16, tie_embeddings=tie, prefix="t_")
    jnet = JaxTransformer(100, **cfg)
    tnet = Transformer(100, device="cpu", **cfg)
    assert list(tnet.collect_params()) == list(jnet.collect_params())
    assert (list(tnet._collect_params_with_prefix())
            == list(jnet._collect_params_with_prefix()))
    assert [tnet.prefix + gluon_name(tnet, k) for k in tnet.state_dict()] \
        == list(tnet.collect_params())


@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_resnet_names_match_jax(layout):
    jnet = jresnet.resnet50_v1b(classes=10, layout=layout, prefix="r_")
    tnet = resnet50_v1b(classes=10, layout=layout, device="cpu",
                        init_weights=False, prefix="r_")
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert list(tp.keys()) == list(jp.keys())
    for k in tp:  # the JAX shapes still hold 0 where deferred
        assert all(j in (0, t) for j, t in zip(jp[k].shape, tp[k].shape))
    assert (list(tnet._collect_params_with_prefix())
            == list(jnet._collect_params_with_prefix()))


# ---------------------------------------------------------------------------
# files
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_save_parameters_load_in_the_other_package(direction, layout,
                                                   tmp_path):
    """``save_parameters`` in one package, ``load_parameters`` in the
    other: the values bit for bit, in Gluon's layout in the file (an NHWC
    convolution's weight is (O, kh, kw, I) there and OIHW in the port's
    tensor)."""
    fname = str(tmp_path / "net.params")
    src = _jax(lenet, layout)
    want = {k: p.data().asnumpy() for k, p in src.collect_params().items()}
    if direction == "jax_to_port":
        src.save_parameters(fname)
        dst = lenet(tgluon, layout=layout)
        dst.load_parameters(fname, ctx=CPU)
        conv = dst[0]
        assert tuple(conv.weight.shape) == (20, 1, 5, 5)
    else:
        port = _port(lenet, src, layout)
        port.save_parameters(fname)
        dst = lenet(jgluon, layout=layout)
        dst.load_parameters(fname, ctx=jmx.cpu())
    got = {k: p.data().asnumpy() for k, p in dst.collect_params().items()}
    if direction == "jax_to_port" and layout == "NHWC":
        # data() is the port's tensor; the Gluon layout is what was saved
        got = {k: dst.collect_params()[k]._gluon_data().numpy()
               for k in got}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    out_j = src(jnd.array(_images(layout), ctx=jmx.cpu())).asnumpy()
    port = dst if direction == "jax_to_port" else _port(lenet, src, layout)
    out_t = port(tnd.array(_images(layout), ctx=CPU)).asnumpy()
    np.testing.assert_allclose(out_t, out_j, **FWD)


@pytest.mark.parametrize("fmt", ["native", "legacy"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_nd_save_load_across_packages(fmt, direction, tmp_path):
    """``nd.save`` of f32, f16, bf16 and int arrays (a dict, and a list)
    in one package loads bit for bit in the other."""
    import ml_dtypes

    r = np.random.RandomState(1)
    f32 = r.randn(3, 4).astype(np.float32)
    f16 = r.randn(5).astype(np.float16)
    bf16 = r.randn(2, 3).astype(ml_dtypes.bfloat16)
    i32 = r.randint(-9, 9, (4,)).astype(np.int32)
    fname = str(tmp_path / "arrays")
    if direction == "jax_to_port":
        arrays = {"a": jnd.array(f32), "b": jnd.array(f16, dtype=f16.dtype),
                  "c": jnd.array(bf16, dtype="bfloat16"),
                  "d": jnd.array(i32, dtype=np.int32)}
        (jnd.save if fmt == "native" else
         __import__("mxnet_tpu.ndarray.utils", fromlist=["x"]).save_legacy)(
            fname, arrays)
        loaded = tnd.load(fname)
        bits = {k: (v._data.view(torch.int16).numpy().view(np.uint16)
                    if v._data.dtype == torch.bfloat16 else v.asnumpy())
                for k, v in loaded.items()}
    else:
        arrays = {"a": tnd.array(f32, ctx=CPU),
                  "b": tnd.array(f16, ctx=CPU, dtype=np.float16),
                  "c": tnd.NDArray(torch.from_numpy(
                      bf16.view(np.int16).copy()).view(torch.bfloat16)),
                  "d": tnd.array(i32, ctx=CPU, dtype=np.int32)}
        (tnd.save if fmt == "native" else tnd.save_legacy)(fname, arrays)
        loaded = jnd.load(fname)
        bits = {k: (np.asarray(v.asnumpy()).view(np.uint16) if k == "c"
                    else v.asnumpy()) for k, v in loaded.items()}
    assert sorted(bits) == ["a", "b", "c", "d"]
    np.testing.assert_array_equal(bits["a"], f32)
    np.testing.assert_array_equal(bits["b"], f16)
    np.testing.assert_array_equal(bits["c"], bf16.view(np.uint16))
    np.testing.assert_array_equal(bits["d"], i32)
    assert bits["b"].dtype == np.float16 and bits["d"].dtype == np.int32
    # a list keeps its order
    (tnd.save if fmt == "native" else tnd.save_legacy)(
        fname, [tnd.array(f32, ctx=CPU), tnd.array(i32, ctx=CPU,
                                                   dtype=np.int32)])
    back = jnd.load(fname)
    assert isinstance(back, list)
    np.testing.assert_array_equal(back[0].asnumpy(), f32)


def test_save_params_full_names_round_trip(tmp_path):
    fname = str(tmp_path / "full.params")
    jnet = _jax(mlp)
    tnet = _port(mlp, jnet)
    tnet.save_params(fname)
    other = mlp(tgluon)
    other.load_params(fname, ctx=CPU)
    for (k, p), (_, q) in zip(tnet.collect_params().items(),
                              other.collect_params().items()):
        np.testing.assert_array_equal(p.data().asnumpy(), q.data().asnumpy())
    with pytest.raises(MXNetError, match="missing"):
        lenet(tgluon).load_parameters(fname, ctx=CPU)


# ---------------------------------------------------------------------------
# deferred shapes, forwards, CachedOp
# ---------------------------------------------------------------------------
def test_deferred_shapes_finish_at_the_first_call():
    net = mlp(tgluon)
    net.initialize(tmx.init.Xavier(), ctx=CPU)
    w = net.collect_params()["net_dense0_weight"]
    assert w.shape == (128, 0)
    with pytest.raises(DeferredInitializationError):
        w.data()
    net(tnd.array(IMAGES[:2], ctx=CPU))
    assert w.shape == (128, 784) and w.data().shape == (128, 784)
    # the draw is Xavier's over the inferred fans
    s = np.sqrt(3.0 / ((784 + 128) / 2))
    assert np.abs(w.data().asnumpy()).max() <= s
    # a tensor call finishes them too
    net2 = mlp(tgluon)
    net2.initialize(ctx=CPU)
    net2(torch.from_numpy(IMAGES[:2]))
    assert net2.collect_params()["net_dense2_weight"].shape == (10, 64)


@pytest.mark.parametrize("kind", ["lenet", "mlp"])
def test_hybridized_forward_matches_jax_and_counts_cached_op_entries(kind):
    """Predict-mode forwards at two batch sizes and one recorded training
    forward: the outputs equal the JAX net's, and the port's CachedOp
    holds one entry per (train flag, input signature), as many as the
    JAX CachedOp's jitted programs specialize."""
    build = {"lenet": lenet, "mlp": mlp}[kind]
    jnet = _jax(build)
    tnet = _port(build, jnet)
    jnet.hybridize()
    tnet.hybridize()
    for n in (16, 8):
        out_j = jnet(jnd.array(IMAGES[:n])).asnumpy()
        out_t = tnet(tnd.array(IMAGES[:n], ctx=CPU))
        assert isinstance(out_t, tnd.NDArray)
        np.testing.assert_allclose(out_t.asnumpy(), out_j, **FWD)
    for pkg_ag, net, arr in ((jag, jnet, jnd.array(IMAGES[:8])),
                             (tag, tnet, tnd.array(IMAGES[:8], ctx=CPU))):
        with pkg_ag.record():
            net(arr)
    jit = jnet._cached_op._jitted
    jax_count = sum(f._cache_size() for (train, _), f in jit.items()
                    if not train) + sum(1 for train, _ in jit if train)
    assert tnet._cached_op.num_entries == jax_count == 3
    assert tnet._cached_op.entries[
        (False, (((16, 1, 28, 28), torch.float32, CPU),), ())]["calls"] == 1


def test_bert_hybridized_forward_matches_jax():
    tokens = RNG.randint(0, 512, (2, 16)).astype(np.int32)
    jnet = jax_bert_small(dropout=0.0, prefix="b_")
    jnet.initialize(jmx.init.Normal(0.02))
    jnet(jnd.array(tokens, dtype="int32"))
    tnet = bert_small(dropout=0.0, init_weights=False, prefix="b_")
    tnet.initialize(ctx=CPU)
    for k, p in tnet.collect_params().items():
        p.set_data(jnet.collect_params()[k].data().asnumpy())
    jnet.hybridize()
    tnet.hybridize()
    out_j = jnet(jnd.array(tokens, dtype="int32")).asnumpy()
    out_t = tnet(tnd.array(tokens, ctx=CPU, dtype=np.int64)).asnumpy()
    np.testing.assert_allclose(out_t, out_j, atol=1e-5)


def test_bert_gluon_initialize_normal():
    """``init_weights=False`` then ``initialize(Normal(0.02))``, as the JAX
    BERT: weights from N(0, 0.02), biases and LayerNorm shifts 0, scales
    1, on the device asked for."""
    tnet = bert_small(dropout=0.0, init_weights=False)
    tnet.initialize(tmx.init.Normal(0.02), ctx=CPU)
    for name, p in tnet.collect_params().items():
        v = p.data().asnumpy()
        if name.endswith(("bias", "beta")):
            assert not v.any()
        elif name.endswith("gamma"):
            assert (v == 1).all()
        else:
            assert 0.015 < v.std() < 0.025, name


def test_block_call_conventions():
    """NDArrays: grad only under record, train mode by MXNet's flag,
    NDArray outputs.  Tensors: torch's module mode and grad mode."""
    net = tgluon.nn.HybridSequential(prefix="c_")
    with net.name_scope():
        net.add(tgluon.nn.Dense(32, in_units=8), tgluon.nn.Dropout(0.5),
                tgluon.nn.BatchNorm(in_channels=32))
    net.initialize(ctx=CPU)
    x = RNG.randn(64, 8).astype(np.float32)
    a = net(tnd.array(x, ctx=CPU))
    b = net(tnd.array(x, ctx=CPU))
    assert isinstance(a, tnd.NDArray) and not a._data.requires_grad
    np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())  # predict mode
    assert not net.training
    with tag.record():
        c = net(tnd.array(x, ctx=CPU))
    assert c._data.requires_grad and net.training
    assert (c.asnumpy() != a.asnumpy()).any()  # dropout and batch stats
    a = net(tnd.array(x, ctx=CPU))  # the running stats moved
    net.eval()
    t = net(torch.from_numpy(x))
    assert isinstance(t, torch.Tensor) and t.requires_grad
    np.testing.assert_allclose(t.detach().numpy(), a.asnumpy(), **FWD)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
_P = RNG.randn(6, 5).astype(np.float32)
_L_SPARSE = RNG.randint(0, 5, 6).astype(np.float32)
_L_DENSE = np.abs(RNG.randn(6, 5)).astype(np.float32)
_L_DENSE /= _L_DENSE.sum(-1, keepdims=True)
_L_SIGNED = np.sign(RNG.randn(6, 5)).astype(np.float32)
_L_01 = (RNG.rand(6, 5) > 0.5).astype(np.float32)
_SW = RNG.rand(6, 1).astype(np.float32)
LOSSES = {
    "l2": ("L2Loss", {}, _L_DENSE, None),
    "l1_weighted": ("L1Loss", {"weight": 0.5}, _L_DENSE, _SW),
    "sce_sparse": ("SoftmaxCrossEntropyLoss", {}, _L_SPARSE, None),
    "sce_sparse_weighted": ("SoftmaxCrossEntropyLoss", {"weight": 2.0},
                            _L_SPARSE, _SW),
    "sce_dense": ("SoftmaxCrossEntropyLoss", {"sparse_label": False},
                  _L_DENSE, None),
    "sce_from_logits": ("SoftmaxCrossEntropyLoss", {"from_logits": True},
                        _L_SPARSE, None),
    "sigmoid_bce": ("SigmoidBinaryCrossEntropyLoss", {}, _L_01, None),
    "sigmoid_bce_from_sigmoid": ("SigmoidBinaryCrossEntropyLoss",
                                 {"from_sigmoid": True}, _L_01, None),
    "kldiv": ("KLDivLoss", {"from_logits": False}, _L_DENSE, None),
    "huber": ("HuberLoss", {"rho": 0.5}, _L_DENSE, _SW),
    "hinge": ("HingeLoss", {}, _L_SIGNED, None),
    "squared_hinge": ("SquaredHingeLoss", {}, _L_SIGNED, None),
    "logistic": ("LogisticLoss", {}, _L_SIGNED, None),
}


def _loss_run(pkg_nd, pkg_ag, gluon, name, kw, inputs, ctx, sample_weight):
    loss = getattr(gluon.loss, name)(**kw)
    arrays = [pkg_nd.array(a, ctx=ctx) for a in inputs]
    arrays[0].attach_grad()
    extra = ([pkg_nd.array(sample_weight, ctx=ctx)]
             if sample_weight is not None else [])
    with pkg_ag.record():
        out = loss(*arrays, *extra)
    out.backward()
    return out.asnumpy(), arrays[0].grad.asnumpy()


@pytest.mark.parametrize("case", sorted(LOSSES))
def test_loss_matches_jax(case):
    name, kw, label, sw = LOSSES[case]
    pred = (1 / (1 + np.exp(-_P))).astype(np.float32) \
        if kw.get("from_sigmoid") else _P
    if kw.get("from_logits"):
        pred = (_P - np.log(np.exp(_P).sum(-1, keepdims=True))) \
            .astype(np.float32)
    want = _loss_run(jnd, jag, jgluon, name, kw, [pred, label], jmx.cpu(), sw)
    got = _loss_run(tnd, tag, tgluon, name, kw, [pred, label], CPU, sw)
    assert got[0].shape == want[0].shape == (6,)
    np.testing.assert_allclose(got[0], want[0], **FWD)
    np.testing.assert_allclose(got[1], want[1], **GRAD)


def test_triplet_loss_matches_jax():
    a, p, n = (RNG.randn(6, 5).astype(np.float32) for _ in range(3))
    want = _loss_run(jnd, jag, jgluon, "TripletLoss", {}, [a, p, n],
                     jmx.cpu(), None)
    got = _loss_run(tnd, tag, tgluon, "TripletLoss", {}, [a, p, n], CPU,
                    None)
    np.testing.assert_allclose(got[0], want[0], **FWD)
    np.testing.assert_allclose(got[1], want[1], **GRAD)


def test_cosine_embedding_loss_matches_jax_forward_and_true_gradient():
    """The forward equals the JAX loss's.  The JAX package's gradient of
    this loss is twice the central difference of its own forward (a fault
    of the reference, ROADMAP C), so the port's gradient is held against
    that difference, in float64 (rtol 1e-4: f32 against f64)."""
    a, p = (RNG.randn(6, 5).astype(np.float32) for _ in range(2))
    lab = np.sign(RNG.randn(6)).astype(np.float32)
    want = _loss_run(jnd, jag, jgluon, "CosineEmbeddingLoss", {},
                     [a, p, lab], jmx.cpu(), None)
    got = _loss_run(tnd, tag, tgluon, "CosineEmbeddingLoss", {},
                    [a, p, lab], CPU, None)
    np.testing.assert_allclose(got[0], want[0], **FWD)

    def f(x):
        x, q = x.astype(np.float64), p.astype(np.float64)
        cos = (x * q).sum(-1) / (np.linalg.norm(x, axis=-1)
                                 * np.linalg.norm(q, axis=-1) + 1e-12)
        return np.where(lab == 1, 1 - cos, np.maximum(cos, 0)).sum()

    fd = np.zeros(a.shape)
    for i in np.ndindex(a.shape):
        e = np.zeros(a.shape)
        e[i] = 1e-6
        fd[i] = (f(a + e) - f(a - e)) / 2e-6
    np.testing.assert_allclose(got[1], fd, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(want[1], 2 * fd, rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# initializers, random, Parameter API
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("case", ["constant", "one", "zero", "bilinear",
                                  "lstmbias", "dispatch"])
def test_deterministic_initializers_match_jax(case):
    make = {"constant": lambda m: m.init.Constant(0.3),
            "one": lambda m: m.init.One(), "zero": lambda m: m.init.Zero(),
            "bilinear": lambda m: m.init.Bilinear(),
            "lstmbias": lambda m: m.init.LSTMBias(2.0),
            "dispatch": lambda m: m.init.Constant(0.7)}[case]
    names = {"bilinear": [("up_weight", (2, 1, 4, 4))],
             "lstmbias": [("lstm_i2h_bias", (16,)), ("lstm_w", (8, 3))],
             "dispatch": [("ln_gamma", (3,)), ("ln_beta", (3,)),
                          ("bn_running_mean", (3,)),
                          ("bn_running_var", (3,)), ("d_bias", (3,)),
                          ("d_weight", (2, 3))]}.get(case,
                                                     [("x_weight", (3, 4))])
    for name, shape in names:
        want = make(jmx).init_array(name, shape, np.float32)
        got = make(tmx).init_array(name, shape)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", ["uniform", "normal", "xavier_in_gauss",
                                  "msraprelu", "orthogonal", "mixed",
                                  "by_name"])
def test_random_initializers(case):
    tmx.random.seed(3)
    shape = (64, 32)
    if case == "uniform":
        v = tmx.init.Uniform(0.2).init_array("w", shape).numpy()
        assert np.abs(v).max() <= 0.2 and v.std() == pytest.approx(
            0.2 / np.sqrt(3), rel=0.05)
    elif case == "normal":
        v = tmx.init.Normal(0.5).init_array("w", shape).numpy()
        assert v.std() == pytest.approx(0.5, rel=0.05)
    elif case == "xavier_in_gauss":
        v = tmx.init.Xavier("gaussian", "in", 2).init_array(
            "w", shape).numpy()
        assert v.std() == pytest.approx(np.sqrt(2 / 32), rel=0.05)
    elif case == "msraprelu":
        v = tmx.init.MSRAPrelu().init_array("w", shape).numpy()
        assert v.std() == pytest.approx(
            np.sqrt(2 / (1 + 0.25 ** 2) / 48), rel=0.05)
    elif case == "orthogonal":
        v = tmx.init.Orthogonal(scale=1.0).init_array("w", (16, 32)).numpy()
        np.testing.assert_allclose(v @ v.T, np.eye(16), atol=1e-5)
    elif case == "mixed":
        init = tmx.init.Mixed([".*bias", ".*"],
                              [tmx.init.One(), tmx.init.Constant(2.0)])
        assert (init.init_array("a_bias", (2,)).numpy() == 0).all()
        assert (init.init_array("a_weight", (2, 2)).numpy() == 2).all()
    else:
        assert isinstance(tmx.init.create("xavier"), tmx.init.Xavier)
        assert isinstance(tmx.init.create("zeros"), tmx.init.Zero)
        c = tmx.init.create('["constant", {"value": 4.0}]')
        assert (c.init_array("w", (2,)).numpy() == 4).all()
        assert isinstance(tmx.init.create(None), tmx.init.Uniform)


def test_random_seed_repeats_initialization_and_dropout():
    outs = []
    for _ in range(2):
        tmx.random.seed(11)
        net = mlp(tgluon)
        net.initialize(tmx.init.Xavier(), ctx=CPU)
        net(tnd.array(IMAGES[:2], ctx=CPU))
        drop = tgluon.nn.Dropout(0.5)
        with tag.record():
            d = drop(tnd.ones((64,), ctx=CPU))
        outs.append([p.data().asnumpy() for p in
                     net.collect_params().values()] + [d.asnumpy()])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    assert tmx.random.generator("cpu") is torch.default_generator


def test_parameter_api():
    p = tgluon.Parameter("w", shape=(3, 4), init=tmx.init.One())
    with pytest.raises(MXNetError, match="not been initialized"):
        p.data()
    with pytest.raises(MXNetError, match="A.9"):
        p.initialize(ctx=[tmx.cpu(), tmx.cpu()])
    p.initialize(ctx=CPU)
    assert p.list_ctx() == [CPU] and (p.data().asnumpy() == 1).all()
    assert p.grad().asnumpy().shape == (3, 4) and not p.grad().asnumpy().any()
    p.set_data(np.full((3, 4), 2.0, np.float32))
    assert (p.list_data()[0].asnumpy() == 2).all()
    p.grad_req = "null"
    assert not p.data()._data.requires_grad
    with pytest.raises(MXNetError, match="null"):
        p.grad()
    p.grad_req = "write"
    p.lr_mult = 0.5
    assert p.data()._data.lr_mult == 0.5
    p.cast("float64")
    assert p.data()._data.dtype == torch.float64 and p.dtype == "float64"
    p.reset_ctx(CPU)
    c = tgluon.Constant("c", np.arange(3, dtype=np.float32))
    c.initialize(ctx=CPU)
    assert c.grad_req == "null" and list(c.data().asnumpy()) == [0, 1, 2]
    d = tgluon.ParameterDict("pre_")
    w = d.get("w", shape=(2,))
    assert d.get("w") is w and w.name == "pre_w"
    assert d.get_constant("k", [1.0]).name == "pre_k"
    d.setattr("wd_mult", 0.0)
    assert w.wd_mult == 0.0
    other = tgluon.ParameterDict("pre_")
    other.get("w", shape=(2,))
    with pytest.raises(MXNetError, match="duplicate"):
        d.update(other)


def test_parameter_dict_save_load_and_zero_grad(tmp_path):
    jnet = _jax(mlp)
    tnet = _port(mlp, jnet)
    params = tnet.collect_params()
    fname = str(tmp_path / "dict.params")
    params.save(fname, strip_prefix="net_")
    fresh = mlp(tgluon)
    fresh.collect_params().load(fname, ctx=CPU, restore_prefix="net_")
    for k in params:
        np.testing.assert_array_equal(
            params[k].data().asnumpy(),
            fresh.collect_params()[k].data().asnumpy())
    with tag.record():
        out = tnet(tnd.array(IMAGES[:4], ctx=CPU))
    out.backward()
    assert params["net_dense0_weight"].grad().asnumpy().any()
    params.zero_grad()
    assert not params["net_dense0_weight"].grad().asnumpy().any()


def test_block_cast_and_custom_hybrid_forward():
    """A block written in Gluon's style: Parameters made with
    ``params.get`` in ``__init__``, ``hybrid_forward(F, x, w)``."""

    class Scale(tgluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.w = self.params.get("w", shape=(4,),
                                         init=tmx.init.Constant(3.0))

        def hybrid_forward(self, F, x, w):
            return F.broadcast_mul(x, w) if hasattr(F, "broadcast_mul") \
                else x * w

    blk = Scale(prefix="s_")
    blk.initialize(ctx=CPU)
    assert list(blk.collect_params()) == ["s_w"]
    x = tnd.array(np.ones((2, 4), np.float32), ctx=CPU)
    x.attach_grad()
    with tag.record():
        y = blk(x)
    y.backward()
    assert (y.asnumpy() == 3).all()
    assert (blk.collect_params()["s_w"].grad().asnumpy() == 2).all()
    blk.cast("bfloat16")
    assert blk.w.dtype == torch.bfloat16
    assert blk.collect_params()["s_w"].dtype == "bfloat16"


def _hook_trace(gluon, nd, ctx):
    """What a Gluon pre-hook and hook on ``Dense(3, in_units=4)``, and a
    hook on the second child of a ``HybridSequential``, see on a call with
    ``nd.ones((2, 4))``: the argument and output types and the values
    ``asnumpy`` reads inside the hooks."""
    seen = []

    def pre(block, args):
        seen.append(("pre", type(args[0]).__name__, args[0].asnumpy()))

    def post(block, args, out):
        seen.append(("post", type(args[0]).__name__, type(out).__name__,
                     out.asnumpy()))

    dense = gluon.nn.Dense(3, in_units=4, prefix="hooked_")
    dense.initialize(jmx.init.One() if gluon is jgluon else tmx.init.One(),
                     **({"ctx": ctx} if ctx is not None else {}))
    dense.register_forward_pre_hook(pre)
    dense.register_forward_hook(post)
    dense(nd.ones((2, 4), **({"ctx": ctx} if ctx is not None else {})))
    seq = gluon.nn.HybridSequential(prefix="hseq_")
    with seq.name_scope():
        seq.add(gluon.nn.Dense(3, in_units=4), gluon.nn.Dense(2, in_units=3))
    seq.initialize(jmx.init.One() if gluon is jgluon else tmx.init.One(),
                   **({"ctx": ctx} if ctx is not None else {}))
    seq[1].register_forward_hook(post)
    seq(nd.ones((2, 4), **({"ctx": ctx} if ctx is not None else {})))
    return seen


def test_hooks_get_ndarrays_as_in_jax():
    """C.5: on a call with NDArrays, a Gluon hook gets NDArrays in and out,
    on the block and on a child of a ``HybridSequential``, as the JAX
    hooks do; a call with torch tensors stays a torch module call, whose
    hooks see tensors."""
    jseen = _hook_trace(jgluon, jnd, None)
    tseen = _hook_trace(tgluon, tnd, CPU)
    assert [s[:-1] for s in tseen] == [s[:-1] for s in jseen] == [
        ("pre", "NDArray"), ("post", "NDArray", "NDArray"),
        ("post", "NDArray", "NDArray")]
    for j, t in zip(jseen, tseen):
        np.testing.assert_array_equal(t[-1], j[-1])
    net = tgluon.nn.Dense(3, in_units=4, prefix="hooked_")
    net.initialize(tmx.init.One(), ctx=CPU)
    types = []
    net.register_forward_hook(
        lambda blk, args, out: types.append((type(args[0]), type(out))))
    net(torch.ones(2, 4))
    assert types == [(torch.Tensor, torch.Tensor)]
