"""The port's ResNet path vs the JAX package's, on the CPU.

``resnet50_v1b`` at ``entry()``'s shape (8, 3, 64, 64), in NCHW and NHWC:
the JAX net is initialized by ``mx.init.Xavier()`` under a numpy seed,
its arrays are carried into the port by name (``convert``), and both
nets run one forward in eval mode and one in training mode on the same
numpy images (the JAX one through ``_block_apply_fn``, jitted), after
which the port's BatchNorm buffers hold the running stats the JAX
forward returns as aux.  Tolerances, relative to the largest magnitude
of the JAX value: eval logits 1e-5; training logits 3e-4, because a
training-mode BatchNorm over a small batch (the last stage sees 8 x 2 x
2 values a channel) amplifies rounding: the port's own f32 forward
differs from its float64 one by 7e-5 of the logits' scale; running stats
2e-4 (one momentum step of those batch stats).

The ``Convolution``, ``Pooling`` and ``BatchNorm`` ops against the JAX
ops case by case at f32, atol 1e-5 (rtol 1e-5); ``convert`` and
``initializer.Xavier`` on the ResNet names and layouts.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu import nd as jnd
from mxnet_tpu.gluon.model_zoo.vision import resnet50_v1b as jax_resnet50_v1b
from mxnet_tpu.initializer import Xavier as JaxXavier
from mxnet_tpu.ops import nn as jops
from mxnet_tpu.parallel.data_parallel import _block_apply_fn
from mxnet_tpu_torch import nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import from_mxnet_tpu_params, gluon_name
from mxnet_tpu_torch.gluon.block import cast
from mxnet_tpu_torch.gluon.nn import BatchNorm, Conv2D
from mxnet_tpu_torch.initializer import Xavier, initialize
from mxnet_tpu_torch.models.resnet import (BottleneckV1, ResNetV1,
                                           resnet50_v1b)
from mxnet_tpu_torch.ops import nn as tops

LAYOUTS = ("NCHW", "NHWC")
N_ARRAYS, N_VALUES = 267, 25_610_152


def _images(layout, n=8, res=64, seed=1):
    shape = (n, 3, res, res) if layout == "NCHW" else (n, res, res, 3)
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _jax_apply(net, train, x):
    """Logits and the aux (BatchNorm running stats) of one jitted
    forward of the JAX net."""
    fn, items = _block_apply_fn(net, mx.cpu(), train=train)
    names = []

    def body(params, key, data):
        out, aux = fn(params, key, data)
        names[:] = [n for n, _ in aux]
        return out, [v for _, v in aux]

    params = {n: p.data()._data for n, p in items}
    out, aux = jax.jit(body)(params, jax.random.PRNGKey(0), x)
    return np.asarray(out), {n: np.asarray(v) for n, v in zip(names, aux)}


@pytest.fixture(scope="module", params=LAYOUTS)
def jax_resnet(request):
    layout = request.param
    mx.random.seed(0)
    np.random.seed(0)
    net = jax_resnet50_v1b(layout=layout)
    net.initialize(mx.init.Xavier())
    with jautograd.pause():  # resolves the deferred shapes
        net(jnd.zeros((1, 3, 64, 64) if layout == "NCHW" else (1, 64, 64, 3)))
    params = {k: p.data().asnumpy() for k, p in net.collect_params().items()}
    x = _images(layout)
    port = resnet50_v1b(layout=layout, device="cpu")
    from_mxnet_tpu_params(port, params, net.prefix)
    return {"layout": layout, "net": net, "params": params, "x": x,
            "port": port, "eval": _jax_apply(net, False, x),
            "train": _jax_apply(net, True, x)}


def _port(jr):
    """A fresh copy of the port's net carrying the JAX weights."""
    return copy.deepcopy(jr["port"])


def _close(got, want, rel):
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_resnet50_v1b_forward_matches_jax(jax_resnet, mode):
    net = _port(jax_resnet)
    net.train(mode == "train")
    with torch.no_grad():
        out = net(torch.from_numpy(jax_resnet["x"])).numpy()
    want = jax_resnet[mode][0]
    assert out.shape == want.shape == (8, 1000)
    _close(out, want, 1e-5 if mode == "eval" else 3e-4)


def test_batchnorm_running_stats_after_one_training_forward(jax_resnet):
    net = _port(jax_resnet)
    net.train()
    with torch.no_grad():
        net(torch.from_numpy(jax_resnet["x"]))
    aux = jax_resnet["train"][1]
    prefix = jax_resnet["net"].prefix
    stats = {prefix + gluon_name(net, k): v.numpy()
             for k, v in net.state_dict().items()
             if k.endswith(("running_mean", "running_var"))}
    assert set(stats) == set(aux) and len(aux) == 2 * 53
    for name, value in stats.items():
        _close(value, aux[name], 2e-4)
    # eval mode leaves them where they are
    before = {k: v.clone() for k, v in net.state_dict().items()}
    net.eval()
    with torch.no_grad():
        net(torch.from_numpy(jax_resnet["x"]))
    assert all(torch.equal(v, before[k]) for k, v in net.state_dict().items())


def test_convert_carries_every_resnet_name(jax_resnet):
    params = jax_resnet["params"]
    assert len(params) == N_ARRAYS
    assert sum(v.size for v in params.values()) == N_VALUES
    net = _port(jax_resnet)
    prefix = jax_resnet["net"].prefix
    state = net.state_dict()
    assert sorted(prefix + gluon_name(net, k) for k in state) == sorted(params)
    assert sum(v.numel() for v in state.values()) == N_VALUES
    # an NHWC weight (O, kh, kw, I) lands as torch's OIHW, value for value
    w = params[prefix + "stage1_conv2d1_weight"]
    got = state["features.4.0.body.3.weight"].numpy()
    want = w.transpose(0, 3, 1, 2) if jax_resnet["layout"] == "NHWC" else w
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        state["features.1.running_var"].numpy(),
        params[prefix + "batchnorm0_running_var"])


def test_convert_refuses_missing_extra_and_misshapen(jax_resnet):
    params = dict(jax_resnet["params"])
    prefix = jax_resnet["net"].prefix
    net = _port(jax_resnet)
    missing = dict(params)
    del missing[prefix + "stage3_batchnorm7_running_mean"]
    with pytest.raises(MXNetError, match="missing.*stage3_batchnorm7"):
        from_mxnet_tpu_params(net, missing, prefix)
    extra = dict(params, **{prefix + "stage5_conv2d0_weight":
                            np.zeros((1, 1, 1, 1), np.float32)})
    with pytest.raises(MXNetError, match="extra.*stage5_conv2d0"):
        from_mxnet_tpu_params(net, extra, prefix)
    bad = dict(params, **{prefix + "dense0_bias": np.zeros(999, np.float32)})
    with pytest.raises(MXNetError, match="dense0_bias"):
        from_mxnet_tpu_params(net, bad, prefix)


@pytest.mark.parametrize("depth,kw", [(18, {"thumbnail": True}),
                                      (34, {}), (101, {"layout": "NHWC"})])
def test_resnet_family_names_match_jax(depth, kw):
    """Every depth takes the JAX package's names in its order of
    creation (BasicBlockV1's downsample after its body, the thumbnail
    stem with no BatchNorm), which the JAX net gives before any shape is
    known."""
    from mxnet_tpu.gluon.model_zoo.vision import get_resnet as jax_get_resnet
    from mxnet_tpu_torch.models.resnet import get_resnet

    v1b = depth == 101
    jnet = jax_get_resnet(1, depth, stride_in_1x1=not v1b, **kw)
    net = get_resnet(1, depth, stride_in_1x1=not v1b, device="cpu", **kw)
    names = [jnet.prefix + gluon_name(net, k) for k in net.state_dict()]
    assert names == list(jnet.collect_params().keys())


def test_cast_takes_parameters_and_running_stats():
    net = ResNetV1(BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256],
                   classes=10, layout="NHWC", device="cpu")
    assert cast(net, "bfloat16") is net
    assert all(t.dtype == torch.bfloat16 for t in net.state_dict().values())
    conv = net.features[0]
    assert conv.weight.is_contiguous(memory_format=torch.channels_last)
    assert isinstance(conv.weight, torch.nn.Parameter)


# ---------------------------------------------------------------------------
# the ops, case by case
# ---------------------------------------------------------------------------
def _rand(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _conv_case(layout, kernel, stride, pad, dilate, groups, bias):
    cin, cout = 4, 6
    x = _rand(1, 2, cin, 9, 11)
    w = _rand(2, cout, cin // groups, *kernel)
    if layout == "NHWC":
        x, w = x.transpose(0, 2, 3, 1), w.transpose(0, 2, 3, 1)
    args = [x, w] + ([_rand(3, cout)] if bias else [])
    attrs = dict(kernel=kernel, stride=stride, pad=pad, dilate=dilate,
                 num_filter=cout, num_group=groups, no_bias=not bias,
                 layout=layout)
    return "Convolution", args, attrs


def _pool_case(layout, **attrs):
    x = _rand(4, 2, 3, 9, 10)
    if layout == "NHWC":
        x = x.transpose(0, 2, 3, 1)
    return "Pooling", [x], dict(attrs, layout=layout)


def _bn_case(layout, training, fix_gamma, output_mean_var=False):
    x = _rand(5, 4, 3, 5, 6) * 3 + 1
    axis = 1
    if layout == "NHWC":
        x, axis = x.transpose(0, 2, 3, 1), -1
    gamma, beta = _rand(6, 3) + 1, _rand(7, 3)
    mean, var = _rand(8, 3), np.abs(_rand(9, 3)) + 0.5
    return "BatchNorm", [x, gamma, beta, mean, var], dict(
        eps=1e-5, fix_gamma=fix_gamma, output_mean_var=output_mean_var,
        axis=axis, training=training)


OP_CASES = {
    "conv_nchw": _conv_case("NCHW", (3, 3), (1, 1), (1, 1), (1, 1), 1, True),
    "conv_nhwc": _conv_case("NHWC", (3, 3), (1, 1), (1, 1), (1, 1), 1, True),
    "conv_stride_nchw": _conv_case("NCHW", (3, 2), (2, 2), (1, 0), (1, 1),
                                   1, False),
    "conv_stride_nhwc": _conv_case("NHWC", (3, 2), (2, 2), (1, 0), (1, 1),
                                   1, False),
    "conv_dilate_groups_nchw": _conv_case("NCHW", (3, 3), (1, 2), (2, 1),
                                          (2, 1), 2, True),
    "conv_dilate_groups_nhwc": _conv_case("NHWC", (3, 3), (1, 2), (2, 1),
                                          (2, 1), 2, True),
    "conv_1x1_nhwc": _conv_case("NHWC", (1, 1), (2, 2), (0, 0), (1, 1), 1,
                                False),
    "max_valid_nchw": _pool_case("NCHW", kernel=(3, 3), stride=(2, 2),
                                 pad=(1, 1), pool_type="max"),
    "max_valid_nhwc": _pool_case("NHWC", kernel=(3, 3), stride=(2, 2),
                                 pad=(1, 1), pool_type="max"),
    "max_full_nchw": _pool_case("NCHW", kernel=(2, 3), stride=(2, 2),
                                pad=(1, 1), pool_type="max",
                                pooling_convention="full"),
    "max_full_nhwc": _pool_case("NHWC", kernel=(2, 2), stride=(2, 3),
                                pad=(1, 1), pool_type="max",
                                pooling_convention="full"),
    "avg_valid_nchw": _pool_case("NCHW", kernel=(3, 3), stride=(2, 2),
                                 pad=(1, 1), pool_type="avg"),
    "avg_no_pad_count_nhwc": _pool_case("NHWC", kernel=(3, 3),
                                        stride=(2, 2), pad=(1, 1),
                                        pool_type="avg",
                                        count_include_pad=False),
    "avg_full_nchw": _pool_case("NCHW", kernel=(3, 3), stride=(2, 2),
                                pad=(1, 1), pool_type="avg",
                                pooling_convention="full"),
    "avg_full_no_pad_count_nchw": _pool_case(
        "NCHW", kernel=(2, 2), stride=(2, 2), pad=(1, 1), pool_type="avg",
        pooling_convention="full", count_include_pad=False),
    "sum_nchw": _pool_case("NCHW", kernel=(2, 2), stride=(1, 1),
                           pool_type="sum"),
    "global_avg_nchw": _pool_case("NCHW", pool_type="avg", global_pool=True),
    "global_avg_nhwc": _pool_case("NHWC", pool_type="avg", global_pool=True),
    "global_max_nhwc": _pool_case("NHWC", pool_type="max", global_pool=True),
    "bn_train_nchw": _bn_case("NCHW", True, False, True),
    "bn_train_nhwc": _bn_case("NHWC", True, False, True),
    "bn_train_fix_gamma_nchw": _bn_case("NCHW", True, True),
    "bn_eval_nchw": _bn_case("NCHW", False, False),
    "bn_eval_fix_gamma_nhwc": _bn_case("NHWC", False, True),
}
JAX_OPS = {"Convolution": jops.convolution, "Pooling": jops.pooling,
           "BatchNorm": jops.batch_norm}
PORT_OPS = {"Convolution": tops.convolution, "Pooling": tops.pooling,
            "BatchNorm": tops.batch_norm}


@pytest.mark.parametrize("case", sorted(OP_CASES))
def test_nn_ops_match_jax(case):
    """Each op against the JAX op on the same arrays: the output (and,
    with ``output_mean_var``, the batch mean and biased variance), and
    the gradients of the data and the weights through torch's autograd
    and ``jax.vjp`` (rtol = atol = 1e-4: a backward chains products)."""
    name, args, attrs = OP_CASES[case]
    want = JAX_OPS[name](*(jnp.asarray(a) for a in args), **attrs)
    want = [np.asarray(w) for w in (want if isinstance(want, tuple)
                                    else (want,))]
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    got = PORT_OPS[name](*leaves, **attrs)
    got = list(got) if isinstance(got, tuple) else [got]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-5,
                                   atol=1e-5)
    # gradients of the output through both packages
    cot = _rand(11, *want[0].shape)
    _, vjp = jax.vjp(lambda *xs: _first(JAX_OPS[name](*xs, **attrs)),
                     *(jnp.asarray(a) for a in args))
    jgrads = vjp(jnp.asarray(cot))
    tgrads = torch.autograd.grad(got[0], leaves, torch.from_numpy(cot),
                                 allow_unused=True)
    for i, (tg, jg) in enumerate(zip(tgrads, jgrads)):
        if name == "BatchNorm" and i >= 3:
            continue  # the running stats (no gradient in training mode)
        jg = np.asarray(jg)
        tg = np.zeros_like(jg) if tg is None else tg.numpy()
        np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-4,
                                   err_msg=f"input {i}")


def _first(out):
    return out[0] if isinstance(out, tuple) else out


def test_ops_are_registered_in_nd():
    """``nd.Convolution``, ``nd.Pooling`` and ``nd.BatchNorm`` dispatch
    to the same functions."""
    name, args, attrs = OP_CASES["conv_nhwc"]
    out = nd.Convolution(*(nd.array(a, ctx="cpu") for a in args), **attrs)
    want = tops.convolution(*(torch.from_numpy(a) for a in args), **attrs)
    assert torch.equal(out._data, want)
    _, args, attrs = OP_CASES["max_full_nchw"]
    out = nd.Pooling(nd.array(args[0], ctx="cpu"), **attrs)
    assert torch.equal(out._data, tops.pooling(torch.from_numpy(args[0]),
                                               **attrs))
    _, args, attrs = OP_CASES["bn_eval_nchw"]
    out = nd.BatchNorm(*(nd.array(a, ctx="cpu") for a in args), **attrs)
    assert torch.equal(out._data, tops.batch_norm(
        *(torch.from_numpy(a) for a in args), **attrs))


@pytest.mark.parametrize("op,shape,attrs", [
    ("Convolution", (2, 3, 8), {"kernel": (3,), "num_filter": 4,
                                "layout": "NCHW"}),
    ("Convolution", (2, 3, 4, 4, 4, 4), {"kernel": (3, 3, 3, 3),
                                         "num_filter": 4}),
    ("Convolution", (2, 8, 3), {"kernel": (3,), "num_filter": 4,
                                "layout": "NHWC"}),
    ("Convolution", (2, 3, 8, 8), {"kernel": (3, 3), "num_filter": 4,
                                   "layout": "NCDHW"}),
    ("Pooling", (2, 3, 8), {"kernel": (2,), "layout": "NHWC"}),
    ("Pooling", (2, 3, 4, 4, 4, 4), {"kernel": (2, 2, 2, 2)}),
    ("Pooling", (2, 8, 8, 3), {"kernel": (2, 2), "layout": "NDHWC"}),
])
def test_conv_and_pooling_ops_refuse_what_is_not_2d(op, shape, attrs):
    """The ops take 1, 2 or 3 spatial axes, each in its own two layouts
    (``tests/test_torch_conv_nd.py`` holds them to the JAX ops): four
    spatial axes, or a layout of another rank, raise instead of running
    untested."""
    x = torch.zeros(shape)
    args = (x,)
    if op == "Convolution":
        kernel = attrs["kernel"]
        args += (torch.zeros((4, shape[1]) + tuple(kernel)),)
    with pytest.raises(MXNetError):
        getattr(tops, op.lower())(*args, **attrs)


# ---------------------------------------------------------------------------
# initializer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("layout", LAYOUTS)
def test_xavier_scale_follows_the_gluon_shape(layout):
    """Xavier's bound comes from the Gluon shape of the weight, so a 3x3
    conv of 64 -> 64 channels draws from U(-s, s) with s =
    sqrt(3 / 576) in NCHW, (64, 64, 3, 3), and sqrt(3 / 6432) in NHWC,
    (64, 3, 3, 64), as the JAX initializer does."""
    conv = Conv2D(64, 3, padding=1, in_channels=64, layout=layout,
                  use_bias=False, prefix="conv2d0_")
    initialize(conv, Xavier(), torch.Generator().manual_seed(0))
    gshape = conv.gluon_shape("weight")
    s = np.sqrt(3 / (576 if layout == "NCHW" else 6432))
    assert Xavier().scale(gshape) == pytest.approx(s)
    w = conv.weight.detach()
    assert 0.99 * s < float(w.abs().max()) <= s
    np.random.seed(0)
    jw = np.zeros(gshape, np.float32)
    JaxXavier()._init_weight("conv2d0_weight", jw)
    assert 0.99 * s < float(np.abs(jw).max()) <= s
    assert abs(float(w.std()) - float(jw.std())) < 0.02 * s


def test_xavier_is_reproducible_under_a_seed():
    def draw(seed):
        return ResNetV1(BottleneckV1, [1, 1, 1, 1], [16, 32, 64, 128, 256],
                        classes=10, stride_in_1x1=False, layout="NHWC",
                        device="cpu",
                        generator=torch.Generator().manual_seed(seed))

    a, b, c = draw(3).state_dict(), draw(3).state_dict(), draw(4).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["output.weight"], c["output.weight"])
    assert torch.equal(a["features.1.weight"], torch.ones(16))
    assert torch.equal(a["features.1.running_var"], torch.ones(16))
    assert torch.equal(a["output.bias"], torch.zeros(10))
    # an NHWC weight is channels_last memory, its Gluon view contiguous
    conv = draw(3).features[0]
    assert conv.weight.is_contiguous(memory_format=torch.channels_last)
    assert conv.weight.permute(0, 2, 3, 1).is_contiguous()


def test_batchnorm_layer_moves_running_stats_in_their_dtype():
    """The moving update rounds as Gluon's does in the running stats'
    dtype: running * m, then batch_stat.astype(dtype) * (1 - m), then
    their sum."""
    bn = BatchNorm(3, axis=-1)
    bn.running_mean.fill_(0.3)
    x = torch.from_numpy(_rand(12, 2, 4, 4, 3) * 2 + 0.7)
    bn = bn.to(torch.bfloat16)
    bn.train()
    with torch.no_grad():
        bn(x.to(torch.bfloat16))
    mean = x.to(torch.bfloat16).float().mean(dim=(0, 1, 2))
    want = (torch.full((3,), 0.3, dtype=torch.bfloat16) * 0.9
            + mean.to(torch.bfloat16) * (1 - 0.9))
    assert bn.running_mean.dtype == torch.bfloat16
    assert torch.equal(bn.running_mean, want)
