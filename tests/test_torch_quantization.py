"""The port's int8/int4 quantization against the JAX package's, case for
case with tests/test_quantization_subgraph.py (the op and ``quantize_net``
cases) and ``test_quantize_dequantize_roundtrip_vs_oracle`` of
tests/test_quantized_serving.py.

Inputs are drawn with numpy from fixed seeds and go through both packages
in this process on the CPU.  Tolerances, stated before the first run:

  * ``quantize_v2``, ``dequantize``, ``requantize``, the quantized FC and
    convolution: the int8 and int32 outputs, and the f32 ranges, are
    EQUAL to the JAX ops' (the same f32 expressions, half-to-even
    rounding, exact integer products);
  * ``_quantize_weight_np`` and ``_quantize_weight_int4_np``: byte for
    byte; ``dequantize_int4``: equal;
  * entropy thresholds (one array, and a streaming histogram over three
    batches): equal;
  * ``quantize_net`` outputs of one MLP / conv net carried across: within
    0.02 * max(1, max|f32 output|) of the JAX quantized net's (the
    calibration of a layer after the first sees f32 activations that the
    two packages round differently, so an int8 code can move by one);
    the JAX test's own bound against f32 is 0.1 of that scale;
  * a degenerate calibration raises naming the layer path and the mode.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.contrib import quantization as jqz
from mxnet_tpu_torch import gluon, nd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import quantization as qz
from mxnet_tpu_torch.convert import from_mxnet_tpu_params
from mxnet_tpu_torch.ops import quantization as q


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else x.detach().numpy()


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _equal(port_outs, jax_outs):
    for a, b in zip(port_outs, jax_outs):
        a, b = _np(a), _np(b)
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a.reshape(b.shape), b)


# ---------------------------------------------------------------------------
# the ops: exact
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("calib", [None, 1.0, 2.5])
def test_quantize_and_dequantize_equal_jax(calib):
    x = np.random.RandomState(0).uniform(-3, 5, (4, 6)).astype(np.float32)
    kw = {} if calib is None else {"min_calib_range": -calib,
                                   "max_calib_range": calib}
    tq = q.quantize_v2(_t(x), **kw)
    jq = jnd.contrib.quantize_v2(jnd.array(x), **kw)
    _equal(tq, jq)
    assert tq[0].dtype == torch.int8
    _equal([q.dequantize(*tq)], [jnd.contrib.dequantize(*jq)])
    # the nd namespace reaches the same op
    nq = nd.contrib.quantize_v2(nd.array(x, ctx="cpu"), **kw)
    _equal(nq, jq)


def test_roundtrip_vs_oracle():
    """The numpy scheme of tests/test_quantized_serving.py, exactly."""
    rng = np.random.RandomState(0)
    x = (rng.randn(64).astype(np.float32) * 3).astype(np.float32)
    t = float(np.abs(x).max())
    qx, mn, mx_ = q.quantize_v2(_t(x), min_calib_range=-t,
                                max_calib_range=t)
    ref_q = np.clip(np.round(x * (127.0 / t)), -127, 127).astype(np.int8)
    np.testing.assert_array_equal(qx.numpy(), ref_q)
    back = q.dequantize(qx, mn, mx_).numpy()
    np.testing.assert_allclose(back, x, atol=t / 127.0 + 1e-6)
    # half to even, as jnp.round: 0.5 -> 0, 1.5 -> 2, -2.5 -> -2
    halves = np.array([0.5, 1.5, -2.5, 127.0], np.float32)
    got = q.quantize_v2(_t(halves), min_calib_range=-127.0,
                        max_calib_range=127.0)[0].numpy()
    np.testing.assert_array_equal(got, [0, 2, -2, 127])


def _fc_inputs(seed, rows=3, k=8, n=4):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (rows, k)).astype(np.float32)
    w = rng.uniform(-1, 1, (n, k)).astype(np.float32)
    b = rng.uniform(-1, 1, n).astype(np.float32)
    return x, w, b


@pytest.mark.parametrize("no_bias", [False, True])
@pytest.mark.parametrize("shape", [(3, 8), (2, 5, 8), (40, 4096)])
def test_quantized_fc_equal_jax(no_bias, shape):
    rng = np.random.RandomState(1)
    k = shape[-1]
    x = rng.uniform(-1, 1, shape).astype(np.float32)
    w = rng.uniform(-1, 1, (24, k)).astype(np.float32)
    b = rng.uniform(-1, 1, 24).astype(np.float32)
    x.reshape(-1, k)[0] = 1.0  # one output sums 127^2 * k
    w[0] = 1.0
    flatten = len(shape) == 2
    tx, tw = q.quantize_v2(_t(x)), q.quantize_v2(_t(w))
    jx, jw = jnd.contrib.quantize_v2(jnd.array(x)), \
        jnd.contrib.quantize_v2(jnd.array(w))
    tout = q.quantized_fully_connected(tx[0], tw[0], _t(b), tx[1], tx[2],
                                       tw[1], tw[2], num_hidden=24,
                                       no_bias=no_bias, flatten=flatten)
    jout = jnd.contrib.quantized_fully_connected(
        jx[0], jw[0], jnd.array(b), jx[1], jx[2], jw[1], jw[2],
        num_hidden=24, no_bias=no_bias, flatten=flatten)
    _equal(tout, jout)
    assert tout[0].dtype == torch.int32
    _equal([q.dequantize(*tout)], [jnd.contrib.dequantize(*jout)])
    # the int32 accumulator of the 4096-wide case is beyond f32's 2^24
    if k == 4096:
        assert int(np.abs(_np(tout[0])).max()) > 2 ** 24


def test_int8_matmul_is_the_integer_product():
    rng = np.random.RandomState(2)
    a = rng.randint(-127, 128, (5, 37)).astype(np.int8)
    w = rng.randint(-127, 128, (11, 37)).astype(np.int8)
    got = q.int8_matmul(_t(a), _t(w)).numpy()
    np.testing.assert_array_equal(
        got, a.astype(np.int64) @ w.astype(np.int64).T)
    assert got.dtype == np.int32


@pytest.mark.parametrize("no_bias", [True, False])
@pytest.mark.parametrize("stride,pad,groups", [(1, 1, 1), (2, 0, 1),
                                               (1, 1, 2)])
def test_quantized_conv_equal_jax(no_bias, stride, pad, groups):
    rng = np.random.RandomState(2)
    x = rng.uniform(-1, 1, (2, 4, 8, 8)).astype(np.float32)
    w = rng.uniform(-1, 1, (6, 4 // groups, 3, 3)).astype(np.float32)
    b = rng.uniform(-1, 1, 6).astype(np.float32)
    kw = dict(kernel=(3, 3), num_filter=6, stride=(stride, stride),
              pad=(pad, pad), num_group=groups, no_bias=no_bias)
    tx, tw = q.quantize_v2(_t(x)), q.quantize_v2(_t(w))
    jx, jw = jnd.contrib.quantize_v2(jnd.array(x)), \
        jnd.contrib.quantize_v2(jnd.array(w))
    tout = q.quantized_conv(tx[0], tw[0], _t(b), tx[1], tx[2], tw[1],
                            tw[2], **kw)
    jout = jnd.contrib.quantized_conv(jx[0], jw[0], jnd.array(b), jx[1],
                                      jx[2], jw[1], jw[2], **kw)
    _equal(tout, jout)


@pytest.mark.parametrize("calib", [None, 0.5])
def test_requantize_equal_jax(calib):
    x, w, _b = _fc_inputs(3)
    kw = {} if calib is None else {"min_calib_range": -calib,
                                   "max_calib_range": calib}
    tx, tw = q.quantize_v2(_t(x)), q.quantize_v2(_t(w))
    jx, jw = jnd.contrib.quantize_v2(jnd.array(x)), \
        jnd.contrib.quantize_v2(jnd.array(w))
    tacc = q.quantized_fully_connected(tx[0], tw[0], None, tx[1], tx[2],
                                       tw[1], tw[2], num_hidden=4,
                                       no_bias=True)
    jacc = jnd.contrib.quantized_fully_connected(
        jx[0], jw[0], jnd.zeros((4,)), jx[1], jx[2], jw[1], jw[2],
        num_hidden=4, no_bias=True)
    _equal(q.requantize(*tacc, **kw), jnd.contrib.requantize(*jacc, **kw))


# ---------------------------------------------------------------------------
# the weight packers: byte for byte
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape", [(4, 8), (16, 37), (3, 1)])
def test_quantize_weight_np_byte_for_byte(shape):
    w = np.random.RandomState(4).randn(*shape).astype(np.float32)
    tq, tt = qz._quantize_weight_np(w)
    jq, jt = jqz._quantize_weight_np(w)
    assert tq.tobytes() == jq.tobytes() and tt == jt


@pytest.mark.parametrize("group", [2, 8, 32])
@pytest.mark.parametrize("shape", [(8, 64), (5, 37), (3, 1)])
def test_int4_packer_byte_for_byte_and_dequantize(group, shape):
    w = np.random.RandomState(5).randn(*shape).astype(np.float32)
    tp, ts, tc = qz._quantize_weight_int4_np(w, group)
    jp, js, jc = jqz._quantize_weight_int4_np(w, group)
    assert tp.dtype == jp.dtype == np.uint8 and ts.dtype == np.float16
    assert tp.tobytes() == jp.tobytes()
    assert ts.tobytes() == js.tobytes() and tc == jc
    got = q.dequantize_int4(_t(tp), _t(ts), group_size=group, cols=tc)
    want = jnd.contrib.dequantize_int4(jnd.array(jp, dtype=np.uint8),
                                       jnd.array(js, dtype=np.float16),
                                       group_size=group, cols=jc)
    _equal([got], [want])
    assert got.shape == shape


def test_int4_packer_rejects_odd_groups_and_3d():
    with pytest.raises(MXNetError, match="even"):
        qz._quantize_weight_int4_np(np.ones((2, 4), np.float32), 3)
    with pytest.raises(MXNetError, match="2-D"):
        qz._quantize_weight_int4_np(np.ones((2, 2, 2), np.float32))


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------
def test_entropy_threshold_equal_jax():
    rng = np.random.RandomState(4)
    arr = np.concatenate([rng.uniform(-1, 1, 100000), [100.0]])
    arr = arr.astype(np.float32)
    t = qz.calib_entropy_threshold(arr)
    assert t == jqz.calib_entropy_threshold(arr)
    assert t < 15.0, t


@pytest.mark.parametrize("mode", ["naive", "entropy"])
def test_streaming_calibrator_equal_jax(mode):
    rng = np.random.RandomState(6)
    batches = [rng.randn(500).astype(np.float32) * s for s in (1, 3, 0.5)]
    tc, jc = qz._Calibrator(mode), jqz._Calibrator(mode)
    for b in batches:
        tc.observe("x", b)
        jc.observe("x", b)
    assert tc.threshold("x") == jc.threshold("x")
    assert tc.minmax["x"] == jc.minmax["x"]


# ---------------------------------------------------------------------------
# quantize_net
# ---------------------------------------------------------------------------
def _mlp_pair(seed, hybridize=False):
    mx.random.seed(seed)
    jnet = jgluon.nn.HybridSequential(prefix="mlp_")
    with jnet.name_scope():
        jnet.add(jgluon.nn.Dense(32, activation="relu", in_units=10),
                 jgluon.nn.Dense(16, activation="relu", in_units=32),
                 jgluon.nn.Dense(4, in_units=16))
    jnet.initialize(mx.init.Xavier())
    tnet = gluon.nn.HybridSequential(prefix="mlp_")
    with tnet.name_scope():
        tnet.add(gluon.nn.Dense(32, activation="relu", in_units=10),
                 gluon.nn.Dense(16, activation="relu", in_units=32),
                 gluon.nn.Dense(4, in_units=16))
    tnet.initialize(ctx=mx_cpu())
    from_mxnet_tpu_params(tnet, {k: p.data().asnumpy() for k, p in
                                 jnet.collect_params().items()}, "mlp_")
    if hybridize:
        jnet.hybridize()
        tnet.hybridize()
    return jnet, tnet


def mx_cpu():
    import mxnet_tpu_torch

    return mxnet_tpu_torch.cpu()


def _close_to_jax(tout, jout, ref):
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(_np(tout), _np(jout), rtol=0,
                               atol=0.02 * scale)


@pytest.mark.parametrize("mode", ["none", "naive", "entropy"])
def test_quantize_net_close_to_jax(mode):
    jnet, tnet = _mlp_pair(5)
    x = np.random.RandomState(5).uniform(-1, 1, (16, 10)).astype(np.float32)
    jx, tx = jnd.array(x), nd.array(x, ctx=mx_cpu())
    ref = jnet(jx).asnumpy()
    jq = jqz.quantize_net(jnet, calib_data=[jx] if mode != "none" else None,
                          calib_mode=mode)
    tq = qz.quantize_net(tnet, calib_data=[tx] if mode != "none" else None,
                         calib_mode=mode)
    tout = tq(tx)
    assert isinstance(tout, nd.NDArray)
    _close_to_jax(tout, jq(jx), ref)
    # the twins quantized the same weights byte for byte
    for tw, jw in zip(tq._parts, jq._parts):
        np.testing.assert_array_equal(tw._qweight.numpy(),
                                      jw._impl._qweight.asnumpy())
    # and the net stays close to f32, as the JAX test asks of its own
    np.testing.assert_allclose(_np(tout), ref, atol=0.1 * max(
        1.0, float(np.abs(ref).max())))


def test_quantize_net_hybridized_calibration():
    jnet, tnet = _mlp_pair(12, hybridize=True)
    x = np.random.RandomState(12).uniform(-1, 1, (8, 10)).astype(np.float32)
    jx, tx = jnd.array(x), nd.array(x, ctx=mx_cpu())
    tnet(tx)
    ref = jnet(jx).asnumpy()
    tq = qz.quantize_net(tnet, calib_data=[tx], calib_mode="naive")
    jq = jqz.quantize_net(jnet, calib_data=[jx], calib_mode="naive")
    _close_to_jax(tq(tx), jq(jx), ref)
    assert tnet._active  # hybridization restored after the pass


def test_quantize_net_conv_close_to_jax():
    mx.random.seed(6)
    jnet = jgluon.nn.HybridSequential(prefix="cnv_")
    tnet = gluon.nn.HybridSequential(prefix="cnv_")
    for pkg, net in ((jgluon, jnet), (gluon, tnet)):
        with net.name_scope():
            net.add(pkg.nn.Conv2D(8, 3, padding=1, activation="relu",
                                  in_channels=3),
                    pkg.nn.Conv2D(4, 3, padding=1, in_channels=8))
    jnet.initialize(mx.init.Xavier())
    tnet.initialize(ctx=mx_cpu())
    from_mxnet_tpu_params(tnet, {k: p.data().asnumpy() for k, p in
                                 jnet.collect_params().items()}, "cnv_")
    x = np.random.RandomState(6).uniform(-1, 1, (2, 3, 8, 8)).astype(
        np.float32)
    jx, tx = jnd.array(x), nd.array(x, ctx=mx_cpu())
    ref = jnet(jx).asnumpy()
    tq = qz.quantize_net(tnet, calib_data=[tx], calib_mode="naive")
    jq = jqz.quantize_net(jnet, calib_data=[jx], calib_mode="naive")
    _close_to_jax(tq(tx), jq(jx), ref)


def test_quantize_net_degenerate_calibration_names_layer_and_mode():
    net = gluon.nn.HybridSequential()
    net.add(gluon.nn.Dense(8, activation="relu", in_units=6),
            gluon.nn.Dense(4, in_units=8))
    net.initialize(ctx=mx_cpu())
    with pytest.raises(MXNetError) as ei:
        qz.quantize_net(net, calib_data=[nd.array(np.zeros((4, 6),
                                                           np.float32),
                                                  ctx=mx_cpu())],
                        calib_mode="naive")
    msg = str(ei.value)
    assert "'0'" in msg and "naive" in msg and "degenerate" in msg


def test_quantize_model_raises_and_custom_root_is_refused():
    with pytest.raises(MXNetError, match="quantize_net"):
        qz.quantize_model(None, {}, {})

    class Residual(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.fc1 = gluon.nn.Dense(8, in_units=8)
                self.fc2 = gluon.nn.Dense(8, in_units=8)

        def forward(self, x):
            return x + self.fc2(torch.relu(self.fc1(x)))

    net = Residual()
    net.initialize(ctx=mx_cpu())
    with pytest.raises(MXNetError, match="Sequential"):
        qz.quantize_net(net, calib_mode="none")
    with pytest.raises(MXNetError, match="int8"):
        qz.quantize_net(gluon.nn.HybridSequential(), quantized_dtype="uint8")
