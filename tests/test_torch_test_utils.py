"""The port's ``test_utils`` against the JAX package's on the CPU: the
cases of ``tests/test_testutils_oracles.py`` (the numeric-gradient and
consistency oracles must pass on sound ops and fail on a planted wrong
gradient), the same values from the same seeds (``rand_ndarray``,
``with_seed``, ``get_mnist``), the same dtype tolerances (bfloat16 held at
bfloat16's although ``asnumpy`` hands it out as float32),
``default_context`` from ``MXNET_TEST_DEVICE``, and the flash-attention
gradient check that the card's ``test_utils_card`` phase runs, here on the
plain version, with its analytic gradients equal to the JAX package's
(rtol 1e-4, atol 1e-5).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu import test_utils as J
from mxnet_tpu_torch import nd
from mxnet_tpu_torch import test_utils as T
from mxnet_tpu_torch.test_utils import (check_consistency,
                                        check_numeric_gradient, rand_ndarray,
                                        with_seed)

CPU = mx.cpu()


@with_seed(7)
def test_check_numeric_gradient_fc():
    x = rand_ndarray((3, 4))
    w = rand_ndarray((5, 4))
    b = rand_ndarray((5,))

    def loss(x_, w_, b_):
        return (nd.FullyConnected(x_, w_, b_, num_hidden=5) ** 2).sum()

    check_numeric_gradient(loss, [x, w, b])


@with_seed(8)
def test_check_numeric_gradient_conv_bn():
    x = rand_ndarray((2, 3, 5, 5))
    k = rand_ndarray((4, 3, 3, 3))

    def loss(x_, k_):
        out = nd.Convolution(x_, k_, kernel=(3, 3), num_filter=4,
                             no_bias=True, pad=(1, 1))
        return nd.tanh(out).sum()

    check_numeric_gradient(loss, [x, k], eps=1e-2, rtol=5e-2)


def _register_bad_square():
    op = mx.operator

    @op.register("test_utils_bad_square")
    class Prop(op.CustomOpProp):
        def create_operator(self, ctx, in_shapes, in_dtypes):
            class BadSquare(op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0],
                                in_data[0] * in_data[0])

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    # WRONG: the derivative is 2 a g
                    self.assign(in_grad[0], req[0],
                                in_data[0] * out_grad[0])

            return BadSquare()


@with_seed(9)
def test_check_numeric_gradient_detects_wrong_grad():
    """The oracle must actually FAIL on a broken gradient."""
    _register_bad_square()
    x = rand_ndarray((4,))

    def loss(x_):
        return nd.Custom(x_, op_type="test_utils_bad_square").sum()

    with pytest.raises(AssertionError):
        check_numeric_gradient(loss, [x])


def test_check_consistency_cpu_contexts():
    inputs = [np.random.RandomState(0).rand(4, 6).astype(np.float32)]

    def fn(x):
        return nd.softmax(nd.dot(x, x.T))

    outs = check_consistency(fn, [mx.cpu(), mx.cpu(1)], inputs_np=inputs)
    jouts = J.check_consistency(
        lambda x: jmx.nd.softmax(jmx.nd.dot(x, x.T)),
        [jmx.cpu(), jmx.cpu(1)], inputs_np=inputs)
    np.testing.assert_allclose(outs[0], jouts[0], rtol=1e-6, atol=1e-7)


def test_check_consistency_fails_outside_the_tolerance():
    calls = []

    def fn(x):
        calls.append(1)
        return x * (1.0 + 1e-3 * (len(calls) - 1))

    with pytest.raises(AssertionError, match="inconsistent"):
        check_consistency(fn, [mx.cpu(), mx.cpu(1)],
                          inputs_np=[np.ones((3,), np.float32)])


def test_surface_and_dtype_tolerances_are_the_jax_ones():
    import ml_dtypes

    assert T.__all__ == J.__all__
    for name in ("float16", "float32", "float64", "int32"):
        assert T._dtype_tol(name) == J._dtype_tol(np.dtype(name))
    assert T._dtype_tol("bfloat16") == J._dtype_tol(ml_dtypes.bfloat16)
    bf = nd.array(np.ones((2, 2), np.float32), ctx=CPU, dtype="bfloat16")
    f32 = nd.array(np.ones((2, 2), np.float32), ctx=CPU)
    assert T._get_tols(bf, f32, None, None) == (2e-2, 2e-2)
    assert T.almost_equal(bf, f32 * 1.01) and not T.almost_equal(
        f32, f32 * 1.01)
    T.assert_almost_equal(f32, f32 * (1 + 1e-5))
    with pytest.raises(AssertionError):
        T.assert_almost_equal(f32, f32 * 1.01)
    assert T.same(f32, np.ones((2, 2), np.float32))
    assert T.list_gpus() == list(range(
        torch.cuda.device_count() if torch.cuda.is_available() else 0))


def test_default_context_reads_mxnet_test_device(monkeypatch):
    monkeypatch.delenv("MXNET_TEST_DEVICE", raising=False)
    assert T.default_context() == mx.cpu()
    assert repr(T.default_context()) == repr(J.default_context())
    monkeypatch.setenv("MXNET_TEST_DEVICE", "gpu")
    assert T.default_context() == mx.gpu(0)
    monkeypatch.setenv("MXNET_TEST_DEVICE", "tpu")
    assert T.default_context() == mx.cpu()
    T.set_default_context(mx.cpu(1))
    try:
        assert T.default_context() == mx.cpu(1)
    finally:
        T.set_default_context(None)


def test_seeded_draws_are_the_jax_ones():
    @with_seed(11)
    def port():
        return rand_ndarray((3, 5), scale=2.0).asnumpy(), T.rand_shape_nd(3)

    @J.with_seed(11)
    def jax():
        return J.rand_ndarray((3, 5), scale=2.0).asnumpy(), J.rand_shape_nd(3)

    (a, sa), (b, sb) = port(), jax()
    np.testing.assert_array_equal(a, b)
    assert sa == sb


def test_get_mnist_is_the_jax_one():
    a, b = T.get_mnist(), J.get_mnist()
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k])


def test_dummy_iter_repeats_one_batch():
    it = mx.io.NDArrayIter(np.arange(12, dtype=np.float32).reshape(6, 2),
                           np.arange(6, dtype=np.float32), batch_size=2,
                           ctx=CPU)
    d = T.DummyIter(it)
    first = next(d)
    assert next(d) is first and d.batch_size == 2
    d.reset()
    assert next(iter(d)) is first


FLASH_SHAPE = (1, 8, 16)  # (N, L, D): the card phase's numeric-gradient size


def _flash_inputs():
    rng = np.random.RandomState(5)
    q, k, v = (rng.randn(*FLASH_SHAPE).astype(np.float32) * 0.5
               for _ in range(3))
    w = rng.randn(*FLASH_SHAPE).astype(np.float32)
    return q, k, v, w


def test_numeric_gradient_of_flash_attention_matches_jax():
    """check_numeric_gradient over nd.contrib.flash_attention (the plain
    version here, K3-K5 on the card), and the analytic gradients it
    checked equal the JAX package's on the same inputs."""
    q, k, v, w = _flash_inputs()
    arrs = [nd.array(a, ctx=CPU) for a in (q, k, v)]
    wt = nd.array(w, ctx=CPU)

    def loss(q_, k_, v_):
        return (nd.contrib.flash_attention(q_, k_, v_) * wt).sum()

    check_numeric_gradient(loss, arrs, eps=1e-2, rtol=5e-2)
    from mxnet_tpu import autograd as jag

    jarrs = [jmx.nd.array(a) for a in (q, k, v)]
    for a in jarrs:
        a.attach_grad()
    with jag.record():
        jl = (jmx.nd.contrib.flash_attention(*jarrs) * jmx.nd.array(w)).sum()
    jl.backward()
    for a, j in zip(arrs, jarrs):
        np.testing.assert_allclose(a.grad.asnumpy(), j.grad.asnumpy(),
                                   rtol=1e-4, atol=1e-5)
