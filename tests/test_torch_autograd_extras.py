"""``autograd.grad`` (with ``create_graph``: a gradient penalty),
``autograd.Function``, and ``nd.contrib.foreach`` / ``while_loop`` /
``cond`` in the port against the JAX package's on the CPU: the same
seeded numpy inputs, the same calls spelled the same in both packages,
outputs and gradients within 1e-5 (relative and absolute; f32 both).
"""
import numpy as np
import pytest

from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd

TOL = dict(rtol=1e-5, atol=1e-5)
PKGS = {"jax": (jnd, jag, lambda a: jnd.array(a)),
        "port": (tnd, tag, lambda a: tnd.array(a, ctx=tmx.cpu()))}
RNG = np.random.RandomState(0)
X = RNG.uniform(-1, 1, (4, 3)).astype(np.float32)
W = RNG.uniform(-1, 1, (3, 2)).astype(np.float32)


def _both(fn):
    return {k: fn(*v) for k, v in PKGS.items()}


def _close(res):
    j, t = res["jax"], res["port"]
    for a, b in zip(j if isinstance(j, (list, tuple)) else [j],
                    t if isinstance(t, (list, tuple)) else [t]):
        np.testing.assert_allclose(b, a, **TOL)


def test_grad_returns_gradients_and_writes_no_buffer():
    def run(nd, ag, arr):
        x, w = arr(X), arr(W)
        x.attach_grad()
        w.attach_grad()
        with ag.record():
            y = (nd.tanh(nd.dot(x, w)) ** 2).sum()
        gx, gw = ag.grad(y, [x, w])
        return [gx.asnumpy(), gw.asnumpy(), x.grad.asnumpy()]

    res = _both(run)
    _close(res)
    assert not res["port"][2].any()


def test_grad_create_graph_gradient_penalty():
    """loss = f(x, w) + ||d f / d x||^2, backward to w and x: the second
    derivative through the recorded gradient."""
    def run(nd, ag, arr):
        x, w = arr(X), arr(W)
        x.attach_grad()
        w.attach_grad()
        with ag.record():
            f = (nd.sigmoid(nd.dot(x, w)) * nd.dot(x, w)).sum()
            gx = ag.grad(f, [x], create_graph=True)[0]
            loss = f + (gx * gx).sum()
        loss.backward()
        return [gx.asnumpy(), loss.asnumpy(), w.grad.asnumpy(),
                x.grad.asnumpy()]

    _close(_both(run))


def test_grad_head_grads_and_unrecorded_variable():
    def run(nd, ag, arr):
        x = arr(X)
        x.attach_grad()
        with ag.record():
            y = nd.exp(x) * 2
        return ag.grad(y, x, head_grads=arr(X * 3)).asnumpy()

    _close(_both(run))
    x = tnd.array(X, ctx=tmx.cpu())
    z = tnd.array(X, ctx=tmx.cpu())
    x.attach_grad()
    z.attach_grad()
    with tag.record():
        y = (x * 2).sum()
    with pytest.raises(tmx.MXNetError, match="not part of the recorded"):
        tag.grad(y, [z])


def _sigmoid_fn(nd, ag):
    class Sigmoid(ag.Function):
        def forward(self, x):
            y = 1 / (1 + nd.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            y, = self.saved_tensors
            return dy * y * (1 - y)

    return Sigmoid


def _scaled_pair_fn(nd, ag):
    class ScaledPair(ag.Function):
        """Two inputs, two outputs, and a backward that is not the
        forward's true derivative (x's gradient doubled), which the
        result must follow."""

        def forward(self, a, b):
            return a * b, a + b

        def backward(self, g_prod, g_sum):
            return g_prod * 2, g_sum * 3

    return ScaledPair


def test_function_forward_and_custom_backward():
    def run(nd, ag, arr):
        x, w = arr(X), arr(X[::-1].copy())
        x.attach_grad()
        w.attach_grad()
        with ag.record():
            s = _sigmoid_fn(nd, ag)()(x)
            p, q = _scaled_pair_fn(nd, ag)()(s, w)
            loss = (p * arr(X) + q).sum()
        loss.backward()
        return [s.asnumpy(), p.asnumpy(), q.asnumpy(), x.grad.asnumpy(),
                w.grad.asnumpy()]

    _close(_both(run))
    out = _sigmoid_fn(tnd, tag)()(tnd.array(X, ctx=tmx.cpu()))
    assert not out._data.requires_grad  # not recording: forward only


def test_foreach_states_outputs_and_gradients():
    seq = RNG.uniform(-1, 1, (5, 2, 3)).astype(np.float32)

    def run(nd, ag, arr):
        data, w = arr(seq), arr(W)
        w.attach_grad()
        h0 = arr(np.zeros((2, 2), np.float32))

        def body(x, states):
            h = nd.tanh(nd.dot(x, w) + states[0])
            return [h, h * 2], [h]

        with ag.record():
            (outs, outs2), states = nd.contrib.foreach(body, data, [h0])
            loss = outs.sum() + outs2.sum() * 0.5 + states[0].sum()
        loss.backward()
        return [outs.asnumpy(), outs2.asnumpy(), states[0].asnumpy(),
                w.grad.asnumpy()]

    _close(_both(run))


def test_while_loop_pads_outputs_to_max_iterations():
    def run(nd, ag, arr):
        i, s = arr(np.zeros((1,), np.float32)), arr(X[0])
        s.attach_grad()

        def cond(i, s):
            return i < 3

        def func(i, s):
            return s * (i + 1), [i + 1, s * 1.5]

        with ag.record():
            outs, (i_f, s_f) = nd.contrib.while_loop(cond, func, [i, s],
                                                     max_iterations=6)
            loss = outs.sum() + s_f.sum()
        loss.backward()
        return [outs.asnumpy(), i_f.asnumpy(), s_f.asnumpy(),
                s.grad.asnumpy()]

    res = _both(run)
    _close(res)
    assert res["port"][0].shape == (6, 3)
    assert not res["port"][0][3:].any()


def test_while_loop_that_never_runs_gives_zero_rows():
    """Unrecorded, as the JAX function runs it through its scan."""
    def run(nd, ag, arr):
        i = arr(np.full((1,), 5.0, np.float32))
        outs, i_f = nd.contrib.while_loop(
            lambda i: i < 3, lambda i: (i * 2, i + 1), i, max_iterations=4)
        return [outs.asnumpy(), i_f.asnumpy()]

    res = _both(run)
    _close(res)
    assert res["port"][0].shape == (4, 1)


@pytest.mark.parametrize("flag", [1.0, 0.0])
def test_cond_takes_one_branch(flag):
    def run(nd, ag, arr):
        x = arr(X)
        x.attach_grad()
        with ag.record():
            out = nd.contrib.cond(arr(np.array([flag], np.float32)),
                                  lambda x: nd.exp(x) * 2,
                                  lambda x: x * x, [x])
            out.sum().backward()
        return [out.asnumpy(), x.grad.asnumpy()]

    _close(_both(run))
    pick = tnd.contrib.cond(lambda a: a.sum() > 100, lambda a: a + 1,
                            lambda a: a - 1,
                            [tnd.array(X, ctx=tmx.cpu())])
    np.testing.assert_allclose(pick.asnumpy(), X - 1)
