"""The port's imperative core (``nd``, the op registry, ``autograd``) vs
the JAX package's ``mxnet_tpu.nd`` and ``mxnet_tpu.autograd``.

The same numpy inputs, drawn from a seed, go through both packages' ``nd``
namespaces on the CPU; outputs and gradients agree at rtol = atol = 1e-5
(f32 on both sides, sums taken in another order).  The namespace is built
from each registry with the same positional-argument rules, so the calls
are spelled the same in both.
"""
import zlib

import numpy as np
import pytest
import torch

from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.base import MXNetError

CPU = tmx.cpu()
TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _both(name, arrays, *pos, contrib=False, **attrs):
    """``nd.<name>(*arrays, *pos, **attrs)`` in both packages, as numpy
    (a list for multi-output ops)."""
    def call(ns, make):
        fn = getattr(ns.contrib if contrib else ns, name)
        out = fn(*[make(a) for a in arrays], *pos, **attrs)
        if isinstance(out, list):
            return [o.asnumpy() for o in out]
        return out.asnumpy()

    return (call(jnd, jnd.array),
            call(tnd, lambda a: tnd.array(a, ctx=CPU)))


def _case(name, shapes, *pos, contrib=False, ints=(), **attrs):
    return (name, shapes, pos, contrib, ints, attrs)


CASES = [
    _case("FullyConnected", [(4, 6), (5, 6), (5,)], num_hidden=5),
    _case("FullyConnected", [(2, 3, 4), (5, 12), (5,)], 5),  # flatten
    _case("FullyConnected", [(2, 3, 4), (5, 4)], num_hidden=5, no_bias=True,
          flatten=False),
    *[_case("Activation", [(3, 7)], act_type=a)
      for a in ("relu", "sigmoid", "tanh", "softrelu", "softsign")],
    *[_case("LeakyReLU", [(3, 7)], act_type=a)
      for a in ("gelu", "elu", "selu")],
    _case("LeakyReLU", [(3, 7)], "leaky", 0.1),  # positional attributes
    _case("softmax", [(3, 7)]),
    _case("softmax", [(3, 7)], axis=0),
    _case("softmax", [(3, 7)], temperature=2.0),
    _case("log_softmax", [(3, 7)]),
    _case("softmax_cross_entropy", [(5, 7), (5,)], ints=(1,)),
    _case("LayerNorm", [(3, 4, 8), (8,), (8,)]),
    _case("LayerNorm", [(3, 4, 8), (4,), (4,)], axis=1, output_mean_var=True),
    _case("add_layer_norm", [(3, 4, 8), (3, 4, 8), (8,), (8,)],
          contrib=True),
    _case("flash_attention", [(4, 6, 8)] * 3, contrib=True),
    _case("flash_attention", [(2, 3, 6, 8)] * 3, contrib=True, causal=True),
    _case("flash_attention", [(4, 6, 16), (4, 9, 16), (4, 9, 16)],
          contrib=True, sm_scale=0.3),
    _case("elemwise_add", [(3, 4), (3, 4)]),
    _case("elemwise_mul", [(3, 4), (3, 4)]),
    _case("broadcast_add", [(3, 1), (1, 4)]),
    _case("broadcast_mul", [(3, 1), (1, 4)]),
    _case("sum", [(2, 3, 4)]),
    _case("sum", [(2, 3, 4)], axis=1, keepdims=True),
    _case("sum", [(2, 3, 4)], axis=(0, 2), exclude=True),
    _case("mean", [(2, 3, 4)], axis=(0, 2)),
    _case("mean", [(2, 3, 4)], 1),
    _case("reshape", [(2, 3, 4)], shape=(0, -1)),
    _case("reshape", [(2, 3, 4)], shape=(-3, 0)),
    _case("reshape", [(2, 3, 4)], shape=(-4, 1, 2, -2)),
    _case("reshape", [(2, 3, 4)], shape=(4, -1), reverse=True),
]


@pytest.mark.parametrize("name,shapes,pos,contrib,ints,attrs", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_op_matches_jax(name, shapes, pos, contrib, ints, attrs):
    rng = np.random.RandomState(zlib.crc32(repr((name, shapes, attrs))
                                           .encode()))
    arrays = [_rand(rng, *s) for s in shapes]
    for i in ints:  # labels, as floats, one of them out of range
        arrays[i] = rng.randint(0, shapes[0][-1] + 1,
                                shapes[i]).astype(np.float32)
    want, got = _both(name, arrays, *pos, contrib=contrib, **attrs)
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)
    else:
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)


def test_namespace_has_the_ported_ops():
    for name in ("FullyConnected", "Activation", "LeakyReLU", "softmax",
                 "log_softmax", "softmax_cross_entropy", "LayerNorm",
                 "_contrib_add_layer_norm", "_contrib_flash_attention",
                 "elemwise_add", "broadcast_add", "sum", "mean", "reshape"):
        assert callable(getattr(tnd, name)), name
        assert callable(getattr(jnd, name)), name
    assert tnd.contrib.add_layer_norm.__name__ == "_contrib_add_layer_norm"
    assert sorted(tnd.contrib.__all__) == ["add_layer_norm", "flash_attention"]
    with pytest.raises(MXNetError, match="too many positional"):
        tnd.softmax(tnd.ones((2, 2), ctx=CPU), -1, 1.0, None, False, 7)


def test_ndarray_basics():
    rng = np.random.RandomState(0)
    a = _rand(rng, 2, 3)
    j, t = jnd.array(a), tnd.array(a, ctx=CPU)
    assert t.shape == j.shape == (2, 3)
    assert t.dtype is j.dtype is np.float32
    assert t.context == torch.device("cpu") and t.ctx == t.context
    assert t.size == 6 and t.ndim == 2 and len(t) == 2
    assert tnd.array(a.astype(np.float64), ctx=CPU).dtype is np.float32
    assert tnd.array([1, 2], ctx=CPU, dtype="int32").dtype is np.int32
    for fn in (lambda x: x + 1.5, lambda x: 2 * x, lambda x: x * x + x,
               lambda x: x.reshape((3, 2)), lambda x: x.reshape(-1),
               lambda x: x.sum(), lambda x: x.mean(axis=0),
               lambda x: x.softmax(axis=0)):
        np.testing.assert_allclose(fn(t).asnumpy(), fn(j).asnumpy(), **TOL)
    t.wait_to_read()
    c = t.copyto(CPU)
    assert c is not t and c._data.data_ptr() != t._data.data_ptr()
    into = tnd.zeros((2, 3), ctx=CPU)
    assert t.copyto(into) is into
    np.testing.assert_array_equal(into.asnumpy(), a)
    assert t.as_in_context(CPU) is t
    np.testing.assert_array_equal(tnd.ones((2, 2), ctx=CPU).asnumpy(),
                                  np.ones((2, 2)))
    np.testing.assert_allclose(float(tnd.array([3.0], ctx=CPU)), 3.0)


def test_arrays_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    with pytest.raises(MXNetError, match="no CUDA device"):
        tnd.array([1.0])
    with pytest.raises(MXNetError, match="no CUDA device"):
        tnd.zeros((2,))


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------
def _loss(ns, x, w):
    return ns.sum(ns.LeakyReLU(ns.FullyConnected(x, w, num_hidden=3,
                                                 no_bias=True),
                               act_type="gelu"))


@pytest.mark.parametrize("grad_req", ["write", "add"])
def test_record_backward_grad_req(grad_req):
    """Two backward passes: ``write`` leaves one pass's gradient, ``add``
    the sum of both, in each package."""
    rng = np.random.RandomState(1)
    xs, ws = _rand(rng, 4, 5), _rand(rng, 3, 5)
    grads = {}
    for pkg, ns, ag, kw in (("jax", jnd, jag, {}), ("torch", tnd, tag,
                                                    {"ctx": CPU})):
        x, w = ns.array(xs, **kw), ns.array(ws, **kw)
        x.attach_grad(grad_req)
        w.attach_grad(grad_req)
        for _ in range(2):
            with ag.record():
                loss = _loss(ns, x, w)
            loss.backward()
        grads[pkg] = (x.grad.asnumpy(), w.grad.asnumpy(), float(loss))
    for g, w in zip(grads["torch"], grads["jax"]):
        np.testing.assert_allclose(g, w, **TOL)


def test_non_scalar_head_and_head_grads():
    """A head that is not a scalar is seeded with ones; ``out_grad``
    seeds it with the given array."""
    rng = np.random.RandomState(2)
    xs, seed = _rand(rng, 3, 4), _rand(rng, 3, 4)
    for out_grad in (None, seed):
        res = []
        for ns, ag, kw in ((jnd, jag, {}), (tnd, tag, {"ctx": CPU})):
            x = ns.array(xs, **kw)
            x.attach_grad()
            with ag.record():
                y = ns.Activation(x * x, act_type="tanh")
            y.backward(None if out_grad is None else ns.array(out_grad, **kw))
            res.append(x.grad.asnumpy())
        np.testing.assert_allclose(res[1], res[0], **TOL)


def test_no_graph_outside_record_and_pause():
    x = tnd.array(np.ones((2, 2), np.float32), ctx=CPU)
    x.attach_grad()
    y = x * x
    assert not y._data.requires_grad  # outside record(): no graph
    with tag.record():
        z = x * x
        with tag.pause():
            p = x * x
    assert z._data.requires_grad and not p._data.requires_grad
    y.backward()  # nothing was recorded into y: the buffer stays zero
    np.testing.assert_array_equal(x.grad.asnumpy(), np.zeros((2, 2)))
    d = x.detach()
    with tag.record():
        u = (d * x).sum()
    u.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(), np.ones((2, 2)))


def test_recording_and_training_flags_match_jax():
    def flags(ag):
        seen = [(ag.is_recording(), ag.is_training())]
        with ag.record():
            seen.append((ag.is_recording(), ag.is_training()))
            with ag.pause():
                seen.append((ag.is_recording(), ag.is_training()))
            with ag.predict_mode():
                seen.append((ag.is_recording(), ag.is_training()))
        with ag.record(train_mode=False):
            seen.append((ag.is_recording(), ag.is_training()))
        with ag.train_mode():
            seen.append((ag.is_recording(), ag.is_training()))
        prev = (ag.set_recording(True), ag.set_training(True))
        seen.append((ag.is_recording(), ag.is_training(), prev))
        ag.set_recording(False)
        ag.set_training(False)
        seen.append((ag.is_recording(), ag.is_training()))
        return seen

    assert flags(tag) == flags(jag)


def test_mark_variables_and_null():
    rng = np.random.RandomState(3)
    xs = _rand(rng, 2, 3)
    for ns, ag, kw in ((jnd, jag, {}), (tnd, tag, {"ctx": CPU})):
        x = ns.array(xs, **kw)
        buf = ns.zeros((2, 3), **kw)
        ag.mark_variables([x], [buf], "write")
        with ag.record():
            (x * x).sum().backward()
        np.testing.assert_allclose(buf.asnumpy(), 2 * xs, **TOL)
        y = ns.array(xs, **kw)
        ag.mark_variables([y], [ns.zeros((2, 3), **kw)], "null")
        assert y.grad is None
    z = tnd.array(xs, ctx=CPU)
    z.attach_grad("null")
    assert z.grad is None
    with pytest.raises(MXNetError, match="grad_req"):
        z.attach_grad("sometimes")
    with pytest.raises(MXNetError, match="cannot have a gradient"):
        tnd.array([1, 2], ctx=CPU, dtype="int32").attach_grad()
