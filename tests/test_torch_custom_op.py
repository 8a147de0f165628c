"""``mx.operator`` and ``nd.Custom`` against the JAX package on the CPU:
the same user op (a scaled square with a user ``backward``, and a
two-input, two-output op) registered in both packages gives the same
forward values and the same gradients through ``autograd.record`` /
``backward``; the registry lists what was registered; ``assign`` honours
``write``, ``add`` and ``null``; and a block whose ``hybrid_forward``
calls ``F.Custom`` runs the op eagerly with the user's gradient, also
hybridized (inside its ``CachedOp``), as the JAX block does unhybridized.  Tolerance: rtol 1e-6 (f32, one
elementwise op each).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as tmx
from torch_fresh_names import fresh_jax_names  # noqa: F401

CPU = tmx.cpu()
TOL = dict(rtol=1e-6, atol=1e-7)


def _register(mx):
    op = mx.operator

    @op.register("scaled_square")
    class ScaledSquareProp(op.CustomOpProp):
        def __init__(self, scale=1.0):
            super().__init__(need_top_grad=True)
            self.scale = float(scale)

        def create_operator(self, ctx, in_shapes, in_dtypes):
            scale = self.scale

            class ScaledSquare(op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    x = in_data[0]
                    self.assign(out_data[0], req[0], x * x * scale)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    # a deliberately non-autodiff gradient: 3 x g, so the
                    # test sees the user's backward, not a derivative
                    self.assign(in_grad[0], req[0],
                                3.0 * in_data[0] * out_grad[0])

            return ScaledSquare()

    @op.register("sum_and_diff")
    class SumDiffProp(op.CustomOpProp):
        def list_arguments(self):
            return ["a", "b"]

        def list_outputs(self):
            return ["sum", "diff"]

        def infer_shape(self, in_shape):
            return in_shape, [in_shape[0], in_shape[0]], []

        def create_operator(self, ctx, in_shapes, in_dtypes):
            class SumDiff(op.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    a, b = in_data
                    self.assign(out_data[0], req[0], a + b)
                    self.assign(out_data[1], req[1], a - b)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    gs, gd = out_grad
                    self.assign(in_grad[0], req[0], gs + gd)
                    self.assign(in_grad[1], req[1], gs - gd)

            return SumDiff()


_register(jmx)
_register(tmx)


def _arr(mx, a):
    return (tmx.nd.array(a, ctx=CPU) if mx is tmx else jmx.nd.array(a))


def _run(mx, x, y):
    xa, ya = _arr(mx, x), _arr(mx, y)
    xa.attach_grad()
    ya.attach_grad()
    with mx.autograd.record():
        sq = mx.nd.Custom(xa, op_type="scaled_square", scale=2.5)
        s, d = mx.nd.Custom(xa, ya, op_type="sum_and_diff")
        loss = (sq * 2.0).sum() + (s * 3.0).sum() + (d * d).sum()
    loss.backward()
    return [sq.asnumpy(), s.asnumpy(), d.asnumpy(), xa.grad.asnumpy(),
            ya.grad.asnumpy()]


def test_forward_and_backward_match_jax():
    rng = np.random.RandomState(0)
    x, y = rng.randn(3, 4).astype(np.float32), rng.randn(3, 4).astype(
        np.float32)
    got, want = _run(tmx, x, y), _run(jmx, x, y)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    # the user's backward: 3 x * 2 from sq, then 3 + 2 d from the pair
    d = x - y
    np.testing.assert_allclose(got[3], 6.0 * x + 3.0 + 2.0 * d, rtol=1e-5)


def test_unrecorded_call_and_registry():
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    out = tmx.nd.Custom(_arr(tmx, x), op_type="scaled_square", scale=2.0)
    np.testing.assert_allclose(out.asnumpy(), 2.0 * x * x)
    names = tmx.operator.get_all_registered_operators()
    assert {"scaled_square", "sum_and_diff"} <= set(names)
    assert names == sorted(names)
    with pytest.raises(tmx.base.MXNetError, match="unknown custom op"):
        tmx.nd.Custom(_arr(tmx, x), op_type="nope")
    with pytest.raises(tmx.base.MXNetError, match="expected 2 inputs"):
        tmx.nd.Custom(_arr(tmx, x), op_type="sum_and_diff")
    with pytest.raises(tmx.base.MXNetError, match="op_type"):
        tmx.nd.Custom(_arr(tmx, x))
    with pytest.raises(tmx.base.MXNetError, match="CustomOpProp"):
        tmx.operator.register("bad")(object)


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_assign_honours_req(req):
    outs = {}
    for mx in (jmx, tmx):
        dst, src = _arr(mx, np.ones(3, np.float32)), _arr(
            mx, np.full(3, 2.0, np.float32))
        mx.operator.CustomOp().assign(dst, req, src)
        outs[mx.__name__] = dst.asnumpy()
    np.testing.assert_array_equal(outs["mxnet_tpu_torch"], outs["mxnet_tpu"])


def _block(mx):
    class Net(mx.gluon.HybridBlock):
        def __init__(self, **kw):
            super().__init__(**kw)
            with self.name_scope():
                self.dense = mx.gluon.nn.Dense(4, in_units=3)

        def hybrid_forward(self, F, x):
            return F.Custom(self.dense(x), op_type="scaled_square",
                            scale=0.5)

    return Net(prefix="cust_")


def _block_run(mx, net, x, hybridize):
    if hybridize:
        net.hybridize()
    with mx.autograd.record():
        out = net(_arr(mx, x))
        loss = out.sum()
    loss.backward()
    return out.asnumpy(), {k: p.grad().asnumpy()
                           for k, p in net.collect_params().items()}


def test_custom_in_a_hybridized_block_runs_eagerly():
    """Hybridized, the block runs the op eagerly with the user's backward
    (the contract of the JAX docstring), so it gives what the JAX block
    gives unhybridized.  The JAX block hybridized differentiates the
    op's forward instead (ROADMAP C, a fault of the reference)."""
    x = np.random.RandomState(1).randn(2, 3).astype(np.float32)
    jb = _block(jmx)
    jb.initialize(jmx.init.Xavier())
    tb = _block(tmx)
    tb.initialize(ctx=CPU)
    for name, p in jb.collect_params().items():
        tb.collect_params()[name].set_data(
            tmx.nd.array(p.data().asnumpy(), ctx=CPU))
    jo, jg = _block_run(jmx, jb, x, hybridize=False)
    for hybridize in (False, True):
        to, tg = _block_run(tmx, tb, x, hybridize)
        np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-6)
        for k in jg:
            np.testing.assert_allclose(tg[k], jg[k], rtol=1e-5, atol=1e-6)
    assert tb._cached_op.num_entries == 1


def test_custom_on_tensors_keeps_the_graph():
    x = torch.randn(3, requires_grad=True)
    with tmx.autograd.record():
        y = tmx.nd.Custom(x, op_type="scaled_square", scale=1.0)
    assert isinstance(y, torch.Tensor)
    y.sum().backward()
    torch.testing.assert_close(x.grad, 3.0 * x.detach())
