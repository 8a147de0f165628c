"""The gradient of the port's LayerNorm vs the JAX package's.

``gluon.nn.LayerNorm`` goes through ``LayerNormFunction``: kernel K1 (its
plain version here, on the CPU) forward, and the closed form of the JAX
package's ``_ln_bwd`` backward.  dx, dgamma and dbeta are held against
``jax.vjp`` of ``mxnet_tpu.ops.pallas.layer_norm`` (whose custom VJP is
``_ln_bwd``, with the Pallas forward in interpret mode) on the same numpy
inputs, at atol 1e-5 (f32 both sides, sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.pallas import layer_norm as jax_layer_norm
from mxnet_tpu_torch.gluon.nn import LayerNorm
from mxnet_tpu_torch.ops.kernels import LayerNormFunction, layer_norm

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(n, c, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, c) * 2 + 0.5).astype(np.float32)
    g = rng.randn(c).astype(np.float32)
    b = rng.randn(c).astype(np.float32)
    dy = rng.randn(n, c).astype(np.float32)
    return x, g, b, dy


@pytest.mark.parametrize("n,c", [(6, 32), (37, 64), (4, 768)])
def test_layer_norm_grad_matches_ln_bwd(n, c):
    x, g, b, dy = _inputs(n, c, n + c)
    out_j, vjp = jax.vjp(lambda a, gg, bb: jax_layer_norm(a, gg, bb, 1e-5),
                         jnp.asarray(x), jnp.asarray(g), jnp.asarray(b))
    dx_j, dg_j, db_j = (np.asarray(t) for t in vjp(jnp.asarray(dy)))

    tx = torch.from_numpy(x).requires_grad_()
    tg = torch.from_numpy(g).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    before = layer_norm.launches
    out = LayerNormFunction.apply(tx, tg, tb, 1e-5)
    dx, dg, db = torch.autograd.grad(out, (tx, tg, tb), torch.from_numpy(dy))
    assert layer_norm.launches == before
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(dx.numpy(), dx_j, **TOL)
    np.testing.assert_allclose(dg.numpy(), dg_j, **TOL)
    np.testing.assert_allclose(db.numpy(), db_j, **TOL)


def test_layer_norm_layer_has_gradients_over_any_leading_shape():
    """The layer flattens the leading axes; its parameters and input get
    the same gradients as the (N, C) function on the flattened rows."""
    x, g, b, dy = _inputs(12, 16, 3)
    ln = LayerNorm(16)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(g))
        ln.bias.copy_(torch.from_numpy(b))
    tx = torch.from_numpy(x).reshape(3, 4, 16).requires_grad_()
    ln(tx).backward(torch.from_numpy(dy).reshape(3, 4, 16))
    fx = torch.from_numpy(x).requires_grad_()
    fg = torch.from_numpy(g).requires_grad_()
    fb = torch.from_numpy(b).requires_grad_()
    LayerNormFunction.apply(fx, fg, fb, 1e-5).backward(torch.from_numpy(dy))
    torch.testing.assert_close(tx.grad.reshape(12, 16), fx.grad)
    torch.testing.assert_close(ln.weight.grad, fg.grad)
    torch.testing.assert_close(ln.bias.grad, fb.grad)
