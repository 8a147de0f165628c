"""The harness of the ``test_torch_zoo_*`` files: one vision net built in
both packages with the same weights, on the CPU.

:func:`pair` builds the JAX net (``mx.init.Xavier()`` under a seed, one
forward of the first image to resolve the deferred shapes) and the
port's (``initialize`` on the CPU and one forward, then the JAX net's
arrays carried by ``convert.from_mxnet_tpu_params``), each with every
``Dropout`` rate set to 0.  :func:`outputs` runs both in eval mode and
in training mode (BatchNorm on the batch's statistics): the JAX net as
one jitted program a mode (``_block_apply_fn``, as the JAX step runs it;
eager dispatch compiles each of a big net's op shapes on its own, which
takes longer here), the port's as a ``torch.nn.Module`` under
``no_grad``.
"""
from __future__ import annotations

import jax
import numpy as np
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jautograd
from mxnet_tpu.gluon.model_zoo import vision as jvision
from mxnet_tpu.parallel.data_parallel import _block_apply_fn
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.convert import from_mxnet_tpu_params
from mxnet_tpu_torch.gluon import nn as tnn
from mxnet_tpu_torch.gluon.model_zoo import vision as tvision

CPU = tmx.cpu()


def images(n, res, seed=1):
    return np.random.RandomState(seed).rand(n, 3, res, res).astype(
        np.float32)


def _jax_blocks(block):
    yield block
    for child in block._children.values():
        yield from _jax_blocks(child)


def build(make, prefix):
    """``make(package's vision module, prefix=...)`` in both packages:
    (JAX net, port net), their weights not drawn yet."""
    return make(jvision, prefix=prefix), make(tvision, prefix=prefix)


def pair(make, prefix, x):
    """(JAX net, port net) with the JAX net's weights, Dropout off in
    both, shapes resolved by a forward of ``x[:1]``."""
    jnet, tnet = build(make, prefix)
    jmx.random.seed(0)
    np.random.seed(0)
    jnet.initialize(jmx.init.Xavier())
    for b in _jax_blocks(jnet):
        if isinstance(b, jmx.gluon.nn.Dropout):
            b._rate = 0.0
    with jautograd.pause():
        jnet(jmx.nd.array(x[:1]))
    tnet.initialize(tmx.init.Xavier(), ctx=CPU)
    for m in tnet.modules():
        if isinstance(m, tnn.Dropout):
            m.rate = 0.0
    tnet.eval()
    with torch.no_grad():
        tnet(torch.from_numpy(x[:1]))
    params = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    from_mxnet_tpu_params(tnet, params, prefix)
    return jnet, tnet


def jax_forward(jnet, x, train):
    """The JAX net's logits on ``x``, one jitted forward."""
    fn, items = _block_apply_fn(jnet, jmx.cpu(), train=train)
    params = {n: p.data()._data for n, p in items}
    logits = jax.jit(lambda p, k, d: fn(p, k, d)[0])
    return np.asarray(logits(params, jax.random.PRNGKey(0), x))


def outputs(jnet, tnet, x):
    """{"eval": (port, jax), "train": (port, jax)} logits on ``x``."""
    out = {}
    xt = torch.from_numpy(x)
    for mode in ("eval", "train"):
        tnet.train(mode == "train")
        with torch.no_grad():
            out[mode] = (tnet(xt).numpy(),
                         jax_forward(jnet, x, mode == "train"))
    return out


def assert_close(got, want, rel):
    """max |got - want| <= rel x max |want|."""
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale, rel)


def same_params(jnet, tnet):
    """The port's ``collect_params()`` names and Gluon shapes are the JAX
    net's."""
    jp, tp = jnet.collect_params(), tnet.collect_params()
    assert list(tp.keys()) == list(jp.keys())
    assert [tuple(p.shape) for p in tp.values()] == \
        [tuple(p.shape) for p in jp.values()]


# train-mode tolerance: BatchNorm on a few values a channel amplifies
# rounding (MobileNet at batch 4, 64^2: each package's f32 logits ~5e-5 of
# their scale from the port's float64 ones; at batch 2, 32^2 the port's
# 3.6e-2, JAX's 4.3e-3, which is why the tables take batch 4 there)
EVAL_TOL, TRAIN_TOL = 1e-5, 5e-4


def family_tests(families):
    """The three tests of a ``test_torch_zoo_*`` file over ``families``
    ({name: (make, batch, resolution)}): parameter names and shapes after
    the forward, eval logits within EVAL_TOL and training-mode logits
    within TRAIN_TOL of the largest JAX logit."""
    import functools

    import pytest

    @functools.lru_cache(maxsize=None)
    def run(name):
        make, n, res = families[name]
        x = images(n, res)
        jnet, tnet = pair(make, name.replace(".", "_") + "_", x)
        return jnet, tnet, outputs(jnet, tnet, x)

    names = sorted(families)

    @pytest.mark.parametrize("name", names)
    def test_params_match_jax_after_a_forward(name):
        jnet, tnet, _ = run(name)
        same_params(jnet, tnet)

    @pytest.mark.parametrize("name", names)
    def test_eval_logits_match_jax(name):
        assert_close(*run(name)[2]["eval"], EVAL_TOL)

    @pytest.mark.parametrize("name", names)
    def test_train_logits_match_jax(name):
        assert_close(*run(name)[2]["train"], TRAIN_TOL)

    return (test_params_match_jax_after_a_forward, test_eval_logits_match_jax,
            test_train_logits_match_jax)
