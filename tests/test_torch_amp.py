"""``contrib.amp`` of the port against the JAX package's, case for case
with tests/test_amp.py: the Gluon AMP workflow (``amp.init``,
``convert_hybrid_block``, ``init_trainer``, ``scale_loss``) through
``gluon.Trainer``, as BASELINE config 2 runs it.

Both packages train one MLP from the same weights (drawn by the JAX
package's Xavier, carried by Gluon name) on the same numpy batches, in
this process on the CPU.  Tolerances, stated before the first run:

  * bf16 workflow, 30 SGD steps: losses within atol 3e-2 of the JAX
    workflow's (bf16 keeps 8 bits; the weights are rounded to bf16 after
    every update in both), falling; the exposed weights stay bf16 while
    the optimizer keeps f32 masters;
  * fp16 with the dynamic scaler, 30 steps: finite, falling, within atol
    3e-2 of JAX's, and the loss scale equal to JAX's after every step;
  * overflow recovery: the loss-scale trajectory over an overflowing step
    and the steps after it EQUAL to JAX's, and the overflowing step's
    gradients zeroed.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.contrib import amp as jamp
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import autograd as tag
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch import nd as tnd
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.contrib import amp as tamp
from mxnet_tpu_torch.convert import from_mxnet_tpu_params

CPU = tmx.cpu()


def _nets(seed):
    jmx.random.seed(seed)
    nets = []
    for gluon in (jgluon, tgluon):
        net = gluon.nn.HybridSequential(prefix="amp_")
        with net.name_scope():
            net.add(gluon.nn.Dense(16, activation="relu", in_units=8),
                    gluon.nn.Dense(4, in_units=16))
        nets.append(net)
    jnet, tnet = nets
    jnet.initialize(jmx.init.Xavier())
    tnet.initialize(ctx=CPU)
    from_mxnet_tpu_params(tnet, {k: p.data().asnumpy() for k, p in
                                 jnet.collect_params().items()}, "amp_")
    return jnet, tnet


SIDES = {"jax": (jamp, jgluon, jag, jnd, {}),
         "torch": (tamp, tgluon, tag, tnd, {"ctx": CPU})}


def _workflow(side, net, dtype, lr, x, y, steps):
    amp, gluon, ag, nd, kw = SIDES[side]
    amp.init(target_dtype=dtype)
    amp.convert_hybrid_block(net, target_dtype=dtype)
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": lr})
    amp.init_trainer(trainer)
    assert trainer._optimizer.multi_precision
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    xb = nd.array(x, dtype=dtype, **kw)
    yb = nd.array(y, **kw)
    losses, scales = [], []
    for _ in range(steps):
        with ag.record():
            loss = loss_fn(net(xb), yb)
        with amp.scale_loss(loss, trainer) as scaled:
            scaled.backward()
        trainer.step(x.shape[0])
        losses.append(float(np.asarray(loss.mean().asnumpy(), np.float32)))
        sc = trainer._amp_loss_scaler
        scales.append(None if sc is None else sc.loss_scale)
    return losses, scales, trainer


def _masters(trainer):
    """The f32 master weights the multi-precision updater keeps."""
    states = trainer._updaters[0].states
    return [st[0]._data for st in states.values()]


def test_amp_bf16_workflow_matches_jax():
    jnet, tnet = _nets(0)
    x = np.random.RandomState(0).rand(16, 8).astype(np.float32)
    y = np.random.RandomState(1).randint(0, 4, 16).astype(np.float32)
    jl, _, _ = _workflow("jax", jnet, "bfloat16", 0.1, x, y, 30)
    tl, scales, trainer = _workflow("torch", tnet, "bfloat16", 0.1, x, y,
                                    30)
    assert scales == [None] * 30  # bf16: no scaler
    assert tl[-1] < tl[0]
    np.testing.assert_allclose(tl, jl, atol=3e-2)
    # bf16 exposed weights, f32 masters in the optimizer state
    assert tnet[0].weight.dtype == torch.bfloat16
    masters = _masters(trainer)
    assert len(masters) == 4
    assert all(m.dtype == torch.float32 for m in masters)


def test_amp_fp16_loss_scaling_matches_jax():
    jnet, tnet = _nets(1)
    x = np.random.RandomState(2).rand(8, 8).astype(np.float32)
    y = np.random.RandomState(3).randint(0, 4, 8).astype(np.float32)
    jl, js, _ = _workflow("jax", jnet, "float16", 0.05, x, y, 30)
    tl, ts, _ = _workflow("torch", tnet, "float16", 0.05, x, y, 30)
    assert ts == js and ts[0] <= 2.0 ** 16
    assert np.isfinite(tl[-1]) and tl[-1] < tl[0], tl
    np.testing.assert_allclose(tl, jl, atol=3e-2)


def _overflow_run(side, net):
    amp, gluon, ag, nd, kw = SIDES[side]
    amp.init(target_dtype="float16")
    net.cast("float16")
    trainer = gluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.1})
    amp.init_trainer(trainer)
    scaler = trainer._amp_loss_scaler
    x = nd.array(np.random.RandomState(4).rand(4, 8).astype(np.float16),
                 dtype=np.float16, **kw)
    scales, zeroed = [scaler.loss_scale], []
    for factor in (6e4, 1.0, 1.0, 1.0, 1.0, 1.0, 6e4, 1.0):
        with ag.record():
            loss = (net(x) * factor).sum()  # 6e4 overflows fp16 grads
        with amp.scale_loss(loss, trainer) as scaled:
            scaled.backward()
        zeroed.append(all(
            float(np.abs(p.grad().asnumpy().astype(np.float32)).sum()) == 0
            for p in net.collect_params().values() if p.grad_req != "null"))
        trainer.step(4)
        scales.append(scaler.loss_scale)
    return scales, zeroed


def test_amp_fp16_overflow_recovery_matches_jax():
    jnet, tnet = _nets(2)
    js, jz = _overflow_run("jax", jnet)
    ts, tz = _overflow_run("torch", tnet)
    assert ts == js and tz == jz
    assert ts[1] == ts[0] / 2 and tz[0] and not all(tz)


def test_scaler_shim_overflow_is_one_reduction():
    tamp.init(target_dtype="float16")
    net = tgluon.nn.Dense(4, in_units=6)
    net.initialize(ctx=CPU)
    x = tnd.array(np.random.RandomState(0).rand(4, 6).astype(np.float32),
                  ctx=CPU)
    with tag.record():
        loss = net(x).sum()
    loss.backward()
    params = list(net.collect_params().values())
    scaler = tamp.DynamicLossScaler()
    assert scaler.has_overflow(params) is False
    params[0].grad()._data[0, 0] = float("inf")
    assert scaler.has_overflow(params) is True
    with pytest.raises(MXNetError, match="target_dtype"):
        tamp.init(target_dtype="int8")


def test_init_trainer_needs_init_and_convert_model_casts():
    from mxnet_tpu_torch.contrib.amp import amp as amp_impl

    saved = dict(amp_impl._amp_state)
    amp_impl._amp_state["initialized"] = False
    try:
        with pytest.raises(MXNetError, match="amp.init"):
            tamp.init_trainer(object())
    finally:
        amp_impl._amp_state.update(saved)
    args = {"w": tnd.array(np.ones((2, 2), np.float32), ctx=CPU)}
    sym, new, aux = tamp.convert_model("sym", args, {"a": 1},
                                       target_dtype="bfloat16")
    assert sym == "sym" and aux == {"a": 1}
    assert new["w"]._data.dtype == torch.bfloat16
