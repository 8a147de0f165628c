"""The port's training step vs the JAX package's ``DataParallelStep``.

Both train ``bert_small(dropout=0.0)`` from the same weights (drawn by the
JAX package's ``mx.init.Normal(0.02)`` and carried by name) on the same
fixed batch of tokens (4, 16) from ``RandomState(0)``, with labels equal
to the tokens and the MLM loss of ``tests/test_parallel.py``
(``SoftmaxCrossEntropyLoss`` over the flattened logits).  The JAX side is
``DataParallelStep`` on a one-device CPU mesh.  Losses agree within rtol
2e-4 at every step and every parameter within atol 2e-4 at the end: f32
on both sides, sums in another order, and the optimizer amplifies the
differences of the gradients over the steps.
"""
import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import gluon, nd
from mxnet_tpu.models import bert_small as jax_bert_small
from mxnet_tpu.parallel import DataParallelStep as JaxDataParallelStep
from mxnet_tpu.parallel import local_mesh
from mxnet_tpu_torch.convert import from_mxnet_tpu_params, gluon_name
from mxnet_tpu_torch.gluon.loss import SoftmaxCrossEntropyLoss
from mxnet_tpu_torch.models.bert import bert_small
from mxnet_tpu_torch.parallel import AsyncLoss, DataParallelStep

TOKENS = np.random.RandomState(0).randint(0, 512, (4, 16)).astype(np.int32)


def _jax_net():
    mx.random.seed(0)
    np.random.seed(0)
    net = jax_bert_small(dropout=0.0)
    net.initialize(mx.init.Normal(0.02))
    net(nd.array(TOKENS, dtype="int32"))  # resolves deferred init
    return net


def _run(optimizer, optimizer_params, steps):
    jnet = _jax_net()
    start = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()

    def jax_mlm(logits, labels):
        return loss_fn(logits.reshape(-1, logits.shape[-1]),
                       labels.reshape(-1))

    jstep = JaxDataParallelStep(
        jnet, jax_mlm, mesh=local_mesh(devices=[jax.devices("cpu")[0]]),
        optimizer=optimizer, optimizer_params=optimizer_params)
    jlosses = [float(np.asarray(jstep.step(
        nd.array(TOKENS, dtype="int32"),
        nd.array(TOKENS.astype(np.float32))))) for _ in range(steps)]

    tnet = bert_small(dropout=0.0, device="cpu")
    from_mxnet_tpu_params(tnet, start, jnet.prefix)
    tloss = SoftmaxCrossEntropyLoss()

    def mlm(logits, labels):
        return tloss(logits.reshape(-1, logits.shape[-1]), labels.reshape(-1))

    tstep = DataParallelStep(tnet, mlm, optimizer=optimizer,
                             optimizer_params=optimizer_params, device="cpu")
    handles = [tstep.step(TOKENS, TOKENS.astype(np.float32))
               for _ in range(steps)]
    final = {jnet.prefix + gluon_name(tnet, k): v
             for k, v in tnet.state_dict().items()}
    jfinal = {k: np.asarray(v) for k, v in jstep.params.items()}
    return jlosses, handles, final, jfinal


@pytest.mark.parametrize("optimizer,params,steps", [
    ("adam", {"learning_rate": 1e-3}, 5),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4}, 3),
])
def test_training_matches_jax_data_parallel_step(optimizer, params, steps):
    jlosses, handles, final, jfinal = _run(optimizer, params, steps)
    assert all(isinstance(h, AsyncLoss) for h in handles)
    losses = [float(h) for h in handles]
    np.testing.assert_allclose(losses, jlosses, rtol=2e-4)
    assert losses[-1] < losses[0], "a fixed batch is being memorised"
    assert set(final) == set(jfinal)
    for name, value in final.items():
        np.testing.assert_allclose(value.numpy(), jfinal[name], rtol=0,
                                   atol=2e-4, err_msg=name)


def test_async_loss_reads_the_value():
    h = AsyncLoss(torch.tensor(2.5))
    assert float(h) == 2.5 and h.item() == 2.5 and h.wait() == 2.5


def test_step_takes_tuples_clips_and_freezes():
    """``data`` may be a tuple of inputs; ``clip_gradient`` bounds each
    update of SGD without momentum by lr * clip; a parameter with
    ``requires_grad=False`` is left as it was."""
    net = bert_small(dropout=0.0, device="cpu",
                     generator=torch.Generator().manual_seed(1))
    net.bert.pos_embed.weight.requires_grad_(False)
    before = {k: v.clone() for k, v in net.state_dict().items()}
    lossf = SoftmaxCrossEntropyLoss()
    step = DataParallelStep(
        net, lambda lg, lb: lossf(lg.reshape(-1, 512), lb.reshape(-1)),
        optimizer="sgd", device="cpu",
        optimizer_params={"learning_rate": 0.5, "momentum": 0.0,
                          "clip_gradient": 1e-3, "rescale_grad": 4.0})
    types = np.zeros_like(TOKENS)
    assert np.isfinite(float(step.step((TOKENS, types), TOKENS)))
    after = net.state_dict()
    assert torch.equal(after["bert.pos_embed.weight"],
                       before["bert.pos_embed.weight"])
    moved = max(float((after[k] - before[k]).abs().max()) for k in after)
    assert 0 < moved <= 0.5 * 1e-3 + 1e-7
