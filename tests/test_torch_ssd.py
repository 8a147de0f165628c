"""The port's SSD (``mxnet_tpu_torch/models/ssd.py``) against the JAX
package's on the CPU, at 96^2 and batch 2.

The JAX net is made and initialized (``Xavier``) under a seed and its
arrays are carried into the port by Gluon name (``convert``, BatchNorm's
running stats too).  Both nets then see the same numpy images and boxes.
Tolerances, relative to the largest magnitude of the JAX value: eval
outputs 1e-5; a training step's loss 1e-5 and each gradient 1e-4 (a
training-mode BatchNorm over 2 x 12^2 values a channel amplifies
rounding); ``detect``'s kept rows and class ids exactly, its scores and
boxes within 1e-5.  MultiBoxTarget's targets are equal in both steps.
A short run of the port's Gluon loop (Adam through ``gluon.Trainer``)
must lower the loss, as the JAX package's ``test_ssd`` asks of its
step.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import gluon as jgluon
from mxnet_tpu import nd as jnd
from mxnet_tpu.models import SSDTrainLoss as JaxSSDTrainLoss
from mxnet_tpu.models import ssd_300 as jax_ssd_300
import mxnet_tpu_torch as tm
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.convert import from_mxnet_tpu_params
from mxnet_tpu_torch.models import SSDTrainLoss, ssd_300

RES, B, CLASSES = 96, 2, 3
CPU = tm.cpu()


def _labels():
    lab = np.full((B, 3, 5), -1.0, np.float32)
    lab[0, :2] = [[0, 0.1, 0.15, 0.5, 0.6], [2, 0.4, 0.3, 0.9, 0.8]]
    lab[1, :1] = [[1, 0.25, 0.25, 0.75, 0.75]]
    return lab


@pytest.fixture(scope="module")
def nets():
    mx.random.seed(0)
    np.random.seed(0)
    jnet = jax_ssd_300(num_classes=CLASSES, prefix="ssd_")
    jnet.initialize(mx.init.Xavier())
    x = np.random.RandomState(1).rand(B, 3, RES, RES).astype(np.float32)
    jnet(jnd.array(x))  # resolves the deferred shapes (eval mode)
    params = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    tnet = ssd_300(num_classes=CLASSES, prefix="ssd_")
    tnet.initialize(tm.init.Xavier(), ctx=CPU)
    tnet(nd.array(x, ctx=CPU))
    from_mxnet_tpu_params(tnet, params, "ssd_")
    return jnet, tnet, x, params


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def test_names_shapes_and_count(nets):
    jnet, tnet, _, params = nets
    tparams = tnet.collect_params()
    assert sorted(tparams.keys()) == sorted(params)
    for k, v in params.items():
        assert tuple(tparams[k].shape) == v.shape, k
    # the identity at scale 0 and the global max pool hold no parameters
    assert not list(tnet.blocks[0].parameters())
    assert not list(tnet.blocks[4].parameters())
    assert sum(v.size for v in params.values()) == sum(
        p.numel() for p in tnet.parameters()) + sum(
        b.numel() for b in tnet.buffers())


def test_eval_forward_matches(nets):
    jnet, tnet, x, _ = nets
    for want, got in zip(jnet(jnd.array(x)), tnet(nd.array(x, ctx=CPU))):
        assert got.shape == want.shape
        assert _rel(got.asnumpy(), want.asnumpy()) <= 1e-5


def test_train_step_loss_grads_and_targets_match(nets):
    jnet, tnet, x, params = nets
    from_mxnet_tpu_params(tnet, params, "ssd_")
    for p in jnet.collect_params().values():
        p.set_data(jnd.array(params[p.name]))
    lab = _labels()
    with jag.record():
        ja, jc, jb = jnet(jnd.array(x))
        jloss = JaxSSDTrainLoss()(ja, jc, jb, jnd.array(lab))
    jloss.backward()
    with autograd.record():
        ta, tc, tb = tnet(nd.array(x, ctx=CPU))
        tloss = SSDTrainLoss()(ta, tc, tb, nd.array(lab, ctx=CPU))
    tloss.backward()
    assert abs(float(tloss.asscalar()) - float(jloss.asscalar())) <= \
        1e-5 * abs(float(jloss.asscalar()))
    tp = tnet.collect_params()
    for k, p in jnet.collect_params().items():
        if p.grad_req == "null":
            continue
        assert _rel(tp[k].grad().asnumpy(), p.grad().asnumpy()) <= 1e-4, k
    # the targets of both steps, from their own outputs
    jt = jnd.contrib.MultiBoxTarget(ja, jnd.array(lab),
                                    jc.transpose((0, 2, 1)),
                                    negative_mining_ratio=3.0)
    tt = nd.contrib.MultiBoxTarget(ta, nd.array(lab, ctx=CPU),
                                   nd.array(tc.asnumpy().transpose(0, 2, 1),
                                            ctx=CPU),
                                   negative_mining_ratio=3.0)
    for i in (1, 2):
        np.testing.assert_array_equal(tt[i].asnumpy(), jt[i].asnumpy())
    # BatchNorm's running stats moved alike
    for k, v in jnet.collect_params().items():
        if k.endswith(("running_mean", "running_var")):
            assert _rel(tp[k].data().asnumpy(), v.data().asnumpy()) <= 1e-4


def test_detect_matches(nets):
    jnet, tnet, x, params = nets
    from_mxnet_tpu_params(tnet, params, "ssd_")
    for p in jnet.collect_params().values():
        p.set_data(jnd.array(params[p.name]))
    for kw in (dict(), dict(threshold=0.2, nms_threshold=0.3, topk=20)):
        want = jnet.detect(jnd.array(x), **kw).asnumpy()
        got = tnet.detect(nd.array(x, ctx=CPU), **kw)
        assert isinstance(got, nd.NDArray)
        got = got.asnumpy()
        np.testing.assert_array_equal(got[..., 0], want[..., 0])
        np.testing.assert_allclose(got, want, atol=1e-5)
        assert (want[..., 0] >= 0).any()
    # a tensor in gives a tensor out
    tnet.eval()
    with torch.no_grad():
        out = tnet.detect(torch.from_numpy(x))
    assert isinstance(out, torch.Tensor) and out.shape[-1] == 6


def test_global_max_pool_matches():
    x = np.random.RandomState(2).normal(0, 1, (2, 5, 7, 6)).astype(np.float32)
    want = jgluon.nn.GlobalMaxPool2D()(jnd.array(x)).asnumpy()
    got = gluon.nn.GlobalMaxPool2D()(nd.array(x, ctx=CPU)).asnumpy()
    np.testing.assert_array_equal(got, want)
    assert got.shape == (2, 5, 1, 1)


def test_gluon_loop_lowers_the_loss():
    """``examples/train_detection.py``'s SSD loop on the port: record ->
    backward -> ``Trainer.step``, Adam lr 1e-3, on one fixed batch."""
    tm.random.seed(0)
    net = ssd_300(num_classes=1)
    net.initialize(tm.init.Xavier(), ctx=CPU)
    loss_block = SSDTrainLoss()
    x = nd.array(np.random.RandomState(0).rand(4, 3, RES, RES)
                 .astype(np.float32), ctx=CPU)
    labels = nd.array(np.tile(np.array([[[0, 0.25, 0.25, 0.75, 0.75]]],
                                       np.float32), (4, 1, 1)), ctx=CPU)
    net(x)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 1e-3})
    losses = []
    for _ in range(8):
        with autograd.record():
            anchors, cls_preds, box_preds = net(x)
            loss = loss_block(anchors, cls_preds, box_preds, labels)
        loss.backward()
        trainer.step(4)
        losses.append(float(loss.asscalar()))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
