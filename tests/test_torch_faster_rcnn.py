"""The port's Faster-RCNN (``mxnet_tpu_torch/models/faster_rcnn.py``)
against the JAX package's on the CPU, at 96^2 and batch 2.

The JAX net (``faster_rcnn_small(num_classes=3)``, ``Xavier``) resolves
its deferred shapes (the Dense layers' ``in_units`` too) on a first call,
and its arrays are carried into the port by Gluon name (``convert``).
Tolerances, relative to the largest magnitude of the JAX value: eval
outputs 1e-5; the proposals' order and scores exactly, their boxes
within 1e-4 pixels; the four-loss training step's loss 1e-5 and each
gradient 1e-4; ``detect``'s kept rows and class ids exactly, the rest
within 1e-4.  A short Gluon loop must lower the loss.  The detector
shared by its loss block and direct calls follows MXNet's train flag in
every layer, whichever block the call goes through.
"""
import numpy as np
import pytest

import mxnet_tpu as mx
from mxnet_tpu import autograd as jag
from mxnet_tpu import nd as jnd
from mxnet_tpu.models import FasterRCNNTrainLoss as JaxLoss
from mxnet_tpu.models import faster_rcnn_small as jax_frcnn
import mxnet_tpu_torch as tm
from mxnet_tpu_torch import autograd, gluon, nd
from mxnet_tpu_torch.convert import from_mxnet_tpu_params
from mxnet_tpu_torch.models import FasterRCNNTrainLoss, faster_rcnn_small

RES, B, CLASSES = 96, 2, 3
CPU = tm.cpu()


def _batch():
    x = np.random.RandomState(1).rand(B, 3, RES, RES).astype(np.float32)
    gt = np.full((B, 3, 5), -1.0, np.float32)
    gt[0, :2] = [[0, 8, 10, 50, 60], [2, 40, 30, 90, 85]]
    gt[1, :1] = [[1, 20, 20, 70, 70]]
    info = np.tile(np.array([[RES, RES, 1.0]], np.float32), (B, 1))
    return x, gt, info


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def nets():
    mx.random.seed(0)
    jnet = jax_frcnn(num_classes=CLASSES, prefix="frcnn_")
    jnet.initialize(mx.init.Xavier())
    x, gt, info = _batch()
    JaxLoss(jnet)(jnd.array(x), jnd.array(gt), jnd.array(info))
    params = {k: p.data().asnumpy() for k, p in jnet.collect_params().items()}
    tnet = faster_rcnn_small(num_classes=CLASSES, prefix="frcnn_")
    tnet.initialize(tm.init.Xavier(), ctx=CPU)
    # the first call resolves the port's deferred shapes as the JAX one's
    FasterRCNNTrainLoss(tnet)(*[nd.array(a, ctx=CPU) for a in (x, gt, info)])
    from_mxnet_tpu_params(tnet, params, "frcnn_")
    return jnet, tnet, params


def _reload(nets):
    jnet, tnet, params = nets
    from_mxnet_tpu_params(tnet, params, "frcnn_")
    for p in jnet.collect_params().values():
        p.set_data(jnd.array(params[p.name]))
    return jnet, tnet


def test_names_and_deferred_shapes(nets):
    jnet, tnet, params = nets
    tparams = tnet.collect_params()
    assert sorted(tparams.keys()) == sorted(params)
    for k, v in params.items():
        assert tuple(tparams[k].shape) == v.shape, k
    assert tparams["frcnn_dense0_weight"].shape == (256, 64 * 7 * 7)


def test_forward_proposals_and_head_match(nets):
    from mxnet_tpu import ndarray as JF

    jnet, tnet = _reload(nets)
    x, _, info = _batch()
    jout = jnet(jnd.array(x))
    tout = tnet(nd.array(x, ctx=CPU))
    for want, got in zip(jout, tout):
        assert _rel(got.asnumpy(), want.asnumpy()) <= 1e-5
    # stage one and two on the same inputs (the JAX net's outputs)
    feat, rpn_cls, rpn_bbox = (nd.array(o.asnumpy(), ctx=CPU) for o in jout)
    jrois = jnet.proposals(JF, *jout[1:], jnd.array(info))
    trois = tnet.proposals(None, rpn_cls, rpn_bbox, nd.array(info, ctx=CPU))
    assert isinstance(trois, nd.NDArray)
    np.testing.assert_array_equal(trois.asnumpy()[:, 0],
                                  jrois.asnumpy()[:, 0])
    np.testing.assert_allclose(trois.asnumpy(), jrois.asnumpy(), atol=1e-4)
    jh = jnet.rcnn_head(JF, jout[0], jrois)
    th = tnet.rcnn_head(None, feat, nd.array(jrois.asnumpy(), ctx=CPU))
    for want, got in zip(jh, th):
        assert _rel(got.asnumpy(), want.asnumpy()) <= 1e-5


def test_train_step_loss_and_grads_match(nets):
    jnet, tnet = _reload(nets)
    x, gt, info = _batch()
    with jag.record():
        jloss = JaxLoss(jnet)(jnd.array(x), jnd.array(gt), jnd.array(info))
    jloss.backward()
    with autograd.record():
        tloss = FasterRCNNTrainLoss(tnet)(
            *[nd.array(a, ctx=CPU) for a in (x, gt, info)])
    tloss.backward()
    want = float(jloss.asscalar())
    assert abs(float(tloss.asscalar()) - want) <= 1e-5 * abs(want)
    tp = tnet.collect_params()
    for k, p in jnet.collect_params().items():
        if p.grad_req == "null":
            continue
        assert _rel(tp[k].grad().asnumpy(), p.grad().asnumpy()) <= 1e-4, k


def test_detect_matches(nets):
    jnet, tnet = _reload(nets)
    x, _, info = _batch()
    for kw in (dict(threshold=0.0), dict(threshold=0.2, nms_threshold=0.5,
                                         topk=10)):
        want = jnet.detect(jnd.array(x), **kw).asnumpy()
        got = tnet.detect(nd.array(x, ctx=CPU), **kw).asnumpy()
        assert got.shape == (B, 64, 6)
        np.testing.assert_array_equal(got[..., 0], want[..., 0])
        np.testing.assert_allclose(got, want, atol=1e-4)
        assert (want[..., 0] >= 0).any()
    got = tnet.detect(nd.array(x, ctx=CPU), im_info=nd.array(info, ctx=CPU))
    np.testing.assert_allclose(got.asnumpy(),
                               jnet.detect(jnd.array(x)).asnumpy(), atol=1e-4)


def test_shared_detector_follows_the_train_flag():
    """An NDArray call of the detector alone (eval: no ``record``) leaves
    its layers in eval mode; the next recorded call through the loss
    block that holds it must run every layer in training mode, as every
    JAX layer reads the one flag (the port once checked only the outer
    block's mode)."""
    tm.random.seed(0)
    net = faster_rcnn_small(num_classes=CLASSES)
    net.initialize(tm.init.Xavier(), ctx=CPU)
    loss_block = FasterRCNNTrainLoss(net)
    args = [nd.array(a, ctx=CPU) for a in _batch()]
    with autograd.record():
        loss_block(*args)
    net(args[0])
    assert not any(m.training for m in net.modules())
    bn = net.body[0][0][1]
    before = bn.running_mean.clone()
    with autograd.record():
        loss_block(*args)
    assert all(m.training for m in net.modules())
    assert not bool((bn.running_mean == before).all())


def test_gluon_loop_lowers_the_loss():
    """``examples/train_detection.py --model faster_rcnn`` on the port:
    record -> backward -> ``Trainer.step`` with Adam lr 1e-3."""
    tm.random.seed(0)
    net = faster_rcnn_small(num_classes=1)
    net.initialize(tm.init.Xavier(), ctx=CPU)
    loss_block = FasterRCNNTrainLoss(net)
    x = nd.array(np.random.RandomState(0).rand(2, 3, 64, 64)
                 .astype(np.float32), ctx=CPU)
    gt = nd.array(np.tile(np.array([[[0, 16, 16, 48, 48]]], np.float32),
                          (2, 1, 1)), ctx=CPU)
    info = nd.array(np.tile(np.array([[64, 64, 1.0]], np.float32), (2, 1)),
                    ctx=CPU)
    loss_block(x, gt, info)
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 1e-3})
    losses = []
    for _ in range(8):
        with autograd.record():
            loss = loss_block(x, gt, info)
        loss.backward()
        trainer.step(2)
        losses.append(float(loss.asscalar()))
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0], losses
