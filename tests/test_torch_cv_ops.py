"""The port's detection ops (``mxnet_tpu_torch/ops/cv_ops.py``) against
the JAX package's (``mxnet_tpu/ops/cv_ops.py``) on the CPU.

The same numpy inputs, drawn from seeds, go through both.  Integer
outputs, masks, keep decisions, orders and values an op selects (not
computes) must be exactly equal; computed floats within ``ATOL`` (1e-6)
of the JAX value, or 1e-5 relative for ``ROIAlign``'s feature gradient.
The cases include tied scores (NMS, Proposal's -1 rows, mining ranks),
NMS bounded by ``topk``, padded gt rows, two gt boxes that share their
best anchor (the higher gt index wins in both, the XLA CPU scatter's
order) and ``mode="drop"`` rows.  Every op is reached through
``nd.contrib.<name>`` (or ``nd.<name>``) too.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops import cv_ops as J
from mxnet_tpu.ops import elemwise as jelem
from mxnet_tpu_torch import cpu, nd
from mxnet_tpu_torch.ops import cv_ops as T
from mxnet_tpu_torch.ops import registry
from mxnet_tpu_torch.ops.elemwise import smooth_l1

ATOL = 1e-6

OPS = ("_contrib_box_iou", "_contrib_box_nms", "_contrib_bipartite_matching",
       "_contrib_MultiBoxPrior", "_contrib_MultiBoxTarget",
       "_contrib_MultiBoxDetection", "ROIPooling", "_contrib_ROIAlign",
       "_contrib_Proposal", "_contrib_MultiProposal", "_contrib_box_encode",
       "_contrib_box_decode", "_contrib_mrcnn_mask_target",
       "_contrib_RPNAnchorTarget", "_contrib_ProposalTarget", "smooth_l1")


def _j(fn, *args, eager=False, **kw):
    """The JAX op, jitted as one program (its attributes static), or
    eager, op by op: XLA's fusion of the bilinear ops contracts
    multiply-adds, which moves their values by a few 1e-6."""
    fn = functools.partial(fn, **kw)
    out = (fn if eager else jax.jit(fn))(*[jnp.asarray(a) for a in args])
    return [np.asarray(o) for o in (out if isinstance(out, (tuple, list))
                                    else (out,))]


def _t(fn, *args, **kw):
    out = fn(*[torch.from_numpy(np.asarray(a)) for a in args], **kw)
    return [o.numpy() for o in (out if isinstance(out, (tuple, list))
                                else (out,))]


def _boxes(rng, shape, lo=0.0, hi=1.0, min_wh=0.02):
    xy = rng.uniform(lo, hi * 0.8, shape + (2,))
    wh = rng.uniform(min_wh, hi * 0.4, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _labels(rng, b, m, pad_rows=1):
    lab = np.concatenate([rng.randint(0, 4, (b, m, 1)).astype(np.float32),
                          _boxes(rng, (b, m))], -1)
    lab[:, m - pad_rows:] = -1.0
    return lab


def _anchors(sizes=(0.3, 0.2), ratios=(1, 2, 0.5), hw=8):
    return _t(T.multibox_prior, np.zeros((1, 1, hw, hw), np.float32),
              sizes=sizes, ratios=ratios)[0]


def test_every_op_is_registered_and_reachable():
    names = registry.list_ops()
    assert all(op in names for op in OPS)
    for op in OPS:
        short = op[len("_contrib_"):] if op.startswith("_contrib_") else op
        ns = nd.contrib if op.startswith("_contrib_") else nd
        assert callable(getattr(ns, short)), op
    a = nd.array(np.array([[0, 0, 2, 2], [1, 1, 3, 3]], np.float32), ctx=cpu())
    iou = nd.contrib.box_iou(a, a).asnumpy()
    np.testing.assert_allclose(iou, _j(J.box_iou, a.asnumpy(),
                                       a.asnumpy())[0], atol=ATOL)
    x = nd.array(np.array([-2.0, -0.1, 0.05, 3.0], np.float32), ctx=cpu())
    np.testing.assert_allclose(nd.smooth_l1(x, scalar=3.0).asnumpy(),
                               np.asarray(jelem.smooth_l1(
                                   jnp.asarray(x.asnumpy()), scalar=3.0)),
                               atol=ATOL)


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou(fmt):
    rng = np.random.RandomState(0)
    lhs, rhs = _boxes(rng, (2, 7)), _boxes(rng, (2, 5))
    np.testing.assert_allclose(_t(T.box_iou, lhs, rhs, format=fmt)[0],
                               _j(J.box_iou, lhs, rhs, format=fmt)[0],
                               atol=ATOL)


def _dets(rng, b, n, grid=8):
    """Rows [cls, score, x1, y1, x2, y2]; scores on a grid of 1/grid, so
    many tie; clustered boxes, so NMS suppresses."""
    d = np.zeros((b, n, 6), np.float32)
    d[..., 0] = rng.randint(0, 3, (b, n))
    d[..., 1] = np.round(rng.uniform(0, 1, (b, n)) * grid) / grid
    centre = rng.uniform(0.3, 0.7, (b, n, 2))
    half = rng.uniform(0.05, 0.2, (b, n, 2))
    d[..., 2:4], d[..., 4:6] = centre - half, centre + half
    return d


@pytest.mark.parametrize("kw", [
    dict(overlap_thresh=0.5, valid_thresh=0.1, topk=-1, id_index=0),
    dict(overlap_thresh=0.4, valid_thresh=0.0, topk=7, id_index=0),
    dict(overlap_thresh=0.3, valid_thresh=0.2, topk=5, id_index=0,
         force_suppress=True),
    dict(overlap_thresh=0.5, valid_thresh=0.0, topk=-1, id_index=-1),
    dict(overlap_thresh=0.5, valid_thresh=0.0, topk=3, id_index=0,
         background_id=1),
    dict(overlap_thresh=0.5, valid_thresh=0.0, topk=100, id_index=0),
], ids=["class_aware", "topk", "force", "no_id", "background", "topk_big"])
def test_box_nms(kw):
    d = _dets(np.random.RandomState(1), 3, 24)
    got, want = _t(T.box_nms, d, **kw)[0], _j(J.box_nms, d, **kw)[0]
    np.testing.assert_array_equal(got, want)
    assert (got[..., 0] >= 0).sum() > 0
    # 2-d input and the center format
    got = _t(T.box_nms, d[0], in_format="center", **kw)[0]
    np.testing.assert_array_equal(
        got, _j(J.box_nms, d[0], in_format="center", **kw)[0])


def test_box_nms_topk_bounds_the_loop_exactly():
    """Rows past topk are never kept, so they suppress nothing: the
    port's loop over the first topk rows gives the full loop's answer."""
    d = _dets(np.random.RandomState(2), 2, 40, grid=1000)
    for k in (1, 4, 13, 39, 40):
        got = _t(T.box_nms, d, overlap_thresh=0.3, topk=k, id_index=0)[0]
        want = _j(J.box_nms, d, overlap_thresh=0.3, topk=k, id_index=0)[0]
        np.testing.assert_array_equal(got, want)
        assert ((got[..., 0] >= 0).sum(axis=1) <= k).all()


@pytest.mark.parametrize("is_ascend,topk", [(False, -1), (True, -1),
                                             (False, 3)])
def test_bipartite_matching(is_ascend, topk):
    rng = np.random.RandomState(3)
    s = (np.round(rng.uniform(0, 1, (2, 6, 4)) * 4) / 4).astype(np.float32)
    kw = dict(threshold=0.3 if not is_ascend else 0.7, is_ascend=is_ascend,
              topk=topk)
    for got, want in zip(_t(T.bipartite_matching, s, **kw),
                         _j(J.bipartite_matching, s, **kw)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(_t(T.bipartite_matching, s[0], **kw),
                         _j(J.bipartite_matching, s[0], **kw)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(sizes=(0.2, 0.272), ratios=(1, 2, 0.5)),
    dict(sizes=(0.5,), ratios=(1, 3), clip=True),
    dict(sizes=(0.1, 0.3), ratios=(1,), steps=(0.2, 0.25),
         offsets=(0.3, 0.6)),
])
def test_multibox_prior(kw):
    x = np.zeros((2, 3, 5, 7), np.float32)
    np.testing.assert_allclose(_t(T.multibox_prior, x, **kw)[0],
                               _j(J.multibox_prior, x, **kw)[0], atol=ATOL)


def _target_case(seed, b=3, m=4):
    rng = np.random.RandomState(seed)
    anchors = _anchors()
    lab = _labels(rng, b, m)
    # image 0: rows 0 and 1 one box under two classes (a shared best
    # anchor); image 1 all padding; image 2 a box far from every anchor
    lab[0, 1] = lab[0, 0]
    lab[0, 1, 0] = (lab[0, 0, 0] + 1) % 4
    lab[1] = -1.0
    lab[2, 0, 1:] = [0.0, 0.0, 1e-4, 1e-4]
    # mining scores on a grid: ties among the negatives
    cls = (np.round(rng.normal(0, 1, (b, 5, anchors.shape[1])) * 4) / 4
           ).astype(np.float32)
    return anchors, lab, cls


@pytest.mark.parametrize("kw", [
    dict(),
    dict(negative_mining_ratio=3.0),
    dict(negative_mining_ratio=2.0, negative_mining_thresh=0.0,
         minimum_negative_samples=5, overlap_threshold=0.4),
    dict(ignore_label=-2.0, negative_mining_ratio=1.0,
         variances=(0.2, 0.2, 0.1, 0.1)),
])
def test_multibox_target(kw):
    anchors, lab, cls = _target_case(4)
    got, want = _t(T.multibox_target, anchors, lab, cls, **kw), \
        _j(J.multibox_target, anchors, lab, cls, **kw)
    np.testing.assert_array_equal(got[1], want[1])        # loc_mask
    np.testing.assert_array_equal(got[2], want[2])        # cls_target
    np.testing.assert_allclose(got[0], want[0], atol=1e-5)
    assert (want[2] > 0).any()


def test_multibox_target_shared_best_anchor_goes_to_the_higher_gt():
    """Two gt boxes whose best anchor is the same: the JAX scatter (XLA on
    the CPU, updates in order) gives it the higher gt index, run after
    run; the port takes the max index, which the card also gives."""
    anchors = np.array([[[0, 0, 0.5, 0.5], [0.6, 0.6, 1, 1]]], np.float32)
    lab = np.array([[[0, 0, 0, 0.5, 0.5], [1, 0.3, 0.3, 0.55, 0.55],
                     [-1, 0, 0, 0, 0]]], np.float32)
    cls = np.zeros((1, 3, 2), np.float32)
    for _ in range(3):
        want = _j(J.multibox_target, anchors, lab, cls)
        assert want[2][0, 0] == 2.0
    got = _t(T.multibox_target, anchors, lab, cls)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_multibox_detection():
    rng = np.random.RandomState(5)
    anchors = _anchors()
    n = anchors.shape[1]
    prob = rng.uniform(0, 1, (2, 4, n)).astype(np.float32)
    prob[:, :, : n // 4] = np.round(prob[:, :, : n // 4] * 4) / 4  # ties
    loc = rng.normal(0, 1, (2, n * 4)).astype(np.float32)
    for kw in (dict(), dict(nms_topk=20, threshold=0.3),
               dict(force_suppress=True, nms_threshold=0.3),
               dict(background_id=1, clip=False)):
        got = _t(T.multibox_detection, prob, loc, anchors, **kw)[0]
        want = _j(J.multibox_detection, prob, loc, anchors, **kw)[0]
        np.testing.assert_array_equal(got[..., :2], want[..., :2])
        np.testing.assert_allclose(got, want, atol=ATOL)


def _rois(rng, r, b, hi):
    rois = np.zeros((r, 5), np.float32)
    rois[:, 0] = rng.randint(0, b, r)
    rois[:, 1:] = _boxes(rng, (r,), 0, hi, 1.0)
    return rois


def test_roi_pooling():
    rng = np.random.RandomState(6)
    data = rng.normal(0, 1, (2, 3, 12, 14)).astype(np.float32)
    rois = _rois(rng, 9, 2, 80.0)
    rois[0, 1:] = [200, 200, 300, 300]                 # clamped to the map
    kw = dict(pooled_size=(3, 4), spatial_scale=1.0 / 8)
    np.testing.assert_array_equal(_t(T.roi_pooling, data, rois, **kw)[0],
                                  _j(J.roi_pooling, data, rois, **kw)[0])
    # gradient: the max's input gets it (no ties in random data)
    td = torch.from_numpy(data).requires_grad_(True)
    T.roi_pooling(td, torch.from_numpy(rois), **kw).sum().backward()
    jg = jax.jit(jax.grad(lambda d: J.roi_pooling(
        d, jnp.asarray(rois), **kw).sum()))(jnp.asarray(data))
    np.testing.assert_allclose(td.grad.numpy(), np.asarray(jg), atol=ATOL)


@pytest.mark.parametrize("kw", [dict(), dict(sample_ratio=3, aligned=True)])
def test_roi_align_forward_and_gradient(kw):
    rng = np.random.RandomState(7)
    data = rng.normal(0, 1, (2, 4, 10, 12)).astype(np.float32)
    rois = _rois(rng, 6, 2, 90.0)
    kw = dict(kw, pooled_size=(3, 3), spatial_scale=1.0 / 8)
    np.testing.assert_allclose(_t(T.roi_align, data, rois, **kw)[0],
                               _j(J.roi_align, data, rois, eager=True,
                                  **kw)[0], atol=ATOL)
    w = rng.normal(0, 1, (6, 4, 3, 3)).astype(np.float32)
    td = torch.from_numpy(data).requires_grad_(True)
    (T.roi_align(td, torch.from_numpy(rois), **kw)
     * torch.from_numpy(w)).sum().backward()
    jg = jax.jit(jax.grad(lambda d: (J.roi_align(d, jnp.asarray(rois), **kw)
                                     * w).sum()))(jnp.asarray(data))
    jg = np.asarray(jg)
    assert np.abs(td.grad.numpy() - jg).max() <= 1e-5 * np.abs(jg).max()


def _rpn_case(seed, b=2, a=6, hw=6, grid=16):
    rng = np.random.RandomState(seed)
    fg = np.round(rng.uniform(0, 1, (b, a, hw, hw)) * grid) / grid
    prob = np.concatenate([1 - fg, fg], 1).astype(np.float32)
    bbox = rng.normal(0, 0.2, (b, 4 * a, hw, hw)).astype(np.float32)
    info = np.tile(np.array([[hw * 8, hw * 8, 1.0]], np.float32), (b, 1))
    info[1, :2] = [hw * 8 - 9, hw * 8 - 3]              # clipped tighter
    return prob, bbox, info


@pytest.mark.parametrize("fn", ["proposal", "multi_proposal"])
@pytest.mark.parametrize("kw", [
    dict(rpn_pre_nms_top_n=40, rpn_post_nms_top_n=12, rpn_min_size=4),
    dict(rpn_pre_nms_top_n=-1, rpn_post_nms_top_n=20, rpn_min_size=12,
         threshold=0.5),
    dict(rpn_pre_nms_top_n=500, rpn_post_nms_top_n=8, rpn_min_size=0),
])
def test_proposal(fn, kw):
    """Scores tie on a grid of 1/16, and boxes under ``rpn_min_size``
    become -1 rows: the pre-NMS top-k keeps lax.top_k's order (ties to
    the lower index) and the rois come out in the same order."""
    prob, bbox, info = _rpn_case(8)
    kw = dict(kw, scales=(2.0, 4.0), ratios=(0.5, 1.0, 2.0),
              feature_stride=8, output_score=True)
    got = _t(getattr(T, fn), prob, bbox, info, **kw)
    want = _j(getattr(J, fn), prob, bbox, info, **kw)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[0][:, 0], want[0][:, 0])
    np.testing.assert_allclose(got[0], want[0], atol=1e-4)
    kw["output_score"] = False
    np.testing.assert_allclose(_t(getattr(T, fn), prob, bbox, info, **kw)[0],
                               want[0], atol=1e-4)


def test_box_encode_and_decode():
    rng = np.random.RandomState(9)
    anchors = _anchors()
    n = anchors.shape[1]
    samples = rng.choice([-1.0, 0.0, 1.0], (2, n)).astype(np.float32)
    matches = rng.randint(0, 3, (2, n)).astype(np.float32)
    refs = _boxes(rng, (2, 3))
    args = (samples, matches, np.repeat(anchors, 2, 0), refs)
    for kw in (dict(), dict(means=(0.1, 0.0, -0.1, 0.0),
                            stds=(0.2, 0.2, 0.3, 0.3))):
        for got, want in zip(_t(T.box_encode, *args, **kw),
                             _j(J.box_encode, *args, **kw)):
            np.testing.assert_allclose(got, want, atol=1e-5)
    deltas = rng.normal(0, 1, (2, n, 4)).astype(np.float32)
    for kw in (dict(), dict(clip=1.0, std0=0.2), dict(format="center")):
        np.testing.assert_allclose(_t(T.box_decode, deltas, anchors, **kw)[0],
                                   _j(J.box_decode, deltas, anchors, **kw)[0],
                                   atol=1e-5)


@pytest.mark.parametrize("kw", [dict(), dict(mask_size=5, sample_ratio=3,
                                             aligned=True)])
def test_mrcnn_mask_target(kw):
    rng = np.random.RandomState(10)
    rois = np.concatenate([rng.uniform(0, 10, (2, 5, 2)),
                           rng.uniform(14, 31, (2, 5, 2))], -1).astype(
        np.float32)
    masks = (rng.uniform(0, 1, (2, 3, 32, 32)) > 0.5).astype(np.float32)
    matches = rng.randint(0, 3, (2, 5)).astype(np.float32)
    cls = rng.randint(0, 4, (2, 5)).astype(np.float32)
    kw = dict(kw, num_classes=4)
    for got, want in zip(_t(T.mrcnn_mask_target, rois, masks, matches, cls,
                            **kw),
                         _j(J.mrcnn_mask_target, rois, masks, matches, cls,
                            eager=True, **kw)):
        np.testing.assert_allclose(got, want, atol=ATOL)


def _gt_pixels(rng, b, m, hi):
    gt = np.concatenate([rng.randint(0, 3, (b, m, 1)).astype(np.float32),
                         _boxes(rng, (b, m), 0, hi, 4.0)], -1)
    gt[:, -1] = -1.0
    return gt


def test_rpn_anchor_target():
    prob, _, _ = _rpn_case(11)
    gt = _gt_pixels(np.random.RandomState(11), 2, 4, 48.0)
    gt[1] = -1.0                                          # no gt at all
    kw = dict(scales=(2.0, 4.0), ratios=(0.5, 1.0, 2.0), feature_stride=8)
    got, want = _t(T.rpn_anchor_target, prob, gt, **kw), \
        _j(J.rpn_anchor_target, prob, gt, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], atol=1e-5)
    assert (want[0] == 1).any() and not (want[0][1] == 1).any()


@pytest.mark.parametrize("kw", [
    dict(num_classes=4, batch_rois=16, fg_fraction=0.25),
    dict(num_classes=4, batch_rois=24, fg_fraction=0.5, fg_overlap=0.3,
         box_stds=(0.2, 0.2, 0.3, 0.3)),
])
def test_proposal_target(kw):
    rng = np.random.RandomState(12)
    prob, bbox, info = _rpn_case(12)
    rois = _t(T.proposal, prob, bbox, info, rpn_pre_nms_top_n=60,
              rpn_post_nms_top_n=20, scales=(2.0, 4.0),
              ratios=(0.5, 1.0, 2.0), feature_stride=8)[0]
    gt = _gt_pixels(rng, 2, 4, 48.0)
    kw = dict(kw, batch_images=2)
    got, want = _t(T.proposal_target, rois, gt, **kw), \
        _j(J.proposal_target, rois, gt, **kw)
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i], want[i])
    np.testing.assert_allclose(got[2], want[2], atol=1e-5)
    assert (want[1] > 0).any()


def test_smooth_l1_and_its_gradient():
    x = np.linspace(-2, 2, 41).astype(np.float32)
    for s in (1.0, 3.0):
        tx = torch.from_numpy(x).requires_grad_(True)
        smooth_l1(tx, scalar=s).sum().backward()
        jg = jax.grad(lambda v: jelem.smooth_l1(v, scalar=s).sum())(
            jnp.asarray(x))
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg),
                                   atol=ATOL)
