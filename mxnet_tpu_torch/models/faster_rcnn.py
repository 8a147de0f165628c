"""Faster-RCNN two-stage detector (BASELINE config 5, second half), the
port's counterpart of ``mxnet_tpu/models/faster_rcnn.py`` (reference:
example/rcnn/symbol/symbol_resnet.py plus proposal.cc /
proposal_target.cc).

A conv body, the RPN (a 3x3 conv with ReLU, then 1x1 class and box
convs), ``Proposal`` (decode, clip, pre-NMS top-k, NMS; gradients
blocked), ``ROIAlign`` and two fully connected layers feeding the class
and box heads.  Training targets are the JAX ops' deterministic ones
(``RPNAnchorTarget``: every anchor labelled, fg and bg halves
normalized apart; ``ProposalTarget``: IoU-ranked selection), so the whole
step is the same as there.  ``Conv2D(..., activation="relu")`` and
``Dense(flatten=False)`` with deferred ``in_units`` resolve at the first
call.  The blocks are made in the JAX class's order and name scopes
(``rpn_conv_``, ``top_``, ``cls_head_``, ...), so ``collect_params()``
gives the JAX net's names and ``convert`` carries its weights.

``proposals``, ``rcnn_head`` and ``rpn_probs`` keep the JAX methods'
``F`` argument (ignored here) and take tensors or NDArrays.  ``detect``
reads the stage-two outputs back to the host and decodes each roi's
best class in numpy, as the JAX method does, then runs ``box_nms`` on
the input's device.  ``FasterRCNN.hybrid_forward`` (body and RPN) is
the JAX block's, so ``export`` writes its graph node for node; the
training loss traces no graph, in either package.  No kernel of the port
is on this path.
"""
from __future__ import annotations

import numpy as np
import torch

from ..gluon import HybridBlock, loss as gloss, nn
from ..ndarray.ndarray import NDArray
from ..ops import cv_ops
from ..ops import nn as _ops
from ..ops.elemwise import smooth_l1
from ..symbol.symbol import Symbol

__all__ = ["FasterRCNN", "FasterRCNNTrainLoss", "faster_rcnn_small"]


def _conv_block(channels):
    blk = nn.HybridSequential()
    blk.add(nn.Conv2D(channels, 3, padding=1, use_bias=False),
            nn.BatchNorm(), nn.Activation("relu"))
    return blk


def _down_sample(channels):
    blk = nn.HybridSequential()
    blk.add(_conv_block(channels), _conv_block(channels), nn.MaxPool2D(2))
    return blk


def _t(x):
    return x.data if isinstance(x, NDArray) else x


def _like(ref, *outs):
    """``outs`` as NDArrays when ``ref`` is one."""
    if isinstance(ref, NDArray):
        outs = tuple(NDArray(o) for o in outs)
    return outs if len(outs) > 1 else outs[0]


class FasterRCNN(HybridBlock):
    """Two-stage detector: conv body -> RPN -> proposals -> ROIAlign ->
    cls/bbox heads.

    forward(x) returns (feat, rpn_cls (B, 2A, H, W), rpn_bbox (B, 4A, H, W));
    `rcnn_head` runs stage two on a given roi set; `detect` is the
    end-to-end inference path.
    """

    def __init__(self, num_classes, base_channels=(16, 32, 64),
                 rpn_channels=128, scales=(2.0, 4.0), ratios=(0.5, 1.0, 2.0),
                 rpn_pre_nms=256, rpn_post_nms=64, rpn_min_size=4,
                 rois_per_image=32, fg_fraction=0.5, roi_size=(7, 7),
                 hidden=256, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.num_classes = num_classes
        self._scales = tuple(float(s) for s in scales)
        self._ratios = tuple(float(r) for r in ratios)
        self._num_anchors = len(self._scales) * len(self._ratios)
        self._stride = 2 ** len(base_channels)
        self._rpn_pre = rpn_pre_nms
        self._rpn_post = rpn_post_nms
        self._rpn_min = rpn_min_size
        self._rois_per_image = rois_per_image
        self._fg_fraction = fg_fraction
        self._roi_size = tuple(roi_size)
        a = self._num_anchors
        with self.name_scope():
            body = nn.HybridSequential()
            for c in base_channels:
                body.add(_down_sample(c))
            self.body = body
            self.rpn_conv = nn.Conv2D(rpn_channels, 3, padding=1,
                                      activation="relu", prefix="rpn_conv_")
            self.rpn_cls = nn.Conv2D(2 * a, 1, prefix="rpn_cls_")
            self.rpn_bbox = nn.Conv2D(4 * a, 1, prefix="rpn_bbox_")
            top = nn.HybridSequential(prefix="top_")
            top.add(nn.Dense(hidden, activation="relu", flatten=False),
                    nn.Dense(hidden, activation="relu", flatten=False))
            self.top = top
            self.cls_head = nn.Dense(num_classes + 1, flatten=False,
                                     prefix="cls_head_")
            self.bbox_head = nn.Dense(4 * (num_classes + 1), flatten=False,
                                      prefix="bbox_head_")

    def forward(self, x):
        feat = self.body(x)
        r = self.rpn_conv(feat)
        return feat, self.rpn_cls(r), self.rpn_bbox(r)

    def hybrid_forward(self, F, x):
        return self.forward(x)

    # ------------------------------------------------------------------
    def rpn_probs(self, F, rpn_cls):
        """(B, 2A, H, W) logits -> Proposal-format probs (first A channels
        bg, last A fg), via a pairwise sigmoid (== 2-way softmax)."""
        a = self._num_anchors
        c = _t(rpn_cls)
        p = torch.sigmoid(c[:, a:2 * a] - c[:, :a])
        return _like(rpn_cls, torch.cat([1.0 - p, p], dim=1))

    def proposals(self, F, rpn_cls, rpn_bbox, im_info):
        """Decoded + NMS'd rois (B*post, 5); gradients are blocked, as in
        the reference (proposals are inputs to stage 2, not a grad path)."""
        cp = self.rpn_probs(F, _t(rpn_cls).detach())
        rois = cv_ops.proposal(
            cp, _t(rpn_bbox).detach(), _t(im_info),
            rpn_pre_nms_top_n=self._rpn_pre,
            rpn_post_nms_top_n=self._rpn_post,
            rpn_min_size=self._rpn_min, scales=self._scales,
            ratios=self._ratios, feature_stride=self._stride)
        return _like(rpn_cls, rois)

    def rcnn_head(self, F, feat, rois):
        """Stage two: ROIAlign -> 2 fc -> (cls (R, C+1), bbox (R, 4(C+1)))."""
        pooled = cv_ops.roi_align(_t(feat), _t(rois),
                                  pooled_size=self._roi_size,
                                  spatial_scale=1.0 / self._stride)
        h = self.top(pooled.reshape(pooled.shape[0], -1))
        return _like(feat, self.cls_head(h), self.bbox_head(h))

    # ------------------------------------------------------------------
    def detect(self, x, im_info=None, threshold=0.05, nms_threshold=0.3,
               topk=-1):
        """End-to-end inference: (B, R, 6) rows [cls_id, score, x1, y1,
        x2, y2], cls_id = -1 for suppressed/below-threshold rows.  An
        NDArray ``x`` gives an NDArray, a tensor a tensor."""
        wrap = isinstance(x, NDArray)
        xt = _t(x)
        b = xt.shape[0]
        if im_info is None:
            im_info = torch.from_numpy(np.tile(
                np.array([[xt.shape[2], xt.shape[3], 1.0]], np.float32),
                (b, 1))).to(xt.device)
        with torch.no_grad():
            out = self(x)
            feat, rpn_cls, rpn_bbox = (o.data for o in out) if wrap else out
            rois = self.proposals(None, rpn_cls, rpn_bbox, _t(im_info))
            cls_pred, bbox_pred = self.rcnn_head(None, feat, rois)
        # the host readback of the JAX method (ROADMAP C)
        probs = torch.softmax(cls_pred, dim=-1).cpu().numpy()
        deltas = bbox_pred.cpu().numpy().reshape(
            -1, self.num_classes + 1, 4) * np.array(
                [0.1, 0.1, 0.2, 0.2], np.float32)
        rois_np = rois.cpu().numpy()
        r_per = self._rpn_post
        rows_all = []
        for i in range(b):
            rows = []
            for j in range(r_per):
                k = i * r_per + j
                c = int(probs[k, 1:].argmax()) + 1
                score = float(probs[k, c])
                roi = rois_np[k, 1:]
                rw = roi[2] - roi[0] + 1.0
                rh = roi[3] - roi[1] + 1.0
                cx = roi[0] + rw / 2 + deltas[k, c, 0] * rw
                cy = roi[1] + rh / 2 + deltas[k, c, 1] * rh
                w = np.exp(np.clip(deltas[k, c, 2], -10, 10)) * rw
                h = np.exp(np.clip(deltas[k, c, 3], -10, 10)) * rh
                rows.append([c - 1, score, cx - w / 2, cy - h / 2,
                             cx + w / 2, cy + h / 2])
            rows_all.append(rows)
        dets = torch.from_numpy(np.asarray(rows_all, np.float32)).to(
            xt.device)
        det = cv_ops.box_nms(dets, overlap_thresh=nms_threshold,
                             valid_thresh=threshold, topk=topk,
                             coord_start=2, score_index=1, id_index=0,
                             force_suppress=False)
        return NDArray(det) if wrap else det


class FasterRCNNTrainLoss(HybridBlock):
    """All four Faster-RCNN losses in one block: RPN balanced sigmoid CE
    + RPN smooth-L1 (sigma=3) + RCNN softmax CE + RCNN per-class
    smooth-L1 (reference: example/rcnn train_end2end.py).
    """

    def __init__(self, net: FasterRCNN, rpn_fg_overlap=0.7,
                 rpn_bg_overlap=0.3, rcnn_fg_overlap=0.5,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.net = net
        self._rpn_fg = rpn_fg_overlap
        self._rpn_bg = rpn_bg_overlap
        self._rcnn_fg = rcnn_fg_overlap
        self._ce = gloss.SoftmaxCrossEntropyLoss()

    def hybrid_forward(self, F, x, gt_boxes, im_info):
        if isinstance(x, Symbol):
            # the JAX body reads x.shape[0], which a Symbol has not: the
            # training loss traces no graph there, nor here
            raise AttributeError("FasterRCNNTrainLoss reads x.shape[0], "
                                 "which a Symbol has not: it has no graph")
        return self.forward(x, gt_boxes, im_info)

    def forward(self, x, gt_boxes, im_info):
        net = self.net
        a = net._num_anchors
        b = x.shape[0]
        feat, rpn_cls, rpn_bbox = net(x)

        # ---- RPN targets + losses
        labels, bt, bw = cv_ops.rpn_anchor_target(
            rpn_cls.detach(), gt_boxes, scales=net._scales,
            ratios=net._ratios, feature_stride=net._stride,
            fg_overlap=self._rpn_fg, bg_overlap=self._rpn_bg)
        bg_l = rpn_cls[:, :a].permute(0, 2, 3, 1).reshape(b, -1)
        fg_l = rpn_cls[:, a:2 * a].permute(0, 2, 3, 1).reshape(b, -1)
        logit = fg_l - bg_l                                   # (B, N)
        y = torch.clamp(labels, min=0.0)
        # stable sigmoid CE; fg and bg halves normalized separately — the
        # static equivalent of the reference's 256-anchor balanced sample
        ce = (torch.relu(logit) - logit * y
              + _ops.activation(-torch.abs(logit), act_type="softrelu"))
        fg_m = (labels == 1.0).to(torch.float32)
        bg_m = (labels == 0.0).to(torch.float32)
        n_fg = torch.clamp(fg_m.sum(), min=1.0)
        rpn_cls_loss = ((ce * fg_m).sum() / n_fg
                        + (ce * bg_m).sum() / torch.clamp(bg_m.sum(),
                                                          min=1.0))
        rb = rpn_bbox.permute(0, 2, 3, 1).reshape(b, -1, 4)
        rpn_box_loss = smooth_l1((rb - bt) * bw, scalar=3.0).sum() / n_fg

        # ---- stage 2: proposals (grad-blocked), targets, head losses
        rois = net.proposals(None, rpn_cls, rpn_bbox, im_info)
        rois2, rlabels, rbt, rbw = cv_ops.proposal_target(
            rois, gt_boxes, num_classes=net.num_classes + 1,
            batch_images=b, batch_rois=b * net._rois_per_image,
            fg_fraction=net._fg_fraction, fg_overlap=self._rcnn_fg)
        cls_pred, bbox_pred = net.rcnn_head(None, feat, rois2)
        rcnn_cls_loss = self._ce(cls_pred, rlabels).mean()
        rfg = (rlabels > 0.0).to(torch.float32)
        rcnn_box_loss = (smooth_l1((bbox_pred - rbt) * rbw,
                                   scalar=1.0).sum()
                         / torch.clamp(rfg.sum(), min=1.0))
        return rpn_cls_loss + rpn_box_loss + rcnn_cls_loss + rcnn_box_loss


def faster_rcnn_small(num_classes=2, **kwargs) -> FasterRCNN:
    """Small config for tests/smokes (stride-8 body, 6 anchors/cell)."""
    return FasterRCNN(num_classes=num_classes, **kwargs)
