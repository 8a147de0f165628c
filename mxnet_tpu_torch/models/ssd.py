"""SSD single-shot detector, the port's counterpart of
``mxnet_tpu/models/ssd.py`` (reference: example/ssd/symbol/symbol_builder.py
and the GluonCV SSD recipe).

A conv body of ``_down_sample`` stages, five feature scales (the first the
body's output through an identity ``HybridLambda``, the last a
``GlobalMaxPool2D``), and per scale ``MultiBoxPrior`` anchors and conv
class and box heads.  The blocks are made in the JAX class's order and
name scopes, so ``collect_params()`` gives the JAX net's Gluon names and
``convert.from_mxnet_tpu_params`` carries its weights (BatchNorm's
running stats too).  Called with NDArrays a block follows MXNet (train
mode from ``autograd``); with tensors it is a ``torch.nn.Module``.

``SSDTrainLoss`` is ``MultiBoxTarget`` matching with hard-negative
mining, softmax cross-entropy over the kept anchors and smooth-L1 over
the matched boxes; ``SSD.detect`` is softmax, ``MultiBoxDetection``'s
decode and per-class NMS (``ops.cv_ops``).  ``SSD.hybrid_forward`` is the
JAX block's body, so ``export`` writes its graph node for node;
``SSDTrainLoss`` traces no graph, in either package.  No kernel of the port is on
this path: the JAX model reaches no Pallas kernel either.
"""
from __future__ import annotations

import torch

from ..gluon import HybridBlock, loss as gloss, nn
from ..ndarray.ndarray import NDArray
from ..ops import cv_ops
from ..ops.elemwise import smooth_l1
from ..symbol.symbol import Symbol

__all__ = ["SSD", "SSDTrainLoss", "ssd_300"]


def _conv_block(channels, kernel=3, stride=1, pad=1):
    blk = nn.HybridSequential()
    blk.add(nn.Conv2D(channels, kernel, strides=stride, padding=pad,
                      use_bias=False),
            nn.BatchNorm(), nn.Activation("relu"))
    return blk


def _down_sample(channels):
    """conv-conv-pool halving the resolution (example/ssd body pattern)."""
    blk = nn.HybridSequential()
    blk.add(_conv_block(channels), _conv_block(channels),
            nn.MaxPool2D(2))
    return blk


class SSD(HybridBlock):
    """Multi-scale SSD head over a light conv body.

    Outputs (anchors (1, N, 4), cls_preds (B, N, num_classes+1),
    box_preds (B, N*4)).
    """

    def __init__(self, num_classes, sizes=None, ratios=None,
                 base_channels=(16, 32, 64), prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self.num_classes = num_classes
        # per-scale anchor spec (5 scales, example/ssd defaults)
        self.sizes = sizes or [[0.2, 0.272], [0.37, 0.447], [0.54, 0.619],
                               [0.71, 0.79], [0.88, 0.961]]
        self.ratios = ratios or [[1, 2, 0.5]] * 5
        self._num_scales = len(self.sizes)
        with self.name_scope():
            body = nn.HybridSequential()
            for c in base_channels:
                body.add(_down_sample(c))
            self.body = body
            self.blocks = nn.HybridSequential()
            self.cls_heads = nn.HybridSequential()
            self.box_heads = nn.HybridSequential()
            for i in range(self._num_scales):
                if i == 0:
                    self.blocks.add(nn.HybridLambda(lambda F, x: x))
                elif i == self._num_scales - 1:
                    self.blocks.add(nn.GlobalMaxPool2D())
                else:
                    self.blocks.add(_down_sample(128))
                a = len(self.sizes[i]) + len(self.ratios[i]) - 1
                self.cls_heads.add(nn.Conv2D(a * (num_classes + 1), 3,
                                             padding=1))
                self.box_heads.add(nn.Conv2D(a * 4, 3, padding=1))

    def forward(self, x):
        b = x.shape[0]
        feat = self.body(x)
        anchors, cls_preds, box_preds = [], [], []
        for i in range(self._num_scales):
            feat = self.blocks[i](feat)
            anchors.append(cv_ops.multibox_prior(
                feat, sizes=self.sizes[i], ratios=self.ratios[i]))
            cls = self.cls_heads[i](feat)
            # (B, aC, H, W) -> (B, H*W*a, C+1)
            cls_preds.append(cls.permute(0, 2, 3, 1).reshape(
                b, -1, self.num_classes + 1))
            box = self.box_heads[i](feat)
            box_preds.append(box.permute(0, 2, 3, 1).reshape(b, -1))
        return (torch.cat(anchors, dim=1), torch.cat(cls_preds, dim=1),
                torch.cat(box_preds, dim=1))

    def hybrid_forward(self, F, x):
        # the JAX block's body: the graph ``export`` writes
        feat = self.body(x)
        anchors, cls_preds, box_preds = [], [], []
        for i in range(self._num_scales):
            feat = self.blocks[i](feat)
            anchors.append(F._contrib_MultiBoxPrior(
                feat, sizes=self.sizes[i], ratios=self.ratios[i]))
            cls = F.transpose(self.cls_heads[i](feat), axes=(0, 2, 3, 1))
            cls_preds.append(F.Reshape(cls,
                                       shape=(0, -1, self.num_classes + 1)))
            box = F.transpose(self.box_heads[i](feat), axes=(0, 2, 3, 1))
            box_preds.append(F.Reshape(box, shape=(0, -1)))
        return (F.concat(*anchors, dim=1), F.concat(*cls_preds, dim=1),
                F.concat(*box_preds, dim=1))

    def detect(self, x, threshold=0.01, nms_threshold=0.45, topk=400):
        """Decode + NMS: (B, N, 6) rows [cls_id, score, x0, y0, x1, y1].
        An NDArray ``x`` runs the net by MXNet's convention and gives an
        NDArray; a tensor runs it as a module in its current mode."""
        wrap = isinstance(x, NDArray)
        with torch.no_grad():
            out = self(x)
            anchors, cls_preds, box_preds = (
                o.data for o in out) if wrap else out
            cls_prob = torch.softmax(cls_preds, dim=-1).transpose(1, 2)
            det = cv_ops.multibox_detection(
                cls_prob, box_preds, anchors, threshold=threshold,
                nms_threshold=nms_threshold, nms_topk=topk)
        return NDArray(det) if wrap else det


class SSDTrainLoss(HybridBlock):
    """MultiBoxTarget matching + (softmax CE, smooth-L1) losses in one
    block (reference example/ssd training loss)."""

    def __init__(self, negative_mining_ratio=3.0, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._ce = gloss.SoftmaxCrossEntropyLoss()
        self._ratio = negative_mining_ratio

    def forward(self, anchors, cls_preds, box_preds, labels):
        # the targets take no gradient: they compare cls_preds, never
        # carry them (as in the JAX block)
        box_target, box_mask, cls_target = cv_ops.multibox_target(
            anchors.detach(), labels, cls_preds.detach().transpose(1, 2),
            negative_mining_ratio=self._ratio)
        flat_t = cls_target.reshape(-1)
        valid = flat_t >= 0.0  # hard-negative mining marks skips with -1
        ce = self._ce(cls_preds.reshape(-1, cls_preds.shape[-1]),
                      torch.clamp(flat_t, min=0.0))
        vmask = valid.to(torch.float32)
        cls_loss = (ce * vmask).sum() / torch.clamp(vmask.sum(), min=1.0)
        box_loss = smooth_l1((box_preds - box_target) * box_mask,
                             scalar=1.0).mean()
        return cls_loss + box_loss

    def hybrid_forward(self, F, anchors, cls_preds, box_preds, labels):
        if isinstance(cls_preds, Symbol):
            # the JAX body unpacks MultiBoxTarget's outputs and reads
            # cls_preds.shape, which a Symbol cannot give: the loss
            # traces no graph there, nor here
            raise AttributeError("SSDTrainLoss reads its inputs' shapes, "
                                 "which a Symbol has not: it has no graph")
        return self.forward(anchors, cls_preds, box_preds, labels)


def ssd_300(num_classes=20, **kwargs) -> SSD:
    """SSD-300-class detector with the default 5-scale anchor spec."""
    return SSD(num_classes=num_classes, **kwargs)
