"""Detection operators (SSD and Faster-RCNN), the port's counterpart of
``mxnet_tpu/ops/cv_ops.py``, registered under the JAX names
(``_contrib_box_iou``, ``_contrib_box_nms``, ``_contrib_bipartite_matching``,
``_contrib_MultiBoxPrior``, ``_contrib_MultiBoxTarget``,
``_contrib_MultiBoxDetection``, ``ROIPooling``, ``_contrib_ROIAlign``,
``_contrib_Proposal``, ``_contrib_MultiProposal``, ``_contrib_box_encode``,
``_contrib_box_decode``, ``_contrib_mrcnn_mask_target``,
``_contrib_RPNAnchorTarget``, ``_contrib_ProposalTarget``), so
``nd.contrib.<name>`` reaches each.  Plain functions on torch tensors,
batched over the leading axis where the JAX code ``vmap``s; shapes are
static and dynamic-length results are -1 (or 0) padded rows, as there.
The JAX package reaches no Pallas kernel here, and neither does the port.

What keeps the results equal to the JAX ones:

  * sorts are stable (``torch.sort(..., stable=True)``): ``jnp.argsort``
    is stable and ``jax.lax.top_k`` breaks ties by the lower index, and
    ties are common (``Proposal``'s -1 scores, masked rows);
  * greedy NMS (:func:`_greedy_nms_mask`) is the JAX loop, row by row on
    the device with no readback.  ``box_nms`` marks sorted rows at and
    past ``topk`` invalid, and an invalid row is never kept and so never
    suppresses, so the loop and its IoU matrix cover only the first
    ``min(n, topk)`` sorted rows: the same answer, without the
    n x n matrix (21,764^2 at SSD-512);
  * ``MultiBoxTarget``'s forced matches scatter into an (n + 1)-wide
    buffer whose last column takes the padded gt rows (the JAX
    ``mode="drop"``).  Two gt boxes whose best anchor is the same write
    one index twice; the port takes the higher gt index, as XLA's
    scatter does on the CPU (its updates apply in order), with a max
    reduction, which is deterministic on the card;
  * ``ROIPooling`` takes the max over each bin in two passes, over the
    bin's rows then its columns, so no intermediate holds more than
    R x C x H x W values (the literal port masks the whole map for
    each of the ph x pw bins).

``ROIAlign``'s gradient with respect to the features comes from
autograd through its gathers; on the card that backward accumulates
with atomic adds, so card and CPU gradients agree to rounding, not bit
for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from .registry import register

# ---------------------------------------------------------------------------
# box utilities
# ---------------------------------------------------------------------------


def _to_corner(boxes, fmt):
    if fmt == "corner":
        return boxes
    # center: (cx, cy, w, h) -> (x1, y1, x2, y2)
    cx, cy, w, h = torch.split(boxes, 1, dim=-1)
    return torch.cat([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                     dim=-1)


def _pair_iou(lhs, rhs):
    """IoU between every box in lhs (..., N, 4) and rhs (..., M, 4),
    corner format -> (..., N, M)."""
    lx1, ly1, lx2, ly2 = torch.split(lhs[..., :, None, :], 1, dim=-1)
    rx1, ry1, rx2, ry2 = torch.split(rhs[..., None, :, :], 1, dim=-1)
    ix1 = torch.maximum(lx1, rx1)
    iy1 = torch.maximum(ly1, ry1)
    ix2 = torch.minimum(lx2, rx2)
    iy2 = torch.minimum(ly2, ry2)
    iw = torch.clamp(ix2 - ix1, min=0.0)
    ih = torch.clamp(iy2 - iy1, min=0.0)
    inter = (iw * ih)[..., 0]
    area_l = ((lx2 - lx1) * (ly2 - ly1))[..., 0]
    area_r = ((rx2 - rx1) * (ry2 - ry1))[..., 0]
    union = area_l + area_r - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


def _argsort(key, dim=-1, descending=False):
    """``jnp.argsort``: stable."""
    return torch.sort(key, dim=dim, descending=descending, stable=True)[1]


def _gather_rows(x, idx):
    """x (B, N, K), idx (B, M) -> x[b, idx[b]] (B, M, K)."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape,
                                                    x.shape[-1]))


def _onehot(cls, n, dtype):
    """``jax.nn.one_hot``: an index outside [0, n) gives a zero row."""
    return (cls[..., None] == torch.arange(n, device=cls.device)).to(dtype)


@register("_contrib_box_iou")
def box_iou(lhs, rhs, format="corner"):
    """Reference: src/operator/contrib/bounding_box.cc (box_iou)."""
    return _pair_iou(_to_corner(lhs, format), _to_corner(rhs, format))


def _greedy_nms_mask(boxes, valid, overlap_thresh, classes=None,
                     force_suppress=True):
    """Greedy NMS on score-sorted rows, batched: boxes (B, m, 4), valid
    (B, m) -> keep (B, m).  Row i is kept when it is valid and no kept
    row before it overlaps it by more than ``overlap_thresh`` (among its
    own class unless ``force_suppress``): the JAX ``fori_loop``, one
    device step a row, nothing read back."""
    iou = _pair_iou(boxes, boxes)
    if classes is not None and not force_suppress:
        same = classes[..., :, None] == classes[..., None, :]
        iou = torch.where(same, iou, torch.zeros_like(iou))
    overlap = iou > overlap_thresh
    keep = torch.zeros_like(valid)
    suppressed = torch.zeros_like(valid)
    for i in range(boxes.shape[-2]):
        keep_i = valid[:, i] & ~suppressed[:, i]
        keep[:, i] = keep_i
        suppressed |= keep_i[:, None] & overlap[:, i]
    return keep


@register("_contrib_box_nms")
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """Reference: src/operator/contrib/bounding_box.cc (BoxNMS ~L100).
    Suppressed/invalid rows become -1, shape preserved; kept rows first,
    in score order."""
    squeeze = data.dim() == 2
    if squeeze:
        data = data[None]
    batch_shape = data.shape[:-2]
    n, k = data.shape[-2:]
    d = data.reshape(-1, n, k)
    scores = d[:, :, score_index]
    valid = scores > valid_thresh
    if id_index >= 0 and background_id >= 0:
        valid = valid & (d[:, :, id_index] != background_id)
    neg_inf = torch.full_like(scores, -float("inf"))
    order = _argsort(-torch.where(valid, scores, neg_inf))
    d_sorted = _gather_rows(d, order)
    m = n if topk <= 0 else min(int(topk), n)
    head = d_sorted[:, :m]
    boxes = _to_corner(head[:, :, coord_start:coord_start + 4], in_format)
    cls = head[:, :, id_index] if id_index >= 0 else None
    keep_m = _greedy_nms_mask(boxes, torch.gather(valid, 1, order)[:, :m],
                              overlap_thresh, classes=cls,
                              force_suppress=force_suppress)
    keep = torch.zeros(d.shape[:2], dtype=torch.bool, device=d.device)
    keep[:, :m] = keep_m
    out = torch.where(keep[..., None], d_sorted,
                      torch.full_like(d_sorted, -1.0))
    # stable-compact kept rows to the front (reference behavior)
    ar = torch.arange(n, device=d.device)
    rank = torch.where(keep, ar, n + ar)
    out = _gather_rows(out, torch.argsort(rank, dim=1))
    out = out.reshape(*batch_shape, n, k)
    return out[0] if squeeze else out


@register("_contrib_bipartite_matching")
def bipartite_matching(data, threshold=0.5, is_ascend=False, topk=-1):
    """Greedy bipartite matching (reference:
    src/operator/contrib/bounding_box.cc BipartiteMatching).
    data (..., N, M) pairwise scores -> (row_match (..., N),
    col_match (..., M))."""
    squeeze = data.dim() == 2
    if squeeze:
        data = data[None]
    b, n, m = data.shape
    sign = 1.0 if is_ascend else -1.0
    steps = n if topk <= 0 else min(topk, n)
    s = data.float().clone()
    row = torch.full((b, n), -1.0, device=data.device)
    col = torch.full((b, m), -1.0, device=data.device)
    rows_ar = torch.arange(n, device=data.device)
    cols_ar = torch.arange(m, device=data.device)
    fill = torch.tensor(float("inf") * sign, device=data.device)
    for _ in range(steps):
        flat = torch.where(torch.isfinite(s), -sign * s,
                           torch.full_like(s, -float("inf"))).reshape(b, -1)
        best = torch.argmax(flat, dim=1)
        i, j = best // m, best % m
        v = s.reshape(b, -1).gather(1, best[:, None])[:, 0]
        ok = torch.isfinite(v) & ((v >= threshold) if not is_ascend
                                  else (v <= threshold))
        hit_r = ok[:, None] & (rows_ar[None] == i[:, None])
        hit_c = ok[:, None] & (cols_ar[None] == j[:, None])
        row = torch.where(hit_r, j[:, None].to(row.dtype), row)
        col = torch.where(hit_c, i[:, None].to(col.dtype), col)
        s = torch.where(hit_r[:, :, None] | hit_c[:, None, :], fill, s)
    if squeeze:
        return row[0], col[0]
    return row, col


# ---------------------------------------------------------------------------
# SSD: MultiBox family (reference: src/operator/contrib/multibox_*.cc)
# ---------------------------------------------------------------------------
@register("_contrib_MultiBoxPrior")
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor generation; output (1, H*W*(S+R-1), 4) corner boxes in [0,1]
    units (reference: multibox_prior.cc)."""
    h, w = data.shape[-2:]
    dev = data.device
    sizes = tuple(float(s) for s in sizes)
    ratios = tuple(float(r) for r in ratios)
    step_y = steps[1] if steps[1] > 0 else 1.0 / h
    step_x = steps[0] if steps[0] > 0 else 1.0 / w
    cy = (torch.arange(h, dtype=torch.float32, device=dev)
          + offsets[1]) * step_y
    cx = (torch.arange(w, dtype=torch.float32, device=dev)
          + offsets[0]) * step_x
    cy, cx = torch.meshgrid(cy, cx, indexing="ij")
    centers = torch.stack([cx.reshape(-1), cy.reshape(-1)], dim=-1)

    # anchor (w, h) combos: all sizes with ratio[0], then size[0] with
    # remaining ratios (reference order)
    whs = [(s, s) for s in sizes]
    s0 = sizes[0]
    for r in ratios[1:]:
        sr = np.sqrt(r)
        whs.append((s0 * sr, s0 / sr))
    wh = torch.from_numpy(np.asarray(whs, np.float32)).to(dev)  # (A, 2)

    cxy = centers[:, None, :]
    half = wh[None, :, :] / 2
    boxes = torch.cat([cxy - half, cxy + half], dim=-1).reshape(-1, 4)
    if clip:
        boxes = torch.clamp(boxes, 0.0, 1.0)
    return boxes[None]


@register("_contrib_MultiBoxTarget")
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD target encoding (reference: multibox_target.cc).

    anchor (1, N, 4) corner; label (B, M, 5+) rows [cls, x1, y1, x2, y2];
    cls_pred (B, num_cls+1, N): hard-negative mining ranks its raw values
    (the max non-background one) against ``negative_mining_thresh`` when
    negative_mining_ratio > 0, as the JAX op does.
    Returns [loc_target (B, N*4), loc_mask (B, N*4), cls_target (B, N)].
    """
    anchors = anchor[0]  # (N, 4)
    n = anchors.shape[0]
    b, mgt = label.shape[:2]
    dev = anchors.device
    var = torch.tensor(variances, dtype=torch.float32, device=dev)
    gt_valid = label[:, :, 0] >= 0                       # (B, M)
    gt_boxes = label[:, :, 1:5]
    ious = _pair_iou(anchors, gt_boxes)                  # (B, N, M)
    ious = torch.where(gt_valid[:, None, :], ious, torch.full_like(ious,
                                                                   -1.0))
    best_gt = torch.argmax(ious, dim=2)                  # first max
    best_iou = torch.gather(ious, 2, best_gt[..., None])[..., 0]
    matched = best_iou >= overlap_threshold

    # stage 1: force-match the best anchor of each usable gt; padded gt
    # rows write to column n, dropped (the JAX mode="drop")
    best_anchor = torch.argmax(ious, dim=1)              # (B, M)
    gt_usable = gt_valid & (ious.max(dim=1).values > 1e-6)
    scatter_idx = torch.where(gt_usable, best_anchor,
                              torch.full_like(best_anchor, n))
    gt_ids = torch.arange(mgt, device=dev).expand(b, mgt)
    winner = torch.full((b, n + 1), -1, dtype=torch.long, device=dev)
    winner.scatter_reduce_(1, scatter_idx, gt_ids, "amax")
    winner = winner[:, :n]
    forced = winner >= 0
    best_gt = torch.where(forced, winner, best_gt)
    matched = matched | forced

    m_gt = _gather_rows(gt_boxes, best_gt)               # (B, N, 4)
    # encode offsets (center form, variance-normalized)
    acx = (anchors[:, 0] + anchors[:, 2]) / 2
    acy = (anchors[:, 1] + anchors[:, 3]) / 2
    aw = torch.clamp(anchors[:, 2] - anchors[:, 0], min=1e-8)
    ah = torch.clamp(anchors[:, 3] - anchors[:, 1], min=1e-8)
    gcx = (m_gt[..., 0] + m_gt[..., 2]) / 2
    gcy = (m_gt[..., 1] + m_gt[..., 3]) / 2
    gw = torch.clamp(m_gt[..., 2] - m_gt[..., 0], min=1e-8)
    gh = torch.clamp(m_gt[..., 3] - m_gt[..., 1], min=1e-8)
    loc_t = torch.stack([(gcx - acx) / aw / var[0],
                         (gcy - acy) / ah / var[1],
                         torch.log(gw / aw) / var[2],
                         torch.log(gh / ah) / var[3]], dim=-1)
    zero = torch.zeros_like(loc_t)
    loc_target = torch.where(matched[..., None], loc_t, zero).reshape(b, -1)
    loc_mask = torch.where(matched[..., None], torch.ones_like(loc_t),
                           zero).reshape(b, -1)

    gt_cls = torch.gather(label[:, :, 0], 1, best_gt)
    cls_t = torch.where(matched, gt_cls + 1.0, torch.zeros_like(gt_cls))
    if negative_mining_ratio > 0:
        neg_score = cls_pred[:, 1:, :].max(dim=1).values  # (B, N)
        neg_cand = (~matched) & (neg_score > negative_mining_thresh)
        num_neg = torch.clamp(
            (negative_mining_ratio * matched.sum(dim=1)).to(torch.int32),
            min=minimum_negative_samples)
        key = torch.where(neg_cand, neg_score,
                          torch.full_like(neg_score, -float("inf")))
        order = _argsort(-key)
        rank = torch.empty_like(order)
        rank.scatter_(1, order, torch.arange(n, device=dev).expand(b, n))
        keep_neg = neg_cand & (rank < num_neg[:, None])
        cls_t = torch.where(~matched & ~keep_neg,
                            torch.full_like(cls_t, ignore_label), cls_t)
    return loc_target, loc_mask, cls_t


def _decode_boxes(anchors, deltas, variances, clip_val=None):
    """Inverse of the multibox encoding: anchors (..., 4) corner +
    variance-scaled deltas (..., 4) -> corner boxes."""
    acx = (anchors[..., 0] + anchors[..., 2]) / 2
    acy = (anchors[..., 1] + anchors[..., 3]) / 2
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    cx = deltas[..., 0] * variances[0] * aw + acx
    cy = deltas[..., 1] * variances[1] * ah + acy
    w = torch.exp(deltas[..., 2] * variances[2]) * aw
    h = torch.exp(deltas[..., 3] * variances[3]) * ah
    boxes = torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)
    if clip_val is not None:
        boxes = torch.clamp(boxes, 0.0, clip_val)
    return boxes


@register("_contrib_MultiBoxDetection")
def multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5,
                       force_suppress=False,
                       variances=(0.1, 0.1, 0.2, 0.2), nms_topk=-1):
    """SSD decode + per-class NMS (reference: multibox_detection.cc).
    cls_prob (B, C+1, N), loc_pred (B, N*4), anchor (1, N, 4)
    -> (B, N, 6) rows [cls_id, score, x1, y1, x2, y2], invalid = -1."""
    anchors = anchor[0]
    b = cls_prob.shape[0]
    n = anchors.shape[0]
    var = tuple(float(v) for v in variances)
    boxes = _decode_boxes(anchors, loc_pred.reshape(b, n, 4), var,
                          1.0 if clip else None)
    # best non-background class per anchor
    fg = torch.cat([cls_prob[:, :background_id],
                    cls_prob[:, background_id + 1:]], dim=1)
    cls_id = torch.argmax(fg, dim=1).to(torch.float32)
    # account for removed background row
    cls_id = torch.where(cls_id >= background_id, cls_id + 1, cls_id) - 1.0
    score = fg.max(dim=1).values
    valid = score > threshold
    minus = torch.full_like(score, -1.0)
    det = torch.cat([torch.where(valid, cls_id, minus)[..., None],
                     torch.where(valid, score, minus)[..., None], boxes],
                    dim=-1)
    return box_nms(det, overlap_thresh=nms_threshold,
                   valid_thresh=0.0, topk=nms_topk,
                   coord_start=2, score_index=1, id_index=0,
                   background_id=-1, force_suppress=force_suppress)


# ---------------------------------------------------------------------------
# ROI ops (reference: src/operator/contrib/roi_align.*,
# src/operator/roi_pooling.*)
# ---------------------------------------------------------------------------
@register("ROIPooling")
def roi_pooling(data, rois, pooled_size=(7, 7), spatial_scale=1.0):
    """Max ROI pooling; rois (R, 5) rows [batch_idx, x1, y1, x2, y2].
    Bin (iy, ix) of a ROI clamped to the map covers rows
    [y1 + floor(iy rh / ph), y1 + ceil((iy + 1) rh / ph)) and the like
    columns; the max runs over its rows, then its columns (module
    docstring)."""
    ph, pw = tuple(int(p) for p in pooled_size)
    n, c, h, w = data.shape
    dev = data.device

    def coord(v, hi):
        return torch.clamp(torch.round(v * spatial_scale), 0,
                           hi - 1).to(torch.long)

    bidx = rois[:, 0].to(torch.long)
    x1, y1 = coord(rois[:, 1], w), coord(rois[:, 2], h)
    x2, y2 = coord(rois[:, 3], w), coord(rois[:, 4], h)
    rw = torch.clamp(x2 - x1 + 1, min=1)
    rh = torch.clamp(y2 - y1 + 1, min=1)
    img = data[bidx]                                      # (R, C, H, W)
    ys = torch.arange(h, device=dev)
    xs = torch.arange(w, device=dev)
    neg = torch.tensor(-float("inf"), dtype=data.dtype, device=dev)
    rows = []
    for iy in range(ph):
        lo = y1 + (iy * rh) // ph
        hi = y1 + ((iy + 1) * rh + ph - 1) // ph
        mask = (ys[None] >= lo[:, None]) & (ys[None] < hi[:, None])
        rows.append(torch.where(mask[:, None, :, None], img,
                                neg).amax(dim=2))        # (R, C, W)
    by_row = torch.stack(rows, dim=2)                     # (R, C, ph, W)
    cols = []
    for ix in range(pw):
        lo = x1 + (ix * rw) // pw
        hi = x1 + ((ix + 1) * rw + pw - 1) // pw
        mask = (xs[None] >= lo[:, None]) & (xs[None] < hi[:, None])
        cols.append(torch.where(mask[:, None, None, :], by_row,
                                neg).amax(dim=3))        # (R, C, ph)
    out = torch.stack(cols, dim=3)                        # (R, C, ph, pw)
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def _bilinear_taps(y, x, h, w):
    """Clamped bilinear taps of sample points y (..., Sy, 1), x (..., 1,
    Sx): integer corners and fractional weights, as the JAX ops take
    them."""
    y = torch.clamp(y, 0.0, h - 1.0)
    x = torch.clamp(x, 0.0, w - 1.0)
    y0 = torch.floor(y).to(torch.long)
    x0 = torch.floor(x).to(torch.long)
    y1 = torch.clamp(y0 + 1, max=h - 1)
    x1 = torch.clamp(x0 + 1, max=w - 1)
    return y0, x0, y1, x1, y - y0, x - x0


@register("_contrib_ROIAlign")
def roi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
              sample_ratio=-1, position_sensitive=False, aligned=False):
    """ROIAlign with bilinear sampling (reference: roi_align.cc): a
    fixed grid of ratio x ratio taps a bin, gathered for every ROI at
    once and averaged; the backward is autograd's through the gathers."""
    ph, pw = tuple(int(p) for p in pooled_size)
    n, c, h, w = data.shape
    r = rois.shape[0]
    ratio = int(sample_ratio) if sample_ratio > 0 else 2
    offset = 0.5 if aligned else 0.0
    dev = data.device
    bidx = rois[:, 0].to(torch.long)
    x1 = rois[:, 1] * spatial_scale - offset
    y1 = rois[:, 2] * spatial_scale - offset
    x2 = rois[:, 3] * spatial_scale - offset
    y2 = rois[:, 4] * spatial_scale - offset
    rw = torch.clamp(x2 - x1, min=1.0)
    rh = torch.clamp(y2 - y1, min=1.0)
    bin_w = rw / pw
    bin_h = rh / ph
    gy = y1[:, None] + (torch.arange(ph * ratio, dtype=torch.float32,
                                     device=dev) + 0.5) * (bin_h / ratio)[:,
                                                                         None]
    gx = x1[:, None] + (torch.arange(pw * ratio, dtype=torch.float32,
                                     device=dev) + 0.5) * (bin_w / ratio)[:,
                                                                         None]
    y0, x0, y1i, x1i, wy, wx = _bilinear_taps(gy[:, :, None], gx[:, None, :],
                                              h, w)
    b = bidx[:, None, None]

    def tap(yy, xx):
        return data[b, :, yy, xx]                         # (R, Sy, Sx, C)

    wy, wx = wy[..., None], wx[..., None]
    samples = ((1 - wy) * (1 - wx) * tap(y0, x0) + (1 - wy) * wx
               * tap(y0, x1i) + wy * (1 - wx) * tap(y1i, x0)
               + wy * wx * tap(y1i, x1i))
    samples = samples.reshape(r, ph, ratio, pw, ratio, c)
    return samples.mean(dim=(2, 4)).permute(0, 3, 1, 2)   # (R, C, ph, pw)


# ---------------------------------------------------------------------------
# RPN Proposal (reference: src/operator/contrib/proposal.cc,
# multi_proposal.cc)
# ---------------------------------------------------------------------------
def _generate_base_anchors(scales, ratios, stride):
    base = stride - 1.0
    cx = base / 2
    cy = base / 2
    anchors = []
    size = stride * stride
    for r in ratios:
        size_r = size / r
        ws = np.round(np.sqrt(size_r))
        hs = np.round(ws * r)
        for s in scales:
            w = ws * s
            h = hs * s
            anchors.append([cx - (w - 1) / 2, cy - (h - 1) / 2,
                            cx + (w - 1) / 2, cy + (h - 1) / 2])
    return np.asarray(anchors, np.float32)


def _rcnn_anchor_grid(scales, ratios, stride, fh, fw, device):
    """Pixel-space anchor grid in the (H, W, A)-fastest-A layout shared
    with _contrib_Proposal -> (H*W*A, 4)."""
    base = _generate_base_anchors([float(s) for s in scales],
                                  [float(r) for r in ratios], float(stride))
    shift_x = torch.arange(fw, dtype=torch.float32, device=device) * stride
    shift_y = torch.arange(fh, dtype=torch.float32, device=device) * stride
    sy, sx = torch.meshgrid(shift_y, shift_x, indexing="ij")
    sx, sy = sx.reshape(-1), sy.reshape(-1)
    shifts = torch.stack([sx, sy, sx, sy], -1)
    return (torch.from_numpy(base).to(device)[None, :, :]
            + shifts[:, None, :]).reshape(-1, 4)


@register("_contrib_Proposal")
def proposal(cls_prob, bbox_pred, im_info, rpn_pre_nms_top_n=6000,
             rpn_post_nms_top_n=300, threshold=0.7, rpn_min_size=16,
             scales=(4.0, 8.0, 16.0, 32.0), ratios=(0.5, 1.0, 2.0),
             feature_stride=16, output_score=False, iou_loss=False):
    """RPN proposal generation (reference: proposal.cc).
    cls_prob (B, 2A, H, W), bbox_pred (B, 4A, H, W), im_info (B, 3)
    -> rois (B*post_n, 5) [batch_idx, x1, y1, x2, y2] (+ scores)."""
    b, _, fh, fw = cls_prob.shape
    a = len(scales) * len(ratios)
    dev = cls_prob.device
    anchors = _rcnn_anchor_grid(scales, ratios, feature_stride, fh, fw, dev)
    n = anchors.shape[0]
    pre_n = min(rpn_pre_nms_top_n, n) if rpn_pre_nms_top_n > 0 else n
    post_n = rpn_post_nms_top_n

    scores = cls_prob[:, a:].permute(0, 2, 3, 1).reshape(b, -1)
    deltas = bbox_pred.permute(0, 2, 3, 1).reshape(b, -1, 4)
    # decode (Faster-RCNN parameterization, variance 1)
    aw = anchors[:, 2] - anchors[:, 0] + 1.0
    ah = anchors[:, 3] - anchors[:, 1] + 1.0
    acx = anchors[:, 0] + aw / 2
    acy = anchors[:, 1] + ah / 2
    cx = deltas[..., 0] * aw + acx
    cy = deltas[..., 1] * ah + acy
    w = torch.exp(torch.clamp(deltas[..., 2], -10, 10)) * aw
    h = torch.exp(torch.clamp(deltas[..., 3], -10, 10)) * ah
    im_h, im_w = im_info[:, 0:1], im_info[:, 1:2]
    zero = torch.zeros_like(cx)

    def clip(v, hi):
        return torch.minimum(torch.maximum(v, zero), hi - 1)

    boxes = torch.stack([clip(cx - w / 2, im_w), clip(cy - h / 2, im_h),
                         clip(cx + w / 2, im_w), clip(cy + h / 2, im_h)], -1)
    min_size = rpn_min_size * im_info[:, 2:3]
    keep_sz = ((boxes[..., 2] - boxes[..., 0] + 1 >= min_size)
               & (boxes[..., 3] - boxes[..., 1] + 1 >= min_size))
    scores = torch.where(keep_sz, scores, torch.full_like(scores, -1.0))
    # pre-NMS top-k: lax.top_k's order, ties to the lower index
    top_scores, order = torch.sort(scores, dim=1, descending=True,
                                   stable=True)
    top_scores, order = top_scores[:, :pre_n], order[:, :pre_n]
    top_boxes = _gather_rows(boxes, order)
    keep = _greedy_nms_mask(top_boxes, top_scores > -1.0, threshold)
    ar = torch.arange(pre_n, device=dev)
    rank = torch.where(keep, ar, pre_n + ar)
    sel = torch.argsort(rank, dim=1)[:, :post_n]
    keep_sel = torch.gather(keep, 1, sel)
    sel_boxes = _gather_rows(top_boxes, sel)
    out_boxes = torch.where(keep_sel[..., None], sel_boxes,
                            torch.zeros_like(sel_boxes))
    sel_scores = torch.gather(top_scores, 1, sel)
    out_scores = torch.where(keep_sel, sel_scores,
                             torch.zeros_like(sel_scores))
    k = out_boxes.shape[1]
    bidx = torch.arange(b, dtype=out_boxes.dtype,
                        device=dev).repeat_interleave(k)
    rois = torch.cat([bidx[:, None], out_boxes.reshape(-1, 4)], dim=-1)
    if output_score:
        return rois, out_scores.reshape(-1, 1)
    return rois


@register("_contrib_MultiProposal")
def multi_proposal(cls_prob, bbox_pred, im_info, **kwargs):
    """Batch alias of Proposal (reference: multi_proposal.cc)."""
    return proposal(cls_prob, bbox_pred, im_info, **kwargs)


# ---------------------------------------------------------------------------
# box encode/decode (1.6-era contrib, used by GluonCV YOLO/SSD)
# ---------------------------------------------------------------------------
@register("_contrib_box_encode")
def box_encode(samples, matches, anchors, refs, means=(0., 0., 0., 0.),
               stds=(0.1, 0.1, 0.2, 0.2)):
    """Encode matched gt boxes against anchors (reference:
    bounding_box.cc BoxEncode). samples (B,N) {+1,-1,0}, matches (B,N) gt
    indices, anchors (B,N,4), refs (B,M,4) -> (targets (B,N,4), masks)."""
    dev = anchors.device
    means = torch.tensor(means, dtype=torch.float32, device=dev)
    stds = torch.tensor(stds, dtype=torch.float32, device=dev)
    g = _gather_rows(refs, matches.to(torch.long))
    anc = anchors
    acx = (anc[..., 0] + anc[..., 2]) / 2
    acy = (anc[..., 1] + anc[..., 3]) / 2
    aw = torch.clamp(anc[..., 2] - anc[..., 0], min=1e-8)
    ah = torch.clamp(anc[..., 3] - anc[..., 1], min=1e-8)
    gcx = (g[..., 0] + g[..., 2]) / 2
    gcy = (g[..., 1] + g[..., 3]) / 2
    gw = torch.clamp(g[..., 2] - g[..., 0], min=1e-8)
    gh = torch.clamp(g[..., 3] - g[..., 1], min=1e-8)
    t = torch.stack([(gcx - acx) / aw, (gcy - acy) / ah,
                     torch.log(gw / aw), torch.log(gh / ah)], -1)
    t = (t - means) / stds
    mask = (samples > 0.5)[..., None]
    return (torch.where(mask, t, torch.zeros_like(t)),
            mask.to(t.dtype) * torch.ones_like(t))


@register("_contrib_box_decode")
def box_decode(data, anchors, std0=0.1, std1=0.1, std2=0.2, std3=0.2,
               clip=-1.0, format="corner"):
    """Decode deltas back to boxes (reference: bounding_box.cc BoxDecode)."""
    stds = torch.tensor((std0, std1, std2, std3), dtype=data.dtype,
                        device=data.device)
    anc = _to_corner(anchors[0], format)
    return _decode_boxes(anc, data * stds, (1.0, 1.0, 1.0, 1.0),
                         clip if clip > 0 else None)


@register("_contrib_mrcnn_mask_target", differentiable=False)
def mrcnn_mask_target(rois, gt_masks, matches, cls_targets, num_rois=None,
                      num_classes=1, mask_size=(14, 14), sample_ratio=2,
                      aligned=False):
    """Mask-RCNN training targets (reference: src/operator/contrib/
    mrcnn_mask_target.cu): crop each matched ground-truth mask to its ROI
    with bilinear ROIAlign sampling and emit per-class targets + weights.

    rois: (B, N, 4) [x1,y1,x2,y2] in image coords; gt_masks: (B, M, H, W)
    {0,1}; matches: (B, N) gt index per roi; cls_targets: (B, N) class id
    (0 = background).  Returns (mask_targets (B,N,C,ms,ms),
    mask_weights (B,N,C,ms,ms)) where weights one-hot the matched class.
    """
    if isinstance(mask_size, int):
        mask_size = (mask_size, mask_size)
    ms_h, ms_w = mask_size
    b, n, _ = rois.shape
    _, m, h, w = gt_masks.shape
    ratio = int(sample_ratio) if sample_ratio and sample_ratio > 0 else 2
    offset = 0.5 if aligned else 0.0
    dev = rois.device
    rois = rois.to(torch.float32)
    x1, y1 = rois[..., 0] - offset, rois[..., 1] - offset
    x2, y2 = rois[..., 2] - offset, rois[..., 3] - offset
    bin_w = torch.clamp(x2 - x1, min=1.0) / ms_w
    bin_h = torch.clamp(y2 - y1, min=1.0) / ms_h
    gy = y1[..., None] + (torch.arange(ms_h * ratio, dtype=torch.float32,
                                       device=dev) + 0.5) * (
        bin_h / ratio)[..., None]
    gx = x1[..., None] + (torch.arange(ms_w * ratio, dtype=torch.float32,
                                       device=dev) + 0.5) * (
        bin_w / ratio)[..., None]
    y0, x0, y1i, x1i, wy, wx = _bilinear_taps(gy[..., :, None],
                                              gx[..., None, :], h, w)
    match = torch.clamp(matches.to(torch.long), 0, m - 1)
    masks = gt_masks.to(torch.float32)
    bi = torch.arange(b, device=dev)[:, None, None, None]
    mi = match[:, :, None, None]

    def tap(yy, xx):
        return masks[bi, mi, yy, xx]                      # (B, N, Sy, Sx)

    samples = (tap(y0, x0) * (1 - wy) * (1 - wx)
               + tap(y0, x1i) * (1 - wy) * wx
               + tap(y1i, x0) * wy * (1 - wx)
               + tap(y1i, x1i) * wy * wx)
    targets = samples.reshape(b, n, ms_h, ratio, ms_w, ratio).mean(
        dim=(3, 5))                                       # (B, N, ms, ms)
    cls = torch.clamp(cls_targets.to(torch.long), 0, num_classes - 1)
    onehot = _onehot(cls, num_classes, targets.dtype)
    # weights zero for background (cls_target 0)
    onehot = onehot * (cls_targets > 0)[..., None].to(targets.dtype)
    mask_targets = targets[:, :, None] * onehot[..., None, None]
    mask_weights = onehot[..., None, None].expand(
        b, n, num_classes, ms_h, ms_w).to(targets.dtype)
    return mask_targets, mask_weights


# ---------------------------------------------------------------------------
# Faster-RCNN training targets (reference: example/rcnn anchor-target logic
# + src/operator/contrib/proposal_target.cc)
# ---------------------------------------------------------------------------
def _rcnn_encode(anchors, gt, stds=(1.0, 1.0, 1.0, 1.0)):
    """Inverse of _contrib_Proposal's decode (+1 pixel convention)."""
    aw = anchors[..., 2] - anchors[..., 0] + 1.0
    ah = anchors[..., 3] - anchors[..., 1] + 1.0
    acx = anchors[..., 0] + aw / 2
    acy = anchors[..., 1] + ah / 2
    gw = torch.clamp(gt[..., 2] - gt[..., 0] + 1.0, min=1e-6)
    gh = torch.clamp(gt[..., 3] - gt[..., 1] + 1.0, min=1e-6)
    gcx = gt[..., 0] + gw / 2
    gcy = gt[..., 1] + gh / 2
    t = torch.stack([(gcx - acx) / aw, (gcy - acy) / ah,
                     torch.log(gw / aw), torch.log(gh / ah)], -1)
    return t / torch.tensor(stds, dtype=t.dtype, device=t.device)


@register("_contrib_RPNAnchorTarget", differentiable=False)
def rpn_anchor_target(cls_prob, gt_boxes, scales=(4.0, 8.0, 16.0, 32.0),
                      ratios=(0.5, 1.0, 2.0), feature_stride=16,
                      fg_overlap=0.7, bg_overlap=0.3):
    """RPN training targets: every anchor keeps its label (no random
    256-anchor subsample; the loss normalizes the fg and bg halves), as
    the JAX op does.

    cls_prob: (B, 2A, H, W) — shape/layout donor for the anchor grid.
    gt_boxes: (B, M, 5) rows [cls, x1, y1, x2, y2] in pixels, cls<0 pads.
    Returns (labels (B, N) in {1 fg, 0 bg, -1 ignore},
             bbox_targets (B, N, 4), bbox_weights (B, N, 1)), N = H*W*A in
    the same (h, w, a) order as _contrib_Proposal.
    """
    b, c2a, fh, fw = cls_prob.shape
    anchors = _rcnn_anchor_grid(scales, ratios, feature_stride, fh, fw,
                                cls_prob.device)
    assert anchors.shape[0] == (c2a // 2) * fh * fw, \
        f"anchor spec {anchors.shape[0]//(fh*fw)} != cls channels {c2a//2}"
    valid_gt = gt_boxes[:, :, 0] >= 0                     # (B, M)
    iou = _pair_iou(anchors, gt_boxes[:, :, 1:])          # (B, N, M)
    iou = torch.where(valid_gt[:, None, :], iou, torch.zeros_like(iou))
    max_iou = iou.max(dim=2).values
    best_gt = torch.argmax(iou, dim=2)
    # the best anchor of every gt is fg even below fg_overlap
    # (reference rule); tolerance for fp ties
    best_per_gt = iou.max(dim=1).values                   # (B, M)
    is_best = ((iou >= best_per_gt[:, None, :] - 1e-6)
               & valid_gt[:, None, :] & (iou > 0)).any(dim=2)
    fg = (max_iou >= fg_overlap) | is_best
    bg = (max_iou < bg_overlap) & ~fg
    one = torch.ones_like(max_iou)
    labels = torch.where(fg, one, torch.where(bg, 0 * one, -one))
    t = _rcnn_encode(anchors, _gather_rows(gt_boxes[:, :, 1:], best_gt))
    w = fg.to(torch.float32)[..., None]
    return labels, t * w, w


@register("_contrib_ProposalTarget", differentiable=False)
def proposal_target(rois, gt_boxes, num_classes=21, batch_images=1,
                    batch_rois=128, fg_fraction=0.25, fg_overlap=0.5,
                    box_stds=(0.1, 0.1, 0.2, 0.2)):
    """RCNN head training targets, the JAX op's deterministic version:
    gt boxes join the candidates, all fg by IoU desc (capped at
    ``fg_fraction``), then bg by IoU desc, truncated to
    batch_rois // batch_images per image; a selected roi at or above
    ``fg_overlap`` keeps its fg label.

    rois: (B*post, 5) [batch_idx, x1, y1, x2, y2] from _contrib_Proposal.
    gt_boxes: (B, M, 5) rows [cls, x1, y1, x2, y2], cls<0 pads (0-based
    foreground classes; output labels are 1-based, 0 = background).
    Returns (rois_out (batch_rois, 5), labels (batch_rois,),
             bbox_targets (batch_rois, 4*num_classes),
             bbox_weights (batch_rois, 4*num_classes));
    num_classes INCLUDES background (slot 0 never targeted).
    """
    b = int(batch_images)
    per_img = int(batch_rois) // b
    fg_quota = int(round(fg_fraction * per_img))
    r = rois.reshape(b, -1, 5)
    valid_gt = gt_boxes[:, :, 0] >= 0
    cand = torch.cat([r[:, :, 1:], gt_boxes[:, :, 1:]], dim=1)  # (B, P+M, 4)
    iou = _pair_iou(cand, gt_boxes[:, :, 1:])
    iou = torch.where(valid_gt[:, None, :], iou, torch.zeros_like(iou))
    max_iou = iou.max(dim=2).values
    best_gt = torch.argmax(iou, dim=2)
    fg = max_iou >= fg_overlap
    minus = torch.full_like(max_iou, -1.0)
    fg_rank = _argsort(_argsort(-torch.where(fg, max_iou, minus)))
    bg_rank = _argsort(_argsort(-torch.where(fg, minus, max_iou)))
    key = torch.where(fg & (fg_rank < fg_quota), fg_rank,
                      fg_quota + bg_rank)
    sel = _argsort(key)[:, :per_img]
    sel_fg = torch.gather(fg, 1, sel)
    sel_gt = torch.gather(best_gt, 1, sel)
    gt_cls = torch.gather(gt_boxes[:, :, 0], 1, sel_gt)
    labels = torch.where(sel_fg, gt_cls + 1.0, torch.zeros_like(gt_cls))
    sel_cand = _gather_rows(cand, sel)
    t = _rcnn_encode(sel_cand, _gather_rows(gt_boxes[:, :, 1:], sel_gt),
                     box_stds)
    # scatter the 4 target values into the matched class's slot
    onehot = _onehot(labels.to(torch.long), num_classes, t.dtype)
    fgf = sel_fg[..., None].to(t.dtype)
    wt = (onehot * fgf).repeat_interleave(4, dim=-1)
    targets = (onehot[..., None] * t[..., None, :]).reshape(
        b, per_img, -1) * fgf
    bidx = torch.arange(b, dtype=sel_cand.dtype,
                        device=rois.device).repeat_interleave(per_img)
    rois_out = torch.cat([bidx[:, None], sel_cand.reshape(-1, 4)], dim=-1)
    return (rois_out, labels.reshape(-1), targets.reshape(batch_rois, -1),
            wt.reshape(batch_rois, -1))
