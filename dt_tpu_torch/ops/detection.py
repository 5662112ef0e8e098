"""Detection ops: anchors, IoU, NMS, multibox matching (counterpart of
``dt_tpu/ops/detection.py``).

Reference: ``src/operator/contrib/`` — ``multibox_prior.cc`` (anchors),
``multibox_target.cc`` (anchor <-> ground-truth matching and loc offsets),
``multibox_detection.cc`` (decode + NMS) and ``bounding_box.cc`` (IoU).
Every function computes what its JAX twin computes, with the same float
operations in the same order, and takes leading batch axes where the JAX
function is vmapped by its callers (``box_iou``, ``force_match``,
``multibox_target``, ``nms``, ``multibox_detection``).

Boxes are corners ``(x1, y1, x2, y2)``, normalized to [0, 1] unless noted.
No TPU kernel stands behind these ops, so they are PyTorch code, but for the
greedy scan of :func:`nms`: the JAX function runs it as a ``lax.fori_loop``
over the boxes, which eager PyTorch would make one host round trip a box.
:func:`nms` sorts and counts on the device and hands the scan to
``ops.kernels.nms_keep`` (``csrc/nms.cu`` on the card, its plain version on
the CPU), which returns the JAX function's keep mask exactly.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from dt_tpu_torch.ops import kernels


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU matrix between ``(..., N, 4)`` and ``(..., M, 4)`` corner boxes
    -> ``(..., N, M)`` (the leading axes broadcast)."""
    area_a = torch.clamp(a[..., 2] - a[..., 0], min=0) * \
        torch.clamp(a[..., 3] - a[..., 1], min=0)
    area_b = torch.clamp(b[..., 2] - b[..., 0], min=0) * \
        torch.clamp(b[..., 3] - b[..., 1], min=0)
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def multibox_prior(feature_hw: Tuple[int, int],
                   sizes: Sequence[float] = (1.0,),
                   ratios: Sequence[float] = (1.0,),
                   device=None) -> torch.Tensor:
    """Anchor boxes for one feature map -> ``(H*W*(S+R-1), 4)`` f32
    corners, in the reference's order: each cell's every size at ratio 1,
    then ``sizes[0]`` at ``ratios[1:]``, centred at ``((j+0.5)/W,
    (i+0.5)/H)``, widths times ``H/W`` so the anchors are square in pixels
    (``multibox_prior.cc:50``)."""
    h, w = feature_hw
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
    cy, cx = torch.meshgrid(ys, xs, indexing="ij")
    aspect = h / w
    uniq = [(s * aspect, s) for s in sizes]
    uniq += [(sizes[0] * aspect * (r ** 0.5), sizes[0] / (r ** 0.5))
             for r in ratios[1:]]
    anchors = []
    for bw, bh in uniq:
        x1 = cx - bw / 2
        y1 = cy - bh / 2
        anchors.append(torch.stack([x1, y1, x1 + bw, y1 + bh], dim=-1))
    return torch.stack(anchors, dim=2).reshape(-1, 4)


def encode_boxes(anchors: torch.Tensor, gt: torch.Tensor,
                 variances=(0.1, 0.1, 0.2, 0.2)) -> torch.Tensor:
    """Corner ground truth -> centre-offset regression targets against
    ``anchors`` (the multibox_target loc encoding)."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    acx = anchors[..., 0] + aw / 2
    acy = anchors[..., 1] + ah / 2
    gw = torch.clamp(gt[..., 2] - gt[..., 0], min=1e-8)
    gh = torch.clamp(gt[..., 3] - gt[..., 1], min=1e-8)
    gcx = gt[..., 0] + gw / 2
    gcy = gt[..., 1] + gh / 2
    return torch.stack([
        (gcx - acx) / (aw * variances[0]),
        (gcy - acy) / (ah * variances[1]),
        torch.log(gw / aw) / variances[2],
        torch.log(gh / ah) / variances[3],
    ], dim=-1)


def decode_boxes(anchors: torch.Tensor, deltas: torch.Tensor,
                 variances=(0.1, 0.1, 0.2, 0.2)) -> torch.Tensor:
    """Inverse of :func:`encode_boxes` (multibox_detection's decode)."""
    aw = anchors[..., 2] - anchors[..., 0]
    ah = anchors[..., 3] - anchors[..., 1]
    acx = anchors[..., 0] + aw / 2
    acy = anchors[..., 1] + ah / 2
    cx = deltas[..., 0] * variances[0] * aw + acx
    cy = deltas[..., 1] * variances[1] * ah + acy
    w = torch.exp(deltas[..., 2] * variances[2]) * aw
    h = torch.exp(deltas[..., 3] * variances[3]) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def force_match(iou: torch.Tensor, valid: torch.Tensor):
    """Best-anchor-per-gt forcing: each VALID gt column of the ``(..., N,
    M)`` IoU matrix forces its argmax anchor positive, with that gt as its
    assignment; padding gts force nothing.  Where valid gts share a best
    anchor, the largest gt index wins, as the JAX function's duplicate-index
    scatter leaves it on the CPU (its writes apply in order); here an
    ``amax`` scatter makes that deterministic on every device.  Returns
    ``(force (..., N) bool, gt_of_forced (..., N) int32)``."""
    n, m = iou.shape[-2:]
    lead = iou.shape[:-2]
    best_anchor = torch.argmax(iou, dim=-2)                 # (..., M)
    idx = torch.where(valid, best_anchor,
                      torch.full_like(best_anchor, n)).reshape(-1, m)
    gts = torch.arange(m, device=iou.device).expand_as(idx)
    force = torch.zeros(idx.shape[0], n + 1, dtype=torch.bool,
                        device=iou.device)
    force.scatter_(1, idx, True)
    gt_of = torch.zeros(idx.shape[0], n + 1, dtype=torch.int64,
                        device=iou.device)
    gt_of.scatter_reduce_(1, idx, gts, reduce="amax", include_self=True)
    return (force[:, :n].reshape(*lead, n),
            gt_of[:, :n].to(torch.int32).reshape(*lead, n))


def _take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx[..., k], :]`` per batch: ``x`` ``(..., M, D)`` or
    ``(..., M)``, ``idx`` ``(..., N)`` -> ``(..., N, D)`` / ``(..., N)``."""
    idx = idx.long()
    if x.dim() == idx.dim():
        return torch.gather(x, -1, idx)
    d = x.shape[-1]
    return torch.gather(x, -2, idx[..., None].expand(*idx.shape, d))


def multibox_target(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                    gt_labels: torch.Tensor, iou_threshold: float = 0.5,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """Match anchors to ground truth.  ``gt_boxes`` ``(..., M, 4)`` padded
    with zero rows, ``gt_labels`` ``(..., M)`` int with -1 padding.  Returns
    ``(cls_target (..., N), loc_target (..., N, 4), loc_mask (..., N))``:
    class 0 is background, k+1 class k; the best anchor of each gt always
    matches, the others where their best IoU is above the threshold."""
    valid = gt_labels >= 0
    iou = box_iou(anchors, gt_boxes) * valid[..., None, :]
    best_iou = torch.amax(iou, dim=-1)
    best_gt = torch.argmax(iou, dim=-1)  # the first of equal maxima
    matched = best_iou > iou_threshold
    force, gt_of_forced = force_match(iou, valid)
    assigned = torch.where(force, gt_of_forced.long(), best_gt)
    matched = matched | force
    labels = _take_rows(gt_labels, assigned)
    cls_target = torch.where(matched, labels + 1, torch.zeros_like(labels))
    loc_target = encode_boxes(anchors, _take_rows(gt_boxes, assigned),
                              variances)
    loc_target = torch.where(matched[..., None], loc_target,
                             torch.zeros_like(loc_target))
    return cls_target, loc_target, matched.to(torch.float32)


def nms(boxes: torch.Tensor, scores: torch.Tensor,
        iou_threshold: float = 0.5, score_threshold: float = 0.0,
        labels: Optional[torch.Tensor] = None,
        force_suppress: bool = False) -> torch.Tensor:
    """Greedy non-max suppression -> keep mask ``(..., N)``.

    Boxes are visited best score first (a stable sort: equal scores keep
    their index order); a box is kept unless an already kept box before it
    overlaps it above ``iou_threshold``, then only boxes scoring above
    ``score_threshold`` stay.  With ``labels`` and not ``force_suppress``
    (the reference default, ``multibox_detection-inl.h:66``) only boxes of
    one class suppress each other.  The boxes at or below the score
    threshold end the sorted order and can suppress none of those above
    it, so the scan covers the boxes above it only (``counts``); it runs in
    ``ops.kernels.nms_keep``.  Leading axes are images, each its own
    scan."""
    order, sb, lab, counts = _scan_inputs(boxes, scores, score_threshold,
                                          labels, force_suppress)
    keep_sorted = kernels.nms_keep(sb, lab, counts, iou_threshold)
    keep = torch.zeros_like(keep_sorted).scatter_(1, order, keep_sorted)
    return keep.reshape(scores.shape)


def _scan_inputs(boxes, scores, score_threshold: float, labels,
                 force_suppress: bool):
    """What :func:`nms` hands the scan: a (B, N) image-by-image stable
    order of the scores, best first, the boxes (B, N, 4) and labels (int32
    (B, N), None when every box suppresses every other) in that order, and
    each image's count of boxes above the score threshold."""
    n = scores.shape[-1]
    s2 = scores.reshape(-1, n)
    order = torch.argsort(-s2, dim=-1, stable=True)
    sb = _take_rows(boxes.reshape(-1, n, 4), order).contiguous()
    counts = (torch.gather(s2, 1, order) > score_threshold).sum(-1) \
        .to(torch.int32)
    lab = None
    if labels is not None and not force_suppress:
        lab = torch.gather(labels.reshape(-1, n), 1, order) \
            .to(torch.int32).contiguous()
    return order, sb, lab, counts


def multibox_detection(cls_probs: torch.Tensor, loc_deltas: torch.Tensor,
                       anchors: torch.Tensor, iou_threshold: float = 0.5,
                       score_threshold: float = 0.01,
                       force_suppress: bool = False,
                       variances=(0.1, 0.1, 0.2, 0.2)):
    """Decode + NMS: ``cls_probs`` ``(..., C+1, N)`` with background at row
    0 (the reference layout), ``loc_deltas`` ``(..., N, 4)``.  Returns
    ``(labels (..., N), scores (..., N), boxes (..., N, 4))``, label -1
    for suppressed and background entries."""
    scores = torch.amax(cls_probs[..., 1:, :], dim=-2)
    labels = torch.argmax(cls_probs[..., 1:, :], dim=-2)
    boxes = decode_boxes(anchors, loc_deltas, variances)
    keep = nms(boxes, scores, iou_threshold, score_threshold,
               labels=labels, force_suppress=force_suppress)
    return torch.where(keep, labels, torch.full_like(labels, -1)), scores, \
        boxes
