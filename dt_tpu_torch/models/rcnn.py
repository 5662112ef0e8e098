"""Two-stage detector, Faster-RCNN family (counterpart of
``dt_tpu/models/rcnn.py``).

Reference: ``example/rcnn/``: a backbone, an RPN (objectness and deltas
over anchors), the proposal op, ROI features and a classification head
with a box refinement, over ``ops.roi`` and ``ops.detection``.  The
proposal stage gives a fixed number of ROIs an image (top-K + NMS, padded
with the best), so the head sees a (B*R, ...) batch; the ROIs carry no
gradient.  The backbone's three ConvBNs run the BN kernels
(``fused_bn_train`` in training, ``fused_bn_inference`` in eval); children
are named as the JAX model names them: ``ConvBN_0..2``, ``Conv_0..2`` (RPN),
``Dense_0..3`` (head).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from dt_tpu_torch.models.common import Dense, Numbered
from dt_tpu_torch.ops import roi as roi_ops
from dt_tpu_torch.ops.detection import (box_iou, decode_boxes, encode_boxes,
                                        force_match, nms)


class FasterRCNNMini(Numbered):
    """``forward(x, training)`` on NCHW channels_last images returns a
    dict: ``rpn_scores`` (B, H, W, A), ``rpn_deltas`` (B, H, W, A, 4),
    ``rois`` (B, R, 4) image-pixel corners (no gradient), ``roi_scores``
    (B, R), ``cls_scores`` (B, R, C+1), ``box_deltas`` (B, R, 4), all
    f32.  In a bfloat16 model the RPN's sigmoid, ``roi_align`` and the last
    two dense layers run in f32, as in the JAX model."""

    def __init__(self, num_classes: int = 3, feature_stride: int = 8,
                 anchor_scales: Sequence[float] = (2.0, 4.0),
                 anchor_ratios: Sequence[float] = (0.5, 1.0, 2.0),
                 num_rois: int = 32, pre_nms_top_n: int = 256,
                 nms_threshold: float = 0.7, pooled_size: int = 7,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3):
        super().__init__(dtype)
        self.num_classes = num_classes
        self.feature_stride = feature_stride
        self.anchor_scales = tuple(anchor_scales)
        self.anchor_ratios = tuple(anchor_ratios)
        self.num_rois = num_rois
        self.pre_nms_top_n = pre_nms_top_n
        self.nms_threshold = nms_threshold
        self.pooled_size = pooled_size
        a = len(self.anchor_scales) * len(self.anchor_ratios)
        self.backbone = []
        cin = in_channels
        for f in (32, 64, 128):
            self.backbone.append(self.conv_bn(cin, f, (3, 3), (2, 2)))
            cin = f
        # (trunk, scores, deltas); children kept in lists, not attributes
        self.rpn = [self.conv(cin, 256, (3, 3)), self.conv(256, a, (1, 1)),
                    self.conv(256, a * 4, (1, 1))]
        p2 = pooled_size * pooled_size
        # the last two dense layers are f32 in every model dtype
        self.head = [self.dense(p2 * cin, 256), self.dense(256, 256),
                     self.numbered("Dense", Dense(256, num_classes + 1)),
                     self.numbered("Dense", Dense(256, 4))]
        self._anchors: Dict[tuple, torch.Tensor] = {}

    def forward(self, x: torch.Tensor, training: bool = False
                ) -> Dict[str, torch.Tensor]:
        b, _, img_h, img_w = x.shape
        a = len(self.anchor_scales) * len(self.anchor_ratios)
        for cb in self.backbone:
            x = cb(x, training)
        feat = x                                           # (B, C, H/8, W/8)
        trunk, score_conv, delta_conv = self.rpn
        rpn = torch.relu(trunk(feat))
        scores = torch.sigmoid(score_conv(rpn).float().permute(0, 2, 3, 1))
        h, w = scores.shape[1], scores.shape[2]
        deltas = delta_conv(rpn).float().permute(0, 2, 3, 1) \
            .reshape(b, h, w, a, 4)
        # (height, width, scale) an image, made on the device (no copy)
        im_info = torch.stack([torch.full((b,), float(v), device=x.device)
                               for v in (img_h, img_w, 1.0)], 1)
        # multi_proposal with the anchors kept on the model; min_size is
        # the proposal stage's default, as the JAX model leaves it
        rois, roi_scores = roi_ops._propose(
            scores, deltas, im_info, self._shifted(h, w, x.device),
            pre_nms_top_n=self.pre_nms_top_n, post_nms_top_n=self.num_rois,
            nms_threshold=self.nms_threshold, min_size=16)
        rois = rois.detach()                               # (B, R, 4)
        r = self.num_rois
        batch_idx = torch.arange(b, dtype=torch.float32,
                                 device=x.device).repeat_interleave(r)
        flat = torch.cat([batch_idx[:, None], rois.reshape(b * r, 4)], 1)
        pooled = roi_ops.roi_align(
            feat.permute(0, 2, 3, 1).float(), flat,
            (self.pooled_size, self.pooled_size),
            spatial_scale=1.0 / self.feature_stride, sample_ratio=2)
        y = pooled.reshape(b * r, -1).to(self.dtype)       # (h, w, c) order
        for d in self.head[:2]:
            y = torch.relu(d(y))
        cls = self.head[2](y.float())
        box = self.head[3](y.float())
        return {"rpn_scores": scores, "rpn_deltas": deltas, "rois": rois,
                "roi_scores": roi_scores,
                "cls_scores": cls.reshape(b, r, self.num_classes + 1),
                "box_deltas": box.reshape(b, r, 4)}

    def _shifted(self, h: int, w: int, device) -> torch.Tensor:
        """The shifted anchors of an (h, w) feature grid on ``device``,
        made once (read them, do not write them)."""
        key = (h, w, str(torch.device(device) if device is not None
                         else "cpu"))
        if key not in self._anchors:
            self._anchors[key] = roi_ops.shifted_anchors(
                h, w, self.feature_stride, self.anchor_scales,
                self.anchor_ratios, device)
        return self._anchors[key]

    def anchors(self, img_hw: Tuple[int, int], device=None) -> torch.Tensor:
        """Every shifted anchor of an input size -> (H*W*A, 4), the RPN's
        target grid (the proposal stage's own anchors); ceil division gives
        the SAME-padded stride-2 backbone's feature sizes."""
        return self._shifted(-(-img_hw[0] // self.feature_stride),
                             -(-img_hw[1] // self.feature_stride), device)


def _smooth_l1(x: torch.Tensor) -> torch.Tensor:
    ax = torch.abs(x)
    return torch.where(ax < 1.0, 0.5 * x * x, ax - 0.5)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, k]]`` for ``x`` (B, M, ...) and ``idx`` (B, N)."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None], idx.long()]


def rcnn_loss(out: Dict[str, torch.Tensor], anchors: torch.Tensor,
              gt_boxes: torch.Tensor, gt_labels: torch.Tensor,
              rpn_pos_iou: float = 0.5,
              head_pos_iou: float = 0.5) -> torch.Tensor:
    """Joint RPN + head loss of a batch (``example/rcnn`` loss wiring):
    ``gt_boxes`` (B, M, 4) image-pixel corners zero-padded, ``gt_labels``
    (B, M), -1 padding.  RPN: binary CE on matched / background anchors +
    smooth-L1 on the positives (the best anchor of each gt forced, with
    that gt as its target); head: softmax CE over C+1 with proposals
    matched by IoU + smooth-L1 on the positive proposals (variances 1)."""
    b = out["rpn_scores"].shape[0]
    valid = gt_labels >= 0
    with torch.no_grad():
        iou = box_iou(anchors, gt_boxes) * valid[:, None, :]
        best = torch.amax(iou, dim=-1)
        arg = torch.argmax(iou, dim=-1)
        pos = best > rpn_pos_iou
        force, gt_of_forced = force_match(iou, valid)
        arg = torch.where(force, gt_of_forced.long(), arg)
        pos = pos | force
        neg = best < 0.3
        t = roi_ops.encode_rpn(anchors, _rows(gt_boxes, arg))
    s = out["rpn_scores"].reshape(b, -1)
    posf = pos.to(s.dtype)
    bce = -(posf * torch.log(s + 1e-8)
            + (neg & ~pos).to(s.dtype) * torch.log(1 - s + 1e-8))
    n_pos = torch.clamp(pos.sum(-1), min=1)
    rpn_cls = bce.sum(-1) / torch.clamp((pos | neg).sum(-1), min=1)
    rpn_loc = (_smooth_l1(out["rpn_deltas"].reshape(b, -1, 4) - t)
               * posf[..., None]).sum((-2, -1)) / n_pos

    rois = out["rois"]
    with torch.no_grad():
        piou = box_iou(rois, gt_boxes) * valid[:, None, :]
        pbest = torch.amax(piou, dim=-1)
        parg = torch.argmax(piou, dim=-1)
        ppos = pbest > head_pos_iou
        labels = _rows(gt_labels, parg)
        cls_t = torch.where(ppos, labels + 1, torch.zeros_like(labels))
        t2 = encode_boxes(rois, _rows(gt_boxes, parg), variances=(1, 1, 1, 1))
    logp = torch.log_softmax(out["cls_scores"], dim=-1)
    head_cls = -torch.gather(logp, -1, cls_t[..., None].long())[..., 0] \
        .mean(-1)
    head_loc = (_smooth_l1(out["box_deltas"] - t2)
                * ppos[..., None].to(logp.dtype)).sum((-2, -1)) \
        / torch.clamp(ppos.sum(-1), min=1)
    return torch.mean(rpn_cls + rpn_loc + head_cls + head_loc)


def rcnn_detect(out: Dict[str, torch.Tensor], score_threshold: float = 0.05,
                iou_threshold: float = 0.5):
    """Decode the head's predictions -> ``(labels (B, R), scores, boxes)``,
    label -1 for background and suppressed entries (``ssd_detect``'s
    contract)."""
    return _detect_probs(torch.softmax(out["cls_scores"], dim=-1),
                         out["rois"], out["box_deltas"], score_threshold,
                         iou_threshold)


def _detect_probs(probs: torch.Tensor, rois: torch.Tensor,
                  box_deltas: torch.Tensor, score_threshold: float = 0.05,
                  iou_threshold: float = 0.5):
    """:func:`rcnn_detect` from the head's class probabilities ``(B, R,
    C+1)``."""
    scores = torch.amax(probs[..., 1:], dim=-1)
    labels = torch.argmax(probs[..., 1:], dim=-1)
    boxes = decode_boxes(rois, box_deltas, variances=(1, 1, 1, 1))
    keep = nms(boxes, scores, iou_threshold, score_threshold, labels=labels)
    return torch.where(keep, labels, torch.full_like(labels, -1)), scores, \
        boxes
