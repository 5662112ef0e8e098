"""SSD single-shot detector (counterpart of ``dt_tpu/models/ssd.py``).

Reference: ``example/ssd/symbol/symbol_builder.py`` (a multi-scale feature
pyramid with a multibox head a scale) over the contrib multibox ops
(``ops.detection``).  The backbone is the JAX model's compact ConvBN stack:
three stride-2 stages to 1/8, then one stride-2 stage a further scale, every
BatchNorm the kernels' (``fused_bn_train`` in training, ``fused_bn_inference``
in eval) with its ReLU fused in.  The heads are biased 3x3 convolutions,
named ``Conv_0..9`` in call order (class then box at each scale), as the
JAX model names them.  Anchors are fixed per input size and made once a size.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from dt_tpu_torch.models.common import Numbered
from dt_tpu_torch.ops import detection

# per-scale anchor configuration (the JAX model's)
_SIZES = ((0.1, 0.141), (0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
          (0.71, 0.79))
_RATIOS = ((1.0, 2.0, 0.5),) * 5


class SSD(Numbered):
    """``forward(x, training)`` on NCHW channels_last images returns
    ``(cls_preds (B, N, C+1) f32, box_preds (B, N, 4) f32, anchors (N, 4)
    f32)``; class 0 is background."""

    def __init__(self, num_classes: int = 20,
                 dtype: torch.dtype = torch.float32,
                 sizes: Sequence[Tuple[float, ...]] = _SIZES,
                 ratios: Sequence[Tuple[float, ...]] = _RATIOS,
                 in_channels: int = 3):
        super().__init__(dtype)
        self.num_classes = num_classes
        self.sizes, self.ratios = tuple(sizes), tuple(ratios)
        cin = in_channels
        self.backbone = []
        for f in (32, 64, 128, 128, 128, 128, 128):
            self.backbone.append(self.conv_bn(cin, f, (3, 3), (2, 2)))
            cin = f
        self.heads = []
        for sz, rt in zip(self.sizes, self.ratios):
            a = len(sz) + len(rt) - 1                      # anchors a cell
            self.heads.append((a, self.conv(cin, a * (num_classes + 1),
                                            (3, 3)),
                               self.conv(cin, a * 4, (3, 3))))
        self._anchors: Dict[tuple, torch.Tensor] = {}

    def anchors_for(self, feature_hws, device) -> torch.Tensor:
        """The anchors of one input size, from its feature maps' sizes."""
        key = (tuple(feature_hws), str(device))
        if key not in self._anchors:
            self._anchors[key] = torch.cat([
                detection.multibox_prior(hw, sz, rt, device)
                for hw, sz, rt in zip(feature_hws, self.sizes, self.ratios)])
        return self._anchors[key]

    def forward(self, x: torch.Tensor, training: bool = False):
        feats = []
        for i, cb in enumerate(self.backbone):
            x = cb(x, training)
            if i >= 2:                                     # strides 8..128
                feats.append(x)
        cls_all, box_all, hws = [], [], []
        b = x.shape[0]
        for feat, (a, cls_conv, box_conv) in zip(feats, self.heads):
            h, w = feat.shape[2], feat.shape[3]
            # NCHW -> NHWC before the reshape: (B, h*w*a, .) in (h, w, a)
            cls = cls_conv(feat).permute(0, 2, 3, 1)
            box = box_conv(feat).permute(0, 2, 3, 1)
            cls_all.append(cls.reshape(b, h * w * a, self.num_classes + 1))
            box_all.append(box.reshape(b, h * w * a, 4))
            hws.append((h, w))
        return (torch.cat(cls_all, dim=1).float(),
                torch.cat(box_all, dim=1).float(),
                self.anchors_for(hws, x.device))


def ssd_loss(cls_preds: torch.Tensor, box_preds: torch.Tensor,
             anchors: torch.Tensor, gt_boxes: torch.Tensor,
             gt_labels: torch.Tensor, neg_ratio: float = 3.0,
             iou_threshold: float = 0.5) -> torch.Tensor:
    """SSD training loss of a batch: softmax CE over the positives and the
    ``neg_ratio`` x positives hardest negatives (by CE, a stable rank),
    plus smooth-L1 on the matched anchors, over the positive count, the
    mean over the images (``multibox_target.cc``, ``example/ssd``).
    ``gt_boxes`` (B, M, 4) zero-padded, ``gt_labels`` (B, M), -1 padding.
    The targets, the matching and the mining carry no gradient."""
    with torch.no_grad():
        cls_t, loc_t, loc_mask = detection.multibox_target(
            anchors, gt_boxes, gt_labels, iou_threshold)
    logp = torch.log_softmax(cls_preds, dim=-1)
    ce = -torch.gather(logp, -1, cls_t[..., None].long())[..., 0]
    pos = cls_t > 0
    n_pos = pos.sum(-1)
    with torch.no_grad():
        neg_ce = torch.where(pos, torch.full_like(ce, float("-inf")), ce)
        rank = torch.argsort(torch.argsort(-neg_ce, dim=-1, stable=True),
                             dim=-1, stable=True)     # 0 = hardest
        n_neg = torch.minimum((neg_ratio * n_pos).to(torch.int32),
                              cls_t.shape[-1] - n_pos)
        neg = (~pos) & (rank < n_neg[:, None])
    cls_loss = torch.where(pos | neg, ce, torch.zeros_like(ce)).sum(-1)
    diff = torch.abs(box_preds - loc_t)
    sl1 = torch.where(diff < 1.0, 0.5 * diff * diff, diff - 0.5)
    loc_loss = (sl1 * loc_mask[..., None]).sum((-2, -1))
    return torch.mean((cls_loss + loc_loss) / torch.clamp(n_pos, min=1))


def ssd_detect(cls_preds: torch.Tensor, box_preds: torch.Tensor,
               anchors: torch.Tensor, iou_threshold: float = 0.45,
               score_threshold: float = 0.01):
    """Decode + per-class NMS of a batch -> ``(labels, scores, boxes)``,
    each (B, N, ...), label -1 for suppressed and background entries
    (``multibox_detection.cc``'s contract)."""
    return _detect_probs(torch.softmax(cls_preds, dim=-1), box_preds,
                         anchors, iou_threshold, score_threshold)


def _detect_probs(probs: torch.Tensor, box_preds: torch.Tensor,
                  anchors: torch.Tensor, iou_threshold: float = 0.45,
                  score_threshold: float = 0.01):
    """:func:`ssd_detect` from the class probabilities ``(B, N, C+1)``."""
    return detection.multibox_detection(probs.transpose(-1, -2), box_preds,
                                        anchors, iou_threshold,
                                        score_threshold)
