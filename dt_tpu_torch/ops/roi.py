"""Region ops: ROI pooling and align, PSROI pooling, the RPN proposal stage
and deformable convolution (counterpart of ``dt_tpu/ops/roi.py``).

Reference semantics, as the JAX package keeps them:

- ``src/operator/roi_pooling.cc`` — max ROI pooling, rounded pixel
  coordinates, +1 box widths, malformed ROIs clamped to 1x1, empty bins 0.
- ``src/operator/contrib/roi_align.cc`` — average ROI align on a fixed
  ``sample_ratio`` grid (2 where the reference adapts it), no half-pixel
  shift.
- ``src/operator/contrib/psroi_pooling.cc`` — position-sensitive average
  pooling.
- ``src/operator/contrib/proposal.cc`` / ``multi_proposal.cc`` — anchors,
  ``BBoxTransformInv`` decode, clip, FilterBox (small boxes widened by
  ``min_size / 2`` and scored -1), pre-NMS top-K, greedy NMS, post-NMS
  top-K padded with the best box.
- ``src/operator/contrib/deformable_convolution.cc`` — deformable conv v1
  as a sampled im2col and one matmul.

Layouts are the JAX functions': feature maps NHWC (a channels_last NCHW
activation ``x`` is ``x.permute(0, 2, 3, 1)`` here, without a copy),
deformable kernels HWIO, ROIs ``(R, 5)`` rows ``[batch_idx, x1, y1, x2,
y2]`` in image pixels.  Each function computes what its JAX twin computes,
with the same float operations in the same order; ties in the top-K break
to the lower index, as ``lax.top_k`` breaks them (a stable descending sort).
No TPU kernel stands behind these ops: they are PyTorch code, but for the
NMS scan inside :func:`proposal` (``ops.detection.nms``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from dt_tpu_torch.ops.detection import nms


# ---------------------------------------------------------------------------
# interval-mask pooling core (roi_pool / psroi_pool share it)
# ---------------------------------------------------------------------------

def _bin_edges(start, bin_size, p: int, limit: int, offset):
    """Per-bin ``[lo, hi)`` integer intervals clipped to ``[0, limit]``:
    ``start``/``bin_size``/``offset`` ``(R,)`` -> ``lo, hi`` ``(R, P)``."""
    idx = torch.arange(p, dtype=torch.float32, device=bin_size.device)
    lo = torch.floor(idx * bin_size[:, None] + offset[:, None]) \
        + start[:, None]
    hi = torch.ceil((idx + 1) * bin_size[:, None] + offset[:, None]) \
        + start[:, None]
    return (torch.clamp(lo, 0, limit).to(torch.int32),
            torch.clamp(hi, 0, limit).to(torch.int32))


def _interval_mask(lo, hi, limit: int) -> torch.Tensor:
    """``(R, P)`` interval bounds -> ``(R, P, limit)`` membership."""
    pos = torch.arange(limit, device=lo.device)
    return (pos >= lo[..., None]) & (pos < hi[..., None])


def roi_pool(data: torch.Tensor, rois: torch.Tensor,
             pooled_size: Tuple[int, int],
             spatial_scale: float) -> torch.Tensor:
    """Max ROI pooling: ``data`` (N, H, W, C), ``rois`` (R, 5) -> (R, PH,
    PW, C) (``roi_pooling.cc`` ROIPoolForward)."""
    ph, pw = pooled_size
    n, h, w, c = data.shape
    feats = data[rois[:, 0].to(torch.int64)]           # (R, H, W, C)
    x1 = torch.round(rois[:, 1] * spatial_scale)
    y1 = torch.round(rois[:, 2] * spatial_scale)
    x2 = torch.round(rois[:, 3] * spatial_scale)
    y2 = torch.round(rois[:, 4] * spatial_scale)
    rh = torch.clamp(y2 - y1 + 1.0, min=1.0)
    rw = torch.clamp(x2 - x1 + 1.0, min=1.0)
    zero = torch.zeros_like(x1)
    hlo, hhi = _bin_edges(y1, rh / ph, ph, h, zero)
    wlo, whi = _bin_edges(x1, rw / pw, pw, w, zero)
    hmask = _interval_mask(hlo, hhi, h)                # (R, PH, H)
    wmask = _interval_mask(wlo, whi, w)                # (R, PW, W)
    neg = torch.finfo(data.dtype).min
    rows = torch.where(hmask[:, :, :, None, None], feats[:, None],
                       torch.full((), neg, dtype=data.dtype,
                                  device=data.device)).amax(dim=2)
    out = torch.where(wmask[:, None, :, :, None], rows[:, :, None],
                      torch.full((), neg, dtype=data.dtype,
                                 device=data.device)).amax(dim=3)
    empty = (hhi <= hlo)[:, :, None] | (whi <= wlo)[:, None, :]
    return torch.where(empty[..., None], torch.zeros_like(out), out) \
        .to(data.dtype)


def psroi_pool(data: torch.Tensor, rois: torch.Tensor, output_dim: int,
               pooled_size: int, spatial_scale: float,
               group_size: int = 0) -> torch.Tensor:
    """Position-sensitive ROI average pooling -> (R, P, P, output_dim).
    ``data`` (N, H, W, G*G*output_dim); output channel ``ctop`` at bin
    ``(gh, gw)`` averages input channel ``(ctop*G + gh)*G + gw``
    (``psroi_pooling.cc`` PSROIPoolForward)."""
    g = group_size or pooled_size
    p = pooled_size
    n, h, w, cin = data.shape
    assert cin == g * g * output_dim, (cin, g, output_dim)
    feats = data[rois[:, 0].to(torch.int64)]
    x1 = torch.round(rois[:, 1]) * spatial_scale
    y1 = torch.round(rois[:, 2]) * spatial_scale
    x2 = (torch.round(rois[:, 3]) + 1.0) * spatial_scale
    y2 = (torch.round(rois[:, 4]) + 1.0) * spatial_scale
    rw = torch.clamp(x2 - x1, min=0.1)
    rh = torch.clamp(y2 - y1, min=0.1)
    zero = torch.zeros_like(x1)
    hlo, hhi = _bin_edges(zero, rh / p, p, h, y1)
    wlo, whi = _bin_edges(zero, rw / p, p, w, x1)
    hmask = _interval_mask(hlo, hhi, h).to(data.dtype)  # (R, P, H)
    wmask = _interval_mask(wlo, whi, w).to(data.dtype)  # (R, P, W)
    f = feats.reshape(-1, h, w, output_dim, g, g)
    f = torch.movedim(f, 3, 5)                          # (R, H, W, gh, gw, D)
    rows = torch.einsum("rph,rhwabd->rpwabd", hmask, f)
    sums = torch.einsum("rqw,rpwabd->rpqabd", wmask, rows)
    gh = torch.clamp((torch.arange(p, device=data.device) * g) // p, 0, g - 1)
    ar = torch.arange(p, device=data.device)
    out = sums[:, ar[:, None], ar[None, :], gh[:, None], gh[None, :]]
    area = ((hhi - hlo)[:, :, None] * (whi - wlo)[:, None, :]).to(data.dtype)
    return torch.where(area[..., None] > 0,
                       out / torch.clamp(area, min=1)[..., None],
                       torch.zeros_like(out))


# ---------------------------------------------------------------------------
# bilinear sampling core (roi_align / deformable / warp share it)
# ---------------------------------------------------------------------------

def sample_batched(data: torch.Tensor, batch_idx: torch.Tensor,
                   ys: torch.Tensor, xs: torch.Tensor,
                   mode: str = "zero") -> torch.Tensor:
    """:func:`bilinear_sample` of image ``batch_idx`` of ``data`` (N, H, W,
    C) at each point: ``batch_idx``, ``ys`` and ``xs`` broadcast to one
    shape S; returns (S..., C).  The images are gathered point by point, so
    no ``(points, H, W, C)`` copy is made."""
    h, w = data.shape[1], data.shape[2]
    if mode == "border":
        valid = (ys >= -1.0) & (ys <= h) & (xs >= -1.0) & (xs <= w)
        ys = torch.clamp(ys, 0, h - 1)
        xs = torch.clamp(xs, 0, w - 1)
    else:
        valid = (ys > -1.0) & (ys < h) & (xs > -1.0) & (xs < w)
    y0 = torch.floor(ys)
    x0 = torch.floor(xs)
    wy1 = ys - y0
    wx1 = xs - x0
    out = 0.0
    for dy in (0, 1):
        for dx in (0, 1):
            yy = y0 + dy
            xx = x0 + dx
            wgt = (wy1 if dy else 1 - wy1) * (wx1 if dx else 1 - wx1)
            ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w) & valid
            yi = torch.clamp(yy, 0, h - 1).to(torch.int64)
            xi = torch.clamp(xx, 0, w - 1).to(torch.int64)
            wgt = torch.where(ok, wgt, torch.zeros_like(wgt))
            out = out + wgt[..., None] * data[batch_idx, yi, xi]
    return out


def bilinear_sample(feat: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    mode: str = "zero") -> torch.Tensor:
    """Bilinear interpolation of ``feat`` (H, W, C) at float coords ``ys``/
    ``xs`` of any one shape S -> (S..., C).  ``"zero"``: corners outside
    the image contribute 0 (``deformable_im2col``); ``"border"``: samples
    in the window [-1, H] x [-1, W] clamp to the border pixel, farther ones
    give 0 (``roi_align.cc`` pre_calc)."""
    return sample_batched(feat[None], torch.zeros((), dtype=torch.int64,
                                                  device=feat.device),
                          ys, xs, mode)


def roi_align(data: torch.Tensor, rois: torch.Tensor,
              pooled_size: Tuple[int, int], spatial_scale: float,
              sample_ratio: int = -1) -> torch.Tensor:
    """Average ROI align -> (R, PH, PW, C): ROI coords scaled (no rounding,
    no half-pixel shift), sizes clamped to >= 1, each bin the mean of an
    ``r x r`` bilinear grid ("border" mode) at ``start + (i + 0.5) * bin /
    r``; ``r`` is ``sample_ratio``, or 2 where it is <= 0 (the JAX
    function's fixed stand-in for the reference's adaptive grid)."""
    ph, pw = pooled_size
    r = sample_ratio if sample_ratio > 0 else 2
    dev = data.device
    x1 = rois[:, 1] * spatial_scale
    y1 = rois[:, 2] * spatial_scale
    x2 = rois[:, 3] * spatial_scale
    y2 = rois[:, 4] * spatial_scale
    rw = torch.clamp(x2 - x1, min=1.0)
    rh = torch.clamp(y2 - y1, min=1.0)
    bh, bw = (rh / ph)[:, None, None], (rw / pw)[:, None, None]
    ar = torch.arange(r, device=dev)[None, None, :] + 0.5
    iy = torch.arange(ph, device=dev)[None, :, None] * bh \
        + ar * bh / r + y1[:, None, None]                # (R, PH, r)
    ix = torch.arange(pw, device=dev)[None, :, None] * bw \
        + ar * bw / r + x1[:, None, None]                # (R, PW, r)
    ys = iy[:, :, None, :, None]
    xs = ix[:, None, :, None, :]                         # (R, PH, PW, r, r)
    bidx = rois[:, 0].to(torch.int64)[:, None, None, None, None]
    samples = sample_batched(data, bidx, ys, xs, mode="border")
    return samples.mean(dim=(3, 4)).to(data.dtype)


# ---------------------------------------------------------------------------
# RPN proposal
# ---------------------------------------------------------------------------

def generate_anchors(stride: int = 16,
                     scales: Sequence[float] = (8, 16, 32),
                     ratios: Sequence[float] = (0.5, 1, 2),
                     device=None) -> torch.Tensor:
    """(A, 4) base anchors of one cell in pixel corners: the Faster-RCNN
    enumeration of ``proposal.cc`` GenerateAnchors (base box ``[0, 0,
    stride-1, stride-1]``; per ratio ``ws = round(sqrt(size / ratio))``,
    ``hs = round(ws * ratio)``, then each scale), ratio-major."""
    base = np.array([0, 0, stride - 1, stride - 1], np.float32)
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + 0.5 * (w - 1)
    cy = base[1] + 0.5 * (h - 1)
    out = []
    for ratio in ratios:
        ws = np.round(np.sqrt(w * h / ratio))
        hs = np.round(ws * ratio)
        for scale in scales:
            sw, sh = ws * scale, hs * scale
            out.append([cx - 0.5 * (sw - 1), cy - 0.5 * (sh - 1),
                        cx + 0.5 * (sw - 1), cy + 0.5 * (sh - 1)])
    return torch.from_numpy(np.array(out, np.float32)).to(device)


def shifted_anchors(feat_h: int, feat_w: int, stride: int,
                    scales: Sequence[float], ratios: Sequence[float],
                    device=None) -> torch.Tensor:
    """All anchors of a (feat_h, feat_w) grid -> (H*W*A, 4): the base
    anchors shifted by ``stride`` a cell, row-major over (h, w, a)."""
    base = generate_anchors(stride, scales, ratios, device)
    sx = torch.arange(feat_w, dtype=torch.float32, device=device) * stride
    sy = torch.arange(feat_h, dtype=torch.float32, device=device) * stride
    gx = sx[None, :].expand(feat_h, feat_w)
    gy = sy[:, None].expand(feat_h, feat_w)
    shift = torch.stack([gx, gy, gx, gy], -1)
    return (shift[:, :, None, :] + base[None, None]).reshape(-1, 4)


def encode_rpn(anchors: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """Regression targets that :func:`_decode_rpn` maps back to ``gt``, in
    the +1-pixel convention (``example/rcnn`` bbox_transform)."""
    aw = anchors[..., 2] - anchors[..., 0] + 1.0
    ah = anchors[..., 3] - anchors[..., 1] + 1.0
    acx = anchors[..., 0] + 0.5 * (aw - 1.0)
    acy = anchors[..., 1] + 0.5 * (ah - 1.0)
    gw = torch.clamp(gt[..., 2] - gt[..., 0] + 1.0, min=1.0)
    gh = torch.clamp(gt[..., 3] - gt[..., 1] + 1.0, min=1.0)
    gcx = gt[..., 0] + 0.5 * (gw - 1.0)
    gcy = gt[..., 1] + 0.5 * (gh - 1.0)
    return torch.stack([(gcx - acx) / aw, (gcy - acy) / ah,
                        torch.log(gw / aw), torch.log(gh / ah)], -1)


def _decode_rpn(anchors: torch.Tensor, deltas: torch.Tensor, im_h,
                im_w) -> torch.Tensor:
    """``BBoxTransformInv`` (proposal.cc): decode with the +1/-1 pixel
    conventions and clip to the image.  ``deltas`` (..., N, 4), ``im_h``/
    ``im_w`` of the leading shape (0-d for one image)."""
    w = anchors[..., 2] - anchors[..., 0] + 1.0
    h = anchors[..., 3] - anchors[..., 1] + 1.0
    cx = anchors[..., 0] + 0.5 * (w - 1.0)
    cy = anchors[..., 1] + 0.5 * (h - 1.0)
    pcx = deltas[..., 0] * w + cx
    pcy = deltas[..., 1] * h + cy
    pw = torch.exp(deltas[..., 2]) * w
    ph = torch.exp(deltas[..., 3]) * h
    boxes = torch.stack([pcx - 0.5 * (pw - 1), pcy - 0.5 * (ph - 1),
                         pcx + 0.5 * (pw - 1), pcy + 0.5 * (ph - 1)], -1)
    im_h = torch.as_tensor(im_h, dtype=boxes.dtype, device=boxes.device)
    im_w = torch.as_tensor(im_w, dtype=boxes.dtype, device=boxes.device)
    hi = torch.stack([im_w - 1, im_h - 1, im_w - 1, im_h - 1], -1)
    return torch.minimum(torch.clamp(boxes, min=0.0), hi.unsqueeze(-2))


def multi_proposal(scores: torch.Tensor, bbox_deltas: torch.Tensor,
                   im_info: torch.Tensor, stride: int = 16,
                   scales: Sequence[float] = (4, 8, 16, 32),
                   ratios: Sequence[float] = (0.5, 1, 2),
                   pre_nms_top_n: int = 6000, post_nms_top_n: int = 300,
                   nms_threshold: float = 0.7, min_size: int = 16):
    """RPN proposals of a batch (``multi_proposal.cc``): ``scores`` (B, H,
    W, A) foreground scores, ``bbox_deltas`` (B, H, W, A, 4), ``im_info``
    (B, 3) = (height, width, scale) -> ``(boxes (B, post_N, 4), scores (B,
    post_N))``.  See :func:`proposal`; every image is its own scan."""
    b, h, w, a = scores.shape
    n_base = len(scales) * len(ratios)
    assert a == n_base, \
        f"scores carry {a} anchors/cell, scales x ratios give {n_base}"
    anchors = shifted_anchors(h, w, stride, scales, ratios, scores.device)
    return _propose(scores, bbox_deltas, im_info, anchors, pre_nms_top_n,
                    post_nms_top_n, nms_threshold, min_size)


def _propose(scores, bbox_deltas, im_info, anchors, pre_nms_top_n: int,
             post_nms_top_n: int, nms_threshold: float, min_size: int):
    """:func:`multi_proposal` from its ``anchors`` (H*W*A, 4), which a
    caller on the card keeps from step to step (making them copies the
    base anchors to the device, and the copy waits for the stream)."""
    b = scores.shape[0]
    deltas = bbox_deltas.reshape(b, -1, 4)
    scr = scores.reshape(b, -1)
    boxes = _decode_rpn(anchors, deltas, im_info[:, 0], im_info[:, 1])
    ms = min_size * im_info[:, 2]                        # (B,)
    bw = boxes[..., 2] - boxes[..., 0] + 1.0
    bh = boxes[..., 3] - boxes[..., 1] + 1.0
    small = (bw < ms[:, None]) | (bh < ms[:, None])
    # FilterBox: widen small boxes by min_size/2 (x1, y1 down, x2, y2 up)
    # and sentinel the score
    half = (ms / 2)[:, None, None]
    widen = torch.where(small[..., None],
                        torch.cat([-half, -half, half, half], -1),
                        torch.zeros((), dtype=boxes.dtype,
                                    device=boxes.device))
    boxes = boxes + widen
    scr = torch.where(small, torch.full_like(scr, -1.0), scr)

    k = min(pre_nms_top_n, scr.shape[1])
    top_scr, top_idx = torch.sort(scr, dim=1, descending=True, stable=True)
    top_scr, top_idx = top_scr[:, :k], top_idx[:, :k]
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(b, k, 4))
    # already score-ordered: nms's stable sort keeps this order; -inf keeps
    # the -1 small-box sentinels eligible, as the reference does
    keep = nms(top_boxes, top_scr, nms_threshold,
               score_threshold=float("-inf"))
    post = min(post_nms_top_n, k)
    pos = torch.arange(k, device=scores.device)
    order = torch.argsort(torch.where(keep, pos, torch.full_like(pos, k)),
                          dim=1, stable=True)
    sel = order[:, :post]
    n_kept = keep.sum(1, keepdim=True)
    sel = torch.where(torch.arange(post, device=scores.device) < n_kept, sel,
                      order[:, :1])
    return (torch.gather(top_boxes, 1, sel[..., None].expand(b, post, 4)),
            torch.gather(top_scr, 1, sel))


def proposal(scores: torch.Tensor, bbox_deltas: torch.Tensor,
             im_info: torch.Tensor, stride: int = 16,
             scales: Sequence[float] = (4, 8, 16, 32),
             ratios: Sequence[float] = (0.5, 1, 2),
             pre_nms_top_n: int = 6000, post_nms_top_n: int = 300,
             nms_threshold: float = 0.7, min_size: int = 16):
    """RPN proposals of one image -> ``(boxes (post_N, 4), scores
    (post_N,))``.  ``scores`` (H, W, A), ``bbox_deltas`` (H, W, A, 4),
    ``im_info`` (3,) = (height, width, scale).  Anchors shifted by
    ``stride`` a cell, decode + clip, FilterBox, pre-NMS top-K, greedy NMS,
    post-NMS top-K; fewer survivors than ``post_N`` repeat the best one, as
    the JAX function pads."""
    boxes, scr = multi_proposal(
        scores[None], bbox_deltas[None], im_info[None], stride=stride,
        scales=scales, ratios=ratios, pre_nms_top_n=pre_nms_top_n,
        post_nms_top_n=post_nms_top_n, nms_threshold=nms_threshold,
        min_size=min_size)
    return boxes[0], scr[0]


# ---------------------------------------------------------------------------
# deformable convolution
# ---------------------------------------------------------------------------

def deformable_conv2d(x: torch.Tensor, offset: torch.Tensor,
                      weight: torch.Tensor,
                      stride: Tuple[int, int] = (1, 1),
                      padding: Tuple[int, int] = (0, 0),
                      dilation: Tuple[int, int] = (1, 1),
                      deformable_groups: int = 1) -> torch.Tensor:
    """Deformable convolution v1, NHWC / HWIO: ``x`` (N, H, W, C),
    ``offset`` (N, OH, OW, DG*KH*KW*2) with the reference's (dy, dx)
    interleave a tap a group, ``weight`` (KH, KW, C, F).  Each tap samples
    its dilated position plus its offset ("zero" mode); the sampled im2col
    matrix meets the weight in one matmul."""
    kh, kw, cin, cout = weight.shape
    n, h, w, c = x.shape
    assert c == cin and c % deformable_groups == 0
    oh = (h + 2 * padding[0] - dilation[0] * (kh - 1) - 1) // stride[0] + 1
    ow = (w + 2 * padding[1] - dilation[1] * (kw - 1) - 1) // stride[1] + 1
    dg = deformable_groups
    dev = x.device
    base_y = (torch.arange(oh, device=dev) * stride[0])[:, None] \
        + (torch.arange(kh, device=dev) * dilation[0])[None, :] - padding[0]
    base_x = (torch.arange(ow, device=dev) * stride[1])[:, None] \
        + (torch.arange(kw, device=dev) * dilation[1])[None, :] - padding[1]
    off = offset.reshape(n, oh, ow, dg, kh, kw, 2)
    ys = base_y[None, :, None, None, :, None] + off[..., 0]
    # (N, OH, OW, DG, KH, KW) each
    xs = base_x[None, None, :, None, None, :] + off[..., 1]
    cpg = c // dg
    bidx = torch.arange(n, device=dev)[:, None, None, None, None]
    cols = [sample_batched(x[..., gi * cpg:(gi + 1) * cpg], bidx,
                           ys[:, :, :, gi], xs[:, :, :, gi])
            for gi in range(dg)]                        # (N,OH,OW,KH,KW,cpg)
    col = torch.stack(cols, dim=5).reshape(n * oh * ow, kh * kw * c)
    out = col @ weight.to(col.dtype).reshape(kh * kw * c, cout)
    return out.reshape(n, oh, ow, cout).to(x.dtype)
