"""Spatial-warp ops: grid generator, bilinear sampler, spatial transformer,
FlowNet correlation (counterpart of ``dt_tpu/ops/warp.py``).

Reference: ``src/operator/grid_generator.cc`` (affine and optical-flow
sampling grids in [-1, 1]), ``bilinear_sampler.cc`` (zero outside),
``spatial_transformer.cc`` (affine grid + sampler) and ``correlation.cc``
(the FlowNet cost volume).  Layouts are the JAX functions': images NHWC (a
channels_last NCHW activation ``x`` is ``x.permute(0, 2, 3, 1)``), grids
(B, H, W, 2) with ``(x, y)`` last, correlation's displacements last.  The
sampler is the shared bilinear core, ``ops.roi.sample_batched``, as the JAX
module shares ``ops.roi.bilinear_sample``.  No TPU kernel stands behind
these ops: they are PyTorch code.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from dt_tpu_torch.ops.roi import sample_batched


def affine_grid(theta: torch.Tensor,
                target_shape: Tuple[int, int]) -> torch.Tensor:
    """Affine sampling grid -> (B, H, W, 2) of (x, y) in [-1, 1].
    ``theta`` (B, 6) or (B, 2, 3) maps target (x, y, 1) to source (x, y)
    (``grid_generator-inl.h:86-111``)."""
    h, w = target_shape
    theta = theta.reshape(-1, 2, 3)
    dev, dt = theta.device, theta.dtype
    xs = -1.0 + torch.arange(w, dtype=dt, device=dev) * (2.0 / (w - 1)) \
        if w > 1 else torch.zeros(w, dtype=dt, device=dev)
    ys = -1.0 + torch.arange(h, dtype=dt, device=dev) * (2.0 / (h - 1)) \
        if h > 1 else torch.zeros(h, dtype=dt, device=dev)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    dst = torch.stack([gx, gy, torch.ones_like(gx)], dim=-1)  # (H, W, 3)
    return torch.einsum("bij,hwj->bhwi", theta, dst)


def warp_grid(flow: torch.Tensor) -> torch.Tensor:
    """Optical-flow sampling grid: ``flow`` (B, H, W, 2) pixel
    displacements -> ``(flow + dst_index) / ((size - 1) / 2) - 1``
    (``grid_generator-inl.h:113-130``)."""
    b, h, w, _ = flow.shape
    gy, gx = torch.meshgrid(
        torch.arange(h, dtype=flow.dtype, device=flow.device),
        torch.arange(w, dtype=flow.dtype, device=flow.device), indexing="ij")
    dst = torch.stack([gx, gy], dim=-1)
    denom = torch.tensor([(w - 1) / 2.0, (h - 1) / 2.0], dtype=flow.dtype,
                         device=flow.device)
    return (flow + dst) / denom - 1.0


def bilinear_sampler(data: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample ``data`` (B, H, W, C) at ``grid`` (B, H', W', 2) of (x, y) in
    [-1, 1] -> (B, H', W', C): ``x_real = (x + 1)(W - 1) / 2``, corners
    outside the image contribute 0 (``bilinear_sampler.cc``)."""
    b, h, w, c = data.shape
    xr = (grid[..., 0] + 1.0) * (w - 1) / 2.0
    yr = (grid[..., 1] + 1.0) * (h - 1) / 2.0
    bidx = torch.arange(b, device=data.device)[:, None, None]
    return sample_batched(data, bidx, yr, xr, mode="zero")


def spatial_transformer(data: torch.Tensor, theta: torch.Tensor,
                        target_shape: Tuple[int, int]) -> torch.Tensor:
    """Affine spatial transformer: :func:`affine_grid` then
    :func:`bilinear_sampler` (``spatial_transformer.cc``)."""
    return bilinear_sampler(data, affine_grid(theta, target_shape))


def correlation(data1: torch.Tensor, data2: torch.Tensor,
                kernel_size: int = 1, max_displacement: int = 1,
                stride1: int = 1, stride2: int = 1, pad_size: int = 0,
                is_multiply: bool = True) -> torch.Tensor:
    """FlowNet correlation -> (B, OH, OW, D*D), ``D = 2*(max_displacement
    // stride2) + 1`` (``correlation.cc`` CorrelationForward): both inputs
    zero-padded by ``pad_size``; output (i, j) correlates the
    ``kernel_size``^2 window of data1 at ``(i*stride1 + max_displacement,
    ...)`` with data2's window displaced by ``(s2p, s2o)``, one displacement
    a channel (s2p outer), over ``kernel_size^2 * C``; ``is_multiply=False``
    takes ``|a - b|``."""
    assert kernel_size % 2 == 1, "kernel_size must be odd"
    b, h, w, c = data1.shape
    kr = (kernel_size - 1) // 2
    border = max_displacement + kr
    ph, pw = h + 2 * pad_size, w + 2 * pad_size
    oh = int(math.ceil((ph - 2 * border) / stride1))
    ow = int(math.ceil((pw - 2 * border) / stride1))
    assert oh > 0 and ow > 0, "output collapses; increase pad_size"
    r = max_displacement // stride2
    pad = (0, 0, pad_size, pad_size, pad_size, pad_size)
    p1 = F.pad(data1, pad)
    p2 = F.pad(data2, pad)
    eh = (oh - 1) * stride1 + kernel_size
    ew = (ow - 1) * stride1 + kernel_size
    md = max_displacement
    a = p1[:, md:md + eh, md:md + ew]
    chans = []
    for s2p in range(-r * stride2, r * stride2 + 1, stride2):
        for s2o in range(-r * stride2, r * stride2 + 1, stride2):
            bs = p2[:, md + s2p:md + s2p + eh, md + s2o:md + s2o + ew]
            prod = a * bs if is_multiply else torch.abs(a - bs)
            # the k x k window sum at stride1
            chans.append(F.avg_pool2d(prod.sum(-1)[:, None], kernel_size,
                                      stride1, divisor_override=1)[:, 0])
    out = torch.stack(chans, dim=-1)
    return out / (kernel_size * kernel_size * c)
