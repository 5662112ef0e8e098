"""INT8 quantized inference (counterpart of ``dt_tpu/ops/quantization.py``).

Symmetric per-tensor int8 (``quantize``: scale = 127 / max(|min|, |max|)),
``dequantize``/``requantize``, the int8 dense and NHWC convolution with an
int32 accumulator scaled back to float, and the calibration flow (min/max
ranges, the KL threshold of ``entropy_calibrate``, ``quantize_params``).

``quantized_dense`` and ``quantized_conv2d`` run ``ops.kernels.qconv``: on a
CUDA tensor the hand-written int8 implicit GEMM (``csrc/qconv.cu``), on a CPU
tensor its plain version; both give the JAX functions' results bit for bit
(the int32 accumulator is exact, the epilogue is the same correctly rounded
ops in the same order).

On the card the kernel reads each weight as a packed copy (K-major rows,
``kernels.qconv_pack``), made once and cached while the weight lives and its
version counter has not moved, so an in-place write to the weight or to any
view of it is seen on the next call.  Two cases fall outside the cache:

- a weight that is an inference tensor (quantized under
  ``torch.inference_mode()``) keeps no version counter, so it is packed anew
  on every call: one more launch and an allocation a call.  Quantize weights
  under ``torch.no_grad()`` to have their packs cached.
- a write that bypasses the weight's version counter (through ``.data``,
  ``set_``, or memory shared with numpy or DLPack) is not seen, and the
  stale pack is served.  Write a weight through the tensor itself or a view
  of it, or pass a new tensor.

JAX's type promotion is kept where it shows: ranges given as Python numbers
make a *weakly typed* scale, so a bfloat16 ``x * scale`` is computed in
bfloat16; ranges given as arrays or tensors make a float32 scale and the
product is computed in float32.  Scales are 0-d float32 tensors on the
input's device, so no scale crosses to the host between layers.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dt_tpu_torch.ops import kernels
from dt_tpu_torch.ops.nn import same_padding

INT8_MAX = 127.0

NAMES = ("quantize", "dequantize", "requantize", "quantized_dense",
         "quantized_conv2d", "MinMaxCollector", "entropy_calibrate",
         "quantize_params")


def _is_python_number(v) -> bool:
    """JAX's weak types: Python scalars only (a numpy scalar is strong, even
    ``np.float64``, a subclass of ``float``)."""
    return type(v) in (bool, int, float)


def _f32(v, device) -> torch.Tensor:
    """``v`` as a 0-d (or shaped) float32 tensor on ``device``, as JAX's
    float32 canonicalization makes it (a float64 array rounds to float32)."""
    if isinstance(v, torch.Tensor):
        return v.detach().to(device=device, dtype=torch.float32)
    arr = np.asarray(v, dtype=np.float32)
    if arr.ndim == 0:
        return torch.full((), float(arr), dtype=torch.float32, device=device)
    return torch.from_numpy(arr.copy()).to(device)


def _scale(min_range, max_range, device) -> Tuple[torch.Tensor, bool]:
    """``127 / max(|min|, |max|, 1e-12)`` in float32 and whether it is
    weakly typed (both ranges Python numbers)."""
    if _is_python_number(min_range) and _is_python_number(max_range):
        amax = max(abs(np.float32(min_range)), abs(np.float32(max_range)),
                   np.float32(1e-12))
        scale = np.float32(INT8_MAX) / amax
        return torch.full((), float(scale), dtype=torch.float32,
                          device=device), True
    amax = torch.maximum(torch.abs(_f32(min_range, device)),
                         torch.abs(_f32(max_range, device)))
    amax = torch.maximum(amax, torch.full((), 1e-12, dtype=torch.float32,
                                          device=device))
    return torch.full((), INT8_MAX, dtype=torch.float32,
                      device=device) / amax, False


def quantize(x: torch.Tensor, min_range, max_range
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """float -> int8 with a symmetric per-tensor scale.  Returns ``(q,
    scale)`` with ``x ~ q / scale``: ``q = clip(round(x * scale), -127,
    127)``, rounding half to even.  The product is taken in ``x``'s floating
    type when the ranges are Python numbers (JAX's weak typing) and in
    float32 otherwise."""
    x = torch.as_tensor(x)
    scale, weak = _scale(min_range, max_range, x.device)
    if weak and x.is_floating_point():
        prod = x * scale.to(x.dtype)
    else:
        dtype = torch.promote_types(x.dtype, torch.float32)
        prod = x.to(dtype) * scale.to(dtype)
    q = torch.clamp(torch.round(prod), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale, dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    """``(q.to(f32) / scale).to(dtype)``."""
    return (q.to(torch.float32) / _f32(scale, q.device)).to(dtype)


def requantize(acc_int32: torch.Tensor, scale_in, scale_out) -> torch.Tensor:
    """int32 accumulator -> int8 under a new output scale: ``clip(round(
    acc / scale_in * scale_out), -127, 127)``, in float32."""
    dev = acc_int32.device
    real = acc_int32.to(torch.float32) / _f32(scale_in, dev)
    q = torch.clamp(torch.round(real * _f32(scale_out, dev)), -INT8_MAX,
                    INT8_MAX)
    return q.to(torch.int8)


def _divisor(x_scale, w_scale, device) -> torch.Tensor:
    """``x_scale * w_scale`` as a 0-d float32 tensor on ``device``: a
    product of two Python numbers is taken in double and rounded once, as
    JAX does before it sees the value; any other product in float32."""
    if _is_python_number(x_scale) and _is_python_number(w_scale):
        return torch.full((), float(np.float32(x_scale * w_scale)),
                          dtype=torch.float32, device=device)
    d = _f32(x_scale, device) * _f32(w_scale, device)
    if d.dim() != 0:
        raise ValueError(f"quantized ops take per-tensor scales, got a "
                         f"scale product of shape {tuple(d.shape)}")
    return d


def _run(xq, wq, x_scale, w_scale, stride, pads, bias, dtype, shape=None):
    """The kernel, its output reshaped to ``shape`` (NHWC when None), with
    the bias fused where it is a vector over the output channels; any other
    broadcastable bias is added after the kernel's float32 output, which is
    the same op on the same values, then cast."""
    dev = xq.device
    b32 = None if bias is None else _f32(bias, dev)
    fused = b32 is not None and b32.dim() == 1 \
        and b32.shape[0] == wq.shape[3] \
        and (shape is None or (len(shape) > 0 and shape[-1] == wq.shape[3]))
    direct = bias is None or fused
    kernel_dtype = dtype if direct and dtype in (torch.float32,
                                                 torch.bfloat16) \
        else torch.float32
    out = kernels.qconv(xq, wq, stride, pads, _divisor(x_scale, w_scale, dev),
                        b32.contiguous() if fused else None, kernel_dtype)
    if shape is not None:
        out = out.reshape(shape)
    if not direct:
        out = out + b32
    return out.to(dtype)


def quantized_dense(xq: torch.Tensor, wq: torch.Tensor, x_scale, w_scale,
                    bias: Optional[torch.Tensor] = None,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 ``xq @ wq`` with an int32 accumulator -> ``acc / (x_scale *
    w_scale) + bias`` as ``dtype``: the last axis of ``xq`` against axis 0
    of ``wq``, any rank of either (the kernel's 1x1 case over ``(M, 1, 1,
    K)``)."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"quantized_dense: xq and wq must be int8, got "
                        f"{xq.dtype} and {wq.dtype}")
    k = xq.shape[-1]
    if wq.dim() < 1 or wq.shape[0] != k:
        raise ValueError(f"quantized_dense: xq {tuple(xq.shape)} and wq "
                         f"{tuple(wq.shape)} do not contract")
    lead, tail = tuple(xq.shape[:-1]), tuple(wq.shape[1:])
    m = int(np.prod(lead, dtype=np.int64))
    n = int(np.prod(tail, dtype=np.int64))
    return _run(xq.reshape(m, 1, 1, k), wq.reshape(1, 1, k, n), x_scale,
                w_scale, (1, 1), ((0, 0), (0, 0)), bias, dtype,
                shape=lead + tail)


def _conv_pads(padding, hw, kernel, stride):
    if isinstance(padding, str):
        mode = padding.upper()
        if mode == "SAME":
            return tuple(same_padding(s, k, st)
                         for s, k, st in zip(hw, kernel, stride))
        if mode == "VALID":
            return (0, 0), (0, 0)
        raise ValueError(f"quantized_conv2d: unknown padding {padding!r}")
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    pads = tuple(tuple(int(v) for v in p) for p in padding)
    if len(pads) != 2 or any(len(p) != 2 for p in pads):
        raise ValueError(f"quantized_conv2d: padding must be an int, "
                         f"'SAME', 'VALID' or ((top, bottom), (left, "
                         f"right)), got {padding!r}")
    return pads


def quantized_conv2d(xq: torch.Tensor, wq: torch.Tensor, x_scale, w_scale,
                     stride=1, padding=0,
                     bias: Optional[torch.Tensor] = None,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """int8 NHWC ``xq`` convolved with HWIO ``wq``, int32 accumulator ->
    ``acc / (x_scale * w_scale) + bias`` as ``dtype``, NHWC.  ``stride`` is
    an int or a pair; ``padding`` an int, ``((top, bottom), (left,
    right))``, ``'SAME'`` or ``'VALID'``, as ``lax.conv_general_dilated``
    takes them."""
    if isinstance(stride, int):
        stride = (stride, stride)
    stride = tuple(int(s) for s in stride)
    xq, wq = xq.to(torch.int8), wq.to(torch.int8)
    pads = _conv_pads(padding, tuple(xq.shape[1:3]), tuple(wq.shape[:2]),
                      stride)
    return _run(xq, wq, x_scale, w_scale, stride, pads, bias, dtype)


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------


def _numpy(x) -> np.ndarray:
    """A host copy of ``x``; bfloat16 goes through float32 (numpy has no
    bfloat16)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


class MinMaxCollector:
    """Track per-tensor min/max over calibration batches (``calib_mode=
    'naive'``).  Takes tensors on any device and numpy arrays."""

    def __init__(self):
        self.ranges: Dict[str, Tuple[float, float]] = {}

    def collect(self, name: str, x) -> None:
        x = x.detach() if isinstance(x, torch.Tensor) else np.asarray(x)
        lo, hi = float(x.min()), float(x.max())
        if name in self.ranges:
            plo, phi = self.ranges[name]
            lo, hi = min(lo, plo), max(hi, phi)
        self.ranges[name] = (lo, hi)


def entropy_calibrate(samples, num_bins: int = 2048,
                      num_quantized_bins: int = 255) -> float:
    """KL-divergence-optimal |max| threshold for int8 quantization (numpy,
    as the JAX package computes it): sweep candidate thresholds, pick the
    one whose quantized distribution has minimal KL divergence from the
    clipped reference distribution."""
    samples = np.abs(_numpy(samples).ravel())
    amax = samples.max()
    if amax == 0:
        return 1e-8
    hist, edges = np.histogram(samples, bins=num_bins, range=(0, amax))
    hist = hist.astype(np.float64)
    best_kl, best_t = np.inf, amax
    # p is the clipped histogram with the saturated (outlier) mass folded
    # into its edge bin, q the int8 reconstruction built from the
    # non-outlier sliced histogram; KL runs over the clipped support only.
    for i in range(num_quantized_bins, num_bins + 1,
                   max((num_bins - num_quantized_bins) // 64, 1)):
        t = edges[i]
        sliced = hist[:i]
        if sliced.sum() == 0:
            continue
        p = sliced.copy()
        p[i - 1] += hist[i:].sum()  # int8 saturates everything beyond t
        factor = i / num_quantized_bins
        q = np.zeros(i)
        for j in range(num_quantized_bins):
            lo = int(np.floor(j * factor))
            hi = min(int(np.ceil((j + 1) * factor)), i)
            chunk = sliced[lo:hi]
            nz = (chunk > 0).sum()
            if nz:
                q[lo:hi][chunk > 0] = chunk[chunk > 0].sum() / nz
        pn = p / p.sum()
        qn = q / max(q.sum(), 1e-12)
        mask = pn > 0
        kl = float(np.sum(pn[mask] * np.log(
            pn[mask] / np.maximum(qn[mask], 1e-12))))
        if kl < best_kl:
            best_kl, best_t = kl, t
    return float(best_t)


def quantize_params(params, collector_ranges: Optional[Dict] = None):
    """Quantize a nested dict (or list, tuple) of weight tensors to int8 +
    scale: leaves of rank < 2 (biases, scales) stay float, every other leaf
    becomes ``{"q": int8, "scale": 0-d float32}`` from its own |max| (the
    weights are quantized offline; activations through calibration)."""
    def q(leaf):
        if isinstance(leaf, dict):
            return {k: q(v) for k, v in leaf.items()}
        if isinstance(leaf, (list, tuple)):
            return type(leaf)(q(v) for v in leaf)
        leaf = torch.as_tensor(leaf)
        if leaf.dim() < 2:
            return leaf
        amax = float(torch.abs(leaf).max())
        qv, scale = quantize(leaf, -amax, amax)
        return {"q": qv, "scale": scale}
    return q(params)
