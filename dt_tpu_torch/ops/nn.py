"""The layer ops of the serving and training paths, as PyTorch calls.

Counterpart of ``dt_tpu/ops/nn.py``: every public function of that module
(``fully_connected`` :32, ``conv2d`` :58, ``deconv2d`` :92, ``max_pool2d``
:134, ``avg_pool2d`` :141, ``global_avg_pool2d`` :154, ``batch_norm`` :164,
``layer_norm`` :202, ``instance_norm`` :211, ``l2_normalize`` :220, ``lrn``
:225, ``activation`` :245, ``leaky_relu`` :263, ``prelu`` :268,
``softmax`` :273, ``log_softmax`` :280, ``dropout`` :284, ``flatten`` :304,
``concat`` :309, ``upsample_nearest`` :314, ``bilinear_resize`` :322,
``pad2d`` :328), and the ``linen.Dense``, ``linen.LayerNorm`` and
``linen.Embed`` arithmetic the models use (``dense``, ``layer_norm``,
``embedding``).  The JAX package leaves these to XLA outside any Pallas
kernel; the port leaves them to PyTorch (cuDNN and cuBLAS on the card).

Layouts: activations are NCHW tensors in ``torch.channels_last`` memory
format, so in memory they are NHWC as in the JAX package, and every image
op here keeps that format; the channel axis is 1 where the JAX package's
is -1 (``concat``, ``lrn``, ``prelu``, ``instance_norm``).  Weights are in
the port's layout (``interchange``): a conv or deconv kernel OIHW (the JAX
HWIO kernel permuted), also channels_last, a dense or fully-connected
weight ``(out, in)``.  ``flatten`` flattens in NHWC order, as the JAX
package's flatten of an NHWC array does, so a JAX dense kernel after it
carries over unchanged.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

Padding = Union[str, int, Sequence[Tuple[int, int]]]
_CL = torch.channels_last


def _pair(v) -> Tuple[int, int]:
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF/XLA "SAME" padding of one spatial axis as (low, high): the total is
    split with the odd pixel on the high side, so a 3x3 stride-2 conv on an
    even input pads (0, 1), not (1, 1)."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pads(padding: Padding, hw: Tuple[int, int], kernel: Tuple[int, int],
          stride: Tuple[int, int]) -> Tuple[Tuple[int, int], ...]:
    """``((top, bottom), (left, right))`` of ``padding``: ``"SAME"``,
    ``"VALID"``, an int or ``(ph, pw)`` (symmetric), or explicit pairs."""
    if isinstance(padding, str):
        if padding == "SAME":
            return tuple(same_padding(s, k, st)
                         for s, k, st in zip(hw, kernel, stride))
        if padding == "VALID":
            return (0, 0), (0, 0)
        raise ValueError(f"unknown padding {padding!r}")
    if isinstance(padding, int):
        return (padding, padding), (padding, padding)
    a, b = padding
    if isinstance(a, int):
        return (a, a), (b, b)
    return tuple(tuple(p) for p in (a, b))


def fully_connected(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor] = None,
                    flatten: bool = True) -> torch.Tensor:
    """Dense layer with ``weight`` as ``(out, in)`` (the JAX ``(in, out)``
    transposed); with ``flatten`` the dims past the batch are collapsed
    first, an image's in NHWC order (:func:`flatten`)."""
    if flatten and x.dim() > 2:
        x = _flatten(x)
    return F.linear(x, weight, bias)


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None,
           stride: Union[int, Tuple[int, int]] = 1,
           padding: Padding = "SAME", groups: int = 1,
           dilation: Union[int, Tuple[int, int]] = 1) -> torch.Tensor:
    """2-D convolution of NCHW channels_last ``x`` with OIHW ``weight``
    (``(out, in / groups, kh, kw)``; depthwise is ``groups == C``).

    ``padding`` is ``"SAME"``, ``"VALID"``, an int, ``(ph, pw)`` or
    ``((top, bottom), (left, right))``.  Symmetric padding goes to the conv
    itself; asymmetric padding is an explicit zero pad, after which the
    layout is restored to channels_last."""
    sh, sw = _pair(stride)
    dh, dw = _pair(dilation)
    kh = (weight.shape[2] - 1) * dh + 1
    kw = (weight.shape[3] - 1) * dw + 1
    (pt, pb), (pl, pr) = _pads(padding, x.shape[2:], (kh, kw), (sh, sw))
    if pt == pb and pl == pr:
        return F.conv2d(x, weight, bias, (sh, sw), (pt, pl), (dh, dw),
                        groups)
    x = F.pad(x, (pl, pr, pt, pb)).contiguous(memory_format=_CL)
    return F.conv2d(x, weight, bias, (sh, sw), 0, (dh, dw), groups)


def deconv2d(x: torch.Tensor, weight: torch.Tensor,
             bias: Optional[torch.Tensor] = None,
             stride: Union[int, Tuple[int, int]] = 1,
             padding: Union[int, Tuple[int, int]] = 0,
             groups: int = 1) -> torch.Tensor:
    """Transposed convolution, as the JAX package's (a conv of the
    stride-dilated input with the flipped kernel, padded ``k - 1 - p``):
    output side ``(H - 1) * stride - 2 * padding + k``.  ``weight`` is the
    JAX ``(kh, kw, in / groups, out)`` kernel in the port's conv layout,
    ``(out, in / groups, kh, kw)``; it is regrouped into
    ``conv_transpose2d``'s ``(in, out / groups, kh, kw)``."""
    out, cin_g, kh, kw = weight.shape
    w = weight.reshape(groups, out // groups, cin_g, kh, kw) \
        .transpose(1, 2).reshape(groups * cin_g, out // groups, kh, kw)
    return F.conv_transpose2d(x, w, bias, _pair(stride), _pair(padding),
                              groups=groups)


def _pool_pad(x: torch.Tensor, padding, kernel, stride, value: float):
    """``x`` padded explicitly with ``value`` when ``padding`` is not one
    ``F.*_pool2d`` takes itself (asymmetric, "SAME", or past half the
    window); returns ``(x, symmetric padding for the pool)``."""
    (pt, pb), (pl, pr) = _pads(padding, x.shape[2:], kernel, stride)
    if pt == pb and pl == pr and 2 * pt <= kernel[0] and 2 * pl <= kernel[1]:
        return x, (pt, pl)
    x = F.pad(x, (pl, pr, pt, pb), value=value)
    return x.contiguous(memory_format=_CL), (0, 0)


def max_pool2d(x: torch.Tensor, kernel, stride=None,
               padding: Padding = 0) -> torch.Tensor:
    """Max pooling (``padding`` as for :func:`conv2d`); padding counts as
    -inf, as ``lax.reduce_window`` pads the JAX package's."""
    k = _pair(kernel)
    s = _pair(stride if stride is not None else kernel)
    x, p = _pool_pad(x, padding, k, s, float("-inf"))
    return F.max_pool2d(x, k, s, p)


def avg_pool2d(x: torch.Tensor, kernel, stride=None, padding: Padding = 0,
               count_include_pad: bool = True) -> torch.Tensor:
    """Average pooling: the window's sum over ``kh * kw`` with zero padding
    (``count_include_pad``, and whenever ``padding`` is the int 0), else
    over the window's count of unpadded elements."""
    k = _pair(kernel)
    s = _pair(stride if stride is not None else kernel)
    if isinstance(padding, int) and padding == 0:
        count_include_pad = True
    padded, p = _pool_pad(x, padding, k, s, 0.0)
    if padded is x:
        return F.avg_pool2d(x, k, s, p, count_include_pad=count_include_pad)
    summed = F.avg_pool2d(padded, k, s, divisor_override=1)
    if count_include_pad:
        return summed / (k[0] * k[1])
    ones = _pool_pad(torch.ones_like(x[:, :1]), padding, k, s, 0.0)[0]
    return summed / F.avg_pool2d(ones, k, s, divisor_override=1)


def global_avg_pool2d(x: torch.Tensor) -> torch.Tensor:
    """Mean over the spatial axes, ``(N, C, H, W) -> (N, C)`` (the JAX
    package keeps them as ``(N, 1, 1, C)``)."""
    return x.mean(dim=(2, 3))


def batch_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               moving_mean: torch.Tensor, moving_var: torch.Tensor, *,
               training: bool, momentum: float = 0.9, eps: float = 1e-5,
               axis: int = 1) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Functional BatchNorm, plain PyTorch (the models use the kernels of
    ``ops.kernels`` instead).  ``axis`` is the channel axis, 1 for the
    port's NCHW tensors (the JAX default -1 is NHWC's).  Training mode takes
    the batch's f32 mean and biased variance and moves the running stats to
    ``moving * momentum + batch * (1 - momentum)``; eval mode uses and
    returns the moving stats.  Returns ``(y, new_mean, new_var)``."""
    ax = axis % x.dim()
    reduce_axes = tuple(i for i in range(x.dim()) if i != ax)
    if training:
        x32 = x.float()
        mean = x32.mean(dim=reduce_axes)
        var = x32.var(dim=reduce_axes, unbiased=False)
        new_mean = moving_mean * momentum + mean * (1.0 - momentum)
        new_var = moving_var * momentum + var * (1.0 - momentum)
    else:
        mean, var = moving_mean, moving_var
        new_mean, new_var = moving_mean, moving_var
    shape = [1] * x.dim()
    shape[ax] = x.shape[ax]
    inv = torch.rsqrt(var + eps) * gamma
    y = (x - mean.reshape(shape).to(x.dtype)) \
        * inv.reshape(shape).to(x.dtype) + beta.reshape(shape).to(x.dtype)
    return y, new_mean, new_var


LN_EPS = 1e-6  # linen.LayerNorm's default epsilon (torch's is 1e-5)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = LN_EPS) -> torch.Tensor:
    """LayerNorm over the last axis as ``linen.LayerNorm`` computes it: mean
    and ``var = max(E[x^2] - mean^2, 0)`` in f32 whatever ``x``'s dtype,
    ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` in f32, then
    the result in ``x``'s dtype.  ``scale``/``bias`` are f32 ``(D,)``."""
    x32 = x.float()
    mean = x32.mean(-1, keepdim=True)
    var = torch.clamp((x32 * x32).mean(-1, keepdim=True) - mean * mean,
                      min=0.0)
    mul = torch.rsqrt(var + eps) * scale.float()
    return ((x32 - mean) * mul + bias.float()).to(x.dtype)


def _per_channel(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A ``(C,)`` tensor shaped to broadcast over NCHW ``x``'s channels."""
    return t.reshape((1, -1) + (1,) * (x.dim() - 2)) if t.dim() == 1 else t


def instance_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  eps: float = 1e-5) -> torch.Tensor:
    """Instance norm: each sample's channel over its spatial axes, f32
    mean and biased variance, ``gamma``/``beta`` ``(C,)``; the result in
    ``x``'s dtype."""
    x32 = x.float()
    mean = x32.mean(dim=(2, 3), keepdim=True)
    var = x32.var(dim=(2, 3), keepdim=True, unbiased=False)
    y = (x32 - mean) * torch.rsqrt(var + eps)
    return (y * _per_channel(gamma, x) + _per_channel(beta, x)).to(x.dtype)


def l2_normalize(x: torch.Tensor, axis: int = -1,
                 eps: float = 1e-10) -> torch.Tensor:
    """``x / sqrt(sum(x^2) + eps)`` along ``axis``, the sum in f32."""
    norm = torch.sqrt(x.float().square().sum(dim=axis, keepdim=True) + eps)
    return x / norm.to(x.dtype)


def lrn(x: torch.Tensor, nsize: int = 5, alpha: float = 1e-4,
        beta: float = 0.75, knorm: float = 2.0) -> torch.Tensor:
    """Local response normalization across the channels (axis 1):
    ``x * (knorm + alpha * win / nsize) ** -beta``, ``win`` the f32 sum of
    the squares over the ``nsize`` channels centred on each (zero past
    the ends), added in the JAX package's order; the factor is cast to
    ``x``'s dtype before the product."""
    c = x.shape[1]
    pad = nsize // 2
    sq = F.pad(x.float().square(), (0, 0, 0, 0, pad, pad))
    win = 0
    for i in range(nsize):
        win = win + sq[:, i:i + c]
    factor = torch.pow(knorm + alpha * win / nsize, -beta).to(x.dtype)
    y = x * factor
    return y.contiguous(memory_format=_CL) if x.dim() == 4 else y


def activation(x: torch.Tensor, act_type: str) -> torch.Tensor:
    """Activation by the reference's act_type strings."""
    if act_type == "relu":
        return torch.relu(x)
    if act_type == "sigmoid":
        return torch.sigmoid(x)
    if act_type == "tanh":
        return torch.tanh(x)
    if act_type == "softrelu":
        return F.softplus(x)
    if act_type == "softsign":
        return F.softsign(x)
    if act_type == "gelu":
        return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default
    raise ValueError(f"unknown act_type {act_type!r}")


def leaky_relu(x: torch.Tensor, slope: float = 0.25) -> torch.Tensor:
    """``x`` where ``x >= 0``, else ``slope * x``."""
    return torch.where(x >= 0, x, slope * x)


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """``x`` where ``x >= 0``, else ``alpha * x``; a ``(C,)`` ``alpha``
    scales channel axis 1."""
    return torch.where(x >= 0, x, _per_channel(alpha, x) * x)


def softmax(x: torch.Tensor, axis: int = -1,
            temperature: float = 1.0) -> torch.Tensor:
    if temperature != 1.0:
        x = x / temperature
    return torch.softmax(x, dim=axis)


def log_softmax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return torch.log_softmax(x, dim=axis)


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight.T + bias`` with ``weight`` as ``(out, in)``."""
    return F.linear(x, weight, bias)


def embedding(tokens: torch.Tensor, table: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
    """Rows of ``table`` (``(V, D)``, f32) for integer ``tokens``, the table
    cast to the compute ``dtype`` first, as ``linen.Embed`` does."""
    return F.embedding(tokens, table.to(dtype))


def draw_dropout_mask(shape, keep: float,
                      generator: Optional[torch.Generator],
                      device: torch.device) -> torch.Tensor:
    """Dropout's one Bernoulli(``keep``) draw: a bool mask of ``shape``,
    the JAX package's shape of the tensor (NHWC for an image), on
    ``device``, from ``generator``.  The JAX package draws
    ``jax.random.bernoulli`` from its ``dropout`` stream instead: the same
    law, another stream (tests replace this function with JAX's masks)."""
    return torch.rand(tuple(shape), generator=generator,
                      device=device) < keep


def dropout(x: torch.Tensor, rate: float, *, training: bool,
            generator: Optional[torch.Generator] = None,
            mode: str = "training") -> torch.Tensor:
    """Inverted dropout (``dt_tpu/ops/nn.py:284-296``): keep each element
    with probability ``1 - rate`` and scale it by ``1 / (1 - rate)``.  The
    mask comes from :func:`draw_dropout_mask` with ``generator`` (on ``x``'s
    device), drawn in the JAX layout (an image's NHWC), so its bits are not
    the JAX package's; only the keep rate and the scale match.  Identity at
    rate 0, and when not training unless ``mode == "always"``; an active
    dropout without a generator raises, as the JAX op does without an rng
    key."""
    if rate <= 0.0 or (not training and mode != "always"):
        return x
    if generator is None:
        raise ValueError("dropout is active (training=True or "
                         "mode='always') and requires a torch.Generator")
    keep = 1.0 - rate
    if x.dim() == 4:
        n, c, h, w = x.shape
        mask = draw_dropout_mask((n, h, w, c), keep, generator, x.device)
        mask = mask.permute(0, 3, 1, 2)
    else:
        mask = draw_dropout_mask(x.shape, keep, generator, x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x))


def flatten(x: torch.Tensor) -> torch.Tensor:
    """Collapse the dims past the batch; an NCHW image in (H, W, C) order,
    as the JAX package's flatten of NHWC (a view for a channels_last
    tensor)."""
    if x.dim() == 4:
        return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return x.reshape(x.shape[0], -1)


_flatten = flatten  # for fully_connected, whose argument shadows the name


def concat(xs: Sequence[torch.Tensor], axis: int = 1) -> torch.Tensor:
    """Concatenate on ``axis``, the channels (1) by default; channels_last
    inputs give a channels_last result."""
    return torch.cat(list(xs), dim=axis)


def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Nearest-neighbour upsampling of the spatial axes by an int
    ``scale``: each pixel repeated ``scale x scale``."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def bilinear_resize(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize to ``(out_h, out_w)`` with half-pixel centres,
    antialiased when it shrinks an axis (``jax.image.resize``'s
    "bilinear": a triangle kernel widened by the scale)."""
    shrink = out_h < x.shape[2] or out_w < x.shape[3]
    return F.interpolate(x, size=(out_h, out_w), mode="bilinear",
                         align_corners=False, antialias=shrink)


def pad2d(x: torch.Tensor, pad_width: Tuple[int, int, int, int],
          mode: str = "constant", value: float = 0.0) -> torch.Tensor:
    """Pad the spatial axes by ``(top, bottom, left, right)``:
    ``"constant"`` (``value``), ``"edge"`` (the border repeated) or
    ``"reflect"`` (mirrored without the border)."""
    t, b, l, r = pad_width
    if mode == "constant":
        y = F.pad(x, (l, r, t, b), value=value)
    elif mode == "edge":
        y = F.pad(x, (l, r, t, b), mode="replicate")
    elif mode == "reflect":
        y = F.pad(x, (l, r, t, b), mode="reflect")
    else:
        raise ValueError(mode)
    return y.contiguous(memory_format=_CL)
