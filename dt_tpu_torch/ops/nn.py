"""The layer ops the serving and training paths need, as PyTorch calls.

Counterpart of ``dt_tpu/ops/nn.py`` (``conv2d`` :58, ``max_pool2d`` :134,
``global_avg_pool2d`` :154, ``batch_norm`` :164, ``activation`` :245,
``dense`` :32).  The JAX package leaves these to XLA outside any Pallas
kernel; the port leaves them to PyTorch (cuDNN and cuBLAS on the card).
Activations are NCHW tensors in ``torch.channels_last`` memory format, so in
memory they are NHWC as in the JAX package; conv weights are OIHW, also
channels_last.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

Padding = Union[str, Sequence[Tuple[int, int]]]


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TF/XLA "SAME" padding of one spatial axis as (low, high): the total is
    split with the odd pixel on the high side, so a 3x3 stride-2 conv on an
    even input pads (0, 1), not (1, 1)."""
    total = max((math.ceil(size / stride) - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d(x: torch.Tensor, weight: torch.Tensor,
           bias: Optional[torch.Tensor] = None,
           stride: Union[int, Tuple[int, int]] = 1,
           padding: Padding = "SAME", groups: int = 1) -> torch.Tensor:
    """2-D convolution of NCHW channels_last ``x`` with OIHW ``weight``.

    ``padding`` is ``"SAME"`` or ``((top, bottom), (left, right))``.
    Symmetric padding goes to the conv itself; asymmetric padding is an
    explicit zero pad, after which the layout is restored to
    channels_last."""
    sh, sw = (stride, stride) if isinstance(stride, int) else stride
    kh, kw = weight.shape[2], weight.shape[3]
    if padding == "SAME":
        pads = (same_padding(x.shape[2], kh, sh),
                same_padding(x.shape[3], kw, sw))
    else:
        pads = tuple(tuple(p) for p in padding)
    (pt, pb), (pl, pr) = pads
    if pt == pb and pl == pr:
        return F.conv2d(x, weight, bias, (sh, sw), (pt, pl), groups=groups)
    x = F.pad(x, (pl, pr, pt, pb))
    x = x.contiguous(memory_format=torch.channels_last)
    return F.conv2d(x, weight, bias, (sh, sw), 0, groups=groups)


def max_pool2d(x: torch.Tensor, kernel: int, stride: Optional[int] = None,
               padding: int = 0) -> torch.Tensor:
    """Max pooling; padding counts as -inf, as in ``dt_tpu/ops/nn.py``."""
    return F.max_pool2d(x, kernel, stride if stride is not None else kernel,
                        padding)


def global_avg_pool2d(x: torch.Tensor) -> torch.Tensor:
    """Mean over the spatial axes, ``(N, C, H, W) -> (N, C)``."""
    return x.mean(dim=(2, 3))


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


def dense(x: torch.Tensor, weight: torch.Tensor,
          bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x @ weight.T + bias`` with ``weight`` as ``(out, in)``."""
    return F.linear(x, weight, bias)


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
