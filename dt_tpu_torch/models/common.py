"""Shared building blocks for the port's model zoo (counterpart of
``dt_tpu/models/common.py``).

Modules are named after the JAX modules they replace, and a model names its
submodules as the JAX side auto-names them (``Conv_0``, ``BatchNorm_0``, ...),
so ``dt_tpu_torch.interchange`` maps a JAX variable path onto a port tensor
by name.  Every parameter is a float32 ``nn.Parameter``, as in the JAX
models; Conv and Dense cast theirs to the compute ``dtype`` at each call, as
the JAX models do, so a bfloat16 step updates float32 masters.  BatchNorm
variables stay float32, and the kernels' scale and bias are computed from
them in float32 and cast once.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from dt_tpu_torch.ops import kernels
from dt_tpu_torch.ops import nn as nn_ops

# Running-stat convention of the reference (moving = moving*momentum +
# batch*(1-momentum), src/operator/nn/batch_norm.cc).
BN_MOMENTUM = 0.9
BN_EPS = 1e-5


class FusedBatchNorm(nn.Module):
    """BatchNorm through the CUDA kernels, with the ReLU that follows it
    fused in when ``relu`` is set.  Eval: ``ops.kernels.fused_bn_inference``
    on the running stats.  Training: ``ops.kernels.fused_bn_train`` on the
    batch's stats, which moves the running stats in place.  Variables match
    the JAX side: params ``scale``/``bias``, buffers (JAX ``batch_stats``)
    ``mean``/``var``, all float32."""

    def __init__(self, features: int, *, epsilon: float = BN_EPS,
                 relu: bool = False):
        super().__init__()
        self.epsilon = epsilon
        self.relu = relu
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        if training:
            return kernels.fused_bn_train(
                x, self.scale, self.bias, self.mean, self.var,
                momentum=BN_MOMENTUM, eps=self.epsilon, relu=self.relu)[0]
        return kernels.fused_bn_inference(x, self.scale, self.bias, self.mean,
                                          self.var, eps=self.epsilon,
                                          relu=self.relu)


def bn(features: int, relu: bool = False) -> FusedBatchNorm:
    """The one BatchNorm construction every model uses (keeps momentum/eps
    in one place).  The port has one BatchNorm, the kernels'."""
    return FusedBatchNorm(features, epsilon=BN_EPS, relu=relu)


class Conv(nn.Module):
    """``linen.Conv`` as the models use it (no bias): f32 OIHW weight in
    channels_last (the JAX HWIO kernel, carried over by ``interchange``),
    cast to ``dtype`` at each call; TF padding."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1),
                 padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
                 groups: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.strides = tuple(strides)
        self.padding = padding
        self.groups = groups
        self.dtype = dtype
        w = torch.zeros(features, in_features // groups, *kernel)
        self.weight = nn.Parameter(w.to(memory_format=torch.channels_last))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn_ops.conv2d(x, self.weight.to(self.dtype), None,
                             self.strides, self.padding, self.groups)


class Dense(nn.Module):
    """``linen.Dense``: f32 weight ``(out, in)`` (the JAX ``(in, out)``
    kernel, transposed by ``interchange``) and bias, cast to ``dtype`` at
    each call."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.zeros(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn_ops.dense(x, self.weight.to(self.dtype),
                            self.bias.to(self.dtype))


class ConvBN(nn.Module):
    """Conv -> BN -> activation; a ReLU is fused into the BN kernel."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int] = (3, 3),
                 strides: Tuple[int, int] = (1, 1),
                 padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
                 act: Optional[str] = "relu", groups: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.act = act
        self.Conv_0 = Conv(in_features, features, kernel, strides, padding,
                           groups=groups, dtype=dtype)
        self.BatchNorm_0 = bn(features, relu=act == "relu")

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x), training)
        if self.act is not None and self.act != "relu":
            x = nn_ops.activation(x, self.act)
        return x
