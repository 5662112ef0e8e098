"""Shared building blocks for the port's model zoo (counterpart of
``dt_tpu/models/common.py``).

Modules are named after the JAX modules they replace, and a model names its
submodules as the JAX side auto-names them (``Conv_0``, ``BatchNorm_0``, ...),
so ``dt_tpu_torch.interchange`` maps a JAX variable path onto a port tensor
by name.  Conv and Dense weights are kept in the compute dtype (the JAX
models cast them to ``dtype`` for every call); BatchNorm variables stay
float32, and the kernel's scale and bias are computed from them in float32
and cast once.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
from torch import nn

from dt_tpu_torch.ops import kernels
from dt_tpu_torch.ops import nn as nn_ops

# Running-stat convention of the reference (moving = moving*momentum +
# batch*(1-momentum)); the momentum waits for the training slice, which
# ports training-mode BatchNorm.
BN_MOMENTUM = 0.9
BN_EPS = 1e-5


class FusedBatchNorm(nn.Module):
    """Eval BatchNorm through the CUDA kernel ``ops.kernels.
    fused_bn_inference``, with the ReLU that follows it fused in when
    ``relu`` is set.  Variables match the JAX side: params ``scale``/``bias``,
    buffers (JAX ``batch_stats``) ``mean``/``var``, all float32."""

    def __init__(self, features: int, *, epsilon: float = BN_EPS,
                 relu: bool = False):
        super().__init__()
        self.epsilon = epsilon
        self.relu = relu
        self.scale = nn.Parameter(torch.ones(features), requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features), requires_grad=False)
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: torch.Tensor, training: bool = False) -> torch.Tensor:
        if training:
            raise NotImplementedError(
                "training-mode BatchNorm (the fused_bn_train kernel) comes "
                "with the port's training slice; this slice serves only")
        return kernels.fused_bn_inference(x, self.scale, self.bias, self.mean,
                                          self.var, eps=self.epsilon,
                                          relu=self.relu)


def bn(features: int, relu: bool = False) -> FusedBatchNorm:
    """The one BatchNorm construction every model uses (keeps momentum/eps
    in one place).  The port has one BatchNorm, the kernel's."""
    return FusedBatchNorm(features, epsilon=BN_EPS, relu=relu)


class Conv(nn.Module):
    """``linen.Conv`` as the models use it (no bias): OIHW weight in
    channels_last (the JAX HWIO kernel, carried over by ``interchange``),
    TF padding."""

    def __init__(self, in_features: int, features: int,
                 kernel: Tuple[int, int],
                 strides: Tuple[int, int] = (1, 1),
                 padding: Union[str, Sequence[Tuple[int, int]]] = "SAME",
                 groups: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.strides = tuple(strides)
        self.padding = padding
        self.groups = groups
        w = torch.zeros(features, in_features // groups, *kernel, dtype=dtype)
        self.weight = nn.Parameter(w.to(memory_format=torch.channels_last),
                                   requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn_ops.conv2d(x, self.weight, None, self.strides,
                             self.padding, self.groups)


class Dense(nn.Module):
    """``linen.Dense``: weight ``(out, in)`` (the JAX ``(in, out)`` kernel,
    transposed by ``interchange``) and bias, in the compute dtype."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(features, in_features,
                                               dtype=dtype),
                                   requires_grad=False)
        self.bias = nn.Parameter(torch.zeros(features, dtype=dtype),
                                 requires_grad=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn_ops.dense(x, self.weight, self.bias)


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
