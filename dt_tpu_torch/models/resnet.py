"""ResNet v1/v2 (ImageNet) and CIFAR ResNet, eval and training forward
(counterpart of ``dt_tpu/models/resnet.py``).

Submodules are created, and named, in the order the JAX models create them, so
every name is the JAX variable path of the same layer (the order
``dt_tpu/interchange.py:130-181`` spells out).  Inputs are NCHW in
``torch.channels_last`` memory format and in the model's compute dtype.  A
ReLU that follows a BatchNorm is fused into the BN kernels (in training, the
BN's backward applies the ReLU's mask); the ReLU after a residual add stays a
PyTorch call.  ``forward(x, training=True)`` runs training-mode BatchNorm,
which moves the running stats in place.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from dt_tpu_torch.models.common import Conv, Dense, bn
from dt_tpu_torch.ops import nn as ops


class BasicBlockV1(nn.Module):
    def __init__(self, in_features: int, features: int,
                 strides: Tuple[int, int] = (1, 1), downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.downsample = downsample
        self.Conv_0 = Conv(in_features, features, (3, 3), strides, dtype=dtype)
        self.BatchNorm_0 = bn(features, relu=True)
        self.Conv_1 = Conv(features, features, (3, 3), dtype=dtype)
        self.BatchNorm_1 = bn(features)
        if downsample:
            self.Conv_2 = Conv(in_features, features, (1, 1), strides,
                               dtype=dtype)
            self.BatchNorm_2 = bn(features)

    def forward(self, x, training: bool = False):
        y = self.BatchNorm_0(self.Conv_0(x), training)
        y = self.BatchNorm_1(self.Conv_1(y), training)
        residual = x
        if self.downsample:
            residual = self.BatchNorm_2(self.Conv_2(x), training)
        return torch.relu(y + residual)


class BottleneckV1(nn.Module):
    """``features`` is the bottleneck width; the output is 4x."""

    def __init__(self, in_features: int, features: int,
                 strides: Tuple[int, int] = (1, 1), downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.downsample = downsample
        self.Conv_0 = Conv(in_features, features, (1, 1), dtype=dtype)
        self.BatchNorm_0 = bn(features, relu=True)
        self.Conv_1 = Conv(features, features, (3, 3), strides, dtype=dtype)
        self.BatchNorm_1 = bn(features, relu=True)
        self.Conv_2 = Conv(features, features * 4, (1, 1), dtype=dtype)
        self.BatchNorm_2 = bn(features * 4)
        if downsample:
            self.Conv_3 = Conv(in_features, features * 4, (1, 1), strides,
                               dtype=dtype)
            self.BatchNorm_3 = bn(features * 4)

    def forward(self, x, training: bool = False):
        y = self.BatchNorm_0(self.Conv_0(x), training)
        y = self.BatchNorm_1(self.Conv_1(y), training)
        y = self.BatchNorm_2(self.Conv_2(y), training)
        residual = x
        if self.downsample:
            residual = self.BatchNorm_3(self.Conv_3(x), training)
        return torch.relu(y + residual)


class BasicBlockV2(nn.Module):
    """Pre-activation block; the shortcut conv, when there is one, is the
    block's first conv in the JAX creation order."""

    def __init__(self, in_features: int, features: int,
                 strides: Tuple[int, int] = (1, 1), downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.downsample = downsample
        self.BatchNorm_0 = bn(in_features, relu=True)
        o = 0
        if downsample:
            self.Conv_0 = Conv(in_features, features, (1, 1), strides,
                               dtype=dtype)
            o = 1
        self.conv_a = f"Conv_{o}"
        self.conv_b = f"Conv_{o + 1}"
        self.add_module(self.conv_a, Conv(in_features, features, (3, 3),
                                          strides, dtype=dtype))
        self.BatchNorm_1 = bn(features, relu=True)
        self.add_module(self.conv_b, Conv(features, features, (3, 3),
                                          dtype=dtype))

    def forward(self, x, training: bool = False):
        y = self.BatchNorm_0(x, training)
        residual = self.Conv_0(y) if self.downsample else x
        y = self.BatchNorm_1(getattr(self, self.conv_a)(y), training)
        y = getattr(self, self.conv_b)(y)
        return y + residual


class BottleneckV2(nn.Module):
    def __init__(self, in_features: int, features: int,
                 strides: Tuple[int, int] = (1, 1), downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.downsample = downsample
        self.BatchNorm_0 = bn(in_features, relu=True)
        o = 0
        if downsample:
            self.Conv_0 = Conv(in_features, features * 4, (1, 1), strides,
                               dtype=dtype)
            o = 1
        self.convs = [f"Conv_{o + i}" for i in range(3)]
        self.add_module(self.convs[0], Conv(in_features, features, (1, 1),
                                            dtype=dtype))
        self.BatchNorm_1 = bn(features, relu=True)
        self.add_module(self.convs[1], Conv(features, features, (3, 3),
                                            strides, dtype=dtype))
        self.BatchNorm_2 = bn(features, relu=True)
        self.add_module(self.convs[2], Conv(features, features * 4, (1, 1),
                                            dtype=dtype))

    def forward(self, x, training: bool = False):
        c0, c1, c2 = (getattr(self, n) for n in self.convs)
        y = self.BatchNorm_0(x, training)
        residual = self.Conv_0(y) if self.downsample else x
        y = self.BatchNorm_1(c0(y), training)
        y = self.BatchNorm_2(c1(y), training)
        return c2(y) + residual


_SPECS = {
    18: ("basic", [2, 2, 2, 2]),
    34: ("basic", [3, 4, 6, 3]),
    50: ("bottleneck", [3, 4, 6, 3]),
    101: ("bottleneck", [3, 4, 23, 3]),
    152: ("bottleneck", [3, 8, 36, 3]),
}
_FILTERS = [64, 128, 256, 512]


class ResNet(nn.Module):
    def __init__(self, depth: int = 50, num_classes: int = 1000,
                 version: int = 1, dtype: torch.dtype = torch.float32,
                 in_channels: int = 3):
        super().__init__()
        block_type, stages = _SPECS[depth]
        if version == 1:
            block = BasicBlockV1 if block_type == "basic" else BottleneckV1
        else:
            block = BasicBlockV2 if block_type == "basic" else BottleneckV2
        self.version = version
        self.Conv_0 = Conv(in_channels, 64, (7, 7), (2, 2),
                           padding=[(3, 3), (3, 3)], dtype=dtype)
        if version == 1:
            self.BatchNorm_0 = bn(64, relu=True)
        expansion = 1 if block_type == "basic" else 4
        in_features = 64
        self.blocks = []
        for stage, (nblk, f) in enumerate(zip(stages, _FILTERS)):
            for i in range(nblk):
                strides = (2, 2) if (i == 0 and stage > 0) else (1, 1)
                down = (i == 0) and (strides != (1, 1) or
                                     in_features != f * expansion)
                name = f"{block.__name__}_{len(self.blocks)}"
                self.add_module(name, block(in_features, f, strides, down,
                                            dtype))
                self.blocks.append(name)
                in_features = f * expansion
        if version == 2:
            self.BatchNorm_0 = bn(in_features, relu=True)
        self.Dense_0 = Dense(in_features, num_classes, dtype)

    def forward(self, x, training: bool = False):
        x = self.Conv_0(x)
        if self.version == 1:
            x = self.BatchNorm_0(x, training)
        x = ops.max_pool2d(x, 3, 2, padding=1)
        for name in self.blocks:
            x = getattr(self, name)(x, training)
        if self.version == 2:
            x = self.BatchNorm_0(x, training)
        return self.Dense_0(ops.global_avg_pool2d(x))


class CifarResNet(nn.Module):
    """6n+2 CIFAR ResNet (20/56/110) of pre-activation blocks.

    ``stochastic_depth`` is the death rate of the deepest block, ramping
    linearly over the blocks; in eval an identity-shortcut block's residual
    branch is scaled by its survival probability (``resnet.py:232-234``).
    Training with ``stochastic_depth > 0`` samples from JAX's RNG in the
    reference (``resnet.py:224-231``) and is not ported yet (ROADMAP, Queue
    1 item 2); with 0 it trains."""

    def __init__(self, depth: int = 20, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3,
                 stochastic_depth: float = 0.0):
        super().__init__()
        if (depth - 2) % 6 != 0:
            raise ValueError("CIFAR ResNet depth must be 6n+2")
        n = (depth - 2) // 6
        self.stochastic_depth = stochastic_depth
        self.Conv_0 = Conv(in_channels, 16, (3, 3), dtype=dtype)
        in_f = 16
        self.blocks = []  # (name, eval scale of the residual branch or None)
        total = 3 * n
        for stage, f in enumerate([16, 32, 64]):
            for i in range(n):
                strides = (2, 2) if (i == 0 and stage > 0) else (1, 1)
                down = (i == 0) and (strides != (1, 1) or in_f != f)
                idx = len(self.blocks)
                name = f"BasicBlockV2_{idx}"
                self.add_module(name, BasicBlockV2(in_f, f, strides, down,
                                                   dtype))
                keep = None
                if stochastic_depth > 0 and not down:
                    keep = 1.0 - stochastic_depth * (idx + 1) / total
                self.blocks.append((name, keep))
                in_f = f
        self.BatchNorm_0 = bn(in_f, relu=True)
        self.Dense_0 = Dense(in_f, num_classes, dtype)

    def forward(self, x, training: bool = False):
        if training and self.stochastic_depth > 0:
            raise NotImplementedError(
                "CifarResNet training with stochastic_depth > 0 (per-block "
                "Bernoulli sampling) is not ported yet; see ROADMAP.md, "
                "Queue 1 item 2")
        x = self.Conv_0(x)
        for name, keep in self.blocks:
            y = getattr(self, name)(x, training)
            # y == x + F(x) for identity-shortcut blocks: scale F(x) only
            x = y if keep is None else x + keep * (y - x)
        x = self.BatchNorm_0(x, training)
        return self.Dense_0(ops.global_avg_pool2d(x))
