"""MobileNet v1 (depthwise-separable) and v2 (inverted residuals)
(counterpart of ``dt_tpu/models/mobilenet.py``).  A depthwise conv is a
``ConvBN`` of ``groups=C`` (weight ``(C, 1, 3, 3)`` channels_last), its
stride-2 "SAME" padding (0, 1) on an even input; v2's projection has no
activation, and a block adds its input when the shapes match.  Widths are
``max(8, int(f * multiplier))``."""

from __future__ import annotations

import torch

from dt_tpu_torch.models.common import Numbered, chain
from dt_tpu_torch.ops import nn as ops


def _width(multiplier: float):
    return lambda f: max(8, int(f * multiplier))


class DWSep(Numbered):
    """Depthwise 3x3 + pointwise 1x1, both BN + ReLU (the v1 block)."""

    def __init__(self, cin: int, features: int, strides: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.convs = [self.conv_bn(cin, cin, (3, 3), (strides, strides),
                                   groups=cin),
                      self.conv_bn(cin, features, (1, 1))]

    def forward(self, x, training: bool = False):
        return chain(self.convs, x, training)


_V1 = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2), (512, 1),
       (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2), (1024, 1)]


class MobileNetV1(Numbered):
    def __init__(self, num_classes: int = 1000, multiplier: float = 1.0,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3):
        super().__init__(dtype)
        c = _width(multiplier)
        self.layers = [self.conv_bn(in_channels, c(32), (3, 3), (2, 2))]
        cin = c(32)
        for f, s in _V1:
            self.layers.append(self.numbered("DWSep",
                                             DWSep(cin, c(f), s, dtype)))
            cin = c(f)
        self.dense(cin, num_classes)

    def forward(self, x, training: bool = False):
        return self.Dense_0(ops.global_avg_pool2d(
            chain(self.layers, x, training)))


class InvertedResidual(Numbered):
    def __init__(self, cin: int, features: int, strides: int = 1,
                 expand: int = 6, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        hidden = cin * expand
        self.convs = []
        if expand != 1:
            self.convs.append(self.conv_bn(cin, hidden, (1, 1)))
        self.convs.append(self.conv_bn(hidden, hidden, (3, 3),
                                       (strides, strides), groups=hidden))
        self.convs.append(self.conv_bn(hidden, features, (1, 1), act=None))
        self.residual = strides == 1 and cin == features

    def forward(self, x, training: bool = False):
        y = chain(self.convs, x, training)
        return x + y if self.residual else y


# (expand, out, repeats, stride)
_V2 = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
       (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]


class MobileNetV2(Numbered):
    def __init__(self, num_classes: int = 1000, multiplier: float = 1.0,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3):
        super().__init__(dtype)
        c = _width(multiplier)
        self.layers = [self.conv_bn(in_channels, c(32), (3, 3), (2, 2))]
        cin = c(32)
        for t, f, n, s in _V2:
            for i in range(n):
                self.layers.append(self.numbered(
                    "InvertedResidual",
                    InvertedResidual(cin, c(f), s if i == 0 else 1, t,
                                     dtype)))
                cin = c(f)
        last = c(1280) if multiplier <= 1.0 else int(1280 * multiplier)
        self.layers.append(self.conv_bn(cin, last, (1, 1)))
        self.dense(last, num_classes)

    def forward(self, x, training: bool = False):
        return self.Dense_0(ops.global_avg_pool2d(
            chain(self.layers, x, training)))
