"""ResNeXt 50/101/152, cardinality 32, 4d (counterpart of
``dt_tpu/models/resnext.py``): bottlenecks whose 3x3 is a grouped conv
(``groups=cardinality``, weight ``(F, F / 32, 3, 3)`` channels_last), BN on
the kernels after each conv (the ReLU fused in where the JAX block applies
one right after), the ReLU after the residual add a PyTorch call.  The BNs
are the blocks' own, numbered as the JAX block's ``_bn`` calls."""

from __future__ import annotations

from typing import Tuple

import torch

from dt_tpu_torch.models.common import Numbered
from dt_tpu_torch.ops import nn as ops

_SPECS = {
    50: [3, 4, 6, 3],
    101: [3, 4, 23, 3],
    152: [3, 8, 36, 3],
}
_FILTERS = [128, 256, 512, 1024]  # group-conv width (cardinality 32, 4d)


class ResNeXtBlock(Numbered):
    """``features`` is the grouped conv's width; the output is 2x."""

    def __init__(self, cin: int, features: int, cardinality: int = 32,
                 strides: Tuple[int, int] = (1, 1), downsample: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        f = features
        self.path = [(self.conv(cin, f, (1, 1), use_bias=False),
                      self.batch_norm(f, relu=True)),
                     (self.conv(f, f, (3, 3), strides, groups=cardinality,
                                use_bias=False),
                      self.batch_norm(f, relu=True)),
                     (self.conv(f, 2 * f, (1, 1), use_bias=False),
                      self.batch_norm(2 * f))]
        self.shortcut = [(self.conv(cin, 2 * f, (1, 1), strides,
                                   use_bias=False),
                          self.batch_norm(2 * f))] if downsample else []

    def forward(self, x, training: bool = False):
        y = x
        for conv, norm in self.path:
            y = norm(conv(y), training)
        residual = x
        for conv, norm in self.shortcut:
            residual = norm(conv(x), training)
        return torch.relu(y + residual)


class ResNeXt(Numbered):
    def __init__(self, depth: int = 50, num_classes: int = 1000,
                 cardinality: int = 32, dtype: torch.dtype = torch.float32,
                 in_channels: int = 3):
        super().__init__(dtype)
        self.conv(in_channels, 64, (7, 7), (2, 2), [(3, 3), (3, 3)],
                  use_bias=False)
        self.batch_norm(64, relu=True)
        self.blocks = []
        cin = 64
        for stage, (nblk, f) in enumerate(zip(_SPECS[depth], _FILTERS)):
            for i in range(nblk):
                strides = (2, 2) if (i == 0 and stage > 0) else (1, 1)
                down = i == 0 and (strides != (1, 1) or cin != 2 * f)
                self.blocks.append(self.numbered("ResNeXtBlock", ResNeXtBlock(
                    cin, f, cardinality, strides, down, dtype)))
                cin = 2 * f
        self.dense(cin, num_classes)

    def forward(self, x, training: bool = False):
        x = self.BatchNorm_0(self.Conv_0(x), training)
        x = ops.max_pool2d(x, 3, 2, padding=1)
        for blk in self.blocks:
            x = blk(x, training)
        return self.Dense_0(ops.global_avg_pool2d(x))
