"""Inception-v3 at 299x299 (counterpart of ``dt_tpu/models/inception.py``):
stem, 3 InceptionA, ReductionA (35 -> 17), 4 InceptionB (7x7 factorized),
ReductionB (17 -> 8), 2 InceptionC, mean, dropout 0.5, dense.  Every conv is
a ``ConvBN`` (no bias), its BN on the kernels with the ReLU fused in.  A
block's branches are lists of ``ConvBN`` created in the JAX block's call
order, which numbers them; each branch's output reaches the concat, and the
next BN, channels_last."""

from __future__ import annotations

from typing import Optional

import torch

from dt_tpu_torch.models.common import Numbered, chain
from dt_tpu_torch.ops import nn as ops

_V = "VALID"


class InceptionA(Numbered):
    def __init__(self, cin: int, pool_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        c = self.conv_bn
        self.b1 = [c(cin, 64, (1, 1))]
        self.b2 = [c(cin, 48, (1, 1)), c(48, 64, (5, 5))]
        self.b3 = [c(cin, 64, (1, 1)), c(64, 96, (3, 3)), c(96, 96, (3, 3))]
        self.b4 = [c(cin, pool_features, (1, 1))]
        self.features = 224 + pool_features

    def forward(self, x, training: bool = False):
        b4 = chain(self.b4, ops.avg_pool2d(x, 3, 1, padding=1), training)
        return ops.concat([chain(self.b1, x, training),
                           chain(self.b2, x, training),
                           chain(self.b3, x, training), b4])


class ReductionA(Numbered):
    def __init__(self, cin: int, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        c = self.conv_bn
        self.b1 = [c(cin, 384, (3, 3), (2, 2), _V)]
        self.b2 = [c(cin, 64, (1, 1)), c(64, 96, (3, 3)),
                   c(96, 96, (3, 3), (2, 2), _V)]
        self.features = 480 + cin

    def forward(self, x, training: bool = False):
        return ops.concat([chain(self.b1, x, training),
                           chain(self.b2, x, training),
                           ops.max_pool2d(x, 3, 2)])


class InceptionB(Numbered):
    def __init__(self, cin: int, channels_7x7: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        c, c7 = self.conv_bn, channels_7x7
        self.b1 = [c(cin, 192, (1, 1))]
        self.b2 = [c(cin, c7, (1, 1)), c(c7, c7, (1, 7)),
                   c(c7, 192, (7, 1))]
        self.b3 = [c(cin, c7, (1, 1)), c(c7, c7, (7, 1)), c(c7, c7, (1, 7)),
                   c(c7, c7, (7, 1)), c(c7, 192, (1, 7))]
        self.b4 = [c(cin, 192, (1, 1))]
        self.features = 768

    def forward(self, x, training: bool = False):
        b4 = chain(self.b4, ops.avg_pool2d(x, 3, 1, padding=1), training)
        return ops.concat([chain(self.b1, x, training),
                           chain(self.b2, x, training),
                           chain(self.b3, x, training), b4])


class ReductionB(Numbered):
    def __init__(self, cin: int, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        c = self.conv_bn
        self.b1 = [c(cin, 192, (1, 1)), c(192, 320, (3, 3), (2, 2), _V)]
        self.b2 = [c(cin, 192, (1, 1)), c(192, 192, (1, 7)),
                   c(192, 192, (7, 1)), c(192, 192, (3, 3), (2, 2), _V)]
        self.features = 512 + cin

    def forward(self, x, training: bool = False):
        return ops.concat([chain(self.b1, x, training),
                           chain(self.b2, x, training),
                           ops.max_pool2d(x, 3, 2)])


class InceptionC(Numbered):
    def __init__(self, cin: int, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        c = self.conv_bn
        self.b1 = [c(cin, 320, (1, 1))]
        self.b2 = [c(cin, 384, (1, 1))]
        self.b2ab = [c(384, 384, (1, 3)), c(384, 384, (3, 1))]
        self.b3 = [c(cin, 448, (1, 1)), c(448, 384, (3, 3))]
        self.b3ab = [c(384, 384, (1, 3)), c(384, 384, (3, 1))]
        self.b4 = [c(cin, 192, (1, 1))]
        self.features = 2048

    def forward(self, x, training: bool = False):
        b2 = chain(self.b2, x, training)
        b3 = chain(self.b3, x, training)
        b4 = chain(self.b4, ops.avg_pool2d(x, 3, 1, padding=1), training)
        return ops.concat([chain(self.b1, x, training)]
                          + [m(b2, training) for m in self.b2ab]
                          + [m(b3, training) for m in self.b3ab] + [b4])


class InceptionV3(Numbered):
    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3):
        super().__init__(dtype)
        c = self.conv_bn
        self.stem = [c(in_channels, 32, (3, 3), (2, 2), _V),
                     c(32, 32, (3, 3), padding=_V), c(32, 64, (3, 3))]
        self.stem2 = [c(64, 80, (1, 1)), c(80, 192, (3, 3), padding=_V)]
        self.blocks = []
        cin = 192

        def add(kind, block):
            nonlocal cin
            self.blocks.append(self.numbered(kind, block))
            cin = block.features

        for pf in (32, 64, 64):
            add("InceptionA", InceptionA(cin, pf, dtype))
        add("ReductionA", ReductionA(cin, dtype))
        for c7 in (128, 160, 160, 192):
            add("InceptionB", InceptionB(cin, c7, dtype))
        add("ReductionB", ReductionB(cin, dtype))
        for _ in range(2):
            add("InceptionC", InceptionC(cin, dtype))
        self.dense(cin, num_classes)

    def forward(self, x, training: bool = False,
                generator: Optional[torch.Generator] = None):
        x = ops.max_pool2d(chain(self.stem, x, training), 3, 2)
        x = ops.max_pool2d(chain(self.stem2, x, training), 3, 2)
        for blk in self.blocks:
            x = blk(x, training)
        x = ops.dropout(ops.global_avg_pool2d(x), 0.5, training=training,
                        generator=generator)
        return self.Dense_0(x)
