"""Inception-ResNet-v2 at 299x299 (counterpart of
``dt_tpu/models/inception_resnet_v2.py``): inception branches whose
concatenation a 1x1 ``ConvBN`` without activation projects back to the
input's width, scaled by ``scale`` and added to the input, then a ReLU
(none after the last block, ``activate=False``).  Every BN runs the
kernels; the ReLU after a residual add stays a PyTorch call."""

from __future__ import annotations

from typing import Optional

import torch

from dt_tpu_torch.models.common import Numbered, chain
from dt_tpu_torch.ops import nn as ops

_V = "VALID"


class _Residual(Numbered):
    """A residual block: ``branches`` (lists of ``ConvBN``) concatenated,
    then ``up`` (created last, as the JAX block creates it)."""

    scale: float
    activate: bool

    def forward(self, x, training: bool = False):
        mix = ops.concat([chain(b, x, training) for b in self.branches])
        out = x + self.scale * self.up[0](mix, training)
        return torch.relu(out) if self.activate else out


class _BlockA(_Residual):  # 35x35
    def __init__(self, cin: int, scale: float = 0.17,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.scale, self.activate = scale, True
        c = self.conv_bn
        self.branches = [[c(cin, 32, (1, 1))],
                         [c(cin, 32, (1, 1)), c(32, 32, (3, 3))],
                         [c(cin, 32, (1, 1)), c(32, 48, (3, 3)),
                          c(48, 64, (3, 3))]]
        self.up = [c(128, cin, (1, 1), act=None)]


class _BlockB(_Residual):  # 17x17
    def __init__(self, cin: int, scale: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.scale, self.activate = scale, True
        c = self.conv_bn
        # 129 is the reference symbol's width, kept for parity
        self.branches = [[c(cin, 192, (1, 1))],
                         [c(cin, 129, (1, 1)), c(129, 160, (1, 7)),
                          c(160, 192, (7, 1))]]
        self.up = [c(384, cin, (1, 1), act=None)]


class _BlockC(_Residual):  # 8x8
    def __init__(self, cin: int, scale: float = 0.2, activate: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.scale, self.activate = scale, activate
        c = self.conv_bn
        self.branches = [[c(cin, 192, (1, 1))],
                         [c(cin, 192, (1, 1)), c(192, 224, (1, 3)),
                          c(224, 256, (3, 1))]]
        self.up = [c(448, cin, (1, 1), act=None)]


class InceptionResNetV2(Numbered):
    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3):
        super().__init__(dtype)
        c = self.conv_bn
        self.stem = [c(in_channels, 32, (3, 3), (2, 2), _V),
                     c(32, 32, (3, 3), padding=_V), c(32, 64, (3, 3))]
        self.stem2 = [c(64, 80, (1, 1)), c(80, 192, (3, 3), padding=_V)]
        self.mixed_5b = [[c(192, 96, (1, 1))],
                         [c(192, 48, (1, 1)), c(48, 64, (5, 5))],
                         [c(192, 64, (1, 1)), c(64, 96, (3, 3)),
                          c(96, 96, (3, 3))]]
        self.mixed_5b_pool = [c(192, 64, (1, 1))]
        self.blocks_a = [self.numbered("_BlockA", _BlockA(320, dtype=dtype))
                         for _ in range(10)]
        self.red_a = [[c(320, 384, (3, 3), (2, 2), _V)],
                      [c(320, 256, (1, 1)), c(256, 256, (3, 3)),
                       c(256, 384, (3, 3), (2, 2), _V)]]
        self.blocks_b = [self.numbered("_BlockB", _BlockB(1088, dtype=dtype))
                         for _ in range(20)]
        self.red_b = [[c(1088, 256, (1, 1)), c(256, 384, (3, 3), (2, 2), _V)],
                      [c(1088, 256, (1, 1)), c(256, 288, (3, 3), (2, 2), _V)],
                      [c(1088, 256, (1, 1)), c(256, 288, (3, 3)),
                       c(288, 320, (3, 3), (2, 2), _V)]]
        self.blocks_c = [self.numbered("_BlockC", _BlockC(2080, dtype=dtype))
                         for _ in range(9)]
        self.blocks_c.append(self.numbered("_BlockC", _BlockC(
            2080, scale=1.0, activate=False, dtype=dtype)))
        self.last = [c(2080, 1536, (1, 1))]
        self.dense(1536, num_classes)

    def forward(self, x, training: bool = False,
                generator: Optional[torch.Generator] = None):
        x = ops.max_pool2d(chain(self.stem, x, training), 3, 2)
        x = ops.max_pool2d(chain(self.stem2, x, training), 3, 2)
        b4 = chain(self.mixed_5b_pool, ops.avg_pool2d(x, 3, 1, padding=1),
                   training)
        x = ops.concat([chain(b, x, training) for b in self.mixed_5b] + [b4])
        for blk in self.blocks_a:
            x = blk(x, training)
        x = ops.concat([chain(b, x, training) for b in self.red_a]
                       + [ops.max_pool2d(x, 3, 2)])
        for blk in self.blocks_b:
            x = blk(x, training)
        x = ops.concat([chain(b, x, training) for b in self.red_b]
                       + [ops.max_pool2d(x, 3, 2)])
        for blk in self.blocks_c:
            x = blk(x, training)
        x = ops.global_avg_pool2d(chain(self.last, x, training))
        x = ops.dropout(x, 0.2, training=training, generator=generator)
        return self.Dense_0(x)
