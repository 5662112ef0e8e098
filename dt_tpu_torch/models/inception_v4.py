"""Inception-BN (v2, 224x224) and Inception-v4 (299x299) (counterpart of
``dt_tpu/models/inception_v4.py``).  Every conv is a ``ConvBN`` (no bias),
its BN on the kernels with the ReLU fused in; branches are lists of
``ConvBN`` created in the JAX modules' call order, which numbers them."""

from __future__ import annotations

from typing import Optional

import torch

from dt_tpu_torch.models.common import Numbered, chain
from dt_tpu_torch.ops import nn as ops

_V = "VALID"


class InceptionBNBlock(Numbered):
    """3a-style mixed block: a 1x1 branch (when ``c1 > 0``), 1x1 -> 3x3,
    1x1 -> 3x3 -> 3x3, and a 3x3 stride-1 avg or max pool (then a 1x1 when
    ``cp > 0``)."""

    def __init__(self, cin: int, c1: int, c3r: int, c3: int, cd3r: int,
                 cd3: int, cp: int, pool: str = "avg",
                 dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        c = self.conv_bn
        self.pool = pool
        self.branches = []
        if c1 > 0:
            self.branches.append([c(cin, c1, (1, 1))])
        self.branches.append([c(cin, c3r, (1, 1)), c(c3r, c3, (3, 3))])
        self.branches.append([c(cin, cd3r, (1, 1)), c(cd3r, cd3, (3, 3)),
                              c(cd3, cd3, (3, 3))])
        self.bp = [c(cin, cp, (1, 1))] if cp > 0 else []
        self.features = max(c1, 0) + c3 + cd3 + (cp if cp > 0 else cin)

    def forward(self, x, training: bool = False):
        pool = ops.avg_pool2d if self.pool == "avg" else ops.max_pool2d
        bp = chain(self.bp, pool(x, 3, 1, padding=1), training)
        return ops.concat([chain(b, x, training) for b in self.branches]
                          + [bp])


class InceptionBNDownsample(Numbered):
    def __init__(self, cin: int, c3r: int, c3: int, cd3r: int, cd3: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        c = self.conv_bn
        self.b3 = [c(cin, c3r, (1, 1)), c(c3r, c3, (3, 3), (2, 2))]
        self.bd3 = [c(cin, cd3r, (1, 1)), c(cd3r, cd3, (3, 3)),
                    c(cd3, cd3, (3, 3), (2, 2))]
        self.features = c3 + cd3 + cin

    def forward(self, x, training: bool = False):
        return ops.concat([chain(self.b3, x, training),
                           chain(self.bd3, x, training),
                           ops.max_pool2d(x, 3, 2, padding=1)])


_BN_BLOCKS = [
    ("block", (64, 64, 64, 64, 96, 32, "avg")),
    ("block", (64, 64, 96, 64, 96, 64, "avg")),
    ("down", (128, 160, 64, 96)),
    ("block", (224, 64, 96, 96, 128, 128, "avg")),
    ("block", (192, 96, 128, 96, 128, 128, "avg")),
    ("block", (160, 128, 160, 128, 160, 128, "avg")),
    ("block", (96, 128, 192, 160, 192, 128, "avg")),
    ("down", (128, 192, 192, 256)),
    ("block", (352, 192, 320, 160, 224, 128, "avg")),
    ("block", (352, 192, 320, 192, 224, 128, "max")),
]


class InceptionBN(Numbered):
    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3):
        super().__init__(dtype)
        c = self.conv_bn
        self.stem = [c(in_channels, 64, (7, 7), (2, 2))]
        self.stem2 = [c(64, 64, (1, 1)), c(64, 192, (3, 3))]
        self.blocks = []
        cin = 192
        for kind, spec in _BN_BLOCKS:
            if kind == "block":
                blk = self.numbered("InceptionBNBlock",
                                    InceptionBNBlock(cin, *spec, dtype=dtype))
            else:
                blk = self.numbered("InceptionBNDownsample",
                                    InceptionBNDownsample(cin, *spec,
                                                          dtype=dtype))
            self.blocks.append(blk)
            cin = blk.features
        self.dense(cin, num_classes)

    def forward(self, x, training: bool = False):
        x = ops.max_pool2d(chain(self.stem, x, training), 3, 2, padding=1)
        x = ops.max_pool2d(chain(self.stem2, x, training), 3, 2, padding=1)
        for blk in self.blocks:
            x = blk(x, training)
        return self.Dense_0(ops.global_avg_pool2d(x))


# ----- Inception-v4 ---------------------------------------------------------


class _StemV4(Numbered):
    def __init__(self, cin: int, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        c = self.conv_bn
        self.s1 = [c(cin, 32, (3, 3), (2, 2), _V), c(32, 32, (3, 3),
                                                      padding=_V),
                   c(32, 64, (3, 3))]
        self.s1b = [c(64, 96, (3, 3), (2, 2), _V)]
        self.s2a = [c(160, 64, (1, 1)), c(64, 96, (3, 3), padding=_V)]
        self.s2b = [c(160, 64, (1, 1)), c(64, 64, (7, 1)),
                    c(64, 64, (1, 7)), c(64, 96, (3, 3), padding=_V)]
        self.s3a = [c(192, 192, (3, 3), (2, 2), _V)]
        self.features = 384

    def forward(self, x, training: bool = False):
        x = chain(self.s1, x, training)
        x = ops.concat([ops.max_pool2d(x, 3, 2),
                        chain(self.s1b, x, training)])
        x = ops.concat([chain(self.s2a, x, training),
                        chain(self.s2b, x, training)])
        return ops.concat([chain(self.s3a, x, training),
                           ops.max_pool2d(x, 3, 2)])


class _BlockA4(Numbered):
    def __init__(self, cin: int, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        c = self.conv_bn
        self.b1 = [c(cin, 96, (1, 1))]
        self.branches = [[c(cin, 96, (1, 1))],
                         [c(cin, 64, (1, 1)), c(64, 96, (3, 3))],
                         [c(cin, 64, (1, 1)), c(64, 96, (3, 3)),
                          c(96, 96, (3, 3))]]
        self.features = 384

    def forward(self, x, training: bool = False):
        b1 = chain(self.b1, ops.avg_pool2d(x, 3, 1, padding=1), training)
        return ops.concat([b1] + [chain(b, x, training)
                                  for b in self.branches])


class _BlockB4(Numbered):
    def __init__(self, cin: int, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        c = self.conv_bn
        self.b1 = [c(cin, 128, (1, 1))]
        self.branches = [[c(cin, 384, (1, 1))],
                         [c(cin, 192, (1, 1)), c(192, 224, (1, 7)),
                          c(224, 256, (7, 1))],
                         [c(cin, 192, (1, 1)), c(192, 192, (1, 7)),
                          c(192, 224, (7, 1)), c(224, 224, (1, 7)),
                          c(224, 256, (7, 1))]]
        self.features = 1024

    def forward(self, x, training: bool = False):
        b1 = chain(self.b1, ops.avg_pool2d(x, 3, 1, padding=1), training)
        return ops.concat([b1] + [chain(b, x, training)
                                  for b in self.branches])


class _BlockC4(Numbered):
    def __init__(self, cin: int, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        c = self.conv_bn
        self.b1 = [c(cin, 256, (1, 1))]
        self.b2 = [c(cin, 256, (1, 1))]
        self.b3 = [c(cin, 384, (1, 1))]
        self.b3ab = [c(384, 256, (1, 3)), c(384, 256, (3, 1))]
        self.b4 = [c(cin, 384, (1, 1)), c(384, 448, (1, 3)),
                   c(448, 512, (3, 1))]
        self.b4ab = [c(512, 256, (3, 1)), c(512, 256, (1, 3))]
        self.features = 1536

    def forward(self, x, training: bool = False):
        b1 = chain(self.b1, ops.avg_pool2d(x, 3, 1, padding=1), training)
        b3 = chain(self.b3, x, training)
        b4 = chain(self.b4, x, training)
        return ops.concat([b1, chain(self.b2, x, training)]
                          + [m(b3, training) for m in self.b3ab]
                          + [m(b4, training) for m in self.b4ab])


class InceptionV4(Numbered):
    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3):
        super().__init__(dtype)
        c = self.conv_bn
        self.numbered("_StemV4", _StemV4(in_channels, dtype))
        self.blocks_a = [self.numbered("_BlockA4", _BlockA4(384, dtype))
                         for _ in range(4)]
        self.red_a = [[c(384, 384, (3, 3), (2, 2), _V)],
                      [c(384, 192, (1, 1)), c(192, 224, (3, 3)),
                       c(224, 256, (3, 3), (2, 2), _V)]]
        self.blocks_b = [self.numbered("_BlockB4", _BlockB4(1024, dtype))
                         for _ in range(7)]
        self.red_b = [[c(1024, 192, (1, 1)), c(192, 192, (3, 3), (2, 2), _V)],
                      [c(1024, 256, (1, 1)), c(256, 256, (1, 7)),
                       c(256, 320, (7, 1)), c(320, 320, (3, 3), (2, 2), _V)]]
        self.blocks_c = [self.numbered("_BlockC4", _BlockC4(1536, dtype))
                         for _ in range(3)]
        self.dense(1536, num_classes)

    def forward(self, x, training: bool = False,
                generator: Optional[torch.Generator] = None):
        x = self._StemV4_0(x, training)
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
        x = ops.dropout(ops.global_avg_pool2d(x), 0.2, training=training,
                        generator=generator)
        return self.Dense_0(x)
