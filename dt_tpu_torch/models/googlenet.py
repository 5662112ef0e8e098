"""GoogLeNet, Inception v1 without the auxiliary heads (counterpart of
``dt_tpu/models/googlenet.py``).  No BatchNorm, so no kernel of the port;
the convolutions carry a bias."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dt_tpu_torch.models.common import Conv, Numbered
from dt_tpu_torch.ops import nn as ops


class ConvRelu(Numbered):
    def __init__(self, cin: int, features: int,
                 kernel: Tuple[int, int] = (1, 1),
                 strides: Tuple[int, int] = (1, 1),
                 dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.Conv_0 = Conv(cin, features, kernel, strides, dtype=dtype,
                           use_bias=True)

    def forward(self, x, training: bool = False):
        return torch.relu(self.Conv_0(x))


class InceptionBlock(Numbered):
    def __init__(self, cin: int, c1: int, c3r: int, c3: int, c5r: int,
                 c5: int, cp: int, dtype: torch.dtype = torch.float32):
        super().__init__(dtype)

        def cr(a, b, k=(1, 1)):
            return self.numbered("ConvRelu", ConvRelu(a, b, k, dtype=dtype))

        self.b1 = [cr(cin, c1)]
        self.b3 = [cr(cin, c3r), cr(c3r, c3, (3, 3))]
        self.b5 = [cr(cin, c5r), cr(c5r, c5, (5, 5))]
        self.bp = [cr(cin, cp)]
        self.features = c1 + c3 + c5 + cp

    def forward(self, x, training: bool = False):
        bp = self.bp[0](ops.max_pool2d(x, 3, 1, padding=1))
        return ops.concat([self.b1[0](x), self.b3[1](self.b3[0](x)),
                           self.b5[1](self.b5[0](x)), bp])


_BLOCKS = [(64, 96, 128, 16, 32, 32), (128, 128, 192, 32, 96, 64), "pool",
           (192, 96, 208, 16, 48, 64), (160, 112, 224, 24, 64, 64),
           (128, 128, 256, 24, 64, 64), (112, 144, 288, 32, 64, 64),
           (256, 160, 320, 32, 128, 128), "pool",
           (256, 160, 320, 32, 128, 128), (384, 192, 384, 48, 128, 128)]


class GoogLeNet(Numbered):
    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3):
        super().__init__(dtype)

        def cr(a, b, k=(1, 1), s=(1, 1)):
            return self.numbered("ConvRelu", ConvRelu(a, b, k, s, dtype))

        self.stem = [cr(in_channels, 64, (7, 7), (2, 2)), cr(64, 64),
                     cr(64, 192, (3, 3))]
        self.blocks = []
        cin = 192
        for spec in _BLOCKS:
            if spec == "pool":
                self.blocks.append(None)
                continue
            blk = self.numbered("InceptionBlock",
                                InceptionBlock(cin, *spec, dtype=dtype))
            self.blocks.append(blk)
            cin = blk.features
        self.dense(cin, num_classes)

    def forward(self, x, training: bool = False,
                generator: Optional[torch.Generator] = None):
        x = ops.max_pool2d(self.stem[0](x), 3, 2, padding=1)
        x = ops.max_pool2d(self.stem[2](self.stem[1](x)), 3, 2, padding=1)
        for blk in self.blocks:
            x = ops.max_pool2d(x, 3, 2, padding=1) if blk is None else blk(x)
        x = ops.dropout(ops.global_avg_pool2d(x), 0.4, training=training,
                        generator=generator)
        return self.Dense_0(x)
