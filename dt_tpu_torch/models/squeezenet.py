"""SqueezeNet 1.1 (counterpart of ``dt_tpu/models/squeezenet.py``).  No
BatchNorm, so no kernel of the port; the convolutions carry a bias.  The
last conv has a ReLU, then a spatial mean gives the logits."""

from __future__ import annotations

from typing import Optional

import torch

from dt_tpu_torch.models.common import Numbered
from dt_tpu_torch.ops import nn as ops


class Fire(Numbered):
    def __init__(self, cin: int, squeeze: int, expand1: int, expand3: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        self.conv(cin, squeeze, (1, 1))
        self.conv(squeeze, expand1, (1, 1))
        self.conv(squeeze, expand3, (3, 3))

    def forward(self, x, training: bool = False):
        x = torch.relu(self.Conv_0(x))
        return ops.concat([torch.relu(self.Conv_1(x)),
                           torch.relu(self.Conv_2(x))])


_FIRES = [(16, 64), (16, 64), (32, 128), (32, 128), (48, 192), (48, 192),
          (64, 256), (64, 256)]  # (squeeze, expand) of each Fire


class SqueezeNet(Numbered):
    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3):
        super().__init__(dtype)
        self.conv(in_channels, 64, (3, 3), (2, 2))
        self.fires = []
        cin = 64
        for sq, ex in _FIRES:
            self.fires.append(self.numbered("Fire", Fire(cin, sq, ex, ex,
                                                         dtype)))
            cin = 2 * ex
        self.conv(cin, num_classes, (1, 1))

    def forward(self, x, training: bool = False,
                generator: Optional[torch.Generator] = None):
        x = ops.max_pool2d(torch.relu(self.Conv_0(x)), 3, 2)
        for i, fire in enumerate(self.fires):
            x = fire(x)
            if i in (1, 3):
                x = ops.max_pool2d(x, 3, 2)
        x = ops.dropout(x, 0.5, training=training, generator=generator)
        return ops.global_avg_pool2d(torch.relu(self.Conv_1(x)))
