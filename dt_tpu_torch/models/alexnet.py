"""AlexNet (counterpart of ``dt_tpu/models/alexnet.py``): the single-tower
variant with LRN.  No BatchNorm, so no kernel of the port; convolutions and
dense layers carry a bias, as linen's defaults do.  The first dense layer
reads the last pool flattened in NHWC order, so its size follows the input
side (``image_size``, 224 by default)."""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from dt_tpu_torch.models.common import Numbered
from dt_tpu_torch.ops import nn as ops


def _pool_side(s: int) -> int:
    return (s - 3) // 2 + 1


def feature_side(s: int) -> int:
    """The side of the last pool for an input side ``s``."""
    s = (s + 4 - 11) // 4 + 1  # conv 11x11 / 4, pad 2
    return _pool_side(_pool_side(_pool_side(s)))


class AlexNet(Numbered):
    def __init__(self, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3,
                 image_size: Union[int, Tuple[int, int]] = 224):
        super().__init__(dtype)
        h, w = (image_size, image_size) if isinstance(image_size, int) \
            else image_size
        p2 = [(2, 2), (2, 2)]
        self.convs = [self.conv(in_channels, 96, (11, 11), (4, 4), p2),
                      self.conv(96, 256, (5, 5), padding=p2),
                      self.conv(256, 384, (3, 3)),
                      self.conv(384, 384, (3, 3)),
                      self.conv(384, 256, (3, 3))]
        flat = feature_side(h) * feature_side(w) * 256
        self.denses = [self.dense(flat, 4096), self.dense(4096, 4096),
                       self.dense(4096, num_classes)]

    def forward(self, x, training: bool = False,
                generator: Optional[torch.Generator] = None):
        c = self.convs
        x = ops.max_pool2d(ops.lrn(torch.relu(c[0](x)), nsize=5), 3, 2)
        x = ops.max_pool2d(ops.lrn(torch.relu(c[1](x)), nsize=5), 3, 2)
        x = torch.relu(c[4](torch.relu(c[3](torch.relu(c[2](x))))))
        x = ops.flatten(ops.max_pool2d(x, 3, 2))
        for d in self.denses[:2]:
            x = ops.dropout(torch.relu(d(x)), 0.5, training=training,
                            generator=generator)
        return self.denses[2](x)
