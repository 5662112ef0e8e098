"""VGG 11/13/16/19 with and without BatchNorm (counterpart of
``dt_tpu/models/vgg.py``).  Convolutions and dense layers carry a bias, as
linen's defaults do; with ``batch_norm`` each conv's BN runs the kernels
with its ReLU fused in.  The first dense layer reads the last pool
flattened in NHWC order (25,088 rows at 224), so its size follows the input
side (``image_size``)."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple, Union

import torch

from dt_tpu_torch.models.common import Numbered
from dt_tpu_torch.ops import nn as ops

_LAYERS: Dict[int, Tuple[Sequence[int], Sequence[int]]] = {
    11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
    13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
    16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
    19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512]),
}


class VGG(Numbered):
    def __init__(self, depth: int = 16, num_classes: int = 1000,
                 batch_norm: bool = False,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3,
                 image_size: Union[int, Tuple[int, int]] = 224):
        super().__init__(dtype)
        h, w = (image_size, image_size) if isinstance(image_size, int) \
            else image_size
        self.stages = []  # a stage: [(conv, bn or None), ...]
        cin = in_channels
        for nblk, f in zip(*_LAYERS[depth]):
            stage = []
            for _ in range(nblk):
                conv = self.conv(cin, f, (3, 3))
                stage.append((conv, self.batch_norm(f, relu=True)
                              if batch_norm else None))
                cin = f
            self.stages.append(stage)
            h, w = h // 2, w // 2
        self.denses = [self.dense(h * w * cin, 4096), self.dense(4096, 4096),
                       self.dense(4096, num_classes)]

    def forward(self, x, training: bool = False,
                generator: Optional[torch.Generator] = None):
        for stage in self.stages:
            for conv, norm in stage:
                x = conv(x)
                x = torch.relu(x) if norm is None else norm(x, training)
            x = ops.max_pool2d(x, 2, 2)
        x = ops.flatten(x)
        for d in self.denses[:2]:
            x = ops.dropout(torch.relu(d(x)), 0.5, training=training,
                            generator=generator)
        return self.denses[2](x)
