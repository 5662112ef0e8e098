"""DenseNet 121/161/169/201 (counterpart of ``dt_tpu/models/densenet.py``).
A ``DenseLayer`` is BN-ReLU-1x1-BN-ReLU-3x3 (each BN on the kernels with its
ReLU fused in) whose output is concatenated to its input; every BN of a
dense block reads such a concatenation, which ``torch.cat`` keeps
channels_last for the kernels.  The top-level BNs (stem, transitions, the
last) are numbered across the model, as the JAX model's ``_bn`` calls
are."""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from dt_tpu_torch.models.common import Numbered
from dt_tpu_torch.ops import nn as ops

_SPECS: Dict[int, Tuple[int, int, Tuple[int, ...]]] = {
    # depth: (init_features, growth_rate, block_config)
    121: (64, 32, (6, 12, 24, 16)),
    161: (96, 48, (6, 12, 36, 24)),
    169: (64, 32, (6, 12, 32, 32)),
    201: (64, 32, (6, 12, 48, 32)),
}


class DenseLayer(Numbered):
    def __init__(self, cin: int, growth_rate: int, bn_size: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__(dtype)
        w = bn_size * growth_rate
        self.path = [(self.batch_norm(cin, relu=True),
                      self.conv(cin, w, (1, 1), use_bias=False)),
                     (self.batch_norm(w, relu=True),
                      self.conv(w, growth_rate, (3, 3), use_bias=False))]

    def forward(self, x, training: bool = False):
        y = x
        for norm, conv in self.path:
            y = conv(norm(y, training))
        return ops.concat([x, y])


class DenseNet(Numbered):
    def __init__(self, depth: int = 121, num_classes: int = 1000,
                 dtype: torch.dtype = torch.float32, in_channels: int = 3):
        super().__init__(dtype)
        init_f, growth, blocks = _SPECS[depth]
        self.conv(in_channels, init_f, (7, 7), (2, 2), [(3, 3), (3, 3)],
                  use_bias=False)
        self.batch_norm(init_f, relu=True)
        self.stages = []  # (dense layers, transition (bn, conv) or None)
        features = init_f
        for i, nlayers in enumerate(blocks):
            layers = []
            for _ in range(nlayers):
                layers.append(self.numbered("DenseLayer", DenseLayer(
                    features, growth, dtype=dtype)))
                features += growth
            trans = None
            if i != len(blocks) - 1:
                trans = (self.batch_norm(features, relu=True),
                         self.conv(features, features // 2, (1, 1),
                                   use_bias=False))
                features //= 2
            self.stages.append((layers, trans))
        self.final_bn = [self.batch_norm(features, relu=True)]
        self.dense(features, num_classes)

    def forward(self, x, training: bool = False):
        x = self.BatchNorm_0(self.Conv_0(x), training)
        x = ops.max_pool2d(x, 3, 2, padding=1)
        for layers, trans in self.stages:
            for layer in layers:
                x = layer(x, training)
            if trans is not None:
                x = ops.avg_pool2d(trans[1](trans[0](x, training)), 2, 2)
        x = self.final_bn[0](x, training)
        return self.Dense_0(ops.global_avg_pool2d(x))
