"""LeNet-5 (counterpart of ``dt_tpu/models/lenet.py``; reference
``example/image-classification/symbols/lenet.py``): conv 5x5x20, tanh, max
pool 2, conv 5x5x50, tanh, max pool 2, dense 500, tanh, dense.

The convs have biases and linen's "SAME" padding; the input's HWC shape
(``in_shape``, MNIST's 28x28x1 by default) fixes the first dense layer's
width, which linen infers.  The pooled map is flattened in NHWC order, as the
JAX model flattens it, so its ``Dense_0`` kernel loads unchanged.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from dt_tpu_torch.models.common import Conv, Dense
from dt_tpu_torch.ops import nn as ops


class LeNet(nn.Module):
    def __init__(self, num_classes: int = 10,
                 dtype: torch.dtype = torch.float32,
                 in_shape: Sequence[int] = (28, 28, 1)):
        super().__init__()
        h, w, c = in_shape
        self.Conv_0 = Conv(c, 20, (5, 5), dtype=dtype, use_bias=True)
        self.Conv_1 = Conv(20, 50, (5, 5), dtype=dtype, use_bias=True)
        flat = (h // 2 // 2) * (w // 2 // 2) * 50
        self.Dense_0 = Dense(flat, 500, dtype)
        self.Dense_1 = Dense(500, num_classes, dtype)

    def forward(self, x: torch.Tensor, training: bool = True
                ) -> torch.Tensor:
        x = ops.max_pool2d(torch.tanh(self.Conv_0(x)), 2, 2)
        x = ops.max_pool2d(torch.tanh(self.Conv_1(x)), 2, 2)
        x = torch.tanh(self.Dense_0(ops.flatten(x)))
        return self.Dense_1(x)
