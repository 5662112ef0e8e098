"""MLP (counterpart of ``dt_tpu/models/mlp.py``; reference
``example/image-classification/symbols/mlp.py``: 128-64-num_classes with
ReLU).

PyTorch needs the input width up front where linen infers it, so the model
takes the input's HWC shape (``in_shape``, MNIST's 28x28x1 by default).  The
input is NCHW (channels_last) and flattened in NHWC order, as the JAX model
flattens it, so its ``Dense_0`` kernel loads unchanged.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from dt_tpu_torch.models.common import Dense
from dt_tpu_torch.ops import nn as ops


class MLP(nn.Module):
    def __init__(self, num_classes: int = 10,
                 hidden: Sequence[int] = (128, 64),
                 dtype: torch.dtype = torch.float32,
                 in_shape: Sequence[int] = (28, 28, 1)):
        super().__init__()
        self.dtype = dtype
        widths = [int(np.prod(in_shape)), *hidden]
        self.layers = []
        for i, (a, b) in enumerate(zip(widths, [*hidden, num_classes])):
            self.add_module(f"Dense_{i}", Dense(a, b, dtype))
            self.layers.append(f"Dense_{i}")

    def forward(self, x: torch.Tensor, training: bool = True
                ) -> torch.Tensor:
        x = ops.flatten_nhwc(x)
        for name in self.layers[:-1]:
            x = torch.relu(getattr(self, name)(x))
        return getattr(self, self.layers[-1])(x)
