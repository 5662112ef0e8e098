"""Ops of the port, by the JAX package's submodule names (``nn``,
``losses``, ``tensor``, ``rnn``, ``sparse``, ``detection``, ``roi``,
``warp``, ``contrib``, ``linalg``, ``custom_op``, and ``quantization``,
imported by its module path as the JAX package's is), plus ``kernels`` (the
CUDA kernels with their plain versions, built by ``_build``) and
``attention``."""

from dt_tpu_torch.ops import nn as nn
from dt_tpu_torch.ops import losses as losses
from dt_tpu_torch.ops import tensor as tensor
from dt_tpu_torch.ops import rnn as rnn
from dt_tpu_torch.ops import sparse as sparse
from dt_tpu_torch.ops import detection as detection
from dt_tpu_torch.ops import roi as roi
from dt_tpu_torch.ops import warp as warp
from dt_tpu_torch.ops import contrib as contrib
from dt_tpu_torch.ops import linalg as linalg
from dt_tpu_torch.ops.custom import custom_op as custom_op
