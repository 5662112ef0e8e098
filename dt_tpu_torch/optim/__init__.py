"""Optimizers and LR schedulers of the port (counterpart of
``dt_tpu/optim``): ``sgd`` and every scheduler in this slice."""

from dt_tpu_torch.optim.lr_scheduler import (
    LRScheduler as LRScheduler,
    FactorScheduler as FactorScheduler,
    MultiFactorScheduler as MultiFactorScheduler,
    PolyScheduler as PolyScheduler,
    CosineScheduler as CosineScheduler,
    constant as constant,
    make as make,
)
from dt_tpu_torch.optim.optimizers import (
    SGD as SGD,
    create as create,
    sgd as sgd,
)
