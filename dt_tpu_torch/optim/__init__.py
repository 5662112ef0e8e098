"""Optimizers and LR schedulers of the port (counterpart of
``dt_tpu/optim``): every optimizer of the JAX registry, the multi-precision
wrapper, the lazy row-sparse updates, SVRG and every scheduler."""

from dt_tpu_torch.optim.optimizers import (
    SGD as SGD,
    create as create,
    register as register,
    sgd as sgd,
    nag as nag,
    adam as adam,
    adagrad as adagrad,
    rmsprop as rmsprop,
    adadelta as adadelta,
    ftrl as ftrl,
    adamax as adamax,
    nadam as nadam,
    signum as signum,
    ftml as ftml,
    sgld as sgld,
    dcasgd as dcasgd,
    lbsgd as lbsgd,
    lamb as lamb,
    with_multi_precision as with_multi_precision,
)
from dt_tpu_torch.optim.sparse import (
    sparse_sgd as sparse_sgd,
    sparse_adagrad as sparse_adagrad,
    SparseSGDState as SparseSGDState,
    SparseAdaGradState as SparseAdaGradState,
)
from dt_tpu_torch.optim.svrg import (
    svrg as svrg,
    SVRGState as SVRGState,
    refresh_snapshot as refresh_snapshot,
    full_gradient as full_gradient,
)
from dt_tpu_torch.optim.lr_scheduler import (
    LRScheduler as LRScheduler,
    FactorScheduler as FactorScheduler,
    MultiFactorScheduler as MultiFactorScheduler,
    PolyScheduler as PolyScheduler,
    CosineScheduler as CosineScheduler,
    constant as constant,
    make as make,
)
