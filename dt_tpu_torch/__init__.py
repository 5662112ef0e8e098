"""dt_tpu_torch — the PyTorch/CUDA port of ``dt_tpu`` for an NVIDIA H100.

The port sits beside the JAX package, keeps its module names, and is held
against it by the tests.  It imports neither JAX nor ``dt_tpu``.  It serves
ResNets (``models``) from ``dt_tpu`` checkpoints (``training.checkpoint``)
through the bucketed ``predictor.Predictor``, and trains models one device
at a time: ``training.module.Module.fit`` over the iterators of
``data.io``, with the metrics, callbacks and checkpoints of ``training``,
the initializers of ``initializer`` and the imperative
``training.trainer.Trainer``, all on the step of ``training.step``
(``grad_step``/``apply_step`` on a ``training.train_state.TrainState``, SGD
from ``optim``, the 2-bit gradient codec of ``parallel.compression``).
Worker processes train one elastic job through ``Module.fit(sync_mode=
"host")`` over ``elastic`` (the worker client, the scheduler's host-sync
core, the wire) and ``training.overlap``, beside JAX workers.  Its
BatchNorms, attention, LSTM cells and the codec run the hand-written CUDA
kernels of ``csrc/`` (``ops.kernels``, ``ops.attention``).

Importing the package imports and builds nothing: submodules load on first
attribute access, and kernels are built on their first launch.
"""

import importlib

__version__ = "0.1.0"

_SUBMODULES = ("config", "data", "elastic", "initializer", "interchange",
               "models", "obs", "ops", "optim", "parallel", "policy",
               "predictor", "training", "utils")


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
