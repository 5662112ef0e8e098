"""Rematerialization: a region's activations recomputed in the backward
instead of kept (the JAX package's ``jax.checkpoint`` / ``linen.remat``;
the reference's ``MXNET_BACKWARD_DO_MIRROR`` memory mirror).

:func:`checkpoint` is ``torch.utils.checkpoint`` (non-reentrant) with the two
things the port's layers need on the recomputed forward:

- it replays the draws of an explicit ``torch.Generator``: the dropout
  masks of ``ops.nn.dropout`` come from one, which the checkpoint's own RNG
  handling (the global CPU and CUDA states) does not cover.  The
  generator's state at the region's start is restored for the recompute,
  and its state from before the recompute put back after it;
- while it recomputes, :func:`replaying` is true, and training BatchNorm
  (``ops.kernels.fused_bn_train``) does not move the running stats a
  second time.  Its kernels do launch again, and count the launches.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint as _torch_checkpoint

_local = threading.local()


def replaying() -> bool:
    """Whether this thread is recomputing a checkpointed region now."""
    return getattr(_local, "depth", 0) > 0


def checkpoint(fn: Callable, *args,
               generator: Optional[torch.Generator] = None):
    """``fn(*args)``, its activations recomputed in the backward; see the
    module docstring.  ``generator``: the explicit generator ``fn`` draws
    from, if any."""
    start = generator.get_state() if generator is not None else None
    first = [True]

    def run(*a):
        if first[0]:
            first[0] = False
            return fn(*a)
        now = generator.get_state() if generator is not None else None
        if generator is not None:
            generator.set_state(start)
        _local.depth = getattr(_local, "depth", 0) + 1
        try:
            return fn(*a)
        finally:
            _local.depth -= 1
            if generator is not None:
                generator.set_state(now)

    return _torch_checkpoint(run, *args, use_reentrant=False)
