"""One training step, split as the JAX package's host-sync step splits it
(``dt_tpu/training/module.py:474-505``; the core ``bench.py:382-536`` times).

- :func:`grad_step` runs the forward in training mode, the loss and the
  gradients, and returns ``(flat_g, flat_s, loss, logits)``: the gradient
  and the new BN stats as flat f32 vectors in ``ravel_pytree``'s order and
  layout (:mod:`dt_tpu_torch.training.flat`), the vectors the elastic data
  plane puts on the wire.
- :func:`apply_step` applies an (averaged) gradient with the optimizer and
  sets the BN stats from ``flat_s``.
- :func:`train_step` composes them, with the optional compressed leg
  between: ``compress_on_device`` quantizes ``flat_g`` to 2-bit words on the
  card and ``decompress_on_device`` turns them back into a flat gradient,
  which is what a one-worker host-sync job with ``{'type': '2bit'}`` applies
  (``module.py:973-984``).

Inputs are NCHW in ``torch.channels_last`` memory format and in the model's
compute dtype; labels are integer class ids.  Unlike the JAX step,
:func:`grad_step` already moves the module's running stats (in place, in the
BN kernels' forward); :func:`apply_step` then sets them from ``flat_s``,
which is the same vector for one worker and the average for many.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dt_tpu_torch.ops.losses import softmax_cross_entropy
from dt_tpu_torch.training.train_state import TrainState


def grad_step(state: TrainState, x: torch.Tensor, y: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """``(flat_g, flat_s, loss, logits)`` of one batch; the params are not
    changed."""
    params = state.params
    names = list(params)
    with torch.enable_grad():
        logits = state.module(x, training=True)
        loss = softmax_cross_entropy(logits, y)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
    flat_g = state.layout.params.ravel(dict(zip(names, grads)))
    flat_s = state.layout.stats.ravel(state.batch_stats)
    return flat_g, flat_s, loss.detach(), logits.detach()


@torch.no_grad()
def apply_step(state: TrainState, flat_g: torch.Tensor,
               flat_s: torch.Tensor) -> TrainState:
    """Apply ``flat_g`` with the optimizer and load the BN stats from
    ``flat_s`` (skipped when it is empty, as for a model without BN).
    Updates ``state`` in place and returns it."""
    state.apply_gradients(state.layout.params.unravel(flat_g))
    if flat_s.numel():
        stats = state.batch_stats
        for name, t in state.layout.stats.unravel(flat_s).items():
            stats[name].copy_(t)
    return state


def train_step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
               compression: Optional[object] = None
               ) -> Tuple[TrainState, torch.Tensor, torch.Tensor]:
    """``grad_step``, then the compressed leg when ``compression`` (a
    ``parallel.compression.GradientCompression``) is given, then
    ``apply_step``.  Returns ``(state, loss, logits)``."""
    flat_g, flat_s, loss, logits = grad_step(state, x, y)
    if compression is not None:
        words = compression.compress_on_device(flat_g)
        flat_g = compression.decompress_on_device(words, flat_g.numel())
    apply_step(state, flat_g, flat_s)
    return state, loss, logits
