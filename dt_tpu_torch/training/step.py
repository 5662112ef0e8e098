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

The loss is a parameter, ``loss_fn(module, x, y) -> (loss, logits)``:

- :func:`classification_loss` (the default), the ResNets' step
  (``bench.py:382-536``): inputs NCHW in ``torch.channels_last`` memory
  format and in the model's compute dtype, labels integer class ids;
- :func:`next_token_loss`, the TransformerLM's (``bench.py:593-598``):
  ``softmax_cross_entropy(logits[:, :-1], tokens[:, 1:])`` over tokens
  ``(B, S)``, with ``y`` unused;
- :class:`BPTTLoss`, the LSTM LM's (``examples/train_lstm_ptb.py:81-92``):
  the window ``x`` ``(T, B)`` against the next tokens ``y``, the state
  carried from window to window, detached.

:func:`train_step` can clip the gradient by its global norm between the
gradient and the update, as the PTB example does.  Unlike the JAX step,
:func:`grad_step` already moves the module's running stats (in place, in the
BN kernels' forward); :func:`apply_step` then sets them from ``flat_s``,
which is the same vector for one worker and the average for many.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from dt_tpu_torch.ops.losses import softmax_cross_entropy
from dt_tpu_torch.ops.tensor import clip_global_norm
from dt_tpu_torch.training.train_state import TrainState


def classification_loss(module, x: torch.Tensor, y: torch.Tensor):
    """Softmax cross entropy of ``module(x, training=True)`` against class
    ids ``y``.  Returns ``(loss, logits)``."""
    logits = module(x, training=True)
    return softmax_cross_entropy(logits, y), logits


def next_token_loss(module, tokens: torch.Tensor, y=None, *,
                    generator: Optional[torch.Generator] = None):
    """The causal LM's loss: logits of ``tokens`` ``(B, S)`` at positions
    ``:-1`` against the tokens at ``1:``, as ``bench.py:594-598`` computes
    it; ``y`` is unused.  ``generator`` feeds dropout (bind it with
    ``functools.partial``).  Returns ``(loss, logits)``."""
    logits = module(tokens, training=True, generator=generator)
    vocab = logits.shape[-1]
    return softmax_cross_entropy(logits[:, :-1].reshape(-1, vocab),
                                 tokens[:, 1:].reshape(-1)), logits


class BPTTLoss:
    """The LSTM LM's loss over one truncated-BPTT window: ``module(x,
    state, training=True, generator=generator)`` on the window ``x`` ``(T,
    B)``, softmax cross entropy against ``y`` ``(T, B)``.  The window's
    final ``(hT, cT)``, detached, is kept in ``state`` for the next window
    (``None``: zeros); set ``state = None`` to start a new stream."""

    def __init__(self, generator: Optional[torch.Generator] = None,
                 state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        self.generator = generator
        self.state = state

    def __call__(self, module, x: torch.Tensor, y: torch.Tensor):
        logits, (h_t, c_t) = module(x, self.state, training=True,
                                    generator=self.generator)
        self.state = (h_t.detach(), c_t.detach())
        vocab = logits.shape[-1]
        return softmax_cross_entropy(logits.reshape(-1, vocab),
                                     y.reshape(-1)), logits


def grad_step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
              loss_fn: Callable = classification_loss
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                         torch.Tensor]:
    """``(flat_g, flat_s, loss, logits)`` of one batch under ``loss_fn``;
    the params are not changed."""
    params = state.params
    names = list(params)
    with torch.enable_grad():
        loss, logits = loss_fn(state.module, x, y)
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
    return load_stats(state, flat_s)


@torch.no_grad()
def load_stats(state: TrainState, flat_s: torch.Tensor) -> TrainState:
    """Load the BN stats from ``flat_s`` (skipped when it is empty)."""
    if flat_s.numel():
        stats = state.batch_stats
        for name, t in state.layout.stats.unravel(flat_s).items():
            stats[name].copy_(t)
    return state


def train_step(state: TrainState, x: torch.Tensor, y: torch.Tensor,
               compression: Optional[object] = None,
               loss_fn: Callable = classification_loss,
               clip_norm: Optional[float] = None
               ) -> Tuple[TrainState, torch.Tensor, torch.Tensor]:
    """``grad_step``, then the clip by global norm when ``clip_norm`` is
    given (``ops.tensor.clip_global_norm`` of the flat gradient), then the
    compressed leg when ``compression`` (a
    ``parallel.compression.GradientCompression``) is given, then
    ``apply_step``.  Returns ``(state, loss, logits)``."""
    flat_g, flat_s, loss, logits = grad_step(state, x, y, loss_fn)
    if clip_norm is not None:
        flat_g = clip_global_norm({"g": flat_g}, clip_norm)[0]["g"]
    if compression is not None:
        words = compression.compress_on_device(flat_g)
        flat_g = compression.decompress_on_device(words, flat_g.numel())
    apply_step(state, flat_g, flat_s)
    return state, loss, logits
