"""Tensor utilities (counterpart of ``dt_tpu/ops/tensor.py``).

This slice ports ``clip_global_norm``, which the LSTM LM's training clips
its gradient with; the rest of the module is for a later slice.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def clip_global_norm(grads: Dict[str, torch.Tensor], max_norm: float
                     ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Clip gradients by their global L2 norm (``tensor.py:105-113``):
    ``norm = sqrt(sum of every element's square)`` in f32, every gradient
    times ``min(1, max_norm / max(norm, 1e-12))`` in f32, then in its own
    dtype.
    ``grads`` is a dict by name (one flat vector works too: ``{"g": v}``).
    Returns ``(clipped, norm)``; the inputs are not changed."""
    norm = torch.sqrt(sum((g.float() * g.float()).sum()
                          for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {k: (g.float() * scale).to(g.dtype) for k, g in grads.items()}, \
        norm
