"""Loss ops (counterpart of ``dt_tpu/ops/losses.py``).

This slice ports the classification loss the training step uses.
"""

from __future__ import annotations

from typing import Optional

import torch


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          smoothing: float = 0.0,
                          ignore_label: Optional[int] = None) -> torch.Tensor:
    """Softmax + cross entropy with integer labels, the mean over the rows
    (``dt_tpu/ops/losses.py:20-36``).  Computed in f32 from logits of any
    dtype.  ``smoothing`` mixes ``smoothing / classes`` into the one-hot;
    rows whose label is ``ignore_label`` count for nothing, and the mean is
    over the rest (at least 1).  A label outside ``[0, classes)`` has an
    all-zero one-hot, as ``jax.nn.one_hot`` gives."""
    num_classes = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    classes = torch.arange(num_classes, device=logits.device)
    onehot = (labels[..., None] == classes).to(logp.dtype)
    if smoothing > 0.0:
        onehot = onehot * (1.0 - smoothing) + smoothing / num_classes
    nll = -(onehot * logp).sum(-1)
    if ignore_label is not None:
        mask = (labels != ignore_label).to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
