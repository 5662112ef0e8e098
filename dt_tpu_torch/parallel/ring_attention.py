"""Single-device attention (counterpart of ``full_attention`` in
``dt_tpu/parallel/ring_attention.py:114-126``).

It is the attention of ``TransformerLM`` with ``seq_parallel=None`` and the
oracle of the flash kernel.  Ring and Ulysses attention over a mesh come
with the parallel layer (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # the JAX package's mask value (finite: no inf - inf NaN)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention of ``(B, S, H, D)`` q/k/v: f32 scores ``q k^T *
    scale`` (``scale`` defaults to ``D**-0.5``), masked entries set to
    ``NEG_INF`` under ``causal``, softmax and the product with f32 ``v``;
    the output in ``q``'s dtype.  It holds the whole ``(B, H, S, S)`` f32
    score matrix."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        mask = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
