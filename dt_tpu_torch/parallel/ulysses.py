"""Ulysses all-to-all sequence parallelism (counterpart of
``dt_tpu/parallel/ulysses.py``).

The second of the two long-context schemes (DeepSpeed-Ulysses, Jacobs et
al. 2023): instead of circulating K/V around a ring
(:mod:`dt_tpu_torch.parallel.ring_attention`), two tiled all-to-alls
re-partition between the sequence-split and the head-split layouts::

    (B, S/n, H, D)  --all_to_all-->  (B, S, H/n, D)
    full attention per local head group (exact, no streaming softmax)
    (B, S, H/n, D)  --all_to_all-->  (B, S/n, H, D)

Each all-to-all is differentiable, its backward the inverse all-to-all
(``parallel.collectives``).  Needs ``num_heads % axis_size == 0``.
"""

from __future__ import annotations

from typing import Optional

import torch

from dt_tpu_torch.parallel import collectives as coll
from dt_tpu_torch.parallel.ring_attention import full_attention


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mesh, *, axis_name: str = "data", causal: bool = False,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention, the sequence split over the mesh axis ``axis_name``
    and re-split by heads through all-to-all (``ulysses.py:31-70``).
    ``q``/``k``/``v``: global ``(B, S, H, D)``, the same on every rank of
    the axis; S and H must divide by the axis size.  Same contract as
    :func:`~dt_tpu_torch.parallel.ring_attention.ring_attention`."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    n = mesh.axis_size(axis_name)
    if q.shape[2] % n:
        raise ValueError(
            f"num_heads {q.shape[2]} must divide by axis size {n} for "
            f"ulysses; use ring_attention for head counts < axis size")
    if q.shape[1] % n:
        raise ValueError(f"sequence length {q.shape[1]} must divide by the "
                         f"{axis_name!r} axis size {n}")
    group = mesh.axis_group(axis_name)
    # this rank's sequence block, then heads split across the ranks and
    # the sequence gathered
    qh, kh, vh = (coll.all_to_all(coll.split(t, group, 1), group, 2, 1)
                  for t in (q, k, v))
    out = full_attention(qh, kh, vh, causal=causal, scale=scale)
    out = coll.all_to_all(out, group, 1, 2)
    return coll.gather(out, group, 1)
