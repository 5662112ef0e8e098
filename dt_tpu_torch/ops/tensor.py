"""Tensor ops with the reference's semantics (counterpart of
``dt_tpu/ops/tensor.py``): ``topk`` with MXNet's conventions, ``one_hot``,
``embedding``, ``take``, ``gather_nd``, the sequence ops, ``swapaxes``,
``slice_channel`` and ``clip_global_norm``, which the LSTM LM's training
clips its gradient with.  Each returns what its JAX twin returns, index
rules included: ``topk`` breaks ties to the lower index (``lax.top_k``'s
order, a stable descending sort here), ``embedding`` wraps negative ids and
gives NaN rows past the table (``jnp.take``'s fill), ``take`` clips or
wraps, ``gather_nd`` wraps negative and clamps large indices (JAX
indexing).  Integer results are int64, torch's index type.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch


def topk(x: torch.Tensor, k: int, axis: int = -1, ret_typ: str = "indices",
         is_ascend: bool = False):
    """The ``k`` largest (``is_ascend``: smallest) along ``axis``
    (``src/operator/tensor/ordering_op.cc``); ``ret_typ`` in {value,
    indices, both}."""
    v = -x if is_ascend else x
    vals, idx = torch.sort(torch.movedim(v, axis, -1), dim=-1,
                           descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    vals = torch.movedim(-vals if is_ascend else vals, -1, axis)
    idx = torch.movedim(idx, -1, axis)
    if ret_typ == "value":
        return vals
    if ret_typ == "indices":
        return idx
    return vals, idx


def one_hot(indices: torch.Tensor, depth: int, on_value: float = 1.0,
            off_value: float = 0.0, dtype=torch.float32) -> torch.Tensor:
    """``indices_op.cc`` one_hot: ``on_value`` at the index, ``off_value``
    elsewhere; an index outside ``[0, depth)`` is all ``off_value``."""
    oh = (indices[..., None] == torch.arange(depth, device=indices.device)) \
        .to(torch.float32)
    return (oh * (on_value - off_value) + off_value).to(dtype)


def embedding(indices: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Embedding lookup: rows of ``weight`` by ``indices`` of any shape;
    a negative id counts from the end, an id past the table gives a NaN row
    (``jnp.take``'s default)."""
    v = weight.shape[0]
    idx = indices.long()
    idx = torch.where(idx < 0, idx + v, idx)
    ok = (idx >= 0) & (idx < v)
    rows = weight[idx.clamp(0, v - 1)]
    return torch.where(ok[..., None], rows,
                       torch.full((), float("nan"), dtype=weight.dtype,
                                  device=weight.device))


def take(x: torch.Tensor, indices: torch.Tensor, axis: int = 0,
         mode: str = "clip") -> torch.Tensor:
    """Take along ``axis`` with ``mode`` clip (indices clamped into range,
    negatives to 0) or wrap (modulo the axis length)."""
    n = x.shape[axis]
    idx = indices.long()
    if mode == "clip":
        idx = idx.clamp(0, n - 1)
    elif mode == "wrap":
        idx = torch.remainder(idx, n)
    else:
        raise ValueError(f"take: mode must be 'clip' or 'wrap', got {mode!r}")
    out = torch.index_select(x, axis, idx.reshape(-1))
    shape = x.shape[:axis % x.dim()] + idx.shape + x.shape[axis % x.dim() + 1:]
    return out.reshape(shape)


def gather_nd(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``indexing_op.cc`` gather_nd: ``indices`` (M, ...) select along the
    first M axes (negative indices count from the end, larger ones clamp to
    the last)."""
    idx = []
    for i in range(indices.shape[0]):
        n = x.shape[i]
        j = indices[i].long()
        idx.append(torch.where(j < 0, j + n, j).clamp(0, n - 1))
    return x[tuple(idx)]


def _mask_shape(mask: torch.Tensor, ndim: int) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (ndim - 2))


def sequence_mask(x: torch.Tensor, lengths: torch.Tensor, value: float = 0.0,
                  time_axis: int = 0) -> torch.Tensor:
    """``sequence_mask.cc``: steps at or past each sequence's length become
    ``value``; time on ``time_axis`` (0 or 1), batch on the other."""
    steps = torch.arange(x.shape[time_axis], device=x.device)
    if time_axis == 0:
        mask = steps[:, None] < lengths[None, :]
    else:
        mask = steps[None, :] < lengths[:, None]
    return torch.where(_mask_shape(mask, x.dim()), x,
                       torch.full((), value, dtype=x.dtype, device=x.device))


def sequence_last(x: torch.Tensor, lengths: torch.Tensor,
                  time_axis: int = 0) -> torch.Tensor:
    """``sequence_last.cc``: each sequence's last valid step (step 0 for a
    length of 0)."""
    idx = torch.clamp(lengths.long() - 1, min=0)
    if time_axis == 0:
        return x[idx, torch.arange(x.shape[1], device=x.device)]
    return x[torch.arange(x.shape[0], device=x.device), idx]


def sequence_reverse(x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                     time_axis: int = 0) -> torch.Tensor:
    """``sequence_reverse.cc``: each sequence's first ``length`` steps
    reversed, the rest left in place (every step without ``lengths``)."""
    if lengths is None:
        return torch.flip(x, dims=(time_axis,))
    steps = torch.arange(x.shape[time_axis], device=x.device)
    lengths = lengths.long()
    if time_axis == 0:
        rev = torch.where(steps[:, None] < lengths[None, :],
                          lengths[None, :] - 1 - steps[:, None],
                          steps[:, None])
        return x[rev, torch.arange(x.shape[1], device=x.device)[None, :]]
    rev = torch.where(steps[None, :] < lengths[:, None],
                      lengths[:, None] - 1 - steps[None, :], steps[None, :])
    return x[torch.arange(x.shape[0], device=x.device)[:, None], rev]


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


def swapaxes(x: torch.Tensor, dim1: int, dim2: int) -> torch.Tensor:
    """``swapaxis.cc``."""
    return torch.swapaxes(x, dim1, dim2)


def slice_channel(x: torch.Tensor, num_outputs: int, axis: int = 1,
                  squeeze_axis: bool = False) -> Tuple[torch.Tensor, ...]:
    """SliceChannel (``slice_channel.cc``): ``num_outputs`` equal parts
    along ``axis`` (which must divide), each squeezed with
    ``squeeze_axis``."""
    if x.shape[axis] % num_outputs:
        raise ValueError(f"slice_channel: {x.shape[axis]} does not split "
                         f"into {num_outputs} equal parts")
    parts = torch.chunk(x, num_outputs, dim=axis)
    if squeeze_axis:
        parts = [p.squeeze(axis) for p in parts]
    return tuple(parts)
