"""Flat vectors of a model's parameters, gradients and BN stats, in
``jax.flatten_util.ravel_pytree``'s order and layout (the JAX package's
``module.py:480-481, 558-562``), so the port's flat gradient and stats are
the JAX package's bit for bit and can share one wire.

- The order is lexicographic on the JAX variable paths, as JAX sorts dict
  keys at every level: ``BottleneckV1_10`` comes before ``BottleneckV1_2``,
  ``bias`` before ``kernel``, ``mean`` before ``var``.
- Each leaf is in the JAX layout: a conv weight (OIHW) as HWIO, a dense
  weight ``(out, in)`` as ``(in, out)`` (the JAX ``kernel``s); every other
  leaf, an ``embedding`` or an LSTM's ``l<i>_wx`` too, as it is.
- Every leaf is float32 in the vector, as ``ravel_pytree`` promotes a
  bfloat16 leaf (a bf16 TransformerLM's ``pos_embed``): exactly.
- BatchNorm modules are ``BatchNorm_<i>`` in the JAX package by default and
  ``FusedBatchNorm_<i>`` under ``DT_PALLAS_BN=1``; the two sort to different
  places, so the name is a parameter (``bn_name``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from dt_tpu_torch.interchange import from_jax_layout, jax_path, to_jax_layout


class Leaves:
    """One pytree's leaves (port names in ravel order, JAX shapes, sizes):
    ``ravel`` takes tensors by port name and returns one f32 vector;
    ``unravel`` returns views of such a vector by port name, in the port's
    layout."""

    def __init__(self, named: Dict[str, torch.Tensor], bn_name: str):
        order = sorted(named, key=lambda n: jax_path(n, bn_name))
        self.names: List[str] = order
        self.leaves = [jax_path(n, bn_name)[-1] for n in order]
        self.jax_shapes = [tuple(to_jax_layout(named[n], leaf).shape)
                           for n, leaf in zip(order, self.leaves)]
        self.sizes = [named[n].numel() for n in order]
        self.size = sum(self.sizes)

    def span(self, name: str) -> Tuple[int, int]:
        """``name``'s ``(start, stop)`` in the flat vector."""
        i = self.names.index(name)
        start = sum(self.sizes[:i])
        return start, start + self.sizes[i]

    @torch.no_grad()
    def ravel(self, tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
        ref = tensors[self.names[0]] if self.names else None
        out = torch.empty(self.size, dtype=torch.float32,
                          device=ref.device if ref is not None else "cpu")
        o = 0
        for name, leaf, shape, k in zip(self.names, self.leaves,
                                        self.jax_shapes, self.sizes):
            out[o:o + k].view(shape).copy_(to_jax_layout(tensors[name], leaf))
            o += k
        return out

    def unravel(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        if flat.shape != (self.size,):
            raise ValueError(f"unravel: expected a flat vector of "
                             f"{self.size} values, got {tuple(flat.shape)}")
        out, o = {}, 0
        for name, leaf, shape, k in zip(self.names, self.leaves,
                                        self.jax_shapes, self.sizes):
            out[name] = from_jax_layout(flat[o:o + k].view(shape), leaf)
            o += k
        return out


class FlatLayout:
    """The leaves of a module's params (and gradients), ``params``, and of
    its buffers (the JAX ``batch_stats``), ``stats``."""

    def __init__(self, module: nn.Module, bn_name: str = "BatchNorm"):
        self.bn_name = bn_name
        self.params = Leaves(dict(module.named_parameters()), bn_name)
        self.stats = Leaves(dict(module.named_buffers()), bn_name)
