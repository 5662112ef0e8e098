"""Mixture-of-experts layer with expert parallelism over a mesh axis
(counterpart of ``dt_tpu/parallel/moe.py``).

Switch-Transformer routing (Fedus et al. 2021): top-1 gating, a fixed
expert capacity ``C = max(1, int(ceil(T/E) * capacity_factor))``, tokens
taking slots in arrival order and the overflow dropped (its output is 0;
the residual path carries it), and the load-balancing loss ``E * sum_e f_e
* P_e``.  :func:`switch_route` returns the JAX package's one-hot
``(T, E, C)`` dispatch and combine tensors.  :class:`MoEMLP` dispatches and
combines by index instead of by one-hot ``einsum`` (each of those products
sums exactly one non-zero term), so it never builds the ``(T, E, C)``
tensors: at the LM's width they are 1.34 GB a block in f32.

Expert parallelism: with ``mesh`` and an ``axis`` of ``n > 1`` ranks, each
rank holds ``E / n`` experts (``wi``/``wo`` rows ``[r E/n, (r+1) E/n)``
of the JAX leaves; a parameter's ``jax_rows`` says which) and computes them
for the tokens routed to them.  The ranks hold the same tokens (the dense
parts run replicated along the axis); the partial outputs are summed over
the axis group, and the tokens and gates enter through
``collectives.copy_to``, whose backward sums the ranks' partial gradients,
so every replicated tensor's gradient is whole on every rank.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from dt_tpu_torch.parallel import collectives as coll


def _softmax(logits: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax``'s arithmetic: ``exp(x - max) / sum``."""
    u = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return u / u.sum(dim=-1, keepdim=True)


class Route:
    """Top-1 capacity routing of ``T`` tokens, by index: each token's
    ``expert``, its ``slot`` in that expert's queue (arrival order), whether
    it is ``kept`` (slot < capacity), its ``gate`` (the top probability),
    and the pre-weight ``aux`` loss term (not yet times ``aux_weight``)."""

    def __init__(self, logits: torch.Tensor, capacity: int):
        t, e = logits.shape
        probs = _softmax(logits)
        self.gate, self.expert = probs.max(dim=-1)
        onehot = torch.nn.functional.one_hot(self.expert, e).to(logits.dtype)
        # position of each token within its expert's queue
        pos = torch.cumsum(onehot, dim=0) * onehot - 1.0
        self.slot = (pos * onehot).sum(dim=-1).long()
        self.kept = self.slot < capacity
        self.capacity = capacity
        self.onehot, self.probs = onehot, probs
        f = onehot.mean(dim=0)  # fraction routed
        p = probs.mean(dim=0)   # mean router probability
        self.aux = e * torch.sum(f * p)


def switch_route(logits: torch.Tensor, capacity: int):
    """Top-1 capacity routing (``moe.py:34-60``).  ``logits``: ``(T, E)``.
    Returns ``(dispatch (T, E, C), combine (T, E, C), aux)``: token ``t``
    goes to its argmax expert at its arrival slot if that is < C;
    ``dispatch`` is the 0/1 mask, ``combine`` carries the gate
    probability on the same support."""
    r = Route(logits, capacity)
    slot = torch.nn.functional.one_hot(
        torch.where(r.kept, r.slot, torch.zeros_like(r.slot)),
        capacity).to(logits.dtype)
    dispatch = r.onehot[:, :, None] * slot[:, None, :] \
        * r.kept.to(logits.dtype)[:, None, None]
    combine = dispatch * r.gate[:, None, None]
    return dispatch, combine, r.aux


class MoEMLP(nn.Module):
    """Expert MLP block, a drop-in for a dense FFN (``moe.py:63-118``):
    ``x`` ``(B, S, D)`` -> ``(B, S, D)``.  The router (``router``, D -> E, no
    bias) computes in f32; ``wi`` ``(E, D, H)`` and ``wo`` ``(E, H, D)`` are
    f32 parameters cast to the compute ``dtype``; each expert is
    ``relu(x wi) wo``, its output scaled by the gate.  After each forward
    ``aux_loss`` holds ``aux_weight * aux`` (pre-weighted, as the JAX layer
    sows it), which ``training.Module`` adds to the objective
    (:func:`aux_losses`)."""

    def __init__(self, embed_dim: int, num_experts: int = 4,
                 hidden_ratio: int = 4, capacity_factor: float = 1.25,
                 aux_weight: float = 0.01, mesh=None, axis: str = "model",
                 dtype: torch.dtype = torch.float32):
        # imported here: dt_tpu_torch.models imports this module
        from dt_tpu_torch.models.common import Dense
        super().__init__()
        self.num_experts = num_experts
        self.capacity_factor = capacity_factor
        self.aux_weight = aux_weight
        self.dtype = dtype
        n = mesh.axis_size(axis) if mesh is not None else 1
        if num_experts % n:
            raise ValueError(f"num_experts={num_experts} must divide by the "
                             f"{axis!r} axis size {n}")
        self.group = mesh.axis_group(axis) if n > 1 else None
        self.mesh_axes = (axis,) if n > 1 else ()
        local = num_experts // n
        self.first = (mesh.axis_index(axis) if n > 1 else 0) * local
        hidden = embed_dim * hidden_ratio
        self.router = Dense(embed_dim, num_experts, torch.float32,
                            use_bias=False)
        self.wi = nn.Parameter(torch.zeros(local, embed_dim, hidden))
        self.wo = nn.Parameter(torch.zeros(local, hidden, embed_dim))
        if n > 1:
            for p in (self.wi, self.wo):
                p.jax_rows = (self.first, num_experts)
        self.aux_loss: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        e = self.num_experts
        tokens = x.reshape(b * s, d)
        t = tokens.shape[0]
        capacity = max(1, int(-(-t // e) * self.capacity_factor))
        route = Route(self.router(tokens.float()), capacity)
        self.aux_loss = self.aux_weight * route.aux
        local = self.wi.shape[0]
        mine = route.kept & (route.expert >= self.first) \
            & (route.expert < self.first + local)
        # a token not dispatched here goes to a spare slot past the
        # capacity, whose output is never read (fixed shapes, no host sync)
        e_idx = torch.where(mine, route.expert - self.first,
                            torch.zeros_like(route.expert))
        c_idx = torch.where(mine, route.slot,
                            torch.full_like(route.slot, capacity))
        toks = coll.copy_to(tokens.to(self.dtype), self.group)
        gate = coll.copy_to(route.gate, self.group)
        # dispatch: each kept token to its expert's slot (one term a sum)
        xin = torch.zeros(local, capacity + 1, d, dtype=self.dtype,
                          device=x.device).index_put((e_idx, c_idx), toks)
        hmid = torch.relu(torch.bmm(xin, self.wi.to(self.dtype)))
        xout = torch.bmm(hmid, self.wo.to(self.dtype))
        # combine: the gate (cast to the compute dtype) times the slot's out
        part = torch.where(mine[:, None],
                           gate.to(self.dtype)[:, None] * xout[e_idx, c_idx],
                           torch.zeros((), dtype=self.dtype, device=x.device))
        return coll.reduce_from(part, self.group).reshape(b, s, d)


def aux_losses(module: nn.Module) -> list:
    """The pre-weighted auxiliary losses the module's MoE layers left in
    their last forward (the JAX ``aux_loss`` collection)."""
    return [m.aux_loss for m in module.modules()
            if isinstance(m, MoEMLP) and m.aux_loss is not None]
