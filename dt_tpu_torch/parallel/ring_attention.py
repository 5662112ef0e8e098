"""Ring attention over a mesh axis, and the single-device oracle
(counterpart of ``dt_tpu/parallel/ring_attention.py``).

The sequence is split over the axis: each rank keeps its query block
resident and passes its K/V block around the ring, merging each block's
scores into streaming-softmax accumulators with the flash-attention
log-sum-exp rule, so the result is exact (Liu et al. 2023).  The per-rank
ring (``ring_attention.py:56-92``) is :class:`_Ring`: ``n - 1`` hops of
K/V after the blocks' products (send and receive posted together), with
the JAX package's handling of rows a block masks entirely (``NEG_INF``,
their ``beta`` exactly 0) and its global causal offsets; a block the
causal mask hides entirely (its keys all after the rank's queries) is
skipped.  Its backward recomputes each block's probabilities from the
saved row log-sum-exp and sends the K/V gradients round the reverse ring
with the blocks, the transpose of the forward's ``ppermute``.  The math is plain
PyTorch in f32, as the JAX version is plain ``jnp`` outside any Pallas
kernel.

:func:`ring_attention` keeps the JAX contract, global ``(B, S, H, D)`` in and
out: the ranks of the axis hold the same q/k/v (the model's dense parts run
replicated along it), each takes its sequence block, and the outputs are
gathered back (``parallel.collectives``, whose backward keeps the
gradients whole on every rank).
"""

from __future__ import annotations

from typing import Optional

import torch

from dt_tpu_torch.parallel import collectives as coll

NEG_INF = -1e30  # the JAX package's mask value (finite: no inf - inf NaN)


def _causal_mask(sq: int, sk: int, q_offset: int, k_offset: int,
                 device) -> torch.Tensor:
    qpos = q_offset + torch.arange(sq, device=device)
    kpos = k_offset + torch.arange(sk, device=device)
    return qpos[:, None] >= kpos[None, :]


def _scores(q, k, *, scale, causal, q_offset, k_offset) -> torch.Tensor:
    """f32 ``(B, H, Sq, Sk)`` scores, masked entries ``NEG_INF``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q_offset, k_offset,
                            q.device)
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    return s


def _block_attend(q, k, v, *, scale, causal, q_offset, k_offset):
    """Scores for one (q-block, k-block) pair and its streaming-softmax
    stats (``ring_attention.py:33-53``): ``(out_unnormalized, row_max,
    row_sumexp)`` in f32; q ``(B, Sq, H, D)``, k/v ``(B, Sk, H, D)``."""
    s = _scores(q, k, scale=scale, causal=causal, q_offset=q_offset,
                k_offset=k_offset)
    m = s.amax(dim=-1)  # (B, H, Sq)
    p = torch.exp(s - m[..., None])
    # fully masked rows: exp(NEG_INF - NEG_INF) = 1 would pollute; zero them
    p = torch.where(m[..., None] <= NEG_INF / 2, torch.zeros_like(p), p)
    l = p.sum(dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out, m, l


def _hidden(causal: bool, q_offset: int, sq: int, k_offset: int) -> bool:
    """Whether the causal mask hides the whole block: its first key comes
    after the rank's last query."""
    return causal and k_offset > q_offset + sq - 1


def _rows(t: torch.Tensor) -> torch.Tensor:
    """``(B, H, Sq)`` row stats broadcast against ``(B, Sq, H, D)``."""
    return t.movedim(1, -1)[..., None]


class _Ring(torch.autograd.Function):
    """The per-rank ring: local q/k/v blocks ``(B, S/n, H, D)`` of the rank
    at position ``idx`` of ``group``; returns the rank's output block."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        n, idx = coll.group_size(group), coll.group_rank(group)
        b, sq, h, d = q.shape
        sk = k.shape[1]
        q_offset = idx * sq
        acc = torch.zeros(b, sq, h, v.shape[-1], dtype=torch.float32,
                          device=q.device)
        row_max = torch.full((b, h, sq), NEG_INF, device=q.device)
        row_sum = torch.zeros((b, h, sq), device=q.device)
        k_cur, v_cur = k, v
        neg = torch.full((), NEG_INF, device=q.device)
        for i in range(n):
            # the K/V block held now came from rank (idx - i) mod n; a
            # block the mask hides has beta exactly 0 and changes nothing
            k_offset = ((idx - i) % n) * sk
            if not _hidden(causal, q_offset, sq, k_offset):
                out, m, l = _block_attend(q, k_cur, v_cur, scale=scale,
                                          causal=causal, q_offset=q_offset,
                                          k_offset=k_offset)
                new_max = torch.maximum(row_max, m)
                alpha = torch.exp(torch.where(row_max <= NEG_INF / 2, neg,
                                              row_max - new_max))
                beta = torch.exp(torch.where(m <= NEG_INF / 2, neg,
                                             m - new_max))
                row_sum = row_sum * alpha + l * beta
                acc = acc * _rows(alpha) + out * _rows(beta)
                row_max = new_max
            if i < n - 1:  # rotate K/V: rank d sends to d + 1
                k_cur, v_cur = coll.shift([k_cur, v_cur], group, 1)
        denom = torch.clamp(row_sum, min=1e-20)
        out = acc / _rows(denom)
        lse = row_max + torch.log(denom)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        n, idx = coll.group_size(group), coll.group_rank(group)
        sq, sk = q.shape[1], k.shape[1]
        q_offset = idx * sq
        go = g.float()
        delta = (go * out).sum(dim=-1).movedim(1, -1)  # (B, H, Sq)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        q32 = q.float()
        # backward steps run n-1 .. 0; at step i the rank holds the block of
        # rank (idx - i) mod n with the gradients gathered for it so far,
        # and hands both to rank idx - 1 (the reverse ring)
        k_cur, v_cur = coll.shift([k, v], group, -1)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for i in reversed(range(n)):
            k_offset = ((idx - i) % n) * sk
            if not _hidden(causal, q_offset, sq, k_offset):
                s = _scores(q, k_cur, scale=scale, causal=causal,
                            q_offset=q_offset, k_offset=k_offset)
                p = torch.exp(s - lse[..., None])
                dv = dv + torch.einsum("bhqk,bqhd->bkhd", p, go)
                dp = torch.einsum("bqhd,bkhd->bhqk", go, v_cur.float())
                ds = p * (dp - delta[..., None]) * scale
                dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, k_cur.float())
                dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, q32)
            if i > 0:
                k_cur, v_cur, dk, dv = coll.shift([k_cur, v_cur, dk, dv],
                                                  group, -1)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh,
                   *, axis_name: str = "data", causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact attention with the sequence split over the mesh axis
    ``axis_name`` (``ring_attention.py:95-111``).  ``q``/``k``/``v``: global
    ``(B, S, H, D)``, the same on every rank of the axis; S must divide by
    the axis size.  Returns the global ``(B, S, H, D)`` output in ``q``'s
    dtype, the same on every rank.  Differentiable."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    n = mesh.axis_size(axis_name)
    if q.shape[1] % n:
        raise ValueError(f"sequence length {q.shape[1]} must divide by the "
                         f"{axis_name!r} axis size {n}")
    group = mesh.axis_group(axis_name)
    ql, kl, vl = (coll.split(t, group, 1) for t in (q, k, v))
    out = _Ring.apply(ql, kl, vl, group, causal, float(scale))
    return coll.gather(out, group, 1)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention of ``(B, S, H, D)`` q/k/v (``ring_attention.py:
    114-126``), the single-device oracle: f32 scores ``q k^T * scale``
    (``scale`` defaults to ``D**-0.5``), masked entries set to ``NEG_INF``
    under ``causal``, softmax and the product with f32 ``v``; the output in
    ``q``'s dtype.  It holds the whole ``(B, H, S, S)`` f32 score matrix."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s = _scores(q, k, scale=scale, causal=causal, q_offset=0, k_offset=0)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
