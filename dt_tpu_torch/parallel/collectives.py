"""The collectives of the parallel layer over a mesh axis's process group.

The JAX package's parallel layer runs inside ``shard_map``, where XLA
differentiates its collectives (``ppermute``, ``all_to_all``).  The port
runs one process a mesh position and keeps the model's dense parts
replicated along the axis: every rank of the axis group computes them on
the same tokens.  Crossing into and out of a sharded region therefore needs
operations whose backward keeps each replicated tensor's gradient whole and
equal on every rank (a gradient summed over ``n`` identical copies would be
``n`` times too large):

- :func:`split` (this rank's chunk of a dimension; backward: the chunks'
  gradients gathered) and :func:`gather` (the chunks gathered; backward:
  this rank's chunk of the gradient);
- :func:`copy_to` (identity; backward: the ranks' partial gradients
  summed) and :func:`reduce_from` (the ranks' partial results summed;
  backward: identity), the pair around expert parallelism;
- :func:`all_to_all`, tiled as JAX's (backward: the inverse all-to-all);
- :func:`shift` and :func:`exchange`, point-to-point sends along a ring or
  a chain (``batch_isend_irecv``, so no send waits for its receiver).

``group`` ``None`` is an axis of one rank: each operation is then the
identity.  A real group of one rank runs its collective all the same.
``exchange.bytes_sent`` and ``all_to_all.bytes_sent`` count the bytes this
process handed to each (the ring's K/V hops; Ulysses' re-partitions, the
part a rank keeps included).

The backend decides how device tensors travel, and nothing falls back:
gloo's point-to-point and all-to-all take CPU tensors only, so under gloo a
CUDA tensor is staged through pinned host memory explicitly (the compute
stays on the card); NCCL passes device tensors.  gloo's ``all_reduce``,
``broadcast`` and ``all_gather_into_tensor`` take CUDA tensors.  A failed
collective raises.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def group_rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _staged(device: torch.device, group) -> bool:
    """Whether a tensor on ``device`` must cross ``group`` through host
    memory: a CUDA tensor on a gloo group (gloo's send, recv and
    all-to-all take CPU tensors)."""
    return device.type == "cuda" and dist.get_backend(group) == "gloo"


def _to_wire(t: torch.Tensor, group) -> torch.Tensor:
    t = t.contiguous()
    if not _staged(t.device, group):
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host


def _buffer(nbytes: int, device: torch.device, group) -> torch.Tensor:
    """A receive buffer of ``nbytes`` for a tensor on ``device``: pinned
    host memory where it must be staged, else on the device."""
    if _staged(device, group):
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    return torch.empty(nbytes, dtype=torch.uint8, device=device)


def _pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """One flat byte tensor of ``tensors`` (one message a hop)."""
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8)
                      for t in tensors])


def _unpack(flat: torch.Tensor, like: Sequence[torch.Tensor]
            ) -> List[torch.Tensor]:
    out, o = [], 0
    for t in like:
        k = t.numel() * t.element_size()
        out.append(flat[o:o + k].view(t.dtype).view(t.shape))
        o += k
    return out


def exchange(tensors: Sequence[torch.Tensor], group, *,
             send_to: Optional[int], recv_from: Optional[int]
             ) -> Optional[List[torch.Tensor]]:
    """Send ``tensors`` (one packed message) to the group rank ``send_to``
    and receive the same shapes and dtypes from ``recv_from`` (either may
    be ``None``); both are posted together.  Returns the received tensors
    on ``tensors``' device, or ``None`` when nothing is received."""
    dev = tensors[0].device
    ops, recv = [], None
    if send_to is not None:
        msg = _to_wire(_pack(tensors), group)
        exchange.bytes_sent += msg.numel()
        ops.append(dist.P2POp(dist.isend, msg,
                              dist.get_global_rank(group, send_to), group))
    if recv_from is not None:
        recv = _buffer(sum(t.numel() * t.element_size() for t in tensors),
                       dev, group)
        ops.append(dist.P2POp(dist.irecv, recv,
                              dist.get_global_rank(group, recv_from), group))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    if recv is None:
        return None
    return _unpack(recv.to(dev), tensors)


exchange.bytes_sent = 0


def shift(tensors: Sequence[torch.Tensor], group, step: int = 1
          ) -> List[torch.Tensor]:
    """Rotate ``tensors`` around the ring of ``group``: send them to group
    rank ``r + step``, receive those of ``r - step`` (mod the size)."""
    n, r = group_size(group), group_rank(group)
    if n == 1:
        return list(tensors)
    return exchange(tensors, group, send_to=(r + step) % n,
                    recv_from=(r - step) % n)


def _all_gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    x = x.contiguous()
    out = torch.empty((n,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out.view(-1), x.view(-1), group=group)
    return torch.cat(out.unbind(0), dim=dim)


def _chunk(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = group_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {dim} of {tuple(x.shape)} does not split "
                         f"into {n} equal parts")
    k = x.shape[dim] // n
    return x.narrow(dim, group_rank(group) * k, k).contiguous()


def _a2a(x: torch.Tensor, group, split_dim: int,
         concat_dim: int) -> torch.Tensor:
    n = group_size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"dimension {split_dim} of {tuple(x.shape)} does not "
                         f"split into {n} equal parts")
    send = torch.stack(x.chunk(n, dim=split_dim))  # (n, ...) part j -> j
    wire = _to_wire(send, group)
    all_to_all.bytes_sent += wire.numel() * wire.element_size()
    recv = torch.empty_like(wire)
    dist.all_to_all_single(recv, wire, group=group)
    return torch.cat(recv.to(x.device).unbind(0), dim=concat_dim)


def _sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` (in float32 for a narrower float: each of the
    layer's sums has one non-zero term a value, or is a gradient)."""
    buf = x.float().contiguous() if x.dtype in (torch.bfloat16,
                                                torch.float16) \
        else x.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(buf, group=group)
    return buf.to(x.dtype)


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _chunk(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.group, ctx.dim), None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _chunk(g, ctx.group, ctx.dim), None, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return _a2a(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return _a2a(g, group, concat_dim, split_dim), None, None, None


def split(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's equal chunk of ``x`` (the same on every rank) along
    ``dim``; the backward gathers the chunks' gradients, so ``x``'s
    gradient is whole on every rank."""
    if group is None:
        return x
    return _Split.apply(x, group, dim)


def gather(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """The ranks' chunks concatenated along ``dim`` in rank order; the
    backward takes this rank's chunk of the (replicated) gradient, no
    sum."""
    if group is None:
        return x
    return _Gather.apply(x, group, dim)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` itself, entering a region whose ranks each compute part of a
    result; the backward sums the ranks' partial gradients of ``x``."""
    if group is None:
        return x
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of the ranks' partial results ``x``, used alike by every
    rank after it; the backward passes the gradient through, no sum."""
    if group is None:
        return x
    return _ReduceFrom.apply(x, group)


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """JAX's tiled ``all_to_all``: ``split_dim`` cut into ``n`` parts, part
    ``j`` sent to rank ``j``, the parts received concatenated along
    ``concat_dim`` in rank order.  Differentiable (backward: the inverse
    all-to-all)."""
    if group is None:
        return x
    return _AllToAll.apply(x, group, split_dim, concat_dim)


all_to_all.bytes_sent = 0
