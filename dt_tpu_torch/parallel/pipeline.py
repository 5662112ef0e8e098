"""GPipe pipeline parallelism over a mesh axis (counterpart of
``dt_tpu/parallel/pipeline.py``).

Stage ``i`` of ``S`` runs on the rank at position ``i`` of the ``pipe``
axis; ``M`` microbatches stream through the stages in ``M + S - 1`` ticks
(the usual bubble): at tick ``t`` stage ``i`` runs microbatch ``t - i``
when there is one, stage 0 reading the microbatch and each later stage
what stage ``i - 1`` sent it the tick before, and the last stage's
outputs come out offset by its ``S - 1`` ticks of fill
(``pipeline.py:30-57``).  The bubble's ticks compute nothing (the JAX
schedule computes zeros there, which no output reads).

:class:`_Pipeline` is one autograd function over the whole schedule.  Its
forward keeps each microbatch's graph; its backward runs the microbatches
in reverse, each stage receiving its outputs' gradients from stage ``i +
1`` and sending its inputs' gradients to stage ``i - 1`` (the transpose of
the forward's sends).  The input and output are replicated along the axis
(every rank computes the embedding and the head): the last stage's outputs
are broadcast to every rank, each of which uses them alike, so the
backward reads the last stage's own gradient and sums nothing; stage 0's
input gradient is broadcast back, so it is whole on every rank.  Each
stage's parameters get their gradient on their own rank only, which is the
only rank that holds them.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

from dt_tpu_torch.parallel import collectives as coll


def _broadcast(t: torch.Tensor, group, src: int) -> torch.Tensor:
    t = t.contiguous()
    dist.broadcast(t, dist.get_global_rank(group, src), group=group)
    return t


def _schedule(x: torch.Tensor, stage_fn, group, grad: bool):
    """The forward ticks on this rank: ``(y, ins, outs)``, ``y`` the last
    stage's ``(M, mb, ...)`` outputs broadcast to every rank, ``ins`` and
    ``outs`` this stage's microbatch inputs (graph leaves) and outputs,
    their graphs kept when ``grad``."""
    n, idx = coll.group_size(group), coll.group_rank(group)
    m = x.shape[0]
    ins: List[torch.Tensor] = []
    outs: List[torch.Tensor] = []
    recv = None
    for t in range(m + n - 1):
        mb = t - idx
        if 0 <= mb < m:
            h = x[mb] if idx == 0 else recv
            if grad:
                h = h.detach().requires_grad_()
            with torch.set_grad_enabled(grad):
                out = stage_fn(h)
            ins.append(h)
            outs.append(out)
        # stage i sends to i + 1 at the tick it computed; stage i + 1
        # takes it as its input at the next tick
        send = outs[-1].detach() if 0 <= mb < m and idx < n - 1 else None
        want = idx > 0 and 0 <= t + 1 - idx < m
        if send is not None or want:
            got = coll.exchange([send if send is not None else x[0]], group,
                                send_to=idx + 1 if send is not None else None,
                                recv_from=idx - 1 if want else None)
            recv = got[0] if got is not None else None
    last = torch.stack(outs).detach() if idx == n - 1 else \
        torch.empty(x.shape, dtype=x.dtype, device=x.device)
    return _broadcast(last, group, n - 1), ins, outs


class _Pipeline(torch.autograd.Function):
    """``apply(x, stage_fn, group, *params)``: ``x`` ``(M, mb, ...)``
    microbatches, the same on every rank; ``stage_fn(h)`` this rank's stage
    over ``params`` (the tensors its gradient is taken against).  Returns
    the last stage's ``(M, mb, ...)`` outputs on every rank."""

    @staticmethod
    def forward(ctx, x, stage_fn, group, *params):
        y, ins, outs = _schedule(x, stage_fn, group, grad=True)
        ctx.stage = (ins, outs, group, params)
        ctx.shape = x.shape
        return y

    @staticmethod
    def backward(ctx, gy):
        ins, outs, group, params = ctx.stage
        n, idx = coll.group_size(group), coll.group_rank(group)
        m = len(ins)
        pgrads = [None] * len(params)
        gx = torch.zeros(ctx.shape, dtype=gy.dtype, device=gy.device) \
            if idx == 0 else None
        for mb in reversed(range(m)):
            if idx == n - 1:
                g = gy[mb]
            else:  # the gradient of this stage's output, from stage i + 1
                g = coll.exchange([outs[mb].detach()], group, send_to=None,
                                  recv_from=idx + 1)[0]
            grads = torch.autograd.grad(outs[mb], [ins[mb]] + list(params), g,
                                        allow_unused=True)
            gin = grads[0] if grads[0] is not None \
                else torch.zeros_like(ins[mb])
            for j, gp in enumerate(grads[1:]):
                if gp is not None:
                    pgrads[j] = gp if pgrads[j] is None else pgrads[j] + gp
            if idx > 0:  # this stage's input gradient, to stage i - 1
                coll.exchange([gin], group, send_to=idx - 1, recv_from=None)
            else:
                gx[mb] = gin
        ctx.stage = None
        if gx is None:
            gx = torch.empty(ctx.shape, dtype=gy.dtype, device=gy.device)
        gx = _broadcast(gx, group, 0)
        return (gx, None, None) + tuple(pgrads)


def pipeline_run(stage_fn: Callable[[torch.Tensor], torch.Tensor],
                 params: Sequence[torch.Tensor], x: torch.Tensor,
                 group) -> torch.Tensor:
    """The GPipe schedule of this rank's stage ``stage_fn`` (differentiable
    in ``params``) over the microbatches ``x`` ``(M, mb, ...)``, along the
    ranks of ``group``.  Returns the last stage's ``(M, mb, ...)`` outputs,
    the same on every rank.  Every stage must keep its output's shape and
    dtype."""
    if not torch.is_grad_enabled():
        return _schedule(x, stage_fn, group, grad=False)[0]
    return _Pipeline.apply(x, stage_fn, group, *params)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stacked_params: Any, x: torch.Tensor, mesh,
                   axis_name: str = "pipe",
                   batch_axis: str = None) -> torch.Tensor:
    """Run ``x`` (microbatches ``(M, mb, ...)``) through ``S`` pipeline
    stages (``pipeline.py:60-101``).  ``stacked_params``: a pytree (dicts,
    lists) whose leaves have leading dim ``S``, the same on every rank;
    the rank at position ``i`` of ``axis_name`` runs ``stage_fn(params_i,
    h)`` with ``params_i`` the leaves' slice ``i``.  Returns the last
    stage's ``(M, mb, ...)`` outputs on every rank.  Differentiable: a
    rank's gradient of the stacked leaves is non-zero in its own slice
    only.  ``batch_axis`` (dp x pp) names the data axis the microbatch dim
    is split over: each rank passes its own rows, and the stages' sends
    ride ``axis_name`` only."""
    n = mesh.axis_size(axis_name)
    num_stages = _leaves(stacked_params)[0].shape[0]
    if num_stages != n:
        raise ValueError(
            f"stacked params carry {num_stages} stages but the "
            f"{axis_name!r} axis has {n} devices; they must match (fold "
            f"multiple layers into one stage_fn to run more layers per "
            f"device)")
    idx = mesh.axis_index(axis_name)
    mine = _map(lambda p: p[idx], stacked_params)
    if n == 1:
        return torch.stack([stage_fn(mine, h) for h in x.unbind(0)])
    return pipeline_run(lambda h: stage_fn(mine, h), _leaves(mine), x,
                        mesh.axis_group(axis_name))


def sequential_apply(stage_fn, stacked_params, x: torch.Tensor
                     ) -> torch.Tensor:
    """Single-device oracle (``pipeline.py:104-112``): the ``S`` stages in
    order over every microbatch of ``x`` ``(M, mb, ...)``."""
    s = _leaves(stacked_params)[0].shape[0]
    h = x
    for i in range(s):
        params_i = _map(lambda p, i=i: p[i], stacked_params)
        h = torch.stack([stage_fn(params_i, hh) for hh in h.unbind(0)])
    return h
