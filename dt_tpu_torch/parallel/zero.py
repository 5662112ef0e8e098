"""ZeRO-1 and FSDP over the data-axis mesh (the JAX ``Module``'s
``shard_opt_state`` and ``shard_params``, ``dt_tpu/training/module.py:
159-174, 390-440``).

The JAX package gives each leaf a ``NamedSharding`` along its largest axis
divisible by the data-axis size (``parallel.mesh.dp_axis``) and lets GSPMD
insert the collectives.  The port does them by hand, on the same leaves
(the axis is chosen in the JAX layout, then mapped to the port's tensor):

- ZeRO-1 (``opt``): each rank keeps its slice of every sharded leaf of
  every per-param slot of the optimizer state (momentum, Adam's moments,
  the f32 masters ...); the update runs on the slices of params, gradient
  and slots, then the params' slices are all-gathered, so every rank
  holds the whole updated params; the counts and the other small leaves
  stay whole;
- FSDP (``params``): between steps each rank keeps only its slice of every
  sharded param (the module's tensor is emptied); :meth:`ShardPlan.
  gather_params` all-gathers them before the forward.  The port gathers
  every param at the start of the step, not layer by layer as XLA does,
  so FSDP lowers the bytes held between steps, not the step's peak.

An elementwise rule (SGD, Adam ...) gives on the slices the bits of the
whole update, so both modes train exactly as plain data parallelism
does.  ``lbsgd``'s and ``lamb``'s ratios take whole parameters' norms: the
update's ``reduce`` sums the slices' squares over the data group first
(:meth:`ShardPlan._sumsq`), which rounds in another order than one
process's norm.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from dt_tpu_torch.optim.state import export_leaf, map_state
from dt_tpu_torch.optim.state import leaves as opt_leaves
from dt_tpu_torch.optim.state import slots as opt_slots
from dt_tpu_torch.parallel.mesh import Mesh, Sharding, dp_axis, local_part

# the port axis of each axis of a JAX ``kernel`` (``interchange.
# to_jax_layout``): HWIO of OIHW, (in, out) of (out, in)
_KERNEL_AXES = {4: (2, 3, 1, 0), 2: (1, 0)}


def port_axis(jax_axis: Optional[int], leaf: str, ndim: int
              ) -> Optional[int]:
    """The axis of the port tensor that is ``jax_axis`` of the JAX leaf
    named ``leaf``."""
    if jax_axis is None or leaf != "kernel" or ndim not in _KERNEL_AXES:
        return jax_axis
    return _KERNEL_AXES[ndim][jax_axis]


def coverage(leaves, n: int) -> Tuple[float, int, int]:
    """``(fraction, sharded_bytes, total_bytes)`` of ``leaves``, ``(shape,
    itemsize, split)`` each (``shape`` in the JAX layout; ``split``: the
    leaf is held in slices over ``n`` ranks), as ``_coverage``
    (``module.py:393-408``) counts a state's leaves."""
    sharded = total = 0
    for shape, itemsize, split in leaves:
        nbytes = itemsize
        for d in shape:
            nbytes *= d
        total += nbytes
        if split:
            sharded += nbytes
    return sharded / max(total, 1), sharded, total


class ShardPlan:
    """Which leaves of a ``TrainState`` split over ``mesh`` and how, and the
    collectives that keep them so.  ``opt``: ZeRO-1 (every per-param slot
    of the optimizer state); ``params``: FSDP."""

    def __init__(self, state, mesh: Mesh, opt: bool, params: bool):
        self.mesh = mesh
        self.opt = opt
        self.params = params
        lay = state.layout.params
        named = state.params
        self.axis: Dict[str, int] = {}
        jax_shape = dict(zip(lay.names, lay.jax_shapes))
        for name, leaf, shape in zip(lay.names, lay.leaves, lay.jax_shapes):
            ax = dp_axis(shape, mesh.data)
            if ax is not None:
                self.axis[name] = port_axis(ax, leaf, named[name].dim())
        self._full = {name: (tuple(p.shape), p.stride())
                      for name, p in named.items()}
        self._shards: Dict[str, torch.Tensor] = {}  # FSDP: this rank's
        self.report = {}
        if self.opt:
            # every slot leaf splits as its param does; the counts (int32)
            # and the other small leaves stay whole beside them
            leaves = [(jax_shape[n], t.element_size(), n in self.axis)
                      for _, slot in opt_slots(state.opt_state, named)
                      for n, t in slot.items()]
            leaves += [(np.shape(v), export_leaf(v).itemsize, False)
                       for v in opt_leaves(state.opt_state, named)]
            self.report["opt_state"] = coverage(leaves, mesh.data)
        if self.params:
            self.report["params"] = coverage(
                [(jax_shape[n], p.element_size(), n in self.axis)
                 for n, p in named.items()], mesh.data)

    # -- placement -------------------------------------------------------

    def _part(self, name: str, t: torch.Tensor) -> torch.Tensor:
        ax = self.axis.get(name)
        return t if ax is None else local_part(t, self.mesh, Sharding(ax))

    @torch.no_grad()
    def shard(self, state) -> None:
        """Commit a whole state to the sharded layout: this rank's slice
        of each sharded leaf of every optimizer slot (ZeRO-1), the params
        released (FSDP)."""
        if self.opt:
            for _, slot in opt_slots(state.opt_state, self._full):
                for name in self.axis:
                    slot[name] = self._part(name, slot[name]).clone()
        if self.params:
            self.release_params(state)

    @torch.no_grad()
    def release_params(self, state) -> None:
        """FSDP: keep this rank's slice of each sharded param and empty
        the module's tensor (a forward before :meth:`gather_params` then
        fails on its shape)."""
        for name, p in state.params.items():
            if name in self.axis:
                self._shards[name] = self._part(name, p).clone()
                p.data = p.data.new_empty(0)

    @torch.no_grad()
    def materialize(self, state) -> None:
        """Whole, unfilled tensors for every sliced param and slot leaf,
        for a snapshot to be loaded into (no collective)."""
        params = state.params
        for name in self._shards:
            shape, stride = self._full[name]
            params[name].data = torch.empty_strided(
                shape, stride, dtype=self._shards[name].dtype,
                device=self._shards[name].device)
        self._shards = {}
        if self.opt:
            for _, slot in opt_slots(state.opt_state, self._full):
                for name in self.axis:
                    slot[name] = torch.empty_strided(
                        *self._full[name], dtype=slot[name].dtype,
                        device=slot[name].device)

    @property
    def released(self) -> bool:
        return bool(self._shards)

    @torch.no_grad()
    def gather_params(self, state) -> None:
        """FSDP: the whole params back in the module, all-gathered from
        every rank's slices (a collective: every rank calls it)."""
        if not self._shards:
            return
        params = state.params
        fulls = {}
        for name, part in self._shards.items():
            shape, stride = self._full[name]
            params[name].data = torch.empty_strided(
                shape, stride, dtype=part.dtype, device=part.device)
            fulls[name] = params[name]
        self._all_gather(self._shards, fulls)
        self._shards = {}

    # -- the update ------------------------------------------------------

    @torch.no_grad()
    def apply_gradients(self, state, grads: Dict[str, torch.Tensor]) -> None:
        """One optimizer update from the averaged gradient ``grads`` (whole
        leaves, by name): on the slices under ZeRO-1, then the params'
        slices all-gathered; whole under FSDP alone.  FSDP then releases
        the params again."""
        if self.opt:
            params = state.params
            views = {n: self._part(n, p) for n, p in params.items()}
            gv = {n: self._part(n, grads[n]) for n in params}
            state.opt_state = state.tx.update(gv, state.opt_state, views,
                                              reduce=self._sumsq)
            state.step += 1
            if not self.params:
                self._all_gather({n: views[n] for n in self.axis},
                                 {n: params[n] for n in self.axis})
        else:
            state.apply_gradients(grads)
        if self.params:
            self.release_params(state)

    # -- whole copies ------------------------------------------------------

    @torch.no_grad()
    def full_params(self, state) -> Dict[str, torch.Tensor]:
        """Every param whole, in new tensors where FSDP holds slices (a
        collective then); the module's own tensors otherwise."""
        params = state.params
        if not self._shards:
            return params
        out = dict(params)
        fulls = {n: torch.empty_strided(*self._full[n], dtype=s.dtype,
                                        device=s.device)
                 for n, s in self._shards.items()}
        self._all_gather(self._shards, fulls)
        out.update(fulls)
        return out

    @torch.no_grad()
    def full_opt_state(self, state) -> dict:
        """The optimizer state with every slot leaf whole (a collective
        under ZeRO-1)."""
        if not self.opt:
            return state.opt_state

        def whole(path, slot):
            out = dict(slot)
            fulls = {n: torch.empty_strided(*self._full[n],
                                            dtype=slot[n].dtype,
                                            device=slot[n].device)
                     for n in self.axis}
            self._all_gather({n: slot[n] for n in self.axis}, fulls)
            out.update(fulls)
            return out
        return map_state(state.opt_state, self._full, whole)

    def _sumsq(self, names, partial: torch.Tensor) -> torch.Tensor:
        """The whole leaves' sums of squares from this rank's partial ones
        (``partial[i]`` of ``names[i]``): summed over the data group where
        the leaf is held in slices, as they are where it is whole (one
        all-reduce; ``lbsgd``'s and ``lamb``'s norms)."""
        split = torch.tensor([n in self.axis for n in names],
                             device=partial.device)
        total = torch.where(split, partial, torch.zeros_like(partial))
        dist.all_reduce(total, group=self.mesh.group)
        return torch.where(split, total, partial)

    def _all_gather(self, parts: Dict[str, torch.Tensor],
                    fulls: Dict[str, torch.Tensor]) -> None:
        """Fill each whole tensor of ``fulls`` from every rank's slice of it
        (``parts`` holds this rank's): one all-gather of the slices laid end
        to end, for each dtype."""
        names = sorted(parts)
        w = self.mesh.data
        for dtype in sorted({parts[n].dtype for n in names}, key=str):
            group = [n for n in names if parts[n].dtype == dtype]
            send = torch.cat([parts[n].reshape(-1) for n in group])
            recv = all_gather_flat(send, self.mesh)
            for r in range(w):
                o = 0
                for n in group:
                    k = parts[n].numel()
                    ax = self.axis[n]
                    m = fulls[n].shape[ax] // w
                    fulls[n].narrow(ax, r * m, m).copy_(
                        recv[r, o:o + k].view(parts[n].shape))
                    o += k


def all_gather_flat(send: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """``(ranks, n)``: every rank's 1-D ``send`` (equal sizes), in rank
    order."""
    recv = torch.empty(mesh.data * send.numel(), dtype=send.dtype,
                       device=send.device)
    dist.all_gather_into_tensor(recv, send, group=mesh.group)
    return recv.view(mesh.data, -1)
