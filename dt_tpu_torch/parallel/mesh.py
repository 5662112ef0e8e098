"""The data-axis mesh over a ``torch.distributed`` process group
(counterpart of ``dt_tpu/parallel/mesh.py``).

The JAX package's mesh is a grid of devices with a ``data`` axis (the
workers: gradients are averaged over it) and a ``model`` axis (tensor
parallelism).  The port's mesh is the ``data`` axis alone: the ranks of a
process group, one device each, this process being ``rank``.  A batch
sharded over it is the rank-ordered concatenation of the ranks' local
parts, as ``jax.make_array_from_process_local_data`` assembles it
(``dt_tpu/training/module.py:584-597``).  A ``model`` axis of more than one
device raises: the parallel layer is ROADMAP.md, Queue 1 item 6.

A sharding here is the axis of a leaf split over ``data`` (``None``:
replicated), the one fact of a ``NamedSharding`` the data-axis mesh needs.
:func:`dp_axis` is the JAX package's ZeRO/FSDP rule (``module.py:530-551``):
a leaf shards along its largest axis divisible by the data-axis size, the
last such axis on a tie, in the JAX layout.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

_MODEL_AXIS = ("a model axis of more than one device is not ported yet "
               "(tensor parallelism); see ROADMAP.md, Queue 1 item 6")


class Mesh:
    """``size`` ranks of ``group`` (``None``: the default group, or no
    group at all for one rank) along ``data``; this process is ``rank`` and
    computes on ``device``.  ``shape`` reads as a JAX mesh's does."""

    def __init__(self, rank: int = 0, size: int = 1, group=None,
                 device: Optional[torch.device] = None, model: int = 1,
                 backend: Optional[str] = None):
        if model != 1:
            raise NotImplementedError(f"Mesh(model={model}): {_MODEL_AXIS}")
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} outside a mesh of {size}")
        self.rank, self.data, self.model = rank, size, model
        self.group = group
        self.device = torch.device(device) if device is not None else None
        self.backend = backend

    @property
    def shape(self) -> dict:
        return {"data": self.data, "model": self.model}

    @property
    def size(self) -> int:
        return self.data * self.model

    def __repr__(self) -> str:
        return (f"Mesh(rank={self.rank}, data={self.data}, "
                f"backend={self.backend}, device={self.device})")


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None, group=None) -> Mesh:
    """The mesh of the process group ``group`` (default: the default group
    when one is initialized, else this process alone).  ``data`` must be
    the group's size when given; ``model`` must be 1.  ``devices``, one
    device, is this process's (default: the current CUDA device where
    there is one, else the CPU)."""
    if model != 1:
        raise NotImplementedError(f"make_mesh(model={model}): {_MODEL_AXIS}")
    grouped = dist.is_available() and dist.is_initialized()
    size = dist.get_world_size(group) if grouped else 1
    rank = dist.get_rank(group) if grouped else 0
    if data is not None and data != size:
        raise ValueError(f"make_mesh(data={data}): the process group has "
                         f"{size} rank(s)")
    if devices is not None:
        devs = list(devices)
        if len(devs) != 1:
            raise NotImplementedError(
                f"{len(devs)} devices in one process: the port's mesh holds "
                "one device a rank")
        device = torch.device(devs[0])
    elif torch.cuda.is_available():
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    if not grouped:
        return Mesh(0, 1, None, device)
    group = group if group is not None else dist.group.WORLD
    return Mesh(rank, size, group, device, backend=dist.get_backend(group))


class Sharding(NamedTuple):
    """The axis a leaf is split along over ``data`` (``None``:
    replicated)."""
    axis: Optional[int]


def data_sharding(mesh: Mesh, ndim: int = 1) -> Sharding:
    """The leading (batch) axis split over ``data``, the rest
    replicated."""
    return Sharding(0)


def replicate_sharding(mesh: Mesh) -> Sharding:
    return Sharding(None)


def dp_axis(shape: Sequence[int], n: int) -> Optional[int]:
    """The axis a ZeRO/FSDP leaf of ``shape`` (JAX layout) is split along
    over ``n`` ranks: the largest axis of at least ``n`` divisible by
    ``n``, the last one on a tie; ``None`` (replicated) for a scalar or a
    leaf with no such axis (``module.py:530-551``)."""
    divisible = [(d, ax) for ax, d in enumerate(shape)
                 if d >= n and d % n == 0]
    if n <= 1 or not divisible:
        return None
    return max(divisible)[1]


def local_part(x, mesh: Mesh, sharding: Sharding):
    """This rank's part of the full leaf ``x`` (numpy or a tensor) under
    ``sharding``: equal slices along its axis, in rank order."""
    if sharding.axis is None or mesh.data == 1:
        return x
    n = x.shape[sharding.axis]
    if n % mesh.data:
        raise ValueError(f"axis {sharding.axis} of {tuple(x.shape)} does not "
                         f"split into {mesh.data} equal parts")
    k = n // mesh.data
    if isinstance(x, torch.Tensor):
        return x.narrow(sharding.axis, mesh.rank * k, k)
    idx = [slice(None)] * x.ndim
    idx[sharding.axis] = slice(mesh.rank * k, (mesh.rank + 1) * k)
    return x[tuple(idx)]


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a global host batch (a numpy array, or a tuple
    or dict of them): the batch is the rank-ordered concatenation of equal
    local parts, so rank ``r`` takes rows ``[r*k, (r+1)*k)``."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    return local_part(np.asarray(batch) if not isinstance(
        batch, torch.Tensor) else batch, mesh, data_sharding(mesh))
