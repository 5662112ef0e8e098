"""The device mesh over a ``torch.distributed`` process group (counterpart of
``dt_tpu/parallel/mesh.py``).

The JAX package's mesh is a 2-D grid of devices, data-major, with a
``data`` axis (the workers: gradients are averaged over it) and a second
axis, ``model`` by default (``pipe`` for the pipelined LM,
``examples/train_transformer_lm.py:73-74``), over which the parallel layer
shards sequences (ring and Ulysses attention), experts (MoE) and pipeline
stages.  The port's mesh is the same grid of processes, one device each:
rank ``r`` of the default group sits at ``(r // model, r % model)``, as
the JAX reshape places device ``r``.  Each axis has its own process groups
(``dist.new_group``): one along ``data`` a model column, one along the
second axis a data row; every rank creates every group, in the same order,
as ``new_group`` requires.

A batch sharded over ``data`` is the rank-ordered concatenation of the
ranks' local parts, as ``jax.make_array_from_process_local_data``
assembles it (``dt_tpu/training/module.py:584-597``).  ``rank``, ``data``
and ``group`` name the data axis (the one ``Module``, ZeRO/FSDP and
cross-rank BN use); the second axis is ``model``, ``model_rank`` and
``model_group``, and :meth:`Mesh.axis_size`, :meth:`Mesh.axis_index` and
:meth:`Mesh.axis_group` read either axis by name.  Dense weights stay whole
on every rank: the tensor-parallel sharding of the JAX example
(``examples/train_transformer_lm.py:121-134``) is not in either package.

A sharding here is the axis of a leaf split over ``data`` (``None``:
replicated), the one fact of a ``NamedSharding`` the data-axis mesh needs.
:func:`dp_axis` is the JAX package's ZeRO/FSDP rule (``module.py:530-551``):
a leaf shards along its largest axis divisible by the data-axis size, the
last such axis on a tie, in the JAX layout.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """A ``data`` x ``model`` grid of processes, this one at ``(rank,
    model_rank)``, computing on ``device``.  ``group`` holds the ranks along
    ``data`` that share this rank's model coordinate (``None``: the
    default group, or no group at all for one rank); ``model_group`` those
    along the second axis that share its data coordinate (``None`` when
    that axis has one rank).  ``axis_names`` names the two axes; ``shape``
    reads as a JAX mesh's does."""

    def __init__(self, rank: int = 0, size: int = 1, group=None,
                 device: Optional[torch.device] = None, model: int = 1,
                 backend: Optional[str] = None, *, model_rank: int = 0,
                 model_group=None,
                 axis_names: Tuple[str, str] = ("data", "model")):
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} outside a mesh of {size}")
        if not 0 <= model_rank < model:
            raise ValueError(f"model rank {model_rank} outside an axis of "
                             f"{model}")
        if len(axis_names) != 2 or axis_names[0] == axis_names[1]:
            raise ValueError(f"a mesh has two distinct axis names, got "
                             f"{axis_names!r}")
        self.rank, self.data, self.model = rank, size, model
        self.model_rank = model_rank
        self.group, self.model_group = group, model_group
        self.axis_names = tuple(axis_names)
        self.device = torch.device(device) if device is not None else None
        self.backend = backend

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, (self.data, self.model)))

    @property
    def size(self) -> int:
        return self.data * self.model

    def _axis(self, name: str) -> int:
        if name not in self.axis_names:
            raise ValueError(f"the mesh has axes {self.axis_names}, not "
                             f"{name!r}")
        return self.axis_names.index(name)

    def axis_size(self, name: str) -> int:
        return (self.data, self.model)[self._axis(name)]

    def axis_index(self, name: str) -> int:
        """This rank's coordinate along the axis ``name``."""
        return (self.rank, self.model_rank)[self._axis(name)]

    def axis_group(self, name: str):
        """The process group along the axis ``name`` that holds this rank
        (``None`` for an axis of one rank)."""
        return (self.group, self.model_group)[self._axis(name)]

    def __repr__(self) -> str:
        return (f"Mesh({self.axis_names[0]}={self.data}, "
                f"{self.axis_names[1]}={self.model}, rank=({self.rank}, "
                f"{self.model_rank}), backend={self.backend}, "
                f"device={self.device})")


def _device(devices) -> torch.device:
    if devices is not None:
        devs = list(devices)
        if len(devs) != 1:
            raise NotImplementedError(
                f"{len(devs)} devices in one process: the port's mesh holds "
                "one device a rank")
        return torch.device(devs[0])
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(data: Optional[int] = None, model: int = 1,
              devices: Optional[Sequence] = None,
              axis_names: Tuple[str, str] = ("data", "model"),
              group=None) -> Mesh:
    """The ``data`` x ``model`` mesh (data-major) of the process group
    ``group`` (default: the default group when one is initialized, else
    this process alone).  ``data=None`` takes the group's size over
    ``model``; ``data * model`` must be the group's size.  A ``model``
    axis of more than one rank needs the default group, whose ranks then
    all call this, in the same order as their other ``new_group`` calls.
    ``devices``, one device, is this process's (default: the current CUDA
    device where there is one, else the CPU)."""
    grouped = dist.is_available() and dist.is_initialized()
    size = dist.get_world_size(group) if grouped else 1
    if data is None:
        if model < 1 or size % model:
            raise ValueError(f"{size} devices not divisible by model={model}")
        data = size // model
    if data * model > size:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, "
                         f"have {size}")
    if data * model != size:
        raise ValueError(f"make_mesh(data={data}, model={model}): the process "
                         f"group has {size} rank(s); every rank is one "
                         "position of the grid")
    device = _device(devices)
    if not grouped:
        return Mesh(0, 1, None, device, axis_names=axis_names)
    backend = dist.get_backend(group)
    if model == 1:
        group = group if group is not None else dist.group.WORLD
        return Mesh(dist.get_rank(group), size, group, device,
                    backend=backend, axis_names=axis_names)
    if group is not None and group is not dist.group.WORLD:
        raise ValueError("a mesh with a model axis is made over the default "
                         "process group")
    r = dist.get_rank()
    col_group = row_group = None
    # every rank creates every group, columns (along data) then rows
    if data > 1:
        for j in range(model):
            g = dist.new_group([i * model + j for i in range(data)])
            if j == r % model:
                col_group = g
    for i in range(data):
        g = dist.new_group([i * model + j for j in range(model)])
        if i == r // model:
            row_group = g
    return Mesh(r // model, data, col_group, device, model, backend,
                model_rank=r % model, model_group=row_group,
                axis_names=axis_names)


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
