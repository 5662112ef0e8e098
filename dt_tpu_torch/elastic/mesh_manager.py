"""The mesh's lifecycle across membership changes (counterpart of
``dt_tpu/elastic/mesh_manager.py``).

A process group cannot change its members, so a membership change tears
the world down and forms it again with the new members, at an epoch
boundary, from a host snapshot of the state (``MeshManager.rebuild``,
``mesh_manager.py:229-248``).  The world is a ``torch.distributed``
process group over a ``TCPStore`` whose server lives in the coordinator's
worker process (rank 0 of the first world; never in the scheduler, which
imports no torch).  Each generation of the world reads and writes its own
key prefix of that store, so a new world never reads the last one's keys.

The backend follows the topology, is recorded in :attr:`MeshManager.
backend` with its reason, and is never a fallback: NCCL where every rank
owns its own CUDA device, gloo where ranks share one device or compute on
the CPU (NCCL refuses two ranks on one device).  A failed NCCL world
raises.

Losing the coordinator loses the store: the survivors restart and form a
new world from the epoch-end snapshot, as the JAX package's scope note
says (``mesh_manager.py:181-189``).
"""

from __future__ import annotations

import datetime
import logging
import socket
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from dt_tpu_torch.obs import trace as obs_trace
from dt_tpu_torch.parallel import mesh as mesh_lib

logger = logging.getLogger("dt_tpu_torch.elastic")

# how long a rank waits for the store, its peers and a collective
_TIMEOUT = datetime.timedelta(seconds=120)


def _is_train_state(state) -> bool:
    return hasattr(state, "layout") and hasattr(state, "opt_state")


def snapshot_state(state: Any) -> Any:
    """The state whole on the host.  A ``TrainState`` becomes ``{step,
    params, batch_stats, opt_state}`` as numpy in the JAX package's names
    and layout (what a joiner bootstraps from); its ZeRO/FSDP slices are
    all-gathered first, a collective every rank of the world attends (the
    epoch-boundary contract).  A dict of tensors becomes a dict of
    numpy."""
    if _is_train_state(state):
        from dt_tpu_torch.interchange import export_jax_tree
        plan = getattr(state, "shards", None)
        if plan is None:
            params, opt = state.params, state.opt_state
        else:
            params, opt = plan.full_params(state), plan.full_opt_state(state)
        return export_jax_tree(state.step, params.items(),
                               state.module.named_buffers(), opt,
                               module=state.module)
    if isinstance(state, dict):
        return {k: snapshot_state(v) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        t = state.detach()
        return (t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy()
    return np.asarray(state)


def restore_state(host_state: Any, mesh, shardings: Any = None,
                  state: Any = None) -> Any:
    """Place a host snapshot on ``mesh``, with no collective: every rank is
    handed the same blob and takes its own slices.  With ``state`` (a
    ``TrainState``) the blob, in the JAX layout, is loaded into it whole
    (its owner shards it again for the new world) and ``state`` is
    returned.  Else each leaf becomes a tensor on the mesh's device, this
    rank's part under ``shardings`` (a matching tree of
    ``mesh.Sharding``; default: every leaf whole)."""
    if state is not None:
        from dt_tpu_torch.interchange import load_jax_train_state
        if state.shards is not None:
            state.shards.materialize(state)
            state.shards = None
        return load_jax_train_state(state, host_state)
    device = mesh.device or torch.device("cpu")

    def put(x, sh):
        if isinstance(x, dict):
            return {k: put(v, sh.get(k) if isinstance(sh, dict) else sh)
                    for k, v in x.items()}
        part = mesh_lib.local_part(np.asarray(x), mesh,
                                   sh or mesh_lib.replicate_sharding(mesh))
        return torch.from_numpy(np.ascontiguousarray(part)).to(device)
    return put(host_state, shardings)


def _device_id(device: torch.device) -> str:
    """Which physical device a rank computes on, comparable across
    processes: ``cpu``, or the host and the CUDA device's UUID."""
    if device.type != "cuda":
        return "cpu"
    props = torch.cuda.get_device_properties(device)
    return f"{socket.gethostname()}/{getattr(props, 'uuid', device.index)}"


def choose_backend(ids) -> tuple:
    """``(backend, reason)`` for ranks computing on devices ``ids`` (as
    :func:`_device_id` names them)."""
    if any(i == "cpu" for i in ids):
        return "gloo", "ranks compute on the CPU"
    if len(set(ids)) == len(ids):
        return "nccl", "every rank owns its own CUDA device"
    return "gloo", ("ranks share a CUDA device, which NCCL refuses; gloo "
                    "carries the collectives through host memory")


class MeshManager:
    """The process group and mesh of one worker process.

    ``coordinator_address`` (``host:port``) is where rank 0 serves the
    store; ``device`` is this process's device (default ``cuda``; the CPU
    only when asked).  ``local_device_count`` is accepted for the JAX
    signature and must be 1 or ``None``: the port's mesh holds one device
    a rank."""

    def __init__(self, coordinator_address: Optional[str] = None,
                 local_device_count: Optional[int] = None,
                 device: Any = "cuda"):
        if local_device_count not in (None, 1):
            raise NotImplementedError(
                f"local_device_count={local_device_count}: the port's mesh "
                "holds one device a process")
        from dt_tpu_torch.config import resolve_device
        self.coordinator_address = coordinator_address
        self.local_device_count = local_device_count
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._initialized = False
        self._store = None  # the TCPStore (its server on the coordinator)
        self._generation = 0
        self.backend: Optional[str] = None
        self.backend_reason: Optional[str] = None
        self.mesh: Optional[mesh_lib.Mesh] = None

    def _connect(self, is_coordinator: bool):
        if self._store is not None:
            return self._store
        host, port = self.coordinator_address.rsplit(":", 1)
        self._store = dist.TCPStore(
            host, int(port), is_master=is_coordinator, wait_for_workers=False,
            timeout=_TIMEOUT)
        return self._store

    def initialize(self, num_processes: int = 1, process_id: int = 0,
                   coordinator_address: Optional[str] = None,
                   generation: Optional[str] = None) -> mesh_lib.Mesh:
        """Join the world of ``num_processes`` as ``process_id`` and return
        its mesh.  One process forms no group.  More than one needs the
        coordinator's address (here or at construction) and forms the
        group under the key prefix ``generation``, which every rank of the
        new world passes alike (default: a count of this manager's worlds,
        which agrees only among ranks that formed the same worlds)."""
        if coordinator_address is not None:
            self.coordinator_address = coordinator_address
        if self._initialized:
            raise RuntimeError("initialize: this process is in a world "
                               "already; teardown first")
        self._generation += 1
        if num_processes > 1:
            if not self.coordinator_address:
                raise ValueError(
                    "multi-process world needs a coordinator_address; "
                    "refusing to build a local-only mesh that would silently "
                    "skip cross-host gradient averaging")
            self._form_group(num_processes, process_id,
                             generation if generation is not None
                             else f"g{self._generation}")
        else:
            self.backend, self.backend_reason = None, "one process"
        self.mesh = mesh_lib.make_mesh(devices=[self.device])
        return self.mesh

    def _form_group(self, num_processes: int, process_id: int,
                    gen: str) -> None:
        """The default process group of ``num_processes`` ranks under the
        store's key prefix ``gen``: each rank names its device there, the
        backend follows from all of them, then the group forms."""
        store = dist.PrefixStore(
            f"dt_mesh/{gen}/",
            self._connect(process_id == 0 and self._store is None))
        store.set(f"device/{process_id}", _device_id(self.device))
        ids = [store.get(f"device/{r}").decode()
               for r in range(num_processes)]
        self.backend, self.backend_reason = choose_backend(ids)
        logger.info("mesh world %s: %d ranks, rank %d, backend %s (%s)",
                    gen, num_processes, process_id, self.backend,
                    self.backend_reason)
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        dist.init_process_group(
            self.backend, store=dist.PrefixStore("pg/", store),
            rank=process_id, world_size=num_processes, timeout=_TIMEOUT)
        self._initialized = True

    def depart(self, state: Any) -> None:
        """A removed worker's exit: attend the old world's last collective
        (the survivors' snapshot gathers ZeRO/FSDP slices), then leave."""
        if self._initialized and dist.get_world_size() > 1:
            snapshot_state(state)  # the collective matters, not the result
        self.teardown()

    def teardown(self, lost_coordinator: bool = False) -> None:
        """Leave the world.  With ``lost_coordinator`` the store (served by
        the dead coordinator) is dropped too: a new world needs a restart
        with a new coordinator."""
        if self._initialized:
            dist.destroy_process_group()
            self._initialized = False
        if lost_coordinator:
            self._store = None
        self.mesh = None

    def rebuild(self, state: Any, num_processes: int, process_id: int,
                coordinator_address: Optional[str] = None,
                generation: Optional[str] = None):
        """Membership changed: snapshot, teardown, initialize the new
        world, restore.  Returns ``(new_mesh, restored_state)``."""
        if self.mesh is not None and self.mesh.model > 1:
            axis = self.mesh.axis_names[1]
            raise NotImplementedError(
                f"MeshManager.rebuild of a mesh with a {axis!r} axis of "
                f"{self.mesh.model}: the manager's worlds are data axes "
                "only, as the JAX package's MeshManager's are")
        tr = obs_trace.tracer()
        t0 = tr.now()
        host_state = snapshot_state(state)
        self.teardown()
        mesh = self.initialize(num_processes, process_id,
                               coordinator_address, generation)
        restored = restore_state(host_state, mesh,
                                 state=state if _is_train_state(state)
                                 else None)
        tr.complete_span("mesh.rebuild", t0, {"world": num_processes,
                                              "rank": process_id})
        logger.info("mesh rebuilt: world=%d rank=%d backend=%s",
                    num_processes, process_id, self.backend)
        return mesh, restored
