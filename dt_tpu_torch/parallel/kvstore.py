"""KVStore facade of the port (counterpart of ``dt_tpu/parallel/kvstore.py``):
the training loop's view of the distributed world, for one process.

Reference: ``include/mxnet/kvstore.h`` + ``python/mxnet/kvstore.py``.  The
JAX store keeps identity (``rank``, ``num_workers``), the epoch-boundary
membership barrier (delegated to an elastic controller), the optimizer
hand-off, gradient compression and a host-side ``push``/``pull`` kept for
the reference's user code (not the training hot path).  The port has the
single-process stores, ``local`` and ``device`` (rank 0 of 1 worker),
``tpu_sync`` (with its aliases ``dist_sync``, ``dist_device_sync``,
``dist``), whose identity comes from an elastic controller
(``elastic.client.WorkerClient``), and ``dist_async``
(:class:`DistAsyncKVStore`): the master weights and the optimizer live on
the scheduler or the range servers, and a step pushes a gradient and
adopts the weights the server answers.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch


class KVStore:
    """The single-process store (``local``/``device``)."""

    def __init__(self):
        self._store: Dict[str, np.ndarray] = {}
        self._controller = None  # an elastic controller (set_controller)
        self._gradient_compression = None
        self._optimizer = None

    # -- identity ----------------------------------------------------------
    @property
    def type(self) -> str:
        return "local"

    @property
    def rank(self) -> int:
        return 0

    @property
    def num_workers(self) -> int:
        return 1

    # -- data-plane parity API (host-side; not the training hot path) ------
    def init(self, key: str, value, exclude_update: bool = False):
        """Reference ``KVStore.init(..., exclude_update)``
        (``kvstore.py:116-158``)."""
        self._store[key] = np.asarray(value)

    def push(self, key: str, values):
        """Aggregate (the mean of ``values``) into the store: the
        server-side merge (``kvstore_dist_server.h:710-739``) without the
        wire.  Row-sparse values (``ops.sparse.RowSparse``) change only
        the touched rows (``kvstore_dist.h:690-748``)."""
        from dt_tpu_torch.ops.sparse import RowSparse
        if not isinstance(values, (list, tuple)):
            values = [values]
        if any(isinstance(v, RowSparse) for v in values):
            if not all(isinstance(v, RowSparse) for v in values):
                raise ValueError(
                    "push: mixed dense and RowSparse values for one key — "
                    "cast_storage them to a common stype first")
            base = np.array(self._store[key], np.float64)
            acc = np.zeros_like(base)
            touched = np.zeros(base.shape[0], bool)
            for v in values:
                ids = _np(v.indices)
                vals = _np(v.values).astype(np.float64)
                keep = ids < v.num_rows
                np.add.at(acc, ids[keep], vals[keep])
                touched[ids[keep]] = True
            base[touched] = acc[touched] / len(values)
            self._store[key] = base.astype(self._store[key].dtype)
            return
        self._store[key] = np.mean([_np(v) for v in values], axis=0)

    def pull(self, key: str):
        return self._store[key]

    def row_sparse_pull(self, key: str, row_ids):
        """Only the requested rows (``kvstore_dist.h:317-376``), as an
        ``ops.sparse.RowSparse`` over the stored value (CPU tensors)."""
        from dt_tpu_torch.ops.sparse import RowSparse
        dense = self._store[key]
        ids = _np(row_ids)
        return RowSparse(torch.from_numpy(ids.astype(np.int32)),
                         torch.from_numpy(np.ascontiguousarray(dense[ids])),
                         dense.shape[0])

    # -- barriers / elasticity --------------------------------------------
    def barrier(self):
        pass

    def set_controller(self, controller):
        """Attach an elastic controller (the worker's client of the
        scheduler)."""
        self._controller = controller

    def _membership_change_barrier(self, info: Optional[dict] = None
                                   ) -> None:
        """Reference ``kvstore.py:617-624``: block until the scheduler
        applied any membership change for this epoch; ``rank`` and
        ``num_workers`` may change."""
        if self._controller is not None:
            self._controller.membership_change_barrier(info or {})

    def get_num_dead_node(self, timeout_s: float = 60.0) -> int:
        """Reference ``kv.get_num_dead_node`` (``kvstore_dist.h:134-143``)."""
        if self._controller is not None:
            return self._controller.num_dead_nodes(timeout_s)
        return 0

    # -- gradient compression ---------------------------------------------
    def set_gradient_compression(self, compression_params: Dict):
        """Reference ``kv.set_gradient_compression({'type': '2bit',
        'threshold': t})``.  Applies to the host-sync data plane (as in the
        JAX package, the one-device step does not compress)."""
        if "type" not in compression_params:
            raise ValueError("compression_params must include 'type' "
                             "(none|2bit)")
        ctype = compression_params["type"]
        if ctype == "none":
            self._gradient_compression = None
            return
        if ctype != "2bit":
            raise ValueError(f"unsupported compression type {ctype!r} "
                             "(reference supports none|2bit)")
        from dt_tpu_torch.parallel.compression import GradientCompression
        self._gradient_compression = GradientCompression(
            float(compression_params.get("threshold", 0.5)))

    # -- optimizer hand-off (API parity) ----------------------------------
    def set_optimizer(self, optimizer):
        """Recorded only: the optimizer runs in the training step."""
        self._optimizer = optimizer


class TPUSyncKVStore(KVStore):
    """The synchronous store (``tpu_sync``, ``dist_sync``): under an
    elastic controller ``rank`` and ``num_workers`` follow the live
    membership the scheduler keeps (ranks shift on removal, as the
    reference's ordered live set, ``van.cc:519-539``); without one it is
    rank 0 of 1 (the port runs one process a card)."""

    @property
    def type(self) -> str:
        return "tpu_sync"

    @property
    def rank(self) -> int:
        if self._controller is not None:
            return self._controller.rank
        return 0

    @property
    def num_workers(self) -> int:
        if self._controller is not None:
            return self._controller.num_workers
        return 1


class DistAsyncKVStore(TPUSyncKVStore):
    """The asynchronous parameter-server store (``dist_async``,
    ``kvstore.py:196-297``): the scheduler (or each range server, for its
    rows) holds the master weights and the updater
    (``elastic.server_optim``) and applies each worker's gradient the
    moment it arrives (``kvstore_dist_server.h:347``, ``!sync_mode_``).  A
    step is ``push(grad) -> updated weights``, no waiting on peers.
    ``Module.fit`` and ``Trainer`` take this path when ``kv.type ==
    "dist_async"``."""

    @property
    def type(self) -> str:
        return "dist_async"

    def set_optimizer(self, optimizer, **params):
        """Ship the optimizer spec (a name and scalar hyperparams) to the
        servers; the reference pickled the optimizer
        (``kvstore.py:451-498``), a spec ships no code."""
        if not isinstance(optimizer, str):
            raise TypeError("dist_async set_optimizer takes a name string "
                            "+ hyperparams (specs ship over the wire, "
                            "code does not)")
        self._optimizer = {"name": optimizer, **params}
        if self._controller is not None:
            self._controller.set_optimizer(self._optimizer)

    def _require_controller(self):
        if self._controller is None:
            raise RuntimeError(
                "dist_async needs an elastic controller — "
                "kv.set_controller(WorkerClient(...)) (or auto_client()); "
                "without one this would silently train single-worker")
        return self._controller

    def attach_flat(self, key: str, optimizer_spec: dict,
                    flat_params) -> np.ndarray:
        """Ship the optimizer spec, then init-or-get the master weights
        under ``key`` (the first worker seeds them, a joiner adopts the
        live copy).  Returns the master, f32 numpy.  Both legs are
        idempotent, so a failed attach is retried by calling again."""
        ctrl = self._require_controller()
        spec = dict(optimizer_spec)
        self.set_optimizer(spec.pop("name"), **spec)
        return ctrl.async_init(key, _np(flat_params))

    def push_flat(self, key: str, flat_grad) -> np.ndarray:
        """Push one flat gradient, get the post-update master."""
        return self._require_controller().async_push(key, _np(flat_grad))

    def push_sparse(self, key: str, rs):
        """Row-sparse async push (an embedding table registered through
        ``async_init``): the server updates the touched rows lazily, and
        they come back as an ``ops.sparse.RowSparse`` over the master
        table, on ``rs.values``' device."""
        from dt_tpu_torch.ops.sparse import RowSparse
        out = self._require_controller().async_push_sparse(
            key, _np(rs.indices), _np(rs.values))
        dev = rs.values.device if isinstance(rs.values, torch.Tensor) \
            else torch.device("cpu")
        return RowSparse(
            torch.from_numpy(np.asarray(out["ids"]).astype(np.int32)).to(dev),
            torch.from_numpy(np.asarray(out["vals"])).to(dev), rs.num_rows)

    def staleness_stats(self) -> dict:
        """``max_staleness``/``mean_staleness``: updates by other workers
        applied to the master between this worker's pushes."""
        return self._require_controller().async_stats()

    def pull_rows(self, key: str, row_ids):
        """The async ``row_sparse_pull`` (``kvstore_dist.h:317-376``): only
        the requested rows of the master table, as a RowSparse (CPU)."""
        from dt_tpu_torch.ops.sparse import RowSparse
        out = self._require_controller().async_pull_rows(key, _np(row_ids))
        return RowSparse(
            torch.from_numpy(np.asarray(out["ids"]).astype(np.int32)),
            torch.from_numpy(np.ascontiguousarray(out["vals"])),
            int(out["num_rows"]))


def _np(a) -> np.ndarray:
    """A tensor (any device) or array-like as numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def create(name: str = "local") -> KVStore:
    """Reference ``mx.kv.create`` type-string dispatch
    (``src/kvstore/kvstore.cc:40-77``)."""
    key = name.lower()
    if key in ("local", "device"):
        return KVStore()
    if key in ("tpu_sync", "dist_sync", "dist_device_sync", "dist"):
        return TPUSyncKVStore()
    if key == "dist_async":
        return DistAsyncKVStore()
    raise ValueError(f"unknown kvstore type {name!r}")
