"""KVStore facade of the port (counterpart of ``dt_tpu/parallel/kvstore.py``):
the training loop's view of the distributed world, for one process.

Reference: ``include/mxnet/kvstore.h`` + ``python/mxnet/kvstore.py``.  The
JAX store keeps identity (``rank``, ``num_workers``), the epoch-boundary
membership barrier (delegated to an elastic controller), the optimizer
hand-off, gradient compression and a host-side ``push``/``pull`` kept for
the reference's user code (not the training hot path).  The port has the
single-process stores, ``local`` and ``device`` (rank 0 of 1 worker), and
``tpu_sync`` (with its aliases ``dist_sync``, ``dist_device_sync``,
``dist``), whose identity comes from an elastic controller
(``elastic.client.WorkerClient``).  ``dist_async`` raises
``NotImplementedError`` (ROADMAP Queue 1 item 3a).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

_ASYNC = ("is not ported yet; see ROADMAP.md, Queue 1 item 3a (dist_async "
          "and the scheduler-side optimizer)")


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
        wire.  Dense values only (the JAX store's row-sparse push needs
        ``ops.sparse``, ROADMAP Queue 1 item 8)."""
        if not isinstance(values, (list, tuple)):
            values = [values]
        self._store[key] = np.mean([np.asarray(v) for v in values], axis=0)

    def pull(self, key: str):
        return self._store[key]

    def row_sparse_pull(self, key: str, row_ids):
        raise NotImplementedError(
            "row_sparse_pull needs the row-sparse type of ops.sparse, which "
            "is not ported yet; see ROADMAP.md, Queue 1 item 8")

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


def create(name: str = "local") -> KVStore:
    """Reference ``mx.kv.create`` type-string dispatch
    (``src/kvstore/kvstore.cc:40-77``)."""
    key = name.lower()
    if key in ("local", "device"):
        return KVStore()
    if key in ("tpu_sync", "dist_sync", "dist_device_sync", "dist"):
        return TPUSyncKVStore()
    if key == "dist_async":
        raise NotImplementedError(f"kvstore {name!r} {_ASYNC}")
    raise ValueError(f"unknown kvstore type {name!r}")
