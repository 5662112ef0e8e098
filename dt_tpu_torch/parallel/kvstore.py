"""KVStore facade of the port (counterpart of ``dt_tpu/parallel/kvstore.py``):
the training loop's view of the distributed world, for one process.

Reference: ``include/mxnet/kvstore.h`` + ``python/mxnet/kvstore.py``.  The
JAX store keeps identity (``rank``, ``num_workers``), the epoch-boundary
membership barrier (delegated to an elastic controller), the optimizer
hand-off, gradient compression and a host-side ``push``/``pull`` kept for
the reference's user code (not the training hot path).  This slice ports
the single-process stores, ``local`` and ``device`` (rank 0 of 1 worker);
the distributed ones (``tpu_sync`` and its aliases, ``dist_async``) and an
elastic controller come with the elastic slice, ROADMAP Queue 1 item 3, and
raise ``NotImplementedError`` until then.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

_ELASTIC = ("is not ported yet; see ROADMAP.md, Queue 1 item 3 (the "
            "elastic host-sync step)")


class KVStore:
    """The single-process store (``local``/``device``)."""

    def __init__(self):
        self._store: Dict[str, np.ndarray] = {}
        self._controller = None  # an elastic controller: not ported
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
        raise NotImplementedError(f"an elastic controller {_ELASTIC}")

    # -- gradient compression ---------------------------------------------
    def set_gradient_compression(self, compression_params: Dict):
        """Reference ``kv.set_gradient_compression({'type': '2bit',
        'threshold': t})``.  Recorded for the host-sync data plane, which a
        single process does not run (as in the JAX package, the one-device
        step does not compress)."""
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


def create(name: str = "local") -> KVStore:
    """Reference ``mx.kv.create`` type-string dispatch
    (``src/kvstore/kvstore.cc:40-77``)."""
    key = name.lower()
    if key in ("local", "device"):
        return KVStore()
    if key in ("tpu_sync", "dist_sync", "dist_device_sync", "dist",
               "dist_async"):
        raise NotImplementedError(f"kvstore {name!r} {_ELASTIC}")
    raise ValueError(f"unknown kvstore type {name!r}")
