"""Gluon-style Trainer of the port (counterpart of
``dt_tpu/training/trainer.py``), the imperative training surface.

Reference: ``python/mxnet/gluon/trainer.py:27-408``: a Trainer holds params,
an optimizer and a kvstore; ``step(grads, batch_size)`` rescales the
gradients by 1/batch_size, syncs them and applies the update;
``save_states``/``load_states`` serialize the optimizer state.  Here the
params are a (nested) dict of tensors, updated in place, and the caller
hands ``step`` gradients of the same structure (from ``torch.autograd``):

    trainer = Trainer(params, "sgd", {"learning_rate": 0.1})
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    trainer.step(grads, batch_size)

The states file is the JAX package's: msgpack of ``{"count", "mom"}`` with
``mom`` shaped like the params, so either package reads the other's.  With
``DT_METRICS`` or ``DT_HEALTH_HALT`` set a step computes the health vector;
under the halt a non-finite gradient raises ``obs.metrics.HealthHalt``
before the update.  The single-process kvstores only: ``dist_async`` and the
host-sync allreduce are ROADMAP Queue 1 item 3.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from dt_tpu_torch.obs import metrics as obs_metrics
from dt_tpu_torch.parallel import kvstore as kvstore_lib
from dt_tpu_torch.training.module import sentinel_health_vec
from dt_tpu_torch.utils import msgpack


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()
             ) -> Dict[Tuple[str, ...], Any]:
    out = {}
    for k, v in tree.items():
        path = prefix + (str(k),)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def _unflatten(flat: Mapping[Tuple[str, ...], Any]) -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for path, v in flat.items():
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    return out


class Trainer:
    def __init__(self, params: Mapping[str, Any],
                 optimizer: Union[str, object] = "sgd",
                 optimizer_params: Optional[Dict] = None,
                 kvstore: Union[str, kvstore_lib.KVStore] = "local"):
        if isinstance(optimizer, str):
            from dt_tpu_torch import optim
            optimizer = optim.create(optimizer, **(optimizer_params or {}))
        self.tx = optimizer
        self.params = params
        self.kv = kvstore_lib.create(kvstore) if isinstance(kvstore, str) \
            else kvstore
        self._paths = list(_flatten(params))
        self._named = self._by_name(params)
        self.opt_state = optimizer.init(self._named)

    def _by_name(self, tree: Mapping) -> Dict[str, torch.Tensor]:
        flat = _flatten(tree)
        if list(flat) != self._paths:
            raise KeyError(f"Trainer: the tree's leaves {list(flat)[:5]} "
                           f"are not the params' {self._paths[:5]}")
        return {"/".join(p): t for p, t in flat.items()}

    def allreduce_grads(self, grads):
        """Average grads across workers (reference
        ``Trainer.allreduce_grads``): one worker's are its own."""
        if self.kv.num_workers > 1:  # pragma: no cover - no such store yet
            raise NotImplementedError(
                "the host-sync allreduce is not ported yet; see ROADMAP.md, "
                "Queue 1 item 3")
        return grads

    @torch.no_grad()
    def step(self, grads: Mapping[str, Any], batch_size: int = 1):
        """Rescale by 1/batch_size, sync, update the params in place
        (reference ``Trainer.step``).  Returns the params."""
        grads = self._by_name(self.allreduce_grads(grads))
        rescale = 1.0 / batch_size
        grads = {k: g.float() * rescale for k, g in grads.items()}
        if obs_metrics.sentinels_enabled():
            names = list(self._named)
            health = sentinel_health_vec(
                torch.cat([grads[k].reshape(-1) for k in names]),
                torch.cat([self._named[k].float().reshape(-1)
                           for k in names]), 0.0)
            self._health_check(health)
        self.opt_state = self.tx.update(grads, self.opt_state, self._named)
        return self.params

    def _health_check(self, health: torch.Tensor) -> None:
        """Under ``DT_HEALTH_HALT`` a non-finite gradient raises
        ``HealthHalt`` before the update (params and optimizer state stay
        the pre-fault values)."""
        nonfinite = int(float(health[0]))
        if nonfinite > 0 and obs_metrics.halt_enabled():
            raise obs_metrics.HealthHalt(
                f"non-finite gradient ({nonfinite} entries); update "
                f"skipped (DT_HEALTH_HALT=1)")

    @property
    def learning_rate(self):
        return getattr(self.tx, "learning_rate", None)

    def _state_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"count": np.int32(self.opt_state["count"])}
        if "mom" in self.opt_state:
            out["mom"] = _unflatten({
                tuple(k.split("/")): v.detach().float().cpu().numpy()
                for k, v in self.opt_state["mom"].items()})
        return out

    def save_states(self, fname: str):
        """Write the optimizer state as the JAX package's ``save_states``
        does: msgpack of ``{"count", "mom"}``."""
        with open(fname, "wb") as f:
            f.write(msgpack.pack(self._state_dict()))

    @torch.no_grad()
    def load_states(self, fname: str):
        """Read a states file of either package into the optimizer state
        (the same keys and shapes, else ``KeyError``/``ValueError``)."""
        with open(fname, "rb") as f:
            restored = msgpack.restore(f.read())
        if set(restored) != set(self.opt_state):
            raise KeyError(f"load_states: the file has {sorted(restored)}, "
                           f"the optimizer keeps {sorted(self.opt_state)}")
        new = {"count": int(np.asarray(restored["count"]))}
        if "mom" in restored:
            mom = self.opt_state["mom"]
            flat = {"/".join(p): v for p, v in
                    _flatten(restored["mom"]).items()}
            if set(flat) != set(mom):
                raise KeyError(f"load_states: mom has {sorted(flat)[:5]}, "
                               f"the params {sorted(mom)[:5]}")
            for k, v in flat.items():
                src = torch.from_numpy(np.array(v))
                if tuple(src.shape) != tuple(mom[k].shape):
                    raise ValueError(f"load_states: mom/{k} has shape "
                                     f"{tuple(src.shape)}, the param "
                                     f"{tuple(mom[k].shape)}")
                mom[k].copy_(src)
            new["mom"] = mom
        self.opt_state = new
