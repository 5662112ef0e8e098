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

The states file is the JAX package's: msgpack of the optimizer state's
``to_state_dict`` (``{"count", "mom"}``, adam's ``{"count", "a", "b"}``,
``{"master", "inner"}`` under ``multi_precision`` ...), each per-param slot
shaped like the params, so either package reads the other's.  With
``DT_METRICS`` or ``DT_HEALTH_HALT`` set a step computes the health vector
(the ``health.*`` gauges, a ``health.nonfinite`` event); under the halt a
non-finite gradient records ``health.halt``, leaves the flight recorder's
bundle and raises ``obs.metrics.HealthHalt`` before the update.

Under an elastic controller with more than one worker, ``step`` averages
the gradients across the workers first (``allreduce_grads``: one flat f32
vector in the JAX ravel order, sorted paths, through the overlapped
bucket pipeline of ``training.overlap`` or one serial round, bit-identical
either way).  Over ``dist_async`` (``trainer.py:126-160``) it pushes the
rescaled flat gradient and adopts the master the servers answer; the
first step ships the optimizer spec and attaches the master under
``async_key``.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from dt_tpu_torch.obs import blackbox as obs_blackbox
from dt_tpu_torch.obs import device as obs_device
from dt_tpu_torch.obs import metrics as obs_metrics
from dt_tpu_torch.obs import trace as obs_trace
from dt_tpu_torch.parallel import kvstore as kvstore_lib
from dt_tpu_torch.optim.state import export_leaf, load_state, map_state
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
                 kvstore: Union[str, kvstore_lib.KVStore] = "local",
                 async_key: str = "trainer_params"):
        """``async_key`` names this Trainer's master vector on the
        ``dist_async`` servers; one job's workers share it, distinct
        param groups of one scheduler need their own."""
        self.kv = kvstore_lib.create(kvstore) if isinstance(kvstore, str) \
            else kvstore
        is_async = self.kv.type == "dist_async"
        self._optimizer_spec = None
        if isinstance(optimizer, str):
            from dt_tpu_torch import optim
            self._optimizer_spec = {"name": optimizer,
                                    **(optimizer_params or {})}
            optimizer = optim.create(optimizer, **(optimizer_params or {}))
        self.tx = optimizer
        self.params = params
        self._paths = list(_flatten(params))
        self._named = self._by_name(params)
        # the flat vector's order: JAX's ravel_pytree sorts dict keys at
        # every level, which is the sorted order of the paths
        self._flat_names = ["/".join(p) for p in sorted(self._paths)]
        # dist_async: the optimizer and its slots run on the servers
        self.opt_state = None if is_async else optimizer.init(self._named)
        self._async_key = async_key
        self._attached = False
        self._overlap = None  # training.overlap.GradSyncEngine, lazy

    def _by_name(self, tree: Mapping) -> Dict[str, torch.Tensor]:
        flat = _flatten(tree)
        if list(flat) != self._paths:
            raise KeyError(f"Trainer: the tree's leaves {list(flat)[:5]} "
                           f"are not the params' {self._paths[:5]}")
        return {"/".join(p): t for p, t in flat.items()}

    def _ravel(self, named: Mapping[str, torch.Tensor],
                scale: float = 1.0) -> torch.Tensor:
        """One f32 vector of ``named`` (by joined path) in the flat
        order."""
        return torch.cat([(named[k].float() * scale).reshape(-1)
                          if scale != 1.0 else named[k].float().reshape(-1)
                          for k in self._flat_names])

    def _unravel(self, flat: torch.Tensor, like: Mapping[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
        """Views of ``flat`` shaped and typed as ``like``'s tensors."""
        out, o = {}, 0
        for k in self._flat_names:
            t = like[k]
            out[k] = flat[o:o + t.numel()].view(t.shape).to(t.dtype)
            o += t.numel()
        return out

    def allreduce_grads(self, grads):
        """Average grads across workers (reference
        ``Trainer.allreduce_grads``, ``trainer.py:102-124``): with an
        elastic controller and more than one worker the flat gradient goes
        through the bucketed D2H, wire, H2D pipeline
        (``training.overlap``) when ``DT_AR_OVERLAP`` allows it, else one
        serial round; both give the same bits.  Returns the tree of the
        averages; one worker's gradients are its own."""
        ctrl = self.kv._controller
        if ctrl is None or self.kv.num_workers <= 1:
            return grads
        named = self._by_name(grads)
        flat = self._ravel(named)
        from dt_tpu_torch.training import overlap as overlap_lib
        if overlap_lib.enabled(ctrl):
            if self._overlap is None:
                self._overlap = overlap_lib.GradSyncEngine(flat.device)
            avg, _ = self._overlap.sync(ctrl, None, flat,
                                        key="trainer_grads")
        else:
            avg = torch.from_numpy(np.asarray(ctrl.allreduce(
                "trainer_grads", flat.cpu().numpy()))).to(flat.device)
        by_name = self._unravel(avg, named)
        return _unflatten({p: by_name["/".join(p)] for p in self._paths})

    @torch.no_grad()
    def _async_step(self, grads, rescale: float):
        """The ``dist_async`` step (``trainer.py:126-160``): the first call
        ships the spec and adopts the master; then push the rescaled flat
        gradient (withheld under the halt when it is not finite) and adopt
        the post-update master, in place."""
        kv = self.kv
        if not self._attached:
            if self._optimizer_spec is None:
                raise ValueError("dist_async Trainer takes the optimizer "
                                 "as (name, hyperparams), not an optimizer "
                                 "object (the spec ships to the server)")
            cur = kv.attach_flat(self._async_key, self._optimizer_spec,
                                 self._ravel(self._named).cpu().numpy())
            self._load_flat(cur)
            self._attached = True  # only once the attach succeeded
        g_host = self._ravel(self._by_name(grads), rescale).cpu().numpy()
        if obs_metrics.sentinels_enabled():
            nonfinite = int(g_host.size - np.isfinite(g_host).sum())
            if nonfinite > 0:
                self._nonfinite(nonfinite)
        self._load_flat(kv.push_flat(self._async_key, g_host))
        return self.params

    def _load_flat(self, flat) -> None:
        src = torch.from_numpy(np.array(flat, np.float32))
        for k, t in self._unravel(src, self._named).items():
            self._named[k].copy_(t)

    @torch.no_grad()
    def step(self, grads: Mapping[str, Any], batch_size: int = 1):
        """Rescale by 1/batch_size, sync, update the params in place
        (reference ``Trainer.step``).  Returns the params."""
        tr = obs_trace.tracer()
        t0 = tr.begin("trainer.step")
        try:
            if self.kv.type == "dist_async":
                return self._async_step(grads, 1.0 / batch_size)
            return self._sync_step(grads, batch_size)
        except Exception as e:
            # an OOM leaves its census bundle (a no-op otherwise)
            obs_device.maybe_oom_bundle(e)
            raise
        finally:
            tr.complete_span("trainer.step", t0)

    def _sync_step(self, grads, batch_size: int):
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
        """One step's health vector (one host read): the ``health.*``
        gauges under the metrics plane; a non-finite gradient is
        :meth:`_nonfinite`."""
        h = health.cpu().numpy()
        if obs_metrics.enabled():
            reg = obs_metrics.registry()
            reg.gauge("health.grad_norm", float(h[1]))
            reg.gauge("health.param_norm", float(h[2]))
        if int(h[0]) > 0:
            self._nonfinite(int(h[0]))

    def _nonfinite(self, nonfinite: int) -> None:
        """A ``health.nonfinite`` event; under ``DT_HEALTH_HALT`` also
        ``health.halt``, the halt's bundle, and ``HealthHalt`` raised
        before the update (params and optimizer state stay the pre-fault
        values; over ``dist_async`` the push is withheld)."""
        obs_trace.tracer().event("health.nonfinite",
                                 {"nonfinite": nonfinite,
                                  "surface": "trainer"})
        if not obs_metrics.halt_enabled():
            return
        obs_trace.tracer().event("health.halt", {"surface": "trainer"})
        obs_blackbox.write_bundle(
            "health.halt", fatal=False,
            extra={"surface": "trainer", "nonfinite": nonfinite})
        what = "dist_async push withheld" \
            if self.kv.type == "dist_async" else "update skipped"
        raise obs_metrics.HealthHalt(
            f"non-finite gradient ({nonfinite} entries); {what} "
            f"(DT_HEALTH_HALT=1)")

    @property
    def learning_rate(self):
        return getattr(self.tx, "learning_rate", None)

    def _state_dict(self) -> Dict[str, Any]:
        """The optimizer state as the JAX package's ``to_state_dict``
        gives it: each per-param slot nested as the params are (float32
        numpy, bfloat16 as ``torch.bfloat16`` tensors), counts as 0-d
        int32 arrays."""
        def host(t):
            t = t.detach().cpu()
            return t.clone() if t.dtype == torch.bfloat16 else \
                t.numpy().copy()

        return map_state(self.opt_state, self._named, lambda path, slot:
                         _unflatten({tuple(k.split("/")): host(v)
                                     for k, v in slot.items()}),
                         export_leaf)

    def _refuse_async(self, what: str) -> None:
        if self.kv.type == "dist_async":
            raise RuntimeError(
                f"dist_async optimizer slots live on the scheduler; "
                f"{what} (reference dist-mode limitation, kvstore.py:551)")

    def save_states(self, fname: str):
        """Write the optimizer state as the JAX package's ``save_states``
        does: msgpack of its ``to_state_dict``."""
        self._refuse_async("save_states would serialize unused local state")
        with open(fname, "wb") as f:
            f.write(msgpack.pack(self._state_dict()))

    @torch.no_grad()
    def load_states(self, fname: str):
        """Read a states file of either package into the optimizer state
        (the same keys and shapes, else ``KeyError``/``ValueError``)."""
        self._refuse_async("load_states cannot restore them")
        with open(fname, "rb") as f:
            restored = msgpack.restore(f.read())

        def load_slot(where, node, slot):
            flat = {"/".join(p): v for p, v in _flatten(node).items()}
            if set(flat) != set(slot):
                raise KeyError(f"load_states: {where} has "
                               f"{sorted(flat)[:5]}, the params "
                               f"{sorted(slot)[:5]}")
            for k, v in flat.items():
                src = v if isinstance(v, torch.Tensor) else \
                    torch.from_numpy(np.array(v))
                if tuple(src.shape) != tuple(slot[k].shape):
                    raise ValueError(f"load_states: {where}/{k} has shape "
                                     f"{tuple(src.shape)}, the param "
                                     f"{tuple(slot[k].shape)}")
                slot[k].copy_(src)
            return slot

        self.opt_state = load_state("load_states", self.opt_state, restored,
                                    self._named, load_slot)
