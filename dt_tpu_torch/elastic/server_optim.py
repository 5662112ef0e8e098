"""Server-side optimizers of the ``dist_async`` store (counterpart of
``dt_tpu/elastic/server_optim.py``, copied since the port imports nothing of
the JAX package; the two must update bit for bit, as a mixed fleet shares
one master).

Reference: in ``dist_async`` mode the parameter server applies each
worker's gradient to the master weights the moment it arrives
(``src/kvstore/kvstore_dist_server.h:347``, the ``!sync_mode_`` branch),
with the optimizer rank 0 sent it (``python/mxnet/kvstore.py:451-498``).
Here the server is the scheduler or a range server, so the updater is plain
numpy with per-key slots: sgd (momentum, weight decay), adagrad and adam,
the reference's server-side set (``src/operator/optimizer_op.cc``).  A
worker selects it with ``set_optimizer``, which ships a spec (a name and
scalar hyperparams), never code.
"""

from __future__ import annotations

import logging
from typing import Dict

import numpy as np

logger = logging.getLogger("dt_tpu_torch")


class NpUpdater:
    """Applies one gradient to one key's master weights, the reference
    server's ``exec_.Exec(updater_(key, recved, &stored))``."""

    def __init__(self, name: str, learning_rate: float = 0.01,
                 momentum: float = 0.0, weight_decay: float = 0.0,
                 epsilon: float = 1e-8, beta1: float = 0.9,
                 beta2: float = 0.999):
        name = name.lower()
        if name not in ("sgd", "adagrad", "adam"):
            raise ValueError(
                f"dist_async server optimizer {name!r} unsupported; "
                "supported: sgd, adagrad, adam (reference server-side set, "
                "optimizer_op.cc)")
        self.name = name
        self.lr = float(learning_rate)
        self.momentum = float(momentum)
        self.wd = float(weight_decay)
        self.eps = float(epsilon)
        self.beta1 = float(beta1)
        self.beta2 = float(beta2)
        self._slots: Dict[str, dict] = {}
        # the installed spec's identity, compared for idempotent re-sends;
        # create() sets it to the caller's exact spec
        self.spec_input = {"name": name, "learning_rate": self.lr,
                           "momentum": self.momentum,
                           "weight_decay": self.wd}

    def sparse(self, key: str, ids: np.ndarray, vals: np.ndarray,
               stored: np.ndarray) -> np.ndarray:
        """The lazy row-sparse update: only the pushed rows move, and an
        untouched row's momentum does not decay (``optimizer_op.cc``
        row_sparse sgd/adagrad).  Duplicate ids are summed here.  Returns a
        new array; ``stored`` is not written (the replay cache may still
        serve it).  sgd and adagrad only: lazy adam needs a step count a
        row, which the reference does not have either."""
        if self.name == "adam":
            raise ValueError(
                "lazy sparse updates support sgd/adagrad (the reference's "
                "row_sparse optimizer set, optimizer_op.cc); adam's bias "
                "correction is global")
        ids = np.asarray(ids).ravel()
        vals = np.asarray(vals, np.float32)
        keep = (ids >= 0) & (ids < stored.shape[0])
        if not keep.all():
            logger.warning(
                "sparse push %s: %d row id(s) outside the registered "
                "table (%d rows) dropped — client/server vocab mismatch?",
                key, int((~keep).sum()), stored.shape[0])
        ids, vals = ids[keep], vals[keep]
        uniq, inv = np.unique(ids, return_inverse=True)
        g = np.zeros((len(uniq),) + vals.shape[1:], np.float32)
        np.add.at(g, inv, vals)
        w = np.array(stored, np.float32)  # a copy, never an alias
        rows = w[uniq]
        slot = self._slots.setdefault(key, {})
        if self.name == "sgd":
            g = g + self.wd * rows
            if self.momentum:
                m = slot.get("m")
                if m is None:
                    m = slot["m"] = np.zeros_like(w)
                m[uniq] = self.momentum * m[uniq] + g  # touched rows only
                g = m[uniq]
            w[uniq] = rows - self.lr * g
        else:  # adagrad
            h = slot.get("h")
            if h is None:
                h = slot["h"] = np.zeros_like(w)
            h[uniq] = h[uniq] + g * g
            w[uniq] = rows - self.lr * (g / np.sqrt(h[uniq] + self.eps)
                                        + self.wd * rows)
        return w.astype(stored.dtype, copy=False)

    def __call__(self, key: str, grad: np.ndarray,
                 stored: np.ndarray) -> np.ndarray:
        g = np.asarray(grad, np.float32)
        w = np.asarray(stored, np.float32)
        slot = self._slots.setdefault(key, {})
        if self.name == "sgd":
            g = g + self.wd * w
            if self.momentum:
                m = slot.get("m")
                m = self.momentum * m + g if m is not None else g
                slot["m"] = m
                g = m
            new = w - self.lr * g
        elif self.name == "adagrad":
            h = slot.get("h", np.zeros_like(w)) + g * g
            slot["h"] = h
            new = w - self.lr * (g / np.sqrt(h + self.eps) + self.wd * w)
        else:  # adam
            t = slot.get("t", 0) + 1
            m = self.beta1 * slot.get("m", np.zeros_like(w)) \
                + (1 - self.beta1) * g
            v = self.beta2 * slot.get("v", np.zeros_like(w)) \
                + (1 - self.beta2) * g * g
            slot.update(t=t, m=m, v=v)
            mhat = m / (1 - self.beta1 ** t)
            vhat = v / (1 - self.beta2 ** t)
            new = w - self.lr * (mhat / (np.sqrt(vhat) + self.eps)
                                 + self.wd * w)
        return new.astype(stored.dtype)


def spec_identity(spec: dict) -> dict:
    """A spec's comparable identity, its scalar hyperparams: every worker
    sends the spec at fit start, and only a different one may reset the
    updater (a reset wipes the slots and the retry-dedup cache)."""
    return {k: v for k, v in spec.items()
            if isinstance(v, (int, float, str, bool))}


def create(name: str, **params) -> NpUpdater:
    identity = spec_identity({"name": name, **params})
    params.pop("lr_scheduler", None)  # a worker-side knob a spec may carry
    upd = NpUpdater(name, **params)
    upd.spec_input = identity
    return upd
