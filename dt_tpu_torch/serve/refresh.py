"""Rolling weight refresh: committed fleet checkpoints into live replicas
(counterpart of ``dt_tpu/serve/refresh.py``, copied since the port imports
nothing of the JAX package).

Training and serving share a scheduler, so the refresher closes the loop:
it polls the fleet-checkpoint manifest (``ckpt_manifest``; only the
COMMITTED manifest is served, and the two-phase protocol makes it complete
and digest-verified), and when a newer step has committed it walks the live
replicas ONE AT A TIME, in ``serve_endpoints`` order, sending
``weight_refresh``.

Safety comes from the gateway, not the walk: each gateway swaps under its
batch-execution lock (the in-flight batch finishes on the old weights, the
next starts on the new), and the step key makes a second application a
no-op, so a retry or a second refresher is harmless.  During a wave the
fleet serves two adjacent steps; every answer names its ``weights_step``.
What cannot happen is a torn answer.

Replicas resolve ``(step, manifest)`` to weights themselves
(``Gateway(refresh_loader=...)``).  :func:`manifest_loader` is the
checkpoint-backed loader: any committed blob restores any replica (the
data-parallel train state is the same on every worker).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional, Sequence, Tuple, Union

from dt_tpu_torch.elastic import protocol
from dt_tpu_torch.elastic.client import parse_endpoints

logger = logging.getLogger("dt_tpu_torch.serve")


def manifest_loader(state_template, host: Optional[str] = None):
    """A ``refresh_loader`` over the fleet checkpoint: restore the
    manifest's blob into ``state_template`` (a
    ``training.train_state.TrainState`` of the served model, on any device;
    digest-verified) and hand its params and BN stats to
    ``Predictor.swap_params`` as JAX-layout trees, the form it takes.
    ``host=None`` restores from any member's blob."""
    from dt_tpu_torch.interchange import export_jax_variables
    from dt_tpu_torch.training import fleet_ckpt

    def load(step: int, manifest: Optional[dict]):
        if not manifest or int(manifest.get("step", -1)) != int(step):
            return None
        state, _cursor = fleet_ckpt.restore_state(manifest, host,
                                                  state_template)
        trees = export_jax_variables(state.module)
        return trees["params"], trees["batch_stats"]

    return load


class RollingRefresher:
    """Poll the scheduler for a newer committed checkpoint and roll it
    across the serving fleet one replica at a time.  ``endpoints``: one
    ``"h:p[,h:p]"`` string or a list of ``(host, port)`` tuples."""

    def __init__(self, endpoints: Union[str, Sequence[Tuple[str, int]]],
                 interval_s: float = 1.0):
        self.addrs = parse_endpoints(endpoints) \
            if isinstance(endpoints, str) else [tuple(a) for a in endpoints]
        self._interval = float(interval_s)
        self._lock = threading.Lock()
        self._leader = 0  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_step = 0  # guarded-by: _lock

    def _req(self, msg: dict, timeout: float = 10.0) -> dict:
        last: Optional[BaseException] = None
        for _ in range(max(len(self.addrs), 1) * 4):
            with self._lock:
                host, port = self.addrs[self._leader]
            try:
                resp = protocol.request(host, port, dict(msg),
                                        timeout=timeout)
            except (ConnectionError, OSError) as e:
                last = e
                with self._lock:
                    self._leader = (self._leader + 1) % len(self.addrs)
                time.sleep(0.05)
                continue
            if resp.get("error") in ("not_leader", "fenced"):
                with self._lock:
                    self._leader = (self._leader + 1) % len(self.addrs)
                continue
            return resp
        raise ConnectionError(f"no scheduler endpoint answered "
                              f"{msg.get('cmd')!r}: {last!r}")

    # ------------------------------------------------------------------

    def poll_once(self, step: Optional[int] = None,
                  manifest: Optional[dict] = None) -> dict:
        """One refresh wave: the target step is the committed manifest's
        unless the caller pins one, then the stale replicas are walked in
        turn.  Returns ``{"step", "applied": [hosts], "skipped":
        [hosts]}``."""
        if step is None:
            resp = self._req({"cmd": "ckpt_manifest"})
            manifest = resp.get("committed")
            if not manifest:
                return {"step": 0, "applied": [], "skipped": []}
            step = int(manifest["step"])
        eps = self._req({"cmd": "serve_endpoints"})
        replicas = eps.get("replicas") or {}
        applied, skipped = [], []
        for host in sorted(replicas):
            ent = replicas[host]
            if ent.get("draining") or \
                    int(ent.get("weights_step", 0)) >= step:
                skipped.append(host)
                continue
            ghost, gport = ent["addr"]
            try:
                # one replica at a time: the next send waits for this
                # gateway's drain-then-swap (keyed by step, so the
                # reliable retry is safe)
                r = protocol.request(ghost, gport,
                                     {"cmd": "weight_refresh",
                                      "step": step,
                                      "manifest": manifest},
                                     timeout=30.0, retries=2)
            except (ConnectionError, OSError) as e:
                logger.warning("weight_refresh %s failed: %s", host, e)
                skipped.append(host)
                continue
            if r.get("error") is not None:
                logger.warning("weight_refresh %s: %s", host,
                               r.get("error"))
                skipped.append(host)
            elif int(r.get("weights_step", 0)) >= step:
                applied.append(host)
        with self._lock:
            self.last_step = max(self.last_step, int(step))
        return {"step": int(step), "applied": applied,
                "skipped": skipped}

    # ------------------------------------------------------------------

    def start(self) -> None:
        """Poll in the background (the long-running deployment; drills
        call :meth:`poll_once` directly)."""
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.poll_once()
            except ConnectionError:
                continue

    def close(self) -> None:
        self._stop.set()
