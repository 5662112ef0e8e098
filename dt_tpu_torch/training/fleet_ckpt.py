"""The fleet checkpoint and the cold-restart resume (counterpart of
``dt_tpu/training/fleet_ckpt.py``, copied since the port imports nothing
of the JAX package).

- **Two-phase fleet checkpoint.**  Host-sync lockstep applies the same
  updates on every worker, so ``state.step`` agrees fleet-wide between
  allreduces.  At ``step % DT_CKPT_EVERY == 0`` each worker sends
  ``ckpt_intent`` (the first opens the journaled window, the others join),
  saves its train state and data cursor through
  ``checkpoint.save_checkpoint(async_save=True)`` and acks with the
  content digest.  The last pinned ack commits the manifest as a journaled
  op; a window that never commits is garbage, the previous commit wins.
- **Cold-restart resume.**  A ``DT_RESUME=1`` boot replays the scheduler
  journal, seeds the fleet from the host file (at any size: every
  worker's state is the same, so any digest-verified blob restores any
  worker) and hands out the committed manifest at registration.
  :func:`restore_state` and :func:`fast_forward` then land the state and
  the data schedule on the next step, bit-identical to a never-killed run.

The blobs are the JAX ``TrainState`` state dict in msgpack, so a JAX
worker resumes from a port blob and a port worker from a JAX blob.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Tuple

from dt_tpu_torch import config
from dt_tpu_torch.elastic import faults as faults_lib
from dt_tpu_torch.obs import trace as obs_trace
from dt_tpu_torch.training import checkpoint

logger = logging.getLogger("dt_tpu_torch")


class FleetCheckpointer:
    """One worker's side of the two-phase protocol; ``fit`` owns it."""

    def __init__(self, ctrl, host: str, directory: str, every: int):
        self.ctrl = ctrl
        self.host = host
        self.every = int(every)
        # a directory a host: workers on a shared filesystem never race on
        # one prefix (the manifest records the exact paths)
        self.prefix = os.path.join(directory, host or "worker", "fleet")
        self._obs = obs_trace.tracer()

    @classmethod
    def from_env(cls, ctrl, host: Optional[str]
                 ) -> Optional["FleetCheckpointer"]:
        """Armed with a controller and ``DT_CKPT_DIR`` set."""
        directory = config.env("DT_CKPT_DIR")
        if ctrl is None or not directory:
            return None
        every = int(config.env("DT_CKPT_EVERY") or 0)
        return cls(ctrl, host or "worker", directory, every)

    def maybe_step(self, state, epoch: int, applied: int) -> None:
        """After each applied step: checkpoint when the global step hits
        the ``DT_CKPT_EVERY`` grid (0: off)."""
        if self.every <= 0:
            return
        step = int(state.step)
        if step > 0 and step % self.every == 0:
            self.checkpoint(state, epoch, applied, step=step)

    def epoch_end(self, state, epoch: int, applied: int) -> None:
        """A draining scheduler flags ``ckpt_epoch_end`` on heartbeat
        replies; the epoch boundary (the same step fleet-wide) is where
        the fleet takes the forced checkpoint."""
        if getattr(self.ctrl, "ckpt_epoch_end", False):
            self.checkpoint(state, epoch, applied)

    def checkpoint(self, state, epoch: int, applied: int,
                   step: Optional[int] = None) -> None:
        """One round: intent, the asynchronous durable save, the ack (the
        digest and the cursor) from the writer's done-callback.  A failed
        save never acks and the window aborts."""
        step = int(state.step) if step is None else int(step)
        try:
            resp = self.ctrl.ckpt_begin(step, epoch)
        except Exception as e:  # noqa: BLE001 — checkpointing is never fatal
            logger.warning("ckpt_intent(step=%d) failed: %s", step, e)
            return
        if not resp.get("ok"):
            return  # already committed, or superseded by a newer window
        faults_lib.crash_point("worker.ckpt_save", host=self.host)
        cursor = {"batches_done": int(applied), "epoch": int(epoch),
                  "step": step}
        t0 = self._obs.begin("ckpt.save")
        try:
            fut = checkpoint.save_checkpoint(
                self.prefix, step, state, async_save=True, cursor=cursor)
        except checkpoint.CheckpointSaveError:
            self._obs.abandon(t0)
            raise  # an earlier background failure surfaces here
        prefix, ctrl, host, obs = self.prefix, self.ctrl, self.host, self._obs

        def _acked(f) -> None:
            # on the writer thread: the wire client is thread-safe
            if f.exception() is not None:
                obs.abandon(t0)  # counted already; no ack, the window aborts
                return
            path = f.result()
            ent = checkpoint.checkpoint_info(prefix, step) or {}
            obs.complete_span("ckpt.save", t0, {"step": step, "host": host})
            try:
                ctrl.ckpt_ack(step, path, ent.get("sha256", ""), cursor)
            except Exception as e:  # noqa: BLE001
                logger.warning("ckpt_ack(step=%d) failed: %s", step, e)

        fut.add_done_callback(_acked)


def resume_manifest(ctrl) -> Optional[dict]:
    """The committed manifest to resume from, or ``None``: it takes the
    worker's ``DT_RESUME`` and a manifest the scheduler served at
    registration."""
    if ctrl is None or not config.env("DT_RESUME"):
        return None
    return getattr(ctrl, "resume", None)


def restore_state(manifest: dict, host: Optional[str],
                  state) -> Tuple[object, Dict]:
    """Restore ``state`` in place from the manifest: this host's blob, else
    any member's (the same state on every worker: the N+-1 resume),
    verified against the journaled sha256.  Returns ``(state, cursor)``."""
    files = manifest.get("files") or {}
    ent = files.get(host) if host else None
    donor = host
    if ent is None:
        if not files:
            raise checkpoint.CheckpointCorruptError(
                "<manifest>", "committed manifest has no files")
        donor = sorted(files)[0]
        ent = files[donor]
    state = checkpoint.load_checkpoint_file(ent["path"], state,
                                            sha256=ent.get("sha256"))
    logger.info("resumed the train state from %s (step %s, donor %s)",
                ent["path"], manifest.get("step"), donor)
    return state, dict(ent.get("cursor") or {})


def fast_forward(train_data, epochs: int) -> None:
    """Replay the data schedule of ``epochs`` completed epochs through the
    iterator protocol (reset, drain), as fit consumed them: the shuffle
    state and ``ResizeIter``'s refills end where the killed run's did."""
    for _ in range(int(epochs)):
        train_data.reset()
        try:
            while True:
                train_data.next()
        except StopIteration:
            pass


def skip_batches(train_data, n: int) -> int:
    """Advance a just-reset iterator past the ``batches_done`` applied
    before the checkpoint; returns how many it skipped (a smaller epoch
    after a resize may end first)."""
    done = 0
    try:
        for _ in range(int(n)):
            train_data.next()
            done += 1
    except StopIteration:
        pass
    return done
