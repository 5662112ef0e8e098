"""The scheduler's control state (counterpart of ``ControlState``,
``dt_tpu/elastic/journal.py:375-692``, copied since the port imports
nothing of the JAX package).

Every scheduler mutation goes through :meth:`ControlState.apply`, so the
write-ahead journal of scheduler HA (ROADMAP Queue 1 item 3c) can be put
in front of it later without a rewrite.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Set


class ControlState:
    """The scheduler's state, changed only through named ops
    (``journal.py:375-692``): the scheduler holds its lock around
    :meth:`apply`.  Ops are idempotent (absolute ``seq``/``gen``/``epoch``
    values ride in each op; membership edits check current membership),
    so a journal could replay them; the write-ahead journal itself, the
    lease and snapshot sidecars are scheduler HA, ROADMAP Queue 1 item 3c.

    ``mc_partial`` tracks a membership change in flight: ``mc_begin``
    opens it and each applied remove/recover/add lands in it, so one
    barrier applies one kind of change (``elastic_training.cc:91-157``).
    """

    def __init__(self):
        self.workers: List[str] = []
        self.base: Set[str] = set()
        self.base0: Set[str] = set()
        self.registered: Set[str] = set()
        self.pending_recovery: Set[str] = set()
        self.recovered_at: Dict[str, int] = {}
        self.removed_hosts: Set[str] = set()
        self.log_seq = 0
        self.expected_workers = 0
        self.barrier_epoch: Optional[int] = None
        self.barrier_arrived: Set[str] = set()
        self.barrier_result: Dict[int, dict] = {}
        self.last_completed_epoch = -1
        self.plain_arrived: Set[str] = set()
        self.plain_gen = 0
        self.plain_served: Dict[str, int] = {}
        self.snapshot = None
        self.mc_partial: Optional[Dict[str, Any]] = None
        # the barrier results' policy view reads these (no engine runs)
        self.policy_shares: Dict[str, int] = {}
        self.policy_lr_scale: float = 1.0
        self.policy_seq = 0
        self.draining: Set[str] = set()

    # -- op dispatch ------------------------------------------------------

    def apply(self, op: str, **kw: Any) -> None:
        fn = getattr(self, f"_op_{op}", None)
        if fn is None:
            raise ValueError(f"unknown control-state op {op!r}")
        fn(**kw)

    # -- ops --------------------------------------------------------------

    def _op_init(self, workers: List[str], expected: int) -> None:
        if self.workers or self.base0:
            return  # replayed twice: the baseline is already seeded
        self.workers = list(workers)
        self.base = set(workers)
        self.base0 = set(workers)
        self.expected_workers = int(expected)

    def _op_worker_add(self, host: str, base: bool) -> None:
        if host not in self.workers:
            self.workers.append(host)
            if base:
                self.base.add(host)
        self.registered.add(host)

    def _op_recovery_pending(self, host: str) -> None:
        self.pending_recovery.add(host)
        self.registered.add(host)

    def _op_quick_evict(self, host: str, seq: int) -> None:
        """Quick-restart eviction (recovery registration beat the
        auto-evictor): drop the dead incarnation, queue the new one."""
        if host in self.workers:
            self.workers.remove(host)
        self.registered.discard(host)
        self.base.discard(host)
        self.removed_hosts.add(host)
        self.pending_recovery.add(host)
        self.barrier_arrived.discard(host)
        self.log_seq = max(self.log_seq, int(seq))
        self._policy_forget(host)

    def _op_evict(self, host: str, seq: int) -> None:
        if host in self.workers:
            self.workers.remove(host)
        self.registered.discard(host)
        self.base.discard(host)
        self.removed_hosts.add(host)
        self.log_seq = max(self.log_seq, int(seq))
        self._policy_forget(host)

    def _op_barrier_arrive(self, host: str, epoch: int) -> None:
        if epoch <= self.last_completed_epoch:
            return  # replay raced the completion record: already released
        if self.barrier_epoch is None:
            self.barrier_epoch = int(epoch)
        self.barrier_arrived.add(host)

    def _op_mc_begin(self, epoch: int) -> None:
        if self.mc_partial is not None and \
                self.mc_partial["epoch"] == epoch:
            return  # resumed after a mid-change crash: keep the prefix
        self.mc_partial = {"epoch": int(epoch), "removed": [],
                           "recovered": [], "added": []}

    def _mc_track(self, kind: str, host: str) -> None:
        if self.mc_partial is not None and \
                host not in self.mc_partial[kind]:
            self.mc_partial[kind].append(host)

    def _op_mc_remove(self, host: str, seq: int) -> None:
        if host in self.workers:
            self.workers.remove(host)
        self.removed_hosts.add(host)
        self.registered.discard(host)
        self.base.discard(host)
        self.log_seq = max(self.log_seq, int(seq))
        self._mc_track("removed", host)
        self._policy_forget(host)

    def _op_mc_recover(self, host: str, epoch: int, seq: int) -> None:
        self.pending_recovery.discard(host)
        self.removed_hosts.discard(host)
        if host not in self.workers:
            self.workers.append(host)
        if host in self.base0:
            self.base.add(host)
        self.recovered_at[host] = int(epoch)
        self.log_seq = max(self.log_seq, int(seq))
        self._mc_track("recovered", host)

    def _op_mc_add(self, host: str, seq: int) -> None:
        self.removed_hosts.discard(host)
        if host not in self.workers:
            self.workers.append(host)
        self.log_seq = max(self.log_seq, int(seq))
        self._mc_track("added", host)

    def _op_barrier_complete(self, epoch: int, result: dict) -> None:
        self.barrier_result[int(epoch)] = result
        self.last_completed_epoch = max(self.last_completed_epoch,
                                        int(epoch))
        self.barrier_epoch = None
        self.barrier_arrived = set()
        self.mc_partial = None

    def _op_recovered_clear(self, host: str) -> None:
        self.recovered_at.pop(host, None)

    def _op_plain_arrive(self, host: str, seq: int) -> None:
        self.plain_arrived.add(host)
        self.plain_served[host] = int(seq)

    def _op_plain_release(self, gen: int) -> None:
        if int(gen) > self.plain_gen:
            self.plain_gen = int(gen)
        self.plain_arrived = set()

    def _policy_forget(self, host: str) -> None:
        """A removed host leaves the policy board (empty while the policy
        engine is not ported)."""
        self.policy_shares.pop(host, None)

    def _op_drain(self, host: str, seq: int) -> None:
        """A graceful drain (SIGTERM): the host loses base protection and
        is marked draining, so its departure reads as intended."""
        self.draining.add(host)
        self.base.discard(host)
        self.base0.discard(host)
        self.log_seq = max(self.log_seq, int(seq))

    def _op_snapshot(self, blob: Any) -> None:
        self.snapshot = blob
