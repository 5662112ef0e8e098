"""Control-plane durability: the write-ahead journal, the leader lease with
fencing, the snapshot sidecars and the :class:`ControlState` the
scheduler's state lives in (counterpart of ``dt_tpu/elastic/journal.py``,
copied since the port imports nothing of the JAX package).

- :class:`ControlState` changes only through named, idempotent ops
  (:meth:`ControlState.apply`): absolute ``seq``/``gen``/``epoch`` values
  ride in each op and membership edits check current membership, so a
  journal applied twice equals one applied once.
- :class:`JournalWriter` appends ``u32 len | u32 crc32 | pickle((fence,
  op, kwargs))`` records and fsyncs before the state mutates.  A torn
  final record fails its length or CRC check and replay stops before it;
  a bad record with records after it is corruption and raises.
- :class:`Lease` is the leader lease: a JSON file carrying a monotonic
  incarnation.  The writer re-reads it on every append and raises
  :class:`Fenced` when a newer incarnation holds it, before the write and
  again after the fsync (withdrawing the record).

The record format is the JAX package's byte for byte, and records and
sidecars hold only builtin types and numpy arrays: a journal written by
either package's scheduler replays in the other's to the same
:meth:`ControlState.struct`.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import pickle
import struct
import threading
import time
import zlib
from typing import Any, Dict, Iterator, List, Optional, Set, Tuple

from dt_tpu_torch import config

try:  # posix-only; the HA pair runs on linux hosts
    import fcntl
except ImportError:  # pragma: no cover - non-posix fallback
    fcntl = None  # type: ignore[assignment]

_HDR = struct.Struct("<II")  # record length, crc32(payload)
#: bound on one journal record: a larger length is corruption
MAX_RECORD = 1 << 31


class JournalError(RuntimeError):
    """A malformed journal record in a non-tail position (corruption, as
    opposed to the torn tail replay tolerates)."""


class Fenced(RuntimeError):
    """This writer's incarnation is no longer the lease's: a newer leader
    exists and every further write is refused."""


# ---------------------------------------------------------------------------
# journal framing (journal.py:77-212)
# ---------------------------------------------------------------------------


class JournalWriter:
    """Append-only fsync'd op log.  ``fence`` is the writer's leader
    incarnation, stamped into every record; with a ``lease`` the writer
    re-reads it on each append and raises :class:`Fenced` once a newer
    incarnation holds it."""

    def __init__(self, path: str, fence: int = 0,
                 lease: Optional["Lease"] = None):
        self.path = path
        self.fence = int(fence)
        self._lease = lease
        # appends come under different scheduler locks (membership under
        # the CV, snapshots under the snapshot lock): frames never
        # interleave because of this one
        self._wlock = threading.Lock()
        self._f = open(path, "ab")

    def append(self, op: str, kw: Dict[str, Any]) -> None:
        if self._lease is not None:
            cur = self._lease.incarnation()
            if cur > self.fence:
                raise Fenced(
                    f"journal write refused: lease incarnation {cur} > "
                    f"this writer's {self.fence} (a newer leader exists)")
        payload = pickle.dumps((self.fence, op, kw),
                               protocol=pickle.HIGHEST_PROTOCOL)
        if len(payload) > MAX_RECORD:
            raise JournalError(f"journal record too large: {len(payload)}")
        with self._wlock:
            # cross-process writer exclusion: a deposed leader and its
            # successor both hold append handles, and the withdrawal below
            # must not cut the successor's records
            if fcntl is not None:
                fcntl.flock(self._f.fileno(), fcntl.LOCK_EX)
            try:
                self._f.seek(0, os.SEEK_END)
                start = self._f.tell()
                self._f.write(_HDR.pack(len(payload), zlib.crc32(payload)))
                self._f.write(payload)
                self._f.flush()
                os.fsync(self._f.fileno())
                if self._lease is not None:
                    # re-check after the bytes are durable: a writer
                    # stalled between the check and the fsync could land a
                    # record after the successor's takeover catch-up; ours
                    # is provably last (we hold the lock), so withdraw it
                    cur = self._lease.incarnation()
                    if cur > self.fence:
                        self._f.truncate(start)
                        self._f.flush()
                        os.fsync(self._f.fileno())
                        raise Fenced(
                            f"journal write fenced mid-append: lease "
                            f"incarnation {cur} > this writer's "
                            f"{self.fence}; record withdrawn")
            finally:
                if fcntl is not None:
                    fcntl.flock(self._f.fileno(), fcntl.LOCK_UN)

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


class JournalReader:
    """Incremental reader of a journal another process may still append
    to.  :meth:`read_new` returns every complete record since the last
    call; a torn tail ends the batch without advancing past it, so the
    next call picks the record up once it is complete."""

    def __init__(self, path: str):
        self.path = path
        self._offset = 0

    def read_new(self) -> List[Tuple[int, str, Dict[str, Any]]]:
        out: List[Tuple[int, str, Dict[str, Any]]] = []
        if not os.path.exists(self.path):
            return out
        with open(self.path, "rb") as f:
            f.seek(self._offset)
            while True:
                hdr = f.read(_HDR.size)
                if len(hdr) < _HDR.size:
                    return out  # clean end, or a torn header
                length, crc = _HDR.unpack(hdr)
                if length > MAX_RECORD:
                    raise JournalError(
                        f"journal {self.path}: absurd record length "
                        f"{length} at offset {self._offset}")
                payload = f.read(length)
                if len(payload) < length:
                    return out  # torn tail: the writer died mid-append
                if zlib.crc32(payload) != crc:
                    if f.read(1) == b"":
                        return out  # a CRC-bad final record: torn tail
                    # valid bytes after a bad record cannot come from a
                    # torn append: raise rather than rebuild a prefix
                    raise JournalError(
                        f"journal {self.path}: CRC mismatch at offset "
                        f"{self._offset} with records following (mid-"
                        f"file corruption, not a torn tail)")
                fence, op, kw = pickle.loads(payload)
                out.append((fence, op, kw))
                self._offset = f.tell()


def replay(path: str) -> Iterator[Tuple[int, str, Dict[str, Any]]]:
    """One-shot replay of every complete record (a torn tail dropped)."""
    return iter(JournalReader(path).read_new())


# ---------------------------------------------------------------------------
# snapshot sidecars (journal.py:223-288): a model-sized parameter snapshot
# lives in a digest-named file beside the journal; the journal carries a
# {"__snap_ref__": sha1} marker
# ---------------------------------------------------------------------------

_SNAP_REF = "__snap_ref__"


def _snap_keep() -> int:
    """Sidecars kept (``DT_CTRL_SNAP_KEEP``, default 2: the current one and
    its predecessor, for a standby one snapshot behind), at least 1; an
    unparseable value reads as the default."""
    try:
        keep = int(config.env("DT_CTRL_SNAP_KEEP"))
    except ValueError:
        keep = 2
    return max(1, keep)


def snapshot_marker(blob: Any) -> bool:
    return isinstance(blob, dict) and _SNAP_REF in blob


def write_snapshot_sidecar(journal_path: str, blob: Any) -> Dict[str, str]:
    """Write ``blob`` durably to ``<journal>.snap.<digest16>`` (temporary
    file, fsync, rename), prune all but the newest :func:`_snap_keep`
    sidecars and return the marker to journal.  The bytes are durable
    before the marker is."""
    payload = pickle.dumps(blob, protocol=pickle.HIGHEST_PROTOCOL)
    digest = hashlib.sha1(payload).hexdigest()
    path = f"{journal_path}.snap.{digest[:16]}"
    if not os.path.exists(path):
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    prefix = os.path.basename(journal_path) + ".snap."
    d = os.path.dirname(journal_path) or "."
    try:
        snaps = sorted(
            (os.path.join(d, n) for n in os.listdir(d)
             if n.startswith(prefix) and ".tmp." not in n),
            key=os.path.getmtime)
        for old in snaps[:-_snap_keep()]:
            os.unlink(old)
    except OSError:
        pass  # pruning is best-effort: an unpruned sidecar is just disk
    return {_SNAP_REF: digest}


def load_snapshot_sidecar(journal_path: str, digest: str) -> Any:
    """The blob a marker names; ``None`` when its sidecar is gone or fails
    its digest."""
    path = f"{journal_path}.snap.{digest[:16]}"
    try:
        with open(path, "rb") as f:
            payload = f.read()
    except OSError:
        return None
    if hashlib.sha1(payload).hexdigest() != digest:
        return None
    return pickle.loads(payload)


# ---------------------------------------------------------------------------
# the leader lease (journal.py:297-367)
# ---------------------------------------------------------------------------


class Lease:
    """Leader lease file: JSON ``{incarnation, owner, ts}``.  The leader
    renews ``ts``; a standby that finds ``ts`` older than the lease
    duration acquires it with ``incarnation + 1``.  Writes are atomic
    (temporary file, rename) and read back; the incarnation is what
    protects the state (the journal's fencing), not the acquire race."""

    def __init__(self, path: str, clock=time.time):
        self.path = path
        self._clock = clock
        self._wseq = itertools.count()  # a temporary name per write

    def read(self) -> Optional[Dict[str, Any]]:
        try:
            with open(self.path) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def incarnation(self) -> int:
        cur = self.read()
        return int(cur["incarnation"]) if cur else 0

    def expired(self, lease_s: float) -> bool:
        cur = self.read()
        if cur is None:
            return True
        return self._clock() - float(cur.get("ts", 0.0)) > lease_s

    def _write(self, rec: Dict[str, Any]) -> None:
        # unique per write, not per process: a renew thread and an
        # in-process standby's acquire share a pid
        tmp = (f"{self.path}.tmp.{os.getpid()}."
               f"{threading.get_ident()}.{next(self._wseq)}")
        with open(tmp, "w") as f:
            json.dump(rec, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def acquire(self, owner: str) -> int:
        """Take the lease with the next incarnation; returns it."""
        inc = self.incarnation() + 1
        self._write({"incarnation": inc, "owner": owner,
                     "ts": self._clock()})
        got = self.read()
        if not got or got.get("owner") != owner or \
                int(got["incarnation"]) != inc:
            raise Fenced(f"lease acquire lost a race on {self.path}")
        return inc

    def renew(self, incarnation: int, owner: str) -> bool:
        """Refresh ``ts`` while we hold the lease; ``False`` (fenced) once
        a newer incarnation took it."""
        cur = self.read()
        if cur is not None and int(cur["incarnation"]) > incarnation:
            return False
        self._write({"incarnation": incarnation, "owner": owner,
                     "ts": self._clock()})
        return True


# ---------------------------------------------------------------------------
# the control state (journal.py:375-742)
# ---------------------------------------------------------------------------


class ControlState:
    """The scheduler's journaled state, changed only through named ops.
    The scheduler holds its lock around :meth:`apply` and journals each op
    before applying it; replay builds a fresh instance and applies the
    recorded ops.

    ``mc_partial`` tracks a membership change in flight: ``mc_begin`` opens
    it and each applied remove/recover/add lands in it, so a leader killed
    inside a change leaves a prefix the successor finishes in the same
    direction (one kind of change per barrier, ``elastic_training.cc:
    91-157``).  The policy fields hold the applied ``policy_decide``
    records of either package's scheduler.  The fleet checkpoint journals intent, per-worker
    acks and commit; only ``ckpt_committed`` is ever resumed from.
    """

    #: decision-log rows kept in memory (the journal keeps every record)
    POLICY_LOG_KEEP = 256

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
        self.policy_shares: Dict[str, int] = {}
        self.policy_streaks: Dict[str, int] = {}
        self.policy_lr_scale: float = 1.0
        self.policy_seq = 0
        self.policy_log: List[Dict[str, Any]] = []
        self.ckpt_seq = 0
        self.ckpt_pending: Optional[Dict[str, Any]] = None
        self.ckpt_committed: Optional[Dict[str, Any]] = None
        self.resume_seq = 0
        self.draining: Set[str] = set()
        # the journal path snapshot markers resolve against at replay
        self.sidecar_base: Optional[str] = None

    # -- op dispatch ------------------------------------------------------

    def apply(self, op: str, **kw: Any) -> None:
        fn = getattr(self, f"_op_{op}", None)
        if fn is None:
            raise JournalError(f"unknown control-state op {op!r}")
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
        """A removed host leaves the policy board."""
        self.policy_shares.pop(host, None)
        self.policy_streaks.pop(host, None)

    def _op_policy_decide(self, epoch: int, seq: int,
                          breached: List[str],
                          streaks: Dict[str, int],
                          shares: Dict[str, int],
                          lr_scale: float = 1.0,
                          evicted: Optional[List[str]] = None,
                          proposals: Optional[List[dict]] = None) -> None:
        """One applied policy decision: absolute streaks and shares ride
        in the record, ``seq`` makes a replay a no-op."""
        if int(seq) <= self.policy_seq:
            return
        self.policy_seq = int(seq)
        self.policy_streaks = {h: int(s) for h, s in sorted(streaks.items())}
        self.policy_shares = {h: int(u) for h, u in sorted(shares.items())}
        self.policy_lr_scale = float(lr_scale)
        self.policy_log.append({
            "seq": int(seq), "epoch": int(epoch),
            "breached": sorted(breached),
            "streaks": dict(self.policy_streaks),
            "shares": dict(self.policy_shares),
            "lr_scale": float(lr_scale),
            "evicted": sorted(evicted or []),
            "proposals": list(proposals or [])})
        del self.policy_log[:-self.POLICY_LOG_KEEP]

    def _op_ckpt_intent(self, step: int, epoch: int, seq: int,
                        workers: List[str]) -> None:
        """Phase 1 of the fleet checkpoint: pin the step and the workers
        whose acks gate the commit.  A newer intent supersedes a pending
        one (its blobs are garbage; the last commit still wins)."""
        if int(seq) <= self.ckpt_seq:
            return
        self.ckpt_seq = int(seq)
        self.ckpt_pending = {"step": int(step), "epoch": int(epoch),
                             "seq": int(seq),
                             "workers": sorted(workers), "acks": {}}

    def _op_ckpt_ack(self, step: int, host: str, path: str, sha256: str,
                     cursor: Dict[str, Any]) -> None:
        """One worker's save is on disk (its digest and data cursor).  An
        ack for a step no longer pending is stale and dropped."""
        p = self.ckpt_pending
        if p is None or p["step"] != int(step):
            return
        p["acks"][host] = {"path": path, "sha256": sha256,
                           "cursor": dict(sorted(cursor.items()))}

    def _op_ckpt_commit(self, step: int, manifest: Dict[str, Any]) -> None:
        """Phase 2: every pinned worker acked, the manifest becomes the
        resume point.  Commits only move forward."""
        p = self.ckpt_pending
        if p is not None and p["step"] == int(step):
            self.ckpt_pending = None
        if self.ckpt_committed is None or \
                int(step) > int(self.ckpt_committed["step"]):
            self.ckpt_committed = dict(manifest)

    def _op_ckpt_abort(self, step: int) -> None:
        """Abandon a pending intent whose worker set changed before every
        ack arrived."""
        p = self.ckpt_pending
        if p is not None and p["step"] == int(step):
            self.ckpt_pending = None

    def _op_drain(self, host: str, seq: int) -> None:
        """A graceful drain (SIGTERM): the host loses base protection and
        is marked draining, so its departure reads as intended."""
        self.draining.add(host)
        self.base.discard(host)
        self.base0.discard(host)
        self.log_seq = max(self.log_seq, int(seq))

    def _op_resume(self, seq: int) -> None:
        """Cold-restart resume: everything of the dead incarnation goes
        back to boot state; the committed manifest and the monotone
        sequences carry forward.  The next ``init`` re-seeds membership
        from the (possibly resized) host file."""
        if int(seq) <= self.resume_seq:
            return
        self.resume_seq = int(seq)
        self.workers = []
        self.base = set()
        self.base0 = set()
        self.registered = set()
        self.pending_recovery = set()
        self.recovered_at = {}
        self.removed_hosts = set()
        self.expected_workers = 0
        self.barrier_epoch = None
        self.barrier_arrived = set()
        self.barrier_result = {}
        self.last_completed_epoch = (
            int(self.ckpt_committed["epoch"]) - 1
            if self.ckpt_committed is not None else -1)
        self.plain_arrived = set()
        self.mc_partial = None
        self.snapshot = None
        self.policy_shares = {}
        self.policy_streaks = {}
        self.policy_lr_scale = 1.0
        self.ckpt_pending = None
        self.draining = set()

    def _op_snapshot(self, blob: Any) -> None:
        if snapshot_marker(blob) and self.sidecar_base:
            loaded = load_snapshot_sidecar(self.sidecar_base,
                                           blob[_SNAP_REF])
            # an unresolvable marker stays a marker: struct() still sees
            # a snapshot, and a fetch resolves it later or gets None
            self.snapshot = loaded if loaded is not None else blob
            return
        self.snapshot = blob

    # -- replay / structural equality ------------------------------------

    @classmethod
    def rebuild(cls, journal_path: str, upto: Optional[int] = None
                ) -> "ControlState":
        """A fresh state from the journal's complete records."""
        st = cls()
        st.sidecar_base = journal_path
        for i, (_fence, op, kw) in enumerate(replay(journal_path)):
            if upto is not None and i >= upto:
                break
            st.apply(op, **kw)
        return st

    def struct(self) -> Dict[str, Any]:
        """Canonical JSON-able view for structural equality (a snapshot
        compares by presence)."""
        return {
            "workers": list(self.workers),
            "base": sorted(self.base),
            "base0": sorted(self.base0),
            "registered": sorted(self.registered),
            "pending_recovery": sorted(self.pending_recovery),
            "recovered_at": dict(sorted(self.recovered_at.items())),
            "removed_hosts": sorted(self.removed_hosts),
            "log_seq": self.log_seq,
            "expected_workers": self.expected_workers,
            "barrier_epoch": self.barrier_epoch,
            "barrier_arrived": sorted(self.barrier_arrived),
            "barrier_result": {int(k): v for k, v
                               in sorted(self.barrier_result.items())},
            "last_completed_epoch": self.last_completed_epoch,
            "plain_arrived": sorted(self.plain_arrived),
            "plain_gen": self.plain_gen,
            "plain_served": dict(sorted(self.plain_served.items())),
            "mc_partial": self.mc_partial,
            "has_snapshot": self.snapshot is not None,
            "policy_seq": self.policy_seq,
            "policy_shares": dict(sorted(self.policy_shares.items())),
            "policy_streaks": dict(sorted(self.policy_streaks.items())),
            "policy_lr_scale": self.policy_lr_scale,
            "policy_log": list(self.policy_log),
            "ckpt_seq": self.ckpt_seq,
            "ckpt_pending": (
                None if self.ckpt_pending is None else
                {**self.ckpt_pending,
                 "acks": dict(sorted(self.ckpt_pending["acks"].items()))}),
            "ckpt_committed": self.ckpt_committed,
            "resume_seq": self.resume_seq,
            "draining": sorted(self.draining),
        }
