"""The host-sync core of the elastic scheduler (counterpart of
``Scheduler``, ``dt_tpu/elastic/scheduler.py:95``, copied since the port
imports nothing of the JAX package and the card's machine has no JAX).

The ps-lite scheduler role plus the fork's ``ETDefaultNodeManager``
(``ps-lite/src/elastic_training.cc``, ``van.cc:256-315``): one instance a
job, a thread a connection over the pooled transport
(``protocol.serve_connection``), all state under one lock in a
``journal.ControlState``.  It serves, as the JAX package's does:

- ``register`` of base and new workers, and the re-admission of a crashed
  worker under its old name (``DT_RECOVERY``; ``van.cc:187-218``);
- ``heartbeat``, ``num_dead`` and the eviction of silent workers
  (``auto_evict_dead_s``);
- ``mc_barrier`` at each epoch boundary: it releases when every live
  worker arrived, after diffing ``host_worker`` against the live set and
  applying one change, removals before adds (``elastic_training.cc:
  91-126``), with the ``<host_worker>_log`` audit lines ``SEQ ADDED|
  REMOVED|RECOVERED|DRAINED HOST TIME``; ``launch_callback(host, epoch)``
  starts an added worker, ``pre_change_hook(epoch)`` runs before the diff;
- the plain ``barrier``; ``allreduce`` through ``dataplane.DataPlane``;
  ``publish_snapshot``/``fetch_snapshot``; ``drain``; ``membership``,
  ``status`` and ``shutdown``.

Every other command of the JAX scheduler answers an error naming its
ROADMAP item (:data:`UNPORTED`), never a silent no-op.
"""

from __future__ import annotations

import logging
import os
import random
import socket
import threading
import time
from typing import Callable, List, Optional, Set

from dt_tpu_torch import config
from dt_tpu_torch.elastic import faults, journal, protocol
from dt_tpu_torch.elastic.dataplane import DataPlane
from dt_tpu_torch.obs import trace as obs_trace

logger = logging.getLogger("dt_tpu_torch.elastic")
_drop_rng = random.Random(0xD207)  # DT_DROP_MSG, seeded as the JAX one

#: responses not kept in the token cache: read-only commands, or ones with
#: their own (host, seq) dedup (the JAX scheduler's ``_TOKEN_EXEMPT``)
_TOKEN_EXEMPT = frozenset((
    "allreduce", "async_init", "async_pull_rows", "async_push",
    "async_stats", "blackbox_index", "ckpt_manifest", "fetch_snapshot",
    "ha_round", "health", "heartbeat", "membership", "num_dead",
    "obs_dump", "obs_push", "serve_endpoints", "serve_heartbeat",
    "serve_register", "servers", "status"))

_ITEM = "is not ported yet; see ROADMAP.md, Queue 1 "
#: the JAX scheduler's commands this one does not serve, each with the
#: ROADMAP item that brings it
UNPORTED = {
    **dict.fromkeys(("obs_push", "obs_dump", "health", "blackbox_index",
                     "profile", "profile_capture"),
                    "item 7 (the obs, metrics and device planes)"),
    **dict.fromkeys(("serve_register", "serve_heartbeat",
                     "serve_endpoints"),
                    "item 5 (the serve gateway and replica)"),
    **dict.fromkeys(("register_server", "servers"),
                    "item 3b (the sparse allreduce and range servers)"),
    **dict.fromkeys(("ckpt_intent", "ckpt_ack", "ckpt_manifest"),
                    "item 3e (fleet checkpoints)"),
    "ha_round": "item 3c (scheduler HA)",
}


class Scheduler:
    def __init__(self, host_worker_file: Optional[str] = None,
                 initial_workers: Optional[List[str]] = None,
                 port: int = 0,
                 launch_callback: Optional[Callable[[str, int], None]] = None,
                 host_worker_log: Optional[str] = None,
                 expected_workers: Optional[int] = None,
                 pre_change_hook: Optional[Callable[[int], None]] = None,
                 auto_evict_dead_s: Optional[float] = None,
                 startup_grace_s: float = 120.0,
                 journal_path: Optional[str] = None,
                 lease_path: Optional[str] = None,
                 lease_s: Optional[float] = None,
                 standby: bool = False,
                 peer: Optional[tuple] = None,
                 resume: bool = False):
        """``initial_workers`` seeds the base set, else the hosts listed in
        ``host_worker_file`` do.  ``journal_path``, ``lease_path``,
        ``lease_s``, ``standby``, ``peer`` (scheduler HA, ROADMAP Queue 1
        item 3c) and ``resume`` (fleet checkpoints, item 3e) raise."""
        journal_path = journal_path or (config.env("DT_CTRL_JOURNAL")
                                        or None)
        for name, val, item in (
                ("journal_path", journal_path, "3c (scheduler HA)"),
                ("lease_path", lease_path, "3c (scheduler HA)"),
                ("lease_s", lease_s, "3c (scheduler HA)"),
                ("standby", standby, "3c (scheduler HA)"),
                ("peer", peer, "3c (scheduler HA)"),
                ("resume", resume, "3e (fleet checkpoints)")):
            if val:
                raise NotImplementedError(
                    f"Scheduler({name}=...) {_ITEM}item {item}")
        self.host_worker_file = host_worker_file
        if initial_workers is None and host_worker_file and \
                os.path.exists(host_worker_file):
            initial_workers = _read_hosts(host_worker_file)

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._state = journal.ControlState()  # guarded-by: _lock
        if initial_workers:
            with self._cv:
                self._apply("init", workers=list(initial_workers),
                            expected=(expected_workers
                                      or len(initial_workers)))
        self.expected_workers = (expected_workers
                                 or self._state.expected_workers
                                 or len(self._state.workers))
        # seeded at start, so a worker that never comes up ages out
        now = time.time()
        self._heartbeats = {h: now for h in self._state.workers}  # guarded-by: _lock
        self._log_path = host_worker_log or (
            host_worker_file + "_log" if host_worker_file else None)
        self._launch_callback = launch_callback
        self._pre_change_hook = pre_change_hook
        # the snapshot has its own lock: a model-sized blob copy never
        # blocks membership traffic
        self._snapshot_lock = threading.Lock()
        self._obs = obs_trace.Tracer(name="control-plane")
        self._barrier_t0 = None  # guarded-by: _lock
        self._dp = DataPlane(expected_fn=lambda: list(self._state.workers),
                             tracer=self._obs)
        self._tokens = protocol.TokenCache(
            ttl_s=float(config.env("DT_CTRL_TOKEN_TTL_S")))

        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((protocol.bind_interface(), port))
        self._sock.listen(128)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._close_lock = threading.Lock()
        self._closed = False  # guarded-by: _close_lock
        self._conns: Set[socket.socket] = set()  # guarded-by: _conns_lock
        self._conns_lock = threading.Lock()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        # beyond the reference: silent workers are evicted (base workers
        # too: a crashed base worker would hang the job), and pending
        # collectives complete with the survivors
        self.auto_evict_dead_s = auto_evict_dead_s
        self.startup_grace_s = max(startup_grace_s, auto_evict_dead_s or 0)
        self._evict_thread: Optional[threading.Thread] = None
        if auto_evict_dead_s:
            self._evict_thread = threading.Thread(target=self._evict_loop,
                                                  daemon=True)
            self._evict_thread.start()
        logger.info("scheduler listening on :%d, base workers %s",
                    self.port, self._state.workers)

    # ------------------------------------------------------------------
    # state access
    # ------------------------------------------------------------------

    def _apply(self, op: str, **kw) -> None:
        """Apply one control-state op.  Caller holds the lock (the
        snapshot op: ``_snapshot_lock``)."""
        self._state.apply(op, **kw)

    # ------------------------------------------------------------------
    # server plumbing
    # ------------------------------------------------------------------

    def _serve(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._handle_conn, args=(conn,),
                             daemon=True).start()

    def _handle_conn(self, conn: socket.socket):
        self._obs.counter("transport.connections")
        try:
            protocol.serve_connection(conn, self._handle_one)
        finally:
            with self._conns_lock:
                self._conns.discard(conn)

    def _handle_one(self, msg: dict) -> Optional[dict]:
        return protocol.traced_handle(self._obs, msg, self._handle_inner)

    def _handle_inner(self, msg: dict) -> Optional[dict]:
        """One request; ``None`` closes the channel unanswered (an
        injected receive-side drop: the client sees EOF and retries)."""
        self._obs.counter("transport.requests")
        drop = config.env("DT_DROP_MSG")
        if drop and _drop_rng.random() * 100 < float(drop):
            return None
        plan = faults.active_plan()
        if plan is not None and \
                not plan.on_recv(msg.get("cmd"), msg.get("host")):
            return None
        token = msg.get("token")
        if token is not None:
            cached = self._tokens.get(token)
            if cached is not None:
                self._obs.counter("tokens.dedup_hits")
                return cached
        try:
            resp = self._dispatch(msg)
        except Exception as e:
            if self._stop.is_set():
                # close() raced this handler: close the connection, as
                # the process death close() stands in for would
                return None
            logger.exception("scheduler handler error")
            return {"error": repr(e)}
        if token is not None and "error" not in resp and \
                msg.get("cmd") not in _TOKEN_EXEMPT:
            self._tokens.put(token, resp)
        return resp

    def close(self):
        """Shut down (idempotent): wake waiters, stop accepting, sever
        the accepted connections (a client parked at a barrier sees a
        reset now) and join the owned threads with a timeout."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        # shutdown before close: a plain close does not wake accept()
        for fn in (lambda: self._sock.shutdown(socket.SHUT_RDWR),
                   self._sock.close):
            try:
                fn()
            except OSError:
                pass
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            for fn in (lambda c=c: c.shutdown(socket.SHUT_RDWR), c.close):
                try:
                    fn()
                except OSError:
                    pass
        me = threading.current_thread()
        for t in (self._evict_thread, self._thread):
            if t is not None and t is not me and t.is_alive():
                t.join(timeout=5.0)

    def join(self, timeout: Optional[float] = None) -> bool:
        """Block until :meth:`close`; True when closed."""
        return self._stop.wait(timeout)

    # ------------------------------------------------------------------
    # dispatch
    # ------------------------------------------------------------------

    def _dispatch(self, msg: dict) -> dict:
        cmd = msg.get("cmd")
        if cmd == "register":
            return self._register(msg["host"], bool(msg.get("is_new")),
                                  bool(msg.get("is_recovery")))
        if cmd == "heartbeat":
            # a JAX worker's span/metrics/device payloads ride here; their
            # ingest is the obs plane (ROADMAP Queue 1 item 7) and is
            # counted, not stored
            for k in ("obs", "hm", "dev"):
                if msg.get(k) is not None:
                    self._obs.counter(f"heartbeat.{k}_ignored")
            with self._lock:
                self._heartbeats[msg["host"]] = time.time()
            return {}
        if cmd == "status":
            with self._lock:
                st = self._state
                out = {"active": True, "incarnation": 0,
                       "workers": list(st.workers),
                       "last_completed_epoch": st.last_completed_epoch,
                       "policy": {"enabled": False,
                                  "shares": dict(st.policy_shares),
                                  "streaks": {},
                                  "lr_scale": st.policy_lr_scale,
                                  "seq": st.policy_seq, "log": []},
                       "ckpt": {"committed_step": None,
                                "pending_step": None,
                                "draining": sorted(st.draining)}}
            return out
        if cmd in DataPlane.CMDS:
            if cmd == "allreduce":
                faults.crash_point("sched.allreduce", host=msg.get("host"))
            return self._dp.dispatch(msg)
        if cmd == "mc_barrier":
            return self._mc_barrier(msg["host"], int(msg["epoch"]),
                                    msg.get("info") or {})
        if cmd == "barrier":
            return self._plain_barrier(msg["host"],
                                       int(msg.get("seq", -1)))
        if cmd == "publish_snapshot":
            with self._snapshot_lock:
                self._apply("snapshot", blob=msg["blob"])
            return {}
        if cmd == "fetch_snapshot":
            with self._snapshot_lock:
                # the one ControlState field read under _snapshot_lock
                return {"blob": self._state.snapshot}
        if cmd == "num_dead":
            return {"count": self._num_dead(float(msg.get("timeout_s", 60)))}
        if cmd == "membership":
            with self._lock:
                return {"workers": list(self._state.workers)}
        if cmd == "drain":
            return self._drain(msg["host"])
        if cmd == "shutdown":
            self.close()
            return {}
        if cmd in UNPORTED:
            return {"error": f"{cmd} {_ITEM}{UNPORTED[cmd]}"}
        return {"error": f"unknown cmd {cmd!r}"}

    # ------------------------------------------------------------------
    # registration / heartbeat
    # ------------------------------------------------------------------

    def _register(self, host: str, is_new: bool,
                  is_recovery: bool = False) -> dict:
        """A base or new worker takes the next rank; a crashed one
        (``is_recovery``) queues for re-admission.  (A failover
        ``reattach`` is scheduler HA: the dense plane keeps no per-host
        state it could purge, so it registers like any worker.)"""
        faults.crash_point("sched.register", host=host)
        with self._cv:
            st = self._state
            if host in st.removed_hosts and not is_recovery:
                # sender validation of removed hosts (van.cc:571-574)
                return {"error": "host was removed from the job"}
            if is_recovery and host in st.workers:
                # a QUICK restart: the old incarnation is gone but not yet
                # evicted; evict it now (the arrival of the dead
                # incarnation at a parked barrier goes with it) and queue
                # the new one for re-admission
                self._apply("quick_evict", host=host, seq=st.log_seq + 1)
                self._audit_locked("REMOVED", host)
                self._rewrite_host_file([host])
                self._complete_pending_locked()
            if host in st.removed_hosts:
                # identity reissue (van.cc:187-218): re-admitted as
                # itself at the next membership barrier, never mid-epoch
                self._apply("recovery_pending", host=host)
                self._heartbeats[host] = time.time()
                self._cv.notify_all()
                self._obs.event("recovery.registered", {"host": host})
                logger.info("recovery registration from %s: pending "
                            "re-admission at the next barrier", host)
                return {"rank": -1, "workers": list(st.workers),
                        "recovery_pending": True,
                        "resume_epoch": st.last_completed_epoch + 1,
                        "profile_seq": 0, "fence": 0, "servers": []}
            self._apply("worker_add", host=host, base=not is_new)
            self._heartbeats[host] = time.time()
            self._cv.notify_all()
            return {"rank": st.workers.index(host),
                    "workers": list(st.workers),
                    "profile_seq": 0, "fence": 0, "servers": []}

    def _num_dead(self, timeout_s: float) -> int:
        now = time.time()
        with self._lock:
            return sum(1 for h in self._state.workers
                       if now - self._heartbeats.get(h, 0.0) > timeout_s)

    # ------------------------------------------------------------------
    # dead-worker eviction
    # ------------------------------------------------------------------

    def _evict_loop(self):
        period = max(self.auto_evict_dead_s / 4.0, 0.1)
        while not self._stop.wait(period):
            now = time.time()
            with self._cv:
                st = self._state
                dead = [
                    h for h in st.workers
                    if now - self._heartbeats.get(h, 0.0) >
                    (self.auto_evict_dead_s if h in st.registered
                     else self.startup_grace_s)]
                if not dead:
                    continue
                for h in dead:
                    logger.warning("evicting dead worker %s (silent %.1fs)",
                                   h, now - self._heartbeats.get(h, 0.0))
                    self._apply("evict", host=h, seq=st.log_seq + 1)
                    self._audit_locked("REMOVED", h)
                self._rewrite_host_file(dead)
                self._complete_pending_locked()
                self._cv.notify_all()

    def _rewrite_host_file(self, evicted):
        """Drop this pass's evicted hosts from host_worker (atomic
        rewrite, ``launch.py:218-224``) so the next diff does not re-add
        them.  Caller holds the lock."""
        if not self.host_worker_file or \
                not os.path.exists(self.host_worker_file):
            return
        listed = _read_hosts(self.host_worker_file)
        kept = [h for h in listed if h not in set(evicted)]
        if kept != listed:
            tmp = self.host_worker_file + ".tmp"
            with open(tmp, "w") as f:
                f.write("\n".join(kept) + ("\n" if kept else ""))
            os.replace(tmp, self.host_worker_file)

    def _add_to_host_file(self, host: str) -> None:
        """Re-list a recovered host, or the next diff would remove it
        again.  Caller holds the lock."""
        if not self.host_worker_file or \
                not os.path.exists(self.host_worker_file):
            return
        if host not in _read_hosts(self.host_worker_file):
            with open(self.host_worker_file, "a") as f:
                f.write(host + "\n")

    def _complete_pending_locked(self):
        """After membership shrank, finish every collective the survivors
        satisfy.  Caller holds the lock."""
        st = self._state
        live = set(st.workers)
        if st.barrier_epoch is not None and live and \
                st.barrier_arrived >= live:
            epoch = st.barrier_epoch
            result = self._apply_membership_change(epoch)
            self._apply("barrier_complete", epoch=epoch, result=result)
            self._obs.complete_span("mc_barrier.window", self._barrier_t0,
                                    {"epoch": epoch,
                                     "released_by": "survivors"})
            self._barrier_t0 = None
        if st.plain_arrived and live and st.plain_arrived >= live:
            self._apply("plain_release", gen=st.plain_gen + 1)
        self._dp.complete_with(live, ordered=st.workers)

    def _drain(self, host: str) -> dict:
        """Graceful departure (SIGTERM, then the current step, then this):
        the host leaves through the eviction machinery, with no recovery
        window."""
        with self._cv:
            st = self._state
            if host in st.draining or host not in st.workers:
                return {"ok": True, "already": True}
            self._apply("drain", host=host, seq=st.log_seq + 1)
            self._obs.event("drain.begin", {"host": host})
            self._apply("evict", host=host, seq=st.log_seq + 1)
            self._audit_locked("DRAINED", host)
            self._rewrite_host_file([host])
            self._complete_pending_locked()
            self._cv.notify_all()
            self._obs.event("drain.complete", {"host": host})
            return {"ok": True}

    # ------------------------------------------------------------------
    # the membership-change barrier
    # ------------------------------------------------------------------

    def _mc_barrier(self, host: str, epoch: int, info: dict) -> dict:
        del info
        with self._cv:
            st = self._state
            if host in st.pending_recovery:
                # a recovering host parks at the NEXT barrier, whatever
                # epoch it thinks it resumes at
                epoch = max(epoch, st.last_completed_epoch + 1)
            admitted = st.recovered_at.get(host)
            if admitted is not None:
                if epoch <= admitted:
                    # a retry of the admitting barrier: the same result
                    return self._result_for(host,
                                            st.barrier_result[admitted])
                self._apply("recovered_clear", host=host)
            if epoch <= st.last_completed_epoch:
                # a late arrival (added during this epoch's barrier)
                res = st.barrier_result.get(epoch)
                if res is None:
                    res = {"workers": list(st.workers), "removed": [],
                           "added": [], "epoch": epoch}
                return self._result_for(host, res)
            if st.barrier_epoch is None:
                self._barrier_t0 = self._obs.now()
            self._apply("barrier_arrive", host=host, epoch=epoch)
            faults.crash_point("sched.barrier_arrived", host=host,
                               epoch=epoch)
            if st.barrier_arrived >= set(st.workers):
                arrived = len(st.barrier_arrived)
                result = self._apply_membership_change(epoch)
                self._apply("barrier_complete", epoch=epoch, result=result)
                self._obs.complete_span("mc_barrier.window",
                                        self._barrier_t0,
                                        {"epoch": epoch,
                                         "arrived": arrived})
                self._barrier_t0 = None
                self._cv.notify_all()
                return self._result_for(host, result)
            while epoch > st.last_completed_epoch:
                if self._stop.is_set():
                    raise RuntimeError("scheduler closed")
                if not self._cv.wait(timeout=300):
                    raise TimeoutError(f"mc_barrier epoch {epoch} stuck")
            return self._result_for(host, st.barrier_result[epoch])

    def _result_for(self, host: str, result: dict) -> dict:
        out = dict(result)
        out["you_are_removed"] = host in result["removed"]
        out["rank"] = result["workers"].index(host) \
            if host in result["workers"] else -1
        return out

    def _apply_membership_change(self, epoch: int) -> dict:
        """Diff host_worker against the live set; removals beat adds
        (``elastic_training.cc:91-157``): one barrier applies removals or
        additions, never both, so a removal always changes the worker
        count.  Base workers are never removed by the diff.  Caller holds
        the lock."""
        t0 = self._obs.now()
        st = self._state
        if self._pre_change_hook is not None:
            try:
                self._pre_change_hook(epoch)
            except Exception:
                logger.exception("pre_change_hook failed")
        desired = set(st.workers)
        if self.host_worker_file and os.path.exists(self.host_worker_file):
            desired = set(_read_hosts(self.host_worker_file))
        faults.crash_point("sched.membership_change", epoch=epoch)
        self._apply("mc_begin", epoch=epoch)
        partial = st.mc_partial
        current = set(st.workers)
        removable = (current - desired) - st.base  # base protected
        blocked = (current - desired) & st.base
        if blocked:
            logger.warning("refusing to remove base workers %s "
                           "(README.md:54-61)", sorted(blocked))
        if removable or partial["removed"]:
            for h in sorted(removable):
                faults.crash_point("sched.membership_change", host=h,
                                   epoch=epoch)
                self._apply("mc_remove", host=h, seq=st.log_seq + 1)
                self._audit_locked("REMOVED", h)
        else:
            # crashed-and-restarted hosts come back as themselves (audit
            # RECOVERED), only those that arrived at this barrier
            for h in sorted(st.pending_recovery & st.barrier_arrived):
                faults.crash_point("sched.membership_change", host=h,
                                   epoch=epoch)
                self._apply("mc_recover", host=h, epoch=epoch,
                            seq=st.log_seq + 1)
                self._audit_locked("RECOVERED", h)
                self._add_to_host_file(h)
            # a pending recovery never enters through the plain ADD
            to_add = sorted(desired - set(st.workers)
                            - st.pending_recovery)
            for h in to_add:
                faults.crash_point("sched.membership_change", host=h,
                                   epoch=epoch)
                self._apply("mc_add", host=h, seq=st.log_seq + 1)
                self._heartbeats[h] = time.time()  # grace until it registers
                self._audit_locked("ADDED", h)
                if self._launch_callback is not None:
                    # EPOCH_BEGIN = this epoch (elastic_training.cc:26-62)
                    threading.Thread(target=self._launch_callback,
                                     args=(h, epoch), daemon=True).start()
        removed = list(partial["removed"])
        added = list(partial["added"])
        recovered = list(partial["recovered"])
        if removed or added or recovered:
            self._obs.complete_span(
                "membership_change", t0,
                {"epoch": epoch, "removed": removed, "added": added,
                 "recovered": recovered})
            logger.info("Epoch[%d] membership change: removed=%s added=%s "
                        "recovered=%s -> %s", epoch, removed, added,
                        recovered, st.workers)
        return {"workers": list(st.workers), "removed": removed,
                "added": added, "recovered": recovered, "epoch": epoch}

    def _audit_locked(self, action: str, host: str):
        """``SEQ ACTION HOST TIME`` (``elastic_training.cc:108-126``);
        the seq was advanced by the op.  Caller holds the lock."""
        seq = self._state.log_seq
        self._obs.event(f"membership.{action}", {"host": host, "seq": seq})
        if self._log_path:
            with open(self._log_path, "a") as f:
                f.write(f"{seq} {action} {host} "
                        f"{time.strftime('%Y-%m-%d_%H:%M:%S')}\n")

    # ------------------------------------------------------------------
    # plain barrier
    # ------------------------------------------------------------------

    def _plain_barrier(self, host: str, seq: int = -1) -> dict:
        """``seq`` dedups retries: a re-sent request of a released
        generation returns at once."""
        with self._cv:
            st = self._state
            if seq >= 0 and host not in st.plain_arrived and \
                    st.plain_served.get(host) == seq:
                return {}
            gen = st.plain_gen
            self._apply("plain_arrive", host=host, seq=seq)
            if st.plain_arrived >= set(st.workers):
                self._apply("plain_release", gen=gen + 1)
                self._cv.notify_all()
                return {}
            while st.plain_gen == gen:
                if self._stop.is_set():
                    raise RuntimeError("scheduler closed")
                if not self._cv.wait(timeout=300):
                    raise TimeoutError("barrier stuck")
            return {}


def _read_hosts(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip() and
                not ln.strip().startswith("#")]
