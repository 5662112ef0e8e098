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
- the plain ``barrier``; ``allreduce`` (dense, 2-bit and row-sparse) and
  the ``dist_async`` store (``set_optimizer``, ``async_init``,
  ``async_push``, ``async_pull_rows``, ``async_stats``) through its
  embedded ``dataplane.DataPlane``, the single-funnel plane used when no
  range server registered;
- ``register_server`` and ``servers``, the range-server fleet workers
  route their bulk data to (``elastic.range_server``; the register reply
  carries the fleet);
- ``publish_snapshot``/``fetch_snapshot``; ``drain``; ``membership``,
  ``status`` and ``shutdown``;
- the obs planes (``scheduler.py:333, 498-636, 859-1045, 1174-1300,
  1375-1520``): worker span, metrics and device payloads ingested from
  the heartbeat and ``obs_push`` (rseq, sample-seq and dseq dedup, a
  bounded LRU of ``(host, incarnation)`` tracks), ``obs_dump`` with every
  worker track beside the control plane's, ``health`` (the SLO engine over
  the scheduler-derived gauges, ``DT_METRICS``) and the Prometheus
  ``HealthServer`` (``DT_METRICS_PORT``), ``blackbox_index`` with the
  fleet-progress hang detector's suspect (``DT_BLACKBOX``), and the
  broadcast ``profile`` and targeted ``profile_capture`` commands with
  their ``(host, post_seq)`` dedup, delivered on the heartbeat;
- scheduler HA (``scheduler.py:118-250, 418-750``): every state change is
  a ``journal.ControlState`` op appended to a fsync'd write-ahead journal
  (``journal_path``/``DT_CTRL_JOURNAL``) before it applies; leadership is
  a lease file with a fencing incarnation (``lease_path``,
  ``lease_s``/``DT_CTRL_LEASE_S``); a warm standby (``standby=True``, the
  same journal) tails the journal and takes over under ``incarnation + 1``
  when the lease lapses, while the journal refuses the deposed leader's
  writes.  A primary given ``peer=`` replicates each completed allreduce
  round to the standby (``ha_round``) before answering, so rounds complete
  exactly once across a failover.  A passive instance answers
  ``not_leader`` to all but the passive commands (:data:`_PASSIVE_CMDS`);
- the fleet checkpoint (``ckpt_intent``, ``ckpt_ack``, ``ckpt_manifest``,
  ``scheduler.py:1600-1630, 1883-1975``): a two-phase commit journaled as
  ops, the pinned window aborted when a pinned worker leaves; and the
  cold-restart resume (``resume=True``/``DT_RESUME``): the journal
  replayed, the dead incarnation cleared by a journaled ``resume`` op, and
  the committed manifest handed to registering workers until the fleet
  passes the checkpointed epoch;
- the policy engine (``DT_POLICY=1``, ``scheduler.py:215-220, 2088-2264``):
  at each membership barrier, before the diff, ``PolicyEngine.decide`` over
  the data plane's straggler board; evictions (and accepted scale-downs)
  leave the host_worker file so the diff removes them (without a host file
  they become advisory proposals); after the diff, one journaled
  ``policy_decide`` op and the ``policy`` payload (share units, LR scale,
  seq) in the barrier reply; ``status`` and ``obs_dump`` carry the
  ``policy`` and ``straggler`` sections.

Every other command of the JAX scheduler answers an error naming its
ROADMAP item (:data:`UNPORTED`), never a silent no-op.  The scheduler
imports no torch.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import random
import socket
import threading
import time
from typing import Callable, Dict, List, Optional, Set

from dt_tpu_torch import config
from dt_tpu_torch import policy as policy_lib
from dt_tpu_torch.elastic import faults, journal, protocol
from dt_tpu_torch.elastic.dataplane import DataPlane
from dt_tpu_torch.obs import blackbox as obs_blackbox
from dt_tpu_torch.obs import metrics as obs_metrics
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

#: commands a passive instance (a warm standby, a fenced ex-leader) still
#: serves; everything else answers ``not_leader`` so clients rotate (the
#: ``passive`` flag of ``dt_tpu/elastic/commands.py``, copied as data)
_PASSIVE_CMDS = frozenset((
    "blackbox_index", "ckpt_manifest", "ha_round", "health", "obs_dump",
    "obs_push", "shutdown", "status"))

_ITEM = "is not ported yet; see ROADMAP.md, Queue 1 "
#: retained (host, incarnation) obs tracks, LRU-evicted past it
_OBS_MAX_TRACKS = 64
#: the JAX scheduler's commands this one does not serve, each with the
#: ROADMAP item that brings it
UNPORTED = {
    **dict.fromkeys(("serve_register", "serve_heartbeat",
                     "serve_endpoints"),
                    "item 5 (the serve gateway and replica)"),
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
        ``host_worker_file`` do (not for a standby: its state comes from
        the journal).  ``journal_path`` turns the write-ahead journal on (a
        restarted primary replays it); ``standby=True`` builds a warm
        standby that answers ``not_leader`` until the lease (``lease_path``,
        default ``<journal>.lease``) is ``lease_s`` stale, then takes over;
        ``peer=(host, port)`` on the primary replicates completed rounds to
        the standby; ``resume=True`` is the cold-restart resume from the
        journal's committed fleet checkpoint."""
        self.host_worker_file = host_worker_file
        if initial_workers is None and host_worker_file and \
                not standby and os.path.exists(host_worker_file):
            initial_workers = _read_hosts(host_worker_file)

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._state = journal.ControlState()  # guarded-by: _lock
        # this instance's control-plane track; worker tracks arrive on the
        # heartbeat and obs_push, one a (host, incarnation)
        self._obs = obs_trace.Tracer(name="control-plane")
        self._obs_lock = threading.Lock()
        self._obs_tracks: Dict[str, dict] = {}  # guarded-by: _obs_lock
        self._obs_cap = self._obs._cap

        # -- the journal, the lease and fencing ---------------------------
        self.journal_path = journal_path or \
            (config.env("DT_CTRL_JOURNAL") or None)
        self._state.sidecar_base = self.journal_path
        self.lease_s = float(lease_s if lease_s is not None
                             else config.env("DT_CTRL_LEASE_S"))
        lp = lease_path or config.env("DT_CTRL_LEASE") or \
            (self.journal_path + ".lease" if self.journal_path else None)
        self._lease = journal.Lease(lp) \
            if (lp and self.journal_path) else None
        self._journal: Optional[journal.JournalWriter] = None
        self._journal_reader = journal.JournalReader(self.journal_path) \
            if self.journal_path else None
        self._incarnation = 0  # the fencing epoch; bumped in _takeover
        self.standby = bool(standby)
        self.peer = tuple(peer) if peer else None
        self._active = threading.Event()
        self._takeover_lock = threading.Lock()
        if standby:
            if not self.journal_path:
                raise ValueError("a standby scheduler needs a journal_path")
            with self._cv:
                self._refresh_from_journal_locked()
            self._incarnation = self._lease.incarnation() \
                if self._lease else 0
        else:
            if self.journal_path:
                # a restarted primary replays its own journal
                with self._cv:
                    self._refresh_from_journal_locked()
            if self._lease is not None:
                self._incarnation = self._lease.acquire(
                    owner=f"sched:{os.getpid()}")
            if self.journal_path:
                self._journal = journal.JournalWriter(
                    self.journal_path, fence=self._incarnation,
                    lease=self._lease)
            if resume and self.journal_path:
                # the replayed journal holds the dead incarnation's fleet:
                # the resume op clears it (init below re-seeds it from the
                # host file, at any size) and keeps the committed manifest
                with self._cv:
                    self._apply("resume", seq=self._state.resume_seq + 1)
            if not self._state.workers and initial_workers:
                with self._cv:
                    self._apply("init", workers=list(initial_workers),
                                expected=(expected_workers
                                          or len(initial_workers)))
        # while a resume boot has not passed its checkpointed epoch,
        # register hands out the committed manifest
        self._resume_boot = bool(resume)
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
        self._barrier_t0 = None  # guarded-by: _lock
        # fleet-checkpoint timing (the ckpt.commit event's dur_ms and
        # spread_ms); the journaled truth is ControlState.ckpt_*
        self._ckpt_times: Dict[int, dict] = {}  # guarded-by: _lock
        # a draining scheduler (SIGTERM on scheduler_main) flags every
        # heartbeat reply with ckpt_epoch_end; a write-once bool
        self._ckpt_epoch_end = False
        if self._resume_boot and self._state.ckpt_committed is not None:
            m = self._state.ckpt_committed
            self._obs.event("ckpt.resume",
                            {"step": int(m["step"]), "epoch": int(m["epoch"]),
                             "workers": list(m["workers"])})
        # the policy engine (DT_POLICY=1): straggler board -> journaled
        # share rebalances, evictions through the host_worker diff, scale
        # proposals; fixed after init
        self._policy = policy_lib.PolicyEngine.from_env() \
            if policy_lib.enabled() else None
        self._dp = DataPlane(
            expected_fn=lambda: list(self._state.workers), tracer=self._obs,
            replicate_fn=self._make_replicator() if self.peer else None,
            track_lag=self._policy is not None)
        # the range-server fleet, index -> (host, port); its own lock:
        # _server_list() is read from inside _register under _lock
        self._servers: Dict[int, tuple] = {}  # guarded-by: _servers_lock
        self._servers_lock = threading.Lock()
        # the broadcast profiler commands (rank 0 drives every worker)
        self._profile_cmds: List[dict] = []  # guarded-by: _lock
        self._profile_seq = 0  # guarded-by: _lock
        self._profile_posted: Dict[tuple, int] = {}  # guarded-by: _lock
        # the device plane: each host's newest heartbeat `dev` view, and
        # the targeted profile_capture queue
        self._dev_lock = threading.Lock()
        self._dev_tracks: Dict[str, dict] = {}  # guarded-by: _dev_lock
        self._capture_cmds: List[dict] = []  # guarded-by: _lock
        self._capture_seq = 0  # guarded-by: _lock
        self._capture_posted: Dict[tuple, int] = {}  # guarded-by: _lock
        self._tokens = protocol.TokenCache(
            ttl_s=float(config.env("DT_CTRL_TOKEN_TTL_S")))
        # the metrics plane (DT_METRICS): the scheduler-derived gauges,
        # the workers' time-series tracks, the SLO engine on every sample
        # and health read, and the Prometheus endpoint (DT_METRICS_PORT)
        self._metrics = obs_metrics.registry() \
            if obs_metrics.enabled() else None
        self._slo = obs_metrics.SLOEngine.from_env() \
            if self._metrics is not None else None
        self._hm_lock = threading.Lock()
        self._hm_tracks: Dict[str, dict] = {}  # guarded-by: _hm_lock
        self._hm_sampler: Optional[obs_metrics.Sampler] = None
        self._http: Optional[obs_metrics.HealthServer] = None
        self.metrics_port: Optional[int] = None
        if self._metrics is not None:
            self._hm_sampler = obs_metrics.Sampler(
                self._metrics, hook=self._health_refresh, tracer=self._obs)
            port_spec = config.env("DT_METRICS_PORT")
            if port_spec != "":
                try:
                    self._http = obs_metrics.HealthServer(
                        int(port_spec), self.metrics_text, self.health_view)
                    self.metrics_port = self._http.port
                    logger.info("metrics/health endpoint on :%d",
                                self.metrics_port)
                except (OSError, ValueError) as e:
                    # never fatal: a same-host standby loses the bind to
                    # its primary and must still come up
                    logger.warning("metrics/health endpoint on :%s "
                                   "unavailable (%s); continuing without "
                                   "it", port_spec, e)

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
        self._lease_thread: Optional[threading.Thread] = None
        self._monitor_thread: Optional[threading.Thread] = None
        # the flight recorder (DT_BLACKBOX): the fleet-progress hang
        # detector, and the control state in every bundle (the active
        # instance owns the provider slot; a standby takes it over)
        self._bb_lock = threading.Lock()
        self._bb_suspect: Optional[dict] = None  # guarded-by: _bb_lock
        self._bb_thread: Optional[threading.Thread] = None
        if obs_blackbox.enabled() and not standby:
            obs_blackbox.register_state("scheduler", self._bb_state)
        if standby:
            self._monitor_thread = threading.Thread(
                target=self._monitor_loop, daemon=True)
            self._monitor_thread.start()
            logger.info("standby scheduler listening on :%d (journal %s)",
                        self.port, self.journal_path)
        else:
            self._active.set()
            if self._lease is not None:
                self._obs.event("leader.elected",
                                {"incarnation": self._incarnation,
                                 "reason": "primary start"})
                self._start_thread("_lease_thread", self._lease_loop)
            if auto_evict_dead_s:
                self._start_thread("_evict_thread", self._evict_loop)
            self._start_hang_thread()
            logger.info("scheduler listening on :%d (incarnation %d), base "
                        "workers %s", self.port, self._incarnation,
                        self._state.workers)

    # ------------------------------------------------------------------
    # journaled state access
    # ------------------------------------------------------------------

    def _apply(self, op: str, **kw) -> None:
        """Append one op to the journal (fsync), then apply it.  Caller
        holds the lock (the snapshot op: ``_snapshot_lock``).  Raises
        :class:`journal.Fenced` when a newer leader holds the lease; the
        dispatcher answers ``fenced:`` and the client rotates."""
        if self._journal is not None:
            self._journal.append(op, kw)
        self._state.apply(op, **kw)

    def _refresh_from_journal_locked(self) -> None:
        """Apply the records appended since the last read (a standby's
        tail, a restart's replay).  Caller holds the lock."""
        if self._journal_reader is None:
            return
        for _fence, op, kw in self._journal_reader.read_new():
            self._state.apply(op, **kw)

    # ------------------------------------------------------------------
    # leadership: the lease, the standby's watch, the takeover
    # ------------------------------------------------------------------

    @property
    def incarnation(self) -> int:
        """This instance's fencing epoch (0: no lease)."""
        return self._incarnation

    def is_leader(self) -> bool:
        return self._active.is_set()

    def _start_thread(self, attr: str, target) -> None:
        t = threading.Thread(target=target, daemon=True)
        setattr(self, attr, t)
        t.start()

    def _lease_loop(self):
        """The leader's lease renewal; losing the lease to a newer
        incarnation demotes this instance."""
        period = max(self.lease_s / 3.0, 0.05)
        owner = f"sched:{os.getpid()}"
        while not self._stop.wait(period):
            if self._lease is None or not self._active.is_set():
                return
            if not self._lease.renew(self._incarnation, owner):
                logger.error("lease lost to a newer incarnation; fencing "
                             "this scheduler (was %d)", self._incarnation)
                self._obs.event("leader.fenced",
                                {"incarnation": self._incarnation})
                self._active.clear()
                return

    def _primary_gone(self) -> bool:
        """A leader has existed (the lease file is there) and its lease
        lapsed.  A standby never takes over before a primary led: the
        launcher starts the standby first."""
        return (self._lease is not None
                and self._lease.read() is not None
                and self._lease.expired(self.lease_s))

    def _monitor_loop(self):
        """The standby: tail the journal and watch the lease."""
        period = max(self.lease_s / 4.0, 0.05)
        while not self._stop.wait(period):
            if self._active.is_set():
                return
            try:
                with self._cv:
                    self._refresh_from_journal_locked()
                if self._primary_gone():
                    self._takeover("lease expired")
                    return
            except Exception:  # noqa: BLE001 — the watch must not die
                logger.exception("standby monitor pass failed; retrying")

    def _takeover(self, reason: str) -> bool:
        """Promote this standby: the last journal catch-up, the lease
        under ``incarnation + 1``, fresh heartbeat clocks, and the
        ``scheduler.failover`` span."""
        with self._takeover_lock:
            if self._active.is_set():
                return True
            t0 = self._obs.now()
            try:
                inc = self._lease.acquire(owner=f"sched:{os.getpid()}") \
                    if self._lease else self._incarnation + 1
            except journal.Fenced:
                return False  # another standby won; stay passive
            with self._cv:
                self._refresh_from_journal_locked()
                self._incarnation = inc
                self._journal = journal.JournalWriter(
                    self.journal_path, fence=inc, lease=self._lease)
                # the failover window is not silence: every replayed
                # worker gets a fresh clock, or the evictor would evict
                # the healthy fleet
                now = time.time()
                workers = list(self._state.workers)
                for h in workers:
                    self._heartbeats[h] = now
                self._cv.notify_all()
            for h in workers:
                self._dp.host_registered(h)
            self._active.set()
            if self.auto_evict_dead_s:
                self._start_thread("_evict_thread", self._evict_loop)
            if self._lease is not None:
                self._start_thread("_lease_thread", self._lease_loop)
            self._start_hang_thread()
            if obs_blackbox.enabled():
                obs_blackbox.register_state("scheduler", self._bb_state)
            self._obs.complete_span(
                "scheduler.failover", t0,
                {"incarnation": inc, "reason": reason,
                 "workers": len(workers)})
            self._obs.event("leader.elected",
                            {"incarnation": inc, "reason": reason})
            logger.warning("standby took over as leader (incarnation %d): "
                           "%s; workers=%s", inc, reason, workers)
            return True

    def _make_replicator(self):
        """The primary's round replication to the standby, stamped with
        our incarnation (a deposed primary's replica is refused)."""
        host, port = self.peer

        def _rep(key: str, gen: int, seqs: Dict[str, int], result) -> None:
            protocol.request(host, int(port),
                             {"cmd": "ha_round",
                              "fence": self._incarnation, "key": key,
                              "gen": gen, "seqs": seqs, "value": result},
                             timeout=5.0)
        return _rep

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
        # the leadership gate: a passive instance refuses all but the
        # passive commands so clients rotate; a standby whose watch finds
        # the primary gone takes over on demand here, so the first
        # failed-over request completes the failover
        if not self._active.is_set() and \
                msg.get("cmd") not in _PASSIVE_CMDS:
            if not (self.standby and self._primary_gone()
                    and self._takeover("client demand")):
                return {"error": "not_leader",
                        "incarnation": self._incarnation}
        token = msg.get("token")
        if token is not None:
            cached = self._tokens.get(token)
            if cached is not None:
                self._obs.counter("tokens.dedup_hits")
                return cached
        try:
            resp = self._dispatch(msg)
        except journal.Fenced as e:
            # a newer leader exists: stop leading and tell the client to
            # rotate (its failover treats this as a dead endpoint)
            logger.error("request fenced: %s", e)
            self._obs.event("leader.fenced",
                            {"incarnation": self._incarnation})
            self._active.clear()
            return {"error": f"fenced: {e}"}
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
        for t in (self._evict_thread, self._monitor_thread,
                  self._lease_thread, self._bb_thread, self._thread):
            if t is not None and t is not me and t.is_alive():
                t.join(timeout=5.0)
        # identity-guarded: a closing standby keeps the leader's provider
        obs_blackbox.unregister_state("scheduler", fn=self._bb_state)
        if self._hm_sampler is not None:
            self._hm_sampler.stop()
        if self._http is not None:
            self._http.close()
        if self._journal is not None:
            self._journal.close()

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
                                  bool(msg.get("is_recovery")),
                                  reattach=bool(msg.get("reattach")))
        if cmd == "heartbeat":
            # a worker's span, metrics and device payloads ride here
            if msg.get("obs") is not None:
                self._obs_ingest(msg["host"], msg["obs"])
            if msg.get("hm") is not None:
                self._hm_ingest(msg["host"], msg["hm"])
            dev = msg.get("dev")
            if dev is not None:
                self._dev_ingest(msg["host"], dev)
            with self._lock:
                self._heartbeats[msg["host"]] = time.time()
                pseq = int(msg.get("pseq", 0))
                newer = [c for c in self._profile_cmds if c["seq"] > pseq]
                caps = []
                if dev is not None:
                    cseq = int(dev.get("cseq", 0))
                    caps = [c for c in self._capture_cmds
                            if c["target"] == msg["host"]
                            and c["seq"] > cseq]
            out = {}
            if newer:
                out["profile_cmds"] = newer
            if caps:
                out["capture_cmds"] = caps
            if self._ckpt_epoch_end:
                # a draining scheduler asks the fleet for an
                # epoch-boundary checkpoint
                out["ckpt_epoch_end"] = True
            return out
        if cmd == "obs_push":
            # a synchronous flush (a worker's close, an injected crash);
            # the rseq and sample-seq dedup make a replay a no-op
            if msg.get("obs") is not None:
                self._obs_ingest(msg["host"], msg["obs"])
            if msg.get("hm") is not None:
                self._hm_ingest(msg["host"], msg["hm"])
            return {}
        if cmd == "health":
            self._health_refresh()
            return {"health": self.health_view()}
        if cmd == "ha_round":
            return self._ha_round(msg)
        if cmd == "blackbox_index":
            # the bundle manifest and the fleet-hang suspect (the bundles
            # stay on disk)
            with self._bb_lock:
                suspect = dict(self._bb_suspect) \
                    if self._bb_suspect else None
            return {"enabled": obs_blackbox.enabled(),
                    "dir": obs_blackbox.bundle_dir(),
                    "bundles": obs_blackbox.read_manifest(),
                    "suspect": suspect}
        if cmd == "status":
            with self._lock:
                st = self._state
                out = {"active": self._active.is_set(),
                       "incarnation": self._incarnation,
                       "workers": list(st.workers),
                       "last_completed_epoch": st.last_completed_epoch,
                       "policy": self._policy_view_locked(),
                       "ckpt": {
                           "committed_step":
                               int(st.ckpt_committed["step"])
                               if st.ckpt_committed else None,
                           "pending_step":
                               int(st.ckpt_pending["step"])
                               if st.ckpt_pending else None,
                           "draining": sorted(st.draining)}}
            out["straggler"] = self._dp.straggler_scores()
            return out
        if cmd == "profile":
            # recorded; every worker takes it on its next heartbeat, and a
            # retried post (host, post_seq) gets its first seq back
            with self._lock:
                key = (msg.get("host"), msg.get("post_seq"))
                if key[0] is not None and key in self._profile_posted:
                    return {"seq": self._profile_posted[key]}
                self._profile_seq += 1
                self._profile_cmds.append(
                    {"seq": self._profile_seq, "action": msg["action"],
                     "params": msg.get("params") or {}})
                del self._profile_cmds[:-32]  # bounded history
                if key[0] is not None:
                    self._profile_posted[key] = self._profile_seq
                    while len(self._profile_posted) > 128:
                        self._profile_posted.pop(
                            next(iter(self._profile_posted)))
                return {"seq": self._profile_seq}
        if cmd == "profile_capture":
            # a bounded capture on one worker, delivered on its next
            # heartbeat (dev.cseq dedups); retries dedup as "profile"'s
            with self._lock:
                key = (msg.get("host"), msg.get("post_seq"))
                if key[0] is not None and key in self._capture_posted:
                    return {"seq": self._capture_posted[key]}
                if msg["target"] not in self._state.workers:
                    return {"error":
                            f"profile_capture target {msg['target']!r} "
                            f"is not a live worker (live: "
                            f"{sorted(self._state.workers)}); note the "
                            f"target must run with DT_DEVICE_OBS=1"}
                self._capture_seq += 1
                self._capture_cmds.append(
                    {"seq": self._capture_seq, "target": msg["target"],
                     "steps": int(msg.get("steps", 8))})
                del self._capture_cmds[:-16]  # bounded history
                if key[0] is not None:
                    self._capture_posted[key] = self._capture_seq
                    while len(self._capture_posted) > 128:
                        self._capture_posted.pop(
                            next(iter(self._capture_posted)))
                return {"seq": self._capture_seq}
        if cmd in DataPlane.CMDS:
            if cmd == "allreduce":
                faults.crash_point("sched.allreduce", host=msg.get("host"))
            return self._dp.dispatch(msg)
        if cmd == "register_server":
            with self._servers_lock:
                self._servers[int(msg["index"])] = (msg["host"],
                                                    int(msg["port"]))
            logger.info("range server %d registered at %s:%d",
                        int(msg["index"]), msg["host"], int(msg["port"]))
            return {}
        if cmd == "servers":
            return {"servers": self._server_list()}
        if cmd == "mc_barrier":
            return self._mc_barrier(msg["host"], int(msg["epoch"]),
                                    msg.get("info") or {})
        if cmd == "barrier":
            return self._plain_barrier(msg["host"],
                                       int(msg.get("seq", -1)))
        if cmd == "publish_snapshot":
            with self._snapshot_lock:
                blob = msg["blob"]
                if self._journal is not None:
                    # a model-sized blob does not ride the journal: the
                    # bytes go to a sidecar first, then the marker is
                    # journaled, then the blob itself memoed (the bytes
                    # the sidecar holds)
                    self._apply("snapshot", blob=journal.
                                write_snapshot_sidecar(self.journal_path,
                                                       blob))
                    self._state.snapshot = blob
                else:
                    self._apply("snapshot", blob=blob)
            return {}
        if cmd == "fetch_snapshot":
            with self._snapshot_lock:
                # the one ControlState field read under _snapshot_lock
                snap = self._state.snapshot
                if journal.snapshot_marker(snap) and self.journal_path:
                    # replay left a marker it could not resolve yet
                    snap = journal.load_snapshot_sidecar(
                        self.journal_path, snap[journal._SNAP_REF])
                    if snap is not None:
                        self._state.snapshot = snap
                return {"blob": snap}
        if cmd == "num_dead":
            return {"count": self._num_dead(float(msg.get("timeout_s", 60)))}
        if cmd == "membership":
            with self._lock:
                return {"workers": list(self._state.workers)}
        if cmd == "ckpt_intent":
            return self._ckpt_intent(msg["host"], int(msg["step"]),
                                     int(msg["epoch"]))
        if cmd == "ckpt_ack":
            return self._ckpt_ack(msg["host"], int(msg["step"]),
                                  msg["path"], msg["sha256"],
                                  msg.get("cursor") or {})
        if cmd == "ckpt_manifest":
            return self._ckpt_manifest()
        if cmd == "drain":
            return self._drain(msg["host"])
        if cmd == "obs_dump":
            return {"job": self.obs_dump()}
        if cmd == "shutdown":
            self.close()
            return {}
        if cmd in UNPORTED:
            return {"error": f"{cmd} {_ITEM}{UNPORTED[cmd]}"}
        return {"error": f"unknown cmd {cmd!r}"}

    # ------------------------------------------------------------------
    # the obs planes: ingest and export (scheduler.py:859-1045)
    # ------------------------------------------------------------------

    def _obs_ingest(self, host: str, payload: dict) -> None:
        """Fold one worker's span batch into its (host, incarnation)
        track.  At-least-once safe: records carry a strictly rising
        ``rseq`` and a replayed prefix is skipped; the counters and the
        drop count apply only from a newer ``fseq``."""
        key = f"{host}#{payload.get('inc', 0)}"
        records = payload.get("records") or ()
        with self._obs_lock:
            tr = self._obs_tracks.setdefault(
                key, {"records": [], "counters": {}, "dropped": 0,
                      "trunc": 0, "rseq": -1, "fseq": -1})
            # LRU by update order, a bounded count: restart churn mints a
            # track an incarnation
            self._obs_tracks.pop(key)
            self._obs_tracks[key] = tr
            while len(self._obs_tracks) > _OBS_MAX_TRACKS:
                evicted = next(iter(self._obs_tracks))
                del self._obs_tracks[evicted]
                logger.info("obs: evicted stale track %s (track cap %d)",
                            evicted, _OBS_MAX_TRACKS)
            fresh = [r for r in records if r[1] > tr["rseq"]]
            if fresh:
                tr["records"].extend(fresh)
                tr["rseq"] = max(r[1] for r in fresh)
                over = len(tr["records"]) - self._obs_cap
                if over > 0:
                    tr["trunc"] += over  # counted, never silent
                    del tr["records"][:over]
            fseq = int(payload.get("fseq", 0))
            if fseq > tr["fseq"]:
                tr["fseq"] = fseq
                if payload.get("counters"):
                    tr["counters"] = dict(payload["counters"])
                tr["dropped"] = int(payload.get("dropped", tr["dropped"]))

    def obs_dump(self) -> dict:
        """The merged job dump (``scheduler.py:904``): every worker
        incarnation's track plus the control-plane track (this instance's
        records merged with the process tracer's), the straggler board,
        the policy view and, when they hold anything, the device and
        health sections and the metrics tracks."""
        with self._obs_lock:
            tracks = {k: {"records": list(v["records"]),
                          "counters": dict(v["counters"]),
                          "dropped": v["dropped"] + v.get("trunc", 0)}
                      for k, v in self._obs_tracks.items()}
        own = self._obs.snapshot()
        proc = obs_trace.tracer().snapshot()
        tracks["control-plane"] = {
            "records": own["records"] + proc["records"],
            "counters": {**proc["counters"], **own["counters"]},
            "dropped": own["dropped"] + proc["dropped"]}
        with self._lock:
            pol = self._policy_view_locked()
        out = {"tracks": tracks, "straggler": self._dp.straggler_scores(),
               "policy": pol}
        dev = self._dev_view()
        if dev["workers"]:
            out["device"] = dev
        if self._metrics is not None:
            self._health_refresh()
            out["health"] = self.health_view()
            with self._hm_lock:
                mtracks = {
                    k: {"samples": list(t["samples"]),
                        "gauges": [list(g) for g in t["gauges"]],
                        "dropped": t["dropped"] + t.get("trunc", 0)}
                    for k, t in self._hm_tracks.items()}
            mtracks["control-plane"] = {
                "samples": self._metrics.series(),
                "gauges": self._metrics.gauges_export(),
                "dropped": self._metrics.dropped()}
            out["metrics"] = {"tracks": mtracks}
        return out

    def _hm_ingest(self, host: str, payload: dict) -> None:
        """Fold one worker's metrics batch into its (host, incarnation)
        track: samples dedup by ``seq``, the gauge and histogram snapshots
        apply only from a newer ``gseq``."""
        if self._metrics is None:
            return
        key = f"{host}#{payload.get('inc', 0)}"
        cap = self._metrics._cap
        with self._hm_lock:
            tr = self._hm_tracks.setdefault(
                key, {"samples": [], "sseq": -1, "gseq": -1,
                      "gauges": [], "hists": [], "dropped": 0,
                      "trunc": 0})
            self._hm_tracks.pop(key)
            self._hm_tracks[key] = tr
            while len(self._hm_tracks) > _OBS_MAX_TRACKS:
                del self._hm_tracks[next(iter(self._hm_tracks))]
            fresh = [s for s in (payload.get("samples") or ())
                     if s.get("seq", 0) > tr["sseq"]]
            if fresh:
                tr["samples"].extend(fresh)
                tr["sseq"] = max(s["seq"] for s in fresh)
                over = len(tr["samples"]) - cap
                if over > 0:
                    tr["trunc"] += over
                    del tr["samples"][:over]
            gseq = int(payload.get("gseq", 0))
            if gseq > tr["gseq"]:
                tr["gseq"] = gseq
                tr["gauges"] = [list(g) for g in
                                (payload.get("gauges") or ())]
                tr["hists"] = [list(h) for h in
                               (payload.get("hists") or ())]
                tr["dropped"] = int(payload.get("dropped", tr["dropped"]))

    def _dev_ingest(self, host: str, payload: dict) -> None:
        """Keep each host's newest device view (``dseq`` orders them; the
        ingest time rides as ``_ts``, so the hang detector can tell a
        fresh view)."""
        with self._dev_lock:
            tr = self._dev_tracks.get(host)
            dseq = int(payload.get("dseq", 0))
            if tr is not None and dseq and int(tr.get("dseq", 0)) >= dseq:
                return  # stale or duplicated beat
            self._dev_tracks.pop(host, None)
            entry = dict(payload)
            entry["_ts"] = time.time()
            self._dev_tracks[host] = entry
            while len(self._dev_tracks) > _OBS_MAX_TRACKS:
                del self._dev_tracks[next(iter(self._dev_tracks))]

    def _dev_forget(self, hosts) -> None:
        """A removed host's device view goes with it."""
        with self._dev_lock:
            for h in set(hosts):
                self._dev_tracks.pop(h, None)

    def _dev_view(self) -> dict:
        """The device section: each host's view, and who is compiling."""
        with self._dev_lock:
            workers = {h: dict(v) for h, v in self._dev_tracks.items()}
        return {"workers": workers,
                "compiling": sorted(h for h, v in workers.items()
                                    if v.get("compiling"))}

    def _metrics_forget(self, hosts) -> None:
        """A removed host's metrics tracks and worker-labeled gauges go
        with it."""
        if self._metrics is None:
            return
        hosts = set(hosts)
        with self._hm_lock:
            for key in [k for k in self._hm_tracks
                        if k.split("#")[0] in hosts]:
                del self._hm_tracks[key]
        for h in sorted(hosts):
            self._metrics.forget_label("worker", h)

    def _worker_step_rates(self) -> Dict[str, float]:
        """Steps/s a worker, from its last shipped ``train.steps``
        samples (the freshest incarnation wins)."""
        out: Dict[str, float] = {}
        with self._hm_lock:
            for key, tr in self._hm_tracks.items():
                host = key.split("#")[0]
                pts = [(s["ts_ms"], s["gauges"].get("train.steps"))
                       for s in tr["samples"][-8:]
                       if s.get("gauges", {}).get("train.steps")
                       is not None]
                if len(pts) >= 2 and pts[-1][0] > pts[0][0]:
                    out[host] = round(
                        max(pts[-1][1] - pts[0][1], 0) * 1000.0
                        / (pts[-1][0] - pts[0][0]), 4)
        return out

    def _health_refresh(self) -> None:
        """One health pass: the scheduler-derived gauges, then the SLO
        rules.  Takes ``_lock``, ``_obs_lock`` and ``_hm_lock`` one at a
        time; a passive instance skips it (it gets no heartbeats, so its
        staleness would breach for every healthy worker)."""
        if self._metrics is None or not self._active.is_set():
            return
        reg = self._metrics
        now = time.time()
        with self._lock:
            stale = {h: round(now - self._heartbeats.get(h, now), 3)
                     for h in self._state.workers}
        for h, v in sorted(stale.items()):
            reg.gauge("sched.heartbeat_staleness_s", v,
                      labels={"worker": h})
        rates = self._worker_step_rates()
        for h, r in sorted(rates.items()):
            reg.gauge("worker.step_rate", r, labels={"worker": h})
        with self._obs_lock:
            drops = sum(t["dropped"] + t.get("trunc", 0)
                        for t in self._obs_tracks.values())
        drops += self._obs.dropped() + obs_trace.tracer().dropped()
        reg.gauge("obs.ring_dropped", drops)
        inputs: Dict[str, object] = {
            "worker.step_rate": rates,
            "round.wait_ms": self._dp.straggler_scores(),
            "sched.heartbeat_staleness_s": stale,
            "obs.ring_dropped": float(drops),
        }
        p99 = reg.hist_quantile("journal.append_ms", 0.99)
        if p99 is not None:
            inputs["journal.append_ms.p99"] = p99
        self._slo.evaluate(inputs, tracer=self._obs)

    def health_view(self) -> dict:
        """The ``health`` reply: the SLO state, the scheduler's gauges and
        histograms, each worker incarnation's latest gauges, and the
        device section."""
        if self._metrics is None:
            return {"enabled": False}
        with self._hm_lock:
            workers = {
                k: {"samples": len(t["samples"]),
                    "dropped": t["dropped"] + t.get("trunc", 0),
                    "gauges": dict(t["samples"][-1].get("gauges") or {})
                    if t["samples"] else {}}
                for k, t in sorted(self._hm_tracks.items())}
        out = {"enabled": True,
               "interval_s": obs_metrics.interval_s(),
               "slo": self._slo.state(),
               "gauges": self._metrics.gauges_export(),
               "hists": self._metrics.hists_export(),
               "workers": workers}
        dev = self._dev_view()
        if dev["workers"]:
            out["device"] = dev
        return out

    def metrics_text(self) -> str:
        """The Prometheus exposition: the scheduler's registry and
        counters under ``role="scheduler"``, each worker incarnation's
        gauges, histograms and counters under ``worker``/``inc``; empty
        when the plane is off."""
        if self._metrics is None:
            return ""
        self._health_refresh()
        jobs = [({"role": "scheduler"},
                 {"gauges": self._metrics.gauges_export(),
                  "hists": self._metrics.hists_export()},
                 {**obs_trace.tracer().counters(),
                  **self._obs.counters()})]
        with self._obs_lock:
            ctrs = {k: dict(v["counters"])
                    for k, v in self._obs_tracks.items()}
        with self._hm_lock:
            tracks = [(k, [list(g) for g in t["gauges"]],
                       [list(h) for h in t["hists"]])
                      for k, t in sorted(self._hm_tracks.items())]
        for key, gauges, hists in tracks:
            host, _, inc = key.partition("#")
            jobs.append(({"worker": host, "inc": inc},
                         {"gauges": gauges, "hists": hists},
                         ctrs.get(key, {})))
        return obs_metrics.render_prometheus(jobs)

    # ------------------------------------------------------------------
    # the fleet-hang detector (scheduler.py:498-636)
    # ------------------------------------------------------------------

    def _start_hang_thread(self) -> None:
        if not obs_blackbox.enabled() or self._bb_thread is not None:
            return
        self._bb_thread = threading.Thread(target=self._hang_loop,
                                           daemon=True, name="dt-sched-hang")
        self._bb_thread.start()

    def _hang_loop(self) -> None:
        period = max(min(obs_blackbox.hang_s() / 4.0, 5.0), 0.05)
        while not self._stop.wait(period):
            if not self._active.is_set():
                continue
            try:
                self._hang_tick()
            except Exception:  # noqa: BLE001 — the detector must not die
                logger.exception("fleet-hang detector pass failed")

    def _hang_tick(self, hang_seconds: Optional[float] = None
                   ) -> Optional[dict]:
        """One fleet-progress check: when the oldest pending round has
        aged past ``DT_HANG_S``, blame the worker it waits on (the worst
        straggler among the missing contributors; one whose device view
        says it is compiling is demoted, while that view is fresh and the
        compile younger than max(10x the threshold, 5 min)) and fire an
        edge-triggered ``hang.suspect`` with one live bundle; the round's
        completion clears it.  Returns the suspect view."""
        threshold = float(hang_seconds if hang_seconds is not None
                          else obs_blackbox.hang_s())
        stalled = [p for p in self._dp.pending_rounds()
                   if p["age_s"] is not None and p["age_s"] > threshold
                   and p["waiting"]]
        fired = None
        cleared = False
        with self._bb_lock:
            was = self._bb_suspect
            if stalled:
                oldest = max(stalled, key=lambda p: p["age_s"])
                scores = self._dp.straggler_scores()
                demote_max = max(10.0 * threshold, 300.0)
                now = time.time()
                with self._dev_lock:
                    compiling = {
                        h for h, v in self._dev_tracks.items()
                        if v.get("compiling")
                        and now - v.get("_ts", 0.0) <= 2.0 * threshold
                        and float(v.get("compiling_age_s", 0.0))
                        <= demote_max}
                    labeled = {h for h, v in self._dev_tracks.items()
                               if v.get("compiling")}
                blamed = max(oldest["waiting"],
                             key=lambda h: (h not in compiling,
                                            scores.get(h, 0.0)))
                cur = {"round": oldest["key"], "age_s": oldest["age_s"],
                       "waiting": oldest["waiting"],
                       "contributed": oldest["contributed"],
                       "blamed": blamed,
                       "straggler_ms": round(scores.get(blamed, 0.0), 3)}
                if blamed in labeled:
                    cur["compile_in_progress"] = True
                if labeled & set(oldest["waiting"]):
                    cur["compiling"] = sorted(
                        labeled & set(oldest["waiting"]))
                if was is None:
                    self._bb_suspect = cur
                    fired = cur
                else:
                    was.update(cur)  # refresh, no re-fire
                    for k in ("compile_in_progress", "compiling"):
                        if k not in cur:
                            was.pop(k, None)
            elif was is not None:
                self._bb_suspect = None
                cleared = True
        if fired is not None:
            self._obs.event("hang.suspect", dict(fired))
            obs_blackbox.note("hang.suspect", role="scheduler", **fired)
            obs_blackbox.write_bundle("hang", host="scheduler", fatal=False,
                                      extra=dict(fired), tracer=self._obs)
        if cleared:
            self._obs.event("hang.clear", {"role": "scheduler"})
            obs_blackbox.note("hang.clear", role="scheduler")
        with self._bb_lock:
            return dict(self._bb_suspect) if self._bb_suspect else None

    def _bb_state(self) -> dict:
        """The control state in every bundle this process writes; bounded
        lock waits (a signal-handler bundle must not deadlock)."""
        out = {"role": "scheduler", "incarnation": self._incarnation,
               "active": self._active.is_set(), "port": self.port}
        if self._lock.acquire(timeout=0.5):
            try:
                out["workers"] = list(self._state.workers)
                out["last_completed_epoch"] = \
                    self._state.last_completed_epoch
                out["pending_recovery"] = \
                    sorted(self._state.pending_recovery)
            finally:
                self._lock.release()
        if self._slo is not None:
            try:
                slo = self._slo.state()
                out["slo_active"] = slo["active"]
                out["slo_history"] = slo["history"][-8:]
            except Exception:  # noqa: BLE001 — best-effort forensics
                pass
        with self._bb_lock:
            if self._bb_suspect:
                out["hang_suspect"] = dict(self._bb_suspect)
        return out

    def _ha_round(self, msg: dict) -> dict:
        """Install a completed round the live primary replicated; a
        replica stamped with an incarnation below ours comes from a
        deposed leader and is refused."""
        fence = int(msg.get("fence", 0))
        if fence < self._incarnation:
            return {"error": f"fenced: round replica carries stale "
                             f"incarnation {fence} < {self._incarnation}"}
        self._dp.install_round(msg["key"], int(msg["gen"]),
                               dict(msg["seqs"]), msg["value"])
        self._obs.counter("ha.rounds_replicated")
        return {}

    # ------------------------------------------------------------------
    # registration / heartbeat
    # ------------------------------------------------------------------

    def _register(self, host: str, is_new: bool,
                  is_recovery: bool = False, reattach: bool = False) -> dict:
        """A base or new worker takes the next rank; a crashed one
        (``is_recovery``) queues for re-admission.  ``reattach`` is a
        client's endpoint rotation, a live process refreshing its fence:
        its retry-dedup state stays (a purge would let a retried push
        apply twice)."""
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
                self._dp.hosts_removed({host})
                self._metrics_forget({host})
                self._dev_forget({host})
                self._rewrite_host_file([host])
                self._complete_pending_locked()
            if host in st.removed_hosts:
                # identity reissue (van.cc:187-218): re-admitted as
                # itself at the next membership barrier, never mid-epoch
                self._apply("recovery_pending", host=host)
                self._heartbeats[host] = time.time()
                self._dp.host_registered(host)
                for key in [k for k in self._profile_posted
                            if k[0] == host]:
                    del self._profile_posted[key]
                self._cv.notify_all()
                self._obs.event("recovery.registered", {"host": host})
                logger.info("recovery registration from %s: pending "
                            "re-admission at the next barrier", host)
                return {"rank": -1, "workers": list(st.workers),
                        "recovery_pending": True,
                        "resume_epoch": st.last_completed_epoch + 1,
                        "profile_seq": self._profile_seq,
                        "fence": self._incarnation,
                        "servers": self._server_list()}
            self._apply("worker_add", host=host, base=not is_new)
            self._heartbeats[host] = time.time()
            if not reattach:
                # a (re)registering worker starts fresh profiler-post and
                # push sequences; a failover reattach continues its own
                for key in [k for k in self._profile_posted
                            if k[0] == host]:
                    del self._profile_posted[key]
                self._dp.host_registered(host)
            self._cv.notify_all()
            out = {"rank": st.workers.index(host),
                   "workers": list(st.workers),
                   "profile_seq": self._profile_seq,
                   "fence": self._incarnation,
                   "servers": self._server_list()}
            # a resume boot short of its checkpointed epoch hands every
            # registrant the committed manifest (any member's blob
            # restores any worker: the N+-1 resume)
            com = st.ckpt_committed
            if self._resume_boot and com is not None and \
                    st.last_completed_epoch < int(com["epoch"]):
                out["resume"] = {
                    "step": int(com["step"]), "epoch": int(com["epoch"]),
                    "workers": list(com["workers"]),
                    "files": {h: dict(a) for h, a in com["files"].items()}}
            return out

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
            if not self._active.is_set():
                continue  # a fenced ex-leader: membership is not ours
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
                try:
                    for h in dead:
                        logger.warning(
                            "evicting dead worker %s (silent %.1fs)", h,
                            now - self._heartbeats.get(h, 0.0))
                        self._apply("evict", host=h, seq=st.log_seq + 1)
                        self._audit_locked("REMOVED", h)
                    self._dp.hosts_removed(set(dead))
                    self._metrics_forget(set(dead))
                    self._dev_forget(set(dead))
                    self._rewrite_host_file(dead)
                    self._complete_pending_locked()
                except journal.Fenced:
                    # deposed mid-pass: stop leading, or this thread
                    # would die with the instance still serving
                    self._active.clear()
                    continue
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
        # a window pinned to a worker set that lost a member can never
        # gather its acks: abort it (the last commit stays the resume
        # point; the next cadence step pins the survivors)
        if st.ckpt_pending is not None and \
                not set(st.ckpt_pending["workers"]) <= live:
            step = st.ckpt_pending["step"]
            self._apply("ckpt_abort", step=step)
            self._ckpt_times.pop(step, None)
            self._obs.event("ckpt.abort",
                            {"step": step, "reason": "member_lost"})
        self._dp.complete_with(live, ordered=st.workers)

    # ------------------------------------------------------------------
    # the fleet checkpoint (scheduler.py:1883-1975)
    # ------------------------------------------------------------------

    def _ckpt_intent(self, host: str, step: int, epoch: int) -> dict:
        """The first worker at a checkpoint step opens the two-phase
        window, the others join it; the journaled intent pins the worker
        set whose acks commit."""
        faults.crash_point("sched.ckpt_intent", host=host)
        with self._cv:
            st = self._state
            com = st.ckpt_committed
            if com is not None and step <= int(com["step"]):
                return {"ok": False, "reason": "already_committed"}
            p = st.ckpt_pending
            if p is not None and int(p["step"]) == step:
                return {"ok": True, "seq": p["seq"]}
            if p is not None and step < int(p["step"]):
                return {"ok": False, "reason": "superseded"}
            if p is not None:
                # a newer intent supersedes a stuck window
                old = int(p["step"])
                self._apply("ckpt_abort", step=old)
                self._ckpt_times.pop(old, None)
                self._obs.event("ckpt.abort",
                                {"step": old, "reason": "superseded"})
            self._apply("ckpt_intent", step=step, epoch=epoch,
                        seq=st.ckpt_seq + 1, workers=sorted(st.workers))
            self._ckpt_times[step] = {"t0": time.monotonic(), "acks": {}}
            self._obs.event("ckpt.intent",
                            {"step": step, "epoch": epoch,
                             "workers": sorted(st.workers)})
            return {"ok": True, "seq": st.ckpt_seq}

    def _ckpt_ack(self, host: str, step: int, path: str, sha256: str,
                  cursor: dict) -> dict:
        """One worker's durable save; the last pinned ack commits the
        manifest in the same journaled stream, so a window torn before
        the commit leaves the previous commit the resume point."""
        faults.crash_point("sched.ckpt_ack", host=host)
        with self._cv:
            st = self._state
            p = st.ckpt_pending
            if p is None or int(p["step"]) != step:
                com = st.ckpt_committed
                if com is not None and int(com["step"]) >= step:
                    return {"committed": True}  # a retry after the commit
                return {"committed": False, "stale": True}
            if host not in p["acks"]:
                self._apply("ckpt_ack", step=step, host=host, path=path,
                            sha256=sha256, cursor=cursor)
                times = self._ckpt_times.get(step)
                if times is not None:
                    times["acks"][host] = time.monotonic()
                self._obs.event("ckpt.ack", {"host": host, "step": step})
            committed = False
            if set(p["workers"]) <= set(p["acks"]):
                # every ack journaled, the commit not yet: a crash here
                # must resume from the previous commit
                faults.crash_point("sched.ckpt_commit", host=host)
                manifest = {"step": int(p["step"]),
                            "epoch": int(p["epoch"]),
                            "seq": int(p["seq"]),
                            "workers": list(p["workers"]),
                            "files": {h: dict(a) for h, a in
                                      sorted(p["acks"].items())}}
                self._apply("ckpt_commit", step=step, manifest=manifest)
                committed = True
                times = self._ckpt_times.pop(step, None)
                attrs = {"step": step, "epoch": manifest["epoch"],
                         "workers": manifest["workers"]}
                if times is not None:
                    ats = sorted(times["acks"].values())
                    attrs["dur_ms"] = round(
                        (time.monotonic() - times["t0"]) * 1e3, 3)
                    attrs["spread_ms"] = round(
                        (ats[-1] - ats[0]) * 1e3, 3) if len(ats) > 1 \
                        else 0.0
                self._obs.event("ckpt.commit", attrs)
                if self._metrics is not None:
                    self._metrics.gauge("ckpt.committed_step", float(step))
                self._cv.notify_all()
            return {"committed": committed}

    def _ckpt_manifest(self) -> dict:
        """The read-only view of the committed and pending windows."""
        with self._lock:
            st = self._state
            pend = None
            if st.ckpt_pending is not None:
                p = st.ckpt_pending
                pend = {"step": p["step"], "epoch": p["epoch"],
                        "workers": list(p["workers"]),
                        "acks": sorted(p["acks"])}
            com = None
            if st.ckpt_committed is not None:
                c = st.ckpt_committed
                com = {"step": c["step"], "epoch": c["epoch"],
                       "workers": list(c["workers"]),
                       "files": {h: dict(a)
                                 for h, a in c["files"].items()}}
            return {"committed": com, "pending": pend,
                    "resume": bool(self._resume_boot)}

    def request_fleet_checkpoint(self) -> None:
        """The scheduler drain (SIGTERM on ``scheduler_main``): every
        heartbeat reply carries ``ckpt_epoch_end`` from now on, so the
        fleet checkpoints at its next epoch boundary, where every worker's
        step agrees."""
        self._ckpt_epoch_end = True
        self._obs.event("drain.requested", {"host": "scheduler"})

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
            self._dp.hosts_removed({host})
            self._metrics_forget({host})
            self._dev_forget({host})
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
        count.  Base workers are never removed by the diff.  With the
        policy engine, its decision comes first (evictions leave the file,
        so this diff removes them) and its shares, over the final workers,
        ride the result.  Caller holds the lock."""
        t0 = self._obs.now()
        st = self._state
        if self._pre_change_hook is not None:
            try:
                self._pre_change_hook(epoch)
            except Exception:
                logger.exception("pre_change_hook failed")
        decision = None
        if self._policy is not None:
            # phase 1, before the diff: chronic stragglers leave host_worker
            # here and the diff below removes them, as the reference's EC2
            # daemon did (launch.py:218-224).  A leader killed between this
            # rewrite and the journaled decision leaves the rewritten file,
            # so its successor removes them too.
            decision = self._policy.decide(
                epoch, list(st.workers), set(st.base),
                dict(st.policy_streaks), self._dp.straggler_scores())
            # evictions and scale-down proposals act through the file;
            # scale-up stays advisory (the engine invents no host)
            drop = list(decision.evict) + [
                p["host"] for p in decision.proposals
                if p.get("kind") == "scale_down" and "host" in p]
            if drop and not (self.host_worker_file and
                             os.path.exists(self.host_worker_file)):
                # no file, no removal through the diff: the evictions
                # become advisory proposals (deduplicated in
                # _policy_apply_locked, so not journaled every epoch)
                decision = dataclasses.replace(
                    decision, evict=[],
                    proposals=list(decision.proposals) + [
                        {"kind": "evict", "host": h} for h in drop])
                drop = []
            if drop:
                self._rewrite_host_file(drop)
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
            self._dp.hosts_removed(removable)
            self._metrics_forget(removable)
            self._dev_forget(removable)
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
        result = {"workers": list(st.workers), "removed": removed,
                  "added": added, "recovered": recovered, "epoch": epoch}
        if decision is not None:
            # phase 2, after the diff: shares over the final workers, in
            # the result barrier_complete journals, so every arrival and a
            # successor serve the same payload
            result["policy"] = self._policy_apply_locked(epoch, decision)
        return result

    def _policy_apply_locked(self, epoch: int, decision) -> dict:
        """Share units over the post-diff rank-ordered workers, journaled
        as one idempotent ``policy_decide`` op when anything changed.
        Returns the barrier reply's ``policy`` payload.  Caller holds the
        lock."""
        st = self._state
        live = set(st.workers)
        streaks = {h: s for h, s in decision.streaks.items() if h in live}
        shares = self._policy.shares(list(st.workers), streaks)
        last_props = st.policy_log[-1].get("proposals", []) \
            if st.policy_log else []
        if (shares != st.policy_shares or streaks != st.policy_streaks
                or decision.evict
                or list(decision.proposals) != list(last_props)):
            self._apply("policy_decide", epoch=epoch,
                        seq=st.policy_seq + 1,
                        breached=list(decision.breached),
                        streaks=streaks, shares=shares,
                        lr_scale=decision.lr_scale,
                        evicted=list(decision.evict),
                        proposals=list(decision.proposals))
            self._obs.counter("policy.decisions")
            self._obs.event("policy.rebalance",
                            {"epoch": epoch, "seq": st.policy_seq,
                             "breached": list(decision.breached),
                             "shares": dict(shares)})
            for h in decision.evict:
                self._obs.event("policy.evict", {"epoch": epoch, "host": h})
            # only new proposals become events; a demoted eviction is an
            # eviction (advisory), not a scale proposal
            for p in decision.proposals:
                if p in last_props:
                    continue
                if p.get("kind") == "evict":
                    self._obs.event("policy.evict",
                                    {"epoch": epoch, "host": p.get("host"),
                                     "advisory": True})
                else:
                    self._obs.event("policy.scale", {"epoch": epoch, **p})
            logger.info(
                "Epoch[%d] policy decision %d: breached=%s shares=%s "
                "evicted=%s proposals=%s", epoch, st.policy_seq,
                decision.breached, shares, decision.evict,
                decision.proposals)
        return {"shares": dict(st.policy_shares),
                "lr_scale": st.policy_lr_scale, "seq": st.policy_seq}

    def _policy_view_locked(self) -> dict:
        """The policy section of ``status`` and ``obs_dump``.  Caller
        holds the lock."""
        st = self._state
        return {"enabled": self._policy is not None,
                "shares": dict(st.policy_shares),
                "streaks": dict(st.policy_streaks),
                "lr_scale": st.policy_lr_scale,
                "seq": st.policy_seq,
                "log": list(st.policy_log[-32:])}

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

    # ------------------------------------------------------------------
    # the range-server registry
    # ------------------------------------------------------------------

    def _server_list(self) -> list:
        """``[[host, port], ...]`` by server index: the worker's key-range
        to server table (``kvstore_dist.h:547-589``)."""
        with self._servers_lock:
            return [list(self._servers[i]) for i in sorted(self._servers)]

    @property
    def _async_store(self):
        """The embedded plane's ``dist_async`` master weights."""
        return self._dp._async_store


def _read_hosts(path: str) -> List[str]:
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip() and
                not ln.strip().startswith("#")]
