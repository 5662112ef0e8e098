"""The worker's side of the elastic control plane (counterpart of
``WorkerClient``, ``dt_tpu/elastic/client.py:80``, copied since the port
imports nothing of the JAX package).

A kvstore takes it through ``kv.set_controller(...)``.  It registers the
worker, heartbeats from a thread, and carries the membership-change
barrier (:meth:`WorkerClient.membership_change_barrier`, the re-admission
of a crashed worker :meth:`~WorkerClient.wait_rejoin`), the plain
barrier, the joiners' snapshot, the dead-node count, the graceful drain,
the exact-average dense allreduce, chunked and windowed
(``client.py:834-1035``), with its bucketed pipeline
(:class:`AllreducePipeline`) for the overlapped step, the row-sparse
allreduce (:meth:`WorkerClient.allreduce_sparse`) and the ``dist_async``
calls (``set_optimizer``, ``async_init``, ``async_push``,
``async_push_sparse``, ``async_stats``, ``async_pull_rows``).

With a range-server fleet (the scheduler's ``servers``, at register or
:meth:`WorkerClient.refresh_servers`) the bulk data goes to the servers,
as the JAX client sends it: dense and 2-bit chunks round-robin from
``crc32(key)``, every sizable tensor split across all R servers, and
the async and sparse calls split into the row ranges of
:func:`_row_bounds` (``np.array_split``'s), so a mixed fleet's workers
address the same rows on the same server.

With scheduler HA the client holds the ordered endpoints of
``DT_CTRL_ENDPOINTS`` (leader first, standbys after; ``client.py:85-99``)
and every request to a scheduler endpoint, the data-plane rounds of the
funnel included, fails over (:meth:`WorkerClient._req_failover`): the
idempotency token is pinned before the first attempt, a dead connection
or a ``not_leader``/``fenced`` answer rotates to the next endpoint, where
the client re-registers under the new fence and replays the same message.
A round in flight on a side thread of the overlap engine takes the same
route and resends the same bytes (its 2-bit words were packed, and the
residual updated, once); the standby was sent the primary's completed
rounds (``ha_round``), so a retry it serves gets the identical average.
It also carries the fleet checkpoint (``ckpt_begin``, ``ckpt_ack``,
``ckpt_manifest``), the committed manifest of a resume boot
(:attr:`WorkerClient.resume`) and a draining scheduler's
``ckpt_epoch_end``.

The heartbeat carries the obs export (``client.py:440-610``): the
process tracer's span batch (``obs``), the metrics plane's time-series
batch with the gauge and histogram snapshots (``hm``) and the device
plane's view (``dev``), each pending until the scheduler answers, with
``rseq``/sample-``seq`` dedup and ``fseq``/``gseq``/``dseq`` ordering so a
replayed or stale heartbeat changes nothing; :meth:`WorkerClient.
obs_flush` pushes the tail synchronously (``obs_push``) on close and from
an injected crash.  Its replies deliver the broadcast profiler commands
(:meth:`WorkerClient.profile_command`, ``utils/profiler.py``) and the
targeted ``profile_capture`` commands (``obs/device.py``).  With
``DT_BLACKBOX`` the client arms the process's crash hooks and stamps every
bundle with its membership view.

Everything it sends is numpy or plain Python (the JAX package's processes
unpickle it).  The heartbeat and comm threads launch nothing on the card:
only the training thread does (the device view reads the allocator's
counters).
"""

from __future__ import annotations

import collections
import logging
import os
import queue
import socket
import threading
import time
import uuid
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dt_tpu_torch import config
from dt_tpu_torch.elastic import faults, protocol
from dt_tpu_torch.obs import blackbox as obs_blackbox
from dt_tpu_torch.obs import device as obs_device
from dt_tpu_torch.obs import metrics as obs_metrics
from dt_tpu_torch.obs import trace as obs_trace

logger = logging.getLogger("dt_tpu_torch.elastic")

#: span records a client keeps pending at most (past it the oldest are shed
#: and counted), and records a heartbeat carries (the JAX client's bounds)
_OBS_PENDING_MAX = 8192
_OBS_FLUSH_MAX = 2048
#: the same for metrics samples
_HM_PENDING_MAX = 1024
_HM_FLUSH_MAX = 256


def _parse_endpoints(spec: str) -> List[Tuple[str, int]]:
    """``host:port[,host:port]`` -> the ordered address list (the
    ``DT_CTRL_ENDPOINTS`` contract: the leader first, standbys after)."""
    out: List[Tuple[str, int]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        host, _, port = part.rpartition(":")
        out.append((host or "127.0.0.1", int(port)))
    return out


#: the public name, as the JAX package exports it
parse_endpoints = _parse_endpoints


def _row_bounds(n: int, r: int) -> List[int]:
    """The split points of ``np.array_split(arr, r, axis=0)`` for ``n``
    rows: the contiguous key-range to server partition
    (``kvstore_dist.h:547-589``).  It must split as the JAX client does
    (``client.py:63``), or a mixed fleet sums misaligned rows."""
    q, rem = divmod(n, r)
    bounds = [0]
    for i in range(r):
        bounds.append(bounds[-1] + q + (1 if i < rem else 0))
    return bounds


class WorkerRemoved(Exception):
    """Raised at the barrier when the scheduler removed this host; the fit
    loop returns cleanly (the reference terminated the instance,
    ``launch.py:196-199``)."""


class WorkerClient:
    def __init__(self, scheduler_host: str, scheduler_port: int,
                 host: Optional[str] = None, is_new: Optional[bool] = None,
                 heartbeat_interval_s: float = 1.0,
                 is_recovery: Optional[bool] = None,
                 endpoints: Optional[Sequence[Tuple[str, int]]] = None):
        eps = endpoints
        if eps is None:
            spec = config.env("DT_CTRL_ENDPOINTS")
            if spec:
                eps = _parse_endpoints(spec)
        self.addrs: List[Tuple[str, int]] = \
            [(a[0], int(a[1])) for a in eps] if eps \
            else [(scheduler_host, int(scheduler_port))]
        self._leader = 0  # index into addrs; guarded-by: _addr_lock
        self._addr_lock = threading.Lock()
        # the leader incarnation we registered under; a failover reattach
        # rewrites it on whichever thread saw the rotation
        self.fence = 0  # guarded-by: _addr_lock
        self.host = host or f"{socket.gethostname()}:{os.getpid()}"
        if is_new is None:
            is_new = os.environ.get("NEW_WORKER", "") in ("1", "true")
        if is_recovery is None:
            # a restarted worker re-entering under its old name
            # (van.cc:187-218 is_recovery)
            is_recovery = config.env("DT_RECOVERY") in ("1", "true")
        # the track's identity and the export's eligibility, fixed before
        # the first request (its span links to this track): the process
        # tracer is shared, so a client built with tracing off never
        # drains it later
        self._obs_inc = os.getpid()
        self._obs_export = obs_trace.enabled()
        if self._obs_export:
            obs_trace.set_origin(f"{self.host}#{self._obs_inc}")
        faults.crash_point("client.register", host=self.host)
        resp = self._req({"cmd": "register", "host": self.host,
                          "is_new": is_new, "is_recovery": is_recovery})
        self.fence = int(resp.get("fence", 0))
        # rank/workers change at barriers (caller thread); the lock keeps
        # a reader on another thread from seeing half an update
        self._lock = threading.Lock()
        self.rank: int = resp["rank"]  # guarded-by: _lock
        self.workers: List[str] = resp["workers"]
        # a recovering worker: rank -1 until a barrier re-admits it
        self.recovery_pending: bool = bool(resp.get("recovery_pending"))
        self.resume_epoch: int = int(resp.get("resume_epoch", 0))
        # the committed fleet checkpoint a resume boot serves until the
        # fleet passes its epoch; fit restores from it (DT_RESUME)
        self.resume: Optional[dict] = resp.get("resume")
        # a draining scheduler's request for an epoch-boundary
        # checkpoint (the heartbeat thread sets it; a write-once bool)
        self.ckpt_epoch_end: bool = False
        # the policy engine's applied decision (share units, LR scale,
        # seq), adopted from barrier replies; the elastic data iterator
        # and the fit loop read it after the barrier
        self.policy_shares: Dict[str, int] = {}  # guarded-by: _lock
        self.policy_lr_scale: float = 1.0  # guarded-by: _lock
        self.policy_seq: int = 0  # guarded-by: _lock
        # the range-server fleet: with servers, bulk data goes to them
        # instead of the scheduler's embedded plane
        self.servers: List[Tuple[str, int]] = [
            tuple(s) for s in resp.get("servers", [])]
        self._key_rows: Dict[str, int] = {}  # key -> rows of a sharded table
        self._ar_seq: Dict[object, int] = {}
        self._seq_lock = threading.Lock()
        self._pool = None  # lazy executor for chunk windows and fan-outs
        self._pipe_pool = None  # lazy executor for bucket rounds
        self._announce_to_servers()
        # the profiler commands: a joiner starts at the scheduler's current
        # seq (no replay of a finished session)
        self._prof_lock = threading.Lock()
        self._prof_seq = int(resp.get("profile_seq", 0))  # guarded-by: _prof_lock
        self._prof_post = 0  # the retry-dedup key of profile_command
        # the span export: the tracer drains into a pending batch that
        # rides the heartbeat, cleared only by the scheduler's answer
        self._obs_lock = threading.Lock()
        self._obs_pending: list = []  # guarded-by: _obs_lock
        self._obs_shed = 0  # guarded-by: _obs_lock
        self._obs_fseq = 0  # guarded-by: _obs_lock
        self._obs_hook = None
        if self._obs_export:
            # an injected os._exit flushes through this hook; weak, so an
            # abandoned client stays collectable
            import weakref
            _wm = weakref.WeakMethod(self.obs_flush)

            def _flush_hook(_wm=_wm):
                fn = _wm()
                if fn is None:
                    obs_trace.unregister_flush(_flush_hook)
                    return
                fn()
            self._obs_hook = _flush_hook
            obs_trace.register_flush(self._obs_hook)
        # the metrics export, the same contract; the sampler takes the
        # gauges every DT_METRICS_INTERVAL_S, the device plane's hook
        # setting the device.* gauges first
        self._hm_export = obs_metrics.enabled()
        self._hm_lock = threading.Lock()
        self._hm_pending: list = []  # guarded-by: _hm_lock
        self._hm_shed = 0  # guarded-by: _hm_lock
        self._hm_gseq = 0  # guarded-by: _hm_lock
        self._dev_export = obs_device.enabled()
        self._hm_sampler = obs_metrics.Sampler(
            obs_metrics.registry(), hook=obs_device.metrics_hook()) \
            if self._hm_export else None
        # the flight recorder: the process's crash hooks, and this
        # client's view in every bundle (weakly held)
        self._bb_state_name = None
        if obs_blackbox.enabled():
            obs_blackbox.install(host=self.host)
            import weakref
            _wm_state = weakref.WeakMethod(self._bb_state)
            self._bb_state_name = f"client:{self.host}"

            def _bb_provider(_wm=_wm_state):
                fn = _wm()
                return fn() if fn is not None else {"gone": True}
            self._bb_provider = _bb_provider
            obs_blackbox.register_state(self._bb_state_name, _bb_provider)
        self._stop = threading.Event()
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop, args=(heartbeat_interval_s,),
            daemon=True, name=f"dt-heartbeat-{self.host}")
        self._hb_thread.start()

    @property
    def num_workers(self) -> int:
        return len(self.workers)

    @property
    def addr(self) -> Tuple[str, int]:
        """The endpoint this client takes for the leader."""
        with self._addr_lock:
            return self.addrs[self._leader]

    def _req_addr(self, addr, msg: dict, timeout: float = 600.0,
                  retries: int = 8) -> dict:
        """Request to ``addr`` (the scheduler or a range server) with
        at-least-once retry (the ``resender.h`` role): every re-send
        carries the same idempotency token.  ``retries`` is the total
        number of attempts.  With more than one scheduler endpoint, a
        request to one of them fails over (:meth:`_req_failover`, bounded
        by its wall budget instead); a range server's never rotates."""
        if len(self.addrs) > 1 and tuple(addr) in set(self.addrs):
            return self._req_failover(msg, timeout)
        resp = protocol.request(addr[0], addr[1], msg, timeout=timeout,
                                retries=max(retries - 1, 0))
        if "error" in resp:
            raise RuntimeError(f"scheduler error: {resp['error']}")
        return resp

    def _req(self, msg: dict, timeout: float = 600.0,
             retries: int = 8) -> dict:
        if len(self.addrs) == 1:
            return self._req_addr(self.addr, msg, timeout, retries)
        return self._req_failover(msg, timeout)

    # -- scheduler failover (client.py:300-402) ----------------------------

    def _req_failover(self, msg: dict, timeout: float) -> dict:
        """One control request over the ordered endpoints.  The token is
        pinned before the first attempt, so a replay that crosses
        endpoints dedups like a same-endpoint retry; ``not_leader`` and
        ``fenced`` answers rotate like a dead connection.
        ``DT_CTRL_FAILOVER_S`` bounds the rotations, not one attempt (a
        barrier may park for minutes on a healthy leader), and every
        endpoint is tried at least once.  No count of attempts bounds
        them: a standby takes over only once the dead leader's lease
        lapsed, which a fixed count of backed-off attempts can end before
        (16 attempts sleep 15 times, each draw in [0.1, 1] s).  The
        backoff is jittered (:func:`protocol.next_backoff`), so a
        failing-over fleet does not reach the standby in lockstep."""
        msg = dict(msg)
        msg.setdefault("token", uuid.uuid4().hex)
        with self._addr_lock:
            msg.setdefault("fence", self.fence)
        deadline = time.monotonic() + \
            float(config.env("DT_CTRL_FAILOVER_S"))
        delay = 0.1
        tried: set = set()
        last_exc: Optional[Exception] = None
        while True:
            addr = self.addr
            tried.add(tuple(addr))
            try:
                resp = protocol.request(addr[0], addr[1], msg,
                                        timeout=timeout, retries=1)
            except (ConnectionError, socket.timeout, OSError) as e:
                last_exc = e
                resp = None
            if resp is not None:
                err = resp.get("error")
                if err is None:
                    return resp
                if not (str(err).startswith("not_leader")
                        or str(err).startswith("fenced")):
                    raise RuntimeError(f"scheduler error: {err}")
                last_exc = ConnectionError(
                    f"scheduler at {addr} refused: {err}")
            if len(tried) >= len(self.addrs) and \
                    time.monotonic() + delay > deadline:
                break
            time.sleep(delay)
            delay = protocol.next_backoff(delay, 0.1, 1.0)
            self._rotate_leader(addr, msg.get("cmd"))
        raise last_exc if last_exc is not None else \
            ConnectionError("control plane unreachable")

    def _rotate_leader(self, failed_addr: Tuple[str, int],
                       cmd: Optional[str]) -> None:
        """Advance to the next endpoint (the first thread to see the
        failure rotates; later ones find it done) and re-establish
        identity there."""
        with self._addr_lock:
            rotated = self.addrs[self._leader] == tuple(failed_addr)
            if rotated:
                self._leader = (self._leader + 1) % len(self.addrs)
            target = self.addrs[self._leader]
        if rotated and obs_trace.enabled():
            tr = obs_trace.tracer()
            tr.counter("client.failover")
            tr.event("client.failover", {"to": f"{target[0]}:{target[1]}",
                                         "cmd": cmd})
        if rotated and cmd != "register":
            self._reattach(target)

    def _reattach(self, addr: Tuple[str, int]) -> None:
        """Re-register at the (possibly new) leader for its fence.  The
        successor replayed the membership, so rank and the live set stay;
        best-effort (a passive standby refuses it, and that refusal is
        what triggers its on-demand takeover)."""
        try:
            resp = protocol.request(
                addr[0], addr[1],
                {"cmd": "register", "host": self.host, "is_new": False,
                 "is_recovery": False, "reattach": True,
                 "token": uuid.uuid4().hex},
                timeout=10.0, retries=1)
        except (ConnectionError, socket.timeout, OSError):
            return
        if "error" in resp:
            return
        fence = int(resp.get("fence", 0))
        with self._addr_lock:
            changed = fence != self.fence
            self.fence = fence
        if changed and obs_trace.enabled():
            obs_trace.tracer().event("client.reattached", {"fence": fence})

    # -- sharded-plane routing (kvstore_dist.h:547-589) --------------------

    def refresh_servers(self) -> List[Tuple[str, int]]:
        """Fetch the range-server fleet again (for a client that
        registered before the servers did)."""
        self.servers = [tuple(s) for s in
                        self._req({"cmd": "servers"})["servers"]]
        self._announce_to_servers()
        return self.servers

    def _announce_to_servers(self) -> None:
        """Tell every range server this host (re)registered: it purges the
        host's retry-dedup entries, as the scheduler does in its
        register."""
        for addr in self.servers:
            self._req_addr(addr, {"cmd": "host_reset", "host": self.host})

    def _partition_rows(self, n: int, ids, vals=None):
        """The row-range partition the sparse calls share: drop ids outside
        the table, split ``n`` rows over the fleet by :func:`_row_bounds`,
        give each id its server.  Returns ``(ids, vals, bounds, part)``."""
        ids = np.asarray(ids).ravel()
        live = (ids >= 0) & (ids < n)
        ids = ids[live]
        if vals is not None:
            vals = np.asarray(vals)[live]
        bounds = _row_bounds(n, len(self.servers))
        part = np.searchsorted(bounds[1:], ids, side="right")
        return ids, vals, bounds, part

    def _data_addr(self, key: str, route: Optional[int] = None):
        """One round's target: server ``route`` (``crc32(key)`` unrouted)
        modulo R, or the scheduler's embedded plane with no servers; the
        same on every worker."""
        r = len(self.servers)
        if r == 0:
            return self.addr
        if route is None:
            route = zlib.crc32(key.encode())
        return self.servers[route % r]

    def _heartbeat_loop(self, interval: float):
        while not self._stop.is_set():
            try:
                faults.crash_point("client.heartbeat", host=self.host)
            except faults.CrashInjected:
                return  # an injected heartbeat death: the thread stops
            try:
                with self._prof_lock:
                    pseq = self._prof_seq
                msg = {"cmd": "heartbeat", "host": self.host, "pseq": pseq}
                payload = self._obs_payload() if self._obs_export \
                    and obs_trace.enabled() else None
                if payload is not None:
                    msg["obs"] = payload
                hm = self._hm_payload() if self._hm_export \
                    and obs_metrics.enabled() else None
                if hm is not None:
                    msg["hm"] = hm
                dev = obs_device.wire_payload() if self._dev_export \
                    and obs_device.enabled() else None
                if dev is not None:
                    msg["dev"] = dev
                if obs_trace.enabled():
                    obs_trace.tracer().counter("heartbeat.sent")
                # retries=1: a lost heartbeat is superseded by the next
                resp = self._req(msg, timeout=10, retries=1)
                if payload is not None:
                    self._obs_ack(payload)
                if hm is not None:
                    self._hm_ack(hm)
                if resp.get("ckpt_epoch_end"):
                    self.ckpt_epoch_end = True
                for c in resp.get("profile_cmds", []):
                    self._apply_profile_cmd(c)
                if dev is not None:
                    # targeted captures; seq-guarded in the device plane
                    obs_device.handle_capture_cmds(
                        resp.get("capture_cmds"), host=self.host)
            except (OSError, RuntimeError):
                pass  # scheduler gone: dead-node detection is its problem
            self._stop.wait(interval)

    # -- the obs export ---------------------------------------------------

    def _obs_payload(self) -> Optional[dict]:
        """Drain the process tracer into the pending batch and return the
        next payload (``None`` when there is nothing to ship): the oldest
        ``_OBS_FLUSH_MAX`` records, the counters and the drop count."""
        tr = obs_trace.tracer()
        with self._obs_lock:
            self._obs_pending.extend(tr.drain())
            over = len(self._obs_pending) - _OBS_PENDING_MAX
            if over > 0:
                self._obs_shed += over
                del self._obs_pending[:over]
            if not self._obs_pending:
                return None
            self._obs_fseq += 1
            return {"inc": self._obs_inc, "fseq": self._obs_fseq,
                    "records": list(self._obs_pending[:_OBS_FLUSH_MAX]),
                    "counters": tr.counters(),
                    "dropped": tr.dropped() + self._obs_shed}

    def _obs_ack(self, payload: dict) -> None:
        """The scheduler has ``payload``: drop its records (by rseq)."""
        if not payload.get("records"):
            return
        last = payload["records"][-1][1]
        with self._obs_lock:
            self._obs_pending = [r for r in self._obs_pending
                                 if r[1] > last]

    def obs_flush(self, timeout: float = 2.0) -> None:
        """Push what is pending over ``obs_push`` now (not a heartbeat, so
        heartbeat fault rules cannot eat it), in bounded bites; the first
        failure ends it.  Called from :meth:`close` and by an injected
        crash's flush hook."""
        if self._obs_export and obs_trace.enabled():
            for _ in range(1 + _OBS_PENDING_MAX // _OBS_FLUSH_MAX):
                payload = self._obs_payload()
                if payload is None:
                    break
                try:
                    self._req({"cmd": "obs_push", "host": self.host,
                               "obs": payload}, timeout=timeout,
                              retries=1)
                    self._obs_ack(payload)
                except (OSError, RuntimeError):
                    return  # observability is never fatal
        if self._hm_export and obs_metrics.enabled():
            # a last sample takes the gauges set since the sampler's tick
            obs_metrics.registry().sample()
            for _ in range(1 + _HM_PENDING_MAX // _HM_FLUSH_MAX):
                hm = self._hm_payload()
                if hm is None:
                    return
                try:
                    self._req({"cmd": "obs_push", "host": self.host,
                               "hm": hm}, timeout=timeout, retries=1)
                    self._hm_ack(hm)
                except (OSError, RuntimeError):
                    return
                if not hm.get("samples"):
                    return  # gauges only: nothing left to ack

    def _hm_payload(self) -> Optional[dict]:
        """Drain the registry's time series into the pending batch and
        return the next payload (``None`` when empty); the cumulative
        gauge and histogram snapshots ride every payload, ordered by
        ``gseq``."""
        reg = obs_metrics.registry()
        with self._hm_lock:
            self._hm_pending.extend(reg.drain_series())
            over = len(self._hm_pending) - _HM_PENDING_MAX
            if over > 0:
                self._hm_shed += over
                del self._hm_pending[:over]
            gauges = reg.gauges_export()
            hists = reg.hists_export()
            if not self._hm_pending and not gauges and not hists:
                return None
            self._hm_gseq += 1
            return {"inc": self._obs_inc, "gseq": self._hm_gseq,
                    "samples": list(self._hm_pending[:_HM_FLUSH_MAX]),
                    "gauges": gauges, "hists": hists,
                    "dropped": reg.dropped() + self._hm_shed}

    def _hm_ack(self, payload: dict) -> None:
        """The scheduler has ``payload``: drop its samples (by seq)."""
        if not payload.get("samples"):
            return
        last = payload["samples"][-1]["seq"]
        with self._hm_lock:
            self._hm_pending = [s for s in self._hm_pending
                                if s["seq"] > last]

    def _bb_state(self) -> dict:
        """This worker's view in every bundle; bounded lock waits (a
        bundle written from a signal handler must not deadlock on a lock
        the interrupted thread holds)."""
        out = {"role": "worker", "host": self.host,
               "incarnation": self._obs_inc,
               "recovery_pending": self.recovery_pending}
        if self._addr_lock.acquire(timeout=0.5):
            try:
                out["fence"] = self.fence
                out["leader"] = list(self.addrs[self._leader])
            finally:
                self._addr_lock.release()
        if self._lock.acquire(timeout=0.5):
            try:
                out["rank"] = self.rank
                out["workers"] = list(self.workers)
                out["policy_seq"] = self.policy_seq
                out["policy_shares"] = dict(self.policy_shares)
            finally:
                self._lock.release()
        return out

    def _apply_profile_cmd(self, c: dict) -> None:
        """Apply one remote profiler command here (rank-prefixed output),
        serialized with a monotonic seq guard: a stale heartbeat never
        re-applies an older command."""
        from dt_tpu_torch.utils import profiler
        with self._prof_lock:
            if c["seq"] <= self._prof_seq:
                return
            self._prof_seq = c["seq"]
            try:
                profiler.apply_remote(c["action"], c.get("params") or {},
                                      rank=self.rank)
            except Exception:  # profiler trouble must not kill heartbeats
                logger.exception("remote profiler command %r failed", c)

    def profile_command(self, action: str, params: Optional[dict] = None
                        ) -> int:
        """Broadcast a profiler command to every worker (reference
        ``kv.set_server_profiler_command``): applied here at once, on the
        others at their next heartbeat; ``post_seq`` dedups retries on
        the scheduler.  Returns the command's seq."""
        self._prof_post += 1
        if obs_trace.enabled():
            obs_trace.tracer().counter("profiler.posts")
        seq = self._req({"cmd": "profile", "action": action,
                         "params": params or {}, "host": self.host,
                         "post_seq": self._prof_post})["seq"]
        self._apply_profile_cmd({"seq": seq, "action": action,
                                 "params": params or {}})
        return seq

    # ------------------------------------------------------------------
    # the kvstore-controller surface
    # ------------------------------------------------------------------

    def membership_change_barrier(self, info: Dict) -> None:
        epoch = int(info.get("EPOCH_BEGIN", 0))
        faults.crash_point("client.mc_barrier", host=self.host, epoch=epoch)
        tr = obs_trace.tracer()
        t0 = tr.begin("mc_barrier", {"epoch": epoch})
        try:
            resp = self._req({"cmd": "mc_barrier", "host": self.host,
                              "epoch": epoch, "info": info})
        except BaseException:
            tr.abandon(t0)
            raise
        tr.complete_span("mc_barrier", t0,
                         {"epoch": epoch,
                          "removed": bool(resp.get("you_are_removed"))})
        if resp.get("you_are_removed"):
            raise WorkerRemoved(self.host)
        with self._lock:
            self.workers = resp["workers"]
            self.rank = resp["rank"]
            self._adopt_policy_locked(resp)
            if self.recovery_pending and self.rank >= 0:
                self.recovery_pending = False  # re-admitted as ourselves

    def _adopt_policy_locked(self, resp: dict) -> None:
        """Adopt a barrier reply's policy payload (share units of
        ``policy.rescale.UNITS``, LR scale, decision seq).  A seq below
        the adopted one (a cached reply replayed after a newer decision)
        is ignored.  Caller holds the lock."""
        pol = resp.get("policy")
        if not pol:
            return
        seq = int(pol.get("seq", 0))
        if seq < self.policy_seq:
            return
        self.policy_seq = seq
        self.policy_shares = {h: int(u) for h, u in
                              (pol.get("shares") or {}).items()}
        self.policy_lr_scale = float(pol.get("lr_scale", 1.0))

    def wait_rejoin(self, timeout_s: float = 600.0) -> int:
        """Recovery re-entry (``van.cc:187-218``): park at the next
        membership barrier until re-admitted as this host, then return the
        epoch whose batches start now.  The caller bootstraps from the
        snapshot, the survivors' state at that barrier."""
        deadline = time.time() + timeout_s
        tr = obs_trace.tracer()
        t0 = tr.begin("recovery.rejoin")
        try:
            while self.recovery_pending:
                if time.time() > deadline:
                    raise TimeoutError("recovery re-admission timed out")
                try:
                    resp = self._req({"cmd": "mc_barrier",
                                      "host": self.host,
                                      "epoch": self.resume_epoch,
                                      "info": {"RECOVERY": 1}})
                except RuntimeError:
                    continue  # the barrier window timed out: park again
                if resp.get("you_are_removed"):
                    raise WorkerRemoved(self.host)
                if resp.get("rank", -1) >= 0:
                    with self._lock:
                        self.workers = resp["workers"]
                        self.rank = resp["rank"]
                        self._adopt_policy_locked(resp)
                        self.recovery_pending = False
                    tr.complete_span("recovery.rejoin", t0,
                                     {"epoch": int(resp["epoch"]),
                                      "rank": int(resp["rank"])})
                    return int(resp["epoch"])
                # a removal won this barrier; recovery stays queued
        except BaseException:
            tr.abandon(t0)
            raise
        tr.abandon(t0)
        return self.resume_epoch

    def _next_seq(self, key) -> int:
        with self._seq_lock:
            seq = self._ar_seq.get(key, 0)
            self._ar_seq[key] = seq + 1
            return seq

    def barrier(self) -> None:
        self._req({"cmd": "barrier", "host": self.host,
                   "seq": self._next_seq("__barrier__")})

    def publish_snapshot(self, blob) -> None:
        self._req({"cmd": "publish_snapshot", "blob": blob})

    def fetch_snapshot(self):
        try:
            return self._req({"cmd": "fetch_snapshot"})["blob"]
        except ModuleNotFoundError as e:
            if e.name != "ml_dtypes":
                raise
            raise RuntimeError(
                "the train-state snapshot holds bfloat16 leaves as "
                "ml_dtypes arrays (a JAX worker published it), and this "
                "host has no ml_dtypes to unpickle them: a worker here "
                "cannot bootstrap from it (ROADMAP.md, Queue 3)") from e

    def num_dead_nodes(self, timeout_s: float = 60.0) -> int:
        return self._req({"cmd": "num_dead",
                          "timeout_s": timeout_s})["count"]

    # -- the fleet checkpoint (client.py:810-830) --------------------------

    def ckpt_begin(self, step: int, epoch: int) -> dict:
        """Open, or join, the two-phase window of ``step``: the first
        worker there opens it, the others get the same seq back."""
        return self._req({"cmd": "ckpt_intent", "host": self.host,
                          "step": int(step), "epoch": int(epoch)})

    def ckpt_ack(self, step: int, path: str, sha256: str,
                 cursor: Dict) -> dict:
        """This host's durable save (path, content digest, data cursor);
        the last pinned worker's ack commits the manifest."""
        return self._req({"cmd": "ckpt_ack", "host": self.host,
                          "step": int(step), "path": path,
                          "sha256": sha256, "cursor": dict(cursor)})

    def ckpt_manifest(self) -> dict:
        """The committed and pending windows, read-only."""
        return self._req({"cmd": "ckpt_manifest"})

    def drain(self) -> dict:
        """Leave the job through the eviction machinery (no recovery
        window)."""
        return self._req({"cmd": "drain", "host": self.host})

    # -- dense allreduce -------------------------------------------------

    def _ar_chunk_elems(self, value_size: int, itemsize: int,
                        route: Optional[int], nbytes: int,
                        quantum: int = 1) -> int:
        """Elements per chunked-allreduce round (``DT_AR_CHUNK_BYTES``),
        shrunk to ~size/R under a fleet of R > 1 servers for a top-level
        tensor past ``DT_AR_SHARD_MIN_BYTES`` (the reference's bigarray
        split; a routed chunk ships as it is), then rounded down to whole
        packing words (``quantum``), as the JAX client chunks."""
        per = max(1, int(config.env("DT_AR_CHUNK_BYTES"))
                  // max(itemsize, 1))
        nsrv = len(self.servers)
        if nsrv > 1 and route is None and nbytes > int(
                config.env("DT_AR_SHARD_MIN_BYTES")):
            per = min(per, -(-value_size // nsrv))
        if quantum > 1:
            per = max(quantum, (per // quantum) * quantum)
        return per

    def _ar_window(self) -> int:
        """The bounded in-flight round window (``DT_AR_WINDOW``, default
        2x fleet, min 4)."""
        return int(config.env("DT_AR_WINDOW")) or \
            max(4, 2 * max(len(self.servers), 1))

    def _fanout_pool(self):
        """Executor of chunk windows; its tasks never submit back into
        it, so sharing one cannot deadlock."""
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=max(4, 2 * max(len(self.servers), 1),
                                int(config.env("DT_AR_WINDOW"))),
                thread_name_prefix=f"dt-ar-{self.host}")
        return self._pool

    def _pipeline_pool(self):
        """Executor of bucket rounds, apart from :meth:`_fanout_pool`: a
        bucket over ``DT_AR_CHUNK_BYTES`` streams its chunks through the
        fan-out pool, and would deadlock a shared saturated window."""
        if self._pipe_pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pipe_pool = ThreadPoolExecutor(
                max_workers=max(4, self._ar_window()),
                thread_name_prefix=f"dt-ar-pipe-{self.host}")
        return self._pipe_pool

    def _stream_iter(self, tasks, pool=None, window: Optional[int] = None):
        """Run round thunks with a bounded in-flight window (task i+W is
        submitted once task i completed); yields results in submission
        order.  On an early exit the submitted rounds are waited out, as
        they may still read the caller's staging buffers."""
        window = window or self._ar_window()
        pool = pool if pool is not None else self._fanout_pool()
        inflight = collections.deque()
        try:
            for t in tasks:
                inflight.append(pool.submit(t))
                if len(inflight) >= window:
                    yield inflight.popleft().result()
            while inflight:
                yield inflight.popleft().result()
        finally:
            for f in inflight:
                try:
                    f.result()
                except Exception:
                    pass

    def _stream_chunks(self, tasks) -> List[np.ndarray]:
        return list(self._stream_iter(tasks))

    def allreduce_pipeline(self, key: str, window: Optional[int] = None
                           ) -> "AllreducePipeline":
        """A bucketed-allreduce pipeline for one step's ``key`` (the
        overlapped host-sync step; see :class:`AllreducePipeline`)."""
        return AllreducePipeline(self, key, window=window)

    def allreduce(self, key: str, value, _route: Optional[int] = None
                  ) -> np.ndarray:
        """The exact average over the live workers, as :meth:`_allreduce`,
        in one ``allreduce`` span a top-level round."""
        if _route is None and obs_trace.enabled():
            tr = obs_trace.tracer()
            t0 = tr.begin("allreduce", {"key": key})
            try:
                return self._allreduce(key, value, _route)
            finally:
                tr.counter("allreduce.rounds")
                tr.complete_span("allreduce", t0, {"key": key})
        return self._allreduce(key, value, _route)

    def _allreduce(self, key: str, value, _route: Optional[int] = None
                   ) -> np.ndarray:
        """Exact average across live workers.  ``value`` is a numpy array
        or a ``{"packed": uint32 words, "n", "threshold"}`` 2-bit dict.
        Past ``DT_AR_CHUNK_BYTES`` of represented gradient the value goes
        in rounds on subkeys ``key#c<i>`` (packed words chunk on the same
        element grid, 16 codes a word), streamed through the bounded
        window.  A per-(host, key) sequence makes a retried round
        idempotent.  With range servers chunk ``i`` goes to server
        ``(crc32(key) + i) % R``."""
        nsrv = len(self.servers)
        if isinstance(value, dict) and "packed" in value:
            from dt_tpu_torch.parallel.codec_np import (CODES_PER_WORD,
                                                        packed_chunks)
            n = int(value["n"])
            per = self._ar_chunk_elems(n, 4, _route, n * 4,
                                       quantum=CODES_PER_WORD)
            if _route is None and n > per:
                packed = np.asarray(value["packed"])
                thr = float(value["threshold"])
                base = zlib.crc32(key.encode())
                chunks = packed_chunks(packed, n, per)
                parts = self._stream_chunks([
                    (lambda i=i, words=words, cn=cn:
                     self._allreduce(f"{key}#c{i}",
                                     {"packed": words, "n": cn,
                                      "threshold": thr},
                                     (base + i) if nsrv else None))
                    for i, (words, cn) in enumerate(chunks)])
                return np.concatenate(parts)
        elif not isinstance(value, dict):
            value = np.asarray(value)
            per = self._ar_chunk_elems(value.size, max(value.itemsize, 1),
                                       _route, value.nbytes)
            if value.size > per:
                flat = value.ravel()
                base = zlib.crc32(key.encode())
                parts = self._stream_chunks([
                    (lambda i=i, start=start:
                     self._allreduce(f"{key}#c{i}",
                                     flat[start:start + per],
                                     (base + i) if nsrv else None))
                    for i, start in enumerate(range(0, flat.size, per))])
                return np.concatenate(parts).reshape(value.shape)
        out = self._req_addr(
            self._data_addr(key, _route),
            {"cmd": "allreduce", "host": self.host, "key": key,
             "seq": self._next_seq(key), "value": value})["value"]
        if isinstance(out, dict) and "__error__" in out:
            raise RuntimeError(f"allreduce {key}: {out['__error__']}")
        return out

    def allreduce_sparse(self, key: str, rs, capacity: Optional[int] = None):
        """Row-sparse exact average (``client.py:1036-1117``): ships
        ``(ids, rows)``, O(touched rows) on the wire, the reference's
        row_sparse push (``kvstore_dist.h:690-748``).  ``rs`` is an
        ``ops.sparse.RowSparse``; the result is one too, on ``rs.values``'
        device, padded with sentinel slots to ``capacity``: by default the
        next power of two above the merged row count, the same on every
        worker.  An explicit ``capacity`` must be the same on every worker;
        merged rows past it are dropped (identically everywhere).  With
        R > 1 servers each takes its row range, every worker contributing
        to every server each round (empty partitions included)."""
        import torch

        from dt_tpu_torch.ops.sparse import RowSparse
        tr = obs_trace.tracer()
        t0 = tr.begin("allreduce_sparse", {"key": key})
        try:
            ids_in, vals_in = _host(rs.indices), _host(rs.values)
            nsrv = len(self.servers)
            if nsrv > 1:
                ids, vals, _, part = self._partition_rows(
                    rs.num_rows, ids_in, vals_in)

                def one(j):
                    sel = part == j
                    return self._req_addr(
                        self.servers[j],
                        {"cmd": "allreduce", "host": self.host,
                         "key": key, "seq": self._next_seq(f"{key}@s{j}"),
                         "value": {"ids": ids[sel], "vals": vals[sel],
                                   "num_rows": rs.num_rows}})["value"]

                outs = list(self._fanout_pool().map(one, range(nsrv)))
                for o in outs:
                    if isinstance(o, dict) and "__error__" in o:
                        raise RuntimeError(
                            f"allreduce_sparse {key}: {o['__error__']}")
                # disjoint ascending ranges: the concatenation is the
                # globally sorted merge
                out = {"ids": np.concatenate([o["ids"] for o in outs]),
                       "vals": np.concatenate([o["vals"] for o in outs],
                                              axis=0)}
            else:
                out = self._req_addr(
                    self._data_addr(key),
                    {"cmd": "allreduce", "host": self.host, "key": key,
                     "seq": self._next_seq(key),
                     "value": {"ids": ids_in, "vals": vals_in,
                               "num_rows": rs.num_rows}})["value"]
            if isinstance(out, dict) and "__error__" in out:
                raise RuntimeError(
                    f"allreduce_sparse {key}: {out['__error__']}")
        except BaseException:
            tr.abandon(t0)
            raise
        merged = len(out["ids"])
        if capacity is None:
            capacity = 1 << max(merged - 1, 0).bit_length()
        n = min(merged, capacity)
        if merged > capacity:
            logger.warning("allreduce_sparse %s: %d merged rows exceed "
                           "capacity %d; excess rows dropped (identically "
                           "on every worker)", key, merged, capacity)
        out_vals = np.asarray(out["vals"])
        ids = np.full((capacity,), rs.num_rows, np.int32)
        vals = np.zeros((capacity,) + out_vals.shape[1:], out_vals.dtype)
        ids[:n] = out["ids"][:n]
        vals[:n] = out_vals[:n]
        tr.complete_span("allreduce_sparse", t0,
                         {"key": key, "merged": merged})
        dev = rs.values.device if isinstance(rs.values, torch.Tensor) \
            else torch.device("cpu")
        return RowSparse(torch.from_numpy(ids).to(dev),
                         torch.from_numpy(vals).to(dev), rs.num_rows)

    # -- the dist_async data plane ----------------------------------------

    def set_optimizer(self, spec: Dict) -> None:
        """Install the server-side updater of ``dist_async`` pushes
        (``kvstore.py:451-498``): ``spec`` is ``{"name": "sgd"|"adagrad"|
        "adam", **scalar hyperparams}``.  Sent to the scheduler's embedded
        plane and to every range server (each keeps its slice's slots)
        before any push."""
        self._req({"cmd": "set_optimizer", "spec": spec})
        for addr in self.servers:
            self._req_addr(addr, {"cmd": "set_optimizer", "spec": spec})

    def _async_fanout(self, fn):
        """``fn(j, addr)`` for every range server, concurrently; results in
        server order."""
        return list(self._fanout_pool().map(
            lambda j: fn(j, self.servers[j]), range(len(self.servers))))

    def async_init(self, key: str, value) -> np.ndarray:
        """Init-or-get the master weights: the first writer seeds them,
        everyone gets the live copy (a joiner adopts the trained state).
        With R > 1 servers the value splits into R row ranges, one a
        server (``kvstore_dist.h:547-589``)."""
        value = np.asarray(value)
        nsrv = len(self.servers)
        if nsrv > 1 and value.ndim >= 1:
            self._key_rows[key] = int(value.shape[0])
            parts = np.array_split(value, nsrv, axis=0)
            outs = self._async_fanout(
                lambda j, addr: self._req_addr(
                    addr, {"cmd": "async_init", "key": key,
                           "value": parts[j]})["value"])
            return np.concatenate([np.asarray(o) for o in outs], axis=0)
        return np.asarray(self._req_addr(
            self._data_addr(key),
            {"cmd": "async_init", "key": key, "value": value})["value"])

    def async_push(self, key: str, grad) -> np.ndarray:
        """Push a gradient, get the post-update master weights: applied at
        once, no barrier (``kvstore_dist_server.h:347``); ``(host, key,
        seq)`` dedups a retry, so a momentum update is never applied twice.
        Sharded, each server updates its rows; the server optimizers are
        elementwise, so the concatenation is the unsharded update."""
        grad = np.asarray(grad)
        nsrv = len(self.servers)
        if nsrv > 1 and grad.ndim >= 1:
            parts = np.array_split(grad, nsrv, axis=0)

            def one(j, addr):
                return self._req_addr(
                    addr, {"cmd": "async_push", "host": self.host,
                           "key": key,
                           "seq": self._next_seq(("async", key, j)),
                           "value": parts[j]})["value"]

            outs = self._async_fanout(one)
            return np.concatenate([np.asarray(o) for o in outs], axis=0)
        out = self._req_addr(
            self._data_addr(key),
            {"cmd": "async_push", "host": self.host, "key": key,
             "seq": self._next_seq(("async", key)), "value": grad})["value"]
        return np.asarray(out)

    def _sparse_rows(self, key: str) -> int:
        """A sharded table's row count: from ``async_init``, else the sum
        of the servers' slices."""
        n = self._key_rows.get(key)
        if n is None:
            outs = self._async_fanout(
                lambda j, addr: self._req_addr(
                    addr, {"cmd": "async_pull_rows", "key": key,
                           "ids": np.empty((0,), np.int64)}))
            n = sum(int(o["num_rows"]) for o in outs)
            self._key_rows[key] = n
        return n

    def async_push_sparse(self, key: str, ids, vals) -> dict:
        """Row-sparse async push: the server updates the touched rows
        lazily and answers ``{"ids", "vals"}`` of just those rows
        (``kvstore_dist.h:690-748``).  Sharded, the ids split by row range
        and are rebased to each server's slice."""
        ids = _host(ids).ravel()
        vals = _host(vals)
        nsrv = len(self.servers)
        if nsrv > 1:
            n = self._sparse_rows(key)
            ids, vals, bounds, part = self._partition_rows(n, ids, vals)

            def one(j, addr):
                sel = part == j
                out = self._req_addr(
                    addr, {"cmd": "async_push", "host": self.host,
                           "key": key,
                           "seq": self._next_seq(("async", key, j)),
                           "value": {"ids": ids[sel] - bounds[j],
                                     "vals": vals[sel]}})["value"]
                return {"ids": np.asarray(out["ids"]) + bounds[j],
                        "vals": np.asarray(out["vals"])}

            outs = self._async_fanout(one)
            return {"ids": np.concatenate([o["ids"] for o in outs]),
                    "vals": np.concatenate([o["vals"] for o in outs],
                                           axis=0)}
        return self._req_addr(
            self._data_addr(key),
            {"cmd": "async_push", "host": self.host, "key": key,
             "seq": self._next_seq(("async", key)),
             "value": {"ids": ids, "vals": vals}})["value"]

    def async_stats(self) -> dict:
        """The fleet's staleness: max over the servers, the push-weighted
        mean (each server measures its own slice's pushes)."""
        if self.servers:
            outs = self._async_fanout(
                lambda j, addr: self._req_addr(addr,
                                               {"cmd": "async_stats"}))
        else:
            outs = [self._req({"cmd": "async_stats"})]
        n = sum(o["measured_pushes"] for o in outs)
        return {
            "max_staleness": max(o["max_staleness"] for o in outs),
            "mean_staleness": (sum(o["mean_staleness"] *
                                   o["measured_pushes"] for o in outs) / n)
            if n else 0.0,
            "measured_pushes": n,
        }

    def async_pull_rows(self, key: str, ids) -> dict:
        """Only the requested rows of the master table (the reference's
        RowSparsePull, ``kvstore_dist.h:317-376``)."""
        ids = _host(ids).ravel()
        nsrv = len(self.servers)
        if nsrv > 1:
            n = self._sparse_rows(key)
            ids, _, bounds, part = self._partition_rows(n, ids)
            outs = self._async_fanout(
                lambda j, addr: self._req_addr(
                    addr, {"cmd": "async_pull_rows", "key": key,
                           "ids": ids[part == j] - bounds[j]}))
            return {"ids": np.concatenate(
                        [np.asarray(o["ids"]) + bounds[j]
                         for j, o in enumerate(outs)]),
                    "vals": np.concatenate(
                        [np.asarray(o["vals"]) for o in outs], axis=0),
                    "num_rows": n}
        return self._req_addr(
            self._data_addr(key),
            {"cmd": "async_pull_rows", "key": key, "ids": ids})

    def close(self):
        # the last obs flush comes before the heartbeat stops: the ring's
        # tail would never reach the job's timeline otherwise
        if self._obs_hook is not None:
            obs_trace.unregister_flush(self._obs_hook)
        if self._bb_state_name is not None:
            obs_blackbox.unregister_state(self._bb_state_name,
                                          fn=self._bb_provider)
        if self._hm_sampler is not None:
            self._hm_sampler.stop()
        self.obs_flush()
        self._stop.set()
        # bounded: an in-flight heartbeat must not return its channel to
        # the pool after the purge below
        self._hb_thread.join(timeout=2.0)
        for attr in ("_pool", "_pipe_pool"):
            pool = getattr(self, attr)
            if pool is not None:
                pool.shutdown(wait=False)
                setattr(self, attr, None)
        for addr in list(self.addrs) + list(self.servers):
            protocol.pool().close_addr(tuple(addr))


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array as numpy, for the wire."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class AllreducePipeline:
    """One step's bucketed allreduce, the wire stage of the overlapped
    host-sync step (``client.py:1329-1556``).

    The caller ``submit()``s bucket payloads in order as it stages them off
    the card; a comm thread feeds them through the bounded window over the
    pipeline executor, and averages come back through :meth:`poll` /
    :meth:`next_result` in bucket order.  Bucket k is the plain allreduce of
    subkey ``key#b<k>``, so dedup, tokens and chunking hold per bucket;
    every worker must run the same mode (``DT_AR_OVERLAP`` is job-wide).
    :meth:`submit_aux` runs a standalone round (the ``"stats"`` allreduce)
    in the same window.

    On failure the comm thread finishes every submitted round (so the
    caller's staging buffers are no longer read), discards the rest of the
    input and the error re-raises from the next call.  :meth:`close` is
    idempotent and returns whether the comm thread exited: only then may
    the caller recycle the buffers it submitted.
    """

    _END = ("end",)

    def __init__(self, client: WorkerClient, key: str,
                 window: Optional[int] = None):
        self._client = client
        self.key = key
        self._window = max(2, window or client._ar_window())
        # input backpressure bounds the caller's staging to ~2 x window
        self._in: "queue.Queue" = queue.Queue(maxsize=self._window)
        self._out: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._error: Optional[BaseException] = None  # guarded-by: _lock
        self._aux: Dict[str, object] = {}  # caller thread only
        self._submitted = 0
        self._consumed = 0
        self._input_done = False
        self._drained = False
        self._thread = threading.Thread(
            target=self._comm_loop, daemon=True,
            name=f"dt-ar-pipeline-{client.host}-{key}")
        self._thread.start()

    def _check_error(self) -> None:
        with self._lock:
            if self._error is not None:
                raise self._error

    def submit(self, payload) -> int:
        """Queue the next bucket (an array or a packed 2-bit dict); blocks
        while the window is full."""
        self._check_error()
        if self._input_done:
            raise RuntimeError("pipeline input already closed")
        idx = self._submitted
        self._submitted += 1
        self._in.put(("bucket", idx, payload))
        return idx

    def submit_aux(self, key: str, payload) -> None:
        """Queue a standalone round; read it with :meth:`aux` once the
        stream drained."""
        self._check_error()
        if self._input_done:
            raise RuntimeError("pipeline input already closed")
        self._in.put(("aux", key, payload))

    def done_submitting(self) -> None:
        if not self._input_done:
            self._input_done = True
            self._in.put(None)

    def poll(self):
        """``[(idx, averaged_bucket), ...]`` ready now; never blocks."""
        out = []
        while True:
            try:
                item = self._out.get_nowait()
            except queue.Empty:
                return out
            got = self._deliver(item)
            if got is not None:
                out.append(got)
            elif self._drained:
                return out

    def next_result(self, timeout: Optional[float] = None):
        """The next ``(idx, averaged_bucket)``; ``None`` once the stream
        ended.  Raises the pipeline's error, or ``queue.Empty`` on
        timeout."""
        while True:
            if self._drained:
                return None
            item = self._out.get(timeout=timeout) if timeout is not None \
                else self._out.get()
            got = self._deliver(item)
            if got is not None:
                return got
            if self._drained:
                return None

    def _deliver(self, item):
        kind = item[0]
        if kind == "bucket":
            self._consumed += 1
            return (item[1], item[2])
        if kind == "aux":
            self._aux[item[1]] = item[2]
            return None
        if kind == "error":
            self._drained = True
            raise item[1]
        self._drained = True  # _END
        return None

    def aux(self, key: str):
        if key not in self._aux:
            raise KeyError(f"aux round {key!r} not completed (drain the "
                           "pipeline first)")
        return self._aux[key]

    def close(self, timeout: float = 120.0) -> bool:
        self.done_submitting()
        try:
            self._in.put_nowait(None)  # wake an error-drain loop, if any
        except queue.Full:
            pass
        self._thread.join(timeout=timeout)
        return not self._thread.is_alive()

    def _tasks(self):
        while True:
            item = self._in.get()
            if item is None:
                return
            kind, a, payload = item
            if kind == "bucket":
                yield (lambda i=a, p=payload:
                       ("bucket", i, self._round(i, p)))
            else:
                yield (lambda k=a, p=payload:
                       ("aux", k, self._aux_round(k, p)))

    def _round(self, idx: int, payload):
        tr = obs_trace.tracer()
        t0 = tr.now()
        out = self._client._allreduce(f"{self.key}#b{idx}", payload)
        if obs_trace.enabled():
            tr.counter("pipeline.buckets")
        tr.complete_span("pipeline.wire", t0,
                         {"key": self.key, "bucket": idx})
        return out

    def _aux_round(self, key: str, payload):
        tr = obs_trace.tracer()
        t0 = tr.now()
        out = self._client._allreduce(key, payload)
        if obs_trace.enabled():
            tr.counter("pipeline.aux_rounds")
        tr.complete_span("pipeline.wire", t0, {"key": key, "aux": True})
        return out

    def _comm_loop(self):
        try:
            for item in self._client._stream_iter(
                    self._tasks(), pool=self._client._pipeline_pool(),
                    window=self._window):
                self._out.put(item)
            self._out.put(self._END)
        except BaseException as e:  # noqa: BLE001 — relayed to the caller
            with self._lock:
                self._error = e
            self._out.put(("error", e))
            while True:
                item = self._in.get()
                if item is None:
                    break


def auto_client(**kwargs) -> Optional[WorkerClient]:
    """A client from the launcher's env contract (``DMLC_PS_ROOT_URI``/
    ``DMLC_PS_ROOT_PORT``, ``DT_WORKER_ID``, ``NEW_WORKER``); ``None``
    outside an elastic launch."""
    uri = os.environ.get("DMLC_PS_ROOT_URI")
    port = os.environ.get("DMLC_PS_ROOT_PORT")
    if not uri or not port:
        return None
    return WorkerClient(uri, int(port),
                        host=config.env("DT_WORKER_ID") or None, **kwargs)
