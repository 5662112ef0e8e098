"""The worker's side of the elastic control plane (counterpart of
``WorkerClient``, ``dt_tpu/elastic/client.py:80``, copied since the port
imports nothing of the JAX package).

A kvstore takes it through ``kv.set_controller(...)``.  It registers the
worker, heartbeats from a thread, and carries the membership-change
barrier (:meth:`WorkerClient.membership_change_barrier`, the re-admission
of a crashed worker :meth:`~WorkerClient.wait_rejoin`), the plain
barrier, the joiners' snapshot, the dead-node count, the graceful drain
and the exact-average dense allreduce, chunked and windowed
(``client.py:834-1035``), with its bucketed pipeline
(:class:`AllreducePipeline`) for the overlapped step.

Everything it sends is numpy or plain Python (the JAX package's processes
unpickle it).  The heartbeat and comm threads touch no CUDA: only the
training thread launches.  What it does not port raises, naming the
ROADMAP item: the sparse and async calls (``client.py:1036-1298``; items
3a, 3b), failover across ``DT_CTRL_ENDPOINTS`` (scheduler HA, item 3c),
and the profiler commands and the obs export on the heartbeat (item 7).
"""

from __future__ import annotations

import collections
import logging
import os
import queue
import socket
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dt_tpu_torch import config
from dt_tpu_torch.elastic import faults, protocol
from dt_tpu_torch.obs import trace as obs_trace

logger = logging.getLogger("dt_tpu_torch.elastic")

_ITEM = "is not ported yet; see ROADMAP.md, Queue 1 "
_ASYNC = "item 3a (dist_async and the scheduler-side optimizer)"
_SPARSE = "item 3b (the sparse allreduce and range servers)"


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
        if endpoints is not None and len(endpoints) > 1 or \
                config.env("DT_CTRL_ENDPOINTS"):
            raise NotImplementedError(
                f"failover across scheduler endpoints {_ITEM}item 3c "
                "(scheduler HA)")
        if endpoints:
            scheduler_host, scheduler_port = endpoints[0]
        self.addrs: List[Tuple[str, int]] = [(scheduler_host,
                                              int(scheduler_port))]
        self.fence = 0
        self.host = host or f"{socket.gethostname()}:{os.getpid()}"
        if is_new is None:
            is_new = os.environ.get("NEW_WORKER", "") in ("1", "true")
        if is_recovery is None:
            # a restarted worker re-entering under its old name
            # (van.cc:187-218 is_recovery)
            is_recovery = config.env("DT_RECOVERY") in ("1", "true")
        if obs_trace.enabled():
            obs_trace.set_origin(f"{self.host}#{os.getpid()}")
        faults.crash_point("client.register", host=self.host)
        resp = self._req({"cmd": "register", "host": self.host,
                          "is_new": is_new, "is_recovery": is_recovery})
        if resp.get("servers"):
            raise NotImplementedError(f"range servers {_ITEM}{_SPARSE}")
        self.fence = int(resp.get("fence", 0))
        # rank/workers change at barriers (caller thread); the lock keeps
        # a reader on another thread from seeing half an update
        self._lock = threading.Lock()
        self.rank: int = resp["rank"]  # guarded-by: _lock
        self.workers: List[str] = resp["workers"]
        # a recovering worker: rank -1 until a barrier re-admits it
        self.recovery_pending: bool = bool(resp.get("recovery_pending"))
        self.resume_epoch: int = int(resp.get("resume_epoch", 0))
        # the policy engine is not ported: a barrier carrying shares
        # raises in _adopt_policy_locked
        self.policy_shares: Dict[str, int] = {}
        self.policy_lr_scale: float = 1.0
        self.policy_seq: int = 0
        self.servers: List[Tuple[str, int]] = []
        self._ar_seq: Dict[object, int] = {}
        self._seq_lock = threading.Lock()
        self._pool = None  # lazy executor for chunk windows
        self._pipe_pool = None  # lazy executor for bucket rounds
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
        return self.addrs[0]

    def _req(self, msg: dict, timeout: float = 600.0,
             retries: int = 8) -> dict:
        """Request with at-least-once retry (the ``resender.h`` role):
        every re-send carries the same idempotency token.  ``retries`` is
        the total number of attempts."""
        resp = protocol.request(self.addr[0], self.addr[1], msg,
                                timeout=timeout,
                                retries=max(retries - 1, 0))
        if "error" in resp:
            raise RuntimeError(f"scheduler error: {resp['error']}")
        return resp

    def _heartbeat_loop(self, interval: float):
        while not self._stop.is_set():
            try:
                faults.crash_point("client.heartbeat", host=self.host)
            except faults.CrashInjected:
                return  # an injected heartbeat death: the thread stops
            try:
                if obs_trace.enabled():
                    obs_trace.tracer().counter("heartbeat.sent")
                # retries=1: a lost heartbeat is superseded by the next
                self._req({"cmd": "heartbeat", "host": self.host,
                           "pseq": 0}, timeout=10, retries=1)
            except (OSError, RuntimeError):
                pass  # scheduler gone: dead-node detection is its problem
            self._stop.wait(interval)

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
        """A barrier response's policy payload: shares never come from a
        scheduler with the policy engine off.  Caller holds the lock."""
        pol = resp.get("policy")
        if pol and pol.get("shares"):
            raise NotImplementedError(
                f"policy batch shares {_ITEM}item 3d (the policy engine "
                "and share-weighted re-sharding)")

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
        return self._req({"cmd": "fetch_snapshot"})["blob"]

    def num_dead_nodes(self, timeout_s: float = 60.0) -> int:
        return self._req({"cmd": "num_dead",
                          "timeout_s": timeout_s})["count"]

    def drain(self) -> dict:
        """Leave the job through the eviction machinery (no recovery
        window)."""
        return self._req({"cmd": "drain", "host": self.host})

    def profile_command(self, action: str, params: Optional[dict] = None):
        raise NotImplementedError(
            f"remote profiler commands {_ITEM}item 7 (the obs, metrics and "
            "device planes)")

    # -- dense allreduce -------------------------------------------------

    def _ar_chunk_elems(self, value_size: int, itemsize: int,
                        route: Optional[int], nbytes: int,
                        quantum: int = 1) -> int:
        """Elements per chunked-allreduce round (``DT_AR_CHUNK_BYTES``),
        rounded down to whole packing words (``quantum``), as the JAX
        client chunks with no range servers."""
        del value_size, route, nbytes  # the fleet split needs servers
        per = max(1, int(config.env("DT_AR_CHUNK_BYTES"))
                  // max(itemsize, 1))
        if quantum > 1:
            per = max(quantum, (per // quantum) * quantum)
        return per

    def _ar_window(self) -> int:
        """The bounded in-flight round window (``DT_AR_WINDOW``, default
        2x fleet, min 4)."""
        return int(config.env("DT_AR_WINDOW")) or 4

    def _fanout_pool(self):
        """Executor of chunk windows; its tasks never submit back into
        it, so sharing one cannot deadlock."""
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(
                max_workers=max(4, int(config.env("DT_AR_WINDOW"))),
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
        idempotent."""
        if isinstance(value, dict) and "packed" in value:
            from dt_tpu_torch.parallel.compression import (CODES_PER_WORD,
                                                           packed_chunks)
            n = int(value["n"])
            per = self._ar_chunk_elems(n, 4, _route, n * 4,
                                       quantum=CODES_PER_WORD)
            if _route is None and n > per:
                packed = np.asarray(value["packed"])
                thr = float(value["threshold"])
                chunks = packed_chunks(packed, n, per)
                parts = self._stream_chunks([
                    (lambda i=i, words=words, cn=cn:
                     self._allreduce(f"{key}#c{i}",
                                     {"packed": words, "n": cn,
                                      "threshold": thr}, None))
                    for i, (words, cn) in enumerate(chunks)])
                return np.concatenate(parts)
        elif isinstance(value, dict):
            raise NotImplementedError(
                f"a row-sparse allreduce {_ITEM}{_SPARSE}")
        else:
            value = np.asarray(value)
            per = self._ar_chunk_elems(value.size, max(value.itemsize, 1),
                                       _route, value.nbytes)
            if value.size > per:
                flat = value.ravel()
                parts = self._stream_chunks([
                    (lambda i=i, start=start:
                     self._allreduce(f"{key}#c{i}",
                                     flat[start:start + per], None))
                    for i, start in enumerate(range(0, flat.size, per))])
                return np.concatenate(parts).reshape(value.shape)
        out = self._req({"cmd": "allreduce", "host": self.host, "key": key,
                         "seq": self._next_seq(key),
                         "value": value})["value"]
        if isinstance(out, dict) and "__error__" in out:
            raise RuntimeError(f"allreduce {key}: {out['__error__']}")
        return out

    def allreduce_sparse(self, key: str, rs, capacity: Optional[int] = None):
        raise NotImplementedError(f"allreduce_sparse {_ITEM}{_SPARSE}")

    def set_optimizer(self, spec: Dict) -> None:
        raise NotImplementedError(f"set_optimizer {_ITEM}{_ASYNC}")

    def async_init(self, key: str, value):
        raise NotImplementedError(f"async_init {_ITEM}{_ASYNC}")

    def async_push(self, key: str, grad):
        raise NotImplementedError(f"async_push {_ITEM}{_ASYNC}")

    def async_push_sparse(self, key: str, ids, vals):
        raise NotImplementedError(f"async_push_sparse {_ITEM}{_ASYNC}")

    def async_stats(self) -> dict:
        raise NotImplementedError(f"async_stats {_ITEM}{_ASYNC}")

    def async_pull_rows(self, key: str, ids):
        raise NotImplementedError(f"async_pull_rows {_ITEM}{_ASYNC}")

    def close(self):
        self._stop.set()
        # bounded: an in-flight heartbeat must not return its channel to
        # the pool after the purge below
        self._hb_thread.join(timeout=2.0)
        for attr in ("_pool", "_pipe_pool"):
            pool = getattr(self, attr)
            if pool is not None:
                pool.shutdown(wait=False)
                setattr(self, attr, None)
        for addr in self.addrs:
            protocol.pool().close_addr(tuple(addr))


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
