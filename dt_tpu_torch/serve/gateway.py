"""The serving gateway: deadline-aware dynamic batching over the pooled
transport (counterpart of ``dt_tpu/serve/gateway.py``, copied since the
port imports nothing of the JAX package).

Two levels:

- :class:`DynamicBatcher`, the batching arithmetic with no clock and no
  thread: launch a batch as soon as the queue fills the largest bucket;
  otherwise wait at most HALF the ``DT_SERVE_DEADLINE_MS`` budget from the
  oldest enqueue (the other half is for the forward) and launch into the
  smallest bucket that fits.  Admission is bounded by
  ``DT_SERVE_QUEUE_ROWS``: past the cap a request is shed, counted
  (``serve.shed``) and answered ``{"shed": true}``; the queue never grows
  without bound.
- :class:`Gateway`, the server: persistent connections through
  ``protocol.serve_connection``, the ``rpc.<cmd>`` causal span through
  ``protocol.traced_handle``, and the at-least-once contract through
  ``protocol.TokenCache``: ``infer`` is answered once a token, so a retried
  request (one that crossed a scheduler failover included: the data plane
  never touches the scheduler) gets the cached answer instead of a second
  run.

One executor thread drains the queue into ``Predictor.predict``; it enters
``torch.inference_mode`` itself (grad mode is thread-local).
``weight_refresh`` swaps the parameters under the same execution lock, so a
swap waits for the in-flight batch and every answer comes entirely from the
old or entirely from the new weights (drain-then-swap; ``serve/refresh.py``).
Every ``infer`` answer carries ``weights_step`` so that can be checked.

The gateway imports no torch: it hands numpy rows to the predictor and
numpy logits back.
"""

from __future__ import annotations

import collections
import logging
import os
import random
import socket
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from dt_tpu_torch import config
from dt_tpu_torch.elastic import faults, protocol
from dt_tpu_torch.obs import metrics as obs_metrics
from dt_tpu_torch.obs import trace as obs_trace

logger = logging.getLogger("dt_tpu_torch.serve")
_drop_rng = random.Random(0x5EED)  # DT_DROP_MSG, seeded as the JAX one

#: responses not kept in the token cache: the replica's read-only commands
#: and the step-keyed refresh (the JAX gateway's ``_TOKEN_EXEMPT``, which
#: ``dt_tpu/elastic/commands.py`` derives for the ``replica`` role)
_TOKEN_EXEMPT = frozenset(("infer_result", "serve_stats", "weight_refresh"))


class DynamicBatcher:
    """The deadline and bucket arithmetic, with no clock and no thread.

    ``plan(pending, now_ms)``, ``pending`` the ordered ``(rows,
    enqueue_ms)`` of the queue, returns how many requests to launch now (0
    = keep waiting):

    - the longest FIFO prefix whose rows fit the largest bucket (a request
      is never split: one larger than the largest bucket is refused at
      admission);
    - launched at once when it is as full as it can get (it fills the
      largest bucket, or a request waits behind it);
    - else launched once ``now_ms`` reaches the oldest request's enqueue
      time plus HALF the deadline; the other half is for the forward.
    """

    def __init__(self, buckets: Sequence[int], deadline_ms: float,
                 queue_rows: int):
        self.buckets = sorted(int(b) for b in buckets)
        self.deadline_ms = float(deadline_ms)
        self.queue_rows = int(queue_rows)

    @property
    def max_batch(self) -> int:
        return self.buckets[-1]

    def bucket_of(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def admit(self, queued_rows: int, n: int) -> bool:
        """A request is at most the largest bucket, and the queue holds at
        most ``queue_rows`` rows."""
        return 0 < n <= self.max_batch and \
            queued_rows + n <= self.queue_rows

    def plan(self, pending: Sequence[Tuple[int, float]],
             now_ms: float) -> int:
        if not pending:
            return 0
        take, total = 0, 0
        for rows, _ in pending:
            if total + rows > self.max_batch:
                break
            take += 1
            total += rows
        if total == self.max_batch or take < len(pending):
            return take  # the batch cannot get any fuller
        if now_ms - pending[0][1] >= self.deadline_ms / 2.0:
            return take  # half the budget spent waiting: launch it partial
        return 0

    def next_wakeup_ms(self, oldest_enqueue_ms: float) -> float:
        """When the oldest request's wait budget runs out."""
        return oldest_enqueue_ms + self.deadline_ms / 2.0


class _Pending:
    __slots__ = ("rid", "x", "enq_ms", "event", "result")

    def __init__(self, rid, x, enq_ms):
        self.rid = rid
        self.x = x
        self.enq_ms = enq_ms
        self.event = threading.Event()
        self.result = None


class Gateway:
    """One replica's request server: a ``Predictor`` behind a dynamic
    batcher.

    ``refresh_loader(step, manifest) -> params | (params, batch_stats) |
    None`` resolves a ``weight_refresh`` to new weights, in the form
    ``Predictor.swap_params`` takes (``serve/refresh.py`` has the
    committed-manifest loader; the toy replicas derive weights from the
    step).
    """

    #: async results kept for ``infer_result`` polls (LRU-capped)
    _RESULT_CAP = 1024

    def __init__(self, predictor, port: int = 0, name: str = "gateway",
                 deadline_ms: Optional[float] = None,
                 queue_rows: Optional[int] = None,
                 refresh_loader: Optional[Callable] = None):
        self._predictor = predictor
        self._batcher = DynamicBatcher(
            predictor.batch_buckets,
            float(config.env("DT_SERVE_DEADLINE_MS"))
            if deadline_ms is None else deadline_ms,
            int(config.env("DT_SERVE_QUEUE_ROWS"))
            if queue_rows is None else queue_rows)
        self._refresh_loader = refresh_loader
        self._obs = obs_trace.Tracer(name=name)
        self._tokens = protocol.TokenCache(
            ttl_s=float(config.env("DT_CTRL_TOKEN_TTL_S")))

        self._cond = threading.Condition()
        self._pending: List[_Pending] = []  # guarded-by: _cond
        self._queued_rows = 0  # guarded-by: _cond
        self._draining = False  # guarded-by: _cond
        # weight_refresh takes this lock, so a swap waits out the
        # in-flight batch (drain-then-swap)
        self._exec_lock = threading.Lock()
        self._weights_step = 0  # guarded-by: _exec_lock
        self._refreshes = 0  # guarded-by: _exec_lock
        self._results = collections.OrderedDict()  # guarded-by: _results_lock
        self._results_lock = threading.Lock()
        # (done monotonic s, latency ms) for p50/p99/qps
        self._lat = collections.deque(maxlen=2048)  # guarded-by: _lat_lock
        self._lat_lock = threading.Lock()
        # a synchronous infer gives the executor generous headroom (the
        # deadline is the batcher's target, not a bound on the forward)
        self._wait_s = max(5.0, self._batcher.deadline_ms / 10.0)

        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((protocol.bind_interface(), port))
        self._sock.listen(128)
        self.port = self._sock.getsockname()[1]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        self._exec_thread = threading.Thread(target=self._exec_loop,
                                             daemon=True)
        self._exec_thread.start()
        logger.info("serve gateway %s listening on :%d", name, self.port)

    # ------------------------------------------------------------------
    # introspection
    # ------------------------------------------------------------------

    @property
    def weights_step(self) -> int:
        with self._exec_lock:
            return self._weights_step

    def _lat_view(self) -> Tuple[float, float, float]:
        """(p50 ms, p99 ms, qps) over the recent answers; qps is the
        answer rate of the trailing 5 s."""
        with self._lat_lock:
            ring = list(self._lat)
        if not ring:
            return 0.0, 0.0, 0.0
        lats = sorted(ms for _, ms in ring)
        p50 = lats[len(lats) // 2]
        p99 = lats[min(len(lats) - 1, int(len(lats) * 0.99))]
        now = time.monotonic()
        recent = sum(1 for ts, _ in ring if now - ts <= 5.0)
        return p50, p99, recent / 5.0

    def stats(self) -> dict:
        """The ``serve_stats`` answer (a pure read)."""
        with self._cond:
            depth = len(self._pending)
            rows = self._queued_rows
            draining = self._draining
        with self._exec_lock:
            step = self._weights_step
            refreshes = self._refreshes
        p50, p99, qps = self._lat_view()
        return {"queue_depth": depth, "queued_rows": rows,
                "draining": draining, "weights_step": step,
                "refreshes": refreshes, "p50_ms": p50, "p99_ms": p99,
                "qps": qps,
                "requests": self._obs.get_counter("serve.requests"),
                "rows": self._obs.get_counter("serve.rows"),
                "batches": self._obs.get_counter("serve.batches"),
                "shed": self._obs.get_counter("serve.shed")}

    def gauges(self) -> dict:
        """Set the live serve gauges on the process metrics plane and
        return them: the replica's heartbeat carries this dict to the
        scheduler, whose autoscaler reads the queue depth."""
        with self._cond:
            depth = float(len(self._pending))
        _, p99, qps = self._lat_view()
        reg = obs_metrics.registry()
        reg.gauge("serve.queue_depth", depth)
        reg.gauge("serve.p99_ms", p99)
        reg.gauge("serve.qps", qps)
        return {"serve.queue_depth": depth, "serve.p99_ms": p99,
                "serve.qps": qps}

    # ------------------------------------------------------------------
    # drain (scale-down, rolling shutdown)
    # ------------------------------------------------------------------

    def drain(self) -> None:
        """Stop admitting; queued requests still complete.  A new infer is
        answered ``{"error": "draining"}``, which is never token-cached, so
        the client's retry with the same token lands on another replica."""
        with self._cond:
            self._draining = True
            self._cond.notify()

    def drained(self) -> bool:
        with self._cond:
            return self._draining and not self._pending

    # ------------------------------------------------------------------
    # the server (shaped as the range server's)
    # ------------------------------------------------------------------

    def _serve(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._handle_conn, args=(conn,),
                             daemon=True).start()

    def _handle_conn(self, conn: socket.socket):
        protocol.serve_connection(conn, self._handle_one)

    def _handle_one(self, msg: dict) -> Optional[dict]:
        return protocol.traced_handle(self._obs, msg, self._handle_inner)

    def _handle_inner(self, msg: dict) -> Optional[dict]:
        """One request on a persistent connection (``None`` drops it)."""
        drop = os.environ.get("DT_DROP_MSG")
        if drop and _drop_rng.random() * 100 < float(drop):
            logger.debug("DT_DROP_MSG: dropping %s", msg.get("cmd"))
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
            logger.exception("serve gateway handler error")
            return {"error": repr(e)}
        if token is not None and "error" not in resp and \
                msg.get("cmd") not in _TOKEN_EXEMPT:
            self._tokens.put(token, resp)
        return resp

    def _dispatch(self, msg: dict) -> dict:
        cmd = msg.get("cmd")
        if cmd == "infer":
            x = np.asarray(msg["x"])
            wait = bool(msg.get("wait", True))
            rid = msg.get("rid")
            n = int(x.shape[0]) if x.ndim else 0
            with self._cond:
                if self._draining:
                    return {"error": "draining"}
                if n > self._batcher.max_batch or n <= 0:
                    return {"error": f"request rows {n} outside "
                                     f"(0, {self._batcher.max_batch}]"}
                if not self._batcher.admit(self._queued_rows, n):
                    self._obs.counter("serve.shed")
                    return {"shed": True}
                req = _Pending(rid, x, time.monotonic() * 1000.0)
                self._pending.append(req)
                self._queued_rows += n
                self._obs.counter("serve.requests")
                self._obs.counter("serve.rows", n)
                self._cond.notify()
            if not wait:
                return {"queued": True, "rid": rid}
            if not req.event.wait(self._wait_s) or req.result is None:
                return {"error": "serve timeout"}
            return dict(req.result)
        if cmd == "infer_result":
            # a read-only poll; the executor prunes the results
            with self._results_lock:
                res = self._results.get(msg["rid"])
            if res is None:
                return {"done": False}
            out = dict(res)
            out["done"] = True
            return out
        if cmd == "serve_stats":
            return self.stats()
        if cmd == "weight_refresh":
            return self._refresh(int(msg["step"]), msg.get("manifest"))
        if cmd == "shutdown":
            self.close()
            return {}
        return {"error": f"unknown cmd {cmd!r} (serve gateway)"}

    # ------------------------------------------------------------------
    # rolling weight refresh (drain-then-swap)
    # ------------------------------------------------------------------

    def _refresh(self, step: int, manifest: Optional[dict]) -> dict:
        with self._exec_lock:  # waits out the in-flight batch
            if step <= self._weights_step:
                # keyed by step: a refresher's retry of the step already
                # served is a no-op
                return {"weights_step": self._weights_step,
                        "applied": False}
            if self._refresh_loader is None:
                return {"error": f"no refresh loader for step {step}"}
            loaded = self._refresh_loader(step, manifest)
            if loaded is None:
                return {"error": f"refresh loader returned nothing for "
                                 f"step {step}"}
            params, batch_stats = loaded if isinstance(loaded, tuple) \
                else (loaded, None)
            self._predictor.swap_params(params, batch_stats)
            self._weights_step = step
            self._refreshes += 1
        self._obs.event("serve.refresh", {"step": step})
        logger.info("weights refreshed to step %d", step)
        return {"weights_step": step, "applied": True}

    # ------------------------------------------------------------------
    # the executor
    # ------------------------------------------------------------------

    def _exec_loop(self):
        while True:
            with self._cond:
                while not self._stop.is_set():
                    now_ms = time.monotonic() * 1000.0
                    k = self._batcher.plan(
                        [(int(p.x.shape[0]), p.enq_ms)
                         for p in self._pending], now_ms)
                    if k:
                        break
                    if self._pending:
                        wake = self._batcher.next_wakeup_ms(
                            self._pending[0].enq_ms)
                        self._cond.wait(
                            max(wake - now_ms, 1.0) / 1000.0)
                    else:
                        self._cond.wait(0.2)
                if self._stop.is_set():
                    return
                batch = self._pending[:k]
                del self._pending[:k]
                self._queued_rows -= sum(int(p.x.shape[0])
                                         for p in batch)
            self._run_batch(batch)

    def _run_batch(self, batch: List[_Pending]) -> None:
        rows = sum(int(p.x.shape[0]) for p in batch)
        t0 = self._obs.begin("serve.batch")
        err = None
        with self._exec_lock:
            step = self._weights_step
            x = batch[0].x if len(batch) == 1 else \
                np.concatenate([p.x for p in batch])
            try:
                y = self._predictor.predict(x)
            except Exception as e:  # answer the batch, keep serving
                logger.exception("serve batch failed")
                err = repr(e)
        self._obs.complete_span(
            "serve.batch", t0,
            {"rows": rows, "requests": len(batch),
             "bucket": self._batcher.bucket_of(rows)})
        self._obs.counter("serve.batches")
        done = time.monotonic()
        reg = obs_metrics.registry()
        off = 0
        for p in batch:
            n = int(p.x.shape[0])
            if err is not None:
                resp = {"error": err}
            else:
                resp = {"y": y[off:off + n], "weights_step": step}
            off += n
            lat_ms = done * 1000.0 - p.enq_ms
            with self._lat_lock:
                self._lat.append((done, lat_ms))
            reg.observe("serve.latency_ms", lat_ms)
            if p.rid is not None:
                with self._results_lock:
                    self._results[p.rid] = resp
                    while len(self._results) > self._RESULT_CAP:
                        self._results.popitem(last=False)
            p.result = resp
            p.event.set()
        self.gauges()  # refresh the local metrics plane a batch

    def close(self):
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        try:
            self._sock.close()
        except OSError:
            pass
