"""The data plane of the scheduler and of each range server: exact-average
allreduce rounds and the ``dist_async`` master-weight store (counterpart of
``dt_tpu/elastic/dataplane.py``, copied since the port imports nothing of
the JAX package).

One round per key use: every expected host contributes, the plane sums the
contributions in the order of the live worker list and divides by their
count, as the JAX package's plane does, so both return the same bits.  A
``{"packed", "n", "threshold"}`` contribution is a 2-bit gradient, decoded
with numpy before the sum (``dataplane.py:223``); an ``{"ids", "vals",
"num_rows"}`` one is row-sparse, merged by :meth:`DataPlane._merge_sparse`.
``(host, seq)`` makes a retried contribution idempotent.

The ``dist_async`` store applies each push at once with the server-side
optimizer (``server_optim``) and answers the post-update weights; a
``(host, key, seq)`` cache serves a retried or stale push the freshest
weights and never applies it twice.

With scheduler HA, the primary's plane replicates each completed round to
the warm standby before any waiter sees it (``replicate_fn``), and the
standby installs it (:meth:`DataPlane.install_round`), so a retry that
lands on the successor after a failover is served the identical average.

The straggler board (``dataplane.py:29-34, 345-409``): each host's first
arrival at a round is stamped, and when the round completes its lag behind
the round's first arrival folds into a per-host EWMA (ms), the policy
engine's input; crossing ``DT_STRAGGLER_MS`` fires one
``worker.straggler`` event an excursion.  Stamps are taken with tracing on
(``DT_OBS``) or with ``track_lag`` (the scheduler's policy engine).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, Optional, Set

import numpy as np

from dt_tpu_torch import config
from dt_tpu_torch.obs import blackbox as obs_blackbox
from dt_tpu_torch.obs import metrics as obs_metrics

logger = logging.getLogger("dt_tpu_torch.elastic")

#: EWMA smoothing of the straggler score: ~0.3 weights the last ~5 rounds,
#: quick to catch a worker going slow, smooth enough that one noisy round
#: does not cross the threshold
_STRAGGLER_ALPHA = 0.3


class DataPlane:
    """Allreduce rounds over the host set ``expected_fn()`` returns (the
    scheduler's live worker list in rank order, or a range server's mirror
    of it), and the ``dist_async`` store.

    ``confirm_fn`` is called right before a round completes, for an
    authoritative membership read: a range server serves from a cache with
    a TTL, and completing off a stale one would skip a just-registered
    worker.

    The embedding server may call :meth:`complete_with` while holding its
    own membership lock: the plane never calls back out, so the nesting is
    one-way."""

    #: commands this plane serves
    CMDS = ("allreduce", "set_optimizer", "async_init", "async_push",
            "async_pull_rows", "async_stats")

    def __init__(self, expected_fn: Callable[[], Set[str]],
                 confirm_fn: Optional[Callable[[], Set[str]]] = None,
                 tracer=None, replicate_fn=None, track_lag: bool = False):
        from dt_tpu_torch.obs import trace as obs_trace
        self._obs = tracer if tracer is not None else obs_trace.tracer()
        self.expected_fn = expected_fn
        # the policy engine needs the lag stamps with tracing off too
        self._track_lag = bool(track_lag)
        # HA: called with (key, gen, {host: seq}, result) after a round's
        # result is computed and before any waiter is released;
        # best-effort (a dead standby degrades HA, never the round)
        self._replicate = replicate_fn
        self._replicate_warned = False  # one log line an outage
        self.confirm_fn = confirm_fn or expected_fn
        self._cv = threading.Condition()
        # key -> {vals: {host: (seq, arr)}, gen, result, served: {host:
        # (seq, result)}, t0, lag0, arrive: {host: mono_ns}, meta}
        self._reduce: Dict[str, dict] = {}  # guarded-by: _cv
        # the straggler board: host -> round-lag EWMA (ms), and the hosts
        # above DT_STRAGGLER_MS (one event an excursion, not one a round)
        self._straggler: Dict[str, float] = {}  # guarded-by: _cv
        self._straggler_over: Set[str] = set()  # guarded-by: _cv
        self._async_lock = threading.Lock()
        self._async_live: Set[str] = set()  # guarded-by: _async_lock
        self._async_store: Dict[str, np.ndarray] = {}  # guarded-by: _async_lock
        self._async_updater = None  # guarded-by: _async_lock
        # (host, key) -> (seq, reply value); guarded-by: _async_lock
        self._async_served: Dict[tuple, tuple] = {}
        # staleness: updates by other workers between the weights a worker
        # trained on and its next push (key -> updates, (host, key) -> the
        # count its last reply carried)
        self._async_update_count: Dict[str, int] = {}  # guarded-by: _async_lock
        self._async_last_seen: Dict[tuple, int] = {}  # guarded-by: _async_lock
        self._async_stale_max = 0  # guarded-by: _async_lock
        self._async_stale_sum = 0  # guarded-by: _async_lock
        self._async_stale_n = 0  # guarded-by: _async_lock

    def dispatch(self, msg: dict) -> Optional[dict]:
        cmd = msg.get("cmd")
        if cmd == "allreduce":
            return self.allreduce(msg["host"], msg["key"], msg["value"],
                                  int(msg.get("seq", -1)))
        if cmd == "set_optimizer":
            return self.async_set_optimizer(msg["spec"])
        if cmd == "async_init":
            return self.async_init(msg["key"], msg["value"])
        if cmd == "async_push":
            return self.async_push(msg["host"], msg["key"], msg["value"],
                                   int(msg.get("seq", -1)))
        if cmd == "async_pull_rows":
            return self.async_pull_rows(msg["key"], msg["ids"])
        if cmd == "async_stats":
            return self.async_stats()
        return None

    # -- membership hooks (called by the embedding server) ---------------

    def host_registered(self, host: str) -> None:
        """A (re)registering worker starts fresh push sequences: purge its
        retry-dedup entries (else its first push after a restart would be
        swallowed by an old ``(host, seq)``) and its staleness basis (it
        re-bases on the live weights through ``async_init``)."""
        with self._async_lock:
            self._async_live.add(host)
            for key in [k for k in self._async_served if k[0] == host]:
                del self._async_served[key]
            for key in [k for k in self._async_last_seen if k[0] == host]:
                del self._async_last_seen[key]

    def hosts_removed(self, hosts: Set[str]) -> None:
        with self._async_lock:
            self._async_live -= set(hosts)
            for key in [k for k in self._async_last_seen if k[0] in hosts]:
                del self._async_last_seen[key]
        with self._cv:
            # a departed host's frozen score would shadow live lag
            for h in hosts:
                self._straggler.pop(h, None)
                self._straggler_over.discard(h)

    @staticmethod
    def _new_slot() -> dict:
        return {"vals": {}, "gen": 0, "result": None, "served": {},
                "t0": None, "lag0": None, "arrive": {}, "meta": None}

    def install_round(self, key: str, gen: int, seqs: Dict[str, int],
                      result) -> None:
        """Install a completed round the live primary replicated
        (``ha_round``): advance the slot's generation and seed the served
        cache, so a retry of that round after a failover gets the same
        result.  Idempotent: a replica at or below the slot's generation
        is a no-op, and a pending contribution at or below a served seq
        belongs to the replicated round and is dropped."""
        with self._cv:
            slot = self._reduce.setdefault(key, self._new_slot())
            if int(gen) <= slot["gen"]:
                return
            slot["gen"] = int(gen)
            for h, s in seqs.items():
                slot["served"][h] = (int(s), result)
                pend = slot["vals"].get(h)
                if pend is not None and pend[0] <= int(s):
                    del slot["vals"][h]
            self._cv.notify_all()

    def complete_with(self, live: Set[str], ordered=None) -> None:
        """After membership shrank, finish every round the survivors
        satisfy."""
        with self._cv:
            order = list(ordered) if ordered is not None else sorted(live)
            for key, slot in self._reduce.items():
                if slot["vals"] and live and set(slot["vals"]) >= live:
                    contributors = [h for h in order if h in slot["vals"]]
                    self._finish_round_locked(slot, contributors, key)
                    self._obs.event("dataplane.survivor_complete",
                                    {"key": key,
                                     "contributors": len(contributors)})
            self._cv.notify_all()

    # -- exact-average allreduce -----------------------------------------

    def allreduce(self, host: str, key: str, value, seq: int = -1) -> dict:
        """Average ``value`` over the expected hosts (server-side
        ``merged / NumWorkers()``, ``kvstore_dist_server.h:345-379``); a
        packed 2-bit dict is decoded first (``DataHandleCompressed``,
        ``:606-673``).  A re-sent ``(host, seq)`` whose round completed is
        served the cached result."""
        if isinstance(value, dict) and "packed" in value:
            from dt_tpu_torch.parallel.codec_np import np_dequantize_2bit
            arr = np_dequantize_2bit(np.asarray(value["packed"]),
                                     int(value["n"]),
                                     float(value["threshold"]))
        elif isinstance(value, dict) and "ids" in value:
            # row-sparse: O(touched rows) on the wire (the reference's
            # row_sparse push, kvstore_dist.h:690-748)
            arr = ("rsp", np.asarray(value["ids"]),
                   np.asarray(value["vals"]), int(value["num_rows"]))
        else:
            arr = np.asarray(value)
        tnow = self._obs.now()  # None when tracing is off
        with self._cv:
            slot = self._reduce.setdefault(key, self._new_slot())
            served = slot["served"].get(host)
            if seq >= 0 and served is not None and served[0] == seq:
                return {"value": served[1]}  # retry of a completed round
            gen = slot["gen"]
            # arrival stamps ride the trace gate, the policy engine, the
            # metrics plane (round.wait_ms and its SLO) and the flight
            # recorder (the scheduler's hang detector ages rounds by them)
            lag_ns = tnow[1] if tnow is not None else \
                (time.monotonic_ns()
                 if self._track_lag or obs_metrics.enabled()
                 or obs_blackbox.enabled() else None)
            if lag_ns is not None:
                if not slot["vals"]:
                    slot["t0"] = tnow  # the span's start; None untraced
                    slot["lag0"] = lag_ns
                    slot["arrive"] = {}
                # setdefault: a retried contribution keeps its first stamp
                # and cannot take the blame from the host everyone waits on
                slot["arrive"].setdefault(host, lag_ns)
            slot["vals"][host] = (seq, arr)
            expected = self.expected_fn()
            if expected and set(slot["vals"]) >= set(expected):
                expected = self.confirm_fn()  # authoritative recheck
            if expected and set(slot["vals"]) >= set(expected):
                contributors = [h for h in expected if h in slot["vals"]]
                self._finish_round_locked(slot, contributors, key)
                self._cv.notify_all()
                return self._round_resp_locked(slot, gen, tnow)
            while slot["gen"] == gen:
                if not self._cv.wait(timeout=300):
                    raise TimeoutError(f"allreduce {key} stuck")
            return self._round_resp_locked(slot, gen, tnow)

    def _round_resp_locked(self, slot: dict, gen: int, tnow) -> dict:
        """A completed round's response; when tracing, a transient
        ``_srv`` key carries this handler's wait for the rpc wrapper,
        which strips it from the wire.  Caller holds the lock."""
        resp = {"value": slot["result"]}
        if tnow is not None:
            t1 = self._obs.now()
            srv = {"wait_ms": round(max(t1[1] - tnow[1], 0) / 1e6, 3)
                   if t1 is not None else 0.0}
            meta = slot.get("meta")
            if meta is not None and meta[0] == gen + 1:
                srv["last"] = meta[1]
                srv["round_wait_ms"] = meta[2]
            resp["_srv"] = srv
        return resp

    def _finish_round_locked(self, slot: dict, contributors,
                             key: str = "") -> None:
        stacked = [slot["vals"][h][1] for h in contributors]
        if any(isinstance(a, tuple) and a[0] == "rsp" for a in stacked):
            slot["result"] = self._merge_sparse(stacked)
        else:
            # accumulate in place in contributor order, with np.mean's
            # dtype rules (the JAX package's plane, bit for bit)
            out_dtype = np.result_type(*[np.asarray(a).dtype
                                         for a in stacked])
            if not np.issubdtype(out_dtype, np.inexact):
                out_dtype = np.float64
            acc_dtype = np.float32 if out_dtype == np.float16 else out_dtype
            if len(stacked) == 1:
                acc = np.array(stacked[0], dtype=acc_dtype, copy=True)
            else:
                acc = np.add(stacked[0], stacked[1], dtype=acc_dtype)
                for a in stacked[2:]:
                    np.add(acc, a, out=acc)
            acc /= len(stacked)
            slot["result"] = acc.astype(out_dtype, copy=False)
        for h, (h_seq, _) in slot["vals"].items():
            slot["served"][h] = (h_seq, slot["result"])
        if self._replicate is not None:
            # to the warm standby before any waiter sees the result (one
            # loopback round trip a round, paid only with a standby)
            try:
                self._replicate(key, slot["gen"] + 1,
                                {h: s for h, (s, _) in slot["vals"].items()},
                                slot["result"])
                self._replicate_warned = False
            except Exception as e:  # noqa: BLE001 — HA is best-effort
                if not self._replicate_warned:
                    self._replicate_warned = True
                    logger.warning("HA round replication to the standby "
                                   "failed (%s); continuing unreplicated",
                                   e)
        lag0 = slot.get("lag0")
        if lag0 is not None:
            arrive = slot.get("arrive") or {}
            last_host, last_t = None, lag0
            for h, t in arrive.items():
                if t >= last_t:
                    last_host, last_t = h, t
            wait_ms = round(max(last_t - lag0, 0) / 1e6, 3)
            slot["meta"] = (slot["gen"] + 1, last_host, wait_ms)
            self._update_straggler_locked(arrive, lag0)
            obs_metrics.registry().observe("round.wait_ms", wait_ms)
            self._obs.complete_span(
                "dataplane.round", slot.get("t0"),
                {"key": key, "gen": slot["gen"] + 1,
                 "contributors": len(contributors),
                 "last": last_host, "wait_ms": wait_ms})
            slot["t0"] = None
            slot["lag0"] = None
            slot["arrive"] = {}
        slot["vals"] = {}
        slot["gen"] += 1
        self._obs.counter("dataplane.rounds")
        if "#b" in key:  # an overlap-pipeline bucket round
            self._obs.counter("dataplane.bucket_rounds")

    def _update_straggler_locked(self, arrive: Dict[str, int],
                                 first: int) -> None:
        """Fold one round's per-host arrival lags into the board; an
        edge-triggered ``worker.straggler`` event at ``DT_STRAGGLER_MS``.
        Caller holds the lock."""
        threshold = float(config.env("DT_STRAGGLER_MS"))
        for h, t in arrive.items():
            lag = max(t - first, 0) / 1e6
            prev = self._straggler.get(h)
            score = lag if prev is None else \
                (1.0 - _STRAGGLER_ALPHA) * prev + _STRAGGLER_ALPHA * lag
            self._straggler[h] = score
            if score >= threshold:
                if h not in self._straggler_over:
                    self._straggler_over.add(h)
                    self._obs.event("worker.straggler",
                                    {"host": h,
                                     "score_ms": round(score, 3)})
            else:
                self._straggler_over.discard(h)

    def pending_rounds(self) -> list:
        """The incomplete rounds and the hosts each waits on, the
        scheduler's hang detector's input; ``age_s`` from the round's
        first contribution (``None`` when no plane stamps arrivals)."""
        now = time.monotonic_ns()
        out = []
        with self._cv:
            expected = set(self.expected_fn())
            for key, slot in self._reduce.items():
                if not slot["vals"]:
                    continue
                waiting = sorted(expected - set(slot["vals"]))
                if not waiting:
                    continue  # completing right now
                lag0 = slot.get("lag0")
                out.append({
                    "key": key,
                    "age_s": round(max(now - lag0, 0) / 1e9, 3)
                    if lag0 is not None else None,
                    "waiting": waiting,
                    "contributed": sorted(slot["vals"])})
        return out

    def straggler_scores(self) -> Dict[str, float]:
        """The straggler board: each host's round-lag EWMA (ms, rounded to
        the µs), empty unless stamps are taken (tracing or
        ``track_lag``)."""
        with self._cv:
            return {h: round(v, 3)
                    for h, v in sorted(self._straggler.items())}

    @staticmethod
    def _merge_sparse(stacked) -> dict:
        """Merge row-sparse contributions: concatenate, sum duplicate ids,
        divide by the contributor count, elementwise the average of the
        dense-with-zeros equivalents (``kvstore_dist_server.h:345-379``).
        Mixed dense and sparse contributions give every waiter an
        ``__error__`` result, raised client-side."""
        if not all(isinstance(a, tuple) and a[0] == "rsp" for a in stacked):
            return {"__error__": "mixed dense and row-sparse contributions "
                                 "for one allreduce key"}
        num_rows = stacked[0][3]
        all_ids = np.concatenate([a[1] for a in stacked])
        all_vals = np.concatenate([a[2] for a in stacked], axis=0)
        live = all_ids < num_rows
        all_ids, all_vals = all_ids[live], all_vals[live]
        uniq, inv = np.unique(all_ids, return_inverse=True)
        summed = np.zeros((len(uniq),) + all_vals.shape[1:],
                          all_vals.dtype)
        np.add.at(summed, inv, all_vals)
        return {"ids": uniq.astype(np.int32),
                "vals": summed / len(stacked), "num_rows": num_rows}

    # -- the dist_async store --------------------------------------------

    def async_set_optimizer(self, spec: dict) -> dict:
        """Install the server-side updater from a spec (the reference
        pickled the optimizer to the servers, ``kvstore.py:451-498``).
        Idempotent for an identical spec (every worker sends it); a
        different one resets the updater, its slots and the dedup cache."""
        from dt_tpu_torch.elastic import server_optim
        with self._async_lock:
            if self._async_updater is not None and \
                    self._async_updater.spec_input == \
                    server_optim.spec_identity(spec):
                return {}
            try:
                upd = server_optim.create(**dict(spec))
            except (TypeError, ValueError) as e:
                return {"error": f"set_optimizer: {e}"}
            self._async_updater = upd
            self._async_served.clear()
        return {}

    def async_init(self, key: str, value) -> dict:
        """Init-or-get: the first writer seeds the master, later inits get
        the live copy (``kvstore_local.h:95-110``), so every worker inits
        and a joiner adopts the trained state."""
        with self._async_lock:
            if key not in self._async_store:
                self._async_store[key] = np.asarray(value)
            return {"value": self._async_store[key]}

    def _count_staleness_locked(self, host: str, key: str) -> None:
        """One applied push: how many updates landed since ``host``'s last
        reply.  Caller holds ``_async_lock``; a served replay never gets
        here."""
        cnt = self._async_update_count.get(key, 0)
        last = self._async_last_seen.get((host, key))
        if last is not None:
            lag = cnt - last
            self._async_stale_max = max(self._async_stale_max, lag)
            self._async_stale_sum += lag
            self._async_stale_n += 1
        self._async_update_count[key] = cnt + 1
        self._async_last_seen[(host, key)] = cnt + 1

    def async_stats(self) -> dict:
        with self._async_lock:
            n = self._async_stale_n
            return {"max_staleness": self._async_stale_max,
                    "mean_staleness":
                        (self._async_stale_sum / n) if n else 0.0,
                    "measured_pushes": n,
                    "keys": len(self._async_store)}

    def async_push(self, host: str, key: str, value, seq: int = -1) -> dict:
        """Apply one worker's gradient at once and answer the new weights
        (``kvstore_dist_server.h:347``: push order is apply order).  A
        replayed ``(host, key, seq)`` is served its cached reply; a stale
        one (below the last served seq: a delayed handler that lost the
        race to its own retry) is served the freshest weights; neither is
        applied again."""
        with self._async_lock:
            served = self._async_served.get((host, key))
            if seq >= 0 and served is not None and served[0] == seq:
                return {"value": served[1]}
            if seq >= 0 and served is not None and seq < served[0]:
                return {"value": served[1]}
            if self._async_updater is None:
                return {"error": "async_push before set_optimizer"}
            stored = self._async_store.get(key)
            if stored is None:
                return {"error": f"async_push: key {key!r} not initialized"}
            if isinstance(value, dict) and "ids" in value:
                # lazy update of the touched rows, and only those rows back
                # (kvstore_dist.h:690-748, optimizer_op.cc sparse variants)
                ids = np.asarray(value["ids"]).ravel()
                try:
                    new = self._async_updater.sparse(
                        key, ids, np.asarray(value["vals"]), stored)
                except ValueError as e:
                    return {"error": f"async_push sparse: {e}"}
                self._async_store[key] = new
                self._count_staleness_locked(host, key)
                keep = (ids >= 0) & (ids < new.shape[0])
                uniq = np.unique(ids[keep])
                resp = {"ids": uniq, "vals": new[uniq]}
                self._async_served[(host, key)] = (seq, resp)
                return {"value": resp}
            grad = np.asarray(value)
            new = self._async_updater(key, grad, stored)
            self._async_store[key] = new
            self._count_staleness_locked(host, key)
            self._async_served[(host, key)] = (seq, new)
            if len(self._async_served) > 4 * max(len(self._async_live), 1):
                # bound the cache by departed hosts' entries only: dropping
                # a live worker's would re-open the double-apply window
                for k in [k for k in self._async_served
                          if k[0] not in self._async_live]:
                    del self._async_served[k]
            return {"value": new}

    def async_pull_rows(self, key: str, ids) -> dict:
        """Only the requested live rows of the master table
        (``kvstore_dist.h:317-376``)."""
        with self._async_lock:
            stored = self._async_store.get(key)
            if stored is None:
                return {"error":
                        f"async_pull_rows: key {key!r} not initialized"}
            ids = np.asarray(ids).ravel()
            keep = (ids >= 0) & (ids < stored.shape[0])
            return {"ids": ids[keep], "vals": stored[ids[keep]],
                    "num_rows": int(stored.shape[0])}
