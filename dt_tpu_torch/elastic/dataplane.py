"""The scheduler's data plane: exact-average allreduce rounds
(counterpart of ``dt_tpu/elastic/dataplane.py:36-449``, copied since the
port imports nothing of the JAX package).

One round per key use: every expected host contributes, the plane sums the
contributions in the order of the live worker list and divides by their
count, as the JAX package's plane does, so both schedulers return the same
bits.  A ``{"packed", "n", "threshold"}`` contribution is a 2-bit gradient,
decoded with numpy before the sum (``dataplane.py:223``).  ``(host, seq)``
makes a retried contribution idempotent.

The ``dist_async`` store (``dataplane.py:477-599``) and row-sparse
contributions raise, naming their ROADMAP items.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional, Set

import numpy as np

from dt_tpu_torch import config

_ASYNC = ("dist_async (the scheduler-side optimizer) is not ported yet; "
          "see ROADMAP.md, Queue 1 item 3a")
_SPARSE = ("the row-sparse allreduce is not ported yet; see ROADMAP.md, "
           "Queue 1 item 3b (the sparse allreduce and range servers)")


class DataPlane:
    """Allreduce rounds over the host set ``expected_fn()`` returns (the
    scheduler's live worker list, in rank order).

    The embedding scheduler may call :meth:`complete_with` while holding
    its own membership lock: the plane never calls back out, so the
    nesting is one-way."""

    #: commands this plane serves (the async ones raise)
    CMDS = ("allreduce", "set_optimizer", "async_init", "async_push",
            "async_pull_rows", "async_stats")

    def __init__(self, expected_fn: Callable[[], Set[str]], tracer=None):
        from dt_tpu_torch.obs import trace as obs_trace
        self._obs = tracer if tracer is not None else obs_trace.tracer()
        self.expected_fn = expected_fn
        self._cv = threading.Condition()
        # key -> {vals: {host: (seq, arr)}, gen, result, served: {host:
        # (seq, result)}, t0, lag0, arrive: {host: mono_ns}, meta}
        self._reduce: Dict[str, dict] = {}  # guarded-by: _cv

    def dispatch(self, msg: dict) -> Optional[dict]:
        cmd = msg.get("cmd")
        if cmd == "allreduce":
            return self.allreduce(msg["host"], msg["key"], msg["value"],
                                  int(msg.get("seq", -1)))
        if cmd in self.CMDS:
            return {"error": f"{cmd}: {_ASYNC}"}
        return None

    @staticmethod
    def _new_slot() -> dict:
        return {"vals": {}, "gen": 0, "result": None, "served": {},
                "t0": None, "lag0": None, "arrive": {}, "meta": None}

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
            from dt_tpu_torch.parallel.compression import np_dequantize_2bit
            arr = np_dequantize_2bit(np.asarray(value["packed"]),
                                     int(value["n"]),
                                     float(value["threshold"]))
        elif isinstance(value, dict) and "ids" in value:
            return {"error": _SPARSE}
        else:
            arr = np.asarray(value)
        tnow = self._obs.now()  # None when tracing is off
        with self._cv:
            slot = self._reduce.setdefault(key, self._new_slot())
            served = slot["served"].get(host)
            if seq >= 0 and served is not None and served[0] == seq:
                return {"value": served[1]}  # retry of a completed round
            gen = slot["gen"]
            if tnow is not None:  # round-lag stamps ride the trace gate
                if not slot["vals"]:
                    slot["t0"] = tnow
                    slot["lag0"] = tnow[1]
                    slot["arrive"] = {}
                # setdefault: a retried contribution keeps its first stamp
                slot["arrive"].setdefault(host, tnow[1])
            slot["vals"][host] = (seq, arr)
            expected = self.expected_fn()
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
        # accumulate in place in contributor order, with np.mean's dtype
        # rules (the JAX package's plane, bit for bit)
        out_dtype = np.result_type(*[np.asarray(a).dtype for a in stacked])
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
        lag0 = slot.get("lag0")
        if lag0 is not None:
            arrive = slot.get("arrive") or {}
            last_host, last_t = None, lag0
            for h, t in arrive.items():
                if t >= last_t:
                    last_host, last_t = h, t
            wait_ms = round(max(last_t - lag0, 0) / 1e6, 3)
            slot["meta"] = (slot["gen"] + 1, last_host, wait_ms)
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
