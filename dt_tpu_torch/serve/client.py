"""The inference client, the request side of the serving plane (counterpart
of ``dt_tpu/serve/client.py``, copied since the port imports nothing of the
JAX package).

Replica discovery rides the scheduler's ``serve_endpoints`` view (control
plane only); requests go straight to the replicas' gateways, so a
scheduler failover never touches inference in flight.

Every ``infer`` carries one idempotency token for all of its retries.  A
retry that lands on the same replica gets the token-cached answer; one that
moves to another replica after a kill computes it again, the same answer
since all live replicas serve one ``weights_step`` between refresh waves.
An explicit ``{"shed": true}`` answer is final (bounded admission), not
retried.
"""

from __future__ import annotations

import socket
import threading
import time
import uuid
from typing import List, Optional, Sequence, Tuple

import numpy as np

from dt_tpu_torch.elastic import protocol
from dt_tpu_torch.elastic.client import parse_endpoints


class InferClient:
    """``InferClient(scheduler="h:p[,h:p]")`` or
    ``InferClient(replicas=[(h, p), ...])``, then ``infer(x)``.

    With a scheduler the replica list comes lazily from
    ``serve_endpoints`` (draining replicas left out: their gateways answer
    ``draining`` anyway); a static ``replicas`` list skips discovery.
    """

    def __init__(self, scheduler: Optional[str] = None,
                 replicas: Optional[Sequence[Tuple[str, int]]] = None,
                 timeout_s: float = 30.0, tries: int = 12):
        self._sched = parse_endpoints(scheduler) if scheduler else []
        self._lock = threading.Lock()
        self._replicas: List[Tuple[str, int]] = \
            [tuple(r) for r in (replicas or [])]  # guarded-by: _lock
        self._rr = 0  # guarded-by: _lock
        self._sched_leader = 0  # guarded-by: _lock
        self._timeout = float(timeout_s)
        self._tries = int(tries)

    # -- control plane -------------------------------------------------

    def _req(self, msg: dict) -> dict:
        """One control request with endpoint rotation (the
        ``DT_CTRL_ENDPOINTS`` failover contract)."""
        last: Optional[BaseException] = None
        for _ in range(max(len(self._sched), 1) * 3):
            with self._lock:
                host, port = self._sched[self._sched_leader]
            try:
                resp = protocol.request(host, port, dict(msg),
                                        timeout=5.0)
            except (ConnectionError, socket.timeout, OSError) as e:
                last = e
                with self._lock:
                    self._sched_leader = \
                        (self._sched_leader + 1) % len(self._sched)
                time.sleep(0.05)
                continue
            if resp.get("error") in ("not_leader", "fenced"):
                with self._lock:
                    self._sched_leader = \
                        (self._sched_leader + 1) % len(self._sched)
                continue
            return resp
        raise ConnectionError(f"no scheduler endpoint answered: {last!r}")

    def refresh_endpoints(self) -> List[Tuple[str, int]]:
        """Pull the live replica set from the scheduler again."""
        if not self._sched:
            with self._lock:
                return list(self._replicas)
        resp = self._req({"cmd": "serve_endpoints"})
        reps = resp.get("replicas") or {}
        addrs = [tuple(e["addr"]) for _, e in sorted(reps.items())
                 if not e.get("draining")]
        with self._lock:
            if addrs:
                self._replicas = addrs
                self._rr %= max(len(addrs), 1)
            return list(self._replicas)

    def _next_replica(self) -> Tuple[str, int]:
        with self._lock:
            if self._replicas:
                addr = self._replicas[self._rr % len(self._replicas)]
                self._rr += 1
                return addr
        addrs = self.refresh_endpoints()
        if not addrs:
            raise ConnectionError("no serving replicas registered")
        return addrs[0]

    # -- data plane ----------------------------------------------------

    def infer(self, x: np.ndarray,
              token: Optional[str] = None) -> dict:
        """Round-robin one request over the live replicas, retrying with
        the SAME token across kills and drains until it is answered or
        shed.  Returns the gateway's answer, ``{"y", "weights_step"}`` or
        ``{"shed": true}``."""
        token = token or uuid.uuid4().hex
        msg = {"cmd": "infer", "x": np.asarray(x), "token": token}
        last: Optional[BaseException] = None
        delay = 0.05
        for _ in range(self._tries):
            try:
                host, port = self._next_replica()
            except ConnectionError as e:
                last = e
                time.sleep(delay)
                delay = protocol.next_backoff(delay, 0.05, 1.0)
                continue
            try:
                resp = protocol.request(host, port, msg,
                                        timeout=self._timeout)
            except (ConnectionError, socket.timeout, OSError) as e:
                # the replica is gone (a kill or a drain race): discover
                # the fleet again and rotate
                last = e
                try:
                    self.refresh_endpoints()
                except ConnectionError:
                    pass
                time.sleep(delay)
                delay = protocol.next_backoff(delay, 0.05, 1.0)
                continue
            if resp.get("error") is not None:
                # "draining" or a transient handler error: another replica
                last = RuntimeError(str(resp.get("error")))
                try:
                    self.refresh_endpoints()
                except ConnectionError:
                    pass
                time.sleep(delay)
                delay = protocol.next_backoff(delay, 0.05, 1.0)
                continue
            return resp
        raise ConnectionError(f"infer not answered after "
                              f"{self._tries} tries: {last!r}")

    def infer_async(self, x: np.ndarray,
                    rid: Optional[str] = None) -> Tuple[str,
                                                        Tuple[str, int]]:
        """Queue without waiting (the ``wait: false`` wire path): returns
        ``(rid, replica_addr)`` to poll with :meth:`result`."""
        rid = rid or uuid.uuid4().hex
        host, port = self._next_replica()
        resp = protocol.request(
            host, port,
            {"cmd": "infer", "x": np.asarray(x), "wait": False,
             "rid": rid}, timeout=self._timeout)
        if resp.get("error") is not None:
            raise RuntimeError(f"infer_async: {resp.get('error')}")
        if resp.get("shed"):
            raise RuntimeError("infer_async: shed")
        return resp["rid"], (host, port)

    def result(self, rid: str, addr: Tuple[str, int],
               wait_s: float = 10.0) -> dict:
        """Poll an async answer by rid until it is done or ``wait_s``
        passed."""
        deadline = time.monotonic() + wait_s
        while True:
            resp = protocol.request(addr[0], addr[1],
                                    {"cmd": "infer_result", "rid": rid},
                                    timeout=5.0)
            if resp.get("done"):
                return resp
            if time.monotonic() >= deadline:
                raise TimeoutError(f"infer_result {rid!r} not done "
                                   f"after {wait_s}s")
            time.sleep(0.005)

    def stats(self, addr: Tuple[str, int]) -> dict:
        """One gateway's ``serve_stats`` view."""
        return protocol.request(addr[0], addr[1],
                                {"cmd": "serve_stats"}, timeout=5.0)
