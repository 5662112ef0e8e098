"""Range server: one shard of the key-range-partitioned data plane
(counterpart of ``dt_tpu/elastic/range_server.py``, copied since the port
imports nothing of the JAX package).

The reference splits every big key across all R servers, so push and pull
bandwidth grow with the fleet (``src/kvstore/kvstore_dist.h:547-589``
``EncodeDefaultKey``; ``kvstore_dist_server.h`` holds each range's master
weights and updater).  A ``RangeServer`` serves a
:class:`~dt_tpu_torch.elastic.dataplane.DataPlane` for its slice of every
tensor; the slicing is the client's (``WorkerClient``): dense tensors in R
row ranges, sparse pushes by row id, 2-bit and dense chunks round-robin.
It speaks the JAX package's wire, so either package's workers and
scheduler may use it.

Control stays with the scheduler: the server registers
(``register_server``) and mirrors the live workers with a short-TTL cache,
refreshed at once when an unknown host contributes (a joiner) and right
before a round completes, and by a poll that completes the rounds the
survivors satisfy when a worker leaves.  The server count is fixed at
launch (the reference's ``DMLC_NUM_SERVER``).

The ``stats`` answer carries this shard's straggler board (``straggler``,
the round-lag EWMAs; stamped with ``DT_OBS`` on): every shard sees the same
workers, so the shards' scores agree up to per-round noise.

    python -m dt_tpu_torch.elastic.range_server --scheduler-host H \\
        --scheduler-port P --index I
"""

from __future__ import annotations

import logging
import os
import random
import socket
import threading
import time
from typing import List, Optional, Set

from dt_tpu_torch import config
from dt_tpu_torch.elastic import faults, protocol
from dt_tpu_torch.elastic.dataplane import DataPlane
from dt_tpu_torch.obs import trace as obs_trace

logger = logging.getLogger("dt_tpu_torch.elastic")
_drop_rng = random.Random(0x5EED)  # DT_DROP_MSG, seeded as the JAX one

#: responses not kept in the token cache: read-only commands, or ones with
#: their own (host, seq) dedup (the JAX range server's ``_TOKEN_EXEMPT``)
_TOKEN_EXEMPT = frozenset((
    "allreduce", "async_init", "async_pull_rows", "async_push",
    "async_stats", "ping", "stats"))


class RangeServer:
    def __init__(self, scheduler_host: str, scheduler_port: int,
                 index: int, port: int = 0,
                 advertise_host: Optional[str] = None,
                 membership_ttl_s: float = 1.0,
                 poll_interval_s: float = 1.0):
        self.index = int(index)
        self.sched_addr = (scheduler_host, int(scheduler_port))
        self._members: List[str] = []  # guarded-by: _members_lock
        self._members_ts = 0.0  # guarded-by: _members_lock
        self._members_lock = threading.Lock()
        self._ttl = membership_ttl_s
        self._obs = obs_trace.Tracer(name=f"range-server-{self.index}")
        self._dp = DataPlane(expected_fn=self._expected,
                             confirm_fn=self._refresh_members,
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
        # register, so workers find this shard
        host = advertise_host or protocol.advertise_host()
        resp = protocol.request(scheduler_host, int(scheduler_port),
                                {"cmd": "register_server",
                                 "index": self.index, "host": host,
                                 "port": self.port})
        if "error" in resp:
            self.close()
            raise RuntimeError(f"range server {self.index}: register "
                               f"refused: {resp['error']}")
        self._poll_thread = threading.Thread(
            target=self._poll_loop, args=(poll_interval_s,), daemon=True)
        self._poll_thread.start()
        logger.info("range server %d listening on :%d", self.index,
                    self.port)

    # -- the membership mirror -------------------------------------------

    def _refresh_members(self) -> List[str]:
        try:
            resp = protocol.request(self.sched_addr[0], self.sched_addr[1],
                                    {"cmd": "membership"}, timeout=10)
            with self._members_lock:
                self._members = list(resp["workers"])
                self._members_ts = time.time()
        except (OSError, KeyError):
            pass  # the scheduler briefly unreachable: the cached view
        with self._members_lock:
            return list(self._members)

    def _expected(self) -> List[str]:
        with self._members_lock:
            if time.time() - self._members_ts < self._ttl:
                return list(self._members)
        return self._refresh_members()

    def _poll_loop(self, interval: float):
        known: Set[str] = set()
        while not self._stop.wait(interval):
            live = set(self._refresh_members())
            if not live:
                continue
            removed = known - live
            if removed:
                self._dp.hosts_removed(removed)
            known = set(live)
            # every tick: a removal an inline refresh absorbed into the
            # cache between polls would be missed by a shrink comparison
            self._dp.complete_with(live, ordered=sorted(live))

    # -- serving ---------------------------------------------------------

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
        try:
            protocol.serve_connection(conn, self._handle_one)
        finally:
            with self._conns_lock:
                self._conns.discard(conn)

    def _handle_one(self, msg: dict) -> Optional[dict]:
        return protocol.traced_handle(self._obs, msg, self._handle_inner)

    def _handle_inner(self, msg: dict) -> Optional[dict]:
        """One request on a persistent connection (``None`` drops it, an
        injected receive-side fault: the client retries)."""
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
                return None
            logger.exception("range server %d handler error", self.index)
            return {"error": repr(e)}
        if token is not None and "error" not in resp and \
                msg.get("cmd") not in _TOKEN_EXEMPT:
            self._tokens.put(token, resp)
        return resp

    def _dispatch(self, msg: dict) -> dict:
        cmd = msg.get("cmd")
        host = msg.get("host")
        if host is not None:
            with self._members_lock:
                known = host in self._members
            if not known:
                # a just-joined worker: refresh, so its round waits for it
                # (no dedup purge here; sequence resets are host_reset's)
                self._refresh_members()
        if cmd == "host_reset":
            # a (re)registered worker starts fresh sequences
            self._dp.host_registered(msg["host"])
            return {}
        if cmd in DataPlane.CMDS:
            val = msg.get("value")
            size = 0
            if hasattr(val, "nbytes"):
                size = int(val.nbytes)
            elif isinstance(val, dict):
                size = sum(int(v.nbytes) for v in val.values()
                           if hasattr(v, "nbytes"))
            self._obs.counter("data.bytes_in", size)
            self._obs.counter("data.requests")
            out = self._dp.dispatch(msg)
            if out is not None:
                return out
        if cmd == "ping":
            return {"index": self.index}
        if cmd == "stats":
            with self._dp._async_lock:
                keys = len(self._dp._async_store)
                stored = sum(int(v.nbytes)
                             for v in self._dp._async_store.values())
            return {"index": self.index, "async_keys": keys,
                    "async_bytes": stored,
                    "data_bytes_in": self._obs.get_counter("data.bytes_in"),
                    "data_requests": self._obs.get_counter("data.requests"),
                    "bucket_rounds": self._obs.get_counter(
                        "dataplane.bucket_rounds"),
                    "straggler": self._dp.straggler_scores()}
        if cmd == "shutdown":
            self.close()
            return {}
        return {"error": f"unknown cmd {cmd!r} (range server)"}

    def close(self):
        """Stop serving (idempotent): stop accepting, sever the accepted
        connections, join the owned threads with a timeout."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self._stop.set()
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
        for t in (self._thread, getattr(self, "_poll_thread", None)):
            if t is not None and t is not me and t.is_alive():
                t.join(timeout=5.0)


def main(argv=None) -> int:
    """The process entry, with the launcher's env contract
    (``DMLC_PS_ROOT_URI``/``DMLC_PS_ROOT_PORT``, ``DT_SERVER_ID``) as the
    defaults; it serves until SIGTERM or a ``shutdown`` command."""
    import argparse
    import signal
    ap = argparse.ArgumentParser(
        description="dt_tpu_torch range server process")
    ap.add_argument("--scheduler-host",
                    default=os.environ.get("DMLC_PS_ROOT_URI", "127.0.0.1"))
    ap.add_argument("--scheduler-port", type=int,
                    default=int(os.environ.get("DMLC_PS_ROOT_PORT", "0")))
    ap.add_argument("--index", type=int,
                    default=int(config.env("DT_SERVER_ID")))
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--advertise-host", default=None)
    args = ap.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s rs[%(process)d] %(levelname)s %(message)s")
    srv = RangeServer(args.scheduler_host, args.scheduler_port, args.index,
                      port=args.port, advertise_host=args.advertise_host)

    def _term(signum, frame):
        del signum, frame
        srv._stop.set()

    try:
        signal.signal(signal.SIGTERM, _term)
    except (ValueError, OSError):
        pass
    try:
        while not srv._stop.wait(1.0):
            pass
    except KeyboardInterrupt:
        pass
    srv.close()
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
