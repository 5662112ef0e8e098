"""Wire protocol of the elastic control plane (counterpart of
``dt_tpu/elastic/protocol.py:104-753``, copied since the port imports
nothing of the JAX package).  It puts the same bytes on the wire as the
JAX package's in both directions, so port workers, JAX workers and either
package's scheduler share one job.

Length-prefixed pickled dicts over TCP (the role of ps-lite's protobuf
``Meta`` + zero-copy SArrays):

- persistent pooled channels (:class:`ChannelPool`): :func:`request` draws
  a socket per ``(host, port)`` and returns it after the response; a stale
  channel found on acquire, or one that dies under the send, is retried
  once on a fresh connection, and any later failure goes to the caller's
  at-least-once retry loop, where idempotency tokens (:class:`TokenCache`)
  and the per-command ``(host, seq)`` dedup make the replay safe;
- zero-copy framing: pickle protocol 5 lifts buffers of 1 KiB and more out
  of band, the frame goes out by vectored ``sendmsg`` over the original
  buffers, and the receiver reads the payload into one buffer the
  unpickled arrays alias; frames with every buffer in-band (the JAX
  package's ``DT_WIRE_INBAND=1``) decode too;
- authenticated frames under ``DT_ELASTIC_SECRET``: ``b"DTH1" | len |
  hmac(tag|len) | payload | hmac(tag|len|payload)`` (``DTH2`` with
  out-of-band buffers, ``DTZ1`` for those without a secret).

Every payload is numpy or plain Python, never a ``torch.Tensor``: the JAX
package's processes unpickle what the port sends.
"""

from __future__ import annotations

import collections
import hashlib
import hmac as _hmac
import os
import pickle
import random
import socket
import struct
import threading
import time
import uuid
from typing import Any, Dict, Optional

import numpy as np

from dt_tpu_torch import config
from dt_tpu_torch.elastic import faults
from dt_tpu_torch.obs import trace as obs_trace

_LEN = struct.Struct("<Q")
_U32 = struct.Struct("<I")
MAX_MSG = 1 << 33  # snapshots can be GBs in theory; sanity bound
_MAC_SIZE = hashlib.sha256().digest_size
_AUTH_TAG = b"DTH1"       # authenticated, in-band pickle payload
_AUTH_TAG_OOB = b"DTH2"   # authenticated, out-of-band buffer payload
_OOB_TAG = b"DTZ1"        # legacy-insecure, out-of-band buffer payload
_OOB_MIN = 1 << 10        # buffers below 1 KiB ride in-band
_MAX_BUFS = 1 << 16       # sanity bound on out-of-band buffer count
_SENDMSG_MAX_SEGS = 64    # stay well under IOV_MAX


def _tune_sock(sock: socket.socket) -> None:
    """Data-plane socket tuning: NODELAY (length-prefixed request/
    response must not sit in Nagle), and socket buffers sized for
    gradient chunks (``DT_WIRE_SOCKBUF``, default 4 MiB — measured 2.3x
    loopback round-trip throughput over the ~200 KiB default, which
    ping-pongs a 4 MiB chunk through a dozen buffer drains)."""
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass
    buf = int(config.env("DT_WIRE_SOCKBUF"))
    if buf > 0:
        for opt in (socket.SO_SNDBUF, socket.SO_RCVBUF):
            try:
                sock.setsockopt(socket.SOL_SOCKET, opt, buf)
            except OSError:
                pass


_SECRET_OVERRIDE: Optional[str] = None


def set_secret(secret: Optional[str]) -> None:
    """Process-local secret that takes precedence over
    ``DT_ELASTIC_SECRET`` (``protocol.py:123-137``).  The launcher hands
    its in-process scheduler the job's generated secret this way, so the
    secret never enters ``os.environ``, which every later subprocess of
    the host program would inherit."""
    global _SECRET_OVERRIDE
    _SECRET_OVERRIDE = secret or None


def _secret() -> Optional[bytes]:
    if _SECRET_OVERRIDE:
        return _SECRET_OVERRIDE.encode()
    s = config.env("DT_ELASTIC_SECRET")
    return s.encode() if s else None


def bind_interface() -> str:
    """Interface the scheduler listens on (``DT_ELASTIC_BIND``)."""
    return config.env("DT_ELASTIC_BIND")


def advertise_host() -> str:
    """The address peers dial to reach a server bound on this machine
    (``DT_ELASTIC_ADVERTISE``; else the bind interface when it is a
    concrete address, else the hostname: ps-lite's ``DMLC_NODE_HOST``)."""
    adv = config.env("DT_ELASTIC_ADVERTISE")
    if adv:
        return adv
    bind = bind_interface()
    if bind not in ("0.0.0.0", "::"):
        return bind
    return socket.gethostname()


def _mac(key: bytes, *parts: bytes) -> bytes:
    m = _hmac.new(key, digestmod=hashlib.sha256)
    for p in parts:
        m.update(p)
    return m.digest()


def _encode(msg: Dict[str, Any]):
    """Pickle ``msg`` -> (pickle_bytes, [out-of-band buffer, ...]).

    Large contiguous buffers (numpy array data) are lifted OUT of the
    pickle stream via protocol 5's ``buffer_callback`` — the sender
    writes them straight from the original array memory (no serialized
    copy), the ps-lite zero-copy SArray property."""
    bufs = []

    def keep_inband(pb: pickle.PickleBuffer) -> bool:
        try:
            raw = pb.raw()
        except BufferError:  # non-contiguous: let pickle copy it in-band
            return True
        if raw.nbytes < _OOB_MIN:
            return True
        bufs.append(raw)
        return False  # falsy = serialize out-of-band

    data = pickle.dumps(msg, protocol=5, buffer_callback=keep_inband)
    return data, bufs


def send_msg(sock: socket.socket, msg: Dict[str, Any]) -> None:
    data, bufs = _encode(msg)
    key = _secret()
    if not bufs:
        # in-band frame: the historical wire format, byte-for-byte.
        # One pathological exception: an insecure legacy frame whose
        # u64 length happens to START with the OOB tag bytes (length
        # % 2^32 == little-endian "DTZ1") would be misparsed as an
        # out-of-band frame — THAT one falls through and ships as a
        # zero-buffer OOB frame, which is unambiguous by construction.
        if key is not None:
            hdr = _AUTH_TAG + _LEN.pack(len(data))
            _send_segments(sock, [hdr, _mac(key, hdr), data,
                                  _mac(key, hdr, data)])
            return
        if _LEN.pack(len(data))[:len(_OOB_TAG)] != _OOB_TAG:
            _send_segments(sock, [_LEN.pack(len(data)), data])
            return
    sub = (_U32.pack(len(data)) + _U32.pack(len(bufs))
           + b"".join(_LEN.pack(b.nbytes) for b in bufs))
    total = len(sub) + len(data) + sum(b.nbytes for b in bufs)
    if key is not None:
        hdr = _AUTH_TAG_OOB + _LEN.pack(total)
        # payload MAC streams over the vectored segments — never a join
        _send_segments(sock, [hdr, _mac(key, hdr), sub, data, *bufs,
                              _mac(key, hdr, sub, data, *bufs)])
    else:
        _send_segments(sock, [_OOB_TAG, _LEN.pack(total), sub, data,
                              *bufs])


def _send_segments(sock: socket.socket, segments) -> None:
    """Vectored ``sendmsg`` of a segment list (bytes / memoryviews)
    without concatenating — partial sends advance through the vector."""
    segs = [memoryview(s).cast("B") for s in segments if len(s)]
    if obs_trace.enabled():  # wire byte meter (single funnel for all frames)
        obs_trace.tracer().counter("wire.bytes_sent",
                                   sum(s.nbytes for s in segs))
    while segs:
        sent = sock.sendmsg(segs[:_SENDMSG_MAX_SEGS])
        i = 0
        while i < len(segs) and sent >= segs[i].nbytes:
            sent -= segs[i].nbytes
            i += 1
        segs = segs[i:]
        if segs and sent:
            segs[0] = segs[0][sent:]


def recv_msg(sock: socket.socket) -> Dict[str, Any]:
    key = _secret()
    if key is not None:
        hdr = _recv_exact(sock, len(_AUTH_TAG) + _LEN.size)
        tag = hdr[:len(_AUTH_TAG)]
        if tag not in (_AUTH_TAG, _AUTH_TAG_OOB):
            raise IOError("unauthenticated frame on authenticated channel "
                          "(peer missing DT_ELASTIC_SECRET?)")
        # header MAC gates BEFORE the body is buffered: an attacker cannot
        # make the receiver allocate length bytes without the key
        if not _hmac.compare_digest(_recv_exact(sock, _MAC_SIZE),
                                    _mac(key, hdr)):
            raise IOError("frame header HMAC verification failed")
        (length,) = _LEN.unpack(hdr[len(_AUTH_TAG):])
        if length > MAX_MSG:
            raise IOError(f"message too large: {length}")
        payload = _recv_into(sock, length)
        if not _hmac.compare_digest(_recv_exact(sock, _MAC_SIZE),
                                    _mac(key, hdr, payload)):
            raise IOError("frame payload HMAC verification failed")
        if tag == _AUTH_TAG:
            return pickle.loads(payload)
        return _decode_oob(memoryview(payload))
    first = _recv_exact(sock, _LEN.size)
    if first[:len(_OOB_TAG)] == _OOB_TAG:
        # out-of-band frame: tag(4) | u64 len | payload.  A legacy
        # receiver reads the tag bytes as an absurd length and rejects
        # oversize — mixed versions fail loudly, like mixed auth modes.
        rest = _recv_exact(sock, _LEN.size - len(_OOB_TAG))
        (length,) = _LEN.unpack(first[len(_OOB_TAG):] + rest)
        if length > MAX_MSG:
            raise IOError(f"message too large: {length}")
        return _decode_oob(memoryview(_recv_into(sock, length)))
    (length,) = _LEN.unpack(first)
    if length > MAX_MSG:
        raise IOError(f"message too large: {length}")
    return pickle.loads(_recv_into(sock, length))


def _decode_oob(mv: memoryview) -> Dict[str, Any]:
    """Parse ``u32 npickle | u32 nbufs | u64 sizes | pickle | buffers``
    out of one contiguous payload; the unpickled arrays ALIAS the
    receive buffer (writable bytearray) — no per-buffer copy."""
    if mv.nbytes < 2 * _U32.size:
        raise IOError("truncated out-of-band frame header")
    npick = _U32.unpack_from(mv, 0)[0]
    nbufs = _U32.unpack_from(mv, _U32.size)[0]
    if nbufs > _MAX_BUFS:
        raise IOError(f"too many out-of-band buffers: {nbufs}")
    off = 2 * _U32.size + nbufs * _LEN.size
    if off > mv.nbytes:
        raise IOError("truncated out-of-band frame header")
    sizes = struct.unpack_from(f"<{nbufs}Q", mv, 2 * _U32.size)
    data = mv[off:off + npick]
    if data.nbytes != npick:
        raise IOError("truncated out-of-band frame pickle")
    bufs = []
    pos = off + npick
    for s in sizes:
        b = mv[pos:pos + s]
        if b.nbytes != s:
            raise IOError("truncated out-of-band buffer")
        bufs.append(b)
        pos += s
    if pos != mv.nbytes:
        raise IOError("out-of-band frame length mismatch")
    return pickle.loads(data, buffers=bufs)


_UNINIT_MIN = 1 << 16  # past this, skip bytearray's zero-fill pass


def _recv_into(sock: socket.socket, n: int):
    """Receive exactly ``n`` bytes into ONE preallocated buffer (no
    chunk-list concatenation copy; out-of-band arrays alias it).  Large
    buffers come from ``numpy.empty`` — uninitialized, so the recv
    doesn't pay a zero-fill memset pass over memory it fully
    overwrites."""
    if obs_trace.enabled():
        obs_trace.tracer().counter("wire.bytes_recv", n)
    if n >= _UNINIT_MIN:
        buf = memoryview(np.empty(n, np.uint8)).cast("B")
    else:
        buf = memoryview(bytearray(n))
    got = 0
    while got < n:
        r = sock.recv_into(buf[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed")
        got += r
    return buf.obj if n < _UNINIT_MIN else buf


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    return bytes(_recv_into(sock, n))


# ---------------------------------------------------------------------------
# persistent channel pool (client side)
# ---------------------------------------------------------------------------


class ChannelPool:
    """Per-``(host, port)`` pool of long-lived request/response sockets —
    ps-lite's persistent Van connections (``van.cc:95-185``) instead of a
    TCP handshake per message.  ``acquire`` hands a thread EXCLUSIVE use
    of a channel (concurrent requests each get their own), ``release``
    returns it for reuse.  Idle channels are probed on acquire (a peer
    that closed shows EOF/RST on a nonblocking peek) and dropped;
    idle-list caps bound fd usage across many endpoints (tests churn
    through schedulers).  Fork-safe: a child process inherits the
    parent's fds but never uses them — the pool resets on pid change."""

    def __init__(self, max_idle_per_addr: int = 8,
                 max_idle_total: int = 64):
        self._lock = threading.Lock()
        self._idle: Dict[tuple, list] = {}  # guarded-by: _lock
        self._order: list = []  # addr LRU for the global idle cap; guarded-by: _lock
        self._max_per = max_idle_per_addr
        self._max_total = max_idle_total
        self._pid = os.getpid()  # guarded-by: _lock
        self.connects = 0  # guarded-by: _lock
        self.reuses = 0  # guarded-by: _lock

    def _reset_if_forked_locked(self) -> None:
        if os.getpid() != self._pid:
            self._idle = {}
            self._order = []
            self._pid = os.getpid()

    @staticmethod
    def _alive(sock: socket.socket) -> bool:
        try:
            sock.setblocking(False)
            try:
                sock.recv(1, socket.MSG_PEEK)
                return False  # EOF (b"") or stray bytes: unusable
            except (BlockingIOError, InterruptedError):
                return True
            finally:
                sock.setblocking(True)
        except OSError:
            return False

    def acquire(self, addr: tuple, timeout: float,
                fresh: bool = False):
        """-> (socket, reused).  ``fresh=True`` skips the idle list (the
        transparent stale-channel retry must not draw another stale
        one)."""
        if not fresh:
            with self._lock:
                self._reset_if_forked_locked()
                lst = self._idle.get(addr)
                while lst:
                    sock = lst.pop()
                    if self._alive(sock):
                        self.reuses += 1
                        return sock, True
                    _close_quietly(sock)
        sock = socket.create_connection(addr, timeout=timeout)
        _tune_sock(sock)
        with self._lock:
            self.connects += 1
        return sock, False

    def release(self, addr: tuple, sock: socket.socket) -> None:
        with self._lock:
            self._reset_if_forked_locked()
            lst = self._idle.setdefault(addr, [])
            lst.append(sock)
            if addr in self._order:
                self._order.remove(addr)
            self._order.append(addr)
            evict = []
            if len(lst) > self._max_per:
                evict.append(lst.pop(0))
            while sum(len(v) for v in self._idle.values()) > \
                    self._max_total and self._order:
                old = self._order[0]
                olst = self._idle.get(old, [])
                if olst:
                    evict.append(olst.pop(0))
                if not olst:
                    self._idle.pop(old, None)
                    self._order.remove(old)
        for s in evict:
            _close_quietly(s)

    def discard(self, sock: socket.socket) -> None:
        _close_quietly(sock)

    def close_addr(self, addr: tuple) -> None:
        """Drop every idle channel to ``addr`` (client shutdown hygiene:
        the server's per-connection thread sees EOF and exits)."""
        with self._lock:
            lst = self._idle.pop(addr, [])
            if addr in self._order:
                self._order.remove(addr)
        for s in lst:
            _close_quietly(s)

    def close_all(self) -> None:
        with self._lock:
            lists, self._idle, self._order = self._idle, {}, []
        for lst in lists.values():
            for s in lst:
                _close_quietly(s)


def _close_quietly(sock: socket.socket) -> None:
    try:
        sock.close()
    except OSError:
        pass


_POOL = ChannelPool()


def pool() -> ChannelPool:
    """The process-wide client channel pool."""
    return _POOL


def _request_once(host: str, port: int, msg: Dict[str, Any],
                  timeout: float, reset: bool = False) -> Dict[str, Any]:
    # wire span: one record per attempt (cmd + whether the channel was a
    # pooled reuse or a fresh connect); byte meters live in the framing.
    # The obs export channel itself is exempt: an obs_push's own span
    # would re-fill the very ring the flush is draining (the flush loop
    # would never see an empty payload and always run to its bound).
    # When tracing is on the attempt also CARRIES its trace context —
    # "_tc": (origin track, this attempt's pre-allocated span id) — so
    # the server opens a handler span linked to this exact wire.request
    # record (the export joins the two with chrome flow events).  The
    # disabled path builds neither: begin() returns None without
    # allocating, and the message ships byte-identical to r9.  (With
    # only the r16 blackbox open-span hook armed, begin() returns an
    # open-table-only token — the attempt shows in a crash bundle — but
    # no trace context rides the wire: the message still ships
    # byte-identical.)
    tr = obs_trace.tracer()
    t0 = tr.begin("wire.request", {"cmd": msg.get("cmd")}) \
        if msg.get("cmd") != "obs_push" else None
    if t0 is not None and tr.on():
        msg = dict(msg)
        msg["_tc"] = (obs_trace.origin(), t0[2])
    try:
        addr = (host, port)
        sock, reused = _POOL.acquire(addr, timeout)
        try:
            sock.settimeout(timeout)
            send_msg(sock, msg)
        except Exception as e:
            _POOL.discard(sock)
            if not (reused and isinstance(e, OSError)):
                raise
            # the pooled channel died under the SEND: the request cannot
            # have been dispatched, so one transparent retry on a fresh
            # connection is safe (no replay window opens)
            sock, reused = _POOL.acquire(addr, timeout, fresh=True)
            try:
                sock.settimeout(timeout)
                send_msg(sock, msg)
            except Exception:
                _POOL.discard(sock)
                raise
        if reset:
            # injected fault: the request was DELIVERED but the
            # connection dies before the response — the replay window
            # only idempotency closes.  The channel is destroyed, NOT
            # returned to the pool (the server's pending response would
            # desync the next request on it).
            _POOL.discard(sock)
            raise ConnectionResetError(
                "fault injection: connection reset after send")
        try:
            resp = recv_msg(sock)
        except Exception:
            # response-phase failure: the server may have acted — never
            # transparently retried; the reliable-mode loop + idempotency
            # tokens own this window
            _POOL.discard(sock)
            raise
    except BaseException:
        # no span is recorded for a failed attempt (the r13 symmetry the
        # causal check counts on) — but the open-table entry must go, or
        # a later blackbox bundle would show phantom in-flight requests
        obs_trace.tracer().abandon(t0)
        raise
    _POOL.release(addr, sock)
    obs_trace.tracer().complete_span(
        "wire.request", t0, {"cmd": msg.get("cmd"), "reused": reused})
    return resp


def traced_handle(tracer, msg: Dict[str, Any], inner):
    """Serve one request through ``inner(msg)`` with the r13 causal-
    tracing wrapper shared by the scheduler and the range server: a
    request carrying trace context (``"_tc"``, attached by
    :func:`_request_once` when the CLIENT traces) gets a server-side
    handler span ``rpc.<cmd>`` on ``tracer`` whose ``link`` attr names
    the exact client track+span it serves — recorded only when a
    response is actually returned, so fault-injected drops stay
    symmetric (the client records no wire.request span for a failed
    attempt either) and the chaos causal-integrity check can count on
    the 1:1 pairing.  Data-plane server timing shipped up via the
    response's transient ``_srv`` key (round wait + last contributor,
    ``dataplane.allreduce``) folds into the span's attrs and is
    stripped from the wire response."""
    tc = msg.get("_tc") if tracer.on() else None
    t0 = tracer.begin(f"rpc.{msg.get('cmd')}") if tc is not None else None
    try:
        resp = inner(msg)
    except BaseException:
        # a raising handler records no span — drop the open-table entry
        # so a later blackbox bundle doesn't show phantom in-flight work
        tracer.abandon(t0)
        raise
    srv = resp.pop("_srv", None) if isinstance(resp, dict) else None
    if resp is None or t0 is None:
        tracer.abandon(t0)  # dropped response: no span, no open entry
        return resp
    attrs = {"cmd": msg.get("cmd"), "link": list(tc)}
    if isinstance(srv, dict):
        attrs.update(srv)
    tracer.complete_span(f"rpc.{msg.get('cmd')}", t0, attrs)
    return resp


def serve_connection(conn: socket.socket, handle_one) -> None:
    """Server side of the pooled transport: serve request/response frames
    over ONE persistent connection until the peer closes it (the
    scheduler/range-server accept loops pass each accepted socket here —
    many requests per connection, the ps-lite Van contract).

    ``handle_one(msg) -> resp dict | None``; ``None`` closes the
    connection without answering — receive-side fault injection (drop /
    partition): the client sees EOF and its retry loop recovers, exactly
    the semantics the per-request transport had."""
    with conn:
        _tune_sock(conn)
        while True:
            try:
                msg = recv_msg(conn)
            except Exception:
                # peer closed, a frame-layer reject, or an unpicklable
                # payload: the stream cannot be trusted past this point
                return
            resp = handle_one(msg)
            if resp is None:
                return
            try:
                send_msg(conn, resp)
            except (ConnectionError, OSError):
                return


def request(host: str, port: int, msg: Dict[str, Any],
            timeout: float = 120.0, retries: int = 0,
            backoff_s: float = 0.2, backoff_max_s: float = 5.0,
            deadline_s: Optional[float] = None) -> Dict[str, Any]:
    """Request/response over a pooled persistent channel
    (:class:`ChannelPool`).  With the defaults this is the historical
    one-shot call (every control message is independent, like ps-lite's
    per-request Customer tracking); only the transport changed — a
    channel is acquired per request, not a connection.

    ``retries`` > 0 (extra attempts) or ``deadline_s`` (overall wall
    budget; with ``retries=0`` it means retry-until-deadline) turn it
    into an at-least-once reliable call — the ``ps-lite/src/resender.h``
    role: exponential backoff between attempts, and every re-send
    carries the SAME ``token`` (idempotency key) so a receiver that
    already served the request answers from its token cache instead of
    dispatching a replay.  Combined with the per-command sequence dedup
    in the data plane this makes duplicated/replayed control messages
    safe.

    Fault injection (:mod:`dt_tpu_torch.elastic.faults`) hooks each attempt:
    drops/resets surface as the connection errors the retry loop already
    handles, so an installed plan exercises exactly this machinery.
    """
    reliable = retries > 0 or deadline_s is not None
    if reliable and isinstance(msg, dict) and "token" not in msg:
        msg = dict(msg)
        msg["token"] = uuid.uuid4().hex
    if deadline_s is not None and retries == 0:
        retries = 1 << 30  # deadline is the budget, not the attempt count
    cmd = msg.get("cmd") if isinstance(msg, dict) else None
    src = msg.get("host") if isinstance(msg, dict) else None
    deadline = (time.monotonic() + deadline_s) \
        if deadline_s is not None else None
    delay = backoff_s
    attempt = 0
    while True:
        try:
            fault = None
            plan = faults.active_plan()
            if plan is not None:
                fault = plan.on_send(cmd, src)
                if fault == "drop":
                    raise ConnectionError(
                        f"fault injection: dropped {cmd!r} from {src!r}")
            step_timeout = timeout
            if deadline is not None:
                step_timeout = min(
                    timeout, max(deadline - time.monotonic(), 0.001))
            resp = _request_once(host, port, msg, step_timeout,
                                 reset=(fault == "reset"))
            if fault == "dup":
                try:  # replay the identical request; discard the answer
                    _request_once(host, port, msg, step_timeout)
                except OSError:
                    pass
            return resp
        except (ConnectionError, socket.timeout, OSError):
            attempt += 1
            past_deadline = deadline is not None and \
                time.monotonic() + delay >= deadline
            if attempt > retries or past_deadline:
                raise
            if obs_trace.enabled():
                tr = obs_trace.tracer()
                tr.counter("wire.retries")
                tr.event("wire.retry", {"cmd": cmd, "attempt": attempt,
                                        "backoff_s": delay})
            time.sleep(delay)
            delay = next_backoff(delay, backoff_s, backoff_max_s)


#: process-local jitter stream for retry backoff; NOT derived from the
#: fault-plan seeds (retry pacing must stay jittered even in seeded
#: chaos runs — determinism there comes from idempotent replay, not
#: from identical sleep schedules)
_BACKOFF_RNG = random.Random()


def next_backoff(delay: float, base_s: float, cap_s: float,
                 rng: Optional[random.Random] = None) -> float:
    """Decorrelated-jitter backoff: the next sleep is drawn uniformly
    from ``[base, 3 * previous]`` and capped.  Plain exponential doubling
    synchronizes a fleet — after a scheduler failover every worker's
    retry clock starts at the same instant, and lockstep backoff slams
    the standby with coordinated retry waves (thundering herd); the
    decorrelated draw spreads the fleet across the window while keeping
    the same expected growth.  The cap bounds the DRAW RANGE rather than
    clamping the result — clamping would pile every saturated retry onto
    exactly ``cap_s`` and re-synchronize the herd at the cap.  ``rng`` is
    injectable for the spread test (tests/test_ha.py)."""
    r = rng if rng is not None else _BACKOFF_RNG
    return r.uniform(base_s, min(cap_s, max(delay * 3.0, base_s)))


class TokenCache:
    """Bounded response cache keyed by request idempotency token — the
    receiver side of :func:`request`'s at-least-once contract.  A re-sent
    request whose first dispatch completed is served the SAME response
    instead of being dispatched again (commands with their own
    seq-dedup or read-only semantics are exempted by the servers).

    Two bounds keep a job-lifetime scheduler's memory flat (r11): an LRU
    entry cap, and a TTL (``ttl_s``; ``DT_CTRL_TOKEN_TTL_S`` at the
    scheduler) — a retry only ever lands within its sender's backoff
    horizon, so entries older than the TTL can never be replayed to and
    are shed even when the cache is not full.  ``clock`` is injectable
    for the TTL tests."""

    def __init__(self, cap: int = 512, ttl_s: float = 300.0,
                 clock=time.monotonic):
        self._cap = cap
        self._ttl = float(ttl_s)
        self._clock = clock
        self._lock = threading.Lock()
        # token -> (stored_at, response), LRU order
        self._cache = collections.OrderedDict()  # guarded-by: _lock

    def __len__(self) -> int:
        with self._lock:
            return len(self._cache)

    def get(self, token: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            ent = self._cache.get(token)
            if ent is None:
                return None
            ts, resp = ent
            if self._ttl > 0 and self._clock() - ts > self._ttl:
                del self._cache[token]
                return None
            return resp

    def put(self, token: str, resp: Dict[str, Any]) -> None:
        with self._lock:
            now = self._clock()
            self._cache[token] = (now, resp)
            self._cache.move_to_end(token)
            # expired entries age out of the LRU end first (insertion
            # order == age order: entries are never refreshed in place)
            while self._cache and self._ttl > 0:
                tok, (ts, _) = next(iter(self._cache.items()))
                if now - ts > self._ttl:
                    del self._cache[tok]
                else:
                    break
            while len(self._cache) > self._cap:
                self._cache.popitem(last=False)
