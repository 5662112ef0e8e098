"""Spans, events and counters of one process (counterpart of
``dt_tpu/obs/trace.py``, copied since the port imports nothing of the JAX
package).

A thread-safe span / event / counter API over a bounded ring: the worker
client ships the ring to the scheduler on the heartbeat (``obs/export.py``
merges the job's tracks into one chrome://tracing timeline), and the
blackbox plane (``obs/blackbox.py``) reads the open-span table into its
bundles.

- Tracing is off unless ``DT_OBS=1`` or :func:`set_enabled`: a disabled
  ``span()`` returns a shared no-op and ``begin``/``now`` return
  ``None``.  Counters are live either way.
- At most ``DT_OBS_RING`` records are kept; past it the oldest is dropped
  and counted, never raising.
- Timestamps are wall-clock, durations monotonic; both, and the thread
  ident, are injectable for byte-deterministic tests.
- Nesting rides a per-tracer ``contextvars.ContextVar``: a span's record
  carries its parent's id, and an event attaches to the enclosing span.

Record schema, the JAX package's::

    ("X", rseq, name, ts_us, dur_us, tid, span_id, parent_id, attrs)  span
    ("i", rseq, name, ts_us, 0,      tid, event_id, parent_id, attrs) event

``rseq`` rises strictly in ring order: the heartbeat export's
at-least-once dedup key on the scheduler.
"""

from __future__ import annotations

import contextvars
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from dt_tpu_torch import config

# ---------------------------------------------------------------------------
# process-wide enable gate (DT_OBS, overridable in-process)
# ---------------------------------------------------------------------------

_ENABLED_OVERRIDE: Optional[bool] = None
_ENV_ENABLED: Optional[bool] = None


def enabled() -> bool:
    """Whether tracing is on for this process (``DT_OBS=1`` or an explicit
    :func:`set_enabled`).  One global-read + compare on the fast path."""
    if _ENABLED_OVERRIDE is not None:
        return _ENABLED_OVERRIDE
    global _ENV_ENABLED
    if _ENV_ENABLED is None:
        _ENV_ENABLED = config.env("DT_OBS").strip().lower() in ("1", "true")
    return _ENV_ENABLED


def set_enabled(on: Optional[bool]) -> None:
    """Process-local override (``None`` = follow the env var again) — the
    in-process analog of exporting ``DT_OBS`` to a subprocess worker."""
    global _ENABLED_OVERRIDE, _ENV_ENABLED
    _ENABLED_OVERRIDE = on
    if on is None:
        _ENV_ENABLED = None


# The r16 flight recorder (obs/blackbox.py) arms the OPEN-SPAN
# table alone even when tracing is off — a crash bundle's "died 40 s
# into allreduce" evidence must not require DT_OBS.  blackbox registers
# its (cached-bool) enabled() here at import; the hook indirection keeps
# this module free of the circular import.  With the hook armed, spans
# enter/leave the open table but record NOTHING in the ring.
_ARM_OPEN_HOOK: Callable[[], bool] = lambda: False


def set_open_span_arm(fn: Optional[Callable[[], bool]]) -> None:
    """Arm the open-span table independently of the trace gate (the
    blackbox plane's hook; ``None`` disarms)."""
    global _ARM_OPEN_HOOK
    _ARM_OPEN_HOOK = fn or (lambda: False)


# ---------------------------------------------------------------------------
# trace origin (r13 causal tracing): the track name this process's records
# will appear under in the merged job dump.  WorkerClient sets it to its
# "host#incarnation" track key at construction; everything else (the
# in-process scheduler, tools) defaults to the control-plane track —
# matching how Scheduler.obs_dump merges the process tracer.  The origin
# rides the wire as half of the trace context (protocol.request "_tc"),
# so a server-side handler span can name the exact client track+span it
# serves and the export can join the two with chrome flow events.
# ---------------------------------------------------------------------------

_ORIGIN: Optional[str] = None


def set_origin(origin: Optional[str]) -> None:
    """Name this process's trace track (``None`` = back to the default)."""
    global _ORIGIN
    _ORIGIN = origin or None


def origin() -> str:
    """This process's track name for cross-process trace context."""
    return _ORIGIN or "control-plane"


# ---------------------------------------------------------------------------
# flush hooks (crash-path export: a worker about to os._exit pushes its
# buffered records to the scheduler so injected crashes still appear on
# the job timeline — registered by WorkerClient)
# ---------------------------------------------------------------------------

_FLUSH_HOOKS: List[Callable[[], None]] = []
_FLUSH_LOCK = threading.Lock()


def register_flush(fn: Callable[[], None]) -> None:
    with _FLUSH_LOCK:
        if fn not in _FLUSH_HOOKS:
            _FLUSH_HOOKS.append(fn)


def unregister_flush(fn: Callable[[], None]) -> None:
    with _FLUSH_LOCK:
        if fn in _FLUSH_HOOKS:
            _FLUSH_HOOKS.remove(fn)


def flush() -> None:
    """Best-effort: run every registered flush hook (never raises — the
    caller may be half a millisecond from ``os._exit``)."""
    with _FLUSH_LOCK:
        hooks = list(_FLUSH_HOOKS)
    for fn in hooks:
        try:
            fn()
        except Exception:
            pass


class _NoopSpan:
    """Shared do-nothing context manager: the disabled fast path returns
    this singleton, so a skipped span allocates nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()

#: bound on the open-span table (leaked begin() tokens shed oldest-first)
_OPEN_MAX = 256


class _Span:
    """A live span; created only when the tracer is enabled."""

    __slots__ = ("_tr", "name", "attrs", "_t0w", "_t0m", "_sid", "_parent",
                 "_tok")

    def __init__(self, tr: "Tracer", name: str, attrs: Optional[dict]):
        self._tr = tr
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        tr = self._tr
        self._t0w = tr._wall()
        self._t0m = tr._mono()
        self._parent = tr._ctx.get()
        self._sid = tr._next_seq()
        self._tok = tr._ctx.set(self._sid)
        tr._open_add(self._sid, self.name, self._t0w, self._t0m,
                     self._parent, self.attrs)
        return self

    def __exit__(self, *exc):
        tr = self._tr
        tr._ctx.reset(self._tok)
        tr._open_pop(self._sid)
        if not tr.on():
            return False  # open-table-only mode (blackbox armed, DT_OBS=0)
        dur_us = max(tr._mono() - self._t0m, 0) // 1000
        tr._push(("X", None, self.name, self._t0w // 1000, dur_us,
                  tr._ident(), self._sid, self._parent,
                  self.attrs))
        return False


class Tracer:
    """One span/event/counter sink with a bounded ring buffer.

    The process has one default instance (:func:`tracer`); servers that
    aggregate (Scheduler, RangeServer) construct their own so their
    control-plane records and counters stay per-instance (tests churn
    through many servers in one process).
    """

    def __init__(self, name: str = "process",
                 capacity: Optional[int] = None,
                 wall_clock: Optional[Callable[[], int]] = None,
                 mono_clock: Optional[Callable[[], int]] = None,
                 enabled: Optional[bool] = None,
                 ident: Optional[Callable[[], int]] = None):
        """``enabled``: ``True``/``False`` pins this instance regardless of
        the process gate; ``None`` follows :func:`enabled`.  Clocks return
        integer nanoseconds; ``ident`` returns the recording thread's id
        (both injectable for deterministic tests — r16 blackbox bundles
        and their digest-named files must serialize byte-identically
        under pinned inputs)."""
        self.name = name
        self._cap = max(1, int(capacity if capacity is not None
                               else int(config.env("DT_OBS_RING"))))
        self._wall = wall_clock or time.time_ns
        self._mono = mono_clock or time.monotonic_ns
        self._ident = ident or threading.get_ident
        self._enabled = enabled
        self._lock = threading.Lock()
        self._records: deque = deque()  # guarded-by: _lock
        self._dropped = 0  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        self._counters: Dict[str, int] = {}  # guarded-by: _lock
        # live (entered-but-not-exited) spans, keyed by span id — the
        # r16 flight-recorder snapshot (blackbox bundles capture "what
        # was this process in the middle of" at death).  Bounded: a
        # begin() whose complete_span never runs (exception paths) must
        # not leak entries forever.
        self._open: Dict[int, dict] = {}  # guarded-by: _lock
        self._ctx: contextvars.ContextVar = contextvars.ContextVar(
            f"dt_obs_span_{id(self)}", default=None)

    # -- gate -------------------------------------------------------------

    def on(self) -> bool:
        return self._enabled if self._enabled is not None else enabled()

    # -- recording --------------------------------------------------------

    def _next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def _push(self, rec: tuple) -> None:
        """Append one record, assigning its ``rseq`` (strictly increasing
        in buffer order — the export dedup key); overflow drops the
        oldest record and counts it, never raises."""
        with self._lock:
            self._seq += 1
            rec = (rec[0], self._seq) + rec[2:]
            if len(self._records) >= self._cap:
                self._records.popleft()
                self._dropped += 1
            self._records.append(rec)

    def span(self, name: str, attrs: Optional[dict] = None):
        """Context manager recording a complete ("X") span on exit; the
        disabled path returns a shared no-op singleton.  With only the
        blackbox open-span hook armed, the span enters/leaves the open
        table (crash evidence) but records nothing."""
        if not self.on() and not _ARM_OPEN_HOOK():
            return _NOOP_SPAN
        return _Span(self, name, attrs)

    def now(self) -> Optional[Tuple[int, int]]:
        """(wall_ns, mono_ns) start token for :meth:`complete_span`, or
        ``None`` when tracing is off — lets call sites thread a span
        through code that can't be re-indented under a ``with``."""
        if not self.on():
            return None
        return (self._wall(), self._mono())

    def begin(self, name: Optional[str] = None,
              attrs: Optional[dict] = None) -> Optional[Tuple[int, int,
                                                              int]]:
        """Like :meth:`now`, but also pre-allocates the span's id —
        ``(wall_ns, mono_ns, span_id)`` — so the id can be propagated
        (e.g. over the wire as trace context) BEFORE the span completes.
        ``None`` when tracing is off: the disabled path allocates
        nothing, exactly like :meth:`now`.

        With ``name``, the in-flight span is additionally registered in
        the open-span table until its :meth:`complete_span` — the r16
        flight-recorder snapshot (:meth:`open_spans`): a crash bundle
        can then say "this process died 40 s into ``allreduce``", which
        the completed-record ring by definition cannot.

        With tracing off but the blackbox open-span hook armed, a NAMED
        begin still registers (and returns a token so its
        :meth:`complete_span` pops it) — open-table only, no record;
        callers gating extra work on the token (e.g. the wire trace
        context) must also check :meth:`on`."""
        if not self.on():
            if name is None or not _ARM_OPEN_HOOK():
                return None
        t0w, t0m = self._wall(), self._mono()
        sid = self._next_seq()
        if name is not None:
            self._open_add(sid, name, t0w, t0m, self._ctx.get(), attrs)
        return (t0w, t0m, sid)

    def complete_span(self, name: str,
                      t0: Optional[Tuple[int, ...]],
                      attrs: Optional[dict] = None) -> None:
        """Record a span begun at ``t0`` (= :meth:`now` or
        :meth:`begin`); no-op on ``None`` (tracing was off when the span
        would have started).  A :meth:`begin` token's pre-allocated id
        becomes the record's ``span_id`` — the export's cross-process
        flow-join key."""
        if t0 is None:
            return
        if len(t0) > 2:
            self._open_pop(t0[2])
        if not self.on():
            return  # open-table-only token (blackbox armed, DT_OBS=0)
        dur_us = max(self._mono() - t0[1], 0) // 1000
        self._push(("X", None, name, t0[0] // 1000, dur_us,
                    self._ident(),
                    t0[2] if len(t0) > 2 else None,
                    self._ctx.get(), attrs))

    # -- open-span table (r16 flight recorder, obs/blackbox.py) ----

    def _open_add(self, sid: int, name: str, t0w: int, t0m: int,
                  parent: Optional[int],
                  attrs: Optional[dict]) -> None:
        with self._lock:
            if len(self._open) >= _OPEN_MAX:
                # a leaked begin() (its complete_span skipped by an
                # exception path) must not grow this forever; shed the
                # OLDEST entry — the newest opens are the death evidence
                self._open.pop(next(iter(self._open)))
            self._open[sid] = {"name": name, "ts_us": t0w // 1000,
                               "mono_ns": t0m,
                               "tid": self._ident(),
                               "parent": parent, "attrs": attrs}

    def _open_pop(self, sid: int) -> None:
        with self._lock:
            self._open.pop(sid, None)

    def abandon(self, t0: Optional[Tuple[int, ...]]) -> None:
        """Discard a named :meth:`begin` token without recording a span
        — failure paths that will never reach :meth:`complete_span`
        (e.g. a wire attempt that raised) drop their open-table entry
        here so a later bundle doesn't show phantom in-flight work."""
        if t0 is not None and len(t0) > 2:
            self._open_pop(t0[2])

    def open_spans(self) -> List[dict]:
        """Snapshot of the spans currently in flight — context-manager
        spans between ``__enter__``/``__exit__`` and named :meth:`begin`
        tokens whose :meth:`complete_span` has not run — ordered oldest
        first, each with its age on the monotonic clock.  This is the
        blackbox bundle's "open-span stack at death": nested spans
        reconstruct via ``parent``/``sid``, cross-thread ones via
        ``tid``."""
        now_m = self._mono()
        with self._lock:
            items = sorted(self._open.items(),
                           key=lambda kv: (kv[1]["mono_ns"], kv[0]))
        return [{"sid": sid, "name": e["name"], "ts_us": e["ts_us"],
                 "age_ms": round(max(now_m - e["mono_ns"], 0) / 1e6, 3),
                 "tid": e["tid"], "parent": e["parent"],
                 "attrs": e["attrs"]}
                for sid, e in items]

    def event(self, name: str, attrs: Optional[dict] = None) -> None:
        """Instant ("i") event, attached to the enclosing span if any."""
        if not self.on():
            return
        self._push(("i", None, name, self._wall() // 1000, 0,
                    self._ident(), None, self._ctx.get(), attrs))

    # -- counters (live even when tracing is off) -------------------------

    def counter(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def get_counter(self, name: str, default: int = 0) -> int:
        with self._lock:
            return self._counters.get(name, default)

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counters)

    def reset_counters(self) -> None:
        """Zero the live counters (tests: the process tracer is shared
        across a whole pytest session, so exact-count asserts must start
        from a clean slate whatever ran before — the r15 fix for the
        test-order dependency where obs tests failed after overlap/ha
        tests had already bumped ``allreduce.rounds`` etc.)."""
        with self._lock:
            self._counters.clear()

    # -- export -----------------------------------------------------------

    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def snapshot(self) -> Dict[str, Any]:
        """Non-destructive view: {name, records, counters, dropped}."""
        with self._lock:
            return {"name": self.name, "records": list(self._records),
                    "counters": dict(self._counters),
                    "dropped": self._dropped}

    def drain(self, max_records: Optional[int] = None) -> List[tuple]:
        """Remove and return up to ``max_records`` OLDEST records (the
        heartbeat flush takes bounded bites so one message stays small)."""
        with self._lock:
            if max_records is None or max_records >= len(self._records):
                out = list(self._records)
                self._records.clear()
            else:
                out = [self._records.popleft()
                       for _ in range(max_records)]
            return out


# ---------------------------------------------------------------------------
# process-default tracer
# ---------------------------------------------------------------------------

_DEFAULT: Optional[Tracer] = None
_DEFAULT_LOCK = threading.Lock()


def tracer() -> Tracer:
    """The process-wide default tracer (one worker process = one track)."""
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = Tracer(name="process")
    return _DEFAULT
