"""Spans, events and counters of one process (counterpart of
``dt_tpu/obs/trace.py:63-454``, copied since the port imports nothing of
the JAX package).

The control plane (``elastic.protocol``), the worker client and the overlap
engine record through this API.  Tracing is off unless ``DT_OBS=1`` or
:func:`set_enabled`: then ``begin``/``now`` return ``None`` and spans and
events retain nothing.  Counters are live either way.  Records stay in the
process: shipping them to the scheduler on the heartbeat is the obs plane,
ROADMAP Queue 1 item 7.

Record schema, as the JAX package's (spans do not nest here, so
``parent_id`` is ``None``)::

    ("X", rseq, name, ts_us, dur_us, tid, span_id, parent_id, attrs)  span
    ("i", rseq, name, ts_us, 0,      tid, event_id, parent_id, attrs) event
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from dt_tpu_torch import config

_ENABLED_OVERRIDE: Optional[bool] = None
_ENV_ENABLED: Optional[bool] = None


def enabled() -> bool:
    """Whether tracing is on in this process (``DT_OBS=1`` or
    :func:`set_enabled`)."""
    if _ENABLED_OVERRIDE is not None:
        return _ENABLED_OVERRIDE
    global _ENV_ENABLED
    if _ENV_ENABLED is None:
        _ENV_ENABLED = config.env("DT_OBS").strip().lower() in ("1", "true")
    return _ENV_ENABLED


def set_enabled(on: Optional[bool]) -> None:
    """Process-local override (``None`` follows the env var again)."""
    global _ENABLED_OVERRIDE, _ENV_ENABLED
    _ENABLED_OVERRIDE = on
    if on is None:
        _ENV_ENABLED = None


_ORIGIN: Optional[str] = None


def set_origin(origin: Optional[str]) -> None:
    """Name this process's trace track (``None``: the default); a worker
    client names it ``host#pid``, and it rides each traced request as
    half of its trace context."""
    global _ORIGIN
    _ORIGIN = origin or None


def origin() -> str:
    return _ORIGIN or "control-plane"


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
    """Run every registered flush hook; never raises (the caller may be
    about to ``os._exit``)."""
    with _FLUSH_LOCK:
        hooks = list(_FLUSH_HOOKS)
    for fn in hooks:
        try:
            fn()
        except Exception:
            pass


class Tracer:
    """One span/event/counter sink over a bounded ring of ``DT_OBS_RING``
    records: past it the oldest is dropped and counted, never raising.
    Timestamps are wall-clock, durations monotonic (nanoseconds)."""

    def __init__(self, name: str = "process"):
        self.name = name
        self._cap = max(1, int(config.env("DT_OBS_RING")))
        self._wall = time.time_ns
        self._mono = time.monotonic_ns
        self._ident = threading.get_ident
        self._lock = threading.Lock()
        self._records: deque = deque()  # guarded-by: _lock
        self._dropped = 0  # guarded-by: _lock
        self._seq = 0  # guarded-by: _lock
        self._counters: Dict[str, int] = {}  # guarded-by: _lock

    def on(self) -> bool:
        return enabled()

    def _next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def _push(self, rec: tuple) -> None:
        with self._lock:
            self._seq += 1
            rec = (rec[0], self._seq) + rec[2:]
            if len(self._records) >= self._cap:
                self._records.popleft()
                self._dropped += 1
            self._records.append(rec)

    def now(self) -> Optional[Tuple[int, int]]:
        """``(wall_ns, mono_ns)``, the start of a span for
        :meth:`complete_span`, or ``None`` when tracing is off."""
        if not self.on():
            return None
        return (self._wall(), self._mono())

    def begin(self, name: Optional[str] = None,
              attrs: Optional[dict] = None
              ) -> Optional[Tuple[int, int, int]]:
        """Like :meth:`now`, with the span's id allocated up front
        (``(wall_ns, mono_ns, span_id)``) so it can ride the wire before
        the span completes.  ``None`` when tracing is off."""
        del name, attrs  # the open-span table is the flight recorder's
        if not self.on():
            return None
        return (self._wall(), self._mono(), self._next_seq())

    def complete_span(self, name: str, t0: Optional[Tuple[int, ...]],
                      attrs: Optional[dict] = None) -> None:
        """Record a span begun at ``t0``; a no-op on ``None``."""
        if t0 is None or not self.on():
            return
        dur_us = max(self._mono() - t0[1], 0) // 1000
        self._push(("X", None, name, t0[0] // 1000, dur_us, self._ident(),
                    t0[2] if len(t0) > 2 else None, None, attrs))

    def abandon(self, t0: Optional[Tuple[int, ...]]) -> None:
        """Drop a :meth:`begin` token that will never complete (a failed
        attempt records no span).  Nothing is held for it here."""
        del t0

    def event(self, name: str, attrs: Optional[dict] = None) -> None:
        """An instant ("i") event."""
        if not self.on():
            return
        self._push(("i", None, name, self._wall() // 1000, 0, self._ident(),
                    None, None, attrs))

    # counters: live whether tracing is on or not

    def counter(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def get_counter(self, name: str, default: int = 0) -> int:
        with self._lock:
            return self._counters.get(name, default)

    def snapshot(self) -> Dict[str, Any]:
        """``{name, records, counters, dropped}``, without draining."""
        with self._lock:
            return {"name": self.name, "records": list(self._records),
                    "counters": dict(self._counters),
                    "dropped": self._dropped}


_DEFAULT: Optional[Tracer] = None
_DEFAULT_LOCK = threading.Lock()


def tracer() -> Tracer:
    """The process's tracer (one worker process, one track)."""
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = Tracer(name="process")
    return _DEFAULT
