"""Graceful drain: SIGTERM, then the current step, then leave (counterpart
of ``dt_tpu/elastic/drain.py``, copied since the port imports nothing of
the JAX package).

The first SIGTERM only raises a flag (the handler takes no lock and does
no I/O); the training loop polls :func:`requested` between steps, sends
the ``drain`` command so the scheduler removes the host through its
eviction machinery, and returns from ``fit``: no collective error and no
recovery window.  A second SIGTERM gets the disposition from before
:func:`install`, so a wedged drain stays killable.  Forked children die
with the default disposition.  :func:`announce` records the one
``drain.requested`` trace event and, with the flight recorder armed, a
``kind="drain"`` manifest row (a drained worker leaves no crash bundle).

Install it after ``obs_blackbox.install`` (``WorkerClient`` construction
does that): the first SIGTERM then drains and the second reaches the
blackbox handler, which writes its fatal bundle and dies.
"""

import os
import signal
import threading
import time
from typing import Optional

from dt_tpu_torch.obs import blackbox as obs_blackbox
from dt_tpu_torch.obs import trace as obs_trace

_LOCK = threading.Lock()
_INSTALLED = False  # guarded-by: _LOCK
_INSTALL_PID = 0  # guarded-by: _LOCK (read lock-free in the handler)
_PREV_HANDLER = None  # guarded-by: _LOCK
_REQUESTED = threading.Event()
_REQUESTED_MS: Optional[int] = None  # stamp for announce(); write-once
_ANNOUNCED = False  # guarded-by: _LOCK


def install(host: Optional[str] = None) -> bool:
    """Arm the graceful-drain SIGTERM handler (idempotent).  Returns
    False off the main thread / unsupported platforms — the training
    loop then simply never sees :func:`requested`."""
    del host  # identity rides announce(); handler must stay lock-free
    global _INSTALLED, _INSTALL_PID, _PREV_HANDLER
    with _LOCK:
        if _INSTALLED:
            return True

        def _handler(signum, frame):
            del frame
            if os.getpid() != _INSTALL_PID:
                # forked child (e.g. a DataLoader pool worker): drain is
                # meaningless here, and swallowing TERM makes the
                # parent's Pool.terminate() join hang forever — die with
                # the default disposition instead
                try:
                    signal.signal(signum, signal.SIG_DFL)
                except (ValueError, OSError):
                    pass
                os.kill(os.getpid(), signum)
                return
            _mark_requested()
            # a second TERM gets the disposition from before install
            try:
                signal.signal(signum, _PREV_HANDLER or signal.SIG_DFL)
            except (ValueError, TypeError, OSError):
                pass

        try:
            _PREV_HANDLER = signal.signal(signal.SIGTERM, _handler)
        except (ValueError, OSError):
            return False  # not the main thread: leave disposition alone
        _INSTALLED = True
        _INSTALL_PID = os.getpid()
        return True


def _mark_requested() -> None:
    """Signal-handler body: flag + timestamp, nothing that takes a
    lock.  (time.time is a lone syscall; int boxing allocates but
    cannot deadlock.)"""
    global _REQUESTED_MS
    if _REQUESTED_MS is None:
        _REQUESTED_MS = int(time.time() * 1000)
    _REQUESTED.set()


def requested() -> bool:
    """Has a drain been requested (a SIGTERM seen)?"""
    return _REQUESTED.is_set()


def announce(host: Optional[str] = None) -> bool:
    """The drain's one ``drain.requested`` trace event, recorded by the
    training loop when it sees :func:`requested`.  True the first time
    only."""
    global _ANNOUNCED
    with _LOCK:
        if _ANNOUNCED or not _REQUESTED.is_set():
            return False
        _ANNOUNCED = True
    ts = _REQUESTED_MS or int(time.time() * 1000)
    obs_trace.tracer().event("drain.requested",
                             {"host": host, "ts_ms": ts})
    obs_blackbox.note("drain.requested", host=host)
    if obs_blackbox.enabled():
        obs_blackbox.manifest_append(
            {"kind": "drain", "ts_ms": ts, "pid": os.getpid(),
             "host": host, "trigger": "SIGTERM", "fatal": False})
    return True
