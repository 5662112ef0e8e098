"""Profiling with the reference's API surface, on ``torch.profiler``
(counterpart of ``dt_tpu/utils/profiler.py``).

``set_config``/``set_state``/``pause``/``resume``/``dump`` follow the
reference's ``mx.profiler``; a session records the host and, on a card,
the device (Kineto) and is written as ``trace.json`` (chrome://tracing,
Perfetto) in the configured directory.  ``set_state_all``/``dump_all``
broadcast the same commands to every worker through the elastic
scheduler (``WorkerClient.profile_command``); each worker writes under a
``rank<N>_`` prefix, as the reference's servers did
(``kvstore_dist_server.h:307``).

Kineto allows one profiler a process: starting a session while another
runs (an on-demand ``profile_capture`` of ``obs/device.py``, or any
``torch.profiler``) raises.  ``pause`` stops the session (a profile
cannot pause mid-flight); ``resume`` starts a fresh one.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

_config = {"filename": "profile_output"}
_running = False  # guarded-by: _state_lock
_active_outdir: Optional[str] = None  # guarded-by: _state_lock
_prof = None  # the live torch.profiler.profile; guarded-by: _state_lock
# a remote command (heartbeat thread) may race the caller's own calls:
# transitions are serialized and idempotent under this lock
_state_lock = threading.Lock()


def running() -> bool:
    """Whether a session started here is recording."""
    return _running


def set_config(filename: str = "profile_output", profile_all: bool = True,
               aggregate_stats: bool = False, **_ignored) -> None:
    """Reference ``mx.profiler.set_config``: ``filename`` is the trace's
    output directory (``profile_all`` and ``aggregate_stats`` are the
    reference's, accepted and unused: a session records every operator)."""
    del profile_all, aggregate_stats
    _config["filename"] = filename


def _start() -> object:
    import torch
    from torch.profiler import ProfilerActivity, profile
    if torch._C._autograd._profiler_enabled():
        raise RuntimeError("a profiler session is already running in this "
                           "process (Kineto allows one a process)")
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def set_state(state: str = "stop", rank: Optional[int] = None) -> None:
    """Reference ``mx.profiler.set_state('run'|'stop')``; ``stop`` writes
    the trace."""
    global _running, _active_outdir, _prof
    if state not in ("run", "stop"):
        raise ValueError(f"state must be run|stop, got {state!r}")
    outdir = _config["filename"]
    if rank is not None:
        outdir = os.path.join(os.path.dirname(outdir) or ".",
                              f"rank{rank}_" + os.path.basename(outdir))
    with _state_lock:
        if state == "run" and not _running:
            _prof = _start()
            _active_outdir = outdir
            _running = True
        elif state == "stop" and _running:
            prof, _prof = _prof, None
            _running = False
            import torch
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            prof.stop()
            os.makedirs(_active_outdir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(_active_outdir,
                                                  "trace.json"))


def pause() -> None:
    """Reference ``mx.profiler.pause``: stops the session."""
    set_state("stop")


def resume() -> None:
    set_state("run")


def dump(finished: bool = True) -> str:
    """Reference ``mx.profiler.dump``: stops the session; returns the
    directory the trace went to (rank-prefixed in a distributed run)."""
    del finished
    set_state("stop")
    return _active_outdir or _config["filename"]


class trace:
    """``with profiler.trace("/tmp/tr"): step()``."""

    def __init__(self, outdir: str):
        self.outdir = outdir

    def __enter__(self):
        set_config(filename=self.outdir)
        set_state("run")
        return self

    def __exit__(self, *a):
        set_state("stop")


def annotate(name: str):
    """A named region of the trace (``torch.profiler.record_function``)."""
    import torch
    return torch.profiler.record_function(name)


def apply_remote(action: str, params: dict, rank: int) -> None:
    """Apply one remote profiler command on this worker (the elastic
    client's heartbeat thread, or the poster itself)."""
    if action == "set_config":
        set_config(**params)
    elif action == "set_state":
        set_state(params.get("state", "stop"), rank=rank)
    elif action == "pause":
        pause()
    elif action == "resume":
        set_state("run", rank=rank)
    elif action == "dump":
        dump()
    else:
        raise ValueError(f"unknown remote profiler action {action!r}")


def set_config_all(kv, **params) -> None:
    """Reference ``kv.set_server_profiler_config``: the config on every
    worker through the scheduler; local without a controller."""
    ctrl = getattr(kv, "_controller", None)
    if ctrl is None or not hasattr(ctrl, "profile_command"):
        set_config(**params)
        return
    ctrl.profile_command("set_config", params)


def set_state_all(kv, state: str) -> None:
    """Reference ``kv.set_server_profiler_state``: run/stop on every
    worker (each at its next heartbeat, the caller at once)."""
    ctrl = getattr(kv, "_controller", None)
    if ctrl is None or not hasattr(ctrl, "profile_command"):
        set_state(state)
        return
    ctrl.profile_command("set_state", {"state": state})


def dump_all(kv) -> str:
    """A dump on every worker; returns this worker's trace directory."""
    ctrl = getattr(kv, "_controller", None)
    if ctrl is not None and hasattr(ctrl, "profile_command"):
        ctrl.profile_command("dump", {})
    return dump()
