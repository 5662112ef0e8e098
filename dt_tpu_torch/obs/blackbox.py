"""The flight recorder and hang forensics (counterpart of
``dt_tpu/obs/blackbox.py``, copied since the port imports nothing of the
JAX package): crash bundles, the per-process hang watchdog and the bundle
manifest.

``DT_BLACKBOX=1`` turns on:

- crash bundles: :func:`write_bundle` serializes a bounded, fsync'd,
  digest-named JSON bundle into ``DT_BLACKBOX_DIR``: every thread's
  stack, the open-span table (:meth:`Tracer.open_spans`, armed by this
  plane even with ``DT_OBS=0``), the span and metrics ring tails, the
  flight-note ring (:func:`note`), the secret-redacted ``ENV_REGISTRY``
  view, the state every :func:`register_state` provider returns and the
  applied-fault summary.  Written by injected ``os._exit`` crashes
  (``elastic/faults.py``), the health halt (``training/module.py``,
  ``trainer.py``), an OOM (``obs/device.py``), unhandled exceptions and
  SIGTERM (:func:`install`) and the watchdog;
- :class:`Watchdog`: when step progress (:meth:`Watchdog.beat`) stalls
  past ``DT_HANG_S`` it writes one live (non-fatal) bundle and an
  edge-triggered ``hang.suspect`` event; the next beat clears it.  The
  scheduler's fleet detector blames the worker a round waits on and
  serves ``blackbox_index`` over the manifest;
- the manifest: every bundle, every profile capture and every clean
  process exit appends a row to ``manifest.jsonl``.

Bundles have the JAX package's schema (:data:`SCHEMA`), so its
``validate_bundle`` and ``tools/dtop.py --postmortem`` read the port's.
Nothing here raises into the instrumented path, and nothing imports
torch.
"""

from __future__ import annotations

import atexit
import hashlib
import json
import os
import re
import signal
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Callable, Dict, List, Optional

from dt_tpu_torch import config
from dt_tpu_torch.obs import trace as obs_trace

#: bundle schema tag; bump on breaking layout changes
#: the package a bundle names: both packages write one format, and the
#: JAX package's readers check it
_WIRE_PACKAGE = "dt_tpu"
SCHEMA = _WIRE_PACKAGE + ".blackbox/1"

# Arm the tracer's open-span table whenever THIS plane is on, even with
# DT_OBS=0 — the bundle's "died 40 s into allreduce" evidence must not
# require the full tracing plane (spans then enter/leave the open table
# but record nothing in the ring).
obs_trace.set_open_span_arm(lambda: enabled())

#: span-ring / metrics-ring tail lengths carried in a bundle (the full
#: rings ride the heartbeat export; the bundle wants the last seconds)
_SPAN_TAIL = 256
_SERIES_TAIL = 120

# ---------------------------------------------------------------------------
# process-wide enable gate (DT_BLACKBOX, overridable in-process)
# ---------------------------------------------------------------------------

_ENABLED_OVERRIDE: Optional[bool] = None
_ENV_ENABLED: Optional[bool] = None


def enabled() -> bool:
    """Whether the flight-recorder plane is armed for this process
    (``DT_BLACKBOX=1`` or an explicit :func:`set_enabled`)."""
    if _ENABLED_OVERRIDE is not None:
        return _ENABLED_OVERRIDE
    global _ENV_ENABLED
    if _ENV_ENABLED is None:
        _ENV_ENABLED = config.env("DT_BLACKBOX").strip().lower() \
            in ("1", "true")
    return _ENV_ENABLED


def set_enabled(on: Optional[bool]) -> None:
    """Process-local override (``None`` = follow the env var again)."""
    global _ENABLED_OVERRIDE, _ENV_ENABLED
    _ENABLED_OVERRIDE = on
    if on is None:
        _ENV_ENABLED = None


def bundle_dir() -> str:
    """Where bundles + the manifest land (``DT_BLACKBOX_DIR``)."""
    return config.env("DT_BLACKBOX_DIR") or ".blackbox"


def hang_s() -> float:
    """The watchdog's stall threshold (``DT_HANG_S``, seconds)."""
    return float(config.env("DT_HANG_S"))


# ---------------------------------------------------------------------------
# flight-note ring: the cheap always-on last-N record this plane arms even
# when DT_OBS=0 (the span rings retain nothing then) — lifecycle beacons
# (steps, faults, halts, hang transitions) land here so a bundle can show
# the last seconds of process life without the full tracing plane
# ---------------------------------------------------------------------------

_RING_LOCK = threading.Lock()
_RING: deque = deque()  # guarded-by: _RING_LOCK
_RING_CAP: Optional[int] = None


def _ring_cap() -> int:
    global _RING_CAP
    if _RING_CAP is None:
        _RING_CAP = max(1, int(config.env("DT_BLACKBOX_RING")))
    return _RING_CAP


def note(kind: str, **attrs: Any) -> None:
    """Append one flight note (bounded, oldest shed).  One cached-bool
    check when the plane is off — safe on any hot path."""
    if not enabled():
        return
    with _RING_LOCK:
        if len(_RING) >= _ring_cap():
            _RING.popleft()
        _RING.append((int(time.time() * 1000), kind, attrs or {}))


def flight_ring() -> List[list]:
    """Non-destructive copy of the flight-note ring (oldest first)."""
    with _RING_LOCK:
        return [[ts, kind, dict(a)] for ts, kind, a in _RING]


def clear_ring() -> None:
    """Reset the flight ring (tests; the ring is process-shared)."""
    with _RING_LOCK:
        _RING.clear()


# ---------------------------------------------------------------------------
# state providers: subsystems register a callable returning their current
# control state (membership, rank, incarnation, policy seq, ...) so every
# bundle carries it without this module knowing about the elastic plane
# ---------------------------------------------------------------------------

_STATE_LOCK = threading.Lock()
_STATE_PROVIDERS: Dict[str, Callable[[], dict]] = {}  # guarded-by: _STATE_LOCK


def register_state(name: str, fn: Callable[[], dict]) -> None:
    """Register/replace a named state provider; its return value lands
    under ``bundle["state"][name]`` (failures are captured, not
    raised)."""
    with _STATE_LOCK:
        _STATE_PROVIDERS[name] = fn


def unregister_state(name: str, fn: Optional[Callable[[], dict]] = None
                     ) -> None:
    """Remove a provider.  With ``fn``, only when it is still the
    registered one (``==`` — bound methods compare by instance): a
    closing instance must not strip a successor's registration."""
    with _STATE_LOCK:
        if fn is None or _STATE_PROVIDERS.get(name) == fn:
            _STATE_PROVIDERS.pop(name, None)


_SECRET_RE = re.compile(r"SECRET|TOKEN$|PASSWORD|KEY$")


def env_view() -> Dict[str, str]:
    """The resolved ``ENV_REGISTRY`` view (effective value per knob),
    with secret-shaped values redacted — a bundle must never exfiltrate
    ``DT_ELASTIC_SECRET``."""
    out: Dict[str, str] = {}
    for name in sorted(config.ENV_REGISTRY):
        v = config.env(name)
        if v and _SECRET_RE.search(name):
            v = "<redacted>"
        out[name] = v
    return out


def thread_stacks() -> List[dict]:
    """All-thread stack snapshot via ``sys._current_frames`` — the
    evidence ``PS_VERBOSE`` could never give: which call every thread
    was blocked in at capture time."""
    frames = sys._current_frames()
    by_id = {t.ident: t for t in threading.enumerate()}
    out = []
    for tid in sorted(frames):
        t = by_id.get(tid)
        out.append({
            "tid": tid,
            "name": t.name if t is not None else "?",
            "daemon": bool(t.daemon) if t is not None else None,
            "frames": [[fs.filename, int(fs.lineno or 0), fs.name]
                       for fs in traceback.extract_stack(frames[tid])]})
    return out


# ---------------------------------------------------------------------------
# bundle build / write
# ---------------------------------------------------------------------------


def build_bundle(trigger: str, host: Optional[str] = None,
                 fatal: bool = True, extra: Optional[dict] = None,
                 clock_ms: Optional[int] = None,
                 pid: Optional[int] = None,
                 stacks: Optional[List[dict]] = None,
                 tracer: Optional[obs_trace.Tracer] = None,
                 registry=None) -> dict:
    """Assemble one bundle dict (see the module docstring for the
    content catalog).  ``clock_ms``/``pid``/``stacks``/``tracer``/
    ``registry`` are injectable so tests can pin a byte-deterministic
    bundle; production callers pass none of them."""
    from dt_tpu_torch.obs import metrics as obs_metrics
    tr = tracer if tracer is not None else obs_trace.tracer()
    snap = tr.snapshot()
    reg = registry if registry is not None else obs_metrics.registry()
    faults_applied: List[list] = []
    try:
        from dt_tpu_torch.elastic import faults as faults_lib
        plan = faults_lib.active_plan()
        if plan is not None:
            faults_applied = [[plan.rules[i].kind, h, n]
                              for i, h, n in plan.applied_summary()]
    except Exception:  # noqa: BLE001 — forensics are best-effort
        pass
    with _STATE_LOCK:
        providers = dict(_STATE_PROVIDERS)
    state: Dict[str, Any] = {}
    for name, fn in sorted(providers.items()):
        try:
            state[name] = fn()
        except Exception as e:  # noqa: BLE001 — a provider bug must not
            # lose the rest of the bundle
            state[name] = {"error": repr(e)[:200]}
    return {
        "schema": SCHEMA,
        "trigger": trigger,
        "fatal": bool(fatal),
        "ts_ms": int(clock_ms if clock_ms is not None
                     else time.time() * 1000),
        "pid": int(pid if pid is not None else os.getpid()),
        "host": host or (config.env("DT_WORKER_ID") or None),
        "threads": stacks if stacks is not None else thread_stacks(),
        "open_spans": tr.open_spans(),
        "span_ring": {"records": [list(r) for r in
                                  snap["records"][-_SPAN_TAIL:]],
                      "counters": snap["counters"],
                      "dropped": snap["dropped"]},
        "metrics_ring": {"series": reg.series()[-_SERIES_TAIL:],
                         "gauges": reg.gauges_export(),
                         "dropped": reg.dropped()},
        "flight_ring": flight_ring(),
        "env": env_view(),
        "state": state,
        "faults_applied": faults_applied,
        "extra": dict(extra or {}),
        "truncated": False,
    }


# deterministic: bytes — bundle serialization is canonical (sort_keys)
def _dump(bundle: dict) -> bytes:
    return json.dumps(bundle, sort_keys=True, default=repr).encode()


def _fit_to_cap(bundle: dict) -> bytes:
    """Serialize under the ``DT_BLACKBOX_MAX_MB`` cap, trimming tails
    (then whole rings) rather than failing — a too-big bundle with
    ``truncated: true`` beats no bundle."""
    cap = max(1, int(float(config.env("DT_BLACKBOX_MAX_MB")))) << 20
    payload = _dump(bundle)
    if len(payload) <= cap:
        return payload
    bundle = dict(bundle)
    bundle["truncated"] = True
    bundle["span_ring"] = {**bundle["span_ring"],
                           "records": bundle["span_ring"]["records"][-32:]}
    bundle["metrics_ring"] = {**bundle["metrics_ring"],
                              "series":
                              bundle["metrics_ring"]["series"][-16:]}
    bundle["flight_ring"] = bundle["flight_ring"][-32:]
    payload = _dump(bundle)
    if len(payload) <= cap:
        return payload
    bundle["span_ring"] = {"records": [], "counters": {}, "dropped": -1}
    bundle["metrics_ring"] = {"series": [], "gauges": [], "dropped": -1}
    bundle["threads"] = [{**t, "frames": t.get("frames", [])[-20:]}
                         for t in bundle["threads"]]
    return _dump(bundle)


def _prune_bundles(d: str) -> None:
    """Bound TOTAL bundle retention per dir (``DT_BLACKBOX_MAX_BUNDLES``,
    oldest pruned on write): a long job with recurring hang episodes
    writes a bundle per episode and must not fill the disk.  Manifest
    rows are kept — they are tiny and ARE the accumulation record; the
    digest-named file name sorts by timestamp, so lexical order is
    age order.  Best-effort, never raises."""
    try:
        cap = max(1, int(config.env("DT_BLACKBOX_MAX_BUNDLES")))
        names = sorted(n for n in os.listdir(d)
                       if n.startswith("bb-") and n.endswith(".json"))
        for n in names[:-cap]:
            try:
                os.remove(os.path.join(d, n))
            except OSError:
                pass
    except Exception:  # noqa: BLE001 — retention pruning is best-effort
        pass


def _fsync_dir(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


_SLUG_RE = re.compile(r"[^A-Za-z0-9._-]")


def write_bundle(trigger: str, host: Optional[str] = None,
                 fatal: bool = True, extra: Optional[dict] = None,
                 dirpath: Optional[str] = None,
                 clock_ms: Optional[int] = None,
                 pid: Optional[int] = None,
                 stacks: Optional[List[dict]] = None,
                 tracer: Optional[obs_trace.Tracer] = None,
                 registry=None) -> Optional[str]:
    """Serialize one bundle to ``DT_BLACKBOX_DIR`` (fsync'd, digest-
    named, size-capped) and append its manifest row.  Returns the
    bundle path, or ``None`` when the plane is off or anything failed —
    this is called half a millisecond from ``os._exit`` and from signal
    handlers, so it NEVER raises."""
    if not enabled():
        return None
    try:
        d = dirpath or bundle_dir()
        os.makedirs(d, exist_ok=True)
        bundle = build_bundle(trigger, host=host, fatal=fatal,
                              extra=extra, clock_ms=clock_ms, pid=pid,
                              stacks=stacks, tracer=tracer,
                              registry=registry)
        payload = _fit_to_cap(bundle)
        digest = hashlib.sha256(payload).hexdigest()[:12]
        fname = (f"bb-{bundle['ts_ms']}-{bundle['pid']}-"
                 f"{_SLUG_RE.sub('_', trigger)[:48]}-{digest}.json")
        path = os.path.join(d, fname)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(d)
        if fatal:
            global _FATAL_BUNDLED
            _FATAL_BUNDLED = True
        manifest_append({"kind": "bundle", "ts_ms": bundle["ts_ms"],
                         "pid": bundle["pid"], "host": bundle["host"],
                         "trigger": trigger, "fatal": bool(fatal),
                         "file": fname, "digest": digest,
                         "size": len(payload)}, dirpath=d)
        _prune_bundles(d)
        # bookkeeping rides the AMBIENT plane only — never the injected
        # tracer or the flight ring that just fed this bundle: two
        # write_bundle calls with identical injected inputs must
        # serialize byte-identically (the digest-named file and the
        # post-mortem golden depend on it), and the manifest row above
        # already records the write durably
        amb = obs_trace.tracer()
        amb.counter("blackbox.bundles")
        amb.event("blackbox.bundle", {"trigger": trigger, "file": fname,
                                      "fatal": bool(fatal)})
        return path
    except Exception:  # noqa: BLE001 — the flight recorder must never
        # be what takes the process down
        return None


_REQUIRED_KEYS = ("schema", "trigger", "fatal", "ts_ms", "pid", "host",
                  "threads", "open_spans", "span_ring", "metrics_ring",
                  "flight_ring", "env", "state", "faults_applied",
                  "extra", "truncated")


def validate_bundle(bundle: dict) -> List[str]:
    """Schema check; returns the list of problems ([] = valid).  The
    chaos harness gates every crash plan on this — a half-written or
    key-missing bundle is evidence lost, not evidence captured."""
    problems = []
    if not isinstance(bundle, dict):
        return ["bundle is not a dict"]
    for k in _REQUIRED_KEYS:
        if k not in bundle:
            problems.append(f"missing key {k!r}")
    if bundle.get("schema") != SCHEMA:
        problems.append(f"schema {bundle.get('schema')!r} != {SCHEMA!r}")
    if not isinstance(bundle.get("threads"), list) or \
            not bundle.get("threads"):
        problems.append("no thread stacks")
    else:
        for t in bundle["threads"]:
            if not isinstance(t.get("frames"), list):
                problems.append("thread entry without frames")
                break
    for k in ("open_spans", "flight_ring", "faults_applied"):
        if not isinstance(bundle.get(k), list):
            problems.append(f"{k} is not a list")
    for k in ("span_ring", "metrics_ring", "env", "state", "extra"):
        if not isinstance(bundle.get(k), dict):
            problems.append(f"{k} is not a dict")
    return problems


# ---------------------------------------------------------------------------
# manifest: one append-only jsonl per DT_BLACKBOX_DIR — bundles, probe
# captures, and clean exits accumulate across
# processes and incarnations
# ---------------------------------------------------------------------------


def manifest_path(dirpath: Optional[str] = None) -> str:
    return os.path.join(dirpath or bundle_dir(), "manifest.jsonl")


# deterministic: bytes — manifest rows serialize canonically
def manifest_append(row: dict, dirpath: Optional[str] = None) -> bool:
    """Append one row (fsync'd).  Never raises; False on failure."""
    try:
        d = dirpath or bundle_dir()
        os.makedirs(d, exist_ok=True)
        with open(manifest_path(d), "a") as f:
            f.write(json.dumps(row, sort_keys=True, default=repr) + "\n")
            f.flush()
            os.fsync(f.fileno())
        return True
    except Exception:  # noqa: BLE001 — manifest rows are best-effort
        return False


def read_manifest(dirpath: Optional[str] = None) -> List[dict]:
    """All parseable manifest rows, file order (= append order).  A
    torn final line (a crash mid-append) is skipped, not fatal."""
    out: List[dict] = []
    try:
        with open(manifest_path(dirpath)) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if isinstance(row, dict):
                    out.append(row)
    except OSError:
        pass
    return out


# ---------------------------------------------------------------------------
# hang watchdog (per-process deadman)
# ---------------------------------------------------------------------------


class Watchdog:
    """Deadman thread: :meth:`beat` marks step progress; when the last
    beat ages past ``hang_s`` the watchdog dumps ONE live (non-fatal)
    bundle with thread stacks + open spans and emits an edge-triggered
    ``hang.suspect`` event; the next beat emits ``hang.clear``.  The
    clock is injectable and :meth:`tick` is callable directly, so tests
    drive fire/clear deterministically without the thread
    (``start_thread=False``)."""

    def __init__(self, host: Optional[str] = None,
                 hang_seconds: Optional[float] = None,
                 tracer: Optional[obs_trace.Tracer] = None,
                 clock: Optional[Callable[[], float]] = None,
                 dirpath: Optional[str] = None,
                 start_thread: bool = True):
        self.host = host
        self.hang_seconds = float(hang_seconds if hang_seconds is not None
                                  else hang_s())
        self._tracer = tracer
        self._mono = clock or time.monotonic
        self._dir = dirpath
        self._lock = threading.Lock()
        self._last_beat = self._mono()  # guarded-by: _lock
        self._last_step: Optional[int] = None  # guarded-by: _lock
        self._suspected = False  # guarded-by: _lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if start_thread:
            self._thread = threading.Thread(
                target=self._loop, daemon=True,
                name=f"dt-blackbox-watchdog-{host or os.getpid()}")
            self._thread.start()

    def _tr(self) -> obs_trace.Tracer:
        return self._tracer if self._tracer is not None \
            else obs_trace.tracer()

    def beat(self, step: Optional[int] = None) -> None:
        """Mark progress (one clock read + lock; call once per step)."""
        with self._lock:
            self._last_beat = self._mono()
            if step is not None:
                self._last_step = int(step)
            clear = self._suspected
            self._suspected = False
        if clear:
            attrs = {"host": self.host, "step": step}
            self._tr().event("hang.clear", attrs)
            note("hang.clear", **attrs)

    def _loop(self) -> None:
        period = max(min(self.hang_seconds / 4.0, 5.0), 0.05)
        while not self._stop.wait(period):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the deadman must not die
                pass

    def tick(self) -> bool:
        """One stall check; True when the watchdog fired this tick
        (edge-triggered: a continuing stall fires once, not per
        tick).

        Compile labeling: when the tracer's open-span table shows a
        ``compile.*`` span in flight (an ``nvcc`` build here), the stall
        is (so far) the compiler working, not a wedge — the bundle/event
        carry ``compile=<span name>`` + ``compile_in_progress=True`` so a
        post-mortem (and the chaos hang gate) can tell the labeled
        compile stall from the real hang, which arrives as the first
        UNLABELED bundle.  The firing stays edge-triggered either way:
        a compile that then wedges is already on record."""
        now = self._mono()
        with self._lock:
            stalled = now - self._last_beat
            if stalled <= self.hang_seconds or self._suspected:
                return False
            self._suspected = True
            step = self._last_step
        attrs = {"host": self.host, "stalled_s": round(stalled, 3),
                 "last_step": step, "hang_s": self.hang_seconds}
        comp = next((s["name"] for s in self._tr().open_spans()
                     if str(s.get("name", "")).startswith("compile.")),
                    None)
        if comp is not None:
            attrs["compile"] = comp
            attrs["compile_in_progress"] = True
        self._tr().event("hang.suspect", attrs)
        note("hang.suspect", **attrs)
        write_bundle("hang", host=self.host, fatal=False, extra=attrs,
                     dirpath=self._dir, tracer=self._tracer)
        return True

    def suspected(self) -> bool:
        with self._lock:
            return self._suspected

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None and \
                self._thread is not threading.current_thread():
            self._thread.join(timeout=2.0)


# ---------------------------------------------------------------------------
# process-wide crash hooks: SIGTERM handler, unhandled-exception hook,
# faulthandler (SIGSEGV/SIGABRT native dumps), clean-exit manifest row
# ---------------------------------------------------------------------------

_INSTALL_LOCK = threading.Lock()
_INSTALLED = False  # guarded-by: _INSTALL_LOCK
#: set once a fatal bundle landed — the atexit row then stays away (a
#: crashed process must not trail a misleading clean-"exit" row).
#: Monotonic write-once bool: benign unlocked.
_FATAL_BUNDLED = False


def install(host: Optional[str] = None) -> bool:
    """Arm the process-wide crash hooks (idempotent; no-op unless the
    plane is enabled).  ``WorkerClient.__init__`` calls it, before
    ``Module.fit`` installs the drain handler (``elastic/drain.py``):
    the first SIGTERM then drains, and a second reaches the handler
    installed here."""
    global _INSTALLED
    if not enabled():
        return False
    with _INSTALL_LOCK:
        if _INSTALLED:
            return True
        _INSTALLED = True
    d = bundle_dir()
    try:
        os.makedirs(d, exist_ok=True)
    except OSError:
        pass
    # native-fault stacks (SIGSEGV/SIGABRT/SIGBUS — a device runtime
    # aborting in C never reaches a Python handler; faulthandler's C
    # handler still writes every thread's stack next to the bundles)
    try:
        import faulthandler
        if not faulthandler.is_enabled():
            fh = open(os.path.join(d, f"faulthandler-{os.getpid()}.log"),
                      "a")
            faulthandler.enable(file=fh, all_threads=True)
    except (OSError, RuntimeError, ValueError):
        pass
    # unhandled exceptions: bundle first, then the normal traceback
    prev_hook = sys.excepthook

    def _except_hook(tp, val, tb):
        try:
            write_bundle(
                "exception", host=host, fatal=True,
                extra={"error": "".join(
                    traceback.format_exception_only(tp, val))[-500:]
                    .strip()})
        except Exception:  # noqa: BLE001 — never mask the real error
            pass
        prev_hook(tp, val, tb)

    sys.excepthook = _except_hook

    # SIGTERM: bundle, then die with the default disposition so the
    # parent still sees exit-by-SIGTERM (rc 143 semantics preserved).
    # The bundle is built on a HELPER thread with a bounded join: the
    # handler runs on whatever thread the signal interrupted, which may
    # already hold one of the non-reentrant locks the bundle readers
    # take (Tracer._lock mid-_push, _RING_LOCK mid-note) — building
    # in-handler could deadlock and leave the process UNKILLABLE by
    # SIGTERM.  Worst case here is a lost bundle after 5 s, never a
    # wedged shutdown.
    def _sig_handler(signum, frame):
        del frame
        try:
            done = threading.Event()

            def _w():
                try:
                    write_bundle(f"signal.{signal.Signals(signum).name}",
                                 host=host, fatal=True)
                finally:
                    done.set()

            threading.Thread(target=_w, daemon=True,
                             name="dt-blackbox-sig").start()
            done.wait(5.0)
        except Exception:  # noqa: BLE001
            pass
        try:
            signal.signal(signum, signal.SIG_DFL)
        except (ValueError, OSError):
            pass
        os.kill(os.getpid(), signum)

    try:
        signal.signal(signal.SIGTERM, _sig_handler)
    except (ValueError, OSError):
        pass  # not the main thread / unsupported platform: skip

    # clean exits leave a manifest row too — wedge forensics need the
    # successes to bound when the wedge began.  A process that already
    # wrote a FATAL bundle skips it: its death is on record and a
    # trailing fatal=False row would read as a clean exit.
    def _exit_row():
        if _FATAL_BUNDLED:
            return
        manifest_append({"kind": "exit", "ts_ms": int(time.time() * 1000),
                         "pid": os.getpid(), "host": host,
                         "trigger": "exit", "fatal": False})

    atexit.register(_exit_row)
    return True


def _reset_for_tests() -> None:
    """Drop the cached install/ring state (tests only — subprocess tests
    re-install per process; in-process tests must not inherit)."""
    global _INSTALLED, _RING_CAP
    with _INSTALL_LOCK:
        _INSTALLED = False
    _RING_CAP = None
    clear_ring()
    with _STATE_LOCK:
        _STATE_PROVIDERS.clear()
