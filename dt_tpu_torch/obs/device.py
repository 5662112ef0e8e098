"""The device plane (counterpart of ``dt_tpu/obs/device.py``, in
PyTorch's idiom): the compile observatory, the HBM gauges, the OOM census
and the on-demand profile capture.

Hard-off unless ``DT_DEVICE_OBS=1`` (or :func:`set_enabled`); off, every
entry point is one cached-bool check.  The module imports no torch:
worker-side functions import it lazily, so the scheduler, which only
ingests the heartbeat's ``dev`` payloads as plain dicts, stays torch-free.

- **Compile observatory.**  The port compiles nothing per step; its
  compile events are the ``nvcc`` builds of ``ops/_build.py``, each inside
  a ``compile.nvcc`` span (:func:`compile_span`; an open one labels a hang
  bundle as a compile stall) and folded into the ledger as
  ``nvcc.<source>`` (cache ``miss`` when built, ``hit`` when the library
  was already on disk), and the first launch of each (kernel, shapes,
  dtypes) signature (:func:`note_launch`, from ``ops.kernels._launch``):
  a second signature of one kernel is a ``compile.recompile`` event naming
  what changed (``shape``/``dtype``/``nargs``).  :func:`summary` and
  :func:`compiling` read the ledger.
- **Memory.**  :func:`memory_snapshot` reads ``torch.cuda.memory_stats``
  of the worker's device (:func:`register_device`; allocated bytes now and
  at peak) and the card's capacity, read once by ``torch.cuda.mem_get_info``
  at registration on the training thread: the sampler's hook
  (:func:`metrics_hook`, :func:`sample_into`) never synchronizes and never
  touches another device.  The ``device.hbm_*`` gauges carry the JAX
  package's names, beside the host RSS and the overlap engine's staging
  pool.  A worker registered on a CUDA device where CUDA is not available
  raises instead of reporting zeros.
- **Forensics.**  :func:`is_oom` knows ``torch.cuda.OutOfMemoryError``;
  :func:`maybe_oom_bundle` writes a blackbox bundle with
  :func:`live_buffer_census` (the live device tensors grouped by shape and
  dtype, largest first, from a bounded scan of the collector's objects)
  before the error propagates.  Every bundle carries the ledger and the
  memory view (the ``device`` state provider).
- **Capture.**  :func:`arm_capture`/:func:`capture_tick` run a bounded
  N-step ``torch.profiler`` trace on demand (the ``profile_capture``
  command), synchronized at both ends, written as ``trace.json`` under
  ``DT_BLACKBOX_DIR`` with a manifest row.  Kineto allows one profiler a
  process: a capture that finds one running fails loudly (a log error, a
  ``profile.capture`` event and a manifest row carrying the error).

Left out, having no counterpart here: XLA's buffer-assignment estimate
(``memory_analysis_row`` and the ``est`` of the ``dev`` payload's compile
view), the AOT ``instrument`` wrapper of jitted steps, and the
``DT_JAX_CACHE_DIR`` persistent-cache probe.
"""

from __future__ import annotations

import contextlib
import gc
import hashlib
import logging
import os
import threading
import time
import warnings
import weakref
from typing import Any, Callable, Dict, List, Optional

from dt_tpu_torch import config
from dt_tpu_torch.obs import trace as obs_trace

logger = logging.getLogger("dt_tpu_torch.obs")

_ENABLED_OVERRIDE: Optional[bool] = None
_ENV_ENABLED: Optional[bool] = None


def enabled() -> bool:
    """Whether the device plane is armed (``DT_DEVICE_OBS=1`` or
    :func:`set_enabled`)."""
    if _ENABLED_OVERRIDE is not None:
        return _ENABLED_OVERRIDE
    global _ENV_ENABLED
    if _ENV_ENABLED is None:
        _ENV_ENABLED = config.env("DT_DEVICE_OBS").strip().lower() \
            in ("1", "true")
    return _ENV_ENABLED


def set_enabled(on: Optional[bool]) -> None:
    """Process-local override (``None`` follows the env var again)."""
    global _ENABLED_OVERRIDE, _ENV_ENABLED
    _ENABLED_OVERRIDE = on
    if on is None:
        _ENV_ENABLED = None


#: distinct launch signatures the ledger keeps a kernel (past it a new
#: shape is no longer recorded)
_MAX_SIGS = 256
#: recompile-cause ledger entries kept a process
_LEDGER_MAX = 128
#: census rows carried in bundles
_CENSUS_TOP = 16
#: collector objects the census scans at most
_CENSUS_SCAN = 2_000_000

# ---------------------------------------------------------------------------
# the compile ledger (process-wide: one history a `what`)
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()
_BY_WHAT: Dict[str, dict] = {}  # guarded-by: _LOCK
_SEEN: Dict[str, set] = {}  # what -> launch keys seen; guarded-by: _LOCK
_RECOMPILES: List[dict] = []  # guarded-by: _LOCK
_TOTALS = {"compiles": 0, "recompiles": 0, "ms_total": 0.0,
           "cache_hits": 0, "cache_misses": 0}  # guarded-by: _LOCK
_ARMED = False  # guarded-by: _LOCK


def _arm_once() -> None:
    """Register the blackbox ``device`` state provider the first time the
    armed plane is used: every bundle then carries the ledger and the
    memory view."""
    global _ARMED
    with _LOCK:
        if _ARMED:
            return
        _ARMED = True
    try:
        from dt_tpu_torch.obs import blackbox
        blackbox.register_state("device", _bb_state)
    except Exception:  # noqa: BLE001 — observability is never fatal
        pass


def _bb_state() -> dict:
    out = {"compile": summary(), "compiling": compiling()}
    try:
        out["mem"] = memory_snapshot()
    except Exception:  # noqa: BLE001 — best-effort forensics
        pass
    try:
        out["census"] = live_buffer_census(_CENSUS_TOP)
    except Exception:  # noqa: BLE001
        pass
    return out


def _sig_of(key: tuple) -> Dict[str, Any]:
    """The signature of one ``((shape, dtype), ...)`` key, digested as the
    JAX package digests a jitted step's (values never enter; a launch has
    no mesh and donates nothing)."""
    shapes = [k[0] for k in key]
    dtypes = [k[1] for k in key]
    sig = {
        "nargs": len(shapes),
        "shape": hashlib.sha1(repr(shapes).encode()).hexdigest()[:12],
        "dtype": hashlib.sha1(repr(dtypes).encode()).hexdigest()[:12],
        "mesh": "",
        "donate": "",
    }
    sig["digest"] = hashlib.sha1(
        repr(sorted(sig.items())).encode()).hexdigest()[:12]
    return sig


def _sig_delta(prev: Dict[str, Any], new: Dict[str, Any]) -> List[str]:
    """Which signature facets changed (``rebuild``: none of them)."""
    changed = [k for k in ("shape", "dtype", "mesh", "donate", "nargs")
               if prev.get(k) != new.get(k)]
    return changed or ["rebuild"]


def _record_compile(what: str, sig: Dict[str, Any], elapsed_ms: float,
                    cache: str, tracer: Optional[obs_trace.Tracer] = None,
                    now_ms: Optional[int] = None) -> Optional[dict]:
    """Fold one compile event into the ledger; returns the recompile
    record when ``what`` had one before.  Tracer and clock injectable."""
    tr = tracer if tracer is not None else obs_trace.tracer()
    ts = int(now_ms if now_ms is not None else time.time() * 1000)
    recompile = None
    with _LOCK:
        ent = _BY_WHAT.setdefault(what, {"builds": 0, "ms_total": 0.0,
                                         "last_sig": None})
        prev = ent["last_sig"]
        ent["builds"] += 1
        ent["ms_total"] = round(ent["ms_total"] + elapsed_ms, 3)
        ent["last_sig"] = dict(sig)
        _TOTALS["compiles"] += 1
        _TOTALS["ms_total"] = round(_TOTALS["ms_total"] + elapsed_ms, 3)
        if cache == "hit":
            _TOTALS["cache_hits"] += 1
        elif cache == "miss":
            _TOTALS["cache_misses"] += 1
        if prev is not None:
            recompile = {"what": what, "changed": _sig_delta(prev, sig),
                         "prev": prev["digest"], "new": sig["digest"],
                         "elapsed_ms": round(elapsed_ms, 3),
                         "cache": cache, "ts_ms": ts}
            _TOTALS["recompiles"] += 1
            _RECOMPILES.append(recompile)
            del _RECOMPILES[:-_LEDGER_MAX]
    tr.counter("compile.compiles")
    if cache == "hit":
        tr.counter("compile.cache_hits")
    elif cache == "miss":
        tr.counter("compile.cache_misses")
    if recompile is not None:
        tr.event("compile.recompile",
                 {k: v for k, v in recompile.items() if k != "ts_ms"})
    return recompile


@contextlib.contextmanager
def compile_span(what: str, attrs: Optional[dict] = None):
    """A ``compile.<what>`` span over a compile (``nvcc``): named, so the
    open-span table, and with it the watchdog, sees a compile in
    progress.  A no-op off."""
    if not enabled():
        yield
        return
    _arm_once()
    tr = obs_trace.tracer()
    t0 = tr.begin(f"compile.{what}", dict(attrs or {}))
    try:
        yield
    finally:
        tr.complete_span(f"compile.{what}", t0, dict(attrs or {}))


def record_build(source: str, elapsed_ms: float, cache: str,
                 digest: str = "") -> None:
    """Fold one ``nvcc`` build (``cache="miss"``) or the load of a library
    already built (``"hit"``) into the ledger as ``nvcc.<source>``."""
    if not enabled():
        return
    _arm_once()
    sig = {"nargs": 1, "shape": "", "dtype": "", "mesh": "",
           "donate": "", "digest": digest[:12]}
    _record_compile(f"nvcc.{source}", sig, elapsed_ms, cache)


def note_launch(what: str, tensors, elapsed_ms: float) -> None:
    """Called by a kernel wrapper after a launch when the plane is armed:
    the first launch of a (shapes, dtypes) signature is a ledger entry of
    ``what`` (its host time ``elapsed_ms``), and any later new signature
    a recompile naming the facets that changed."""
    key = tuple(shape_key(t) for t in tensors)
    with _LOCK:
        seen = _SEEN.setdefault(what, set())
        if key in seen or len(seen) >= _MAX_SIGS:
            return
        seen.add(key)
    _arm_once()
    _record_compile(what, _sig_of(key), elapsed_ms, "off")


def summary() -> dict:
    """The ledger: totals, a ``what``'s builds and last signature, and the
    bounded recompile log (the ``dev`` payload, the worker results)."""
    with _LOCK:
        return {"enabled": enabled(),
                **dict(_TOTALS),
                "whats": sorted(_BY_WHAT),
                "by_what": {w: {"builds": e["builds"],
                                "ms_total": e["ms_total"],
                                "sig": dict(e["last_sig"] or {}),
                                "mem": None}
                            for w, e in sorted(_BY_WHAT.items())},
                "recompile_log": [dict(r) for r in _RECOMPILES[-32:]]}


def compiling_info() -> Optional[Dict[str, Any]]:
    """The oldest open ``compile.*`` span as ``{"name", "age_s"}``, or
    ``None``."""
    for s in obs_trace.tracer().open_spans():
        if str(s.get("name", "")).startswith("compile."):
            return {"name": s["name"],
                    "age_s": round(float(s.get("age_ms", 0.0)) / 1000.0,
                                   3)}
    return None


def compiling() -> Optional[str]:
    """The open ``compile.*`` span's name, or ``None``."""
    info = compiling_info()
    return info["name"] if info else None


# ---------------------------------------------------------------------------
# memory: the worker's device, host RSS, staging pools, the census
# ---------------------------------------------------------------------------

_STAGING: "weakref.WeakValueDictionary[int, Any]" = \
    weakref.WeakValueDictionary()
_PROVENANCE: Dict[str, Callable[[], set]] = {}  # guarded-by: _LOCK
_DEVICES: Dict[str, int] = {}  # "cuda:i" -> capacity bytes; guarded-by: _LOCK


def register_device(device) -> None:
    """The worker's device, whose memory the gauges read.  Call on the
    training thread: a CUDA device's capacity is read here, once, by
    ``torch.cuda.mem_get_info``.  Raises when CUDA is not available for a
    CUDA device; a CPU device has no HBM rows (the host RSS stands)."""
    if not enabled():
        return
    import torch
    dev = torch.device(device)
    if dev.type != "cuda":
        return
    if not torch.cuda.is_available():
        raise RuntimeError(f"device plane: the worker runs on {dev}, but "
                           "CUDA is not available")
    idx = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    total = int(torch.cuda.mem_get_info(idx)[1])
    with _LOCK:
        _DEVICES[f"cuda:{idx}"] = total
    _arm_once()


def register_staging(pool) -> None:
    """Track an overlap ``StagingPool``'s occupancy (weakly)."""
    _STAGING[id(pool)] = pool


def shape_key(t) -> tuple:
    """A tensor's census group, ``(str(shape tuple), dtype name)`` with the
    JAX package's dtype names (``float32``, ``bfloat16``)."""
    return (str(tuple(int(s) for s in t.shape)),
            str(t.dtype).replace("torch.", ""))


def register_provenance(name: str, shapes_fn: Callable[[], set]) -> None:
    """``shapes_fn()`` returns the :func:`shape_key` pairs belonging to
    ``name`` (the params, the optimizer state): the census tags the rows
    it matches."""
    with _LOCK:
        _PROVENANCE[name] = shapes_fn


def _rss_bytes() -> Optional[int]:
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError, AttributeError):
        try:
            import resource
            return resource.getrusage(
                resource.RUSAGE_SELF).ru_maxrss * 1024
        except Exception:  # noqa: BLE001
            return None


def _device_rows(devices) -> List[dict]:
    """One row a device: a registered CUDA device reads the caching
    allocator's counters (host memory, no synchronize); an injected
    device view (tests) answers ``memory_stats()`` in the JAX package's
    keys."""
    rows = []
    if devices is None:
        with _LOCK:
            reg = dict(_DEVICES)
        if not reg:
            return rows
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("device plane: CUDA devices registered, "
                               "but CUDA is not available")
        for name, total in sorted(reg.items()):
            idx = int(name.split(":")[1])
            ms = torch.cuda.memory_stats(idx)
            if not ms:
                continue  # no allocation yet on this device
            rows.append({"id": idx,
                         "bytes_in_use":
                             int(ms.get("allocated_bytes.all.current", 0)),
                         "peak_bytes_in_use":
                             int(ms.get("allocated_bytes.all.peak", 0)),
                         "bytes_limit": int(total)})
        return rows
    for d in devices:
        ms = d.memory_stats()
        if not ms:
            continue
        rows.append({"id": getattr(d, "id", len(rows)),
                     "bytes_in_use": int(ms.get("bytes_in_use", 0)),
                     "peak_bytes_in_use":
                         int(ms.get("peak_bytes_in_use", 0)),
                     "bytes_limit": int(ms.get("bytes_limit", 0))})
    return rows


def memory_snapshot(devices=None) -> dict:
    """One memory view: a row for each registered device (or each
    injected ``devices`` view), host RSS, and the staging pools'
    occupancy when any is registered."""
    out: Dict[str, Any] = {"devices": _device_rows(devices)}
    rss = _rss_bytes()
    if rss is not None:
        out["host_rss_bytes"] = int(rss)
    pools = list(_STAGING.values())
    if pools:
        out["staging"] = {
            "bytes": sum(int(getattr(p, "_free_bytes", 0)) for p in pools),
            "outstanding": sum(int(getattr(p, "outstanding", 0))
                               for p in pools),
            "allocated": sum(int(getattr(p, "allocated", 0))
                             for p in pools)}
    return out


def sample_into(reg, devices=None) -> dict:
    """Set the ``device.*`` gauges on a ``MetricsRegistry`` from one
    memory snapshot; returns the snapshot."""
    snap = memory_snapshot(devices=devices)
    for d in snap["devices"]:
        labels = {"device": str(d["id"])}
        reg.gauge("device.hbm_bytes", d["bytes_in_use"], labels=labels)
        reg.gauge("device.hbm_peak_bytes", d["peak_bytes_in_use"],
                  labels=labels)
        if d["bytes_limit"]:
            reg.gauge("device.hbm_limit_bytes", d["bytes_limit"],
                      labels=labels)
    if "host_rss_bytes" in snap:
        reg.gauge("device.host_rss_bytes", snap["host_rss_bytes"])
    st = snap.get("staging")
    if st is not None:
        reg.gauge("device.staging_bytes", st["bytes"])
        reg.gauge("device.staging_outstanding", st["outstanding"])
    return snap


def metrics_hook() -> Optional[Callable[[], None]]:
    """The worker ``Sampler``'s hook (``None`` off)."""
    if not enabled():
        return None
    _arm_once()
    from dt_tpu_torch.obs import metrics as obs_metrics

    def _hook():
        sample_into(obs_metrics.registry())
    return _hook


def _live_device_tensors() -> list:
    """The live CUDA tensors the collector tracks (views skipped: their
    storage is counted once, by their base), at most
    :data:`_CENSUS_SCAN` objects scanned."""
    import sys
    torch = sys.modules.get("torch")
    if torch is None:
        return []
    out = []
    with warnings.catch_warnings():
        # an isinstance test on a deprecated alias object warns
        warnings.simplefilter("ignore")
        for i, o in enumerate(gc.get_objects()):
            if i >= _CENSUS_SCAN:
                break
            try:
                if isinstance(o, torch.Tensor) and o.is_cuda and \
                        o._base is None:
                    out.append(o)
            except Exception:  # noqa: BLE001 — a half-built object
                continue
    return out


def live_buffer_census(top: int = _CENSUS_TOP, arrays=None) -> List[dict]:
    """The largest groups of live device tensors by total bytes, grouped by
    ``(shape, dtype)`` and tagged from the provenance sets.  ``arrays`` is
    injectable (tests pass CPU tensors)."""
    if arrays is None:
        arrays = _live_device_tensors()
    with _LOCK:
        provs = dict(_PROVENANCE)
    tagsets = []
    for name, fn in sorted(provs.items()):
        try:
            tagsets.append((name, set(fn())))
        except Exception:  # noqa: BLE001 — a provider bug loses its tag
            pass
    groups: Dict[tuple, dict] = {}
    for a in arrays:
        try:
            shape, dtype = shape_key(a)
            nbytes = int(a.numel()) * int(a.element_size())
        except Exception:  # noqa: BLE001
            continue
        g = groups.setdefault((shape, dtype),
                              {"shape": shape, "dtype": dtype,
                               "count": 0, "bytes": 0, "tag": ""})
        g["count"] += 1
        g["bytes"] += nbytes
    for g in groups.values():
        for name, shapes in tagsets:
            if (g["shape"], g["dtype"]) in shapes:
                g["tag"] = name
                break
    return sorted(groups.values(),
                  key=lambda g: (-g["bytes"], g["shape"]))[:top]


# ---------------------------------------------------------------------------
# OOM forensics
# ---------------------------------------------------------------------------


def is_oom(exc: BaseException) -> bool:
    """Whether ``exc`` is a device allocation failure
    (``torch.cuda.OutOfMemoryError``, or its message)."""
    import sys
    torch = sys.modules.get("torch")
    if torch is not None and isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    r = repr(exc)
    return "CUDA out of memory" in r or "RESOURCE_EXHAUSTED" in r \
        or "Out of memory" in r


def maybe_oom_bundle(exc: BaseException,
                     host: Optional[str] = None) -> Optional[str]:
    """On an OOM, write a blackbox bundle carrying the census and the
    memory view before the error propagates.  A no-op unless this plane
    and the blackbox plane are armed; returns the bundle path or
    ``None``, never raises."""
    if not enabled() or not is_oom(exc):
        return None
    _arm_once()
    try:
        from dt_tpu_torch.obs import blackbox
        if not blackbox.enabled():
            return None
        extra: Dict[str, Any] = {"error": repr(exc)[-500:]}
        try:
            extra["census"] = live_buffer_census(_CENSUS_TOP)
        except Exception:  # noqa: BLE001
            pass
        try:
            extra["mem"] = memory_snapshot()
        except Exception:  # noqa: BLE001
            pass
        obs_trace.tracer().event("device.oom",
                                 {"error": extra["error"][:200]})
        blackbox.note("device.oom", host=host)
        return blackbox.write_bundle("oom", host=host, fatal=True,
                                     extra=extra)
    except Exception:  # noqa: BLE001
        return None


# ---------------------------------------------------------------------------
# on-demand torch.profiler capture (the profile_capture command)
# ---------------------------------------------------------------------------

_CAPTURE: Optional[dict] = None  # guarded-by: _LOCK
_CAPTURE_SEQ = 0  # last capture-command seq applied; guarded-by: _LOCK
_WIRE_SEQ = 0  # dev-payload order (dseq); guarded-by: _LOCK
_PROF = None  # the capture's live torch.profiler.profile (training thread)


def capture_seq() -> int:
    """The last ``profile_capture`` seq applied: the heartbeat's dedup
    cursor (``cseq``)."""
    with _LOCK:
        return _CAPTURE_SEQ


def handle_capture_cmds(cmds, host: Optional[str] = None) -> int:
    """Arm the capture commands a heartbeat delivered (seq-guarded: a
    re-delivery is a no-op).  Returns how many armed."""
    armed = 0
    for c in cmds or ():
        try:
            if arm_capture(int(c.get("steps", 8)), seq=int(c["seq"]),
                           host=host):
                armed += 1
        except (KeyError, TypeError, ValueError):
            continue
    return armed


def _profiler_busy() -> bool:
    """Whether a profiler session already runs in this process (the
    port's ``utils.profiler`` or any ``torch.profiler``)."""
    import sys
    prof = sys.modules.get("dt_tpu_torch.utils.profiler")
    if prof is not None and prof.running():
        return True
    torch = sys.modules.get("torch")
    return bool(torch is not None
                and torch._C._autograd._profiler_enabled())


def _fail_capture(cap: dict, why: str) -> None:
    """A capture that cannot run says so everywhere an operator looks."""
    from dt_tpu_torch.obs import blackbox
    logger.error("profile capture %s (seq %s) failed: %s", cap.get("dir"),
                 cap.get("seq"), why)
    obs_trace.tracer().event("profile.capture",
                             {"seq": cap.get("seq"), "dir": cap.get("dir"),
                              "error": why[:200]})
    blackbox.note("profile.capture", phase="failed", dir=cap.get("dir"),
                  error=why[:200])
    blackbox.manifest_append({
        "kind": "profile_capture", "ts_ms": int(time.time() * 1000),
        "pid": os.getpid(), "host": cap.get("host"),
        "trigger": "profile.capture", "seq": cap.get("seq"),
        "dir": cap.get("dir"), "error": why[:500]})


def arm_capture(steps: int, seq: int = 0, outdir: Optional[str] = None,
                host: Optional[str] = None) -> bool:
    """Arm a bounded ``steps``-step ``torch.profiler`` capture: it starts
    at the next :func:`capture_tick` and stops ``steps`` ticks later.
    Seq-guarded, one at a time; a profiler already running fails the
    capture loudly."""
    global _CAPTURE, _CAPTURE_SEQ
    if not enabled():
        return False
    _arm_once()
    from dt_tpu_torch.obs import blackbox
    with _LOCK:
        if seq and seq <= _CAPTURE_SEQ:
            return False
        if _CAPTURE is not None:
            # one at a time; the cursor stays, so the heartbeat's
            # re-delivery arms this one once the slot frees
            return False
        if seq:
            _CAPTURE_SEQ = seq
        d = outdir or os.path.join(blackbox.bundle_dir(),
                                   f"profile-{seq or int(time.time())}")
        cap = {"steps": max(1, int(steps)), "left": max(1, int(steps)),
               "dir": d, "seq": seq, "started": False, "host": host}
        busy = _profiler_busy()
        if not busy:
            _CAPTURE = cap
    if busy:
        _fail_capture(cap, "a profiler session is already running in this "
                           "process (one profiler a process)")
        return False
    blackbox.note("profile.capture", phase="armed", steps=steps, host=host)
    return True


def _start_trace(d: str) -> None:
    global _PROF
    import torch
    from torch.profiler import ProfilerActivity, profile
    if _profiler_busy():
        raise RuntimeError("a profiler session is already running in this "
                           "process (one profiler a process)")
    os.makedirs(d, exist_ok=True)
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()  # earlier steps' kernels stay out
    prof = profile(activities=acts)
    prof.start()
    _PROF = prof


def _stop_trace(d: str) -> None:
    global _PROF
    import torch
    prof, _PROF = _PROF, None
    if prof is None:
        return
    if torch.cuda.is_available():
        torch.cuda.synchronize()  # the last step's kernels are in
    prof.stop()
    prof.export_chrome_trace(os.path.join(d, "trace.json"))


def capture_tick() -> None:
    """One step's tick (``Module.fit``, beside the watchdog's beat): one
    global ``None`` check unless a capture is armed.  Runs on the training
    thread, which alone drives the profiler."""
    global _CAPTURE
    if _CAPTURE is None:
        return
    with _LOCK:
        cap = _CAPTURE
        if cap is None:
            return
        if not cap["started"]:
            cap["started"] = True
            start, stop = True, False
        else:
            cap["left"] -= 1
            start = False
            stop = cap["left"] <= 0
            if stop:
                _CAPTURE = None
    try:
        if start:
            _start_trace(cap["dir"])
        if stop:
            _stop_trace(cap["dir"])
            from dt_tpu_torch.obs import blackbox
            obs_trace.tracer().event("profile.capture",
                                     {"steps": cap["steps"],
                                      "dir": cap["dir"],
                                      "seq": cap["seq"]})
            blackbox.note("profile.capture", phase="done",
                          steps=cap["steps"], dir=cap["dir"])
            blackbox.manifest_append({
                "kind": "profile_capture",
                "ts_ms": int(time.time() * 1000), "pid": os.getpid(),
                "host": cap.get("host"), "trigger": "profile.capture",
                "steps": cap["steps"], "seq": cap["seq"],
                "dir": cap["dir"]})
    except Exception as e:  # noqa: BLE001 — the step loop goes on; the
        # failure is logged, traced and in the manifest
        with _LOCK:
            _CAPTURE = None
        _fail_capture(cap, repr(e))


def capture_abort() -> None:
    """Close a capture the step loop cannot finish (fit returns early):
    the profiler stops and the manifest records the truncated capture."""
    global _CAPTURE
    if _CAPTURE is None:
        return
    with _LOCK:
        cap = _CAPTURE
        _CAPTURE = None
    if cap is None or not cap["started"]:
        return
    try:
        _stop_trace(cap["dir"])
        from dt_tpu_torch.obs import blackbox
        done = cap["steps"] - cap["left"]
        obs_trace.tracer().event("profile.capture",
                                 {"steps": done, "dir": cap["dir"],
                                  "seq": cap["seq"], "aborted": True})
        blackbox.note("profile.capture", phase="aborted",
                      steps=done, dir=cap["dir"])
        blackbox.manifest_append({
            "kind": "profile_capture", "aborted": True,
            "ts_ms": int(time.time() * 1000), "pid": os.getpid(),
            "host": cap.get("host"), "trigger": "profile.capture",
            "steps": done, "requested_steps": cap["steps"],
            "seq": cap["seq"], "dir": cap["dir"]})
    except Exception:  # noqa: BLE001 — teardown is best-effort
        pass


# ---------------------------------------------------------------------------
# the heartbeat's `dev` payload, and the test reset
# ---------------------------------------------------------------------------


def wire_payload() -> Optional[dict]:
    """The small device view each heartbeat carries (the JAX package's
    keys): ledger totals, the compiling-now flag the scheduler's hang
    detector reads, the memory snapshot and the capture cursor.  ``None``
    off."""
    global _WIRE_SEQ
    if not enabled():
        return None
    _arm_once()
    with _LOCK:
        compile_view = {**{k: _TOTALS[k] for k in
                           ("compiles", "recompiles", "cache_hits",
                            "cache_misses")},
                        "ms_total": _TOTALS["ms_total"],
                        "whats": sorted(_BY_WHAT)}
        cseq = _CAPTURE_SEQ
        _WIRE_SEQ += 1
        dseq = _WIRE_SEQ
    info = compiling_info()
    out = {"dseq": dseq, "cseq": cseq,
           "compiling": info["name"] if info else None,
           "compiling_age_s": info["age_s"] if info else 0.0,
           "compile": compile_view}
    try:
        out["mem"] = memory_snapshot()
    except Exception:  # noqa: BLE001 — the payload ships without it
        pass
    return out


def _reset_for_tests() -> None:
    """Drop the ledger, capture, device and provenance state (tests)."""
    global _CAPTURE, _CAPTURE_SEQ, _ARMED, _WIRE_SEQ, _PROF
    with _LOCK:
        _BY_WHAT.clear()
        _SEEN.clear()
        _RECOMPILES.clear()
        for k in _TOTALS:
            _TOTALS[k] = 0 if k != "ms_total" else 0.0
        _PROVENANCE.clear()
        _DEVICES.clear()
        _CAPTURE = None
        _CAPTURE_SEQ = 0
        _WIRE_SEQ = 0
        _ARMED = False
    _PROF = None
    _STAGING.clear()
    try:
        from dt_tpu_torch.obs import blackbox
        blackbox.unregister_state("device", _bb_state)
    except Exception:  # noqa: BLE001
        pass
