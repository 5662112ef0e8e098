"""The metrics plane (counterpart of ``dt_tpu/obs/metrics.py``, copied
since the port imports nothing of the JAX package): gauges, fixed-bucket
histograms, a bounded time-series ring, the Prometheus text exposition,
the declarative training-health SLO engine and the scheduler's HTTP
endpoint, with the training-health gates.

- ``DT_METRICS=1`` (or :func:`set_enabled`) arms the plane; a disabled
  ``gauge()``/``observe()`` is one cached-bool check and keeps nothing.
  ``DT_HEALTH_HALT=1`` stops training before a non-finite update, and
  either gate makes the steps compute the health vector.
- At most ``DT_METRICS_RING`` samples are kept; past it the oldest is
  dropped and counted.  The :class:`Sampler` thread samples the gauges
  every ``DT_METRICS_INTERVAL_S``; a worker's samples ride the heartbeat
  to the scheduler, which serves them as ``/metrics`` and ``/healthz``
  (:class:`HealthServer`, ``DT_METRICS_PORT``), the ``health`` command and
  ``obs_dump``'s sections.
- :class:`SLOEngine` evaluates :data:`DEFAULT_SLO_RULES` (overridden by
  name through ``DT_SLO_RULES``) and fires edge-triggered
  ``health.breach``/``health.clear`` events.

Imports no torch: the scheduler runs it.  Sample schema, the JAX
package's::

    {"seq": int, "ts_ms": int, "gauges": {name: float, ...}}

``seq`` rises strictly in ring order (the heartbeat export's dedup key).
"""

from __future__ import annotations

import json
import re
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from dt_tpu_torch import config
from dt_tpu_torch.obs import trace as obs_trace

# ---------------------------------------------------------------------------
# process-wide enable gate (DT_METRICS, overridable in-process)
# ---------------------------------------------------------------------------

_ENABLED_OVERRIDE: Optional[bool] = None
_ENV_ENABLED: Optional[bool] = None


def enabled() -> bool:
    """Whether the metrics plane is on for this process (``DT_METRICS=1``
    or an explicit :func:`set_enabled`)."""
    if _ENABLED_OVERRIDE is not None:
        return _ENABLED_OVERRIDE
    global _ENV_ENABLED
    if _ENV_ENABLED is None:
        _ENV_ENABLED = config.env("DT_METRICS").strip().lower() \
            in ("1", "true")
    return _ENV_ENABLED


def set_enabled(on: Optional[bool]) -> None:
    """Process-local override (``None`` = follow the env var again)."""
    global _ENABLED_OVERRIDE, _ENV_ENABLED
    _ENABLED_OVERRIDE = on
    if on is None:
        _ENV_ENABLED = None


class HealthHalt(RuntimeError):
    """A training-health sentinel tripped with ``DT_HEALTH_HALT=1``: the
    step's update was NOT applied (the compiled step skips it on a
    non-finite gradient) and the training loop must stop cleanly.
    ``Module.fit`` catches this internally; ``Trainer.step`` lets it
    propagate to the imperative caller."""


def halt_enabled() -> bool:
    """``DT_HEALTH_HALT=1``: a non-finite gradient stops training before
    the poisoned update is applied (read per step-build, not cached —
    tests flip it)."""
    return config.env("DT_HEALTH_HALT").strip().lower() in ("1", "true")


def sentinels_enabled() -> bool:
    """Whether the compiled steps should carry the fused health outputs
    (non-finite check + grad/param norms): on when either the metrics
    plane or the halt gate is armed."""
    return enabled() or halt_enabled()


# ---------------------------------------------------------------------------
# registry: gauges + fixed-bucket histograms + the time-series ring
# ---------------------------------------------------------------------------

#: default fixed bucket bounds (ms-oriented; +Inf is implicit).  Pinned
#: per histogram at first observe — fixed buckets keep merge and
#: exposition trivial (no per-sample storage).
DEFAULT_BUCKETS: Tuple[float, ...] = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1000.0, 2500.0, 5000.0, 10000.0)

_EMPTY_LABELS: Tuple[Tuple[str, str], ...] = ()


def _label_key(labels: Optional[Dict[str, str]]
               ) -> Tuple[Tuple[str, str], ...]:
    if not labels:
        return _EMPTY_LABELS
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """One process's (or server instance's) gauge/histogram sink plus the
    bounded time-series ring its unlabeled gauges are sampled into.

    The process has one default instance (:func:`registry`) — the analog
    of :func:`dt_tpu_torch.obs.trace.tracer`; servers that need isolation
    construct their own.
    """

    def __init__(self, name: str = "process",
                 capacity: Optional[int] = None,
                 wall_clock: Optional[Callable[[], int]] = None,
                 enabled: Optional[bool] = None):
        """``enabled``: ``True``/``False`` pins this instance regardless
        of the process gate; ``None`` follows :func:`enabled`.
        ``wall_clock`` returns integer nanoseconds (injectable)."""
        self.name = name
        self._cap = max(1, int(capacity if capacity is not None
                               else int(config.env("DT_METRICS_RING"))))
        self._wall = wall_clock or time.time_ns
        self._enabled = enabled
        self._lock = threading.Lock()
        self._gauges: Dict[Tuple[str, tuple], float] = {}  # guarded-by: _lock
        self._hists: Dict[Tuple[str, tuple], dict] = {}  # guarded-by: _lock
        self._series: deque = deque()  # guarded-by: _lock
        self._sseq = 0  # guarded-by: _lock
        self._dropped = 0  # guarded-by: _lock

    def on(self) -> bool:
        return self._enabled if self._enabled is not None else enabled()

    # -- recording --------------------------------------------------------

    def gauge(self, name: str, value: float,
              labels: Optional[Dict[str, str]] = None) -> None:
        """Set a gauge to ``value`` (last-write-wins; the sampler
        snapshots it into the time-series ring).  No-op when the plane
        is off."""
        if not self.on():
            return
        with self._lock:
            self._gauges[(name, _label_key(labels))] = float(value)

    def observe(self, name: str, value: float,
                labels: Optional[Dict[str, str]] = None,
                buckets: Optional[Sequence[float]] = None) -> None:
        """Fold ``value`` into a fixed-bucket histogram (bounds pinned at
        first observe; default :data:`DEFAULT_BUCKETS`).  No-op when the
        plane is off."""
        if not self.on():
            return
        v = float(value)
        with self._lock:
            key = (name, _label_key(labels))
            h = self._hists.get(key)
            if h is None:
                bs = tuple(float(b) for b in (buckets or DEFAULT_BUCKETS))
                h = {"buckets": bs, "counts": [0] * (len(bs) + 1),
                     "sum": 0.0, "count": 0}
                self._hists[key] = h
            i = 0
            bs = h["buckets"]
            while i < len(bs) and v > bs[i]:
                i += 1
            h["counts"][i] += 1
            h["sum"] += v
            h["count"] += 1

    def sample(self, now_ms: Optional[int] = None) -> Optional[dict]:
        """Snapshot the UNLABELED gauges into one time-series sample and
        append it to the ring (overflow drops the oldest, counted).
        Labeled gauges stay out of the series — they are per-entity
        last-values for the exposition surface, not a per-process
        trajectory.  Returns the sample, or ``None`` when the plane is
        off."""
        if not self.on():
            return None
        with self._lock:
            self._sseq += 1
            rec = {"seq": self._sseq,
                   "ts_ms": int(now_ms if now_ms is not None
                                else self._wall() // 1_000_000),
                   "gauges": {n: v for (n, lk), v in self._gauges.items()
                              if lk == _EMPTY_LABELS}}
            if len(self._series) >= self._cap:
                self._series.popleft()
                self._dropped += 1
            self._series.append(rec)
            return rec

    # -- export -----------------------------------------------------------

    def dropped(self) -> int:
        with self._lock:
            return self._dropped

    def series(self) -> List[dict]:
        """Non-destructive copy of the retained time-series ring."""
        with self._lock:
            return list(self._series)

    def drain_series(self, max_samples: Optional[int] = None) -> List[dict]:
        """Remove and return up to ``max_samples`` OLDEST samples (the
        heartbeat flush takes bounded bites, like the span ring's)."""
        with self._lock:
            if max_samples is None or max_samples >= len(self._series):
                out = list(self._series)
                self._series.clear()
            else:
                out = [self._series.popleft() for _ in range(max_samples)]
            return out

    def gauges_export(self) -> List[list]:
        """Sorted ``[[name, {labels}, value], ...]`` (JSON/wire-safe)."""
        with self._lock:
            return [[n, dict(lk), v] for (n, lk), v in
                    sorted(self._gauges.items())]

    def hists_export(self) -> List[list]:
        """Sorted ``[[name, {labels}, {buckets, counts, sum, count}]]``."""
        with self._lock:
            return [[n, dict(lk),
                     {"buckets": list(h["buckets"]),
                      "counts": list(h["counts"]),
                      "sum": h["sum"], "count": h["count"]}]
                    for (n, lk), h in sorted(self._hists.items())]

    def hist_quantile(self, name: str, q: float,
                      labels: Optional[Dict[str, str]] = None
                      ) -> Optional[float]:
        """Nearest-upper-bound quantile estimate off the fixed buckets
        (the classic Prometheus ``histogram_quantile`` read); ``None``
        when the histogram is empty/absent."""
        with self._lock:
            h = self._hists.get((name, _label_key(labels)))
            if h is None or not h["count"]:
                return None
            rank = q * h["count"]
            acc = 0
            for i, c in enumerate(h["counts"]):
                acc += c
                if acc >= rank:
                    return h["buckets"][i] if i < len(h["buckets"]) \
                        else float("inf")
            return float("inf")

    def snapshot(self) -> Dict[str, Any]:
        """{name, gauges, hists, series, dropped, seq} — the health-RPC /
        exposition view."""
        with self._lock:
            seq = self._sseq
        return {"name": self.name, "gauges": self.gauges_export(),
                "hists": self.hists_export(), "series": self.series(),
                "dropped": self.dropped(), "seq": seq}

    def forget_label(self, key: str, value: str) -> None:
        """Drop every gauge/histogram whose labels carry
        ``key=value`` — membership removals scrub an evicted worker's
        series so the exposition and SLO inputs stop advertising it as
        live (the scheduler's ``_policy_forget`` analog)."""
        pair = (str(key), str(value))
        with self._lock:
            for k in [k for k in self._gauges if pair in k[1]]:
                del self._gauges[k]
            for k in [k for k in self._hists if pair in k[1]]:
                del self._hists[k]

    def clear(self) -> None:
        """Reset everything (tests; the process registry is shared)."""
        with self._lock:
            self._gauges.clear()
            self._hists.clear()
            self._series.clear()
            self._sseq = 0
            self._dropped = 0


_DEFAULT: Optional[MetricsRegistry] = None
_DEFAULT_LOCK = threading.Lock()


def registry() -> MetricsRegistry:
    """The process-wide default registry (one worker process = one
    metrics track, matching the trace-plane track model)."""
    global _DEFAULT
    if _DEFAULT is None:
        with _DEFAULT_LOCK:
            if _DEFAULT is None:
                _DEFAULT = MetricsRegistry(name="process")
    return _DEFAULT


def interval_s() -> float:
    """The wall-clock sampling cadence (``DT_METRICS_INTERVAL_S``)."""
    return float(config.env("DT_METRICS_INTERVAL_S"))


class Sampler:
    """Background wall-clock sampler: every ``interval_s`` runs the
    optional ``hook()`` (e.g. the scheduler's gauge refresh + SLO pass)
    then ``reg.sample()``.  Daemon thread; ``stop()`` is idempotent and
    joins bounded.  Never raises out of the loop — a metrics bug must
    not kill a worker."""

    def __init__(self, reg: MetricsRegistry,
                 interval: Optional[float] = None,
                 hook: Optional[Callable[[], None]] = None,
                 tracer: Optional[obs_trace.Tracer] = None):
        self._reg = reg
        self._interval = float(interval if interval is not None
                               else interval_s())
        self._hook = hook
        self._tracer = tracer
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"dt-metrics-{reg.name}")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self._interval):
            self.tick()

    def tick(self) -> None:
        """One sampling pass (also callable directly from tests).  The
        hook and the sample are swallowed SEPARATELY: a persistently
        raising hook must not silently stop the time-series too."""
        try:
            if self._hook is not None:
                self._hook()
        except Exception:  # noqa: BLE001 — observability is never fatal
            pass
        try:
            self._reg.sample()
            (self._tracer or obs_trace.tracer()).counter("metrics.samples")
        except Exception:  # noqa: BLE001 — observability is never fatal
            pass

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not threading.current_thread():
            self._thread.join(timeout=2.0)


# ---------------------------------------------------------------------------
# Prometheus text exposition (format version 0.0.4)
# ---------------------------------------------------------------------------

_PROM_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")
_LABEL_SANITIZE = re.compile(r"[^a-zA-Z0-9_]")


def prom_name(name: str) -> str:
    """``train.loss`` -> ``dt_train_loss`` (the project namespace keeps
    scraped jobs collision-free)."""
    return "dt_" + _PROM_SANITIZE.sub("_", name)


def _prom_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    parts = []
    for k, v in sorted(labels.items()):
        v = str(v).replace("\\", "\\\\").replace('"', '\\"') \
            .replace("\n", "\\n")
        parts.append(f'{_LABEL_SANITIZE.sub("_", str(k))}="{v}"')
    return "{" + ",".join(parts) + "}"


def _prom_num(v: float) -> str:
    f = float(v)
    if f != f:
        # a NaN gauge is exactly what a training-health incident looks
        # like — the exposition must render it, not 500 the scrape
        return "NaN"
    if f == float("inf"):
        return "+Inf"
    if f == float("-inf"):
        return "-Inf"
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def _help_for(name: str) -> str:
    """One-line HELP text from the obs name catalog when the metric is
    declared there (``obs/names.py``); empty otherwise."""
    try:
        from dt_tpu_torch.obs import names
        return names.lookup(name)[2].replace("\n", " ")
    except KeyError:
        return ""


# deterministic: bytes — the exposition golden-file contract
def render_prometheus(jobs: Sequence[Tuple[Dict[str, str], Dict[str, Any],
                                           Dict[str, int]]]) -> str:
    """Render Prometheus text exposition from one or more label-scoped
    sections.

    ``jobs`` is ``[(base_labels, snapshot, counters), ...]`` where
    ``snapshot`` follows :meth:`MetricsRegistry.snapshot` (only
    ``gauges``/``hists`` are read) and ``counters`` is a plain
    name→int map (the tracer's live counters).  Families are merged
    across sections (one HELP/TYPE block per metric, samples carrying
    each section's base labels) and the output is byte-deterministic
    for a given input — the golden-file contract."""
    gauges: Dict[str, List[Tuple[Dict[str, str], float]]] = {}
    hists: Dict[str, List[Tuple[Dict[str, str], dict]]] = {}
    counters: Dict[str, List[Tuple[Dict[str, str], int]]] = {}
    for base, snap, ctrs in jobs:
        for n, lk, v in (snap or {}).get("gauges", ()):
            gauges.setdefault(n, []).append(({**base, **dict(lk)}, v))
        for n, lk, h in (snap or {}).get("hists", ()):
            hists.setdefault(n, []).append(({**base, **dict(lk)}, h))
        for n, v in sorted((ctrs or {}).items()):
            counters.setdefault(n, []).append((dict(base), int(v)))
    lines: List[str] = []
    for n in sorted(gauges):
        pn = prom_name(n)
        doc = _help_for(n)
        if doc:
            lines.append(f"# HELP {pn} {doc}")
        lines.append(f"# TYPE {pn} gauge")
        for labels, v in sorted(gauges[n], key=lambda e: sorted(
                e[0].items())):
            lines.append(f"{pn}{_prom_labels(labels)} {_prom_num(v)}")
    for n in sorted(counters):
        pn = prom_name(n) + "_total"
        doc = _help_for(n)
        if doc:
            lines.append(f"# HELP {pn} {doc}")
        lines.append(f"# TYPE {pn} counter")
        for labels, v in sorted(counters[n], key=lambda e: sorted(
                e[0].items())):
            lines.append(f"{pn}{_prom_labels(labels)} {_prom_num(v)}")
    for n in sorted(hists):
        pn = prom_name(n)
        doc = _help_for(n)
        if doc:
            lines.append(f"# HELP {pn} {doc}")
        lines.append(f"# TYPE {pn} histogram")
        for labels, h in sorted(hists[n], key=lambda e: sorted(
                e[0].items())):
            acc = 0
            for b, c in zip(list(h["buckets"]) + [float("inf")],
                            h["counts"]):
                acc += c
                le = {**labels, "le": _prom_num(b)}
                lines.append(f"{pn}_bucket{_prom_labels(le)} {acc}")
            lines.append(f"{pn}_sum{_prom_labels(labels)} "
                         f"{_prom_num(h['sum'])}")
            lines.append(f"{pn}_count{_prom_labels(labels)} {h['count']}")
    return "\n".join(lines) + ("\n" if lines else "")


#: promtool-style line grammar (no external dep): comments, or
#: ``name{labels} value [timestamp]`` — the test's format check and the
#: exposition's self-check share it
PROM_LINE_RE = re.compile(
    r"^(#\s(HELP|TYPE)\s[a-zA-Z_:][a-zA-Z0-9_:]*(\s.*)?"
    r"|[a-zA-Z_:][a-zA-Z0-9_:]*"
    r"(\{[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\""
    r"(,[a-zA-Z_][a-zA-Z0-9_]*=\"(?:[^\"\\]|\\.)*\")*\})?"
    r"\s[-+]?(Inf|NaN|[0-9.eE+-]+)(\s[0-9]+)?)$")


# ---------------------------------------------------------------------------
# declarative SLO engine
# ---------------------------------------------------------------------------

#: the default rule set.  ``threshold: 0`` with op ``<`` means "no floor
#: configured" — the rule is declared (operators see it in the health
#: view and can arm it via DT_SLO_RULES) but never breaches.
#: ``per_worker`` rules take a {worker: value} input and blame the worst
#: violator; scalar rules blame nobody.  ``source: "export"`` rules are
#: evaluated post-hoc over the merged summary (the causal join only
#: exists there).
DEFAULT_SLO_RULES: Tuple[Dict[str, Any], ...] = (
    {"name": "step_rate", "metric": "worker.step_rate", "op": "<",
     "threshold": 0.0, "per_worker": True,
     "doc": "per-worker training step rate floor (steps/s; 0 = unarmed)"},
    {"name": "round_wait", "metric": "round.wait_ms", "op": ">",
     "threshold": 500.0, "per_worker": True,
     "doc": "per-worker round-contribution-lag EWMA ceiling (ms)"},
    {"name": "heartbeat_staleness", "metric": "sched.heartbeat_staleness_s",
     "op": ">", "threshold": 30.0, "per_worker": True,
     "doc": "seconds since a live worker's last heartbeat"},
    {"name": "journal_append_p99", "metric": "journal.append_ms.p99",
     "op": ">", "threshold": 250.0,
     "doc": "control-journal fsync-append latency p99 ceiling (ms)"},
    {"name": "ring_drop", "metric": "obs.ring_dropped", "op": ">",
     "threshold": 1000.0,
     "doc": "total obs ring/pending records shed job-wide"},
    {"name": "causal_orphans", "metric": "causal.orphan_rate", "op": ">",
     "threshold": 0.05, "source": "export",
     "doc": "fraction of answered client spans with no handler span"},
)

#: bounded breach/clear transition history kept by the engine
_SLO_HISTORY_MAX = 64


class SLOEngine:
    """Edge-triggered evaluation of a declarative SLO rule list.

    Rules are plain dicts (see :data:`DEFAULT_SLO_RULES`);
    ``DT_SLO_RULES`` (JSON list, or ``@/path``) overrides by ``name`` —
    a row with a known name replaces that default, an unknown name
    appends — so one env var re-arms a threshold without restating the
    whole set.  ``evaluate`` takes a flat input map, flips per-rule
    breach state, emits ``health.breach``/``health.clear`` events on
    the given tracer (each carrying the blamed worker), and keeps a
    bounded transition history for the health view."""

    def __init__(self, rules: Optional[Sequence[Dict[str, Any]]] = None):
        self.rules: List[Dict[str, Any]] = \
            [dict(r) for r in (rules if rules is not None
                               else DEFAULT_SLO_RULES)]
        for r in self.rules:
            # fail loudly at construction, never mid-evaluate: a typo'd
            # DT_SLO_RULES row would otherwise either invert the rule's
            # direction (unrecognized op falling through to "<") or
            # KeyError inside the background sampler's swallowed pass —
            # silently killing breach detection for the job's lifetime
            if not r.get("name") or not r.get("metric"):
                raise ValueError(
                    f"SLO rule needs 'name' and 'metric': {r!r}")
            if r.get("op", ">") not in (">", "<"):
                raise ValueError(
                    f"SLO rule {r.get('name')!r}: op must be '>' or "
                    f"'<', got {r.get('op')!r}")
        self._lock = threading.Lock()
        self._active: Dict[str, dict] = {}  # guarded-by: _lock
        self._history: List[dict] = []  # guarded-by: _lock

    @classmethod
    def from_env(cls) -> "SLOEngine":
        """Defaults overlaid with ``DT_SLO_RULES`` (by rule name)."""
        spec = config.env("DT_SLO_RULES")
        if not spec:
            return cls()
        if spec.startswith("@"):
            with open(spec[1:]) as f:
                text = f.read()
        else:
            text = spec
        overrides = json.loads(text)
        rules = [dict(r) for r in DEFAULT_SLO_RULES]
        by_name = {r["name"]: r for r in rules}
        for o in overrides:
            tgt = by_name.get(o.get("name"))
            if tgt is not None:
                tgt.update(o)
            else:
                rules.append(dict(o))
        return cls(rules)

    @staticmethod
    def _violates(op: str, value: float, threshold: float) -> bool:
        return value > threshold if op == ">" else value < threshold

    def evaluate(self, inputs: Dict[str, Any],
                 tracer: Optional[obs_trace.Tracer] = None,
                 now_ms: Optional[int] = None,
                 source: str = "live") -> List[dict]:
        """One pass: rules whose ``source`` matches and whose metric is
        present flip breach state; returns this pass's transitions
        (``what``: breach|clear), each ``{rule, worker, value,
        threshold, ts_ms, what}``."""
        ts = int(now_ms if now_ms is not None else time.time() * 1000)
        out: List[dict] = []
        with self._lock:
            for rule in self.rules:
                if rule.get("source", "live") != source:
                    continue
                thr = float(rule.get("threshold", 0.0))
                if rule.get("op", ">") == "<" and thr <= 0.0:
                    continue  # unarmed floor
                val = inputs.get(rule["metric"])
                if val is None:
                    continue
                # shape guard: a rule whose per_worker flag disagrees
                # with the input's shape is skipped, not raised — an
                # exception here would abort the remaining rules and
                # (via the sampler's swallow) silently kill breach
                # detection for the job
                if bool(rule.get("per_worker")) != isinstance(val, dict):
                    continue
                worker = None
                if rule.get("per_worker"):
                    worst = None
                    for h, v in (val or {}).items():
                        if self._violates(rule.get("op", ">"),
                                          float(v), thr) and \
                                (worst is None or
                                 self._worse(rule, v, worst[1])):
                            worst = (h, float(v))
                    breached = worst is not None
                    if breached:
                        worker, value = worst
                    else:
                        value = None
                else:
                    value = float(val)
                    breached = self._violates(rule.get("op", ">"),
                                              value, thr)
                name = rule["name"]
                was = name in self._active
                if breached and not was:
                    entry = {"rule": name, "worker": worker,
                             "value": round(value, 4), "threshold": thr,
                             "ts_ms": ts, "what": "breach"}
                    self._active[name] = entry
                    self._record_locked(entry, tracer, out)
                elif breached and was:
                    # refresh blame/value without re-firing the event
                    self._active[name].update(
                        {"worker": worker, "value": round(value, 4),
                         "ts_ms": ts})
                elif not breached and was:
                    self._active.pop(name)
                    entry = {"rule": name, "worker": worker,
                             "value": None if value is None
                             else round(value, 4),
                             "threshold": thr, "ts_ms": ts,
                             "what": "clear"}
                    self._record_locked(entry, tracer, out)
        return out

    @staticmethod
    def _worse(rule: Dict[str, Any], a: float, b: float) -> bool:
        return a > b if rule.get("op", ">") == ">" else a < b

    def _record_locked(self, entry: dict,
                       tracer: Optional[obs_trace.Tracer],
                       out: List[dict]) -> None:
        """Append one transition + emit its event.  Caller holds the
        lock.  The history gets a COPY: the active-breach entry keeps
        being refreshed in place (blame/value/ts) on later passes, and
        that must not retroactively rewrite the recorded at-breach
        transition."""
        self._history.append(dict(entry))
        del self._history[:-_SLO_HISTORY_MAX]
        out.append(entry)
        if tracer is not None:
            attrs = {k: v for k, v in entry.items() if k != "what"}
            if entry["what"] == "breach":
                tracer.event("health.breach", attrs)
            else:
                tracer.event("health.clear", attrs)

    def state(self) -> Dict[str, Any]:
        """The health view: rules + active breaches + bounded history."""
        with self._lock:
            return {"rules": [dict(r) for r in self.rules],
                    "active": {k: dict(v)
                               for k, v in sorted(self._active.items())},
                    "history": [dict(e) for e in self._history]}


# ---------------------------------------------------------------------------
# the health/exposition HTTP plane (scheduler-side)
# ---------------------------------------------------------------------------


class HealthServer:
    """Tiny threaded HTTP server: ``GET /metrics`` serves Prometheus
    text exposition from ``metrics_fn()``, ``GET /healthz`` serves the
    health view JSON from ``health_fn()`` (stdlib ``http.server``);
    bound to ``DT_ELASTIC_BIND`` like the wire plane.
    Port 0 binds an ephemeral port (tests) — read back via ``.port``."""

    def __init__(self, port: int,
                 metrics_fn: Callable[[], str],
                 health_fn: Callable[[], dict],
                 host: Optional[str] = None):
        import http.server

        class _Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server contract
                try:
                    if self.path.split("?")[0] == "/metrics":
                        obs_trace.tracer().counter("metrics.scrapes")
                        body = metrics_fn().encode()
                        ctype = ("text/plain; version=0.0.4; "
                                 "charset=utf-8")
                    elif self.path.split("?")[0] in ("/healthz",
                                                     "/health"):
                        body = json.dumps(health_fn(),
                                          sort_keys=True).encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                except Exception as e:  # noqa: BLE001 — a handler bug
                    # must answer 500, not kill the serving thread
                    self.send_error(500, repr(e)[:120])
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request stderr spam
                del a

        bind = host if host is not None else config.env("DT_ELASTIC_BIND")
        self._srv = http.server.ThreadingHTTPServer(
            (bind or "0.0.0.0", int(port)), _Handler)
        self._srv.daemon_threads = True
        self.port = self._srv.server_address[1]
        self._thread = threading.Thread(target=self._srv.serve_forever,
                                        daemon=True,
                                        name="dt-metrics-http")
        self._thread.start()

    def close(self) -> None:
        try:
            self._srv.shutdown()
            self._srv.server_close()
        except Exception:  # noqa: BLE001 — close is best-effort
            pass
        self._thread.join(timeout=2.0)
