"""The merged chrome://tracing export and the job summary (counterpart
of ``dt_tpu/obs/export.py``, copied since the port imports nothing of the
JAX package).

The scheduler gathers every worker incarnation's span ring (shipped on the
heartbeat by ``elastic/client.py``) and this module renders one timeline:

- :func:`chrome_trace`: ``{"traceEvents": [...]}`` with a process track a
  worker incarnation (``host#pid``) plus the scheduler's
  ``control-plane`` track, loadable in chrome://tracing or Perfetto;
- :func:`summarize_chrome`: step-time percentiles, stall attribution, the
  per-track retry and fault counts, the membership timeline, the causal
  join of client and server spans (:func:`_causal_and_critical`), the
  critical path of each step with its blamed worker, and the straggler,
  health, device and policy sections (``tools/dtop.py`` renders them);
- :func:`write`: the chrome trace to ``PATH`` and the summary to
  :func:`metrics_path` (``PATH`` with a ``.metrics.json`` suffix),
  byte-deterministic.

Input ``job`` dicts come from ``Scheduler.obs_dump()`` (either package's)::

    {"tracks": {"w0#4242": {"records": [...], "counters": {...},
                            "dropped": 0}, ...,
                "control-plane": {...}}}

with records in ``obs/trace.py``'s flat-tuple schema.  Imports neither
torch nor numpy.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

#: span names attributed to "stall" (time training waited on the control
#: or data plane) in the summary.  Deliberately only the TOP-LEVEL
#: blocking spans: wire.request spans are excluded because (a) transport
#: time inside an allreduce/barrier is already inside that span (adding
#: it would double-count) and (b) background heartbeat RTTs are not
#: training stall at all.
STALL_SPANS = ("mc_barrier", "allreduce", "allreduce_sparse",
               "recovery.rejoin")

#: overlap-pipeline stage spans (``training/overlap.py`` +
#: ``elastic/client.py`` AllreducePipeline).  NOT stall spans: they run
#: concurrently with (and inside the wall-clock of) the top-level
#: ``allreduce`` span, so summing them alongside it would double-count;
#: the summary reports them as a separate per-stage attribution split —
#: where the overlapped step's time went (d2h / wire / h2d).
PIPELINE_PREFIX = "pipeline."


def chrome_trace(job: Dict[str, Any]) -> Dict[str, Any]:
    """Render a job dump into one chrome://tracing JSON object.

    r13 causal join: spans carry ids (``span_id`` slot of the record
    schema), and server-side handler spans name the client span they
    serve in an ``attrs["link"] = [origin_track, span_id]`` pair — for
    every such pair whose source span is present, a chrome flow
    (``ph: "s"`` on the client span → ``ph: "f"`` on the handler span,
    id ``"<origin>:<sid>"``) is emitted, so Perfetto draws the arrow
    from each ``wire.request`` to the server work it caused."""
    events: List[dict] = []
    other: Dict[str, Any] = {"tracks": {}}
    if "straggler" in job:
        other["straggler"] = dict(job["straggler"] or {})
    if "policy" in job:
        # r14 policy view (shares / streaks / decision log) rides the
        # export like the straggler board: dtop's policy section and the
        # chaos straggler checks read it from the summary
        other["policy"] = dict(job["policy"] or {})
    if "health" in job:
        # r15 health plane (SLO state + gauges) and the per-track
        # metrics time-series ride the export the same way — dtop's
        # health board and the chaos SLO checks read them from the
        # summary / .metrics.json
        other["health"] = dict(job["health"] or {})
    if "metrics" in job:
        other["metrics"] = dict(job["metrics"] or {})
    if "device" in job:
        # r18 device plane (compile observatory + memory view) rides
        # the export like policy/health: dtop's device board and the
        # chaos compile/memory cross-checks read it from the summary
        other["device"] = dict(job["device"] or {})
    if "serving" in job:
        # r21 serving plane (replica table + autoscale decision log)
        # rides the export the same way — dtop's serving board and the
        # serve chaos checks read it from the summary
        other["serving"] = dict(job["serving"] or {})
    # pass 1: index every id-carrying span by (track, sid) so pass 2 can
    # bind flow starts to the exact client slice
    span_at: Dict[tuple, dict] = {}
    ordered = sorted((job.get("tracks") or {}).items())
    for pid, (track, data) in enumerate(ordered, start=1):
        for rec in data.get("records", ()):
            if rec[0] == "X" and rec[6] is not None:
                span_at[(track, rec[6])] = {"pid": pid, "tid": rec[5],
                                            "ts": rec[3], "dur": rec[4]}
    for pid, (track, data) in enumerate(ordered, start=1):
        events.append({"ph": "M", "name": "process_name", "pid": pid,
                       "tid": 0, "args": {"name": track}})
        for rec in data.get("records", ()):
            ph, rseq, name, ts_us, dur_us, tid, sid, parent, attrs = rec
            args = dict(attrs or {})
            args["seq"] = rseq
            if sid is not None:
                args["sid"] = sid
            if parent is not None:
                args["parent"] = parent
            ev = {"ph": "X" if ph == "X" else "i", "name": name,
                  "cat": "obs", "pid": pid, "tid": tid, "ts": ts_us,
                  "args": args}
            if ph == "X":
                ev["dur"] = dur_us
            else:
                ev["s"] = "t"
            events.append(ev)
            link = (attrs or {}).get("link")
            if ph == "X" and isinstance(link, (list, tuple)) \
                    and len(link) == 2:
                src = span_at.get((link[0], link[1]))
                if src is not None:
                    fid = f"{link[0]}:{link[1]}"
                    events.append({"ph": "s", "id": fid, "cat": "rpc",
                                   "name": "rpc", "pid": src["pid"],
                                   "tid": src["tid"], "ts": src["ts"]})
                    events.append({"ph": "f", "bp": "e", "id": fid,
                                   "cat": "rpc", "name": "rpc",
                                   "pid": pid, "tid": tid, "ts": ts_us})
        other["tracks"][track] = {
            "counters": dict(data.get("counters") or {}),
            "dropped": int(data.get("dropped") or 0)}
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": other}


#: per-track per-step entries kept in the critical-path section; later
#: steps are aggregated into the totals but not listed (bounds the
#: .metrics.json size on long runs — the truncation is flagged)
_MAX_PER_STEP = 512


def _causal_and_critical(chrome: Dict[str, Any],
                         track_of_pid: Dict[int, str]) -> Dict[str, Any]:
    """Causal-integrity counts + the per-step critical-path
    decomposition (r13).

    Causal: every client ``wire.request`` span carries its ``sid``;
    every server handler span (``rpc.<cmd>``) carries
    ``link=[origin_track, sid]``.  A client span is *matched* when
    exactly one handler span links to it; *orphans* (answered requests
    whose handler span is missing) are bounded by the server-side ring
    ``dropped`` counters, and *server_unmatched* handler spans arise
    when the client's span was lost (its ring/pending shed) or the
    client never got the reply (reset-fault replay windows).

    Critical path: for each worker track's ``step`` span, the step's
    wall-clock is decomposed into compute (step minus blocking sync
    spans) + the sync pipeline's stages: ``d2h`` / ``h2d`` (staging
    spans), and — per linked allreduce ``wire.request`` — client→server
    ``send``, server-side ``straggler_wait`` (the round's
    wait-for-last-contributor window this request sat through,
    attributed to the round's ``last`` contributor), the remaining
    server ``queue`` time, and ``reply``.  Stage spans run concurrently
    across buckets, so the stage sums can exceed the step wall-clock
    exactly when the overlap pipeline is working — same convention as
    the ``pipeline_ms`` split."""
    client: Dict[tuple, dict] = {}    # (track, sid) -> wire.request span
    handlers: Dict[tuple, list] = {}  # link key -> [handler spans]
    per_track: Dict[str, dict] = {}
    for ev in chrome.get("traceEvents", ()):
        if ev.get("ph") != "X":
            continue
        track = track_of_pid.get(ev.get("pid"), f"pid{ev.get('pid')}")
        name = ev.get("name", "")
        args = ev.get("args") or {}
        tr = per_track.setdefault(track, {"steps": [], "d2h": [],
                                          "h2d": [], "stall": [],
                                          "wire": []})
        if name == "step":
            tr["steps"].append(ev)
        elif name == "pipeline.d2h":
            tr["d2h"].append(ev)
        elif name == "pipeline.h2d":
            tr["h2d"].append(ev)
        elif name in STALL_SPANS:
            tr["stall"].append(ev)
        elif name == "wire.request":
            tr["wire"].append(ev)
            if args.get("sid") is not None:
                client[(track, args["sid"])] = ev
        elif name.startswith("rpc."):
            link = args.get("link")
            if isinstance(link, (list, tuple)) and len(link) == 2:
                handlers.setdefault((link[0], link[1]), []).append(ev)

    matched = sum(1 for k in client if len(handlers.get(k, ())) == 1)
    multi = sum(1 for k in client if len(handlers.get(k, ())) > 1)
    server_unmatched = sum(len(v) for k, v in handlers.items()
                           if k not in client)
    causal = {"client_spans": len(client), "matched": matched,
              "orphans": len(client) - matched - multi,
              "multi_linked": multi,
              "server_spans": sum(len(v) for v in handlers.values()),
              "server_unmatched": server_unmatched}

    def in_window(ev, t0, t1):
        return t0 <= ev.get("ts", 0) < t1

    critical: Dict[str, Any] = {}
    for track, tr in sorted(per_track.items()):
        if not tr["steps"]:
            continue
        totals = {"compute_ms": 0.0, "d2h_ms": 0.0, "send_ms": 0.0,
                  "server_queue_ms": 0.0, "straggler_wait_ms": 0.0,
                  "reply_ms": 0.0, "h2d_ms": 0.0}
        by_worker: Dict[str, float] = {}
        per_step: List[dict] = []
        for st in sorted(tr["steps"], key=lambda e: e.get("ts", 0)):
            t0, dur = st.get("ts", 0), st.get("dur", 0)
            t1 = t0 + dur
            row = {"ts": t0, "step_ms": round(dur / 1000.0, 3),
                   "compute_ms": 0.0, "d2h_ms": 0.0, "send_ms": 0.0,
                   "server_queue_ms": 0.0, "straggler_wait_ms": 0.0,
                   "reply_ms": 0.0, "h2d_ms": 0.0}
            stall_us = sum(e.get("dur", 0) for e in tr["stall"]
                           if in_window(e, t0, t1))
            row["compute_ms"] = round(max(dur - stall_us, 0) / 1000.0, 3)
            row["d2h_ms"] = round(sum(
                e.get("dur", 0) for e in tr["d2h"]
                if in_window(e, t0, t1)) / 1000.0, 3)
            row["h2d_ms"] = round(sum(
                e.get("dur", 0) for e in tr["h2d"]
                if in_window(e, t0, t1)) / 1000.0, 3)
            for r in tr["wire"]:
                args = r.get("args") or {}
                if args.get("cmd") != "allreduce" or \
                        not in_window(r, t0, t1):
                    continue
                hs = handlers.get((track, args.get("sid")))
                if not hs or len(hs) != 1:
                    continue
                h = hs[0]
                hargs = h.get("args") or {}
                wait = float(hargs.get("wait_ms") or 0.0)
                hdur = h.get("dur", 0) / 1000.0
                row["send_ms"] += max(h.get("ts", 0) - r.get("ts", 0),
                                      0) / 1000.0
                row["reply_ms"] += max(
                    (r.get("ts", 0) + r.get("dur", 0))
                    - (h.get("ts", 0) + h.get("dur", 0)), 0) / 1000.0
                row["straggler_wait_ms"] += wait
                row["server_queue_ms"] += max(hdur - wait, 0.0)
                last = hargs.get("last")
                if last and wait > 0:
                    by_worker[last] = by_worker.get(last, 0.0) + wait
            for k in totals:
                v = round(row[k], 3)
                row[k] = v
                totals[k] += v
            if len(per_step) < _MAX_PER_STEP:
                per_step.append(row)
        critical[track] = {
            "steps": len(tr["steps"]),
            "totals": {k: round(v, 3) for k, v in sorted(totals.items())},
            "straggler_wait_by_worker": {
                k: round(v, 3) for k, v in sorted(by_worker.items())},
            "per_step": per_step,
            "per_step_truncated": len(tr["steps"]) > _MAX_PER_STEP}
    # job-wide blame fold (the one consumers rank on — dtop's
    # attribution line and the chaos straggler check read this instead
    # of re-aggregating the per-track maps)
    blame: Dict[str, float] = {}
    for cp in critical.values():
        for h, v in cp["straggler_wait_by_worker"].items():
            blame[h] = blame.get(h, 0.0) + v
    return {"causal": causal, "critical_path": critical,
            "straggler_blame": {k: round(v, 3)
                                for k, v in sorted(blame.items())}}


def _percentile(sorted_vals: List[float], q: float) -> float:
    """Nearest-rank percentile over a pre-sorted list (numpy-free)."""
    if not sorted_vals:
        return 0.0
    k = max(0, min(len(sorted_vals) - 1,
                   int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return sorted_vals[k]


def summarize_chrome(chrome: Dict[str, Any]) -> Dict[str, Any]:
    """Job summary off the chrome schema (the one format both the live
    path and dump files share)."""
    track_of_pid: Dict[int, str] = {}
    for ev in chrome.get("traceEvents", ()):
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            track_of_pid[ev["pid"]] = ev["args"]["name"]

    tracks: Dict[str, Any] = {}
    membership: List[dict] = []
    failovers: List[dict] = []
    leadership: List[dict] = []
    recompiles: Dict[str, List[dict]] = {}  # r18 compile.recompile fold
    ckpt_events: List[dict] = []  # r19 ckpt.*/drain.* timeline fold
    serve_events: List[dict] = []  # r21 serve.refresh/scale timeline
    total_faults = 0
    for ev in chrome.get("traceEvents", ()):
        if ev.get("ph") in ("M", "s", "f", "t"):
            continue  # metadata + the r13 causal flow arrows
        track = track_of_pid.get(ev.get("pid"), f"pid{ev.get('pid')}")
        tr = tracks.setdefault(track, {"steps_ms": [], "stall_ms": {},
                                       "pipeline_ms": {}, "faults": {},
                                       "events": 0, "spans": 0})
        name = ev.get("name", "")
        if ev.get("ph") == "X":
            tr["spans"] += 1
            dur_ms = ev.get("dur", 0) / 1000.0
            if name == "step":
                tr["steps_ms"].append(dur_ms)
            if name in STALL_SPANS:
                tr["stall_ms"][name] = tr["stall_ms"].get(name, 0.0) \
                    + dur_ms
            if name.startswith(PIPELINE_PREFIX):
                stage = name[len(PIPELINE_PREFIX):]
                tr["pipeline_ms"][stage] = \
                    tr["pipeline_ms"].get(stage, 0.0) + dur_ms
            if name == "membership_change":
                membership.append({"track": track, "ts": ev.get("ts"),
                                   **{k: v for k, v in ev["args"].items()
                                      if k in ("epoch", "removed", "added",
                                               "recovered")}})
            if name == "scheduler.failover":
                # the control-plane HA takeover span (docs/ha.md): the
                # chaos harness and dtop both report its count + duration
                failovers.append({"track": track, "ts": ev.get("ts"),
                                  "dur_ms": round(dur_ms, 3),
                                  **{k: v for k, v in ev["args"].items()
                                     if k in ("incarnation", "reason",
                                              "workers")}})
        else:
            tr["events"] += 1
            if name.startswith("fault."):
                kind = name[len("fault."):]
                tr["faults"][kind] = tr["faults"].get(kind, 0) + 1
                total_faults += 1
            if name == "compile.recompile":
                # r18 recompile-cause timeline: each event names its
                # signature delta; the fold below feeds the device
                # board and the chaos recompile-churn gate
                recompiles.setdefault(track, []).append(
                    {"ts": ev.get("ts"),
                     **{k: v for k, v in (ev.get("args") or {}).items()
                        if k in ("what", "changed", "cache",
                                 "elapsed_ms")}})
            if name in ("leader.elected", "leader.fenced"):
                # leader-incarnation timeline: elections (primary start +
                # failover takeovers) and fencings, job-wide order
                leadership.append({"track": track, "ts": ev.get("ts"),
                                   "what": name.split(".", 1)[1],
                                   **{k: v for k, v in ev["args"].items()
                                      if k in ("incarnation", "reason")}})
            if name.startswith("ckpt.") or name.startswith("drain."):
                # r19 survivability timeline (docs/checkpoint.md):
                # intents/acks/commits/aborts, drains, the resume event
                # — one chronological list dtop folds into its
                # checkpoint/drain section
                ckpt_events.append(
                    {"track": track, "ts": ev.get("ts"), "what": name,
                     **{k: v for k, v in (ev.get("args") or {}).items()
                        if k in ("step", "epoch", "host", "workers",
                                 "reason", "dur_ms", "spread_ms")}})
            if name in ("serve.refresh", "serve.scale"):
                # r21 serving timeline (docs/serving.md): rolling
                # refresh waves + fleet scale events, folded into
                # dtop's serving board
                serve_events.append(
                    {"track": track, "ts": ev.get("ts"), "what": name,
                     **{k: v for k, v in (ev.get("args") or {}).items()
                        if k in ("step", "kind", "host", "replicas")}})

    meta = (chrome.get("otherData") or {}).get("tracks") or {}
    out_tracks: Dict[str, Any] = {}
    for track, tr in tracks.items():
        steps = sorted(tr["steps_ms"])
        counters = dict((meta.get(track) or {}).get("counters") or {})
        out_tracks[track] = {
            "steps": {"count": len(steps),
                      "p50_ms": round(_percentile(steps, 50), 3),
                      "p90_ms": round(_percentile(steps, 90), 3),
                      "p99_ms": round(_percentile(steps, 99), 3)},
            "stall_ms": {k: round(v, 3)
                         for k, v in sorted(tr["stall_ms"].items())},
            "pipeline_ms": {k: round(v, 3)
                            for k, v in sorted(tr["pipeline_ms"].items())},
            "pipeline_buckets": counters.get("pipeline.buckets", 0),
            "faults": tr["faults"],
            "retries": counters.get("wire.retries", 0),
            "counters": counters,
            "dropped": (meta.get(track) or {}).get("dropped", 0),
            "spans": tr["spans"], "events": tr["events"],
        }
    for track, m in meta.items():  # tracks with counters but no records
        if track not in out_tracks:
            out_tracks[track] = {
                "steps": {"count": 0, "p50_ms": 0.0, "p90_ms": 0.0,
                          "p99_ms": 0.0},
                "stall_ms": {}, "pipeline_ms": {},
                "pipeline_buckets": (m.get("counters") or {}).get(
                    "pipeline.buckets", 0),
                "faults": {},
                "retries": (m.get("counters") or {}).get("wire.retries", 0),
                "counters": dict(m.get("counters") or {}),
                "dropped": m.get("dropped", 0), "spans": 0, "events": 0}
    out = {"tracks": out_tracks,
           "membership_changes": sorted(membership,
                                        key=lambda m: m.get("ts") or 0),
           "failovers": sorted(failovers, key=lambda m: m.get("ts") or 0),
           "leadership": sorted(leadership,
                                key=lambda m: m.get("ts") or 0),
           "total_fault_events": total_faults,
           "serve_events": sorted(serve_events,
                                  key=lambda m: m.get("ts") or 0),
           "checkpoint": sorted(ckpt_events,
                                key=lambda m: m.get("ts") or 0),
           "straggler": dict((chrome.get("otherData") or {})
                             .get("straggler") or {}),
           "policy": dict((chrome.get("otherData") or {})
                          .get("policy") or {})}
    out.update(_causal_and_critical(chrome, track_of_pid))
    # r18 device section: the scheduler's per-host compile/memory view
    # (otherData) plus the recompile-cause timeline folded from the
    # compile.recompile events above
    device = dict((chrome.get("otherData") or {}).get("device") or {})
    if recompiles:
        device["recompiles_by_track"] = {
            t: sorted(v, key=lambda e: e.get("ts") or 0)
            for t, v in sorted(recompiles.items())}
    out["device"] = device
    # r21 serving section: replica gauges + autoscale decisions
    # (otherData passthrough, like policy — dtop's serving board)
    out["serving"] = dict((chrome.get("otherData") or {})
                          .get("serving") or {})
    # r15 health plane: thread the scheduler's SLO/gauge state + the
    # per-track time-series through, then run the post-hoc SLO pass over
    # export-derived inputs (the causal join only exists here — the
    # causal_orphans rule is declared source:"export" for exactly this).
    # now_ms=0 keeps the write byte-deterministic.
    health = dict((chrome.get("otherData") or {}).get("health") or {})
    out["metrics"] = dict((chrome.get("otherData") or {})
                          .get("metrics") or {})
    if health.get("enabled"):
        causal = out["causal"]
        rate = (causal["orphans"] / causal["client_spans"]) \
            if causal["client_spans"] else 0.0
        health["derived"] = {"causal.orphan_rate": round(rate, 4)}
        try:
            from dt_tpu_torch.obs import metrics as obs_metrics
            eng = obs_metrics.SLOEngine(
                (health.get("slo") or {}).get("rules"))
            health["export_breaches"] = eng.evaluate(
                {"causal.orphan_rate": rate}, now_ms=0, source="export")
        except Exception:  # noqa: BLE001 — a malformed rule set must
            # not break the export; the live sections still land
            health["export_breaches"] = []
    out["health"] = health
    return out


def metrics_path(trace_path: str) -> str:
    root, _ = os.path.splitext(trace_path)
    return root + ".metrics.json"


# deterministic: bytes — two writes of one dump are byte-identical
def write(trace_path: str, job: Dict[str, Any]) -> Dict[str, Any]:
    """Write the merged chrome trace to ``trace_path`` and the metrics/
    summary snapshot next to it; returns the summary.  Byte-
    deterministic: two writes of the same dump produce identical files
    (``sort_keys`` + the summarizer's own sorted sections) — diffs of
    committed metrics files mean the DATA changed."""
    chrome = chrome_trace(job)
    with open(trace_path, "w") as f:
        json.dump(chrome, f, sort_keys=True)
    summary = summarize_chrome(chrome)
    with open(metrics_path(trace_path), "w") as f:
        json.dump(summary, f, indent=2, sort_keys=True)
    return summary
