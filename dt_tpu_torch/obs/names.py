"""The span / event / counter / gauge / histogram name catalog
(counterpart of ``dt_tpu/obs/names.py``, copied as it stands since the
port imports nothing of the JAX package): every name the port records is
declared here, with the JAX package's kind and meaning, so one job's
records read the same from either package's workers and
``tools/dtop.py``'s sections find them.

:data:`NAME_REGISTRY` is the JAX package's table unchanged; the few
names only the port records (the parts of its elastic step, PR 7-8) are
declared apart in :data:`PORT_NAMES`, and :func:`lookup` resolves both.

Names ending in ``*`` are prefix entries for the dynamically suffixed
families (``fault.<kind>``, ``membership.<ACTION>``, ``rpc.<cmd>``,
``compile.<what>``).  Values are ``(kind, doc)``; kind is ``span`` /
``event`` / ``counter`` / ``gauge`` / ``histogram``, ``|``-separated when
one name is both.  The docs name the JAX package's modules; the port's
counterparts carry the same names (``compile.*`` here is an ``nvcc``
build or a first launch, ``obs/device.py``).
"""

from __future__ import annotations

from typing import Mapping, Tuple

NAME_REGISTRY: Mapping[str, Tuple[str, str]] = {
    # -- training plane (training/module.py, trainer.py) -------------------
    "step": ("span", "one training step (fwd+bwd+sync+update), worker track"),
    "epoch": ("span", "one training epoch (Module.fit)"),
    "eval": ("span", "one evaluation pass (Module.score)"),
    "trainer.step": ("span", "one Trainer.step (low-level training loop)"),
    # -- worker client (elastic/client.py) ---------------------------------
    "mc_barrier": ("span", "client side of the membership-change barrier"),
    "allreduce": ("span", "one top-level exact-average round (serial or "
                          "pipelined wall-clock)"),
    "allreduce_sparse": ("span", "one row-sparse exact-average round"),
    "recovery.rejoin": ("span", "crash-recovery re-admission wait"),
    "allreduce.chunked": ("event", "a round split into chunk sub-rounds"),
    "client.failover": ("event|counter", "scheduler endpoint rotation"),
    "client.reattached": ("event", "re-registered under a new leader fence"),
    "heartbeat.sent": ("counter", "heartbeats issued by this worker"),
    "allreduce.rounds": ("counter", "top-level allreduce rounds"),
    "profiler.posts": ("counter", "remote profiler commands posted"),
    # -- wire (elastic/protocol.py) ----------------------------------------
    "wire.request": ("span", "one request/response attempt on a pooled "
                             "channel; carries the propagated span id"),
    "wire.retry": ("event", "an at-least-once retry (with backoff)"),
    "wire.retries": ("counter", "total transport retries"),
    "wire.bytes_sent": ("counter", "frame bytes written (all frames)"),
    "wire.bytes_recv": ("counter", "frame bytes received (all frames)"),
    # -- scheduler control plane (elastic/scheduler.py) --------------------
    "rpc.*": ("span", "server-side handler span, one per served request "
                      "that carried trace context (rpc.<cmd>)"),
    "mc_barrier.window": ("span", "barrier window: first arrival → release"),
    "membership_change": ("span", "one applied membership change"),
    "scheduler.failover": ("span", "warm-standby takeover (docs/ha.md)"),
    "membership.*": ("event", "audit-line events (membership.ADDED / "
                              "REMOVED / RECOVERED)"),
    "recovery.registered": ("event", "a crashed worker re-registered"),
    "leader.elected": ("event", "leadership assumed (start or takeover)"),
    "leader.fenced": ("event", "this leader was deposed by a newer fence"),
    "transport.connections": ("counter", "accepted control connections"),
    "transport.requests": ("counter", "control requests served"),
    "tokens.dedup_hits": ("counter", "idempotency-token replays served "
                                     "from cache"),
    "ha.rounds_replicated": ("counter", "completed rounds installed from "
                                        "the live primary"),
    # -- data plane (elastic/dataplane.py, range_server.py) ----------------
    "dataplane.round": ("span", "one allreduce round: first contribution "
                                "→ completion; attrs carry the last "
                                "(straggling) contributor + wait_ms"),
    "dataplane.survivor_complete": ("event", "round finished by survivors "
                                             "after membership shrank"),
    "worker.straggler": ("event", "a worker's round-lag EWMA crossed "
                                  "DT_STRAGGLER_MS"),
    "dataplane.rounds": ("counter", "completed allreduce rounds"),
    "dataplane.bucket_rounds": ("counter", "overlap-pipeline bucket rounds "
                                           "(key#b<i>)"),
    "data.bytes_in": ("counter", "range-server data-plane bytes received"),
    "data.requests": ("counter", "range-server data-plane requests"),
    # -- overlap pipeline (training/overlap.py, client AllreducePipeline) --
    "pipeline.d2h": ("span", "one bucket's device→host staging"),
    "pipeline.wire": ("span", "one bucket's wire round (comm thread)"),
    "pipeline.h2d": ("span", "one bucket's host→device dispatch"),
    "pipeline.buckets": ("counter", "bucket rounds pushed through the "
                                    "overlap pipeline"),
    "pipeline.aux_rounds": ("counter", "aux rounds ridden on the pipeline "
                                       "window (e.g. stats)"),
    # -- policy engine (dt_tpu/policy via elastic/scheduler.py) ------------
    "policy.rebalance": ("event", "one applied policy decision: breach "
                                  "set + the journaled batch-share units"),
    "policy.evict": ("event", "a chronic straggler dropped from "
                              "host_worker by the policy engine"),
    "policy.scale": ("event", "a scale-up/down proposal toward "
                              "DT_POLICY_TARGET_WORKERS"),
    "policy.decisions": ("counter", "journaled policy_decide ops"),
    # -- metrics / health plane (obs/metrics.py, r15) ----------------------
    # gauges and histograms are emitted through MetricsRegistry.gauge /
    # .observe and sampled into the DT_METRICS time-series ring; dtlint
    # DT011 holds them to this catalog exactly like spans/events/counters
    "train.loss": ("gauge", "last completed step's training loss"),
    "train.steps": ("gauge", "cumulative optimizer steps this process "
                             "applied (the scheduler derives step rate "
                             "from successive samples)"),
    "health.grad_norm": ("gauge", "last step's global gradient L2 norm "
                                  "(non-finite entries excluded)"),
    "health.param_norm": ("gauge", "last step's parameter L2 norm"),
    "worker.step_rate": ("gauge", "scheduler-derived per-worker step "
                                  "rate (steps/s) from the shipped "
                                  "train.steps series"),
    "sched.heartbeat_staleness_s": ("gauge", "seconds since each live "
                                             "worker's last heartbeat"),
    "obs.ring_dropped": ("gauge", "total obs ring/pending records shed "
                                  "job-wide (scheduler view)"),
    "step.ms": ("histogram", "host-side wall-clock of one training step"),
    "round.wait_ms": ("histogram", "allreduce round wait-for-last-"
                                   "contributor window (data plane)"),
    "journal.append_ms": ("histogram", "control-journal fsync-append "
                                       "latency"),
    "metrics.samples": ("counter", "time-series samples taken by the "
                                   "background sampler"),
    "metrics.scrapes": ("counter", "/metrics exposition scrapes served"),
    "health.nonfinite": ("event", "the fused non-finite sentinel fired: "
                                  "a gradient/loss went NaN/Inf this "
                                  "step"),
    "health.halt": ("event", "DT_HEALTH_HALT stopped training before "
                             "the poisoned update was applied"),
    "health.breach": ("event", "an SLO rule started breaching (attrs "
                               "carry rule, blamed worker, value, "
                               "threshold)"),
    "health.clear": ("event", "a breaching SLO rule recovered"),
    # -- flight recorder / hang forensics (obs/blackbox.py, r16) -----------
    "blackbox.bundle": ("event", "a crash/hang bundle was written to "
                                 "DT_BLACKBOX_DIR (attrs: trigger, file, "
                                 "fatal)"),
    "blackbox.bundles": ("counter", "flight-recorder bundles written by "
                                    "this process"),
    "hang.suspect": ("event", "edge-triggered: step/fleet progress "
                              "stalled past DT_HANG_S (worker watchdog "
                              "or scheduler fleet detector; attrs carry "
                              "the stall age and — scheduler-side — the "
                              "blamed worker)"),
    "hang.clear": ("event", "a suspected hang recovered (progress "
                            "resumed / the stalled round completed)"),
    # -- device plane (obs/device.py, r18) ---------------------------------
    "compile.*": ("span", "one XLA compile of an instrumented step "
                          "(compile.<what>); open while the compiler "
                          "runs, so hang bundles can label a "
                          "compile-in-progress stall"),
    "compile.recompile": ("event", "an instrumented step compiled AGAIN "
                                   "(attrs name the signature delta: "
                                   "shape/dtype/mesh/donate/nargs, or "
                                   "'rebuild' for an identical-signature "
                                   "elastic rebuild)"),
    "compile.compiles": ("counter", "XLA compiles observed by the device "
                                    "plane"),
    "compile.cache_hits": ("counter", "compiles served from the "
                                      "DT_JAX_CACHE_DIR persistent cache"),
    "compile.cache_misses": ("counter", "compiles that wrote fresh "
                                        "persistent-cache entries"),
    "device.hbm_bytes": ("gauge", "per-device HBM bytes in use "
                                  "(jax.Device.memory_stats)"),
    "device.hbm_peak_bytes": ("gauge", "per-device peak HBM bytes in use"),
    "device.hbm_limit_bytes": ("gauge", "per-device HBM capacity"),
    "device.host_rss_bytes": ("gauge", "process resident-set bytes (the "
                                       "CPU fallback when the backend "
                                       "reports no HBM stats)"),
    "device.staging_bytes": ("gauge", "overlap StagingPool pooled host "
                                      "bytes (free-list occupancy)"),
    "device.staging_outstanding": ("gauge", "overlap StagingPool buffers "
                                            "acquired and not yet "
                                            "released"),
    "device.oom": ("event", "a RESOURCE_EXHAUSTED allocation failure was "
                            "caught; the OOM bundle carries the "
                            "live-buffer census"),
    "profile.capture": ("event", "a bounded on-demand jax.profiler "
                                 "capture finished (profile_capture "
                                 "wire command; trace dir in attrs)"),
    # -- job survivability plane (r19 — coordinated fleet checkpointing,
    # cold-restart resume, graceful drain; docs/checkpoint.md) -------------
    "ckpt.save": ("span", "one worker's fleet-checkpoint save: device_get "
                          "+ msgpack + atomic write (async tail included "
                          "— the span closes when the blob is on disk)"),
    "ckpt.intent": ("event", "scheduler journaled a fleet-checkpoint "
                             "intent (attrs: step, epoch, workers)"),
    "ckpt.ack": ("event", "scheduler recorded one worker's save ack "
                          "(attrs: host, step)"),
    "ckpt.commit": ("event", "all acks in — the manifest is journaled and "
                             "the checkpoint is durable (attrs: step, "
                             "epoch, workers, dur_ms, spread_ms)"),
    "ckpt.abort": ("event", "a pending intent was abandoned (superseded "
                            "or its worker set changed before commit)"),
    "ckpt.resume": ("event", "cold-restart resume: the newest committed "
                             "manifest was adopted (scheduler) / restored "
                             "(worker)"),
    "ckpt.committed_step": ("gauge", "global step of the newest committed "
                                     "fleet checkpoint (scheduler view)"),
    "ckpt.save_errors": ("counter", "background checkpoint writes that "
                                    "failed (surfaced on the next save / "
                                    "fit exit)"),
    "drain.requested": ("event", "SIGTERM preemption notice received — "
                                 "finish the current step, then depart "
                                 "through the membership machinery"),
    "drain.begin": ("event", "scheduler accepted a drain (attrs: host); "
                             "the host leaves host_worker and the next "
                             "barrier removes it"),
    "drain.complete": ("event", "a draining worker departed cleanly (no "
                                "crash bundle — the manifest carries a "
                                "drain row instead)"),
    # -- serving plane (dt_tpu/serve, r21 — docs/serving.md) ---------------
    "serve.batch": ("span", "one coalesced dynamic batch through the "
                            "Predictor (attrs: bucket, rows, reqs, "
                            "weights_step)"),
    "serve.requests": ("counter", "infer requests admitted by the gateway"),
    "serve.rows": ("counter", "rows admitted by the gateway"),
    "serve.batches": ("counter", "dynamic batches executed"),
    "serve.shed": ("counter", "requests shed by admission control "
                              "(queue-row cap DT_SERVE_QUEUE_ROWS)"),
    "serve.queue_depth": ("gauge", "requests queued in the gateway "
                                   "batcher right now (the ServePolicy "
                                   "autoscale signal)"),
    "serve.p99_ms": ("gauge", "rolling p99 gateway latency "
                              "(enqueue -> reply) over the last window"),
    "serve.qps": ("gauge", "rolling requests/s over the last window"),
    "serve.latency_ms": ("histogram", "per-request gateway latency "
                                      "(enqueue -> reply)"),
    "serve.refresh": ("event", "rolling weight refresh: this replica "
                               "swapped to a new committed manifest "
                               "(attrs: step)"),
    "serve.scale": ("event", "a serving-policy decision was applied "
                             "(attrs: kind, host, replicas)"),
    "serve.replicas": ("gauge", "registered live serving replicas "
                                "(scheduler view)"),
    # -- predictor (dt_tpu/predictor.py — the obs face of the old ad-hoc
    # Predictor.stats dict; the dict stays as a per-instance view) ---------
    "predict.requests": ("counter", "Predictor.predict calls served"),
    "predict.rows": ("counter", "rows served through Predictor.predict"),
    "predict.compiles": ("counter", "bucket programs compiled outside "
                                    "warmup (a live request paid a "
                                    "compile)"),
    "predict.ms": ("histogram", "one Predictor.predict wall-clock "
                                "(pad + dispatch + device_get)"),
    # -- fault injection (elastic/faults.py) -------------------------------
    "fault.*": ("event", "every APPLIED fault (fault.<kind>); the chaos "
                         "harness cross-checks these against "
                         "applied_summary()"),
}


#: the names only the port records, with their kind and meaning
PORT_NAMES: Mapping[str, Tuple[str, str]] = {
    "step.grad": ("span", "the forward and backward of one elastic or "
                          "dist_async step (worker track)"),
    "step.apply": ("span", "the update from the averaged gradient of one "
                           "host-sync step"),
    "step.push": ("span", "one dist_async push and the adopted master's "
                          "fetch"),
    "step.h2d": ("span", "the adopted master's host-to-device copy of one "
                         "dist_async step"),
    "pipeline.grad_bytes": ("counter", "gradient bytes the overlap "
                                       "pipeline put on the wire"),
}


def lookup(name: str) -> Tuple[str, str, str]:
    """Resolve ``name`` against the registry: exact row first (the port's
    own rows after the JAX package's), then the longest matching prefix
    row.  Returns ``(matched_key, kind, doc)``; raises ``KeyError`` for
    unregistered names."""
    row = NAME_REGISTRY.get(name) or PORT_NAMES.get(name)
    if row is not None:
        return (name, row[0], row[1])
    best = None
    for key, (kind, doc) in NAME_REGISTRY.items():
        if key.endswith("*") and name.startswith(key[:-1]):
            if best is None or len(key) > len(best[0]):
                best = (key, kind, doc)
    if best is None:
        raise KeyError(f"{name!r} is not declared in "
                       f"dt_tpu_torch.obs.names")
    return best
