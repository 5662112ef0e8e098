"""Device selection for the port's entry points, and the environment of
its elastic path.

Entry points take ``device=`` and default to ``"cuda"``.  Without a GPU they
raise unless the caller asked for ``"cpu"``: the port never falls back to the
CPU quietly (the counterpart of ``maybe_force_cpu`` in ``dt_tpu/config.py``,
which only moves to the CPU when asked).
"""

from __future__ import annotations

import os
from typing import TYPE_CHECKING, Optional, Union

if TYPE_CHECKING:
    import torch


def resolve_device(device: Union[str, "torch.device"] = "cuda"
                   ) -> "torch.device":
    # torch is imported here, not with the module: the scheduler, the
    # standby and the launcher read the environment table below and never
    # touch a tensor, and a process that imports torch starts seconds later
    import torch
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device found; pass device='cpu' to "
                               "run on the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")


# ---------------------------------------------------------------------------
# The environment the elastic host-sync path reads, with the JAX package's
# defaults (``dt_tpu/config.py:59-116, 131`` and the fit contract of
# ``dt_tpu/training/module.py:612-617``).  Read through :func:`env`, which
# raises for a name not declared here, so a mistyped knob fails loudly.
# ---------------------------------------------------------------------------

ENV_NEW_WORKER = "NEW_WORKER"
ENV_EPOCH_BEGIN = "EPOCH_BEGIN"
ENV_ELASTIC_ENABLED = "ELASTIC_TRAINING_ENABLED"

ENV_REGISTRY = {
    # the control plane and its wire
    "DT_ELASTIC_SECRET": ("", "HMAC secret authenticating control frames (launcher generates per-job)"),
    "DT_ELASTIC_INSECURE": ("", "1 = explicit opt-out of frame authentication (trusted single host)"),
    "DT_ELASTIC_BIND": ("0.0.0.0", "interface the scheduler listens on"),
    "DT_ELASTIC_ADVERTISE": ("", "address peers dial to reach a server bound here (DMLC_NODE_HOST analog)"),
    "DT_WIRE_SOCKBUF": (str(4 << 20), "SO_SNDBUF/SO_RCVBUF of data-plane sockets (bytes)"),
    # the allreduce and the overlapped step
    "DT_AR_CHUNK_BYTES": (str(4 << 20), "represented-gradient bytes per chunked-allreduce round"),
    "DT_AR_SHARD_MIN_BYTES": (str(64 << 10), "tensors above this split across ALL range servers"),
    "DT_AR_WINDOW": ("0", "in-flight round window (0 = 2x fleet, min 4)"),
    "DT_AR_BUCKET_BYTES": (str(4 << 20), "represented-gradient bytes per overlap bucket"),
    "DT_AR_OVERLAP": ("1", "0 = serial host-sync step; must be the same job-wide"),
    "DT_AR_STAGING_MB": ("64", "cap on pinned host staging bytes the overlap engine keeps"),
    # worker identity
    "DT_WORKER_ID": ("", "this worker's host name under the launcher's env contract"),
    "DT_RECOVERY": ("", "1 = re-register under the old identity after a crash"),
    "DT_SERVER_ID": ("0", "range-server index under the launcher env contract"),
    # control-plane HA (scheduler journal, warm standby, client failover)
    "DT_CTRL_JOURNAL": ("", "control-state write-ahead journal path (enables scheduler HA replay)"),
    "DT_CTRL_LEASE": ("", "leader lease file path (default <journal>.lease)"),
    "DT_CTRL_LEASE_S": ("2.0", "leader lease duration; the standby takes over after this much silence"),
    "DT_CTRL_TOKEN_TTL_S": ("300", "idempotency-token response-cache TTL (s)"),
    "DT_CTRL_ENDPOINTS": ("", "ordered scheduler endpoints host:port[,host:port] for client failover (leader first)"),
    "DT_CTRL_FAILOVER_S": ("60", "client-side wall budget for failing a request over across the endpoint list"),
    "DT_CTRL_SNAP_KEEP": ("2", "newest snapshot sidecars kept a journal (older ones pruned at each snapshot; min 1)"),
    # fleet checkpoints and cold-restart resume
    "DT_CKPT_DIR": ("", "fleet-checkpoint directory (<dir>/<host>/fleet-<step>.state blobs, the manifest in the scheduler journal); empty = off"),
    "DT_CKPT_EVERY": ("0", "global steps between fleet checkpoints (0 = only the scheduler-forced epoch-boundary ones)"),
    "DT_RESUME": ("", "1 = cold-restart resume: the scheduler replays its journal for the newest committed manifest, workers restore the train state and data cursor"),
    # tracing
    "DT_OBS": ("", "1 = record spans and events in the process tracer"),
    "DT_OBS_RING": (str(4096), "tracer ring capacity (records)"),
    "DT_STRAGGLER_MS": ("500", "round-contribution-lag EWMA threshold (ms) that fires the worker.straggler event"),
    # the metrics / health plane (obs/metrics.py)
    "DT_METRICS": ("", "1 = enable the metrics plane (gauges/histograms, time-series sampling, heartbeat export, health RPC)"),
    "DT_METRICS_INTERVAL_S": ("2.0", "wall-clock cadence of the per-process time-series sampler"),
    "DT_METRICS_RING": ("360", "time-series ring capacity (samples per process; overflow drops oldest)"),
    "DT_METRICS_PORT": ("", "scheduler Prometheus/health HTTP port (empty = no endpoint; 0 = ephemeral for tests)"),
    "DT_HEALTH_HALT": ("", "1 = training-health sentinel stops cleanly BEFORE a non-finite update is applied"),
    "DT_SLO_RULES": ("", "JSON list (or @/path) overriding the default SLO rule set by rule name (obs.metrics.DEFAULT_SLO_RULES)"),
    # the flight recorder and hang forensics (obs/blackbox.py)
    "DT_BLACKBOX": ("", "1 = arm the flight-recorder plane: crash bundles, hang watchdog, manifest (works with DT_OBS=0)"),
    "DT_BLACKBOX_DIR": (".blackbox", "bundle + manifest.jsonl output directory"),
    "DT_BLACKBOX_RING": ("512", "flight-note ring capacity (last-N lifecycle notes per process; overflow drops oldest)"),
    "DT_BLACKBOX_MAX_MB": ("8", "per-bundle size cap (MiB), best-effort: ring tails trimmed first, thread stacks truncated last"),
    "DT_BLACKBOX_MAX_BUNDLES": ("64", "per-directory bundle retention cap: oldest bundles pruned on write (manifest rows are kept)"),
    "DT_HANG_S": ("120", "step/fleet-progress stall threshold (seconds) before the hang watchdog dumps a live bundle"),
    # the device plane (obs/device.py)
    "DT_DEVICE_OBS": ("", "1 = arm the device plane: compile.* spans + first-launch ledger, device.hbm_* gauges, OOM census bundles, on-demand profile_capture (works with DT_OBS=0)"),
    # the policy engine (straggler-adaptive dynamic mini-batch + autoscaling)
    "DT_POLICY": ("", "1 = enable the scheduler-side policy engine (batch-share rebalancing, auto-eviction, scale proposals)"),
    "DT_POLICY_STRAGGLER_MS": ("", "breach threshold (ms) for policy decisions (default: DT_STRAGGLER_MS)"),
    "DT_POLICY_SHRINK": ("0.5", "per-breach-streak geometric batch-share shrink factor"),
    "DT_POLICY_MIN_FRAC": ("0.25", "floor on a straggler's relative share weight before eviction"),
    "DT_POLICY_EVICT_AFTER": ("0", "consecutive breaches before a non-base straggler is evicted (0 = off)"),
    "DT_POLICY_TARGET_WORKERS": ("", "autoscale target worker count for scale proposals (empty = off)"),
    # the serving plane (serve/: the gateway, replicas and the serving
    # autoscaler)
    "DT_SERVE_DEADLINE_MS": ("50", "per-request latency budget (ms): the dynamic batcher launches a partial batch once the oldest queued request has spent half of it waiting"),
    "DT_SERVE_MAX_BATCH": ("64", "largest dynamic-batch bucket the gateway coalesces into (Predictor batch_buckets cap)"),
    "DT_SERVE_QUEUE_ROWS": ("256", "admission-control cap on queued rows per gateway; past it requests are shed with a counted serve.shed drop, never queued unbounded"),
    "DT_SERVE_POLICY": ("", "1 = scheduler-side serving autoscale mode: the policy engine scales the replica set from live serve gauges (docs/serving.md)"),
    "DT_SERVE_QHI": ("8.0", "mean queued rows per replica at/above which an overload streak accrues toward a scale_up decision"),
    "DT_SERVE_QLO": ("0.5", "mean queued rows per replica at/below which an idle streak accrues toward a scale_down decision"),
    "DT_SERVE_UP_AFTER": ("3", "consecutive overloaded serve-policy evaluations before a scale_up decision fires"),
    "DT_SERVE_DOWN_AFTER": ("6", "consecutive idle serve-policy evaluations before a scale_down decision fires"),
    "DT_SERVE_MIN_REPLICAS": ("1", "serving autoscale floor (scale_down never goes below it)"),
    "DT_SERVE_MAX_REPLICAS": ("8", "serving autoscale ceiling (scale_up never goes above it)"),
    # the data pipeline (data/recordio.py)
    "DT_DECODE_THREADS": ("", "recordio decode pool size (default min(cpus, 16))"),
    # fault injection
    "DT_FAULT_PLAN": ("", "fault-plan JSON (or @/path) for subprocess workers"),
    "DT_DROP_MSG": ("", "percent of received control messages the scheduler drops"),
}


def env(name: str, default: Optional[str] = None) -> str:
    """A declared env var: its value, else ``default`` when given, else the
    registry's default.  An undeclared name raises ``KeyError``."""
    spec = ENV_REGISTRY.get(name)
    if spec is None:
        raise KeyError(f"{name!r} is not declared in "
                       "dt_tpu_torch.config.ENV_REGISTRY")
    v = os.environ.get(name)
    if v is not None:
        return v
    return spec[0] if default is None else default


def env_flag(name: str, default: bool = False) -> bool:
    """A boolean env var, as the reference's fit reads it ("1"/"true")."""
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes")


def env_int(name: str, default: int = 0) -> int:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return int(v)
