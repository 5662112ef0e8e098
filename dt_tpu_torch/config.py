"""Device selection for the port's entry points, and the environment of
its elastic path.

Entry points take ``device=`` and default to ``"cuda"``.  Without a GPU they
raise unless the caller asked for ``"cpu"``: the port never falls back to the
CPU quietly (the counterpart of ``maybe_force_cpu`` in ``dt_tpu/config.py``,
which only moves to the CPU when asked).
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
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
# defaults (``dt_tpu/config.py:65-81, 131`` and the fit contract of
# ``dt_tpu/training/module.py:612-617``).  Read through :func:`env`, which
# raises for a name not declared here, so a mistyped knob fails loudly.
# ---------------------------------------------------------------------------

ENV_NEW_WORKER = "NEW_WORKER"
ENV_EPOCH_BEGIN = "EPOCH_BEGIN"
ENV_ELASTIC_ENABLED = "ELASTIC_TRAINING_ENABLED"

ENV_REGISTRY = {
    # the control plane and its wire
    "DT_ELASTIC_SECRET": ("", "HMAC secret authenticating control frames"),
    "DT_ELASTIC_BIND": ("0.0.0.0", "interface the scheduler listens on"),
    "DT_WIRE_SOCKBUF": (str(4 << 20), "SO_SNDBUF/SO_RCVBUF of data-plane sockets (bytes)"),
    # the allreduce and the overlapped step
    "DT_AR_CHUNK_BYTES": (str(4 << 20), "represented-gradient bytes per chunked-allreduce round"),
    "DT_AR_WINDOW": ("0", "in-flight round window (0 = 2x fleet, min 4)"),
    "DT_AR_BUCKET_BYTES": (str(4 << 20), "represented-gradient bytes per overlap bucket"),
    "DT_AR_OVERLAP": ("1", "0 = serial host-sync step; must be the same job-wide"),
    "DT_AR_STAGING_MB": ("64", "cap on pinned host staging bytes the overlap engine keeps"),
    # worker identity
    "DT_WORKER_ID": ("", "this worker's host name under the launcher's env contract"),
    "DT_RECOVERY": ("", "1 = re-register under the old identity after a crash"),
    # control-plane clients
    "DT_CTRL_JOURNAL": ("", "scheduler journal path (scheduler HA: not ported)"),
    "DT_CTRL_TOKEN_TTL_S": ("300", "idempotency-token response-cache TTL (s)"),
    "DT_CTRL_ENDPOINTS": ("", "host:port[,host:port] for client failover (not ported)"),
    # tracing
    "DT_OBS": ("", "1 = record spans and events in the process tracer"),
    "DT_OBS_RING": (str(4096), "tracer ring capacity (records)"),
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
