"""Read ``dt_tpu`` checkpoints: the read side of
``dt_tpu/training/checkpoint.py`` (:79-92, :209-245, :279-306).

A checkpoint is ``prefix-%04d.state``, msgpack of the JAX ``TrainState``
state dict, beside ``prefix-meta.json``, whose ``"checkpoints"`` map records
each tag's sha256.  The reader verifies that digest and decodes with the
port's own msgpack decoder; a torn or corrupt file raises
:class:`CheckpointCorruptError` naming it.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
from typing import Any, Dict, Optional

from dt_tpu_torch.utils import msgpack


class CheckpointCorruptError(RuntimeError):
    """A state file is torn or fails its digest; the message names it."""

    def __init__(self, path: str, why: str):
        super().__init__(f"corrupt checkpoint {path}: {why}")
        self.path = path


def read_meta(prefix: str) -> Dict[str, Any]:
    """The meta sidecar as a dict ({} when absent or unreadable)."""
    try:
        with open(f"{prefix}-meta.json") as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def checkpoint_info(prefix: str, tag: int) -> Optional[Dict[str, Any]]:
    """The recorded entry (sha256/bytes/cursor) for one saved tag."""
    return read_meta(prefix).get("checkpoints", {}).get(f"{tag:04d}")


def _read_verified(prefix: str, epoch: int, verify: bool) -> bytes:
    path = f"{prefix}-{epoch:04d}.state"
    with open(path, "rb") as f:
        blob = f.read()
    if not blob:
        raise CheckpointCorruptError(path, "zero-byte file")
    if verify:
        ent = checkpoint_info(prefix, epoch)
        if ent is not None and "sha256" in ent:
            got = hashlib.sha256(blob).hexdigest()
            if got != ent["sha256"]:
                raise CheckpointCorruptError(
                    path, f"sha256 mismatch (file {got[:12]}… != recorded "
                          f"{ent['sha256'][:12]}…)")
    return blob


def load_checkpoint(prefix: str, epoch: int,
                    verify: bool = True) -> Dict[str, Any]:
    """``{"step", "params", "batch_stats"}`` of one saved tag, as nested
    dicts of numpy arrays (bfloat16 leaves as torch tensors).  ``verify``
    checks the recorded digest (a checkpoint without one is read as is); the
    optimizer state is not kept."""
    path = f"{prefix}-{epoch:04d}.state"
    blob = _read_verified(prefix, epoch, verify)
    try:
        state = msgpack.restore(blob)
    except (ValueError, TypeError) as e:  # MsgpackError is a ValueError
        raise CheckpointCorruptError(path, f"undecodable msgpack ({e})") \
            from e
    if not isinstance(state, dict) or "params" not in state:
        raise CheckpointCorruptError(path, "not a TrainState state dict")
    return {"step": state.get("step"), "params": state["params"],
            "batch_stats": state.get("batch_stats") or {}}


def latest_checkpoint(prefix: str) -> Optional[int]:
    """The newest saved tag for ``prefix``; ``.tmp`` leftovers and
    zero-byte torn writes are skipped."""
    d = os.path.dirname(os.path.abspath(prefix)) or "."
    base = os.path.basename(prefix)
    if not os.path.isdir(d):
        return None
    pat = re.compile(re.escape(base) + r"-(\d{4,})\.state$")
    tags = []
    for name in os.listdir(d):
        m = pat.match(name)
        if not m:
            continue
        try:
            if os.path.getsize(os.path.join(d, name)) == 0:
                continue
        except OSError:
            continue
        tags.append(int(m.group(1)))
    return max(tags) if tags else None
