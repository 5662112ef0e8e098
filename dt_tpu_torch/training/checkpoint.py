"""Checkpoints in the format of ``dt_tpu/training/checkpoint.py``: the
synchronous and asynchronous writes, the reads and the fallback to an
older intact tag.

A checkpoint is ``prefix-%04d.state``, msgpack of the JAX ``TrainState``
state dict (``{"step", "params", "batch_stats", "opt_state"}`` in the JAX
layout and names, as ``interchange.export_jax_train_state`` gives it),
beside ``prefix-meta.json``, whose ``"checkpoints"`` map records each tag's
sha256, byte count and optional data-iterator cursor (user meta keys stay
at the top level).  Fleet checkpoints tag by the global step, which
outgrows four digits.  The reader verifies the digest and decodes with the
port's own msgpack codec; a torn or corrupt file raises
:class:`CheckpointCorruptError` naming it.  So either package restores the
other's checkpoints.

``save_checkpoint(async_save=True)`` takes the snapshot on the caller's
thread and leaves the encoding, the digest and the write to one
background thread.  The port updates params, momentum and BN stats in
place, so the snapshot must be whole before the next step writes them: a
CUDA state is copied into pinned host buffers on the current stream
(asynchronously to the host; every later kernel on that stream, the next
update included, runs after the copy in stream order) and the writer
waits on the copy's event; a CPU state is cloned on the spot.  No
``torch.cuda.synchronize()`` on the step path.  The bytes equal a
synchronous save's.  A failed background write is never dropped: the
first failure re-raises from the next save or :func:`flush_saves` as
:class:`CheckpointSaveError`, and each bumps the ``ckpt.save_errors``
counter.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import json
import os
import re
import threading
from typing import Any, Dict, List, Optional, Tuple

import torch

from dt_tpu_torch.interchange import export_jax_tree, load_jax_train_state
from dt_tpu_torch.obs import trace as obs_trace
from dt_tpu_torch.utils import msgpack


class CheckpointSaveError(RuntimeError):
    """An earlier background checkpoint write failed; the original error
    is the ``__cause__``."""


class CheckpointCorruptError(RuntimeError):
    """A state file is torn or fails its digest; the message names it."""

    def __init__(self, path: str, why: str):
        super().__init__(f"corrupt checkpoint {path}: {why}")
        self.path = path


_track_lock = threading.Lock()
_outstanding: set = set()  # in-flight async saves  # guarded-by: _track_lock
_first_error: Optional[BaseException] = None  # guarded-by: _track_lock
_meta_lock = threading.Lock()  # prefix-meta.json read-modify-write


def _digest(blob: bytes) -> str:
    return hashlib.sha256(blob).hexdigest()


def _write_bytes(path: str, blob: bytes) -> None:
    """The one write primitive (tests inject failures here)."""
    with open(path, "wb") as f:
        f.write(blob)


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


def _record_meta(prefix: str, tag: int, entry: Dict[str, Any],
                 meta: Optional[dict]) -> None:
    """Merge one tag's entry into the meta sidecar (user keys written once
    at the top level; the ``checkpoints`` map accumulates), atomically."""
    with _meta_lock:
        cur = read_meta(prefix)
        if meta is not None:
            for k, v in meta.items():
                cur.setdefault(k, v)
        cur.setdefault("checkpoints", {})[f"{tag:04d}"] = entry
        mp = f"{prefix}-meta.json"
        with open(mp + ".tmp", "w") as f:
            json.dump(cur, f, indent=2, sort_keys=True)
        os.replace(mp + ".tmp", mp)


# -- the background writes (checkpoint.py:110-143, 198-207) -------------


def _note_done(fut) -> None:
    global _first_error
    exc = fut.exception()
    with _track_lock:
        _outstanding.discard(fut)
        if exc is not None and _first_error is None:
            _first_error = exc
    if exc is not None:
        obs_trace.tracer().counter("ckpt.save_errors")


def raise_pending_save_error() -> None:
    """Raise (and clear) the first background save failure, if any."""
    global _first_error
    with _track_lock:
        err, _first_error = _first_error, None
    if err is not None:
        raise CheckpointSaveError(
            f"an earlier async checkpoint save failed: {err!r}") from err


def flush_saves(timeout: Optional[float] = None,
                raise_on_error: bool = True) -> None:
    """Wait for the outstanding background saves, then raise the first
    failure (``fit`` calls this before it returns)."""
    with _track_lock:
        pending = list(_outstanding)
    if pending:
        concurrent.futures.wait(pending, timeout=timeout)
    if raise_on_error:
        raise_pending_save_error()


_pool = None
_pool_lock = threading.Lock()


def _save_pool():
    """One writer thread: saves land in order, and disk pressure stays
    bounded."""
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="dt_ckpt")
        return _pool


# -- the snapshot ---------------------------------------------------------

#: free sets of pinned host buffers, by the state's tensor signature; a
#: set goes back once its save is written
_pinned_free: Dict[tuple, List[List[torch.Tensor]]] = {}  # guarded-by: _pinned_lock
_pinned_lock = threading.Lock()


class _HostCopy:
    """One train state's snapshot on the host: its step and count, and
    ``(name, tensor)`` copies of params, BN stats and momentum.  On the
    card the copies are in flight until :meth:`wait`."""

    def __init__(self, state):
        self.step = int(state.step)
        self.count = int(state.opt_state["count"])
        self.bn_name = state.layout.bn_name
        named = [("p", n, t) for n, t in state.module.named_parameters()]
        named += [("b", n, t) for n, t in state.module.named_buffers()]
        named += [("m", n, t)
                  for n, t in state.opt_state.get("mom", {}).items()]
        self._names = [(k, n) for k, n, _ in named]
        self.has_mom = "mom" in state.opt_state
        srcs = [t.detach() for _, _, t in named]
        self._event = None
        self._sig = None
        cuda = [t for t in srcs if t.is_cuda]
        if not cuda:
            self._host = [t.clone() for t in srcs]
            return
        self._sig = tuple((tuple(t.shape), t.dtype, t.device.type)
                          for t in srcs)
        with _pinned_lock:
            free = _pinned_free.get(self._sig)
            bufs = free.pop() if free else None
        if bufs is None:
            bufs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
                    for t in srcs]
        for dst, src in zip(bufs, srcs):
            dst.copy_(src, non_blocking=True)
        self._event = torch.cuda.Event()
        self._event.record(torch.cuda.current_stream(cuda[0].device))
        self._host = bufs

    def wait(self) -> None:
        if self._event is not None:
            self._event.synchronize()

    def release(self) -> None:
        """Hand pinned buffers back for the next save."""
        if self._sig is not None:
            with _pinned_lock:
                _pinned_free.setdefault(self._sig, []).append(self._host)
            self._sig = None

    def tree(self) -> Dict[str, Any]:
        """The JAX state dict of the snapshot."""
        parts: Dict[str, list] = {"p": [], "b": [], "m": []}
        for (kind, name), t in zip(self._names, self._host):
            parts[kind].append((name, t))
        opt: Dict[str, Any] = {"count": self.count}
        if self.has_mom:
            opt["mom"] = dict(parts["m"])
        return export_jax_tree(self.step, parts["p"], parts["b"], opt,
                               self.bn_name)


def save_checkpoint(prefix: str, epoch: int, state,
                    meta: Optional[dict] = None,
                    async_save: bool = False,
                    cursor: Optional[dict] = None):
    """Write ``prefix-%04d.state`` from a ``training.train_state.TrainState``
    (its step, params, BN stats and optimizer state) and record its digest
    in ``prefix-meta.json``.  The write is atomic (a temporary file, then a
    rename), so a crash never corrupts an earlier checkpoint.  ``cursor``
    is a JSON dict recorded beside the digest (a fleet checkpoint's data
    position).  Returns the path, or with ``async_save=True`` a
    ``concurrent.futures.Future`` of it: the snapshot is taken now (see
    the module docstring), the rest runs on the background writer.  An
    earlier background failure raises :class:`CheckpointSaveError`
    first."""
    raise_pending_save_error()
    os.makedirs(os.path.dirname(os.path.abspath(prefix)) or ".",
                exist_ok=True)
    path = f"{prefix}-{epoch:04d}.state"
    snap = _HostCopy(state)

    def _write() -> str:
        try:
            snap.wait()
            blob = msgpack.pack(snap.tree())
        finally:
            snap.release()
        _write_bytes(path + ".tmp", blob)
        os.replace(path + ".tmp", path)
        entry: Dict[str, Any] = {"sha256": _digest(blob),
                                 "bytes": len(blob)}
        if cursor is not None:
            entry["cursor"] = dict(cursor)
        _record_meta(prefix, epoch, entry, meta)
        return path

    if async_save:
        fut = _save_pool().submit(_write)
        with _track_lock:
            _outstanding.add(fut)
        fut.add_done_callback(_note_done)
        return fut
    return _write()


# -- the reads --------------------------------------------------------------


def _read_verified(prefix: str, epoch: int, verify: bool) -> bytes:
    path = f"{prefix}-{epoch:04d}.state"
    with open(path, "rb") as f:
        blob = f.read()
    if not blob:
        raise CheckpointCorruptError(path, "zero-byte file")
    if verify:
        ent = checkpoint_info(prefix, epoch)
        if ent is not None and "sha256" in ent:
            got = _digest(blob)
            if got != ent["sha256"]:
                raise CheckpointCorruptError(
                    path, f"sha256 mismatch (file {got[:12]}… != recorded "
                          f"{ent['sha256'][:12]}…)")
    return blob


def _decode(path: str, blob: bytes) -> Dict[str, Any]:
    try:
        state = msgpack.restore(blob)
    except (ValueError, TypeError) as e:  # MsgpackError is a ValueError
        raise CheckpointCorruptError(path, f"undecodable msgpack ({e})") \
            from e
    if not isinstance(state, dict) or "params" not in state:
        raise CheckpointCorruptError(path, "not a TrainState state dict")
    return state


def load_checkpoint(prefix: str, epoch: int,
                    verify: bool = True) -> Dict[str, Any]:
    """``{"step", "params", "batch_stats"}`` of one saved tag, as nested
    dicts of numpy arrays (bfloat16 leaves as torch tensors).  ``verify``
    checks the recorded digest (a checkpoint without one is read as is); the
    optimizer state is not kept."""
    path = f"{prefix}-{epoch:04d}.state"
    state = _decode(path, _read_verified(prefix, epoch, verify))
    return {"step": state.get("step"), "params": state["params"],
            "batch_stats": state.get("batch_stats") or {}}


def _restore(path: str, blob: bytes, state):
    """Decode ``blob`` whole, then fill ``state`` (params, BN stats,
    optimizer state and step, on the module's device) from it; a blob that
    does not fit the state raises :class:`CheckpointCorruptError`."""
    tree = _decode(path, blob)
    try:
        return load_jax_train_state(state, tree)
    except (KeyError, ValueError, TypeError, RuntimeError) as e:
        raise CheckpointCorruptError(
            path, f"does not fit the train state ({e})") from e


def load_checkpoint_file(path: str, state,
                         sha256: Optional[str] = None):
    """Restore ``state`` in place from one state file, verified against a
    digest handed in from elsewhere (a fleet checkpoint's journaled
    sha256, so a resuming worker may adopt any member's blob without
    trusting the blob's own sidecar).  Returns ``state``."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError as e:
        raise CheckpointCorruptError(path, f"unreadable ({e})") from e
    if not blob:
        raise CheckpointCorruptError(path, "zero-byte file")
    if sha256:
        got = _digest(blob)
        if got != sha256:
            raise CheckpointCorruptError(
                path, f"sha256 mismatch (file {got[:12]}… != manifest "
                      f"{sha256[:12]}…)")
    return _restore(path, blob, state)


def _saved_tags(prefix: str) -> List[int]:
    """Every intact-looking saved tag, ascending: ``.tmp`` leftovers never
    match, zero-byte files (torn writes) are skipped."""
    d = os.path.dirname(os.path.abspath(prefix)) or "."
    base = os.path.basename(prefix)
    if not os.path.isdir(d):
        return []
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
    return sorted(tags)


def latest_checkpoint(prefix: str) -> Optional[int]:
    """The newest saved tag for ``prefix``."""
    tags = _saved_tags(prefix)
    return tags[-1] if tags else None


def load_latest_checkpoint(prefix: str, state, verify: bool = True
                           ) -> Optional[Tuple[int, Any]]:
    """Restore ``state`` from the newest intact checkpoint, falling back
    tag by tag past torn or corrupt ones.  Returns ``(tag, state)``, or
    ``None`` when nothing loads."""
    for tag in reversed(_saved_tags(prefix)):
        path = f"{prefix}-{tag:04d}.state"
        try:
            return tag, _restore(path, _read_verified(prefix, tag, verify),
                                 state)
        except CheckpointCorruptError:
            continue
    return None
