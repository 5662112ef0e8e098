"""The overlapped host-sync step: bucketed D2H, wire, H2D (counterpart of
``dt_tpu/training/overlap.py``).

The flat gradient (or its 2-bit words) splits into buckets of
``DT_AR_BUCKET_BYTES`` of represented gradient (:func:`bucket_bounds`,
aligned to whole packing words under compression).  Per bucket:

- D2H on a side CUDA stream into a pinned staging buffer
  (:class:`StagingPool`), with an event: the wire reads the buffer only
  after the event completed, and the copy of bucket k+1 is queued before
  the host waits for bucket k;
- the wire round through ``elastic.client.AllreducePipeline``
  (``key#b<k>``), the ``"stats"`` round beside it in the same window;
- H2D of the averaged bucket from a pinned buffer on a second stream; the
  caller's stream waits on that stream's last event before the apply.

A staging buffer goes back to the pool only after its round is done, and
is forfeited (dropped, not recycled) when a failed pipeline could not be
drained.  The buckets only re-tile the elementwise sum the scheduler does
either way, so the result is bit-identical to the serial step
(``DT_AR_OVERLAP=0``).  On a CPU tensor the copies are plain copies.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from dt_tpu_torch import config
from dt_tpu_torch.obs import trace as obs_trace


def enabled(controller) -> bool:
    """Whether the overlapped step applies: ``DT_AR_OVERLAP`` is not 0
    (it must be the same job-wide: bucket subkeys only pair with bucket
    subkeys) and the controller has the pipeline API."""
    if config.env("DT_AR_OVERLAP").strip().lower() in ("0", "false"):
        return False
    return hasattr(controller, "allreduce_pipeline")


@functools.lru_cache(maxsize=256)
def bucket_bounds(n_elems: int, elem_bytes: int, bucket_bytes: int,
                  quantum: int = 1) -> Tuple[Tuple[int, int], ...]:
    """``((start, stop), ...)`` element ranges of the bucket grid of a
    flat vector of ``n_elems``; ``quantum`` aligns the boundaries to whole
    2-bit packing words (16 codes a uint32), the last bucket carries the
    remainder (``overlap.py:52-78``)."""
    if n_elems <= 0:
        return ((0, 0),)
    per = max(1, bucket_bytes // max(elem_bytes, 1))
    if quantum > 1:
        per = max(quantum, (per // quantum) * quantum)
    return tuple((start, min(start + per, n_elems))
                 for start in range(0, n_elems, per))


_NP_OF = {torch.float32: np.float32, torch.int32: np.uint32}


class StagingPool:
    """Reused host staging buffers for the D2H and H2D stages: pinned
    tensors when ``pin`` (a card's copies), plain ones otherwise.
    ``max_bytes`` (``DT_AR_STAGING_MB``) caps what the free list keeps;
    past it a released buffer goes back to the allocator.  Buffers are
    taken and returned on the caller's thread only."""

    def __init__(self, max_bytes: int, pin: bool = False):
        self._max_bytes = int(max_bytes)
        self._pin = bool(pin)
        self._free: Dict[tuple, list] = {}  # (nelems, dtype) -> [buf, ...]
        self._free_bytes = 0
        self.outstanding = 0  # taken and not yet released or forfeited
        self.allocated = 0    # buffers ever allocated (the reuse metric)

    @property
    def max_bytes(self) -> int:
        return self._max_bytes

    def acquire(self, n: int, dtype: torch.dtype) -> torch.Tensor:
        key = (int(n), dtype)
        lst = self._free.get(key)
        if lst:
            buf = lst.pop()
            self._free_bytes -= buf.numel() * buf.element_size()
        else:
            buf = torch.empty(int(n), dtype=dtype, pin_memory=self._pin)
            self.allocated += 1
        self.outstanding += 1
        return buf

    def release(self, buf: torch.Tensor) -> None:
        self.outstanding -= 1
        nbytes = buf.numel() * buf.element_size()
        if self._free_bytes + nbytes > self._max_bytes:
            return
        self._free.setdefault((buf.numel(), buf.dtype), []).append(buf)
        self._free_bytes += nbytes

    def forfeit(self, buf: torch.Tensor) -> None:
        """A buffer a wire thread may still read (the drain timed out):
        dropped, never recycled."""
        del buf
        self.outstanding -= 1


def host_view(buf: torch.Tensor) -> np.ndarray:
    """The wire's numpy view of a staging buffer: f32 as float32, the
    codec's int32 words as uint32 (``{"packed": uint32}``)."""
    return buf.numpy().view(_NP_OF[buf.dtype])


class GradSyncEngine:
    """One Module's overlapped gradient synchronizer; it keeps the staging
    pool and the two side streams across steps."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        cuda = self.device.type == "cuda"
        self._staging = StagingPool(
            int(config.env("DT_AR_STAGING_MB")) * (1 << 20), pin=cuda)
        self._d2h = torch.cuda.Stream(self.device) if cuda else None
        self._h2d = torch.cuda.Stream(self.device) if cuda else None

    @property
    def staging(self) -> StagingPool:
        return self._staging

    def _window(self, controller, bucket_bytes: int) -> int:
        """The pipeline window, clamped so live staging (~2 x window x
        bucket) respects ``DT_AR_STAGING_MB`` (``overlap.py:162-168``)."""
        base = getattr(controller, "_ar_window", None)
        base = base() if callable(base) else 4
        cap = self._staging.max_bytes // max(2 * bucket_bytes, 1)
        return max(1, min(base, cap)) if cap else 1

    def _to_host(self, src: torch.Tensor):
        """Queue ``src``'s copy into a staging buffer; returns ``(buf,
        event)`` (``event`` is ``None`` on the CPU, where the copy is
        done)."""
        buf = self._staging.acquire(src.numel(), src.dtype)
        if self._d2h is None:
            buf.copy_(src)
            return buf, None
        with torch.cuda.stream(self._d2h):
            buf.copy_(src, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(self._d2h)
        return buf, ev

    def sync(self, controller, gc, flat_g: torch.Tensor,
             flat_s: Optional[torch.Tensor] = None, key: str = "grads"):
        """Exact-average ``flat_g`` (and ``flat_s``) across the workers
        through the bucketed pipeline.  ``gc`` is the kvstore's
        ``GradientCompression`` or ``None``.  Returns ``(avg_g, avg_s)``:
        the averaged gradient on ``flat_g``'s device (the caller's stream
        already waits for it) and the averaged stats as numpy, or
        ``None`` without ``flat_s``."""
        tr = obs_trace.tracer()
        t0 = tr.now()
        n = int(flat_g.numel())
        bucket_bytes = int(config.env("DT_AR_BUCKET_BYTES"))
        thr = None
        if gc is not None:
            from dt_tpu_torch.parallel.compression import CODES_PER_WORD
            quantum = CODES_PER_WORD
            src = gc.compress_on_device(flat_g)  # the residual stays put
            thr = float(gc.threshold)
        else:
            quantum = 1
            src = flat_g
        bounds = bucket_bounds(n, 4, bucket_bytes, quantum)
        nb = len(bounds)
        if gc is not None:
            slices = [src[a // quantum: -(-b // quantum)] for a, b in bounds]
        else:
            slices = [src[a:b] for a, b in bounds]
        cuda = self._d2h is not None
        if cuda:  # the side streams start after the step's work
            ready = torch.cuda.Event()
            ready.record()
            self._d2h.wait_event(ready)
            self._h2d.wait_event(ready)
        out = torch.empty(n, dtype=torch.float32, device=flat_g.device)
        outstanding: Dict[int, torch.Tensor] = {}  # idx -> D2H buffer
        uploads: List[tuple] = []  # (event, pinned buffer) of each H2D
        h2d_last = None

        def h2d(i, avg):
            nonlocal h2d_last
            th = tr.now()
            a, b = bounds[i]
            if cuda:
                pinned = self._staging.acquire(b - a, torch.float32)
                np.copyto(pinned.numpy(), avg)
                with torch.cuda.stream(self._h2d):
                    out[a:b].copy_(pinned, non_blocking=True)
                    h2d_last = torch.cuda.Event()
                    h2d_last.record(self._h2d)
                uploads.append((h2d_last, pinned))
            else:
                out[a:b].copy_(torch.from_numpy(np.asarray(avg)))
            tr.complete_span("pipeline.h2d", th, {"bucket": i})
            buf = outstanding.pop(i, None)
            if buf is not None:  # round i is done: the wire let go
                self._staging.release(buf)

        def stage(k):
            buf, ev = self._to_host(slices[k])
            outstanding[k] = buf
            return ev

        pipe = controller.allreduce_pipeline(
            key, window=self._window(controller, bucket_bytes))
        stats_avg = None
        stats_buf = None
        try:
            if flat_s is not None:
                stats_buf, ev = self._to_host(flat_s)
                pending = stage(0)
                if ev is not None:
                    ev.synchronize()
                pipe.submit_aux("stats", host_view(stats_buf).copy())
            else:
                pending = stage(0)
            for k, (a, b) in enumerate(bounds):
                ev = pending
                if k + 1 < nb:  # the next copy queues before this wait
                    pending = stage(k + 1)
                td = tr.now()
                if ev is not None:
                    ev.synchronize()
                tr.complete_span("pipeline.d2h", td,
                                 {"bucket": k, "elems": b - a})
                buf = outstanding[k]
                if obs_trace.enabled():  # the gradient's bytes on the wire
                    tr.counter("pipeline.grad_bytes",
                               buf.numel() * buf.element_size())
                if gc is not None:
                    payload = {"packed": host_view(buf), "n": b - a,
                               "threshold": thr}
                else:
                    payload = host_view(buf)
                pipe.submit(payload)
                for i, avg in pipe.poll():  # H2D overlaps later buckets
                    h2d(i, avg)
            pipe.done_submitting()
            while True:
                got = pipe.next_result()
                if got is None:
                    break
                h2d(*got)
            if flat_s is not None:
                stats_avg = pipe.aux("stats")
        finally:
            joined = pipe.close()
            # every buffer recycles (the comm thread is done with it) or
            # is forfeited: never leaked, never recycled while read
            for buf in outstanding.values():
                (self._staging.release if joined
                 else self._staging.forfeit)(buf)
            outstanding.clear()
            if stats_buf is not None:
                self._staging.release(stats_buf)
            if obs_trace.enabled():
                tr.counter("allreduce.rounds")
            tr.complete_span("allreduce", t0,
                             {"key": key, "pipelined": True, "buckets": nb})
        if cuda:
            if h2d_last is not None:
                torch.cuda.current_stream(self.device).wait_event(h2d_last)
            # a pinned upload buffer is reused only once its copy is done
            for ev, pinned in uploads:
                ev.synchronize()
                self._staging.release(pinned)
        return out, stats_avg
