"""Inference/serving surface of the port (counterpart of
``dt_tpu/predictor.py``).

``Predictor`` loads a ``dt_tpu`` checkpoint into a port model and serves its
eval forward in batch buckets, as the JAX predictor does: a request of n rows
is padded to the smallest bucket >= n, a request larger than the top bucket
is split into top-bucket chunks, and the padding is sliced off.  All chunks
are dispatched before any result is copied back, so the card runs chunk k+1
while chunk k's logits travel.  Requests are NHWC numpy at the boundary;
inside, images are NCHW in ``torch.channels_last`` (NHWC in memory).
"""

from __future__ import annotations

import copy
import time
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from dt_tpu_torch import models as models_lib
from dt_tpu_torch.config import resolve_device
from dt_tpu_torch.interchange import export_jax_variables, load_jax_variables
from dt_tpu_torch.training import checkpoint as ckpt_lib


def _default_buckets(max_batch: int) -> list:
    out = []
    b = 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(max_batch)
    return out


def _module_forward(module: nn.Module, _stats, x: torch.Tensor):
    return module(x)


class Predictor:
    """``Predictor(model_or_name, prefix, epoch, sample_input)`` ->
    ``predict(x)``.

    ``sample_input`` is one NHWC request (its channel count sizes the model's
    stem).  ``dtype`` is the compute type (``torch.float32`` or
    ``torch.bfloat16``).  ``batch_buckets``: allowed batch sizes (ascending);
    ``None`` -> powers of two up to ``max_batch``.  ``device`` defaults to
    ``"cuda"`` and raises without a GPU unless it is ``"cpu"``.
    """

    def __init__(self, model: Union[str, nn.Module], prefix: str, epoch: int,
                 sample_input: np.ndarray, dtype: torch.dtype = torch.float32,
                 batch_buckets: Optional[Sequence[int]] = None,
                 max_batch: int = 256,
                 device: Union[str, torch.device] = "cuda", **model_kwargs):
        dev = resolve_device(device)
        if isinstance(model, str):
            model_kwargs.setdefault("in_channels",
                                    np.shape(sample_input)[-1])
            model = models_lib.create(model, device=dev, dtype=dtype,
                                      **model_kwargs)
        state = ckpt_lib.load_checkpoint(prefix, epoch)
        self.model = load_jax_variables(
            model.to(dev).eval(),
            {"params": state["params"], "batch_stats": state["batch_stats"]})
        self.step = state["step"]
        self._init_serving(_module_forward, self.model, dtype, dev,
                           batch_buckets, max_batch)

    def _init_serving(self, fwd, params, dtype, device, batch_buckets,
                      max_batch):
        self._fwd = fwd
        self._params = params
        self.dtype = dtype
        self.device = device
        self.batch_buckets = sorted(batch_buckets) if batch_buckets \
            else _default_buckets(max_batch)
        # "compiles" counts the first request at each (bucket, row shape,
        # dtype), as the JAX predictor counts its compiles; nothing compiles
        # here, but the first run of a shape is where cuDNN picks its plans
        self.stats = {"requests": 0, "rows": 0, "compiles": 0,
                      "serve_s": 0.0}
        self._compiled = set()

    @classmethod
    def from_fn(cls, fn: Callable[[Any, Any, torch.Tensor], torch.Tensor],
                params: Any, dtype: torch.dtype = torch.float32,
                batch_buckets: Optional[Sequence[int]] = None,
                max_batch: int = 256,
                device: Union[str, torch.device] = "cuda") -> "Predictor":
        """Serve any ``(params, batch_stats, x) -> y`` forward with the same
        bucketed pipeline (``batch_stats`` is ``{}``; ``x`` is a tensor on
        ``device`` in ``dtype``, NCHW channels_last for images)."""
        self = cls.__new__(cls)
        self.model = None
        self.step = None
        self._init_serving(fn, params, dtype, resolve_device(device),
                           batch_buckets, max_batch)
        return self

    def swap_params(self, params, batch_stats=None) -> None:
        """Replace the served weights between requests.  For a checkpoint
        predictor ``params``/``batch_stats`` are JAX-layout trees (as in a
        checkpoint; ``batch_stats=None`` keeps the current ones), loaded into
        a copy of the model that then replaces it in one assignment: an
        in-flight ``predict`` finishes on the weights it started with."""
        if self.model is None:
            self._params = params
            return
        if batch_stats is None:
            batch_stats = export_jax_variables(self.model)["batch_stats"]
        model = load_jax_variables(copy.deepcopy(self.model),
                                   {"params": params,
                                    "batch_stats": batch_stats})
        self.model = self._params = model

    def _bucket_of(self, n: int) -> int:
        for b in self.batch_buckets:
            if b >= n:
                return b
        return self.batch_buckets[-1]

    def warmup(self, feature_shape: Optional[tuple] = None,
               buckets: Optional[Sequence[int]] = None) -> None:
        """Run every bucket once before serving traffic.  ``feature_shape``:
        per-row shape; required unless a request has already set it."""
        shape = feature_shape or getattr(self, "_row_shape", None)
        if shape is None:
            raise ValueError("warmup needs feature_shape before the "
                             "first request")
        for b in buckets or self.batch_buckets:
            self.predict(np.zeros((b,) + tuple(shape), np.float32),
                         _warmup=True)

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x)).to(self.device,
                                                          self.dtype)
        return t.permute(0, 3, 1, 2) if t.dim() == 4 else t

    def predict(self, x: np.ndarray, _warmup: bool = False) -> np.ndarray:
        """Logits for the rows of ``x`` (NHWC numpy).  They come back as
        numpy float32 also when the compute type is bfloat16, which numpy
        lacks."""
        x = np.asarray(x)
        self._row_shape = x.shape[1:]
        n = x.shape[0]
        t0 = time.perf_counter()
        outs = []  # (device tensor, real row count)
        max_b = self.batch_buckets[-1]
        params = self._params  # one snapshot for the whole request
        # an empty request still answers with the right feature shape:
        # run the smallest bucket once and slice to zero rows
        starts = range(0, n, max_b) if n else [0]
        with torch.inference_mode():
            for start in starts:
                part = x[start:start + max_b]
                b = self._bucket_of(len(part))
                key = (b, part.shape[1:], str(self.dtype))
                if key not in self._compiled:
                    self._compiled.add(key)
                    if not _warmup:
                        self.stats["compiles"] += 1
                if len(part) < b:  # pad up to the bucket, slice back after
                    pad = np.zeros((b - len(part),) + part.shape[1:],
                                   part.dtype)
                    part_b = np.concatenate([part, pad])
                else:
                    part_b = part
                outs.append((self._fwd(params, {}, self._to_device(part_b)),
                             len(part)))
            chunks = [o[:keep].float().cpu().numpy() for o, keep in outs]
        if not _warmup:
            self.stats["requests"] += 1
            self.stats["rows"] += n
            self.stats["serve_s"] += time.perf_counter() - t0
        return chunks[0] if len(chunks) == 1 else np.concatenate(chunks)

    def predict_proba(self, x: np.ndarray) -> np.ndarray:
        logits = self.predict(x)
        z = logits - logits.max(axis=-1, keepdims=True)
        e = np.exp(z)
        return e / e.sum(axis=-1, keepdims=True)
