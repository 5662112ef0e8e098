"""Module: the high-level training loop, on one device (counterpart of
``dt_tpu/training/module.py``).

Reference: ``python/mxnet/module/base_module.py:497-623`` (fit),
``module/module.py`` (init_optimizer/update).  This slice ports the
single-device branch of the JAX ``Module.fit`` (its one-device "mesh" step
with a ``local`` kvstore): every batch is one ``training.step.grad_step``
and one ``apply_step`` on the port's ``TrainState``, with

- ``grad_accum`` microbatches in sequence and one averaged update, the BN
  running stats chained through the microbatches (the JAX ``lax.scan``);
- the training-health sentinel (``[nonfinite, grad_norm, param_norm]``)
  when ``DT_METRICS`` or ``DT_HEALTH_HALT`` is set; under the halt a
  poisoned update (and its BN stats) is never applied and fit stops;
- the metric updated one step behind: step N+1 is launched before step N's
  logits are read, which come to pinned host memory by an asynchronous
  copy with an event, so reading them waits for step N alone and never
  drains the CUDA stream;
- the next batch placed on the device right after a step is launched
  (``_prefetch_batch``), so its copy overlaps the step.

What the slice does not port raises ``NotImplementedError`` naming its
ROADMAP item: the elastic paths (an elastic controller, the elastic
environment, ``elastic_data_iterator`` over several workers,
``sync_mode="host"``, the distributed kvstores: Queue 1 item 3), a
``mesh_manager`` (item 4) and ``remat=True`` (item 6).
``shard_opt_state``/``shard_params`` shard nothing on one device, as in the
JAX package, so they are accepted and ``sharding_report`` stays empty.
"""

from __future__ import annotations

import inspect
import logging
import os
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from dt_tpu_torch import models as models_lib
from dt_tpu_torch.config import resolve_device
from dt_tpu_torch.obs import metrics as obs_metrics
from dt_tpu_torch.ops.losses import softmax_cross_entropy
from dt_tpu_torch.parallel import kvstore as kvstore_lib
from dt_tpu_torch.training import callbacks as callbacks_lib
from dt_tpu_torch.training import metrics as metrics_lib
from dt_tpu_torch.training.step import apply_step, grad_step
from dt_tpu_torch.training.train_state import TrainState

logger = logging.getLogger("dt_tpu_torch")

# the elastic environment of the reference's fit (base_module.py:503-506)
ELASTIC_ENV = ("NEW_WORKER", "ELASTIC_TRAINING_ENABLED", "EPOCH_BEGIN")
_ELASTIC = "see ROADMAP.md, Queue 1 item 3 (the elastic host-sync step)"


def softmax_ce_loss(logits, labels):
    return softmax_cross_entropy(logits, labels)


def sentinel_health_vec(flat_g: torch.Tensor, flat_p: torch.Tensor,
                        loss) -> torch.Tensor:
    """The training-health vector ``[nonfinite_count, grad_norm,
    param_norm]`` (f32, on the gradient's device), as
    ``dt_tpu/training/module.py:59-78`` defines it: a non-finite ``loss``
    counts as one more non-finite entry, and non-finite gradient entries
    are left out of the norm."""
    finite = torch.isfinite(flat_g)
    loss = torch.as_tensor(loss, dtype=torch.float32, device=flat_g.device)
    nonfinite = (flat_g.numel() - finite.sum()
                 + (~torch.isfinite(loss)).to(torch.int64))
    gnorm = torch.sqrt(torch.sum(torch.square(
        torch.where(finite, flat_g, torch.zeros_like(flat_g)))))
    pnorm = torch.sqrt(torch.sum(torch.square(flat_p)))
    return torch.stack([nonfinite.to(torch.float32), gnorm.float(),
                        pnorm.float()])


def _softmax_np(logits: np.ndarray) -> np.ndarray:
    """Metrics take probabilities (the reference's SoftmaxOutput emitted
    them); the models emit logits."""
    z = logits - logits.max(axis=-1, keepdims=True)
    e = np.exp(z)
    return e / e.sum(axis=-1, keepdims=True)


class _HostCopy:
    """A device tensor's copy to the host, started now and read later: on
    the card a ``non_blocking`` copy into pinned memory and an event after
    it, so :meth:`numpy` waits for that copy alone (not for the work queued
    since); on the CPU the tensor itself."""

    def __init__(self, t: torch.Tensor):
        t = t.detach()
        self.event = None
        if t.device.type == "cuda":
            self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self.host.copy_(t, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = t

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        h = self.host
        return (h.float() if h.is_floating_point() else h).numpy()


def _host_labels(label):
    """A batch's labels for the metric: numpy as they are, a placed tensor
    (``DevicePrefetchIter``) by an asynchronous host copy."""
    return _HostCopy(label) if isinstance(label, torch.Tensor) else label


def _update_metric(pending, metric) -> None:
    """Feed one batch's real rows to ``metric``: ``pending`` is (labels,
    real rows, the logits' host copy)."""
    label, n_real, fetched = pending
    lab = label.numpy() if isinstance(label, _HostCopy) \
        else np.asarray(label)
    metric.update(lab[:n_real], _softmax_np(fetched.numpy())[:n_real])


def _compute_dtype(model) -> torch.dtype:
    """The model's compute dtype: its own ``dtype``, else its first
    layer's."""
    for m in model.modules():
        dt = getattr(m, "dtype", None)
        if isinstance(dt, torch.dtype):
            return dt
    return torch.float32


class Module:
    """Model + loss + optimizer + kvstore, with ``fit``/``score``/
    ``predict``, on one device.

    ``model`` is a port model (``models.create``); it is moved to
    ``device`` (default ``"cuda"``; without a GPU that raises unless
    ``device="cpu"``).  ``loss_fn(logits, labels)`` is a scalar loss, as in
    the JAX package.  The whole training state is ``self.state``, a
    ``training.train_state.TrainState`` holding the model (params and BN
    stats), the step and the optimizer state.
    """

    def __init__(self, model, loss_fn: Callable = softmax_ce_loss,
                 optimizer: Union[str, object] = "sgd",
                 optimizer_params: Optional[dict] = None,
                 kvstore: Union[str, kvstore_lib.KVStore] = "local",
                 device: Union[str, torch.device] = "cuda",
                 mesh=None, mesh_manager=None, seed: int = 0,
                 remat: bool = False, shard_opt_state: bool = False,
                 shard_params: bool = False, grad_accum: int = 1):
        if remat:
            raise NotImplementedError(
                "Module(remat=True) is not ported yet (a recomputed forward "
                "would move the BN running stats twice); see ROADMAP.md, "
                "Queue 1 item 6")
        if mesh_manager is not None:
            raise NotImplementedError(
                "Module(mesh_manager=...) is not ported yet; see ROADMAP.md, "
                "Queue 1 item 4 (elastic mesh and survivability)")
        if mesh is not None:
            raise NotImplementedError(
                "Module(mesh=...): the port's Module runs on one device "
                "(the parallel layer is ROADMAP.md, Queue 1 item 6)")
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loss_fn = loss_fn
        if isinstance(optimizer, str):
            from dt_tpu_torch import optim
            optimizer = optim.create(optimizer, **(optimizer_params or {}))
        self.tx = optimizer
        self.kv = kvstore_lib.create(kvstore) if isinstance(kvstore, str) \
            else kvstore
        self.seed = seed
        self.grad_accum = int(grad_accum)
        self.state: Optional[TrainState] = None
        # ZeRO/FSDP coverage; nothing is sharded on one device
        self.sharding_report: dict = {}
        # "mesh": the step on this device; "host" (the elastic host-sync
        # allreduce) is not ported
        self.sync_mode = "mesh"
        self._sentinel = False
        self._halt = False
        self.health_halted = False
        self._dtype = _compute_dtype(self.model)
        takes = inspect.signature(self.model.forward).parameters
        self._generator = None
        if "generator" in takes:  # dropout draws (the JAX dropout rng)
            self._generator = torch.Generator(device=self.device)
            self._generator.manual_seed(seed + 17)

    # ------------------------------------------------------------------
    # Binding / init
    # ------------------------------------------------------------------

    def init_params(self, sample_data=None,
                    initialize_from_kvstore: bool = False) -> TrainState:
        """Draw the model's initial parameters (``models.init_params`` with
        this Module's seed: linen's defaults, from a seeded generator) and
        make the train state.  ``sample_data`` is accepted for the JAX
        signature; the port's models know their shapes.  Bootstrapping from
        a kvstore snapshot (a joining worker's path) is not ported."""
        if initialize_from_kvstore:
            raise NotImplementedError(
                f"bootstrapping params from a kvstore snapshot; {_ELASTIC}")
        models_lib.init_params(self.model, self.seed)
        self.state = TrainState.create(self.model, self.tx)
        return self.state

    # ------------------------------------------------------------------
    # One step
    # ------------------------------------------------------------------

    def _forward_loss(self, module, x, y):
        kw = {} if self._generator is None else {"generator": self._generator}
        out = module(x, training=True, **kw)
        logits = out[0] if isinstance(out, tuple) else out
        return self.loss_fn(logits, y), logits

    def _step(self, data: torch.Tensor, labels: torch.Tensor):
        """One update from one batch: ``(loss, logits, health)``; health is
        ``None`` unless the sentinels are armed.  Under the halt gate a
        non-finite gradient leaves params, optimizer state, step and BN
        stats as they were."""
        st = self.state
        stats0 = None
        if self._halt and st.layout.stats.size:
            stats0 = st.layout.stats.ravel(st.batch_stats)
        accum = self.grad_accum
        if accum <= 1:
            flat_g, flat_s, loss, logits = grad_step(st, data, labels,
                                                     self._forward_loss)
        else:
            n = data.shape[0]
            if n % accum:
                raise ValueError(f"grad_accum={accum} must divide the batch "
                                 f"({n})")
            m = n // accum
            flat_g, losses, parts = None, [], []
            for i in range(accum):
                g, flat_s, loss_i, lg = grad_step(
                    st, data[i * m:(i + 1) * m], labels[i * m:(i + 1) * m],
                    self._forward_loss)
                flat_g = g if flat_g is None else flat_g.add_(g)
                losses.append(loss_i)
                parts.append(lg)
            flat_g = flat_g / accum
            loss = torch.stack(losses).mean()
            logits = torch.cat(parts)
        health = None
        if self._sentinel:
            health = sentinel_health_vec(
                flat_g, st.layout.params.ravel(st.params), loss)
            if self._halt and float(health[0]) > 0:  # the halt's host read
                if stats0 is not None:  # the forward moved them in place
                    with torch.no_grad():
                        for name, t in st.layout.stats.unravel(
                                stats0).items():
                            st.batch_stats[name].copy_(t)
                return loss, logits, health
        apply_step(st, flat_g, flat_s)
        return loss, logits, health

    # ------------------------------------------------------------------
    # Placement
    # ------------------------------------------------------------------

    def _place(self, arr, label: bool = False):
        """A host batch (numpy, or a tensor ``data.io.DevicePrefetchIter``
        already placed) on this Module's device: NHWC images as NCHW
        ``channels_last`` views in the compute dtype, other float data in
        the compute dtype, float labels in f32, integers (labels, tokens)
        as int64.  Host arrays go through pinned memory, so the copy does
        not wait for the step in flight."""
        if isinstance(arr, tuple):
            return tuple(self._place(a, label) for a in arr)
        if isinstance(arr, torch.Tensor):
            t = arr
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr))
        if t.device != self.device:
            if self.device.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory()
            t = t.to(self.device, non_blocking=True)
        if not t.is_floating_point():
            return t.long()
        if label:
            return t.float()
        if t.dim() == 4:
            t = t.permute(0, 3, 1, 2)
        return t.to(self._dtype)

    def _prefetch_batch(self, train_data):
        """The next batch, placed right after the current step is launched
        so its copy overlaps the step; ``None`` when the epoch is done."""
        try:
            batch = train_data.next()
        except StopIteration:
            return None
        return (batch, self._place(batch.data),
                self._place(batch.label, label=True))

    # ------------------------------------------------------------------
    # fit
    # ------------------------------------------------------------------

    def _check_ported(self, elastic_data_iterator) -> None:
        set_env = [k for k in ELASTIC_ENV
                   if os.environ.get(k, "").strip() not in ("", "0", "false",
                                                           "False")]
        if set_env:
            raise NotImplementedError(
                f"the elastic environment ({', '.join(set_env)}) is not "
                f"ported yet; {_ELASTIC}")
        if getattr(self.kv, "_controller", None) is not None:
            raise NotImplementedError(
                f"a kvstore with an elastic controller; {_ELASTIC}")
        if self.sync_mode != "mesh":
            raise NotImplementedError(
                f"sync_mode={self.sync_mode!r}; {_ELASTIC}")
        if elastic_data_iterator is not None and self.kv.num_workers > 1:
            raise NotImplementedError(
                f"elastic_data_iterator over {self.kv.num_workers} workers; "
                f"{_ELASTIC}")

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            num_epoch: int = 1, begin_epoch: int = 0,
            batch_end_callback=None, epoch_end_callback=None,
            eval_end_callback=None, elastic_data_iterator=None,
            validation_metric=None):
        """Train from ``begin_epoch`` to ``num_epoch`` (reference
        ``BaseModule.fit``, ``base_module.py:497-623``).  Each epoch resets
        ``train_data``, runs one step a batch (the metric one step behind,
        the rows a batch pads excluded), calls the batch-end callbacks with
        a ``callbacks.BatchEndParam``, logs the train metric, calls the
        epoch-end callbacks with ``(epoch, state, metric)``, and scores
        ``eval_data`` with ``validation_metric`` (default: the train
        metric) before the eval-end callback.  Returns the train metric."""
        self._check_ported(elastic_data_iterator)
        if batch_end_callback is not None and not isinstance(
                batch_end_callback, (list, tuple)):
            batch_end_callback = [batch_end_callback]
        if epoch_end_callback is not None and not isinstance(
                epoch_end_callback, (list, tuple)):
            epoch_end_callback = [epoch_end_callback]
        eval_metric = metrics_lib.create(eval_metric)
        validation_metric = metrics_lib.create(validation_metric) \
            if validation_metric is not None else eval_metric
        if self.state is None:
            self.init_params()
        self._sentinel = obs_metrics.sentinels_enabled()
        self._halt = obs_metrics.halt_enabled()

        for epoch in range(begin_epoch, num_epoch):
            tic = time.time()
            eval_metric.reset()
            nbatch = 0
            train_data.reset()
            # (labels, real rows, logits' host copy) of the step whose
            # metric is not yet counted; the rows a batch pads are not real
            pending = None
            # () nothing prefetched yet, None the epoch is done, else the
            # next batch already placed
            prefetched = ()
            while True:
                if prefetched:
                    batch, data, labels = prefetched
                elif prefetched is None:
                    break
                else:
                    try:
                        batch = train_data.next()
                    except StopIteration:
                        break
                    data = self._place(batch.data)
                    labels = self._place(batch.label, label=True)
                loss, logits, health = self._step(data, labels)
                fetched = (_host_labels(batch.label), batch.data.shape[0]
                           - batch.pad, _HostCopy(logits))
                prefetched = self._prefetch_batch(train_data)
                if health is not None and self._health_step(health, loss,
                                                            epoch):
                    break
                if pending is not None:
                    nbatch = self._flush_metric(pending, eval_metric, epoch,
                                                nbatch, batch_end_callback)
                pending = fetched
            if pending is not None:  # the last step's metric and callback
                nbatch = self._flush_metric(pending, eval_metric, epoch,
                                            nbatch, batch_end_callback)
            if self.health_halted:
                logger.warning(
                    "Epoch[%d] training halted by the health sentinel "
                    "(non-finite gradient; update not applied)", epoch)
                break
            if eval_metric.num_inst > 0:  # empty after a Speedometer reset
                for name, val in eval_metric.get_name_value():
                    logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            logger.info("Epoch[%d] Time cost=%.3f", epoch, time.time() - tic)
            if epoch_end_callback is not None:
                for cb in epoch_end_callback:
                    cb(epoch, self.state, eval_metric)
            if eval_data is not None:
                res = self.score(eval_data, validation_metric)
                for name, val in res:
                    logger.info("Epoch[%d] Validation-%s=%f", epoch, name,
                                val)
                if eval_end_callback is not None:
                    eval_end_callback(epoch, validation_metric)
        return eval_metric

    def _health_step(self, health, loss, epoch) -> bool:
        """Account one step's health vector (one host read): a non-finite
        gradient is logged, and under ``DT_HEALTH_HALT`` (the step already
        skipped its update) ends the fit.  The metrics plane's gauges are
        ROADMAP Queue 1 item 7."""
        h = health.cpu().numpy()
        nonfinite = int(h[0])
        if nonfinite <= 0:
            return False
        logger.warning("Epoch[%d] step %d: %d non-finite gradient entries "
                       "(grad_norm %g, param_norm %g)", epoch,
                       int(self.state.step), nonfinite, h[1], h[2])
        if not self._halt:
            return False
        self.health_halted = True
        return True

    def _flush_metric(self, pending, eval_metric, epoch, nbatch,
                      batch_end_callback):
        """Count one finished batch: the metric update, then its batch-end
        callbacks, one step after the batch was launched."""
        _update_metric(pending, eval_metric)
        nbatch += 1
        if batch_end_callback is not None:
            p = callbacks_lib.BatchEndParam(epoch, nbatch, eval_metric)
            for cb in batch_end_callback:
                cb(p)
        return nbatch

    # ------------------------------------------------------------------
    # score / predict
    # ------------------------------------------------------------------

    def _forward(self, data: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            out = self.model(data, training=False)
        return out[0] if isinstance(out, tuple) else out

    def score(self, eval_data, eval_metric="acc"):
        """Reference ``BaseModule.score`` (``base_module.py:613-620``): the
        eval-mode forward (BN through ``fused_bn_inference``) over
        ``eval_data``, the metric one batch behind.  Returns the metric's
        ``get_name_value()``."""
        if self.state is None:
            self.init_params()
        eval_metric = metrics_lib.create(eval_metric)
        eval_metric.reset()
        eval_data.reset()
        pending = None
        while True:
            try:
                batch = eval_data.next()
            except StopIteration:
                break
            fetched = (_host_labels(batch.label),
                       batch.data.shape[0] - batch.pad,
                       _HostCopy(self._forward(self._place(batch.data))))
            if pending is not None:
                _update_metric(pending, eval_metric)
            pending = fetched
        if pending is not None:
            _update_metric(pending, eval_metric)
        return eval_metric.get_name_value()

    def predict(self, data) -> np.ndarray:
        """The eval-mode logits of ``data`` (NHWC images) as f32 numpy."""
        if self.state is None:
            self.init_params()
        out = self._forward(self._place(np.asarray(data)))
        return out.float().cpu().numpy()
