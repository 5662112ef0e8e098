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

The elastic host-sync step (``sync_mode="host"`` over a ``tpu_sync``
kvstore with an elastic controller, ``module.py:612-1251``) runs as the
JAX package's: the env contract (``NEW_WORKER``, ``EPOCH_BEGIN``,
``ELASTIC_TRAINING_ENABLED``), the recovery re-entry through
``wait_rejoin``, the membership barrier at each epoch with re-sharding
through ``elastic_data_iterator``, the flat gradient and BN stats averaged
across workers (bucketed and overlapped by ``training.overlap``, or
serial; 2-bit words on the wire under ``set_gradient_compression``), the
graceful drain after a step and rank 0's snapshot at each epoch end, from
which joiners bootstrap (``init_params(initialize_from_kvstore=True)``).
With ``DT_CKPT_DIR`` set the fleet checkpoints through
``training.fleet_ckpt`` every ``DT_CKPT_EVERY`` steps and when a draining
scheduler asks at an epoch end; a ``DT_RESUME=1`` worker handed a
committed manifest restores the state, replays the data schedule to the
checkpointed batch and goes on from there (``module.py:710-745, 822-832,
1083-1090, 1112-1115``; not under ``dist_async``, as in the JAX package).
Under the policy engine the barrier reply carries batch shares: the
iterators are rebuilt with the share-weighted batches, and each worker
weights its gradient by ``b_i * W / B`` (:attr:`Module.grad_scale`) before
the wire, so the plain average is the fixed global batch's gradient
(``module.py:929-950, 1188-1218``).

Over a ``dist_async`` kvstore (``module.py:682-698, 864-915``) the master
weights live on the scheduler or the range servers: ``fit`` ships the
optimizer spec and attaches the flat master vector (init-or-get, in the
JAX ravel order of ``training.flat``, so JAX and port workers share one
master), and each step computes the local gradient, withholds a
non-finite one under the halt, pushes it and adopts the master the server
answers, through a pinned buffer and a side stream (the next step's work
waits on that copy's event).  BN stats stay worker-local between the
epoch-end snapshots; rank 0 logs the staleness each epoch.

What the port does not have raises ``NotImplementedError`` naming its
ROADMAP item: a ``mesh_manager`` and the mesh sync mode across processes
(Queue 1 item 4) and ``remat=True`` (item 6).  ``shard_opt_state``/``shard_params`` shard
nothing on one device, as in the JAX package, so they are accepted and
``sharding_report`` stays empty.
"""

from __future__ import annotations

import inspect
import logging
import time
from typing import Callable, Optional, Union

import numpy as np
import torch

from dt_tpu_torch import config as config_lib
from dt_tpu_torch import models as models_lib
from dt_tpu_torch.config import resolve_device
from dt_tpu_torch.obs import metrics as obs_metrics
from dt_tpu_torch.obs import trace as obs_trace
from dt_tpu_torch.ops.losses import softmax_cross_entropy
from dt_tpu_torch.parallel import kvstore as kvstore_lib
from dt_tpu_torch.training import callbacks as callbacks_lib
from dt_tpu_torch.training import metrics as metrics_lib
from dt_tpu_torch.training.step import apply_step, grad_step
from dt_tpu_torch.training.train_state import TrainState

logger = logging.getLogger("dt_tpu_torch")

_ITEM = "is not ported yet; see ROADMAP.md, Queue 1 "


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


def _tensor_leaves(tree, path=()):
    """The paths of a nested dict's ``torch.Tensor`` leaves."""
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _tensor_leaves(v, path + (k,))
        elif isinstance(v, torch.Tensor):
            out.append("/".join(path + (k,)))
    return out


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


def _peek_batch(data_iter) -> None:
    """What the JAX fit's init-time peek does to the iterator
    (``module.py:1288-1293``: reset, one batch, reset).  The port's init
    needs no sample, but a shuffling iterator draws a new order at each
    reset, so a fit that initializes lazily consumes these resets as the
    JAX one does and feeds the same batches (the data schedule a fleet
    checkpoint's cursor replays across the packages)."""
    data_iter.reset()
    data_iter.next()
    data_iter.reset()


def _compute_dtype(model) -> torch.dtype:
    """The model's compute dtype: its own ``dtype``, else its first
    layer's."""
    for m in model.modules():
        dt = getattr(m, "dtype", None)
        if isinstance(dt, torch.dtype):
            return dt
    return torch.float32


class _ServerSideOptimizer:
    """The local optimizer of a ``dist_async`` Module whose optimizer the
    port has not ported for local use: the servers run it, so the state
    keeps a count only and an update is an error."""

    def __init__(self, name: str):
        self.name = name

    def init(self, params) -> dict:
        return {"count": 0}

    def update(self, grads, state, params):
        raise RuntimeError(f"optimizer {self.name!r} runs on the dist_async "
                           "servers, not in this process")


class _AsyncMaster:
    """The host legs of a ``dist_async`` step on a card: the gradient comes
    to a pinned buffer (a copy and an event on the current stream), and
    the master the server answers goes back through a second pinned buffer
    on a side stream into a flat device vector; the current stream waits
    on that copy's event, the host does not.  The pinned master buffer is
    rewritten only once its previous copy completed."""

    def __init__(self, n: int, device: torch.device):
        self.grad = torch.empty(n, dtype=torch.float32, pin_memory=True)
        self.master = torch.empty(n, dtype=torch.float32, pin_memory=True)
        self.flat = torch.empty(n, dtype=torch.float32, device=device)
        self.stream = torch.cuda.Stream(device)
        self.copied = None  # the last H2D's event

    def to_host(self, flat_g: torch.Tensor) -> np.ndarray:
        self.grad.copy_(flat_g, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        ev.synchronize()
        return self.grad.numpy()

    def to_device(self, new_p: np.ndarray) -> torch.Tensor:
        if self.copied is not None:
            self.copied.synchronize()
        np.copyto(self.master.numpy(), new_p)
        cur = torch.cuda.current_stream(self.flat.device)
        self.stream.wait_stream(cur)  # earlier reads of ``flat`` are done
        with torch.cuda.stream(self.stream):
            self.flat.copy_(self.master, non_blocking=True)
            self.copied = torch.cuda.Event()
            self.copied.record(self.stream)
        cur.wait_event(self.copied)
        return self.flat


class Module:
    """Model + loss + optimizer + kvstore, with ``fit``/``score``/
    ``predict``, on one device.

    ``model`` is a port model (``models.create``); it is moved to
    ``device`` (default ``"cuda"``; without a GPU that raises unless
    ``device="cpu"``).  ``loss_fn(logits, labels)`` is a scalar loss, as in
    the JAX package.  The whole training state is ``self.state``, a
    ``training.train_state.TrainState`` holding the model (params and BN
    stats), the step and the optimizer state.  ``async_key`` names the
    flat master vector on the ``dist_async`` servers: two Modules of one
    scheduler need distinct keys (attach is init-or-get).
    """

    def __init__(self, model, loss_fn: Callable = softmax_ce_loss,
                 optimizer: Union[str, object] = "sgd",
                 optimizer_params: Optional[dict] = None,
                 kvstore: Union[str, kvstore_lib.KVStore] = "local",
                 device: Union[str, torch.device] = "cuda",
                 mesh=None, mesh_manager=None, seed: int = 0,
                 remat: bool = False, shard_opt_state: bool = False,
                 shard_params: bool = False, async_key: str = "params",
                 grad_accum: int = 1):
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
        self.kv = kvstore_lib.create(kvstore) if isinstance(kvstore, str) \
            else kvstore
        # the (name, scalar hyperparams) spec dist_async ships to the
        # servers' updater
        self._optimizer_spec = None
        if isinstance(optimizer, str):
            from dt_tpu_torch import optim
            self._optimizer_spec = {"name": optimizer,
                                    **(optimizer_params or {})}
            if self.kv.type == "dist_async" and optimizer.lower() != "sgd":
                optimizer = _ServerSideOptimizer(optimizer)
            else:
                optimizer = optim.create(optimizer,
                                         **(optimizer_params or {}))
        self.tx = optimizer
        self.async_key = async_key
        self._async = None  # _AsyncMaster on a card, lazy
        self.seed = seed
        self.grad_accum = int(grad_accum)
        self.state: Optional[TrainState] = None
        # ZeRO/FSDP coverage; nothing is sharded on one device
        self.sharding_report: dict = {}
        # "mesh": the step on this device; "host": the gradient and BN
        # stats averaged across worker processes through the elastic
        # controller (the two-phase step of module.py:916-991)
        self.sync_mode = "mesh"
        self._overlap = None  # training.overlap.GradSyncEngine, lazy
        # the policy's gradient pre-weight b_i*W/B; fit sets it from the
        # controller's shares (exactly 1.0 without them: no multiply)
        self.grad_scale = 1.0
        self._sentinel = False
        self._halt = False
        self.health_halted = False
        # the committed fleet-checkpoint step a resumed fit restored
        self.resumed_from_step: Optional[int] = None
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
        signature; the port's models know their shapes.  With
        ``initialize_from_kvstore`` a joining worker then loads the
        snapshot its kvstore's controller serves, when there is one
        (``module.py:240-262``): ``{step, params, batch_stats,
        opt_state}`` in the JAX package's names and layout, from either
        package's workers."""
        models_lib.init_params(self.model, self.seed)
        self.state = TrainState.create(self.model, self.tx)
        if initialize_from_kvstore:
            ctrl = getattr(self.kv, "_controller", None)
            snap = ctrl.fetch_snapshot() if ctrl is not None else None
            if snap is not None:
                from dt_tpu_torch.interchange import load_jax_train_state
                load_jax_train_state(self.state, snap)
                logger.info("bootstrapped params from kvstore snapshot "
                            "(step %d)", self.state.step)
        return self.state

    # ------------------------------------------------------------------
    # One step
    # ------------------------------------------------------------------

    def _forward_loss(self, module, x, y):
        kw = {} if self._generator is None else {"generator": self._generator}
        out = module(x, training=True, **kw)
        logits = out[0] if isinstance(out, tuple) else out
        return self.loss_fn(logits, y), logits

    def _stats_snapshot(self):
        """The BN stats before a step, when the halt gate may have to put
        them back (the forward moves them in place); else ``None``."""
        st = self.state
        if self._halt and st.layout.stats.size:
            return st.layout.stats.ravel(st.batch_stats)
        return None

    def _restore_stats(self, stats0) -> None:
        if stats0 is not None:
            with torch.no_grad():
                for name, t in self.state.layout.stats.unravel(
                        stats0).items():
                    self.state.batch_stats[name].copy_(t)

    def _grads(self, data: torch.Tensor, labels: torch.Tensor):
        """``(flat_g, flat_s, loss, logits)`` of one batch: one
        ``grad_step``, or ``grad_accum`` microbatches in sequence with
        their gradients averaged and the BN stats chained."""
        st = self.state
        accum = self.grad_accum
        if accum <= 1:
            return grad_step(st, data, labels, self._forward_loss)
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
        return (flat_g / accum, flat_s, torch.stack(losses).mean(),
                torch.cat(parts))

    def _step(self, data: torch.Tensor, labels: torch.Tensor):
        """One update from one batch: ``(loss, logits, health)``; health is
        ``None`` unless the sentinels are armed.  Under the halt gate a
        non-finite gradient leaves params, optimizer state, step and BN
        stats as they were."""
        stats0 = self._stats_snapshot()
        flat_g, flat_s, loss, logits = self._grads(data, labels)
        return loss, logits, self._apply_synced(flat_g, flat_s, loss,
                                                stats0)

    def _apply_synced(self, flat_g, flat_s, loss, stats0):
        """Apply one (averaged) update; returns the health vector, or
        ``None`` with the sentinels off.  On the host-sync path the
        sentinel checks the averaged gradient, so one worker's poisoned
        contribution halts the whole fleet on the same step."""
        st = self.state
        health = None
        if self._sentinel:
            health = sentinel_health_vec(
                flat_g, st.layout.params.ravel(st.params), loss)
            if self._halt and float(health[0]) > 0:  # the halt's host read
                self._restore_stats(stats0)
                return health
        apply_step(st, flat_g, flat_s)
        return health

    def _overlap_engine(self):
        if self._overlap is None:
            from dt_tpu_torch.training import overlap as overlap_lib
            self._overlap = overlap_lib.GradSyncEngine(self.device)
        return self._overlap

    def _host_sync_step(self, ctrl, data, labels, train_data, epoch):
        """The host-sync step (``module.py:916-991``): local gradient and
        stats, the next batch placed, then the average across workers
        (overlapped or serial, the gradient as 2-bit words under
        compression), then the update.  Returns ``(loss, logits, health,
        prefetched)``."""
        from dt_tpu_torch.elastic import faults as faults_lib
        tr = obs_trace.tracer()
        stats0 = self._stats_snapshot()
        t0 = tr.now()
        flat_g, flat_s, loss, logits = self._grads(data, labels)
        prefetched = self._prefetch_batch(train_data)
        if faults_lib.nan_point("worker.grad", host=getattr(ctrl, "host",
                                                            None)):
            flat_g[0] = float("nan")  # the seeded poison (chaos --plan nan)
        if self.grad_scale != 1.0:
            # the policy's share weight: the f32 multiply by the weight
            # rounded to f32, as the JAX package's weak-typed float does,
            # so 2-bit words agree word for word in a mixed fleet
            flat_g = flat_g * float(np.float32(self.grad_scale))
        if t0 is not None and flat_g.is_cuda:  # the span ends with the work
            torch.cuda.current_stream(flat_g.device).synchronize()
        tr.complete_span("step.grad", t0, {"epoch": epoch})
        gc = self.kv._gradient_compression
        # 2-bit quantization launders NaN (it fails both threshold tests
        # and lodges in the residual), so with the sentinels on a
        # non-finite step ships raw and trips every worker's check
        if gc is not None and self._sentinel and \
                not bool(torch.isfinite(flat_g).all()):
            gc = None
        has_stats = self.state.layout.stats.size > 0
        from dt_tpu_torch.training import overlap as overlap_lib
        if overlap_lib.enabled(ctrl):
            avg_g, avg_s = self._overlap_engine().sync(
                ctrl, gc, flat_g, flat_s if has_stats else None)
        else:
            if gc is not None:
                words = gc.compress_on_device(flat_g)
                payload = {"packed": words.cpu().numpy().view(np.uint32),
                           "n": int(flat_g.numel()),
                           "threshold": gc.threshold}
            else:
                payload = flat_g.cpu().numpy()
            avg_g = torch.from_numpy(
                np.asarray(ctrl.allreduce("grads", payload))).to(
                    self.device)
            avg_s = ctrl.allreduce("stats", flat_s.cpu().numpy()) \
                if has_stats else None
        avg_s = torch.from_numpy(np.asarray(avg_s, np.float32)).to(
            self.device) if avg_s is not None else \
            torch.zeros(0, device=self.device)
        ta = tr.now()
        health = self._apply_synced(avg_g, avg_s, torch.zeros(()), stats0)
        tr.complete_span("step.apply", ta, {"epoch": epoch})
        return loss, logits, health, prefetched

    def _attach_async(self) -> None:
        """Ship the optimizer spec and init-or-get the flat master: the
        first worker seeds it, every other (and a joiner) adopts it."""
        if self._optimizer_spec is None:
            raise ValueError(
                "dist_async needs the optimizer as (name, hyperparams) — "
                "pass optimizer='sgd' style, not an optimizer object (the "
                "spec ships to the servers' updater)")
        st = self.state
        flat = st.layout.params.ravel(st.params).cpu().numpy()
        self._adopt_master(self.kv.attach_flat(
            self.async_key, self._optimizer_spec, flat))

    def _adopt_master(self, new_p) -> None:
        """Load the flat master (numpy, JAX ravel order) into the params;
        on a card through :class:`_AsyncMaster`."""
        st = self.state
        if self.device.type == "cuda":
            if self._async is None:
                self._async = _AsyncMaster(st.layout.params.size,
                                           self.device)
            src = self._async.to_device(np.asarray(new_p, np.float32))
        else:
            src = torch.from_numpy(np.array(new_p, np.float32))
        params = st.params
        with torch.no_grad():
            for name, t in st.layout.params.unravel(src).items():
                params[name].copy_(t)

    def _async_step(self, data, labels, train_data, epoch):
        """The ``dist_async`` step (``module.py:864-915``): local gradient
        and BN stats, the next batch placed, the gradient to the host, then
        (unless the halt withholds a non-finite one) push and adopt the
        post-update master.  No peer barrier: the optimizer and its
        momentum run on the servers.  Returns ``(loss, logits, health,
        prefetched)``."""
        tr = obs_trace.tracer()
        stats0 = self._stats_snapshot()
        t0 = tr.now()
        flat_g, _, loss, logits = self._grads(data, labels)
        prefetched = self._prefetch_batch(train_data)
        if self.device.type == "cuda":
            if self._async is None:
                self._async = _AsyncMaster(flat_g.numel(), self.device)
            g_host = self._async.to_host(flat_g)
        else:
            g_host = flat_g.numpy()
        tr.complete_span("step.grad", t0, {"epoch": epoch})
        health = None
        st = self.state
        if self._sentinel:
            # no post-average apply to fuse the check into: it guards the
            # push, so a non-finite gradient never poisons the master
            health = sentinel_health_vec(
                flat_g, st.layout.params.ravel(st.params), loss)
            if self._halt and float(health[0]) > 0:
                self._restore_stats(stats0)
                return loss, logits, health, prefetched
        tp = tr.now()
        new_p = self.kv.push_flat(self.async_key, g_host)
        tr.complete_span("step.push", tp, {"epoch": epoch})
        th = tr.now()
        self._adopt_master(new_p)
        tr.complete_span("step.h2d", th, {"epoch": epoch})
        st.step += 1
        return loss, logits, health, prefetched

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

    def _check_ported(self) -> None:
        if self.sync_mode not in ("mesh", "host"):
            raise ValueError(f"sync_mode must be 'mesh' or 'host', got "
                             f"{self.sync_mode!r}")
        if self.sync_mode == "mesh" and self.kv.num_workers > 1 and \
                self.kv.type != "dist_async":
            raise NotImplementedError(
                f"the mesh sync mode across {self.kv.num_workers} worker "
                f"processes {_ITEM}item 4 (elastic mesh and survivability); "
                "use sync_mode='host'")

    def _membership_sig(self):
        """What re-shards the data: the member list, this worker's rank
        and the policy decision's seq (a count alone misses an eviction
        and a re-admission at one barrier)."""
        ctrl = getattr(self.kv, "_controller", None)
        pol = getattr(ctrl, "policy_seq", 0) if ctrl is not None else 0
        members = getattr(ctrl, "workers", None)
        if members is not None:
            return (tuple(members), ctrl.rank, pol)
        return (self.kv.num_workers, self.kv.rank, pol)

    def _policy_grad_scale(self, elastic_data_iterator) -> float:
        """The share-aware gradient pre-weight (``module.py:1188-1218``):
        ``b_i * W / B`` from the controller's share units, times the
        decision's LR scale.  Exactly 1.0 without shares (the policy
        engine off, or no decision yet), without an elastic iterator to
        define the global batch, outside the host-sync mode, and under
        ``fixed_per_worker_batch`` (whose batches the shares never
        reshape)."""
        ctrl = getattr(self.kv, "_controller", None)
        shares = getattr(ctrl, "policy_shares", None)
        if not shares or elastic_data_iterator is None or \
                self.sync_mode != "host":
            return 1.0
        if getattr(elastic_data_iterator, "fixed_per_worker_batch", False):
            return 1.0
        workers = list(getattr(ctrl, "workers", None) or [])
        b_global = int(getattr(elastic_data_iterator,
                               "global_batch_size", 0) or 0)
        if not workers or b_global <= 0:
            return 1.0
        from dt_tpu_torch.policy import rescale
        bmap = rescale.batch_map(shares, workers, b_global)
        b = bmap.get(getattr(ctrl, "host", None))
        if b is None:
            return 1.0
        return rescale.grad_weight(b, len(workers), sum(bmap.values())) \
            * float(getattr(ctrl, "policy_lr_scale", 1.0))

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            num_epoch: int = 1, begin_epoch: int = 0,
            batch_end_callback=None, epoch_end_callback=None,
            eval_end_callback=None, elastic_data_iterator=None,
            validation_metric=None):
        """Train from ``begin_epoch`` to ``num_epoch`` (reference
        ``BaseModule.fit``, ``base_module.py:497-623``, with the elastic
        contract of ``:503-552``).  Each epoch passes the membership
        barrier (under an elastic controller or
        ``ELASTIC_TRAINING_ENABLED``; a removed worker returns), rebuilds
        the iterators through ``elastic_data_iterator`` when the members
        changed, resets ``train_data``, runs one step a batch (the metric
        one step behind, the rows a batch pads excluded; under
        ``sync_mode="host"`` with more than one worker the host-sync
        step), calls the batch-end callbacks with a
        ``callbacks.BatchEndParam``, logs the train metric, publishes the
        snapshot (rank 0), calls the epoch-end callbacks with ``(epoch,
        state, metric)``, and scores ``eval_data`` with
        ``validation_metric`` (default: the train metric) before the
        eval-end callback.  Returns the train metric."""
        from dt_tpu_torch.elastic import drain as drain_lib
        from dt_tpu_torch.elastic import faults as faults_lib
        from dt_tpu_torch.training import checkpoint as checkpoint_lib
        from dt_tpu_torch.training import fleet_ckpt
        # the elastic env contract (base_module.py:503-506)
        is_new_worker = config_lib.env_flag(config_lib.ENV_NEW_WORKER)
        elastic_enabled = config_lib.env_flag(config_lib.ENV_ELASTIC_ENABLED)
        env_begin_epoch = config_lib.env_int(config_lib.ENV_EPOCH_BEGIN, -1)
        if is_new_worker and env_begin_epoch >= 0:
            begin_epoch = env_begin_epoch
        self._check_ported()
        ctrl = getattr(self.kv, "_controller", None)
        host = getattr(ctrl, "host", None)
        if ctrl is not None and getattr(ctrl, "recovery_pending", False):
            # crash re-entry under the old name (van.cc:187-218): park
            # until a barrier re-admits us, then take the survivors' state
            begin_epoch = ctrl.wait_rejoin()
            _peek_batch(train_data)
            self.init_params(initialize_from_kvstore=True)
            logger.info("recovered worker re-admitted; resuming at "
                        "epoch %d", begin_epoch)
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
            _peek_batch(train_data)
            self.init_params(initialize_from_kvstore=is_new_worker)
        self._sentinel = obs_metrics.sentinels_enabled()
        self._halt = obs_metrics.halt_enabled()
        members = self._membership_sig()
        self.grad_scale = self._policy_grad_scale(elastic_data_iterator)
        tr = obs_trace.tracer()
        drain_lib.install(host)
        is_async = self.kv.type == "dist_async"
        if is_async:
            self._attach_async()
        fc = fleet_ckpt.FleetCheckpointer.from_env(ctrl, host)
        resume_skip = 0
        manifest = fleet_ckpt.resume_manifest(ctrl)
        if manifest is not None and not is_async:
            # dying here must leave the committed checkpoint reusable
            faults_lib.crash_point("worker.resume", host=host)
            # restored in place, on the module's device
            _, cursor = fleet_ckpt.restore_state(manifest, host, self.state)
            begin_epoch = int(manifest["epoch"])
            resume_skip = int(cursor.get("batches_done", 0))
            self.resumed_from_step = int(manifest["step"])
            # the completed epochs' data schedule, replayed through the
            # iterator protocol, so the shuffle matches the killed run's
            fleet_ckpt.fast_forward(train_data, begin_epoch)
            tr.event("ckpt.resume", {"step": self.resumed_from_step,
                                     "epoch": begin_epoch, "host": host})
            logger.info("cold-restart resume: step %d, epoch %d, %d batches "
                        "into the epoch", self.resumed_from_step,
                        begin_epoch, resume_skip)

        for epoch in range(begin_epoch, num_epoch):
            t_epoch = tr.begin("epoch")
            # a crash rule pinned to this epoch dies here, the boundary
            # the recovery path must survive
            faults_lib.crash_point("module.epoch_begin", host=host,
                                   epoch=epoch)
            if elastic_enabled or ctrl is not None:
                from dt_tpu_torch.elastic.client import WorkerRemoved
                try:
                    self.kv._membership_change_barrier(
                        {"EPOCH_BEGIN": epoch})
                except WorkerRemoved:
                    # the reference terminates removed instances
                    # (launch.py:196-199): leave the fit cleanly
                    logger.info("Epoch[%d] this worker was removed from "
                                "the job; stopping", epoch)
                    tr.abandon(t_epoch)
                    return eval_metric
                sig = self._membership_sig()
                if sig != members:
                    logger.info("Epoch[%d] membership changed: %s -> %s",
                                epoch, members, sig)
                    members = sig
                    if elastic_data_iterator is not None:
                        train_data, new_eval = \
                            elastic_data_iterator.get_data_iterator(self.kv)
                        if new_eval is not None:
                            eval_data = new_eval
                    # a share-only rebalance (the policy seq moved) lands
                    # here too: new batches, a new weight
                    self.grad_scale = self._policy_grad_scale(
                        elastic_data_iterator)
            host_sync = not is_async and self.sync_mode == "host" and \
                self.kv.num_workers > 1
            if host_sync and ctrl is None:
                raise RuntimeError(
                    "sync_mode='host' needs an elastic controller "
                    "(kv.set_controller) to carry the allreduce")
            tic = time.time()
            eval_metric.reset()
            nbatch = 0
            train_data.reset()
            # steps applied this epoch: the fleet checkpoint's cursor
            applied = 0
            if resume_skip:
                # resumed mid-epoch: the restored state holds these
                # batches' updates already
                applied = fleet_ckpt.skip_batches(train_data, resume_skip)
                resume_skip = 0
            # (labels, real rows, logits' host copy) of the step whose
            # metric is not yet counted; the rows a batch pads are not real
            pending = None
            # () nothing prefetched yet, None the epoch is done, else the
            # next batch already placed
            prefetched = ()
            drained = False
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
                faults_lib.stall_point("worker.step", host=host)
                t_step = tr.now()
                if is_async:
                    loss, logits, health, prefetched = self._async_step(
                        data, labels, train_data, epoch)
                elif host_sync:
                    loss, logits, health, prefetched = self._host_sync_step(
                        ctrl, data, labels, train_data, epoch)
                else:
                    loss, logits, health = self._step(data, labels)
                    prefetched = self._prefetch_batch(train_data)
                tr.complete_span("step", t_step, {"epoch": epoch})
                fetched = (_host_labels(batch.label), batch.data.shape[0]
                           - batch.pad, _HostCopy(logits))
                if health is not None and self._health_step(health, loss,
                                                            epoch):
                    break
                applied += 1
                if fc is not None:
                    # the step agrees fleet-wide here (host-sync
                    # lockstep): every worker opens or joins one window
                    fc.maybe_step(self.state, epoch, applied)
                if drain_lib.requested():
                    # SIGTERM: this step is applied; leave through the
                    # membership machinery, no collective error
                    drain_lib.announce(host)
                    if ctrl is not None:
                        try:
                            ctrl.drain()
                        except Exception as e:  # noqa: BLE001
                            logger.warning("drain rpc failed: %s", e)
                    logger.info("Epoch[%d] graceful drain after step %d; "
                                "leaving the job", epoch, self.state.step)
                    drained = True
                    break
                if pending is not None:
                    nbatch = self._flush_metric(pending, eval_metric, epoch,
                                                nbatch, batch_end_callback)
                pending = fetched
            if drained:
                tr.abandon(t_epoch)
                return eval_metric
            if pending is not None:  # the last step's metric and callback
                nbatch = self._flush_metric(pending, eval_metric, epoch,
                                            nbatch, batch_end_callback)
            if self.health_halted:
                logger.warning(
                    "Epoch[%d] training halted by the health sentinel "
                    "(non-finite gradient; update not applied)", epoch)
                tr.complete_span("epoch", t_epoch,
                                 {"epoch": epoch, "halted": True})
                break
            if eval_metric.num_inst > 0:  # empty after a Speedometer reset
                for name, val in eval_metric.get_name_value():
                    logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
            tr.complete_span("epoch", t_epoch,
                             {"epoch": epoch, "nbatch": nbatch})
            logger.info("Epoch[%d] Time cost=%.3f", epoch, time.time() - tic)
            # the epoch-end snapshot joiners bootstrap from
            # (store_aux_params analog, base_module.py:601-605)
            self._publish_snapshot()
            if fc is not None:
                # a draining scheduler's forced checkpoint; the cursor
                # points at the next epoch's first batch
                fc.epoch_end(self.state, epoch + 1, 0)
            if is_async and self.kv.rank == 0:
                try:
                    sst = self.kv.staleness_stats()
                    logger.info("Epoch[%d] dist_async staleness: max %d "
                                "mean %.2f over %d pushes", epoch,
                                sst["max_staleness"], sst["mean_staleness"],
                                sst["measured_pushes"])
                except (RuntimeError, OSError, KeyError):
                    pass  # observability, never fatal
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
        # the last background checkpoint write lands, and a failed one
        # raises, before fit returns
        checkpoint_lib.flush_saves(timeout=120.0)
        return eval_metric

    def _publish_snapshot(self) -> None:
        """Rank 0 pushes the train state to the controller, the copy
        joiners bootstrap from (``module.py:1235-1251``): ``{step, params,
        batch_stats, opt_state}`` as numpy in the JAX package's names and
        layout (HWIO kernels), so a JAX joiner restores it too.  Nothing of
        it is a ``torch.Tensor``."""
        ctrl = getattr(self.kv, "_controller", None)
        if ctrl is None or not hasattr(ctrl, "publish_snapshot") or \
                self.kv.rank != 0:
            return
        from dt_tpu_torch.interchange import export_jax_train_state
        snap = export_jax_train_state(self.state)
        bad = _tensor_leaves(snap)
        if bad:
            raise NotImplementedError(
                f"a snapshot with bfloat16 master params ({bad[:3]}) "
                f"{_ITEM}item 8 (with_multi_precision)")
        ctrl.publish_snapshot(snap)

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
