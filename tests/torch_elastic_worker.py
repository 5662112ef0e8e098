"""One worker process of an elastic job of the PyTorch port (the port's
mirror of ``tests/elastic_worker.py``).

    python tests/torch_elastic_worker.py --scheduler-port P --host w0 \\
        --out w0.json [--model tinybn|resnet20|resnet50] [--device cpu]

Under the port's launcher (``python -m dt_tpu_torch.launcher.launch``) the
scheduler's port and the host come from the env contract
(``DMLC_PS_ROOT_PORT``, ``DT_WORKER_ID``) and ``--out`` may name the host
as ``{host}``, so one command serves every worker and the joiners.

It registers with the scheduler at ``127.0.0.1:P`` (the JAX package's
``Scheduler`` or the port's), trains through ``Module.fit`` with
``sync_mode="host"`` over a ``tpu_sync`` kvstore (or, with ``--kvstore
dist_async``, pushing to the scheduler-side optimizer; ``--fixed-batch``
keeps ``--global-batch`` a worker), the elastic contract
(``NEW_WORKER``/``EPOCH_BEGIN``, ``DT_RECOVERY`` re-entry, the membership
barrier, re-sharding through ``ElasticDataIterator``, with the shard
weighted by the policy engine's batch shares) and the joiners' snapshot,
and writes a JSON result; each epoch records its batch, the gradient
weight and the scheduler's straggler board at the epoch's end, which is
the board the next barrier's policy decision reads.  ``tinybn`` is the JAX harness's job
(the same dataset, seeds, ``MultiFactorScheduler``, ``ResizeIter``), so a
fleet may mix the two harnesses; ``--init-npz`` loads the JAX worker's
initial variables (``params/<path>``, ``batch_stats/<path>`` arrays),
since the two packages draw from different RNG streams.  The environment
carries scheduler HA (``DT_CTRL_ENDPOINTS``: the client fails over across
the endpoints) and the fleet checkpoint (``DT_CKPT_DIR``,
``DT_CKPT_EVERY``, ``DT_RESUME``) into ``Module.fit``; the result records
``resumed_from_step``, the fence the client ended under and its
``client.failover`` count, and ``--progress F`` rewrites ``F`` with the
global step after every batch.  The obs planes arm from the environment
as the JAX harness's do (``DT_OBS``, ``DT_METRICS``, ``DT_BLACKBOX``,
``DT_DEVICE_OBS``, ``DT_HEALTH_HALT``, ``DT_HANG_S``): the client ships
the heartbeat export and installs the flight recorder's hooks, and the
result records ``health_halted`` beside ``final_step``, the device
plane's ledger (``device_plane``) and ``faults_applied``.  It imports
neither JAX nor the JAX package.
"""

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch import nn  # noqa: E402

from dt_tpu_torch import models  # noqa: E402
from dt_tpu_torch.data import io  # noqa: E402
from dt_tpu_torch.elastic import faults  # noqa: E402
from dt_tpu_torch.elastic.client import WorkerClient  # noqa: E402
from dt_tpu_torch.interchange import load_jax_variables  # noqa: E402
from dt_tpu_torch.models.common import Conv, Dense, bn  # noqa: E402
from dt_tpu_torch.obs import trace as obs_trace  # noqa: E402
from dt_tpu_torch.optim import MultiFactorScheduler  # noqa: E402
from dt_tpu_torch.ops import attention, kernels  # noqa: E402
from dt_tpu_torch.parallel import kvstore as kvstore_lib  # noqa: E402
from dt_tpu_torch.training.module import Module  # noqa: E402

#: the spans of worker 0 that make up the elastic step (training.module,
#: training.overlap, elastic.client)
SPANS = ("step", "step.grad", "pipeline.d2h", "pipeline.wire",
         "pipeline.h2d", "step.apply", "allreduce", "step.push",
         "step.h2d", "ckpt.save", "mc_barrier")


def make_dataset(n=256, seed=1234):
    """The JAX harness's sign-of-mean task with a decision margin
    (``tests/elastic_worker.py:30-48``), the same draws."""
    rng = np.random.RandomState(seed)
    margin = 0.7 / np.sqrt(8 * 8 * 3)
    xs = []
    while sum(len(a) for a in xs) < n:
        cand = rng.normal(0, 1, (2 * n, 8, 8, 3)).astype(np.float32)
        m = cand.mean(axis=(1, 2, 3))
        xs.append(cand[np.abs(m) > margin])
    x = np.concatenate(xs)[:n]
    y = (x.mean(axis=(1, 2, 3)) > 0).astype(np.int32)
    return x, y


def make_val_dataset(n=2048):
    return make_dataset(n, seed=777)


def make_images(n, size, classes, seed=4321):
    """Seeded images in [-1, 1) (NHWC, f32) and labels for the ResNets."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1, 1, (n, size, size, 3)).astype(np.float32)
    y = rng.randint(0, classes, n).astype(np.int32)
    return x, y


class SlowIter:
    """Pass-through iterator firing the ``worker.step`` delay hook before
    each fetch, the one that ends the epoch included, scaled by the
    iterator's batch over the equal split.  ``fit`` fetches the next batch
    between a step's gradient and its allreduce, so each step's rounds
    wait for the delay, the epoch's last step too (the JAX harness's probe
    fires after a batch arrives, which leaves the last step undelayed and
    lets its rounds decay a straggler's score before the barrier)."""

    def __init__(self, it, host, batch, equal_batch):
        self._it = it
        self._host = host
        self._scale = int(batch) / max(int(equal_batch), 1)

    def reset(self):
        self._it.reset()

    def next(self):
        faults.delay_point("worker.step", host=self._host, scale=self._scale)
        return self._it.next()

    def __getattr__(self, name):
        return getattr(self._it, name)


class TinyBNNet(nn.Module):
    """Conv + BN + ReLU + mean + dense, with the JAX harness's variable
    names (``Conv_0``, ``BatchNorm_0``, ``Dense_0``)."""

    def __init__(self):
        super().__init__()
        self.dtype = torch.float32
        self.Conv_0 = Conv(3, 8, (3, 3))
        self.BatchNorm_0 = bn(8, relu=True)
        self.Dense_0 = Dense(8, 2)

    def forward(self, x, training=True):
        x = self.BatchNorm_0(self.Conv_0(x), training=training)
        return self.Dense_0(x.mean(dim=(2, 3)))


def load_npz_variables(model, path):
    """``{"params": ..., "batch_stats": ...}`` from an npz of
    ``<collection>/<path>`` arrays, into ``model``."""
    tree = {}
    with np.load(path) as z:
        for key in z.files:
            node = tree
            *parents, leaf = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = z[key]
    load_jax_variables(model, tree)


def state_digest(st) -> str:
    """sha256 of the raw bytes of the flat params, BN stats and optimizer
    state (momentum in the params' order, then the count)."""
    h = hashlib.sha256()
    lay = st.layout
    h.update(lay.params.ravel(st.params).cpu().numpy().tobytes())
    if lay.stats.size:
        h.update(lay.stats.ravel(st.batch_stats).cpu().numpy().tobytes())
    if "mom" in st.opt_state:
        h.update(lay.params.ravel(st.opt_state["mom"]).cpu().numpy()
                 .tobytes())
    h.update(np.int64(st.opt_state["count"]).tobytes())
    h.update(np.int64(st.step).tobytes())
    return h.hexdigest()


def launch_counts() -> dict:
    """Every kernel wrapper's launch counter, and (with tracing on) the
    gradient bytes the overlap engine put on the wire and every frame's
    bytes, sent and received."""
    tr = obs_trace.tracer()
    return {"bn_stats": kernels.bn_stats.launches,
            "bn_act": kernels.bn_act.launches,
            "quantize_2bit": kernels.quantize_2bit.launches,
            "dequantize_2bit": kernels.dequantize_2bit.launches,
            "flash_attention": attention.flash_fwd.launches,
            "lstm_pointwise": kernels.lstm_point.launches,
            "lstm_layer": kernels.lstm_layer.launches,
            "lstm_layer_bwd": kernels.lstm_layer_bwd.launches,
            "grad_bytes": tr.get_counter("pipeline.grad_bytes"),
            "wire_bytes": tr.get_counter("wire.bytes_sent"),
            "wire_recv_bytes": tr.get_counter("wire.bytes_recv")}


#: the records the heartbeat export drained from the process tracer (the
#: client ships them to the scheduler); :func:`keep_drained` collects them
_DRAINED: list = []


def keep_drained() -> None:
    """Keep a copy of every record the export drains, so
    :func:`span_summary` reads the whole run."""
    tr = obs_trace.tracer()
    drain = tr.drain

    def keeping(max_records=None):
        out = drain(max_records)
        _DRAINED.extend(out)
        return out
    tr.drain = keeping


def span_summary() -> dict:
    """Durations (ms) of this process's :data:`SPANS`, in record order, and
    each step's and membership barrier's start (ms, wall clock) as
    ``step_start`` and ``mc_barrier_start``."""
    out = {k: [] for k in SPANS}
    out["step_start"], out["mc_barrier_start"] = [], []
    for rec in _DRAINED + obs_trace.tracer().snapshot()["records"]:
        if rec[0] == "X" and rec[2] in SPANS:
            out[rec[2]].append(rec[4] / 1e3)
            if rec[2] in ("step", "mc_barrier"):
                out[rec[2] + "_start"].append(rec[3] / 1e3)
    return out


def build(args, dev):
    """(model, x, y, val, lr schedule, momentum, wd) of ``--model``; ``val``
    is ``(images, labels, batch)`` scored after every epoch, as the JAX
    harness does (``tinybn``: its held-out set; a ResNet: ``--val-images``
    seeded images in batches of 32, none without)."""
    if args.model == "tinybn":
        x, y = make_dataset()
        model = TinyBNNet()
        spe = len(x) // args.global_batch
        lr = MultiFactorScheduler(steps=[10 * spe, 13 * spe], factor=0.1,
                                  base_lr=args.lr or 0.1)
        return model.to(dev), x, y, make_val_dataset() + (256,), lr, 0.9, \
            0.0
    dtype = getattr(torch, args.dtype)
    classes = 10 if args.model == "resnet20" else 1000
    x, y = make_images(args.images or (256 if classes == 10 else 128),
                       args.image_size, classes)
    model = models.create(args.model, device=dev, dtype=dtype,
                          num_classes=classes)
    val = make_images(args.val_images, args.image_size, classes,
                      seed=8765) + (32,) if args.val_images else None
    return model, x, y, val, args.lr or 0.025, 0.9, args.wd


def main():
    t_main = time.time() * 1e3  # the imports done (wall clock, ms)
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheduler-port", type=int,
                    default=int(os.environ.get("DMLC_PS_ROOT_PORT") or 0))
    ap.add_argument("--host", default=os.environ.get("DT_WORKER_ID", ""))
    ap.add_argument("--num-epoch", type=int, default=6)
    ap.add_argument("--global-batch", type=int, default=32)
    ap.add_argument("--out", required=True,
                    help="result file; {host} is replaced by the host")
    ap.add_argument("--heartbeat", type=float, default=1.0)
    ap.add_argument("--model", default="tinybn",
                    choices=("tinybn", "resnet20", "resnet50"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--compress", type=float, default=None,
                    help="2-bit gradient compression at this threshold")
    ap.add_argument("--init-npz", default=None)
    ap.add_argument("--images", type=int, default=0)
    ap.add_argument("--image-size", type=int, default=224,
                    help="image side (resnet20 and resnet50)")
    ap.add_argument("--epoch-steps", type=int, default=0,
                    help="steps an epoch (default: one pass over the "
                         "images at the global batch)")
    ap.add_argument("--val-images", type=int, default=0,
                    help="ResNets: seeded images scored after every epoch")
    ap.add_argument("--lr", type=float, default=0.0)
    ap.add_argument("--wd", type=float, default=1e-4)
    ap.add_argument("--bare-steps", type=int, default=0,
                    help="after fit, time this many bare train steps")
    ap.add_argument("--profile-epoch", type=int, default=-1,
                    help="the card's busy time over this epoch "
                         "(torch.profiler), and its idle share")
    ap.add_argument("--deterministic", action="store_true",
                    help="cuDNN's deterministic algorithms (runs compared "
                         "bit for bit)")
    ap.add_argument("--kvstore", default="tpu_sync",
                    choices=("tpu_sync", "dist_async"))
    ap.add_argument("--fixed-batch", action="store_true",
                    help="--global-batch is each worker's batch")
    ap.add_argument("--progress", default="",
                    help="rewrite this file with the global step after "
                         "every batch; {host} is replaced by the host")
    args = ap.parse_args()
    if not args.scheduler_port or not args.host:
        ap.error("--scheduler-port and --host (or the launcher's "
                 "DMLC_PS_ROOT_PORT and DT_WORKER_ID) are needed")
    args.out = args.out.format(host=args.host)
    args.progress = args.progress.format(host=args.host)

    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        if args.deterministic:
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
    model, x, y, val, lr, momentum, wd = build(args, dev)
    # a worker can be started early and released by a marker file, so
    # its start-up does not fall inside the job's epochs
    wait_file = os.environ.get("DT_WAIT_FILE")
    if wait_file:
        while not os.path.exists(wait_file):
            time.sleep(0.05)
    t_built = time.time() * 1e3  # the model and data built
    keep_drained()
    ctrl = WorkerClient("127.0.0.1", args.scheduler_port, host=args.host,
                        heartbeat_interval_s=args.heartbeat)
    begin_epoch = 0
    if ctrl.recovery_pending:
        begin_epoch = ctrl.wait_rejoin()
    kv = kvstore_lib.create(args.kvstore)
    kv.set_controller(ctrl)
    attach = {}  # dist_async: the master served at attach, the first params
    if args.kvstore == "dist_async":
        attach_flat = kv.attach_flat

        def recording_attach(key, spec, flat):
            cur = attach_flat(key, spec, flat)
            attach["served_sha256"] = hashlib.sha256(
                np.ascontiguousarray(cur, np.float32).tobytes()).hexdigest()
            return cur

        kv.attach_flat = recording_attach
    if args.compress:
        kv.set_gradient_compression({"type": "2bit",
                                     "threshold": args.compress})

    live = {}  # the batch of the iterators fit trains on now

    def factory(num_parts, part_index, batch_size, weights=None):
        # ``weights``: the policy's rank-ordered batches, a weighted
        # contiguous shard (None: the equal strided split)
        live["batch"] = batch_size
        it = io.NDArrayIter(x, y, batch_size=batch_size, shuffle=True,
                            num_parts=num_parts, part_index=part_index,
                            seed=99, part_weights=weights)
        resized = io.ResizeIter(
            it, size=args.epoch_steps or len(x) // args.global_batch)
        return SlowIter(resized, args.host, batch_size,
                        args.global_batch // max(num_parts, 1)), None

    eit = io.ElasticDataIterator(factory, args.global_batch,
                                 fixed_per_worker_batch=args.fixed_batch)
    train, _ = eit.get_data_iterator(kv)
    mod = Module(model, optimizer="sgd",
                 optimizer_params={"learning_rate": lr, "momentum": momentum,
                                   "weight_decay": wd},
                 kvstore=kv, seed=7, device=dev)
    mod.sync_mode = "host"
    if args.kvstore == "dist_async":
        attach_async = mod._attach_async

        def recording_attach_async():
            attach_async()
            st = mod.state
            attach["first_params_sha256"] = hashlib.sha256(
                st.layout.params.ravel(st.params).cpu().numpy()
                .tobytes()).hexdigest()

        mod._attach_async = recording_attach_async
    bootstrap_step = None
    if os.environ.get("NEW_WORKER") == "1" or \
            os.environ.get("DT_RECOVERY") == "1":
        mod.init_params(initialize_from_kvstore=True)
        bootstrap_step = int(mod.state.step)
    elif args.init_npz:
        mod.init_params()
        load_npz_variables(mod.model, args.init_npz)
    # else fit initializes, as the JAX harness's does (its init-time peek
    # draws the same shuffles)

    epochs = []
    marks = {"t": time.monotonic(), "launch": launch_counts(),
             "step": int(mod.state.step) if mod.state is not None else 0}

    def record(epoch, state, metric):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        if mod.resumed_from_step is not None and not epochs:
            marks["step"] = mod.resumed_from_step  # fit restored the state
        now, counts = time.monotonic(), launch_counts()
        loss = dict(metric.get_name_value()).get("cross-entropy")
        epochs.append({
            "epoch": epoch, "step": int(state.step),
            "steps": int(state.step) - marks["step"],
            "sha256": state_digest(state), "loss": loss,
            "num_workers": kv.num_workers, "rank": kv.rank,
            "batch": live["batch"], "grad_scale": mod.grad_scale,
            "policy_seq": ctrl.policy_seq,
            "policy_shares": dict(ctrl.policy_shares),
            "board": ctrl._req({"cmd": "status"}).get("straggler"),
            "seconds": now - marks["t"],
            "launches": {k: counts[k] - marks["launch"][k] for k in counts}})
        marks.update(t=now, launch=counts, step=int(state.step))
        if epoch == args.profile_epoch and "prof" in marks:
            prof = marks.pop("prof")
            prof.stop()
            busy = sum(e.self_device_time_total
                       for e in prof.key_averages()) / 1e3
            wall = epochs[-1]["seconds"] * 1e3
            epochs[-1]["device_busy_ms"] = busy
            epochs[-1]["idle_share"] = max(0.0, 1 - busy / wall) \
                if busy else None
        if val is not None:  # validation, outside the epoch's window
            acc = dict(mod.score(io.NDArrayIter(val[0], val[1],
                                                batch_size=val[2]), "acc"))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            counts = launch_counts()
            epochs[-1]["val_acc"] = float(acc["accuracy"])
            epochs[-1]["score_launches"] = {
                k: counts[k] - marks["launch"][k]
                for k in ("bn_stats", "bn_act")}
            marks.update(t=time.monotonic(), launch=counts)
        if epoch + 1 == args.profile_epoch and dev.type == "cuda":
            from torch.profiler import ProfilerActivity, profile
            marks["prof"] = profile(activities=[ProfilerActivity.CUDA])
            marks["prof"].start()
            marks["t"] = time.monotonic()  # the window opens here

    batch_end = None
    if args.progress:
        def batch_end(param):
            tmp = args.progress + ".tmp"
            with open(tmp, "w") as f:
                f.write(str(int(mod.state.step)))
            os.replace(tmp, args.progress)

    mod.fit(train, num_epoch=args.num_epoch, begin_epoch=begin_epoch,
            elastic_data_iterator=eit, eval_metric="ce",
            epoch_end_callback=record, batch_end_callback=batch_end)

    st = mod.state
    flat = torch.cat([st.layout.params.ravel(st.params),
                      st.layout.stats.ravel(st.batch_stats)]).cpu().numpy()
    result = {
        "host": args.host, "model": args.model, "device": str(dev),
        "final_step": int(st.step),
        "final_sha256": state_digest(st),
        # the health sentinel stopped the fit before a poisoned update
        # (DT_HEALTH_HALT): final_step is then the pre-fault prefix
        "health_halted": bool(mod.health_halted),
        "param_sum": float(flat.sum()),
        "param_hash": float(np.abs(flat).sum()),
        "num_workers_at_end": kv.num_workers,
        "bootstrap_step": bootstrap_step,
        "resumed_from_step": mod.resumed_from_step,
        "fence": ctrl.fence,
        "failovers": obs_trace.tracer().get_counter("client.failover"),
        "attach": attach,
        "epochs": epochs,
        "spans": span_summary() if obs_trace.enabled() else None,
        "start_ms": {"main": t_main, "built": t_built},
    }
    # the device plane's compile ledger (DT_DEVICE_OBS), and the faults
    # this incarnation applied (kind, host, count), as the JAX harness
    # records them
    from dt_tpu_torch.obs import device as obs_device
    if obs_device.enabled():
        result["device_plane"] = obs_device.summary()
    plan = faults.active_plan()
    result["faults_applied"] = (
        [[plan.rules[i].kind, h, n] for i, h, n in plan.applied_summary()]
        if plan else [])
    if args.model == "tinybn":
        # the JAX harness's final_loss: cross-entropy on its held-out set
        result["final_loss"] = float(dict(mod.score(
            io.NDArrayIter(val[0], val[1], batch_size=val[2]),
            "ce"))["cross-entropy"])
    if args.bare_steps:
        from dt_tpu_torch.training.step import train_step
        xb = mod._place(x[:args.global_batch // max(kv.num_workers, 1)])
        yb = mod._place(y[:xb.shape[0]], label=True)
        times = []
        for _ in range(args.bare_steps):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            train_step(st, xb, yb)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        result["bare_step_ms"] = times
    # the wall clock (the spans' clock) as the result is written: an
    # evicted worker's exit against the survivors' steps
    result["end_ms"] = time.time() * 1e3
    with open(args.out, "w") as f:
        json.dump(result, f)
    ctrl.close()


if __name__ == "__main__":
    main()
