"""One worker process of a mesh job of the PyTorch port (after
``tests/jaxdist_worker*.py`` and ``tests/torch_elastic_worker.py``).

An elastic job against the port's scheduler::

    python tests/torch_mesh_worker.py --scheduler-port P --host w0 \\
        --coordinator 127.0.0.1:C --out w0.json [--model tinybn|resnet20|
        resnet50] [--device cpu|cuda] [--zero] [--fsdp] [--deterministic]

trains through ``Module.fit`` in the mesh sync mode with a
``MeshManager`` whose store the first rank 0 serves at ``--coordinator``:
the world forms at the first barrier and is rebuilt at each change of
members, the batch re-sharded through ``ElasticDataIterator`` (global
batch ``--global-batch``), the joiner (``NEW_WORKER=1``) bootstrapped from
rank 0's epoch-end snapshot.  Each epoch records the sha256 of the state
gathered whole (params, BN stats, momentum, count and step), the kernels'
launches, the mesh's counters, the bytes the card holds between steps and
(with ``DT_OBS=1``) the step's spans.

A fixed world, no scheduler::

    python tests/torch_mesh_worker.py --world 4 --rank R \\
        --coordinator 127.0.0.1:C --init-npz init.npz --data-npz d{rank}.npz \\
        --out r{rank}.npz [--model ...] [--zero] [--fsdp]

loads the JAX-layout variables of ``--init-npz``, trains one epoch over
this rank's rows (``x``/``y`` of ``--data-npz``, batch ``--batch``) and
writes the whole state after it (``params/<path>``, ``batch_stats/<path>``,
``mom/<path>``) to ``--out``.  With ``--bn-case`` instead, it runs one
training BatchNorm (``ops.kernels.fused_bn_train`` across the ranks) on its
rows of ``x`` (NHWC) of ``--data-npz``, without and with the ReLU, and
backward from the cotangent ``gy`` there, and writes ``y``, ``dx``, its
local ``dgamma``/``dbeta`` and the new running stats.  It imports neither
JAX nor the JAX package.
"""

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

from dt_tpu_torch import models  # noqa: E402
from dt_tpu_torch.data import io  # noqa: E402
from dt_tpu_torch.elastic.mesh_manager import (MeshManager,  # noqa: E402
                                               snapshot_state)
from dt_tpu_torch.obs import trace as obs_trace  # noqa: E402
from dt_tpu_torch.ops import kernels  # noqa: E402
from dt_tpu_torch.training.module import Module  # noqa: E402
from torch_elastic_worker import (TinyBNNet, keep_drained,  # noqa: E402
                                  load_npz_variables, make_dataset,
                                  make_images, _DRAINED)

#: the spans of the mesh step (training.module, ops.kernels,
#: elastic.mesh_manager, elastic.client)
SPANS = ("step", "step.grad", "step.apply", "mesh.bn_allreduce",
         "mesh.grad_allreduce", "mesh.rebuild", "mc_barrier")


def flat_tree(tree, prefix=""):
    """``{"a/b/c": array}`` of a nested dict, keys sorted."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flat_tree(v, key + "/"))
        else:
            out[key] = np.asarray(v.float() if isinstance(v, torch.Tensor)
                                  else v)
    return out


def blob_digest(blob, parts=("params", "batch_stats", "opt_state",
                             "step")) -> str:
    """sha256 of a snapshot's arrays (in sorted path order)."""
    h = hashlib.sha256()
    for key, arr in flat_tree({k: blob[k] for k in parts}).items():
        h.update(key.encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def launch_counts() -> dict:
    return {"bn_sums": kernels.bn_sums.launches,
            "bn_stats": kernels.bn_stats.launches,
            "bn_act": kernels.bn_act.launches}


def span_summary() -> dict:
    """Durations (ms) of :data:`SPANS` in record order, and each step's
    and barrier's start (ms, wall clock) as ``step_start`` and
    ``mc_barrier_start``."""
    out = {k: [] for k in SPANS}
    out["step_start"], out["mc_barrier_start"] = [], []
    for rec in _DRAINED + obs_trace.tracer().snapshot()["records"]:
        if rec[0] == "X" and rec[2] in SPANS:
            out[rec[2]].append(rec[4] / 1e3)
            if rec[2] in ("step", "mc_barrier"):
                out[rec[2] + "_start"].append(rec[3] / 1e3)
    return out


def build(args, dev, data=True):
    """(model, x, y, lr, momentum, wd) of ``--model`` (``x``, ``y``
    ``None`` without ``data``)."""
    if args.model == "tinybn":
        x, y = make_dataset() if data else (None, None)
        return TinyBNNet().to(dev), x, y, args.lr or 0.1, 0.9, 0.0
    classes = 10 if args.model == "resnet20" else 1000
    x, y = make_images(args.images or (256 if classes == 10 else 128),
                       args.image_size, classes) if data else (None, None)
    model = models.create(args.model, device=dev,
                          dtype=getattr(torch, args.dtype),
                          num_classes=classes)
    return model, x, y, args.lr or 0.025, 0.9, args.wd


def fixed_world(args, dev, lr, momentum, wd, mesh=None, rank=None):
    """The fixed world (``mesh``, or one formed here): one epoch over this
    rank's rows in each mode of ``--modes`` in turn (``dp``,
    ``zero1_fsdp``; ``_f32`` computes in float32), each from
    ``--init-npz``; the whole state after it written to ``--out``
    (``{mode}`` names the mode), and a JSON line a mode with the bytes the
    device holds after the epoch and this rank's cross-entropy."""
    mm = None
    if mesh is None:
        mm = MeshManager(args.coordinator, device=dev)
        mesh = mm.initialize(args.world, args.rank)
    rank = args.rank if rank is None else rank
    with np.load(args.data_npz.format(rank=rank)) as z:
        x, y = z["x"], z["y"]
    modes = args.modes.split(",") if args.modes else \
        ["zero1_fsdp" if args.zero or args.fsdp else "dp"]
    lines = []
    for mode in modes:
        # a mode names its sharding (an elastic worker's --zero/--fsdp are
        # the job's, not the modes')
        zero = mode.startswith("zero1_fsdp") if args.modes else args.zero
        fsdp = mode.startswith("zero1_fsdp") if args.modes else args.fsdp
        dtype = "float32" if mode.endswith("_f32") else args.dtype
        model = build(argparse.Namespace(**{**vars(args), "dtype": dtype}),
                      dev, data=False)[0]
        mod = Module(model, optimizer="sgd",
                     optimizer_params={"learning_rate": lr,
                                       "momentum": momentum,
                                       "weight_decay": wd},
                     device=dev, mesh=mesh, shard_opt_state=zero,
                     shard_params=fsdp)
        mod.init_params()
        if args.init_npz:
            load_npz_variables(mod.model, args.init_npz)
        before = launch_counts()
        t0 = time.perf_counter()
        metric = mod.fit(io.NDArrayIter(x, y, batch_size=args.batch),
                         num_epoch=1, eval_metric="ce")
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        after = launch_counts()
        held = torch.cuda.memory_allocated(dev) if dev.type == "cuda" \
            else None
        blob = snapshot_state(mod.state)
        flat = flat_tree({"params": blob["params"],
                          "batch_stats": blob["batch_stats"],
                          "mom": blob["opt_state"].get("mom", {})})
        np.savez((args.state_out or args.out).format(rank=rank, mode=mode),
                 **flat)
        lines.append({"rank": rank, "mode": mode, "backend": mesh.backend,
                      "sha256": blob_digest(blob),
                      "sharding_report": mod.sharding_report,
                      "memory_allocated": held, "seconds": seconds,
                      "loss": dict(metric.get_name_value())["cross-entropy"],
                      "launches": {k: after[k] - before[k] for k in after}})
        print(json.dumps(lines[-1]), flush=True)
        del mod, model, blob, flat
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if mm is not None:
        mm.teardown()
    return lines


def bn_case(args, dev):
    """One cross-rank training BN forward and backward on this rank's
    rows; see the module's docstring."""
    mm = MeshManager(args.coordinator, device=dev)
    mesh = mm.initialize(args.world, args.rank)
    with np.load(args.data_npz) as z:
        d = {k: z[k] for k in z.files}
    n = d["x"].shape[0] // args.world
    rows = slice(args.rank * n, (args.rank + 1) * n)
    out = {}
    for relu in (False, True):
        base = torch.from_numpy(d["x"][rows].copy()).to(dev)
        base.requires_grad_()
        gamma = torch.from_numpy(d["gamma"]).to(dev).requires_grad_()
        beta = torch.from_numpy(d["beta"]).to(dev).requires_grad_()
        rm = torch.from_numpy(d["rm"].copy()).to(dev)
        rv = torch.from_numpy(d["rv"].copy()).to(dev)
        with kernels.cross_rank_bn(mesh.group):
            y, rm, rv = kernels.fused_bn_train(
                base.permute(0, 3, 1, 2), gamma, beta, rm, rv,
                momentum=0.9, eps=1e-5, relu=relu)
        gy = torch.from_numpy(d["gy"][rows].copy()).to(dev)
        (y.permute(0, 2, 3, 1) * gy).sum().backward()
        tag = "relu" if relu else "plain"
        out.update({f"{tag}/y": y.permute(0, 2, 3, 1), f"{tag}/dx": base.grad,
                    f"{tag}/dgamma": gamma.grad, f"{tag}/dbeta": beta.grad,
                    f"{tag}/mean": rm, f"{tag}/var": rv})
    np.savez(args.out.format(rank=args.rank),
             **{k: v.detach().cpu().numpy() for k, v in out.items()})
    mm.teardown()


def main():
    t_main = time.time() * 1e3
    ap = argparse.ArgumentParser()
    ap.add_argument("--scheduler-port", type=int, default=0)
    ap.add_argument("--host", default="")
    ap.add_argument("--coordinator", required=True,
                    help="host:port of the store rank 0 serves")
    ap.add_argument("--out", required=True)
    ap.add_argument("--num-epoch", type=int, default=3)
    ap.add_argument("--global-batch", type=int, default=32)
    ap.add_argument("--model", default="tinybn",
                    choices=("tinybn", "resnet20", "resnet50"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--images", type=int, default=0)
    ap.add_argument("--image-size", type=int, default=224)
    ap.add_argument("--epoch-steps", type=int, default=0)
    ap.add_argument("--lr", type=float, default=0.0)
    ap.add_argument("--wd", type=float, default=1e-4)
    ap.add_argument("--zero", action="store_true",
                    help="shard_opt_state (ZeRO-1)")
    ap.add_argument("--fsdp", action="store_true",
                    help="shard_params (FSDP)")
    ap.add_argument("--deterministic", action="store_true",
                    help="cuDNN's deterministic algorithms")
    ap.add_argument("--heartbeat", type=float, default=1.0)
    ap.add_argument("--world", type=int, default=0,
                    help="a fixed world of this many ranks, no scheduler")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--init-npz", default=None)
    ap.add_argument("--data-npz", default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--bn-case", action="store_true",
                    help="one cross-rank BatchNorm, not a Module")
    ap.add_argument("--state-out", default="",
                    help="fixed world: where each mode's state goes "
                         "(default --out)")
    ap.add_argument("--modes", default="",
                    help="fixed world: dp,zero1_fsdp (default: the flags)")
    ap.add_argument("--val-images", type=int, default=0,
                    help="seeded images scored after every epoch, this "
                         "rank's strided part")
    args = ap.parse_args()

    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        if args.deterministic:
            torch.backends.cudnn.deterministic = True
            torch.backends.cudnn.benchmark = False
    if args.bn_case:
        return bn_case(args, dev)
    if args.world:
        _, _, _, lr, momentum, wd = build(args, dev, data=False)
        return fixed_world(args, dev, lr, momentum, wd)
    model, x, y, lr, momentum, wd = build(args, dev)
    if not args.scheduler_port or not args.host:
        ap.error("--scheduler-port and --host (or --world) are needed")

    from dt_tpu_torch.elastic.client import WorkerClient
    from dt_tpu_torch.parallel import kvstore as kvstore_lib
    wait_file = os.environ.get("DT_WAIT_FILE")
    if wait_file:
        while not os.path.exists(wait_file):
            time.sleep(0.05)
    t_built = time.time() * 1e3
    keep_drained()
    ctrl = WorkerClient("127.0.0.1", args.scheduler_port, host=args.host,
                        heartbeat_interval_s=args.heartbeat)
    kv = kvstore_lib.create("tpu_sync")
    kv.set_controller(ctrl)

    live = {}

    def factory(num_parts, part_index, batch_size, weights=None):
        live["batch"] = batch_size
        it = io.NDArrayIter(x, y, batch_size=batch_size, shuffle=True,
                            num_parts=num_parts, part_index=part_index,
                            seed=99, part_weights=weights)
        return io.ResizeIter(
            it, size=args.epoch_steps or len(x) // args.global_batch), None

    eit = io.ElasticDataIterator(factory, args.global_batch)
    train, _ = eit.get_data_iterator(kv)
    mm = MeshManager(args.coordinator, device=dev)
    mod = Module(model, optimizer="sgd",
                 optimizer_params={"learning_rate": lr, "momentum": momentum,
                                   "weight_decay": wd},
                 kvstore=kv, seed=7, device=dev, mesh_manager=mm,
                 shard_opt_state=args.zero, shard_params=args.fsdp)
    bootstrap = None
    if os.environ.get("NEW_WORKER") == "1":
        mod.init_params(initialize_from_kvstore=True)
        bootstrap = {"step": int(mod.state.step),
                     "sha256": blob_digest(snapshot_state(mod.state))}
    epochs = []
    marks = {"t": time.monotonic(), "launch": launch_counts(),
             "step": int(mod.state.step) if mod.state is not None else 0}

    def record(epoch, state, metric):
        if dev.type == "cuda":
            torch.cuda.synchronize()
        now, counts = time.monotonic(), launch_counts()
        now_counts = counts
        blob = snapshot_state(state)  # a collective under ZeRO/FSDP
        epochs.append({
            "epoch": epoch, "step": int(state.step),
            "steps": int(state.step) - marks["step"],
            "sha256": blob_digest(blob),
            "params_stats_sha256": blob_digest(
                blob, ("params", "batch_stats")),
            "loss": dict(metric.get_name_value()).get("cross-entropy"),
            "num_workers": kv.num_workers, "rank": kv.rank,
            "batch": live["batch"], "backend": mm.backend,
            "backend_reason": mm.backend_reason,
            "mesh_rebuilds": mod.mesh_rebuilds, "resharded": mod.resharded,
            "sharding_report": mod.sharding_report,
            "memory_allocated": torch.cuda.memory_allocated(dev)
            if dev.type == "cuda" else None,
            "seconds": now - marks["t"],
            "launches": {k: counts[k] - marks["launch"][k] for k in counts}})
        if args.val_images:  # this rank's part, outside the epoch's window
            xv, yv = make_images(args.val_images, args.image_size,
                                 1000 if args.model == "resnet50" else 10,
                                 seed=8765)
            acc = dict(mod.score(io.NDArrayIter(
                xv, yv, batch_size=32, num_parts=kv.num_workers,
                part_index=kv.rank), "acc"))
            if dev.type == "cuda":
                torch.cuda.synchronize()
            counts = launch_counts()
            epochs[-1]["val_acc"] = float(acc["accuracy"])
            epochs[-1]["score_launches"] = {
                k: counts[k] - now_counts[k] for k in counts}
        marks.update(t=time.monotonic(), launch=launch_counts(),
                     step=int(state.step))

    mod.fit(train, num_epoch=args.num_epoch, elastic_data_iterator=eit,
            eval_metric="ce", epoch_end_callback=record)
    result = {"host": args.host, "model": args.model, "device": str(dev),
              "final_step": int(mod.state.step), "bootstrap": bootstrap,
              "mesh_rebuilds": mod.mesh_rebuilds,
              "resharded": mod.resharded, "epochs": epochs, "pair": None,
              "spans": span_summary() if obs_trace.enabled() else None,
              "start_ms": {"main": t_main, "built": t_built}}
    if args.modes and mm.mesh is not None:
        # the job's last world (the survivors) runs the fixed-world modes,
        # the job's state freed first so the bytes held are theirs alone
        del mod, model
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        result["pair"] = fixed_world(args, dev, lr, momentum, wd,
                                     mesh=mm.mesh, rank=kv.rank)
    with open(args.out, "w") as f:
        json.dump(result, f)
    mm.teardown()
    ctrl.close()


if __name__ == "__main__":
    main()
