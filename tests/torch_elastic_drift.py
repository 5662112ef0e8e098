"""Hold every step of an elastic job of the PyTorch port on the card against
the port on the CPU, and show where a card job and a CPU job part.

Recording: ``python tests/torch_elastic_drift.py worker --dump X.npz
[--layers N] -- <tests/torch_elastic_worker.py args>`` is one worker
that records, for each step, its start state (flat params, momentum, BN
stats), its batch, its own loss, gradient and post-forward BN stats, the
ReLU mask of every fused BatchNorm-ReLU output, and the gradient and
stats it applies (the fleet's average with two workers); with
``--layers N`` also each training BatchNorm call's input and output over
the first N steps.

:func:`replay` takes the recordings of one job's workers and, on the CPU,
runs each step again from the recorded start state and batch: the loss,
the post-forward stats and, where every ReLU mask came out the same, the
gradient must agree with the card's within a tolerance; the applied
gradient and stats must be the workers' f32 average bit for bit (the
host-sync path adds nothing); the applied update must give the next
step's recorded params and momentum.  A ReLU mask that differs (an
activation within rounding of zero) moves that worker's gradient by a
whole activation's share; such a step is reported with its count of
flipped outputs and its gradient is not compared.

Diagnosis: ``python tests/torch_elastic_drift.py [--out drift.json]``
runs the f32 ``resnet20`` jobs of :data:`JOBS` against the port's
``Scheduler`` once on ``cuda:0`` (cuDNN deterministic, TF32 off) and once
on the CPU, and prints per step the card's relative error against the CPU
job, whether each side applied exactly its workers' average, the tensors
whose gradients part most at the first step, per BatchNorm call over the
first two steps each side's error against a float64 BatchNorm of its own
input and the outputs whose ReLU mask differs between the two jobs, the
card job's replay, and the per-epoch train loss.

Imports neither JAX nor the JAX package.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

#: the steps whose BatchNorm inputs and outputs the diagnosis records
LAYER_STEPS = 2
#: (tag, workers, images, global batch, image side) of the diagnosis; each
#: job 2 epochs of 2 steps
JOBS = (("1w_b64_8", 1, 128, 64, 8), ("1w_b32_8", 1, 64, 32, 8),
        ("2w_b32_8", 2, 128, 64, 8), ("2w_b32_32", 2, 128, 64, 32))
#: SGD of every job here: lr, momentum, weight decay
SGD = (0.1, 0.9, 0.0)
#: card step against its CPU replay, relative to the largest |value|
TOL_REPLAY = 1e-4


def job_args(size, images, global_batch, num_epoch=2):
    """``tests/torch_elastic_worker.py`` arguments of an f32 ``resnet20``
    job with :data:`SGD`."""
    return ["--model", "resnet20", "--dtype", "float32", "--image-size",
            str(size), "--images", str(images), "--global-batch",
            str(global_batch), "--lr", str(SGD[0]), "--wd", str(SGD[2]),
            "--num-epoch", str(num_epoch)]


def _fused_bns(model):
    from dt_tpu_torch.models.common import FusedBatchNorm
    return [m for m in model.modules() if isinstance(m, FusedBatchNorm)]


def worker(dump, argv, layer_steps=0):
    """Run ``torch_elastic_worker.main`` with ``argv``, recording what the
    module docstring lists into ``dump`` (device clones, so nothing waits
    on the card)."""
    import torch

    sys.path.insert(0, HERE)
    import torch_elastic_worker
    from dt_tpu_torch.training.flat import FlatLayout
    from dt_tpu_torch.training.module import Module

    keys = ("p", "m", "st", "x", "y", "g", "s", "loss", "mask", "ag", "as")
    rec = {k: [] for k in keys}
    layers = []  # (step, x, y, scale, bias, relu) of training BN calls
    live = {"on": False, "masks": [], "hooked": False}
    grads, apply = Module._grads, Module._apply_synced

    def hook(bn, args, out):
        if not live["on"]:
            return
        if bn.relu:
            live["masks"].append((out > 0).flatten())
        if len(rec["g"]) < layer_steps:
            layers.append((len(rec["g"]),) + tuple(
                t.detach().float().clone() for t in (args[0], out, bn.scale,
                                                     bn.bias)) + (bn.relu,))

    def _grads(self, data, labels):
        st = self.state
        if not live["hooked"]:
            for bn in _fused_bns(st.module):
                bn.register_forward_hook(hook)
            live["hooked"] = True
        lay = st.layout
        rec["p"].append(lay.params.ravel(st.params).clone())
        rec["m"].append(lay.params.ravel(st.opt_state["mom"]).clone())
        rec["st"].append(lay.stats.ravel(st.batch_stats).clone())
        rec["x"].append(data.float().clone())
        rec["y"].append(labels.clone())
        live.update(on=True, masks=[])
        out = grads(self, data, labels)
        live["on"] = False
        rec["mask"].append(torch.cat(live["masks"]))
        rec["g"].append(out[0].clone())
        rec["s"].append(out[1].clone())
        rec["loss"].append(out[2].clone())
        return out

    def _apply(self, flat_g, flat_s, loss, stats0):
        rec["ag"].append(flat_g.clone())
        rec["as"].append(flat_s.clone())
        return apply(self, flat_g, flat_s, loss, stats0)

    Module._grads, Module._apply_synced = _grads, _apply
    sys.argv = [torch_elastic_worker.__file__] + argv
    torch_elastic_worker.main()
    arrays = {}
    for k, ts in rec.items():
        for i, t in enumerate(ts):
            a = t.cpu().numpy() if k in ("y", "mask") else \
                t.float().cpu().numpy()
            arrays[f"{k}{i}"] = np.packbits(a) if k == "mask" else a
    for i, (k, x, y, scale, bias, relu) in enumerate(layers):
        for key, t in (("x", x), ("y", y), ("scale", scale),
                       ("bias", bias)):
            arrays[f"bn{k}_{i}_{key}"] = t.cpu().numpy()
        arrays[f"bn{k}_{i}_relu"] = np.asarray(relu)
    lay = FlatLayout(torch_elastic_worker.models.create(
        "resnet20", device="cpu", num_classes=10)).params
    arrays["names"] = np.array(lay.names)
    arrays["sizes"] = np.array(lay.sizes)
    np.savez(dump, steps=len(rec["g"]), **arrays)


def _rel(a, b):
    """max |a - b| over max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def replay(dumps, tol=TOL_REPLAY):
    """Each recorded step of one job (``{host: arrays}``) again on the CPU,
    as the module docstring says.  Returns ``(rows, failures)``: one row
    per worker and step, and a message per broken gate."""
    import torch

    from dt_tpu_torch import models
    from dt_tpu_torch.training.module import Module
    from dt_tpu_torch.training.step import apply_step, grad_step
    lr, momentum, wd = SGD
    mod = Module(models.create("resnet20", device="cpu", num_classes=10),
                 optimizer="sgd", optimizer_params={
                     "learning_rate": lr, "momentum": momentum,
                     "weight_decay": wd}, device="cpu", seed=7)
    mod.init_params()
    st = mod.state
    lay = st.layout
    masks = []
    hooks = [bn.register_forward_hook(
        lambda bn, args, out: masks.append((out > 0).flatten())
        if bn.relu else None) for bn in _fused_bns(st.module)]

    def put(tree, flat, leaves):
        with torch.no_grad():
            for name, t in leaves.unravel(torch.from_numpy(flat)).items():
                tree[name].copy_(t)

    hosts = sorted(dumps)
    steps = int(dumps[hosts[0]]["steps"])
    rows, failures = [], []
    try:
        for k in range(steps):
            own = [dumps[h][f"g{k}"] for h in hosts]
            stats = [dumps[h][f"s{k}"] for h in hosts]
            mean_g = own[0] if len(own) == 1 else \
                np.add(own[0], own[1], dtype=np.float32)
            mean_s = stats[0] if len(stats) == 1 else \
                np.add(stats[0], stats[1], dtype=np.float32)
            for a in own[2:]:
                mean_g = mean_g + a
            for a in stats[2:]:
                mean_s = mean_s + a
            mean_g = (mean_g / np.float32(len(own))).astype(np.float32)
            mean_s = (mean_s / np.float32(len(stats))).astype(np.float32)
            for h in hosts:
                d = dumps[h]
                put(st.params, d[f"p{k}"], lay.params)
                put(st.opt_state["mom"], d[f"m{k}"], lay.params)
                put(st.batch_stats, d[f"st{k}"], lay.stats)
                x = torch.from_numpy(d[f"x{k}"]).contiguous(
                    memory_format=torch.channels_last)
                masks.clear()
                g, s, loss, _ = grad_step(st, x, torch.from_numpy(d[f"y{k}"]),
                                          mod._forward_loss)
                mask = np.packbits(torch.cat(masks).numpy())
                flips = int(np.unpackbits(mask ^ d[f"mask{k}"]).sum())
                row = {"host": h, "step": k + 1, "relu_flips": flips,
                       "cpu_loss": float(loss),
                       "loss": _rel(d[f"loss{k}"], loss.numpy()),
                       "stats": _rel(d[f"s{k}"], s.numpy()),
                       "grad": _rel(d[f"g{k}"], g.numpy()),
                       "applied_is_mean": bool(
                           np.array_equal(d[f"ag{k}"], mean_g) and
                           np.array_equal(d[f"as{k}"], mean_s))}
                apply_step(st, torch.from_numpy(d[f"ag{k}"]),
                           torch.from_numpy(d[f"as{k}"]))
                if k + 1 < steps:
                    row["params_next"] = _rel(
                        d[f"p{k + 1}"], lay.params.ravel(st.params).numpy())
                    row["momentum_next"] = _rel(
                        d[f"m{k + 1}"],
                        lay.params.ravel(st.opt_state["mom"]).numpy())
                rows.append(row)
                gated = ["loss", "stats", "params_next", "momentum_next"] + \
                    (["grad"] if flips == 0 else [])
                bad = [c for c in gated if c in row and not row[c] <= tol]
                if bad or not row["applied_is_mean"]:
                    failures.append(f"step {k + 1} {h}: {bad} over {tol}, "
                                    f"applied is mean "
                                    f"{row['applied_is_mean']}: {row}")
    finally:
        for hk in hooks:
            hk.remove()
    return rows, failures


def hold_card_job(card, cpu, tol=TOL_REPLAY):
    """One job on the card (``card``: ``{host: (result, arrays)}``, the
    workers recording) against the port on the CPU: :func:`replay`, then
    each worker's per-epoch train loss as the job reports it against the
    mean of the replay's losses over that epoch's steps, and against the
    same job run on the CPU (``cpu``: ``{host: (result, _)}``) over the
    epochs that end no later than the first step with a flipped ReLU mask
    (from there the two runs took different branches).  Returns
    ``(summary, failures)``."""
    rows, failures = replay({h: a for h, (_, a) in card.items()}, tol)
    flipped = sorted({r["step"] for r in rows if r["relu_flips"]})
    first = flipped[0] if flipped else None
    summary = {"flipped_steps": flipped, "epochs": []}
    for h, (res, _) in sorted(card.items()):
        done = 0
        for e, c in zip(res["epochs"], cpu[h][0]["epochs"]):
            steps = range(done + 1, done + e["steps"] + 1)
            done += e["steps"]
            replayed = np.mean([r["cpu_loss"] for r in rows
                                if r["host"] == h and r["step"] in steps])
            vs_replay = abs(e["loss"] - replayed) / abs(replayed)
            vs_cpu_job = abs(e["loss"] - c["loss"]) / abs(c["loss"])
            held = first is None or done <= first
            summary["epochs"].append({
                "host": h, "epoch": e["epoch"], "card": e["loss"],
                "cpu_replay": float(replayed), "cpu_job": c["loss"],
                "vs_replay": vs_replay, "vs_cpu_job": vs_cpu_job,
                "cpu_job_held": held})
            if not vs_replay <= tol or (held and not vs_cpu_job <= tol):
                failures.append(f"epoch {e['epoch']} {h}: loss card "
                                f"{e['loss']} replay {replayed} cpu job "
                                f"{c['loss']} (held {held}) over {tol}")
    summary["replay_worst"] = {
        k: max((r[k] for r in rows if k in r and (
            k != "grad" or not r["relu_flips"])), default=0.0)
        for k in ("loss", "stats", "grad", "params_next", "momentum_next")}
    summary["applied_is_mean"] = all(r["applied_is_mean"] for r in rows)
    return summary, failures


def spawn(port, host, stem, args, env=None, dump=False, layer_steps=0):
    """One worker against the scheduler at ``port``, output to
    ``stem.log``, result to ``stem.json``; a recording worker (``stem.npz``)
    with ``dump``."""
    cmd = [sys.executable, os.path.join(HERE, "torch_elastic_worker.py")]
    if dump:
        cmd = [sys.executable, __file__, "worker", "--dump", stem + ".npz",
               "--layers", str(layer_steps), "--"]
    return subprocess.Popen(
        cmd + ["--scheduler-port", str(port), "--host", host, "--out",
               stem + ".json"] + list(args),
        env=dict(os.environ, ELASTIC_TRAINING_ENABLED="1", **(env or {})),
        stdout=open(stem + ".log", "w"), stderr=subprocess.STDOUT)


def wait_all(procs, stems, deadline):
    """Wait for every process by ``deadline`` (monotonic); kill the rest in
    any case; raise with the log's tail for one that failed."""
    try:
        for key, p in procs.items():
            rc = p.wait(timeout=max(deadline - time.monotonic(), 1))
            if rc != 0:
                raise AssertionError(f"{key} rc={rc}:\n"
                                     f"{open(stems[key] + '.log').read()[-3000:]}")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


def load(stem, dump=False):
    """``(result, arrays)`` of a worker: its JSON and, with ``dump``, its
    recording."""
    with open(stem + ".json") as f:
        res = json.load(f)
    if not dump:
        return res, None
    with np.load(stem + ".npz") as z:
        return res, {k: z[k] for k in z.files}


def run_jobs(tmp, timeout):
    """Every job of :data:`JOBS` on the card and on the CPU, all at once,
    every worker recording; returns ``{(tag, side): {host: (result,
    arrays)}}``."""
    from dt_tpu_torch.elastic.scheduler import Scheduler
    scheds, procs, stems = {}, {}, {}
    try:
        for tag, n, images, gb, size in JOBS:
            for side in ("card", "cpu"):
                hosts = [f"w{i}" for i in range(n)]
                sc = scheds[tag, side] = Scheduler(initial_workers=hosts)
                for h in hosts:
                    stem = stems[tag, side, h] = os.path.join(
                        tmp, f"{tag}_{side}_{h}")
                    dev = ["--device", "cpu"] if side == "cpu" else \
                        ["--deterministic"]
                    procs[tag, side, h] = spawn(
                        sc.port, h, stem, job_args(size, images, gb) + dev,
                        dump=True, layer_steps=LAYER_STEPS)
        wait_all(procs, stems, time.monotonic() + timeout)
    finally:
        for sc in scheds.values():
            sc.close()
    out = {}
    for (tag, side, h), stem in stems.items():
        out.setdefault((tag, side), {})[h] = load(stem, dump=True)
    return out


def bn_report(dc, dp, k):
    """Step ``k``'s training BatchNorm calls of one worker, card (``dc``)
    against CPU (``dp``): per call the input's relative error, each side's
    output error against a float64 BatchNorm of its own input, and the
    outputs whose ReLU mask differs between the sides."""
    out = []
    ids = sorted(int(key.split("_")[1]) for key in dc
                 if key.startswith(f"bn{k}_") and key.endswith("_x"))
    for i in ids:
        pre = f"bn{k}_{i}_"
        row = {"call": i, "shape": list(dc[pre + "x"].shape),
               "x": _rel(dc[pre + "x"], dp[pre + "x"])}
        for side, d in (("card", dc), ("cpu", dp)):
            x = d[pre + "x"].astype(np.float64)
            mean = x.mean(axis=(0, 2, 3), keepdims=True)
            var = x.var(axis=(0, 2, 3), keepdims=True)
            sh = (1, -1, 1, 1)
            y = (x - mean) / np.sqrt(var + 1e-5) * \
                d[pre + "scale"].reshape(sh) + d[pre + "bias"].reshape(sh)
            if bool(d[pre + "relu"]):
                y = np.maximum(y, 0)
            row[f"{side}_vs_f64"] = _rel(d[pre + "y"], y)
            row["mean2_over_var"] = float((mean ** 2 / var).max())
        row["relu_flips"] = int(((dc[pre + "y"] > 0) !=
                                 (dp[pre + "y"] > 0)).sum()) \
            if bool(dc[pre + "relu"]) else 0
        out.append(row)
    return out


def compare(runs):
    """Per job of :data:`JOBS`: the card job against the CPU job step by
    step, the BatchNorm report of the first steps, the card job's replay
    and the per-epoch loss (see the module docstring)."""
    report = {}
    for tag, n, _, _, _ in JOBS:
        card, cpu = runs[tag, "card"], runs[tag, "cpu"]
        hosts = sorted(card)
        steps = int(card[hosts[0]][1]["steps"])
        rows = []
        for k in range(steps):
            row = {"step": k + 1}
            for h in hosts:
                dc, dp = card[h][1], cpu[h][1]
                row[h] = {x: _rel(dc[f"{x}{k}"], dp[f"{x}{k}"])
                          for x in ("p", "g", "s", "loss", "ag", "as")}
            for side, r in (("card", card), ("cpu", cpu)):
                d = [r[h][1] for h in hosts]
                own = sum(x[f"g{k}"] for x in d) / np.float32(len(d)) \
                    if n > 1 else d[0][f"g{k}"]
                row[f"{side}_applied_is_mean"] = all(
                    np.array_equal(x[f"ag{k}"], own) for x in d)
            rows.append(row)
        bn = {}
        for k in range(LAYER_STEPS):
            for h in hosts:
                calls = bn_report(card[h][1], cpu[h][1], k)
                bn[f"step{k + 1}_{h}"] = {
                    "relu_flips": sum(c["relu_flips"] for c in calls),
                    "worst_card_vs_f64": max(c["card_vs_f64"] for c in calls),
                    "worst_cpu_vs_f64": max(c["cpu_vs_f64"] for c in calls),
                    "calls_with_flips": [c for c in calls if c["relu_flips"]]}
        # the first step starts from the same params: where do grads part?
        d0c, d0p = card[hosts[0]][1], cpu[hosts[0]][1]
        per, o = [], 0
        for name, size in zip(d0c["names"], d0c["sizes"]):
            per.append((_rel(d0c["g0"][o:o + size], d0p["g0"][o:o + size]),
                        str(name)))
            o += int(size)
        per.sort(reverse=True)
        loss = {h: {"card": [e["loss"] for e in card[h][0]["epochs"]],
                    "cpu": [e["loss"] for e in cpu[h][0]["epochs"]]}
                for h in hosts}
        loss_rel = max(abs(a - b) / abs(b) for h in hosts for a, b in zip(
            loss[h]["card"], loss[h]["cpu"]))
        replayed, failures = replay({h: card[h][1] for h in hosts})
        report[tag] = {"steps": rows, "first_step_worst_grads": per[:5],
                       "bn": bn, "replay": replayed,
                       "replay_failures": failures, "epoch_loss": loss,
                       "epoch_loss_max_rel": loss_rel}
    return report


def main():
    argv = sys.argv[1:]
    if argv[:2] == ["worker", "--dump"] and "--" in argv:
        cut = argv.index("--")
        opts = argv[3:cut]
        layer_steps = int(opts[1]) if opts[:1] == ["--layers"] else 0
        worker(argv[2], argv[cut + 1:], layer_steps)
        return 0
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="also write the report here")
    ap.add_argument("--timeout", type=float, default=300.0)
    a = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("torch_elastic_drift: no CUDA device", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory(prefix="dt_drift_") as tmp:
        report = compare(run_jobs(tmp, a.timeout))
    for tag, r in report.items():
        print(f"== {tag}: epoch loss max rel {r['epoch_loss_max_rel']:.3e} "
              f"{json.dumps(r['epoch_loss'])}")
        for row in r["steps"]:
            print("  " + json.dumps(row))
        print(f"  first step, worst grads (rel, tensor): "
              f"{r['first_step_worst_grads']}")
        for key, b in r["bn"].items():
            print(f"  bn {key}: " + json.dumps(b))
        for row in r["replay"]:
            print("  replay " + json.dumps(row))
        print(f"  replay failures: {r['replay_failures']}")
    if a.out:
        with open(a.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
