"""One rank of a fixed world that drives the PyTorch port's parallel layer
(``dt_tpu_torch.parallel``: ring and Ulysses attention, MoE expert
parallelism, the GPipe pipeline, and the models and ``Module`` over a
two-axis mesh)::

    python tests/torch_parallel_worker.py --world 4 --rank R \\
        --coordinator 127.0.0.1:C --case CASE --npz in.npz --out o{rank}.npz \\
        [--device cpu|cuda]

joins a gloo process group of ``--world`` ranks (a TCP store at
``--coordinator``, served by rank 0), runs ``CASE`` on the inputs of
``--npz`` and writes what it computed to ``--out`` (``{rank}`` filled in).
Cases (every input the same on all ranks; the shapes are the npz's):

- ``ring`` / ``ulysses``: the attention over a 1 x world ``model`` axis,
  causal and not: the global output and ``q``/``k``/``v`` gradients of
  ``sum(out * g)``; then ``fit`` of a ``TransformerLM`` with that
  attention and ``remat=True`` over a 2 x (world / 2) ``data`` x ``model``
  mesh (``Module``, sgd, ``grad_accum`` 1) from the npz's JAX variables,
  this data rank's rows of each batch: the params after it;
- ``moe``: ``MoEMLP`` with its experts over a 1 x world ``model`` axis:
  output, pre-weighted aux, and the gradients of ``sum(out * g) + aux``
  (the input's and router's whole, the rank's ``wi``/``wo`` rows);
- ``pipe``: ``pipeline_apply`` of ``tanh(h w + b)`` stages over a world x 1
  ``pipe`` axis (output and the stacked params' gradient of
  ``sum(out^2)``), then the ``PipelinedTransformerLM`` over a 2 x (world /
  2) ``data`` x ``pipe`` mesh: its logits of this data rank's rows, and
  its params (``outer`` and this rank's stage) after ``fit``;
- ``card``: phase 21 of ``chip_smoke.py`` (:func:`card_case`), a JSON
  object a rank.

It imports neither JAX nor the JAX package.  :func:`run_world` starts a
world from a test and waits for it with a time limit.
"""

import argparse
import datetime
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))

#: the LM cases' SGD, the JAX tests' (``test_pipeline_transformer.py:79``)
SGD = {"learning_rate": 0.1, "momentum": 0.9}


def unflat(flat: dict, prefix: str) -> dict:
    """The nested dict of the ``prefix/``-keyed arrays of ``flat``."""
    out = {}
    for key, v in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node = out
        *parents, leaf = key[len(prefix) + 1:].split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def flat(tree: dict, prefix: str) -> dict:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(flat(v, key))
        else:
            out[key] = np.asarray(v.float() if isinstance(v, torch.Tensor)
                                  else v)
    return out


def lm_loss(logits, labels):
    """The JAX tests' LM loss: the mean negative log-likelihood of
    ``labels`` over every position (``test_pipeline_transformer.py:71``)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[..., None]).mean()


def shifted_loss(logits, labels):
    """``softmax_cross_entropy(logits[:, :-1], labels[:, 1:])``, the
    long-context test's loss (``test_transformer_ulysses.py:160``)."""
    from dt_tpu_torch.ops.losses import softmax_cross_entropy
    v = logits.shape[-1]
    return softmax_cross_entropy(logits[:, :-1].reshape(-1, v),
                                 labels[:, 1:].reshape(-1))


def _tensor(a, dev, grad=False):
    return torch.from_numpy(np.array(a)).to(dev).requires_grad_(grad)


def _fit(model, mesh, d, dev, loss_fn, batch):
    """``Module.fit`` of ``model`` on this data rank's rows of every batch
    of ``d["x"]``/``d["y"]``; returns the exported params."""
    from dt_tpu_torch.data import io
    from dt_tpu_torch.interchange import export_jax_variables
    from dt_tpu_torch.training.module import Module
    x, y = d["x"], d["y"]
    per = batch // mesh.data
    idx = np.concatenate([np.arange(s + mesh.rank * per,
                                    s + (mesh.rank + 1) * per)
                          for s in range(0, len(x), batch)])
    mod = Module(model, loss_fn=loss_fn, optimizer="sgd",
                 optimizer_params=SGD, device=dev, mesh=mesh, seed=5)
    mod.init_params()
    from dt_tpu_torch.interchange import load_jax_variables
    load_jax_variables(model, {"params": unflat(d, "init")})
    mod.fit(io.NDArrayIter(x[idx], y[idx], batch_size=per), num_epoch=1,
            eval_metric="ce")
    return export_jax_variables(model)["params"]


def attention_case(kind, d, dev, world):
    from dt_tpu_torch import models
    from dt_tpu_torch.parallel.mesh import make_mesh
    from dt_tpu_torch.parallel.ring_attention import ring_attention
    from dt_tpu_torch.parallel.ulysses import ulysses_attention
    fn = ring_attention if kind == "ring" else ulysses_attention
    mesh = make_mesh(data=1, model=world, devices=[dev])
    out = {}
    for causal in (False, True):
        q, k, v = (_tensor(d[n], dev, True) for n in ("q", "k", "v"))
        o = fn(q, k, v, mesh, axis_name="model", causal=causal)
        (o * _tensor(d["g"], dev)).sum().backward()
        tag = "causal" if causal else "full"
        out.update({f"{tag}/out": o.detach(), f"{tag}/dq": q.grad,
                    f"{tag}/dk": k.grad, f"{tag}/dv": v.grad})
    mesh2 = make_mesh(data=2, model=world // 2, devices=[dev])
    cfg = {k[4:]: int(d[k]) for k in d if k.startswith("cfg/")}
    lm = models.create("transformer_lm", device=dev, seq_parallel=kind,
                       mesh=mesh2, axis_name="model", remat=True, **cfg)
    out.update(flat(_fit(lm, mesh2, d, dev, shifted_loss,
                         int(d["batch"])), "params"))
    return out


def moe_case(d, dev, world):
    from dt_tpu_torch.interchange import load_jax_variables
    from dt_tpu_torch.parallel.mesh import make_mesh
    from dt_tpu_torch.parallel.moe import MoEMLP
    mesh = make_mesh(data=1, model=world, devices=[dev])
    x = _tensor(d["x"], dev, True)
    layer = MoEMLP(x.shape[-1], int(d["experts"]), int(d["ratio"]),
                   float(d["capacity_factor"]), mesh=mesh,
                   axis="model").to(dev)
    load_jax_variables(layer, {"params": unflat(d, "init")})
    o = layer(x)
    ((o * _tensor(d["g"], dev)).sum() + layer.aux_loss).backward()
    return {"out": o.detach(), "aux": layer.aux_loss.detach(),
            "dx": x.grad, "drouter": layer.router.weight.grad.t(),
            "dwi": layer.wi.grad, "dwo": layer.wo.grad}


def pipe_case(d, dev, world):
    from dt_tpu_torch import models
    from dt_tpu_torch.parallel.mesh import make_mesh
    from dt_tpu_torch.parallel.pipeline import pipeline_apply
    mesh = make_mesh(data=world, model=1, axis_names=("pipe", "model"),
                     devices=[dev])
    params = {"w": _tensor(d["w"], dev, True), "b": _tensor(d["b"], dev,
                                                           True)}

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    got = pipeline_apply(stage_fn, params, _tensor(d["x_toy"], dev), mesh,
                         axis_name="pipe")
    (got ** 2).sum().backward()
    out = {"toy/out": got.detach(), "toy/dw": params["w"].grad,
           "toy/db": params["b"].grad}
    mesh2 = make_mesh(data=2, model=world // 2, axis_names=("data", "pipe"),
                      devices=[dev])
    cfg = {k[4:]: int(d[k]) for k in d if k.startswith("cfg/")}
    lm = models.create("transformer_lm_pipelined", device=dev, mesh=mesh2,
                       batch_axis="data", **cfg)
    from dt_tpu_torch.interchange import load_jax_variables
    load_jax_variables(lm, {"params": unflat(d, "init")})
    toks = d["toks"]
    per = len(toks) // 2
    with torch.no_grad():
        out["logits"] = lm(torch.from_numpy(
            toks[mesh2.rank * per:(mesh2.rank + 1) * per]).to(dev))
    out.update(flat(_fit(lm, mesh2, d, dev, lm_loss, int(d["batch"])),
                    "params"))
    return out


def _timed(mod, toks, steps: int) -> dict:
    """``steps`` more steps of ``mod`` on ``toks``, each synchronized and
    timed; the median ms and the bytes the collectives moved a step."""
    from dt_tpu_torch.parallel import collectives as coll
    data = mod._place(toks)
    labels = mod._place(toks, label=True)
    sent = (coll.exchange.bytes_sent, coll.all_to_all.bytes_sent)
    ms = []
    sync = torch.cuda.synchronize if data.is_cuda else (lambda: None)
    for _ in range(steps):
        sync()
        t0 = time.perf_counter()
        mod._step(data, labels)
        sync()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"step_ms": ms, "median_ms": float(np.median(ms)),
            "p2p_bytes_a_step": (coll.exchange.bytes_sent - sent[0]) // steps,
            "a2a_bytes_a_step":
                (coll.all_to_all.bytes_sent - sent[1]) // steps}


def _fit_steps(model, mesh, toks, dev, steps: int) -> dict:
    """``Module.fit`` of the bf16 ``model`` over ``mesh``, ``steps`` steps
    on the one batch ``toks`` (next-token loss, the LM's sgd): the losses,
    then :func:`_timed` over as many more."""
    from dt_tpu_torch.data import io
    from dt_tpu_torch.training.module import Module
    losses = []

    def loss_fn(logits, labels):
        loss = shifted_loss(logits, labels)
        losses.append(loss.detach())
        return loss

    mod = Module(model, loss_fn=loss_fn, optimizer="sgd",
                 optimizer_params=SGD, device=dev, mesh=mesh)
    mod.init_params()
    x = np.concatenate([toks] * steps)
    mod.fit(io.NDArrayIter(x, x, batch_size=len(toks)), num_epoch=1,
            eval_metric="ce")
    out = {"losses": [float(v) for v in losses]}
    out.update(_timed(mod, toks, steps))
    return out


def _rel_max(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def card_case(d, dev, world):
    """Phase 21 of ``chip_smoke.py`` on the card's ranks: (a) ring, then
    Ulysses, over a 1 x world ``model`` axis: an f32 forward's logits
    against one process's full attention (rank 0 computes it), then bf16
    ``fit`` steps, timed steps and the bytes they moved; (b) an f32 MoE
    layer with its 4 experts over the axis against the one-process layer;
    (d) the ``PipelinedTransformerLM`` (2 stages, 4 microbatches) over a 1
    x world ``pipe`` axis: f32 logits against the one-process sequential
    path, then bf16 ``fit`` steps and timed steps.  The kernel wrappers'
    launches over all of it (these paths launch none: plain attention)."""
    from dt_tpu_torch import models
    from dt_tpu_torch.interchange import load_jax_variables
    from dt_tpu_torch.ops import attention, kernels
    from dt_tpu_torch.parallel.mesh import make_mesh
    from dt_tpu_torch.parallel.moe import MoEMLP
    cfg = {k[4:]: int(d[k]) for k in d if k.startswith("cfg/")}
    steps = int(d["steps"])
    rank = dist.get_rank()
    mesh = make_mesh(data=1, model=world, devices=[dev])
    pmesh = make_mesh(data=1, model=world, axis_names=("data", "pipe"),
                      devices=[dev])
    toks = d["toks"]
    tokens = torch.from_numpy(toks).to(dev)
    lm_vars = {"params": unflat(d, "lm")}
    pipe_vars = {"params": unflat(d, "pipe")}
    counters = (attention.flash_fwd, kernels.bn_stats, kernels.bn_act)
    before = [w.launches for w in counters]
    res = {"rank": rank, "backend": dist.get_backend()}

    def f32_check(name, **kw):
        """The f32 logits of ``name`` over the mesh, and rank 0's error
        against the same model in one process (``kw`` without the mesh)."""
        model = load_jax_variables(models.create(name, device=dev, **kw),
                                   pipe_vars if "num_stages" in kw
                                   else lm_vars)
        with torch.no_grad():
            logits = model(tokens, training=False)
        del model
        if rank != 0:
            return None
        one = {k: v for k, v in kw.items()
               if k not in ("mesh", "seq_parallel", "axis_name",
                            "batch_axis")}
        ref_model = load_jax_variables(models.create(name, device=dev, **one),
                                       pipe_vars if "num_stages" in kw
                                       else lm_vars)
        with torch.no_grad():
            ref = ref_model(tokens, training=False)
        return _rel_max(logits, ref)

    for kind in ("ring", "ulysses"):
        t0 = time.perf_counter()
        part = {"f32_rel_err": f32_check(
            "transformer_lm", seq_parallel=kind, mesh=mesh,
            axis_name="model", **cfg)}
        model = load_jax_variables(models.create(
            "transformer_lm", device=dev, seq_parallel=kind, mesh=mesh,
            axis_name="model", dtype=torch.bfloat16, **cfg), lm_vars)
        part.update(_fit_steps(model, mesh, toks, dev, steps))
        del model
        torch.cuda.empty_cache()
        part["seconds"] = time.perf_counter() - t0
        res[kind] = part
    # (b) expert parallelism: one MoE layer of the LM's width
    t0 = time.perf_counter()
    rng = np.random.RandomState(int(d["moe_seed"]))
    e, dm = int(d["moe_experts"]), cfg["embed_dim"]
    w = {"router": {"kernel": rng.normal(0, dm ** -0.5, (dm, e))},
         "wi": rng.normal(0, dm ** -0.5, (e, dm, 4 * dm)),
         "wo": rng.normal(0, (4 * dm) ** -0.5, (e, 4 * dm, dm))}
    w = {"params": {k: ({"kernel": v["kernel"].astype(np.float32)}
                        if isinstance(v, dict) else v.astype(np.float32))
                    for k, v in w.items()}}
    x = torch.from_numpy(rng.normal(0, 1, toks.shape + (dm,)).astype(
        np.float32)).to(dev)
    ep = load_jax_variables(MoEMLP(dm, e, 4, mesh=mesh, axis="model").to(
        dev), w)
    with torch.no_grad():
        y = ep(x)
    res["ep"] = {"experts_here": int(ep.wi.shape[0])}
    if rank == 0:
        one = load_jax_variables(MoEMLP(dm, e, 4).to(dev), w)
        with torch.no_grad():
            res["ep"]["rel_err"] = _rel_max(y, one(x))
    del ep, x, y
    res["ep"]["seconds"] = time.perf_counter() - t0
    # (d) the pipeline
    t0 = time.perf_counter()
    pcfg = dict(cfg, num_stages=int(d["stages"]), num_micro=int(d["micro"]))
    part = {"f32_rel_err": f32_check("transformer_lm_pipelined", mesh=pmesh,
                                     **pcfg)}
    model = load_jax_variables(models.create(
        "transformer_lm_pipelined", device=dev, mesh=pmesh,
        dtype=torch.bfloat16, **pcfg), pipe_vars)
    part.update(_fit_steps(model, pmesh, toks, dev, steps))
    part["seconds"] = time.perf_counter() - t0
    res["pipe"] = part
    res["launches"] = {c.__name__: c.launches - b
                       for c, b in zip(counters, before)}
    if dev.type == "cuda":
        res["peak_mem_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--case", required=True,
                    choices=("ring", "ulysses", "moe", "pipe", "card"))
    ap.add_argument("--npz", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()
    dev = torch.device(args.device)
    torch.set_num_threads(1)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://{args.coordinator}",
                            rank=args.rank, world_size=args.world,
                            timeout=datetime.timedelta(seconds=60))
    with np.load(args.npz) as z:
        d = {k: z[k] for k in z.files}
    if args.case == "card":
        with open(args.out.format(rank=args.rank), "w") as f:
            json.dump(card_case(d, dev, args.world), f)
        dist.destroy_process_group()
        return
    if args.case in ("ring", "ulysses"):
        out = attention_case(args.case, d, dev, args.world)
    elif args.case == "moe":
        out = moe_case(d, dev, args.world)
    else:
        out = pipe_case(d, dev, args.world)
    np.savez(args.out.format(rank=args.rank),
             **{k: np.asarray(v.detach().float().cpu()
                              if isinstance(v, torch.Tensor) else v)
                for k, v in out.items()})
    dist.destroy_process_group()


def run_world(tmp, case: str, inputs: dict, world: int = 4,
              timeout: float = 90.0, device: str = "cpu") -> list:
    """Run ``case`` on ``world`` ranks on ``device`` from ``inputs``
    (arrays, saved to an npz under ``tmp``); returns each rank's outputs
    (the ``card`` case's JSON object).  A rank that fails or outlives
    ``timeout`` fails the call (every rank killed), with the logs'
    tails."""
    from torch_mesh_job import free_port
    npz = os.path.join(tmp, f"{case}_in.npz")
    np.savez(npz, **inputs)
    ext = "json" if case == "card" else "npz"
    out = os.path.join(tmp, case + "_out{rank}." + ext)
    coord = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs, logs = [], []
    for r in range(world):
        logs.append(os.path.join(tmp, f"{case}_rank{r}.log"))
        procs.append(subprocess.Popen(
            [sys.executable, os.path.join(HERE, "torch_parallel_worker.py"),
             "--world", str(world), "--rank", str(r), "--coordinator", coord,
             "--case", case, "--npz", npz, "--out", out,
             "--device", device],
            env=env, stdout=open(logs[-1], "w"), stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    try:
        for r, p in enumerate(procs):
            try:
                rc = p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"rank {r} did not finish in {timeout} s")
            if rc != 0:
                raise AssertionError(f"rank {r} exited {rc}")
    except AssertionError as e:
        tails = "\n".join(f"--- rank {r}:\n{open(f).read()[-3000:]}"
                          for r, f in enumerate(logs))
        raise AssertionError(f"{e}\n{tails}") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    results = []
    for r in range(world):
        if ext == "json":
            with open(out.format(rank=r)) as f:
                results.append(json.load(f))
            continue
        with np.load(out.format(rank=r)) as z:
            results.append({k: z[k] for k in z.files})
    return results


if __name__ == "__main__":
    main()
