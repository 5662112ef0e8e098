#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA.  It imports only the port (``dt_tpu_torch``), never
JAX.  Phases, each fatal on failure:

1. setup: the card's name and power limit, versions, the kernels' build
   (``nvcc``, one process per source, all started together);
2. kernels: every distinct BatchNorm shape of ResNet-50 v1 at 224x224,
   batch 32, plus ragged and misaligned cases, in float32 and bfloat16 with
   ReLU on and off: the CUDA kernel against its plain PyTorch version on the
   same inputs (max abs difference must be 0), and the times of the kernel,
   the plain version and ``F.batch_norm`` (a yardstick the port never calls)
   against the bytes bound;
3. serve: ResNet-50 v1 at full width (224x224x3, 1000 classes) from seeded
   weights carried in through ``load_jax_variables``, served through
   ``Predictor`` (buckets up to 64) in float32 and bfloat16: requests of 1,
   3, 32 and 130 rows, 53 kernel launches per chunk forward, float32 logits
   against the port on the CPU, bfloat16 against float32, and per-bucket
   latency and throughput.

The line before the last holds the card's name and power limit, the one
before it a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.  TF32 is off for every phase, timings
included.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12  # HBM3 rate of the H100 SXM data sheet
L2_BYTES = 2 * 50 * 2 ** 20  # twice the H100's 50 MB L2
BN_PER_FORWARD = 53  # ResNet-50 v1: stem + 16 bottlenecks x 3 + 4 shortcuts
BUCKET_MAX = 64
REQUESTS = (1, 3, 32, 130)  # 130 splits into 64 + 64 + 2
TOL_F32 = 1e-3  # card f32 (no TF32) against the CPU: summation order
TOL_BF16 = 1.5e-2  # of the largest |logit|: bf16 keeps 8 mantissa bits


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, inputs, iters: int = 20) -> float:
    """Device time of ``fn(inputs[i % len(inputs)])`` in ms: ``iters`` calls
    captured in one CUDA graph, replayed between two CUDA events, so the
    host's cost of a call (Python, checks, launch) is not in the time."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream
        for i in range(3):
            fn(inputs[i % len(inputs)])
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / iters


def host_us(fn, arg, iters: int = 200) -> float:
    """Host time of one call of ``fn(arg)`` in microseconds (what the
    caller's thread spends to enqueue it), synchronising only at the end."""
    import torch
    fn(arg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(arg)
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def seeded_variables(model, seed: int):
    """Weights for ``model`` in the JAX layout, from numpy with ``seed``:
    He-normal convs, LeCun-normal dense, BN stats away from their initial
    values (mean ~ N(0, 0.1), var ~ U(0.5, 2))."""
    from dt_tpu_torch.interchange import export_jax_variables
    rng = np.random.RandomState(seed)

    def fill(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v)
            elif k == "kernel":
                fan_in = int(np.prod(v.shape[:-1]))
                gain = 2.0 if v.ndim == 4 else 1.0
                out[k] = (rng.normal(0, 1, v.shape)
                          * np.sqrt(gain / fan_in)).astype(np.float32)
            elif k == "scale":
                out[k] = rng.uniform(0.2, 0.6, v.shape).astype(np.float32)
            elif k in ("bias", "mean"):
                out[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)
            elif k == "var":
                out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
            else:
                raise KeyError(f"unexpected leaf {k!r}")
        return out

    return fill(export_jax_variables(model))


def bn_shapes(model, x):
    """(N, C, H, W, relu) -> number of BatchNorm calls with that shape in
    one forward of ``model`` on ``x``."""
    import torch
    from dt_tpu_torch.models.common import FusedBatchNorm
    seen = {}

    def hook(mod, args):
        key = (*args[0].shape, mod.relu)
        seen[key] = seen.get(key, 0) + 1

    hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
             if isinstance(m, FusedBatchNorm)]
    with torch.inference_mode():
        model(x)
    for h in hooks:
        h.remove()
    return seen


def kernel_phase(shapes, dev):
    """Hold the kernel against its plain version at every shape, bit for
    bit, and time it.  Returns one summary per dtype, with times summed over
    the BatchNorm calls of one batch-32 forward."""
    import torch
    import torch.nn.functional as F
    from dt_tpu_torch.ops import kernels
    cases = {}
    for (n, c, h, w, _relu), count in shapes.items():
        for relu in (False, True):
            key = (n, c, h, w, relu)
            cases[key] = cases.get(key, 0) + (count if relu == _relu else 0)
    extra = [((37, 3), False), ((1001, 17), True), ((1001, 64), True),
             ((2, 3, 5, 7), True)]
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(0)
        tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "library_ms": 0.0, "max_abs_err": 0.0}
        runs = [(k[:4], k[4], m) for k, m in cases.items()] + \
            [(s, r, 0) for s, r in extra]
        for shape, relu, per_fwd in runs:
            # a 2-D view one element into its storage is not 16-byte
            # aligned: it takes the kernel's scalar path
            for offset in [False, True] if len(shape) == 2 else [False]:
                numel = int(np.prod(shape))
                flat = torch.randn(numel + 1, generator=g, device=dev,
                                   dtype=torch.float32).to(dtype)
                if len(shape) == 4:
                    n, c, h, w = shape
                    x = flat[:numel].view(n, h, w, c).permute(0, 3, 1, 2)
                else:
                    c = shape[1]
                    x = flat[1:] if offset else flat[:numel]
                    x = x.view(shape)
                gamma = torch.rand(c, generator=g, device=dev) + 0.5
                beta, mean = (torch.randn(c, generator=g, device=dev)
                              for _ in range(2))
                var = torch.rand(c, generator=g, device=dev) * 1.5 + 0.5
                scale, bias = kernels.bn_scale_bias(gamma, beta, mean, var,
                                                    1e-5, dtype)
                x2 = kernels.rows_view(x)
                got = kernels.rows_view(kernels.bn_act(x, scale, bias, relu))
                want = kernels.bn_act_plain(x2, scale, bias, relu)
                err = (got.float() - want.float()).abs().max().item()
                if not torch.equal(got, want):
                    raise AssertionError(
                        f"bn_act {tuple(shape)} {dtype} relu={relu} "
                        f"misaligned={offset}: max abs err {err} != 0")
                tot["max_abs_err"] = max(tot["max_abs_err"], err)
                nbytes = (2 * x2.numel() + 2 * c) * x.element_size()
                bound = nbytes / H100_BYTES_PER_S * 1e3
                # time on copies that together exceed the 50 MB L2, so each
                # call reads its input from device memory, as the bound
                # does (the tiny extra shapes stay in L2 regardless)
                xs = [x] + [x.clone()
                            for _ in range(min(L2_BYTES // nbytes, 63))]
                def kernel(a):
                    return kernels.bn_act(a, scale, bias, relu)

                def plain(a):
                    return kernels.bn_act_plain(kernels.rows_view(a), scale,
                                                bias, relu)

                def library(a):
                    y = F.batch_norm(a, mean, var, gamma, beta,
                                     training=False, eps=1e-5)
                    return torch.relu_(y) if relu else y

                k_ms = cuda_ms(kernel, xs)
                k_host = host_us(kernel, x)
                p_ms = cuda_ms(plain, xs)
                lib_ms = cuda_ms(library, xs) if len(shape) == 4 else None
                del xs
                print(f"kernel bn_act {dtype} shape={tuple(shape)} "
                      f"relu={relu} misaligned={offset} max_abs_err={err} "
                      f"kernel_ms={k_ms:.5f} kernel_host_us={k_host:.1f} "
                      f"plain_ms={p_ms:.5f} "
                      f"library_ms={lib_ms and round(lib_ms, 5)} "
                      f"bound_ms={bound:.5f} "
                      f"per_forward={per_fwd}", flush=True)
                if per_fwd:
                    tot["ms"] += per_fwd * k_ms
                    tot["plain_ms"] += per_fwd * p_ms
                    tot["bound_ms"] += per_fwd * bound
                    tot["library_ms"] += per_fwd * lib_ms
        summary[dtype] = tot
    return summary


def serve(name, dtype, variables, dev, images, gpu):
    """Serve ResNet-50 through the Predictor: the port's main path.  Returns
    (launches of the kernel, chunk forwards, logits of ``images[:4]``)."""
    import torch
    from dt_tpu_torch import models
    from dt_tpu_torch.interchange import load_jax_variables
    from dt_tpu_torch.ops import kernels
    from dt_tpu_torch.predictor import Predictor

    model = load_jax_variables(models.create(name, device=dev, dtype=dtype),
                               variables)
    pred = Predictor.from_fn(lambda m, _stats, x: m(x), model, dtype=dtype,
                             max_batch=BUCKET_MAX, device=dev)
    pred.warmup(images.shape[1:])
    torch.cuda.synchronize()
    kernels.bn_act.launches = 0  # the main path's run starts here
    chunks = 0
    first4 = None
    for n in REQUESTS:
        t0 = time.perf_counter()
        out = pred.predict(images[:n])
        ms = (time.perf_counter() - t0) * 1e3
        if out.shape != (n, 1000) or not np.isfinite(out).all():
            raise AssertionError(f"{dtype} request of {n}: bad output "
                                 f"{out.shape}")
        chunks += -(-n // BUCKET_MAX)
        if n >= 4 and first4 is None:
            first4 = out[:4]
        print(f"serve {dtype} request rows={n} ms={ms:.3f} gpu={gpu}",
              flush=True)
    launches = kernels.bn_act.launches  # ... and ends here
    for b in pred.batch_buckets:
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            pred.predict(images[:b])
        ms = (time.perf_counter() - t0) * 1e3 / reps
        print(f"serve {dtype} bucket={b} ms_per_request={ms:.3f} "
              f"img_per_s={b / ms * 1e3:.1f} gpu={gpu}", flush=True)
        if b in (1, BUCKET_MAX):
            profile_request(pred, images[:b], ms, f"{dtype} bucket={b}")
    return launches, chunks, first4


def profile_request(pred, x, wall_ms: float, tag: str) -> None:
    """Device time of one request by kernel, from ``torch.profiler``, and
    the device's idle share against the request's unprofiled host time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pred.predict(x)
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.self_cpu_time_total == 0]
    busy = sum(r[2] for r in rows)
    if busy == 0:
        print(f"profile {tag}: device time not measured (the profiler saw "
              "no device events)", flush=True)
        return
    print(f"profile {tag} wall_ms={wall_ms:.3f} device_busy_ms={busy:.3f} "
          f"device_idle_share={max(0.0, 1 - busy / wall_ms):.3f}", flush=True)
    for key, count, ms in sorted(rows, key=lambda r: -r[2])[:8]:
        print(f"profile {tag} device_ms={ms:.3f} share={ms / busy:.3f} "
              f"calls={count} {key[:90]}", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "dt_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no dt_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from dt_tpu_torch import models
    from dt_tpu_torch.interchange import load_jax_variables
    from dt_tpu_torch.ops import _build

    gpu = gpu_line()
    print(f"gpu: {gpu}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {json.dumps(built)} total_s={time.perf_counter() - t0:.2f}",
          flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("tf32: off (cudnn and matmul) for every phase", flush=True)
    dev = torch.device("cuda")

    # --- kernels --------------------------------------------------------
    model = models.create("resnet50", device=dev)
    variables = seeded_variables(model, seed=0)
    load_jax_variables(model, variables)
    x32 = torch.zeros(32, 224, 224, 3, device=dev).permute(0, 3, 1, 2)
    shapes = bn_shapes(model, x32)
    if sum(shapes.values()) != BN_PER_FORWARD:
        raise AssertionError(f"{sum(shapes.values())} BatchNorms in one "
                             f"forward, expected {BN_PER_FORWARD}")
    summary = kernel_phase(shapes, dev)
    del model, x32

    # --- serve ----------------------------------------------------------
    rng = np.random.RandomState(1)
    images = rng.uniform(-1, 1, (max(REQUESTS), 224, 224, 3)) \
        .astype(np.float32)
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        launches, chunks, logits = serve("resnet50", dtype, variables, dev,
                                         images, gpu)
        print(f"serve {dtype} launches={launches} chunk_forwards={chunks} "
              f"expected={BN_PER_FORWARD * chunks}", flush=True)
        if launches != BN_PER_FORWARD * chunks:
            raise AssertionError(f"{dtype}: {launches} kernel launches for "
                                 f"{chunks} chunk forwards")
        results[dtype] = (launches, logits)

    cpu = load_jax_variables(models.create("resnet50", device="cpu"),
                             variables)
    with torch.inference_mode():
        ref = cpu(torch.from_numpy(images[:4]).permute(0, 3, 1, 2)).numpy()
    f32 = results[torch.float32][1]
    err = float(np.abs(f32 - ref).max())
    print(f"check f32 card vs cpu: max_abs_err={err:.3e} "
          f"max_abs_logit={np.abs(ref).max():.3f} tol={TOL_F32}", flush=True)
    np.testing.assert_allclose(f32, ref, rtol=TOL_F32, atol=TOL_F32)
    bf16 = results[torch.bfloat16][1]
    tol = TOL_BF16 * float(np.abs(f32).max())
    err = float(np.abs(bf16 - f32).max())
    top = np.sort(f32, axis=1)
    margin = top[:, -1] - top[:, -2]
    clear = margin > 2 * tol
    agree = bf16.argmax(1) == f32.argmax(1)
    print(f"check bf16 vs f32: max_abs_err={err:.3e} tol={tol:.3e} "
          f"top1_agree={agree.tolist()} margin_over_2tol={clear.tolist()}",
          flush=True)
    if err > tol or not agree[clear].all():
        raise AssertionError("bf16 logits disagree with f32")

    kernels = []
    for dtype, tot in summary.items():
        kernels.append({
            "name": f"fused_bn_inference[{str(dtype).split('.')[-1]}]",
            "route": "cuda",
            "source": "dt_tpu_torch/csrc/bn_act.cu",
            "replaces": "dt_tpu/ops/pallas/kernels.py:43",
            "launches": results[dtype][0],
            "max_abs_err": tot["max_abs_err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": "bytes",
            "library_ms": tot["library_ms"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"gpu: {gpu_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
