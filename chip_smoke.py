#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving and training paths on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card, ``nvcc`` and
PyTorch built for CUDA.  It imports only the port (``dt_tpu_torch``), never
JAX.  Phases, each fatal on failure:

1. setup: the card's name and power limit, versions, the kernels' build
   (``nvcc``, one process per source, all started together);
2. kernels: every distinct BatchNorm shape of ResNet-50 v1 at 224x224,
   batch 32 and batch 21 (the elastic job's three workers), plus ragged
   and misaligned cases, in float32 and bfloat16 with
   ReLU on and off: the BN-inference kernel against its plain PyTorch
   version on the same inputs (max abs difference must be 0), and the times
   of the kernel, the plain version and ``F.batch_norm`` (a yardstick the
   port never calls) against the bytes bound;
3. training kernels: the BN-train pass 1 at the same shapes, held against
   its plain version (mean and var within 1e-5 of the largest E[x^2], two
   launches bit-identical, y bit-equal to the plain pass 2 on the kernel's
   stats, one CUDA kernel a call in a ``torch.profiler`` window), and the
   2-bit quantize/dequantize pair at ResNet-50's parameter
   count and at 0, 1, 15, 17 and 1000 elements with values at +-t, +-0,
   +-inf and NaN, bit for bit; each timed beside its bound, its plain
   version and, for BN, ``F.batch_norm(training=True)``;
4. serve: ResNet-50 v1 at full width (224x224x3, 1000 classes) from seeded
   weights carried in through ``load_jax_variables``, served through
   ``Predictor`` (buckets up to 64) in float32 and bfloat16: requests of 1,
   3, 32 and 130 rows, 53 kernel launches per chunk forward, float32 logits
   against the port on the CPU, bfloat16 against float32, and per-bucket
   latency and throughput;
5. train: ResNet-50 v1 at full width, batch 32, the same seeded weights,
   SGD (momentum 0.9, lr 0.1, wd 1e-4) through ``grad_step``/``apply_step``
   in three modes (bfloat16 compute on float32 params, float32, bfloat16
   with the 2-bit compressed leg): ten steps on one batch (loss finite and
   falling; 53 + 53 BN-train launches a step, 1 + 1 codec launches a
   compressed step), step time queued and synced, images/s, a profile of
   one step, model FLOPs; and one float32 step at batch 2 against the port
   on the CPU;
6. LM kernels: ``flash_attention`` at the TransformerLM's shape (B=8,
   S=2048, H=8, D=64, causal; q/k/v strided views of one qkv buffer, as the
   model hands them), at D=128 with S=1024 (causal) and at the LM's shape
   without the mask, each in bfloat16 and float32, out and lse held against
   ``flash_attention_plain``, two launches bit-identical, timed beside the
   bound (for f32 also the 3xTF32 bound of its tensor-core kernel), the
   plain version and ``F.scaled_dot_product_attention`` (a yardstick the
   port never calls), with TFLOP/s and the share of the bound;
   ``lstm_pointwise`` at B=32 and H=200 (the PTB example's default) and
   H=650, against its plain version, beside
   ``torch.ops.aten._thnn_fused_lstm_cell`` (also never called by the
   port); the LSTM layer kernel over a PTB window (T 35, B 32) at H 200
   and 650, forward and reverse, against its plain step loop (1e-5, bits
   repeated), timed alone and with its input product beside the per-step
   path, the plain loop, cuDNN's one-layer ``torch._VF.lstm`` (never
   called by the port), its bound and its serial floor;
7. train the TransformerLM of ``bench.py:579-598`` at full width (vocab
   8192, 512 wide, 6 layers, 8 heads, S 2048, batch 8, bfloat16 compute,
   ``seq_parallel="flash"``, SGD lr 0.1 momentum 0.9) for ten steps on one
   batch (loss finite and falling; 6 flash launches a forward), step time
   queued and synced, tokens/s, a profile of one step, model FLOPs; then
   one float32 step at 2 layers, S 256, batch 2 against the port on the
   CPU;
8. train the LSTM LM of ``examples/train_lstm_ptb.py`` with its defaults
   (vocab 10000, 200/200, 2 layers, bptt 35, batch 32, SGD lr 1.0, clip
   0.25, dropout 0.2 from a seeded generator) for ten windows with the
   state carried (loss falling; 2 ``lstm_layer`` launches a forward and
   no ``lstm_pointwise``), window time, tokens/s, a profile; then one
   float32 window at dropout 0 against the port on the CPU (2
   ``lstm_layer`` launches; the TransformerLM's f32 step: 2 f32 flash
   launches);
9. the PTB LSTM LM's forward in bfloat16 over one window, the path that
   steps the fused cell (70 ``lstm_pointwise`` launches), its logits
   against float32;
10. ``Module.fit`` (run after the train phase, before the LM phases):
   ResNet-50 v1 in bfloat16 at full width from the port's own
   ``init_params(seed=0)``, SGD lr 0.0125 (0.1 scaled to batch 32),
   momentum 0.9, wd 1e-4, 4 epochs of a shuffled
   seeded 64-image ``NDArrayIter`` (batch 32) behind a
   ``DevicePrefetchIter``, with ``eval_data`` (32 images), metrics ce and
   acc, a ``Speedometer`` and ``do_checkpoint``: 53 ``bn_stats`` launches a
   step and 53 ``bn_act`` a step plus 53 an eval forward, train loss finite
   and falling, the last checkpoint reloaded into a bf16 ``Predictor``
   against ``Module.predict``; fit's step time and a profile of one epoch
   beside phase 5's bare step; then a small f32 ``fit`` (resnet20, 8x8x3)
   on the card against the CPU, per-epoch loss within 1e-4 relative.  The
   flash kernels of phase 6 are also held and timed at D 16 and D 8 (the
   heads of the repo's small flash models);
11. the elastic host-sync job (after ``fit``): the port's ``Scheduler`` in
   this process and ``tests/torch_elastic_worker.py`` processes on the
   card: ResNet-50 v1 at full width in bf16 on f32 params, global batch
   64, SGD lr 0.025 momentum 0.9 wd 1e-4, 2-bit at 0.005, the overlapped
   step, 3 epochs of 8 steps, 64 images scored after every epoch; ``w2``
   added at the epoch-1 boundary (bootstrapping from the snapshot) and
   removed at the epoch-2 one; the live workers' sha256 equal at every
   epoch end, 53 + 53 BN-train and 1 codec launch a step, 53 BN-inference
   launches a scored batch, 6,389,260 bytes of packed words a step; each
   epoch's steps after its first timed as a window on worker 0's clock
   (2, 3, 2 workers), the step's parts from worker 0's spans beside the
   bare step; then 2-worker f32 resnet20 jobs (8x8x3 and 32x32x3) on the
   card, each step recorded and replayed on the CPU from the card's state
   (``tests/torch_elastic_drift.py``: loss, stats, update and, where no
   ReLU mask flipped, gradient within 1e-4; the applied average exact;
   per-epoch loss within 1e-4 of the replay and of the same job on the
   CPU up to the first flipped mask), and with ``DT_AR_OVERLAP=0`` (the
   same sha256 as the overlapped job).

The line before the last holds the card's name and power limit, the one
before it a JSON summary of the kernels, every number in it measured in
this run except the bounds, which it computes (the two kernels redesigned
for Hopper carry ``redesigned_in``); the last line is
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
# BN-train pass 1 against its plain version: f32 sums in another order, so
# mean and var may differ by a few ulps of E[x^2] (1e-5 of the largest)
TOL_STATS = 1e-5
BATCH = 32
IMAGE = 224  # ImageNet resolution of ResNet-50 v1
TRAIN_STEPS = 10  # steps on one batch in each mode: the loss must fall
TIME_STEPS = 5  # steps timed queued, and again synced
SGD = dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)
# The 2-bit leg's threshold ({'type': '2bit', 'threshold': ...}).  At the
# codec's default of 0.5 a step of this batch sends no element at all (the
# largest |g| is ~0.33, so the loss cannot fall in ten steps); at 0.005 it
# sends ~4 % of them (printed for 0.5 ... 0.0005 after the compressed run).
THRESHOLD_2BIT = 0.005
# one f32 step at batch 2, card against the port on the CPU, from the same
# state: the loss and new BN stats (forward only) tight; the gradient, the
# momentum and the params to 5e-2 of their norm, since a ReLU mask flips
# where the two devices' rounding puts a pre-activation on the other side
# of 0, and that moves every gradient below it (tests/test_torch_train.py)
TOL_STEP = dict(loss=1e-4, stats=1e-4, dense=1e-3, flat_g=5e-2, mom=5e-2,
                params=5e-2)
BF16_TFLOPS = 989.0  # H100 SXM dense bf16 peak, NVIDIA's data sheet
FP32_TFLOPS = 67.0  # H100 SXM f32 peak outside the tensor cores, same sheet
TF32_TFLOPS = 495.0  # H100 SXM dense TF32 tensor-core peak, same sheet
# TransformerLM of bench.py:579-581 and its batch (bench.py:572-574)
LM = dict(vocab_size=8192, embed_dim=512, num_layers=6, num_heads=8,
          max_len=2048)
LM_BATCH, LM_SEQ = 8, 2048
LM_SGD = dict(learning_rate=0.1, momentum=0.9)
# the PTB LSTM LM's defaults (examples/train_lstm_ptb.py:30-40)
PTB = dict(vocab_size=10000, embed_dim=200, hidden=200, num_layers=2,
           dropout=0.2)
PTB_BPTT, PTB_BATCH, PTB_LR, PTB_CLIP = 35, 32, 1.0, 0.25
# kernel against its plain version on the card: f32 sums in another order
# (flash out 2e-5 absolute in f32; in bf16 one ulp of each output row,
# 2**-7 of that row's largest |out|, where the f32 result rounds the other
# way; lse 1e-5 absolute, ~10 ulps at log(2048)); the LSTM cell's
# expf/tanhf against PyTorch's, a few ulps of values in [-1, 1] (1e-6)
TOL_FLASH = {"float32": 2e-5, "bfloat16": 2.0 ** -7}
TOL_LSE = 1e-5
TOL_LSTM = 1e-6
# the LSTM layer kernel against its plain step loop: the recurrent product's
# f32 sums in another order, carried through 35 steps
TOL_LSTM_LAYER = 1e-5
# the PTB LM's forward in bf16 against f32, of the largest |logit|: h and c
# are rounded to bf16 at every one of the 35 steps
TOL_LSTM_BF16 = 5e-2
# one f32 LM step, card against the port on the CPU (no ReLU masks: the
# loss and gradient agree to f32 summation order)
TOL_LM_STEP = dict(loss=1e-5, flat_g=1e-4, mom=1e-4, params=1e-4)
# Module.fit: epochs of the bf16 ResNet-50 run (2 steps each), and the
# per-epoch train loss of the small f32 fit, card against CPU (relative)
FIT_EPOCHS = 4
FIT_ROUNDS = 3  # alternating rounds of bare steps and fit epochs, timed
TOL_FIT = 1e-4
# Module.fit's SGD: bench.py's momentum and weight decay, with lr 0.1 taken
# as the rate for a batch of 256 and scaled linearly to the batch of 32
# (Goyal et al.).  bench.py's own lr 0.1 at batch 32 is a timing setting:
# from linen's default init (BN scale 1) it sends ResNet-50's logits to
# ~1e15 within the 8 steps, so the loss check would pass or fail by chance.
FIT_SGD = dict(learning_rate=0.1 * BATCH / 256, momentum=0.9,
               weight_decay=1e-4)
# The elastic phase: ResNet-50 v1 workers of tests/torch_elastic_worker.py
# against the port's Scheduler, global batch 64 (2 x 32, 3 x 21), SGD lr
# 0.025 (0.1 scaled to 64 of 256), momentum 0.9, wd 1e-4, 2-bit at 0.005,
# the overlapped step, 3 epochs of ELASTIC_STEPS steps cycling over 128
# seeded images (each epoch's steps after its first are its timed window),
# and 64 seeded images scored after every epoch (batch 32).
ELASTIC_STEPS = 8
ELASTIC_ARGS = ["--model", "resnet50", "--dtype", "bfloat16",
                "--global-batch", "64", "--images", "128", "--lr", "0.025",
                "--wd", "1e-4", "--compress", "0.005", "--num-epoch", "3",
                "--epoch-steps", str(ELASTIC_STEPS), "--val-images", "64"]
ELASTIC_VAL_FORWARDS = 2  # 64 images in batches of 32
RESNET50_PARAMS = 25_557_032
PACKED_BYTES = 4 * -(-RESNET50_PARAMS // 16)  # 6,389,260 a step a worker
ELASTIC_TIMEOUT = 420  # s, the whole job
# the small jobs: f32 resnet20 (8x8x3 and CIFAR's 32x32x3), 2 workers, 2
# epochs of 2 steps over 128 seeded images (tests/torch_elastic_drift.py)
SMALL_SIZES = (8, 32)
TOL_ELASTIC_LOSS = 1e-4  # card against CPU, relative


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


def kernel_phase(shapes, dev, also=()):
    """Hold the kernel against its plain version at every shape, bit for
    bit, and time it; the shapes of ``also`` (``bn_shapes`` keys of another
    batch) too, both ways of ReLU.  Returns one summary per dtype, with
    times summed over the BatchNorm calls of one batch-32 forward."""
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
            [(k[:4], r, 0) for k in also for r in (False, True)] + \
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
    from dt_tpu_torch.predictor import Predictor

    model = load_jax_variables(models.create(name, device=dev, dtype=dtype),
                               variables)
    pred = Predictor.from_fn(lambda m, _stats, x: m(x), model, dtype=dtype,
                             max_batch=BUCKET_MAX, device=dev)
    pred.warmup(images.shape[1:])
    torch.cuda.synchronize()
    reset_counts()  # the main path's run starts here
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
    counts = read_counts()  # ... and ends here
    launches = counts.pop("bn_act")
    if any(counts.values()):
        raise AssertionError(f"serving launched other kernels: {counts}")
    for b in pred.batch_buckets:
        reps = 10
        t0 = time.perf_counter()
        for _ in range(reps):
            pred.predict(images[:b])
        ms = (time.perf_counter() - t0) * 1e3 / reps
        print(f"serve {dtype} bucket={b} ms_per_request={ms:.3f} "
              f"img_per_s={b / ms * 1e3:.1f} gpu={gpu}", flush=True)
        if b in (1, BUCKET_MAX):
            profile_fn(lambda: pred.predict(images[:b]), ms,
                       f"{dtype} bucket={b}")
    return launches, chunks, first4


def profile_fn(fn, wall_ms: float, tag: str) -> dict:
    """Device time of one call of ``fn`` by kernel, from ``torch.profiler``,
    and the device's idle share against the call's unprofiled host time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if e.self_device_time_total > 0 and e.self_cpu_time_total == 0]
    busy = sum(r[2] for r in rows)
    if busy == 0:
        print(f"profile {tag}: device time not measured (the profiler saw "
              "no device events)", flush=True)
        return {}
    idle = max(0.0, 1 - busy / wall_ms)
    print(f"profile {tag} wall_ms={wall_ms:.3f} device_busy_ms={busy:.3f} "
          f"device_idle_share={idle:.3f}", flush=True)
    for key, count, ms in sorted(rows, key=lambda r: -r[2])[:10]:
        print(f"profile {tag} device_ms={ms:.3f} share={ms / busy:.3f} "
              f"calls={count} {key[:90]}", flush=True)
    return {"busy_ms": busy, "idle_share": idle}


def counted():
    """The launch counters of every kernel wrapper, by kernel."""
    from dt_tpu_torch.ops import attention, kernels
    return {"bn_act": kernels.bn_act, "bn_stats": kernels.bn_stats,
            "quantize_2bit": kernels.quantize_2bit,
            "dequantize_2bit": kernels.dequantize_2bit,
            "flash_attention": attention.flash_fwd,
            "lstm_pointwise": kernels.lstm_point,
            "lstm_layer": kernels.lstm_layer}


def reset_counts() -> None:
    for wrapper in counted().values():
        wrapper.launches = 0


def read_counts() -> dict:
    return {k: w.launches for k, w in counted().items()}


def device_kernels(fn) -> list:
    """Names of the CUDA kernels (and memsets, copies) that one call of
    ``fn`` puts on the device, from a ``torch.profiler`` window over that
    call alone."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def bn_train_phase(shapes, dev, also=()):
    """Hold the BN-train pass 1 against its plain version at every shape of
    a batch-32 forward, of ``also`` (``bn_shapes`` keys of another batch),
    and ragged and misaligned ones, check that two
    launches agree bit for bit and that y is the plain pass 2 on the
    kernel's stats, and time pass 1 + pass 2.  Returns one summary per
    dtype, times summed over the BatchNorm calls of one forward."""
    import torch
    import torch.nn.functional as F
    from dt_tpu_torch.ops import kernels
    extra = [((37, 3), False), ((1001, 17), True), ((1001, 64), True)]
    summary = {}
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(3)
        tot = {"ms": 0.0, "pass1_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
               "pass1_bound_ms": 0.0, "library_ms": 0.0, "max_abs_err": 0.0,
               "kernels_a_call": 0}
        runs = [(k[:4], k[4], m) for k, m in shapes.items()] + \
            [(k[:4], k[4], 0) for k in also] + \
            [(sh, r, 0) for sh, r in extra]
        for shape, relu, per_fwd in runs:
            for offset in [False, True] if shape == (1001, 64) else [False]:
                numel = int(np.prod(shape))
                flat = (torch.randn(numel + 1, generator=g, device=dev)
                        + 0.5).to(dtype)
                if len(shape) == 4:
                    n, c, h, w = shape
                    x = flat[:numel].view(n, h, w, c).permute(0, 3, 1, 2)
                else:
                    c = shape[1]
                    x = (flat[1:] if offset else flat[:numel]).view(shape)
                gamma = torch.rand(c, generator=g, device=dev) + 0.5
                beta = torch.randn(c, generator=g, device=dev)
                x2 = kernels.rows_view(x)
                mean, var = kernels.bn_stats(x)
                mean2, var2 = kernels.bn_stats(x)
                pm, pv = kernels.bn_stats_plain(x2)
                ex2 = float((x2.float() ** 2).mean(0).max())
                err = max(float((mean - pm).abs().max()),
                          float((var - pv).abs().max()))
                rm, rv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
                with torch.no_grad():
                    y, _, _ = kernels.fused_bn_train(x, gamma, beta, rm, rv,
                                                     relu=relu)
                scale, bias = kernels.bn_scale_bias(gamma, beta, mean, var,
                                                    1e-5, dtype)
                want = kernels.bn_act_plain(x2, scale, bias, relu)
                torch.cuda.synchronize()
                tag = (f"{dtype} shape={tuple(shape)} relu={relu} "
                       f"misaligned={offset}")
                if not (torch.equal(mean, mean2) and torch.equal(var, var2)):
                    raise AssertionError(f"bn_stats {tag}: two launches "
                                         "differ")
                if err > TOL_STATS * ex2:
                    raise AssertionError(f"bn_stats {tag}: max abs err "
                                         f"{err} > {TOL_STATS} * {ex2}")
                if not torch.equal(kernels.rows_view(y), want):
                    raise AssertionError(f"fused_bn_train {tag}: y differs "
                                         "from the plain pass 2")
                launched = device_kernels(lambda: kernels.bn_stats(x))
                print(f"kernel bn_train {tag} kernels_a_bn_stats_call="
                      f"{len(launched)} {launched}", flush=True)
                if len(launched) != 1:
                    raise AssertionError(f"bn_stats {tag}: one call put "
                                         f"{launched} on the device, not "
                                         "one kernel")
                tot["kernels_a_call"] = max(tot["kernels_a_call"],
                                            len(launched))
                tot["max_abs_err"] = max(tot["max_abs_err"], err)
                nbytes = x2.numel() * x.element_size()
                b1 = (nbytes + 2 * c * 4) / H100_BYTES_PER_S * 1e3
                b2 = (2 * nbytes + 2 * c * x.element_size()) \
                    / H100_BYTES_PER_S * 1e3
                xs = [x] + [x.clone()
                            for _ in range(min(L2_BYTES // nbytes, 63))]

                def library(a):
                    out = F.batch_norm(a, rm, rv, gamma, beta, training=True,
                                       momentum=0.1, eps=1e-5)
                    return torch.relu_(out) if relu else out

                p1 = cuda_ms(kernels.bn_stats, xs)
                p2 = cuda_ms(lambda a: kernels.bn_act(a, scale, bias, relu),
                             xs)
                pl1 = cuda_ms(lambda a: kernels.bn_stats_plain(
                    kernels.rows_view(a)), xs)
                pl2 = cuda_ms(lambda a: kernels.bn_act_plain(
                    kernels.rows_view(a), scale, bias, relu), xs)
                lib = cuda_ms(library, xs) if len(shape) == 4 else None
                del xs
                print(f"kernel bn_train {tag} stats_max_abs_err={err:.3e} "
                      f"ex2={ex2:.3f} pass1_ms={p1:.5f} "
                      f"pass1_bound_ms={b1:.5f} pass1_plain_ms={pl1:.5f} "
                      f"pass2_ms={p2:.5f} pass2_bound_ms={b2:.5f} "
                      f"fwd_ms={p1 + p2:.5f} fwd_plain_ms={pl1 + pl2:.5f} "
                      f"library_ms={lib and round(lib, 5)} "
                      f"per_forward={per_fwd}", flush=True)
                if per_fwd:
                    tot["ms"] += per_fwd * (p1 + p2)
                    tot["pass1_ms"] += per_fwd * p1
                    tot["plain_ms"] += per_fwd * (pl1 + pl2)
                    tot["bound_ms"] += per_fwd * (b1 + b2)
                    tot["pass1_bound_ms"] += per_fwd * b1
                    tot["library_ms"] += per_fwd * lib
        print(f"kernel bn_train {dtype} per forward: " + " ".join(
            f"{k}={v:.5f}" for k, v in tot.items()), flush=True)
        summary[dtype] = tot
    return summary


def codec_phase(n_params: int, dev):
    """Hold the 2-bit quantize/dequantize kernels against their plain
    versions bit for bit at ``n_params`` (ResNet-50's gradient) and at small
    and ragged sizes with values at +-t, +-0, +-inf and NaN; time both at
    ``n_params``.  Returns ``{"quantize_2bit": {...}, "dequantize_2bit":
    {...}}``."""
    import torch
    from dt_tpu_torch.ops import kernels
    t = 0.5
    special = torch.tensor([t, -t, 0.0, -0.0, float("inf"), -float("inf"),
                            float("nan"), t], device=dev)
    special_r = torch.tensor([0.0, 0.0, 0.0, -0.0, 1.0, 1.0, 0.0, -1e-8],
                             device=dev)
    g = torch.Generator(device=dev).manual_seed(4)

    def inputs(n):
        grad = torch.randn(n, generator=g, device=dev) * 0.6
        resid = torch.randn(n, generator=g, device=dev) * 0.2
        if n >= 16:
            grad[:8], resid[:8] = special, special_r
        return grad, resid

    for n in (0, 1, 15, 16, 17, 1000, n_params):
        grad, resid = inputs(n)
        words, res = kernels.quantize_2bit(grad, resid, t)
        pw, pr = kernels.quantize_2bit_plain(grad, resid, t)
        out = kernels.dequantize_2bit(words, n, t)
        pout = kernels.dequantize_2bit_plain(words, n, t)
        torch.cuda.synchronize()
        same = (torch.equal(words, pw)
                and torch.equal(res.view(torch.int32), pr.view(torch.int32))
                and torch.equal(out.view(torch.int32),
                                pout.view(torch.int32)))
        print(f"kernel quant2 n={n} words={words.numel()} bitwise={same}",
              flush=True)
        if not same:
            raise AssertionError(f"2-bit codec n={n}: kernel and plain "
                                 "version differ")
    n = n_params
    pairs = [inputs(n) for _ in range(2)]  # 2 x 204 MB: past the L2
    words = [kernels.quantize_2bit(*pr, t)[0] for pr in pairs]
    q_ms = cuda_ms(lambda a: kernels.quantize_2bit(*a, t), pairs, iters=10)
    qp_ms = cuda_ms(lambda a: kernels.quantize_2bit_plain(*a, t), pairs,
                    iters=4)
    d_ms = cuda_ms(lambda w: kernels.dequantize_2bit(w, n, t), words,
                   iters=10)
    dp_ms = cuda_ms(lambda w: kernels.dequantize_2bit_plain(w, n, t), words,
                    iters=4)
    nwords = -(-n // kernels.CODES_PER_WORD)
    out = {"quantize_2bit": {
        "ms": q_ms, "plain_ms": qp_ms, "max_abs_err": 0.0,
        "bound_ms": (12 * n + 4 * nwords) / H100_BYTES_PER_S * 1e3},
        "dequantize_2bit": {
        "ms": d_ms, "plain_ms": dp_ms, "max_abs_err": 0.0,
        "bound_ms": (4 * n + 4 * nwords) / H100_BYTES_PER_S * 1e3}}
    for name, r in out.items():
        print(f"kernel {name} n={n} kernel_ms={r['ms']:.5f} "
              f"plain_ms={r['plain_ms']:.5f} bound_ms={r['bound_ms']:.5f}",
              flush=True)
    return out


def _rel(a, b) -> float:
    return float((a - b).norm() / max(float(b.norm()), 1e-30))


def train_phase(variables, dev, gpu):
    """ResNet-50 training through ``train_step`` in three modes (the main
    path: counts are reset just before each mode's ten steps and read just
    after).  Returns ``{mode: {"launches": {...}, ...}}``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from dt_tpu_torch import models, optim
    from dt_tpu_torch.interchange import load_jax_variables
    from dt_tpu_torch.parallel.compression import GradientCompression
    from dt_tpu_torch.ops import kernels
    from dt_tpu_torch.training.step import grad_step, train_step
    from dt_tpu_torch.training.train_state import TrainState
    rng = np.random.RandomState(2)
    images = rng.uniform(-1, 1, (BATCH, IMAGE, IMAGE, 3)).astype(np.float32)
    labels = torch.from_numpy(rng.randint(0, 1000, BATCH)).to(dev)
    results = {}
    for mode, dtype, compressed in (("bf16", torch.bfloat16, False),
                                    ("f32", torch.float32, False),
                                    ("bf16_2bit", torch.bfloat16, True)):
        model = load_jax_variables(models.create("resnet50", device=dev,
                                                 dtype=dtype), variables)
        state = TrainState.create(model, optim.create("sgd", **SGD))
        gc = GradientCompression(THRESHOLD_2BIT) if compressed else None
        x = torch.from_numpy(images).to(dev).permute(0, 3, 1, 2).to(dtype)

        def step():
            return train_step(state, x, labels, compression=gc)[1]

        step()  # warm up: cuDNN plans, the allocator's pool
        torch.cuda.synchronize()
        reset_counts()  # the main path's run starts here
        losses = [float(step()) for _ in range(TRAIN_STEPS)]
        counts = read_counts()  # ... and ends here
        want = {k: 0 for k in counts}
        want.update(bn_stats=BN_PER_FORWARD * TRAIN_STEPS,
                    bn_act=BN_PER_FORWARD * TRAIN_STEPS)
        if compressed:
            want.update(quantize_2bit=TRAIN_STEPS,
                        dequantize_2bit=TRAIN_STEPS)
        _falling(f"train {mode}", losses)
        _check_counts(f"train {mode}", counts, want)
        res = {"launches": counts, "losses": losses, **_timed_steps(step)}
        res["imgs_per_s"] = BATCH * 1e3 / res["step_ms"]
        if mode == "bf16":
            with FlopCounterMode(display=False) as fc:
                step()
            flops = fc.get_total_flops()
            res["model_tflops_per_s"] = flops / res["step_ms"] / 1e9
            res["share_of_bf16_peak"] = res["model_tflops_per_s"] \
                / BF16_TFLOPS
            res["step_gflop"] = flops / 1e9
        print(f"train {mode} " + " ".join(
            f"{k}={round(v, 4) if isinstance(v, float) else v}"
            for k, v in res.items() if k not in ("launches", "losses"))
            + f" gpu={gpu}", flush=True)
        res.update(profile_fn(step, res["step_ms"], f"train {mode} step"))
        if compressed:
            # the share of one step's gradient that a fresh codec sends
            # (code != 0) at each threshold, from the same gradient
            flat_g = grad_step(state, x, labels)[0]
            for t in (0.5, 0.05, 0.005, 0.0005):
                words = GradientCompression(t).compress_on_device(flat_g)
                sent = float((kernels.dequantize_2bit(
                    words, flat_g.numel(), t) != 0).float().mean())
                print(f"train {mode} threshold={t} sent_share={sent:.5f} "
                      f"grad_abs_max={float(flat_g.abs().max()):.4g}",
                      flush=True)
        results[mode] = res
        del model, state, x, gc
        torch.cuda.empty_cache()
    return results


def step_card_vs_cpu(variables, dev) -> None:
    """One f32 step of ResNet-50 at batch 2 on the card and on the CPU from
    the same state, compared within ``TOL_STEP``."""
    import torch
    from dt_tpu_torch import models, optim
    from dt_tpu_torch.interchange import load_jax_variables
    from dt_tpu_torch.training.step import apply_step, grad_step
    from dt_tpu_torch.training.train_state import TrainState
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, IMAGE, IMAGE, 3))
                         .astype(np.float32)).permute(0, 3, 1, 2)
    y = torch.from_numpy(rng.randint(0, 1000, 2))
    got = {}
    for where in ("cuda", "cpu"):
        model = load_jax_variables(models.create("resnet50", device=where),
                                   variables)
        state = TrainState.create(model, optim.create("sgd", **SGD))
        t0 = time.perf_counter()
        flat_g, flat_s, loss, _ = grad_step(state, x.to(where), y.to(where))
        apply_step(state, flat_g, flat_s)
        lay = state.layout
        got[where] = {k: v.cpu() for k, v in {
            "loss": loss, "flat_g": flat_g, "stats": flat_s,
            "params": lay.params.ravel(state.params),
            "mom": lay.params.ravel(state.opt_state["mom"])}.items()}
        print(f"step card-vs-cpu {where} seconds="
              f"{time.perf_counter() - t0:.2f}", flush=True)
    dense = slice(*lay.params.span("Dense_0.weight"))
    card, cpu = got["cuda"], got["cpu"]
    card["dense"], cpu["dense"] = card["flat_g"][dense], cpu["flat_g"][dense]
    errs = {"loss": abs(float(card["loss"]) - float(cpu["loss"]))
            / abs(float(cpu["loss"]))}
    errs.update({k: _rel(card[k], cpu[k])
                 for k in ("stats", "dense", "flat_g", "mom", "params")})
    print("step card-vs-cpu f32 batch=2 " + " ".join(
        f"{k}_err={v:.3e} (tol {TOL_STEP[k]})" for k, v in errs.items()),
        flush=True)
    bad = {k: v for k, v in errs.items() if not v <= TOL_STEP[k]}
    if bad:
        raise AssertionError(f"f32 step, card against CPU: {bad}")


def flash_flops(bh: int, s: int, d: int, causal: bool = True) -> float:
    """Multiply-adds x 2 of one flash forward: q k^T and p v over the
    (query, key) pairs the mask leaves, S(S+1)/2 of them when causal."""
    pairs = s * (s + 1) / 2 if causal else s * s
    return 4.0 * bh * d * pairs


def flash_phase(dev):
    """Hold the flash kernel against its plain version in bf16 (the main
    path's type) and f32 at the TransformerLM's shape (causal), at D = 128
    with S = 1024 (causal) and at the LM's shape without the mask; two
    launches bit-identical; time kernel, plain version and SDPA.  Returns
    one summary per (shape name, dtype name)."""
    import torch
    import torch.nn.functional as F
    from dt_tpu_torch.ops import attention as TA
    h = LM["num_heads"]
    cases = {"lm": (LM_BATCH, LM_SEQ, h, LM["embed_dim"] // h, True),
             "d128": (LM_BATCH, 1024, 4, 128, True),
             "lm_full": (LM_BATCH, LM_SEQ, h, LM["embed_dim"] // h, False),
             # the small heads of the repo's own flash models (embed 64 or
             # 32 over 4 heads), at the LM's batch and length
             "d16": (LM_BATCH, LM_SEQ, 4, 16, True),
             "d8": (LM_BATCH, LM_SEQ, 4, 8, True)}
    out = {}
    for case, (b, s, h, d, causal) in cases.items():
        flops = flash_flops(b * h, s, d, causal)
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            g = torch.Generator(device=dev).manual_seed(6)

            def qkv_views():
                qkv = torch.randn(b, s, 3 * h * d, generator=g, device=dev) \
                    .to(dtype)
                return tuple(t.reshape(b, s, h, d)
                             for t in qkv.split(h * d, dim=-1))

            def kernel(a):
                return TA.flash_fwd(*a, scale=d ** -0.5, causal=causal)

            q, k, v = qkv_views()
            o1, lse1 = kernel((q, k, v))
            o2, lse2 = kernel((q, k, v))
            p3, plse = TA.flash_attention_plain(
                TA._to3(q), TA._to3(k), TA._to3(v), scale=d ** -0.5,
                causal=causal)
            po = TA._from3(p3, b, h)
            torch.cuda.synchronize()
            same = torch.equal(o1, o2) and torch.equal(lse1, lse2)
            diff = (o1.float() - po.float()).abs()
            err = float(diff.max())
            lse_err = float((lse1 - plse).abs().max())
            # the tolerance of each output row (its D values)
            tol = TOL_FLASH[name] * (
                po.float().abs().amax(-1, keepdim=True)
                if dtype == torch.bfloat16 else torch.ones_like(diff[..., :1]))
            worst = float((diff / tol).max())  # 1 is the limit
            tag = f"{name} shape=({b},{s},{h},{d}) causal={causal}"
            print(f"kernel flash_attention {tag} max_abs_err={err:.3e} "
                  f"worst_row_err_over_tol={worst:.3f} "
                  f"lse_max_abs_err={lse_err:.3e} (tol {TOL_LSE}) "
                  f"bitwise_repeat={same}", flush=True)
            if not same or not worst <= 1.0 or lse_err > TOL_LSE:
                raise AssertionError(f"flash_attention {tag}: kernel "
                                     "against plain version failed")
            inputs = [(q, k, v), qkv_views()]
            heads = [tuple(t.transpose(1, 2).contiguous() for t in trio)
                     for trio in inputs]
            k_ms = cuda_ms(kernel, inputs)
            p_ms = cuda_ms(lambda a: TA.flash_attention_plain(
                TA._to3(a[0]), TA._to3(a[1]), TA._to3(a[2]),
                scale=d ** -0.5, causal=causal), inputs, iters=5)
            lib_ms = cuda_ms(lambda a: F.scaled_dot_product_attention(
                *a, is_causal=causal), heads)
            item = q.element_size()
            nbytes = 4 * b * s * h * d * item + b * h * s * 4
            peak = BF16_TFLOPS if dtype == torch.bfloat16 else FP32_TFLOPS
            bound = max(nbytes / H100_BYTES_PER_S,
                        flops / (peak * 1e12)) * 1e3
            out[case, name] = {
                "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                "bound_ms": bound, "max_abs_err": err,
                "worst_row_err_over_tol": worst, "lse_max_abs_err": lse_err,
                "shape": [b, s, h, d],
                "causal": causal, "tflops_per_s": flops / k_ms / 1e9,
                "bound_share": bound / k_ms}
            if dtype == torch.float32:
                # the f32 kernel runs three TF32 products for each one
                out[case, name]["bound_3xtf32_ms"] = max(
                    nbytes / H100_BYTES_PER_S,
                    3 * flops / (TF32_TFLOPS * 1e12)) * 1e3
            print(f"kernel flash_attention {tag} kernel_ms={k_ms:.4f} "
                  f"plain_ms={p_ms:.4f} library_ms={lib_ms:.4f} "
                  f"bound_ms={bound:.5f} "
                  f"bound_3xtf32_ms="
                  f"{out[case, name].get('bound_3xtf32_ms', float('nan')):.5f} "
                  f"gflop={flops / 1e9:.2f} "
                  f"kernel_tflops_per_s={flops / k_ms / 1e9:.2f} "
                  f"bound_share={bound / k_ms:.3f} "
                  f"library_tflops_per_s={flops / lib_ms / 1e9:.2f} "
                  f"kernel_over_library={k_ms / lib_ms:.3f} bytes={nbytes}",
                  flush=True)
            del inputs, heads, q, k, v, o1, o2, po, p3
    return out


def lstm_phase(dev):
    """Hold the LSTM pointwise kernel against its plain version at B=32,
    H=200 (the PTB default) and H=650, two launches bit-identical; time it
    beside its bound, the plain version and aten's fused LSTM cell.  Returns
    one summary per H."""
    import torch
    from dt_tpu_torch.ops import kernels
    out = {}
    for hidden in (200, 650):
        b = PTB_BATCH
        g = torch.Generator(device=dev).manual_seed(hidden)
        pairs = [(torch.randn(b, 4 * hidden, generator=g, device=dev) * 2,
                  torch.randn(b, hidden, generator=g, device=dev))
                 for _ in range(2)]
        gates, c = pairs[0]
        h1, c1 = kernels.lstm_point(gates, c)
        h2, c2 = kernels.lstm_point(gates, c)
        ph, pc = kernels.lstm_pointwise_plain(gates, c)
        torch.cuda.synchronize()
        same = torch.equal(h1, h2) and torch.equal(c1, c2)
        err = max(float((h1 - ph).abs().max()), float((c1 - pc).abs().max()))
        print(f"kernel lstm_pointwise B={b} H={hidden} max_abs_err={err:.3e} "
              f"(tol {TOL_LSTM}) bitwise_repeat={same}", flush=True)
        if not same or err > TOL_LSTM:
            raise AssertionError(f"lstm_pointwise H={hidden}: kernel against "
                                 "plain version failed")
        k_ms = cuda_ms(lambda a: kernels.lstm_point(*a), pairs, iters=100)
        p_ms = cuda_ms(lambda a: kernels.lstm_pointwise_plain(*a), pairs,
                       iters=100)
        lib_ms = cuda_ms(lambda a: torch.ops.aten._thnn_fused_lstm_cell(
            a[0], torch.zeros_like(a[0]), a[1]), pairs, iters=100)
        bound = 28 * b * hidden / H100_BYTES_PER_S * 1e3
        out[hidden] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                       "bound_ms": bound, "max_abs_err": err}
        print(f"kernel lstm_pointwise B={b} H={hidden} kernel_ms={k_ms:.5f} "
              f"plain_ms={p_ms:.5f} library_ms={lib_ms:.5f} "
              f"bound_ms={bound:.6f}", flush=True)
    return out


def layer_bound_ms(t: int, b: int, hidden: int) -> float:
    """Least time of one layer window from xw: 2 T B H 4H operations at the
    f32 peak against xw in, the gates out, h and c out, Wh, h0 and c0 once,
    in f32."""
    ops = 2.0 * t * b * hidden * 4 * hidden
    nbytes = 4.0 * (2 * t * b * 4 * hidden + 2 * t * b * hidden
                    + 4 * hidden * hidden + 2 * b * hidden)
    return max(nbytes / H100_BYTES_PER_S, ops / (FP32_TFLOPS * 1e12)) * 1e3


def lstm_layer_phase(dev):
    """Hold the LSTM layer kernel against its plain step loop at the PTB
    window (T 35, B 32) with H 200 and 650, forward and reverse, two
    launches bit-identical; time it alone, with its input product, beside
    the per-step path of the same window (the fused cell, pointwise kernel
    and all), the plain loop and cuDNN's one-layer LSTM (``torch._VF.lstm``,
    a yardstick the port never calls); and its serial floor, the same
    kernel at B 1, H 16.  Returns one summary per H."""
    import torch
    from dt_tpu_torch.ops import kernels, rnn
    t, b = PTB_BPTT, PTB_BATCH
    out = {}
    for hidden in (200, 650):
        g = torch.Generator(device=dev).manual_seed(hidden + 1)
        lim = hidden ** -0.5

        def draw():
            x = torch.randn(t, b, hidden, generator=g, device=dev)
            h0, c0 = (torch.randn(b, hidden, generator=g, device=dev) * 0.3
                      for _ in range(2))
            wx, wh = ((torch.rand(hidden, 4 * hidden, generator=g,
                                  device=dev) * 2 - 1) * lim
                      for _ in range(2))
            bias = torch.randn(4 * hidden, generator=g, device=dev) * 0.02
            xw = (x.reshape(t * b, hidden) @ wx + bias).reshape(t, b, -1)
            return x, h0, c0, rnn.LSTMWeights(wx, wh, bias), xw

        sets = [draw(), draw()]
        x, h0, c0, w, xw = sets[0]
        err, same = 0.0, True
        for reverse in (False, True):
            got = kernels.lstm_layer(xw, h0, c0, w.wh, reverse)
            again = kernels.lstm_layer(xw, h0, c0, w.wh, reverse)
            want = kernels.lstm_layer_plain(xw, h0, c0, w.wh, reverse)
            torch.cuda.synchronize()
            same = same and all(torch.equal(a, a2)
                                for a, a2 in zip(got, again))
            err = max([err] + [float((a - p).abs().max())
                               for a, p in zip(got, want)])
        print(f"kernel lstm_layer T={t} B={b} H={hidden} "
              f"geometry={tuple(kernels.layer_geometry(b, hidden))} "
              f"max_abs_err={err:.3e} (tol {TOL_LSTM_LAYER}) "
              f"bitwise_repeat={same}", flush=True)
        if not same or not err <= TOL_LSTM_LAYER:
            raise AssertionError(f"lstm_layer H={hidden}: kernel against "
                                 "plain version failed")
        # cuDNN's layer on the same x and weights (the same function), its
        # weights in one flat buffer as torch.nn.LSTM keeps them
        flat = []
        for a in sets:
            mod = torch.nn.LSTM(hidden, hidden, 1).to(dev)
            with torch.no_grad():
                for name, val in (("weight_ih_l0", a[3].wx.t()),
                                  ("weight_hh_l0", a[3].wh.t()),
                                  ("bias_ih_l0", a[3].b),
                                  ("bias_hh_l0", torch.zeros_like(a[3].b))):
                    getattr(mod, name).copy_(val)
            mod.flatten_parameters()
            flat.append(mod._flat_weights)

        def cudnn(a):
            return torch._VF.lstm(a[0], (a[1][None], a[2][None]), a[5],
                                  True, 1, 0.0, False, False, False)

        sets = [(*a, f) for a, f in zip(sets, flat)]
        y_lib = cudnn(sets[0])[0]
        lib_err = float((y_lib - kernels.lstm_layer(xw, h0, c0, w.wh)[0])
                        .abs().max())

        def per_step(a):  # today's path before this kernel: a cell a step
            hh, cc = a[1], a[2]
            for s_ in range(t):
                hh, cc = kernels.lstm_cell_fused(a[0][s_], hh, cc, a[3])
            return hh

        with torch.no_grad():
            k_ms = cuda_ms(lambda a: kernels.lstm_layer(a[4], a[1], a[2],
                                                        a[3].wh), sets)
            layer_ms = cuda_ms(lambda a: kernels.lstm_layer_fused(
                a[0], a[1], a[2], a[3]), sets)
            step_ms = cuda_ms(per_step, sets, iters=5)
            p_ms = cuda_ms(lambda a: kernels.lstm_layer_plain(
                a[4], a[1], a[2], a[3].wh), sets, iters=5)
            lib_ms = cuda_ms(cudnn, sets)
            tiny = [(torch.randn(t, 1, 64, generator=g, device=dev),
                     torch.zeros(1, 16, device=dev),
                     torch.zeros(1, 16, device=dev),
                     torch.randn(16, 64, generator=g, device=dev) * 0.25)]
            floor_ms = cuda_ms(lambda a: kernels.lstm_layer(*a), tiny)
        bound = layer_bound_ms(t, b, hidden)
        out[hidden] = {"ms": k_ms, "layer_ms": layer_ms,
                       "per_step_ms": step_ms, "plain_ms": p_ms,
                       "library_ms": lib_ms, "bound_ms": bound,
                       "serial_floor_ms": floor_ms, "max_abs_err": err,
                       "library_max_abs_diff": lib_err,
                       "shape": [t, b, hidden]}
        print(f"kernel lstm_layer T={t} B={b} H={hidden} kernel_ms={k_ms:.5f} "
              f"layer_ms={layer_ms:.5f} per_step_ms={step_ms:.5f} "
              f"plain_ms={p_ms:.5f} library_ms={lib_ms:.5f} "
              f"bound_ms={bound:.5f} serial_floor_ms={floor_ms:.5f} "
              f"kernel_over_library={k_ms / lib_ms:.3f} "
              f"layer_over_library={layer_ms / lib_ms:.3f} "
              f"library_max_abs_diff={lib_err:.3e}", flush=True)
        del sets, x, h0, c0, w, xw
    return out


def seeded_lm_variables(model, seed: int, head_std: float = 1.0):
    """Weights for an LM in the JAX layout from numpy with ``seed``:
    LeCun-normal kernels (the LM head's times ``head_std``), N(0, 1)
    embeddings, N(0, 0.02) positions, LayerNorm scale 1 + N(0, 0.05), the
    LSTM's uniform(+-1/sqrt(H)), biases N(0, 0.02)."""
    from dt_tpu_torch.interchange import export_jax_variables
    rng = np.random.RandomState(seed)

    def fill(tree, path=()):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = fill(v, path + (k,))
                continue
            shape = tuple(v.shape)
            if k == "kernel":
                std = 1.0 / np.sqrt(shape[0])
                if path and path[-1] in ("lm_head", "Dense_0"):
                    std *= head_std
                w = rng.normal(0, std, shape)
            elif k == "embedding":
                w = rng.normal(0, 1.0, shape)
            elif k == "pos_embed":
                w = rng.normal(0, 0.02, shape)
            elif k == "scale":
                w = 1.0 + rng.normal(0, 0.05, shape)
            elif k.endswith(("_wx", "_wh")):
                lim = 1.0 / np.sqrt(shape[1] // 4)
                w = rng.uniform(-lim, lim, shape)
            elif k == "bias" or k.endswith("_b"):
                w = rng.normal(0, 0.02, shape)
            else:
                raise KeyError(f"unexpected leaf {k!r}")
            out[k] = w.astype(np.float32)
        return out

    return {"params": fill(export_jax_variables(model)["params"])}


def _timed_steps(step) -> dict:
    """Step time by the host clock, queued and synced (``bench.py:462-486,
    619-631``), and the smaller of the two."""
    import torch
    t0 = time.perf_counter()
    for _ in range(TIME_STEPS):
        step()
    torch.cuda.synchronize()
    queued = (time.perf_counter() - t0) / TIME_STEPS
    t0 = time.perf_counter()
    for _ in range(TIME_STEPS):
        step()
        torch.cuda.synchronize()
    synced = (time.perf_counter() - t0) / TIME_STEPS
    return {"step_ms": min(queued, synced) * 1e3,
            "step_ms_queued": queued * 1e3, "step_ms_synced": synced * 1e3,
            "sync_agreement": min(queued, synced) / max(queued, synced)}


def _check_counts(tag, counts, want):
    print(f"{tag} launches={json.dumps(counts)} expected={json.dumps(want)}",
          flush=True)
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts}, expected {want}")


def _falling(tag, losses):
    """Finite and falling: the mean of the last three steps below the first
    (lr 0.1 on one batch overshoots now and then)."""
    print(f"{tag} losses={[round(v, 5) for v in losses]}", flush=True)
    if not (np.isfinite(losses).all() and np.mean(losses[-3:]) < losses[0]):
        raise AssertionError(f"{tag}: loss not finite and falling: {losses}")


def lm_train_phase(dev, gpu):
    """The TransformerLM of ``bench.py:579-598`` trained through
    ``train_step`` with the next-token loss (the main path: counts reset
    just before the ten steps and read just after)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from dt_tpu_torch import models, optim
    from dt_tpu_torch.interchange import load_jax_variables
    from dt_tpu_torch.training.step import next_token_loss, train_step
    from dt_tpu_torch.training.train_state import TrainState
    model = models.create("transformer_lm", device=dev, seq_parallel="flash",
                          dtype=torch.bfloat16, **LM)
    load_jax_variables(model, seeded_lm_variables(model, seed=0))
    state = TrainState.create(model, optim.create("sgd", **LM_SGD))
    tokens = torch.from_numpy(np.random.RandomState(0).randint(
        0, LM["vocab_size"], (LM_BATCH, LM_SEQ))).to(dev)

    def step():
        return train_step(state, tokens, None, loss_fn=next_token_loss)[1]

    step()  # warm up: cuBLAS plans, the allocator's pool
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()  # the main path's run starts here
    losses = [float(step()) for _ in range(TRAIN_STEPS)]
    counts = read_counts()  # ... and ends here
    want = {k: 0 for k in counts}
    want["flash_attention"] = LM["num_layers"] * TRAIN_STEPS
    _check_counts("lm_train bf16", counts, want)
    _falling("lm_train bf16", losses)
    res = {"launches": counts, "losses": losses, **_timed_steps(step),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    res["tokens_per_s"] = LM_BATCH * LM_SEQ * 1e3 / res["step_ms"]
    with FlopCounterMode(display=False) as fc:
        step()
    # FlopCounterMode sees the PyTorch ops (the matmuls, and the plain
    # attention backward's five per kv block) but not the ctypes flash
    # forward: add the causal work it does, once per layer
    attn = LM["num_layers"] * flash_flops(
        LM_BATCH * LM["num_heads"], LM_SEQ, LM["embed_dim"] // LM["num_heads"])
    flops = fc.get_total_flops() + attn
    res.update(step_gflop=flops / 1e9, flash_fwd_gflop=attn / 1e9,
               model_tflops_per_s=flops / res["step_ms"] / 1e9,
               share_of_bf16_peak=flops / res["step_ms"] / 1e9 / BF16_TFLOPS)
    print("lm_train bf16 " + " ".join(
        f"{k}={round(v, 4) if isinstance(v, float) else v}"
        for k, v in res.items() if k not in ("launches", "losses"))
        + f" gpu={gpu}", flush=True)
    res.update(profile_fn(step, res["step_ms"], "lm_train bf16 step"))
    del model, state, tokens
    torch.cuda.empty_cache()
    return res


def ptb_stream(vocab: int, seed: int = 0):
    """The PTB example's synthetic stream (``train_lstm_ptb.py:65-69``):
    200,000 seeded tokens batchified to ``(T_total, B)``."""
    toks = np.random.RandomState(seed).randint(0, vocab, 200000)
    nb = len(toks) // PTB_BATCH
    return toks[:nb * PTB_BATCH].reshape(PTB_BATCH, nb).T


def lstm_train_phase(dev, gpu):
    """The PTB LSTM LM trained through ``train_step`` with the BPTT loss
    and the clip, window after window with the state carried (the main
    path: counts reset just before the ten windows and read just
    after)."""
    import torch
    from dt_tpu_torch import models, optim
    from dt_tpu_torch.interchange import load_jax_variables
    from dt_tpu_torch.training.step import BPTTLoss, train_step
    from dt_tpu_torch.training.train_state import TrainState
    model = models.create("lstm_lm", device=dev, **PTB)
    # the head at 40x LeCun: the LSTM's outputs are small (|h| ~ 0.03), so
    # at LeCun scale the logits are near-uniform and the loss starts at the
    # uniform stream's floor log(10000) = 9.21 with nothing to fall; at 40x
    # it starts ~1.1 nats above it (10.31 on the CPU at this seed)
    load_jax_variables(model, seeded_lm_variables(model, seed=1,
                                                  head_std=40.0))
    state = TrainState.create(model, optim.create("sgd",
                                                  learning_rate=PTB_LR))
    stream = torch.from_numpy(ptb_stream(PTB["vocab_size"])).to(dev)
    loss_fn = BPTTLoss(generator=torch.Generator(device=dev).manual_seed(2))
    window = iter(range(0, stream.shape[0] - 1 - PTB_BPTT, PTB_BPTT))

    def step():
        i = next(window)
        return train_step(state, stream[i:i + PTB_BPTT],
                          stream[i + 1:i + 1 + PTB_BPTT], loss_fn=loss_fn,
                          clip_norm=PTB_CLIP)[1]

    step()  # warm up
    torch.cuda.synchronize()
    reset_counts()  # the main path's run starts here
    losses = [float(step()) for _ in range(TRAIN_STEPS)]
    counts = read_counts()  # ... and ends here
    want = {k: 0 for k in counts}
    want["lstm_layer"] = PTB["num_layers"] * TRAIN_STEPS
    _check_counts("lstm_train f32", counts, want)
    _falling("lstm_train f32", losses)
    res = {"launches": counts, "losses": losses, **_timed_steps(step)}
    res["tokens_per_s"] = PTB_BPTT * PTB_BATCH * 1e3 / res["step_ms"]
    print("lstm_train f32 " + " ".join(
        f"{k}={round(v, 4) if isinstance(v, float) else v}"
        for k, v in res.items() if k not in ("launches", "losses"))
        + f" gpu={gpu}", flush=True)
    res.update(profile_fn(step, res["step_ms"], "lstm_train f32 window"))
    del model, state, stream
    torch.cuda.empty_cache()
    return res


def lstm_bf16_forward(dev):
    """The PTB LSTM LM's forward in bf16 over one window (the path that
    steps the fused cell: a bf16 layer runs ``lstm_cell_fused`` a step, and
    so the pointwise kernel; counts reset just before and read just after),
    its logits against the same model in f32 within ``TOL_LSTM_BF16`` of
    the largest |logit|."""
    import torch
    from dt_tpu_torch import models
    from dt_tpu_torch.interchange import load_jax_variables
    cfg = dict(PTB, dropout=0.0)
    variables = seeded_lm_variables(models.create("lstm_lm", device="cpu",
                                                  **cfg), seed=1,
                                    head_std=40.0)
    tokens = torch.from_numpy(ptb_stream(PTB["vocab_size"])[:PTB_BPTT]) \
        .to(dev)
    logits = {}
    for dtype in (torch.float32, torch.bfloat16):
        model = load_jax_variables(models.create("lstm_lm", device=dev,
                                                 dtype=dtype, **cfg),
                                   variables)
        with torch.no_grad():
            model(tokens, training=False)  # warm up
            torch.cuda.synchronize()
            reset_counts()  # the path's run starts here
            logits[dtype] = model(tokens, training=False)[0].float()
            counts = read_counts()  # ... and ends here
        if dtype == torch.bfloat16:
            want = {k: 0 for k in counts}
            want["lstm_pointwise"] = PTB_BPTT * PTB["num_layers"]
            _check_counts("lstm_forward bf16", counts, want)
    f32, bf = logits[torch.float32], logits[torch.bfloat16]
    scale = float(f32.abs().max())
    err = float((bf - f32).abs().max())
    print(f"lstm_forward bf16 vs f32 max_abs_err={err:.3e} "
          f"max_abs_logit={scale:.3f} tol={TOL_LSTM_BF16 * scale:.3e} "
          f"finite={bool(torch.isfinite(bf).all())}", flush=True)
    if not (torch.isfinite(bf).all() and err <= TOL_LSTM_BF16 * scale):
        raise AssertionError("bf16 LSTM LM forward disagrees with f32")
    return {"launches": counts, "max_abs_err": err}


def lm_steps_card_vs_cpu() -> dict:
    """One f32 step of each LM on the card and on the CPU from the same
    weights, compared within ``TOL_LM_STEP``: the TransformerLM at 2
    layers, S 256, batch 2 (flash: the f32 kernel on the card, the plain
    version on the CPU); the LSTM LM's first window at dropout 0 (the layer
    kernel).  Each card step is a path of its own: counts reset just before
    it and read just after.  Returns the counts by model."""
    import torch
    from dt_tpu_torch import models, optim
    from dt_tpu_torch.interchange import load_jax_variables
    from dt_tpu_torch.ops.tensor import clip_global_norm
    from dt_tpu_torch.training.step import (BPTTLoss, apply_step, grad_step,
                                            next_token_loss)
    from dt_tpu_torch.training.train_state import TrainState
    lm = dict(LM, num_layers=2, max_len=256)
    stream = ptb_stream(PTB["vocab_size"])
    cases = {
        "transformer_lm": (dict(lm, seq_parallel="flash"), LM_SGD,
                           next_token_loss, None,
                           np.random.RandomState(7).randint(
                               0, LM["vocab_size"], (2, 256)), None),
        "lstm_lm": (dict(PTB, dropout=0.0), dict(learning_rate=PTB_LR),
                    None, PTB_CLIP, stream[:PTB_BPTT],
                    stream[1:1 + PTB_BPTT])}
    expected = {"transformer_lm": ("flash_attention", lm["num_layers"]),
                "lstm_lm": ("lstm_layer", PTB["num_layers"])}
    launched = {}
    for name, (kw, sgd, loss_fn, clip, x, y) in cases.items():
        variables = seeded_lm_variables(
            models.create(name, device="cpu", **kw), seed=3)
        got = {}
        for where in ("cuda", "cpu"):
            model = load_jax_variables(models.create(name, device=where,
                                                     **kw), variables)
            state = TrainState.create(model, optim.create("sgd", **sgd))
            xt = torch.from_numpy(x).to(where)
            yt = None if y is None else torch.from_numpy(y).to(where)
            t0 = time.perf_counter()
            reset_counts()  # the card step's run starts here
            flat_g, flat_s, loss, _ = grad_step(state, xt, yt,
                                                loss_fn or BPTTLoss())
            if where == "cuda":
                launched[name] = read_counts()  # ... and ends here
                want = {k: 0 for k in launched[name]}
                want[expected[name][0]] = expected[name][1]
                _check_counts(f"lm step f32 {name}", launched[name], want)
            if clip is not None:
                flat_g = clip_global_norm({"g": flat_g}, clip)[0]["g"]
            apply_step(state, flat_g, flat_s)
            lay = state.layout
            got[where] = {"loss": loss.cpu(), "flat_g": flat_g.cpu(),
                          "params": lay.params.ravel(state.params).cpu()}
            if "mom" in state.opt_state:
                got[where]["mom"] = lay.params.ravel(
                    state.opt_state["mom"]).cpu()
            print(f"lm step card-vs-cpu {name} {where} seconds="
                  f"{time.perf_counter() - t0:.2f}", flush=True)
        card, cpu = got["cuda"], got["cpu"]
        errs = {"loss": abs(float(card["loss"]) - float(cpu["loss"]))
                / abs(float(cpu["loss"]))}
        errs.update({k: _rel(card[k], cpu[k]) for k in card if k != "loss"})
        print(f"lm step card-vs-cpu {name} f32 " + " ".join(
            f"{k}_err={v:.3e} (tol {TOL_LM_STEP[k]})"
            for k, v in errs.items()), flush=True)
        bad = {k: v for k, v in errs.items() if not v <= TOL_LM_STEP[k]}
        if bad:
            raise AssertionError(f"{name} f32 step, card against CPU: {bad}")
    return launched


def fit_phase(dev, gpu, train_bf16) -> dict:
    """``Module.fit`` on the card, the slice's main path: ResNet-50 v1 in
    bfloat16 at full width from the port's own ``init_params(seed=0)``, SGD
    lr 0.1 momentum 0.9 wd 1e-4, 4 epochs of a shuffled seeded 64-image
    ``NDArrayIter`` (batch 32, 8 steps) behind a ``DevicePrefetchIter``,
    ``eval_data`` of 32 images, metrics ce and acc, a ``Speedometer`` and
    ``do_checkpoint``.  Counts are reset just before ``fit`` and read just
    after: 53 ``bn_stats`` a step, and ``bn_act`` 53 a step plus 53 an eval
    forward.  The train cross-entropy is finite each epoch and lower in the
    last than in the first; the last checkpoint reloads into a bf16
    ``Predictor`` whose logits match ``Module.predict``'s within
    ``TOL_BF16`` of the largest |logit|.  Then fit's step time (3 epochs
    without eval or checkpoint, behind ``DevicePrefetchIter`` and without
    it) against the bare ``train_step`` on the same module, in alternating
    rounds, and profiles of a fit epoch and of bare steps."""
    import tempfile
    import torch
    from dt_tpu_torch import models
    from dt_tpu_torch.data import io
    from dt_tpu_torch.predictor import Predictor
    from dt_tpu_torch.training import callbacks
    from dt_tpu_torch.training.module import Module
    from dt_tpu_torch.training.step import train_step
    n_train, n_eval, epochs = 2 * BATCH, BATCH, FIT_EPOCHS
    rng = np.random.RandomState(7)
    images = rng.uniform(-1, 1, (n_train + n_eval, IMAGE, IMAGE, 3)) \
        .astype(np.float32)
    labels = rng.randint(0, 1000, n_train + n_eval).astype(np.int32)
    mod = Module(models.create("resnet50", device=dev, dtype=torch.bfloat16),
                 optimizer="sgd", optimizer_params=FIT_SGD, device=dev,
                 seed=0)
    mod.init_params()

    spare = Module(models.create("resnet50", device=dev,
                                 dtype=torch.bfloat16),
                   optimizer="sgd", optimizer_params=FIT_SGD, device=dev)
    spare.init_params()
    before = _fit_rounds(spare, images[:n_train], labels[:n_train], dev, 1,
                         0)
    del spare

    def train_iter():
        return io.DevicePrefetchIter(io.NDArrayIter(
            images[:n_train], labels[:n_train], batch_size=BATCH,
            shuffle=True, seed=0), device=dev)

    eval_iter = io.NDArrayIter(images[n_train:], labels[n_train:],
                               batch_size=BATCH)
    per_epoch = []

    def record(epoch, state, metric):
        per_epoch.append(dict(metric.get_name_value()))

    speed = callbacks.Speedometer(BATCH, frequent=1, auto_reset=False)
    with tempfile.TemporaryDirectory() as tmp:
        prefix = str(Path(tmp) / "resnet50")
        torch.cuda.synchronize()
        reset_counts()  # the main path's run starts here
        t0 = time.perf_counter()
        mod.fit(train_iter(), eval_data=eval_iter, eval_metric=["ce", "acc"],
                num_epoch=epochs, batch_end_callback=speed,
                epoch_end_callback=[record,
                                    callbacks.do_checkpoint(prefix)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()  # ... and ends here
        steps = epochs * n_train // BATCH
        want = {k: 0 for k in counts}
        want.update(bn_stats=BN_PER_FORWARD * steps,
                    bn_act=BN_PER_FORWARD * (steps + epochs))
        _check_counts("fit bf16", counts, want)
        ce = [e["cross-entropy"] for e in per_epoch]
        print(f"fit bf16 epochs={epochs} steps={steps} wall_s={wall:.3f} "
              f"train_ce={[round(v, 5) for v in ce]} "
              f"train_acc={[e['accuracy'] for e in per_epoch]} "
              f"speedometer_samples_per_s="
              f"{[round(v, 1) for v in speed.speeds]} gpu={gpu}", flush=True)
        if not (np.isfinite(ce).all() and ce[-1] < ce[0]):
            raise AssertionError(f"fit: train cross-entropy not finite and "
                                 f"falling: {ce}")
        pred = Predictor("resnet50", prefix, epochs - 1, images[:1],
                         dtype=torch.bfloat16, max_batch=4, device=dev)
        got = pred.predict(images[:4])
    want_logits = mod.predict(images[:4])
    err = float(np.abs(got - want_logits).max())
    tol = TOL_BF16 * float(np.abs(want_logits).max())
    print(f"fit checkpoint -> Predictor bf16: max_abs_err={err:.3e} "
          f"tol={tol:.3e} step={int(np.asarray(pred.step))}", flush=True)
    if not (np.isfinite(got).all() and err <= tol):
        raise AssertionError("fit: the reloaded checkpoint's logits disagree "
                             "with Module.predict")

    # fit's own step time against the bare step on the same module, in
    # alternating rounds (host clocks drift within a run): medians over
    # FIT_ROUNDS rounds after the main path, and one round on a fresh
    # module run before it (does the main path's eval, checkpoints and
    # Predictor leave the process slower?)
    times = _fit_rounds(mod, images[:n_train], labels[:n_train], dev,
                        FIT_ROUNDS, epochs)
    med = {k: float(np.median(v)) for k, v in times.items()}
    nd = io.NDArrayIter(images[:n_train], labels[:n_train], batch_size=BATCH,
                        shuffle=True)
    t0 = time.perf_counter()
    batches = [nd.next().data for _ in range(2)]
    nd.reset()
    batches += [nd.next().data for _ in range(2)]
    t1 = time.perf_counter()
    for b in batches:
        torch.from_numpy(b).pin_memory()
    t2 = time.perf_counter()
    step_ms = med["prefetch"]
    res = {"launches": counts, "train_ce": ce, "wall_s": wall,
           "step_ms": step_ms, "imgs_per_s": BATCH * 1e3 / step_ms,
           "bare_step_ms": med["bare"],
           "bare_imgs_per_s": BATCH * 1e3 / med["bare"],
           "loop_overhead_ms": step_ms - med["bare"],
           "step_ms_without_prefetch_iter": med["plain"],
           "bare_cpu_ms": med["bare_cpu"], "fit_cpu_ms": med["prefetch_cpu"],
           "rounds_ms": times, "before_main_path_ms": before,
           "train_phase_step_ms": train_bf16["step_ms"],
           "host_gather_ms": (t1 - t0) * 1e3 / 4,
           "host_pin_ms": (t2 - t1) * 1e3 / 4,
           "checkpoint_max_abs_err": err}
    print(f"fit bf16 step_ms={step_ms:.3f} imgs_per_s="
          f"{res['imgs_per_s']:.1f} bare_step_ms={med['bare']:.3f} "
          f"bare_imgs_per_s={res['bare_imgs_per_s']:.1f} "
          f"loop_overhead_ms={res['loop_overhead_ms']:.3f} "
          f"step_ms_without_prefetch_iter={med['plain']:.3f} "
          f"bare_cpu_ms={med['bare_cpu']:.3f} "
          f"fit_cpu_ms={med['prefetch_cpu']:.3f} "
          f"train_phase_step_ms={train_bf16['step_ms']:.3f} "
          f"host_gather_ms={res['host_gather_ms']:.3f} "
          f"host_pin_ms={res['host_pin_ms']:.3f} gpu={gpu}", flush=True)
    for tag, t in (("after", times), ("before", before)):
        print(f"fit bf16 rounds_ms {tag} the main path " + json.dumps(
            {k: [round(v, 3) for v in vs] for k, vs in t.items()}),
            flush=True)
    it = io.DevicePrefetchIter(nd, device=dev)
    res.update(profile_fn(
        lambda: mod.fit(it, num_epoch=1), step_ms * n_train // BATCH,
        "fit bf16 epoch"))
    x, y = mod._place(images[:BATCH]), mod._place(labels[:BATCH], label=True)
    res.update({f"bare_{k}": v for k, v in profile_fn(
        lambda: [train_step(mod.state, x, y, loss_fn=mod._forward_loss)
                 for _ in range(2)], med["bare"] * 2,
        "fit bf16 bare 2 steps").items()})
    del mod, pred
    torch.cuda.empty_cache()
    return res


def _fit_rounds(mod, images, labels, dev, rounds: int,
                first_epoch: int) -> dict:
    """Rounds of: 6 bare ``train_step``s on ``mod`` (one batch, placed),
    3 epochs of ``mod.fit`` over ``images`` (2 steps an epoch) behind
    ``DevicePrefetchIter``, the same without it, 6 bare steps again; each
    fit after one epoch of warm-up.  ``{name: [ms a step]}`` by the host
    clock and (``*_cpu``) by the process's CPU time."""
    import torch
    from dt_tpu_torch.data import io
    from dt_tpu_torch.training.step import train_step
    x = mod._place(images[:BATCH])
    y = mod._place(labels[:BATCH], label=True)
    first = [first_epoch]  # the next epoch number, so each fit counts on
    steps = len(images) // BATCH

    def timed(fn, n):
        torch.cuda.synchronize()
        t0, c0 = time.perf_counter(), time.process_time()
        fn()
        torch.cuda.synchronize()
        return ((time.perf_counter() - t0) * 1e3 / n,
                (time.process_time() - c0) * 1e3 / n)

    def bare():
        for _ in range(6):
            train_step(mod.state, x, y, loss_fn=mod._forward_loss)

    def fit(it):
        mod.fit(it, num_epoch=first[0] + 1, begin_epoch=first[0])  # warm
        first[0] += 1
        out = timed(lambda: mod.fit(it, num_epoch=first[0] + 3,
                                    begin_epoch=first[0]), 3 * steps)
        first[0] += 3
        return out

    def nd():
        return io.NDArrayIter(images, labels, batch_size=BATCH, shuffle=True)

    times = {k: [] for k in ("bare", "prefetch", "plain", "bare_cpu",
                             "prefetch_cpu", "plain_cpu")}
    for _ in range(rounds):
        for name, fn in (("bare", lambda: timed(bare, 6)),
                         ("prefetch", lambda: fit(io.DevicePrefetchIter(
                             nd(), device=dev))),
                         ("plain", lambda: fit(nd())),
                         ("bare", lambda: timed(bare, 6))):
            wall, cpu = fn()
            times[name].append(wall)
            times[name + "_cpu"].append(cpu)
    return times


def fit_card_vs_cpu() -> dict:
    """A small f32 ``Module.fit`` (``resnet20``, 2 epochs of 64 seeded 8x8x3
    images, batch 32, SGD momentum, the port's own init) on the card and
    on the CPU: per-epoch train cross-entropy within ``TOL_FIT`` relative
    (f32 sums in another order; TF32 is off)."""
    from dt_tpu_torch import models
    from dt_tpu_torch.data import io
    from dt_tpu_torch.training.module import Module
    rng = np.random.RandomState(8)
    x = rng.uniform(-1, 1, (64, 8, 8, 3)).astype(np.float32)
    y = rng.randint(0, 10, 64).astype(np.int32)
    curves = {}
    for where in ("cuda", "cpu"):
        mod = Module(models.create("resnet20", device=where, num_classes=10),
                     optimizer="sgd", optimizer_params=dict(
                         learning_rate=0.1, momentum=0.9), device=where,
                     seed=1)
        per_epoch = []
        mod.fit(io.NDArrayIter(x, y, batch_size=32, shuffle=True),
                eval_metric="ce", num_epoch=2,
                epoch_end_callback=lambda e, s, m: per_epoch.append(
                    m.get()[1]))
        curves[where] = per_epoch
    rel = max(abs(a - b) / abs(b) for a, b in zip(curves["cuda"],
                                                    curves["cpu"]))
    print(f"fit card-vs-cpu f32 resnet20 ce_card={curves['cuda']} "
          f"ce_cpu={curves['cpu']} max_rel_err={rel:.3e} (tol {TOL_FIT})",
          flush=True)
    if not rel <= TOL_FIT:
        raise AssertionError(f"fit, card against CPU: {curves}")
    return {"max_rel_err": rel, **curves}


def elastic_phase(gpu) -> dict:
    """The main path of the elastic slice at full width: the port's
    ``Scheduler`` in this process with a host_worker file, two ResNet-50
    workers on ``cuda:0`` (bf16 on f32 params, 2-bit, overlapped step);
    the operator adds ``w2`` at the epoch-1 boundary (started beforehand,
    released by the launch callback; it bootstraps from rank 0's
    snapshot) and removes it at the epoch-2 boundary.  Gates: every
    process exits 0, the live workers' sha256 of params, stats and
    optimizer state agree at every epoch end, ``w2`` bootstraps after
    epoch 0 (at step ``ELASTIC_STEPS``), the audit log reads ADDED then
    REMOVED w2, finite losses, per step and worker 53 ``bn_stats``, 53
    ``bn_act``, 1 ``quantize_2bit``, 0 ``dequantize_2bit`` and
    ``PACKED_BYTES`` of packed words, and per epoch and worker a score of
    the validation images through ``fused_bn_inference`` (53 ``bn_act``
    a forward, no ``bn_stats``).  Prints, for each epoch's window (its
    steps after the first) on worker 0's clock, the wall time, ms a step
    and the fleet's images/s, the step's parts from worker 0's spans, the
    bare step, and MB on the wire a step (two or three processes share
    the card)."""
    import os
    import tempfile

    import torch_elastic_drift as drift
    from torch_elastic_job import write_hosts

    from dt_tpu_torch.elastic.scheduler import Scheduler
    tmp = tempfile.mkdtemp(prefix="dt_elastic_")
    hw = os.path.join(tmp, "host_worker")
    write_hosts(hw, ["w0", "w1"])
    go = os.path.join(tmp, "go_w2")
    stems = {h: os.path.join(tmp, h) for h in ("w0", "w1", "w2")}
    launched = []

    def operator(epoch):
        if epoch == 1:
            write_hosts(hw, ["w0", "w1", "w2"])
        elif epoch == 2:
            write_hosts(hw, ["w0", "w1"])

    def launch(host, epoch):
        launched.append((host, epoch))
        open(go, "w").close()

    sched = Scheduler(host_worker_file=hw, launch_callback=launch,
                      pre_change_hook=operator)
    procs = {}
    t0 = time.monotonic()
    try:
        env = {"DT_OBS": "1", "DT_OBS_RING": "65536"}
        for h in ("w0", "w1"):
            procs[h] = drift.spawn(
                sched.port, h, stems[h],
                ELASTIC_ARGS + ["--bare-steps", "6", "--profile-epoch", "2"],
                env)
        procs["w2"] = drift.spawn(  # no bare steps: w0, w1 still train
            sched.port, "w2", stems["w2"], ELASTIC_ARGS,
            dict(env, NEW_WORKER="1", EPOCH_BEGIN="1", DT_WAIT_FILE=go))
        drift.wait_all(procs, stems, t0 + ELASTIC_TIMEOUT)
    finally:
        sched.close()
    wall = time.monotonic() - t0
    r = {h: json.load(open(stems[h] + ".json")) for h in stems}
    audit = [ln.split()[1:3] for ln in open(hw + "_log")]
    print(f"elastic audit={audit} launched={launched} wall_s={wall:.1f}",
          flush=True)
    if audit != [["ADDED", "w2"], ["REMOVED", "w2"]] or \
            launched != [("w2", 1)]:
        raise AssertionError(f"elastic audit log {audit}, launched "
                             f"{launched}")
    if r["w2"]["bootstrap_step"] != ELASTIC_STEPS:
        raise AssertionError(f"w2 bootstrapped at step "
                             f"{r['w2']['bootstrap_step']}, expected "
                             f"{ELASTIC_STEPS}")
    by_epoch = {}
    for h, res in r.items():
        for e in res["epochs"]:
            by_epoch.setdefault(e["epoch"], {})[h] = e
    want_live = {0: {"w0", "w1"}, 1: {"w0", "w1", "w2"}, 2: {"w0", "w1"}}
    launches = {"bn_stats": 0, "bn_act": 0, "quantize_2bit": 0,
                "dequantize_2bit": 0, "score_bn_act": 0}
    score_want = {"bn_stats": 0, "bn_act": BN_PER_FORWARD *
                  ELASTIC_VAL_FORWARDS}
    for epoch, live in want_live.items():
        got = by_epoch.get(epoch, {})
        shas = {h: got[h]["sha256"][:16] for h in got}
        losses = {h: got[h]["loss"] for h in got}
        print(f"elastic epoch {epoch} workers={sorted(got)} sha256={shas} "
              f"train_ce={losses}", flush=True)
        if set(got) != live or len(set(shas.values())) != 1:
            raise AssertionError(f"epoch {epoch}: live {sorted(got)}, "
                                 f"digests {shas}")
        for h, e in got.items():
            n = e["steps"]
            la = e["launches"]
            want = {"bn_stats": BN_PER_FORWARD * n,
                    "bn_act": BN_PER_FORWARD * n, "quantize_2bit": n,
                    "dequantize_2bit": 0, "grad_bytes": PACKED_BYTES * n}
            got_la = {k: la[k] for k in want}
            if n != ELASTIC_STEPS or got_la != want or \
                    e["score_launches"] != score_want or \
                    not np.isfinite(e["loss"]):
                raise AssertionError(f"epoch {epoch} {h}: steps {n}, "
                                     f"launches {got_la} want {want}, "
                                     f"score {e['score_launches']} want "
                                     f"{score_want}, loss {e['loss']}")
            for k in want:
                if k in launches:
                    launches[k] += la[k]
            launches["score_bn_act"] += e["score_launches"]["bn_act"]
    w0 = r["w0"]
    spans = w0["spans"]
    k = ELASTIC_STEPS
    buckets = len(spans["pipeline.d2h"]) // max(len(spans["step"]), 1)
    if len(spans["step"]) != 3 * k or \
            len(spans["pipeline.d2h"]) != 3 * k * buckets:
        raise AssertionError(f"worker 0 recorded {len(spans['step'])} "
                             f"steps, {len(spans['pipeline.d2h'])} bucket "
                             f"copies; expected {3 * k} steps")
    windows = []
    for epoch, live in want_live.items():
        # the epoch's steps after its first (which carries the warm-up,
        # a joiner's first step or the first step after a removal)
        lo, hi = epoch * k + 1, epoch * k + k
        span = spans["step_start"][hi - 1] + spans["step"][hi - 1] - \
            spans["step_start"][lo]
        windows.append({"epoch": epoch, "workers": len(live),
                        "steps": hi - lo, "wall_ms": span,
                        "ms_a_step": span / (hi - lo),
                        "images_s": 64 * (hi - lo) / span * 1e3,
                        "step_ms": spans["step"][lo:hi]})
    # the parts, over epoch 0's window (two workers, not profiled)
    parts = {}
    for name in ("step.grad", "step.apply"):
        parts[name] = float(np.median(spans[name][1:k]))
    for name in ("pipeline.d2h", "pipeline.wire", "pipeline.h2d"):
        parts[name] = float(np.median(spans[name][buckets:k * buckets]))
    bare = float(np.median(w0["bare_step_ms"][1:]))
    last = w0["epochs"][-1]  # epoch 2, under torch.profiler
    busy, idle = last.get("device_busy_ms"), last.get("idle_share")
    # rank 1 publishes no snapshot: its frames are the step's own (the
    # packed words, the stats, barriers and heartbeats), up and down
    w1 = r["w1"]["epochs"]
    wire_mb = sum(e["launches"]["wire_bytes"] for e in w1) / \
        sum(e["steps"] for e in w1) / 1e6
    recv_mb = sum(e["launches"]["wire_recv_bytes"] for e in w1) / \
        sum(e["steps"] for e in w1) / 1e6
    out = {"step_ms": windows[0]["ms_a_step"], "windows": windows,
           "parts_ms": parts, "buckets_a_step": buckets,
           "bare_step_ms": bare, "wire_mb_a_step": wire_mb,
           "wire_recv_mb_a_step": recv_mb,
           "packed_mb_a_step": PACKED_BYTES / 1e6,
           "dense_mb_a_step": 4 * RESNET50_PARAMS / 1e6,
           "launches": launches, "wall_s": wall,
           "epoch2_device_busy_ms": busy, "epoch2_idle_share": idle,
           "epoch2_wall_ms": last["seconds"] * 1e3}
    for w in windows:
        print(f"elastic resnet50 bf16 2-bit overlap window: epoch "
              f"{w['epoch']} workers={w['workers']} steps={w['steps']} "
              f"wall_ms={w['wall_ms']:.3f} ms_a_step={w['ms_a_step']:.3f} "
              f"fleet_images_s={w['images_s']:.2f} step_ms="
              f"{json.dumps([round(t, 3) for t in w['step_ms']])} (worker "
              f"0's clock; {w['workers']} processes share one card"
              f"{', profiled' if w['epoch'] == 2 else ''}); gpu={gpu}",
              flush=True)
    print(f"elastic resnet50 bf16 2-bit overlap: parts_ms (epoch 0 window, "
          f"median each; d2h/wire/h2d per bucket, {buckets} buckets a "
          f"step)={json.dumps(parts)} bare_train_step_ms={bare:.3f} "
          f"w1_wire_mb_a_step sent={wire_mb:.3f} received={recv_mb:.3f} "
          f"packed_mb_a_step="
          f"{PACKED_BYTES / 1e6:.3f} (dense {4 * RESNET50_PARAMS / 1e6:.3f}) "
          f"launches={json.dumps(launches)} epoch2 (profiled, worker 0): "
          f"wall_ms={last['seconds'] * 1e3:.1f} device_busy_ms={busy} "
          f"idle_share={idle}; gpu={gpu}", flush=True)
    return out


def elastic_small_jobs(gpu) -> dict:
    """2-worker f32 resnet20 jobs (2 epochs of 2 steps) at 8x8 and at
    32x32 images, each against its own port ``Scheduler``, all at once:
    on the card with the overlapped step, its workers recording every step
    (``tests/torch_elastic_drift.py``); on the card with
    ``DT_AR_OVERLAP=0`` (serial); on the CPU.  Gates: every step of the
    card job replayed on the CPU from its recorded state within
    ``TOL_ELASTIC_LOSS`` (loss, stats, update, and the gradient where no
    ReLU mask flipped), the applied gradient and stats the workers' f32
    average bit for bit, the per-epoch loss within ``TOL_ELASTIC_LOSS`` of
    the replay's and of the CPU job's up to the first flipped step, and
    overlap against serial (cuDNN deterministic in both): the same sha256
    of params, stats and optimizer state at every epoch end."""
    import os
    import tempfile

    import torch_elastic_drift as drift
    from dt_tpu_torch.elastic.scheduler import Scheduler
    tmp = tempfile.mkdtemp(prefix="dt_elastic_small_")
    jobs = {"card": (["--deterministic"], {}),
            "serial": (["--deterministic"], {"DT_AR_OVERLAP": "0"}),
            "cpu": (["--device", "cpu"], {})}
    scheds, procs, stems = {}, {}, {}
    t0 = time.monotonic()
    try:
        for size in SMALL_SIZES:
            for tag, (extra, env) in jobs.items():
                sc = scheds[size, tag] = Scheduler(
                    initial_workers=["w0", "w1"])
                for h in ("w0", "w1"):
                    key = (size, tag, h)
                    stems[key] = os.path.join(tmp, f"{size}_{tag}_{h}")
                    procs[key] = drift.spawn(
                        sc.port, h, stems[key],
                        drift.job_args(size, 128, 64) + extra, env,
                        dump=tag == "card")
        drift.wait_all(procs, stems, t0 + 300)
    finally:
        for sc in scheds.values():
            sc.close()
    out = {}
    for size in SMALL_SIZES:
        r = {tag: {h: drift.load(stems[size, tag, h], dump=tag == "card")
                   for h in ("w0", "w1")} for tag in jobs}
        summary, failures = drift.hold_card_job(r["card"], r["cpu"],
                                                TOL_ELASTIC_LOSS)
        shas = {tag: [e["sha256"] for e in r[tag]["w0"][0]["epochs"]]
                for tag in ("card", "serial")}
        same = shas["card"] == shas["serial"] == \
            [e["sha256"] for e in r["card"]["w1"][0]["epochs"]]
        for e in summary["epochs"]:
            print(f"elastic card-vs-cpu f32 resnet20 {size}x{size} "
                  f"{json.dumps(e)}", flush=True)
        print(f"elastic card-vs-cpu f32 resnet20 {size}x{size}: replay worst "
              f"(rel) {json.dumps(summary['replay_worst'])} applied_is_mean="
              f"{summary['applied_is_mean']} relu_flipped_steps="
              f"{summary['flipped_steps']} (tol {TOL_ELASTIC_LOSS}); overlap "
              f"vs serial on the card bit-identical={same} wall_s="
              f"{time.monotonic() - t0:.1f} gpu={gpu}", flush=True)
        if failures:
            raise AssertionError(f"elastic job {size}x{size}, card against "
                                 f"CPU: {failures}")
        if not same:
            raise AssertionError(f"overlap against serial: {shas}")
        out[size] = dict(summary, overlap_bit_identical=same)
    return out


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
    sys.path.insert(0, str(ROOT / "tests"))  # the elastic job's helpers
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
    # the elastic phase's three workers train at a per-worker batch of 21
    shapes21 = bn_shapes(model, torch.zeros(21, 224, 224, 3, device=dev)
                         .permute(0, 3, 1, 2))
    if sum(shapes.values()) != BN_PER_FORWARD or \
            sum(shapes21.values()) != BN_PER_FORWARD:
        raise AssertionError(f"{sum(shapes.values())}, "
                             f"{sum(shapes21.values())} BatchNorms in one "
                             f"forward, expected {BN_PER_FORWARD}")
    summary = kernel_phase(shapes, dev, also=list(shapes21))
    print(f"phase kernels done at {time.perf_counter() - t0:.1f} s",
          flush=True)

    # --- training kernels -----------------------------------------------
    n_params = sum(p.numel() for p in model.parameters())
    del model, x32
    train_kernels = bn_train_phase(shapes, dev, also=list(shapes21))
    codec = codec_phase(n_params, dev)
    print(f"phase training kernels done at {time.perf_counter() - t0:.1f} s",
          flush=True)

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
    print(f"phase serve done at {time.perf_counter() - t0:.1f} s", flush=True)

    # --- train ----------------------------------------------------------
    trained = train_phase(variables, dev, gpu)
    step_card_vs_cpu(variables, dev)
    print(f"phase train done at {time.perf_counter() - t0:.1f} s", flush=True)

    # --- Module.fit -----------------------------------------------------
    fitted = fit_phase(dev, gpu, trained["bf16"])
    fit_cmp = fit_card_vs_cpu()
    print(f"phase fit done at {time.perf_counter() - t0:.1f} s", flush=True)

    # --- the elastic host-sync job --------------------------------------
    torch.cuda.empty_cache()  # the workers are other processes on the card
    elastic = elastic_phase(gpu)
    elastic_small_jobs(gpu)
    print(f"phase elastic done at {time.perf_counter() - t0:.1f} s",
          flush=True)

    # --- LM kernels -----------------------------------------------------
    flash = flash_phase(dev)
    lstm = lstm_phase(dev)
    layer = lstm_layer_phase(dev)
    print(f"phase LM kernels done at {time.perf_counter() - t0:.1f} s",
          flush=True)

    # --- LM training ----------------------------------------------------
    lm_trained = lm_train_phase(dev, gpu)
    lstm_trained = lstm_train_phase(dev, gpu)
    lm_steps = lm_steps_card_vs_cpu()
    lstm_bf16 = lstm_bf16_forward(dev)
    print(f"phase LM train done at {time.perf_counter() - t0:.1f} s",
          flush=True)

    kernels = []
    fit_counts = fitted["launches"]
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
        if dtype == torch.bfloat16:  # fit's eval forwards (bn_act alone)
            kernels[-1]["fit_launches"] = (fit_counts["bn_act"]
                                           - fit_counts["bn_stats"])
            # the elastic job's scores (every live worker, every epoch)
            kernels[-1]["elastic_launches"] = \
                elastic["launches"]["score_bn_act"]
    train_launches = {
        torch.float32: trained["f32"]["launches"]["bn_stats"],
        torch.bfloat16: trained["bf16"]["launches"]["bn_stats"]
        + trained["bf16_2bit"]["launches"]["bn_stats"]}
    for dtype, tot in train_kernels.items():
        # one fused_bn_train call = pass 1 (bn_train.cu) + pass 2
        # (bn_act.cu); times, bound and plain are the two passes' sums
        name = str(dtype).split(".")[-1]
        kernels.append({
            "name": f"fused_bn_train[{name}]",
            "route": "cuda",
            "source": "dt_tpu_torch/csrc/bn_train.cu",
            "replaces": "dt_tpu/ops/pallas/kernels.py:101",
            "launches": train_launches[dtype],
            "max_abs_err": tot["max_abs_err"],
            "ms": tot["ms"], "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"], "bound_by": "bytes",
            "library_ms": tot["library_ms"],
            "redesigned_in": 4, "pass1_ms": tot["pass1_ms"],
            "pass1_bound_ms": tot["pass1_bound_ms"],
            "pass1_kernels_a_call": tot["kernels_a_call"]})
        if dtype == torch.bfloat16:  # every BN of every fit step
            kernels[-1]["fit_launches"] = fit_counts["bn_stats"]
            kernels[-1]["elastic_launches"] = \
                elastic["launches"]["bn_stats"]
    for name, line in (("quantize_2bit", 233), ("dequantize_2bit", 284)):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "dt_tpu_torch/csrc/quant2.cu",
            "replaces": f"dt_tpu/ops/pallas/kernels.py:{line}",
            "launches": trained["bf16_2bit"]["launches"][name],
            "max_abs_err": codec[name]["max_abs_err"],
            "ms": codec[name]["ms"], "plain_ms": codec[name]["plain_ms"],
            "bound_ms": codec[name]["bound_ms"], "bound_by": "bytes",
            "library_ms": None,
            "elastic_launches": elastic["launches"][name]})
    fb = flash["lm", "bfloat16"]
    kernels.append({
        "name": "flash_attention[bfloat16]", "route": "cuda",
        "source": "dt_tpu_torch/csrc/flash_attn.cu",
        "replaces": "dt_tpu/ops/pallas/attention.py:40",
        "launches": lm_trained["launches"]["flash_attention"],
        "max_abs_err": fb["max_abs_err"], "ms": fb["ms"],
        "plain_ms": fb["plain_ms"], "bound_ms": fb["bound_ms"],
        "bound_by": "operations", "library_ms": fb["library_ms"],
        "redesigned_in": 4, "path": "lm_train bf16",
        "more": {c: r for (c, n), r in flash.items()
                 if n == "bfloat16" and c != "lm"}})
    ff = flash["lm", "float32"]
    kernels.append({
        "name": "flash_attention[float32]", "route": "cuda",
        "source": "dt_tpu_torch/csrc/flash_attn.cu",
        "replaces": "dt_tpu/ops/pallas/attention.py:40",
        "launches": lm_steps["transformer_lm"]["flash_attention"],
        "max_abs_err": ff["max_abs_err"], "ms": ff["ms"],
        "plain_ms": ff["plain_ms"], "bound_ms": ff["bound_ms"],
        "bound_by": "operations", "library_ms": ff["library_ms"],
        "bound_3xtf32_ms": ff["bound_3xtf32_ms"], "redesigned_in": 5,
        "path": "lm step f32 transformer_lm",
        "more": {c: r for (c, n), r in flash.items()
                 if n == "float32" and c != "lm"}})
    lp = lstm[200]
    kernels.append({
        "name": "lstm_pointwise", "route": "cuda",
        "source": "dt_tpu_torch/csrc/lstm_point.cu",
        "replaces": "dt_tpu/ops/pallas/kernels.py:319",
        "launches": lstm_bf16["launches"]["lstm_pointwise"],
        "max_abs_err": lp["max_abs_err"], "ms": lp["ms"],
        "plain_ms": lp["plain_ms"], "bound_ms": lp["bound_ms"],
        "bound_by": "bytes", "library_ms": lp["library_ms"],
        "path": "lstm_forward bf16",
        "main_path_launches": lstm_trained["launches"]["lstm_pointwise"],
        "shape": [PTB_BATCH, 200], "h650": lstm[650]})
    ll = layer[200]
    kernels.append({
        "name": "lstm_layer", "route": "cuda",
        "source": "dt_tpu_torch/csrc/lstm_layer.cu",
        "replaces": "dt_tpu/ops/pallas/kernels.py:319",
        "launches": lstm_trained["launches"]["lstm_layer"],
        "max_abs_err": ll["max_abs_err"], "ms": ll["ms"],
        "plain_ms": ll["plain_ms"], "bound_ms": ll["bound_ms"],
        "bound_by": "operations", "library_ms": ll["library_ms"],
        "redesigned_in": 5, "path": "lstm_train f32",
        "layer_ms": ll["layer_ms"], "per_step_ms": ll["per_step_ms"],
        "serial_floor_ms": ll["serial_floor_ms"],
        "shape": ll["shape"], "h650": layer[650]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"gpu: {gpu_line()}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
