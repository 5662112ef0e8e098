"""The int8 convolution kernel against its earlier version, on the card.

``chip_smoke.py`` phase 26 (a) prints each shape's time beside the earlier
``mma.sync`` kernel's (``QCONV_MMA_SYNC_MS``); this script measures both in
one process on one card, in turns (earlier, this tree, this tree, earlier;
the least of each pair kept), at every distinct convolution of ResNet-50
v1 (224x224, batch 32, phase 26 (a)'s shapes and codes) and the quantize
example's three dense calls, and then ResNet's stem on its planned route
beside the gather route on x padded to 16 channels.  Each is held
bit-equal to ``qconv_plain`` first.  The earlier source
(``csrc/qconv.cu`` and ``csrc/common.cuh`` at commit 0721b42:
``mma.sync`` m16n8k32 on 128 x 64 tiles, HWIO read directly) is built
from a directory given on the command line; unpack it from the
repository's history first::

    mkdir -p build/qconv_mma_sync && git archive 0721b42 dt_tpu_torch/csrc \\
        | tar -x --strip-components=2 -C build/qconv_mma_sync
    python tests/torch_qconv_ab.py build/qconv_mma_sync [out.json]

Run on a machine with an NVIDIA GPU from the repository's root.  Prints a
JSON line a shape and the sums over one forward, and writes them to
``out.json`` where one is named.
"""

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dt_tpu_torch.ops import _build, kernels  # noqa: E402

_V, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def old_library(src: Path) -> ctypes.CDLL:
    """The earlier ``dt_qconv`` (x, HWIO w, bias, divisor, out; batch, H, W,
    C; kh, kw, N, OH, OW, sh, sw, pad top, pad left, dtype; stream)."""
    lib = ROOT / "build" / "qconv_mma_sync.so"
    lib.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src / "qconv.cu")], check=True)
    so = ctypes.CDLL(str(lib))
    so.dt_qconv.argtypes = [_V] * 5 + [_I64] * 4 + [_INT] * 10 + [_V]
    so.dt_qconv.restype = ctypes.c_int
    return so


def old_call(so, wq, stride, pads, d):
    kh, kw, c, n = wq.shape

    def run(xq):
        b, h, w = xq.shape[:3]
        oh, ow = kernels.qconv_out_hw((h, w), (kh, kw), stride, pads)
        out = torch.empty((b, oh, ow, n), device=xq.device)
        err = so.dt_qconv(xq.data_ptr(), wq.data_ptr(), 0, d.data_ptr(),
                          out.data_ptr(), b, h, w, c, kh, kw, n, oh, ow,
                          stride[0], stride[1], pads[0][0], pads[1][0], 0,
                          torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the earlier dt_qconv: error {err}")
        return out
    return run


def stem_routes(case) -> dict:
    """ResNet's stem (C 3) on the route :func:`kernels.qconv_plan` picks and
    on the gather route (x padded to 16 channels inside the call, the
    filter's taps unpadded), in turns (plan, gather, gather, plan; the
    least of each pair), each held bit-equal to ``qconv_plain`` first."""
    tag, _, xq, wq, xs, ws, stride, pads, _ = case
    d = (xs * ws).to(xq.device)
    want = kernels.qconv_plain(xq, wq, stride, pads, d)
    real = kernels.qconv_plan

    def gather_plan(x_shape, w_shape, *rest):
        p = real(x_shape, w_shape, *rest)
        return p._replace(route="gather", cp=-(-w_shape[2] // 16) * 16,
                          kwp=w_shape[1])

    def run(route):
        def call(a):
            if route == "gather":
                kernels.qconv_plan = gather_plan
            try:
                return kernels.qconv(a, wq, stride, pads, d)
            finally:
                kernels.qconv_plan = real
        return call

    plan = real(tuple(xq.shape), tuple(wq.shape), stride, pads,
                torch.float32)
    fns = {"plan": run("plan"), "gather": run("gather")}
    equal = {k: bool(torch.equal(f(xq), want)) for k, f in fns.items()}
    copies = [xq] + [xq.clone() for _ in range(
        min(7, (60 << 20) // max(xq.numel(), 1)))]
    ms = {"plan": [], "gather": []}
    for who in ("plan", "gather", "gather", "plan"):
        ms[who].append(cs.cuda_ms(fns[who], copies))
    return {"tag": f"{tag} stem routes", "plan_route": plan.route,
            "equal": equal, **{k: min(v) for k, v in ms.items()},
            "runs": ms}


def main() -> int:
    if len(sys.argv) not in (2, 3) or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    _build.build_all()
    so = old_library(Path(sys.argv[1]))
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gpu = cs.gpu_line()
    print(f"gpu: {gpu}", flush=True)
    from dt_tpu_torch import models
    variables = cs.seeded_variables(models.create("resnet50", device=dev),
                                    seed=0)
    images = np.random.RandomState(1).uniform(
        -1, 1, (cs.BATCH, 224, 224, 3)).astype(np.float32)
    cases = cs._resnet_qconv_cases(dev, variables, images)
    for i, (args, _) in enumerate(cs._quant_mlp(dev, gpu)["calls"]):
        xq, wq, xs, ws = args[:4]
        cases.append((f"mlp{i}", 1, xq.reshape(*xq.shape[:1], 1, 1, -1),
                      wq.reshape(1, 1, *wq.shape), xs, ws, (1, 1),
                      ((0, 0), (0, 0)), None))
    rows = []
    for tag, calls, xq, wq, xs, ws, stride, pads, _ in cases:
        d = (xs * ws).to(dev)
        want = kernels.qconv_plain(xq, wq, stride, pads, d)
        fns = {"mma_sync": old_call(so, wq, stride, pads, d),
               "now": lambda a, wq=wq, stride=stride, pads=pads, d=d:
               kernels.qconv(a, wq, stride, pads, d)}
        equal = {k: bool(torch.equal(f(xq), want)) for k, f in fns.items()}
        copies = [xq] + [xq.clone() for _ in range(
            min(7, (60 << 20) // max(xq.numel(), 1)))]
        ms = {"mma_sync": [], "now": []}
        for who in ("mma_sync", "now", "now", "mma_sync"):
            ms[who].append(cs.cuda_ms(fns[who], copies))
        plan = kernels.qconv_plan(tuple(xq.shape), tuple(wq.shape), stride,
                                  pads, torch.float32)
        row = {"tag": tag, "key": cs._qconv_shape_key(xq, wq, stride),
               "calls": calls, "route": plan.route, "bn": plan.bn,
               "equal": equal, **{k: min(v) for k, v in ms.items()},
               "runs": ms}
        rows.append(row)
        print(json.dumps(row), flush=True)
    stem = stem_routes(cases[0])
    print(json.dumps(stem), flush=True)
    ok_stem = all(stem["equal"].values())
    resnet = [r for r in rows if not r["tag"].startswith("mlp")]
    sums = {who: sum(r[who] * r["calls"] for r in resnet)
            for who in ("mma_sync", "now")}
    mlp = {who: sum(r[who] for r in rows if r["tag"].startswith("mlp"))
           for who in ("mma_sync", "now")}
    ok = all(all(r["equal"].values()) for r in rows) and ok_stem
    print(f"resnet50 int8 forward: mma.sync {sums['mma_sync']:.4f} ms, now "
          f"{sums['now']:.4f} ms; the MLP's 3 calls: mma.sync "
          f"{mlp['mma_sync']:.4f} ms, now {mlp['now']:.4f} ms; all "
          f"bit-equal {ok}; "
          f"{time.perf_counter() - t0:.1f} s gpu={gpu}", flush=True)
    if len(sys.argv) == 3:
        Path(sys.argv[2]).write_text(json.dumps(
            {"gpu": gpu, "rows": rows, "stem": stem, "resnet50": sums,
             "mlp": mlp},
            indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
