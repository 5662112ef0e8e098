"""Phases 14 (failover), 17 (policy) and 25 (detection) of
``chip_smoke.py``, alone and repeated, on the card: a flaky phase's rate of
failure, or a changed phase's result, without the rest of the script.

Run on a machine with an NVIDIA GPU, from the repository's root::

    python tests/torch_chip_phases.py --failover 5 --policy 3 --detection 1

Phase 11 runs once first when phase 14 is asked for (phase 14 holds its
digests against phase 11's).  Each run's failure is caught, its traceback
printed, and the next run starts; the last line sums them up.  Exits 1 if
any run failed.
"""

import argparse
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from dt_tpu_torch.ops import _build  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--failover", type=int, default=0)
    ap.add_argument("--policy", type=int, default=0)
    ap.add_argument("--detection", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_chip_phases: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    _build.build_all()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gpu = cs.gpu_line()
    print(f"gpu: {gpu}", flush=True)
    t0 = time.perf_counter()
    runs = {"failover": [], "policy": [], "detection": []}
    elastic = cs.elastic_phase(gpu) if args.failover else None
    for phase, n in (("failover", args.failover), ("policy", args.policy),
                     ("detection", args.detection)):
        for i in range(n):
            t = time.perf_counter()
            try:
                if phase == "failover":
                    r = cs.failover_phase(gpu, elastic)
                    got = {"stall_ms": r["stall"]["stall_ms"]}
                elif phase == "detection":
                    r = cs.detection_phase(gpu, torch.device("cuda"))
                    nk = r["detect"]["ssd", torch.bfloat16]["nms"]
                    got = {k: nk[k] for k in ("ms", "kernels_a_call",
                                              "peak_bytes_a_call")}
                else:
                    r = cs.policy_phase(gpu)
                    got = {"gain_ms": r["gain_ms"],
                           "recovery": r["recovery"], "stall": r["stall"]}
                runs[phase].append({"ok": True, **got})
            except Exception as e:  # noqa: BLE001 — the next run goes on
                traceback.print_exc()
                runs[phase].append({"ok": False, "error": repr(e)[:400]})
            runs[phase][-1]["s"] = round(time.perf_counter() - t, 1)
            print(f"{phase} run {i + 1}: {runs[phase][-1]}", flush=True)
    print(f"summary {runs} total_s={time.perf_counter() - t0:.1f} "
          f"gpu={gpu}", flush=True)
    return 0 if all(r["ok"] for v in runs.values() for r in v) else 1


if __name__ == "__main__":
    sys.exit(main())
