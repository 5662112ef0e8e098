"""Build the CUDA sources in ``dt_tpu_torch/csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for Hopper (``sm_90a``) and loaded with
``ctypes``; nothing includes PyTorch's headers, so a build takes seconds.
Libraries go under ``build/dt_tpu_torch/`` beside the package, named by a
hash of the sources and flags, and are written under a temporary name and
renamed, so a stale or half-written library is never loaded.  A failed build
raises with nvcc's output; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dt_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def sources() -> List[str]:
    """The kernel sources, one library each (``bn_act`` for ``bn_act.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def library_path(name: str) -> Path:
    """Where ``name``'s library lives, keyed by its sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or shutil.which(
        os.path.join(cuda_home, "bin", "nvcc"))
    if found is None:
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           f"{cuda_home}/bin); the CUDA kernels cannot be "
                           "built")
    return found


def build_all() -> Dict[str, float]:
    """Build every source that has no library yet, one ``nvcc`` per source,
    all started together.  Returns the seconds each build took."""
    todo = [n for n in sources() if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in todo:
        tmp = f"{library_path(name)}.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    took, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            Path(tmp).unlink(missing_ok=True)
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n"
                          f"{out}")
            continue
        os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return took


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    if not library_path(name).exists():
        build_all()
    return ctypes.CDLL(str(library_path(name)))
