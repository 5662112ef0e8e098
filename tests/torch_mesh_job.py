"""Helpers of the port's mesh tests: a free port for the store, a fixed
world of ``tests/torch_mesh_worker.py`` processes, and the elastic mesh job
(2 -> 3 -> 2 workers against the port's scheduler), each with a time
limit.  Imports neither JAX nor the JAX package."""

import json
import os
import socket
import subprocess
import sys
import time

from torch_elastic_job import write_hosts

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER = os.path.join(HERE, "torch_mesh_worker.py")
#: a worker's environment: one OpenMP thread, the elastic contract on
ENV = {"OMP_NUM_THREADS": "1", "ELASTIC_TRAINING_ENABLED": "1"}


def free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _env(extra=None):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.update(ENV)
    env.update(extra or {})
    return env


def _wait(procs, logs, deadline):
    """Wait for every process until ``deadline`` (monotonic); kill all and
    raise with the logs' tails if one fails or time runs out."""
    try:
        for h, p in procs.items():
            left = max(deadline - time.monotonic(), 0.1)
            try:
                rc = p.wait(timeout=left)
            except subprocess.TimeoutExpired:
                raise AssertionError(f"{h} did not finish in time")
            if rc != 0:
                raise AssertionError(f"{h} exited {rc}")
    except AssertionError as e:
        tails = "\n".join(f"--- {h}:\n{open(logs[h]).read()[-2500:]}"
                          for h in procs)
        raise AssertionError(f"{e}\n{tails}") from None
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)


def run_world(tmp, world, args, timeout=120, env=None):
    """``world`` processes of the fixed-world worker (``--world`` and
    ``--rank`` added, a fresh coordinator); returns each rank's JSON
    lines of stdout, parsed."""
    coord = f"127.0.0.1:{free_port()}"
    procs, logs = {}, {}
    for r in range(world):
        logs[r] = os.path.join(tmp, f"rank{r}.log")
        procs[r] = subprocess.Popen(
            [sys.executable, WORKER, "--world", str(world), "--rank", str(r),
             "--coordinator", coord] + list(args),
            env=_env(env), stdout=open(logs[r], "w"),
            stderr=subprocess.STDOUT)
    _wait(procs, logs, time.monotonic() + timeout)
    return [[json.loads(ln) for ln in open(logs[r]).read().splitlines()
             if ln.startswith("{")] for r in range(world)]


def elastic_job(tmp, args, timeout=180, env=None):
    """The elastic mesh job: the port's ``Scheduler`` in this process with
    a host_worker file; ``w0`` and ``w1`` start, the operator adds ``w2``
    at the epoch-1 boundary (started beforehand, released by the launch
    callback; it bootstraps from rank 0's snapshot) and removes it at the
    epoch-2 boundary.  ``args`` follow the worker's own.  Returns
    ``(results by host, audit lines, launched, wall seconds)``."""
    from dt_tpu_torch.elastic.scheduler import Scheduler
    hw = os.path.join(tmp, "host_worker")
    write_hosts(hw, ["w0", "w1"])
    go = os.path.join(tmp, "go_w2")
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
    base = [sys.executable, WORKER, "--scheduler-port", str(sched.port),
            "--coordinator", f"127.0.0.1:{free_port()}"] + list(args)
    procs, logs = {}, {}
    t0 = time.monotonic()
    try:
        for h in ("w0", "w1", "w2"):
            extra = dict(env or {})
            if h == "w2":
                extra.update(NEW_WORKER="1", EPOCH_BEGIN="1",
                             DT_WAIT_FILE=go)
            logs[h] = os.path.join(tmp, f"{h}.log")
            procs[h] = subprocess.Popen(
                base + ["--host", h, "--out", os.path.join(tmp, f"{h}.json")],
                env=_env(extra), stdout=open(logs[h], "w"),
                stderr=subprocess.STDOUT)
        _wait(procs, logs, t0 + timeout)
    finally:
        sched.close()
    wall = time.monotonic() - t0
    results = {h: json.load(open(os.path.join(tmp, f"{h}.json")))
               for h in procs}
    with open(hw + "_log") as f:
        audit = [ln.split()[1:3] for ln in f if ln.strip()]
    return results, audit, launched, wall
