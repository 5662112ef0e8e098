"""Helpers of the port's elastic job tests: start worker processes of
either package against a scheduler, wait for them with a time limit, and
read their results.  Imports neither JAX nor the JAX package."""

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
PORT_WORKER = os.path.join(HERE, "torch_elastic_worker.py")
JAX_WORKER = os.path.join(HERE, "elastic_worker.py")


def write_hosts(path, hosts):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write("\n".join(hosts) + "\n")
    os.replace(tmp, path)


def spawn(kind, port, host, out, num_epoch, extra_env=None, args=(),
          device="cpu"):
    """Start one worker: ``kind`` is ``"jax"`` (``elastic_worker.py``) or
    ``"port"`` (``torch_elastic_worker.py`` on ``device``)."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["ELASTIC_TRAINING_ENABLED"] = "1"
    env.update(extra_env or {})
    cmd = [sys.executable, JAX_WORKER if kind == "jax" else PORT_WORKER,
           "--scheduler-port", str(port), "--host", host,
           "--num-epoch", str(num_epoch), "--out", out]
    if kind == "port":
        cmd += ["--device", device]
    return subprocess.Popen(cmd + list(args), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def wait_ok(procs, timeout=120):
    """Wait for every process (each at most ``timeout`` s); assert exit 0
    with the tail of its output otherwise."""
    for h, p in list(procs.items()):
        try:
            rc = p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            p.kill()
            raise AssertionError(f"{h} did not finish in {timeout} s:\n"
                                 f"{p.stdout.read().decode()[-3000:]}")
        assert rc == 0, f"{h} rc={rc}:\n{p.stdout.read().decode()[-3000:]}"


def kill_all(procs):
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.wait(timeout=10)


def load(path):
    with open(path) as f:
        return json.load(f)


def audit(hw):
    """``(action, host)`` of each ``<host_worker>_log`` line."""
    with open(hw + "_log") as f:
        return [tuple(ln.split()[1:3]) for ln in f if ln.strip()]
