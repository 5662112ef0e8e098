"""Helpers of the port's elastic job tests: start worker processes of
either package against a scheduler, start the port's scheduler as a
process of its own (an HA primary or standby), wait for them with a time
limit, and read their results.  Imports neither JAX nor the JAX
package."""

import contextlib
import json
import os
import signal
import subprocess
import sys
import time

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
    # one OpenMP thread a worker: the tests run several processes at once
    env.setdefault("OMP_NUM_THREADS", "1")
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


def start_scheduler(tmp, name, args=(), env=None, timeout=60):
    """``python -m dt_tpu_torch.elastic.scheduler_main`` with ``args``; waits
    for its port file.  Returns ``(process, port)``; its log is
    ``<tmp>/<name>.log``."""
    port_file = os.path.join(tmp, name + ".port")
    log_path = os.path.join(tmp, name + ".log")
    penv = dict(os.environ)
    penv.pop("XLA_FLAGS", None)
    penv["PYTHONPATH"] = os.path.dirname(HERE)
    penv.setdefault("OMP_NUM_THREADS", "1")
    penv.update(env or {})
    with open(log_path, "w") as log:
        proc = subprocess.Popen(
            [sys.executable, "-m", "dt_tpu_torch.elastic.scheduler_main",
             "--port-file", port_file] + list(args),
            cwd=os.path.dirname(HERE), env=penv, stdout=log,
            stderr=subprocess.STDOUT)
    deadline = time.monotonic() + timeout
    while not os.path.exists(port_file):
        if proc.poll() is not None or time.monotonic() > deadline:
            proc.kill()
            with open(log_path) as f:
                raise AssertionError(f"scheduler {name} did not come up:\n"
                                     f"{f.read()[-3000:]}")
        time.sleep(0.02)
    with open(port_file) as f:
        return proc, int(f.read())


def stop_scheduler(proc, port, timeout=10):
    """The ``shutdown`` command (the process closes the connection
    unanswered), then SIGKILL if it is still up after ``timeout``."""
    from dt_tpu_torch.elastic import protocol
    if proc.poll() is None:
        try:
            protocol.request("127.0.0.1", port, {"cmd": "shutdown"},
                             timeout=5)
        except (OSError, RuntimeError):
            pass
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=30)


def read_step(path):
    """The global step a worker's ``--progress`` file holds (0 before
    the first batch)."""
    try:
        with open(path) as f:
            return int(f.read() or 0)
    except (OSError, ValueError):
        return 0


def policy_drill_log(engine, rescale, global_batch=64, epochs=4):
    """The policy drill's decision log as the scheduler journals it
    (``ControlState.policy_log`` rows), and each epoch's per-worker
    batches: base workers ``w0`` and ``w2``, ``w1`` added to the host file
    for the epoch-1 barrier, ``w1`` breaching at every barrier after an
    epoch it trained and nobody else ever breaching.  ``engine`` is either
    package's ``PolicyEngine``, ``rescale`` its ``policy.rescale``; the
    barrier's order is the scheduler's: decide on the board, the diff
    (evictions first, else the add), shares over the final workers."""
    workers, base = ["w0", "w2"], {"w0", "w2"}
    streaks, shares, log, batches = {}, {}, [], []
    hot = engine.threshold_ms + 1.0
    for epoch in range(epochs):
        scores = {} if epoch == 0 else \
            {h: hot if h == "w1" else 0.0 for h in workers}
        d = engine.decide(epoch, workers, base, streaks, scores)
        if d.evict:
            workers = [h for h in workers if h not in d.evict]
        elif epoch == 1:
            workers = workers + ["w1"]
        new_streaks = {h: s for h, s in d.streaks.items() if h in workers}
        new_shares = engine.shares(workers, new_streaks)
        last_props = log[-1]["proposals"] if log else []
        if new_shares != shares or new_streaks != streaks or d.evict or \
                list(d.proposals) != list(last_props):
            streaks = dict(sorted(new_streaks.items()))
            shares = dict(sorted(new_shares.items()))
            log.append({"seq": len(log) + 1, "epoch": epoch,
                        "breached": sorted(d.breached),
                        "streaks": dict(streaks), "shares": dict(shares),
                        "lr_scale": float(d.lr_scale),
                        "evicted": sorted(d.evict),
                        "proposals": list(d.proposals)})
        batches.append(rescale.batch_map(shares, workers, global_batch))
    return log, batches


@contextlib.contextmanager
def deadline(seconds):
    """A test's own time limit: past ``seconds`` a ``TimeoutError`` is
    raised in the main thread (a blocked socket read included), so a hung
    lease, standby or worker fails its test instead of the whole run."""
    def _expire(signum, frame):
        raise TimeoutError(f"the test ran past its {seconds} s limit")

    old = signal.signal(signal.SIGALRM, _expire)
    signal.alarm(int(seconds))
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
