"""A mixed fleet against the JAX package's unmodified ``Scheduler``: a JAX
worker ``w0`` (rank 0, ``tests/elastic_worker.py``) and a port worker
``w1`` started from the JAX worker's initial variables train one job; a
port joiner ``w2`` is added at the epoch-2 boundary, bootstraps from the
JAX worker's snapshot, and is removed at the epoch-4 boundary.  The
scheduler receives no ``torch`` object."""

import importlib.util
import os

import pytest

import torch_elastic_job as job
from dt_tpu.elastic import Scheduler

#: how close the JAX and port workers' params end (relative): both apply
#: the same averaged gradient each step, so the only difference is the
#: two SGD implementations' rounding
TOL = 1e-5


def jax_worker_module():
    """``tests/elastic_worker.py`` as a module (its ``TinyBNNet`` and
    dataset), for the tests that run the JAX side."""
    spec = importlib.util.spec_from_file_location("_jax_elastic_worker",
                                                  job.JAX_WORKER)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def save_jax_init(path, seed=7):
    """The JAX harness's initial ``TinyBNNet`` variables (its ``Module``
    draws them from ``PRNGKey(seed)``) as an npz of
    ``<collection>/<path>`` arrays, for ``torch_elastic_worker.py
    --init-npz``."""
    import jax
    import numpy as np
    ew = jax_worker_module()
    x, _ = ew.make_dataset()
    variables = ew.TinyBNNet.create().init(
        {"params": jax.random.PRNGKey(seed),
         "dropout": jax.random.PRNGKey(seed + 1)}, x[:16], training=False)
    flat = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict) or hasattr(v, "items"):
                walk(v, f"{prefix}{k}/")
            else:
                flat[prefix + k] = np.asarray(v)

    walk({k: dict(v) for k, v in variables.items()}, "")
    np.savez(path, **flat)


def _torch_objects(obj, path="msg"):
    if isinstance(obj, dict):
        return [p for k, v in obj.items()
                for p in _torch_objects(v, f"{path}/{k}")]
    if isinstance(obj, (list, tuple)):
        return [p for i, v in enumerate(obj)
                for p in _torch_objects(v, f"{path}/{i}")]
    return [path] if type(obj).__module__.split(".")[0] == "torch" else []


def test_jax_and_port_workers_share_the_reference_scheduler(tmp_path):
    hw = str(tmp_path / "host_worker")
    job.write_hosts(hw, ["w0", "w1"])
    outs = {h: str(tmp_path / f"{h}.json") for h in ("w0", "w1", "w2")}
    npz = str(tmp_path / "init.npz")
    save_jax_init(npz)
    procs = {}
    num_epoch = 6

    def launch(host, epoch):
        procs[host] = job.spawn("port", sched.port, host, outs[host],
                                num_epoch, {"NEW_WORKER": "1",
                                            "EPOCH_BEGIN": str(epoch)})

    def operator(epoch):
        if epoch == 2:
            job.write_hosts(hw, ["w0", "w1", "w2"])
        elif epoch == 4:
            job.write_hosts(hw, ["w0", "w1"])

    sched = Scheduler(host_worker_file=hw, launch_callback=launch,
                      pre_change_hook=operator)
    seen = []
    dispatch = sched._dispatch

    def spy(msg):
        seen.extend(_torch_objects(msg))
        return dispatch(msg)

    sched._dispatch = spy
    try:
        procs["w0"] = job.spawn("jax", sched.port, "w0", outs["w0"],
                                num_epoch)
        procs["w1"] = job.spawn("port", sched.port, "w1", outs["w1"],
                                num_epoch, args=("--init-npz", npz))
        job.wait_ok({h: procs[h] for h in ("w0", "w1")})
        assert "w2" in procs, "the scheduler never launched w2"
        job.wait_ok({"w2": procs["w2"]})
    finally:
        sched.close()
        job.kill_all(procs)
    r = {h: job.load(outs[h]) for h in outs}
    assert seen == []
    assert r["w0"]["final_step"] == r["w1"]["final_step"] == 6 * 8
    for k in ("param_sum", "param_hash"):
        assert r["w1"][k] == pytest.approx(r["w0"][k], rel=TOL), k
    assert r["w0"]["num_workers_at_end"] == r["w1"]["num_workers_at_end"] \
        == 2
    assert r["w2"]["bootstrap_step"] == 2 * 8
    assert r["w2"]["final_step"] == 4 * 8
    assert [e["num_workers"] for e in r["w2"]["epochs"]] == [3, 3]
    assert job.audit(hw) == [("ADDED", "w2"), ("REMOVED", "w2")]
    assert os.path.exists(outs["w2"])
