"""The mixed fleet with the roles swapped: the port's ``Scheduler``
(in-process), a port worker ``w0`` (rank 0, from the JAX worker's initial
variables) and a JAX worker ``w1`` (the unmodified
``tests/elastic_worker.py``); a JAX joiner ``w2`` is added at the epoch-2
boundary, bootstraps from the port worker's snapshot, and is removed at
the epoch-4 boundary."""

import pytest

import torch_elastic_job as job
from test_torch_elastic_mixed_ref import save_jax_init
from dt_tpu_torch.elastic.scheduler import Scheduler
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

#: relative agreement of the JAX and port workers' params at the end (the
#: two SGD implementations round differently; the averages are shared)
TOL = 1e-5


def test_port_scheduler_serves_a_mixed_fleet(tmp_path):
    hw = str(tmp_path / "host_worker")
    job.write_hosts(hw, ["w0", "w1"])
    outs = {h: str(tmp_path / f"{h}.json") for h in ("w0", "w1", "w2")}
    npz = str(tmp_path / "init.npz")
    save_jax_init(npz)
    procs = {}
    num_epoch = 6

    def launch(host, epoch):
        procs[host] = job.spawn("jax", sched.port, host, outs[host],
                                num_epoch, {"NEW_WORKER": "1",
                                            "EPOCH_BEGIN": str(epoch)})

    def operator(epoch):
        if epoch == 2:
            job.write_hosts(hw, ["w0", "w1", "w2"])
        elif epoch == 4:
            job.write_hosts(hw, ["w0", "w1"])

    sched = Scheduler(host_worker_file=hw, launch_callback=launch,
                      pre_change_hook=operator)
    try:
        procs["w0"] = job.spawn("port", sched.port, "w0", outs["w0"],
                                num_epoch, args=("--init-npz", npz))
        procs["w1"] = job.spawn("jax", sched.port, "w1", outs["w1"],
                                num_epoch)
        job.wait_ok({h: procs[h] for h in ("w0", "w1")})
        assert "w2" in procs, "the scheduler never launched w2"
        job.wait_ok({"w2": procs["w2"]})
    finally:
        sched.close()
        job.kill_all(procs)
    r = {h: job.load(outs[h]) for h in outs}
    assert r["w0"]["final_step"] == r["w1"]["final_step"] == 6 * 8
    for k in ("param_sum", "param_hash"):
        assert r["w1"][k] == pytest.approx(r["w0"][k], rel=TOL), k
    assert r["w0"]["num_workers_at_end"] == r["w1"]["num_workers_at_end"] \
        == 2
    assert r["w2"]["bootstrap_step"] == 2 * 8
    assert r["w2"]["final_step"] == 4 * 8
    assert job.audit(hw) == [("ADDED", "w2"), ("REMOVED", "w2")]
