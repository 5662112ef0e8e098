"""Crash and re-entry, and the graceful drain, on the port alone.

With 2-bit compression: three
port workers against the port's ``Scheduler``; ``w1`` dies at the
``module.epoch_begin`` crash rule of epoch 2 (``os._exit(137)``), a
replacement registers under its name with ``DT_RECOVERY=1`` (the quick
restart: the dead incarnation is evicted at once), is re-admitted as
itself at the next barrier, bootstraps from the snapshot, and the three
end bit-identical (mirrors ``tests/test_crash_recovery.py:83``)."""

import json
import os
import signal
import time

import torch_elastic_job as job
from dt_tpu_torch.elastic.scheduler import Scheduler
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

CRASH = json.dumps({"seed": 0, "rules": [
    {"kind": "crash", "site": "module.epoch_begin", "host": "w1",
     "epoch": 2, "action": "exit"}]})


def test_crashed_worker_reenters_bit_identical(tmp_path):
    hw = str(tmp_path / "host_worker")
    job.write_hosts(hw, ["w0", "w1", "w2"])
    outs = {h: str(tmp_path / f"{h}.json") for h in ("w0", "w1", "w2")}
    go = str(tmp_path / "go")
    num_epoch = 8
    args = ("--compress", "0.005", "--heartbeat", "0.2")
    sched = Scheduler(host_worker_file=hw)
    procs = {}
    try:
        for h in ("w0", "w1", "w2"):
            procs[h] = job.spawn("port", sched.port, h, outs[h], num_epoch,
                                 {"DT_FAULT_PLAN": CRASH}, args=args)
        # the replacement starts now and waits for the marker file, so
        # its start-up is not what the re-entry waits on
        procs["w1'"] = job.spawn("port", sched.port, "w1", outs["w1"],
                                 num_epoch, {"DT_RECOVERY": "1",
                                             "DT_WAIT_FILE": go}, args=args)
        assert procs["w1"].wait(timeout=120) == 137
        open(go, "w").close()
        job.wait_ok({h: procs[h] for h in ("w0", "w2", "w1'")})
    finally:
        sched.close()
        job.kill_all(procs)
    r = {h: job.load(outs[h]) for h in outs}
    last = {h: r[h]["epochs"][-1] for h in r}
    assert {v["epoch"] for v in last.values()} == {num_epoch - 1}
    assert len({v["sha256"] for v in last.values()}) == 1, last
    assert len({r[h]["final_step"] for h in r}) == 1
    assert len({r[h]["param_hash"] for h in r}) == 1
    assert all(r[h]["num_workers_at_end"] == 3 for h in r)
    # w1 missed epoch 2 (the survivors ran it as two) and came back at 3
    assert r["w1"]["bootstrap_step"] == 2 * 8 + 8
    assert [e["epoch"] for e in r["w1"]["epochs"]] == list(range(3, 8))
    assert [e["num_workers"] for e in r["w0"]["epochs"]] == \
        [3, 3, 2, 3, 3, 3, 3, 3]
    assert job.audit(hw) == [("REMOVED", "w1"), ("RECOVERED", "w1")]
    assert sorted(open(hw).read().split()) == ["w0", "w1", "w2"]
    assert os.path.exists(outs["w1"])


def test_sigterm_drains_a_worker_after_its_step(tmp_path):
    """The graceful drain: SIGTERM to ``w2`` mid-job makes it finish its
    step, send ``drain`` and leave ``fit``; the scheduler removes it
    (audit DRAINED, host_worker rewritten) and the survivors end
    bit-identical as a 2-worker job."""
    hw = str(tmp_path / "host_worker")
    job.write_hosts(hw, ["w0", "w1", "w2"])
    outs = {h: str(tmp_path / f"{h}.json") for h in ("w0", "w1", "w2")}
    num_epoch = 8
    sched = Scheduler(host_worker_file=hw)
    procs = {}
    try:
        for h in ("w0", "w1", "w2"):
            procs[h] = job.spawn("port", sched.port, h, outs[h], num_epoch)
        deadline = time.time() + 120
        while sched._state.last_completed_epoch < 2:
            assert time.time() < deadline, "training never got going"
            time.sleep(0.02)
        procs["w2"].send_signal(signal.SIGTERM)
        job.wait_ok(procs)
    finally:
        sched.close()
        job.kill_all(procs)
    r = {h: job.load(outs[h]) for h in outs}
    assert job.audit(hw) == [("DRAINED", "w2")]
    assert open(hw).read().split() == ["w0", "w1"]
    assert r["w2"]["final_step"] < r["w0"]["final_step"] == \
        r["w1"]["final_step"] == num_epoch * 8
    assert r["w0"]["epochs"][-1]["sha256"] == r["w1"]["epochs"][-1]["sha256"]
    assert r["w0"]["num_workers_at_end"] == 2
