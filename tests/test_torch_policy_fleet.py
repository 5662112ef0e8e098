"""A mixed tinybn fleet under the policy engine: a JAX worker ``w0``
(``tests/elastic_worker.py``) and a port worker ``w1`` (from the JAX
worker's initial variables), under either package's scheduler with
``DT_POLICY=1``, share-weighted from the first barrier.

The shares are installed through the journal the scheduler starts from:
a ``policy_decide`` record leaves ``w1`` one breach into a rebalance, and
the first barrier, with no lag signal yet, holds the journaled streak
(6667 / 3333 units: batches 21 / 11 of 32, gradient weights 1.3125 /
0.6875).  The breach threshold is out of reach, so the epoch-1 barrier
resets the streak whatever the lags (a share-only rebalance to 16 / 16):
nothing depends on wall-clock lag.  Both workers apply the same weighted
average, so their parameters end equal up to the two SGDs' rounding."""

import os

import pytest

import torch_elastic_job as job
from dt_tpu.elastic import Scheduler as JScheduler
from dt_tpu_torch.elastic import journal as tjournal
from dt_tpu_torch.elastic.scheduler import Scheduler as TScheduler
from dt_tpu_torch.policy import rescale
from test_torch_elastic_mixed_ref import save_jax_init
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

#: relative agreement of the two workers' params (as the mixed-fleet tests)
TOL = 1e-5


@pytest.mark.parametrize("scheduler", ["jax", "port"])
def test_mixed_fleet_trains_on_installed_shares(tmp_path, monkeypatch,
                                                scheduler):
    with job.deadline(150):
        _run(tmp_path, monkeypatch, scheduler)


def _run(tmp_path, monkeypatch, scheduler):
    monkeypatch.setenv("DT_POLICY", "1")
    monkeypatch.setenv("DT_POLICY_STRAGGLER_MS", "1e9")
    hw = str(tmp_path / "host_worker")
    job.write_hosts(hw, ["w0", "w1"])
    jp = str(tmp_path / "ctrl.journal")
    shares = rescale.share_units(["w0", "w1"], {"w1": 1})
    w = tjournal.JournalWriter(jp)
    w.append("init", {"workers": ["w0", "w1"], "expected": 2})
    w.append("policy_decide", {"epoch": 0, "seq": 1, "breached": ["w1"],
                               "streaks": {"w1": 1}, "shares": shares,
                               "lr_scale": 1.0, "evicted": [],
                               "proposals": []})
    w.close()
    cls = JScheduler if scheduler == "jax" else TScheduler
    sched = cls(host_worker_file=hw, journal_path=jp)
    outs = {h: str(tmp_path / f"{h}.json") for h in ("w0", "w1")}
    npz = str(tmp_path / "init.npz")
    save_jax_init(npz)
    procs = {}
    try:
        procs["w0"] = job.spawn("jax", sched.port, "w0", outs["w0"], 2)
        procs["w1"] = job.spawn("port", sched.port, "w1", outs["w1"], 2,
                                args=("--init-npz", npz))
        job.wait_ok(procs)
    finally:
        sched.close()
        job.kill_all(procs)
    r = {h: job.load(outs[h]) for h in outs}
    st = tjournal.ControlState.rebuild(jp)
    assert shares == {"w0": 6667, "w1": 3333}
    assert [(e["epoch"], e["shares"]) for e in st.policy_log] == \
        [(0, shares), (1, {"w0": 5000, "w1": 5000})]
    w1 = r["w1"]["epochs"]
    assert [e["batch"] for e in w1] == [11, 16]
    assert [e["grad_scale"] for e in w1] == [0.6875, 1.0]
    assert [e["policy_seq"] for e in w1] == [1, 2]
    assert rescale.batch_map(shares, ["w0", "w1"], 32) == {"w0": 21,
                                                           "w1": 11}
    assert r["w0"]["policy_shares"] == {"w0": 5000, "w1": 5000}
    assert r["w0"]["policy_seq"] == 2
    assert r["w0"]["final_step"] == r["w1"]["final_step"] == 2 * 8
    for k in ("param_sum", "param_hash"):
        assert r["w1"][k] == pytest.approx(r["w0"][k], rel=TOL), k
    assert os.path.exists(jp)
