"""The step recorder and replay of ``tests/torch_elastic_drift.py`` (the
card's elastic jobs are held against the CPU through it): a 2-worker f32
``resnet20`` job of the port on the CPU, recorded, replays exactly; a
changed gradient, update or average is caught; a flipped ReLU mask is
counted and takes that step's gradient out of the comparison."""

import time

import numpy as np
import pytest

import torch_elastic_drift as drift


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    from dt_tpu_torch.elastic.scheduler import Scheduler
    tmp = tmp_path_factory.mktemp("replay")
    stems, procs = {}, {}
    sched = Scheduler(initial_workers=["w0", "w1"])
    try:
        for h in ("w0", "w1"):
            stems[h] = str(tmp / h)
            procs[h] = drift.spawn(sched.port, h, stems[h],
                                   drift.job_args(8, 64, 64) +
                                   ["--device", "cpu"], dump=True)
        drift.wait_all(procs, stems, time.monotonic() + 120)
    finally:
        sched.close()
    return {h: drift.load(stems[h], dump=True) for h in stems}


def test_a_cpu_job_replays_exactly(job):
    summary, failures = drift.hold_card_job(job, job)
    assert failures == []
    assert summary["flipped_steps"] == []
    assert summary["applied_is_mean"]
    assert set(summary["replay_worst"].values()) == {0.0}
    assert len(summary["epochs"]) == 4  # 2 workers x 2 epochs of 1 step
    assert all(e["cpu_job_held"] and e["vs_cpu_job"] == 0.0
               and e["vs_replay"] < 1e-6 for e in summary["epochs"])


@pytest.mark.parametrize("key,step", [("g1", 2), ("p1", 1), ("ag0", 1)])
def test_the_replay_catches_a_changed_step(job, key, step):
    """A gradient (``g``), the params a step leaves (``p``, the next step's
    start) or one worker's applied average (``ag``) off by 1 % at its
    largest element fails that step's gates."""
    dumps = {h: dict(a) for h, (_, a) in job.items()}
    a = dumps["w1"][key].copy()
    i = int(np.abs(a).argmax())
    a[i] *= 1.01
    dumps["w1"][key] = a
    _, failures = drift.replay(dumps)
    assert any(f.startswith(f"step {step} w1") for f in failures)


def test_a_flipped_relu_mask_is_counted_and_not_held(job):
    dumps = {h: dict(a) for h, (_, a) in job.items()}
    mask = dumps["w0"]["mask1"].copy()
    mask[0] ^= np.uint8(0x80)
    dumps["w0"]["mask1"] = mask
    g = dumps["w0"]["g1"].copy()
    g[int(np.abs(g).argmax())] *= 1.01
    dumps["w0"]["g1"] = g
    rows, failures = drift.replay(dumps)
    row = next(r for r in rows if r["host"] == "w0" and r["step"] == 2)
    assert row["relu_flips"] == 1 and row["grad"] > 1e-3
    # the changed gradient is no longer the applied average's half
    assert failures and all("applied is mean False" in f for f in failures)
