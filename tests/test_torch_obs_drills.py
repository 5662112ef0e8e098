"""The health-halt and hang drills on the CPU, in both packages side by
side: a 2-worker ``TinyBNNet`` job of the JAX harness
(``tests/elastic_worker.py``) against the JAX scheduler and of the port's
(``tests/torch_elastic_worker.py``) against the port's, one seeded fault
plan for both.

- nan: ``DT_HEALTH_HALT=1`` and a ``nan`` rule on ``w1``'s
  ``worker.grad`` after 3 gradients: in both packages both workers exit 0
  with ``health_halted`` and ``final_step`` 3, and each halted process
  left a ``health.halt`` bundle the JAX validator accepts.
- hang: ``DT_HANG_S=1`` and a ``stall`` rule on ``w1``'s ``worker.step``
  after 2 steps: in both packages ``w1``'s watchdog writes a live bundle
  whose stacks name ``stall_at``, and the scheduler's ``blackbox_index``
  names the same suspect (``w1``, the fleet waiting on it alone).
"""

import json
import os
import time

import pytest

from dt_tpu.elastic import Scheduler as JScheduler
from dt_tpu.elastic import protocol as jproto
from dt_tpu.obs import blackbox as jbb
from dt_tpu_torch.elastic.scheduler import Scheduler as TScheduler
from dt_tpu_torch.obs import blackbox as tbb
from torch_one_thread import ENV, one_torch_thread  # noqa: F401 (fixture)

import torch_elastic_job as job

_KINDS = (("jax", JScheduler, jbb), ("port", TScheduler, tbb))


def _plan(rule):
    return json.dumps({"seed": 0, "rules": [rule]})


def _fleets(tmp, env, monkeypatch):
    """Start both packages' schedulers and 2-worker fleets; returns
    ``{kind: (sched, procs, outs, bundle dir)}``."""
    runs = {}
    for kind, cls, _ in _KINDS:
        sched = cls(initial_workers=["w0", "w1"])
        bb = os.path.join(tmp, kind, "bb")
        outs = {h: os.path.join(tmp, kind, f"{h}.json") for h in ("w0", "w1")}
        os.makedirs(os.path.dirname(bb), exist_ok=True)
        procs = {h: job.spawn(kind, sched.port, h, outs[h], 1,
                              dict(ENV, DT_BLACKBOX="1", DT_BLACKBOX_DIR=bb,
                                   **env))
                 for h in ("w0", "w1")}
        runs[kind] = (sched, procs, outs, bb)
    return runs


def _stop(runs):
    for sched, procs, _, _ in runs.values():
        job.kill_all(procs)
        sched.close()


@pytest.fixture
def bb_armed(monkeypatch, tmp_path):
    """The schedulers here age rounds for the hang detector (the blackbox
    plane on in this process, with its own bundle directory)."""
    monkeypatch.setenv("DT_BLACKBOX_DIR", str(tmp_path / "sched_bb"))
    monkeypatch.setenv("DT_HANG_S", "1")
    for m in (tbb, jbb):
        m.set_enabled(True)
    yield tmp_path
    for m in (tbb, jbb):
        m.set_enabled(None)


def test_nan_drill_halts_both_packages_alike(bb_armed, monkeypatch):
    env = {"DT_HEALTH_HALT": "1", "DT_FAULT_PLAN": _plan(
        {"kind": "nan", "site": "worker.grad", "host": ["w1"], "after": 3,
         "times": 1})}
    runs = _fleets(str(bb_armed), env, monkeypatch)
    try:
        with job.deadline(150):
            for _, procs, _, _ in runs.values():
                job.wait_ok(procs, timeout=120)
    finally:
        _stop(runs)
    got = {}
    for kind, (_, _, outs, bb) in runs.items():
        res = {h: job.load(p) for h, p in outs.items()}
        got[kind] = {h: (r["final_step"], r["health_halted"])
                     for h, r in res.items()}
        halts = [r for r in jbb.read_manifest(bb) if r["kind"] == "bundle"
                 and r["trigger"] == "health.halt"]
        assert sorted(r["host"] for r in halts) == ["w0", "w1"], kind
        for r in halts:
            b = json.load(open(os.path.join(bb, r["file"])))
            assert jbb.validate_bundle(b) == [] and b["fatal"] is False
    assert got["port"] == got["jax"] == {"w0": (3, True), "w1": (3, True)}


def _stall_bundle(bb):
    """``w1``'s hang bundle whose stacks name ``stall_at``, if any."""
    for r in jbb.read_manifest(bb):
        if r["kind"] != "bundle" or r["host"] != "w1" or \
                r["trigger"] != "hang":
            continue
        b = json.load(open(os.path.join(bb, r["file"])))
        if any(fr[2] == "stall_at" for t in b["threads"]
               for fr in t["frames"]):
            return b
    return None


def test_hang_drill_blames_the_same_worker(bb_armed, monkeypatch):
    env = {"DT_HANG_S": "1", "DT_FAULT_PLAN": _plan(
        {"kind": "stall", "site": "worker.step", "host": ["w1"],
         "after": 2})}
    runs = _fleets(str(bb_armed), env, monkeypatch)
    suspects = {}
    try:
        with job.deadline(150):
            end = time.monotonic() + 120
            while len(suspects) < 2 and time.monotonic() < end:
                for kind, (sched, procs, _, bb) in runs.items():
                    for h, p in procs.items():
                        assert p.poll() is None, (kind, h, p.returncode)
                    if kind in suspects or _stall_bundle(bb) is None:
                        continue
                    idx = jproto.request("127.0.0.1", sched.port,
                                         {"cmd": "blackbox_index"},
                                         timeout=10)
                    if idx["suspect"] and idx["suspect"]["age_s"] > 1.0:
                        suspects[kind] = idx["suspect"]
                time.sleep(0.2)
    finally:
        _stop(runs)
    assert set(suspects) == {"jax", "port"}, suspects
    for kind, s in suspects.items():
        assert (s["blamed"], s["waiting"], s["contributed"]) == \
            ("w1", ["w1"], ["w0"]), (kind, s)
    b = _stall_bundle(runs["port"][3])
    assert jbb.validate_bundle(b) == [] and b["fatal"] is False
    assert b["extra"]["hang_s"] == 1.0
