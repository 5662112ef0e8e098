"""The port's seeded fault plans make the JAX package's decisions: the same
rules and seed give the same per-message actions, site firings and
``applied_summary`` in both."""

import json

import pytest

from dt_tpu.elastic import faults as jfaults
from dt_tpu_torch.elastic import faults as tfaults
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

_RULES = [
    {"kind": "drop", "op": "send", "cmd": "allreduce", "prob": 0.3},
    {"kind": "dup", "op": "send", "prob": 0.25, "after": 2},
    {"kind": "reset", "op": "send", "cmd": ["mc_barrier", "barrier"],
     "prob": 0.5, "times": 3},
    {"kind": "partition", "op": "recv", "host": "w1", "prob": 0.4},
    {"kind": "delay", "op": "recv", "prob": 0.5, "delay_s": 0.0},
    {"kind": "delay", "site": "worker.step", "prob": 0.5, "delay_s": 0.0},
    {"kind": "nan", "site": "worker.grad", "host": "w0", "after": 3,
     "times": 2},
    {"kind": "crash", "site": "module.epoch_begin", "host": "w2",
     "epoch": 4},
]


def _trace(mod, seed):
    plan = mod.FaultPlan(_RULES, seed=seed)
    out = []
    for i in range(60):
        host = f"w{i % 3}"
        cmd = ("allreduce", "mc_barrier", "heartbeat", "barrier")[i % 4]
        out.append(("send", plan.on_send(cmd, host)))
        out.append(("recv", plan.on_recv(cmd, host)))
        out.append(("site", plan.delay_at("worker.step", host=host)))
        out.append(("nan", plan.nan_at("worker.grad", host=host, step=i)))
        try:
            plan.crash("module.epoch_begin", host=host, epoch=i % 6)
            out.append(("crash", None))
        except mod.CrashInjected:
            out.append(("crash", host))
    return out, plan.applied_summary(), plan.to_json()


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_seeded_plan_makes_the_same_decisions(seed):
    port, ref = _trace(tfaults, seed), _trace(jfaults, seed)
    assert port[0] == ref[0]
    assert port[1] == ref[1] and port[1]
    assert json.loads(port[2]) == json.loads(ref[2])


def test_plan_from_env_and_hooks(monkeypatch):
    """``DT_FAULT_PLAN`` loads lazily; an installed plan wins; the hooks
    are no-ops without one."""
    tfaults.clear()
    try:
        assert tfaults.active_plan() is None
        tfaults.clear()
        monkeypatch.setenv("DT_FAULT_PLAN", json.dumps(
            {"seed": 3, "rules": [{"kind": "nan", "site": "worker.grad"}]}))
        assert tfaults.nan_point("worker.grad", host="w0") == 1
        assert tfaults.delay_point("worker.step") == 0.0
        tfaults.install(tfaults.FaultPlan(
            [{"kind": "crash", "site": "client.register"}]))
        with pytest.raises(tfaults.CrashInjected):
            tfaults.crash_point("client.register", host="w0")
        assert tfaults.nan_point("worker.grad") == 0
    finally:
        tfaults.clear()
    with pytest.raises(ValueError):
        tfaults.FaultRule("crash")
    with pytest.raises(ValueError):
        tfaults.FaultRule("bogus")
