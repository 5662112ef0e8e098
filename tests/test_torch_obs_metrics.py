"""The port's metrics plane against the JAX package's (``obs/metrics.py``).

- One seeded stream of gauges, histogram observations and samples into a
  registry of each package (the same injected clock) gives the same
  snapshot, series and histogram quantiles, and ``render_prometheus`` of
  the same sections is byte-equal (the port's own render of the port
  registry against the JAX render of the JAX registry).
- ``SLOEngine``, from the defaults overlaid with a ``DT_SLO_RULES``
  override, fed one seeded input sequence, fires the same breaches and
  clears, events included, and holds the same state.
- The port's ``HealthServer`` serves ``/metrics`` and ``/healthz``.
"""

import json
import urllib.request

import numpy as np
import pytest

from dt_tpu.obs import metrics as jm
from dt_tpu.obs import trace as jtrace
from dt_tpu_torch.obs import metrics as tm
from dt_tpu_torch.obs import trace as ttrace
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)


def _fill(mod, seed):
    rng = np.random.RandomState(seed)
    clock = {"t": 1_700_000_000_000_000_000}

    def wall():
        clock["t"] += int(rng.randint(1, 400)) * 1_000_000
        return clock["t"]

    reg = mod.MetricsRegistry(capacity=8, wall_clock=wall, enabled=True)
    for i in range(14):
        reg.gauge("train.loss", float(rng.uniform(0, 3)))
        reg.gauge("train.steps", i)
        reg.gauge("device.hbm_bytes", int(rng.randint(1, 1 << 30)),
                  labels={"device": "0"})
        reg.gauge("sched.heartbeat_staleness_s",
                  float(rng.uniform(0, 2)),
                  labels={"worker": f"w{i % 3}"})
        for _ in range(3):
            reg.observe("step.ms", float(rng.exponential(120.0)))
            reg.observe("round.wait_ms", float(rng.exponential(8.0)))
        reg.sample()
    reg.forget_label("worker", "w2")
    return reg


def test_registry_and_exposition_are_byte_equal():
    t, j = _fill(tm, 11), _fill(jm, 11)
    assert t.snapshot() == j.snapshot()
    assert t.series() == j.series() and t.dropped() == j.dropped() == 6
    for q in (0.5, 0.9, 0.99):
        assert t.hist_quantile("step.ms", q) == \
            j.hist_quantile("step.ms", q)
    ctrs = {"wire.retries": 3, "heartbeat.sent": 41}
    jobs_t = [({"role": "scheduler"}, t.snapshot(), ctrs),
              ({"worker": "w0", "inc": "12"},
               {"gauges": t.gauges_export(), "hists": t.hists_export()},
               {"allreduce.rounds": 9})]
    jobs_j = [({"role": "scheduler"}, j.snapshot(), ctrs),
              ({"worker": "w0", "inc": "12"},
               {"gauges": j.gauges_export(), "hists": j.hists_export()},
               {"allreduce.rounds": 9})]
    text = tm.render_prometheus(jobs_t)
    assert text.encode() == jm.render_prometheus(jobs_j).encode()
    assert "dt_device_hbm_bytes" in text and "dt_step_ms_bucket" in text
    for line in text.splitlines():
        assert line.startswith("#") or tm.PROM_LINE_RE.match(line), line
    for name in ("device.hbm_bytes", "round.wait_ms", "a-b.c"):
        assert tm.prom_name(name) == jm.prom_name(name)
    assert tm.interval_s() == jm.interval_s()


def _slo_run(mod, trmod, monkeypatch, seed):
    monkeypatch.setenv("DT_SLO_RULES", json.dumps(
        [{"name": "round_wait", "metric": "round.wait_ms", "op": ">",
          "threshold": 40.0, "per_worker": True},
         {"name": "step_rate", "metric": "worker.step_rate", "op": "<",
          "threshold": 0.5, "per_worker": True},
         {"name": "extra", "metric": "obs.ring_dropped", "op": ">",
          "threshold": 5.0}]))
    eng = mod.SLOEngine.from_env()
    tr = trmod.Tracer(name="slo", wall_clock=lambda: 5_000_000_000,
                      mono_clock=lambda: 7_000_000_000, enabled=True,
                      ident=lambda: 1)
    rng = np.random.RandomState(seed)
    fired = []
    for k in range(30):
        inputs = {
            "round.wait_ms": {f"w{i}": float(rng.exponential(30.0))
                              for i in range(3)},
            "worker.step_rate": {f"w{i}": float(rng.uniform(0, 2))
                                 for i in range(3)},
            "obs.ring_dropped": float(rng.randint(0, 10)),
            "journal.append_ms.p99": float(rng.exponential(100.0)),
        }
        fired.append(eng.evaluate(inputs, tracer=tr, now_ms=1000 * k))
    return eng.rules, fired, eng.state(), tr.snapshot()["records"]


def test_slo_engine_fires_the_same_breaches(monkeypatch):
    t = _slo_run(tm, ttrace, monkeypatch, 5)
    j = _slo_run(jm, jtrace, monkeypatch, 5)
    assert t == j
    assert any(f for f in t[1])  # the seeded inputs do breach and clear
    assert {r[2] for r in t[3]} == {"health.breach", "health.clear"}
    assert [r for r in tm.DEFAULT_SLO_RULES] == list(jm.DEFAULT_SLO_RULES)
    with pytest.raises(ValueError):
        tm.SLOEngine([{"name": "x", "metric": "y", "op": "=="}])


def test_health_server_serves_metrics_and_health():
    srv = tm.HealthServer(0, lambda: "dt_x 1\n",
                          lambda: {"enabled": True, "slo": {}})
    try:
        base = f"http://127.0.0.1:{srv.port}"
        assert urllib.request.urlopen(base + "/metrics", timeout=10) \
            .read() == b"dt_x 1\n"
        assert json.loads(urllib.request.urlopen(
            base + "/healthz", timeout=10).read()) == {"enabled": True,
                                                       "slo": {}}
    finally:
        srv.close()
