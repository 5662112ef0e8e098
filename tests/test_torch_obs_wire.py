"""The obs planes on the wire: the port's scheduler and client against the
JAX package's.

- One scripted sequence (worker heartbeats carrying span, metrics and
  device payloads, ``obs_push`` replays, profiler posts and their
  retries, targeted ``profile_capture`` commands, a bad target,
  ``blackbox_index`` over a manifest) sent to each package's scheduler
  through the JAX package's wire: every deterministic reply pickles to the
  same bytes, and the ``obs_dump`` worker tracks, device and metrics
  sections and the ``health`` view agree.
- A port worker client heartbeats into the JAX scheduler and a JAX worker
  client into the port's: each scheduler holds the other package's
  worker track, its gauges and its device view.
- The port client's ``hm`` payload and the device plane's ``dev`` payload
  are the JAX client's for the same registry and ledger (byte-equal once
  the host RSS, sampled at another instant, and the JAX compile view's
  XLA estimate, which has no counterpart, are set aside).
"""

import os
import pickle
import time

import numpy as np
import pytest

from dt_tpu.elastic import Scheduler as JScheduler
from dt_tpu.elastic import protocol as jproto
from dt_tpu.elastic.client import WorkerClient as JClient
from dt_tpu.obs import blackbox as jbb
from dt_tpu.obs import device as jdev
from dt_tpu.obs import metrics as jm
from dt_tpu.obs import trace as jtrace
from dt_tpu_torch.elastic.client import WorkerClient as TClient
from dt_tpu_torch.elastic.scheduler import Scheduler as TScheduler
from dt_tpu_torch.obs import blackbox as tbb
from dt_tpu_torch.obs import device as tdev
from dt_tpu_torch.obs import metrics as tm
from dt_tpu_torch.obs import trace as ttrace
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

_MODS = ((ttrace, jtrace), (tm, jm), (tdev, jdev), (tbb, jbb))


@pytest.fixture
def planes(monkeypatch, tmp_path):
    """Trace, metrics and device planes on in both packages (the
    blackbox plane only for the index: no crash hooks in this process)."""
    monkeypatch.setenv("DT_BLACKBOX_DIR", str(tmp_path / "bb"))
    for t, j in _MODS[:3]:
        t.set_enabled(True)
        j.set_enabled(True)
    for reg in (tm.registry(), jm.registry()):
        reg.clear()
    yield tmp_path
    for t, j in _MODS:
        t.set_enabled(None)
        j.set_enabled(None)
    tdev._reset_for_tests()
    jdev._reset_for_tests()
    for reg in (tm.registry(), jm.registry()):
        reg.clear()


def _payloads(seed):
    rng = np.random.RandomState(seed)
    recs = []
    for i in range(1, 9):
        ts = 1_700_000_000_000_000 + i * 1000
        recs.append(["X", i, "step" if i % 2 else "pipeline.wire", ts,
                     int(rng.randint(100, 900)), 5, i, None, {"epoch": 0}])
    obs = {"inc": 41, "fseq": 1, "records": recs,
           "counters": {"allreduce.rounds": 4}, "dropped": 0}
    hm = {"inc": 41, "gseq": 1,
          "samples": [{"seq": s, "ts_ms": 1000 * s,
                       "gauges": {"train.steps": float(s),
                                  "train.loss": float(rng.uniform(1, 2))}}
                      for s in range(1, 5)],
          "gauges": [["device.hbm_bytes", [["device", "0"]], 1234.0],
                     ["train.loss", [], 1.5]],
          "hists": [], "dropped": 0}
    dev = {"dseq": 1, "cseq": 0, "compiling": None,
           "compiling_age_s": 0.0,
           "compile": {"compiles": 2, "recompiles": 1, "cache_hits": 0,
                       "cache_misses": 1, "ms_total": 3.5,
                       "whats": ["fused_bn_train"]},
           "mem": {"devices": [{"id": 0, "bytes_in_use": 1234,
                                "peak_bytes_in_use": 2000,
                                "bytes_limit": 8000}]}}
    return obs, hm, dev


def _script(cls, tmp_path):
    sched = cls(initial_workers=["w0", "w1"])
    port = sched.port
    out = []

    def req(label, msg):
        out.append((label, jproto.request("127.0.0.1", port, msg,
                                          timeout=30)))
        return out[-1][1]

    try:
        for h in ("w0", "w1"):
            req("register", {"cmd": "register", "host": h, "is_new": False})
        obs, hm, dev = _payloads(3)
        req("hb0", {"cmd": "heartbeat", "host": "w0", "pseq": 0,
                    "obs": obs, "hm": hm, "dev": dev})
        # a replay of the same batches, then the next ones
        req("push", {"cmd": "obs_push", "host": "w0", "obs": obs, "hm": hm})
        obs2 = dict(obs, fseq=2, records=[list(r) for r in obs["records"]]
                    + [["i", 9, "fault.drop", 1_700_000_000_010_000, 0, 5,
                        None, None, {"op": "send"}]])
        req("push2", {"cmd": "obs_push", "host": "w0", "obs": obs2})
        req("prof1", {"cmd": "profile", "action": "set_state",
                      "params": {"state": "run"}, "host": "w0",
                      "post_seq": 1})
        req("prof1-retry", {"cmd": "profile", "action": "set_state",
                            "params": {"state": "run"}, "host": "w0",
                            "post_seq": 1})
        req("prof2", {"cmd": "profile", "action": "dump", "params": {},
                      "host": "w0", "post_seq": 2})
        req("cap", {"cmd": "profile_capture", "target": "w1", "steps": 2,
                    "host": "w0", "post_seq": 1})
        req("cap-retry", {"cmd": "profile_capture", "target": "w1",
                          "steps": 2, "host": "w0", "post_seq": 1})
        req("cap-bad", {"cmd": "profile_capture", "target": "w9",
                        "steps": 2, "host": "w0", "post_seq": 2})
        req("hb1", {"cmd": "heartbeat", "host": "w1", "pseq": 0,
                    "dev": dict(dev, dseq=1)})
        req("hb1-after", {"cmd": "heartbeat", "host": "w1", "pseq": 2,
                          "dev": dict(dev, dseq=2, cseq=1)})
        req("hb0-stale-dev", {"cmd": "heartbeat", "host": "w0", "pseq": 2,
                              "dev": dict(dev, dseq=1,
                                          compiling="compile.nvcc")})
        req("bb", {"cmd": "blackbox_index"})
        health = jproto.request("127.0.0.1", port, {"cmd": "health"},
                                timeout=30)["health"]
        dump = jproto.request("127.0.0.1", port, {"cmd": "obs_dump"},
                              timeout=30)["job"]
    finally:
        sched.close()
    return out, health, dump


def test_schedulers_answer_the_obs_commands_alike(planes):
    tbb.set_enabled(True)
    jbb.set_enabled(True)
    tbb.manifest_append({"kind": "exit", "ts_ms": 5, "pid": 7,
                         "host": "w0", "trigger": "exit", "fatal": False})
    t, th, td = _script(TScheduler, planes)
    j, jh, jd = _script(JScheduler, planes)
    assert [lab for lab, _ in t] == [lab for lab, _ in j]
    for (lab, a), (_, b) in zip(t, j):
        assert pickle.dumps(a) == pickle.dumps(b), (lab, a, b)
    got = dict(t)
    assert got["prof1-retry"] == got["prof1"] == {"seq": 1}
    assert [c["seq"] for c in got["hb1"]["profile_cmds"]] == [1, 2]
    assert got["hb1"]["capture_cmds"] == [{"seq": 1, "target": "w1",
                                           "steps": 2}]
    assert "capture_cmds" not in got["hb1-after"]
    assert "is not a live worker" in got["cap-bad"]["error"]
    assert got["bb"]["bundles"] == tbb.read_manifest()
    # the dumps: worker tracks, device view, metrics tracks
    tt = {k: v for k, v in td["tracks"].items() if k != "control-plane"}
    jt = {k: v for k, v in jd["tracks"].items() if k != "control-plane"}
    assert tt == jt and list(tt) == ["w0#41"]
    assert len(tt["w0#41"]["records"]) == 9  # the replay deduplicated

    def strip(view):
        return {h: {k: v for k, v in w.items() if k != "_ts"}
                for h, w in view["workers"].items()}
    assert strip(td["device"]) == strip(jd["device"])
    assert td["device"]["workers"]["w0"]["compiling"] is None  # stale beat
    mt = {k: v for k, v in td["metrics"]["tracks"].items()
          if k != "control-plane"}
    mj = {k: v for k, v in jd["metrics"]["tracks"].items()
          if k != "control-plane"}
    assert mt == mj and len(mt["w0#41"]["samples"]) == 4
    # health: the same rules and worker gauges (the scheduler's own
    # gauges carry timings)
    assert th["slo"]["rules"] == jh["slo"]["rules"]
    assert th["workers"] == jh["workers"]
    assert set(th) == set(jh)
    assert strip(th["device"]) == strip(jh["device"])


def _wait(cond, timeout=20.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return True
        time.sleep(0.05)
    return False


def test_each_scheduler_ingests_the_other_packages_worker(planes):
    jsched = JScheduler(initial_workers=["pw"])
    tsched = TScheduler(initial_workers=["jw"])
    clients = []
    try:
        clients.append(TClient("127.0.0.1", jsched.port, host="pw",
                               heartbeat_interval_s=0.1))
        clients.append(JClient("127.0.0.1", tsched.port, host="jw",
                               heartbeat_interval_s=0.1))
        for tr in (ttrace.tracer(), jtrace.tracer()):
            for _ in range(3):
                with tr.span("step", {"epoch": 0}):
                    pass
        tm.registry().gauge("train.steps", 3)
        jm.registry().gauge("train.steps", 3)
        for c in clients:
            c.obs_flush()

        def track(sched, host):
            dump = sched.obs_dump()
            keys = [k for k in dump["tracks"] if k.startswith(host + "#")]
            return dump, keys
        for sched, host in ((jsched, "pw"), (tsched, "jw")):
            assert _wait(lambda: track(sched, host)[1] and host in
                         (sched.obs_dump().get("device") or {})
                         .get("workers", {}))
            dump, keys = track(sched, host)
            steps = [r for r in dump["tracks"][keys[0]]["records"]
                     if r[2] == "step"]
            assert len(steps) >= 3
            h = sched.health_view()
            key = f"{host}#{os.getpid()}"
            assert _wait(lambda: sched.health_view()["workers"]
                         .get(key, {}).get("gauges", {})
                         .get("train.steps") == 3.0)
            assert h["enabled"] is True
    finally:
        for c in clients:
            c.close()
        jsched.close()
        tsched.close()


def test_hm_and_dev_payloads_are_the_jax_clients(planes):
    jsched = JScheduler(initial_workers=["a"])
    tsched = TScheduler(initial_workers=["b"])
    try:
        tc = TClient("127.0.0.1", tsched.port, host="b",
                     heartbeat_interval_s=3600)
        jc = JClient("127.0.0.1", jsched.port, host="a",
                     heartbeat_interval_s=3600)
        time.sleep(0.3)  # the clients' first heartbeats are out
        payloads = {}
        for name, client, reg, dev, trmod in (
                ("port", tc, tm.registry(), tdev, ttrace),
                ("jax", jc, jm.registry(), jdev, jtrace)):
            reg.clear()
            reg._wall = iter(range(10**18, 10**18 + 10**12, 10**6)).__next__
            rng = np.random.RandomState(9)
            for i in range(5):
                reg.gauge("train.loss", float(rng.uniform(0, 3)))
                reg.gauge("device.hbm_bytes", 100 + i,
                          labels={"device": "0"})
                reg.observe("step.ms", float(rng.exponential(50.0)))
                reg.sample()
            with client._hm_lock:
                client._hm_pending.clear()
                client._hm_gseq = 0
            hm = client._hm_payload()
            tr = trmod.Tracer(enabled=True, wall_clock=lambda: 5000,
                              mono_clock=lambda: 5000, ident=lambda: 1)
            for k in range(3):
                s = {"nargs": 1, "shape": f"s{k % 2}", "dtype": "d",
                     "mesh": "", "donate": "", "digest": f"g{k}"}
                if name == "port":
                    dev._record_compile("bn", s, 2.0, "off", tracer=tr,
                                        now_ms=7)
                else:
                    dev._record_compile("bn", s, 2.0, "off", None,
                                        tracer=tr, now_ms=7)
            d = dev.wire_payload()
            d["compile"].pop("est", None)
            d.pop("mem")
            payloads[name] = (hm, d, tr.snapshot()["records"],
                              dev.summary()["recompile_log"])
            reg._wall = time.time_ns
        assert pickle.dumps(payloads["port"][0]) == \
            pickle.dumps(payloads["jax"][0])
        assert pickle.dumps(payloads["port"][1]) == \
            pickle.dumps(payloads["jax"][1])
        assert payloads["port"][2:] == payloads["jax"][2:]
        tc.close()
        jc.close()
    finally:
        jsched.close()
        tsched.close()


def test_a_crashing_primary_relays_its_track_to_the_peer(tmp_path):
    """``scheduler_main --peer``: an injected ``os._exit`` of the primary
    first pushes its control-plane track to the peer (``_relay_obs``), so
    the peer's dump keeps the dead incarnation's ``fault.crash``."""
    import json

    import torch_elastic_job as job
    peer = TScheduler(initial_workers=["w0"])
    plan = {"seed": 0, "rules": [{"kind": "crash", "site":
                                  "sched.allreduce", "action": "exit"}]}
    proc, port = job.start_scheduler(
        str(tmp_path), "primary",
        ["--peer", f"127.0.0.1:{peer.port}"],
        env={"DT_OBS": "1", "DT_FAULT_PLAN": json.dumps(plan)})
    try:
        with job.deadline(60):
            jproto.request("127.0.0.1", port, {"cmd": "register",
                                               "host": "w0"}, timeout=10)
            with pytest.raises((OSError, RuntimeError)):
                jproto.request("127.0.0.1", port,
                               {"cmd": "allreduce", "host": "w0",
                                "key": "g", "value": np.zeros(2)},
                               timeout=10)
            assert proc.wait(timeout=30) == 137
        dump = peer.obs_dump()
        key = f"sched-primary#{proc.pid}"
        names = [r[2] for r in dump["tracks"][key]["records"]]
        assert "fault.crash" in names
    finally:
        job.stop_scheduler(proc, port)
        peer.close()


def test_an_injected_crash_flushes_the_worker_and_bundles(tmp_path):
    """A port worker killed by an injected ``os._exit`` at the epoch-1
    boundary: its track reaches the scheduler through the crash flush
    (``obs_push``), epoch 0's 8 steps and the ``fault.crash`` event in it,
    and it left a ``crash.module.epoch_begin`` bundle."""
    import json

    import torch_elastic_job as job
    from torch_one_thread import ENV
    ttrace.set_enabled(True)
    sched = TScheduler(initial_workers=["w0"])
    bb = str(tmp_path / "bb")
    plan = {"seed": 0, "rules": [{"kind": "crash", "site":
                                  "module.epoch_begin", "epoch": 1,
                                  "action": "exit"}]}
    try:
        p = job.spawn("port", sched.port, "w0", str(tmp_path / "w0.json"),
                      2, dict(ENV, DT_OBS="1", DT_BLACKBOX="1",
                              DT_BLACKBOX_DIR=bb,
                              DT_FAULT_PLAN=json.dumps(plan)))
        assert p.wait(timeout=120) == 137, p.stdout.read().decode()[-2000:]
        dump = sched.obs_dump()
    finally:
        sched.close()
        ttrace.set_enabled(None)
    (key,) = [k for k in dump["tracks"] if k.startswith("w0#")]
    names = [r[2] for r in dump["tracks"][key]["records"]]
    assert names.count("step") == 8 and "fault.crash" in names
    rows = [r for r in jbb.read_manifest(bb) if r["kind"] == "bundle"]
    assert [r["trigger"] for r in rows] == ["crash.module.epoch_begin"]
    b = json.load(open(os.path.join(bb, rows[0]["file"])))
    assert jbb.validate_bundle(b) == [] and b["extra"]["epoch"] == 1
    assert any(s["name"] == "epoch" for s in b["open_spans"])
