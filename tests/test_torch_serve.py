"""The port's serving plane on the CPU (``dt_tpu_torch.serve``): the tests of
``tests/test_serve.py`` moved onto the port's scheduler, replicas and toy
predictor, with the same pinned numbers.

Batcher numbers are pinned against a fake clock; served values are held
against ``Predictor.predict`` and the numpy oracle ``x @ params_for_step(...)
["w"]`` (float32 on the CPU, rtol 1e-5).  The replica's ``--onnx`` serves a
file the port exports (``tests/test_torch_onnx.py`` serves the JAX
package's file in process).
"""

import json
import os
import subprocess
import sys
import threading
import time
import uuid

import numpy as np
import pytest

from dt_tpu_torch.elastic import protocol
from dt_tpu_torch.elastic.scheduler import Scheduler
from dt_tpu_torch.obs import export as obs_export
from dt_tpu_torch.obs import trace as obs_trace
from dt_tpu_torch.policy import ServePolicy
from dt_tpu_torch.serve import (DynamicBatcher, Gateway, InferClient,
                                RollingRefresher)
from dt_tpu_torch.serve.replica import (Replica, params_for_step,
                                        toy_predictor)
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F, C = 4, 3  # the toy linear model: features, classes


# ---------------------------------------------------------------------------
# DynamicBatcher: the arithmetic against a fake clock
# ---------------------------------------------------------------------------


def test_batcher_plan_pinned():
    b = DynamicBatcher(buckets=[1, 2, 4, 8], deadline_ms=50.0,
                       queue_rows=64)
    t0 = 1000.0
    assert b.plan([], t0) == 0
    # one small request inside the wait budget: held for coalescing
    assert b.plan([(1, t0)], t0) == 0
    assert b.plan([(1, t0)], t0 + 24.9) == 0
    # half the deadline (25 ms) spent waiting: the partial batch goes
    assert b.plan([(1, t0)], t0 + 25.0) == 1
    # the queue fills the largest bucket exactly: launched at once
    assert b.plan([(4, t0), (4, t0 + 1)], t0 + 1) == 2
    # 3 + 4 = 7 fits 8, adding 5 overflows: the prefix goes now
    assert b.plan([(3, t0), (4, t0 + 1), (5, t0 + 2)], t0 + 2) == 2
    assert b.plan([(1, t0 + i) for i in range(8)], t0 + 7) == 8
    assert b.plan([(1, t0 + i) for i in range(9)], t0 + 8) == 8
    assert b.next_wakeup_ms(t0) == t0 + 25.0


def test_batcher_admission():
    b = DynamicBatcher(buckets=[2, 4], deadline_ms=10.0, queue_rows=6)
    assert b.admit(0, 4)
    assert not b.admit(0, 5)  # one request larger than the largest bucket
    assert not b.admit(0, 0)
    assert b.admit(2, 4)
    assert not b.admit(3, 4)  # past the queue-row cap
    assert b.bucket_of(1) == 2 and b.bucket_of(3) == 4
    assert b.bucket_of(99) == 4


# ---------------------------------------------------------------------------
# Gateway: served values against Predictor.predict and the numpy oracle
# ---------------------------------------------------------------------------


def _gateway(step=0, **kw):
    pred = toy_predictor(F, C, max_batch=8, step=step, device="cpu")
    pred.warmup(feature_shape=(F,))
    return Gateway(pred, name=f"test-{uuid.uuid4().hex[:6]}", **kw), pred


def test_gateway_padded_bucket_oracle():
    gw, pred = _gateway()
    try:
        c = InferClient(replicas=[("127.0.0.1", gw.port)])
        rng = np.random.RandomState(0)
        w = params_for_step(F, C, 0)["w"]
        # padded (3 -> 4), exactly full (8), the minimum (1)
        for n in (1, 3, 5, 8):
            x = rng.randn(n, F).astype(np.float32)
            got = c.infer(x)
            assert got["weights_step"] == 0
            np.testing.assert_array_equal(got["y"], pred.predict(x))
            np.testing.assert_allclose(got["y"], x @ w, rtol=1e-5)
        # an oversized request: an explicit error, never a truncation
        with pytest.raises(ConnectionError):
            InferClient(replicas=[("127.0.0.1", gw.port)],
                        tries=1).infer(rng.randn(9, F).astype(np.float32))
    finally:
        gw.close()


def test_gateway_coalesces_concurrent_requests():
    gw, _ = _gateway(deadline_ms=100.0)
    try:
        c = InferClient(replicas=[("127.0.0.1", gw.port)])
        rng = np.random.RandomState(1)
        xs = [rng.randn(2, F).astype(np.float32) for _ in range(4)]
        outs = [None] * 4

        def call(i):
            outs[i] = c.infer(xs[i])

        ts = [threading.Thread(target=call, args=(i,)) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
            assert not t.is_alive()
        w = params_for_step(F, C, 0)["w"]
        for i in range(4):
            np.testing.assert_allclose(outs[i]["y"], xs[i] @ w, rtol=1e-5)
        st = c.stats(("127.0.0.1", gw.port))
        # four concurrent 2-row requests: at most 2 batches (8 rows fill
        # one bucket; thread-start skew may split once)
        assert st["requests"] == 4 and st["rows"] == 8
        assert 1 <= st["batches"] <= 2
    finally:
        gw.close()


def test_gateway_shed_accounting():
    # a 4-row queue flooded faster than the executor drains it: shed and
    # served account for every submission
    gw, _ = _gateway(queue_rows=4, deadline_ms=200.0)
    try:
        addr = ("127.0.0.1", gw.port)
        c = InferClient(replicas=[addr])
        x = np.ones((2, F), np.float32)
        shed = served = 0
        rids = []
        for i in range(8):
            resp = protocol.request(addr[0], addr[1],
                                    {"cmd": "infer", "x": x,
                                     "wait": False, "rid": f"r{i}"})
            if resp.get("shed"):
                shed += 1
            else:
                rids.append(f"r{i}")
        for rid in rids:
            out = c.result(rid, addr, wait_s=30.0)
            np.testing.assert_allclose(
                out["y"], x @ params_for_step(F, C, 0)["w"], rtol=1e-5)
            served += 1
        assert shed >= 1, "a flood at a 4-row cap must shed"
        assert served + shed == 8
        st = c.stats(addr)
        assert st["shed"] == shed and st["requests"] == served
    finally:
        gw.close()


def test_infer_retry_dedup_same_token():
    gw, _ = _gateway()
    try:
        addr = ("127.0.0.1", gw.port)
        x = np.ones((2, F), np.float32)
        tok = uuid.uuid4().hex
        r1 = protocol.request(addr[0], addr[1],
                              {"cmd": "infer", "x": x, "token": tok})
        r2 = protocol.request(addr[0], addr[1],
                              {"cmd": "infer", "x": x, "token": tok})
        np.testing.assert_array_equal(r1["y"], r2["y"])
        st = InferClient(replicas=[addr]).stats(addr)
        assert st["requests"] == 1, "a retry with one token ran again"
    finally:
        gw.close()


# ---------------------------------------------------------------------------
# the control plane: registration, failover, refresh, autoscale
# ---------------------------------------------------------------------------


def _mk_replica(host, endpoints, **kw):
    pred = toy_predictor(F, C, max_batch=8, device="cpu")
    pred.warmup(feature_shape=(F,))
    return Replica(pred, host, endpoints, heartbeat_s=0.1,
                   refresh_loader=lambda s, _m: params_for_step(F, C, s),
                   advertise_host="127.0.0.1", **kw)


def test_replica_discovery_and_refresh_never_torn(tmp_path):
    sched = Scheduler(initial_workers=[],
                      host_worker_file=str(tmp_path / "hosts"))
    reps = []
    try:
        eps = f"127.0.0.1:{sched.port}"
        reps = [_mk_replica("s0", eps), _mk_replica("s1", eps)]
        c = InferClient(scheduler=eps)
        deadline = time.time() + 10
        while len(c.refresh_endpoints()) < 2:
            assert time.time() < deadline
            time.sleep(0.05)

        ws = {s: params_for_step(F, C, s)["w"] for s in (0, 7)}
        stop = threading.Event()
        bad = []

        def hammer():
            rng = np.random.RandomState(os.getpid() & 0xffff)
            while not stop.is_set():
                x = rng.randn(3, F).astype(np.float32)
                out = c.infer(x)
                # every answer is entirely the weights of the step it names
                expect = x @ ws[out["weights_step"]]
                if not np.allclose(out["y"], expect, rtol=1e-5):
                    bad.append(out["weights_step"])

        threads = [threading.Thread(target=hammer) for _ in range(2)]
        for t in threads:
            t.start()
        time.sleep(0.3)
        out = RollingRefresher(eps).poll_once(step=7, manifest=None)
        assert sorted(out["applied"]) == ["s0", "s1"], out
        time.sleep(0.3)
        stop.set()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        assert not bad, f"torn answers at steps {bad}"
        assert c.infer(np.ones((2, F), np.float32))["weights_step"] == 7
        deadline = time.time() + 10
        while True:
            v = protocol.request("127.0.0.1", sched.port,
                                 {"cmd": "serve_endpoints"})
            if all(e["weights_step"] == 7
                   for e in v["replicas"].values()):
                break
            assert time.time() < deadline
            time.sleep(0.05)
    finally:
        for r in reps:
            r.close()
        sched.close()


def test_serve_survives_scheduler_failover(tmp_path):
    jp = str(tmp_path / "ctrl.journal")
    lp = str(tmp_path / "ctrl.lease")
    standby = Scheduler(standby=True, journal_path=jp, lease_path=lp,
                        lease_s=2.0)
    primary = Scheduler(initial_workers=[], journal_path=jp,
                        lease_path=lp, lease_s=2.0,
                        host_worker_file=str(tmp_path / "hosts"))
    eps = f"127.0.0.1:{primary.port},127.0.0.1:{standby.port}"
    rep = None
    try:
        rep = _mk_replica("s0", eps)
        c = InferClient(scheduler=eps)
        deadline = time.time() + 10
        while not c.refresh_endpoints():
            assert time.time() < deadline
            time.sleep(0.05)
        x = np.ones((2, F), np.float32)
        tok = uuid.uuid4().hex
        before = c.infer(x, token=tok)

        primary.close()  # the process dying, its connections severed

        # the data plane never touches the scheduler: the same token
        # retried mid-failover gets the cached answer
        addr = ("127.0.0.1", rep.gateway.port)
        again = protocol.request(addr[0], addr[1],
                                 {"cmd": "infer", "x": x, "token": tok})
        np.testing.assert_array_equal(before["y"], again["y"])
        st = InferClient(replicas=[addr]).stats(addr)
        assert st["requests"] == 1

        # the ServeClient rotates to the standby and registers again
        deadline = time.time() + 20
        while True:
            v = protocol.request("127.0.0.1", standby.port,
                                 {"cmd": "serve_endpoints"})
            if "error" not in v and "s0" in (v.get("replicas") or {}):
                break
            assert time.time() < deadline
            time.sleep(0.1)
        assert standby.is_leader()
        c2 = InferClient(scheduler=f"127.0.0.1:{standby.port}")
        np.testing.assert_allclose(
            c2.infer(x)["y"], x @ params_for_step(F, C, 0)["w"],
            rtol=1e-5)
    finally:
        if rep is not None:
            rep.close()
        standby.close()
        primary.close()


# ---------------------------------------------------------------------------
# ServePolicy: the decide arithmetic and the scheduler's decision log
# ---------------------------------------------------------------------------


def test_serve_policy_decide_pinned():
    p = ServePolicy(q_hi=8.0, q_lo=0.5, up_after=3, down_after=2,
                    min_replicas=1, max_replicas=3)
    live, base = ["a", "b"], {"a"}
    hot = {"a": 9.0, "b": 9.0}
    d = p.decide(live, base, hot, 0, 0)
    assert d.action == "hold" and (d.hi_streak, d.lo_streak) == (1, 0)
    assert d.breached == ["a", "b"]
    d = p.decide(live, base, hot, d.hi_streak, 0)
    assert d.action == "hold" and d.hi_streak == 2
    d = p.decide(live, base, hot, d.hi_streak, 0)
    assert d.action == "scale_up" and d.want == 1
    # at the fleet's bound the streak saturates and never fires again
    d = p.decide(["a", "b", "c"], base, {"a": 9.0, "b": 9.0, "c": 9.0},
                 3, 0)
    assert d.action == "hold" and d.hi_streak == 3
    d = p.decide(live, base, {}, 0, 1)
    assert d.action == "scale_down" and d.host == "b"
    d = p.decide(["a"], base, {}, 0, 99)
    assert d.action == "hold"  # at min_replicas
    d = p.decide(live, base, {"a": 2.0, "b": 2.0}, 2, 1)
    assert (d.hi_streak, d.lo_streak) == (0, 0)


def test_scheduler_autoscale_decision_log(tmp_path, monkeypatch):
    monkeypatch.setenv("DT_SERVE_POLICY", "1")
    monkeypatch.setenv("DT_SERVE_QHI", "4")
    monkeypatch.setenv("DT_SERVE_QLO", "0.5")
    monkeypatch.setenv("DT_SERVE_UP_AFTER", "2")
    monkeypatch.setenv("DT_SERVE_DOWN_AFTER", "2")
    monkeypatch.setenv("DT_SERVE_MIN_REPLICAS", "1")
    monkeypatch.setenv("DT_SERVE_MAX_REPLICAS", "2")
    sched = Scheduler(initial_workers=[],
                      host_worker_file=str(tmp_path / "hosts"))
    try:
        def beat(host, depth):
            return protocol.request(
                "127.0.0.1", sched.port,
                {"cmd": "serve_heartbeat", "host": host,
                 "gauges": {"serve.queue_depth": depth},
                 "weights_step": 0, "refreshes": 0})

        protocol.request("127.0.0.1", sched.port,
                         {"cmd": "serve_register", "host": "s0",
                          "addr": ["127.0.0.1", 1], "weights_step": 0})
        # sustained pressure: one scale_up (evaluations are throttled to
        # 4 a second, so the beats are paced past it)
        deadline = time.time() + 20
        while True:
            v = protocol.request("127.0.0.1", sched.port,
                                 {"cmd": "serve_endpoints"})
            if v["want"] == 2:
                break
            assert time.time() < deadline
            beat("s0", 9.0)
            time.sleep(0.15)
        protocol.request("127.0.0.1", sched.port,
                         {"cmd": "serve_register", "host": "s1",
                          "addr": ["127.0.0.1", 2], "weights_step": 0})
        # sustained idle: one scale_down draining the non-base replica
        deadline = time.time() + 20
        while True:
            v = protocol.request("127.0.0.1", sched.port,
                                 {"cmd": "serve_endpoints"})
            if v["want"] == 1:
                break
            assert time.time() < deadline
            beat("s0", 0.0)
            beat("s1", 0.0)
            time.sleep(0.15)
        assert v["replicas"]["s1"]["draining"] is True
        assert not v["replicas"]["s0"]["draining"]
        assert v["decisions"] == [
            {"seq": 0, "kind": "scale_up", "n_before": 1, "n_after": 2},
            {"seq": 1, "kind": "scale_down", "n_before": 2,
             "n_after": 1, "host": "s1"}]
        json.dumps(v["decisions"], sort_keys=True)
        # a drained replica registering again keeps its flag
        protocol.request("127.0.0.1", sched.port,
                         {"cmd": "serve_register", "host": "s1",
                          "addr": ["127.0.0.1", 2], "weights_step": 0})
        v = protocol.request("127.0.0.1", sched.port,
                             {"cmd": "serve_endpoints"})
        assert v["replicas"]["s1"]["draining"] is True
        assert v["want"] == 1
        st = protocol.request("127.0.0.1", sched.port, {"cmd": "status"})
        assert st["serving"]["want"] == 1
        assert st["serving"]["decisions"] == 2
        dump = sched.obs_dump()
        assert sorted(dump["serving"]["replicas"]) == ["s0", "s1"]
    finally:
        sched.close()


def test_drain_rejects_new_but_finishes_queued():
    gw, _ = _gateway(deadline_ms=100.0)
    try:
        addr = ("127.0.0.1", gw.port)
        x = np.ones((2, F), np.float32)
        protocol.request(addr[0], addr[1],
                         {"cmd": "infer", "x": x, "wait": False,
                          "rid": "q0"})
        gw.drain()
        resp = protocol.request(addr[0], addr[1],
                                {"cmd": "infer", "x": x})
        assert resp.get("error") == "draining"
        out = InferClient(replicas=[addr]).result("q0", addr, wait_s=30.0)
        np.testing.assert_allclose(
            out["y"], x @ params_for_step(F, C, 0)["w"], rtol=1e-5)
        deadline = time.time() + 10
        while not gw.drained():
            assert time.time() < deadline
            time.sleep(0.02)
    finally:
        gw.close()


# ---------------------------------------------------------------------------
# the export and the dtop serving board (the JAX package's golden)
# ---------------------------------------------------------------------------


def _serve_job():
    """A pinned serving section with every kind of board row."""
    return {
        "tracks": {"control-plane": {
            "records": [["i", 1, "serve.scale", 1000, None, 1, None,
                         None, {"kind": "scale_up", "host": None,
                                "replicas": 3}]],
            "counters": {}, "dropped": 0}},
        "serving": {
            "enabled": True,
            "want": 2,
            "replicas": {
                "s0": {"addr": ["127.0.0.1", 1],
                       "gauges": {"serve.qps": 123.4,
                                  "serve.p99_ms": 41.5,
                                  "serve.queue_depth": 3.0},
                       "weights_step": 8, "refreshes": 1,
                       "draining": False},
                "s1": {"addr": ["127.0.0.1", 2],
                       "gauges": {"serve.qps": 0.0,
                                  "serve.p99_ms": 0.0,
                                  "serve.queue_depth": 0.0},
                       "weights_step": 0, "refreshes": 0,
                       "draining": True}},
            "decisions": [
                {"seq": 0, "kind": "scale_up", "n_before": 1,
                 "n_after": 2},
                {"seq": 1, "kind": "scale_down", "n_before": 2,
                 "n_after": 1, "host": "s1"}]}}


def test_export_threads_serving_section():
    chrome = obs_export.chrome_trace(_serve_job())
    summary = obs_export.summarize_chrome(chrome)
    assert summary["serving"]["want"] == 2
    assert summary["serving"]["replicas"]["s0"]["weights_step"] == 8
    assert [d["kind"] for d in summary["serving"]["decisions"]] == \
        ["scale_up", "scale_down"]
    assert summary["serve_events"] == [
        {"track": "control-plane", "ts": 1000, "what": "serve.scale",
         "kind": "scale_up", "host": None, "replicas": 3}]


def test_dtop_serving_board_golden(tmp_path):
    chrome = obs_export.chrome_trace(_serve_job())
    trace = str(tmp_path / "t.json")
    with open(trace, "w") as f:
        json.dump(chrome, f)
    r = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools", "dtop.py"), trace],
        capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    start = r.stdout.index("serving board")
    section = r.stdout[start:].split("\n\n")[0] + "\n"
    golden = os.path.join(ROOT, "tests", "fixtures", "serve_board.golden")
    assert section == open(golden).read(), section


def test_stats_counters_mirror_obs_plane():
    # Predictor.stats and the predict.* counters of the obs plane agree
    pred = toy_predictor(F, C, max_batch=8, device="cpu")
    pred.warmup(feature_shape=(F,))
    tr = obs_trace.tracer()
    before = tr.get_counter("predict.requests")
    rows_before = tr.get_counter("predict.rows")
    pred.predict(np.ones((3, F), np.float32))
    assert pred.stats["requests"] == 1 and pred.stats["rows"] == 3
    assert tr.get_counter("predict.requests") == before + 1
    assert tr.get_counter("predict.rows") == rows_before + 3


# ---------------------------------------------------------------------------
# the replica's command line
# ---------------------------------------------------------------------------


def test_replica_cli_serves_and_refreshes_on_the_cpu(tmp_path):
    """``python -m dt_tpu_torch.serve.replica --device cpu`` registers with
    the scheduler, answers ``x @ params_for_step`` at its start step, takes
    a rolling refresh and stops on the ``shutdown`` command."""
    from torch_one_thread import ENV
    sched = Scheduler(initial_workers=[],
                      host_worker_file=str(tmp_path / "hosts"))
    port_file = str(tmp_path / "port")
    env = dict(os.environ, PYTHONPATH=ROOT, **ENV)
    proc = subprocess.Popen(
        [sys.executable, "-m", "dt_tpu_torch.serve.replica",
         "--scheduler", f"127.0.0.1:{sched.port}", "--host", "c0",
         "--device", "cpu", "--features", str(F), "--classes", str(C),
         "--max-batch", "8", "--weights-step", "2",
         "--port-file", port_file], cwd=ROOT, env=env)
    try:
        c = InferClient(scheduler=f"127.0.0.1:{sched.port}")
        deadline = time.time() + 60
        while not (os.path.exists(port_file) and c.refresh_endpoints()):
            assert proc.poll() is None, "the replica exited"
            assert time.time() < deadline
            time.sleep(0.1)
        x = np.random.RandomState(2).randn(5, F).astype(np.float32)
        out = c.infer(x)
        assert out["weights_step"] == 2
        np.testing.assert_allclose(
            out["y"], x @ params_for_step(F, C, 2)["w"], rtol=1e-5)
        wave = RollingRefresher(f"127.0.0.1:{sched.port}").poll_once(step=5)
        assert wave == {"step": 5, "applied": ["c0"], "skipped": []}
        out = c.infer(x)
        assert out["weights_step"] == 5
        np.testing.assert_allclose(
            out["y"], x @ params_for_step(F, C, 5)["w"], rtol=1e-5)
        gport = int(open(port_file).read())
        assert protocol.request("127.0.0.1", gport,
                                {"cmd": "shutdown"}) == {}
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        sched.close()


def test_replica_cli_refuses_onnx_and_a_missing_card(tmp_path):
    """``--onnx`` (refused until the ONNX slice was ported) now serves: a
    replica process on the CPU answers ``x @ w`` from a file the port
    exported, and stops on ``shutdown``.  A replica made for the card
    still never falls back to the CPU."""
    import torch

    from dt_tpu_torch import onnx as tonnx
    from torch_one_thread import ENV
    w = params_for_step(F, C, 0)["w"]
    path = str(tmp_path / "linear.onnx")
    tonnx.export_onnx(lambda x: x @ torch.from_numpy(w),
                      np.ones((2, F), np.float32), path=path)
    sched = Scheduler(initial_workers=[],
                      host_worker_file=str(tmp_path / "hosts"))
    port_file = str(tmp_path / "port")
    env = dict(os.environ, PYTHONPATH=ROOT, **ENV)
    proc = subprocess.Popen(
        [sys.executable, "-m", "dt_tpu_torch.serve.replica",
         "--scheduler", f"127.0.0.1:{sched.port}", "--host", "onnx0",
         "--onnx", path, "--device", "cpu", "--max-batch", "8",
         "--port-file", port_file], cwd=ROOT, env=env)
    try:
        c = InferClient(scheduler=f"127.0.0.1:{sched.port}")
        deadline = time.time() + 60
        while not (os.path.exists(port_file) and c.refresh_endpoints()):
            assert proc.poll() is None, "the replica exited"
            assert time.time() < deadline
            time.sleep(0.1)
        x = np.random.RandomState(4).randn(5, F).astype(np.float32)
        np.testing.assert_allclose(c.infer(x)["y"], x @ w, rtol=1e-5)
        gport = int(open(port_file).read())
        try:  # the gateway closes as it handles it: the answer may not leave
            protocol.request("127.0.0.1", gport, {"cmd": "shutdown"},
                             timeout=30)
        except ConnectionError:
            pass
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        sched.close()
    if not torch.cuda.is_available():
        # a replica made for the card never falls back to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            toy_predictor(F, C)
