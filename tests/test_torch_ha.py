"""Scheduler HA of the port: the warm standby, the leader lease with
fencing, round replication and client failover (``tests/test_ha.py:
490-589`` held on the port, and across the packages).

- A job's primary is a port ``scheduler_main`` process with a journal and
  a lease, its warm standby another one tailing the same journal; the
  workers get both endpoints through ``DT_CTRL_ENDPOINTS``.  The primary
  is SIGKILLed mid-job; the standby takes over once, under the next
  incarnation, and the workers' params at every epoch end are bit for bit
  those of the same fleet's never-killed run: port workers in f32, port
  workers with the overlapped 2-bit step (a round in flight resends its
  words), and a mixed fleet of a port and a JAX worker.
- A parked barrier completes exactly once across an in-process failover,
  a port and a JAX client on either side of it.
- A round replica carrying a stale incarnation is refused.
"""

import json
import os
import signal
import threading
import time

import pytest

import torch_elastic_job as job
from dt_tpu.elastic import WorkerClient as JClient
from dt_tpu.elastic import protocol as jproto
from dt_tpu_torch.elastic import journal, protocol
from dt_tpu_torch.elastic.client import WorkerClient, parse_endpoints
from dt_tpu_torch.elastic.scheduler import Scheduler
from dt_tpu_torch.obs import trace as obs_trace
from test_torch_elastic_mixed_ref import save_jax_init
from torch_one_thread import ENV, one_torch_thread  # noqa: F401 (fixture)

#: the default lease: a tighter one lets a standby depose a primary whose
#: renewal thread merely starved on a loaded host (the protocol working,
#: but not the scenario under test)
LEASE_S = 2.0
EPOCHS = 2
KILL_AT = 11  # w0's global step: mid-epoch 1 of 8-step epochs
#: a sleep each batch (a site-scoped delay: the trajectory is unchanged),
#: so the kill lands mid-job on any machine
SLOW = json.dumps({"seed": 0, "rules": [
    {"kind": "delay", "op": "send", "site": "worker.step",
     "delay_s": 0.03}]})


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("DT_CTRL_ENDPOINTS", raising=False)
    monkeypatch.delenv("DT_FAULT_PLAN", raising=False)
    with job.deadline(200):
        yield
    obs_trace.set_enabled(None)


def _ha_job(tmp, kinds, kill, args=(), npz=None):
    """One job under an HA pair of port scheduler processes; with
    ``kill`` the primary is SIGKILLed once w0 passed ``KILL_AT``.
    Returns ``(results by host, standby trace, audit)``."""
    os.makedirs(tmp, exist_ok=True)
    hw = os.path.join(tmp, "host_worker")
    job.write_hosts(hw, list(kinds))
    jp = os.path.join(tmp, "ctrl.journal")
    common = ["--journal", jp, "--host-worker-file", hw,
              "--lease-s", str(LEASE_S)]
    sb, sb_port = job.start_scheduler(
        tmp, "standby", ["--standby"] + common, env={"DT_OBS": "1"})
    pr, pr_port = job.start_scheduler(
        tmp, "primary", ["--peer", f"127.0.0.1:{sb_port}"] + common)
    env = dict(ENV, DT_OBS="1", DT_FAULT_PLAN=SLOW,
               DT_CTRL_ENDPOINTS=f"127.0.0.1:{pr_port},127.0.0.1:{sb_port}")
    outs = {h: os.path.join(tmp, f"{h}.json") for h in kinds}
    progress = os.path.join(tmp, "w0.progress")
    procs = {}
    try:
        for h, kind in kinds.items():
            extra = list(args) if kind == "port" else []
            if kind == "port" and h == "w0":
                extra += ["--progress", progress]
                if npz:
                    extra += ["--init-npz", npz]
            procs[h] = job.spawn(kind, pr_port, h, outs[h], EPOCHS, env,
                                 args=extra)
        if kill:
            deadline = time.monotonic() + 120
            while job.read_step(progress) < KILL_AT:
                assert time.monotonic() < deadline, "w0 made no progress"
                assert all(p.poll() is None for p in procs.values())
                time.sleep(0.005)
            pr.send_signal(signal.SIGKILL)
            pr.wait(timeout=30)
        job.wait_ok(procs, timeout=240)
        tr = _standby_trace(sb_port)
    finally:
        job.kill_all(procs)
        job.stop_scheduler(pr, pr_port)
        job.stop_scheduler(sb, sb_port)
    return {h: job.load(outs[h]) for h in outs}, tr, \
        (job.audit(hw) if os.path.exists(hw + "_log") else [])


def _standby_trace(port):
    """The standby's control-plane records (its ``obs_dump``) and its
    incarnation (its ``status``)."""
    dump = protocol.request("127.0.0.1", port, {"cmd": "obs_dump"},
                            timeout=10)["job"]["tracks"]["control-plane"]
    status = protocol.request("127.0.0.1", port, {"cmd": "status"},
                              timeout=10)
    return {"records": dump["records"],
            "incarnation": status["incarnation"]}


def _elected(tr):
    return [r for r in tr["records"] if r[2] == "leader.elected"]


@pytest.mark.parametrize("fleet,args", [
    ({"w0": "port", "w1": "port"}, ()),
    ({"w0": "port", "w1": "port"}, ("--compress", "0.005")),
    ({"w0": "port", "w1": "jax"}, ()),
], ids=["port_f32", "port_2bit_overlap", "mixed_port_jax"])
def test_standby_takes_over_from_killed_primary_bit_identical(
        tmp_path, fleet, args):
    npz = None
    if "jax" in fleet.values():
        npz = str(tmp_path / "init.npz")
        save_jax_init(npz)
    base, tr0, audit0 = _ha_job(str(tmp_path / "base"), fleet, False, args,
                                npz)
    killed, tr1, audit1 = _ha_job(str(tmp_path / "kill"), fleet, True, args,
                                  npz)
    # the never-killed pair: the standby never led
    assert tr0["incarnation"] == 0 and _elected(tr0) == []
    # the kill: exactly one takeover, the fence up by one, one failover
    # span (a worker's own fence may stay the old one: a request the
    # successor took over for answers without a reattach, as in the JAX
    # package)
    assert tr1["incarnation"] == 2
    assert [r[8]["incarnation"] for r in _elected(tr1)] == [2]
    spans = [r for r in tr1["records"]
             if r[0] == "X" and r[2] == "scheduler.failover"]
    assert len(spans) == 1 and spans[0][8]["incarnation"] == 2
    for h, kind in fleet.items():
        assert killed[h]["final_step"] == base[h]["final_step"] == \
            EPOCHS * 8
        if kind == "port":
            assert base[h]["fence"] == 1 and killed[h]["fence"] in (1, 2)
            assert killed[h]["failovers"] >= 1
            # every epoch end, bit for bit
            assert [e["sha256"] for e in killed[h]["epochs"]] == \
                [e["sha256"] for e in base[h]["epochs"]]
        for k in ("param_sum", "param_hash"):
            assert killed[h][k] == base[h][k], (h, k)
    assert audit0 == audit1 == []


def test_parked_barrier_completes_once_across_failover(tmp_path):
    """A port primary and standby in this process, a port and a JAX
    client: w0 parks at a barrier on the primary, the primary dies, the
    replayed arrival parks on the successor until w1 arrives."""
    obs_trace.set_enabled(True)
    jp = str(tmp_path / "ctrl.journal")
    lp = str(tmp_path / "ctrl.lease")
    standby = Scheduler(standby=True, journal_path=jp, lease_path=lp,
                        lease_s=2.0)
    primary = Scheduler(initial_workers=["w0", "w1"], journal_path=jp,
                        lease_path=lp, lease_s=2.0)
    eps = [("127.0.0.1", primary.port), ("127.0.0.1", standby.port)]
    assert parse_endpoints(f"127.0.0.1:{primary.port},:{standby.port}") \
        == eps
    cs = []
    try:
        assert primary.is_leader() and primary.incarnation == 1
        assert not standby.is_leader()
        c0 = WorkerClient("127.0.0.1", primary.port, host="w0",
                          heartbeat_interval_s=30.0, endpoints=eps)
        c1 = JClient("127.0.0.1", primary.port, host="w1",
                     heartbeat_interval_s=30.0, endpoints=eps)
        cs = [c0, c1]
        assert c0.fence == 1
        # a passive standby refuses all but the passive commands
        assert jproto.request("127.0.0.1", standby.port,
                              {"cmd": "membership"}, timeout=10) == {
            "error": "not_leader", "incarnation": 0}
        assert jproto.request("127.0.0.1", standby.port,
                              {"cmd": "status"}, timeout=10)["active"] \
            is False
        t = threading.Thread(target=c0.barrier, daemon=True)
        t.start()
        c1.barrier()
        t.join(timeout=30)
        assert not t.is_alive()
        c0.publish_snapshot({"step": 3, "params": [1.0, 2.0]})

        done0 = threading.Event()

        def park():
            c0.barrier()
            done0.set()

        threading.Thread(target=park, daemon=True).start()
        deadline = time.time() + 30
        while True:
            with primary._lock:
                if "w0" in primary._state.plain_arrived:
                    break
            assert time.time() < deadline
            time.sleep(0.01)
        primary.close()  # severed connections, as the process dying
        time.sleep(3.0)  # past the lease: the failover window is over
        assert not done0.is_set(), \
            "the parked worker cleared the barrier alone"
        c1.barrier()  # fails over, completes the barrier fleet-wide
        assert done0.wait(timeout=30)
        assert standby.is_leader() and standby.incarnation == 2
        assert c0.fence == 2
        assert c1.fetch_snapshot() == {"step": 3, "params": [1.0, 2.0]}
        spans = [r for r in standby._obs.snapshot()["records"]
                 if r[0] == "X" and r[2] == "scheduler.failover"]
        assert len(spans) == 1
        with standby._lock:
            live = standby._state.struct()
        assert journal.ControlState.rebuild(jp).struct() == live
        assert obs_trace.tracer().get_counter("client.failover") >= 1
    finally:
        for c in cs:
            c.close()
        standby.close()
        primary.close()


def test_stale_incarnation_round_replica_refused(tmp_path):
    jp = str(tmp_path / "ctrl.journal")
    lease = journal.Lease(str(tmp_path / "ctrl.lease"))
    lease.acquire("sched:old")  # incarnation 1, the dead primary
    standby = Scheduler(standby=True, journal_path=jp,
                        lease_path=str(tmp_path / "ctrl.lease"),
                        lease_s=0.2)
    try:
        deadline = time.time() + 30
        while not standby.is_leader() and time.time() < deadline:
            time.sleep(0.05)  # the lease is stale already: takeover
        assert standby.is_leader() and standby.incarnation == 2
        stale = protocol.request(
            "127.0.0.1", standby.port,
            {"cmd": "ha_round", "fence": 1, "key": "g", "gen": 5,
             "seqs": {"w0": 0}, "value": [1.0]}, timeout=10)
        assert "fenced" in stale.get("error", "")
        fresh = protocol.request(
            "127.0.0.1", standby.port,
            {"cmd": "ha_round", "fence": 2, "key": "g", "gen": 5,
             "seqs": {"w0": 0}, "value": [1.0]}, timeout=10)
        assert "error" not in fresh
        # the installed round answers a retry of its contribution
        again = protocol.request(
            "127.0.0.1", standby.port,
            {"cmd": "allreduce", "host": "w0", "key": "g", "seq": 0,
             "value": [9.0]}, timeout=10)
        assert again == {"value": [1.0]}
    finally:
        standby.close()
