"""The port's scheduler answers a scripted sequence exactly as the JAX
package's does.  One script (register, dense and 2-bit allreduce, the
snapshot, membership barriers with an add and then a remove, the plain
barrier, ``num_dead``, ``drain``) runs against each scheduler through the
JAX package's wire; responses, ranks and averages must be equal bit for
bit, and the audit lines equal up to their timestamps."""

import threading

import numpy as np
import pytest

from dt_tpu.elastic import Scheduler as JScheduler
from dt_tpu.elastic import protocol as jproto
from dt_tpu.parallel.compression import np_quantize_2bit
from dt_tpu_torch.elastic.scheduler import Scheduler as TScheduler
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)


def _write(path, hosts):
    with open(path, "w") as f:
        f.write("\n".join(hosts) + "\n")


def _parallel(port, msgs):
    """Send ``msgs`` concurrently (a collective); responses in order."""
    out = [None] * len(msgs)

    def one(i, m):
        out[i] = jproto.request("127.0.0.1", port, m, timeout=60)

    ts = [threading.Thread(target=one, args=(i, m))
          for i, m in enumerate(msgs)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not any(t.is_alive() for t in ts)
    return out


def _script(cls, tmp_path):
    hw = str(tmp_path / "host_worker")
    _write(hw, ["w0", "w1"])
    launched = []

    def operator(epoch):
        if epoch == 1:
            _write(hw, ["w0", "w1", "w2"])
        elif epoch == 2:
            _write(hw, ["w0", "w1"])

    sched = cls(host_worker_file=hw, pre_change_hook=operator,
                launch_callback=lambda h, e: launched.append((h, e)))
    port = sched.port
    rng = np.random.RandomState(5)
    log = []

    def req(label, msg):
        log.append((label, jproto.request("127.0.0.1", port, msg,
                                          timeout=60)))

    def coll(label, msgs):
        log.append((label, _parallel(port, msgs)))

    try:
        for h in ("w0", "w1"):
            req(f"register {h}", {"cmd": "register", "host": h,
                                  "is_new": False, "is_recovery": False})
        req("heartbeat", {"cmd": "heartbeat", "host": "w0", "pseq": 0})
        g = [rng.normal(size=3001).astype(np.float32) for _ in range(2)]
        coll("dense", [{"cmd": "allreduce", "host": h, "key": "grads",
                        "seq": 0, "value": g[i]}
                       for i, h in enumerate(("w0", "w1"))])
        packed = [np_quantize_2bit(g[i] * 0.01, np.zeros_like(g[i]),
                                   0.005)[0] for i in range(2)]
        coll("packed", [{"cmd": "allreduce", "host": h, "key": "grads#b0",
                         "seq": 0, "value": {"packed": packed[i],
                                             "n": 3001, "threshold": 0.005}}
                        for i, h in enumerate(("w0", "w1"))])
        # a retried (host, seq) of a finished round: the cached result
        req("dense retry", {"cmd": "allreduce", "host": "w0",
                            "key": "grads", "seq": 0, "value": g[1]})
        snap = {"step": np.asarray(4, np.int32),
                "params": {"Dense_0": {"kernel": g[0][:6].reshape(3, 2)}}}
        req("publish", {"cmd": "publish_snapshot", "blob": snap})
        req("fetch", {"cmd": "fetch_snapshot"})
        coll("mc 0", [{"cmd": "mc_barrier", "host": h, "epoch": 0,
                       "info": {"EPOCH_BEGIN": 0}} for h in ("w0", "w1")])
        coll("mc 1 add", [{"cmd": "mc_barrier", "host": h, "epoch": 1,
                           "info": {"EPOCH_BEGIN": 1}}
                          for h in ("w0", "w1")])
        req("register w2", {"cmd": "register", "host": "w2", "is_new": True,
                            "is_recovery": False})
        req("mc 1 late", {"cmd": "mc_barrier", "host": "w2", "epoch": 1,
                          "info": {"EPOCH_BEGIN": 1}})
        g3 = [rng.normal(size=17).astype(np.float32) for _ in range(3)]
        coll("dense 3", [{"cmd": "allreduce", "host": h, "key": "stats",
                          "seq": 0, "value": g3[i]}
                         for i, h in enumerate(("w0", "w1", "w2"))])
        coll("barrier", [{"cmd": "barrier", "host": h, "seq": 0}
                         for h in ("w0", "w1", "w2")])
        coll("mc 2 remove", [{"cmd": "mc_barrier", "host": h, "epoch": 2,
                              "info": {"EPOCH_BEGIN": 2}}
                             for h in ("w0", "w1", "w2")])
        req("membership", {"cmd": "membership"})
        req("num_dead", {"cmd": "num_dead", "timeout_s": 1e6})
        req("drain w1", {"cmd": "drain", "host": "w1"})
        req("drain again", {"cmd": "drain", "host": "w1"})
        req("membership after drain", {"cmd": "membership"})
        req("removed re-register", {"cmd": "register", "host": "w2",
                                    "is_new": False, "is_recovery": False})
        audit = [ln.split()[:3] for ln in open(hw + "_log")]
        hosts = open(hw).read().split()
    finally:
        sched.close()
    return log, audit, hosts, launched


def _same(x, y) -> bool:
    if isinstance(x, dict):
        return isinstance(y, dict) and x.keys() == y.keys() and \
            all(_same(x[k], y[k]) for k in x)
    if isinstance(x, (list, tuple)):
        return type(x) is type(y) and len(x) == len(y) and \
            all(_same(a, b) for a, b in zip(x, y))
    if isinstance(x, np.ndarray):
        return isinstance(y, np.ndarray) and x.dtype == y.dtype and \
            x.shape == y.shape and x.tobytes() == y.tobytes()
    return type(x) is type(y) and x == y


def test_scripted_sequence_matches_the_jax_scheduler(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    ref = _script(JScheduler, tmp_path / "j")
    port = _script(TScheduler, tmp_path / "t")
    for (label, r), (label2, p) in zip(ref[0], port[0]):
        assert label == label2
        assert _same(r, p), (label, r, p)
    assert len(ref[0]) == len(port[0])
    assert ref[1:] == port[1:]
    assert port[1] == [["1", "ADDED", "w2"], ["2", "REMOVED", "w2"],
                       ["4", "DRAINED", "w1"]]
    assert port[3] == [("w2", 1)]


def test_unported_commands_name_their_item(tmp_path):
    sched = TScheduler(initial_workers=["w0"])
    try:
        for cmd, item in (("obs_push", "item 7"), ("health", "item 7"),
                          ("serve_endpoints", "item 5")):
            resp = jproto.request("127.0.0.1", sched.port, {"cmd": cmd},
                                  timeout=10)
            assert item in resp["error"] and "ROADMAP" in resp["error"]
        assert "unknown cmd" in jproto.request(
            "127.0.0.1", sched.port, {"cmd": "bogus"}, timeout=10)["error"]
        # the range-server registry and the dist_async store are served
        assert jproto.request("127.0.0.1", sched.port, {"cmd": "servers"},
                              timeout=10) == {"servers": []}
        assert jproto.request("127.0.0.1", sched.port,
                              {"cmd": "async_stats"}, timeout=10) == {
            "max_staleness": 0, "mean_staleness": 0.0,
            "measured_pushes": 0, "keys": 0}
        # obs_dump answers with the control-plane track alone
        dump = jproto.request("127.0.0.1", sched.port, {"cmd": "obs_dump"},
                              timeout=10)["job"]
        assert set(dump["tracks"]) == {"control-plane"}
        assert {"records", "counters", "dropped"} <= \
            set(dump["tracks"]["control-plane"])
        # scheduler HA and the fleet checkpoint are served now
        assert jproto.request("127.0.0.1", sched.port,
                              {"cmd": "ckpt_manifest"}, timeout=10) == {
            "committed": None, "pending": None, "resume": False}
        assert jproto.request(
            "127.0.0.1", sched.port,
            {"cmd": "ha_round", "fence": 0, "key": "g", "gen": 1,
             "seqs": {"w0": 0}, "value": np.zeros(2, np.float32)},
            timeout=10) == {}
    finally:
        sched.close()
    journaled = TScheduler(journal_path=str(tmp_path / "j"),
                           initial_workers=["w0"])
    try:
        assert journaled.incarnation == 1 and journaled.is_leader()
    finally:
        journaled.close()
