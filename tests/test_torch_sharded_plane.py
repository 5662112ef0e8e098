"""The range-server (sharded) data plane of the port, against the
single-funnel plane and across the packages, on the CPU (the port's twin of
``tests/test_sharded_plane.py``).

Each case runs on four fleets: port clients against the port's scheduler
and range servers (``port``), port clients against the JAX package's
(``ref_servers``), JAX clients against the port's (``jax_clients``), and a
JAX and a port client together against the port's (``mixed``).  The dense,
2-bit and row-sparse allreduce and the ``dist_async`` trajectories (sgd
with momentum, adam, the lazy sparse update and row pulls, over three
servers holding 4 + 3 + 3 rows) must be bit for bit what the same clients
get from the scheduler alone.  The port's fleet also keeps its answers
under a seeded fault plan (dup, reorder, drop), completes a round when a
worker is evicted mid-round, waits for a joiner, and aggregates the
staleness across servers.  Every thread join has a deadline (``test_torch_async._parallel``).
"""

import numpy as np
import pytest
import torch

from dt_tpu.elastic import RangeServer as JRangeServer
from dt_tpu.elastic import Scheduler as JScheduler
from dt_tpu.elastic import WorkerClient as JClient
from dt_tpu.elastic.client import _row_bounds as jrow_bounds
from dt_tpu.ops.sparse import RowSparse as JRowSparse
from dt_tpu.parallel.compression import np_quantize_2bit
from dt_tpu_torch.elastic import faults as tfaults
from dt_tpu_torch.elastic.client import WorkerClient as TClient
from dt_tpu_torch.elastic.client import _row_bounds
from dt_tpu_torch.elastic.range_server import RangeServer as TRangeServer
from dt_tpu_torch.elastic.scheduler import Scheduler as TScheduler
from dt_tpu_torch.ops.sparse import RowSparse as TRowSparse
from test_torch_async import _parallel
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

TOPOLOGIES = ("port", "ref_servers", "jax_clients", "mixed")


def _fleet(topo, n_workers=2, n_servers=2, **sched_kw):
    hosts = [f"w{i}" for i in range(n_workers)]
    ref = topo == "ref_servers"
    sched = (JScheduler if ref else TScheduler)(initial_workers=hosts,
                                                **sched_kw)
    servers = [(JRangeServer if ref else TRangeServer)(
        "127.0.0.1", sched.port, i, advertise_host="127.0.0.1",
        membership_ttl_s=0.2, poll_interval_s=0.2)
        for i in range(n_servers)]
    kinds = {"port": [TClient], "ref_servers": [TClient],
             "jax_clients": [JClient], "mixed": [JClient, TClient]}[topo]
    clients = [kinds[i % len(kinds)]("127.0.0.1", sched.port, host=h,
                                     heartbeat_interval_s=0.2)
               for i, h in enumerate(hosts)]
    for c in clients:
        c.refresh_servers()
        assert len(c.servers) == n_servers
    return sched, servers, clients


def _close(sched, servers, clients):
    for c in clients:
        c.close()
    for s in servers:
        s.close()
    sched.close()


def _run(fleet, fn):
    """``fn(clients)`` on a fleet, closed after."""
    sched, servers, clients = fleet
    try:
        return fn(clients)
    finally:
        _close(sched, servers, clients)


def _bytes(x):
    """A result as comparable bytes: arrays, RowSparse (either package's)
    and dicts of them."""
    if isinstance(x, (JRowSparse, TRowSparse)):
        return (_bytes(x.indices), _bytes(x.values), x.num_rows)
    if isinstance(x, dict):
        return tuple((k, _bytes(v)) for k, v in sorted(x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_bytes(v) for v in x)
    if isinstance(x, torch.Tensor):
        x = x.numpy()
    if isinstance(x, int):
        return x
    a = np.asarray(x)
    return (a.dtype.str, a.shape, a.tobytes())


def test_row_bounds_split_as_the_jax_client():
    for n in (0, 1, 5, 7, 16, 1000):
        for r in (1, 2, 3, 4, 7):
            b = _row_bounds(n, r)
            assert b == jrow_bounds(n, r)
            assert [b[j + 1] - b[j] for j in range(r)] == \
                [len(p) for p in np.array_split(np.arange(n), r)]


# -- the cases: each returns what the clients got ---------------------------


def _dense(clients, monkeypatch):
    rng = np.random.RandomState(0)
    out = []
    for size, chunk in ((16, None), (6000, "4096"), (100_000, None)):
        if chunk:
            monkeypatch.setenv("DT_AR_CHUNK_BYTES", chunk)
        vs = [rng.normal(size=size).astype(np.float32)
              for _ in clients]
        out.append(_parallel([lambda c=c, v=v: c.allreduce(f"d{size}", v)
                              for c, v in zip(clients, vs)]))
        monkeypatch.delenv("DT_AR_CHUNK_BYTES", raising=False)
    return out


def _two_bit(clients, monkeypatch):
    rng = np.random.RandomState(1)
    n = 50_001  # not a whole number of packing words
    monkeypatch.setenv("DT_AR_CHUNK_BYTES", "65536")
    payloads = []
    for _ in clients:
        g = rng.normal(scale=0.01, size=n).astype(np.float32)
        words, _ = np_quantize_2bit(g, np.zeros_like(g), 0.005)
        payloads.append({"packed": words, "n": n, "threshold": 0.005})
    return _parallel([lambda c=c, p=p: c.allreduce("g2", p)
                      for c, p in zip(clients, payloads)])


def _sparse(clients, monkeypatch):
    rng = np.random.RandomState(2)
    out = []
    for rnd in range(2):
        fns = []
        for i, c in enumerate(clients):
            ids = rng.randint(0, 11, size=6).astype(np.int32)
            ids[0] = 11  # a sentinel slot
            vals = rng.normal(size=(6, 3)).astype(np.float32)
            rs = JRowSparse(ids, vals, 11) if isinstance(c, JClient) else \
                TRowSparse(torch.from_numpy(ids), torch.from_numpy(vals), 11)
            fns.append(lambda c=c, rs=rs: c.allreduce_sparse("se", rs))
        out.append(_parallel(fns))
    return out


def _async(clients, monkeypatch):
    """Worker 0 alone drives the master: sgd with momentum on a dense key
    and a lazy-sparse table (pushes and row pulls), then adam on another
    key (its step count advances once a push on every shard)."""
    c = clients[0]
    rng = np.random.RandomState(3)
    out = []
    c.set_optimizer({"name": "sgd", "learning_rate": 0.05,
                     "momentum": 0.9, "weight_decay": 1e-3})
    out.append(c.async_init("p", np.linspace(-1, 1, 50).astype(np.float32)
                            .reshape(10, 5)))
    out.append(c.async_init("emb", rng.normal(size=(10, 2))
                            .astype(np.float32)))
    for _ in range(4):
        out.append(c.async_push("p", rng.normal(size=(10, 5))
                                .astype(np.float32)))
        ids = rng.randint(0, 12, size=5)
        out.append(c.async_push_sparse("emb", ids, rng.normal(size=(5, 2))
                                       .astype(np.float32)))
    out.append(c.async_pull_rows("emb", np.array([0, 3, 4, 9, 11])))
    c.set_optimizer({"name": "adam", "learning_rate": 0.01})
    out.append(c.async_init("q", np.ones((7, 3), np.float32)))
    for _ in range(3):
        out.append(c.async_push("q", rng.normal(size=(7, 3))
                                .astype(np.float32)))
    return out


CASES = {"dense": (_dense, 2), "two_bit": (_two_bit, 2),
         "sparse": (_sparse, 2), "async": (_async, 3)}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("topo", TOPOLOGIES)
def test_sharded_is_bit_identical_to_the_funnel(topo, case, monkeypatch):
    fn, n_servers = CASES[case]
    funnel = _run(_fleet(topo, n_servers=0), lambda c: fn(c, monkeypatch))
    sharded = _run(_fleet(topo, n_servers=n_servers),
                   lambda c: fn(c, monkeypatch))
    assert _bytes(sharded) == _bytes(funnel)


def test_port_fleet_keeps_its_answers_under_faults(monkeypatch):
    """Seeded dup, reorder and drop of ``async_push`` and ``allreduce``
    frames (sent and received) at the clients and the servers: the async
    trajectory and the averages are the fault-free ones, bit for bit (the
    (host, key, seq) dedup never applies a push twice)."""
    clean = _run(_fleet("port", n_servers=3),
                 lambda c: (_async(c, monkeypatch),
                            _dense(c, monkeypatch)))
    plan = tfaults.FaultPlan([
        {"kind": "dup", "op": "send", "cmd": ["async_push", "allreduce"],
         "prob": 0.5},
        {"kind": "reorder", "op": "send", "cmd": "async_push", "prob": 0.3,
         "delay_s": 0.02},
        {"kind": "drop", "op": "recv", "cmd": ["async_push", "allreduce"],
         "prob": 0.2}], seed=0)
    tfaults.install(plan)
    try:
        faulty = _run(_fleet("port", n_servers=3),
                      lambda c: (_async(c, monkeypatch),
                                 _dense(c, monkeypatch)))
    finally:
        tfaults.clear()
    fired = {idx for idx, _, _ in plan.applied_summary()}
    assert fired == {0, 1, 2}, plan.applied_summary()
    assert _bytes(faulty) == _bytes(clean)


def test_port_fleet_completes_a_round_when_a_worker_is_evicted():
    sched, servers, clients = _fleet("port", n_workers=3,
                                     auto_evict_dead_s=1.0,
                                     startup_grace_s=1.0)
    try:
        clients[2].close()  # stops heartbeating: evicted
        vs = [np.full(8, float(i), np.float32) for i in range(2)]
        res = _parallel([lambda i=i: clients[i].allreduce("r", vs[i])
                         for i in range(2)])
        np.testing.assert_array_equal(res[0], (vs[0] + vs[1]) / 2)
        assert "w2" not in sched._state.workers
    finally:
        _close(sched, servers, clients[:2])


@pytest.mark.parametrize("topo", ["port", "ref_servers"])
def test_joiner_and_staleness_across_the_fleet(topo):
    """A worker registered after the fleet contributes to the servers'
    round (they refresh their membership on the unknown host); the
    staleness aggregates over the servers: max over them, the
    push-weighted mean."""
    sched, servers, clients = _fleet(topo)
    new = TClient("127.0.0.1", sched.port, host="w_new", is_new=True,
                  heartbeat_interval_s=0.2)
    try:
        new.refresh_servers()
        every = clients + [new]
        vs = [np.full(4, float(i + 1), np.float32) for i in range(3)]
        res = _parallel([lambda i=i: every[i].allreduce("j", vs[i])
                         for i in range(3)])
        np.testing.assert_array_equal(res[2], (vs[0] + vs[1] + vs[2]) / 3)
        c0, c1 = clients
        c0.set_optimizer({"name": "sgd", "learning_rate": 0.1})
        w = np.zeros(8, np.float32)
        c0.async_init("w", w)
        c1.async_init("w", w)
        g = np.ones(8, np.float32)
        for c in (c0, c1, c1, c0):
            c.async_push("w", g)
        st = c0.async_stats()
        assert (st["max_staleness"], st["measured_pushes"]) == (2, 4), st
        assert st["mean_staleness"] == pytest.approx(1.0)
        stats = [s._dp.async_stats() for s in servers]
        assert [s["keys"] for s in stats] == [1, 1]
    finally:
        new.close()
        _close(sched, servers, clients)
