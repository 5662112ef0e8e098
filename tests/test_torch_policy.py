"""The port's policy engine against the JAX package's (``dt_tpu/policy``,
the straggler board of ``dt_tpu/elastic/dataplane.py``, the policy path of
``dt_tpu/elastic/scheduler.py``, the share-aware data iterator and the
gradient weight of ``Module.fit``).

Seeded random inputs through both packages' ``rescale`` functions and
``PolicyEngine.decide`` must give the same numbers and the same
``Decision``, field for field; the same arrival stamps (a patched
``time.monotonic_ns``) the same straggler scores, the overlapped window's
decay included; the same scripted boards the same barrier replies and
journal records from both schedulers, each journal rebuilding in the other
package; the same shares the same shards, index for index; the same
gradient and weight the same 2-bit words.  No test reads a wall-clock
lag: the boards are scripted or stamped by hand.
"""

import dataclasses
import threading
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_elastic_job as job
from dt_tpu import policy as jpolicy
from dt_tpu.data import io as jio
from dt_tpu.elastic import Scheduler as JScheduler
from dt_tpu.elastic import journal as jjournal
from dt_tpu.elastic import protocol as jproto
from dt_tpu.elastic.dataplane import DataPlane as JDataPlane
from dt_tpu.parallel.compression import GradientCompression as JCompression
from dt_tpu_torch import policy as tpolicy
from dt_tpu_torch.data import io as tio
from dt_tpu_torch.elastic import journal as tjournal
from dt_tpu_torch.elastic.dataplane import DataPlane as TDataPlane
from dt_tpu_torch.elastic.scheduler import Scheduler as TScheduler
from test_torch_io import _assert_same, _epochs
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

PKGS = {"jax": jpolicy, "port": tpolicy}


@pytest.fixture(autouse=True)
def _deadline():
    with job.deadline(60):
        yield


def _same_outcome(fn_j, fn_t, *args):
    """Both functions return equal values, or raise the same type."""
    try:
        want = fn_j(*args)
    except Exception as e:  # noqa: BLE001 — the reference's outcome
        with pytest.raises(type(e)):
            fn_t(*args)
        return None
    got = fn_t(*args)
    assert got == want and type(got) is type(want), (args, got, want)
    return got


# ---------------------------------------------------------------------------
# rescale and the engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_rescale_matches_the_reference(seed):
    rng = np.random.RandomState(seed)
    jr, tr = jpolicy.rescale, tpolicy.rescale
    assert tr.UNITS == jr.UNITS == 10000
    for _ in range(300):
        n = rng.randint(0, 9)
        kind = rng.randint(4)
        weights = [rng.uniform(0, 3, n), rng.randint(0, 4, n) * 1.0,
                   np.ones(n), rng.uniform(-1, 2, n)][kind].tolist()
        min_each = int(rng.randint(0, 3))
        total = int(rng.randint(0, 120))
        _same_outcome(jr.apportion, tr.apportion, weights, total, min_each)
        streak = int(rng.randint(-1, 11))
        shrink, frac = float(rng.uniform(0.1, 0.9)), \
            float(rng.uniform(0, 0.5))
        _same_outcome(jr.weight_for_streak, tr.weight_for_streak, streak,
                      shrink, frac)
        workers = [f"w{i}" for i in rng.permutation(max(n, 1))]
        streaks = {h: int(rng.randint(0, 6)) for h in workers
                   if rng.rand() < 0.5}
        units = _same_outcome(jr.share_units, tr.share_units, workers,
                              streaks, shrink, frac)
        if rng.rand() < 0.3:  # a host added after the decision
            units.pop(workers[0], None)
        _same_outcome(jr.batch_map, tr.batch_map,
                      units if rng.rand() < 0.8 else None, workers,
                      int(rng.randint(len(workers), 200)))
        b, w, g = (int(v) for v in rng.randint(-1, 70, 3))
        _same_outcome(jr.grad_weight, tr.grad_weight, b, w, g)
        _same_outcome(jr.lr_scale, tr.lr_scale, g, b)


def _random_engine_case(rng):
    kw = dict(threshold_ms=float(rng.choice([50.0, 200.0, 500.0])),
              shrink=float(rng.uniform(0.2, 0.9)),
              min_frac=float(rng.uniform(0.05, 0.5)),
              evict_after=int(rng.randint(0, 4)),
              target_workers=int(rng.randint(0, 6)))
    n = int(rng.randint(1, 7))
    workers = [f"w{i}" for i in rng.permutation(n)]
    base = {h for h in workers if rng.rand() < 0.4}
    streaks = {h: int(rng.randint(1, 10)) for h in workers
               if rng.rand() < 0.5}
    if rng.rand() < 0.2:
        streaks["gone"] = 3  # a departed host's streak
    if rng.rand() < 0.25:
        scores = {}
    else:
        scores = {h: float(rng.choice([0.0, 10.0, kw["threshold_ms"],
                                       rng.uniform(0, 1000)]))
                  for h in workers if rng.rand() < 0.9}
    return kw, (int(rng.randint(0, 20)), workers, base, streaks, scores)


@pytest.mark.parametrize("seed", range(4))
def test_engine_decisions_match_the_reference(seed):
    """``decide`` and ``shares`` on seeded random boards, streaks and
    settings: the ``Decision`` field for field."""
    rng = np.random.RandomState(100 + seed)
    kinds = set()
    for _ in range(400):
        kw, args = _random_engine_case(rng)
        dj = jpolicy.PolicyEngine(**kw).decide(*args)
        dt = tpolicy.PolicyEngine(**kw).decide(*args)
        assert [f.name for f in dataclasses.fields(dt)] == \
            [f.name for f in dataclasses.fields(dj)]
        assert dataclasses.asdict(dt) == dataclasses.asdict(dj), (kw, args)
        survivors = [h for h in args[1] if h not in dt.evict]
        assert tpolicy.PolicyEngine(**kw).shares(survivors, dt.streaks) == \
            jpolicy.PolicyEngine(**kw).shares(survivors, dj.streaks)
        kinds.update(p["kind"] for p in dt.proposals)
        kinds.update(["evict"] if dt.evict else [])
        kinds.update(["held"] if not args[4] and dt.streaks else [])
    assert kinds == {"scale_up", "scale_down", "evict", "held"}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_engine_rules(pkg):
    """The rules both packages share, stated once: an empty board holds
    the journaled streaks (a failover must not revert a rebalance), base
    workers are never evicted, streaks saturate, and scale proposals name
    the slowest non-base worker (the last in rank order on ties)."""
    eng = PKGS[pkg].PolicyEngine(threshold_ms=100, evict_after=2,
                                 target_workers=2)
    held = eng.decide(5, ["a", "b", "c"], {"a"}, {"b": 1, "x": 4}, {})
    assert (held.breached, held.streaks, held.evict) == ([], {"b": 1}, [])
    d = eng.decide(6, ["a", "b", "c"], {"a"}, {"a": 3, "b": 1},
                   {"a": 500.0, "b": 100.0, "c": 1.0})
    assert d.breached == ["a", "b"] and d.streaks == {"a": 4, "b": 2}
    assert d.evict == ["b"]  # "a" is base: it keeps its floored share
    assert d.proposals == []  # two survivors = the target
    capped = PKGS[pkg].PolicyEngine(threshold_ms=1).decide(
        0, ["a"], set(), {"a": 8}, {"a": 5.0})
    assert capped.streaks == {"a": 8}
    down = PKGS[pkg].PolicyEngine(target_workers=1).decide(
        0, ["a", "b", "c"], {"a"}, {}, {"a": 0.0, "b": 3.0, "c": 3.0})
    assert down.proposals == [{"kind": "scale_down", "host": "c"}]
    up = PKGS[pkg].PolicyEngine(target_workers=4).decide(
        0, ["a"], {"a"}, {}, {"a": 0.0})
    assert up.proposals == [{"kind": "scale_up", "want": 3}]
    assert eng.shares(["a", "b", "c"], {"a": 4, "b": 2}) == \
        {"a": 1667, "b": 1667, "c": 6666}  # both floored at 0.25


@pytest.mark.parametrize("env", [
    {},
    {"DT_POLICY": "1", "DT_STRAGGLER_MS": "80"},
    {"DT_POLICY": "true", "DT_POLICY_STRAGGLER_MS": "120",
     "DT_POLICY_SHRINK": "0.7", "DT_POLICY_MIN_FRAC": "0.1",
     "DT_POLICY_EVICT_AFTER": "3", "DT_POLICY_TARGET_WORKERS": "5"},
    {"DT_POLICY": "0", "DT_POLICY_TARGET_WORKERS": ""}])
def test_engine_from_env(monkeypatch, env):
    for name in ("DT_POLICY", "DT_STRAGGLER_MS", "DT_POLICY_STRAGGLER_MS",
                 "DT_POLICY_SHRINK", "DT_POLICY_MIN_FRAC",
                 "DT_POLICY_EVICT_AFTER", "DT_POLICY_TARGET_WORKERS"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tpolicy.enabled() == jpolicy.enabled()
    assert vars(tpolicy.PolicyEngine.from_env()) == \
        vars(jpolicy.PolicyEngine.from_env())


def test_policy_drill_table_is_the_references():
    """The card drill's shares and batches (ISSUE's table), from the JAX
    package's own engine, and the port's the same."""
    runs = {}
    for pkg, mod in PKGS.items():
        eng = mod.PolicyEngine(threshold_ms=150, evict_after=2)
        runs[pkg] = job.policy_drill_log(eng, mod.rescale)
    assert runs["port"] == runs["jax"]
    log, batches = runs["jax"]
    assert [r["shares"] for r in log] == [
        {"w0": 5000, "w2": 5000},
        {"w0": 3334, "w1": 3333, "w2": 3333},
        {"w0": 4000, "w1": 2000, "w2": 4000},
        {"w0": 5000, "w2": 5000}]
    assert [(r["epoch"], r["breached"], r["evicted"]) for r in log] == [
        (0, [], []), (1, [], []), (2, ["w1"], []), (3, ["w1"], ["w1"])]
    assert batches == [{"w0": 32, "w2": 32},
                       {"w0": 22, "w2": 21, "w1": 21},
                       {"w0": 26, "w2": 25, "w1": 13},
                       {"w0": 32, "w2": 32}]
    assert [tpolicy.rescale.grad_weight(b[h], len(b), 64)
            for b in batches for h in sorted(b)] == [
        1.0, 1.0, 66 / 64, 63 / 64, 63 / 64, 78 / 64, 39 / 64, 75 / 64,
        1.0, 1.0]


# ---------------------------------------------------------------------------
# the straggler board
# ---------------------------------------------------------------------------


class _Clock:
    """``time.monotonic_ns`` of the contributing threads, by thread name
    (a host), so each arrival's stamp is scripted."""

    def __init__(self):
        self.stamp = {}
        self._real = time.monotonic_ns

    def __call__(self):
        name = threading.current_thread().name
        return self.stamp[name] if name in self.stamp else self._real()


def _drive(dp, rounds, clock):
    """``rounds``: ``(key, [(host, stamp_ns), ...])`` in arrival order;
    each contribution waits until the previous one is in the slot, so the
    arrival order is the script's."""
    for seq, (key, arrivals) in enumerate(rounds):
        threads = []
        for i, (h, t) in enumerate(arrivals):
            clock.stamp[h] = t
            th = threading.Thread(target=dp.allreduce, name=h,
                                  args=(h, key, np.ones(3, np.float32), seq))
            th.start()
            threads.append(th)
            if i + 1 < len(arrivals):
                deadline = time.monotonic() + 10
                while h not in dp._reduce.get(key, {}).get("vals", {}):
                    assert time.monotonic() < deadline
                    time.sleep(0.001)
        for th in threads:
            th.join(10)
            assert not th.is_alive()


def _ewma(samples, alpha=0.3):
    s = None
    for x in samples:
        s = x if s is None else (1 - alpha) * s + alpha * x
    return s


def test_straggler_board_matches_the_reference(monkeypatch):
    """Three hosts, seeded arrival stamps over rounds of several keys,
    then a host departs: both planes give the same board, the EWMA of the
    lags behind each round's first arrival; a host that departs leaves the
    board."""
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic_ns", clock)
    rng = np.random.RandomState(3)
    hosts = ["w0", "w1", "w2"]
    rounds, lags = [], {h: [] for h in hosts}
    for r in range(12):
        order = list(rng.permutation(hosts))
        t0 = int(1e12) + r * int(1e9)
        offs = sorted(int(v) for v in rng.randint(0, 400_000_000, 3))
        offs[0] = 0
        arrivals = [(h, t0 + o) for h, o in zip(order, offs)]
        rounds.append((f"grads#b{r % 3}", arrivals))
        for h, o in zip(order, offs):
            lags[h].append(o / 1e6)
    boards = {}
    for name, cls in (("jax", JDataPlane), ("port", TDataPlane)):
        dp = cls(expected_fn=lambda: list(hosts), track_lag=True)
        _drive(dp, rounds, clock)
        before = dp.straggler_scores()
        dp.hosts_removed({"w1"})
        boards[name] = (before, dp.straggler_scores())
    assert boards["port"] == boards["jax"]
    want = {h: round(_ewma(v), 3) for h, v in lags.items()}
    assert boards["port"][0] == want
    assert set(boards["port"][1]) == {"w0", "w2"}


def test_straggler_board_without_stamps_and_with_a_retry(monkeypatch):
    """No stamps without ``track_lag`` (and tracing off): an empty board.
    A retried contribution keeps its first stamp, so the blame stays on
    the host everyone waited for."""
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic_ns", clock)
    for cls in (JDataPlane, TDataPlane):
        dp = cls(expected_fn=lambda: ["a", "b"])
        _drive(dp, [("k", [("a", 0), ("b", 5_000_000)])], clock)
        assert dp.straggler_scores() == {}
    boards = []
    for cls in (JDataPlane, TDataPlane):
        dp = cls(expected_fn=lambda: ["a", "b"], track_lag=True)
        clock.stamp["a"] = 1_000_000
        t = threading.Thread(target=dp.allreduce, name="a",
                             args=("a", "k", np.ones(3, np.float32), 0))
        t.start()
        while "a" not in dp._reduce.get("k", {}).get("vals", {}):
            time.sleep(0.001)
        clock.stamp["a"] = 900_000_000  # the retry, much later
        t2 = threading.Thread(target=dp.allreduce, name="a",
                              args=("a", "k", np.ones(3, np.float32), 0))
        t2.start()
        time.sleep(0.05)
        _drive(dp, [("k", [("b", 201_000_000)])], clock)
        for th in (t, t2):
            th.join(10)
        boards.append(dp.straggler_scores())
    assert boards[0] == boards[1] == {"a": 0.0, "b": 200.0}


def test_overlapped_window_decays_a_step_lag():
    """The reference's arithmetic, pinned: a worker that sleeps D before
    its step is late only in the first window's rounds of the ~25 a
    ResNet-50 step has at 4 MiB buckets; after that the fleet moves in
    lockstep, and the remaining rounds decay its score to ~0.001 D by the
    barrier.  The drill therefore makes one step one round."""
    d_ms, window, n_rounds = 600.0, 4, 25
    for cls in (JDataPlane, TDataPlane):
        clock = _Clock()
        with pytest.MonkeyPatch.context() as m:
            m.setattr(time, "monotonic_ns", clock)
            dp = cls(expected_fn=lambda: ["w0", "w1"], track_lag=True)
            rounds = []
            for k in range(n_rounds):
                t0 = int(1e12) + k * 10_000_000
                late = int(d_ms * 1e6) if k < window else 0
                rounds.append((f"grads#b{k}", [("w0", t0),
                                               ("w1", t0 + late)]))
            _drive(dp, rounds, clock)
            board = dp.straggler_scores()
        want = _ewma([d_ms] * window + [0.0] * (n_rounds - window))
        assert board == {"w0": 0.0, "w1": round(want, 3)}
        assert board["w1"] < 0.001 * d_ms
    # one round a step keeps the lag to the barrier
    assert _ewma([d_ms] * 2) == d_ms


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------


def _write(path, hosts):
    with open(path, "w") as f:
        f.write("\n".join(hosts) + "\n")


def _barrier(sched, msgs):
    """One membership barrier, its arrivals in the order of ``msgs`` (each
    request waits until the previous host's arrival is journaled), so both
    schedulers journal the same records.  Replies in order."""
    out = [None] * len(msgs)

    def one(i, m):
        out[i] = jproto.request("127.0.0.1", sched.port, m, timeout=30)

    ts = []
    for i, m in enumerate(msgs):
        ts.append(threading.Thread(target=one, args=(i, m)))
        ts[-1].start()
        deadline = time.monotonic() + 10
        while i + 1 < len(msgs) and \
                m["host"] not in sched._state.barrier_arrived:
            assert time.monotonic() < deadline
            time.sleep(0.002)
    for t in ts:
        t.join(30)
    assert not any(t.is_alive() for t in ts)
    return out


#: scenario -> (host file at start or None, hosts registered at start,
#: a host the operator adds at the epoch-1 barrier, env, scripted boards
#: by barrier epoch)
SCENARIOS = {
    "evict_via_host_file": (
        ["w0", "w1"], ["w0", "w1"], "w2",
        {"DT_POLICY": "1", "DT_POLICY_EVICT_AFTER": "2"},
        {1: {"w0": 3.0, "w1": 9.0}, 2: {"w0": 3.0, "w1": 1.0, "w2": 800.0},
         3: {"w0": 2.0, "w1": 4.0, "w2": 700.0},
         4: {"w0": 1.0, "w1": 2.0}}),
    "advisory_without_host_file": (
        None, ["w0"], None,
        {"DT_POLICY": "1", "DT_POLICY_EVICT_AFTER": "2"},
        {1: {"w0": 1.0, "w1": 900.0}, 2: {"w0": 1.0, "w1": 900.0},
         3: {"w0": 1.0, "w1": 900.0}, 4: {"w0": 1.0, "w1": 5.0}}),
    "scale_down": (
        ["w0"], ["w0"], "w1",
        {"DT_POLICY": "1", "DT_POLICY_TARGET_WORKERS": "1"},
        {1: {"w0": 1.0}, 2: {"w0": 1.0, "w1": 2.0}, 3: {"w0": 1.0},
         4: {"w0": 1.0}}),
    "policy_off": (
        ["w0", "w1"], ["w0", "w1"], "w2", {},
        {1: {"w0": 3.0, "w1": 9.0}, 2: {"w0": 3.0, "w1": 1.0, "w2": 800.0},
         3: {"w0": 2.0, "w1": 4.0, "w2": 700.0},
         4: {"w0": 1.0, "w1": 2.0}}),
}


def _policy_script(cls, tmp_path, scenario, monkeypatch):
    """Registers, then membership barriers for epochs 0-4 with the
    scripted board at each; a non-base ``w1`` registers as new where the
    scenario has no host file.  Returns ``(replies, journal path)``."""
    hosts, first, joiner, env, boards = SCENARIOS[scenario]
    for name in ("DT_POLICY", "DT_POLICY_EVICT_AFTER",
                 "DT_POLICY_TARGET_WORKERS", "DT_POLICY_STRAGGLER_MS"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("DT_POLICY_STRAGGLER_MS", "100")
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    hw = None
    if hosts is not None:
        hw = str(tmp_path / "host_worker")
        _write(hw, hosts)
    jp = str(tmp_path / "ctrl.journal")
    cur = {}

    def operator(epoch):
        cur["epoch"] = epoch
        if epoch == 1 and joiner is not None and hw is not None:
            _write(hw, hosts + [joiner])

    sched = cls(host_worker_file=hw, initial_workers=list(first),
                pre_change_hook=operator, journal_path=jp)
    sched._dp.straggler_scores = lambda: dict(boards.get(cur["epoch"], {}))
    port = sched.port
    log = []
    live = list(first)
    try:
        for h in first:
            log.append(("register", h, jproto.request(
                "127.0.0.1", port, {"cmd": "register", "host": h,
                                    "is_new": False,
                                    "is_recovery": False}, timeout=30)))
        if hosts is None:  # a non-base worker without a host file
            log.append(("register", "w1", jproto.request(
                "127.0.0.1", port, {"cmd": "register", "host": "w1",
                                    "is_new": True, "is_recovery": False},
                timeout=30)))
            live.append("w1")
        for epoch in range(5):
            replies = _barrier(sched, [
                {"cmd": "mc_barrier", "host": h, "epoch": epoch,
                 "info": {"EPOCH_BEGIN": epoch}} for h in live])
            log.append(("mc_barrier", epoch, replies))
            live = [h for h, r in zip(live, replies)
                    if not r["you_are_removed"]]
            for h in replies[0]["workers"]:
                if h not in live:  # added here: registers, arrives late
                    log.append(("register", h, jproto.request(
                        "127.0.0.1", port, {"cmd": "register", "host": h,
                                            "is_new": True,
                                            "is_recovery": False},
                        timeout=30)))
                    log.append(("late", h, jproto.request(
                        "127.0.0.1", port, {"cmd": "mc_barrier", "host": h,
                                            "epoch": epoch, "info": {}},
                        timeout=30)))
                    live.append(h)
        log.append(("status", jproto.request(
            "127.0.0.1", port, {"cmd": "status"}, timeout=30)["policy"]))
    finally:
        sched.close()
    return log, jp


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_scheduler_policy_matches_the_reference(tmp_path, monkeypatch,
                                                scenario):
    runs = {}
    for name, cls in (("jax", JScheduler), ("port", TScheduler)):
        d = tmp_path / name
        d.mkdir()
        runs[name] = _policy_script(cls, d, scenario, monkeypatch)
    (jlog, jjp), (tlog, tjp) = runs["jax"], runs["port"]
    assert tlog == jlog
    with open(jjp, "rb") as f, open(tjp, "rb") as g:
        assert g.read() == f.read()
    # journals cross both ways, policy fields included
    for path in (jjp, tjp):
        js = jjournal.ControlState.rebuild(path)
        ts = tjournal.ControlState.rebuild(path)
        assert ts.struct() == js.struct()
    rebuilt = tjournal.ControlState.rebuild(tjp)
    barriers = [r for r in tlog if r[0] == "mc_barrier"]
    payloads = [r[2][0].get("policy") for r in barriers]
    # a successor serves a retried barrier the journaled reply: the
    # payload survives a failover
    assert [rebuilt.barrier_result[e].get("policy")
            for e in range(5)] == payloads
    if scenario == "policy_off":
        assert payloads == [None] * 5 and rebuilt.policy_log == []
        assert tlog[-1][1]["enabled"] is False
        return
    assert all(p is not None for p in payloads)
    assert tlog[-1][1]["enabled"] is True
    if scenario == "evict_via_host_file":
        assert [r["evicted"] for r in rebuilt.policy_log] == \
            [[], [], [], ["w2"]]
        assert barriers[3][2][2]["you_are_removed"]
        assert payloads[2]["shares"] == {"w0": 4000, "w1": 4000,
                                         "w2": 2000}
        with open(str(tmp_path / "port" / "host_worker")) as f:
            assert f.read().split() == ["w0", "w1"]
    elif scenario == "advisory_without_host_file":
        assert [r["evicted"] for r in rebuilt.policy_log] == [[]] * \
            len(rebuilt.policy_log)
        assert {"kind": "evict", "host": "w1"} in \
            rebuilt.policy_log[-2]["proposals"]
        assert barriers[-1][2][1]["workers"] == ["w0", "w1"]
    else:
        props = [p for r in rebuilt.policy_log for p in r["proposals"]]
        assert {"kind": "scale_down", "host": "w1"} in props
        assert barriers[2][2][1]["you_are_removed"]


# ---------------------------------------------------------------------------
# the share-aware data iterator and the gradient weight
# ---------------------------------------------------------------------------


class _Ctrl:
    def __init__(self, host, workers, shares, lr_scale=1.0):
        self.host, self.workers = host, list(workers)
        self.rank = self.workers.index(host)
        self.policy_shares, self.policy_lr_scale = dict(shares), lr_scale
        self.policy_seq = 1


class _KV:
    def __init__(self, ctrl):
        self._controller = ctrl
        self.num_workers, self.rank = len(ctrl.workers), ctrl.rank


@pytest.mark.parametrize("shares", [
    {"w0": 4000, "w2": 4000, "w1": 2000},
    {"w0": 3334, "w2": 3333, "w1": 3333},
    {"w0": 7000, "w2": 3000}])
@pytest.mark.parametrize("weighted", [True, False])
def test_share_aware_iterators_match_the_reference(shares, weighted):
    """Each worker's batch and shard under the controller's shares: the
    JAX package's, batch for batch and index for index, with a factory
    that takes the weights (a weighted contiguous shard) and with a
    three-argument one (the weighted batch over an equal shard)."""
    rng = np.random.RandomState(4)
    x = rng.uniform(-1, 1, (96, 4, 4, 3)).astype(np.float32)
    y = rng.randint(0, 10, 96).astype(np.int32)
    workers = list(shares)

    def factory(mod):
        def weighted_f(num_parts, part_index, batch_size, weights=None):
            return mod.ResizeIter(mod.NDArrayIter(
                x, y, batch_size=batch_size, shuffle=True,
                num_parts=num_parts, part_index=part_index, seed=99,
                part_weights=weights), size=3), None

        def plain_f(num_parts, part_index, batch_size):
            return weighted_f(num_parts, part_index, batch_size)
        return weighted_f if weighted else plain_f

    sizes = {}
    for h in workers:
        kv = _KV(_Ctrl(h, workers, shares))
        a, _ = jio.ElasticDataIterator(factory(jio), 48) \
            .get_data_iterator(kv)
        b, _ = tio.ElasticDataIterator(factory(tio), 48) \
            .get_data_iterator(kv)
        ea, eb = _epochs(a, 2), _epochs(b, 2)
        _assert_same(ea, eb)
        sizes[h] = eb[0][0][0][0].shape[0]
    assert sizes == tpolicy.rescale.batch_map(shares, workers, 48)


def _port_words(g, scale, threshold, overlap, monkeypatch):
    """The 2-bit payload the port's ``Module`` host-sync step sends for
    the local gradient ``g`` under the gradient weight ``scale`` (its
    gradient pass replaced by ``g``), two steps, so the residual carries
    into the second."""
    from dt_tpu_torch.parallel import kvstore as tkv
    from dt_tpu_torch.training.module import Module
    monkeypatch.setenv("DT_AR_OVERLAP", "1" if overlap else "0")
    monkeypatch.setenv("DT_AR_BUCKET_BYTES", str(4 * 1000))
    sent = []

    class Ctrl:
        host, workers, rank = "w0", ["w0", "w1"], 0

        def allreduce(self, key, payload):
            sent.append(payload)
            return np.zeros(len(g[0]), np.float32)

    class PipeCtrl(Ctrl):
        def allreduce_pipeline(self, key, window=None):
            return _Pipe(sent)

    kv = tkv.create("tpu_sync")
    kv.set_gradient_compression({"type": "2bit", "threshold": threshold})
    mod = Module(torch.nn.Linear(2, 2), device="cpu", kvstore=kv)
    mod.state = types.SimpleNamespace(
        layout=types.SimpleNamespace(
            stats=types.SimpleNamespace(size=0)))
    mod.grad_scale = scale
    mod._stats_snapshot = lambda: None
    mod._prefetch_batch = lambda it: None
    mod._apply_synced = lambda *a: None
    words = []
    for gi in g:
        sent.clear()
        mod._grads = lambda data, labels, gi=gi: (
            torch.from_numpy(gi.copy()), torch.zeros(0), torch.zeros(()),
            None)
        mod._host_sync_step(PipeCtrl() if overlap else Ctrl(), None, None,
                            None, 0)
        words.append(np.concatenate([p["packed"] for p in sent]))
    return words


class _Pipe:
    """The ``AllreducePipeline`` surface the overlap engine uses, which
    keeps each bucket's payload."""

    def __init__(self, sent):
        self._sent, self._out = sent, []

    def submit(self, payload):
        self._out.append((len(self._sent),
                          np.zeros(payload["n"], np.float32)))
        self._sent.append({k: (np.array(v) if k == "packed" else v)
                           for k, v in payload.items()})

    def submit_aux(self, key, payload):
        pass

    def poll(self):
        out, self._out = self._out, []
        return out

    def done_submitting(self):
        pass

    def next_result(self):
        return self._out.pop(0) if self._out else None

    def aux(self, key):
        return None

    def close(self):
        return True


@pytest.mark.parametrize("overlap", [False, True])
def test_weighted_gradient_packs_the_references_words(monkeypatch,
                                                      overlap):
    """The same gradient and the same share weight give the same 2-bit
    words from the port's host-sync step (serial, and bucketed through the
    overlap engine) as from the JAX package's ``flat_g * grad_scale`` and
    on-device quantize, word for word, the residual carried over two
    steps.  The gradients sit on the threshold's edges after scaling."""
    rng = np.random.RandomState(11)
    t = 0.005
    n = 4099
    for b, w, gb in ((26, 3, 64), (13, 3, 64), (22, 3, 64), (21, 3, 64)):
        scale = tpolicy.rescale.grad_weight(b, w, gb)
        assert scale == jpolicy.rescale.grad_weight(b, w, gb)
        g = []
        for _ in range(2):
            v = rng.normal(0, 0.01, n).astype(np.float32)
            edge = rng.rand(n) < 0.3  # values that land near +-t
            v[edge] = (np.float32(t) / np.float32(scale)) * \
                rng.choice([-1, 1], edge.sum()) * \
                (1 + rng.randint(-3, 4, edge.sum()) * 1e-7)
            g.append(v.astype(np.float32))
        jgc = JCompression(t)
        want = [np.asarray(jgc.compress_on_device(jnp.asarray(gi) * scale))
                for gi in g]
        got = _port_words(g, scale, t, overlap, monkeypatch)
        for a, bw in zip(want, got):
            np.testing.assert_array_equal(bw.view(np.uint32),
                                          a.view(np.uint32))


@pytest.mark.parametrize("path", ["barrier", "rejoin"])
def test_client_adopts_policy_payloads_as_the_reference(path):
    """Both packages' ``WorkerClient`` adopt a barrier reply's shares, LR
    scale and seq, on the membership barrier and on the recovery rejoin;
    a reply with a lower seq (a cached reply replayed after a newer
    decision, as after a failover) changes nothing; a reply without a
    payload keeps the adopted decision."""
    from dt_tpu.elastic.client import WorkerClient as JClient
    from dt_tpu_torch.elastic.client import WorkerClient as TClient
    replies = [
        {"workers": ["w0", "w1"], "rank": 1, "epoch": 1, "removed": [],
         "you_are_removed": False,
         "policy": {"shares": {"w0": 6667, "w1": 3333}, "lr_scale": 1.0,
                    "seq": 2}},
        {"workers": ["w0", "w1"], "rank": 1, "epoch": 2, "removed": [],
         "you_are_removed": False,
         "policy": {"shares": {"w0": 5000, "w1": 5000}, "lr_scale": 1.0,
                    "seq": 1}},
        {"workers": ["w0", "w1"], "rank": 1, "epoch": 3, "removed": [],
         "you_are_removed": False}]
    seen = {}
    for name, cls in (("jax", JClient), ("port", TClient)):
        c = cls.__new__(cls)
        c.host, c.workers, c.rank = "w1", ["w0"], -1
        c.recovery_pending, c.resume_epoch = path == "rejoin", 1
        c.policy_shares, c.policy_lr_scale, c.policy_seq = {}, 1.0, 0
        for attr in ("_lock", "_prof_lock"):
            setattr(c, attr, threading.Lock())
        states = []
        for r in replies:
            c._req = lambda msg, r=r, **kw: dict(r)
            if path == "rejoin":
                c.recovery_pending = True
                c.wait_rejoin(timeout_s=5)
            else:
                c.membership_change_barrier({"EPOCH_BEGIN": r["epoch"]})
            states.append((c.policy_seq, dict(c.policy_shares),
                           c.policy_lr_scale, c.rank))
        seen[name] = states
    assert seen["port"] == seen["jax"]
    assert seen["port"] == [(2, {"w0": 6667, "w1": 3333}, 1.0, 1)] * 3
