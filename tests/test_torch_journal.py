"""The port's write-ahead journal against the JAX package's.

The journal is a contract between the packages: ``u32 len | u32 crc32 |
pickle((fence, op, kwargs))`` records and digest-named snapshot sidecars.
A journal either package writes, by hand or from a live scheduler, must
replay in the other's ``ControlState`` to the same ``struct()``, through
the incremental tail too.  Then the framing faults of
``tests/test_ha.py:71-317``, held on the port: a torn final record cut at
every byte, mid-file corruption, a fenced append withdrawn, a journal
applied twice equal to once, lease fencing and the sidecar retention.
"""

import os
import struct
import threading

import numpy as np
import pytest

import torch_elastic_job as job
from dt_tpu.elastic import Scheduler as JScheduler
from dt_tpu.elastic import journal as jjournal
from dt_tpu.elastic import protocol as jproto
from dt_tpu_torch.elastic import journal as tjournal
from dt_tpu_torch.elastic.scheduler import Scheduler as TScheduler
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

PKGS = {"jax": jjournal, "port": tjournal}


@pytest.fixture(autouse=True)
def _deadline():
    with job.deadline(60):
        yield

DIRECTIONS = [("jax", "port"), ("port", "jax")]
IDS = ["jax_writes_port_reads", "port_writes_jax_reads"]

_SNAP = {"step": np.int32(16),
         "params": {"Dense_0": {"kernel": np.arange(6, dtype=np.float32)
                                .reshape(2, 3),
                                "bias": np.zeros(3, np.float32)}},
         "batch_stats": {}, "opt_state": {"count": np.int32(16)}}

#: every op of the vocabulary, the fleet checkpoint and a policy decision
#: of the JAX scheduler's engine among them
_OPS = [
    ("init", {"workers": ["a", "b"], "expected": 2}),
    ("worker_add", {"host": "a", "base": True}),
    ("worker_add", {"host": "b", "base": True}),
    ("plain_arrive", {"host": "a", "seq": 0}),
    ("plain_arrive", {"host": "b", "seq": 0}),
    ("plain_release", {"gen": 1}),
    ("barrier_arrive", {"host": "a", "epoch": 1}),
    ("barrier_arrive", {"host": "b", "epoch": 1}),
    ("mc_begin", {"epoch": 1}),
    ("mc_add", {"host": "c", "seq": 1}),
    ("barrier_complete",
     {"epoch": 1, "result": {"workers": ["a", "b", "c"], "removed": [],
                             "added": ["c"], "recovered": [], "epoch": 1}}),
    ("worker_add", {"host": "c", "base": False}),
    ("policy_decide", {"epoch": 1, "seq": 1, "breached": ["c"],
                       "streaks": {"c": 1}, "shares": {"a": 4, "b": 4,
                                                       "c": 2},
                       "lr_scale": 1.0}),
    ("ckpt_intent", {"step": 8, "epoch": 1, "seq": 1,
                     "workers": ["a", "b", "c"]}),
    ("ckpt_ack", {"step": 8, "host": "a", "path": "/d/a-8", "sha256": "aa",
                  "cursor": {"batches_done": 0, "epoch": 1, "step": 8}}),
    ("quick_evict", {"host": "c", "seq": 2}),
    ("ckpt_abort", {"step": 8}),
    ("recovery_pending", {"host": "c"}),
    ("barrier_arrive", {"host": "a", "epoch": 2}),
    ("barrier_arrive", {"host": "b", "epoch": 2}),
    ("barrier_arrive", {"host": "c", "epoch": 2}),
    ("mc_begin", {"epoch": 2}),
    ("mc_recover", {"host": "c", "epoch": 2, "seq": 3}),
    ("barrier_complete",
     {"epoch": 2, "result": {"workers": ["a", "b", "c"], "removed": [],
                             "added": [], "recovered": ["c"], "epoch": 2}}),
    ("recovered_clear", {"host": "c"}),
    ("ckpt_intent", {"step": 16, "epoch": 2, "seq": 2,
                     "workers": ["a", "b", "c"]}),
]
_TAIL = [
    ("ckpt_ack", {"step": 16, "host": h, "path": f"/d/{h}-16",
                  "sha256": h * 2, "cursor": {"batches_done": 0,
                                              "epoch": 2, "step": 16}})
    for h in ("a", "b", "c")] + [
    ("ckpt_commit", {"step": 16, "manifest": {
        "step": 16, "epoch": 2, "seq": 2, "workers": ["a", "b", "c"],
        "files": {h: {"path": f"/d/{h}-16", "sha256": h * 2,
                      "cursor": {"batches_done": 0, "epoch": 2,
                                 "step": 16}} for h in ("a", "b", "c")}}}),
    ("drain", {"host": "b", "seq": 4}),
    ("evict", {"host": "b", "seq": 5}),
    ("resume", {"seq": 1}),
    ("init", {"workers": ["a", "c"], "expected": 2}),
]


def _same(x, y):
    """Deep equality with numpy leaves compared by dtype, shape and
    bytes."""
    if isinstance(x, dict):
        return isinstance(y, dict) and x.keys() == y.keys() and \
            all(_same(x[k], y[k]) for k in x)
    if isinstance(x, (list, tuple)):
        return type(x) is type(y) and len(x) == len(y) and \
            all(_same(a, b) for a, b in zip(x, y))
    if isinstance(x, (np.ndarray, np.generic)):
        x, y = np.asarray(x), np.asarray(y)
        return x.dtype == y.dtype and x.shape == y.shape and \
            x.tobytes() == y.tobytes()
    return type(x) is type(y) and x == y


@pytest.mark.parametrize("writer,reader", DIRECTIONS, ids=IDS)
def test_journal_written_by_one_package_replays_in_the_other(
        tmp_path, writer, reader):
    """Round trip, incremental tail and the snapshot sidecar, across the
    packages: both ``rebuild``s give the same ``struct()``, and the
    reader's state holds the writer's snapshot blob bit for bit."""
    w_pkg, r_pkg = PKGS[writer], PKGS[reader]
    jp = str(tmp_path / "ctrl.journal")
    w = w_pkg.JournalWriter(jp, fence=3)
    for op, kw in _OPS:
        w.append(op, kw)
    w.append("snapshot", {"blob": w_pkg.write_snapshot_sidecar(jp, _SNAP)})

    tail = r_pkg.JournalReader(jp)
    st = r_pkg.ControlState()
    st.sidecar_base = jp
    first = tail.read_new()
    assert [op for _f, op, _kw in first] == [op for op, _ in _OPS] + \
        ["snapshot"]
    assert {f for f, _op, _kw in first} == {3}
    for _f, op, kw in first:
        st.apply(op, **kw)
    assert tail.read_new() == []
    for op, kw in _TAIL:
        w.append(op, kw)
    w.close()
    for _f, op, kw in tail.read_new():
        st.apply(op, **kw)

    mine = w_pkg.ControlState.rebuild(jp)
    theirs = r_pkg.ControlState.rebuild(jp)
    assert theirs.struct() == mine.struct() == st.struct()
    assert theirs.struct()["ckpt_committed"]["step"] == 16
    assert theirs.struct()["workers"] == ["a", "c"]
    # the resume op dropped the snapshot; the sidecar still resolves
    marker = [kw for _f, op, kw in r_pkg.replay(jp) if op == "snapshot"][0]
    blob = r_pkg.load_snapshot_sidecar(jp, marker["blob"]["__snap_ref__"])
    assert _same(blob, _SNAP)
    # and a mid-way rebuild (before the resume) holds the blob itself
    upto = len(_OPS) + 1
    assert _same(r_pkg.ControlState.rebuild(jp, upto=upto).snapshot, _SNAP)
    assert r_pkg.ControlState.rebuild(jp, upto=upto).struct() == \
        w_pkg.ControlState.rebuild(jp, upto=upto).struct()


def _drive(port):
    """A live job's control traffic over the wire: registers, a plain
    barrier, a snapshot, a two-phase checkpoint and a membership barrier
    that adds ``w2`` (the operator lists it)."""
    def req(msg):
        resp = jproto.request("127.0.0.1", port, msg, timeout=60)
        assert "error" not in resp, (msg["cmd"], resp)
        return resp

    def both(make):
        out = [None, None]

        def one(i, h):
            out[i] = req(make(h))
        ts = [threading.Thread(target=one, args=(i, h))
              for i, h in enumerate(("w0", "w1"))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
        return out

    for h in ("w0", "w1"):
        req({"cmd": "register", "host": h, "is_new": False,
             "is_recovery": False})
    both(lambda h: {"cmd": "barrier", "host": h, "seq": 0})
    req({"cmd": "publish_snapshot", "blob": _SNAP})
    assert req({"cmd": "ckpt_intent", "host": "w0", "step": 8,
                "epoch": 1})["ok"]
    assert req({"cmd": "ckpt_intent", "host": "w1", "step": 8,
                "epoch": 1})["ok"]
    for h in ("w0", "w1"):
        req({"cmd": "ckpt_ack", "host": h, "step": 8,
             "path": f"/d/{h}-8", "sha256": h * 8,
             "cursor": {"batches_done": 0, "epoch": 1, "step": 8}})
    res = both(lambda h: {"cmd": "mc_barrier", "host": h, "epoch": 1,
                          "info": {}})
    assert res[0]["workers"] == ["w0", "w1", "w2"]


@pytest.mark.parametrize("writer,reader", DIRECTIONS, ids=IDS)
def test_live_scheduler_journal_replays_in_the_other_package(
        tmp_path, writer, reader):
    """A journal a live scheduler of one package wrote (under its lease)
    rebuilds in the other package to the writer's live state."""
    hw = str(tmp_path / "host_worker")
    with open(hw, "w") as f:
        f.write("w0\nw1\n")

    def operator(epoch):
        with open(hw, "w") as f:
            f.write("w0\nw1\nw2\n")

    jp = str(tmp_path / "ctrl.journal")
    cls = JScheduler if writer == "jax" else TScheduler
    sched = cls(host_worker_file=hw, journal_path=jp,
                pre_change_hook=operator)
    try:
        _drive(sched.port)
        with sched._lock:
            live = sched._state.struct()
        assert sched.incarnation == 1
    finally:
        sched.close()
    assert live["ckpt_committed"]["step"] == 8 and live["has_snapshot"]
    assert PKGS[reader].ControlState.rebuild(jp).struct() == live
    assert PKGS[writer].ControlState.rebuild(jp).struct() == live
    fences = {f for f, _op, _kw in PKGS[reader].replay(jp)}
    assert fences == {1}


# ---------------------------------------------------------------------------
# framing faults, held on the port (tests/test_ha.py:71-317)
# ---------------------------------------------------------------------------

def test_torn_final_record_replay_stops_cleanly(tmp_path):
    path = str(tmp_path / "j")
    w = tjournal.JournalWriter(path)
    w.append("init", {"workers": ["a"], "expected": 1})
    w.append("worker_add", {"host": "a", "base": True})
    w.close()
    good = open(path, "rb").read()
    ln, _crc = struct.Struct("<II").unpack(good[:8])
    first_len = 8 + ln
    # cut at every byte of the final record: exactly the first survives
    for cut in range(first_len + 1, len(good)):
        with open(path, "wb") as f:
            f.write(good[:cut])
        recs = tjournal.JournalReader(path).read_new()
        assert [op for _f, op, _k in recs] == ["init"], cut
    bad = bytearray(good)
    bad[-1] ^= 0xFF  # a CRC-bad tail is the same torn-tail case
    with open(path, "wb") as f:
        f.write(bytes(bad))
    assert [op for _f, op, _k in tjournal.JournalReader(path).read_new()] \
        == ["init"]
    # a reader that saw the torn tail picks the record up once complete
    with open(path, "wb") as f:
        f.write(good[:first_len + 4])
    r = tjournal.JournalReader(path)
    assert [op for _f, op, _k in r.read_new()] == ["init"]
    with open(path, "r+b") as f:
        f.write(good)
    assert [op for _f, op, _k in r.read_new()] == ["worker_add"]
    # an absurd length is corruption, not a torn tail
    with open(path, "wb") as f:
        f.write(struct.Struct("<II").pack(tjournal.MAX_RECORD + 1, 0))
    with pytest.raises(tjournal.JournalError):
        tjournal.JournalReader(path).read_new()


def test_mid_file_corruption_raises_not_truncates(tmp_path):
    path = str(tmp_path / "j")
    w = tjournal.JournalWriter(path)
    w.append("init", {"workers": ["a"], "expected": 1})
    w.append("worker_add", {"host": "a", "base": True})
    w.append("evict", {"host": "a", "seq": 1})
    w.close()
    good = open(path, "rb").read()
    ln, _crc = struct.Struct("<II").unpack(good[:8])
    bad = bytearray(good)
    bad[8] ^= 0xFF  # the first record's payload, records after it
    with open(path, "wb") as f:
        f.write(bytes(bad))
    with pytest.raises(tjournal.JournalError, match="mid-file corruption"):
        tjournal.JournalReader(path).read_new()
    with pytest.raises(jjournal.JournalError, match="mid-file corruption"):
        jjournal.JournalReader(path).read_new()
    # the second record corrupted, the third intact
    bad = bytearray(good)
    bad[8 + ln + 8] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(bad))
    r = tjournal.JournalReader(path)
    with pytest.raises(tjournal.JournalError):
        r.read_new()


def test_fenced_mid_append_withdraws_the_record(tmp_path):
    """A writer deposed between its pre-append check and its fsync leaves
    no record behind (the re-check truncates it out)."""
    path = str(tmp_path / "j")
    lease = tjournal.Lease(str(tmp_path / "lease"))
    inc = lease.acquire("sched:A")

    class _DeposedBetweenChecks:
        def __init__(self):
            self._reads = 0

        def incarnation(self):
            self._reads += 1
            return inc if self._reads == 1 else inc + 1

    w = tjournal.JournalWriter(path, fence=inc, lease=lease)
    w.append("init", {"workers": ["a"], "expected": 1})
    w._lease = _DeposedBetweenChecks()
    with pytest.raises(tjournal.Fenced, match="mid-append"):
        w.append("evict", {"host": "a", "seq": 1})
    w.close()
    assert [op for _f, op, _kw in tjournal.replay(path)] == ["init"]
    assert [op for _f, op, _kw in jjournal.replay(path)] == ["init"]


def test_journal_replay_idempotent_twice_equals_once(tmp_path):
    mod = tjournal
    # a resume op resets the dead incarnation, so twice-equals-once holds
    # up to it (as in the JAX package)
    ops = _OPS + _TAIL[:-2]
    once = mod.ControlState()
    for op, kw in ops:
        once.apply(op, **kw)
    twice = mod.ControlState()
    for _pass in range(2):
        for op, kw in ops:
            twice.apply(op, **kw)
    assert once.struct() == twice.struct()
    path = str(tmp_path / "j")
    w = mod.JournalWriter(path)
    for op, kw in ops:
        w.append(op, kw)
    w.close()
    assert mod.ControlState.rebuild(path).struct() == once.struct()
    # the JAX package's replay of the same journal agrees
    assert jjournal.ControlState.rebuild(path).struct() == once.struct()


def test_lease_fencing_refuses_stale_leader(tmp_path):
    path = str(tmp_path / "j")
    lease = tjournal.Lease(str(tmp_path / "lease"))
    inc_a = lease.acquire("sched:A")
    assert inc_a == 1
    wa = tjournal.JournalWriter(path, fence=inc_a, lease=lease)
    wa.append("init", {"workers": ["a"], "expected": 1})
    assert lease.renew(inc_a, "sched:A")
    # the JAX package's lease reads the port's file, and takes over
    inc_b = jjournal.Lease(str(tmp_path / "lease")).acquire("sched:B")
    assert inc_b == 2
    with pytest.raises(tjournal.Fenced):
        wa.append("evict", {"host": "a", "seq": 1})
    assert not lease.renew(inc_a, "sched:A")
    wa.close()
    wb = tjournal.JournalWriter(path, fence=inc_b, lease=lease)
    wb.append("evict", {"host": "a", "seq": 1})
    wb.close()
    assert [f for f, _op, _kw in tjournal.replay(path)] == [1, 2]
    assert tjournal.Lease(str(tmp_path / "lease")).expired(3600.0) is False


def test_snap_keep_env_bounds_and_prunes(tmp_path, monkeypatch):
    monkeypatch.delenv("DT_CTRL_SNAP_KEEP", raising=False)
    assert tjournal._snap_keep() == 2
    monkeypatch.setenv("DT_CTRL_SNAP_KEEP", "5")
    assert tjournal._snap_keep() == 5
    monkeypatch.setenv("DT_CTRL_SNAP_KEEP", "0")
    assert tjournal._snap_keep() == 1
    monkeypatch.setenv("DT_CTRL_SNAP_KEEP", "junk")
    assert tjournal._snap_keep() == 2
    monkeypatch.setenv("DT_CTRL_SNAP_KEEP", "1")
    jp = str(tmp_path / "ctrl.journal")
    for i in range(3):
        tjournal.write_snapshot_sidecar(jp, {"epoch": i})
    snaps = [n for n in os.listdir(tmp_path)
             if n.startswith("ctrl.journal.snap.")]
    assert len(snaps) == 1
    # the same blob names the same sidecar in both packages
    assert tjournal.write_snapshot_sidecar(jp, {"epoch": 9}) == \
        jjournal.write_snapshot_sidecar(jp, {"epoch": 9})
