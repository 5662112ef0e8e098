"""The port's fleet checkpoint and cold-restart resume
(``tests/test_ckpt.py:93-316, 426-600`` held on the port, and across the
packages).

- the two-phase protocol over a port ``Scheduler`` and port clients:
  intent dedup, commit on the last ack, stale acks, the manifest view; a
  newer intent superseding a stuck window; a window torn at the intent,
  mid-save or before the commit recovering to the previous commit; a
  crash during the resume; a resized (N+1) fleet resuming from a donor
  blob; a drain aborting the window pinned to the drained host;
- checkpoint files: async save errors surfacing on the next save and on
  ``flush_saves``; the async save's bytes equal to a synchronous save's;
  corrupt files at every offset; the fallback past a corrupt newest tag;
  ``.tmp`` and zero-byte tags ignored; 5-digit step tags; the journaled
  digest; ``fast_forward`` and ``skip_batches``;
- a port fleet killed after a commit and resumed ends bit-identical to its
  never-killed run;
- port workers resume from a fleet checkpoint JAX workers wrote against
  the JAX ``Scheduler``, and JAX workers from one port workers wrote: the
  restored state equals the blob bit for bit, and the continued run agrees
  with the never-killed one of the other package within 1e-5 relative.
"""

import json
import os
import signal
import struct
import time

import numpy as np
import pytest
import torch

import torch_elastic_job as job
from dt_tpu.elastic import Scheduler as JScheduler
from dt_tpu_torch import models, optim
from dt_tpu_torch.data import io
from dt_tpu_torch.elastic import faults, journal, protocol
from dt_tpu_torch.elastic.client import WorkerClient
from dt_tpu_torch.elastic.scheduler import Scheduler
from dt_tpu_torch.interchange import export_jax_train_state
from dt_tpu_torch.obs import trace as obs_trace
from dt_tpu_torch.training import checkpoint, fleet_ckpt
from dt_tpu_torch.training.train_state import TrainState
from dt_tpu_torch.utils import msgpack
from torch_one_thread import ENV, one_torch_thread  # noqa: F401 (fixture)

#: relative agreement of a JAX and a port run (the two SGD implementations
#: round differently), as ``tests/test_torch_module.py`` holds them
TOL = 1e-5
EPOCHS = 3
EVERY = 4


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("DT_FAULT_PLAN", "DT_CTRL_ENDPOINTS", "DT_CKPT_DIR",
                "DT_CKPT_EVERY", "DT_RESUME", "DT_CTRL_SNAP_KEEP"):
        monkeypatch.delenv(var, raising=False)
    faults.clear()
    checkpoint.raise_pending_save_error()
    with job.deadline(200):
        yield
    faults.clear()
    obs_trace.set_enabled(None)
    try:
        checkpoint.raise_pending_save_error()
    except checkpoint.CheckpointSaveError:
        pass


def _client(port, host):
    return WorkerClient("127.0.0.1", port, host=host,
                        heartbeat_interval_s=30.0)


def _live(sched):
    with sched._lock:
        return sched._state.struct()


def _close_all(sched, clients):
    for c in clients:
        c.close()
    sched.close()


# ---------------------------------------------------------------------------
# the two-phase protocol over a port scheduler
# ---------------------------------------------------------------------------

def test_two_phase_commit_flow(tmp_path):
    hw = str(tmp_path / "hosts")
    job.write_hosts(hw, ["w0", "w1"])
    jp = str(tmp_path / "ctrl.journal")
    sched = Scheduler(host_worker_file=hw, journal_path=jp)
    cs = []
    try:
        cs = [_client(sched.port, h) for h in ("w0", "w1")]
        c0, c1 = cs
        r0 = c0.ckpt_begin(8, 1)
        assert r0["ok"]
        r1 = c1.ckpt_begin(8, 1)  # joins the same window
        assert r1["ok"] and r1["seq"] == r0["seq"]
        assert not c0.ckpt_begin(4, 0)["ok"]  # never behind the pending
        cur = {"batches_done": 3, "epoch": 1, "step": 8}
        assert c0.ckpt_ack(8, "/d/w0-8", "aa" * 32, cur) == \
            {"committed": False}
        st = _live(sched)
        assert st["ckpt_pending"]["step"] == 8
        assert sorted(st["ckpt_pending"]["acks"]) == ["w0"]
        assert c1.ckpt_ack(8, "/d/w1-8", "bb" * 32, cur) == \
            {"committed": True}
        st = _live(sched)
        assert st["ckpt_pending"] is None
        com = st["ckpt_committed"]
        assert com["step"] == 8 and com["epoch"] == 1
        assert com["files"]["w0"]["sha256"] == "aa" * 32
        assert com["files"]["w0"]["cursor"]["batches_done"] == 3
        # a replayed ack after the commit reports it; an intent for the
        # committed step is refused
        assert c0.ckpt_ack(8, "/d/w0-8", "aa" * 32, cur)["committed"]
        assert c1.ckpt_begin(8, 1)["reason"] == "already_committed"
        view = c0.ckpt_manifest()
        assert view["committed"]["step"] == 8 and view["pending"] is None
        assert journal.ControlState.rebuild(jp).struct() == _live(sched)
    finally:
        _close_all(sched, cs)


def test_newer_intent_supersedes_stuck_window(tmp_path):
    hw = str(tmp_path / "hosts")
    job.write_hosts(hw, ["w0", "w1"])
    sched = Scheduler(host_worker_file=hw,
                      journal_path=str(tmp_path / "j"))
    cs = []
    try:
        cs = [_client(sched.port, h) for h in ("w0", "w1")]
        c0, c1 = cs
        assert c0.ckpt_begin(8, 1)["ok"]
        c0.ckpt_ack(8, "/d/w0-8", "aa", {})
        assert c1.ckpt_begin(16, 2)["ok"]  # w1 never saved step 8
        st = _live(sched)
        assert st["ckpt_pending"]["step"] == 16
        assert st["ckpt_committed"] is None
        assert c0.ckpt_ack(8, "/d/w0-8", "aa", {}) == {
            "committed": False, "stale": True}
    finally:
        _close_all(sched, cs)


def _journal_with(tmp_path, ops):
    """A journal as the dead incarnation left it."""
    jp = str(tmp_path / "ctrl.journal")
    w = journal.JournalWriter(jp, fence=1)
    for op, kw in ops:
        w.append(op, kw)
    w.close()
    return jp


_CUR8 = {"batches_done": 3, "epoch": 1, "step": 8}
_PREV_COMMIT = {"step": 8, "epoch": 1, "seq": 1, "workers": ["w0", "w1"],
                "files": {"w0": {"path": "/d/w0-8", "sha256": "aa",
                                 "cursor": _CUR8},
                          "w1": {"path": "/d/w1-8", "sha256": "bb",
                                 "cursor": _CUR8}}}


def _base_ops():
    return [
        ("init", {"workers": ["w0", "w1"], "expected": 2}),
        ("worker_add", {"host": "w0", "base": True}),
        ("worker_add", {"host": "w1", "base": True}),
        ("ckpt_intent", {"step": 8, "epoch": 1, "seq": 1,
                         "workers": ["w0", "w1"]}),
        ("ckpt_ack", {"step": 8, "host": "w0", "path": "/d/w0-8",
                      "sha256": "aa", "cursor": _CUR8}),
        ("ckpt_ack", {"step": 8, "host": "w1", "path": "/d/w1-8",
                      "sha256": "bb", "cursor": _CUR8}),
        ("ckpt_commit", {"step": 8, "manifest": _PREV_COMMIT}),
    ]


_CUR16 = {"batches_done": 2, "epoch": 2, "step": 16}
_INTENT16 = ("ckpt_intent", {"step": 16, "epoch": 2, "seq": 2,
                             "workers": ["w0", "w1"]})


@pytest.mark.parametrize("torn_tail", [
    [_INTENT16],
    [_INTENT16, ("ckpt_ack", {"step": 16, "host": "w0", "path": "/d/w0-16",
                              "sha256": "cc", "cursor": _CUR16})],
    [_INTENT16] + [("ckpt_ack", {"step": 16, "host": h,
                                 "path": f"/d/{h}-16", "sha256": h,
                                 "cursor": _CUR16}) for h in ("w0", "w1")],
], ids=["torn_at_intent", "torn_mid_save", "torn_before_commit"])
def test_torn_window_recovers_to_previous_commit(tmp_path, torn_tail):
    jp = _journal_with(tmp_path, _base_ops() + torn_tail)
    hw = str(tmp_path / "hosts")
    job.write_hosts(hw, ["w0", "w1"])
    sched = Scheduler(host_worker_file=hw, journal_path=jp, resume=True)
    cs = []
    try:
        st = _live(sched)
        assert st["ckpt_pending"] is None
        assert st["ckpt_committed"]["step"] == 8
        assert st["last_completed_epoch"] == 0  # resumes at epoch 1
        assert st["workers"] == ["w0", "w1"]
        cs = [_client(sched.port, "w0")]
        assert cs[0].resume["step"] == 8 and cs[0].resume["epoch"] == 1
        assert cs[0].resume["files"]["w0"]["sha256"] == "aa"
        assert cs[0].ckpt_manifest()["resume"] is True
        assert journal.ControlState.rebuild(jp).struct() == _live(sched)
    finally:
        _close_all(sched, cs)


def test_torn_with_no_prior_commit_resumes_fresh(tmp_path):
    jp = _journal_with(tmp_path, _base_ops()[:-1])  # no commit journaled
    hw = str(tmp_path / "hosts")
    job.write_hosts(hw, ["w0", "w1"])
    sched = Scheduler(host_worker_file=hw, journal_path=jp, resume=True)
    cs = []
    try:
        st = _live(sched)
        assert st["ckpt_committed"] is None and st["ckpt_pending"] is None
        assert st["last_completed_epoch"] == -1
        cs = [_client(sched.port, "w0")]
        assert cs[0].resume is None
    finally:
        _close_all(sched, cs)


def test_crash_during_resume_boots_again(tmp_path):
    """A resume boot that dies leaves a journal the next resume boot
    replays to the same committed manifest, and a worker dying at its
    ``worker.resume`` site leaves the blobs reusable."""
    jp = _journal_with(tmp_path, _base_ops())
    hw = str(tmp_path / "hosts")
    job.write_hosts(hw, ["w0", "w1"])
    s1 = Scheduler(host_worker_file=hw, journal_path=jp, resume=True)
    assert _live(s1)["resume_seq"] == 1
    s1.close()
    s2 = Scheduler(host_worker_file=hw, journal_path=jp, resume=True)
    cs = []
    try:
        st = _live(s2)
        assert st["resume_seq"] == 2
        assert st["ckpt_committed"]["step"] == 8
        cs = [_client(s2.port, "w1")]
        assert cs[0].resume["step"] == 8
        assert journal.ControlState.rebuild(jp).struct() == _live(s2)
    finally:
        _close_all(s2, cs)


def test_elastic_resume_resized_fleet(tmp_path):
    """Resume into N+1 workers: the host file seeds the fleet, and a new
    worker without a blob of its own gets the manifest (and restores a
    donor's blob)."""
    jp = _journal_with(tmp_path, _base_ops())
    hw = str(tmp_path / "hosts")
    job.write_hosts(hw, ["w0", "w1", "w2"])
    sched = Scheduler(host_worker_file=hw, journal_path=jp, resume=True)
    cs = []
    try:
        assert _live(sched)["workers"] == ["w0", "w1", "w2"]
        cs = [_client(sched.port, "w2")]
        assert cs[0].resume["step"] == 8
        assert "w2" not in cs[0].resume["files"]
    finally:
        _close_all(sched, cs)


def test_drain_rpc_removes_host_and_aborts_pinned_window(tmp_path):
    hw = str(tmp_path / "hosts")
    job.write_hosts(hw, ["w0", "w1"])
    jp = str(tmp_path / "j")
    sched = Scheduler(host_worker_file=hw, journal_path=jp)
    cs = []
    try:
        cs = [_client(sched.port, h) for h in ("w0", "w1")]
        c0, c1 = cs
        assert c0.ckpt_begin(8, 1)["ok"]  # pinned to {w0, w1}
        assert c1.drain()["ok"]
        st = _live(sched)
        assert st["workers"] == ["w0"]
        assert st["ckpt_pending"] is None  # aborted: w1 can never ack
        assert "w1" in st["draining"]
        assert journal.ControlState.rebuild(jp).struct() == st
        # the next cadence step pins the survivor and commits alone
        assert c0.ckpt_begin(16, 2)["ok"]
        assert c0.ckpt_ack(16, "/d/w0-16", "cc", {})["committed"]
    finally:
        _close_all(sched, cs)


# ---------------------------------------------------------------------------
# checkpoint files
# ---------------------------------------------------------------------------

def _tiny_state(seed=0):
    model = models.create("mlp", device="cpu", num_classes=3, hidden=(8,),
                          in_shape=(4, 4, 1))
    with torch.no_grad():
        g = torch.Generator().manual_seed(seed)
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    st = TrainState.create(model, optim.create("sgd", learning_rate=0.1,
                                               momentum=0.9))
    st.step = 5
    for m in st.opt_state["mom"].values():
        m.normal_(generator=g)
    st.opt_state["count"] = 5
    return st


def test_async_save_bytes_equal_a_synchronous_save(tmp_path):
    """The snapshot is whole at the call: an update right after an async
    save does not reach the file, whose bytes equal a synchronous save of
    the same state."""
    st = _tiny_state()
    sync_path = checkpoint.save_checkpoint(str(tmp_path / "s"), 5, st)
    fut = checkpoint.save_checkpoint(str(tmp_path / "a"), 5, st,
                                     async_save=True,
                                     cursor={"batches_done": 1})
    with torch.no_grad():  # the next in-place update
        for p in st.module.parameters():
            p.add_(1.0)
        for m in st.opt_state["mom"].values():
            m.mul_(0.5)
    path = fut.result(timeout=30)
    checkpoint.flush_saves(timeout=30)
    assert open(path, "rb").read() == open(sync_path, "rb").read()
    ent = checkpoint.checkpoint_info(str(tmp_path / "a"), 5)
    assert ent["cursor"] == {"batches_done": 1}
    assert ent["sha256"] == checkpoint.checkpoint_info(
        str(tmp_path / "s"), 5)["sha256"]


def test_async_save_failure_surfaces_on_next_save(tmp_path, monkeypatch):
    st = _tiny_state()
    prefix = str(tmp_path / "ckpt")
    boom = OSError(28, "No space left on device")

    def _fail(path, blob):
        raise boom

    before = obs_trace.tracer().get_counter("ckpt.save_errors")
    monkeypatch.setattr(checkpoint, "_write_bytes", _fail)
    fut = checkpoint.save_checkpoint(prefix, 1, st, async_save=True)
    with pytest.raises(OSError):
        fut.result(timeout=30)
    monkeypatch.undo()
    with pytest.raises(checkpoint.CheckpointSaveError) as ei:
        checkpoint.save_checkpoint(prefix, 2, st, async_save=True)
    assert ei.value.__cause__ is boom
    assert obs_trace.tracer().get_counter("ckpt.save_errors") == before + 1
    assert os.path.exists(checkpoint.save_checkpoint(prefix, 3, st))
    checkpoint.flush_saves(timeout=30)


def test_flush_saves_surfaces_failure(tmp_path, monkeypatch):
    st = _tiny_state()
    monkeypatch.setattr(checkpoint, "_write_bytes",
                        lambda p, b: (_ for _ in ()).throw(OSError("io")))
    fut = checkpoint.save_checkpoint(str(tmp_path / "c"), 1, st,
                                     async_save=True)
    with pytest.raises(checkpoint.CheckpointSaveError):
        checkpoint.flush_saves(timeout=30)
    assert fut.done()


def test_corrupt_state_file_detected_at_offsets(tmp_path):
    st = _tiny_state()
    prefix = str(tmp_path / "ckpt")
    path = checkpoint.save_checkpoint(prefix, 5, st)
    sha = checkpoint.checkpoint_info(prefix, 5)["sha256"]
    blob = open(path, "rb").read()
    for cut in (0, 1, len(blob) // 2, len(blob) - 1):
        with open(path, "wb") as f:
            f.write(blob[:cut])
        with pytest.raises(checkpoint.CheckpointCorruptError) as ei:
            checkpoint.load_checkpoint(prefix, 5)
        assert path in str(ei.value)
        with pytest.raises(checkpoint.CheckpointCorruptError):
            checkpoint.load_checkpoint_file(path, _tiny_state(1))
    with open(path, "wb") as f:
        f.write(blob[:-8] + bytes(8))
    with pytest.raises(checkpoint.CheckpointCorruptError,
                       match="sha256 mismatch"):
        checkpoint.load_checkpoint(prefix, 5)
    with pytest.raises(checkpoint.CheckpointCorruptError,
                       match="sha256 mismatch"):
        checkpoint.load_checkpoint_file(path, _tiny_state(1), sha256=sha)
    with open(path, "wb") as f:
        f.write(blob)
    other = checkpoint.load_checkpoint_file(path, _tiny_state(1),
                                            sha256=sha)
    assert msgpack.pack(export_jax_train_state(other)) == blob
    with pytest.raises(checkpoint.CheckpointCorruptError):
        checkpoint.load_checkpoint_file(path, _tiny_state(1),
                                        sha256="00" * 32)


def test_load_latest_falls_back_past_corrupt_newest(tmp_path):
    prefix = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(prefix, 1, _tiny_state(1))
    p2 = checkpoint.save_checkpoint(prefix, 2, _tiny_state(2))
    with open(p2, "r+b") as f:
        f.truncate(7)
    st = _tiny_state(3)
    got = checkpoint.load_latest_checkpoint(prefix, st)
    assert got is not None and got[0] == 1 and got[1] is st
    assert msgpack.pack(export_jax_train_state(st)) == \
        open(f"{prefix}-0001.state", "rb").read()
    assert checkpoint.load_latest_checkpoint(str(tmp_path / "none"),
                                             st) is None


def test_saved_tags_ignore_tmp_and_zero_byte_and_grow_past_four_digits(
        tmp_path):
    st = _tiny_state()
    prefix = str(tmp_path / "ckpt")
    checkpoint.save_checkpoint(prefix, 1, st)
    open(f"{prefix}-0002.state.tmp", "wb").write(b"half")
    open(f"{prefix}-0003.state", "wb").close()
    assert checkpoint.latest_checkpoint(prefix) == 1
    checkpoint.save_checkpoint(prefix, 12000, st)
    assert checkpoint.latest_checkpoint(prefix) == 12000
    assert checkpoint.load_latest_checkpoint(prefix, _tiny_state(1))[0] == \
        12000
    assert checkpoint.checkpoint_info(prefix, 12000)["bytes"] > 0


def _make_iter(seed=7):
    rng = np.random.RandomState(0)
    x = rng.rand(23, 4).astype(np.float32)
    y = np.arange(23) % 3
    return io.NDArrayIter(x, y, batch_size=4, shuffle=True, seed=seed)


def _consume(it):
    out = []
    try:
        while True:
            out.append(np.asarray(it.next().data).copy())
    except StopIteration:
        return out


def test_fast_forward_and_skip_replay_exactly():
    orig = _make_iter()
    for _ in range(2):
        orig.reset()
        _consume(orig)
    orig.reset()
    for _ in range(3):
        orig.next()
    expect_next = np.asarray(orig.next().data).copy()
    res = _make_iter()
    fleet_ckpt.fast_forward(res, 2)
    res.reset()
    assert fleet_ckpt.skip_batches(res, 3) == 3
    np.testing.assert_array_equal(np.asarray(res.next().data), expect_next)
    it = _make_iter()
    it.reset()
    n_total = len(_consume(it))
    it.reset()
    assert fleet_ckpt.skip_batches(it, n_total + 5) == n_total


def test_fleet_checkpoint_round_trip_via_scheduler(tmp_path, monkeypatch):
    """``FleetCheckpointer.from_env`` and one two-phase round against a
    port scheduler, then the restore through the committed manifest."""
    assert fleet_ckpt.FleetCheckpointer.from_env(object(), "w0") is None
    monkeypatch.setenv("DT_CKPT_DIR", str(tmp_path / "fleet"))
    assert fleet_ckpt.FleetCheckpointer.from_env(None, "w0") is None
    monkeypatch.setenv("DT_CKPT_EVERY", "4")
    hw = str(tmp_path / "hosts")
    job.write_hosts(hw, ["w0"])
    sched = Scheduler(host_worker_file=hw, journal_path=str(tmp_path / "j"))
    cs = []
    try:
        c0 = _client(sched.port, "w0")
        cs = [c0]
        fc = fleet_ckpt.FleetCheckpointer.from_env(c0, "w0")
        assert fc.every == 4 and fc.prefix == os.path.join(
            str(tmp_path / "fleet"), "w0", "fleet")
        st = _tiny_state()
        st.step = 7
        fc.maybe_step(st, 1, 3)  # off the grid: nothing
        st.step = 8
        fc.maybe_step(st, 1, 3)
        checkpoint.flush_saves(timeout=30)
        deadline = time.time() + 30
        while _live(sched)["ckpt_committed"] is None:
            assert time.time() < deadline
            time.sleep(0.02)
        com = _live(sched)["ckpt_committed"]
        assert com["step"] == 8
        ent = com["files"]["w0"]
        assert ent["cursor"] == {"batches_done": 3, "epoch": 1, "step": 8}
        fresh = _tiny_state(4)
        restored, cur = fleet_ckpt.restore_state(com, "w0", fresh)
        assert restored is fresh and restored.step == 8
        assert cur["batches_done"] == 3
        # a host without a blob of its own restores the donor's
        donor, _ = fleet_ckpt.restore_state(com, "w9", _tiny_state(5))
        assert msgpack.pack(export_jax_train_state(donor)) == \
            open(ent["path"], "rb").read()
        assert json.loads(json.dumps(com, sort_keys=True)) == com
    finally:
        _close_all(sched, cs)


# ---------------------------------------------------------------------------
# whole fleets: killed and resumed, within the port and across packages
# ---------------------------------------------------------------------------

def _run(tmp, sched_port, kinds, env, tag, args=()):
    outs = {h: os.path.join(tmp, f"{h}.{tag}.json") for h in kinds}
    procs = {h: job.spawn(kind, sched_port, h, outs[h], EPOCHS, env,
                          args=args if kind == "port" else ())
             for h, kind in kinds.items()}
    try:
        job.wait_ok(procs, timeout=240)
    finally:
        job.kill_all(procs)
    return {h: job.load(outs[h]) for h in outs}


def _journal_upto_commit(src, dst, step):
    """Copy ``src``'s records up to and including the commit of ``step``
    (the journal of a job that died right after that commit)."""
    data = open(src, "rb").read()
    off, hdr = 0, struct.Struct("<II")
    for _fence, op, kw in journal.replay(src):
        n, _crc = hdr.unpack_from(data, off)
        off += hdr.size + n
        if op == "ckpt_commit" and kw["step"] == step:
            with open(dst, "wb") as f:
                f.write(data[:off])
            return kw["manifest"]
    raise AssertionError(f"no commit of step {step} in {src}")


def test_port_fleet_killed_after_commit_resumes_bit_identical(tmp_path):
    hosts = {"w0": "port", "w1": "port"}
    # never killed
    base_dir = str(tmp_path / "base")
    os.makedirs(base_dir)
    hw = os.path.join(base_dir, "hw")
    job.write_hosts(hw, list(hosts))
    sp, port = job.start_scheduler(
        base_dir, "sched", ["--journal", os.path.join(base_dir, "j"),
                            "--host-worker-file", hw])
    env = dict(ENV, DT_CKPT_DIR=os.path.join(base_dir, "ckpt"),
               DT_CKPT_EVERY=str(EVERY))
    try:
        base = _run(base_dir, port, hosts, env, "base")
    finally:
        job.stop_scheduler(sp, port)
    # killed after the step-12 commit: every worker holds before step 14
    # (a stall rule), so the kill lands between the commit and step 16
    tmp = str(tmp_path / "kill")
    os.makedirs(tmp)
    hw = os.path.join(tmp, "hw")
    job.write_hosts(hw, list(hosts))
    jp = os.path.join(tmp, "j")
    sp, port = job.start_scheduler(tmp, "sched", ["--journal", jp,
                                                  "--host-worker-file", hw])
    env = dict(ENV, DT_CKPT_DIR=os.path.join(tmp, "ckpt"),
               DT_CKPT_EVERY=str(EVERY), DT_FAULT_PLAN=json.dumps(
                   {"seed": 0, "rules": [{"kind": "stall",
                                          "site": "worker.step",
                                          "after": 13}]}))
    procs = {h: job.spawn("port", port, h, os.path.join(tmp, f"{h}.k.json"),
                          EPOCHS, env) for h in hosts}
    try:
        deadline = time.monotonic() + 120
        while True:
            view = protocol.request("127.0.0.1", port,
                                    {"cmd": "ckpt_manifest"}, timeout=10)
            if view["committed"] and view["committed"]["step"] >= 12:
                break
            assert time.monotonic() < deadline
            assert all(p.poll() is None for p in procs.values())
            time.sleep(0.02)
        assert view["committed"]["step"] == 12
    finally:
        for p in list(procs.values()) + [sp]:
            p.send_signal(signal.SIGKILL)
        for p in list(procs.values()) + [sp]:
            p.wait(timeout=30)
    # resumed on the same journal
    sp, port = job.start_scheduler(tmp, "resumed",
                                   ["--journal", jp, "--host-worker-file",
                                    hw, "--resume"])
    env = dict(ENV, DT_CKPT_DIR=os.path.join(tmp, "ckpt"),
               DT_CKPT_EVERY=str(EVERY), DT_RESUME="1")
    try:
        res = _run(tmp, port, hosts, env, "res")
    finally:
        job.stop_scheduler(sp, port)
    for h in hosts:
        assert res[h]["resumed_from_step"] == 12
        assert base[h]["resumed_from_step"] is None
        assert res[h]["final_step"] == base[h]["final_step"] == EPOCHS * 8
        assert res[h]["epochs"][-1]["sha256"] == \
            base[h]["epochs"][-1]["sha256"]
        assert [e["steps"] for e in res[h]["epochs"]] == [4, 8]
    st = journal.ControlState.rebuild(jp).struct()
    assert st["resume_seq"] == 1 and st["ckpt_committed"]["step"] == 24


def _tinybn_state():
    import torch_elastic_worker as tw
    return TrainState.create(tw.TinyBNNet(), optim.create(
        "sgd", learning_rate=0.1, momentum=0.9))


@pytest.mark.parametrize("writer", ["jax", "port"],
                         ids=["jax_writes_port_resumes",
                              "port_writes_jax_resumes"])
def test_fleet_checkpoint_resumes_across_packages(tmp_path, writer):
    """One package's fleet runs to the end, checkpointing every 4 steps;
    the other package's fleet resumes from its step-12 commit (the
    journal cut right after it) and finishes the run."""
    reader = "port" if writer == "jax" else "jax"
    hosts = ["w0", "w1"]
    hw = str(tmp_path / "hw")
    job.write_hosts(hw, hosts)
    jp = str(tmp_path / "ctrl.journal")
    env = dict(ENV, DT_CKPT_DIR=str(tmp_path / "ckpt"),
               DT_CKPT_EVERY=str(EVERY))
    sched = (JScheduler if writer == "jax" else Scheduler)(
        host_worker_file=hw, journal_path=jp)
    try:
        full = _run(str(tmp_path), sched.port, dict.fromkeys(hosts, writer),
                    env, "full")
    finally:
        sched.close()
    cut = str(tmp_path / "cut.journal")
    manifest = _journal_upto_commit(jp, cut, 12)
    # the restored state equals the blob, bit for bit
    for h in hosts:
        ent = manifest["files"][h]
        st, cur = fleet_ckpt.restore_state(manifest, h, _tinybn_state())
        assert st.step == 12 and cur == {"batches_done": 4, "epoch": 1,
                                         "step": 12}
        assert msgpack.pack(export_jax_train_state(st)) == \
            open(ent["path"], "rb").read()
    env = dict(ENV, DT_CKPT_DIR=str(tmp_path / "ckpt2"),
               DT_CKPT_EVERY=str(EVERY), DT_RESUME="1")
    sched = (Scheduler if writer == "jax" else JScheduler)(
        host_worker_file=hw, journal_path=cut, resume=True)
    try:
        res = _run(str(tmp_path), sched.port, dict.fromkeys(hosts, reader),
                   env, "res")
    finally:
        sched.close()
    for h in hosts:
        assert res[h]["resumed_from_step"] == 12
        assert res[h]["final_step"] == full[h]["final_step"] == EPOCHS * 8
        for k in ("param_sum", "param_hash", "final_loss"):
            assert res[h][k] == pytest.approx(full[h][k], rel=TOL), (h, k)
