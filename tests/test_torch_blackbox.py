"""The port's flight recorder (``obs/blackbox.py``) against the JAX
package's.

- A bundle built from pinned inputs (clock, pid, stacks, tracer, registry,
  flight notes, state providers) is the JAX package's bundle from the same
  inputs, apart from the ``env`` view (each package's registry), and two
  writes of it are byte-identical under one digest-named file.
- Port bundles pass ``dt_tpu.obs.blackbox.validate_bundle``, port manifests
  read with ``dt_tpu.obs.blackbox.read_manifest``; the size cap trims and
  marks a bundle, the retention cap prunes files and keeps manifest rows.
- The watchdog fires once a stall, labels a compile in progress, clears on
  the next beat, as the JAX one does; a threaded one fires within its
  ``DT_HANG_S`` of 0.3 s.
- In a process: the first SIGTERM drains (a ``drain`` manifest row, no
  bundle) and the second writes the fatal ``signal.SIGTERM`` bundle and
  dies by the signal; an injected ``os._exit`` crash and an unhandled
  exception each leave their bundle.
"""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest

from dt_tpu.obs import blackbox as jbb
from dt_tpu.obs import metrics as jm
from dt_tpu.obs import trace as jtrace
from dt_tpu_torch.obs import blackbox as tbb
from dt_tpu_torch.obs import metrics as tm
from dt_tpu_torch.obs import trace as ttrace
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

import torch_elastic_job as job

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STACKS = [{"tid": 1, "name": "MainThread", "daemon": False,
           "frames": [["train.py", 10, "main"], ["faults.py", 5,
                                                   "stall_at"]]}]


@pytest.fixture
def armed(monkeypatch, tmp_path):
    monkeypatch.setenv("DT_BLACKBOX_DIR", str(tmp_path / "bb"))
    for m in (tbb, jbb):
        m._reset_for_tests()
        m.set_enabled(True)
    yield tmp_path
    for m in (tbb, jbb):
        m._reset_for_tests()
        m.set_enabled(None)


def _pinned(bb, trmod, mmod):
    tr = trmod.Tracer(name="p", wall_clock=lambda: 9_000_000_000,
                      mono_clock=lambda: 9_000_000_000, enabled=True,
                      ident=lambda: 1)
    with tr.span("step", {"epoch": 1}):
        tr.event("fault.drop", {"op": "send"})
    tr.begin("allreduce", {"key": "grads"})  # open at death
    reg = mmod.MetricsRegistry(wall_clock=lambda: 9_000_000_000,
                               enabled=True)
    reg.gauge("train.loss", 1.25)
    reg.sample()
    bb.note("fault.stall", site="worker.step", host="w1")
    bb.register_state("client:w1", lambda: {"rank": 1, "workers": ["w0",
                                                                    "w1"]})
    return dict(host="w1", fatal=True, extra={"site": "worker.step"},
                clock_ms=1234, pid=42, stacks=STACKS, tracer=tr,
                registry=reg)


def test_bundles_are_the_jax_packages_and_deterministic(armed):
    t = tbb.build_bundle("crash.worker.step", **_pinned(tbb, ttrace, tm))
    j = jbb.build_bundle("crash.worker.step", **_pinned(jbb, jtrace, jm))
    t_env, j_env = t.pop("env"), j.pop("env")
    # the flight notes carry the wall clock of the note itself
    assert [n[1:] for n in t.pop("flight_ring")] == \
        [n[1:] for n in j.pop("flight_ring")]
    assert t == j
    assert t["schema"] == jbb.SCHEMA == tbb.SCHEMA
    assert t["open_spans"][0]["name"] == "allreduce"
    # the env view is each package's registry; the shared knobs agree
    shared = set(t_env) & set(j_env)
    assert {"DT_BLACKBOX", "DT_HANG_S", "DT_METRICS", "DT_DEVICE_OBS",
            "DT_SLO_RULES"} <= shared
    assert {k: t_env[k] for k in shared} == {k: j_env[k] for k in shared}
    d = str(armed / "det")
    kw = _pinned(tbb, ttrace, tm)
    p1 = tbb.write_bundle("crash.worker.step", dirpath=d, **kw)
    p2 = tbb.write_bundle("crash.worker.step", dirpath=d, **kw)
    assert p1 == p2 and open(p1, "rb").read() == open(p2, "rb").read()
    bundle = json.load(open(p1))
    assert jbb.validate_bundle(bundle) == [] == tbb.validate_bundle(bundle)
    rows = jbb.read_manifest(d)
    assert rows == tbb.read_manifest(d) and len(rows) == 2
    assert rows[0]["kind"] == "bundle" and rows[0]["file"] == \
        os.path.basename(p1)


def test_size_cap_and_retention(armed, monkeypatch):
    d = str(armed / "cap")
    monkeypatch.setenv("DT_BLACKBOX_MAX_MB", "1")
    tr = ttrace.Tracer(enabled=True)
    for i in range(300):
        tr.event("fault.drop", {"pad": "x" * 5000, "i": i})
    p = tbb.write_bundle("exception", host="w0", dirpath=d, tracer=tr)
    b = json.load(open(p))
    assert b["truncated"] is True and os.path.getsize(p) <= 1 << 20
    assert len(b["span_ring"]["records"]) == 32
    assert jbb.validate_bundle(b) == []
    monkeypatch.setenv("DT_BLACKBOX_MAX_BUNDLES", "2")
    for i in range(4):
        tbb.write_bundle("hang", host="w0", fatal=False, dirpath=d,
                         clock_ms=10_000 + i, stacks=STACKS)
    files = [n for n in os.listdir(d) if n.startswith("bb-")]
    assert len(files) == 2
    assert len([r for r in jbb.read_manifest(d)
                if r["kind"] == "bundle"]) == 5
    tbb.set_enabled(False)
    assert tbb.write_bundle("exception", dirpath=d) is None


def _watch(bb, trmod, d):
    clock = {"t": 100.0}
    tr = trmod.Tracer(enabled=True, wall_clock=lambda: 1, mono_clock=lambda:
                      1, ident=lambda: 1)
    dog = bb.Watchdog(host="w1", hang_seconds=1.0, tracer=tr,
                      clock=lambda: clock["t"], dirpath=d,
                      start_thread=False)
    fired = [dog.tick()]
    clock["t"] += 2.0
    t0 = tr.begin("compile.nvcc")
    fired += [dog.tick(), dog.tick()]  # edge-triggered
    tr.complete_span("compile.nvcc", t0)
    dog.beat(step=3)
    clock["t"] += 2.0
    fired += [dog.tick(), dog.suspected()]
    dog.beat(step=4)
    return fired, [(r[2], r[8]) for r in tr.snapshot()["records"]]


def test_watchdog_fires_and_clears_as_the_jax_one(armed):
    t = _watch(tbb, ttrace, str(armed / "t"))
    j = _watch(jbb, jtrace, str(armed / "j"))
    assert t == j
    assert t[0] == [False, True, False, True, True]
    events = [n for n, _ in t[1] if n.startswith("hang.")]
    assert events == ["hang.suspect", "hang.clear", "hang.suspect",
                      "hang.clear"]
    first = [a for n, a in t[1] if n == "hang.suspect"][0]
    assert first["compile"] == "compile.nvcc" and first["compile_in_progress"]
    bundles = [r for r in tbb.read_manifest(str(armed / "t"))
               if r["kind"] == "bundle"]
    assert [r["trigger"] for r in bundles] == ["hang", "hang"]


def test_threaded_watchdog_fires_within_hang_s(armed):
    d = str(armed / "thr")
    with job.deadline(20):
        dog = tbb.Watchdog(host="w0", hang_seconds=0.3, dirpath=d)
        try:
            end = time.monotonic() + 5.0
            while not dog.suspected() and time.monotonic() < end:
                time.sleep(0.05)
            assert dog.suspected()
        finally:
            dog.stop()
    rows = tbb.read_manifest(d)
    assert rows and rows[0]["trigger"] == "hang" and not rows[0]["fatal"]


_SIGTERM_CHILD = textwrap.dedent("""
    import os, sys, time
    sys.path.insert(0, sys.argv[1])
    from dt_tpu_torch.elastic import drain
    from dt_tpu_torch.obs import blackbox
    assert blackbox.install(host="w0")
    assert drain.install("w0")
    print("ready", flush=True)
    while not drain.requested():
        time.sleep(0.02)
    drain.announce("w0")
    print("drained", flush=True)
    while True:
        time.sleep(0.1)
""")


def _child_env(tmp):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(DT_BLACKBOX="1", DT_BLACKBOX_DIR=str(tmp))
    return env


def test_sigterm_drains_first_and_bundles_second(tmp_path):
    d = tmp_path / "bb"
    with job.deadline(60):
        p = subprocess.Popen([sys.executable, "-c", _SIGTERM_CHILD, ROOT],
                             env=_child_env(d), stdout=subprocess.PIPE,
                             text=True)
        try:
            assert p.stdout.readline().strip() == "ready"
            p.send_signal(signal.SIGTERM)
            assert p.stdout.readline().strip() == "drained"
            rows = jbb.read_manifest(str(d))
            assert [r["kind"] for r in rows] == ["drain"]
            p.send_signal(signal.SIGTERM)
            assert p.wait(timeout=30) == -signal.SIGTERM
        finally:
            if p.poll() is None:
                p.kill()
    rows = jbb.read_manifest(str(d))
    assert [(r["kind"], r.get("trigger")) for r in rows] == [
        ("drain", "SIGTERM"), ("bundle", "signal.SIGTERM")]
    bundle = json.load(open(d / rows[1]["file"]))
    assert jbb.validate_bundle(bundle) == [] and bundle["fatal"] is True


def test_crash_and_exception_leave_bundles(tmp_path):
    d = tmp_path / "bb"
    crash = textwrap.dedent("""
        import sys
        sys.path.insert(0, sys.argv[1])
        from dt_tpu_torch.elastic import faults
        from dt_tpu_torch.obs import blackbox
        blackbox.install(host="w1")
        faults.install(faults.FaultPlan([{"kind": "crash",
            "site": "module.epoch_begin", "action": "exit"}], seed=0))
        faults.crash_point("module.epoch_begin", host="w1", epoch=2)
    """)
    boom = textwrap.dedent("""
        import sys
        sys.path.insert(0, sys.argv[1])
        from dt_tpu_torch.obs import blackbox
        blackbox.install(host="w2")
        raise ValueError("boom")
    """)
    with job.deadline(60):
        rc1 = subprocess.run([sys.executable, "-c", crash, ROOT],
                             env=_child_env(d), capture_output=True,
                             timeout=30).returncode
        rc2 = subprocess.run([sys.executable, "-c", boom, ROOT],
                             env=_child_env(d), capture_output=True,
                             timeout=30).returncode
    assert (rc1, rc2) == (137, 1)
    rows = [r for r in jbb.read_manifest(str(d)) if r["kind"] == "bundle"]
    assert [(r["host"], r["trigger"]) for r in rows] == [
        ("w1", "crash.module.epoch_begin"), ("w2", "exception")]
    for r in rows:
        b = json.load(open(d / r["file"]))
        assert jbb.validate_bundle(b) == [] and b["fatal"] is True
    assert b["extra"]["error"].startswith("ValueError: boom")
    # a process that wrote a fatal bundle trails no clean exit row
    assert not [r for r in jbb.read_manifest(str(d)) if r["kind"] == "exit"]
