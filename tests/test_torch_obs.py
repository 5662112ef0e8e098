"""The port's tracer, name catalog and export against the JAX package's.

- The catalog (``obs/names.py``) is the JAX package's, and ``lookup``
  resolves the same names the same way.
- Two tracers, one of each package, with the same injected clocks and
  thread ident, fed one seeded sequence of nested spans, named begins,
  events, abandons and counters, hold the same records, open spans and
  counters.
- A real port job (two port workers of ``tests/torch_elastic_worker.py``
  on the CPU against the port's scheduler, every plane armed) gives a
  dump whose chrome trace, summary and written files are the same from
  either package's ``export``; the summary's critical path names a
  worker, and the unedited ``tools/dtop.py`` renders the trace and the
  job's post-mortem directory (by subprocess, exit 0).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from dt_tpu.obs import export as jexport
from dt_tpu.obs import names as jnames
from dt_tpu.obs import trace as jtrace
from dt_tpu_torch.obs import export as texport
from dt_tpu_torch.obs import names as tnames
from dt_tpu_torch.obs import trace as ttrace
from torch_one_thread import ENV, one_torch_thread  # noqa: F401 (fixture)

import torch_elastic_job as job

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_catalog_and_lookup_are_the_jax_packages():
    assert dict(tnames.NAME_REGISTRY) == dict(jnames.NAME_REGISTRY)
    # the port's own rows are apart, and none shadows a JAX name
    assert not set(tnames.PORT_NAMES) & set(jnames.NAME_REGISTRY)
    for name in tnames.PORT_NAMES:
        with pytest.raises(KeyError):
            jnames.lookup(name)
    for name in ("step", "fault.crash", "rpc.allreduce", "compile.nvcc",
                 "membership.ADDED", "device.hbm_bytes", "health.halt"):
        assert tnames.lookup(name) == jnames.lookup(name), name
    for bad in ("nope", "steps"):
        with pytest.raises(KeyError):
            tnames.lookup(bad)
        with pytest.raises(KeyError):
            jnames.lookup(bad)


def _drive(mod, seed):
    """One seeded sequence through a tracer of ``mod``: nested spans, named
    begins (one abandoned, one left open), events inside spans, counters.
    Returns the tracer."""
    rng = np.random.RandomState(seed)
    clock = {"t": 1_000_000_000}

    def tick():
        clock["t"] += int(rng.randint(1, 5000)) * 1000
        return clock["t"]

    tr = mod.Tracer(name="t", capacity=64, wall_clock=tick, mono_clock=tick,
                    enabled=True, ident=lambda: 7)
    for i in range(6):
        with tr.span("step", {"i": i}):
            tr.event("fault.drop", {"i": i})
            with tr.span("allreduce"):
                t0 = tr.begin("wire.request", {"cmd": "allreduce"})
                if i % 3 == 0:
                    tr.abandon(t0)
                else:
                    tr.complete_span("wire.request", t0, {"try": i})
            tr.counter("allreduce.rounds", int(rng.randint(1, 4)))
    tr.begin("mc_barrier", {"epoch": 1})  # still open
    return tr


def test_tracer_records_equal_the_jax_tracer():
    t, j = _drive(ttrace, 3), _drive(jtrace, 3)
    assert t.snapshot() == j.snapshot()
    assert t.open_spans() == j.open_spans()
    assert t.counters() == j.counters()
    # nested spans carry their parent's id, events their span's
    recs = t.snapshot()["records"]
    steps = {r[6] for r in recs if r[2] == "step"}
    assert {r[7] for r in recs if r[2] == "allreduce"} == steps
    assert all(r[7] in steps for r in recs if r[2] == "fault.drop")
    assert t.drain(5) == j.drain(5)
    assert t.drain() == j.drain()


def test_a_disabled_tracer_keeps_nothing():
    tr = ttrace.Tracer(enabled=False)
    with tr.span("step"):
        tr.event("fault.drop")
    assert tr.begin("step") is None and tr.now() is None
    tr.counter("wire.retries")
    snap = tr.snapshot()
    assert snap["records"] == [] and snap["counters"] == {"wire.retries": 1}


@pytest.fixture(scope="module")
def port_job(tmp_path_factory):
    """One 2-worker port tinybn job on the CPU, every plane armed against
    the port's scheduler in this process; returns (dump, results, dir)."""
    from dt_tpu_torch.elastic.scheduler import Scheduler
    from dt_tpu_torch.obs import metrics as tmetrics
    tmp = str(tmp_path_factory.mktemp("obsjob"))
    bb = os.path.join(tmp, "bb")
    planes = {"DT_OBS": "1", "DT_METRICS": "1", "DT_METRICS_INTERVAL_S":
              "0.2", "DT_BLACKBOX": "1", "DT_BLACKBOX_DIR": bb,
              "DT_DEVICE_OBS": "1"}
    ttrace.set_enabled(True)
    tmetrics.set_enabled(True)
    sched = Scheduler(initial_workers=["w0", "w1"])
    procs = {}
    try:
        for h in ("w0", "w1"):
            procs[h] = job.spawn("port", sched.port, h,
                                 os.path.join(tmp, f"{h}.json"), 1,
                                 dict(ENV, **planes), device="cpu")
        job.wait_ok(procs, timeout=120)
        dump = sched.obs_dump()
    finally:
        job.kill_all(procs)
        sched.close()
        ttrace.set_enabled(None)
        tmetrics.set_enabled(None)
    res = {h: job.load(os.path.join(tmp, f"{h}.json")) for h in procs}
    return dump, res, tmp


def test_port_job_exports_as_the_jax_package_does(port_job):
    dump, res, tmp = port_job
    workers = sorted(k for k in dump["tracks"] if k != "control-plane")
    assert [k.split("#")[0] for k in workers] == ["w0", "w1"]
    for k in workers:
        names = {r[2] for r in dump["tracks"][k]["records"]}
        steps = sum(r[2] == "step" for r in dump["tracks"][k]["records"])
        assert steps == res[k.split("#")[0]]["final_step"] == 8
        for n in names:  # every recorded name is in the catalog
            tnames.lookup(n)
    tc, jc = texport.chrome_trace(dump), jexport.chrome_trace(dump)
    assert json.dumps(tc, sort_keys=True) == json.dumps(jc, sort_keys=True)
    ts, js = texport.summarize_chrome(tc), jexport.summarize_chrome(jc)
    assert json.dumps(ts, sort_keys=True) == json.dumps(js, sort_keys=True)
    tpath, jpath = os.path.join(tmp, "t.json"), os.path.join(tmp, "j.json")
    texport.write(tpath, dump)
    jexport.write(jpath, dump)
    for a, b in ((tpath, jpath), (texport.metrics_path(tpath),
                                  jexport.metrics_path(jpath))):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
    # the critical path decomposes each worker's steps and names the
    # worker the rounds waited on
    crit = ts["critical_path"]
    assert {k for k, v in crit.items() if v["steps"] == 8} == set(workers)
    assert ts["straggler_blame"] and \
        set(ts["straggler_blame"]) <= {"w0", "w1"}, ts["straggler_blame"]


def test_dtop_renders_a_port_trace_and_post_mortem(port_job):
    dump, _, tmp = port_job
    path = os.path.join(tmp, "dtop.json")
    texport.write(path, dump)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "tools/dtop.py", path], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "w0#" in out.stdout and "w1#" in out.stdout
    # the clean exits left manifest rows; a bundle makes the post-mortem
    from dt_tpu_torch.obs import blackbox
    blackbox.set_enabled(True)
    try:
        assert blackbox.write_bundle("exception", host="w0", fatal=True,
                                     dirpath=os.path.join(tmp, "bb"))
    finally:
        blackbox.set_enabled(None)
    out = subprocess.run([sys.executable, "tools/dtop.py", "--postmortem",
                          os.path.join(tmp, "bb")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "exception" in out.stdout


def test_dtop_renders_a_live_port_scheduler(monkeypatch):
    """``tools/dtop.py --scheduler`` against the port's scheduler: the
    job summary from ``obs_dump``, ``--health`` (the metrics plane's
    view), ``--status`` and ``--capture`` (queued on a live worker)."""
    from dt_tpu.elastic import protocol as jproto
    from dt_tpu_torch.elastic.scheduler import Scheduler
    from dt_tpu_torch.obs import metrics as tmetrics
    tmetrics.set_enabled(True)
    sched = Scheduler(initial_workers=["w0", "w1"])
    try:
        recs = [["X", i, "step", 1_700_000_000_000_000 + 1000 * i, 400, 5,
                 i, None, {"epoch": 0}] for i in range(1, 5)]
        jproto.request("127.0.0.1", sched.port, {
            "cmd": "heartbeat", "host": "w0", "pseq": 0,
            "obs": {"inc": 9, "fseq": 1, "records": recs, "counters": {},
                    "dropped": 0},
            "hm": {"inc": 9, "gseq": 1, "samples": [
                {"seq": 1, "ts_ms": 1, "gauges": {"train.steps": 4.0}}],
                "gauges": [["train.loss", [], 1.5]], "hists": [],
                "dropped": 0}}, timeout=10)
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        addr = f"127.0.0.1:{sched.port}"
        outs = {}
        for flags in ([], ["--health"], ["--status"],
                      ["--capture", "w1", "--steps", "2"]):
            out = subprocess.run(
                [sys.executable, "tools/dtop.py", "--scheduler", addr]
                + flags, cwd=ROOT, env=env, capture_output=True,
                text=True, timeout=60)
            assert out.returncode == 0, (flags, out.stderr[-2000:])
            outs[" ".join(flags)] = out.stdout
        assert "w0#9" in outs[""]
        assert json.loads(outs["--capture w1 --steps 2"])["queued"] is True
        assert outs["--health"].strip() and outs["--status"].strip()
    finally:
        sched.close()
        tmetrics.set_enabled(None)
