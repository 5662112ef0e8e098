"""The port's device plane (``obs/device.py``) against the JAX package's,
on the CPU (the card tests are in ``tests/test_torch_cuda.py``).

- The ``device.*`` gauges set from injected device views are the JAX
  package's gauges from the same views; the census of live tensors, with
  provenance tags, is the JAX census of arrays of the same shapes and
  dtypes.
- The launch ledger: a kernel's first (shape, dtype) signature is an
  entry, a new one a ``compile.recompile`` naming what changed, with the
  JAX package's signature digests; an ``nvcc`` build runs in an open
  ``compile.nvcc`` span.
- ``torch.cuda.OutOfMemoryError`` is an OOM, and with the blackbox armed
  it leaves a bundle whose census names the largest tensors first.
- A worker registered on ``cuda`` without CUDA raises (no zeros).
- A capture armed for 2 steps writes a ``torch.profiler`` trace and a
  manifest row; a re-delivered command is a no-op; a capture armed while
  a profiler runs fails loudly.
"""

import json
import os

import numpy as np
import pytest
import torch

from dt_tpu.obs import blackbox as jbb
from dt_tpu.obs import device as jdev
from dt_tpu.obs import metrics as jm
from dt_tpu_torch.obs import blackbox as tbb
from dt_tpu_torch.obs import device as tdev
from dt_tpu_torch.obs import metrics as tm
from dt_tpu_torch.obs import trace as ttrace
from dt_tpu_torch.utils import profiler as tprof
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)


@pytest.fixture
def armed(monkeypatch, tmp_path):
    monkeypatch.setenv("DT_BLACKBOX_DIR", str(tmp_path / "bb"))
    for m in (tdev, jdev, tbb, jbb):
        m._reset_for_tests()
        m.set_enabled(True)
    yield tmp_path
    for m in (tdev, jdev, tbb, jbb):
        m._reset_for_tests()
        m.set_enabled(None)


class _Dev:
    def __init__(self, i, used, peak, limit):
        self.id = i
        self._ms = {"bytes_in_use": used, "peak_bytes_in_use": peak,
                    "bytes_limit": limit}

    def memory_stats(self):
        return dict(self._ms)


def test_hbm_gauges_are_the_jax_packages(armed):
    devs = [_Dev(0, 5 << 30, 9 << 30, 80 << 30), _Dev(1, 1 << 20, 2 << 20,
                                                      0)]
    out = []
    for mod, mm in ((tdev, tm), (jdev, jm)):
        reg = mm.MetricsRegistry(wall_clock=lambda: 1, enabled=True)
        snap = mod.sample_into(reg, devices=devs)
        out.append(([g for g in reg.gauges_export()
                     if g[0] != "device.host_rss_bytes"], snap["devices"]))
    assert out[0] == out[1]
    assert [g[0] for g in out[0][0]] == [
        "device.hbm_bytes", "device.hbm_bytes", "device.hbm_limit_bytes",
        "device.hbm_peak_bytes", "device.hbm_peak_bytes"]
    # the worker's own device: CPU has no HBM rows, cuda without CUDA
    # raises rather than reporting zeros
    tdev.register_device("cpu")
    assert tdev.memory_snapshot()["devices"] == []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tdev.register_device("cuda")


def test_census_is_the_jax_packages(armed):
    shapes = [((64, 3, 7, 7), "float32"), ((64,), "float32"),
              ((64,), "float32"), ((1000, 2048), "bfloat16"),
              ((3, 3), "float32")]
    tt = [torch.zeros(s, dtype=getattr(torch, d)) for s, d in shapes]
    ja = [np.zeros(s, np.float32 if d == "float32" else np.float16)
          for s, d in shapes]
    tdev.register_provenance("params", lambda: {tdev.shape_key(tt[0])})
    jdev.register_provenance("params", lambda: {("(64, 3, 7, 7)",
                                                 "float32")})
    got = tdev.live_buffer_census(top=3, arrays=tt)
    want = jdev.live_buffer_census(top=3, arrays=ja)
    # bfloat16 stands as float16 on the JAX side (the same itemsize)
    for g in want:
        g["dtype"] = g["dtype"].replace("float16", "bfloat16")
    assert got == want
    assert got[0]["shape"] == "(1000, 2048)" and got[1]["tag"] == "params"


def test_launch_ledger_and_nvcc_span(armed):
    tr = ttrace.tracer()
    ttrace.set_enabled(True)
    try:
        tr.drain()
        a = torch.zeros(4, 8)
        for t in (a, a, torch.zeros(2, 8), torch.zeros(2, 8,
                                                       dtype=torch.bfloat16)):
            tdev.note_launch("fused_bn_train", (t,), 0.5)
        s = tdev.summary()
        assert s["by_what"]["fused_bn_train"]["builds"] == 3
        assert [r["changed"] for r in s["recompile_log"]] == [["shape"],
                                                              ["dtype"]]
        key = (tdev.shape_key(a),)
        assert tdev._sig_of(key) == jdev._sig_of((), None, key=key)
        with tdev.compile_span("nvcc", {"sources": ["bn_act"]}):
            assert tdev.compiling() == "compile.nvcc"
            tdev.record_build("bn_act", 1500.0, "miss", "abcdef123456")
        tdev.record_build("quant2", 0.2, "hit")
        assert tdev.compiling() is None
        s = tdev.summary()
        assert (s["cache_misses"], s["cache_hits"], s["compiles"]) == (1, 1,
                                                                       5)
        names = [r[2] for r in tr.drain()]
        assert names.count("compile.recompile") == 2 and \
            "compile.nvcc" in names
        wire = tdev.wire_payload()
        assert set(wire) == {"dseq", "cseq", "compiling", "compiling_age_s",
                             "compile", "mem"}
        tdev.set_enabled(False)
        assert tdev.wire_payload() is None and tdev.metrics_hook() is None
    finally:
        ttrace.set_enabled(None)


def test_oom_is_seen_and_bundled_with_the_census(armed, monkeypatch):
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 90.00 GiB")
    assert tdev.is_oom(oom) and jdev.is_oom(RuntimeError(
        "RESOURCE_EXHAUSTED")) and tdev.is_oom(RuntimeError(
            "RESOURCE_EXHAUSTED"))
    assert not tdev.is_oom(ValueError("shape"))
    live = [torch.zeros(1 << 16), torch.zeros(1 << 10), torch.zeros(1 << 16)]
    monkeypatch.setattr(tdev, "_live_device_tensors", lambda: live)
    path = tdev.maybe_oom_bundle(oom, host="w0")
    b = json.load(open(path))
    assert jbb.validate_bundle(b) == [] and b["trigger"] == "oom"
    census = b["extra"]["census"]
    assert census[0] == {"shape": "(65536,)", "dtype": "float32",
                         "count": 2, "bytes": 2 * 4 * 65536, "tag": ""}
    assert b["state"]["device"]["census"] == census
    assert tdev.maybe_oom_bundle(ValueError("x")) is None


def test_capture_runs_two_steps_and_fails_loudly_when_busy(armed):
    d = str(armed / "bb")
    assert tdev.handle_capture_cmds([{"seq": 1, "steps": 2}], host="w1") == 1
    assert tdev.capture_seq() == 1
    for _ in range(3):
        torch.ones(8).sum()
        tdev.capture_tick()
    assert tdev.handle_capture_cmds([{"seq": 1, "steps": 2}]) == 0
    rows = [r for r in tbb.read_manifest(d) if r["kind"] ==
            "profile_capture"]
    assert len(rows) == 1 and rows[0]["steps"] == 2 and "error" not in \
        rows[0]
    assert os.path.exists(os.path.join(rows[0]["dir"], "trace.json"))
    tprof.set_config(filename=str(armed / "prof"))
    tprof.set_state("run")
    try:
        assert not tdev.arm_capture(2, seq=2, host="w1")
    finally:
        tprof.set_state("stop")
    rows = [r for r in tbb.read_manifest(d) if r["kind"] ==
            "profile_capture"]
    assert "already running" in rows[-1]["error"]
    # an armed capture the fit leaves early is closed out
    assert tdev.arm_capture(4, seq=3)
    tdev.capture_tick()
    tdev.capture_abort()
    rows = [r for r in tbb.read_manifest(d) if r["kind"] ==
            "profile_capture"]
    assert rows[-1]["aborted"] is True
    assert not tprof.running()
