"""Rules of the port package: it imports neither JAX nor ``dt_tpu``, and
neither do the port's elastic worker harness (``tests/
torch_elastic_worker.py``), its job helpers, its step recorder and replay
(``tests/torch_elastic_drift.py``) and ``chip_smoke.py``.  A ROADMAP item
that is done refuses nothing any more, and the items still open keep
their refusals.

``tests/conftest.py`` imports jax into every test process, so the import
check runs in a fresh interpreter.
"""

import json
import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import dt_tpu_torch
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "dt_tpu_torch"

_PROBE = r"""
import importlib, json, pkgutil, sys
import dt_tpu_torch
names = ["dt_tpu_torch"]
for m in pkgutil.walk_packages(dt_tpu_torch.__path__, "dt_tpu_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
import importlib.util
for name in ("torch_elastic_worker", "torch_elastic_job",
             "torch_elastic_drift"):
    spec = importlib.util.spec_from_file_location(name, f"tests/{name}.py")
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    names.append(name)
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "jaxlib", "flax", "optax",
                                            "msgpack"))
             or n == "dt_tpu" or n.startswith("dt_tpu."))
print(json.dumps({"imported": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_no_dt_tpu():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=str(ROOT),
                         env=env, capture_output=True, text=True, timeout=120,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    want = {"dt_tpu_torch"} | {
        m.name for m in pkgutil.walk_packages(dt_tpu_torch.__path__,
                                              "dt_tpu_torch.")}
    assert set(got["imported"]) == want | {"torch_elastic_worker",
                                           "torch_elastic_job",
                                           "torch_elastic_drift"}
    assert {"dt_tpu_torch.predictor", "dt_tpu_torch.ops.kernels",
            "dt_tpu_torch.utils.msgpack", "dt_tpu_torch.ops.losses",
            "dt_tpu_torch.optim", "dt_tpu_torch.optim.optimizers",
            "dt_tpu_torch.optim.lr_scheduler",
            "dt_tpu_torch.parallel.compression",
            "dt_tpu_torch.training.flat", "dt_tpu_torch.training.step",
            "dt_tpu_torch.training.train_state",
            "dt_tpu_torch.ops.attention", "dt_tpu_torch.ops.rnn",
            "dt_tpu_torch.ops.tensor", "dt_tpu_torch.parallel.ring_attention",
            "dt_tpu_torch.models.transformer",
            "dt_tpu_torch.models.lstm_lm",
            "dt_tpu_torch.data.io", "dt_tpu_torch.training.module",
            "dt_tpu_torch.training.trainer",
            "dt_tpu_torch.training.metrics",
            "dt_tpu_torch.training.callbacks",
            "dt_tpu_torch.parallel.kvstore", "dt_tpu_torch.initializer",
            "dt_tpu_torch.policy.rescale", "dt_tpu_torch.models.mlp",
            "dt_tpu_torch.models.lenet", "dt_tpu_torch.obs.metrics",
            "dt_tpu_torch.config", "dt_tpu_torch.obs.trace",
            "dt_tpu_torch.elastic", "dt_tpu_torch.elastic.faults",
            "dt_tpu_torch.elastic.protocol",
            "dt_tpu_torch.elastic.dataplane",
            "dt_tpu_torch.elastic.journal",
            "dt_tpu_torch.elastic.scheduler",
            "dt_tpu_torch.elastic.scheduler_main",
            "dt_tpu_torch.elastic.client", "dt_tpu_torch.elastic.drain",
            "dt_tpu_torch.training.overlap", "dt_tpu_torch.ops.sparse",
            "dt_tpu_torch.optim.sparse", "dt_tpu_torch.elastic.server_optim",
            "dt_tpu_torch.elastic.range_server",
            "dt_tpu_torch.training.fleet_ckpt",
            "dt_tpu_torch.training.checkpoint",
            "dt_tpu_torch.policy", "dt_tpu_torch.policy.engine",
            "dt_tpu_torch.launcher",
            "dt_tpu_torch.launcher.launch", "dt_tpu_torch.obs.names",
            "dt_tpu_torch.obs.export", "dt_tpu_torch.obs.blackbox",
            "dt_tpu_torch.obs.device", "dt_tpu_torch.utils.profiler",
            "dt_tpu_torch.training.monitor",
            "dt_tpu_torch.test_utils"} <= want


_FORBIDDEN = re.compile(r"import jax|from jax|flax|dt_tpu\.|"
                        r"(?:import|from) dt_tpu\b")


def test_port_sources_name_no_jax_and_no_dt_tpu_module():
    files = sorted(PORT.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "torch_elastic_worker.py",
        ROOT / "tests" / "torch_elastic_job.py",
        ROOT / "tests" / "torch_elastic_drift.py"]
    assert len(files) > 10
    hits = []
    for f in files:
        for i, line in enumerate(f.read_text().splitlines(), 1):
            if _FORBIDDEN.search(line):
                hits.append(f"{f.relative_to(ROOT)}:{i}: {line.strip()}")
    assert hits == []


#: ROADMAP Queue 1 items done, whose refusals must be gone, and items still
#: open that the port refuses by name (3g and 9 add modules the port does
#: not import, so nothing refuses them)
_DONE_ITEMS = ("item 3a", "item 3b", "item 3c", "item 3d", "item 3e",
               "item 3f", "item 7")
_OPEN_ITEMS = ("item 4", "item 5", "item 6", "item 8")


def test_done_items_refuse_nothing_and_open_items_still_refuse():
    text = "\n".join(f.read_text() for f in sorted(PORT.rglob("*.py")))
    for item in _DONE_ITEMS:
        assert not re.search(re.escape(item) + r"\b", text), item
    for item in _OPEN_ITEMS:
        assert re.search(re.escape(item) + r"\b", text), item
    # a refusal names a Queue 1 item, never a slice (PR titles count
    # slices; the queues count items)
    assert "ROADMAP slice" not in text
    assert not re.search(r"ROADMAP\s+slice", text)
    from dt_tpu_torch.elastic.client import WorkerClient
    from dt_tpu_torch.elastic.scheduler import UNPORTED, Scheduler
    from dt_tpu_torch.parallel import kvstore
    assert kvstore.create("dist_async").type == "dist_async"
    assert not {"register_server", "servers", "set_optimizer",
                "async_push"} & set(UNPORTED)
    for name in ("allreduce_sparse", "set_optimizer", "async_init",
                 "async_push", "async_push_sparse", "async_stats",
                 "async_pull_rows", "refresh_servers"):
        assert callable(getattr(WorkerClient, name))
    assert not {"ckpt_intent", "ckpt_ack", "ckpt_manifest",
                "ha_round"} & set(UNPORTED)
    # the obs planes are served; the serve gateway's commands stay item 5
    assert UNPORTED == dict.fromkeys(
        ("serve_register", "serve_heartbeat", "serve_endpoints"),
        "item 5 (the serve gateway and replica)")
    for name in ("profile_command", "obs_flush", "_obs_payload",
                 "_hm_payload", "_apply_profile_cmd"):
        assert callable(getattr(WorkerClient, name))
    for name in ("ckpt_begin", "ckpt_ack", "ckpt_manifest",
                 "_req_failover", "_rotate_leader", "_reattach"):
        assert callable(getattr(WorkerClient, name))
    import inspect
    params = inspect.signature(Scheduler).parameters
    for name in ("journal_path", "lease_path", "lease_s", "standby", "peer",
                 "resume"):
        assert name in params, name
    from dt_tpu_torch import launcher, policy
    from dt_tpu_torch.elastic import protocol
    assert callable(protocol.set_secret)
    for name in ("launch_local", "launch_ssh", "main"):
        assert callable(getattr(launcher, name))
    for name in ("Decision", "PolicyEngine", "enabled", "rescale"):
        assert hasattr(policy, name)


def test_port_journal_records_unpickle_without_the_port(tmp_path):
    """The port's journal records and snapshot sidecars hold builtin types
    and numpy only: a process that never imported ``dt_tpu_torch`` reads
    them (the JAX scheduler replays a port journal that way)."""
    import numpy as np

    from dt_tpu_torch.elastic import journal
    jp = str(tmp_path / "ctrl.journal")
    w = journal.JournalWriter(jp, fence=1)
    w.append("init", {"workers": ["w0", "w1"], "expected": 2})
    w.append("ckpt_intent", {"step": 8, "epoch": 1, "seq": 1,
                             "workers": ["w0", "w1"]})
    w.append("snapshot", {"blob": journal.write_snapshot_sidecar(
        jp, {"step": np.int32(8),
             "params": {"Dense_0": {"kernel": np.ones((2, 3),
                                                      np.float32)}}})})
    w.close()
    probe = (
        "import glob, json, pickle, struct, sys, zlib\n"
        "jp = sys.argv[1]\n"
        "data = open(jp, 'rb').read()\n"
        "ops, off = [], 0\n"
        "while off < len(data):\n"
        "    n, crc = struct.unpack_from('<II', data, off)\n"
        "    payload = data[off + 8:off + 8 + n]\n"
        "    assert zlib.crc32(payload) == crc\n"
        "    ops.append(pickle.loads(payload)[1])\n"
        "    off += 8 + n\n"
        "snaps = [pickle.loads(open(p, 'rb').read())\n"
        "         for p in glob.glob(jp + '.snap.*')]\n"
        "bad = sorted(m for m in sys.modules if m.startswith(\n"
        "    ('dt_tpu', 'torch')))\n"
        "print(json.dumps({'ops': ops, 'snaps': len(snaps),\n"
        "                  'step': int(snaps[0]['step']), 'bad': bad}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe, jp], cwd=str(tmp_path),
                         env=env, capture_output=True, text=True, timeout=60,
                         check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"ops": ["init", "ckpt_intent", "snapshot"], "snaps": 1,
                   "step": 8, "bad": []}


def _literals(root, pattern):
    """The string literals ``pattern`` captures in the ``.py`` files under
    ``root``."""
    found = set()
    for f in Path(root).rglob("*.py"):
        found.update(re.findall(pattern, f.read_text()))
    return found


#: the HA, fleet-checkpoint, straggler and policy record names (PRs 9-10)
_HA_POLICY_NAMES = (
    "worker.straggler", "policy.rebalance", "policy.evict", "policy.scale",
    "policy.decisions", "scheduler.failover", "leader.elected",
    "leader.fenced", "client.failover", "client.reattached", "ckpt.save",
    "ckpt.intent", "ckpt.ack", "ckpt.commit", "ckpt.abort", "ckpt.resume",
    "ckpt.save_errors")


def test_trace_names_and_crash_sites_are_the_jax_packages():
    """The port's name catalog is the JAX package's, and every HA,
    fleet-checkpoint and policy name is recorded somewhere in the port;
    every crash site the port hooks has the JAX package's name, so one
    seeded fault plan means the same in both."""
    import importlib.util

    from dt_tpu_torch.obs import names as port_names
    spec = importlib.util.spec_from_file_location(
        "_jax_names", ROOT / "dt_tpu" / "obs" / "names.py")
    names = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(names)
    assert dict(port_names.NAME_REGISTRY) == dict(names.NAME_REGISTRY)
    recorded = _literals(PORT, r'(?:event|counter|begin|complete_span)\(\s*'
                               r'"([\w.]+)"')
    assert set(_HA_POLICY_NAMES) <= recorded, \
        set(_HA_POLICY_NAMES) - recorded
    port_sites = _literals(PORT, r'crash_point\(\s*"([\w.]+)"')
    jax_sites = _literals(ROOT / "dt_tpu", r'crash_point\(\s*"([\w.]+)"')
    assert {"sched.ckpt_intent", "sched.ckpt_ack", "sched.ckpt_commit",
            "worker.resume", "worker.ckpt_save"} <= port_sites
    assert port_sites <= jax_sites, port_sites - jax_sites


_SCHED_PROBE = r"""
import json, sys, urllib.request
from dt_tpu_torch.elastic import protocol
from dt_tpu_torch.elastic.scheduler import Scheduler
sched = Scheduler(initial_workers=["w0"])
port = sched.port
req = lambda m: protocol.request("127.0.0.1", port, m, timeout=10)
req({"cmd": "register", "host": "w0", "is_new": False})
dev = {"dseq": 1, "cseq": 0, "compiling": None, "compiling_age_s": 0.0,
       "compile": {"compiles": 1, "recompiles": 0, "cache_hits": 0,
                   "cache_misses": 1, "ms_total": 1.0, "whats": ["x"]},
       "mem": {"devices": [{"id": 0, "bytes_in_use": 5,
                            "peak_bytes_in_use": 6, "bytes_limit": 9}]}}
hm = {"inc": 7, "gseq": 1, "samples": [{"seq": 1, "ts_ms": 1,
      "gauges": {"train.steps": 1.0}}],
      "gauges": [["device.hbm_bytes", [["device", "0"]], 5.0]],
      "hists": [], "dropped": 0}
obs = {"inc": 7, "fseq": 1, "records": [["X", 1, "step", 1, 2, 3, 1, None,
                                          None]], "counters": {},
       "dropped": 0}
req({"cmd": "heartbeat", "host": "w0", "pseq": 0, "obs": obs, "hm": hm,
     "dev": dev})
req({"cmd": "obs_push", "host": "w0", "obs": obs, "hm": hm})
out = {"health": req({"cmd": "health"})["health"]["enabled"],
       "bb": req({"cmd": "blackbox_index"})["enabled"],
       "tracks": sorted(req({"cmd": "obs_dump"})["job"]["tracks"])}
text = urllib.request.urlopen(
    f"http://127.0.0.1:{sched.metrics_port}/metrics", timeout=10).read()
out["scrape"] = b"dt_device_hbm_bytes" in text
sched.close()
out["torch"] = sorted(m for m in sys.modules
                      if m == "torch" or m.startswith("torch."))
print(json.dumps(out))
"""


def test_scheduler_imports_no_torch_with_every_plane_armed(tmp_path):
    """With the trace, metrics (and its HTTP endpoint), blackbox and
    device planes armed, the port's scheduler ingests a worker's span,
    metrics and device payloads, answers ``health``, ``blackbox_index``,
    ``obs_dump`` and a ``/metrics`` scrape, and its process never imports
    torch."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), DT_OBS="1", DT_METRICS="1",
               DT_METRICS_PORT="0", DT_BLACKBOX="1",
               DT_BLACKBOX_DIR=str(tmp_path / "bb"), DT_DEVICE_OBS="1",
               DT_ELASTIC_INSECURE="1")
    out = subprocess.run([sys.executable, "-c", _SCHED_PROBE],
                         cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"health": True, "bb": True,
                   "tracks": ["control-plane", "w0#7"], "scrape": True,
                   "torch": []}
