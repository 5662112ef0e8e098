"""Rules of the port package: it imports neither JAX nor ``dt_tpu``, and
neither do the port's elastic worker harness (``tests/
torch_elastic_worker.py``), its job helpers, its step recorder and replay
(``tests/torch_elastic_drift.py``) and ``chip_smoke.py``.

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
            "dt_tpu_torch.training.overlap"} <= want


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
