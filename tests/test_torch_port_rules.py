"""Rules of the port package: it imports neither JAX nor ``dt_tpu``.

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
    assert set(got["imported"]) == want
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
            "dt_tpu_torch.models.lenet", "dt_tpu_torch.obs.metrics"} <= want


_FORBIDDEN = re.compile(r"import jax|from jax|flax|dt_tpu\.|"
                        r"(?:import|from) dt_tpu\b")


def test_port_sources_name_no_jax_and_no_dt_tpu_module():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    hits = []
    for f in files:
        for i, line in enumerate(f.read_text().splitlines(), 1):
            if _FORBIDDEN.search(line):
                hits.append(f"{f.relative_to(ROOT)}:{i}: {line.strip()}")
    assert hits == []
