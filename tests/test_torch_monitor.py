"""The port's ``Monitor`` (``training/monitor.py``) against the JAX
package's: on the same weights and inputs, the MLP's and LeNet's layer
outputs come out under the same names with the same statistics (default
``|x|.mean()`` and a custom one), on the interval's steps only."""

import jax
import numpy as np
import pytest
import torch

from dt_tpu import models as jmodels
from dt_tpu.training.monitor import Monitor as JMonitor
from dt_tpu_torch import models as tmodels
from dt_tpu_torch.interchange import load_jax_variables
from dt_tpu_torch.training.monitor import Monitor as TMonitor
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)


def _pair(name, kw, x):
    jm = jmodels.create(name, **kw)
    variables = jm.init(jax.random.PRNGKey(0), x, training=False)
    tm = tmodels.create(name, device="cpu", in_shape=x.shape[1:], **kw)
    load_jax_variables(tm, jax.device_get(variables))
    return jm, variables, tm


@pytest.mark.parametrize("name", ["mlp", "lenet"])
def test_monitor_matches_the_jax_monitor(name):
    x = np.random.RandomState(0).normal(size=(4, 28, 28, 1)) \
        .astype(np.float32)
    jm, variables, tm = _pair(name, {"num_classes": 10}, x)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for stat, pattern in ((None, ".*"),
                          (lambda v: (v * v).mean(), "Dense")):
        jmon = JMonitor(interval=2, stat_func=stat, pattern=pattern,
                        sort=True)
        tmon = TMonitor(interval=2, stat_func=stat, pattern=pattern,
                        sort=True)
        for _ in range(3):
            jout = jmon.forward(jm, variables, x, training=False)
            tout = tmon.forward(tm, xt, training=False)
        np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                                   rtol=1e-4, atol=1e-5)
        j, t = jmon.toc_print(), tmon.toc_print()
        assert [(s, n) for s, n, _ in t] == [(s, n) for s, n, _ in j]
        assert t and all(s == 2 for s, _, _ in t)
        np.testing.assert_allclose([v for _, _, v in t],
                                   [v for _, _, v in j], rtol=1e-5,
                                   atol=1e-6)
        assert tmon.queue == [] and tmon.step == 3
