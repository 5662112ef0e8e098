"""Training of the 299-input Inceptions, the port against ``dt_tpu``:
Inception-v3, Inception-v4 and Inception-ResNet-v2, one training forward +
backward each in float64 at their smallest valid input (75), held as
``test_torch_zoo_train.py`` holds every family (its docstring gives the
bounds and why).  In a file of their own so that ``--dist loadfile`` runs
them beside the other families; most of the time is JAX's compiles of the
gradient.
"""

import pytest

from test_torch_zoo_models import FAMILIES
from test_torch_zoo_train import INCEPTIONS_299, train_parity
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)


@pytest.mark.parametrize("name", INCEPTIONS_299)
def test_training_step_matches_jax(name, monkeypatch):
    train_parity(monkeypatch, *FAMILIES[name])
