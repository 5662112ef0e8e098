"""The port's ``Trainer`` against the JAX package's, on the CPU: the same
gradients give the same params and momentum (1/batch_size rescale, SGD
with momentum and weight decay), the states files cross between the two
packages in both directions, and the health halt leaves both at the same
pre-fault params."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt_tpu.obs import metrics as jobs
from dt_tpu.training.trainer import Trainer as JTrainer
from dt_tpu_torch.obs import metrics as tobs
from dt_tpu_torch.training.trainer import Trainer as TTrainer
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

OPT = {"learning_rate": 0.1, "momentum": 0.9, "weight_decay": 1e-4}


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"dense": {"kernel": rng.normal(0, 1, (4, 3)).astype(np.float32),
                      "bias": rng.normal(0, 1, (3,)).astype(np.float32)},
            "scale": rng.normal(0, 1, (5,)).astype(np.float32)}


def _jax(tree):
    return {k: _jax(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _torch(tree):
    return {k: _torch(v) if isinstance(v, dict) else torch.from_numpy(
        v.copy()) for k, v in tree.items()}


def _np(tree):
    return {k: _np(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def _assert_trees(a, b, tol=1e-6):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_trees(a[k], b[k], tol)
        else:
            np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                       rtol=tol, atol=tol)


def _pair():
    p0 = _tree(0)
    return JTrainer(_jax(p0), "sgd", OPT), TTrainer(_torch(p0), "sgd", OPT)


def test_step_matches_the_jax_trainer():
    """Three steps of the same gradients at batch sizes 4, 1, 8."""
    jt, tt = _pair()
    for seed, bs in ((1, 4), (2, 1), (3, 8)):
        g = _tree(seed)
        jt.step(_jax(g), batch_size=bs)
        got = tt.step(_torch(g), batch_size=bs)
        assert got is tt.params
        _assert_trees(_np(tt.params), _np(jt.params))
    _assert_trees({k: v.numpy() for k, v in tt.opt_state["mom"].items()},
                  {"/".join(p): v for p, v in _flat(jt.opt_state.mom)})
    assert tt.opt_state["count"] == int(jt.opt_state.count) == 3
    # the port's optimizer keeps its rate; the JAX package's optax
    # transformation has no such attribute, so its property gives None
    assert tt.learning_rate == 0.1 and jt.learning_rate is None
    with pytest.raises(KeyError, match="leaves"):
        tt.step({"scale": torch.zeros(5)})


def _flat(tree, prefix=()):
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += _flat(v, prefix + (k,))
        else:
            out.append((prefix + (k,), np.asarray(v)))
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_states_files_cross_between_the_packages(tmp_path, writer):
    """A states file written by one package loads into the other's
    Trainer, and the next step agrees."""
    jt, tt = _pair()
    for seed in (1, 2):
        jt.step(_jax(_tree(seed)), batch_size=2)
        tt.step(_torch(_tree(seed)), batch_size=2)
    f = str(tmp_path / "opt.states")
    fresh_j, fresh_t = _pair()
    if writer == "jax":
        jt.save_states(f)
        fresh_t.load_states(f)
        assert fresh_t.opt_state["count"] == 2
        fresh_j.load_states(f)
    else:
        tt.save_states(f)
        fresh_j.load_states(f)
        assert int(fresh_j.opt_state.count) == 2
        fresh_t.load_states(f)
    _assert_trees({"/".join(p): v for p, v in _flat(fresh_j.opt_state.mom)},
                  {k: v.numpy() for k, v in fresh_t.opt_state["mom"].items()})
    g = _tree(5)
    fresh_j.step(_jax(g), batch_size=2)
    fresh_t.step(_torch(g), batch_size=2)
    _assert_trees(_np(fresh_t.params), _np(fresh_j.params))


def test_load_states_refuses_another_shape(tmp_path):
    jt, _ = _pair()
    f = str(tmp_path / "opt.states")
    jt.save_states(f)
    other = TTrainer({"w": torch.zeros(3)}, "sgd", OPT)
    with pytest.raises(KeyError):
        other.load_states(f)
    plain = TTrainer(_torch(_tree(0)), "sgd", {"learning_rate": 0.1})
    with pytest.raises(KeyError, match="count"):
        plain.load_states(f)  # no momentum: the file's "mom" is extra


@pytest.fixture
def _halt(monkeypatch):
    monkeypatch.setenv("DT_HEALTH_HALT", "1")
    yield
    tobs.set_enabled(None)
    jobs.set_enabled(None)


def test_health_halt_raises_before_the_update(_halt):
    """A non-finite gradient under ``DT_HEALTH_HALT=1`` raises ``HealthHalt``
    in both packages, their params left at the same pre-fault values."""
    jt, tt = _pair()
    jt.step(_jax(_tree(1)), batch_size=1)
    tt.step(_torch(_tree(1)), batch_size=1)
    bad = _tree(2)
    bad["dense"]["bias"][1] = np.nan
    with pytest.raises(jobs.HealthHalt):
        jt.step(_jax(bad), batch_size=1)
    with pytest.raises(tobs.HealthHalt):
        tt.step(_torch(bad), batch_size=1)
    _assert_trees(_np(tt.params), _np(jt.params))
    assert tt.opt_state["count"] == 1
