"""The port's SGD and LR schedulers against the JAX package's.

The same seeded numpy parameters and gradients go through
``dt_tpu.optim.create("sgd", ...)`` (optax, applied with
``optax.apply_updates``) and ``dt_tpu_torch.optim.create("sgd", ...)``
(in place), step after step; every scheduler is read at the same steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dt_tpu import optim as joptim
from dt_tpu_torch import optim as toptim
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

# f32 elementwise math, each op rounded once on both sides; a scheduler's
# LR is an f32 jnp value on the JAX side and a Python float (rounded to f32
# where it multiplies) on the port's, one ulp apart at most
TOL = 1e-6

SCHEDULERS = [
    ("constant", dict(base_lr=0.1)),
    ("factor", dict(step=3, factor=0.5, base_lr=0.1)),
    ("factor", dict(step=2, factor=0.1, stop_factor_lr=2e-4, base_lr=0.1)),
    ("multifactor", dict(steps=[2, 5], factor=0.1, base_lr=0.1)),
    ("poly", dict(max_update=8, base_lr=0.1, final_lr=0.01, pwr=2)),
    ("cosine", dict(max_update=8, base_lr=0.1, final_lr=0.001)),
    ("cosine", dict(max_update=10, base_lr=0.1, warmup_steps=3,
                    warmup_begin_lr=0.01)),
    ("poly", dict(max_update=10, base_lr=0.2, warmup_steps=4,
                  warmup_mode="constant", warmup_begin_lr=0.05)),
    ("multifactor", dict(steps=[4, 6], factor=0.5, base_lr=0.1,
                         warmup_steps=2)),
]


@pytest.mark.parametrize("name,kw", SCHEDULERS)
def test_schedulers_match_jax(name, kw):
    js = joptim.make(name, **kw)
    ts = toptim.make(name, **kw)
    for step in range(12):
        want = float(js(jnp.asarray(step)))
        got = ts(step)
        assert isinstance(got, float)
        np.testing.assert_allclose(got, want, rtol=TOL, err_msg=str(step))


def _params(seed):
    rng = np.random.RandomState(seed)
    return {"conv": rng.normal(0, 1, (2, 3, 3, 3)).astype(np.float32),
            "dense": rng.normal(0, 1, (4, 5)).astype(np.float32),
            "bias": rng.normal(0, 1, (5,)).astype(np.float32)}


@pytest.mark.parametrize("kw", [
    dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4),
    dict(momentum=0.9, weight_decay=1e-2, rescale_grad=0.5,
         clip_gradient=0.7),
    dict(learning_rate=0.05, momentum=0.0, weight_decay=1e-3,
         clip_gradient=1.0),
])
def test_sgd_matches_jax_over_steps_across_an_lr_drop(kw):
    """Three steps under a multifactor schedule that drops after update 2
    (the 1-based count crosses the threshold), with wd, clip and rescale."""
    kw = dict(kw)
    if "learning_rate" not in kw:
        kw["learning_rate"] = "schedule"
    jkw, tkw = dict(kw), dict(kw)
    if kw["learning_rate"] == "schedule":
        jkw["learning_rate"] = joptim.make("multifactor", steps=[2],
                                           factor=0.1, base_lr=0.1)
        tkw["learning_rate"] = toptim.make("multifactor", steps=[2],
                                           factor=0.1, base_lr=0.1)
    jtx = joptim.create("sgd", **jkw)
    ttx = toptim.create("sgd", **tkw)
    p = _params(0)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p.items()}
    jstate = jtx.init(jp)
    tstate = ttx.init(tp)
    rng = np.random.RandomState(1)
    for step in range(3):
        g = {k: rng.normal(0, 2, v.shape).astype(np.float32)
             for k, v in p.items()}
        upd, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                 jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tstate = ttx.update({k: torch.from_numpy(v) for k, v in g.items()},
                            tstate, tp)
        assert tstate["count"] == int(jstate.count) == step + 1
        for k in p:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)
            if kw["momentum"]:
                np.testing.assert_allclose(tstate["mom"][k].numpy(),
                                           np.asarray(jstate.mom[k]),
                                           rtol=TOL, atol=TOL, err_msg=k)
    assert ("mom" in tstate) == bool(kw["momentum"])


def test_sgd_keeps_grads_and_updates_in_place():
    ttx = toptim.sgd(learning_rate=0.1, momentum=0.9, weight_decay=1e-4,
                     rescale_grad=2.0)
    w = torch.ones(3, 2).contiguous()
    g = torch.full((3, 2), 0.5)
    st = ttx.init({"w": w})
    ptr = w.data_ptr()
    st = ttx.update({"w": g}, st, {"w": w})
    assert w.data_ptr() == ptr and torch.equal(g, torch.full((3, 2), 0.5))
    mom = -(0.1 * (2.0 * 0.5 + 1e-4 * 1.0))
    np.testing.assert_allclose(w.numpy(), 1.0 + mom, rtol=1e-6)


def test_create_names():
    assert isinstance(toptim.create("SGD", learning_rate=0.1), toptim.SGD)
    for name in ("adam", "nag", "lamb", "signsgd"):
        with pytest.raises(NotImplementedError, match="not ported"):
            toptim.create(name)
    with pytest.raises(NotImplementedError, match="multi_precision"):
        toptim.create("sgd", multi_precision=True)
    with pytest.raises(ValueError, match="unknown optimizer"):
        toptim.create("bogus")
    with pytest.raises(ValueError, match="unknown scheduler"):
        toptim.make("bogus")
    with pytest.raises(ValueError, match="increasing"):
        toptim.MultiFactorScheduler([5, 2])
