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
    """Every name of the JAX registry creates, with and without
    ``multi_precision``; unknown names still raise the JAX text."""
    assert isinstance(toptim.create("SGD", learning_rate=0.1), toptim.SGD)
    for name in sorted(joptim.optimizers._REGISTRY):
        tx = toptim.create(name)
        assert hasattr(tx, "init") and hasattr(tx, "update"), name
        mp = toptim.create(name, multi_precision=True)
        assert isinstance(mp, toptim.optimizers.MultiPrecision), name
    assert sorted(toptim.optimizers._REGISTRY) == \
        sorted(joptim.optimizers._REGISTRY)
    with pytest.raises(ValueError, match="unknown optimizer 'bogus'; "
                       "registered: "):
        toptim.create("bogus")
    with pytest.raises(ValueError, match="unknown scheduler"):
        toptim.make("bogus")
    with pytest.raises(ValueError, match="increasing"):
        toptim.MultiFactorScheduler([5, 2])


# --------------------------------------------------------------------------
# every optimizer of the registry
# --------------------------------------------------------------------------

NAMES = sorted(joptim.optimizers._REGISTRY)
#: each leaf held normwise: max |port - jax| <= tol * max |jax| of the leaf.
#: float32 leaves: the same f32 ops in the same order; the JAX side's XLA
#: pow/sqrt and the port's libm ones can differ in the last bit, which the
#: later steps carry (largest seen 3.1e-7).  bfloat16 leaves: at most one
#: bf16 ulp at the leaf's largest value (2^-7 of it), as an f32 update a
#: last bit apart can round the other way in bf16, and lamb, which runs in
#: bf16 on a bf16 leaf, takes its norm's square root in f32 where JAX takes
#: it in bf16 (seen: 0 for every rule but lamb, up to 5.6e-3 there).
TOL_RULE = {"float32": 1e-6, "bfloat16": 2.0 ** -7}
STEPS = 5


def _schedule(lib):
    # update 3 (1-based) and on run at lr/10: the drop lands inside 5 steps
    return lib.make("multifactor", steps=[2], factor=0.1, base_lr=0.05)


def _kwargs(name, lib):
    kw = dict(learning_rate=_schedule(lib), weight_decay=1e-3,
              rescale_grad=0.5, clip_gradient=0.8)
    if name == "adadelta":
        kw.pop("learning_rate")
    if name == "lamb":  # optax.lamb takes no gradient pipeline
        kw = dict(learning_rate=_schedule(lib), weight_decay=1e-3)
    if name in ("sgd", "rmsprop", "dcasgd"):
        kw["momentum"] = 0.9
    return kw


def _tree_params(seed):
    """A JAX-style tree with a conv and a dense kernel, a bias and a
    bfloat16 leaf (the bf16 TransformerLM's ``pos_embed``)."""
    import ml_dtypes
    rng = np.random.RandomState(seed)
    return {"conv": {"kernel": rng.normal(0, 1, (3, 3, 2, 4))
                     .astype(np.float32)},
            "dense": {"kernel": rng.normal(0, 1, (5, 4)).astype(np.float32),
                      "bias": rng.normal(0, 1, (4,)).astype(np.float32)},
            "pos": rng.normal(0, 1, (6, 4)).astype(ml_dtypes.bfloat16)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _to_torch(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _dtype(v) -> str:
    if isinstance(v, torch.Tensor):
        return str(v.dtype).split(".")[-1]
    if isinstance(v, int):
        return "int32"
    return np.asarray(v).dtype.name


def _f64(v):
    return (v.double().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v).astype(np.float64))


def _hold(got, want, tol, what):
    got, want = _f64(got), _f64(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) if got.size else 0.0
    scale = float(np.abs(want).max()) if want.size else 0.0
    assert err <= tol * scale, (what, err, scale)


def _run_both(jtx, ttx, steps=STEPS, grads=None):
    """``steps`` updates of both from the same seeded params and
    gradients; returns ``(jax_params, jax_state, port_params,
    port_state)``."""
    import optax
    p = _tree_params(0)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = {k: _to_torch(v) for k, v in _flat(p).items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    rng = np.random.RandomState(1)
    for _ in range(steps):
        g = jax.tree_util.tree_map(
            lambda v: rng.normal(0, 2, v.shape).astype(v.dtype), p)
        upd, js = jtx.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = ttx.update({k: _to_torch(v) for k, v in _flat(g).items()},
                        ts, tp)
    return jp, js, tp, ts


def _hold_state(js, ts, tol_of):
    """Every leaf of the JAX ``to_state_dict`` against the port's state:
    the same keys, the same dtypes, values within ``tol_of(dtype)``."""
    import flax.serialization
    want = _flat(flax.serialization.to_state_dict(js))
    got = _flat(ts)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert _dtype(got[k]) == np.asarray(v).dtype.name, k
        _hold(got[k], v, tol_of(np.asarray(v).dtype.name), k)


@pytest.mark.parametrize("mp", [False, True], ids=["plain", "mp"])
@pytest.mark.parametrize("name", NAMES)
def test_every_optimizer_matches_jax_over_steps(name, mp):
    """5 updates across an LR drop (rescale_grad and clip_gradient set
    where the rule takes them) over f32 conv/dense leaves and a bf16 leaf:
    params and every state leaf against ``dt_tpu``'s within
    :data:`TOL_RULE`, with equal state keys and dtypes.  sgld's noise is
    another stream (the key stream is the same, held exactly); its params
    are held to the noise's own bound."""
    jtx = joptim.create(name, multi_precision=mp, **_kwargs(name, joptim))
    ttx = toptim.create(name, multi_precision=mp, **_kwargs(name, toptim))
    jp, js, tp, ts = _run_both(jtx, ttx)
    for k, want in _flat(jp).items():
        dt = np.asarray(want).dtype.name
        assert _dtype(tp[k]) == dt, k
        if name == "sgld":
            # N(0, lr) noise a step on each side: 6 sigma of the difference
            lrs = [0.05, 0.05, 0.005, 0.005, 0.005]
            bound = 6 * np.sqrt(2 * sum(lrs)) + 2.0 ** -7 * 4
            assert np.abs(_f64(tp[k]) - _f64(want)).max() <= bound, k
        else:
            _hold(tp[k], want, TOL_RULE[dt], k)
    if name == "sgld" and mp:
        import flax.serialization
        want = _flat(flax.serialization.to_state_dict(js))
        got = _flat(ts)
        assert sorted(got) == sorted(want)
        for k in ("inner/count", "inner/mom"):
            np.testing.assert_array_equal(np.asarray(got[k]), want[k])
        return
    _hold_state(js, ts, lambda dt: TOL_RULE.get(dt, 0.0))


@pytest.mark.parametrize("scheduled", [False, True],
                         ids=["constant", "schedule"])
def test_lamb_matches_optax_lamb(scheduled):
    """lamb at its defaults with a constant LR (the chain's ``"3"`` is
    ``{}``) and under a schedule (``"3"`` counts, 0-based as optax hands
    it to the schedule) with weight decay."""
    lr = _schedule(joptim) if scheduled else 1e-3
    tlr = _schedule(toptim) if scheduled else 1e-3
    jtx = joptim.create("lamb", learning_rate=lr, weight_decay=1e-2)
    ttx = toptim.create("lamb", learning_rate=tlr, weight_decay=1e-2)
    jp, js, tp, ts = _run_both(jtx, ttx)
    assert ts["3"] == ({"count": STEPS} if scheduled else {})
    for k, want in _flat(jp).items():
        _hold(tp[k], want, TOL_RULE[np.asarray(want).dtype.name], k)
    _hold_state(js, ts, lambda dt: TOL_RULE.get(dt, 0.0))


def test_multi_precision_applies_master_as_apply_updates_does():
    """with_multi_precision over sgd and adam: the masters are the inner
    rule on f32 copies; a param is ``w + (master.astype(w.dtype) - w)``
    in its dtype, which for a bf16 leaf need not be the rounded master."""
    for name, kw in (("sgd", dict(learning_rate=0.1, momentum=0.9)),
                     ("adam", dict(learning_rate=0.01))):
        jtx = joptim.create(name, multi_precision=True, **kw)
        ttx = toptim.create(name, multi_precision=True, **kw)
        jp, js, tp, ts = _run_both(jtx, ttx, steps=3)
        assert set(ts) == {"master", "inner"}
        for k, w in tp.items():
            assert ts["master"][k].dtype == torch.float32
            m = ts["master"][k]
            assert w.dtype == _to_torch(_flat(jp)[k]).dtype
            assert w.dtype != torch.float32 or torch.allclose(
                w, m, rtol=1e-6, atol=1e-7), k
        _hold_state(js, ts, lambda dt: TOL_RULE.get(dt, 0.0))


def test_svrg_with_full_gradient_matches_jax():
    """svrg over sgd on a least-squares model: the full gradient at the
    snapshot from 3 weighted batches, 3 corrected steps, then a refresh;
    params, snapshot, full gradient and the inner state against JAX's."""
    rng = np.random.RandomState(4)
    xs = [rng.normal(0, 1, (8, 5)).astype(np.float32) for _ in range(3)]
    ys = [rng.normal(0, 1, (8, 2)).astype(np.float32) for _ in range(3)]
    w0 = rng.normal(0, 1, (5, 2)).astype(np.float32)

    def jgrad(params, i):
        return jax.grad(lambda p: jnp.mean(
            (jnp.asarray(xs[i]) @ p["w"] - ys[i]) ** 2))(params)

    def tgrad(params, i):
        w = params["w"].detach().requires_grad_(True)
        loss = ((torch.from_numpy(xs[i]) @ w - torch.from_numpy(ys[i]))
                ** 2).mean()
        return {"w": torch.autograd.grad(loss, w)[0]}

    jtx = joptim.svrg(joptim.sgd(0.05, momentum=0.9))
    ttx = toptim.svrg(toptim.sgd(0.05, momentum=0.9))
    jp = {"w": jnp.asarray(w0)}
    tp = {"w": torch.from_numpy(w0.copy())}
    js, ts = jtx.init(jp), ttx.init(tp)
    weights = [8, 8, 4]
    jfull = joptim.full_gradient(jgrad, jp, range(3), weights)
    tfull = toptim.full_gradient(tgrad, tp, range(3), weights)
    js = joptim.refresh_snapshot(js, jp, jfull)
    ts = toptim.refresh_snapshot(ts, tp, tfull)
    import optax
    for step in range(3):
        i = step % 3
        g = (jgrad(jp, i), jgrad(js.w_snap, i))
        upd, js = jtx.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
        ts = ttx.update((tgrad(tp, i), tgrad(ts["w_snap"], i)), ts, tp)
    _hold(tp["w"], jp["w"], 1e-6, "w")
    _hold(ts["w_snap"]["w"], js.w_snap["w"], 0.0, "w_snap")
    _hold(ts["full_grad"]["w"], js.full_grad["w"], 1e-6, "full_grad")
    _hold(ts["inner"]["mom"]["w"], js.inner.mom["w"], 1e-6, "mom")
    assert ts["inner"]["count"] == int(js.inner.count) == 3
    # the snapshot is a copy: the live params moved, it did not
    assert not torch.equal(ts["w_snap"]["w"], tp["w"])
    with pytest.raises(ValueError, match="at least one batch"):
        toptim.full_gradient(tgrad, tp, [])


def test_sgld_key_stream_and_noise_statistics():
    """sgld keeps the JAX key (``uint32[2]``) and splits it as JAX does,
    bit for bit; with no gradient its update is the noise alone, N(0, lr):
    mean and standard deviation within 4 sigma of their sampling error."""
    lr, n = 0.01, 200_000
    jtx, ttx = joptim.sgld(lr, seed=7), toptim.sgld(lr, seed=7)
    w = {"w": torch.zeros(n)}
    js, ts = jtx.init({"w": jnp.zeros(n)}), ttx.init(w)
    assert ts["mom"].dtype == np.uint32 and ts["mom"].shape == (2,)
    np.testing.assert_array_equal(ts["mom"], np.asarray(js.mom))
    for _ in range(3):
        before = w["w"].clone()
        _, js = jtx.update({"w": jnp.zeros(n)}, js, {"w": jnp.zeros(n)})
        ts = ttx.update({"w": torch.zeros(n)}, ts, w)
        np.testing.assert_array_equal(ts["mom"], np.asarray(js.mom))
        noise = (w["w"] - before).double().numpy()
        sigma = np.sqrt(lr)
        assert abs(noise.mean()) <= 4 * sigma / np.sqrt(n)
        # the sample std's standard error is sigma / sqrt(2n)
        assert abs(noise.std() - sigma) <= 4 * sigma / np.sqrt(2 * n)
    assert ts["count"] == 3
