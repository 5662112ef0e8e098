"""The port's mesh against the JAX package's, on the CPU.

- Cross-rank BN: ``ops.kernels.fused_bn_train`` inside ``cross_rank_bn``
  on a 4-process gloo group (each rank its rows; ``bn_sums_plain`` on the
  CPU) against ``dt_tpu``'s ``fused_bn_train`` (Pallas interpret mode,
  ``jax.grad``) on the concatenated batch: ``y``, ``dx``, the ranks' summed
  ``dgamma``/``dbeta`` and the running stats within 1e-6 relative (f32).
- The Module step: 3 steps of ``resnet20`` at 8x8 on a global batch of 16,
  a JAX ``Module`` on a 4-device CPU mesh against the port's 4-process
  gloo mesh of 4 rows a rank from the same weights; params, BN stats and
  momentum within 1e-5 relative; with ``shard_opt_state`` and
  ``shard_params`` on the port's result is plain data parallelism's, bit
  for bit.
- ``sharding_report``: the port's plan against ``Module._coverage`` for
  ResNet-50 and ``mlp`` at n = 2, 3, 4, 8.
- A port snapshot restores through ``dt_tpu``'s ``restore_state`` onto
  the 8-device mesh with equal values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt_tpu import models as jmodels
from dt_tpu import optim as joptim
from dt_tpu.elastic import mesh_manager as jmm
from dt_tpu.ops.pallas import kernels as K
from dt_tpu.parallel import mesh as jmesh
from dt_tpu.training.module import Module as JModule
from dt_tpu_torch import models as tmodels
from dt_tpu_torch import optim as toptim
from dt_tpu_torch.elastic.mesh_manager import snapshot_state
from dt_tpu_torch.interchange import load_jax_variables
from dt_tpu_torch.parallel.mesh import Mesh
from dt_tpu_torch.parallel.zero import ShardPlan
from dt_tpu_torch.training.module import Module as TModule
from dt_tpu_torch.training.train_state import TrainState
from torch_mesh_job import run_world
from torch_mesh_worker import flat_tree
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# --------------------------------------------------------------------------
# cross-rank BN
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bn_job(tmp_path_factory):
    """The 4-rank BN case and the JAX reference on the whole batch."""
    tmp = tmp_path_factory.mktemp("bn")
    rng = np.random.RandomState(3)
    c = 16
    d = {"x": (rng.normal(0.3, 1.5, (16, 5, 5, c))).astype(np.float32),
         "gy": rng.normal(0, 1, (16, 5, 5, c)).astype(np.float32),
         "gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
         "beta": rng.normal(0, 0.5, c).astype(np.float32),
         "rm": rng.normal(0, 0.1, c).astype(np.float32),
         "rv": rng.uniform(0.5, 1.5, c).astype(np.float32)}
    np.savez(tmp / "bn.npz", **d)
    run_world(str(tmp), 4, ["--bn-case", "--device", "cpu", "--data-npz",
                            str(tmp / "bn.npz"), "--out",
                            str(tmp / "bn{rank}.npz")])
    ranks = [dict(np.load(tmp / f"bn{r}.npz")) for r in range(4)]
    ref = {}
    for relu in (False, True):
        def loss(x, g, b):
            y, nm, nv = K.fused_bn_train(x, g, b, jnp.asarray(d["rm"]),
                                         jnp.asarray(d["rv"]), 0.9, 1e-5,
                                         interpret=True)
            if relu:
                y = jax.nn.relu(y)
            return jnp.sum(y * d["gy"]), (y, nm, nv)
        (_, (y, nm, nv)), (dx, dg, db) = jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(d["x"]), jnp.asarray(d["gamma"]),
            jnp.asarray(d["beta"]))
        tag = "relu" if relu else "plain"
        ref.update({f"{tag}/y": y, f"{tag}/dx": dx, f"{tag}/dgamma": dg,
                    f"{tag}/dbeta": db, f"{tag}/mean": nm, f"{tag}/var": nv})
    return ranks, {k: np.asarray(v) for k, v in ref.items()}


@pytest.mark.parametrize("tag", ["plain", "relu"])
@pytest.mark.parametrize("what", ["y", "dx", "dgamma", "dbeta", "mean",
                                  "var"])
def test_cross_rank_bn_matches_the_global_batch(bn_job, tag, what):
    """Rows concatenated in rank order (``y``, ``dx``), summed over the
    ranks (the local ``dgamma``/``dbeta``, which the gradient average
    turns into the global batch's), or the same on every rank (the running
    stats): within 1e-6 of the JAX kernel on the whole batch."""
    ranks, ref = bn_job
    key = f"{tag}/{what}"
    if what in ("y", "dx"):
        got = np.concatenate([r[key] for r in ranks])
    elif what in ("dgamma", "dbeta"):
        got = sum(r[key].astype(np.float64) for r in ranks)
    else:
        got = ranks[0][key]
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[key], got)
    assert _rel(got, ref[key]) <= 1e-6, (key, _rel(got, ref[key]))


# --------------------------------------------------------------------------
# the Module step
# --------------------------------------------------------------------------

SGD = dict(learning_rate=0.1, momentum=0.9)
STEPS, GLOBAL, RANKS = 3, 16, 4


def _global_data():
    rng = np.random.RandomState(11)
    x = rng.uniform(-1, 1, (STEPS * GLOBAL, 8, 8, 3)).astype(np.float32)
    y = rng.randint(0, 10, STEPS * GLOBAL).astype(np.int32)
    return x, y


@pytest.fixture(scope="module")
def module_case(tmp_path_factory):
    """The data, the initial weights (npz, JAX layout) and the JAX
    Module's state after 3 steps on a 4-device mesh."""
    tmp = tmp_path_factory.mktemp("mod")
    x, y = _global_data()
    mesh = jmesh.make_mesh(devices=jax.devices()[:RANKS])
    from dt_tpu import data as jdata
    jmod = JModule(jmodels.create("resnet20", num_classes=10),
                   optimizer="sgd", optimizer_params=SGD, mesh=mesh)
    jmod.init_params(x[:GLOBAL])
    init = jax.device_get({"params": jmod.state.params,
                           "batch_stats": jmod.state.batch_stats})
    np.savez(tmp / "init.npz", **flat_tree(init))
    # step s: the global rows [16s, 16s+16), device d rows [4d, 4d+4)
    per = GLOBAL // RANKS
    for r in range(RANKS):
        idx = np.concatenate([np.arange(s * GLOBAL + r * per,
                                        s * GLOBAL + (r + 1) * per)
                              for s in range(STEPS)])
        np.savez(tmp / f"data{r}.npz", x=x[idx], y=y[idx])
    jmod.fit(jdata.NDArrayIter(x, y, batch_size=GLOBAL), num_epoch=1)
    st = jax.device_get(jmod.state)
    ref = flat_tree({"params": st.params, "batch_stats": st.batch_stats,
                     "mom": st.opt_state.mom})
    return tmp, ref


def _port_run(tmp, flags, data="data{rank}.npz"):
    out = str(tmp / ("r{rank}" + "".join(f for f in flags
                                          if f.startswith("--")) + ".npz"))
    res = run_world(str(tmp), RANKS, [
        "--model", "resnet20", "--image-size", "8", "--device", "cpu",
        "--lr", str(SGD["learning_rate"]), "--wd", "0", "--batch",
        str(GLOBAL // RANKS), "--init-npz", str(tmp / "init.npz"),
        "--data-npz", str(tmp / data), "--out", out] + flags)
    states = [dict(np.load(out.format(rank=r))) for r in range(RANKS)]
    return [lines[-1] for lines in res], states


@pytest.mark.parametrize("flags", [[], ["--zero", "--fsdp"]],
                         ids=["dp", "zero1_fsdp"])
def test_module_step_matches_the_jax_mesh(module_case, flags):
    """3 steps of the 4-process gloo mesh against the JAX Module on a
    4-device mesh: every rank holds the same state (the same sha256), and
    params, BN stats and momentum are within 1e-5 relative of JAX's, each
    collection as one vector (the running stats agree only if every
    BatchNorm of every step took the global batch's statistics)."""
    tmp, ref = module_case
    res, states = _port_run(tmp, flags)
    assert len({r["sha256"] for r in res}) == 1
    assert {r["backend"] for r in res} == {"gloo"}
    got = states[0]
    assert set(got) == set(ref)
    for coll in ("params", "batch_stats", "mom"):
        keys = sorted(k for k in ref if k.startswith(coll + "/"))
        a = np.concatenate([got[k].ravel() for k in keys])
        b = np.concatenate([ref[k].ravel() for k in keys])
        assert _rel(a, b) <= 1e-5, (coll, _rel(a, b))
    if flags:
        _, plain = _port_run(tmp, [])
        for k in got:
            np.testing.assert_array_equal(got[k], plain[0][k], err_msg=k)
        # all of ResNet-20 but the 10-wide head's bias splits over 4
        assert 0.9999 < res[0]["sharding_report"]["params"][0] < 1.0


#: ZeRO-1 beyond SGD: Adam's two slots (elementwise: the slices give the
#: whole update's bits) and lbsgd's LARS ratio, whose whole-leaf norms the
#: ranks' slices sum over the data group (another rounding order)
_ZERO_OPTS = {"adam": {"learning_rate": 0.01, "weight_decay": 1e-4},
              "lbsgd": {"learning_rate": 0.1, "momentum": 0.9,
                        "weight_decay": 1e-4, "eta": 0.01}}


@pytest.mark.parametrize("name", sorted(_ZERO_OPTS))
def test_zero1_step_of_other_optimizers_matches_the_jax_mesh(module_case,
                                                             name):
    """One ZeRO-1 step of adam and of lbsgd on the 4-process gloo mesh
    against the JAX Module's on a 4-device mesh (``shard_opt_state``)
    from the same weights and global batch: params, BN stats and every
    optimizer slot within 1e-5 relative, each collection as one vector
    (the counts equal); one sha256 over the ranks.  One step: past it a
    last-bit difference of the norms can flip a ReLU mask and part the
    trajectories (as any two implementations' can)."""
    import json
    import flax.serialization
    from dt_tpu import data as jdata
    tmp, _ = module_case
    x, y = _global_data()
    per = GLOBAL // RANKS
    for r in range(RANKS):
        with np.load(tmp / f"data{r}.npz") as z:
            np.savez(tmp / f"one{r}.npz", x=z["x"][:per], y=z["y"][:per])
    mesh = jmesh.make_mesh(devices=jax.devices()[:RANKS])
    jmod = JModule(jmodels.create("resnet20", num_classes=10),
                   optimizer=name, optimizer_params=_ZERO_OPTS[name],
                   mesh=mesh, shard_opt_state=True)
    jmod.init_params(x[:GLOBAL])
    jmod.fit(jdata.NDArrayIter(x[:GLOBAL], y[:GLOBAL], batch_size=GLOBAL),
             num_epoch=1)
    st = jax.device_get(jmod.state)
    ref = flat_tree({"params": st.params, "batch_stats": st.batch_stats,
                     "opt_state": flax.serialization.to_state_dict(
                         st.opt_state)})
    res, states = _port_run(tmp, ["--zero", "--optimizer", name,
                                  "--opt-params",
                                  json.dumps(_ZERO_OPTS[name])],
                            data="one{rank}.npz")
    assert len({r["sha256"] for r in res}) == 1
    got = states[0]
    assert set(got) == set(ref)
    assert got["opt_state/count"] == ref["opt_state/count"] == 1
    for coll in ("params/", "batch_stats/", "opt_state/a/", "opt_state/b/",
                 "opt_state/mom/"):
        keys = sorted(k for k in ref if k.startswith(coll))
        if not keys:
            continue
        a = np.concatenate([got[k].ravel() for k in keys])
        b = np.concatenate([ref[k].ravel() for k in keys])
        if coll == "params/" and name == "adam":
            # Adam's first update is -lr*g/(|g| + eps): where |g| is down
            # at the two packages' gradient noise (1e-5 of the largest
            # here; 1e-8 to 7e-7 seen against 0.27) it is +-lr on the sign
            # of that noise.  Those entries are held to the rule's bound,
            # 2*lr; the others as every other vector is
            g = np.concatenate([ref["opt_state/a/" + k[len(coll):]].ravel()
                                for k in keys])
            noise = np.abs(g) <= 1e-5 * np.abs(g).max()
            assert np.abs(a - b)[noise].max(initial=0.0) <= \
                2 * _ZERO_OPTS[name]["learning_rate"]
            a, b = a[~noise], b[~noise]
        assert _rel(a, b) <= 1e-5, (coll, _rel(a, b))


# --------------------------------------------------------------------------
# sharding_report
# --------------------------------------------------------------------------

_JAX_STATES = {}


def _jax_state(name):
    if name not in _JAX_STATES:
        kw = {"num_classes": 1000} if name == "resnet50" else \
            {"num_classes": 10, "hidden": (96, 48)}
        shape = (1, 32, 32, 3) if name == "resnet50" else (1, 6, 6, 1)
        jmod = JModule(jmodels.create(name, **kw), optimizer="sgd",
                       optimizer_params=SGD)
        jmod.init_params(np.zeros(shape, np.float32))
        _JAX_STATES[name] = (jmod.state, kw, shape)
    return _JAX_STATES[name]


@pytest.mark.parametrize("n", [2, 3, 4, 8])
@pytest.mark.parametrize("name", ["resnet50", "mlp"])
def test_sharding_report_matches_jax_coverage(name, n):
    """The port's ZeRO-1/FSDP plan covers the bytes the JAX Module's
    ``_dp_shardings`` shards, as ``_coverage`` counts them; the port's
    Module reports the same after sharding its state on a mesh of n."""
    st, kw, shape = _jax_state(name)
    mesh = jmesh.make_mesh(devices=jax.devices()[:n])
    rep = jmesh.replicate_sharding(mesh)
    want = {
        "opt_state": JModule._coverage(
            st.opt_state, JModule._dp_shardings(st.opt_state, mesh, rep),
            rep),
        "params": JModule._coverage(
            st.params, JModule._dp_shardings(st.params, mesh, rep), rep)}
    in_shape = {"in_shape": shape[1:]} if name == "mlp" else {}
    model = tmodels.create(name, device="cpu", **kw, **in_shape)
    tstate = TrainState.create(model, toptim.create("sgd", **SGD))
    plan = ShardPlan(tstate, Mesh(0, n, device="cpu"), True, True)
    assert plan.report == want
    tmod = TModule(tmodels.create(name, device="cpu", **kw, **in_shape),
                   optimizer="sgd", optimizer_params=SGD, device="cpu",
                   mesh=Mesh(n - 1, n, device="cpu"), shard_opt_state=True,
                   shard_params=True)
    tmod.init_params()
    tmod._setup_mesh()
    assert tmod.sharding_report == want


_REPORT_OPTS = {"adam": ("adam", {}), "nadam": ("nadam", {}),
                "mp_sgd": ("sgd", dict(SGD, multi_precision=True))}


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("case", sorted(_REPORT_OPTS))
def test_sharding_report_of_every_slot_layout(case, n):
    """ZeRO-1's report over adam's two slots, nadam's (its 0-d ``c`` and
    the count stay whole) and the multi-precision masters beside the
    momentum equals the JAX Module's ``_coverage`` of that state, for
    ResNet-50 and the mlp."""
    import dt_tpu.training.train_state as jts
    name, kw = _REPORT_OPTS[case]
    for model_name in ("resnet50", "mlp"):
        st, mkw, shape = _jax_state(model_name)
        jst = jts.TrainState.create(st.apply_fn, st.params,
                                    joptim.create(name, **kw),
                                    st.batch_stats)
        mesh = jmesh.make_mesh(devices=jax.devices()[:n])
        rep = jmesh.replicate_sharding(mesh)
        want = JModule._coverage(
            jst.opt_state, JModule._dp_shardings(jst.opt_state, mesh, rep),
            rep)
        in_shape = {"in_shape": shape[1:]} if model_name == "mlp" else {}
        model = tmodels.create(model_name, device="cpu", **mkw, **in_shape)
        tstate = TrainState.create(model, toptim.create(name, **kw))
        plan = ShardPlan(tstate, Mesh(0, n, device="cpu"), True, False)
        assert plan.report == {"opt_state": want}, model_name


# --------------------------------------------------------------------------
# snapshots across the packages
# --------------------------------------------------------------------------

def test_port_snapshot_restores_through_jax_restore_state():
    """A port TrainState after one step (momentum non-zero), snapshotted
    (JAX names and layout), restores through ``dt_tpu``'s
    ``restore_state`` onto the 8-device mesh with every value equal."""
    from dt_tpu_torch.training.step import train_step
    model = tmodels.create("resnet20", device="cpu", num_classes=10)
    tmod = TModule(model, optimizer="sgd", optimizer_params=SGD,
                   device="cpu")
    tmod.init_params()
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.uniform(-1, 1, (8, 8, 8, 3))
                         .astype(np.float32)).permute(0, 3, 1, 2)
    train_step(tmod.state, x, torch.from_numpy(rng.randint(0, 10, 8)))
    blob = snapshot_state(tmod.state)
    mesh = jmesh.make_mesh()
    placed = jmm.restore_state(blob, mesh)
    assert len(jax.tree_util.tree_leaves(placed)) == \
        len(jax.tree_util.tree_leaves(blob))
    for (path, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(placed)[0],
            jax.tree_util.tree_flatten_with_path(blob)[0]):
        assert len(a.sharding.device_set) == 8
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))
    back = load_jax_variables(
        tmodels.create("resnet20", device="cpu", num_classes=10),
        {"params": jax.device_get(placed["params"]),
         "batch_stats": jax.device_get(placed["batch_stats"])})
    for (n, p), (_, q) in zip(back.named_parameters(),
                              tmod.model.named_parameters()):
        assert torch.equal(p, q), n
