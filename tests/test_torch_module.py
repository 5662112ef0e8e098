"""The port's ``Module`` against the JAX package's, on the CPU.

The gate of ``Module.fit`` in one process: the JAX Module initializes a
model (its own flax init), the port's Module takes those weights through
``interchange.load_jax_variables``, and both fit the same shuffled batches
of sklearn's bundled digits (8x8x1, no download; batches divide by the 8
virtual CPU devices the JAX side runs on).  Held: the per-epoch train
cross-entropy within 1e-3 relative and the validation accuracy within 0.5
points (MLP, LeNet); params within 1e-3 of their norm after a
``grad_accum=2`` fit of ``resnet20_cifar`` (BN stats chained through the
microbatches); the health halt; ``score``/``predict``; and every feature
the slice does not port raising ``NotImplementedError``.
"""

import jax
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from sklearn.datasets import load_digits

from dt_tpu import models as jmodels
from dt_tpu.data import io as jio
from dt_tpu.training.module import Module as JModule
from dt_tpu_torch import models as tmodels
from dt_tpu_torch.data import io as tio
from dt_tpu_torch.interchange import export_jax_variables, load_jax_variables
from dt_tpu_torch.obs import metrics as tobs
from dt_tpu_torch.parallel import kvstore as tkv
from dt_tpu_torch.training import callbacks as tcb
from dt_tpu_torch.training.module import Module as TModule
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

SGD = dict(learning_rate=0.1, momentum=0.9)


def _digits(n_train=1408, n_val=384):
    d = load_digits()
    x = (d.images[..., None] / 16.0).astype(np.float32)
    y = d.target.astype(np.int32)
    return (x[:n_train], y[:n_train],
            x[n_train:n_train + n_val], y[n_train:n_train + n_val])


def _curves(mod, io, xtr, ytr, xva, yva, epochs, **fit_kw):
    """Per-epoch train metrics and validation metrics of one fit."""
    train, val = [], []
    mod.fit(io.NDArrayIter(xtr, ytr, batch_size=64, shuffle=True),
            eval_data=io.NDArrayIter(xva, yva, batch_size=64),
            eval_metric=["ce", "acc"], num_epoch=epochs,
            epoch_end_callback=lambda e, s, m: train.append(
                dict(m.get_name_value())),
            eval_end_callback=lambda e, m: val.append(
                dict(m.get_name_value())), **fit_kw)
    return train, val


def _pair(name, xtr, port_kw=None, grad_accum=1, **kw):
    """A JAX Module (its own init) and a port Module on the CPU holding the
    same weights."""
    jmod = JModule(jmodels.create(name, **kw), optimizer="sgd",
                   optimizer_params=SGD, seed=0, grad_accum=grad_accum)
    jmod.init_params(xtr[:64])
    tmod = TModule(tmodels.create(name, device="cpu", **kw,
                                  **(port_kw or {})),
                   optimizer="sgd", optimizer_params=SGD, device="cpu",
                   grad_accum=grad_accum)
    tmod.init_params()
    load_jax_variables(tmod.model, {
        "params": jax.device_get(jmod.state.params),
        "batch_stats": jax.device_get(jmod.state.batch_stats)})
    return jmod, tmod


@pytest.mark.parametrize("name", ["mlp", "lenet"])
def test_fit_on_digits_matches_the_jax_module(name):
    """3 epochs, batch 64, shuffled, SGD momentum 0.9: train cross-entropy
    within 1e-3 relative each epoch, validation accuracy within 0.5
    points, and the model learns (validation accuracy above 0.8)."""
    xtr, ytr, xva, yva = _digits()
    jmod, tmod = _pair(name, xtr, dict(in_shape=(8, 8, 1)), num_classes=10)
    jt, jv = _curves(jmod, jio, xtr, ytr, xva, yva, 3)
    tt, tv = _curves(tmod, tio, xtr, ytr, xva, yva, 3)
    for a, b in zip(tt, jt):
        assert abs(a["cross-entropy"] - b["cross-entropy"]) <= \
            1e-3 * b["cross-entropy"], (tt, jt)
    for a, b in zip(tv, jv):
        assert abs(a["accuracy"] - b["accuracy"]) <= 0.005, (tv, jv)
    assert tv[-1]["accuracy"] > 0.8
    assert tmod.state.step == jmod.state.step == 3 * 22


def test_grad_accum_resnet20_matches_the_jax_module():
    """``resnet20_cifar`` with ``grad_accum=2`` (two microbatches of 32 a
    step, one averaged update, the BN running stats chained through the
    microbatches), 2 epochs over 128 digits: params and BN stats within
    1e-3 of their norm of the JAX Module's, and the stats moved."""
    xtr, ytr, _, _ = _digits(128, 0)
    jmod, tmod = _pair("resnet20_cifar", xtr, dict(in_channels=1),
                       grad_accum=2, num_classes=10)
    for mod, io in ((jmod, jio), (tmod, tio)):
        mod.fit(io.NDArrayIter(xtr, ytr, batch_size=64, shuffle=True),
                eval_metric="ce", num_epoch=2)
    got = export_jax_variables(tmod.model)
    for coll, tree in (("params", jmod.state.params),
                       ("batch_stats", jmod.state.batch_stats)):
        want = np.asarray(ravel_pytree(jax.device_get(tree))[0])
        have = np.asarray(ravel_pytree(got[coll])[0])
        rel = np.linalg.norm(have - want) / np.linalg.norm(want)
        assert rel <= 1e-3, (coll, rel)
    moved = tmod.state.layout.stats.ravel(tmod.state.batch_stats)
    assert float(moved.abs().sum()) > 0 and tmod.state.step == 4


def test_grad_accum_matches_the_monolithic_step():
    """The port's twin of ``tests/test_training.py``'s: for a BN-less model
    ``grad_accum=4`` (mean of microbatch-mean gradients) updates as the
    whole batch does, within 2e-5."""
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (16, 4, 4, 1)).astype(np.float32)
    y = rng.randint(0, 2, 16).astype(np.int32)

    def run(accum):
        mod = TModule(tmodels.create("mlp", device="cpu", num_classes=2,
                                     hidden=(8,), in_shape=(4, 4, 1)),
                      optimizer="sgd", optimizer_params=SGD, device="cpu",
                      seed=3, grad_accum=accum)
        mod.fit(tio.NDArrayIter(x, y, batch_size=16), num_epoch=2)
        return mod.state.layout.params.ravel(mod.state.params).numpy()

    np.testing.assert_allclose(run(1), run(4), rtol=2e-5, atol=2e-5)
    mod = TModule(tmodels.create("mlp", device="cpu", num_classes=2,
                                 hidden=(4,), in_shape=(4, 4, 1)),
                  device="cpu", grad_accum=3)
    with pytest.raises(ValueError, match="divide the batch"):
        mod.fit(tio.NDArrayIter(x[:8], y[:8], batch_size=8), num_epoch=1)
    with pytest.raises(ValueError, match="grad_accum"):
        TModule(mod.model, device="cpu", grad_accum=0)


def _nan_dataset(n=32, poison_from=16):
    x = np.random.RandomState(0).normal(size=(n, 4, 4, 1)).astype(
        np.float32)
    x[poison_from:] = np.nan
    y = np.random.RandomState(1).randint(0, 2, n).astype(np.int32)
    return x, y


@pytest.fixture
def _no_health_env(monkeypatch):
    monkeypatch.delenv("DT_HEALTH_HALT", raising=False)
    monkeypatch.delenv("DT_METRICS", raising=False)
    yield monkeypatch
    tobs.set_enabled(None)


def test_health_halt_leaves_params_as_the_jax_module_does(_no_health_env):
    """A NaN batch under ``DT_HEALTH_HALT=1``: both Modules stop after the
    clean step, the poisoned update never applied, with the same finite
    params; without the halt the sentinel only observes."""
    _no_health_env.setenv("DT_HEALTH_HALT", "1")
    x, y = _nan_dataset()
    kw = dict(num_classes=2, hidden=())
    jmod, tmod = _pair("mlp", x, dict(in_shape=(4, 4, 1)), **kw)
    for mod, io in ((jmod, jio), (tmod, tio)):
        mod.fit(io.NDArrayIter(x, y, batch_size=16), num_epoch=3)
        assert mod.health_halted is True
        assert int(mod.state.step) == 1
    want = np.asarray(ravel_pytree(jax.device_get(jmod.state.params))[0])
    have = np.asarray(ravel_pytree(export_jax_variables(
        tmod.model)["params"])[0])
    assert np.isfinite(have).all()
    np.testing.assert_allclose(have, want, rtol=1e-6, atol=1e-7)
    _no_health_env.delenv("DT_HEALTH_HALT")
    tobs.set_enabled(True)  # observe only
    mod = TModule(tmodels.create("mlp", device="cpu", in_shape=(4, 4, 1),
                                 **kw), device="cpu")
    mod.fit(tio.NDArrayIter(x, y, batch_size=16), num_epoch=1)
    assert mod.health_halted is False and mod.state.step == 2


def test_score_and_predict_match_the_jax_module():
    """After the same 1-epoch LeNet fit: ``predict`` logits within 1e-4 and
    ``score`` (acc, ce; a padded last batch) within 1e-5."""
    xtr, ytr, xva, yva = _digits(256, 100)
    jmod, tmod = _pair("lenet", xtr, dict(in_shape=(8, 8, 1)),
                       num_classes=10)
    for mod, io in ((jmod, jio), (tmod, tio)):
        mod.fit(io.NDArrayIter(xtr, ytr, batch_size=64, shuffle=True),
                num_epoch=1)
    np.testing.assert_allclose(tmod.predict(xva[:16]), jmod.predict(
        xva[:16]), rtol=1e-4, atol=1e-4)
    a = dict(jmod.score(jio.NDArrayIter(xva, yva, batch_size=32),
                        ["acc", "ce"]))
    b = dict(tmod.score(tio.NDArrayIter(xva, yva, batch_size=32),
                        ["acc", "ce"]))
    assert abs(a["accuracy"] - b["accuracy"]) <= 1e-5
    assert abs(a["cross-entropy"] - b["cross-entropy"]) <= \
        1e-5 * a["cross-entropy"]


def test_fit_callbacks_checkpoint_and_begin_epoch(tmp_path):
    """Batch-end callbacks see the metric one step behind with pads left
    out, the Speedometer logs, ``do_checkpoint`` writes each epoch and
    ``begin_epoch`` numbers them; ``DevicePrefetchIter`` on the CPU feeds
    the same steps."""
    xtr, ytr, xva, yva = _digits(200, 64)
    seen = []
    speed = tcb.Speedometer(64, frequent=1, auto_reset=False)
    mod = TModule(tmodels.create("mlp", device="cpu", in_shape=(8, 8, 1)),
                  optimizer="sgd", optimizer_params=SGD, device="cpu")
    mod.fit(tio.DevicePrefetchIter(tio.NDArrayIter(xtr, ytr, 64),
                                   device="cpu"),
            eval_data=tio.NDArrayIter(xva, yva, 64), num_epoch=3,
            begin_epoch=1, batch_end_callback=[
                lambda p: seen.append((p.epoch, p.nbatch,
                                       p.eval_metric.num_inst)), speed],
            epoch_end_callback=tcb.do_checkpoint(str(tmp_path / "m")),
            eval_end_callback=tcb.log_validation_metrics)
    # 200 rows, batch 64: 4 batches an epoch, the last padded by 56 rows
    assert seen[:4] == [(1, 1, 64), (1, 2, 128), (1, 3, 192), (1, 4, 200)]
    assert len(seen) == 8 and seen[-1][0] == 2
    assert len(speed.speeds) == 6
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "m-0001.state", "m-0002.state", "m-meta.json"]
    assert mod.state.step == 8


def test_unported_features_raise(monkeypatch):
    """What the port does not have raises ``NotImplementedError`` naming
    its ROADMAP item (``remat`` and a mesh's model axis are ported now: a
    Module takes ``remat=True``, and a mesh must be a port mesh); a
    ``mesh_manager``
    is taken, and the mesh sync mode across worker processes without their
    process group refuses to train each worker alone; the elastic contract
    (the distributed kvstores, a controller, the env variables,
    ``sync_mode="host"`` alone) runs; ZeRO/FSDP flags are no-ops on one
    device."""
    import types
    model = tmodels.create("mlp", device="cpu", in_shape=(4, 4, 1))
    x, y = _nan_dataset(poison_from=32)
    it = tio.NDArrayIter(x, y, batch_size=16)
    assert TModule(model, device="cpu", remat=True).remat
    assert TModule(model, device="cpu",
                   mesh_manager=object()).mesh_manager is not None
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        TModule(model, device="cpu", mesh=types.SimpleNamespace(
            shape={"data": 1, "model": 2}))
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        TModule(model, device="cpu", mesh=object())
    for name in ("tpu_sync", "dist_sync", "dist_device_sync", "dist"):
        kv = tkv.create(name)
        assert (kv.type, kv.rank, kv.num_workers) == ("tpu_sync", 0, 1)
    # dist_async is ported: without a controller fit says what it needs
    with pytest.raises(RuntimeError, match="elastic controller"):
        TModule(model, device="cpu", kvstore="dist_async").fit(it)
    with pytest.raises(ValueError, match="unknown kvstore"):
        tkv.create("nccl")
    for var in ("NEW_WORKER", "ELASTIC_TRAINING_ENABLED", "EPOCH_BEGIN"):
        with monkeypatch.context() as m:
            m.setenv(var, "1")
            mod = TModule(model, device="cpu")
            mod.fit(it, num_epoch=2)
            assert mod.state.step == 4  # EPOCH_BEGIN counts with NEW_WORKER
    mod = TModule(model, device="cpu")
    mod.sync_mode = "host"  # one worker: the plain step
    mod.fit(it)
    assert mod.state.step == 2

    class TwoWorkers(tkv.KVStore):
        num_workers = 2

    class Ctrl:
        policy_shares = {"w0": 6000, "w1": 4000}
        workers = ["w0", "w1"]
        rank = 0
        host = "w0"

        def membership_change_barrier(self, info):
            pass

    with pytest.raises(ValueError, match="mesh_manager"):
        TModule(model, device="cpu", kvstore=TwoWorkers()).fit(it)
    kv = tkv.create("tpu_sync")
    kv.set_controller(Ctrl())
    mod = TModule(model, device="cpu", kvstore=kv)
    mod.sync_mode = "host"
    # policy shares are ported (item 3d): they weight the gradient as the
    # JAX Module weights it, and fixed per-worker batches ignore them
    for fixed, want in ((False, 1.25), (True, 1.0)):
        eit = tio.ElasticDataIterator(lambda p, i, b: (it, None), 16, fixed)
        jeit = jio.ElasticDataIterator(lambda p, i, b: (it, None), 16, fixed)
        got = mod._policy_grad_scale(eit)
        assert got == want == JModule._policy_grad_scale(
            types.SimpleNamespace(kv=kv, sync_mode="host"), jeit)
    mod = TModule(model, device="cpu", shard_opt_state=True,
                  shard_params=True)
    mod.fit(it, num_epoch=1, elastic_data_iterator=tio.ElasticDataIterator(
        lambda p, i, b: (it, None), 16))
    assert mod.sharding_report == {} and mod.state.step == 2
    kv = tkv.create("device")
    kv.init("w", np.ones(3))
    kv.push("w", [np.ones(3), 3 * np.ones(3)])
    np.testing.assert_array_equal(kv.pull("w"), 2 * np.ones(3))
    kv.set_gradient_compression({"type": "2bit", "threshold": 0.1})
    assert kv._gradient_compression.threshold == 0.1
    assert (kv.rank, kv.num_workers, kv.type) == (0, 1, "local")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TModule(tmodels.create("mlp", device="cpu"))
