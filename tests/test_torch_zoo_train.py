"""Training of the classification zoo, the port against ``dt_tpu``.

One training forward + backward a family at its smallest valid input: the
flax tree from ``jax.eval_shape`` and a seeded numpy fill, the JAX loss
(softmax cross-entropy) and its gradient jitted, ``DT_PALLAS_BN`` unset
(linen's BatchNorm, whose variance is ``E[x^2] - mean^2``, the kernels'
formula).  JAX's dropout masks are recorded (``jax.random.bernoulli``
wrapped, the masks returned from the jitted function) and fed to the port
through ``ops.nn.draw_dropout_mask``.

Both sides compute in float64: JAX under ``jax.enable_x64`` with the model's
``dtype`` float64, the port's model with ``dtype=torch.float64``, whose
BatchNorm runs the kernels' plain versions in float64 on the CPU.  The
weights are the same float32 values on both sides and both return float32
gradients.  In float32 a random deep BN network at batch 4 is
ill-conditioned: ``E[x^2] - mean^2`` over the few rows of a small last
stage loses digits, a pre-activation within rounding of 0 flips its ReLU
mask, and JAX's own float32 gradient moves by up to half a leaf under a
one-ulp nudge of the input.  In float64 the two sides agree to the float32
rounding of what they return (DenseNet-121: logits 4e-13 of the largest,
every gradient leaf 1.3e-8 of its norm).  Held, every family alike
(``TOL``): the training logits within 1e-6 of the largest (AlexNet's LRN
forms its factor in float32 on both sides), the new running stats within
1e-6 (float32 buffers), and each parameter's gradient within 1e-6 of its
norm, which holds both its direction and its size; a leaf whose norm is
below 1e-6 of the largest leaf's (an exact 0 in rounding: a conv bias
before a BatchNorm) within 1e-12 of the largest.

Also here: one ``Module.fit`` step of Inception-BN against ``dt_tpu``'s
``Module``, both in float64.  The 299-input Inceptions are in
``test_torch_zoo_train_inception.py``.  Most of the time is JAX's compiles
of the gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt_tpu import models as jmodels
from dt_tpu_torch.interchange import export_jax_variables, load_jax_variables
from dt_tpu_torch.ops import nn as tnn
from test_torch_zoo_models import FAMILIES, fill, nchw, port_model
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

BATCH = 4
TOL = dict(logits=1e-6, stats=1e-6, leaf=1e-6)
INCEPTIONS_299 = ("inception_v3", "inception_v4", "inception_resnet_v2")


def _leaves(tree):
    return [(jax.tree_util.keystr(p), np.asarray(v, np.float64))
            for p, v in jax.tree_util.tree_leaves_with_path(tree)]


def _shapes(jm, x):
    return jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0)},
                                          x[:1], training=False))


def assert_leaves_close(got, want, tol):
    """Each leaf of ``got`` within ``tol`` of its norm in ``want``; a leaf
    whose norm in ``want`` is below ``tol`` of the largest leaf's (an exact
    0 in rounding) within ``tol ** 2`` of the largest."""
    got, want = _leaves(got), _leaves(want)
    assert [n for n, _ in got] == [n for n, _ in want]
    scale = max(np.linalg.norm(b) for _, b in want)
    for (n, a), (_, b) in zip(got, want):
        err = np.linalg.norm(a - b)
        assert err <= tol * max(np.linalg.norm(b), tol * scale), (n, err)


def train_parity(monkeypatch, name, size):
    """One training forward + backward of ``name`` on both sides, held as
    the module docstring says."""
    monkeypatch.delenv("DT_PALLAS_BN", raising=False)
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (BATCH, size, size, 3))
    y = rng.randint(0, 10, BATCH).astype(np.int32)
    drawn = []
    real = jax.random.bernoulli

    def record(key, p=0.5, shape=None):
        out = real(key, p, shape)
        drawn.append(out)
        return out

    with jax.enable_x64(True):
        jm = jmodels.create(name, num_classes=10, dtype=jnp.float64)
        variables = fill(_shapes(jm, x))
        stats = variables.get("batch_stats", {})

        def loss(params):
            drawn.clear()
            logits, new = jm.apply({"params": params, "batch_stats": stats},
                                   x, training=True, mutable=["batch_stats"],
                                   rngs={"dropout": jax.random.PRNGKey(5)})
            ce = -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits),
                                               jnp.asarray(y)[:, None], 1))
            return ce, (logits, new, list(drawn))

        monkeypatch.setattr(jax.random, "bernoulli", record)
        (_, (want, new, masks)), jgrad = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(variables["params"])
        monkeypatch.undo()
        want, jgrad = np.asarray(want), jax.device_get(jgrad)
        new = jax.device_get(new)

    model = load_jax_variables(port_model(name, size, dtype=torch.float64),
                               variables)
    fed = iter([np.asarray(m) for m in masks])
    monkeypatch.setattr(tnn, "draw_dropout_mask",
                        lambda shape, keep, gen, dev: torch.from_numpy(
                            next(fed).copy()))
    kw = {"generator": torch.Generator()} if masks else {}
    logits = model(nchw(x), training=True, **kw)
    assert next(fed, None) is None  # every JAX mask used, in order
    assert logits.dtype == torch.float64
    torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(y).long()).backward()
    got_stats = export_jax_variables(model)["batch_stats"]
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.grad)
    grads = export_jax_variables(model)["params"]

    err = np.abs(logits.detach().numpy() - want).max()
    assert err <= TOL["logits"] * np.abs(want).max(), err
    assert bool(got_stats) == bool(stats)
    for (n, a), (_, b) in zip(_leaves(got_stats),
                              _leaves(new.get("batch_stats", {}))):
        assert np.abs(a - b).max() <= TOL["stats"], n
    assert_leaves_close(grads, jgrad, TOL["leaf"])


@pytest.mark.parametrize("family", sorted(
    f for f, (name, _) in FAMILIES.items() if name not in INCEPTIONS_299))
def test_training_step_matches_jax(family, monkeypatch):
    train_parity(monkeypatch, *FAMILIES[family])


def test_module_fit_step_matches_the_jax_module():
    """One ``Module.fit`` step of Inception-BN (an epoch of one batch of 8,
    a row for each device of the JAX side's 8-device mesh; sgd lr 0.05,
    momentum 0.9, wd 1e-4) on both sides in float64 from the same filled
    weights.  Each param's update within 1e-6 of its norm, plus one float32
    ulp of the param (both sides round the new float32 value), the new BN
    stats within 1e-6, the step count equal."""
    from dt_tpu.data import io as jio
    from dt_tpu.training.module import Module as JModule
    from dt_tpu.training.train_state import TrainState as JTrainState
    from dt_tpu_torch.data import io as tio
    from dt_tpu_torch.training.module import Module as TModule
    from dt_tpu_torch.training.train_state import TrainState
    rng = np.random.RandomState(3)
    x = rng.uniform(-1, 1, (8, 32, 32, 3))
    y = rng.randint(0, 10, 8).astype(np.int32)
    opt = dict(learning_rate=0.05, momentum=0.9, weight_decay=1e-4)
    with jax.enable_x64(True):
        jm = jmodels.create("inception_bn", num_classes=10,
                            dtype=jnp.float64)
        jmod = JModule(jm, optimizer="sgd", optimizer_params=opt, seed=0)
        start = fill(_shapes(jm, x))
        # the filled weights instead of init_params' eager linen init
        jmod.state = JTrainState.create(jm.apply, start["params"], jmod.tx,
                                        start["batch_stats"])
        jmod.fit(jio.NDArrayIter(x, y, batch_size=8), eval_metric="ce",
                 num_epoch=1)
        jstep = int(jmod.state.step)
        jparams = jax.device_get(jmod.state.params)
        jstats = jax.device_get(jmod.state.batch_stats)
    tmod = TModule(port_model("inception_bn", 32, dtype=torch.float64),
                   optimizer="sgd", optimizer_params=opt, device="cpu")
    tmod.init_params()
    load_jax_variables(tmod.model, start)
    tmod.state = TrainState.create(tmod.model, tmod.tx)
    tmod.fit(tio.NDArrayIter(x, y, batch_size=8), eval_metric="ce",
             num_epoch=1)
    assert tmod.state.step == jstep == 1
    got = export_jax_variables(tmod.model)
    assert [n for n, _ in _leaves(got)] == [n for n, _ in _leaves(
        {"params": jparams, "batch_stats": jstats})]
    ulp = float(np.finfo(np.float32).eps)
    for (n, a), (_, b), (_, w0) in zip(_leaves(got["params"]),
                                       _leaves(jparams),
                                       _leaves(start["params"])):
        err = np.linalg.norm(a - b)
        assert err <= TOL["leaf"] * np.linalg.norm(b - w0) + \
            ulp * np.linalg.norm(b), (n, err)
    for (n, a), (_, b) in zip(_leaves(got["batch_stats"]), _leaves(jstats)):
        assert np.abs(a - b).max() <= TOL["stats"], n


def test_bn_wrappers_run_float64_on_the_cpu():
    """The float64 path the parity above runs: on a CPU float64 input the BN
    wrappers compute in float64 (the kernels' formulas: ``E[x^2] - mean^2``,
    then ``x * scale + bias``), forward and backward, against the same
    formulas written out here; float16 is still refused."""
    from dt_tpu_torch.ops import kernels
    g = torch.Generator().manual_seed(0)
    x = (torch.randn(2, 5, 3, 3, generator=g, dtype=torch.float64) + 3.0) \
        .contiguous(memory_format=torch.channels_last).requires_grad_()
    gamma = torch.rand(5, generator=g) + 0.5
    beta = torch.randn(5, generator=g)
    rm, rv = torch.zeros(5), torch.ones(5)
    y = kernels.fused_bn_train(x, gamma, beta, rm, rv, relu=True)[0]
    x2 = x.permute(0, 2, 3, 1).reshape(-1, 5)
    mean = x2.mean(0)
    var = (x2 * x2).mean(0) - mean * mean
    inv = torch.rsqrt(var + 1e-5)
    want = torch.relu(x2 * (gamma.double() * inv)
                      + (beta.double() - mean * gamma.double() * inv))
    got = kernels.rows_view(y)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=1e-14, atol=1e-14)
    gy = torch.randn(want.shape, generator=g, dtype=torch.float64)
    dx, = torch.autograd.grad(got, x, gy)
    dx_want, = torch.autograd.grad(want, x, gy)
    torch.testing.assert_close(dx, dx_want, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(rv, 0.9 + 0.1 * var.detach().float())
    y = kernels.fused_bn_inference(x.detach(), gamma, beta, rm, rv)
    scale = gamma.double() * torch.rsqrt(rv.double() + 1e-5)
    torch.testing.assert_close(
        kernels.rows_view(y), x2.detach() * scale
        + (beta.double() - rm.double() * scale), rtol=1e-14, atol=1e-14)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        kernels.bn_stats(torch.zeros(4, 5, dtype=torch.float16))
