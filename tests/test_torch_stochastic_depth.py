"""``CifarResNet`` training with stochastic depth, the port against the JAX
package, on the CPU.

The JAX model draws each identity-shortcut block's keep with
``jax.random.bernoulli`` from its ``dropout`` stream, which the port cannot
reproduce; the tests record JAX's draws (``jax.random.bernoulli`` wrapped
through ``monkeypatch``) and hand them to the port's forward by replacing
``dt_tpu_torch.models.resnet.draw_keep``.  Held: train-mode logits within
1e-4, the running stats and every parameter's gradient within 1e-4 of the
largest of its leaf (f32 convolutions sum in another order on the two
sides); eval logits; and ``Module.fit`` steps of ``resnet20_cifar`` with
``stochastic_depth=0.5`` against the JAX ``Module`` with one keep pattern
forced on both sides (the JAX step is jitted, so its draws are not
concrete), params within 1e-4 of their norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from dt_tpu import models as jmodels
from dt_tpu.data import io as jio
from dt_tpu.training.module import Module as JModule
from dt_tpu_torch import models as tmodels
from dt_tpu_torch.data import io as tio
from dt_tpu_torch.interchange import export_jax_variables, load_jax_variables
from dt_tpu_torch.models import resnet as tresnet
from dt_tpu_torch.training.module import Module as TModule
from dt_tpu_torch.training.train_state import TrainState
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

TOL = 1e-4
RATE = 0.5
BLOCKS = 7  # resnet20: 9 blocks, 2 of them downsampling


def _fill(shapes, seed=1):
    rng = np.random.RandomState(seed)

    def one(path, s):
        k = path[-1].key
        if k == "mean":
            return rng.normal(0, 0.5, s.shape).astype(np.float32)
        if k in ("var", "scale"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if k == "bias":
            return rng.normal(0, 0.1, s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.normal(0, 1, s.shape) / np.sqrt(fan_in)) \
            .astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


def _record_bernoulli(monkeypatch):
    """Wrap ``jax.random.bernoulli``: every draw is recorded, concrete."""
    drawn = []
    real = jax.random.bernoulli

    def wrapped(key, p=0.5, shape=None):
        out = real(key, p, shape)
        drawn.append(bool(np.asarray(out)))
        return out

    monkeypatch.setattr(jax.random, "bernoulli", wrapped)
    return drawn


def _replay_keeps(monkeypatch, keeps):
    """The port's draws replaced by ``keeps``, in order, cycling."""
    count = [0]

    def draw(keep_prob, generator, device):
        k = keeps[count[0] % len(keeps)]
        count[0] += 1
        return torch.tensor(k, device=device)

    monkeypatch.setattr(tresnet, "draw_keep", draw)
    return count


def _ce(logits, y):
    return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits),
                                         y[:, None], 1))


@pytest.mark.parametrize("key", [0, 3, 5])
def test_train_forward_and_grads_with_jax_keeps(monkeypatch, key):
    rng = np.random.RandomState(key)
    x = rng.uniform(-1, 1, (4, 16, 16, 3)).astype(np.float32)
    y = rng.randint(0, 10, 4).astype(np.int32)
    jm = jmodels.create("resnet20", num_classes=10, stochastic_depth=RATE)
    variables = _fill(jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, x, training=False)))
    drawn = _record_bernoulli(monkeypatch)

    def loss(params):
        logits, new = jm.apply({"params": params,
                                "batch_stats": variables["batch_stats"]},
                               x, training=True, mutable=["batch_stats"],
                               rngs={"dropout": jax.random.PRNGKey(key)})
        return _ce(logits, jnp.asarray(y)), (logits, new)

    (_, (want, new_stats)), jg = jax.value_and_grad(
        loss, has_aux=True)(variables["params"])
    assert len(drawn) == BLOCKS and 0 < sum(drawn) < BLOCKS  # both kinds

    model = tmodels.create("resnet20", device="cpu", num_classes=10,
                           stochastic_depth=RATE)
    load_jax_variables(model, variables)
    count = _replay_keeps(monkeypatch, drawn)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    logits = model(xt, training=True)
    assert count[0] == BLOCKS
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    torch.nn.functional.cross_entropy(logits,
                                      torch.from_numpy(y).long()).backward()
    got = export_jax_variables(model)
    for a, b in zip(jax.tree_util.tree_leaves(got["batch_stats"]),
                    jax.tree_util.tree_leaves(new_stats["batch_stats"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=TOL,
                                   atol=TOL)
    # the gradients in the JAX layout: the same export over the .grad's
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.grad)
    grads = export_jax_variables(model)["params"]
    flat_g, _ = ravel_pytree(jax.tree_util.tree_map(np.asarray, grads))
    flat_w, _ = ravel_pytree(jax.device_get(jg))
    assert flat_g.shape == flat_w.shape
    for a, b in zip(jax.tree_util.tree_leaves(grads),
                    jax.tree_util.tree_leaves(jax.device_get(jg))):
        b = np.asarray(b)
        assert np.abs(np.asarray(a) - b).max() <= \
            TOL * max(np.abs(b).max(), 1e-6)


def test_draws_follow_the_generator_and_eval_is_deterministic():
    torch.manual_seed(0)
    model = tmodels.create("resnet20", device="cpu", num_classes=10,
                           stochastic_depth=0.9)
    tmodels.init_params(model, 0)
    x = torch.randn(2, 3, 8, 8).contiguous(memory_format=torch.channels_last)

    def train(seed):
        with torch.no_grad():
            return model(x, training=True,
                         generator=torch.Generator().manual_seed(seed))

    assert torch.equal(train(1), train(1))
    assert any(not torch.equal(train(1), train(s)) for s in (2, 3, 4))
    a, b = model(x), model(x)
    assert torch.equal(a, b) and torch.isfinite(a).all()


KEEPS = [True, False, True, True, False, True, False]


def test_module_fit_steps_match_the_jax_module(monkeypatch):
    """Two epochs of ``Module.fit`` (4 steps of 32) with one keep pattern
    forced on both sides (every step draws the pattern again)."""
    rng = np.random.RandomState(2)
    x = rng.uniform(-1, 1, (64, 8, 8, 3)).astype(np.float32)
    y = rng.randint(0, 10, 64).astype(np.int32)
    pattern = iter(range(10 ** 6))

    def forced(key, p=0.5, shape=None):
        return jnp.asarray(KEEPS[next(pattern) % len(KEEPS)])

    monkeypatch.setattr(jax.random, "bernoulli", forced)
    opt = dict(learning_rate=0.05, momentum=0.9)
    jmod = JModule(jmodels.create("resnet20_cifar", num_classes=10,
                                  stochastic_depth=RATE),
                   optimizer="sgd", optimizer_params=opt, seed=0)
    jmod.init_params(x[:32])
    tmod = TModule(tmodels.create("resnet20_cifar", device="cpu",
                                  num_classes=10, stochastic_depth=RATE),
                   optimizer="sgd", optimizer_params=opt, device="cpu")
    tmod.init_params()
    load_jax_variables(tmod.model, {
        "params": jax.device_get(jmod.state.params),
        "batch_stats": jax.device_get(jmod.state.batch_stats)})
    tmod.state = TrainState.create(tmod.model, tmod.tx)
    count = _replay_keeps(monkeypatch, KEEPS)
    for mod, io in ((jmod, jio), (tmod, tio)):
        mod.fit(io.NDArrayIter(x, y, batch_size=32, shuffle=True),
                eval_metric="ce", num_epoch=2)
    assert count[0] == 4 * BLOCKS  # one draw a block a step
    assert next(pattern) % BLOCKS == 0  # JAX traced whole patterns
    got = export_jax_variables(tmod.model)
    for coll, tree in (("params", jmod.state.params),
                       ("batch_stats", jmod.state.batch_stats)):
        want = np.asarray(ravel_pytree(jax.device_get(tree))[0])
        have = np.asarray(ravel_pytree(got[coll])[0])
        rel = np.linalg.norm(have - want) / np.linalg.norm(want)
        assert rel <= TOL, (coll, rel)
