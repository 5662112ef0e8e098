"""Rematerialization in the port (``ops.remat``; the models' ``remat`` and
``Module(remat=True)``), on the CPU.

- Bit for bit against the same model without remat: the gradients of a
  ``TransformerLM`` with dropout drawn from an explicit generator (the
  recompute replays the masks, and leaves the generator where the forward
  left it) and of ``resnet20``/``resnet18`` in training mode, whose
  running stats move once, not again in the recompute;
- ``Module(remat=True)`` (one checkpoint over the forward and the loss):
  two sgd steps of ``resnet20`` with BN and of the LM with dropout land on
  the same params and BN stats, bit for bit, as without it;
- against ``dt_tpu``: the gradient of ``resnet20(remat=True)``'s loss in
  training mode and the TransformerLM's within 1e-5 relative of
  ``jax.grad`` of the JAX model with ``remat=True``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt_tpu import models as jmodels
from dt_tpu.ops import losses as jlosses
from dt_tpu_torch import models as tmodels
from dt_tpu_torch.data import io as tio
from dt_tpu_torch.interchange import load_jax_variables
from dt_tpu_torch.ops import remat
from dt_tpu_torch.ops.losses import softmax_cross_entropy
from dt_tpu_torch.training.module import Module as TModule
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)
from torch_parallel_worker import SGD, flat, shifted_loss

LM = dict(vocab_size=32, embed_dim=16, num_layers=2, num_heads=2, max_len=8)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _grads(model) -> torch.Tensor:
    return torch.cat([p.grad.reshape(-1) for p in model.parameters()])


def _images(n=4, size=8, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, 3, size, size, generator=g).contiguous(
        memory_format=torch.channels_last)


def test_checkpoint_replays_the_generator():
    """A region that draws from a generator: the recompute sees the same
    draws, and the generator ends where the forward left it."""
    w = torch.randn(6, requires_grad=True)
    out = {}
    for use in (False, True):
        gen = torch.Generator().manual_seed(3)
        w.grad = None

        def f(x):
            return x * torch.rand(x.shape, generator=gen)
        y = remat.checkpoint(f, w * 2, generator=gen) if use else f(w * 2)
        after_fwd = gen.get_state()
        y.square().sum().backward()
        assert torch.equal(gen.get_state(), after_fwd)
        out[use] = (y.detach(), w.grad.clone())
    assert torch.equal(out[False][0], out[True][0])
    assert torch.equal(out[False][1], out[True][1])
    assert not remat.replaying()


def test_lm_remat_with_dropout_is_bit_equal():
    toks = torch.from_numpy(np.random.RandomState(0).randint(0, 32, (2, 8)))
    res = []
    for use in (False, True):
        m = tmodels.init_params(tmodels.create(
            "transformer_lm", device="cpu", dropout=0.2, remat=use, **LM), 0)
        gen = torch.Generator().manual_seed(5)
        logits = m(toks, training=True, generator=gen)
        logits.float().square().mean().backward()
        res.append((logits.detach(), _grads(m), gen.get_state()))
    for a, b in zip(*res):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["resnet20", "resnet18"])
def test_resnet_remat_is_bit_equal_and_moves_stats_once(name):
    res = []
    for use in (False, True):
        m = tmodels.init_params(tmodels.create(
            name, device="cpu", num_classes=10, remat=use), 0)
        out = m(_images(size=8 if name == "resnet20" else 32), training=True)
        softmax_cross_entropy(out, torch.arange(4)).backward()
        res.append((out.detach(), _grads(m),
                    torch.cat([b.reshape(-1) for b in m.buffers()])))
    for a, b in zip(*res):
        assert torch.equal(a, b)
    assert not torch.equal(res[0][2][:16], torch.zeros(16))  # moved at all


def _module_run(model, use, loss_fn, x, y):
    mod = TModule(model, loss_fn=loss_fn, optimizer="sgd",
                  optimizer_params=SGD, device="cpu", remat=use, seed=2)
    mod.init_params()
    mod.fit(tio.NDArrayIter(x, y, batch_size=4), num_epoch=1)
    return [t.detach().clone() for t in model.state_dict().values()]


@pytest.mark.parametrize("case", ["resnet20", "lm_dropout"])
def test_module_remat_is_bit_equal(case):
    rng = np.random.RandomState(4)
    if case == "resnet20":
        x = rng.uniform(-1, 1, (8, 8, 8, 3)).astype(np.float32)
        y = rng.randint(0, 10, 8).astype(np.int32)
        make = lambda use: tmodels.create(  # noqa: E731
            "resnet20", device="cpu", num_classes=10)
        loss_fn = softmax_cross_entropy
    else:
        x = rng.randint(0, 32, (8, 8)).astype(np.int32)
        y = x
        make = lambda use: tmodels.create(  # noqa: E731
            "transformer_lm", device="cpu", dropout=0.2, **LM)
        loss_fn = shifted_loss
    a = _module_run(make(False), False, loss_fn, x, y)
    b = _module_run(make(True), True, loss_fn, x, y)
    assert len(a) == len(b)
    for s, t in zip(a, b):
        assert torch.equal(s, t)


def _jax_grad(model, variables, x, loss):
    def f(p):
        out, _ = model.apply({**variables, "params": p}, x, training=True,
                             mutable=["batch_stats"])
        return loss(out)
    return flat(jax.device_get(jax.jit(jax.grad(f))(variables["params"])),
                "p")


def test_resnet_remat_gradient_matches_jax():
    x = np.transpose(_images().numpy(), (0, 2, 3, 1))
    jm = jmodels.create("resnet20", num_classes=10, remat=True)
    v = jax.device_get(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                               training=False))
    labels = jnp.arange(4)
    want = _jax_grad(jm, v, jnp.asarray(x),
                     lambda o: jlosses.softmax_cross_entropy(o, labels))
    tm = tmodels.create("resnet20", device="cpu", num_classes=10, remat=True)
    load_jax_variables(tm, v)
    out = tm(_images(), training=True)
    softmax_cross_entropy(out, torch.arange(4)).backward()
    from dt_tpu_torch.interchange import jax_path, to_jax_layout
    got = {"p/" + "/".join(jax_path(n)): to_jax_layout(p.grad, jax_path(n)[-1])
           .numpy() for n, p in tm.named_parameters()}
    assert set(got) == set(want)
    for k in want:
        assert _rel(got[k], want[k]) <= 1e-5, (k, _rel(got[k], want[k]))


def test_lm_remat_gradient_matches_jax():
    toks = np.random.RandomState(1).randint(0, 32, (2, 8)).astype(np.int32)
    jm = jmodels.TransformerLM(remat=True, **LM)
    v = jax.device_get(jm.init({"params": jax.random.PRNGKey(2)},
                               jnp.asarray(toks), training=False))

    def loss(o):
        return jlosses.softmax_cross_entropy(
            o[:, :-1].reshape(-1, 32), jnp.asarray(toks)[:, 1:].reshape(-1))
    want = _jax_grad(jm, v, jnp.asarray(toks), loss)
    tm = tmodels.create("transformer_lm", device="cpu", remat=True, **LM)
    load_jax_variables(tm, v)
    t = torch.from_numpy(toks)
    shifted_loss(tm(t, training=True), t).backward()
    from dt_tpu_torch.interchange import jax_path, to_jax_layout
    for n, p in tm.named_parameters():
        key = "p/" + "/".join(jax_path(n))
        got = to_jax_layout(p.grad, jax_path(n)[-1]).numpy()
        assert _rel(got, want[key]) <= 1e-5, (key, _rel(got, want[key]))
