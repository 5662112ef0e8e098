"""The port's MoE layer against ``dt_tpu``'s, on the CPU.

- ``switch_route``: the dispatch tensor bit-equal to JAX's (the routing,
  the capacity and the arrival-order slots); the combine tensor and the
  aux term within 2.4e-7 and 1e-6 (the two packages' ``exp`` differ in
  the last bit of some probabilities);
- ``MoEMLP`` in one process (f32, tokens dropped at capacity): the output,
  the pre-weighted aux and the gradients of ``sum(out * g) + aux`` (input,
  router, ``wi``, ``wo``) within 1e-5 of ``jax.grad``'s;
- expert parallelism over a 4-rank ``model`` axis (a 4-process gloo world,
  ``tests/torch_parallel_worker.py``, case ``moe``; ``tests/test_moe.py:
  66-87``'s layer): the output, aux and whole gradients alike on every rank
  and within 1e-5 of the unsharded JAX layer's, each rank's ``wi``/``wo``
  gradient rows within 1e-5 of the same rows of JAX's;
- ``Module`` folds the aux into the objective (``module.py:288-307``): two
  sgd steps of a MoE ``TransformerLM`` land within 1e-5 relative of the JAX
  ``Module``'s params, the router moved; the interchange carries the MoE
  leaves in and out unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt_tpu import data as jdata
from dt_tpu import models as jmodels
from dt_tpu.parallel.moe import MoEMLP as JMoEMLP
from dt_tpu.parallel.moe import switch_route as jswitch
from dt_tpu.training.module import Module as JModule
from dt_tpu_torch import models as tmodels
from dt_tpu_torch.data import io as tio
from dt_tpu_torch.interchange import export_jax_variables, load_jax_variables
from dt_tpu_torch.parallel.moe import MoEMLP, switch_route
from dt_tpu_torch.training.module import Module as TModule
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)
from torch_parallel_worker import SGD, flat, run_world, shifted_loss


def _leaves(tree) -> dict:
    return flat(jax.device_get(tree), "p")


@pytest.mark.parametrize("experts,capacity", [(2, 2), (4, 5), (8, 3)])
def test_switch_route_matches_jax(experts, capacity):
    rng = np.random.RandomState(experts)
    logits = (rng.normal(0, 2, (24, experts))).astype(np.float32)
    jd, jc, ja = (np.asarray(t) for t in jswitch(jnp.asarray(logits),
                                                 capacity))
    td, tc, ta = (t.numpy() for t in switch_route(torch.from_numpy(logits),
                                                  capacity))
    np.testing.assert_array_equal(td, jd)
    assert (tc[td == 0] == 0).all()
    np.testing.assert_allclose(tc, jc, rtol=0, atol=2.4e-7)
    np.testing.assert_allclose(ta, ja, rtol=1e-6)


def test_switch_route_capacity_and_order():
    """``tests/test_moe.py``'s routing oracle: 6 tokens, 2 experts,
    capacity 2: tokens 2 and 5 overflow expert 0 and are dropped."""
    logits = torch.tensor([[2.0, 0.0], [2.0, 0.0], [2.0, 0.0], [0.0, 2.0],
                           [0.0, 2.0], [2.0, 0.0]])
    d, c, aux = switch_route(logits, 2)
    assert d[0, 0, 0] == 1 and d[1, 0, 1] == 1
    assert d[2].sum() == 0 and d[5].sum() == 0
    assert d[3, 1, 0] == 1 and d[4, 1, 1] == 1
    assert 0.9 < float(aux) < 1.3


def _jax_layer(x, g, experts, ratio, cf):
    """The JAX layer's variables, output, aux and the gradients of
    ``sum(out * g) + aux`` (x, router kernel, wi, wo)."""
    layer = JMoEMLP(num_experts=experts, hidden_ratio=ratio,
                    capacity_factor=cf)
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def loss(p, xx):
        out, st = layer.apply({"params": p}, xx, mutable=["aux_loss"])
        aux = st["aux_loss"]["moe"][0]
        return jnp.sum(out * g) + aux, (out, aux)

    (_, (out, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    ref = {"out": out, "aux": aux, "dx": gx,
           "drouter": gp["router"]["kernel"], "dwi": gp["wi"],
           "dwo": gp["wo"]}
    return jax.device_get(params), {k: np.asarray(v) for k, v in ref.items()}


def _inputs(seed, shape):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape).astype(np.float32),
            rng.randn(*shape).astype(np.float32))


@pytest.fixture(scope="module")
def one_process_case():
    x, g = _inputs(0, (2, 8, 16))
    return x, g, _jax_layer(x, g, 4, 2, 1.25)


@pytest.mark.parametrize("key", ["out", "aux", "dx", "drouter", "dwi",
                                 "dwo"])
def test_moe_layer_matches_jax(one_process_case, key):
    x, g, (params, ref) = one_process_case
    layer = MoEMLP(16, 4, 2, 1.25)
    load_jax_variables(layer, {"params": params})
    xt = torch.from_numpy(x).requires_grad_()
    out = layer(xt)
    ((out * torch.from_numpy(g)).sum() + layer.aux_loss).backward()
    got = {"out": out.detach(), "aux": layer.aux_loss.detach(),
           "dx": xt.grad, "drouter": layer.router.weight.grad.t(),
           "dwi": layer.wi.grad, "dwo": layer.wo.grad}[key].numpy()
    np.testing.assert_allclose(got, ref[key], rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ep_case(tmp_path_factory):
    x, g = _inputs(1, (2, 16, 32))
    params, ref = _jax_layer(x, g, 4, 2, 2.0)
    inputs = dict(x=x, g=g, experts=np.int64(4), ratio=np.int64(2),
                  capacity_factor=np.float64(2.0), **flat(params, "init"))
    return run_world(str(tmp_path_factory.mktemp("moe")), "moe", inputs), ref


@pytest.mark.parametrize("key", ["out", "aux", "dx", "drouter", "dwi",
                                 "dwo"])
def test_moe_expert_parallel_matches_unsharded(ep_case, key):
    ranks, ref = ep_case
    if key in ("dwi", "dwo"):  # rank r holds expert r
        got = np.concatenate([r[key] for r in ranks])
    else:
        for r in ranks:
            np.testing.assert_array_equal(r[key], ranks[0][key])
        got = ranks[0][key]
    np.testing.assert_allclose(got, ref[key], rtol=1e-5, atol=1e-5)


LM = dict(vocab_size=16, embed_dim=16, num_layers=1, num_heads=2, max_len=8,
          moe_experts=2)


def test_moe_aux_loss_reaches_the_module_objective():
    """Two sgd steps of a MoE ``TransformerLM`` through ``Module.fit`` in
    both packages from the same weights: params within 1e-5 relative (the
    aux term's gradient included), the router moved."""
    toks = np.random.RandomState(3).randint(1, 16, (16, 8)).astype(np.int32)

    def jloss(logits, labels):
        from dt_tpu.ops import losses
        return losses.softmax_cross_entropy(
            logits[:, :-1].reshape(-1, 16), labels[:, 1:].reshape(-1))

    jmod = JModule(jmodels.TransformerLM(**LM), loss_fn=jloss,
                   optimizer="sgd", optimizer_params=SGD, seed=0)
    jmod.init_params(toks[:8])
    init = jax.device_get({"params": jmod.state.params})
    jmod.fit(jdata.NDArrayIter(toks, toks, batch_size=8), num_epoch=1)
    want = _leaves(jmod.state.params)

    model = tmodels.create("transformer_lm", device="cpu", **LM)
    tmod = TModule(model, loss_fn=shifted_loss, optimizer="sgd",
                   optimizer_params=SGD, device="cpu")
    tmod.init_params()
    load_jax_variables(model, init)
    before = model.block0.moe.router.weight.detach().clone()
    tmod.fit(tio.NDArrayIter(toks, toks, batch_size=8), num_epoch=1)
    assert not torch.equal(before, model.block0.moe.router.weight)
    got = _leaves(export_jax_variables(model)["params"])
    assert set(got) == set(want)
    for k, v in want.items():
        err = np.linalg.norm(got[k] - v) / max(np.linalg.norm(v), 1e-30)
        assert err <= 1e-5, (k, err)


def test_moe_leaves_round_trip_through_interchange():
    v = jmodels.TransformerLM(**LM).init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 8), jnp.int32),
        training=False)
    model = tmodels.create("transformer_lm", device="cpu", **LM)
    load_jax_variables(model, jax.device_get(v))
    assert tuple(model.block0.moe.wi.shape) == (2, 16, 64)
    got = _leaves(export_jax_variables(model)["params"])
    want = _leaves(v["params"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
