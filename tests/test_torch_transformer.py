"""The port's TransformerLM against the JAX package's, on the CPU.

Logits with ``seq_parallel=None`` (``full_attention``) and ``"flash"`` (JAX:
the Pallas kernel in interpret mode; port: the kernel's plain version), at
S = 128 and at S = 100, which pads to one 128 block; one step of
``bench.py``'s LM train step (``bench.py:593-600``: next-token loss, SGD
momentum 0.9, lr 0.1) in f32 and bf16; the flat vectors of both LMs in
``ravel_pytree``'s order, bit for bit; and the layer ops the model is made
of (LayerNorm, Embed, tanh GELU, dropout).  Weights are a seeded numpy fill
of the JAX tree, carried in with ``load_jax_variables``; tokens are seeded
numpy.

Tolerances: logits 2e-4 (f32 sums in another order through two layers);
the f32 step's loss 1e-5 relative, gradient, momentum and params 1e-4 of
their norm (GELU and softmax are smooth, so no mask flips as in the
ResNets); the bf16 step within 1.5x JAX's own bf16-vs-f32 distance from the
same state, plus an f32 floor (``tests/test_torch_train.py``'s rule).
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from dt_tpu import models as jmodels
from dt_tpu import optim as joptim
from dt_tpu.ops import losses as jlosses
from dt_tpu.ops import nn as jnn
from dt_tpu.training.train_state import TrainState as JaxState
from dt_tpu_torch import models as tmodels
from dt_tpu_torch import optim as toptim
from dt_tpu_torch.interchange import (export_jax_train_state,
                                      load_jax_train_state,
                                      load_jax_variables)
from dt_tpu_torch.models.common import Embed, LayerNorm
from dt_tpu_torch.ops import nn as tnn
from dt_tpu_torch.training.flat import FlatLayout
from dt_tpu_torch.training.step import (apply_step, grad_step,
                                        next_token_loss, train_step)
from dt_tpu_torch.training.train_state import TrainState
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

CFG = dict(vocab_size=64, embed_dim=32, num_layers=2, num_heads=2,
           max_len=256)
SGD = dict(learning_rate=0.1, momentum=0.9)
LOGITS = dict(rtol=2e-4, atol=2e-4)
F32 = dict(loss=1e-5, flat_g=1e-4, mom=1e-4, params=1e-4)
BF16_MARGIN = 1.5
# bf16 loss: the two sides round the logits to bf16 at other points (2**-8
# of each), which the mean over 254 positions averages down to ~1e-5; JAX's
# own bf16-vs-f32 loss distance is of the same size, so it is no bound here
BF16_LOSS = 1e-3


def _fill(shapes, seed=0):
    """Seeded weights by leaf name: LeCun-normal kernels, N(0, 1) embedding,
    N(0, 0.5) positions, LayerNorm scale near 1, small biases."""
    rng = np.random.RandomState(seed)

    def one(path, s):
        k = path[-1].key
        if k == "kernel":
            return (rng.normal(0, 1, s.shape)
                    / np.sqrt(s.shape[0])).astype(np.float32)
        if k in ("embedding", "pos_embed"):
            std = 1.0 if k == "embedding" else 0.5
            return rng.normal(0, std, s.shape).astype(np.float32)
        if k == "scale":
            return rng.uniform(0.8, 1.2, s.shape).astype(np.float32)
        return rng.normal(0, 0.1, s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


def _jax_lm(seq_parallel=None, dtype=jnp.float32, seq=128):
    model = jmodels.create("transformer_lm", seq_parallel=seq_parallel,
                           dtype=dtype, **CFG)
    params = _fill(jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, seq), jnp.int32),
        training=False)))["params"]
    if dtype == jnp.bfloat16:  # the JAX model makes pos_embed in bf16
        params["pos_embed"] = params["pos_embed"].astype(jnp.bfloat16)
    return model, params


def _tokens(seed, b, s):
    return np.random.RandomState(seed).randint(
        0, CFG["vocab_size"], (b, s)).astype(np.int32)


def _port(params, seq_parallel=None, dtype=torch.float32):
    return load_jax_variables(
        tmodels.create("transformer_lm", device="cpu",
                       seq_parallel=seq_parallel, dtype=dtype, **CFG),
        {"params": params})


@pytest.mark.parametrize("seq", [128, 100])
@pytest.mark.parametrize("seq_parallel", [None, "flash"])
def test_logits_match_jax(seq_parallel, seq):
    model, params = _jax_lm(seq_parallel, seq=seq)
    toks = _tokens(1, 2, seq)
    want = model.apply({"params": params}, jnp.asarray(toks), training=False)
    got = _port(params, seq_parallel)(torch.from_numpy(toks).long(),
                                      training=False)
    assert got.shape == (2, seq, CFG["vocab_size"])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **LOGITS)


def test_flash_and_full_attention_agree_in_the_port():
    _, params = _jax_lm()
    toks = torch.from_numpy(_tokens(2, 2, 100)).long()
    full = _port(params)(toks, training=False)
    flash = _port(params, "flash")(toks, training=False)
    np.testing.assert_allclose(flash.detach().numpy(), full.detach().numpy(),
                               **LOGITS)


_STEPS = {}


def _jax_step(seq_parallel, dtype):
    key = (seq_parallel, dtype)
    if key not in _STEPS:
        model = jmodels.create("transformer_lm", seq_parallel=seq_parallel,
                               dtype=dtype, **CFG)
        vocab = CFG["vocab_size"]

        def step(state, toks):
            def loss_of(params):
                logits = model.apply({"params": params}, toks,
                                     training=True)
                return jlosses.softmax_cross_entropy(
                    logits[:, :-1].reshape(-1, vocab),
                    toks[:, 1:].reshape(-1))
            loss, grads = jax.value_and_grad(loss_of)(state.params)
            return state.apply_gradients(grads), loss, ravel_pytree(grads)[0]

        _STEPS[key] = jax.jit(step)
    return _STEPS[key]


def _snapshot(js):
    return {"step": js.step, "params": js.params, "batch_stats": {},
            "opt_state": flax.serialization.to_state_dict(js.opt_state)}


def _flat(js, flat_g, loss):
    return {"loss": float(loss), "flat_g": np.asarray(flat_g, np.float32),
            "params": np.asarray(ravel_pytree(js.params)[0], np.float32),
            "mom": np.asarray(ravel_pytree(js.opt_state.mom)[0])}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("seq_parallel,dtype", [
    (None, "float32"), ("flash", "float32"), ("flash", "bfloat16")])
def test_train_step_matches_bench_lm_step(seq_parallel, dtype):
    """Two steps from the same state (the port set to the JAX state before
    each): loss, flat gradient, params and momentum."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    _, params = _jax_lm(seq_parallel, jdt)
    tx = joptim.create("sgd", **SGD)
    js = JaxState.create(None, params, tx, {})
    port = _port(params, seq_parallel, tdt)
    assert port.pos_embed.dtype == tdt
    ts = TrainState.create(port, toptim.create("sgd", **SGD))
    toks = _tokens(3, 2, 128)
    for step in range(2):
        load_jax_train_state(ts, _snapshot(js))
        before = js
        js, loss, flat_g = _jax_step(seq_parallel, jdt)(js,
                                                        jnp.asarray(toks))
        want = _flat(js, flat_g, loss)
        fg, _, loss_t, logits = grad_step(ts, torch.from_numpy(toks).long(),
                                          None, next_token_loss)
        assert logits.dtype == tdt
        apply_step(ts, fg, torch.zeros(0))
        assert ts.step == int(js.step) == step + 1
        assert port.pos_embed.dtype == tdt
        lay = ts.layout
        got = {"loss": float(loss_t), "flat_g": fg.numpy(),
               "params": lay.params.ravel(ts.params).numpy(),
               "mom": lay.params.ravel(ts.opt_state["mom"]).numpy()}
        if dtype == "float32":
            np.testing.assert_allclose(got["loss"], want["loss"],
                                       rtol=F32["loss"])
            bound = F32
        else:  # JAX's own f32 step from the same state calibrates bf16
            params32 = jax.tree_util.tree_map(
                lambda p: p.astype(jnp.float32), before.params)
            js32 = JaxState.create(None, params32, tx, {}).replace(
                step=before.step, opt_state=before.opt_state)
            js32, loss32, fg32 = _jax_step(seq_parallel, jnp.float32)(
                js32, jnp.asarray(toks))
            ref = _flat(js32, fg32, loss32)
            np.testing.assert_allclose(
                got["loss"], want["loss"], rtol=BF16_LOSS,
                atol=BF16_MARGIN * abs(ref["loss"] - want["loss"]))
            bound = {k: BF16_MARGIN * _rel(ref[k], want[k]) + 1e-6
                     for k in want}
        for k in ("flat_g", "params", "mom"):
            err = _rel(got[k], want[k])
            assert err <= bound[k], (step, k, err, bound[k])


def test_train_step_entry_point_and_state_round_trip():
    """``train_step`` with the LM loss equals ``grad_step`` +
    ``apply_step``; the train state round-trips through the JAX form with
    the bf16 ``pos_embed`` kept bf16."""
    _, params = _jax_lm("flash", jnp.bfloat16)
    toks = torch.from_numpy(_tokens(4, 2, 128)).long()
    states = []
    for _ in range(2):
        port = _port(params, "flash", torch.bfloat16)
        states.append(TrainState.create(port, toptim.create("sgd", **SGD)))
    a, b = states
    train_step(a, toks, None, loss_fn=next_token_loss)
    snap = export_jax_train_state(a)
    assert snap["params"]["pos_embed"].dtype == torch.bfloat16
    assert snap["opt_state"]["mom"]["pos_embed"].dtype == np.float32
    load_jax_train_state(b, snap)
    for (n, x), (_, y) in zip(a.module.named_parameters(),
                              b.module.named_parameters()):
        assert x.dtype == y.dtype and torch.equal(x, y), n
    assert b.step == 1


@pytest.mark.parametrize("name", ["transformer_lm", "lstm_lm"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_order_is_ravel_pytree(name, dtype):
    """Params and a gradient-shaped tree raveled by the port equal
    ``ravel_pytree`` of the JAX trees bit for bit (bf16 leaves promoted to
    f32 exactly); unravel inverts it."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    kw = CFG if name == "transformer_lm" else dict(
        vocab_size=40, embed_dim=12, hidden=12, num_layers=3)
    jm = jmodels.create(name, dtype=jdt, **kw)
    toks = jnp.zeros((2, 16), jnp.int32)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, toks, training=False))["params"]
    trees = [jax.tree_util.tree_map(
        lambda s, v: v.astype(s.dtype), shapes, _fill(shapes, seed))
        for seed in (5, 6)]
    port = tmodels.create(name, device="cpu", dtype=getattr(torch, dtype),
                          **kw)
    lay = FlatLayout(port)
    for tree in trees:
        load_jax_variables(port, {"params": tree})
        named = dict(port.named_parameters())
        got = lay.params.ravel(named)
        want = np.asarray(ravel_pytree(tree)[0], np.float32)
        np.testing.assert_array_equal(got.numpy(), want)
        for k, t in lay.params.unravel(got).items():
            assert torch.equal(t.to(named[k].dtype), named[k].detach())


def test_layer_ops_match_linen():
    import flax.linen as linen
    rng = np.random.RandomState(7)
    x = rng.normal(1.0, 2.0, (3, 5, 16)).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 16).astype(np.float32)
    bias = rng.normal(0, 0.1, 16).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        ln = linen.LayerNorm(dtype=jdt)
        want = ln.apply({"params": {"scale": scale, "bias": bias}},
                        jnp.asarray(x, jdt))
        mod = LayerNorm(16)
        mod.scale.data = torch.from_numpy(scale)
        mod.bias.data = torch.from_numpy(bias)
        got = mod(torch.from_numpy(x).to(tdt))
        assert got.dtype == tdt
        # bf16: one ulp (2**-7 relative), as the two round at other points
        tol = 1e-5 if tdt == torch.float32 else 2.0 ** -7
        np.testing.assert_allclose(got.float().detach().numpy(),
                                   np.asarray(want, np.float32), rtol=tol,
                                   atol=tol)
        gelu = tnn.activation(torch.from_numpy(x).to(tdt), "gelu")
        np.testing.assert_allclose(
            gelu.float().numpy(),
            np.asarray(jnn.activation(jnp.asarray(x, jdt), "gelu"),
                       np.float32), rtol=tol, atol=tol)
    table = rng.normal(0, 1, (10, 4)).astype(np.float32)
    ids = np.array([[3, 0, 9], [1, 1, 2]], np.int32)
    emb = Embed(10, 4, torch.bfloat16)
    emb.embedding.data = torch.from_numpy(table)
    want = linen.Embed(10, 4, dtype=jnp.bfloat16).apply(
        {"params": {"embedding": table}}, jnp.asarray(ids))
    got = emb(torch.from_numpy(ids).long())
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want, np.float32))


def test_dropout_keep_rate_and_scale():
    x = torch.ones(200, 500)
    g = torch.Generator().manual_seed(0)
    y = tnn.dropout(x, 0.2, training=True, generator=g)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.8) < 0.01
    assert torch.equal(y[kept], torch.full_like(y[kept], 1 / 0.8))
    assert tnn.dropout(x, 0.2, training=False) is x
    with pytest.raises(ValueError, match="Generator"):
        tnn.dropout(x, 0.2, training=True)


@pytest.mark.parametrize("kw", [dict(seq_parallel="ring"),
                                dict(seq_parallel="ulysses"),
                                dict(moe_experts=2), dict(remat=True)])
def test_later_slices_raise(kw):
    with pytest.raises(NotImplementedError, match="slice 8"):
        tmodels.create("transformer_lm", device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="slice 8"):
        tmodels.create("transformer_lm_pipelined", device="cpu")


def test_create_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("has a CUDA device; the no-GPU refusal is checked "
                    "where there is none")
    for name in ("transformer_lm", "lstm_lm"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tmodels.create(name)
