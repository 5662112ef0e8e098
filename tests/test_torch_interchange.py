"""Layout of carried variables by leaf name (``dt_tpu_torch.interchange``).

Only a JAX leaf named ``kernel`` changes layout (conv HWIO <-> OIHW, dense
``(in, out)`` <-> ``(out, in)``); an ``embedding``, a ``pos_embed`` and the
LSTM's ``l<i>_wx``/``l<i>_wh``, 2-D too, copy as they are, and a bf16 leaf
stays bf16.  The ResNet layouts of the earlier slices are unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt_tpu import models as jmodels
from dt_tpu_torch import models as tmodels
from dt_tpu_torch.interchange import (export_jax_variables, from_jax_layout,
                                      load_jax_variables, to_jax_layout)
from dt_tpu_torch.training.flat import FlatLayout
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)


def _seeded(shapes, seed=0):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda s: rng.normal(0, 1, s.shape).astype(np.float32), shapes)


def _shapes(model, x):
    return jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, x, training=False))


@pytest.mark.parametrize("name,kw,x", [
    ("transformer_lm", dict(vocab_size=30, embed_dim=16, num_layers=1,
                            num_heads=2, max_len=40),
     np.zeros((2, 8), np.int32)),
    ("lstm_lm", dict(vocab_size=30, embed_dim=6, hidden=10, num_layers=2),
     np.zeros((4, 2), np.int32))])
def test_lm_leaves_round_trip_untransposed(name, kw, x):
    variables = _seeded(_shapes(jmodels.create(name, **kw), x))
    port = load_jax_variables(tmodels.create(name, device="cpu", **kw),
                              variables)
    named = dict(port.named_parameters())
    params = variables["params"]
    np.testing.assert_array_equal(named["embed.embedding"].detach().numpy(),
                                  params["embed"]["embedding"])
    if name == "transformer_lm":
        np.testing.assert_array_equal(named["pos_embed"].detach().numpy(),
                                      params["pos_embed"])
        np.testing.assert_array_equal(  # a dense kernel is transposed
            named["lm_head.weight"].detach().numpy(),
            params["lm_head"]["kernel"].T)
    else:
        for leaf in ("l0_wx", "l0_wh", "l1_wx", "l0_b"):
            np.testing.assert_array_equal(named[leaf].detach().numpy(),
                                          params[leaf])
        assert named["l0_wx"].shape == (6, 40)
    back = export_jax_variables(port)["params"]
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


def test_bf16_leaf_keeps_its_dtype():
    """The bf16 TransformerLM's ``pos_embed`` comes in from the JAX arrays'
    numpy bfloat16, stays a bf16 parameter, goes out as a bf16 tensor, and
    ravels to f32 exactly."""
    kw = dict(vocab_size=30, embed_dim=16, num_layers=1, num_heads=2,
              max_len=40)
    jm = jmodels.create("transformer_lm", dtype=jnp.bfloat16, **kw)
    shapes = _shapes(jm, np.zeros((2, 8), np.int32))
    assert shapes["params"]["pos_embed"].dtype == jnp.bfloat16
    variables = _seeded(shapes)
    pos = np.asarray(jnp.asarray(variables["params"]["pos_embed"],
                                 jnp.bfloat16))
    variables["params"]["pos_embed"] = pos
    port = load_jax_variables(
        tmodels.create("transformer_lm", device="cpu", dtype=torch.bfloat16,
                       **kw), variables)
    assert port.pos_embed.dtype == torch.bfloat16
    assert port.embed.embedding.dtype == torch.float32
    np.testing.assert_array_equal(port.pos_embed.detach().float().numpy(),
                                  pos.astype(np.float32))
    out = export_jax_variables(port)["params"]["pos_embed"]
    assert isinstance(out, torch.Tensor) and out.dtype == torch.bfloat16
    assert torch.equal(out, port.pos_embed.detach())
    out[0, 0] = 7.0  # a copy, not the live parameter
    assert port.pos_embed[0, 0] != 7.0
    lay = FlatLayout(port)
    flat = lay.params.ravel(dict(port.named_parameters()))
    start, stop = lay.params.span("pos_embed")
    np.testing.assert_array_equal(flat[start:stop].numpy(),
                                  pos.astype(np.float32).ravel())


def test_resnet_layouts_unchanged():
    """Conv and dense kernels still change layout; BN leaves do not."""
    conv = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).view(2, 3, 4, 5)
    assert to_jax_layout(conv, "kernel").shape == (4, 5, 3, 2)
    assert torch.equal(from_jax_layout(to_jax_layout(conv, "kernel"),
                                       "kernel"), conv)
    dense = torch.arange(6, dtype=torch.float32).view(2, 3)
    assert torch.equal(to_jax_layout(dense, "kernel"), dense.t())
    for leaf in ("scale", "bias", "mean", "var", "embedding", "l0_wx"):
        assert to_jax_layout(dense, leaf) is dense
        assert from_jax_layout(dense, leaf) is dense
    x = np.zeros((1, 32, 32, 3), np.float32)
    variables = _seeded(_shapes(jmodels.create("resnet20", num_classes=10),
                                x), seed=1)
    port = load_jax_variables(tmodels.create("resnet20", device="cpu",
                                             num_classes=10), variables)
    named = dict(port.named_parameters())
    np.testing.assert_array_equal(
        named["Conv_0.weight"].detach().numpy(),
        variables["params"]["Conv_0"]["kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        named["Dense_0.weight"].detach().numpy(),
        variables["params"]["Dense_0"]["kernel"].T)
