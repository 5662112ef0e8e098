"""The port's initializers against the JAX package's, on the CPU.

The two draw from different generators (``jax.random`` against a
``torch.Generator``), so they are held by distribution: shapes and dtypes
equal, values that draw nothing (zeros, ones, constants, bilinear) equal,
and for every drawn tensor of 64 or more values a two-sample
Kolmogorov-Smirnov test of the port's values against the JAX package's
must not reject at ``ALPHA`` (seeds are fixed, so the outcome is too).
The same holds for each ported model's default initialization
(``models.init_params``) against flax's ``Module.init``, leaf by leaf.
"""

import flax.linen as linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from dt_tpu import initializer as JI
from dt_tpu import models as jmodels
from dt_tpu_torch import initializer as TI
from dt_tpu_torch import models as tmodels
from dt_tpu_torch.interchange import export_jax_variables
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

ALPHA = 1e-3  # KS rejection level of one comparison
SHAPE = (3, 3, 16, 32)  # HWIO, 4608 values


def _same_dist(a: np.ndarray, b: np.ndarray, what: str) -> None:
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    assert a.shape == b.shape, what
    if np.ptp(a) == 0 and np.ptp(b) == 0:
        np.testing.assert_array_equal(a, b, err_msg=what)
        return
    p = stats.ks_2samp(a, b).pvalue
    assert p > ALPHA, f"{what}: KS p = {p:.2e}, mean {a.mean():.4g} vs " \
                      f"{b.mean():.4g}, std {a.std():.4g} vs {b.std():.4g}"


_CASES = [("zeros", {}), ("ones", {}), ("constant", {"value": 0.3}),
          ("uniform", {}), ("uniform", {"scale": 0.5}), ("normal", {}),
          ("normal", {"sigma": 2.0}), ("orthogonal", {}),
          ("xavier", {}), ("xavier", {"rnd_type": "gaussian",
                                      "factor_type": "in"}),
          ("xavier", {"factor_type": "out", "magnitude": 2.0}),
          ("msra_prelu", {}), ("bilinear", {})]


@pytest.mark.parametrize("name,kw", _CASES)
def test_initializer_matches_by_distribution(name, kw):
    want = np.asarray(JI.create(name, **kw)(jax.random.PRNGKey(1), SHAPE))
    got = TI.create(name, **kw)(torch.Generator().manual_seed(1), SHAPE)
    assert tuple(got.shape) == SHAPE and got.dtype == torch.float32
    _same_dist(got.numpy(), want, name)
    if name in ("zeros", "ones", "constant", "bilinear"):
        np.testing.assert_array_equal(got.numpy(), want)
    if name == "orthogonal":  # columns orthogonal with norm 1.414
        m = got.numpy().reshape(-1, SHAPE[-1])
        np.testing.assert_allclose(m.T @ m, 1.414 ** 2 * np.eye(SHAPE[-1]),
                                   atol=1e-4)
    assert got.to(torch.bfloat16).dtype == torch.bfloat16


def test_flax_defaults_match_by_distribution():
    """The defaults ``models.init_params`` draws with: lecun-normal
    (truncated) and the Embed default, against flax's."""
    gen = torch.Generator().manual_seed(2)
    _same_dist(TI.lecun_normal()(gen, SHAPE).numpy(),
               linen.initializers.lecun_normal()(jax.random.PRNGKey(2),
                                                 SHAPE), "lecun_normal")
    _same_dist(TI.embed_normal()(gen, (300, 24)).numpy(),
               linen.linear.default_embed_init(jax.random.PRNGKey(3),
                                               (300, 24)), "embed")
    mixed = TI.mixed(["bias$", ".*"], [TI.zeros(), TI.ones()])
    assert float(mixed("a/bias", gen, (3,)).sum()) == 0
    assert float(mixed("a/kernel", gen, (3,)).sum()) == 3
    with pytest.raises(ValueError, match="unknown initializer"):
        TI.create("he")


_MODELS = [
    ("mlp", dict(num_classes=10), (2, 8, 8, 1), dict(in_shape=(8, 8, 1))),
    ("lenet", dict(num_classes=10), (2, 8, 8, 1), dict(in_shape=(8, 8, 1))),
    ("resnet20", dict(num_classes=10), (2, 8, 8, 3), {}),
    ("lstm_lm", dict(vocab_size=300, embed_dim=24, hidden=24,
                     num_layers=2), (5, 3), {}),
    ("transformer_lm", dict(vocab_size=300, embed_dim=32, num_layers=1,
                            num_heads=2, max_len=64), (2, 16), {}),
]


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v, np.float32)


@pytest.mark.parametrize("name,kw,shape,port_kw",
                         _MODELS, ids=[m[0] for m in _MODELS])
def test_model_default_init_matches_flax(name, kw, shape, port_kw):
    """Every leaf of the port's default init against the JAX model's
    ``init``: same names and shapes, zeros/ones equal, drawn leaves alike
    by KS; BN stats mean 0, var 1."""
    x = jnp.zeros(shape, jnp.int32 if len(shape) == 2 else jnp.float32)
    jvars = jmodels.create(name, **kw).init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        x, training=False)
    port = tmodels.init_params(
        tmodels.create(name, device="cpu", **kw, **port_kw), seed=0)
    got = export_jax_variables(port)
    for coll in ("params", "batch_stats"):
        want = dict(_leaves(jax.device_get(jvars.get(coll, {}))))
        have = dict(_leaves(got[coll]))
        assert sorted(have) == sorted(want), coll
        for path, w in want.items():
            assert have[path].shape == w.shape, path
            _same_dist(have[path], w, f"{name} {'/'.join(path)}")
