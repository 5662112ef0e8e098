"""The port's public test fixtures (``dt_tpu_torch/test_utils.py``)
against the JAX package's ``test_utils``: the same tolerances by dtype,
the same draws from the same ``rng``, the same verdicts, and the numeric
gradient check passing on the same function in both packages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt_tpu import test_utils as jtu
from dt_tpu_torch import test_utils as ttu
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)


def test_tolerances_and_verdicts_match():
    for dts in (("float32",), ("bfloat16",), ("float16", "float64"),
                ("float32", "bfloat16")):
        assert ttu.default_rtol_atol(*dts) == jtu.default_rtol_atol(*dts)
    assert ttu.default_rtol_atol(torch.bfloat16) == \
        jtu.default_rtol_atol("bfloat16")
    a = np.linspace(-1, 1, 12, dtype=np.float32)
    ttu.assert_almost_equal(torch.from_numpy(a), a + 1e-7)
    jtu.assert_almost_equal(a, a + 1e-7)
    for mod in (ttu, jtu):
        with pytest.raises(AssertionError):
            mod.assert_almost_equal(a, a + 0.1)
    # a bf16 tensor compares at bf16's tolerance
    ttu.assert_almost_equal(torch.from_numpy(a).bfloat16(), a)


def test_draws_are_the_jax_packages():
    for stype in ("default", "row_sparse", "csr"):
        t = ttu.rand_ndarray((6, 3), stype, density=0.5,
                             rng=np.random.RandomState(4))
        j = jtu.rand_ndarray((6, 3), stype, density=0.5,
                             rng=np.random.RandomState(4))
        if stype == "default":
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            np.testing.assert_array_equal(t.to_dense().numpy(),
                                          np.asarray(j.to_dense()))
    csr = ttu.rand_ndarray((4, 4), "csr", rng=np.random.RandomState(0))
    assert csr.nse == int(np.count_nonzero(csr.to_dense().numpy()))


def test_gradient_and_consistency_checks():
    x = np.random.RandomState(2).uniform(-1, 1, (3, 4)).astype(np.float32)
    w = np.random.RandomState(3).uniform(-1, 1, (4, 2)).astype(np.float32)
    ttu.check_numeric_gradient(lambda a, b: torch.tanh(a @ b), [x, w])
    jtu.check_numeric_gradient(lambda a, b: jnp.tanh(a @ b), [x, w])
    with pytest.raises(AssertionError):
        ttu.check_numeric_gradient(
            lambda a, b: WrongGrad.apply(a @ b), [x, w])
    t = ttu.check_consistency(lambda a, b: torch.tanh(a @ b), [x, w])
    j = jtu.check_consistency(lambda a, b: jnp.tanh(a @ b), [x, w])
    for k in ("float32", "bfloat16"):
        ttu.assert_almost_equal(t[k], j[k], *ttu.default_rtol_atol(k))


class WrongGrad(torch.autograd.Function):
    """``tanh`` with a gradient off by a factor of two."""

    @staticmethod
    def forward(ctx, v):
        y = torch.tanh(v)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return 2 * g * (1 - y * y)


@ttu.with_seed(7)
def _seeded():
    return np.random.rand(), torch.rand(1).item()


def test_with_seed_reproduces():
    assert _seeded() == _seeded()
