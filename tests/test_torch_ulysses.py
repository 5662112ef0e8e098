"""The port's Ulysses attention against ``dt_tpu``'s, on the CPU.

As ``tests/test_torch_ring_attention.py`` (its helpers), for
``seq_parallel="ulysses"``: the attention over a 4-rank ``model`` axis,
causal and not (output within 1e-5, ``q``/``k``/``v`` gradients within
1e-4 of JAX's), the ``TransformerLM`` fit with ``remat=True`` over a data 2
x model 2 mesh (params within 1e-4 relative of the JAX ``Module``'s), and
the error when the heads do not divide the axis.
"""

import numpy as np
import pytest
import torch

from dt_tpu.parallel.ulysses import ulysses_attention as julysses
from dt_tpu_torch.parallel import mesh as tmesh
from dt_tpu_torch.parallel.ring_attention import full_attention
from dt_tpu_torch.parallel.ulysses import ulysses_attention
from test_torch_ring_attention import (attention_inputs, check_attention,
                                       check_fit, parallel_case)
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def ulysses_case(tmp_path_factory):
    return parallel_case(tmp_path_factory.mktemp("ulysses"), "ulysses",
                         julysses, 10)


@pytest.mark.parametrize("key", [f"{t}/{w}" for t in ("full", "causal")
                                 for w in ("out", "dq", "dk", "dv")])
def test_ulysses_attention_matches_jax(ulysses_case, key):
    ranks, ref, _ = ulysses_case
    check_attention(ranks, ref, key)


def test_ulysses_lm_fit_on_data_x_model_mesh_matches_jax(ulysses_case):
    ranks, _, trained = ulysses_case
    check_fit(ranks, trained)


def test_ulysses_of_one_rank_is_full_attention():
    d = attention_inputs(11)
    q, k, v = (torch.from_numpy(d[n]) for n in "qkv")
    mesh = tmesh.make_mesh(devices=["cpu"])
    for causal in (False, True):
        got = ulysses_attention(q, k, v, mesh, axis_name="model",
                                causal=causal)
        np.testing.assert_array_equal(
            got.numpy(), full_attention(q, k, v, causal=causal).numpy())


def test_ulysses_heads_must_divide_the_axis():
    """The JAX package's text, for 3 heads over an axis of 2."""
    mesh = tmesh.Mesh(0, 1, None, "cpu", model=2)
    q = torch.zeros(1, 4, 3, 8)
    with pytest.raises(ValueError, match=r"num_heads 3 must divide by axis "
                       r"size 2 for ulysses; use ring_attention"):
        ulysses_attention(q, q, q, mesh, axis_name="model")
