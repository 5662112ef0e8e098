"""The port's ring attention against ``dt_tpu``'s, on the CPU.

A 4-process gloo world (``tests/torch_parallel_worker.py``, case ``ring``)
against JAX on the 8-device CPU mesh of this process, inputs and weights
from a numpy seed:

- ``ring_attention`` over a 4-rank ``model`` axis, causal and not: the
  output within 1e-5 and the ``q``/``k``/``v`` gradients of ``sum(out *
  g)`` within 1e-4 of JAX's ``ring_attention`` and ``jax.grad`` (f32; the
  two sum the blocks in different orders);
- ``fit`` of a ``TransformerLM(seq_parallel="ring", remat=True)`` over a
  data 2 x model 2 mesh (one block: the JAX compile dominates the file's
  time), 2 sgd steps of a global batch of 8: every param
  within 1e-4 relative of the JAX ``Module`` on the same 2 x 2 mesh
  (``tests/test_transformer_ulysses.py:142``'s composition with sgd and
  ``grad_accum`` 1);
- the single-device ``full_attention`` and the errors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt_tpu import data as jdata
from dt_tpu import models as jmodels
from dt_tpu.ops import losses as jlosses
from dt_tpu.parallel import mesh as jmesh
from dt_tpu.parallel.ring_attention import full_attention as jfull
from dt_tpu.parallel.ring_attention import ring_attention as jring
from dt_tpu.training.module import Module as JModule
from dt_tpu_torch.parallel import mesh as tmesh
from dt_tpu_torch.parallel.ring_attention import full_attention, \
    ring_attention
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)
from torch_parallel_worker import SGD, flat, run_world

#: the LM of the composition test, cut to a CPU's size
LM = dict(vocab_size=64, embed_dim=32, num_layers=1, num_heads=8, max_len=32)
BATCH, STEPS, SEQ = 8, 2, 32


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def attention_inputs(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    return {n: rng.normal(0, 1, (2, 32, 4, 8)).astype(np.float32)
            for n in ("q", "k", "v", "g")}


def jax_attention(fn, d, mesh_axis: str) -> dict:
    """JAX's outputs and gradients of ``sum(fn(q, k, v) * g)`` on a
    4-device mesh whose second axis is ``mesh_axis``."""
    mesh = jmesh.make_mesh(data=1, model=4, devices=jax.devices()[:4])
    ref = {}
    for causal in (False, True):
        def loss(q, k, v):
            o = fn(q, k, v, mesh, axis_name=mesh_axis, causal=causal)
            return jnp.sum(o * d["g"]), o
        (_, o), (dq, dk, dv) = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(
            *(jnp.asarray(d[n]) for n in ("q", "k", "v")))
        tag = "causal" if causal else "full"
        ref.update({f"{tag}/out": o, f"{tag}/dq": dq, f"{tag}/dk": dk,
                    f"{tag}/dv": dv})
    return {k: np.asarray(v) for k, v in ref.items()}


def lm_inputs(seed: int) -> np.ndarray:
    """The composition's tokens: a repeated token over the first half of
    each row (the JAX test's copy task), random ones after it."""
    rng = np.random.RandomState(seed)
    base = rng.randint(0, LM["vocab_size"], (BATCH * STEPS, 1))
    toks = np.repeat(base, SEQ, axis=1).astype(np.int32)
    toks[:, SEQ // 2:] = rng.randint(0, LM["vocab_size"],
                                     (BATCH * STEPS, SEQ - SEQ // 2))
    return toks


def jax_fit(kind: str, toks):
    """The JAX Module's params after ``fit`` over a data 2 x model 2 mesh,
    and its initial variables."""
    mesh = jmesh.make_mesh(data=2, model=2, devices=jax.devices()[:4])
    model = jmodels.TransformerLM(seq_parallel=kind, mesh=mesh,
                                  axis_name="model", remat=True, **LM)

    def lm_loss(logits, labels):
        return jlosses.softmax_cross_entropy(
            logits[:, :-1].reshape(-1, LM["vocab_size"]),
            labels[:, 1:].reshape(-1))

    mod = JModule(model, loss_fn=lm_loss, optimizer="sgd",
                  optimizer_params=SGD, mesh=mesh, seed=3)
    mod.init_params(toks[:BATCH])
    init = jax.device_get(mod.state.params)
    mod.fit(jdata.NDArrayIter(toks, toks, batch_size=BATCH), num_epoch=1,
            eval_metric="ce")
    return init, jax.device_get(mod.state.params)


def parallel_case(tmp, kind: str, jfn, seed: int):
    """The world's results and the JAX references of one scheme."""
    d = attention_inputs(seed)
    toks = lm_inputs(seed + 1)
    init, trained = jax_fit(kind, toks)
    inputs = dict(d, x=toks, y=toks, batch=np.int64(BATCH),
                  **flat(init, "init"),
                  **{f"cfg/{k}": np.int64(v) for k, v in LM.items()})
    ranks = run_world(str(tmp), kind, inputs)
    return ranks, jax_attention(jfn, d, "model"), flat(trained, "params")


@pytest.fixture(scope="module")
def ring_case(tmp_path_factory):
    return parallel_case(tmp_path_factory.mktemp("ring"), "ring", jring, 0)


def check_attention(ranks, ref, key):
    tol = 1e-5 if key.endswith("/out") else 1e-4
    for r in ranks:  # whole and alike on every rank
        np.testing.assert_array_equal(r[key], ranks[0][key])
    err = float(np.abs(ranks[0][key] - ref[key]).max())
    assert err <= tol * max(1.0, float(np.abs(ref[key]).max())), (key, err)


def check_fit(ranks, trained):
    for key, want in trained.items():
        for r in ranks:
            assert _rel(r[key], want) <= 1e-4, (key, _rel(r[key], want))


@pytest.mark.parametrize("key", [f"{t}/{w}" for t in ("full", "causal")
                                 for w in ("out", "dq", "dk", "dv")])
def test_ring_attention_matches_jax(ring_case, key):
    ranks, ref, _ = ring_case
    check_attention(ranks, ref, key)


def test_ring_lm_fit_on_data_x_model_mesh_matches_jax(ring_case):
    ranks, _, trained = ring_case
    check_fit(ranks, trained)


@pytest.mark.parametrize("causal", [False, True])
def test_full_attention_matches_jax(causal):
    d = attention_inputs(5)
    want = np.asarray(jfull(*(jnp.asarray(d[n]) for n in "qkv"),
                            causal=causal))
    got = full_attention(*(torch.from_numpy(d[n]) for n in "qkv"),
                         causal=causal).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_ring_of_one_rank_is_full_attention():
    """A mesh of one process: the ring is one block, equal to the oracle
    within 1e-6 (its streaming merge, not a softmax)."""
    d = attention_inputs(6)
    q, k, v = (torch.from_numpy(d[n]) for n in "qkv")
    mesh = tmesh.make_mesh(devices=["cpu"], axis_names=("data", "model"))
    for causal in (False, True):
        got = ring_attention(q, k, v, mesh, axis_name="model", causal=causal)
        want = full_attention(q, k, v, causal=causal)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_ring_errors():
    mesh = tmesh.make_mesh(devices=["cpu"])
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="not 'pipe'"):
        ring_attention(q, q, q, mesh, axis_name="pipe")
    from dt_tpu_torch import models
    with pytest.raises(ValueError, match="needs a mesh"):
        models.create("transformer_lm", device="cpu", seq_parallel="ring")
    with pytest.raises(ValueError, match="seq_parallel='rings'"):
        models.create("transformer_lm", device="cpu", seq_parallel="rings")
