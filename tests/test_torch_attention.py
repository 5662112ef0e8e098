"""The port's attention against the JAX package's, on the CPU.

``flash_attention_plain`` (the kernel's plain version) and the port's
differentiable ``flash_attention`` against the JAX ``_flash_fwd_pallas``
(Pallas in interpret mode, as ``tests/test_flash_attention.py`` runs it) and
``flash_attention``, and the port's ``full_attention`` against the JAX
oracle.  Inputs are seeded numpy, handed to both sides.  Tolerances:

- f32 outputs rtol 2e-4 / atol 2e-5, the JAX package's own flash-vs-oracle
  bound (``tests/test_flash_attention.py:27-28``): f32 sums in another
  order;
- lse 1e-5 (absolute; it is ~log S);
- dq/dk/dv 5e-4 (the JAX package's backward bound);
- bf16: both sides upcast to f32, accumulate in f32 and round to bf16 once,
  so outputs differ by at most one bf16 ulp where the f32 sums straddle a
  rounding boundary: 2**-7 of the largest |value|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt_tpu.ops.pallas.attention import _flash_fwd_pallas
from dt_tpu.ops.pallas.attention import flash_attention as jflash
from dt_tpu.parallel.ring_attention import full_attention as jfull
from dt_tpu_torch.ops import attention as TA
from dt_tpu_torch.parallel.ring_attention import full_attention

F32 = dict(rtol=2e-4, atol=2e-5)
LSE = 1e-5
GRAD = dict(rtol=5e-4, atol=5e-4)
BF16_ULP = 2.0 ** -7


def _qkv(seed, b=2, s=256, h=2, d=32):
    rng = np.random.RandomState(seed)
    return [(rng.randn(b, s, h, d) * 0.5).astype(np.float32)
            for _ in range(3)]


def _to3(x):
    b, s, h, d = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3)).reshape(b * h, s, d)


def _bf16_close(got, want):
    got, want = (np.asarray(t, np.float32) for t in (got, want))
    bound = BF16_ULP * float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= bound


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s,block", [(256, 128), (512, 128), (256, 64)])
def test_plain_matches_pallas_forward(causal, s, block):
    """Out and lse of the plain version against the Pallas kernel, several
    kv blocks per q block."""
    q, k, v = (_to3(t) for t in _qkv(0, s=s))
    want_o, want_lse = _flash_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=32 ** -0.5,
        causal=causal, block_q=block, block_k=block, interpret=True)
    got_o, got_lse = TA.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=32 ** -0.5, causal=causal, block_q=block, block_k=block)
    assert got_o.dtype == torch.float32 and got_lse.shape == (4, s)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **F32)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=0, atol=LSE)


def test_plain_matches_pallas_forward_bf16():
    q, k, v = (_to3(t) for t in _qkv(1, s=256))
    jq, jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    want_o, want_lse = _flash_fwd_pallas(jq, jk, jv, scale=32 ** -0.5,
                                         causal=True, block_q=128,
                                         block_k=128, interpret=True)
    tq, tk, tv = (torch.from_numpy(np.asarray(t, np.float32))
                  .to(torch.bfloat16) for t in (jq, jk, jv))
    got_o, got_lse = TA.flash_attention_plain(tq, tk, tv, scale=32 ** -0.5,
                                              causal=True)
    assert got_o.dtype == torch.bfloat16
    _bf16_close(got_o.float().numpy(), want_o)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=0, atol=LSE)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_forward_and_grads_match_jax(causal):
    """The port's flash_attention (CPU: the plain forward, the blockwise
    backward) against the JAX flash_attention, values and dq/dk/dv of
    sum(o * o), and against the port's full_attention."""
    q, k, v = _qkv(2, b=1, s=256, h=2, d=32)

    def jloss(q, k, v):
        o = jflash(q, k, v, causal=causal, block_q=128, block_k=128)
        return (o * o).sum(), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                     has_aux=True)(
        *(jnp.asarray(t) for t in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    before = TA.flash_fwd.launches
    to = TA.flash_attention(tq, tk, tv, causal=causal)
    assert TA.flash_fwd.launches == before  # CPU: the plain version
    tg = torch.autograd.grad((to * to).sum(), (tq, tk, tv))
    np.testing.assert_allclose(to.detach().numpy(), np.asarray(jo), **F32)
    for name, a, b in zip("qkv", tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD,
                                   err_msg=f"d{name}")
    ref = full_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(to.detach().numpy(), ref.detach().numpy(),
                               **F32)


def test_flash_attention_bf16_matches_jax():
    q, k, v = (jnp.asarray(t, jnp.bfloat16)
               for t in _qkv(3, b=2, s=128, h=2, d=16))

    def jloss(q, k, v):
        o = jflash(q, k, v, causal=True)
        return o.astype(jnp.float32).sum(), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                     has_aux=True)(q, k, v)
    tq, tk, tv = (torch.from_numpy(np.asarray(t, np.float32))
                  .to(torch.bfloat16).requires_grad_() for t in (q, k, v))
    to = TA.flash_attention(tq, tk, tv, causal=True)
    tg = torch.autograd.grad(to.float().sum(), (tq, tk, tv))
    assert to.dtype == torch.bfloat16
    _bf16_close(to.float().detach().numpy(), jo)
    for a, b in zip(tg, jg):
        assert a.dtype == torch.bfloat16
        _bf16_close(a.float().numpy(), b)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_full_attention_matches_jax(causal, dtype):
    q, k, v = _qkv(4, b=2, s=100, h=2, d=8)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jfull(*(jnp.asarray(t, jdt) for t in (q, k, v)), causal=causal)
    got = full_attention(*(torch.from_numpy(t).to(getattr(torch, dtype))
                           for t in (q, k, v)), causal=causal)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    else:
        _bf16_close(got.float().numpy(), want)


@pytest.mark.parametrize("s,block", [(100, 128), (256, 96)])
def test_non_multiple_sequence_raises(s, block):
    q = torch.zeros(1, s, 1, 32)
    with pytest.raises(ValueError, match="multiples"):
        TA.flash_attention(q, q, q, causal=True, block_q=block,
                           block_k=block)


def test_flash_fwd_checks_its_inputs():
    q = torch.zeros(1, 128, 2, 32)
    with pytest.raises(ValueError, match="do not fit"):
        TA.flash_fwd(q, torch.zeros(1, 128, 1, 32), q, scale=1.0,
                     causal=True)
    with pytest.raises(TypeError, match="dtype"):
        TA.flash_fwd(q, q.double(), q, scale=1.0, causal=True)
    out, lse = TA.flash_fwd(q, q, q, scale=1.0, causal=False)
    assert out.shape == q.shape and out.is_contiguous()
    assert lse.shape == (2, 128) and lse.dtype == torch.float32
