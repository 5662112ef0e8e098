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
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

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


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [8, 16])
def test_plain_matches_pallas_forward_small_heads(causal, d):
    """D 8 and D 16, the heads of the repo's small flash models (the
    kernel's newest widths): the plain version against the Pallas kernel
    in interpret mode, f32 and bf16."""
    q, k, v = (_to3(t) for t in _qkv(3, s=256, d=d))
    want_o, want_lse = _flash_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale=d ** -0.5,
        causal=causal, block_q=128, block_k=128, interpret=True)
    got_o, got_lse = TA.flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        scale=d ** -0.5, causal=causal)
    np.testing.assert_allclose(got_o.numpy(), np.asarray(want_o), **F32)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse),
                               rtol=0, atol=LSE)
    jq, jk, jv = (jnp.asarray(t, jnp.bfloat16) for t in (q, k, v))
    want_o, _ = _flash_fwd_pallas(jq, jk, jv, scale=d ** -0.5,
                                  causal=causal, block_q=128, block_k=128,
                                  interpret=True)
    got_o, _ = TA.flash_attention_plain(
        *(torch.from_numpy(np.asarray(t, np.float32)).to(torch.bfloat16)
          for t in (jq, jk, jv)), scale=d ** -0.5, causal=causal)
    _bf16_close(got_o.float().numpy(), want_o)


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


@pytest.mark.parametrize("shape,strides,want", [
    ((2, 256, 4, 64), (256 * 768, 768, 64, 1), [256 * 768, 768, 64]),
    ((2, 256, 1, 64), (256 * 64, 64, 7, 1), [256 * 64, 64, 64]),
    ((1, 1, 1, 32), (5, 3, 2, 1), [32, 32, 32])])
def test_flash_strides_of_size_one_axes(shape, strides, want):
    """The (B, S, H) strides handed to the flash kernel: an axis of size 1
    takes a dense stride, so that a TMA map accepts it."""
    t = torch.empty_strided(shape, strides)
    assert TA._bsh_strides(t) == want


# --- the f32 kernel's 3xTF32 arithmetic, emulated on the CPU -------------

LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def _tf32(x):
    """Round f32 to TF32 as ``cvt.rna.tf32.f32`` does (10 mantissa bits,
    to nearest, ties away from zero), by bit masks on the int32 view."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm3(a, b):
    """a @ b from TF32 parts as the kernel issues them: lo.hi + hi.lo +
    hi.hi (the products are exact in f32; the sums are f32)."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return al @ bh + ah @ bl + ah @ bh


def _flash_3xtf32(q3, k3, v3, scale, causal, terms=3):
    """The f32 kernel's arithmetic on ``(B*H, S, D)`` f32: key tiles of 64
    (32 at D 128), scores in log2 units, exp2, P and V split like Q and K;
    ``terms=1`` keeps hi.hi alone (plain TF32)."""
    mm = _mm3 if terms == 3 else (lambda a, b: _tf32(a) @ _tf32(b))
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    bk = 64 if d <= 64 else 32
    scale_log2 = torch.tensor(scale * LOG2E, dtype=torch.float32)
    m = torch.full((bh, sq, 1), -1e30)
    l = torch.zeros((bh, sq, 1))
    acc = torch.zeros((bh, sq, d))
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, sk, bk):
        s = mm(q3, k3[:, k0:k0 + bk].transpose(1, 2)) * scale_log2
        if causal:
            keys = torch.arange(k0, min(k0 + bk, sk))[None, :]
            s = torch.where(keys <= rows, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s - m_new)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + mm(p, v3[:, k0:k0 + bk])
        m = m_new
    l = torch.clamp(l, min=1e-30)
    return acc / l, (m * LN2 + torch.log(l))[..., 0]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("s,d", [(256, 8), (256, 16), (256, 32), (256, 64),
                                 (200, 64), (128, 128)])
def test_3xtf32_emulation_holds_the_f32_tolerances(s, d, causal):
    """The 3xTF32 split (TF32 rounding by bit masks) against the plain
    version at unit-normal q, k, v (as ``chip_smoke.py`` draws them): out
    within 2e-5 and lse within 1e-5, the f32 kernel's tolerances; plain
    TF32 (hi.hi alone) misses the out tolerance by far, which is why the
    kernel issues three products."""
    rng = np.random.RandomState(s + d)
    q3, k3, v3 = (torch.from_numpy(rng.randn(2, s, d).astype(np.float32))
                  for _ in range(3))
    scale = d ** -0.5
    want, want_lse = TA.flash_attention_plain(q3, k3, v3, scale=scale,
                                              causal=causal)
    out, lse = _flash_3xtf32(q3, k3, v3, scale, causal)
    assert float((out - want).abs().max()) <= 2e-5
    assert float((lse - want_lse).abs().max()) <= LSE
    tf32_out, _ = _flash_3xtf32(q3, k3, v3, scale, causal, terms=1)
    assert float((tf32_out - want).abs().max()) > 10 * 2e-5


def test_tf32_rounding_is_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0e-39])
    got = _tf32(x).tolist()
    assert got[:4] == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9,
                       -(1.0 + 2.0 ** -10), 1.0]
    hi, lo = _split(torch.tensor([0.1]))
    assert float(hi + lo) == pytest.approx(0.1, rel=2.0 ** -21)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _flash_bf16_p(q3, k3, v3, scale, causal, split):
    """The bf16 kernel's arithmetic on ``(B*H, S, D)`` bf16 values held in
    f32: 64-key tiles, f32 scores in log2 units, and p rounded to bf16 for
    P V (``split``: as two bf16 terms, bf16(p) + bf16(p - bf16(p)), as the
    kernel does at D 8 and 16); l sums the f32 p; out rounded to bf16."""
    bh, sq, d = q3.shape
    m = torch.full((bh, sq, 1), -1e30)
    l = torch.zeros((bh, sq, 1))
    acc = torch.zeros((bh, sq, d))
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, k3.shape[1], 64):
        s = q3 @ k3[:, k0:k0 + 64].transpose(1, 2) * (scale * LOG2E)
        if causal:
            keys = torch.arange(k0, k0 + s.shape[-1])[None, :]
            s = torch.where(keys <= rows, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp2(s - m_new)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        hi = _bf16(p)
        pv = hi @ v3[:, k0:k0 + 64]
        if split:
            pv = pv + _bf16(p - hi) @ v3[:, k0:k0 + 64]
        acc = acc * corr + pv
        m = m_new
    return _bf16(acc / torch.clamp(l, min=1e-30))


@pytest.mark.parametrize("d", [8, 16])
def test_split_p_holds_the_bf16_row_bound_at_small_heads(d):
    """Why the bf16 kernel splits p at D 8 and 16: with so few columns a
    row, its bound (one ulp of each output row, 2^-7 of the row's largest
    |out|) leaves no room for p's own bf16 rounding on late causal rows
    (this emulation without the split sits at the bound; on an H100 the
    unsplit D 8 kernel went to 1.41 times it); with p as two bf16 terms
    the emulated kernel holds it, at about half the bound."""
    q, k, v = (_bf16(torch.from_numpy(_to3(t))) for t in _qkv(4, s=512,
                                                               d=d))
    want, _ = TA.flash_attention_plain(q, k, v, scale=d ** -0.5,
                                       causal=True)
    want = _bf16(want)
    got = _flash_bf16_p(q, k, v, d ** -0.5, True, split=True)
    tol = BF16_ULP * want.abs().amax(-1, keepdim=True)
    assert bool(((got - want).abs() <= tol).all())
