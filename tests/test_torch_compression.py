"""The port's 2-bit gradient codec against the JAX package's, bit for bit.

On the CPU the wrappers ``ops.kernels.quantize_2bit``/``dequantize_2bit``
run their plain versions; the JAX side runs the Pallas kernels in interpret
mode and the numpy oracles (``dt_tpu/parallel/compression.py``).  Words are
compared as uint32 (the port's int32 words viewed as uint32), residuals and
values bit for bit (NaN where NaN).  The CUDA kernels are held against the
plain versions on the card by ``tests/test_torch_cuda.py`` and
``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt_tpu.ops.pallas import kernels as K
from dt_tpu.parallel import compression as JC
from dt_tpu_torch.ops import kernels as TK
from dt_tpu_torch.parallel import compression as TC
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

SIZES = [0, 1, 15, 16, 17, 1000, 4099]


def _grad(n, seed=0, special=False):
    rng = np.random.RandomState(seed)
    g = rng.normal(0, 0.6, n).astype(np.float32)
    r = rng.normal(0, 0.2, n).astype(np.float32)
    if special and n >= 16:
        t = np.float32(0.5)
        # x = g + r lands exactly on +-t, at +-0, at +-inf and NaN
        g[:8] = [t, -t, 0.0, -0.0, np.inf, -np.inf, np.nan, t]
        r[:8] = [0.0, 0.0, 0.0, -0.0, 1.0, 1.0, 0.0, -np.float32(1e-8)]
        g[8] = np.nextafter(t, np.float32(0))
        r[8] = 0.0
    return g, r


def _same_bits(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def _port_quant(g, r, t):
    words, res = TK.quantize_2bit(torch.from_numpy(g), torch.from_numpy(r), t)
    assert words.dtype == torch.int32
    return words.numpy().view(np.uint32), res.numpy()


@pytest.mark.parametrize("special", [False, True])
@pytest.mark.parametrize("n", SIZES)
def test_quantize_matches_numpy_and_pallas_bitwise(n, special):
    g, r = _grad(n, seed=n, special=special)
    words, res = _port_quant(g, r, 0.5)
    np_words, np_res = JC.np_quantize_2bit(g, r, 0.5)
    assert words.shape == (-(-n // 16),)
    np.testing.assert_array_equal(words, np_words)
    _same_bits(res, np_res)
    if n:
        pk, pres = K.quantize_2bit(jnp.asarray(g), jnp.asarray(r), 0.5,
                                   interpret=True)
        np.testing.assert_array_equal(words, np.asarray(pk))
        _same_bits(res, pres)
    # the port's numpy copy is the JAX package's oracle
    mine = TC.np_quantize_2bit(g, r, 0.5)
    np.testing.assert_array_equal(mine[0], np_words)
    _same_bits(mine[1], np_res)


@pytest.mark.parametrize("n", SIZES)
def test_dequantize_matches_numpy_and_pallas_bitwise(n):
    rng = np.random.RandomState(n)
    words = rng.randint(0, 2 ** 32, -(-n // 16), dtype=np.uint64) \
        .astype(np.uint32)  # every code, 3 included
    got = TK.dequantize_2bit(torch.from_numpy(words.view(np.int32)), n,
                             0.3).numpy()
    want = JC.np_dequantize_2bit(words, n, 0.3)
    _same_bits(got, want)
    _same_bits(TC.np_dequantize_2bit(words, n, 0.3), want)
    if n:
        _same_bits(got, K.dequantize_2bit(jnp.asarray(words), n, 0.3,
                                          interpret=True))


@pytest.mark.parametrize("threshold", [0.5, 0.1, 1e-3])
def test_threshold_is_taken_as_float32(threshold):
    """A threshold not exact in f32 (0.1) rounds to f32, as numpy's weak
    scalar does in the comparisons and in the decoded values."""
    t32 = np.float32(threshold)
    g = np.array([t32, np.nextafter(t32, np.float32(0)), -t32,
                  np.nextafter(-t32, np.float32(0))] * 4, np.float32)
    r = np.zeros_like(g)
    words, res = _port_quant(g, r, threshold)
    np_words, np_res = JC.np_quantize_2bit(g, r, threshold)
    np.testing.assert_array_equal(words, np_words)
    _same_bits(res, np_res)
    _same_bits(TK.dequantize_2bit(torch.from_numpy(words.view(np.int32)), 16,
                                  threshold).numpy(),
               JC.np_dequantize_2bit(np_words, 16, threshold))


def test_quantize_roundtrip_error_feedback():
    """Error feedback: over steps, the sum of dequantized values tracks the
    sum of the gradients to within one threshold (``test_pallas_kernels.py
    :67``), and equals the Pallas kernels' sum bit for bit."""
    rng = np.random.RandomState(1)
    resid_t = torch.zeros(64)
    resid_j = jnp.zeros(64, jnp.float32)
    total_t = torch.zeros(64)
    total_j = jnp.zeros(64, jnp.float32)
    gsum = np.zeros(64, np.float32)
    for _ in range(20):
        g = rng.normal(0, 0.3, 64).astype(np.float32)
        gsum += g
        w, resid_t = TK.quantize_2bit(torch.from_numpy(g), resid_t, 0.5)
        total_t = total_t + TK.dequantize_2bit(w, 64, 0.5)
        pk, resid_j = K.quantize_2bit(jnp.asarray(g), resid_j, 0.5,
                                      interpret=True)
        total_j = total_j + K.dequantize_2bit(pk, 64, 0.5, interpret=True)
    _same_bits(total_t.numpy(), total_j)
    _same_bits(resid_t.numpy(), resid_j)
    assert np.abs(total_t.numpy() - gsum).max() <= 0.5 + 1e-5


def test_gradient_compression_sequence_matches_numpy_path():
    """``compress_on_device`` keeps its residual across steps and tracks the
    numpy path bit for bit (``test_compression.py:121``); decompression on
    either side gives the same values."""
    rng = np.random.RandomState(0)
    dev = TC.GradientCompression(0.4)
    host = JC.GradientCompression(0.4)
    mine = TC.GradientCompression(0.4)
    for _ in range(4):
        g = rng.randn(333).astype(np.float32)
        w_dev = dev.compress_on_device(torch.from_numpy(g))
        w_host = host.compress(g)
        np.testing.assert_array_equal(w_dev.numpy().view(np.uint32), w_host)
        np.testing.assert_array_equal(mine.compress(g), w_host)
        _same_bits(dev.decompress_on_device(w_dev, 333).numpy(),
                   host.decompress(w_host, 333))
    _same_bits(dev._residual_dev.numpy(), host._residual)
    _same_bits(mine._residual, host._residual)
    _same_bits(mine.decompress(w_host, 333), host.decompress(w_host, 333))


def test_compress_on_device_restarts_on_a_new_shape():
    gc = TC.GradientCompression(0.5)
    gc.compress_on_device(torch.full((20,), 0.3))
    assert gc._residual_dev.shape == (20,)
    w = gc.compress_on_device(torch.full((5,), 0.3))
    assert gc._residual_dev.shape == (5,) and int(w[0]) == 0


@pytest.mark.parametrize("n,per", [(100, 32), (64, 16), (5, 16)])
def test_packed_chunks_match(n, per):
    words = np.arange(-(-n // 16), dtype=np.uint32)
    got = TC.packed_chunks(words, n, per)
    want = JC.packed_chunks(words, n, per)
    assert [c for _, c in got] == [c for _, c in want]
    for (a, _), (b, _) in zip(got, want):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="multiple"):
        TC.packed_chunks(words, n, 10)


def test_codec_rejects_bad_inputs_and_cpu_never_launches():
    before = (TK.quantize_2bit.launches, TK.dequantize_2bit.launches)
    with pytest.raises(ValueError, match="float32"):
        TK.quantize_2bit(torch.zeros(4, dtype=torch.float64), torch.zeros(4))
    with pytest.raises(ValueError, match="residual must match"):
        TK.quantize_2bit(torch.zeros(4), torch.zeros(5))
    with pytest.raises(TypeError, match="int32"):
        TK.dequantize_2bit(torch.zeros(1, dtype=torch.int64), 16)
    with pytest.raises(ValueError, match="words"):
        TK.dequantize_2bit(torch.zeros(2, dtype=torch.int32), 16)
    with pytest.raises(ValueError, match="positive"):
        TC.GradientCompression(0.0)
    TK.dequantize_2bit(TK.quantize_2bit(torch.ones(40), torch.zeros(40))[0],
                       40)
    assert (TK.quantize_2bit.launches, TK.dequantize_2bit.launches) == before
    assert TC.CODES_PER_WORD == JC.CODES_PER_WORD == 16
