"""``dt_tpu_torch.ops.quantization`` against ``dt_tpu.ops.quantization`` on
the CPU.

The same seeded numpy inputs go through both packages (JAX eagerly on the
CPU, as ``tests/test_quantization.py`` runs it).  Every result is held
bit for bit: int8 codes, scales, the int32 accumulators of the int8 dense
and convolution (exact in both: products of at most 127^2 summed below
2^31), and their float outputs in float32 and bfloat16 (the same correctly
rounded ops in the same order: ``acc.astype(f32) / (x_scale * w_scale) +
bias``, then the cast; eager XLA's CPU division agrees with torch's bit
for bit).  Only the example's forward under ``jax.jit`` (as the example
runs it) is not bit-equal, to eager JAX either: XLA rewrites the division
by a constant scale there, one ulp apart, and the bias added after it
cancels digits, so it is held within one float32 ulp of the largest
logit.  ``entropy_calibrate`` is numpy in both and returns the
same float.  The kernel's wrapper runs its plain version here (the tensors
lie on the CPU) and counts no launch; ``tests/test_torch_cuda.py`` holds
the kernel against that plain version on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from dt_tpu.ops import quantization as JQ
from dt_tpu_torch.ops import kernels
from dt_tpu_torch.ops import quantization as TQ
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)


def _np(x) -> np.ndarray:
    """A host array of either package's value (bfloat16 as float32)."""
    if isinstance(x, torch.Tensor):
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype == jnp.bfloat16 else x


def _same_bits(a, b) -> None:
    a, b = _np(a), _np(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    np.testing.assert_array_equal(a.reshape(-1).view(np.uint8),
                                  b.reshape(-1).view(np.uint8))


# --- quantize ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ranges", ["python", "f32_array", "numpy_scalar"])
def test_quantize_codes_and_scale(dtype, ranges):
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1.3, (7, 33)).astype(np.float32)
    lo, hi = -2.7, 3.1
    if ranges == "f32_array":
        lo_j, hi_j = jnp.asarray(lo, jnp.float32), jnp.asarray(hi, jnp.float32)
        lo_t, hi_t = torch.tensor(lo), torch.tensor(hi)
    elif ranges == "numpy_scalar":
        lo_j = lo_t = np.float32(lo)
        hi_j = hi_t = np.float32(hi)
    else:
        lo_j = lo_t = lo
        hi_j = hi_t = hi
    qj, sj = JQ.quantize(jnp.asarray(x).astype(dtype), lo_j, hi_j)
    qt, st = TQ.quantize(torch.from_numpy(x).to(getattr(torch, dtype)),
                         lo_t, hi_t)
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert st.dim() == 0
    _same_bits(qj, qt)
    _same_bits(jnp.asarray(sj, jnp.float32), st)


def test_quantize_bf16_weak_type_rule():
    """Python-number ranges give JAX a weakly typed scale: a bfloat16 input
    is multiplied in bfloat16 (the scale rounded to bfloat16 first); array
    ranges multiply in float32.  The two differ on these inputs, and the
    port follows each."""
    rng = np.random.RandomState(1)
    x = rng.uniform(-3, 3, 4096).astype(np.float32)
    xb_j = jnp.asarray(x).astype(jnp.bfloat16)
    xb_t = torch.from_numpy(x).to(torch.bfloat16)
    weak_j, _ = JQ.quantize(xb_j, -2.7, 2.7)
    strong_j, _ = JQ.quantize(xb_j, jnp.float32(-2.7), jnp.float32(2.7))
    weak_t, _ = TQ.quantize(xb_t, -2.7, 2.7)
    strong_t, _ = TQ.quantize(xb_t, torch.tensor(-2.7), torch.tensor(2.7))
    assert (np.asarray(weak_j) != np.asarray(strong_j)).sum() > 10
    _same_bits(weak_j, weak_t)
    _same_bits(strong_j, strong_t)


def test_quantize_at_amax_halves_and_clip():
    """Scale 1 (amax 127): x.5 points round half to even, +-amax map to
    +-127, beyond it clips; a zero range falls back to 1e-12."""
    x = np.concatenate([np.arange(-130, 131) + 0.5, [127.0, -127.0, 1e9,
                                                     -1e9, 0.0, -0.0]])
    x = x.astype(np.float32)
    for lo, hi in [(-127.0, 127.0), (-127.0, 3.0), (0.0, 0.0)]:
        qj, sj = JQ.quantize(jnp.asarray(x), lo, hi)
        qt, st = TQ.quantize(torch.from_numpy(x), lo, hi)
        _same_bits(qj, qt)
        _same_bits(jnp.asarray(sj, jnp.float32), st)
    q, _ = TQ.quantize(torch.tensor([126.5, 125.5, -0.5, 127.0, -127.0]),
                       -127.0, 127.0)
    assert q.tolist() == [126, 126, 0, 127, -127]


def test_dequantize_and_requantize():
    rng = np.random.RandomState(2)
    q = rng.randint(-127, 128, (5, 17)).astype(np.int8)
    acc = rng.randint(-2 ** 20, 2 ** 20, (6, 9)).astype(np.int32)
    for scale in (3.7, np.float32(0.81)):
        for dtype_j, dtype_t in ((jnp.float32, torch.float32),
                                 (jnp.bfloat16, torch.bfloat16)):
            _same_bits(JQ.dequantize(jnp.asarray(q), scale, dtype_j),
                       TQ.dequantize(torch.from_numpy(q), scale, dtype_t))
    for s_in, s_out in [(100.0, 12.7), (np.float32(3e3), np.float32(0.3))]:
        _same_bits(JQ.requantize(jnp.asarray(acc), s_in, s_out),
                   TQ.requantize(torch.from_numpy(acc), s_in, s_out))
    out = TQ.requantize(torch.tensor([[1000, -500]], dtype=torch.int32),
                        scale_in=100.0, scale_out=12.7)
    assert out.tolist() == [[127, -64]]


# --- the int8 convolution and dense --------------------------------------

_CONV_CASES = [  # (C_in, kernel, stride, padding)
    (3, 7, 2, "SAME"), (3, 7, 2, ((3, 3), (3, 3))), (3, 3, 1, 1),
    (64, 3, 1, "SAME"), (64, 3, 2, "SAME"), (64, 3, 2, "VALID"),
    (64, 1, 1, 0), (64, 1, 2, "VALID"), (3, 1, (1, 2), ((0, 1), (2, 0))),
    (64, 3, (2, 1), ((1, 0), (0, 2))),
]


def _int8(rng, shape):
    return rng.randint(-127, 128, shape).astype(np.int8)


@pytest.mark.parametrize("cin,k,stride,padding", _CONV_CASES)
def test_conv_accumulator_exact(cin, k, stride, padding):
    rng = np.random.RandomState(cin * 10 + k)
    x, w = _int8(rng, (2, 11, 9, cin)), _int8(rng, (k, k, cin, 24))
    st = (stride, stride) if isinstance(stride, int) else stride
    pad = padding
    if isinstance(padding, int):
        pad = ((padding, padding), (padding, padding))
    want = lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), st, pad,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    pads = TQ._conv_pads(padding, (11, 9), (k, k), st)
    got = kernels.qconv_acc_plain(torch.from_numpy(x), torch.from_numpy(w),
                                  st, pads)
    _same_bits(want, got)


@pytest.mark.parametrize("cin,k,stride,padding", _CONV_CASES)
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_conv2d_bit_equal(cin, k, stride, padding, with_bias,
                                    dtype):
    rng = np.random.RandomState(cin + k + int(with_bias))
    x = rng.normal(0, 1, (2, 11, 9, cin)).astype(np.float32)
    w = rng.normal(0, 0.2, (k, k, cin, 24)).astype(np.float32)
    bias = rng.normal(0, 0.5, 24).astype(np.float32) if with_bias else None
    xq_j, xs_j = JQ.quantize(jnp.asarray(x), float(x.min()), float(x.max()))
    wq_j, ws_j = JQ.quantize(jnp.asarray(w), -float(np.abs(w).max()),
                             float(np.abs(w).max()))
    want = JQ.quantized_conv2d(
        xq_j, wq_j, xs_j, ws_j, stride, padding,
        bias=None if bias is None else jnp.asarray(bias),
        dtype=getattr(jnp, dtype))
    xq_t, xs_t = TQ.quantize(torch.from_numpy(x), float(x.min()),
                             float(x.max()))
    wq_t, ws_t = TQ.quantize(torch.from_numpy(w), -float(np.abs(w).max()),
                             float(np.abs(w).max()))
    before = kernels.qconv.launches
    got = TQ.quantized_conv2d(
        xq_t, wq_t, xs_t, ws_t, stride, padding,
        bias=None if bias is None else torch.from_numpy(bias),
        dtype=getattr(torch, dtype))
    assert kernels.qconv.launches == before  # the CPU runs the plain version
    assert got.dtype == getattr(torch, dtype)
    _same_bits(want, got)


@pytest.mark.parametrize("lead,k,tail", [((8,), 32, (16,)),
                                         ((2, 3), 64, (5,)),
                                         ((4,), 147, (3, 2)),
                                         ((1,), 2048, (40,))])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_dense_bit_equal(lead, k, tail, dtype):
    rng = np.random.RandomState(k)
    x = rng.uniform(-1, 1, lead + (k,)).astype(np.float32)
    w = rng.uniform(-0.5, 0.5, (k,) + tail).astype(np.float32)
    n = int(np.prod(tail))
    for bias in (None, rng.normal(0, 1, tail[-1:]).astype(np.float32),
                 rng.normal(0, 1, lead[-1:] + (1,) * len(tail))
                 .astype(np.float32)):
        xq_j, xs_j = JQ.quantize(jnp.asarray(x), x.min(), x.max())
        wq_j, ws_j = JQ.quantize(jnp.asarray(w), w.min(), w.max())
        want = JQ.quantized_dense(xq_j, wq_j, xs_j, ws_j,
                                  None if bias is None else jnp.asarray(bias),
                                  getattr(jnp, dtype))
        xq_t, xs_t = TQ.quantize(torch.from_numpy(x), x.min(), x.max())
        wq_t, ws_t = TQ.quantize(torch.from_numpy(w), w.min(), w.max())
        got = TQ.quantized_dense(
            xq_t, wq_t, xs_t, ws_t,
            None if bias is None else torch.from_numpy(bias),
            getattr(torch, dtype))
        _same_bits(want, got)
        assert got.shape == lead + tail and n == int(np.prod(tail))


def test_scale_products_python_and_mixed():
    """``x_scale * w_scale`` of two Python floats is a double product
    rounded once; with a tensor in it, a float32 product."""
    rng = np.random.RandomState(5)
    xq, wq = _int8(rng, (6, 40)), _int8(rng, (40, 7))
    for xs, ws in [(0.1234567, 7.654321), (np.float32(0.1234567), 7.654321),
                   (1 / 3, np.float32(3.3))]:
        want = JQ.quantized_dense(jnp.asarray(xq), jnp.asarray(wq), xs, ws)
        got = TQ.quantized_dense(torch.from_numpy(xq), torch.from_numpy(wq),
                                 xs, ws)
        _same_bits(want, got)


def test_qconv_wrapper_refuses_outside_its_domain():
    x = torch.zeros((1, 1, 1, 8), dtype=torch.int8)
    d = torch.ones(())
    with pytest.raises(TypeError, match="int8"):
        kernels.qconv(x.float(), torch.zeros((1, 1, 8, 2), dtype=torch.int8),
                      (1, 1), ((0, 0), (0, 0)), d)
    with pytest.raises(ValueError, match="133144"):
        kernels.qconv(torch.zeros((1, 1, 1, 133145), dtype=torch.int8),
                      torch.zeros((1, 1, 133145, 1), dtype=torch.int8),
                      (1, 1), ((0, 0), (0, 0)), d)
    assert kernels.QCONV_MAX_K == 133144
    assert 127 ** 2 * kernels.QCONV_MAX_K < 2 ** 31 <= 127 ** 2 * 133145
    with pytest.raises(TypeError, match="dtype"):
        kernels.qconv(x, torch.zeros((1, 1, 8, 2), dtype=torch.int8),
                      (1, 1), ((0, 0), (0, 0)), d, dtype=torch.float16)
    # float16 output goes through the kernel's float32 output, then a cast
    xq, wq = torch.ones((2, 8), dtype=torch.int8), \
        torch.ones((8, 3), dtype=torch.int8)
    got = TQ.quantized_dense(xq, wq, 2.0, 1.0, dtype=torch.float16)
    assert got.dtype == torch.float16 and got.tolist() == [[4.0] * 3] * 2


# --- calibration --------------------------------------------------------

def test_minmax_collector():
    rng = np.random.RandomState(3)
    cj, ct = JQ.MinMaxCollector(), TQ.MinMaxCollector()
    for i in range(4):
        a = rng.normal(0, 1 + i, (16, 8)).astype(np.float32)
        cj.collect("a", a)
        ct.collect("a", torch.from_numpy(a) if i % 2 else a)
        b = jnp.asarray(a).astype(jnp.bfloat16)
        cj.collect("b", np.asarray(b))
        ct.collect("b", torch.from_numpy(a).to(torch.bfloat16))
    assert cj.ranges == ct.ranges
    c = TQ.MinMaxCollector()
    c.collect("a", np.array([1.0, -2.0]))
    c.collect("a", torch.tensor([3.0, 0.0]))
    assert c.ranges["a"] == (-2.0, 3.0)


@pytest.mark.parametrize("case", ["outliers", "relu", "zeros"])
def test_entropy_calibrate_equal(case):
    rng = np.random.RandomState(4)
    if case == "outliers":
        s = np.concatenate([rng.normal(0, 1, 100000), [50.0, -60.0]])
    elif case == "relu":
        s = np.maximum(rng.normal(0, 2, (256, 128)), 0).astype(np.float32)
    else:
        s = np.zeros(100, np.float32)
    want = JQ.entropy_calibrate(s)
    assert TQ.entropy_calibrate(s) == want
    assert TQ.entropy_calibrate(torch.from_numpy(np.asarray(s))) == want
    if case == "outliers":
        assert 1.0 < want < 20.0


def test_quantize_params_tree():
    rng = np.random.RandomState(6)
    tree = {"dense": {"kernel": rng.normal(0, 1, (8, 4)).astype(np.float32),
                      "bias": rng.normal(0, 1, 4).astype(np.float32)},
            "conv": {"kernel": rng.normal(0, 1, (3, 3, 2, 5))
                     .astype(np.float32)}}
    qj = JQ.quantize_params(jax.tree_util.tree_map(jnp.asarray, tree))
    qt = TQ.quantize_params(jax.tree_util.tree_map(torch.from_numpy, tree))
    assert qt["dense"]["bias"].dtype == torch.float32
    _same_bits(qj["dense"]["bias"], qt["dense"]["bias"])
    for name in ("dense", "conv"):
        assert qt[name]["kernel"]["q"].dtype == torch.int8
        _same_bits(qj[name]["kernel"]["q"], qt[name]["kernel"]["q"])
        _same_bits(jnp.asarray(qj[name]["kernel"]["scale"], jnp.float32),
                   qt[name]["kernel"]["scale"])
    bf = TQ.quantize_params({"w": torch.from_numpy(
        tree["dense"]["kernel"]).to(torch.bfloat16)})
    bj = JQ.quantize_params({"w": jnp.asarray(tree["dense"]["kernel"])
                             .astype(jnp.bfloat16)})
    _same_bits(bj["w"]["q"], bf["w"]["q"])


# --- examples/quantize_model.py's int8 forward ---------------------------

def _mlp_params(seed):
    rng = np.random.RandomState(seed)
    return {"w1": rng.normal(0, 0.1, (64, 128)).astype(np.float32),
            "b1": rng.normal(0, 0.1, 128).astype(np.float32),
            "w2": rng.normal(0, 0.1, (128, 128)).astype(np.float32),
            "b2": rng.normal(0, 0.1, 128).astype(np.float32),
            "w3": rng.normal(0, 0.1, (128, 4)).astype(np.float32),
            "b3": rng.normal(0, 0.1, 4).astype(np.float32)}


def _int8_forward(Q, relu, params, ranges, qw, xb):
    """The example's int8 forward (``examples/quantize_model.py``), written
    once for either package."""
    xq, xs = Q.quantize(xb, *ranges["in"])
    h1 = relu(Q.quantized_dense(xq, qw["w1"][0], xs, qw["w1"][1])
              + params["b1"])
    h1q, h1s = Q.quantize(h1, *ranges["h1"])
    h2 = relu(Q.quantized_dense(h1q, qw["w2"][0], h1s, qw["w2"][1])
              + params["b2"])
    h2q, h2s = Q.quantize(h2, *ranges["h2"])
    return Q.quantized_dense(h2q, qw["w3"][0], h2s, qw["w3"][1]) \
        + params["b3"]


@pytest.mark.parametrize("calib", ["naive", "entropy"])
def test_example_int8_forward(calib):
    """The same seeded weights and calibration batches through both
    packages' int8 forward: ranges, weight codes and logits bit-equal to
    eager JAX; within one float32 ulp of the largest logit of the forward
    under ``jax.jit`` (as the example runs it), which is not bit-equal to
    eager JAX either."""
    p = _mlp_params(7)
    rng = np.random.RandomState(8)
    calib_x = rng.normal(0, 1, (512, 64)).astype(np.float32)
    xb = rng.normal(0, 1, (256, 64)).astype(np.float32)
    # the taps of the float forward, in numpy, fed to both collectors
    h1 = np.maximum(calib_x @ p["w1"] + p["b1"], 0)
    h2 = np.maximum(h1 @ p["w2"] + p["b2"], 0)
    taps = {"in": calib_x, "h1": h1, "h2": h2}
    cj, ct = JQ.MinMaxCollector(), TQ.MinMaxCollector()
    for name, v in taps.items():
        cj.collect(name, v)
        ct.collect(name, torch.from_numpy(v))
    if calib == "entropy":
        ranges_j = {k: (-JQ.entropy_calibrate(v), JQ.entropy_calibrate(v))
                    for k, v in taps.items()}
        ranges_t = {k: (-TQ.entropy_calibrate(v), TQ.entropy_calibrate(v))
                    for k, v in taps.items()}
    else:
        ranges_j, ranges_t = cj.ranges, ct.ranges
    assert ranges_j == ranges_t
    qw_j, qw_t = {}, {}
    for name in ("w1", "w2", "w3"):
        amax = float(np.abs(p[name]).max())
        qw_j[name] = JQ.quantize(jnp.asarray(p[name]), -amax, amax)
        qw_t[name] = TQ.quantize(torch.from_numpy(p[name]), -amax, amax)
        _same_bits(qw_j[name][0], qw_t[name][0])
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    got = _int8_forward(TQ, torch.relu, pt, ranges_t, qw_t,
                        torch.from_numpy(xb))
    want = _int8_forward(JQ, jax.nn.relu, pj, ranges_j, qw_j,
                         jnp.asarray(xb))
    _same_bits(want, got)
    jitted = jax.jit(lambda x: _int8_forward(JQ, jax.nn.relu, pj, ranges_j,
                                             qw_j, x))(jnp.asarray(xb))
    ulp = float(np.spacing(np.abs(_np(jitted)).max()))
    assert np.abs(_np(jitted) - _np(got)).max() <= ulp
    assert np.abs(_np(jitted) - _np(want)).max() <= ulp
    # and the int8 logits keep the float forward's top-1 on most rows
    f1 = np.maximum(xb @ p["w1"] + p["b1"], 0)
    f2 = np.maximum(f1 @ p["w2"] + p["b2"], 0)
    agree = np.argmax(_np(got), -1) == np.argmax(f2 @ p["w3"] + p["b3"], -1)
    assert agree.mean() > 0.9, agree.mean()
