"""The port's BN kernel wrapper against the Pallas kernel it replaces.

On the CPU the wrapper runs its plain version; the JAX side runs
``fused_bn_inference`` in Pallas interpret mode.  Both get the same seeded
numpy inputs.  The CUDA kernel itself is checked against the plain version on
the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt_tpu.ops.pallas import kernels as K
from dt_tpu_torch.ops import _build
from dt_tpu_torch.ops import kernels as TK
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

SHAPES = [(2, 8, 8, 16), (300, 64), (5, 3), (4, 7, 7, 2048)]
# f32: one ulp of rsqrt may differ between the frameworks.  bf16: one bf16
# ulp is 2**-8 relative, and the two frameworks may round at other points.
TOL = {"float32": 1e-6, "bfloat16": 1e-2}


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = rng.normal(0, 2, shape).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.normal(0, 1, c).astype(np.float32)
    mean = rng.normal(0, 1, c).astype(np.float32)
    var = rng.uniform(0.5, 2.0, c).astype(np.float32)
    return x, gamma, beta, mean, var


def _port(x_nhwc: np.ndarray, params, dtype, relu):
    """Run the port on NHWC numpy: 4-D goes in as NCHW channels_last."""
    x = torch.from_numpy(x_nhwc).to(dtype)
    if x.dim() == 4:
        x = x.permute(0, 3, 1, 2)
    y = TK.fused_bn_inference(x, *(torch.from_numpy(p) for p in params),
                              relu=relu)
    assert y.dtype == dtype and y.shape == x.shape
    if y.dim() == 4:
        assert y.is_contiguous(memory_format=torch.channels_last)
        y = y.permute(0, 2, 3, 1)
    return y.float().numpy()


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_bn_matches_pallas_kernel(shape, dtype, relu):
    x, *params = _inputs(shape)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = K.fused_bn_inference(jnp.asarray(x, jdt), *params, relu=relu,
                                interpret=True)
    want = np.asarray(want.astype(jnp.float32))
    got = _port(x, params, getattr(torch, dtype), relu)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


def test_bn_relu_keeps_nan():
    x, *params = _inputs((6, 8))
    x[2, 3] = np.nan
    got = _port(x, params, torch.float32, relu=True)
    want = np.asarray(K.fused_bn_inference(jnp.asarray(x), *params,
                                           relu=True, interpret=True))
    assert np.isnan(got[2, 3]) and np.isnan(want[2, 3])
    assert np.isnan(got).sum() == 1 and (got[~np.isnan(got)] >= 0).all()


def test_bn_plain_rounds_like_eager_bf16():
    """The plain version rounds after the multiply and after the add, which
    is what the CUDA kernel does (bit-exact agreement on the card)."""
    x, *params = _inputs((64, 32), seed=3)
    xb = torch.from_numpy(x).bfloat16()
    scale, bias = TK.bn_scale_bias(*(torch.from_numpy(p) for p in params),
                                   1e-5, torch.bfloat16)
    prod = (xb.float() * scale.float()).bfloat16()
    want = (prod.float() + bias.float()).bfloat16()
    got = TK.bn_act_plain(xb, scale, bias, relu=False)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_bn_rejects_bad_inputs():
    x, *params = _inputs((2, 4, 4, 8))
    ps = [torch.from_numpy(p) for p in params]
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    with pytest.raises(ValueError, match="channels_last"):
        TK.fused_bn_inference(nchw, *ps)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        TK.fused_bn_inference(torch.zeros(4, 8, dtype=torch.float16), *ps)
    with pytest.raises(ValueError, match="shape"):
        TK.fused_bn_inference(torch.zeros(4, 7), *ps)
    with pytest.raises(ValueError, match="contiguous"):
        TK.fused_bn_inference(torch.zeros(8, 4).t(), *ps)
    with pytest.raises(ValueError, match="bfloat16"):
        TK.bn_act(torch.zeros(4, 8, dtype=torch.bfloat16), ps[0], ps[1])


def test_cpu_tensor_never_launches():
    before = TK.bn_act.launches
    x, *params = _inputs((300, 64))
    _port(x, params, torch.float32, relu=True)
    assert TK.bn_act.launches == before


def test_build_key_follows_sources_and_flags(monkeypatch):
    assert _build.sources() == ["bn_act", "bn_train", "flash_attn",
                                "lstm_layer", "lstm_layer_bwd", "lstm_point",
                                "nms", "qconv", "quant2"]
    path = _build.library_path("bn_act")
    assert path.parent == _build.BUILD_DIR and path.suffix == ".so"
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-G"])
    assert _build.library_path("bn_act") != path
