"""The port's training BatchNorm against the Pallas kernel it replaces.

On the CPU ``ops.kernels.fused_bn_train`` runs its plain versions (pass 1
``bn_stats_plain``, pass 2 ``bn_act_plain``) and its PyTorch backward; the
JAX side runs ``fused_bn_train`` in Pallas interpret mode with its custom
VJP, and ``jax.nn.relu`` after it where the port fuses the ReLU in.  Both get
the same seeded numpy inputs and the same output cotangent.  The CUDA pass 1
is held against ``bn_stats_plain`` on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt_tpu.ops import nn as jnn
from dt_tpu.ops.pallas import kernels as K
from dt_tpu_torch.ops import kernels as TK
from dt_tpu_torch.ops import nn as tnn
from test_torch_shapes import RESNET50_BN_CHW
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

# f32: the two sides sum the batch in different orders (the JAX kernel in
# 256-row blocks), so mean and var differ in the last bits and the
# normalized output by a few ulps of its O(1) values; the backward's sums
# differ the same way.  bf16: y is rounded to bf16 (2**-8 relative) from
# scale/bias that are themselves rounded to bf16, and dx is rounded to bf16;
# the two frameworks may round those at other points.
TOL = {"float32": dict(y=2e-5, stats=1e-5, grad=1e-4),
       "bfloat16": dict(y=5e-2, stats=1e-5, grad=5e-2)}
SHAPES = [(6, 5, 5, 16), (300, 64), (37, 3), (2, 7, 7, 256)]


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = rng.normal(0.5, 2, shape).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = rng.normal(0, 1, c).astype(np.float32)
    rm = rng.normal(0, 1, c).astype(np.float32)
    rv = rng.uniform(0.5, 2, c).astype(np.float32)
    gy = rng.normal(0, 1, shape).astype(np.float32)
    return x, gamma, beta, rm, rv, gy


def _to_port(a_nhwc, dtype):
    t = torch.from_numpy(a_nhwc).to(dtype)
    return t.permute(0, 3, 1, 2) if t.dim() == 4 else t


def _from_port(t):
    t = t.detach().float()
    return (t.permute(0, 2, 3, 1) if t.dim() == 4 else t).numpy()


def _jax(x, gamma, beta, rm, rv, gy, dtype, relu):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16

    def f(x, g, b):
        y, nm, nv = K.fused_bn_train(x, g, b, rm, rv, 0.9, 1e-5,
                                     interpret=True)
        return (jax.nn.relu(y) if relu else y), (nm, nv)

    (y, (nm, nv)), vjp = jax.vjp(f, jnp.asarray(x, jdt), gamma, beta)
    dx, dg, db = vjp((jnp.asarray(gy, jdt), (jnp.zeros_like(nm),
                                             jnp.zeros_like(nv))))
    return [np.asarray(a.astype(jnp.float32)) for a in (y, nm, nv, dx, dg,
                                                         db)]


def _port(x, gamma, beta, rm, rv, gy, dtype, relu):
    tdt = getattr(torch, dtype)
    xt = _to_port(x, tdt).requires_grad_(True)
    g = torch.from_numpy(gamma).requires_grad_(True)
    b = torch.from_numpy(beta).requires_grad_(True)
    rmt, rvt = torch.from_numpy(rm.copy()), torch.from_numpy(rv.copy())
    y, nm, nv = TK.fused_bn_train(xt, g, b, rmt, rvt, momentum=0.9,
                                  eps=1e-5, relu=relu)
    assert y.dtype == tdt and y.shape == xt.shape
    assert nm is rmt and nv is rvt  # moved in place
    if y.dim() == 4:
        assert y.is_contiguous(memory_format=torch.channels_last)
    y.backward(_to_port(gy, tdt))
    assert xt.grad.dtype == tdt and g.grad.dtype == torch.float32
    return [_from_port(a) for a in (y, nm, nv, xt.grad, g.grad, b.grad)]


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_bn_train_matches_pallas_kernel(shape, dtype, relu):
    args = _inputs(shape)
    want = _jax(*args, dtype, relu)
    got = _port(*args, dtype, relu)
    tol = TOL[dtype]
    names = ["y", "new_mean", "new_var", "dx", "dgamma", "dbeta"]
    for name, a, b in zip(names, got, want):
        kind = "y" if name == "y" else "stats" if name.startswith("new") \
            else "grad"
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=tol[kind],
                                   atol=tol[kind] * scale, err_msg=name)


def test_bn_train_large_mean_small_variance_no_nan():
    """E[x^2] - mean^2 cancels for a mean of 2048 and sigma 1e-3 and can go
    negative; the clamp keeps outputs, stats and gradients finite, as in
    the JAX kernel's test (``test_pallas_kernels.py:232``)."""
    rng = np.random.RandomState(3)
    c = 16
    x = (2048.0 + rng.normal(0, 1e-3, (8, 4, 4, c))).astype(np.float32)
    gamma = np.ones(c, np.float32)
    beta = rng.normal(0, 1, c).astype(np.float32)
    rm, rv = np.zeros(c, np.float32), np.ones(c, np.float32)
    gy = rng.normal(0, 1, x.shape).astype(np.float32)
    got = _port(x, gamma, beta, rm, rv, gy, "float32", relu=False)
    for a in got:
        assert np.isfinite(a).all()
    assert (got[2] >= 0.9 - 1e-6).all()  # batch var floored at 0
    mean, var = TK.bn_stats_plain(torch.from_numpy(x.reshape(-1, c)))
    assert (var >= 0).all()
    want = _jax(x, gamma, beta, rm, rv, gy, "float32", relu=False)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)


def test_bn_stats_plain_is_the_kernel_formula():
    """mean = sum/n and var = max(sum(x*x)/n - mean^2, 0), NaN kept."""
    x = torch.tensor([[1.0, np.nan], [3.0, 2.0], [5.0, 4.0]])
    mean, var = TK.bn_stats_plain(x)
    f = np.float32
    assert mean[0] == 3.0 and var[0] == f(35) / f(3) - f(9)
    assert torch.isnan(mean[1]) and torch.isnan(var[1])


@pytest.mark.parametrize("training", [True, False])
def test_functional_batch_norm_matches_jax(training):
    x, gamma, beta, rm, rv, _ = _inputs((4, 6, 6, 8), seed=5)
    want = jnn.batch_norm(jnp.asarray(x), gamma, beta, rm, rv,
                          training=training, momentum=0.9, eps=1e-5)
    got = tnn.batch_norm(_to_port(x, torch.float32),
                         *(torch.from_numpy(a) for a in (gamma, beta, rm,
                                                         rv)),
                         training=training, momentum=0.9, eps=1e-5)
    # f32, batch sums in another order: a few ulps
    np.testing.assert_allclose(_from_port(got[0]), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)


def test_backward_takes_a_cotangent_in_any_layout():
    x, gamma, beta, rm, rv, gy = _inputs((2, 3, 3, 8), seed=6)
    outs = []
    for contiguous_nchw in (False, True):
        xt = _to_port(x, torch.float32).requires_grad_(True)
        y, _, _ = TK.fused_bn_train(xt, torch.from_numpy(gamma),
                                    torch.from_numpy(beta),
                                    torch.from_numpy(rm.copy()),
                                    torch.from_numpy(rv.copy()), relu=True)
        g = _to_port(gy, torch.float32)
        y.backward(g.contiguous() if contiguous_nchw else g)
        outs.append(xt.grad)
    assert torch.equal(outs[0], outs[1])


def test_bn_train_rejects_bad_inputs():
    x, gamma, beta, rm, rv, _ = _inputs((2, 4, 4, 8))
    ps = [torch.from_numpy(a) for a in (gamma, beta, rm, rv)]
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()
    with pytest.raises(ValueError, match="fused_bn_train: a 4-D input must "
                                         "be channels_last"):
        TK.fused_bn_train(nchw, *ps)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        TK.fused_bn_train(torch.zeros(4, 8, dtype=torch.float16), *ps)
    with pytest.raises(ValueError, match="shape"):
        TK.fused_bn_train(torch.zeros(4, 7), *ps)
    with pytest.raises(ValueError, match="empty"):
        TK.bn_stats(torch.zeros(0, 8))


def test_cpu_tensor_never_launches():
    before = (TK.bn_stats.launches, TK.bn_act.launches)
    args = _inputs((300, 64))
    _port(*args, "float32", relu=True)
    assert (TK.bn_stats.launches, TK.bn_act.launches) == before


@pytest.mark.parametrize("rows,c,want", [
    (401408, 64, (2, 132)), (1568, 2048, (16, 17)), (37, 3, (1, 1)),
    (1, 5, (1, 1)), (100352, 4096, (16, 17)), (1568, 64, (2, 25))])
def test_stats_blocks(rows, c, want):
    """Pass 1's (slices, row blocks) in bf16: ~2 blocks per SM in all,
    slices of 256 channels narrowing while blocks are short, fewer row
    blocks when the partials would pass 1/16 of x's bytes (or 64 KB), one
    when the rows fit one block."""
    g = TK.stats_geometry(rows, c, 2)
    assert (g.slices, g.row_blocks) == want


# every BatchNorm input of ResNet-50 at batch 1, 32 and 256, and ragged ones
GEOMETRY_SHAPES = sorted(
    {(n * h * w, c) for n in (1, 32, 256) for c, h, w in RESNET50_BN_CHW}
    | {(37, 3), (1001, 17), (1001, 64), (1, 5), (105, 1), (3, 70000),
       (1 << 20, 1), (7, 4096 + 8)})


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("aligned", [True, False])
def test_stats_geometry_within_limits(itemsize, aligned):
    """Partials within 1/16 of x (or 64 KB), the grid within CUDA's limits,
    at least one block a slice, every row and channel covered once, the
    16-byte loads only where the rows allow them; ResNet-50's batch-32
    inputs fill the H100's 132 SMs twice over."""
    for rows, c in GEOMETRY_SHAPES:
        g = TK.stats_geometry(rows, c, itemsize, aligned)
        tag = (rows, c, g)
        assert g.partial_bytes(c) <= max(rows * c * itemsize // 16,
                                         64 * 1024), tag
        assert 1 <= g.row_blocks <= 65535 and 1 <= g.slices <= 65535, tag
        assert g.slices <= TK._MAX_TICKETS, tag
        assert 1 <= g.bx * g.by <= 256, tag
        assert c % g.vec == 0 and g.bx * g.vec * g.slices >= c, tag
        assert (g.slices - 1) * g.bx * g.vec < c, tag  # no empty slice
        # the slice's last block adds at most 8 rows of partials a thread
        assert g.row_blocks <= 8 * g.by, tag
        assert (g.row_blocks - 1) * g.by < rows, tag  # no empty block
        if g.vec > 1:
            assert aligned and g.vec * itemsize == 16, tag
            assert (c * itemsize) % 16 == 0, tag
        assert g.bx * g.vec <= 256 or g.vec == 1, tag
    for c, h, w in RESNET50_BN_CHW:
        g = TK.stats_geometry(32 * h * w, c, itemsize, aligned)
        if g.vec > 1:
            assert 264 <= g.slices * g.row_blocks <= 264 + g.slices, (c, g)
