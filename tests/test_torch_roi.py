"""The port's ``ops.roi`` and ``ops.warp`` against ``dt_tpu``'s on the CPU.

The same seeded numpy inputs (NHWC feature maps, ``[batch, x1, y1, x2,
y2]`` ROIs in pixels) go through both.  Float results within 1e-6 of the
largest magnitude (``TOL``), discrete ones (anchors, proposals' order and
padding) equal; where a gradient exists (``roi_align``, the bilinear
sampler, ``deformable_conv2d``) it is held within 1e-5 (``TOL_GRAD``) of
``jax.grad``'s of the same weighted sum.  The JAX side runs jitted where
the results are held to a tolerance (eager JAX compiles each op of these
gather-heavy functions and takes several times longer), eagerly for the
pools, whose bin edges are floors and ceilings of quotients that XLA
rewrites under ``jit``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt_tpu.ops import roi as jr
from dt_tpu.ops import warp as jw
from dt_tpu_torch.ops import roi as tr
from dt_tpu_torch.ops import warp as tw
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

TOL = 1e-6
TOL_GRAD = 1e-5


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _feat(seed, shape):
    return np.random.RandomState(seed).normal(0, 1, shape).astype(np.float32)


def _rois(seed, n, batch, size):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(-4, size - 8, (n, 2))
    wh = rng.uniform(0.5, size / 2, (n, 2))
    b = rng.randint(0, batch, (n, 1))
    r = np.concatenate([b, xy, xy + wh], 1).astype(np.float32)
    r[0, 1:] = [5.0, 5.0, 3.0, 2.0]  # malformed: clamps to a minimum size
    return r


def _value_and_grads_close(jfn, tfn, args, wrt, seed=9):
    """The port's value against the JAX function's, and the port's backward
    against ``jax.grad`` of ``sum(out * w)``, both jitted together."""
    shape = jax.eval_shape(jfn, *[jnp.asarray(a) for a in args]).shape
    w = np.random.RandomState(seed).normal(0, 1, shape).astype(np.float32)

    def loss(*xs):
        out = jfn(*xs)
        return jnp.sum(out * w), out

    (_, want), jg = jax.jit(jax.value_and_grad(loss, argnums=wrt,
                                               has_aux=True))(
        *[jnp.asarray(a) for a in args])
    ts = [_t(a, i in wrt) for i, a in enumerate(args)]
    got = tfn(*ts)
    _close(got, want)
    (got * _t(w)).sum().backward()
    for i, g in zip(wrt, jg):
        _close(ts[i].grad, g, TOL_GRAD)


@pytest.mark.parametrize("pooled,scale", [((2, 4), 0.5)])
def test_roi_pool(pooled, scale):
    data = _feat(0, (2, 12, 10, 3))
    rois = _rois(1, 7, 2, 24)
    # eager: jitted, XLA turns ``rh / ph`` into a product by the
    # reciprocal, and a bin edge's floor or ceil moves by one pixel
    _close(tr.roi_pool(_t(data), _t(rois), pooled, scale),
           jr.roi_pool(jnp.asarray(data), jnp.asarray(rois), pooled, scale))


@pytest.mark.parametrize("group", [2])  # G != P: bins share groups
def test_psroi_pool(group):
    p, d = 3, 2
    g = group or p
    data = _feat(2, (2, 9, 11, g * g * d))
    rois = _rois(3, 6, 2, 30)
    _close(tr.psroi_pool(_t(data), _t(rois), d, p, 0.3, group),
           jr.psroi_pool(jnp.asarray(data), jnp.asarray(rois), d, p, 0.3,
                         group))


@pytest.mark.parametrize("mode", ["zero", "border"])
def test_bilinear_sample(mode):
    feat = _feat(4, (6, 7, 3))
    rng = np.random.RandomState(5)
    ys = rng.uniform(-2, 8, (4, 5)).astype(np.float32)
    xs = rng.uniform(-2, 9, (4, 5)).astype(np.float32)
    ys[0, 0], xs[0, 0] = -1.0, 7.0  # on the window's edges
    _close(tr.bilinear_sample(_t(feat), _t(ys), _t(xs), mode),
           jr.bilinear_sample(jnp.asarray(feat), jnp.asarray(ys),
                              jnp.asarray(xs), mode))


@pytest.mark.parametrize("ratio", [-1, 3])
def test_roi_align_and_its_gradient(ratio):
    data = _feat(6, (2, 10, 12, 4))
    rois = _rois(7, 5, 2, 40)

    def jfn(d, r):
        return jr.roi_align(d, r, (3, 3), 0.25, ratio)

    def tfn(d, r):
        return tr.roi_align(d, r, (3, 3), 0.25, ratio)

    _value_and_grads_close(jfn, tfn, [data, rois], (0, 1))


def test_anchors_are_equal():
    for args in [(16, (8, 16, 32), (0.5, 1, 2)), (8, (2.0, 4.0),
                                                  (0.5, 1.0, 2.0))]:
        np.testing.assert_array_equal(tr.generate_anchors(*args).numpy(),
                                      np.asarray(jr.generate_anchors(*args)))
        np.testing.assert_array_equal(
            tr.shifted_anchors(3, 5, *args).numpy(),
            np.asarray(jr.shifted_anchors(3, 5, *args)))


def test_encode_and_decode_rpn():
    rng = np.random.RandomState(8)
    anchors = np.asarray(jr.shifted_anchors(3, 3, 16, (2.0,), (0.5, 1.0)))
    lo = rng.uniform(0, 30, (anchors.shape[0], 2))
    gt = np.concatenate([lo, lo + rng.uniform(2, 20, lo.shape)], 1) \
        .astype(np.float32)
    _close(tr.encode_rpn(_t(anchors), _t(gt)),
           jr.encode_rpn(jnp.asarray(anchors), jnp.asarray(gt)))
    deltas = rng.normal(0, 0.5, gt.shape).astype(np.float32)
    _close(tr._decode_rpn(_t(anchors), _t(deltas), 40.0, 35.0),
           jr._decode_rpn(jnp.asarray(anchors), jnp.asarray(deltas),
                          jnp.float32(40.0), jnp.float32(35.0)))


def _rpn_inputs(seed, b, h, w, a):
    rng = np.random.RandomState(seed)
    scores = rng.uniform(0, 1, (b, h, w, a)).astype(np.float32)
    scores[0, 0, 0, :3] = scores[0, 0, 1, :3]  # exact ties in the top-K
    deltas = rng.normal(0, 0.3, (b, h, w, a, 4)).astype(np.float32)
    deltas[..., 2:] -= 1.5  # some boxes below min_size: FilterBox
    info = np.array([[h * 8, w * 8, 1.0], [h * 8 - 5, w * 8, 1.5]],
                    np.float32)[:b]
    return scores, deltas, info


KW = dict(stride=8, scales=(2.0, 4.0), ratios=(0.5, 1.0, 2.0),
          pre_nms_top_n=40, post_nms_top_n=16, nms_threshold=0.5,
          min_size=8)


@pytest.mark.parametrize("post", [16, 40])
def test_proposal_matches(post):
    """One image and a batch: the same boxes in the same order (ties to the
    lower index), the -1 sentinels of FilterBox, and past the survivors
    the best box repeated."""
    scores, deltas, info = _rpn_inputs(10, 2, 5, 6, 6)
    kw = dict(KW, post_nms_top_n=post)
    jb, js = jax.jit(functools.partial(jr.multi_proposal, **kw))(
        jnp.asarray(scores), jnp.asarray(deltas), jnp.asarray(info))
    tb, ts = tr.multi_proposal(_t(scores), _t(deltas), _t(info), **kw)
    _close(tb, jb)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ts == -1).any()
    jb1, js1 = jax.jit(functools.partial(jr.proposal, **kw))(
        jnp.asarray(scores[1]), jnp.asarray(deltas[1]), jnp.asarray(info[1]))
    tb1, ts1 = tr.proposal(_t(scores[1]), _t(deltas[1]), _t(info[1]), **kw)
    _close(tb1, jb1)
    np.testing.assert_array_equal(ts1.numpy(), np.asarray(js1))
    if post == 40:  # fewer survivors than post: padded with the best
        assert (tb1 == tb1[0]).all(-1).sum() > 1


@pytest.mark.parametrize("dg,stride,pad,dil", [(1, (1, 1), (1, 1), (1, 1)),
                                               (2, (2, 1), (0, 1), (1, 2))])
def test_deformable_conv2d_and_its_gradient(dg, stride, pad, dil):
    x = _feat(11, (2, 7, 8, 4))
    kh, kw = 3, 2
    weight = _feat(12, (kh, kw, 4, 5)) * 0.3
    oh = (7 + 2 * pad[0] - dil[0] * (kh - 1) - 1) // stride[0] + 1
    ow = (8 + 2 * pad[1] - dil[1] * (kw - 1) - 1) // stride[1] + 1
    offset = _feat(13, (2, oh, ow, dg * kh * kw * 2)) * 1.5

    def jfn(x, o, w):
        return jr.deformable_conv2d(x, o, w, stride, pad, dil, dg)

    def tfn(x, o, w):
        return tr.deformable_conv2d(x, o, w, stride, pad, dil, dg)

    _value_and_grads_close(jfn, tfn, [x, offset, weight], (0, 1, 2))


# --- ops.warp ---------------------------------------------------------------

def test_affine_and_warp_grids():
    theta = _feat(14, (2, 6)) * 0.5
    for shape in [(5, 7), (1, 4)]:
        _close(tw.affine_grid(_t(theta), shape),
               jw.affine_grid(jnp.asarray(theta), shape))
    flow = _feat(15, (2, 5, 6, 2))
    _close(tw.warp_grid(_t(flow)), jw.warp_grid(jnp.asarray(flow)))


def test_bilinear_sampler_and_spatial_transformer_gradients():
    data = _feat(16, (2, 6, 7, 3))
    grid = np.random.RandomState(17).uniform(-1.3, 1.3, (2, 4, 5, 2)) \
        .astype(np.float32)
    _value_and_grads_close(jw.bilinear_sampler, tw.bilinear_sampler,
                           [data, grid], (0, 1))
    theta = (np.array([[1, 0, 0, 0, 1, 0], [0.8, -0.3, 0.1, 0.2, 0.9, -0.2]])
             + _feat(18, (2, 6)) * 0.05).astype(np.float32)

    def jfn(d, th):
        return jw.spatial_transformer(d, th, (5, 4))

    def tfn(d, th):
        return tw.spatial_transformer(d, th, (5, 4))

    _value_and_grads_close(jfn, tfn, [data, theta], (0, 1))


@pytest.mark.parametrize("kw", [
    dict(kernel_size=1, max_displacement=2, stride1=1, stride2=1,
         pad_size=2),
    dict(kernel_size=3, max_displacement=2, stride1=2, stride2=2,
         pad_size=3, is_multiply=False)])
def test_correlation(kw):
    a, b = _feat(19, (2, 8, 9, 3)), _feat(20, (2, 8, 9, 3))
    _close(tw.correlation(_t(a), _t(b), **kw),
           jw.correlation(jnp.asarray(a), jnp.asarray(b), **kw))
