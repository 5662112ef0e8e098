"""The rest of the port's ``ops`` against ``dt_tpu.ops`` on the CPU:
``tensor``, ``losses``, ``contrib``, ``linalg``, ``custom_op`` and
``sparse``'s CSR, and the package's submodule names.

The same seeded numpy inputs go through both.  Discrete results (top-K
indices, CSR index arrays, one-hot positions) must be equal; float results
within 1e-6 of the largest magnitude (``TOL``), ``ctc_loss``, ``linalg`` and
``fft`` within 1e-5 (``TOL_LOOSE``).  Every loss's gradient, and
``custom_op``'s through its numpy ``backward``, is held within 1e-5 of
``jax.grad``'s.  The JAX side runs jitted where its eager form would
compile op by op (the losses' gradients, ``ctc_loss``'s scan, CSR), eagerly
elsewhere.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt_tpu import ops as jops
from dt_tpu.ops import contrib as jc
from dt_tpu.ops import linalg as jl
from dt_tpu.ops import losses as jloss
from dt_tpu.ops import sparse as jsp
from dt_tpu.ops import tensor as jt
from dt_tpu_torch import ops as tops
from dt_tpu_torch.ops import contrib as tc
from dt_tpu_torch.ops import linalg as tl
from dt_tpu_torch.ops import losses as tloss
from dt_tpu_torch.ops import sparse as tsp
from dt_tpu_torch.ops import tensor as tt
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

TOL = 1e-6
TOL_LOOSE = 1e-5


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _x(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).normal(0, 1, shape) * scale) \
        .astype(np.float32)


def test_ops_exports_every_submodule_of_the_jax_package_but_quantization():
    """Every name ``dt_tpu/ops/__init__.py`` imports (its ``... as name``
    lines; the attributes of the package also hold submodules other tests
    imported) is a name of ``dt_tpu_torch.ops``."""
    import re
    want = set(re.findall(r"\bas (\w+)$", open(jops.__file__).read(),
                          re.M))
    assert want == {"nn", "losses", "tensor", "rnn", "sparse", "detection",
                    "roi", "warp", "contrib", "linalg", "custom_op"}
    have = {n for n in vars(tops) if not n.startswith("_")}
    assert want <= have, sorted(want - have)
    assert callable(tops.custom_op)


def test_quantization_refuses_by_name():
    """Every public name of the JAX module (``NAMES``) exists in the port's
    ``ops.quantization`` and is callable (it refused each before the module
    was ported; ``tests/test_torch_quantization.py`` holds the values)."""
    from dt_tpu_torch.ops import quantization
    for name in quantization.NAMES:
        assert callable(getattr(quantization, name)), name
    with pytest.raises(AttributeError):
        quantization.no_such_function
    from dt_tpu.ops import quantization as jq
    public = {n for n, v in vars(jq).items() if not n.startswith("_")
              and (inspect.isfunction(v) or inspect.isclass(v))
              and v.__module__ == jq.__name__}
    assert public == set(quantization.NAMES)


@pytest.mark.parametrize("module", ["tensor", "losses", "contrib", "linalg",
                                    "detection", "roi", "warp"])
def test_every_public_function_has_a_port_twin(module):
    import importlib
    j = importlib.import_module(f"dt_tpu.ops.{module}")
    t = importlib.import_module(f"dt_tpu_torch.ops.{module}")
    want = {n for n, f in vars(j).items() if inspect.isfunction(f)
            and f.__module__ == j.__name__ and not n.startswith("_")}
    have = {n for n, f in vars(t).items() if inspect.isfunction(f)}
    assert want and want <= have, sorted(want - have)


# --- tensor -----------------------------------------------------------------

@pytest.mark.parametrize("axis,ascend,ret", [(-1, False, "both"),
                                             (0, True, "value"),
                                             (1, False, "indices")])
def test_topk_breaks_ties_to_the_lower_index(axis, ascend, ret):
    x = np.round(_x(0, (6, 7, 3)), 1)  # rounded: many exact ties
    want = jt.topk(jnp.asarray(x), 3, axis, ret, ascend)
    got = tt.topk(_t(x), 3, axis, ret, ascend)
    for g, w in zip(got if ret == "both" else [got],
                    want if ret == "both" else [want]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_one_hot_embedding_take_gather_nd():
    idx = np.array([[0, 3, -1], [5, 2, 1]])
    np.testing.assert_array_equal(
        tt.one_hot(_t(idx), 4, 2.0, -1.0).numpy(),
        np.asarray(jt.one_hot(jnp.asarray(idx), 4, 2.0, -1.0)))
    table = _x(1, (5, 3))
    ids = np.array([[-1, 9, 2], [0, 4, -5]])
    np.testing.assert_array_equal(
        tt.embedding(_t(ids), _t(table)).numpy(),
        np.asarray(jt.embedding(jnp.asarray(ids), jnp.asarray(table))))
    x = _x(2, (4, 5, 2))
    for mode in ("clip", "wrap"):
        for axis in (0, 1, -1):
            ind = np.array([[-2, 7], [1, 0]])
            np.testing.assert_array_equal(
                tt.take(_t(x), _t(ind), axis, mode).numpy(),
                np.asarray(jt.take(jnp.asarray(x), jnp.asarray(ind), axis,
                                   mode)))
    ind = np.array([[0, -1, 3, 9], [1, 7, 2, 0]])
    np.testing.assert_array_equal(
        tt.gather_nd(_t(x), _t(ind)).numpy(),
        np.asarray(jt.gather_nd(jnp.asarray(x), jnp.asarray(ind))))


@pytest.mark.parametrize("time_axis", [0, 1])
def test_sequence_ops(time_axis):
    x = _x(3, (6, 4, 3) if time_axis == 0 else (4, 6, 3))
    lengths = np.array([6, 0, 3, 1])
    jx, tx = jnp.asarray(x), _t(x)
    jlen, tlen = jnp.asarray(lengths), _t(lengths)
    np.testing.assert_array_equal(
        tt.sequence_mask(tx, tlen, -7.0, time_axis).numpy(),
        np.asarray(jt.sequence_mask(jx, jlen, -7.0, time_axis)))
    np.testing.assert_array_equal(
        tt.sequence_last(tx, tlen, time_axis).numpy(),
        np.asarray(jt.sequence_last(jx, jlen, time_axis)))
    for ln in (tlen, None):
        np.testing.assert_array_equal(
            tt.sequence_reverse(tx, ln, time_axis).numpy(),
            np.asarray(jt.sequence_reverse(
                jx, None if ln is None else jlen, time_axis)))


def test_swapaxes_and_slice_channel():
    x = _x(4, (2, 6, 3))
    np.testing.assert_array_equal(tt.swapaxes(_t(x), 0, 2).numpy(),
                                  np.asarray(jt.swapaxes(jnp.asarray(x), 0,
                                                         2)))
    for squeeze, n, axis in ((False, 3, 1), (True, 2, 0)):
        got = tt.slice_channel(_t(x), n, axis, squeeze)
        want = jt.slice_channel(jnp.asarray(x), n, axis, squeeze)
        assert len(got) == len(want) == n
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="equal parts"):
        tt.slice_channel(_t(x), 4, 1)


# --- losses -----------------------------------------------------------------

def _loss_pair(jfn, tfn, args, wrt=(0,)):
    """Value and gradient (of the inputs at ``wrt``) on both sides."""
    jv, jg = jax.jit(jax.value_and_grad(jfn, argnums=wrt))(
        *[jnp.asarray(a) for a in args])
    ts = [_t(a, i in wrt) for i, a in enumerate(args)]
    tv = tfn(*ts)
    _close(tv, jv, TOL)
    tv.backward()
    for i, g in zip(wrt, jg):
        _close(ts[i].grad, g, TOL_LOOSE)


@pytest.mark.parametrize("name", ["l2_loss", "l1_loss", "logistic_loss",
                                  "huber_loss", "hinge_loss"])
def test_regression_losses_and_gradients(name):
    pred = _x(5, (8, 3), 2.0)
    label = _x(6, (8, 3))
    if name in ("logistic_loss",):
        label = (label > 0).astype(np.float32)
    if name == "hinge_loss":
        label = np.sign(label).astype(np.float32)
    _loss_pair(getattr(jloss, name), getattr(tloss, name), [pred, label],
               (0,))


def test_nce_losses_and_gradients():
    hidden = _x(7, (4, 5))
    embeds = _x(8, (4, 3, 5))
    weight = np.zeros((4, 3), np.float32)
    weight[:, 0] = 1.0
    _loss_pair(jloss.nce_loss, tloss.nce_loss, [hidden, embeds, weight],
               (0, 1))
    table = _x(9, (11, 5))
    ids = np.random.RandomState(10).randint(0, 11, (4, 3))
    _loss_pair(jloss.nce_loss_from_ids, tloss.nce_loss_from_ids,
               [hidden, table, ids, weight], (0, 1))


def test_kl_divergence_and_its_gradient():
    logits = _x(11, (5, 4))
    logp = np.asarray(jax.nn.log_softmax(jnp.asarray(logits)))
    p = np.array(jax.nn.softmax(jnp.asarray(_x(12, (5, 4)))))
    p[0, 0] = 0.0  # log(0) clamps to 1e-12
    _loss_pair(jloss.kl_divergence, tloss.kl_divergence, [logp, p], (0, 1))


def test_ctc_loss_is_the_jax_recursion():
    """Padded labels, repeated labels (the skip is barred), an empty label,
    logits masked past ``logit_lengths``, and a non-zero blank; the value
    and the gradient of the logits within 1e-5."""
    b, t, v = 4, 9, 6
    logits = _x(13, (b, t, v), 2.0)
    labels = np.array([[1, 2, 2, 3], [4, 4, 0, 0], [0, 0, 0, 0],
                       [5, 1, 3, 0]], np.int32)
    label_lengths = np.array([4, 2, 0, 3], np.int32)
    logit_lengths = np.array([9, 6, 3, 7], np.int32)
    for blank in (0, 2):
        lab = np.where(labels == blank, (blank + 1) % v, labels) \
            .astype(np.int32)

        def jfn(x, lab=lab, blank=blank):
            return jloss.ctc_loss(x, jnp.asarray(logit_lengths),
                                  jnp.asarray(lab),
                                  jnp.asarray(label_lengths), blank)

        def tfn(x, lab=lab, blank=blank):
            return tloss.ctc_loss(x, _t(logit_lengths), _t(lab),
                                  _t(label_lengths), blank)

        jv, jg = jax.jit(jax.value_and_grad(jfn))(jnp.asarray(logits))
        x = _t(logits, True)
        tv = tfn(x)
        _close(tv, jv, TOL_LOOSE)
        tv.backward()
        _close(x.grad, jg, TOL_LOOSE)


def test_softmax_cross_entropy_gradient():
    logits = _x(14, (6, 5))
    labels = np.array([0, 4, 2, 2, 1, 3])

    def jfn(x):
        return jloss.softmax_cross_entropy(x, jnp.asarray(labels),
                                           smoothing=0.1, ignore_label=2)

    def tfn(x):
        return tloss.softmax_cross_entropy(x, _t(labels), smoothing=0.1,
                                           ignore_label=2)

    _loss_pair(jfn, tfn, [logits])


# --- contrib ----------------------------------------------------------------

@pytest.mark.parametrize("out", [3, (2, 5), 7])
def test_adaptive_avg_pool2d(out):
    x = _x(15, (2, 7, 9, 3))
    _close(tc.adaptive_avg_pool2d(_t(x), out),
           jc.adaptive_avg_pool2d(jnp.asarray(x), out))


def test_count_sketch_and_kronecker_products():
    x = _x(16, (3, 10))
    rng = np.random.RandomState(17)
    h = rng.randint(0, 4, 10)
    s = rng.choice([-1.0, 1.0], 10).astype(np.float32)
    _close(tc.count_sketch(_t(x), _t(h), _t(s), 4),
           jc.count_sketch(jnp.asarray(x), jnp.asarray(h), jnp.asarray(s), 4))
    mats = [_x(18 + i, (4, k)) for i, k in enumerate((2, 3, 2))]
    _close(tc.row_wise_kronecker([_t(m) for m in mats]),
           jc.row_wise_kronecker([jnp.asarray(m) for m in mats]))
    mats = [_x(21 + i, (r, 3)) for i, r in enumerate((2, 4))]
    _close(tc.khatri_rao([_t(m) for m in mats]),
           jc.khatri_rao([jnp.asarray(m) for m in mats]))


def test_fft_packing_quadratic_index_copy():
    x = _x(23, (3, 8))
    f = tc.fft(_t(x))
    _close(f, jc.fft(jnp.asarray(x)), TOL_LOOSE)
    _close(tc.ifft(f), jc.ifft(jnp.asarray(f.numpy())), TOL_LOOSE)
    _close(tc.ifft(f), x * 8, TOL_LOOSE)
    _close(tc.quadratic(_t(x), 0.5, -2.0, 3.0),
           jc.quadratic(jnp.asarray(x), 0.5, -2.0, 3.0))
    old = _x(24, (5, 2))
    rows = _x(25, (2, 2))
    idx = np.array([3, 0])
    np.testing.assert_array_equal(
        tc.index_copy(_t(old), _t(idx), _t(rows)).numpy(),
        np.asarray(jc.index_copy(jnp.asarray(old), jnp.asarray(idx),
                                 jnp.asarray(rows))))


# --- linalg -----------------------------------------------------------------

def _spd(seed, n=4, batch=2):
    a = _x(seed, (batch, n, n))
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n)).astype(np.float32)


def test_gemm_syrk_trmm():
    a, b, c = _x(26, (2, 3, 4)), _x(27, (2, 4, 5)), _x(28, (2, 3, 5))
    _close(tl.gemm(_t(a), _t(b), _t(c), 0.5, -1.5),
           jl.gemm(jnp.asarray(a), jnp.asarray(b), jnp.asarray(c), 0.5, -1.5),
           TOL_LOOSE)
    _close(tl.gemm2(_t(np.swapaxes(a, 1, 2)), _t(np.swapaxes(b, 1, 2)), 2.0,
                    True, True),
           jl.gemm2(jnp.asarray(np.swapaxes(a, 1, 2)),
                    jnp.asarray(np.swapaxes(b, 1, 2)), 2.0, True, True),
           TOL_LOOSE)
    for tr in (False, True):
        _close(tl.syrk(_t(a), 0.7, tr), jl.syrk(jnp.asarray(a), 0.7, tr),
               TOL_LOOSE)
    sq, m = _x(29, (2, 4, 4)), _x(30, (2, 4, 3))
    for tr in (False, True):
        for lower in (True, False):
            _close(tl.trmm(_t(sq), _t(m), 1.5, tr, False, lower),
                   jl.trmm(jnp.asarray(sq), jnp.asarray(m), 1.5, tr, False,
                           lower), TOL_LOOSE)
            mr = np.swapaxes(m, 1, 2).copy()
            _close(tl.trmm(_t(sq), _t(mr), 1.5, tr, True, lower),
                   jl.trmm(jnp.asarray(sq), jnp.asarray(mr), 1.5, tr, True,
                           lower), TOL_LOOSE)


def test_cholesky_family():
    a = _spd(31)
    L = tl.potrf(_t(a))
    _close(L, jl.potrf(jnp.asarray(a)), TOL_LOOSE)
    Ln = L.numpy()
    _close(tl.potri(_t(Ln)), jl.potri(jnp.asarray(Ln)), TOL_LOOSE)
    _close(tl.sumlogdiag(_t(Ln)), jl.sumlogdiag(jnp.asarray(Ln)), TOL_LOOSE)
    b = _x(32, (2, 4, 3))
    tri = Ln + np.triu(_x(33, (2, 4, 4)), 1)  # junk above: ignored
    for tr in (False, True):
        for lower in (True, False):
            t_a = tri if lower else np.swapaxes(tri, 1, 2).copy()
            _close(tl.trsm(_t(t_a), _t(b), 0.5, tr, False, lower),
                   jl.trsm(jnp.asarray(t_a), jnp.asarray(b), 0.5, tr, False,
                           lower), TOL_LOOSE)
            br = np.swapaxes(b, 1, 2).copy()
            _close(tl.trsm(_t(t_a), _t(br), 0.5, tr, True, lower),
                   jl.trsm(jnp.asarray(t_a), jnp.asarray(br), 0.5, tr, True,
                           lower), TOL_LOOSE)


def test_gelqf_and_syevd():
    """gelqf's (L, Q) is unique with L's diagonal non-negative: equal on
    both sides.  syevd's eigenvalues are equal and ascending; each
    eigenvector row equals JAX's up to its sign, which each side's solver
    picks (the JAX function fixes none)."""
    a = _x(34, (2, 3, 5))
    L, Q = tl.gelqf(_t(a))
    jL, jQ = jl.gelqf(jnp.asarray(a))
    _close(L, jL, TOL_LOOSE)
    _close(Q, jQ, TOL_LOOSE)
    assert (torch.diagonal(L, dim1=-2, dim2=-1) >= 0).all()
    _close(L @ Q, a, TOL_LOOSE)
    s = _spd(35)
    u, w = tl.syevd(_t(s))
    ju, jw = jl.syevd(jnp.asarray(s))
    _close(w, jw, TOL_LOOSE)
    assert (torch.diff(w, dim=-1) >= 0).all()
    ju = np.asarray(ju)
    sign = np.sign((u.numpy() * ju).sum(-1, keepdims=True))
    _close(u.numpy() * sign, ju, TOL_LOOSE)
    _close(torch.swapaxes(u, 1, 2) @ torch.diag_embed(w) @ u, s, TOL_LOOSE)


# --- custom_op --------------------------------------------------------------

def _matmul_op(lib):
    def fwd(x, w):
        return (x @ w,)

    def bwd(inputs, outputs, gys):
        x, w = inputs
        (gy,) = gys
        return gy @ w.T, x.T @ gy

    return lib.custom_op(fwd, bwd, infer_shape=lambda x, w: [(x[0], w[1])],
                         name="matmul")


def test_custom_op_forward_and_backward():
    x, w = _x(36, (3, 4)), _x(37, (4, 2))
    jop, top = _matmul_op(jops), _matmul_op(tops)
    _close(top(_t(x), _t(w)), jop(jnp.asarray(x), jnp.asarray(w)))
    jg = jax.grad(lambda a, b: jnp.sum(jnp.sin(jop(a, b))), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(w))
    tx, tw_ = _t(x, True), _t(w, True)
    torch.sin(top(tx, tw_)).sum().backward()
    _close(tx.grad, jg[0], TOL_LOOSE)
    _close(tw_.grad, jg[1], TOL_LOOSE)
    assert top.__name__ == "matmul"


def test_custom_op_defaults_outputs_and_no_backward():
    """Without ``infer_shape`` one output of the first input's shape and
    dtype; several outputs come back as a tuple; without ``backward`` the
    outputs carry no gradient; a count mismatch raises."""
    x = _x(38, (2, 3))
    top = tops.custom_op(lambda a: np.tanh(a).astype(np.float64))
    jop = jops.custom_op(lambda a: np.tanh(a).astype(np.float64))
    y = top(_t(x, True))
    assert y.dtype == torch.float32 and not y.requires_grad
    _close(y, jop(jnp.asarray(x)))
    two = tops.custom_op(lambda a: (a + 1, (a > 0)),
                         infer_shape=lambda s: [s, s],
                         infer_dtype=lambda d: [d, np.bool_])
    a, b = two(_t(x))
    assert a.dtype == torch.float32 and b.dtype == torch.bool
    bad = tops.custom_op(lambda a: (a, a), name="bad")
    with pytest.raises(ValueError, match="bad: forward returned 2"):
        bad(_t(x))


# --- sparse CSR -------------------------------------------------------------

def _sparse_dense(seed, shape=(5, 6), density=0.3):
    rng = np.random.RandomState(seed)
    x = rng.normal(0, 1, shape).astype(np.float32)
    return x * (rng.uniform(0, 1, shape) < density)


@pytest.mark.parametrize("nse", [None, 4, 40])
def test_csr_from_dense_slot_for_slot(nse):
    x = _sparse_dense(39)
    j = jax.jit(jsp.csr_from_dense, static_argnums=1)(jnp.asarray(x), nse)
    t = tsp.csr_from_dense(_t(x), nse)
    assert t.shape == j.shape and t.nse == j.nse
    for f in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    np.testing.assert_array_equal(t._row_ids().numpy(),
                                  np.asarray(j._row_ids()))
    np.testing.assert_array_equal(t.to_dense().numpy(),
                                  np.asarray(j.to_dense()))


@pytest.mark.parametrize("transpose", [False, True])
def test_csr_dot_dense(transpose):
    x = _sparse_dense(40)
    rhs = _x(41, (5 if transpose else 6, 3))
    t = tsp.csr_from_dense(_t(x), 12)
    want = jax.jit(lambda x, r: jsp.csr_dot_dense(
        jsp.csr_from_dense(x, 12), r, transpose))(jnp.asarray(x),
                                                  jnp.asarray(rhs))
    _close(tsp.csr_dot_dense(t, _t(rhs), transpose), want)


def test_cast_storage_every_stype():
    x = _sparse_dense(42)
    tx = _t(x)
    for stype, cls in (("csr", tsp.CSR), ("row_sparse", tsp.RowSparse)):
        s = tsp.cast_storage(tx, stype)
        assert isinstance(s, cls)
        assert tsp.cast_storage(s, stype) is s
        back = tsp.cast_storage(s, "default")
        np.testing.assert_array_equal(back.numpy(), x)
        js = jsp.cast_storage(jnp.asarray(x), stype)
        np.testing.assert_array_equal(back.numpy(),
                                      np.asarray(js.to_dense()))
    assert tsp.cast_storage(tx, "default") is tx
    with pytest.raises(ValueError, match="unknown storage type"):
        tsp.cast_storage(tx, "coo")
