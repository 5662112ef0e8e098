"""The port's bf16 LSTM layer Function (and the f32 one's BPTT) against the
JAX package, on the CPU.

On the CPU the layer Function runs the plain versions of its two kernels:
``lstm_layer_plain`` (the bf16 layer kernel's loop: hw = bf16(h @ wh), pre =
bf16(xw_t + hw), gates = f32(pre) + f32(b), h and c rounded to bf16) and
``lstm_layer_bwd_plain`` (the BPTT kernel's loop, with the roundings of
autograd through the stepped bf16 cell).  They are held against
``dt_tpu.ops.rnn.lstm(fused=True)`` and ``bidirectional_lstm`` with the
Pallas cell in interpret mode, values and ``jax.vjp`` gradients of x, h0,
c0 and every wx, wh, b, from seeded numpy; the plain BPTT against autograd
through the stepped cell bit for bit; and the geometry of both kernels.

Tolerances: bf16 within 2^-6 of each output's largest magnitude (as
``tests/test_torch_rnn.py``: both sides round each matmul's f32 sum to bf16,
sometimes to neighbouring values, and the steps carry it); f32 within 1e-5
(through matmuls, as ``tests/test_torch_lstm.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt_tpu.ops import rnn as jrnn
from dt_tpu_torch.ops import kernels as TK
from dt_tpu_torch.ops import rnn as trnn
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

BF16 = 2.0 ** -6
F32 = 1e-5
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, want, dtype):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32, atol=F32)
    else:
        tol = BF16 * max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= tol


def _weights(rng, layers, inp, hidden, concat=1):
    s = 1.0 / np.sqrt(hidden)
    return [[rng.uniform(-s, s, shape).astype(np.float32)
             for shape in ((inp if i == 0 else concat * hidden, 4 * hidden),
                           (hidden, 4 * hidden), (4 * hidden,))]
            for i in range(layers)]


class _Spy:
    """Counts the calls of a function it wraps."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **k):
        self.calls += 1
        return self.fn(*a, **k)


def _vjp_both(jfn, tfn, arrays, dtype, seed=99):
    """Outputs and gradients of sum(out * cot) through ``jfn`` (JAX, by
    ``jax.vjp``) and ``tfn`` (the port, autograd), each taking a list of
    arrays in ``dtype``; compared output by output and gradient by
    gradient."""
    jd, td = DTYPES[dtype]
    outs, vjp = jax.vjp(jfn, *[jnp.asarray(a, jd) for a in arrays])
    rng = np.random.RandomState(seed)
    cots = [rng.normal(0, 1, np.shape(o)).astype(np.float32) for o in outs]
    jg = vjp(type(outs)(jnp.asarray(c, jd) for c in cots))
    targs = [torch.from_numpy(a).to(td).requires_grad_() for a in arrays]
    touts = tfn(*targs)
    loss = sum((o.float() * torch.from_numpy(c)).sum()
               for o, c in zip(touts, cots))
    tg = torch.autograd.grad(loss, targs)
    assert len(touts) == len(outs) and len(tg) == len(jg) == len(arrays)
    for a, b in zip(touts, outs):
        assert a.dtype == td
        _close(a, b, dtype)
    for a, b in zip(tg, jg):
        assert a.dtype == td
        _close(a, b, dtype)


@pytest.mark.parametrize("dtype,b,h,layers,reverse", [
    ("bfloat16", 1, 8, 1, False), ("bfloat16", 5, 8, 2, True),
    ("bfloat16", 37, 16, 2, False), ("bfloat16", 5, 16, 1, True),
    ("bfloat16", 37, 8, 1, True), ("bfloat16", 1, 16, 2, True),
    ("float32", 5, 16, 2, True), ("float32", 37, 8, 1, False)])
def test_layer_function_matches_jax_vjp(monkeypatch, dtype, b, h, layers,
                                        reverse):
    """``ops.rnn.lstm`` (every layer through the layer Function: one
    ``lstm_layer_fused`` and one BPTT call a layer) against the JAX
    ``rnn.lstm(fused=True)`` at T 7: outputs, hT, cT and the gradients of
    x, h0, c0 and every layer's wx, wh and b."""
    rng = np.random.RandomState(b * h + layers)
    t, i = 7, 6
    x = rng.normal(0, 1, (t, b, i)).astype(np.float32)
    h0 = rng.normal(0, 0.3, (layers, b, h)).astype(np.float32)
    c0 = rng.normal(0, 0.3, (layers, b, h)).astype(np.float32)
    ws = [a for w in _weights(rng, layers, i, h) for a in w]

    def jfn(x, h0, c0, *w):
        return jrnn.lstm(x, h0, c0, [jrnn.LSTMWeights(*w[k:k + 3])
                                     for k in range(0, len(w), 3)],
                         reverse=reverse, fused=True)

    def tfn(x, h0, c0, *w):
        return trnn.lstm(x, h0, c0, [trnn.LSTMWeights(*w[k:k + 3])
                                     for k in range(0, len(w), 3)],
                         reverse=reverse)

    layer = _Spy(trnn.lstm_layer_fused)
    bwd = _Spy(TK.lstm_layer_bwd)
    before = (TK.lstm_layer.launches, TK.lstm_point.launches,
              bwd.fn.launches)
    monkeypatch.setattr(trnn, "lstm_layer_fused", layer)
    monkeypatch.setattr(TK, "lstm_layer_bwd", bwd)
    _vjp_both(jfn, tfn, [x, h0, c0] + ws, dtype)
    assert (layer.calls, bwd.calls) == (layers, layers)
    # the CPU runs the plain versions: no launch is counted
    assert (TK.lstm_layer.launches, TK.lstm_point.launches,
            bwd.fn.launches) == before


@pytest.mark.parametrize("layers", [1, 2])
def test_bidirectional_lstm_bf16_matches_jax_vjp(monkeypatch, layers):
    """``bidirectional_lstm`` in bf16, each direction through the layer
    Function, against the JAX package's with the Pallas fused cell
    (``DT_PALLAS_RNN=1``, interpret mode): outputs (T, B, 2H), hT, cT and
    every gradient, B 5, H 8, T 7."""
    monkeypatch.setenv("DT_PALLAS_RNN", "1")
    rng = np.random.RandomState(10 + layers)
    t, b, i, h = 7, 5, 6, 8
    x = rng.normal(0, 1, (t, b, i)).astype(np.float32)
    h0 = rng.normal(0, 0.3, (2 * layers, b, h)).astype(np.float32)
    c0 = rng.normal(0, 0.3, (2 * layers, b, h)).astype(np.float32)
    fw = [a for w in _weights(rng, layers, i, h, 2) for a in w]
    bw = [a for w in _weights(rng, layers, i, h, 2) for a in w]
    n = 3 * layers

    def split(w, make):
        return [make(*w[k:k + 3]) for k in range(0, len(w), 3)]

    def jfn(x, h0, c0, *w):
        return jrnn.bidirectional_lstm(x, h0, c0,
                                       split(w[:n], jrnn.LSTMWeights),
                                       split(w[n:], jrnn.LSTMWeights))

    def tfn(x, h0, c0, *w):
        return trnn.bidirectional_lstm(x, h0, c0,
                                       split(w[:n], trnn.LSTMWeights),
                                       split(w[n:], trnn.LSTMWeights))

    bwd = _Spy(TK.lstm_layer_bwd)
    monkeypatch.setattr(TK, "lstm_layer_bwd", bwd)
    _vjp_both(jfn, tfn, [x, h0, c0] + fw + bw, "bfloat16", seed=7)
    assert bwd.calls == 2 * layers


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("reverse", [False, True])
def test_plain_bptt_is_autograd_of_the_stepped_cell(dtype, reverse):
    """The plain BPTT gives, bit for bit, what autograd gives through the
    stepped fused cell on the same xw: the loop ``gates = (xw_t + h @
    wh).float() + b``, ``lstm_pointwise``, h and c cast to the layer's
    dtype.  dG is the gradient of xw, then dh0 and dc0 (bf16: the sums of
    the outside and carried gradients in bf16, the cotangents of
    ``.float()`` rounded, dh a bf16 product)."""
    rng = np.random.RandomState(3)
    t, b, h = 6, 4, 8

    def arr(*shape, scale=1.0):
        return torch.from_numpy(rng.normal(0, scale, shape)
                                .astype(np.float32)).to(dtype)

    xw, h0, c0 = arr(t, b, 4 * h), arr(b, h, scale=0.3), arr(b, h, scale=0.3)
    wh, bias = arr(h, 4 * h, scale=0.3), arr(4 * h, scale=0.1)
    dhs, dcs = arr(t, b, h), arr(t, b, h)
    f32 = dtype == torch.float32
    if f32:  # an f32 layer's xw holds the bias
        xw, bias = xw + bias, None
    leaves = [a.clone().requires_grad_() for a in (xw, h0, c0)]
    hh, cc = leaves[1], leaves[2]
    hs, cs = [None] * t, [None] * t
    for s in range(t):
        k = t - 1 - s if reverse else s
        gates = leaves[0][k] + hh @ wh if f32 \
            else (leaves[0][k] + hh @ wh).float() + bias
        h32, c32 = TK.lstm_pointwise(gates, cc.float())
        hh, cc = h32.to(dtype), c32.to(dtype)
        hs[k], cs[k] = hh, cc
    loss = sum((a.float() * g.float()).sum()
               for a, g in zip(hs + cs, list(dhs) + list(dcs)))
    want = torch.autograd.grad(loss, leaves)
    p_hs, p_cs, p_gates = TK.lstm_layer_plain(xw, h0, c0, wh, reverse,
                                              b=bias)
    assert torch.equal(p_hs, torch.stack(hs).detach())
    assert torch.equal(p_cs, torch.stack(cs).detach())
    got = TK.lstm_layer_bwd(p_gates, p_cs, c0, wh, dhs, dcs, reverse)
    for a, w in zip(got, want):
        assert a.dtype == w.dtype == dtype
        assert torch.equal(a, w)


@pytest.mark.parametrize("batch,hidden,want", [
    (32, 200, (16, 8, 4, 2, True)), (32, 650, (16, 2, 16, 1, True)),
    (5, 8, (8, 5, 1, 1, True)), (37, 16, (16, 10, 4, 1, True)),
    (1, 7, (7, 1, 1, 1, True)), (512, 200, (16, 16, 32, 2, True)),
    (32, 1500, (16, 8, 4, 1, False))])
def test_layer_geometry_bf16(batch, hidden, want):
    """The bf16 layer kernel's launch: (cluster size, rows a cluster,
    clusters, slices of the k tiles, Wh in shared memory): at most 16 rows
    (one m16 tile), fewer where that lets Wh's columns into shared memory
    (H 650: 2 rows, 16 clusters); the layout fits 227 KB and the pairs the
    threads, and the clusters cover the batch."""
    geo = TK.layer_geometry(batch, hidden, torch.bfloat16)
    assert (geo.n, geo.rows, geo.clusters, geo.ks, geo.wsm) == want
    nbytes, ks, threads = TK._layer_bytes_bf16(hidden, geo.n, geo.rows,
                                               geo.wsm)
    assert geo.smem == nbytes <= TK._LAYER_SMEM and ks == geo.ks
    assert threads and geo.rows <= TK._LAYER_BF16_ROWS
    assert geo.clusters * geo.rows >= batch > (geo.clusters - 1) * geo.rows
    with pytest.raises(ValueError, match="too wide"):
        TK.layer_geometry(4, 40000, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,hidden,want", [
    (32, 200, {torch.float32: (16, 8, 4, 32, True),
               torch.bfloat16: (16, 8, 4, 32, True)}),
    (32, 650, {torch.float32: (16, 8, 4, 23, False),
               torch.bfloat16: (16, 8, 4, 23, False)}),
    (3, 7, {torch.float32: (7, 3, 1, 32, True),
            torch.bfloat16: (7, 3, 1, 32, True)})])
def test_layer_bwd_geometry(dtype, batch, hidden, want):
    """The BPTT kernel's launch in both dtypes at the PTB shapes and a small
    one: the layout fits 227 KB, the tiles and pairs the threads, and the
    clusters cover the batch."""
    geo = TK.layer_bwd_geometry(batch, hidden, dtype)
    assert (geo.n, geo.rows, geo.clusters, geo.ks, geo.wsm) == want[dtype]
    size = torch.tensor([], dtype=dtype).element_size()
    nbytes, ks, threads = TK._layer_bwd_bytes(hidden, geo.n, geo.rows,
                                              geo.wsm, size)
    assert geo.smem == nbytes <= TK._LAYER_SMEM and ks == geo.ks and threads
    assert geo.clusters * geo.rows >= batch > (geo.clusters - 1) * geo.rows


@pytest.mark.parametrize("dtype,top", [(torch.float32, 6404),
                                       (torch.bfloat16, 14085)])
def test_layer_fits_covers_both_kernels(dtype, top):
    """``layer_fits`` holds where both the forward and the backward kernel
    take one row a cluster: f32 up to H 6404 (the forward's limit), bf16
    up to H 14085 (the backward's dG buffers); never at B or H 0."""
    for batch in (1, 32):
        assert TK.layer_fits(batch, top, dtype)
        assert not TK.layer_fits(batch, top + 1, dtype)
        TK.layer_geometry(batch, top, dtype)
        TK.layer_bwd_geometry(batch, top, dtype)
    assert not TK.layer_fits(0, 200, dtype)
    assert not TK.layer_fits(4, 0, dtype)


@pytest.mark.parametrize("case,want", [("bf16", "layer"),
                                       ("bf16 x, f32 weights", "cell"),
                                       ("bf16 too wide", "cell")])
def test_lstm_routes_bf16_layers(monkeypatch, case, want):
    """``ops.rnn.lstm`` sends a bf16 layer with bf16 weights that
    ``layer_fits`` to ``lstm_layer_fused``; a bf16 input with f32 weights
    and a layer too wide for the kernels step ``lstm_cell_fused`` (the two
    stubbed here)."""
    calls = []
    hidden = 14086 if case == "bf16 too wide" else 8
    wdt = torch.float32 if "f32" in case else torch.bfloat16

    def layer(x, h0, c0, w, reverse):
        calls.append("layer")
        return x.new_zeros(x.shape[0], x.shape[1], hidden), \
            x.new_zeros(x.shape[0], x.shape[1], hidden)

    def cell(x, h, c, w):
        calls.append("cell")
        return h, c

    monkeypatch.setattr(trnn, "lstm_layer_fused", layer)
    monkeypatch.setattr(trnn, "lstm_cell_fused", cell)
    x = torch.zeros(3, 1, 4, dtype=torch.bfloat16)
    h0 = torch.zeros(1, 1, hidden, dtype=torch.bfloat16)
    w = trnn.LSTMWeights(torch.zeros(1, dtype=wdt), torch.zeros(1, dtype=wdt),
                         torch.zeros(1, dtype=wdt))
    outs, _, _ = trnn.lstm(x, h0, h0, [w])
    assert set(calls) == {want}
    assert len(calls) == (3 if want == "cell" else 1)
    assert outs.shape == (3, 1, hidden)


def test_bf16_wrappers_check_inputs():
    """A bf16 layer needs its b; an f32 one's xw holds the bias; the
    backward takes one dtype throughout and f32 gates."""
    bf = torch.bfloat16
    xw = torch.zeros(2, 3, 16, dtype=bf)
    h0 = torch.zeros(3, 4, dtype=bf)
    wh = torch.zeros(4, 16, dtype=bf)
    b = torch.zeros(16, dtype=bf)
    hs, cs, gates = TK.lstm_layer(xw, h0, h0, wh, b=b)
    assert hs.dtype == cs.dtype == bf and gates.dtype == torch.float32
    with pytest.raises(ValueError, match="needs b"):
        TK.lstm_layer(xw, h0, h0, wh)
    with pytest.raises(ValueError, match="bfloat16"):
        TK.lstm_layer(xw, h0, h0, wh.float(), b=b)
    with pytest.raises(ValueError, match="b must be None"):
        TK.lstm_layer(xw.float(), h0.float(), h0.float(), wh.float(), b=b)
    dg, dh0, dc0 = TK.lstm_layer_bwd(gates, cs, h0, wh, hs, cs)
    assert dg.shape == (2, 3, 16) and dg.dtype == dh0.dtype == bf
    with pytest.raises(ValueError, match="float32"):
        TK.lstm_layer_bwd(gates.to(bf), cs, h0, wh, hs, cs)
    with pytest.raises(ValueError, match="bfloat16"):
        TK.lstm_layer_bwd(gates, cs, h0, wh.float(), hs, cs)
    with pytest.raises(ValueError, match="fit"):
        TK.lstm_layer_bwd(gates, cs, h0, wh[:, :8], hs, cs)
