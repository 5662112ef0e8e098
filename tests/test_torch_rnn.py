"""The rest of the port's ``ops.rnn`` against the JAX package's, on the CPU:
``gru_cell``, ``gru``, ``vanilla_cell`` (tanh and relu) and
``bidirectional_lstm`` (1 and 2 layers), values and gradients in f32 and
bf16 with the weights carried from seeded numpy; and ``init_lstm_weights``
(its shapes, dtype, bounds and zero bias: its stream is not JAX's).

Tolerances: f32 within 1e-5 (through matmuls, as ``test_torch_lstm.py``);
bf16 within 2^-6 of the largest magnitude of each output or gradient (two
bf16 ulps at the top of the range: both sides round each matmul's f32 sum
to bf16, sometimes to neighbouring values, and the steps carry it).
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

F32 = 1e-5
BF16 = 2.0 ** -6

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(got, want, dtype):
    got = np.asarray(got.detach().float().numpy() if isinstance(
        got, torch.Tensor) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=F32, atol=F32)
    else:
        tol = BF16 * max(float(np.abs(want).max()), 1e-30)
        assert float(np.abs(got - want).max()) <= tol


_JAX = {}  # the JAX side of a case, shared by the port's variants


def _grads(jfn, tfn, arrays, dtype, key=None):
    """Values and gradients of sum(out * cot) for every array, through
    ``jfn`` (JAX) and ``tfn`` (the port), each taking a list of arrays;
    ``key`` names a JAX side computed once for several port variants."""
    jd, td = DTYPES[dtype]
    if key is None or key not in _JAX:
        rng = np.random.RandomState(99)
        outs, vjp = jax.vjp(jfn, *[jnp.asarray(a, jd) for a in arrays])
        cots = [rng.normal(0, 1, np.shape(o)).astype(np.float32)
                for o in outs]
        jg = vjp(type(outs)(jnp.asarray(c, jd) for c in cots))
        _JAX[key] = outs, cots, jg
    outs, cots, jg = _JAX[key]
    targs = [torch.from_numpy(np.asarray(a, np.float32)).to(td)
             .requires_grad_() for a in arrays]
    touts = tfn(*targs)
    loss = sum((o.float() * torch.from_numpy(c)).sum()
               for o, c in zip(touts, cots))
    tg = torch.autograd.grad(loss, targs)
    for a, b in zip(touts, outs):
        assert a.dtype == td
        _close(a, b, dtype)
    for a, b in zip(tg, jg):
        _close(a, b, dtype)


def _gru_arrays(rng, layers, inp, hidden):
    s = 1.0 / np.sqrt(hidden)
    out = []
    for layer in range(layers):
        i = inp if layer == 0 else hidden
        out += [rng.uniform(-s, s, shape).astype(np.float32)
                for shape in ((i, 3 * hidden), (hidden, 3 * hidden),
                              (3 * hidden,), (3 * hidden,))]
    return out


def _split(ws, n, make):
    return [make(*ws[k:k + n]) for k in range(0, len(ws), n)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gru_cell_matches(dtype):
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1, (6, 7)).astype(np.float32)
    h = rng.normal(0, 0.5, (6, 9)).astype(np.float32)
    w = _gru_arrays(rng, 1, 7, 9)
    _grads(lambda x, h, *w: [jrnn.gru_cell(x, h, jrnn.GRUWeights(*w))],
           lambda x, h, *w: [trnn.gru_cell(x, h, trnn.GRUWeights(*w))],
           [x, h] + w, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layers,reverse", [(1, False), (2, False),
                                            (2, True)])
def test_gru_matches(dtype, layers, reverse):
    rng = np.random.RandomState(layers + 2 * reverse)
    t, b, i, h = 5, 3, 6, 8
    x = rng.normal(0, 1, (t, b, i)).astype(np.float32)
    h0 = rng.normal(0, 0.3, (layers, b, h)).astype(np.float32)
    w = _gru_arrays(rng, layers, i, h)
    _grads(lambda x, h0, *w: jrnn.gru(x, h0, _split(w, 4, jrnn.GRUWeights),
                                      reverse=reverse),
           lambda x, h0, *w: trnn.gru(x, h0, _split(w, 4, trnn.GRUWeights),
                                      reverse=reverse),
           [x, h0] + w, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["tanh", "relu"])
def test_vanilla_cell_matches(dtype, act):
    rng = np.random.RandomState(3)
    arrays = [rng.normal(0, 1, (5, 6)), rng.normal(0, 0.5, (5, 4)),
              rng.normal(0, 0.4, (6, 4)), rng.normal(0, 0.4, (4, 4)),
              rng.normal(0, 0.2, (4,))]
    arrays = [a.astype(np.float32) for a in arrays]
    _grads(lambda *a: [jrnn.vanilla_cell(*a, act=act)],
           lambda *a: [trnn.vanilla_cell(*a, act=act)], arrays, dtype)


def _lstm_arrays(rng, layers, inp, hidden):
    s = 1.0 / np.sqrt(hidden)
    out = []
    for layer in range(layers):
        i = inp if layer == 0 else 2 * hidden  # the fwd/bwd concat
        out += [rng.uniform(-s, s, shape).astype(np.float32)
                for shape in ((i, 4 * hidden), (hidden, 4 * hidden),
                              (4 * hidden,))]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("fused", [None, False])
def test_bidirectional_lstm_matches(dtype, layers, fused):
    """Outputs (T, B, 2H), hT and cT (2L, B, H) and the gradients of x, h0,
    c0 and every direction's wx, wh, b.  With ``fused`` at its default an
    f32 or bf16 direction runs the layer Function (its plain versions on
    the CPU: the step loop and the BPTT loop); ``False`` the plain cell."""
    rng = np.random.RandomState(layers)
    t, b, i, h = 6, 3, 5, 8
    x = rng.normal(0, 1, (t, b, i)).astype(np.float32)
    h0 = rng.normal(0, 0.3, (2 * layers, b, h)).astype(np.float32)
    c0 = rng.normal(0, 0.3, (2 * layers, b, h)).astype(np.float32)
    fw = _lstm_arrays(rng, layers, i, h)
    bw = _lstm_arrays(rng, layers, i, h)
    n = 3 * layers

    def jfn(x, h0, c0, *w):
        return jrnn.bidirectional_lstm(
            x, h0, c0, _split(list(w[:n]), 3, jrnn.LSTMWeights),
            _split(list(w[n:]), 3, jrnn.LSTMWeights))

    def tfn(x, h0, c0, *w):
        return trnn.bidirectional_lstm(
            x, h0, c0, _split(list(w[:n]), 3, trnn.LSTMWeights),
            _split(list(w[n:]), 3, trnn.LSTMWeights), fused=fused)

    before = (TK.lstm_layer.launches, TK.lstm_point.launches)
    _grads(jfn, tfn, [x, h0, c0] + fw + bw, dtype, key=(dtype, layers))
    # the CPU runs the plain versions: no launch is counted
    assert (TK.lstm_layer.launches, TK.lstm_point.launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_init_lstm_weights(dtype):
    g = torch.Generator().manual_seed(0)
    ws = trnn.init_lstm_weights(g, 3, 7, 16, dtype=dtype, device="cpu")
    jws = jrnn.init_lstm_weights(jax.random.PRNGKey(0), 3, 7, 16,
                                 dtype=jnp.float32 if dtype == torch.float32
                                 else jnp.bfloat16)
    assert len(ws) == len(jws) == 3
    scale = 1.0 / np.sqrt(16)
    for w, jw in zip(ws, jws):
        for a, b in zip(w, jw):
            assert tuple(a.shape) == b.shape and a.dtype == dtype
            assert a.device.type == "cpu"
        assert float(w.wx.abs().max()) <= scale
        assert float(w.wh.abs().max()) <= scale
        assert float(w.wx.float().std()) > 0.4 * scale  # U(-s, s): s/sqrt 3
        assert torch.count_nonzero(w.b) == 0
    # one generator state gives one draw; the next call draws on
    again = trnn.init_lstm_weights(torch.Generator().manual_seed(0), 3, 7,
                                   16, dtype=dtype, device="cpu")
    assert all(torch.equal(a, b) for w, v in zip(ws, again)
               for a, b in zip(w, v))
    nxt = trnn.init_lstm_weights(g, 1, 7, 16, dtype=dtype, device="cpu")
    assert not torch.equal(nxt[0].wx, ws[0].wx)


def test_init_lstm_weights_needs_a_gpu_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        trnn.init_lstm_weights(torch.Generator(), 1, 2, 3)
