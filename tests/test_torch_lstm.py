"""The port's LSTM path against the JAX package's, on the CPU.

``lstm_pointwise`` (the kernel's wrapper; on the CPU its plain version) and
its backward against the Pallas ``lstm_pointwise`` in interpret mode and its
custom VJP; ``lstm_cell_fused`` and ``lstm_cell`` against ``rnn.lstm_cell``;
a multi-layer ``lstm``; the LSTM LM's logits and state; ``clip_global_norm``;
and one PTB training step (``examples/train_lstm_ptb.py:81-92``) against the
JAX step, with the state carried into a second window.  Inputs and weights
are seeded numpy.  Tolerances: 1e-6 absolute for the pointwise stage (f32
activations in [-1, 1]: a few ulps); 1e-5 for what passes through matmuls;
the step as in ``tests/test_torch_transformer.py``.
"""

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree

from dt_tpu import models as jmodels
from dt_tpu import optim as joptim
from dt_tpu.ops import losses as jlosses
from dt_tpu.ops import rnn as jrnn
from dt_tpu.ops import tensor as jtensor
from dt_tpu.ops.pallas import kernels as JK
from dt_tpu.training.train_state import TrainState as JaxState
from dt_tpu_torch import models as tmodels
from dt_tpu_torch import optim as toptim
from dt_tpu_torch.interchange import load_jax_train_state, load_jax_variables
from dt_tpu_torch.ops import kernels as TK
from dt_tpu_torch.ops import rnn as trnn
from dt_tpu_torch.ops.tensor import clip_global_norm
from dt_tpu_torch.training.flat import FlatLayout
from dt_tpu_torch.training.step import BPTTLoss, grad_step, train_step
from dt_tpu_torch.training.train_state import TrainState
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

POINT = dict(rtol=0, atol=1e-6)
MATMUL = dict(rtol=1e-5, atol=1e-5)


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


@pytest.mark.parametrize("b,h", [(5, 8), (37, 16), (300, 4)])
def test_lstm_pointwise_forward_and_vjp_match_pallas(b, h):
    """Ragged batches (5 and 37 rows; 300 rows pad to two 256-row blocks on
    the TPU side), forward and VJP."""
    rng = np.random.RandomState(b)
    gates = rng.normal(0, 2, (b, 4 * h)).astype(np.float32)
    c = rng.normal(0, 1, (b, h)).astype(np.float32)
    gh = rng.normal(0, 1, (b, h)).astype(np.float32)
    gc = rng.normal(0, 1, (b, h)).astype(np.float32)
    (jh, jc), vjp = jax.vjp(lambda g, c: JK.lstm_pointwise(g, c, 256, True),
                            jnp.asarray(gates), jnp.asarray(c))
    jdg, jdc = vjp((jnp.asarray(gh), jnp.asarray(gc)))
    tg, tc = (torch.from_numpy(a).requires_grad_() for a in (gates, c))
    before = TK.lstm_point.launches
    th, tc_new = TK.lstm_pointwise(tg, tc)
    assert TK.lstm_point.launches == before  # CPU: the plain version
    assert th.dtype == tc_new.dtype == torch.float32
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh), **POINT)
    np.testing.assert_allclose(tc_new.detach().numpy(), np.asarray(jc),
                               **POINT)
    tdg, tdc = torch.autograd.grad((th, tc_new), (tg, tc),
                                   (torch.from_numpy(gh),
                                    torch.from_numpy(gc)))
    np.testing.assert_allclose(tdg.numpy(), np.asarray(jdg), **POINT)
    np.testing.assert_allclose(tdc.numpy(), np.asarray(jdc), **POINT)


def test_lstm_pointwise_keeps_c_dtype_and_checks_shapes():
    gates = torch.randn(3, 8)
    c = torch.randn(3, 2).to(torch.bfloat16)
    h, c_new = TK.lstm_point(gates, c)
    assert h.dtype == torch.float32 and c_new.dtype == torch.bfloat16
    want_h, want_c = TK.lstm_pointwise_plain(gates, c)
    assert torch.equal(h, want_h) and torch.equal(c_new, want_c)
    with pytest.raises(ValueError, match="gates"):
        TK.lstm_point(torch.randn(3, 7), c)
    with pytest.raises(TypeError, match="float32"):
        TK.lstm_point(gates.double(), c)


def _weights(rng, layers, inp, hidden):
    s = 1.0 / np.sqrt(hidden)
    return [tuple(rng.uniform(-s, s, shape).astype(np.float32)
                  for shape in ((inp if i == 0 else hidden, 4 * hidden),
                                (hidden, 4 * hidden), (4 * hidden,)))
            for i in range(layers)]


def test_cells_match_jax_lstm_cell():
    rng = np.random.RandomState(0)
    x = rng.normal(0, 1, (7, 12)).astype(np.float32)
    h = rng.normal(0, 0.5, (7, 10)).astype(np.float32)
    c = rng.normal(0, 0.5, (7, 10)).astype(np.float32)
    w = _weights(rng, 1, 12, 10)[0]
    want_h, want_c = jrnn.lstm_cell(*(jnp.asarray(a) for a in (x, h, c)),
                                    jrnn.LSTMWeights(*map(jnp.asarray, w)))
    tw = trnn.LSTMWeights(*map(torch.from_numpy, w))
    for cell in (trnn.lstm_cell, TK.lstm_cell_fused):
        got_h, got_c = cell(*map(torch.from_numpy, (x, h, c)), tw)
        np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h),
                                   **MATMUL)
        np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c),
                                   **MATMUL)


@pytest.mark.parametrize("reverse", [False, True])
def test_multilayer_lstm_matches_jax(reverse):
    """Two layers over 6 steps against the JAX fused (Pallas interpret)
    path, outputs and final states, and the input gradient of a sum."""
    rng = np.random.RandomState(1)
    t, b, i, h = 6, 3, 5, 8
    x = rng.normal(0, 1, (t, b, i)).astype(np.float32)
    h0 = rng.normal(0, 0.3, (2, b, h)).astype(np.float32)
    c0 = rng.normal(0, 0.3, (2, b, h)).astype(np.float32)
    ws = _weights(rng, 2, i, h)

    def jrun(x):
        y, hT, cT = jrnn.lstm(x, jnp.asarray(h0), jnp.asarray(c0),
                              [jrnn.LSTMWeights(*map(jnp.asarray, w))
                               for w in ws], reverse=reverse, fused=True)
        return y.sum() + hT.sum() + cT.sum(), (y, hT, cT)

    (_, want), jgx = jax.value_and_grad(jrun, has_aux=True)(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    got = trnn.lstm(tx, torch.from_numpy(h0), torch.from_numpy(c0),
                    [trnn.LSTMWeights(*map(torch.from_numpy, w))
                     for w in ws], reverse=reverse)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b_),
                                   **MATMUL)
    gx, = torch.autograd.grad(sum(a.sum() for a in got), tx)
    np.testing.assert_allclose(gx.numpy(), np.asarray(jgx), **MATMUL)
    plain = trnn.lstm(tx, torch.from_numpy(h0), torch.from_numpy(c0),
                      [trnn.LSTMWeights(*map(torch.from_numpy, w))
                       for w in ws], reverse=reverse, fused=False)
    for a, b_ in zip(plain, got):
        np.testing.assert_allclose(a.detach().numpy(), b_.detach().numpy(),
                                   **MATMUL)


def _layer_case(seed, t=5, b=3, i=6, h=16, layers=2):
    """Seeded inputs, states, weights and output cotangents of a
    ``layers``-layer LSTM."""
    rng = np.random.RandomState(seed)
    arrays = dict(
        x=rng.normal(0, 1, (t, b, i)).astype(np.float32),
        h0=rng.normal(0, 0.3, (layers, b, h)).astype(np.float32),
        c0=rng.normal(0, 0.3, (layers, b, h)).astype(np.float32))
    ws = _weights(rng, layers, i, h)
    cot = [rng.normal(0, 1, shape).astype(np.float32)
           for shape in ((t, b, h), (layers, b, h), (layers, b, h))]
    return arrays, ws, cot


def _lstm_grads(arrays, ws, cot, run):
    """Outputs of ``run(x, h0, c0, weights)`` (an LSTM over the seeded
    inputs) and the gradients of sum(out * cot) for x, h0, c0 and every
    layer's wx, wh, b."""
    leaves = {k: torch.from_numpy(v).requires_grad_()
              for k, v in arrays.items()}
    tw = [trnn.LSTMWeights(*(torch.from_numpy(a).requires_grad_()
                             for a in w)) for w in ws]
    out = run(leaves["x"], leaves["h0"], leaves["c0"], tw)
    loss = sum((o * torch.from_numpy(g)).sum() for o, g in zip(out, cot))
    params = list(leaves.values()) + [a for w in tw for a in w]
    grads = torch.autograd.grad(loss, params)
    return [o.detach().numpy() for o in out], [g.numpy() for g in grads]


def _step_loop(cell, reverse):
    """A multi-layer LSTM as a loop of ``cell`` over the steps, with
    autograd's own backward."""
    def run(x, h0, c0, weights):
        outs, hs, cs = x, [], []
        for layer, w in enumerate(weights):
            h, c = h0[layer], c0[layer]
            ys = [None] * outs.shape[0]
            for t in (range(outs.shape[0])[::-1] if reverse
                      else range(outs.shape[0])):
                h, c = cell(outs[t], h, c, w)
                ys[t] = h
            outs = torch.stack(ys)
            hs.append(h)
            cs.append(c)
        return outs, torch.stack(hs), torch.stack(cs)
    return run


def _layer_lstm(reverse):
    return lambda x, h0, c0, w: trnn.lstm(x, h0, c0, w, reverse=reverse)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_layer_function_matches_jax(reverse):
    """The layer Function (on the CPU: the plain step loop forward, the
    explicit BPTT backward), two layers, T 5, B 3, H 16, against the JAX
    ``rnn.lstm(fused=True)`` with the Pallas cell in interpret mode:
    outputs, hT and cT, and ``jax.grad`` for x, h0, c0, wx, wh and b
    (1e-5: f32 through matmuls)."""
    arrays, ws, cot = _layer_case(5)

    def jloss(x, h0, c0, jws):
        out = jrnn.lstm(x, h0, c0, [jrnn.LSTMWeights(*w) for w in jws],
                        reverse=reverse, fused=True)
        return sum((o * jnp.asarray(g)).sum() for o, g in zip(out, cot)), \
            out

    jargs = [jnp.asarray(arrays[k]) for k in ("x", "h0", "c0")] + \
        [[tuple(jnp.asarray(a) for a in w) for w in ws]]
    (_, want), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2, 3),
                                       has_aux=True)(*jargs)
    want_grads = list(jg[:3]) + [a for w in jg[3] for a in w]
    before = TK.lstm_layer.launches
    got, grads = _lstm_grads(arrays, ws, cot, _layer_lstm(reverse))
    assert TK.lstm_layer.launches == before  # CPU: the plain version
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b_), **MATMUL)
    assert len(grads) == len(want_grads) == 9
    for a, b_ in zip(grads, want_grads):
        np.testing.assert_allclose(a, np.asarray(b_), **MATMUL)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_layer_backward_matches_autograd_of_the_step_loop(reverse):
    """The explicit BPTT backward against autograd through the per-step
    loops (the fused cell, and the plain ``lstm_cell``): the same outputs
    and gradients (1e-5)."""
    arrays, ws, cot = _layer_case(6, t=7, b=4, i=5, h=12)
    got, grads = _lstm_grads(arrays, ws, cot, _layer_lstm(reverse))
    for cell in (TK.lstm_cell_fused, trnn.lstm_cell):
        want, want_grads = _lstm_grads(arrays, ws, cot,
                                       _step_loop(cell, reverse))
        for a, b_ in zip(got + grads, want + want_grads):
            np.testing.assert_allclose(a, b_, **MATMUL)


def test_lstm_layer_plain_and_wrapper_check_inputs():
    """The wrapper on the CPU is its plain version; hs, cs and gates in
    time order also under ``reverse``; shapes and dtypes are checked."""
    rng = np.random.RandomState(7)
    xw = _t(rng.normal(0, 1, (4, 2, 12)))
    h0, c0 = _t(rng.normal(0, 1, (2, 3))), _t(rng.normal(0, 1, (2, 3)))
    wh = _t(rng.normal(0, 0.5, (3, 12)))
    hs, cs, gates = TK.lstm_layer(xw, h0, c0, wh, reverse=True)
    h, c = h0, c0
    for t in (3, 2, 1, 0):
        g = xw[t] + h @ wh
        h, c = TK.lstm_pointwise_plain(g, c)
        assert torch.equal(gates[t], g)
        assert torch.equal(hs[t], h) and torch.equal(cs[t], c)
    with pytest.raises(ValueError, match="fit"):
        TK.lstm_layer(xw, h0, c0, wh[:, :8])
    with pytest.raises(ValueError, match="float32"):
        TK.lstm_layer(xw.double(), h0, c0, wh)
    with pytest.raises(ValueError, match="T >= 1"):
        TK.lstm_layer(xw[:0], h0, c0, wh)


@pytest.mark.parametrize("batch,hidden,want", [
    (32, 200, (16, 8, 4, 8, True)), (32, 650, (16, 8, 4, 6, False)),
    (3, 16, (16, 3, 1, 8, True)), (33, 650, (16, 9, 4, 4, False)),
    (1, 7, (7, 1, 1, 8, True)), (512, 200, (16, 103, 5, 1, False))])
def test_layer_geometry(batch, hidden, want):
    """The layer kernel's launch: (cluster size, rows a cluster, clusters,
    input slices, Wh in shared memory) at the PTB shapes, small and ragged
    batches; the layout fits 227 KB and the threads, and the clusters
    cover the batch."""
    geo = TK.layer_geometry(batch, hidden)
    assert (geo.n, geo.rows, geo.clusters, geo.ks, geo.wsm) == want
    floats, tiles, pairs = TK._layer_floats(hidden, geo.n, geo.rows, geo.ks,
                                            geo.wsm)
    assert geo.smem == 4 * floats <= TK._LAYER_SMEM
    assert tiles * geo.ks <= TK._LAYER_THREADS
    assert pairs <= TK._LAYER_PAIRS * TK._LAYER_THREADS
    assert geo.clusters * geo.rows >= batch > (geo.clusters - 1) * geo.rows
    with pytest.raises(ValueError, match="too wide"):
        TK.layer_geometry(4, 40000)


@pytest.mark.parametrize("batch", [1, 32, 512])
def test_layer_fits_is_the_geometry_s_domain(batch):
    """``layer_fits`` is True exactly where ``layer_geometry`` gives a
    launch: up to H 6404 at any batch (one row a cluster), not at 6405 or
    the 6656 that used to fail on the card."""
    for hidden in (1, 200, 650, 6404, 6405, 6656, 40000):
        try:
            TK.layer_geometry(batch, hidden)
            ok = True
        except ValueError:
            ok = False
        assert TK.layer_fits(batch, hidden) == ok == (hidden <= 6404)
    assert not TK.layer_fits(0, 200) and not TK.layer_fits(batch, 0)


@pytest.mark.parametrize("hidden,want", [(6656, "cell"), (6404, "layer"),
                                         (200, "layer")])
def test_lstm_routes_a_wide_f32_layer_to_the_fused_cell(monkeypatch, hidden,
                                                        want):
    """``ops.rnn.lstm`` picks the route from the shape before any launch:
    an f32 layer the layer kernel takes goes to ``lstm_layer_fused``, a
    wider one (H 6656) steps ``lstm_cell_fused`` (the two kernels stubbed
    here, so no H 6656 weights are made; bf16 in
    ``test_torch_lstm_bf16.py``)."""
    calls = []

    def layer(x, h0, c0, w, reverse):
        calls.append("layer")
        return x.new_zeros(x.shape[0], x.shape[1], hidden), \
            x.new_zeros(x.shape[0], x.shape[1], hidden)

    def cell(x, h, c, w):
        calls.append("cell")
        return h, c

    monkeypatch.setattr(trnn, "lstm_layer_fused", layer)
    monkeypatch.setattr(trnn, "lstm_cell_fused", cell)
    x = torch.zeros(3, 1, 4)
    h0 = torch.zeros(1, 1, hidden)
    outs, h_t, c_t = trnn.lstm(x, h0, h0, [None])
    assert set(calls) == {want}
    assert len(calls) == (3 if want == "cell" else 1)
    assert outs.shape == (3, 1, hidden) and h_t.shape == (1, 1, hidden)


def _fill(shapes, seed):
    """Seeded weights for an LSTM LM tree by leaf name."""
    rng = np.random.RandomState(seed)

    def one(path, s):
        k = path[-1].key
        if k == "embedding":
            return rng.normal(0, 1, s.shape).astype(np.float32)
        if k == "kernel":
            return (rng.normal(0, 1, s.shape)
                    / np.sqrt(s.shape[0])).astype(np.float32)
        if k.endswith("_wx") or k.endswith("_wh"):
            lim = 1.0 / np.sqrt(s.shape[1] // 4)
            return rng.uniform(-lim, lim, s.shape).astype(np.float32)
        return rng.normal(0, 0.1, s.shape).astype(np.float32)  # biases

    return jax.tree_util.tree_map_with_path(one, shapes)


CFG = dict(vocab_size=40, embed_dim=12, hidden=12, num_layers=2)


def _jax_lm(tie, dropout=0.0):
    model = jmodels.create("lstm_lm", dropout=dropout, tie_weights=tie,
                           **CFG)
    toks = jnp.zeros((5, 3), jnp.int32)
    params = _fill(jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, toks, training=False)),
        seed=int(tie))["params"]
    return model, params


@pytest.mark.parametrize("tie", [False, True])
def test_lstm_lm_logits_and_state_match_jax(tie):
    model, params = _jax_lm(tie)
    rng = np.random.RandomState(2)
    toks = rng.randint(0, CFG["vocab_size"], (7, 3)).astype(np.int32)
    h0 = rng.normal(0, 0.3, (2, 3, 12)).astype(np.float32)
    c0 = rng.normal(0, 0.3, (2, 3, 12)).astype(np.float32)
    logits, (hT, cT) = model.apply({"params": params}, jnp.asarray(toks),
                                   state=(jnp.asarray(h0), jnp.asarray(c0)),
                                   training=False)
    port = load_jax_variables(
        tmodels.create("lstm_lm", device="cpu", dropout=0.2,
                       tie_weights=tie, **CFG), {"params": params})
    assert ("Dense_0.weight" in dict(port.named_parameters())) != tie
    got, (gh, gc) = port(torch.from_numpy(toks).long(),
                         (torch.from_numpy(h0), torch.from_numpy(c0)),
                         training=False)
    assert got.shape == (7, 3, CFG["vocab_size"])
    for a, b in ((got, logits), (gh, hT), (gc, cT)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   **MATMUL)


def test_dropout_in_training_needs_a_generator_and_keeps_its_rate():
    port = tmodels.create("lstm_lm", device="cpu", dropout=0.5, **CFG)
    toks = torch.zeros(4, 2, dtype=torch.long)
    with pytest.raises(ValueError, match="Generator"):
        port(toks)
    a, _ = port(toks, generator=torch.Generator().manual_seed(0))
    b, _ = port(toks, generator=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)


def test_clip_global_norm_matches_jax():
    rng = np.random.RandomState(3)
    tree = {"a": rng.normal(0, 1, (4, 5)).astype(np.float32),
            "b": rng.normal(0, 1, (7,)).astype(np.float32)}
    for max_norm in (0.25, 100.0):
        want, wnorm = jtensor.clip_global_norm(
            jax.tree_util.tree_map(jnp.asarray, tree), max_norm)
        got, norm = clip_global_norm(
            {k: torch.from_numpy(v) for k, v in tree.items()}, max_norm)
        np.testing.assert_allclose(float(norm), float(wnorm), rtol=1e-6)
        for k in tree:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-6, atol=1e-7)


def test_ptb_step_matches_jax_and_carries_state():
    """Two BPTT windows of the PTB example's step (SGD lr 1.0, clip 0.25,
    dropout 0 here: the two sides' dropout bits differ), the port set to the
    JAX state before each: loss 1e-5 relative, the clipped gradient and the
    params 1e-4 of their norm, and the carried state."""
    model, params = _jax_lm(False)
    vocab, clip = CFG["vocab_size"], 0.25
    tx = joptim.create("sgd", learning_rate=1.0)

    @jax.jit
    def jstep(state, inp, tgt, h, c):
        def loss_of(p):
            logits, (hT, cT) = model.apply({"params": p}, inp, state=(h, c),
                                           training=True)
            return jlosses.softmax_cross_entropy(
                logits.reshape(-1, vocab), tgt.reshape(-1)), (hT, cT)
        (loss, (hT, cT)), grads = jax.value_and_grad(
            loss_of, has_aux=True)(state.params)
        grads, _ = jtensor.clip_global_norm(grads, clip)
        return (state.apply_gradients(grads), loss, hT, cT,
                ravel_pytree(grads)[0])

    rng = np.random.RandomState(4)
    stream = rng.randint(0, vocab, (11, 3)).astype(np.int32)
    js = JaxState.create(None, params, tx, {})
    port = load_jax_variables(tmodels.create("lstm_lm", device="cpu",
                                             dropout=0.0, **CFG),
                              {"params": params})
    ts = TrainState.create(port, toptim.create("sgd", learning_rate=1.0))
    assert FlatLayout(port).stats.size == 0
    h = c = jnp.zeros((2, 3, 12))
    loss_fn = BPTTLoss()
    for i in (0, 5):
        load_jax_train_state(ts, {
            "step": js.step, "params": js.params, "batch_stats": {},
            "opt_state": flax.serialization.to_state_dict(js.opt_state)})
        inp, tgt = stream[i:i + 5], stream[i + 1:i + 6]
        js, jloss, h, c, jg = jstep(js, jnp.asarray(inp), jnp.asarray(tgt),
                                    h, c)
        flat_g = grad_step(ts, torch.from_numpy(inp).long(),
                           torch.from_numpy(tgt).long(),
                           BPTTLoss(state=loss_fn.state))[0]
        got_g = clip_global_norm({"g": flat_g}, clip)[0]["g"]
        _, loss, _ = train_step(ts, torch.from_numpy(inp).long(),
                                torch.from_numpy(tgt).long(),
                                loss_fn=loss_fn, clip_norm=clip)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        jg = np.asarray(jg)
        assert np.linalg.norm(got_g.numpy() - jg) <= 1e-4 * np.linalg.norm(jg)
        want_p = np.asarray(ravel_pytree(js.params)[0])
        got_p = ts.layout.params.ravel(ts.params).numpy()
        assert np.linalg.norm(got_p - want_p) <= \
            1e-4 * np.linalg.norm(want_p)
        for a, b in zip(loss_fn.state, (h, c)):
            assert not a.requires_grad
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **MATMUL)
