"""The port's training step against the JAX package's, on the CPU.

``bench.py``'s ``train_step`` (``model.apply(training=True)``,
``softmax_cross_entropy``, gradients, SGD with momentum 0.9, lr 0.1, wd
1e-4, the new BN stats) runs jitted on a ``dt_tpu`` ``TrainState``; the port
runs ``grad_step`` + ``apply_step`` on its own ``TrainState``.  Before each
step the port is set to the JAX state with ``load_jax_train_state``, so
each step is compared from the same state and an earlier step's rounding is
not carried (a ReLU mask flipped by one ulp would otherwise send the two
trajectories apart).  Compared per step: loss, ``flat_g`` (the JAX
``ravel_pytree`` of the gradient), and after the update the params, the
momentum, the BN stats and the step count, each flattened in
``ravel_pytree``'s order.

``DT_PALLAS_BN=1`` makes every JAX BN the fused Pallas kernel (interpret
mode here), the port's counterpart; the default ``linen.BatchNorm`` path is
compared in f32 too.  Weights come from a seeded numpy fill of the flax
tree; inputs are seeded numpy.
"""

import os

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
from dt_tpu.parallel import compression as JC
from dt_tpu.training.train_state import TrainState as JaxState
from dt_tpu_torch import models as tmodels
from dt_tpu_torch import optim as toptim
from dt_tpu_torch.interchange import (export_jax_train_state, jax_path,
                                      load_jax_train_state,
                                      load_jax_variables)
from dt_tpu_torch.ops import kernels as TK
from dt_tpu_torch.ops.losses import softmax_cross_entropy
from dt_tpu_torch.parallel.compression import GradientCompression
from dt_tpu_torch.training import flat
from dt_tpu_torch.training.step import apply_step, grad_step, train_step
from dt_tpu_torch.training.train_state import TrainState

SGD = dict(learning_rate=0.1, momentum=0.9, weight_decay=1e-4)
# f32 bounds.  Both sides sum in other orders (batch stats, convolutions),
# so results differ in the last bits.  What depends on the forward alone is
# held tight: the loss (rtol), the new BN stats and the Dense layer's
# gradient (|port - jax| / |jax| over the flat vector).  resnet50's last
# stage normalizes over 16 rows, where E[x^2] - mean^2 loses digits, so its
# loss moves by up to ~1e-4.  The backward can
# flip a ReLU mask: a pre-activation within rounding of 0 takes the other
# side, and the gradient of every layer below moves by ~1 % (seen on
# resnet18 with linen.BatchNorm and on resnet50), so the whole gradient and
# the momentum and the params (which move by lr times it: the gradient is
# large against the weights here) are held to 5e-2.
F32 = dict(loss=1e-3, stats=1e-4, dense=1e-3, flat_g=5e-2, mom=5e-2,
           params=5e-2)
# linen.BatchNorm normalizes as (x - mean) * (inv * scale) + bias, not as
# the kernels' x * scale' + bias', so more pre-activations differ by an ulp
# and more masks flip (4 % on resnet50's first step)
F32_LINEN = dict(F32, flat_g=1e-1, mom=1e-1, params=1e-1)
# bf16 compute: the port may be no further from JAX's bf16 step than JAX's
# bf16 step is from its own f32 step on the same state (rounding to bf16
# dominates both), times this margin, plus an f32 floor.
BF16_MARGIN = 1.5
# loss, bf16: the logits are rounded to bf16 (2**-8 relative) at other
# points through the net on the two sides; the calibration above also
# applies, as resnet50's forward amplifies that rounding
BF16_LOSS = 1e-2
# the last stage of resnet18/50 at 32x32 is 1x1: with 2-4 images each BN
# there normalizes over 2-4 values, and the gradient through it is
# degenerate (1e9 and more); at 64x64 and 4 images it has 16 rows
SIZES = {"resnet20": (32, 2), "resnet18": (64, 4), "resnet50": (64, 4)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests spend their time in JAX compiles,
    and idle OpenMP threads spinning between torch ops would take cores
    from the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fill(shapes, seed=1):
    rng = np.random.RandomState(seed)

    def one(path, s):
        k = path[-1].key
        if k == "mean":
            return rng.normal(0, 0.5, s.shape).astype(np.float32)
        if k == "var":
            return rng.uniform(0.5, 2.0, s.shape).astype(np.float32)
        if k == "scale":
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        if k == "bias":
            return rng.normal(0, 0.1, s.shape).astype(np.float32)
        fan_in = int(np.prod(s.shape[:-1]))
        return (rng.normal(0, 1, s.shape)
                * np.sqrt(2.0 / fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


class _Env:
    """``DT_PALLAS_BN`` set while the JAX model is traced (flax reads it
    when the module runs)."""

    def __init__(self, fused):
        self.fused = fused

    def __enter__(self):
        self.old = os.environ.pop("DT_PALLAS_BN", None)
        if self.fused:
            os.environ["DT_PALLAS_BN"] = "1"

    def __exit__(self, *exc):
        os.environ.pop("DT_PALLAS_BN", None)
        if self.old is not None:
            os.environ["DT_PALLAS_BN"] = self.old


_CACHE = {}


def _jax_case(name, fused, dtypes=(jnp.float32,)):
    """(variables, {dtype: compiled bench train_step}, x, y), cached per
    model and BN path; each dtype's step is compiled at its first use (a
    compile takes seconds)."""
    key = (name, fused)
    if key not in _CACHE:
        size, batch = SIZES[name]
        rng = np.random.RandomState(0)
        x = rng.uniform(-1, 1, (batch, size, size, 3)).astype(np.float32)
        y = rng.randint(0, 10, (batch,)).astype(np.int32)
        with _Env(fused):
            model = jmodels.create(name, num_classes=10)
            variables = _fill(jax.eval_shape(
                lambda: model.init({"params": jax.random.PRNGKey(0)}, x,
                                   training=False)))
        _CACHE[key] = (variables, {}, x, y)
    variables, steps, x, y = _CACHE[key]
    for dtype in dtypes:
        if dtype in steps:
            continue
        with _Env(fused):
            model = jmodels.create(name, num_classes=10, dtype=dtype)

            def train_step(state, x, y, model=model):
                def loss_of(params):
                    out, mut = model.apply(
                        {"params": params, "batch_stats": state.batch_stats},
                        x, training=True, mutable=["batch_stats"])
                    return jlosses.softmax_cross_entropy(out, y), \
                        mut["batch_stats"]
                (loss, stats), grads = jax.value_and_grad(
                    loss_of, has_aux=True)(state.params)
                return (state.apply_gradients(grads).replace(
                    batch_stats=stats), loss, ravel_pytree(grads)[0])

            state = _jax_state(variables)
            steps[dtype] = jax.jit(train_step).lower(
                state, jnp.asarray(x, dtype), jnp.asarray(y)).compile()
    return _CACHE[key]


def _np_ravel(tree):
    """``ravel_pytree(tree)[0]`` as numpy for an all-f32 tree, without
    dispatching (and compiling) JAX ops leaf by leaf."""
    return np.concatenate([np.asarray(leaf, np.float32).ravel()
                           for leaf in jax.tree_util.tree_leaves(tree)])


# one optimizer object and no apply_fn: the compiled steps take any of the
# states (its static fields must match what they were compiled for)
_TX = joptim.create("sgd", **SGD)


def _jax_state(variables):
    return JaxState.create(None, variables["params"], _TX,
                           variables["batch_stats"])


def _snapshot(js):
    return {"step": js.step, "params": js.params,
            "batch_stats": js.batch_stats,
            "opt_state": flax.serialization.to_state_dict(js.opt_state)}


def _jax_flat(js, flat_g, loss):
    return {"loss": float(loss), "flat_g": np.asarray(flat_g),
            "params": _np_ravel(js.params),
            "mom": _np_ravel(js.opt_state.mom),
            "stats": _np_ravel(js.batch_stats)}


def _port_flat(ts, flat_g, loss):
    lay = ts.layout
    return {"loss": float(loss), "flat_g": flat_g.numpy(),
            "params": lay.params.ravel(ts.params).numpy(),
            "mom": lay.params.ravel(ts.opt_state["mom"]).numpy(),
            "stats": lay.stats.ravel(ts.batch_stats).numpy()}


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _run(name, dtype, fused):
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    # a bf16 case calibrates against JAX's own f32 step
    variables, steps, x, y = _jax_case(name, fused,
                                       tuple({jnp.float32, jdt}))
    tdt = getattr(torch, dtype)
    model = tmodels.create(name, device="cpu", num_classes=10, dtype=tdt)
    load_jax_variables(model, variables)
    ts = TrainState.create(model, toptim.create("sgd", **SGD),
                           "FusedBatchNorm" if fused else "BatchNorm")
    js = _jax_state(variables)
    xj, yj = jnp.asarray(x, jdt), jnp.asarray(y)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(tdt)
    yt = torch.from_numpy(y).long()
    for step in range(2):
        load_jax_train_state(ts, _snapshot(js))
        before = js
        js, loss, flat_g = steps[jdt](js, xj, yj)
        want = _jax_flat(js, flat_g, loss)
        fg, fs, loss_t, logits = grad_step(ts, xt, yt)
        assert logits.shape == (x.shape[0], 10) and logits.dtype == tdt
        apply_step(ts, fg, fs)
        got = _port_flat(ts, fg, loss_t)
        assert ts.step == int(js.step) == step + 1
        assert ts.opt_state["count"] == int(js.opt_state.count)
        dense = slice(*ts.layout.params.span("Dense_0.weight"))
        got["dense"], want["dense"] = got["flat_g"][dense], \
            want["flat_g"][dense]
        if dtype == "float32":
            np.testing.assert_allclose(got["loss"], want["loss"],
                                       rtol=F32["loss"])
            bound = F32 if fused else F32_LINEN
        else:  # JAX's own f32 step from the same state calibrates bf16
            _, loss32, fg32 = steps[jnp.float32](before, jnp.asarray(x), yj)
            ref = _jax_flat(_, fg32, loss32)
            ref["dense"] = ref["flat_g"][dense]
            np.testing.assert_allclose(
                got["loss"], want["loss"], rtol=BF16_LOSS,
                atol=BF16_MARGIN * abs(ref["loss"] - want["loss"]))
            bound = {k: BF16_MARGIN * _rel(ref[k], want[k]) + 1e-6
                     for k in want}
        for k in ("flat_g", "dense", "params", "mom", "stats"):
            assert got[k].shape == want[k].shape
            err = _rel(got[k], want[k])
            assert err <= bound[k], (step, k, err, bound[k])
    return ts, xt, yt


@pytest.mark.parametrize("name,dtype,fused", [
    ("resnet20", "float32", True), ("resnet20", "bfloat16", True),
    ("resnet20", "float32", False),
    ("resnet18", "float32", True), ("resnet18", "bfloat16", True),
    ("resnet18", "float32", False)])
def test_two_steps_match_bench_train_step(name, dtype, fused):
    _run(name, dtype, fused)


def test_compressed_leg_is_the_numpy_codec():
    """One step with the 2-bit leg: the port's device quantize/dequantize of
    ``flat_g`` is ``np_quantize_2bit`` -> ``np_dequantize_2bit`` of the same
    vector, bit for bit, and the step applies exactly that gradient."""
    ts, xt, yt = _run("resnet20", "float32", True)
    snap = export_jax_train_state(ts, "FusedBatchNorm")
    flat_g, flat_s, _, _ = grad_step(ts, xt, yt)
    load_jax_train_state(ts, snap)  # undo grad_step's running-stat move
    words, _ = JC.np_quantize_2bit(flat_g.numpy(),
                                   np.zeros(flat_g.numel(), np.float32), 0.5)
    want_g = JC.np_dequantize_2bit(words, flat_g.numel(), 0.5)
    gc = GradientCompression(0.5)
    got_words = gc.compress_on_device(flat_g)
    np.testing.assert_array_equal(got_words.numpy().view(np.uint32), words)
    got_g = gc.decompress_on_device(got_words, flat_g.numel())
    np.testing.assert_array_equal(got_g.numpy(), want_g)
    # the same step through train_step's compressed leg
    other = TrainState.create(
        load_jax_variables(tmodels.create("resnet20", device="cpu",
                                          num_classes=10),
                           {"params": snap["params"],
                            "batch_stats": snap["batch_stats"]}),
        toptim.create("sgd", **SGD), "FusedBatchNorm")
    load_jax_train_state(other, snap)
    train_step(other, xt, yt, compression=GradientCompression(0.5))
    apply_step(ts, torch.from_numpy(want_g), flat_s)
    for a, b in zip(other.module.state_dict().values(),
                    ts.module.state_dict().values()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", ["resnet50", "resnet18_v2", "resnet20"])
def test_flat_order_and_layout_are_ravel_pytree(name, fused):
    """Params and stats raveled by the port equal ``ravel_pytree`` of the
    flax trees bit for bit, under both BN namings; unravel inverts it."""
    with _Env(fused):
        x = np.zeros((1, 32, 32, 3), np.float32)
        model = jmodels.create(name, num_classes=10)
        variables = _fill(jax.eval_shape(
            lambda: model.init({"params": jax.random.PRNGKey(0)}, x,
                               training=False)), seed=4)
    port = load_jax_variables(
        tmodels.create(name, device="cpu", num_classes=10), variables)
    lay = flat.FlatLayout(port, "FusedBatchNorm" if fused else "BatchNorm")
    for coll, ravel, unravel, named in (
            ("params", lay.params.ravel, lay.params.unravel,
             dict(port.named_parameters())),
            ("batch_stats", lay.stats.ravel, lay.stats.unravel,
             dict(port.named_buffers()))):
        want = np.asarray(ravel_pytree(variables[coll])[0])
        got = ravel(named)
        np.testing.assert_array_equal(got.numpy(), want)
        back = unravel(got)
        assert back.keys() == named.keys()
        for k, t in back.items():
            assert t.shape == named[k].shape
            assert torch.equal(t, named[k].detach())
    names = [jax_path(n, lay.bn_name) for n in lay.params.names]
    assert names == sorted(names)
    if name == "resnet50":
        i10, i2 = (names.index(("BottleneckV1_%d" % i, "Conv_0", "kernel"))
                   for i in (10, 2))
        assert i10 < i2


def test_train_state_round_trip_and_checks():
    variables, _, _, _ = _jax_case("resnet20", True)
    model = load_jax_variables(
        tmodels.create("resnet20", device="cpu", num_classes=10), variables)
    ts = TrainState.create(model, toptim.create("sgd", **SGD))
    snap = export_jax_train_state(ts, "FusedBatchNorm")
    assert snap["step"] == 0 and set(snap["opt_state"]) == {"count", "mom"}
    assert "FusedBatchNorm_0" in snap["params"]
    np.testing.assert_array_equal(
        ravel_pytree(snap["params"])[0],
        ravel_pytree(jax.tree_util.tree_map(np.asarray,
                                            variables["params"]))[0])
    bad = dict(snap, opt_state={"count": 0})
    with pytest.raises(KeyError, match="opt_state"):
        load_jax_train_state(ts, bad)
    with pytest.raises(ValueError, match="bn_name"):
        jax_path("BatchNorm_0.scale", "BN")


@pytest.mark.parametrize("smoothing,ignore", [(0.0, None), (0.1, None),
                                              (0.0, 3), (0.2, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_softmax_cross_entropy_matches_jax(smoothing, ignore, dtype):
    rng = np.random.RandomState(2)
    logits = rng.normal(0, 3, (6, 5)).astype(np.float32)
    labels = np.array([0, 3, 4, 1, 3, 2], np.int32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    want = jlosses.softmax_cross_entropy(jnp.asarray(logits, jdt),
                                         jnp.asarray(labels),
                                         smoothing=smoothing,
                                         ignore_label=ignore)
    got = softmax_cross_entropy(torch.from_numpy(logits).to(
        getattr(torch, dtype)), torch.from_numpy(labels),
        smoothing=smoothing, ignore_label=ignore)
    assert got.dtype == torch.float32
    # computed in f32 from the same (bf16-rounded) logits on both sides
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_all_rows_ignored_gives_zero_loss():
    logits = torch.randn(3, 4)
    labels = torch.tensor([2, 2, 2])
    assert softmax_cross_entropy(logits, labels, ignore_label=2).item() == 0


def test_training_forward_counts_no_launch_on_cpu():
    model = tmodels.create("resnet20", device="cpu", num_classes=10)
    before = (TK.bn_stats.launches, TK.bn_act.launches)
    x = torch.randn(2, 3, 8, 8).contiguous(memory_format=torch.channels_last)
    model(x, training=True)
    assert (TK.bn_stats.launches, TK.bn_act.launches) == before
