"""The classification zoo and ``ops.nn`` of the port against ``dt_tpu``.

``ops.nn``: every function the port adds is held against its
``dt_tpu.ops.nn`` counterpart on the same seeded numpy inputs, an image in
NHWC on the JAX side and NCHW channels_last on the port's (1e-6 in f32, the
summation orders of the pools and of the antialiased resize differing).

Models: each family at its smallest valid input, 10 classes.  The flax tree
comes from ``jax.eval_shape`` (traced once a family) and a seeded numpy
fill (non-trivial BN running stats), the JAX eval forward runs jitted, the
same arrays are carried into the port and the logits are held within 1e-4
(f32 CPU convolutions sum in other orders).  MobileNet-v2 also runs with
``DT_PALLAS_BN=1`` (every JAX BN the Pallas kernel, interpret mode; the
carry takes ``FusedBatchNorm_<i>``).  The carry of every new tree
round-trips bit for bit; the other depths of a family are built with a
check of their tree against the JAX model's (names and shapes, no JAX
forward) and of their logits' shape.  Most of the time is the JAX side's
tracing and compiles.
"""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from dt_tpu import models as jmodels
from dt_tpu.ops import nn as jnn
from dt_tpu_torch import models as tmodels
from dt_tpu_torch.interchange import export_jax_variables, load_jax_variables
from dt_tpu_torch.models.common import FusedBatchNorm
from dt_tpu_torch.ops import nn as tnn
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

TOL = 1e-4  # f32 logits
OPS_TOL = 1e-6

# family -> (name, smallest valid input side)
FAMILIES = {
    "alexnet": ("alexnet", 64), "vgg": ("vgg11", 32),
    "vgg_bn": ("vgg11_bn", 32), "squeezenet": ("squeezenet", 32),
    "googlenet": ("googlenet", 32), "inception_bn": ("inception_bn", 32),
    "inception_v3": ("inception_v3", 75), "inception_v4": ("inception_v4", 75),
    "inception_resnet_v2": ("inception_resnet_v2", 75),
    "resnext": ("resnext50", 32), "mobilenet": ("mobilenet", 32),
    "mobilenet_v2": ("mobilenet_v2", 32), "densenet": ("densenet121", 32),
}
OTHER_DEPTHS = ["vgg13", "vgg16", "vgg19", "vgg13_bn", "vgg16_bn",
                "vgg19_bn", "resnext101", "resnext152", "densenet161",
                "densenet169", "densenet201"]


def fill(shapes, seed=1):
    """Seeded values for a flax variable tree of ShapeDtypeStructs."""
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
        return (rng.normal(0, 1, s.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, shapes)


def port_model(name, size, **kw):
    if tmodels.takes_image_size(name):
        kw["image_size"] = size
    return tmodels.create(name, device="cpu", num_classes=10, **kw)


def nchw(x: np.ndarray) -> torch.Tensor:
    """An NHWC array as the port's NCHW channels_last tensor."""
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


def _x(shape, seed=0):
    return np.random.RandomState(seed).normal(0, 1, shape).astype(np.float32)


# --- ops.nn -----------------------------------------------------------------

def test_ops_nn_exports_every_function_of_the_jax_module():
    import inspect
    want = {n for n, f in vars(jnn).items()
            if inspect.isfunction(f) and f.__module__ == jnn.__name__
            and not n.startswith("_")}
    have = {n for n, f in vars(tnn).items() if inspect.isfunction(f)}
    assert want and want <= have, sorted(want - have)


@pytest.mark.parametrize("padding", [0, 1, "SAME", "VALID"])
@pytest.mark.parametrize("count_include_pad", [True, False])
@pytest.mark.parametrize("kernel,stride", [(3, 1), (3, 2), (2, 2)])
def test_avg_pool2d(padding, count_include_pad, kernel, stride):
    x = _x((2, 7, 8, 3))
    want = jnn.avg_pool2d(x, kernel, stride, padding, count_include_pad)
    got = tnn.avg_pool2d(nchw(x), kernel, stride, padding, count_include_pad)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=OPS_TOL)


@pytest.mark.parametrize("padding", [0, 1, "SAME", "VALID"])
@pytest.mark.parametrize("kernel,stride", [(3, 1), (3, 2), (2, 2)])
def test_max_pool2d_pads_with_minus_inf(padding, kernel, stride):
    # every value negative: a zero fill would show at the borders
    x = -np.abs(_x((2, 7, 8, 3))) - 1.0
    want = jnn.max_pool2d(x, kernel, stride, padding)
    got = tnn.max_pool2d(nchw(x), kernel, stride, padding)
    assert got.is_contiguous(memory_format=torch.channels_last)
    assert float(got.max()) < 0
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))


@pytest.mark.parametrize("nsize", [3, 5])
def test_lrn_at_knorm_2(nsize):
    x = _x((2, 4, 5, 7)) * 3
    want = jnn.lrn(x, nsize=nsize, alpha=1e-2, beta=0.75, knorm=2.0)
    got = tnn.lrn(nchw(x), nsize=nsize, alpha=1e-2, beta=0.75, knorm=2.0)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=OPS_TOL,
                               atol=OPS_TOL)


def test_flatten_is_nhwc_order_and_concat_keeps_channels_last():
    x = _x((2, 3, 4, 5))
    np.testing.assert_array_equal(tnn.flatten(nchw(x)).numpy(),
                                  np.asarray(jnn.flatten(x)))
    flat = _x((2, 6))
    np.testing.assert_array_equal(tnn.flatten(torch.from_numpy(flat)).numpy(),
                                  flat)
    y = _x((2, 3, 4, 2), seed=1)
    got = tnn.concat([nchw(x), nchw(y)])
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(nhwc(got), np.asarray(jnn.concat([x, y])))


@pytest.mark.parametrize("flatten", [True, False])
def test_fully_connected(flatten):
    x = _x((2, 3, 3, 4)) if flatten else _x((5, 6))
    fan = 36 if flatten else 6
    w = _x((fan, 7), seed=1)
    b = _x((7,), seed=2)
    want = jnn.fully_connected(x, w, b, flatten=flatten)
    xt = nchw(x) if flatten else torch.from_numpy(x)
    got = tnn.fully_connected(xt, torch.from_numpy(w.T.copy()),
                              torch.from_numpy(b), flatten=flatten)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("stride,padding,groups", [(1, 0, 1), (2, 1, 1),
                                                   (2, 0, 2), (3, 1, 1)])
def test_deconv2d(stride, padding, groups):
    x = _x((2, 5, 6, 4))
    w = _x((3, 3, 4 // groups, 6), seed=1)  # the JAX HWIO kernel
    b = _x((6,), seed=2)
    want = jnn.deconv2d(x, w, b, stride, padding, groups)
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)  # the port's conv layout
    got = tnn.deconv2d(nchw(x), wt, torch.from_numpy(b), stride, padding,
                       groups)
    assert got.shape[2:] == want.shape[1:3]
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("padding,dilation", [("SAME", 1), ("VALID", 1),
                                              (1, 1), ("SAME", 2)])
def test_conv2d_paddings_and_dilation(padding, dilation):
    x = _x((2, 8, 7, 3))
    w = _x((3, 3, 3, 4), seed=1)
    want = jnn.conv2d(x, w, None, 2 if dilation == 1 else 1, padding,
                      dilation)
    got = tnn.conv2d(nchw(x), torch.from_numpy(w).permute(3, 2, 0, 1)
                     .contiguous(memory_format=torch.channels_last), None,
                     2 if dilation == 1 else 1, padding, dilation=dilation)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)


def test_instance_norm_and_l2_normalize():
    x = _x((2, 4, 5, 3)) + 2.0
    g, b = _x((3,), seed=1), _x((3,), seed=2)
    want = jnn.instance_norm(x, g, b)
    got = tnn.instance_norm(nchw(x), torch.from_numpy(g), torch.from_numpy(b))
    np.testing.assert_allclose(nhwc(got), np.asarray(want), atol=1e-5)
    v = _x((4, 9))
    for axis in (-1, 0):
        np.testing.assert_allclose(
            tnn.l2_normalize(torch.from_numpy(v), axis).numpy(),
            np.asarray(jnn.l2_normalize(v, axis)), atol=OPS_TOL)


def test_activations_and_softmax():
    x = _x((3, 4, 5, 6))
    xt = nchw(x)
    np.testing.assert_allclose(nhwc(tnn.leaky_relu(xt, 0.1)),
                               np.asarray(jnn.leaky_relu(x, 0.1)), atol=0)
    alpha = np.abs(_x((6,), seed=1))
    np.testing.assert_allclose(
        nhwc(tnn.prelu(xt, torch.from_numpy(alpha))),
        np.asarray(jnn.prelu(x, alpha)), atol=0)
    v = _x((4, 9)) * 3
    vt = torch.from_numpy(v)
    for axis, temp in ((-1, 1.0), (0, 2.0)):
        np.testing.assert_allclose(
            tnn.softmax(vt, axis, temp).numpy(),
            np.asarray(jnn.softmax(v, axis, temp)), atol=OPS_TOL)
    np.testing.assert_allclose(tnn.log_softmax(vt).numpy(),
                               np.asarray(jnn.log_softmax(v)), atol=1e-5)


def test_upsample_and_bilinear_resize():
    x = _x((2, 4, 5, 3))
    np.testing.assert_array_equal(nhwc(tnn.upsample_nearest(nchw(x), 3)),
                                  np.asarray(jnn.upsample_nearest(x, 3)))
    for out in ((8, 10), (7, 9), (2, 3), (3, 8)):  # up, down, mixed
        np.testing.assert_allclose(
            nhwc(tnn.bilinear_resize(nchw(x), *out)),
            np.asarray(jnn.bilinear_resize(x, *out)), atol=1e-5)


@pytest.mark.parametrize("mode", ["constant", "edge", "reflect"])
def test_pad2d(mode):
    x = _x((2, 4, 5, 3))
    want = jnn.pad2d(x, (1, 2, 3, 1), mode, value=0.5)
    got = tnn.pad2d(nchw(x), (1, 2, 3, 1), mode, value=0.5)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_array_equal(nhwc(got), np.asarray(want))


def test_dropout_modes_and_the_mask_hook(monkeypatch):
    x = _x((2, 3, 4, 5))
    key = jax.random.PRNGKey(7)
    masks = []
    real = jax.random.bernoulli

    def record(k, p=0.5, shape=None):
        out = real(k, p, shape)
        masks.append(np.asarray(out))
        return out

    monkeypatch.setattr(jax.random, "bernoulli", record)
    want = jnn.dropout(x, 0.3, training=False, rng=key, mode="always")
    assert masks[0].shape == x.shape  # NHWC, as the hook draws it
    monkeypatch.setattr(tnn, "draw_dropout_mask",
                        lambda shape, keep, gen, dev: torch.from_numpy(
                            masks[0].copy()))
    got = tnn.dropout(nchw(x), 0.3, training=False,
                      generator=torch.Generator(), mode="always")
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(nhwc(got), np.asarray(want), rtol=1e-6)
    # "training" mode is the identity in eval, and needs a generator in
    # training; the draw follows the generator
    assert tnn.dropout(nchw(x), 0.3, training=False) is not None
    with pytest.raises(ValueError, match="Generator"):
        tnn.dropout(nchw(x), 0.3, training=True)
    monkeypatch.undo()
    a, b = (tnn.dropout(nchw(x), 0.5, training=True,
                        generator=torch.Generator().manual_seed(3))
            for _ in range(2))
    assert torch.equal(a, b) and 0 < int((a == 0).sum()) < a.numel()


# --- models -----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _jax_shapes(name, size, pallas_bn):
    """The JAX model ``name`` and its variables' shapes at input ``size``
    (traced once for every test of the family; ``pallas_bn``: the
    ``DT_PALLAS_BN`` setting, which names the BatchNorms)."""
    model = jmodels.create(name, num_classes=10)
    x = np.zeros((1, size, size, 3), np.float32)
    return model, jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, x, training=False))


def _jax_case(name, size, batch=2, seed=1):
    x = np.random.RandomState(0).uniform(-1, 1, (batch, size, size, 3)) \
        .astype(np.float32)
    model, shapes = _jax_shapes(name, size, os.environ.get("DT_PALLAS_BN"))
    return model, fill(shapes, seed=seed), x


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_eval_logits_match_jax(family, monkeypatch):
    monkeypatch.delenv("DT_PALLAS_BN", raising=False)
    name, size = FAMILIES[family]
    jm, variables, x = _jax_case(name, size)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, training=False))(
        variables, x))
    model = load_jax_variables(port_model(name, size), variables)
    with torch.no_grad():
        got = model(nchw(x)).numpy()
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_eval_logits_match_jax_pallas_bn(monkeypatch):
    """MobileNet-v2 (depthwise convs, a projection BN without ReLU) with
    every JAX BN the Pallas kernel in interpret mode, carried from
    ``FusedBatchNorm_<i>``."""
    monkeypatch.setenv("DT_PALLAS_BN", "1")
    name, size = FAMILIES["mobilenet_v2"]
    jm, variables, x = _jax_case(name, size)
    bn = [p for p, _ in jax.tree_util.tree_leaves_with_path(variables)
          if any("BatchNorm" in str(k) for k in p)]
    assert bn and all("FusedBatchNorm" in jax.tree_util.keystr(p)
                      for p in bn)
    want = np.asarray(jax.jit(lambda v, x: jm.apply(v, x, training=False))(
        variables, x))
    model = load_jax_variables(port_model(name, size), variables)
    with torch.no_grad():
        got = model(nchw(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def _flat(tree):
    return {tuple(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_carry_round_trips_bit_for_bit(family):
    name, size = FAMILIES[family]
    _, variables, _ = _jax_case(name, size, seed=4)
    model = load_jax_variables(port_model(name, size), variables)
    back = export_jax_variables(model)
    flat_in, flat_out = _flat(variables), _flat(back)
    assert flat_in.keys() == flat_out.keys()
    n_port = sum(1 for _ in model.parameters()) + \
        sum(1 for _ in model.buffers())
    assert len(flat_in) == n_port
    for k in flat_in:
        np.testing.assert_array_equal(flat_out[k], flat_in[k])
    # no submodule registered twice: one name for every tensor
    assert len(list(model.named_parameters(remove_duplicate=False))) == \
        len(list(model.named_parameters()))
    for n, p in model.named_parameters():
        if p.dim() == 4:  # grouped and depthwise kernels too
            assert p.is_contiguous(memory_format=torch.channels_last), n


@pytest.mark.parametrize("name", OTHER_DEPTHS)
def test_other_depths_have_the_jax_tree(name):
    size = 32
    x = np.zeros((1, size, size, 3), np.float32)
    jm = jmodels.create(name, num_classes=10)
    shapes = jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0)}, x, training=False))
    model = port_model(name, size)
    want = {k: tuple(v.shape) for k, v in _flat(shapes).items()}
    have = {k: tuple(np.shape(v))
            for k, v in _flat(export_jax_variables(model)).items()}
    assert have == want
    with torch.no_grad():
        assert model(torch.zeros(2, 3, size, size).contiguous(
            memory_format=torch.channels_last)).shape == (2, 10)


def test_the_carry_raises_on_missing_extra_or_misshapen_leaves():
    name, size = "densenet121", 32
    _, variables, _ = _jax_case(name, size)
    variables = jax.tree_util.tree_map(np.asarray, variables)

    def load(params):
        return load_jax_variables(port_model(name, size),
                                  {"params": params,
                                   "batch_stats": variables["batch_stats"]})

    missing = dict(variables["params"])
    missing["DenseLayer_3"] = dict(missing["DenseLayer_3"])
    del missing["DenseLayer_3"]["BatchNorm_1"]
    with pytest.raises(KeyError, match="unfilled"):
        load(missing)
    extra = dict(variables["params"], BatchNorm_5={
        "scale": np.ones(1024, np.float32), "bias": np.zeros(1024,
                                                            np.float32)})
    with pytest.raises(KeyError, match="no port tensor"):
        load(extra)
    wrong = dict(variables["params"])
    wrong["Conv_0"] = {"kernel": np.zeros((7, 7, 3, 65), np.float32)}
    with pytest.raises(ValueError, match="shape"):
        load(wrong)


def test_every_jax_name_is_built_but_ssd_and_rcnn(monkeypatch):
    """Every name of the JAX package's registry builds, the detectors
    too."""
    from dt_tpu.models import _REGISTRY as jax_names
    for name in sorted(jax_names):
        model = tmodels.create(name, device="cpu")
        assert isinstance(model, torch.nn.Module), name
    model = tmodels.create("inception-v3", device="cpu", num_classes=3)
    assert isinstance(model, tmodels.InceptionV3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodels.create("densenet121")


@pytest.mark.parametrize("name", ["inception_v3", "googlenet", "vgg11_bn"])
def test_init_params_draws_every_new_leaf(name):
    size = 75 if name == "inception_v3" else 32
    model = tmodels.init_params(port_model(name, size), seed=3)
    for n, p in model.named_parameters():
        p = p.detach()
        leaf = n.rsplit(".", 1)[-1]
        if leaf == "weight":
            assert float(p.abs().max()) > 0, n
        elif leaf == "scale":
            assert torch.equal(p, torch.ones_like(p)), n
        else:  # biases, conv biases included, start at zero
            assert float(p.abs().max()) == 0, n


def test_bn_inputs_are_channels_last_in_every_bn_family():
    """Every BN input of every BN family, eval and training, is a
    channels_last NCHW tensor (``rows_view`` raises otherwise: the kernels
    never see a copy made to suit them)."""
    seen = []

    def hook(mod, args):
        seen.append(args[0].is_contiguous(memory_format=torch.channels_last))

    for family, (name, size) in sorted(FAMILIES.items()):
        model = port_model(name, size)
        hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
                 if isinstance(m, FusedBatchNorm)]
        x = torch.randn(2, 3, size, size).contiguous(
            memory_format=torch.channels_last)
        with torch.no_grad():
            model(x)
            model(x, training=True, generator=torch.Generator()) \
                if "generator" in model.forward.__code__.co_varnames \
                else model(x, training=True)
        for h in hooks:
            h.remove()
    assert len(seen) > 1000 and all(seen)


@pytest.mark.parametrize("name,size", [("vgg11_bn", 48), ("inception_v3", 75),
                                       ("squeezenet", 32)])
def test_predictor_serves_a_new_model(name, size, tmp_path):
    from dt_tpu_torch import optim
    from dt_tpu_torch.predictor import Predictor
    from dt_tpu_torch.training import checkpoint as ckpt
    from dt_tpu_torch.training.train_state import TrainState
    model = tmodels.init_params(port_model(name, size), seed=1)
    prefix = str(tmp_path / name)
    ckpt.save_checkpoint(prefix, 0, TrainState.create(model,
                                                      optim.create("sgd")))
    x = np.random.RandomState(2).uniform(-1, 1, (3, size, size, 3)) \
        .astype(np.float32)
    pred = Predictor(name, prefix, 0, x[:1], batch_buckets=[1, 2],
                     device="cpu", num_classes=10)
    got = pred.predict(x)
    with torch.no_grad():
        want = model(nchw(x)).numpy()
    assert got.shape == (3, 10)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
