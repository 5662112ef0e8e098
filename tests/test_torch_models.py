"""The port's ResNets and weight carry against the ``dt_tpu`` models.

Each case builds the flax variable tree with ``jax.eval_shape`` (no init),
fills it from a seeded numpy generator, including non-trivial BN running
stats, runs the flax eval forward, carries the same arrays into the port and
compares logits.  Under ``DT_PALLAS_BN=1`` every flax BN is
``FusedBatchNorm`` and runs the Pallas kernel in interpret mode; without it,
``linen.BatchNorm``; the carry accepts both namings.
"""

import jax
import numpy as np
import pytest
import torch

from dt_tpu import models as jmodels
from dt_tpu.models import common as jcommon
from dt_tpu_torch import models as tmodels
from dt_tpu_torch.interchange import export_jax_variables, load_jax_variables
from dt_tpu_torch.models import common as tcommon
from dt_tpu_torch.ops import nn as tnn
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

# f32 logits: CPU convs sum in a different order in the two frameworks.
TOL = 1e-4


def _fill(shapes, seed=1):
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


def _jax_case(name, x, **kw):
    model = jmodels.create(name, **kw)
    shapes = jax.eval_shape(
        lambda: model.init({"params": jax.random.PRNGKey(0)}, x,
                           training=False))
    variables = _fill(shapes)
    return model, variables


def _port_logits(name, variables, x, **kw):
    model = tmodels.create(name, device="cpu", **kw)
    load_jax_variables(model, variables)
    with torch.no_grad():
        return model(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()


@pytest.mark.parametrize("name,fused", [
    ("resnet18", True), ("resnet18_v2", True), ("resnet20", True),
    ("resnet50", True), ("resnet50", False)])
def test_resnet_logits_match_jax(name, fused, monkeypatch):
    if fused:
        monkeypatch.setenv("DT_PALLAS_BN", "1")
    else:
        monkeypatch.delenv("DT_PALLAS_BN", raising=False)
    x = np.random.RandomState(0).uniform(-1, 1, (2, 32, 32, 3)) \
        .astype(np.float32)
    model, variables = _jax_case(name, x, num_classes=10)
    bn_names = [k for k in variables["params"] if "BatchNorm" in k]
    assert bn_names and all(k.startswith("FusedBatchNorm_") == fused
                            for k in bn_names)
    want = np.asarray(model.apply(variables, x, training=False))
    got = _port_logits(name, variables, x, num_classes=10)
    assert got.shape == (2, 10)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_cifar_stochastic_depth_eval_scaling():
    x = np.random.RandomState(2).uniform(-1, 1, (2, 16, 16, 3)) \
        .astype(np.float32)
    model, variables = _jax_case("resnet20", x, num_classes=10,
                                 stochastic_depth=0.5)
    want = np.asarray(model.apply(variables, x, training=False))
    got = _port_logits("resnet20", variables, x, num_classes=10,
                       stochastic_depth=0.5)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_convbn_matches_jax(monkeypatch):
    monkeypatch.setenv("DT_PALLAS_BN", "1")
    x = np.random.RandomState(3).normal(0, 1, (2, 9, 9, 5)).astype(np.float32)
    jm = jcommon.ConvBN(features=6, kernel=(3, 3), strides=(2, 2))
    variables = _fill(jax.eval_shape(
        lambda: jm.init({"params": jax.random.PRNGKey(0)}, x,
                        training=False)))
    want = np.asarray(jm.apply(variables, x, training=False))
    tm = tcommon.ConvBN(5, 6, (3, 3), (2, 2))
    load_jax_variables(tm, variables)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("size,kernel,stride,pads", [
    (56, 3, 2, (0, 1)), (56, 3, 1, (1, 1)), (7, 3, 2, (1, 1)),
    (224, 7, 2, (2, 3)), (56, 1, 2, (0, 0))])
def test_same_padding_is_tf_same(size, kernel, stride, pads):
    assert tnn.same_padding(size, kernel, stride) == pads


def test_weight_carry_is_complete_and_reversible(monkeypatch):
    monkeypatch.setenv("DT_PALLAS_BN", "1")
    x = np.zeros((1, 16, 16, 3), np.float32)
    _, variables = _jax_case("resnet18_v2", x, num_classes=4)
    model = tmodels.create("resnet18_v2", device="cpu", num_classes=4)
    load_jax_variables(model, variables)
    back = export_jax_variables(model)
    flat_in = {tuple(str(getattr(k, "key", k)).replace("FusedBatchNorm",
                                                        "BatchNorm")
                     for k in path): v
               for path, v in jax.tree_util.tree_leaves_with_path(variables)}
    flat_out = {tuple(str(k.key) for k in path): v
                for path, v in jax.tree_util.tree_leaves_with_path(back)}
    assert flat_in.keys() == flat_out.keys()
    n_port = sum(1 for _ in model.parameters()) + \
        sum(1 for _ in model.buffers())
    assert len(flat_in) == n_port
    for k in flat_in:
        np.testing.assert_array_equal(flat_out[k], flat_in[k])


def test_weight_carry_raises_on_missing_extra_or_misshapen_leaves():
    x = np.zeros((1, 16, 16, 3), np.float32)
    _, variables = _jax_case("resnet20", x, num_classes=4)
    variables = jax.tree_util.tree_map(np.asarray, variables)

    def fresh():
        return tmodels.create("resnet20", device="cpu", num_classes=4)

    missing = {"params": dict(variables["params"]),
               "batch_stats": variables["batch_stats"]}
    del missing["params"]["Dense_0"]
    with pytest.raises(KeyError, match="unfilled"):
        load_jax_variables(fresh(), missing)
    extra = {"params": dict(variables["params"], Dense_9={
        "kernel": np.zeros((64, 4), np.float32)}),
        "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="no port tensor"):
        load_jax_variables(fresh(), extra)
    both = {"params": dict(variables["params"]),
            "batch_stats": variables["batch_stats"]}
    both["params"]["FusedBatchNorm_0"] = both["params"]["BatchNorm_0"]
    with pytest.raises(KeyError, match="second time"):
        load_jax_variables(fresh(), both)
    wrong = {"params": dict(variables["params"], Dense_0={
        "kernel": np.zeros((65, 4), np.float32),
        "bias": np.zeros(4, np.float32)}),
        "batch_stats": variables["batch_stats"]}
    with pytest.raises(ValueError, match="shape"):
        load_jax_variables(fresh(), wrong)


def test_conv_weights_stay_channels_last_after_carry():
    x = np.zeros((1, 16, 16, 3), np.float32)
    _, variables = _jax_case("resnet20", x, num_classes=4)
    model = tmodels.create("resnet20", device="cpu", num_classes=4)
    load_jax_variables(model, variables)
    w = model.BasicBlockV2_3.Conv_0.weight
    assert w.shape == (32, 16, 1, 1)
    assert model.Conv_0.weight.is_contiguous(
        memory_format=torch.channels_last)


def test_create_needs_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodels.create("resnet18")
    assert isinstance(tmodels.create("resnet18", device="cpu"),
                      tmodels.ResNet)


def test_unported_models_raise():
    """Every name of the JAX package's registry is ported: only a name
    neither package registers is refused."""
    with pytest.raises(NotImplementedError, match="unknown model 'yolo3'"):
        tmodels.create("yolo3", device="cpu")


@pytest.mark.parametrize("name", ["ssd", "faster_rcnn", "faster-rcnn"])
def test_unported_models_name_their_roadmap_item(name):
    """The detectors, once refused by their ROADMAP item, build on the CPU
    (``faster-rcnn`` folds to ``faster_rcnn``) and run one eval forward."""
    model = tmodels.init_params(tmodels.create(name, device="cpu",
                                               num_classes=2), seed=0)
    x = torch.randn(1, 3, 64, 64).contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        out = model(x)
    if name == "ssd":
        cls, box, anchors = out
        assert cls.shape == (1, anchors.shape[0], 3)
        assert box.shape == (1, anchors.shape[0], 4)
    else:
        assert isinstance(model, tmodels.FasterRCNNMini)
        assert out["cls_scores"].shape == (1, 32, 3)
        assert out["rois"].shape == (1, 32, 4)
        assert all(torch.isfinite(v).all() for v in out.values())


def test_training_mode_bn_is_not_ported():
    """Training-mode BN is ported (``tests/test_torch_train.py`` holds it
    against JAX), and so is the CIFAR ResNet's stochastic-depth sampling
    (``tests/test_torch_stochastic_depth.py``): both train."""
    x = torch.zeros(2, 3, 32, 32).contiguous(
        memory_format=torch.channels_last)
    sd = tmodels.create("resnet20", device="cpu", num_classes=3,
                        stochastic_depth=0.5)
    assert torch.isfinite(sd(x, training=True,
                             generator=torch.Generator())).all()
    model = tmodels.create("resnet18", device="cpu", num_classes=3)
    assert torch.isfinite(model(x, training=True)).all()
