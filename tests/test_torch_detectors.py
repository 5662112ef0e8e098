"""SSD and FasterRCNNMini of the port against ``dt_tpu``'s on the CPU.

At the examples' sizes (96x96 inputs, batch 2; SSD 3 classes, up to 4 boxes
an image; FasterRCNNMini 2 classes, 2 boxes, 32 ROIs), from
``examples/train_ssd.py``'s and ``train_rcnn.py``'s ``synthetic_batch`` at a
fixed seed.  The JAX model's variables come from its own ``init``, with the
BN running stats filled with seeded values; they are carried into the port
by ``load_jax_variables``.  One jitted JAX function a model gives the
training forward's outputs, the loss, every gradient leaf and the new
running stats; the port runs the same step.  Held (``TOL``):

- the outputs (class logits, boxes, anchors; RPN scores and deltas, ROIs,
  ROI scores, head logits and deltas) and the loss within 1e-5 of each
  one's largest magnitude;
- each gradient leaf within 1e-4 of its norm, its norm ratio within 1e-4
  of 1 and its cosine within 1e-4 of 1 (leaves with no gradient: exactly 0
  on both sides);
- the running stats within 1e-6.

FasterRCNNMini runs the JAX side with ``DT_PALLAS_BN=1`` (every BN the
Pallas kernels in interpret mode, carried as ``FusedBatchNorm_<i>``), SSD
with ``DT_PALLAS_BN`` unset (``BatchNorm_<i>``).  The eval forward and the
detection stage: ``ssd_detect``/``rcnn_detect`` on the JAX model's own
outputs give equal labels and scores and boxes within 1e-6; the port's eval
outputs are held as above.  Float32 holds these bounds on both models (the
largest gradient error is ~1e-5 of a leaf), so nothing runs in float64.
"""

import functools
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt_tpu import models as jmodels
from dt_tpu.models.rcnn import rcnn_detect as j_rcnn_detect
from dt_tpu.models.rcnn import rcnn_loss as j_rcnn_loss
from dt_tpu.models.ssd import ssd_detect as j_ssd_detect
from dt_tpu.models.ssd import ssd_loss as j_ssd_loss
from dt_tpu_torch import models as tmodels
from dt_tpu_torch.interchange import export_jax_variables, load_jax_variables
from dt_tpu_torch.models.common import FusedBatchNorm
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
from train_rcnn import synthetic_batch as rcnn_batch  # noqa: E402
from train_ssd import synthetic_batch as ssd_batch  # noqa: E402

TOL = dict(out=1e-5, leaf=1e-4, stats=1e-6, detect=1e-6)
SIZE, BATCH = 96, 2
CASES = {  # name -> (kwargs, data generator args, DT_PALLAS_BN)
    "ssd": (dict(num_classes=3), (ssd_batch, 3, 4), "0"),
    "faster_rcnn": (dict(num_classes=2, num_rois=32), (rcnn_batch, 2, 2),
                    "1"),
}


def _data(name, seed=0):
    gen, classes, boxes = CASES[name][1]
    return gen(np.random.RandomState(seed), BATCH, SIZE, classes, boxes)


def _fill_stats(stats, seed=1):
    rng = np.random.RandomState(seed)

    def one(path, v):
        if path[-1].key == "mean":
            return rng.normal(0, 0.3, v.shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, v.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(one, stats)


def _nchw(x):
    return torch.from_numpy(np.array(x)).permute(0, 3, 1, 2)


def _jax_loss(name, model, out, gtb, gtl, size=SIZE):
    if name == "ssd":
        return j_ssd_loss(*out, gtb, gtl)
    return j_rcnn_loss(out, model.anchors((size, size)), gtb, gtl)


def _port_loss(name, model, out, gtb, gtl, size=SIZE):
    if name == "ssd":
        return tmodels.ssd_loss(*out, gtb, gtl)
    return tmodels.rcnn_loss(out, model.anchors((size, size)), gtb, gtl)


@functools.lru_cache(maxsize=None)
def jax_case(name):
    """The JAX model's variables, its training step (outputs, loss,
    gradients, new stats) and its eval outputs, computed once a model
    under its ``DT_PALLAS_BN``."""
    kw, _, fused = CASES[name]
    old = os.environ.get("DT_PALLAS_BN")
    os.environ["DT_PALLAS_BN"] = fused
    try:
        imgs, boxes, labels = _data(name)
        jm = jmodels.create(name, **kw)
        x = jnp.asarray(imgs)
        variables = jax.jit(lambda x: jm.init(
            {"params": jax.random.PRNGKey(0)}, x, training=False))(x)
        variables = {"params": variables["params"],
                     "batch_stats": _fill_stats(variables["batch_stats"])}

        def loss(params):
            out, new = jm.apply({"params": params,
                                 "batch_stats": variables["batch_stats"]}, x,
                                training=True, mutable=["batch_stats"])
            return _jax_loss(name, jm, out, jnp.asarray(boxes),
                             jnp.asarray(labels)), (out, new["batch_stats"])

        def step(variables):  # one program: the step and the eval forward
            return (jax.value_and_grad(loss, has_aux=True)(
                variables["params"]),
                jm.apply(variables, x, training=False))

        ((value, (out, new)), grads), evals = jax.jit(step)(variables)
        return jax.device_get(dict(variables=variables, loss=value, out=out,
                                   stats=new, grads=grads, eval=evals,
                                   data=(imgs, boxes, labels)))
    finally:
        if old is None:
            del os.environ["DT_PALLAS_BN"]
        else:
            os.environ["DT_PALLAS_BN"] = old


def port_model(name, **extra):
    return tmodels.create(name, device="cpu", **CASES[name][0], **extra)


def _flat_out(name, out):
    if name == "ssd":
        return dict(zip(("cls", "box", "anchors"), out))
    return out


def _hold_outputs(name, got, want):
    got, want = _flat_out(name, got), _flat_out(name, want)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].detach().numpy()
        assert g.shape == w.shape and g.dtype == np.float32, k
        err = np.abs(g - w).max()
        assert err <= TOL["out"] * np.abs(w).max(), (k, err)


def _leaves(tree):
    """(path, float64 value) of every leaf, sorted by path, the Pallas BN
    naming (``FusedBatchNorm_<i>``) read as the default one."""
    return sorted((jax.tree_util.keystr(p).replace("FusedBatchNorm",
                                                   "BatchNorm"),
                   np.asarray(v, np.float64))
                  for p, v in jax.tree_util.tree_leaves_with_path(tree))


@pytest.mark.parametrize("name", sorted(CASES))
def test_training_step_matches_jax(name):
    case = jax_case(name)
    imgs, boxes, labels = case["data"]
    model = load_jax_variables(port_model(name), case["variables"])
    out = model(_nchw(imgs), training=True)
    _hold_outputs(name, out, case["out"])
    loss = _port_loss(name, model, out, torch.from_numpy(boxes),
                      torch.from_numpy(labels))
    want = float(case["loss"])
    assert abs(loss.item() - want) <= TOL["out"] * abs(want)
    loss.backward()
    got = export_jax_variables(model)
    got_s, want_s = _leaves(got["batch_stats"]), _leaves(case["stats"])
    assert [n for n, _ in got_s] == [n for n, _ in want_s]
    for (n, a), (_, b) in zip(got_s, want_s):
        assert np.abs(a - b).max() <= TOL["stats"], n
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.grad)
    grads = export_jax_variables(model)["params"]
    got_l, want_l = _leaves(grads), _leaves(case["grads"])
    assert [n for n, _ in got_l] == [n for n, _ in want_l]
    live = 0
    for (n, a), (_, b) in zip(got_l, want_l):
        nb = np.linalg.norm(b)
        if nb == 0.0:  # no anchor of this scale matched or was mined
            assert np.linalg.norm(a) == 0.0, n
            continue
        live += 1
        na = np.linalg.norm(a)
        assert np.linalg.norm(a - b) <= TOL["leaf"] * nb, n
        assert abs(na / nb - 1.0) <= TOL["leaf"], n
        assert (a * b).sum() / (na * nb) >= 1.0 - TOL["leaf"], n
    assert live >= 20


@pytest.mark.parametrize("name", sorted(CASES))
def test_eval_forward_and_detection_match_jax(name):
    case = jax_case(name)
    imgs = case["data"][0]
    model = load_jax_variables(port_model(name), case["variables"])
    with torch.no_grad():
        out = model(_nchw(imgs))
    _hold_outputs(name, out, case["eval"])
    ev = case["eval"]
    if name == "ssd":
        want = jax.jit(j_ssd_detect)(*[jnp.asarray(v) for v in ev])
        got = tmodels.ssd_detect(*[torch.from_numpy(np.array(v))
                                   for v in ev])
    else:
        want = jax.jit(j_rcnn_detect)({k: jnp.asarray(v)
                                       for k, v in ev.items()})
        got = tmodels.rcnn_detect({k: torch.from_numpy(np.array(v))
                                   for k, v in ev.items()})
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert (got[0] >= 0).any()
    for g, w in zip(got[1:], want[1:]):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= TOL["detect"] * np.abs(w).max()


@pytest.mark.parametrize("name", sorted(CASES))
def test_carry_round_trips_bit_for_bit(name):
    variables = jax_case(name)["variables"]
    model = load_jax_variables(port_model(name), variables)
    got = _leaves(export_jax_variables(model))
    want = _leaves(variables)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (n, a), (_, b) in zip(got, want):
        np.testing.assert_array_equal(a, b, err_msg=n)
    n_bn = sum(isinstance(m, FusedBatchNorm) for m in model.modules())
    assert n_bn == (7 if name == "ssd" else 3)


def test_children_are_named_as_flax_names_them():
    ssd = port_model("ssd")
    names = [n for n, _ in ssd.named_children()]
    assert names == [f"ConvBN_{i}" for i in range(7)] + \
        [f"Conv_{i}" for i in range(10)]
    rcnn = port_model("faster_rcnn")
    assert [n for n, _ in rcnn.named_children()] == \
        [f"ConvBN_{i}" for i in range(3)] + [f"Conv_{i}" for i in range(3)] \
        + [f"Dense_{i}" for i in range(4)]
    # no child registered twice
    for m in (ssd, rcnn):
        assert len(list(m.named_parameters(remove_duplicate=False))) == \
            len(list(m.parameters()))


def test_rcnn_anchors_use_ceil_division_as_jax():
    jm = jmodels.create("faster_rcnn", num_classes=2)
    tm = port_model("faster_rcnn")
    for hw in [(96, 96), (68, 75)]:
        np.testing.assert_array_equal(tm.anchors(hw).numpy(),
                                      np.asarray(jm.anchors(hw)))


def test_bfloat16_models_keep_their_f32_islands():
    """In a bfloat16 model the heads' outputs, the RPN's scores, the ROI
    features and the head's last two dense layers are f32, as in the JAX
    model; every BN input is a channels_last tensor (the kernels never see
    a copy made to suit them)."""
    seen = []

    def hook(mod, args):
        seen.append(args[0].is_contiguous(memory_format=torch.channels_last))

    x = _nchw(_data("ssd")[0]).to(torch.bfloat16)
    for name in sorted(CASES):
        model = tmodels.init_params(port_model(name, dtype=torch.bfloat16),
                                    seed=0)
        hooks = [m.register_forward_pre_hook(hook) for m in model.modules()
                 if isinstance(m, FusedBatchNorm)]
        with torch.no_grad():
            for training in (True, False):
                out = model(x, training=training)
                leaves = out if name == "ssd" else out.values()
                assert all(t.dtype == torch.float32 for t in leaves)
        for h in hooks:
            h.remove()
    assert len(seen) == 2 * (7 + 3) and all(seen)


@pytest.mark.parametrize("name", sorted(CASES))
def test_init_params_draws_every_leaf(name):
    """``init_params`` draws every conv and dense kernel of the detectors
    (lecun-normal, as linen's default), their biases and BN shifts at 0 and
    BN scales at 1, on a seeded generator: the same seed, the same
    weights."""
    model = tmodels.init_params(port_model(name), seed=3)
    again = tmodels.init_params(port_model(name), seed=3)
    for (n, p), (_, q) in zip(model.named_parameters(),
                              again.named_parameters()):
        p = p.detach()
        assert torch.equal(p, q), n
        leaf = n.rsplit(".", 1)[-1]
        if leaf == "weight":
            fan_in = p[0].numel()
            assert 0.5 < float(p.std()) * fan_in ** 0.5 < 1.5, n
        elif leaf == "scale":
            assert torch.equal(p, torch.ones_like(p)), n
        else:
            assert float(p.abs().max()) == 0, n
