"""The port's ``ops.detection`` against ``dt_tpu.ops.detection`` on the CPU.

The same seeded numpy inputs go through both.  Discrete results (keep
masks, matches, class targets, forced gts) must be equal; float results
within 1e-6 relative (``TOL``).  The JAX functions run eagerly, as their
callers see them outside ``jit`` where a result must be bit-equal (a
jitted ``multibox_prior`` rounds one ulp differently: XLA rewrites its
division), jitted elsewhere (eagerly ``nms``'s loop dispatches a step at a
time).  Also here: the NMS scan's
plain version (``ops.kernels.nms_keep_plain``, what a CPU tensor runs)
against a brute-force greedy loop, and the wrapper's input checks.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt_tpu.ops import detection as jd
from dt_tpu_torch.ops import detection as td
from dt_tpu_torch.ops import kernels
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

TOL = 1e-6


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(float(np.abs(want).max()), 1e-30) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _boxes(rng, n, lo=0.0, hi=1.0, min_wh=0.02, max_wh=0.4):
    xy = rng.uniform(lo, hi - max_wh, (n, 2))
    wh = rng.uniform(min_wh, max_wh, (n, 2))
    return np.concatenate([xy, xy + wh], 1).astype(np.float32)


def test_box_iou_matches_and_broadcasts():
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 13), _boxes(rng, 7)
    b[0] = [0.3, 0.3, 0.3, 0.5]  # zero area: union 0 against itself
    _close(td.box_iou(_t(a), _t(b)), jd.box_iou(jnp.asarray(a),
                                                jnp.asarray(b)))
    assert td.box_iou(_t(b[:1]), _t(b[:1])).item() == 0.0
    batched = td.box_iou(_t(a), _t(np.stack([b, b[::-1]])))
    _close(batched[1], jd.box_iou(jnp.asarray(a), jnp.asarray(b[::-1])))


@pytest.mark.parametrize("hw,sizes,ratios", [
    ((5, 5), (0.2, 0.272), (1.0, 2.0, 0.5)),
    ((4, 7), (0.1,), (1.0, 3.0)),
    ((1, 1), (0.71, 0.79), (1.0, 2.0, 0.5))])
def test_multibox_prior_is_bit_equal(hw, sizes, ratios):
    want = np.asarray(jd.multibox_prior(hw, sizes, ratios))
    got = td.multibox_prior(hw, sizes, ratios).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_encode_decode_boxes():
    rng = np.random.RandomState(1)
    anchors, gt = _boxes(rng, 20), _boxes(rng, 20)
    for var in ((0.1, 0.1, 0.2, 0.2), (1, 1, 1, 1)):
        enc = td.encode_boxes(_t(anchors), _t(gt), var)
        _close(enc, jd.encode_boxes(jnp.asarray(anchors), jnp.asarray(gt),
                                    var))
        deltas = rng.normal(0, 1, (20, 4)).astype(np.float32)
        _close(td.decode_boxes(_t(anchors), _t(deltas), var),
               jd.decode_boxes(jnp.asarray(anchors), jnp.asarray(deltas),
                               var))
        _close(td.decode_boxes(_t(anchors), enc, var), gt, 1e-5)


def test_force_match_two_gts_sharing_a_best_anchor():
    """Two valid gts whose best anchor is the same: the JAX function's
    duplicate-index scatter leaves the larger gt index there (its writes
    apply in order on the CPU); the port's ``amax`` scatter gives the same
    on every device.  A padding gt forces nothing."""
    iou = np.array([[0.9, 0.8, 0.0, 0.7],
                    [0.1, 0.2, 0.0, 0.3],
                    [0.95, 0.85, 0.0, 0.1],
                    [0.0, 0.0, 0.0, 0.0]], np.float32)
    valid = np.array([True, True, False, True])
    jf, jg = jd.force_match(jnp.asarray(iou), jnp.asarray(valid))
    tf, tg = td.force_match(_t(iou), _t(valid))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
    assert tg[2].item() == 1  # gts 0 and 1 both pick anchor 2
    # a batch: each image alone
    iou2 = np.stack([iou, iou[::-1].copy()])
    tf2, tg2 = td.force_match(_t(iou2), _t(np.stack([valid, valid])))
    jf2, jg2 = jd.force_match(jnp.asarray(iou2[1]), jnp.asarray(valid))
    np.testing.assert_array_equal(tg2[1].numpy(), np.asarray(jg2))
    np.testing.assert_array_equal(tf2[0].numpy(), np.asarray(jf))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_multibox_target_matches(seed):
    rng = np.random.RandomState(seed)
    anchors = np.asarray(jd.multibox_prior((6, 6), (0.2, 0.3),
                                           (1.0, 2.0, 0.5)))
    gt = np.zeros((5, 4), np.float32)
    labels = np.full(5, -1, np.int32)
    k = 3 + seed % 2
    gt[:k] = _boxes(rng, k, min_wh=0.1, max_wh=0.5)
    labels[:k] = rng.randint(0, 4, k)
    if seed == 2:  # two identical gts: the same best anchor
        gt[1], labels[1] = gt[0], 3
    target = jax.jit(jd.multibox_target)
    want = target(jnp.asarray(anchors), jnp.asarray(gt), jnp.asarray(labels))
    got = td.multibox_target(_t(anchors), _t(gt), _t(labels), 0.5)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1], want[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # the batched form: image 1 alone
    gtb = np.stack([gt, gt[::-1].copy()])
    lb = np.stack([labels, labels[::-1].copy()])
    got_b = td.multibox_target(_t(anchors), _t(gtb), _t(lb), 0.5)
    want_1 = target(jnp.asarray(anchors), jnp.asarray(gtb[1]),
                    jnp.asarray(lb[1]))
    np.testing.assert_array_equal(got_b[0][1].numpy(), np.asarray(want_1[0]))


def _nms_case(seed, n=60, classes=3):
    rng = np.random.RandomState(seed)
    # clustered boxes, so many overlap
    centers = rng.uniform(0.2, 0.8, (5, 2))
    c = centers[rng.randint(0, 5, n)] + rng.normal(0, 0.03, (n, 2))
    wh = rng.uniform(0.1, 0.3, (n, 2))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    scores[:6] = scores[6:12]  # exact ties: the lower index goes first
    labels = rng.randint(0, classes, n).astype(np.int32)
    return boxes, scores, labels


@functools.lru_cache(maxsize=None)
def _jit_nms(thr, score_thr, labelled, force):
    """The JAX ``nms`` jitted once a configuration (eagerly its loop
    dispatches a step at a time).  The keep mask is discrete: jit cannot
    move it but across an IoU at the threshold, which these cases lack."""
    def fn(boxes, scores, labels):
        return jd.nms(boxes, scores, thr, score_thr,
                      labels=labels if labelled else None,
                      force_suppress=force)
    return jax.jit(fn)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", ["labels", "force", "none"])
@pytest.mark.parametrize("thr,score_thr", [(0.5, 0.0), (0.3, 0.4),
                                           (0.7, float("-inf"))])
def test_nms_keep_mask_is_equal(seed, mode, thr, score_thr):
    boxes, scores, labels = _nms_case(seed)
    lab = None if mode == "none" else labels
    force = mode == "force"
    want = _jit_nms(thr, score_thr, lab is not None, force)(
        jnp.asarray(boxes), jnp.asarray(scores),
        None if lab is None else jnp.asarray(lab))
    got = td.nms(_t(boxes), _t(scores), thr, score_thr,
                 labels=None if lab is None else _t(lab),
                 force_suppress=force)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.sum() < len(scores)


def test_nms_batched_is_each_image_alone():
    cases = [_nms_case(s) for s in (3, 4, 5)]
    boxes = np.stack([c[0] for c in cases])
    scores = np.stack([c[1] for c in cases])
    labels = np.stack([c[2] for c in cases])
    got = td.nms(_t(boxes), _t(scores), 0.45, 0.2, labels=_t(labels))
    for i in range(3):
        want = _jit_nms(0.45, 0.2, True, False)(
            jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
            jnp.asarray(labels[i]))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def _greedy(boxes, labels, count, thr):
    """The JAX function's loop, written out: box i is kept unless a kept
    box before it overlaps it above ``thr``."""
    iou = td.box_iou(_t(boxes), _t(boxes)).numpy()
    if labels is not None:
        iou = np.where(labels[:, None] == labels[None, :], iou, 0.0)
    keep = np.zeros(len(boxes), bool)
    for i in range(count):
        keep[i] = not np.any((iou[i, :i] > thr) & keep[:i])
    return keep


@pytest.mark.parametrize("chunk", [7, 1024])
def test_nms_keep_plain_is_the_greedy_scan(chunk):
    """The scan's plain version on sorted boxes (chunked "over" rows, bits
    packed on the host) against the greedy loop, with counts that cut the
    order short, 0 and all."""
    boxes, scores, labels = _nms_case(6, n=150)
    order = np.argsort(-scores, kind="stable")
    sb = np.stack([boxes[order]] * 3)
    sl = np.stack([labels[order]] * 3)
    counts = np.array([150, 40, 0], np.int32)
    for lab in (None, sl):
        got = kernels.nms_keep_plain(_t(sb), None if lab is None else _t(lab),
                                     _t(counts), 0.5, chunk=chunk)
        for i, k in enumerate(counts):
            want = _greedy(sb[i], None if lab is None else lab[i], k, 0.5)
            np.testing.assert_array_equal(got[i].numpy(), want)
    assert kernels.nms_keep.launches == 0  # the CPU launches nothing


def test_nms_keep_checks_its_inputs():
    boxes = torch.zeros(2, 5, 4)
    counts = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="counts"):
        kernels.nms_keep(boxes, None, counts.long(), 0.5)
    with pytest.raises(ValueError, match="labels"):
        kernels.nms_keep(boxes, torch.zeros(2, 5, dtype=torch.int64),
                         counts, 0.5)
    with pytest.raises(ValueError, match="boxes"):
        kernels.nms_keep(boxes[:, :, :3], None, counts, 0.5)


@pytest.mark.parametrize("force", [False, True])
def test_multibox_detection_matches(force):
    rng = np.random.RandomState(7)
    anchors = np.asarray(jd.multibox_prior((5, 5), (0.2, 0.3),
                                           (1.0, 2.0, 0.5)))
    n = anchors.shape[0]
    logits = rng.normal(0, 2, (4, n)).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(0)
    deltas = rng.normal(0, 0.5, (n, 4)).astype(np.float32)
    want = jax.jit(functools.partial(
        jd.multibox_detection, iou_threshold=0.45, score_threshold=0.05,
        force_suppress=force))(jnp.asarray(probs), jnp.asarray(deltas),
                               jnp.asarray(anchors))
    got = td.multibox_detection(_t(probs), _t(deltas), _t(anchors), 0.45,
                                0.05, force_suppress=force)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1], want[1])
    _close(got[2], want[2])
    assert (got[0] >= 0).sum() > 0 and (got[0] < 0).sum() > 0
