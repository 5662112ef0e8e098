"""The NMS scan kernel's label reorder against ``dt_tpu.ops.detection.nms``.

The scan kernel (``csrc/nms.cu``) scans each label's boxes as a run of its
own: with labels and a threshold >= 0 its wrapper first reorders each
image's prefix stably by label (``ops.kernels.nms_label_runs``, plain
PyTorch), scans the reordered boxes and writes ``keep`` back through the
permutation; without labels, with ``force_suppress`` or below a threshold
of 0 it scans the prefix as one run.  The kernel runs only on the card, so
here the card path's steps run with the scan's plain version
(``nms_keep_plain``) in the kernel's place, on the same seeded numpy
inputs as the jitted JAX ``nms``; the keep masks must be equal.  The
reorder itself must keep each label's score order and the prefix a
prefix.
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

INT32_MAX = 2 ** 31 - 1


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _jit_nms(thr, score_thr, labelled, force):
    """The JAX ``nms`` (one image) jitted once a configuration."""
    def fn(boxes, scores, labels):
        return jd.nms(boxes, scores, thr, score_thr,
                      labels=labels if labelled else None,
                      force_suppress=force)
    return jax.jit(fn)


def _boxes(rng, n):
    """``n`` clustered boxes (many overlaps)."""
    centers = rng.uniform(0.2, 0.8, (6, 2))
    c = centers[rng.randint(0, 6, n)] + rng.normal(0, 0.03, (n, 2))
    wh = rng.uniform(0.1, 0.3, (n, 2))
    return np.concatenate([c - wh / 2, c + wh / 2], 1).astype(np.float32)


def _case(kind, seed, n=120):
    """(boxes (B, n, 4), scores (B, n), labels (B, n) int32) of one kind."""
    rng = np.random.RandomState(seed)
    b = 3
    boxes = np.stack([_boxes(rng, n) for _ in range(b)])
    scores = rng.uniform(0, 1, (b, n)).astype(np.float32)
    labels = rng.randint(0, 4, (b, n)).astype(np.int32)
    if kind == "unbalanced":  # one label holds 90 % of the boxes
        labels = np.where(rng.uniform(0, 1, (b, n)) < 0.9, 2,
                          labels).astype(np.int32)
    elif kind == "ties":  # equal scores: the lower index goes first
        scores = np.round(scores * 4) / 4
    elif kind == "extreme_labels":  # negative and large values
        values = np.array([-5, 100000, -(2 ** 31), INT32_MAX, 0], np.int32)
        labels = values[rng.randint(0, len(values), (b, n))]
    return boxes, scores, labels


def _card_path_plain(boxes, scores, labels, thr, score_thr, force):
    """The card path of ``ops.detection.nms`` with the scan's plain version
    in the kernel's place: the score order and counts (``_scan_inputs``),
    the label reorder where the wrapper makes it, the scan, ``keep`` back
    through both permutations."""
    order, sb, lab, counts = td._scan_inputs(boxes, scores, score_thr,
                                             labels, force)
    if lab is not None and thr >= 0:
        perm, sb, lab = kernels.nms_label_runs(sb, lab, counts)
        keep_runs = kernels.nms_keep_plain(sb, lab, counts, thr)
        keep_sorted = torch.zeros_like(keep_runs).scatter_(1, perm,
                                                           keep_runs)
    else:
        keep_sorted = kernels.nms_keep_plain(sb, lab, counts, thr)
    return torch.zeros_like(keep_sorted).scatter_(1, order, keep_sorted)


def _want(boxes, scores, labels, thr, score_thr, labelled, force):
    fn = _jit_nms(thr, score_thr, labelled, force)
    return np.stack([np.asarray(fn(jnp.asarray(boxes[i]),
                                   jnp.asarray(scores[i]),
                                   jnp.asarray(labels[i])))
                     for i in range(len(boxes))])


@pytest.mark.parametrize("kind", ["plain", "unbalanced", "ties",
                                  "extreme_labels"])
@pytest.mark.parametrize("thr,score_thr", [(0.45, 0.1), (0.0, 0.3),
                                           (0.7, float("-inf"))])
def test_label_runs_scan_matches_jax_nms(kind, thr, score_thr):
    boxes, scores, labels = _case(kind, seed=len(kind) + int(thr * 100))
    got = _card_path_plain(_t(boxes), _t(scores), _t(labels), thr,
                           score_thr, False)
    want = _want(boxes, scores, labels, thr, score_thr, True, False)
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < got.sum() < got.numel()


@pytest.mark.parametrize("case", ["force_suppress", "negative_threshold",
                                  "no_labels"])
def test_one_run_scan_matches_jax_nms(case):
    """The one-run paths: ``force_suppress`` and no labels scan every box
    against every other; a labelled threshold < 0 lets two labels'
    boxes suppress each other (their IoU counts as 0, which is above it),
    so the wrapper does not reorder."""
    boxes, scores, labels = _case("plain", seed=11)
    thr = -0.1 if case == "negative_threshold" else 0.5
    force = case == "force_suppress"
    labelled = case != "no_labels"
    got = _card_path_plain(_t(boxes), _t(scores),
                           _t(labels) if labelled else None, thr, 0.2, force)
    want = _want(boxes, scores, labels, thr, 0.2, labelled, force)
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "negative_threshold":  # the best box suppresses the rest
        assert (got.sum(1) == 1).all()


@pytest.mark.parametrize("count", ["zero", "one", "all"])
@pytest.mark.parametrize("kind", ["plain", "unbalanced", "extreme_labels"])
def test_label_runs_scan_counts_zero_one_all(count, kind):
    """Counts 0, 1 and N through the score threshold: above every score,
    between the best two, below every score."""
    boxes, scores, labels = _case(kind, seed=5)
    top = np.sort(scores, axis=1)[:, ::-1]
    score_thr = {"zero": float(top[:, 0].max()) + 1.0,
                 "one": None, "all": float("-inf")}[count]
    if count == "one":  # one threshold for every image: give each its gap
        scores = scores.copy()
        scores[:, :] = np.minimum(scores, 0.5)
        scores[np.arange(len(scores)), np.argmax(scores, axis=1)] = 0.9
        score_thr = 0.7
    got = _card_path_plain(_t(boxes), _t(scores), _t(labels), 0.45,
                           score_thr, False)
    want = _want(boxes, scores, labels, 0.45, score_thr, True, False)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (got.sum(1) == {"zero": 0, "one": 1}.get(count, got.sum(1))).all()


@pytest.mark.parametrize("kind", ["plain", "unbalanced", "ties",
                                  "extreme_labels"])
def test_label_reorder_keeps_each_labels_score_order(kind):
    """``nms_label_runs`` on sorted inputs with counts 0, 1, part and N
    (and ones outside [0, N], held to it): the prefix's labels ascend, each
    label's boxes keep their score order, the prefix stays a prefix and
    the boxes past it stay in place; the boxes follow the permutation."""
    boxes, scores, labels = _case(kind, seed=3)
    n = scores.shape[1]
    order = np.argsort(-scores, axis=1, kind="stable")
    sb = np.take_along_axis(boxes, order[..., None], 1)
    sl = np.take_along_axis(labels, order, 1)
    for counts in ([0, 1, n], [n // 3, n - 1, 2], [-4, n + 7, n // 2]):
        c = _t(np.asarray(counts, np.int32))
        perm, rb, rl = kernels.nms_label_runs(_t(sb), _t(sl), c)
        assert perm.dtype == torch.int64 and rl.dtype == torch.int32
        np.testing.assert_array_equal(
            rb.numpy(), np.take_along_axis(sb, perm.numpy()[..., None], 1))
        for img, k in enumerate(counts):
            k = min(max(k, 0), n)
            p, lab = perm[img].numpy(), rl[img].numpy()
            np.testing.assert_array_equal(np.sort(p[:k]), np.arange(k))
            np.testing.assert_array_equal(p[k:], np.arange(k, n))
            np.testing.assert_array_equal(lab[:k], sl[img][p[:k]])
            assert (np.diff(lab[:k].astype(np.int64)) >= 0).all()
            assert (lab[k:] == INT32_MAX).all()
            for v in np.unique(lab[:k]):
                run = p[:k][lab[:k] == v]
                assert (np.diff(run) > 0).all(), (kind, counts, img, v)


def test_label_reorder_scan_equals_unordered_plain_scan():
    """At the wrapper's level: the plain scan of the reordered boxes, put
    back through ``perm``, equals the plain scan of the boxes as they came
    (which scans each label alone too), at SSD300's anchor count with one
    label holding 90 % of the boxes."""
    rng = np.random.RandomState(19)
    n = 7756
    boxes = _boxes(rng, n)[None]
    labels = np.where(rng.uniform(0, 1, (1, n)) < 0.9, 100000,
                      rng.randint(-5, 15, (1, n))).astype(np.int32)
    counts = _t(np.array([n - 300], np.int32))
    perm, rb, rl = kernels.nms_label_runs(_t(boxes), _t(labels), counts)
    keep_runs = kernels.nms_keep_plain(rb, rl, counts, 0.45)
    got = torch.zeros_like(keep_runs).scatter_(1, perm, keep_runs)
    want = kernels.nms_keep_plain(_t(boxes), _t(labels), counts, 0.45)
    assert torch.equal(got, want)
    assert int((rl[0, :n - 300] == 100000).sum()) > 2048  # one long run
