"""The port's metrics against the JAX package's, on the CPU: every name of
the registry, a composite and a custom metric, fed the same numpy labels
and predictions over three updates, agree within 1e-6 (relative)."""

import numpy as np
import pytest

from dt_tpu.training import metrics as jm
from dt_tpu_torch.training import metrics as tm
from torch_one_thread import one_torch_thread  # noqa: F401 (fixture)

_NAMES = sorted(jm._REGISTRY)


def _inputs(name, seed):
    """(labels, preds) the metric takes: class ids and probabilities for
    the classifiers, binary ones for F1, values for the regressions, a
    loss vector for ``loss``."""
    rng = np.random.RandomState(seed)
    n, k = 17, 6
    if name in ("mae", "mse", "rmse"):
        return rng.normal(0, 1, (n, 3)), rng.normal(0, 1, (n, 3))
    if name == "loss":
        return None, rng.uniform(0, 3, n)
    if name == "f1":
        return rng.randint(0, 2, n), rng.uniform(0, 1, (n, 2))
    logits = rng.normal(0, 2, (n, k))
    p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return rng.randint(0, k, n), p


def test_registry_is_the_same():
    assert sorted(tm._REGISTRY) == _NAMES


@pytest.mark.parametrize("name", _NAMES)
def test_metric_matches(name):
    a, b = jm.create(name), tm.create(name)
    assert type(b).__name__ == type(a).__name__
    for seed in range(3):
        labels, preds = _inputs(name, seed)
        a.update(labels, preds)
        b.update(labels, preds)
        (na, va), (nb, vb) = a.get(), b.get()
        assert na == nb
        assert abs(va - vb) <= 1e-6 * max(1.0, abs(va))
    assert a.get_name_value() == b.get_name_value()
    a.reset()
    b.reset()
    assert np.isnan(b.get()[1]) and np.isnan(a.get()[1])


def test_options_composite_and_custom_match():
    labels, preds = _inputs("ce", 5)
    pairs = [(jm.create("top_k_accuracy", top_k=3),
              tm.create("top_k_accuracy", top_k=3)),
             (jm.Perplexity(ignore_label=2), tm.Perplexity(ignore_label=2)),
             (jm.create(["acc", "ce"]), tm.create(["acc", "ce"])),
             (jm.create(lambda lb, p: float((p.argmax(-1) == lb).mean())),
              tm.create(lambda lb, p: float((p.argmax(-1) == lb).mean())))]
    for a, b in pairs:
        for s in range(2):
            lb, p = _inputs("ce", 10 + s)
            a.update(lb, p)
            b.update(lb, p)
        for (na, va), (nb, vb) in zip(a.get_name_value(),
                                      b.get_name_value()):
            assert na == nb and abs(va - vb) <= 1e-6 * max(1.0, abs(va))
    m = tm.create("acc")
    assert tm.create(m) is m
    with pytest.raises(ValueError, match="unknown metric"):
        tm.create("bleu")
