"""Evaluation metrics of the port (counterpart of
``dt_tpu/training/metrics.py``), copied since the port imports nothing of
``dt_tpu``.

Reference: ``python/mxnet/metric.py`` (EvalMetric base with
update/reset/get, Accuracy, TopKAccuracy, F1, MAE/MSE/RMSE, CrossEntropy,
NegativeLogLikelihood, Perplexity, Loss, CompositeEvalMetric, CustomMetric,
``metric.create``).  Updates take numpy arrays (``Module`` hands them the
host copies of labels and probabilities), and sums are host-side floats, as
in the JAX package: a metric never touches the device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np


def _np(x) -> np.ndarray:
    return np.asarray(x)


class EvalMetric:
    """Base metric (reference ``mx.metric.EvalMetric``)."""

    def __init__(self, name: str):
        self.name = name
        self.reset()

    def reset(self):
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        raise NotImplementedError

    def get(self) -> Tuple[str, float]:
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, self.sum_metric / self.num_inst

    def get_name_value(self) -> List[Tuple[str, float]]:
        return [self.get()]


class Accuracy(EvalMetric):
    """Top-1 accuracy; preds may be logits/probs (argmax) or class ids."""

    def __init__(self, name: str = "accuracy"):
        super().__init__(name)

    def update(self, labels, preds):
        labels = _np(labels)
        preds = _np(preds)
        if preds.ndim == labels.ndim + 1:
            preds = preds.argmax(-1)
        labels = labels.reshape(-1)
        preds = preds.reshape(-1)
        self.sum_metric += float((preds == labels).sum())
        self.num_inst += labels.size


class TopKAccuracy(EvalMetric):
    """Reference: ``mx.metric.TopKAccuracy`` (top_k attr)."""

    def __init__(self, top_k: int = 5, name: Optional[str] = None):
        self.top_k = top_k
        super().__init__(name or f"top_k_accuracy_{top_k}")

    def update(self, labels, preds):
        labels = _np(labels).reshape(-1)
        preds = _np(preds).reshape(labels.size, -1)
        topk = np.argpartition(preds, -self.top_k, axis=-1)[:, -self.top_k:]
        self.sum_metric += float((topk == labels[:, None]).any(-1).sum())
        self.num_inst += labels.size


class F1(EvalMetric):
    """Binary F1 (reference ``mx.metric.F1``, average='macro' over updates)."""

    def __init__(self, name: str = "f1"):
        super().__init__(name)

    def reset(self):
        super().reset()
        self.tp = self.fp = self.fn = 0

    def update(self, labels, preds):
        labels = _np(labels).reshape(-1)
        preds = _np(preds)
        if preds.ndim > 1:
            preds = preds.argmax(-1)
        preds = preds.reshape(-1)
        self.tp += int(((preds == 1) & (labels == 1)).sum())
        self.fp += int(((preds == 1) & (labels == 0)).sum())
        self.fn += int(((preds == 0) & (labels == 1)).sum())
        precision = self.tp / max(self.tp + self.fp, 1)
        recall = self.tp / max(self.tp + self.fn, 1)
        f1 = 2 * precision * recall / max(precision + recall, 1e-12)
        self.sum_metric = f1
        self.num_inst = 1


class MAE(EvalMetric):
    def __init__(self, name: str = "mae"):
        super().__init__(name)

    def update(self, labels, preds):
        labels = _np(labels)
        preds = _np(preds).reshape(labels.shape)
        self.sum_metric += float(np.abs(labels - preds).mean() * labels.shape[0])
        self.num_inst += labels.shape[0]


class MSE(EvalMetric):
    def __init__(self, name: str = "mse"):
        super().__init__(name)

    def update(self, labels, preds):
        labels = _np(labels)
        preds = _np(preds).reshape(labels.shape)
        self.sum_metric += float(((labels - preds) ** 2).mean() * labels.shape[0])
        self.num_inst += labels.shape[0]


class RMSE(MSE):
    def __init__(self, name: str = "rmse"):
        super().__init__(name)

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(np.sqrt(self.sum_metric / self.num_inst))


class CrossEntropy(EvalMetric):
    """Mean -log p(label).  ``preds`` are probabilities (reference
    convention)."""

    def __init__(self, eps: float = 1e-12, name: str = "cross-entropy"):
        self.eps = eps
        super().__init__(name)

    def update(self, labels, preds):
        labels = _np(labels).astype(int).reshape(-1)
        preds = _np(preds).reshape(labels.size, -1)
        p = preds[np.arange(labels.size), labels]
        self.sum_metric += float(-np.log(np.maximum(p, self.eps)).sum())
        self.num_inst += labels.size


class NegativeLogLikelihood(CrossEntropy):
    def __init__(self, eps: float = 1e-12, name: str = "nll-loss"):
        super().__init__(eps, name)


class Perplexity(CrossEntropy):
    """exp(mean CE), optional ignore_label (reference ``mx.metric.Perplexity``,
    used by the PTB LM example)."""

    def __init__(self, ignore_label: Optional[int] = None, eps: float = 1e-12,
                 name: str = "perplexity"):
        self.ignore_label = ignore_label
        super().__init__(eps, name)

    def update(self, labels, preds):
        labels = _np(labels).astype(int).reshape(-1)
        preds = _np(preds).reshape(labels.size, -1)
        if self.ignore_label is not None:
            keep = labels != self.ignore_label
            labels, preds = labels[keep], preds[keep]
        p = preds[np.arange(labels.size), labels]
        self.sum_metric += float(-np.log(np.maximum(p, self.eps)).sum())
        self.num_inst += labels.size

    def get(self):
        if self.num_inst == 0:
            return self.name, float("nan")
        return self.name, float(np.exp(self.sum_metric / self.num_inst))


class Loss(EvalMetric):
    """Running mean of a scalar loss (reference ``mx.metric.Loss``)."""

    def __init__(self, name: str = "loss"):
        super().__init__(name)

    def update(self, labels, preds):
        self.sum_metric += float(_np(preds).sum())
        self.num_inst += max(_np(preds).size, 1)


class CustomMetric(EvalMetric):
    """Wrap ``feval(label, pred) -> float`` (reference
    ``mx.metric.CustomMetric`` / ``np`` helper)."""

    def __init__(self, feval: Callable, name: str = "custom"):
        self._feval = feval
        super().__init__(name)

    def update(self, labels, preds):
        self.sum_metric += float(self._feval(_np(labels), _np(preds)))
        self.num_inst += 1


class CompositeEvalMetric(EvalMetric):
    """Aggregate several metrics (reference
    ``mx.metric.CompositeEvalMetric``)."""

    def __init__(self, metrics: Sequence[EvalMetric],
                 name: str = "composite"):
        self.metrics = list(metrics)
        super().__init__(name)

    def reset(self):
        for m in getattr(self, "metrics", []):
            m.reset()
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)
        self.num_inst = 1

    def get(self):
        names, vals = [], []
        for m in self.metrics:
            n, v = m.get()
            names.append(n)
            vals.append(v)
        return names, vals

    def get_name_value(self):
        return [m.get() for m in self.metrics]


_REGISTRY: Dict[str, Callable[..., EvalMetric]] = {
    "acc": Accuracy,
    "accuracy": Accuracy,
    "top_k_accuracy": TopKAccuracy,
    "f1": F1,
    "mae": MAE,
    "mse": MSE,
    "rmse": RMSE,
    "ce": CrossEntropy,
    "cross-entropy": CrossEntropy,
    "nll_loss": NegativeLogLikelihood,
    "perplexity": Perplexity,
    "loss": Loss,
}


def create(metric: Union[str, EvalMetric, Sequence], **kwargs) -> EvalMetric:
    """``mx.metric.create`` semantics: str name, instance passthrough, or
    list -> composite."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        return CompositeEvalMetric([create(m) for m in metric])
    if callable(metric):
        return CustomMetric(metric)
    key = metric.lower()
    if key not in _REGISTRY:
        raise ValueError(f"unknown metric {metric!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key](**kwargs)
