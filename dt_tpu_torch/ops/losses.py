"""Loss ops (counterpart of ``dt_tpu/ops/losses.py``).

Reference analogs: ``src/operator/softmax_output.cc`` (SoftmaxOutput),
``regression_output.cc`` (Linear/Logistic/MAE regression outputs),
``svm_output.cc``, ``nn/ctc_loss.cc``, the gluon losses and
``example/nce-loss``.  Each returns the batch mean its JAX twin returns,
computed in f32 from inputs of any float dtype (float64 stays float64).
"""

from __future__ import annotations

from typing import Optional

import torch


def _f32(x: torch.Tensor) -> torch.Tensor:
    return x if x.dtype == torch.float64 else x.float()


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          smoothing: float = 0.0,
                          ignore_label: Optional[int] = None) -> torch.Tensor:
    """Softmax + cross entropy with integer labels, the mean over the rows
    (``dt_tpu/ops/losses.py:20-36``).  Computed in f32 from logits of any
    dtype.  ``smoothing`` mixes ``smoothing / classes`` into the one-hot;
    rows whose label is ``ignore_label`` count for nothing, and the mean is
    over the rest (at least 1).  A label outside ``[0, classes)`` has an
    all-zero one-hot, as ``jax.nn.one_hot`` gives."""
    num_classes = logits.shape[-1]
    logp = torch.log_softmax(logits.float(), dim=-1)
    classes = torch.arange(num_classes, device=logits.device)
    onehot = (labels[..., None] == classes).to(logp.dtype)
    if smoothing > 0.0:
        onehot = onehot * (1.0 - smoothing) + smoothing / num_classes
    nll = -(onehot * logp).sum(-1)
    if ignore_label is not None:
        mask = (labels != ignore_label).to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def l2_loss(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """LinearRegressionOutput: ``0.5 * mean((p - y)^2)``."""
    return 0.5 * torch.mean(torch.square(_f32(pred) - label))


def l1_loss(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """MAERegressionOutput: ``mean(|p - y|)``."""
    return torch.mean(torch.abs(_f32(pred) - label))


def logistic_loss(pred: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """LogisticRegressionOutput: sigmoid BCE on logits, in the stable
    ``max(p, 0) - p*y + log1p(exp(-|p|))`` form."""
    p = _f32(pred)
    return torch.mean(torch.clamp(p, min=0) - p * label
                      + torch.log1p(torch.exp(-torch.abs(p))))


def huber_loss(pred: torch.Tensor, label: torch.Tensor,
               rho: float = 1.0) -> torch.Tensor:
    """gluon HuberLoss: ``0.5 d^2 / rho`` within ``rho``, ``d - rho/2``
    beyond."""
    d = torch.abs(_f32(pred) - label)
    return torch.mean(torch.where(d <= rho, 0.5 * d * d / rho, d - 0.5 * rho))


def hinge_loss(pred: torch.Tensor, label: torch.Tensor,
               margin: float = 1.0) -> torch.Tensor:
    """SVMOutput (L1 hinge): ``mean(max(0, margin - p * y))``."""
    return torch.mean(torch.clamp(margin - _f32(pred) * label, min=0.0))


def nce_loss(hidden: torch.Tensor, label_embeds: torch.Tensor,
             label_weight: torch.Tensor) -> torch.Tensor:
    """Noise-contrastive estimation (``example/nce-loss/nce.py:27-35``):
    ``hidden`` (B, D) scored by dot product against ``label_embeds`` (B,
    K+1, D), the mean BCE-with-logits against ``label_weight`` (B, K+1) in
    {0, 1}."""
    pred = (_f32(hidden)[:, None, :] * _f32(label_embeds)).sum(-1)
    t = _f32(label_weight)
    return torch.mean(torch.clamp(pred, min=0.0) - pred * t
                      + torch.log1p(torch.exp(-torch.abs(pred))))


def nce_loss_from_ids(hidden: torch.Tensor, embed_table: torch.Tensor,
                      label_ids: torch.Tensor,
                      label_weight: torch.Tensor) -> torch.Tensor:
    """:func:`nce_loss` with the embeddings gathered from a (V, D) table by
    ``label_ids`` (B, K+1): column 0 the true label, the rest noise."""
    return nce_loss(hidden, embed_table[label_ids.long()], label_weight)


def kl_divergence(logp_pred: torch.Tensor,
                  p_label: torch.Tensor) -> torch.Tensor:
    """gluon KLDivLoss on log-probs and probs, the mean over every axis
    (the class axis averaged, as the reference does)."""
    return torch.mean(p_label * (torch.log(torch.clamp(p_label, min=1e-12))
                                 - logp_pred))


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor,
             labels: torch.Tensor, label_lengths: torch.Tensor,
             blank: int = 0) -> torch.Tensor:
    """CTC loss, the mean over the batch, by the JAX function's log-alpha
    recursion (``dt_tpu/ops/losses.py:105-154``): ``logits`` (B, T, V),
    ``labels`` (B, L) padded past ``label_lengths``.  The extended sequence
    interleaves blanks (2L+1 states, -1e30 for log 0); a step past a
    sequence's ``logit_lengths`` leaves its alphas as they are; the loss is
    ``-logaddexp`` of the last blank and the last label (the blank alone
    for an empty label)."""
    b, t, v = logits.shape
    ll = labels.shape[1]
    dev = logits.device
    logp = torch.log_softmax(_f32(logits), dim=-1)
    s = 2 * ll + 1
    ext = torch.full((b, s), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels.long()
    neg_inf = -1e30
    alpha = torch.full((b, s), neg_inf, dtype=logp.dtype, device=dev)
    alpha[:, 0] = logp[:, 0, blank]
    alpha[:, 1] = torch.gather(logp[:, 0, :], 1, ext[:, 1:2])[:, 0]
    same_as_prev2 = torch.cat(
        [torch.ones((b, 2), dtype=torch.bool, device=dev),
         ext[:, 2:] == ext[:, :-2]], dim=1)
    pad1 = torch.full((b, 1), neg_inf, dtype=logp.dtype, device=dev)
    pad2 = torch.full((b, 2), neg_inf, dtype=logp.dtype, device=dev)
    lengths = logit_lengths.to(dev)
    for step in range(1, t):
        shift1 = torch.cat([pad1, alpha[:, :-1]], 1)
        shift2 = torch.cat([pad2, alpha[:, :-2]], 1)
        shift2 = torch.where(same_as_prev2, torch.full_like(shift2, neg_inf),
                             shift2)
        merged = torch.logaddexp(torch.logaddexp(alpha, shift1), shift2)
        new = merged + torch.gather(logp[:, step, :], 1, ext)
        alpha = torch.where((step < lengths)[:, None], new, alpha)
    end = 2 * label_lengths.long().to(dev)
    last = torch.gather(alpha, 1, end[:, None])[:, 0]
    last2 = torch.gather(alpha, 1, torch.clamp(end - 1, min=0)[:, None])[:, 0]
    last2 = torch.where(end == 0, torch.full_like(last2, float("-inf")),
                        last2)
    return torch.mean(-torch.logaddexp(last, last2))
