"""SVRG, stochastic variance-reduced gradient (counterpart of
``dt_tpu/optim/svrg.py``).

Reference: ``python/mxnet/contrib/svrg_optimization/`` (Johnson & Zhang
2013): every ``update_freq`` epochs snapshot the weights and compute the
full-dataset gradient at the snapshot; each step then updates with
``g(w) - g(w_snap) + full_grad``.  The loop computes each batch's gradient
twice (at the live weights and at ``state["w_snap"]``) and refreshes the
snapshot each epoch with :func:`refresh_snapshot` and
:func:`full_gradient`.  The state is ``{"inner", "w_snap", "full_grad"}``,
the per-param ones dicts by name in the params' dtypes; the port updates
the params in place, so ``w_snap`` holds copies of them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, TypedDict

import torch


class SVRGState(TypedDict):
    """The state's layout (a plain dict): the inner optimizer's state, the
    snapshot's weights and the full gradient at them."""
    inner: Any
    w_snap: Any
    full_grad: Any


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def _copy(params) -> Dict[str, Any]:
    return _tree_map(lambda p: p.detach().clone(), params)


class SVRG:
    """``inner`` (e.g. plain SGD) with SVRG variance reduction; ``update``
    takes ``grads`` as the pair ``(batch_grad_at_w,
    batch_grad_at_snapshot)``."""

    def __init__(self, inner):
        self.inner = inner

    @property
    def learning_rate(self):
        return getattr(self.inner, "learning_rate", None)

    def init(self, params) -> SVRGState:
        return SVRGState(inner=self.inner.init(params), w_snap=_copy(params),
                         full_grad=_tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def update(self, grads, state: SVRGState, params,
               reduce=None) -> SVRGState:
        g_w, g_snap = grads
        corrected = {k: g_w[k] - g_snap[k] + state["full_grad"][k]
                     for k in params}
        inner = self.inner.update(corrected, state["inner"], params, reduce)
        return SVRGState(inner=inner, w_snap=state["w_snap"],
                         full_grad=state["full_grad"])


def svrg(inner) -> SVRG:
    """Wrap ``inner`` with SVRG variance reduction."""
    return SVRG(inner)


def refresh_snapshot(state: SVRGState, params, full_grad) -> SVRGState:
    """The epoch-boundary snapshot refresh (reference
    ``update_full_grads``): a copy of ``params`` and ``full_grad``."""
    return SVRGState(inner=state["inner"], w_snap=_copy(params),
                     full_grad=full_grad)


def full_gradient(grad_fn: Callable, params, batches, weights=None):
    """Average ``grad_fn(params, batch)`` over all batches (the
    full-dataset gradient at the snapshot).  Batches weigh equally; pass
    per-batch ``weights`` (e.g. example counts) when their sizes differ."""
    total = None
    wsum = 0.0
    for i, batch in enumerate(batches):
        w = 1.0 if weights is None else float(weights[i])
        g = _tree_map(lambda x: x * w, grad_fn(params, batch))
        total = g if total is None else _tree_map(torch.add, total, g)
        wsum += w
    if total is None:
        raise ValueError("full_gradient needs at least one batch")
    return _tree_map(lambda t: t / wsum, total)
