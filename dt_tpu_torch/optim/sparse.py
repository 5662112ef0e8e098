"""Lazy (row-sparse) optimizer updates (counterpart of
``dt_tpu/optim/sparse.py``).

Reference: the row_sparse optimizer kernels of
``src/operator/optimizer_op.cc``: SGD and SGD-momentum with
``lazy_update=True`` (only the touched rows move, and an untouched row's
momentum does not decay) and the sparse AdaGrad update.  The gradient is an
``ops.sparse.RowSparse``; duplicates are summed first
(``aggregate_duplicates``), then each state tensor is read and written at
the live rows only, so a step costs O(touched rows), not O(vocab).

As in the JAX package a sparse update applies directly and returns new
tensors: ``update(grad_rs, state, table) -> (new_table, new_state)``; the
inputs are left as they were.  ``lazy_update=False`` is the std_update
path (every row decays momentum and pays weight decay), the dense
optimizer's trajectory.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dt_tpu_torch.ops.sparse import RowSparse, aggregate_duplicates
from dt_tpu_torch.optim.optimizers import _lr_at


class SparseSGDState(NamedTuple):
    count: int
    mom: Optional[torch.Tensor]  # (num_rows, dim) f32; None without momentum


class SparseAdaGradState(NamedTuple):
    count: int
    hist: torch.Tensor  # (num_rows, dim) f32


def _prep(rs: RowSparse, rescale_grad, clip_gradient):
    """The summed gradient: ``(ids, live, g)``, ``live`` the slots that are
    not sentinels, ``g`` f32 rescaled and clipped."""
    rs = aggregate_duplicates(rs)
    g = rs.values.float() * rescale_grad
    if clip_gradient is not None:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    ids = rs.indices.long()
    return ids, (ids >= 0) & (ids < rs.num_rows), g


def _take(t: torch.Tensor, ids: torch.Tensor, live: torch.Tensor):
    """``t[ids]`` with zeros at the sentinel slots (the JAX ``take`` in
    fill mode)."""
    rows = t[ids.clamp(0, t.shape[0] - 1)]
    return torch.where(live.reshape((-1,) + (1,) * (rows.dim() - 1)), rows,
                       torch.zeros_like(rows))


def _add_rows(t: torch.Tensor, ids, live, upd) -> torch.Tensor:
    """A copy of ``t`` with ``upd`` added at the live rows (the slots are
    unique after ``aggregate_duplicates``)."""
    out = t.clone()
    out.index_add_(0, ids[live], upd[live].to(t.dtype))
    return out


def _set_rows(t: torch.Tensor, ids, live, rows) -> torch.Tensor:
    out = t.clone()
    out[ids[live]] = rows[live].to(t.dtype)
    return out


class sparse_sgd:
    """SGD(+momentum) with lazy row-sparse semantics: for the touched rows
    only, ``mom[r] = momentum*mom[r] - lr*(g[r] + wd*w[r]); w[r] +=
    mom[r]`` (``optimizer_op.cc`` sgd_mom_update, lazy path)."""

    def __init__(self, learning_rate=0.01, momentum: float = 0.0,
                 weight_decay: float = 0.0, rescale_grad: float = 1.0,
                 clip_gradient: Optional[float] = None,
                 lazy_update: bool = True):
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient
        self.lazy_update = lazy_update

    def init(self, table: torch.Tensor) -> SparseSGDState:
        mom = torch.zeros(table.shape, dtype=torch.float32,
                          device=table.device) if self.momentum else None
        return SparseSGDState(0, mom)

    @torch.no_grad()
    def update(self, grad: RowSparse, state: SparseSGDState,
               table: torch.Tensor):
        lr = _lr_at(self.learning_rate, state.count)
        ids, live, g = _prep(grad, self.rescale_grad, self.clip_gradient)
        if not self.lazy_update:
            # std_update: every row decays momentum and pays wd, the grad
            # read as dense-with-zeros
            w = table.float()
            if self.momentum == 0.0:
                new = w * (1.0 - lr * self.weight_decay)
                new.index_add_(0, ids[live], (-lr * g)[live])
                return new.to(table.dtype), SparseSGDState(state.count + 1,
                                                           None)
            mom = self.momentum * state.mom - lr * self.weight_decay * w
            mom.index_add_(0, ids[live], (-lr * g)[live])
            return (w + mom).to(table.dtype), SparseSGDState(
                state.count + 1, mom)
        w_rows = _take(table, ids, live).float()
        g = g + self.weight_decay * w_rows
        if self.momentum == 0.0:
            return (_add_rows(table, ids, live, -lr * g),
                    SparseSGDState(state.count + 1, None))
        m_rows = _take(state.mom, ids, live)
        new_m_rows = self.momentum * m_rows - lr * g
        mom = _set_rows(state.mom, ids, live, new_m_rows)
        return (_add_rows(table, ids, live, new_m_rows),
                SparseSGDState(state.count + 1, mom))


class sparse_adagrad:
    """AdaGrad with lazy row updates (``optimizer_op.cc:623-640``): for the
    touched rows, ``hist[r] += g**2; w[r] -= lr*(g/sqrt(hist[r]+eps) +
    wd*w[r])``."""

    def __init__(self, learning_rate=0.01, epsilon: float = 1e-7,
                 weight_decay: float = 0.0, rescale_grad: float = 1.0,
                 clip_gradient: Optional[float] = None):
        self.learning_rate = learning_rate
        self.epsilon = epsilon
        self.weight_decay = weight_decay
        self.rescale_grad = rescale_grad
        self.clip_gradient = clip_gradient

    def init(self, table: torch.Tensor) -> SparseAdaGradState:
        return SparseAdaGradState(0, torch.zeros(
            table.shape, dtype=torch.float32, device=table.device))

    @torch.no_grad()
    def update(self, grad: RowSparse, state: SparseAdaGradState,
               table: torch.Tensor):
        lr = _lr_at(self.learning_rate, state.count)
        ids, live, g = _prep(grad, self.rescale_grad, self.clip_gradient)
        h_rows = _take(state.hist, ids, live) + g * g
        hist = _set_rows(state.hist, ids, live, h_rows)
        w_rows = _take(table, ids, live).float()
        upd = -lr * (g / torch.sqrt(h_rows + self.epsilon)
                     + self.weight_decay * w_rows)
        return (_add_rows(table, ids, live, upd),
                SparseAdaGradState(state.count + 1, hist))
