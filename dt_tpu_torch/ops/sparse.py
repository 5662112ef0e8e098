"""Row-sparse storage and the sparse-gradient embedding (counterpart of
``dt_tpu/ops/sparse.py``).

Reference: the ``row_sparse`` storage type (``include/mxnet/ndarray.h``),
``sparse_retain`` (``src/operator/tensor/sparse_retain-inl.h``) and the
sparse-grad Embedding (``src/operator/tensor/indexing_op.cc``,
``sparse_grad=True``).  As in the JAX package a :class:`RowSparse` has a
fixed slot count ``nnz``; the out-of-range row id ``num_rows`` marks an
empty slot, dropped by every scatter and read as zeros by every gather.
Each function here returns what its JAX counterpart returns, slot for slot.

The CSR type has a fixed capacity ``nse`` too: an empty slot's column is
``n`` (its data 0) and ``indptr[-1]`` counts the filled slots; the filled
slots come first, in row-major order.  ``cast_storage`` converts between the
dense, row-sparse and CSR types.  The sparse plane has no TPU kernel behind
it, so nothing here launches a hand-written one: these are PyTorch ops on
whatever device the tensors are on.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

class RowSparse:
    """``nnz`` (possibly duplicate) row slots of a ``(num_rows, ...)``
    tensor: ``indices`` ``(nnz,)`` int, ``values`` ``(nnz, ...)``.
    ``indices[k] == num_rows`` is an empty slot.  Duplicates sum on
    densification, the gradient of a repeated embedding lookup."""

    __slots__ = ("indices", "values", "num_rows")

    def __init__(self, indices, values, num_rows: int):
        self.indices = indices
        self.values = values
        self.num_rows = int(num_rows)

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.num_rows,) + tuple(self.values.shape[1:])

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def dtype(self):
        return self.values.dtype

    def to_dense(self) -> torch.Tensor:
        """Densify: duplicate rows sum, sentinel slots drop (reference
        ``cast_storage(rsp, 'default')``)."""
        out = torch.zeros(self.shape, dtype=self.values.dtype,
                          device=self.values.device)
        live = (self.indices >= 0) & (self.indices < self.num_rows)
        out.index_put_((self.indices[live].long(),), self.values[live],
                       accumulate=True)
        return out

    def __repr__(self):
        return (f"RowSparse(nnz={self.nnz}, shape={self.shape}, "
                f"dtype={self.dtype})")


def _rows_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``mask`` ``(nnz,)`` broadcast over the trailing dims of ``like``."""
    return mask.reshape((-1,) + (1,) * (like.dim() - 1))


def row_sparse_from_dense(x: torch.Tensor,
                          nnz: Optional[int] = None) -> RowSparse:
    """``cast_storage(dense, 'row_sparse')`` with capacity ``nnz`` (default
    every row): the occupied rows in ascending order, then sentinel slots;
    rows past the capacity are dropped."""
    num_rows = x.shape[0]
    nnz = num_rows if nnz is None else int(nnz)
    occupied = (x != 0).reshape(num_rows, -1).any(dim=1)
    rows = torch.nonzero(occupied).flatten()[:nnz]
    idx = torch.full((nnz,), num_rows, dtype=torch.int32, device=x.device)
    idx[:rows.numel()] = rows.to(torch.int32)
    vals = torch.zeros((nnz,) + tuple(x.shape[1:]), dtype=x.dtype,
                       device=x.device)
    vals[:rows.numel()] = x[rows]
    return RowSparse(idx, vals, num_rows)


def sparse_retain(rs: RowSparse, keep_rows) -> RowSparse:
    """Keep only the slots whose row id is in ``keep_rows`` (reference
    ``sparse_retain``); the others become sentinels with zero values."""
    keep_rows = torch.as_tensor(keep_rows, device=rs.indices.device).long()
    keep = torch.zeros(rs.num_rows + 1, dtype=torch.bool,
                       device=rs.indices.device)
    keep[keep_rows[(keep_rows >= 0) & (keep_rows <= rs.num_rows)]] = True
    kept = keep[rs.indices.long().clamp(0, rs.num_rows)] & \
        (rs.indices < rs.num_rows)
    idx = torch.where(kept, rs.indices,
                      torch.full_like(rs.indices, rs.num_rows))
    vals = torch.where(_rows_mask(kept, rs.values), rs.values,
                       torch.zeros_like(rs.values))
    return RowSparse(idx, vals, rs.num_rows)


def aggregate_duplicates(rs: RowSparse) -> RowSparse:
    """Sum the values of duplicate row ids into one slot each: the slots
    come out in ascending row order (a stable sort), each id's sum in its
    first slot, the other slots sentinels with zero values, as the JAX
    function returns them.  Lazy optimizer updates need it: each touched
    row must be updated once."""
    sids, order = torch.sort(rs.indices, stable=True)
    svals = rs.values[order]
    head = torch.ones_like(sids, dtype=torch.bool)
    head[1:] = sids[1:] != sids[:-1]
    seg = torch.cumsum(head.long(), 0) - 1
    summed = torch.zeros_like(svals)
    summed.index_add_(0, seg, svals)
    vals = torch.where(_rows_mask(head, svals), summed[seg],
                       torch.zeros_like(svals))
    idx = torch.where(head & (sids < rs.num_rows), sids,
                      torch.full_like(sids, rs.num_rows))
    return RowSparse(idx, vals, rs.num_rows)


class CSR:
    """Compressed sparse row matrix of shape ``(m, n)`` with capacity
    ``nse``: ``indptr`` ``(m+1,)`` int32, ``indices`` ``(nse,)`` int32
    column ids (``n`` marks an empty slot), ``data`` ``(nse,)``
    (reference kCSRStorage, ``ndarray.h``)."""

    __slots__ = ("indptr", "indices", "data", "_shape")

    def __init__(self, indptr, indices, data, shape: Tuple[int, int]):
        self.indptr = indptr
        self.indices = indices
        self.data = data
        self._shape = (int(shape[0]), int(shape[1]))

    @property
    def shape(self) -> Tuple[int, int]:
        return self._shape

    @property
    def nse(self) -> int:
        return int(self.indices.shape[0])

    @property
    def dtype(self):
        return self.data.dtype

    def _row_ids(self) -> torch.Tensor:
        """Each slot's row, from ``indptr``; an empty slot gets ``m``."""
        k = torch.arange(self.nse, device=self.indices.device)
        row = torch.searchsorted(self.indptr.long(), k, right=True) - 1
        return torch.where(k < self.indptr[-1], row,
                           torch.full_like(row, self.shape[0]))

    def to_dense(self) -> torch.Tensor:
        """Densify; empty slots drop (``cast_storage(csr, 'default')``)."""
        m, n = self.shape
        out = torch.zeros((m, n), dtype=self.data.dtype,
                          device=self.data.device)
        rows = self._row_ids()
        live = (rows < m) & (self.indices >= 0) & (self.indices < n)
        out.index_put_((rows[live], self.indices[live].long()),
                       self.data[live], accumulate=True)
        return out

    def __repr__(self):
        return f"CSR(nse={self.nse}, shape={self.shape}, dtype={self.dtype})"


def csr_from_dense(x: torch.Tensor, nse: Optional[int] = None) -> CSR:
    """``cast_storage(dense, 'csr')`` with capacity ``nse`` (default every
    element): the nonzeros in row-major order, then empty slots; nonzeros
    past the capacity are dropped."""
    m, n = x.shape
    nse = m * n if nse is None else int(nse)
    flat = x.reshape(-1)
    pos = torch.nonzero(flat != 0).flatten()[:nse]
    cols = torch.full((nse,), n, dtype=torch.int32, device=x.device)
    cols[:pos.numel()] = (pos % n).to(torch.int32)
    rows = torch.full((nse,), m, dtype=torch.int64, device=x.device)
    rows[:pos.numel()] = pos // n
    data = torch.zeros((nse,), dtype=x.dtype, device=x.device)
    data[:pos.numel()] = flat[pos]
    indptr = torch.searchsorted(rows, torch.arange(m + 1, device=x.device)) \
        .to(torch.int32)
    return CSR(indptr, cols, data, (m, n))


def csr_dot_dense(lhs: CSR, rhs: torch.Tensor,
                  transpose_a: bool = False) -> torch.Tensor:
    """``dot(csr, dense)`` -> (m, k), or ``dot(csr.T, dense)`` -> (n, k)
    with ``transpose_a`` (``dot-inl.h`` DotCsrDnsDns / DotCsrDnsRsp, dense
    out): a gather of ``rhs``'s rows and a sum by row (by column)."""
    m, n = lhs.shape
    rows = lhs._row_ids()
    cols = lhs.indices.long()
    live = (rows < m) & (cols >= 0) & (cols < n)
    if not transpose_a:
        contrib = lhs.data[:, None] * rhs[cols.clamp(0, n - 1)]
        out = torch.zeros((m, rhs.shape[1]), dtype=contrib.dtype,
                          device=rhs.device)
        return out.index_add(0, rows[live], contrib[live])
    contrib = lhs.data[:, None] * rhs[rows.clamp(0, m - 1)]
    out = torch.zeros((n, rhs.shape[1]), dtype=contrib.dtype,
                      device=rhs.device)
    return out.index_add(0, cols[live], contrib[live])


def cast_storage(x, stype: str, **kw):
    """The storage cast (``cast_storage-inl.h``): ``'default'`` densifies,
    ``'row_sparse'``/``'csr'`` sparsify (``nnz``/``nse`` capacity in
    ``kw``); a tensor already of the type is returned as it is."""
    if stype == "default":
        return x.to_dense() if isinstance(x, (RowSparse, CSR)) else x
    if stype == "row_sparse":
        return x if isinstance(x, RowSparse) else row_sparse_from_dense(x,
                                                                        **kw)
    if stype == "csr":
        return x if isinstance(x, CSR) else csr_from_dense(x, **kw)
    raise ValueError(f"unknown storage type {stype!r}")


def embedding_lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The Embedding forward: rows of ``table`` gathered by ``ids`` of any
    shape; returns ``ids.shape + (dim,)``."""
    flat = table[ids.reshape(-1).long()]
    return flat.reshape(tuple(ids.shape) + (table.shape[-1],))


def embedding_value_and_grad(loss_of_rows: Callable, has_aux: bool = False,
                             argnums: Tuple[int, ...] = ()):
    """The ``sparse_grad=True`` Embedding: returns
    ``f(table, ids, *args) -> (loss, (RowSparse grad of table, grads of
    args[argnums]))``, where ``loss_of_rows(rows, *args)`` takes the
    gathered rows (``ids.shape + (dim,)``; with ``has_aux`` it returns
    ``(loss, aux)`` and ``f``'s first output is that pair).  The gradient
    is taken around the gather, so the dense ``(vocab, dim)`` gradient is
    never made: the RowSparse has one slot per id, duplicates unsummed."""
    argnums = tuple(argnums)

    def val_and_grad(table, ids, *args):
        rows = embedding_lookup(table.detach(), ids).requires_grad_(True)
        full = list(args)
        diff = []
        for i in argnums:
            full[i] = args[i].detach().requires_grad_(True)
            diff.append(full[i])
        with torch.enable_grad():
            out = loss_of_rows(rows, *full)
            loss = out[0] if has_aux else out
            grads = torch.autograd.grad(loss, [rows] + diff)
        rs = RowSparse(ids.reshape(-1).to(torch.int32),
                       grads[0].reshape(-1, table.shape[-1]),
                       table.shape[0])
        if has_aux:
            out = (out[0].detach(), out[1])
        else:
            out = out.detach()
        return out, (rs, tuple(grads[1:]))

    return val_and_grad
