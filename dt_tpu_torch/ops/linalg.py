"""Linear-algebra operators (counterpart of ``dt_tpu/ops/linalg.py``).

Reference: ``src/operator/tensor/la_op.cc`` (``_linalg_*``): gemm, gemm2,
potrf, potri, trmm, trsm, sumlogdiag, syrk, gelqf, syevd, batched over the
leading axes, lower-triangular by default, through ``torch.linalg``.
``gelqf`` makes L's diagonal non-negative, as the JAX function does, so
(L, Q) is unique; ``syevd`` returns the eigenvectors as rows, eigenvalues
ascending.  An eigenvector's sign is its solver's choice on both sides (the
JAX function fixes none), so two solvers may return a row negated.
"""

from __future__ import annotations

import torch


def _t(x: torch.Tensor) -> torch.Tensor:
    return torch.swapaxes(x, -1, -2)


def gemm(a, b, c, alpha: float = 1.0, beta: float = 1.0,
         transpose_a: bool = False, transpose_b: bool = False):
    """``alpha * op(A) op(B) + beta * C`` (``_linalg_gemm``)."""
    a = _t(a) if transpose_a else a
    b = _t(b) if transpose_b else b
    return alpha * (a @ b) + beta * c


def gemm2(a, b, alpha: float = 1.0, transpose_a: bool = False,
          transpose_b: bool = False):
    """``alpha * op(A) op(B)`` (``_linalg_gemm2``)."""
    a = _t(a) if transpose_a else a
    b = _t(b) if transpose_b else b
    return alpha * (a @ b)


def potrf(a):
    """Lower Cholesky factor L with A = L L^T (``_linalg_potrf``)."""
    return torch.linalg.cholesky(a)


def potri(a):
    """``(L L^T)^-1`` from the Cholesky factor L (``_linalg_potri`` takes
    L, not A)."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device) \
        .expand(a.shape)
    linv = torch.linalg.solve_triangular(a, eye, upper=False)
    return _t(linv) @ linv


def trmm(a, b, alpha: float = 1.0, transpose: bool = False,
         rightside: bool = False, lower: bool = True):
    """``alpha * op(A) B`` (``B op(A)`` with ``rightside``), A triangular
    (``_linalg_trmm``)."""
    tri = torch.tril(a) if lower else torch.triu(a)
    tri = _t(tri) if transpose else tri
    return alpha * (b @ tri if rightside else tri @ b)


def trsm(a, b, alpha: float = 1.0, transpose: bool = False,
         rightside: bool = False, lower: bool = True):
    """Solve ``op(A) X = alpha B`` (``X op(A) = alpha B`` with
    ``rightside``), A triangular (``_linalg_trsm``)."""
    upper = not lower
    op_upper = lower if transpose else upper  # op(A)'s triangle
    op_a = _t(a) if transpose else a
    return torch.linalg.solve_triangular(op_a, alpha * b, upper=op_upper,
                                         left=not rightside)


def sumlogdiag(a):
    """``sum(log(diag(A)))`` over the last two axes
    (``_linalg_sumlogdiag``)."""
    return torch.log(torch.diagonal(a, dim1=-2, dim2=-1)).sum(-1)


def syrk(a, alpha: float = 1.0, transpose: bool = False):
    """``alpha * A A^T`` (``alpha * A^T A`` with ``transpose``)
    (``_linalg_syrk``)."""
    a1 = _t(a) if transpose else a
    return alpha * (a1 @ _t(a1))


def gelqf(a):
    """LQ factorization A = L Q, Q with orthonormal rows (m <= n), L's
    diagonal non-negative (``_linalg_gelqf``).  Returns (L, Q)."""
    q, r = torch.linalg.qr(_t(a), mode="reduced")
    sign = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    return _t(r) * sign[..., None, :], _t(q * sign[..., None, :])


def syevd(a):
    """Symmetric eigendecomposition A = U^T diag(w) U (``_linalg_syevd``):
    the rows of ``u`` are the eigenvectors, ``w`` ascending.  Returns
    (u, w)."""
    w, v = torch.linalg.eigh(a)
    return _t(v), w
