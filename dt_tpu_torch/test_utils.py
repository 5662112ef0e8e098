"""Public numerical test fixtures (counterpart of ``dt_tpu/test_utils.py``;
reference ``python/mxnet/test_utils.py``): ``assert_almost_equal``,
``check_numeric_gradient`` (central differences against autograd),
``check_consistency`` (one function across dtypes, and eager against
``torch.jit.trace``), ``rand_ndarray`` (dense and row-sparse) and the
``@with_seed`` decorator.  Tolerances by dtype are the JAX package's.
"""

from __future__ import annotations

import functools
import os
import random
from typing import Callable, Optional, Sequence

import numpy as np
import torch

__all__ = ["assert_almost_equal", "check_numeric_gradient",
           "check_consistency", "rand_ndarray", "with_seed",
           "default_rtol_atol"]

_DTYPE_TOL = {
    "float64": (1e-7, 1e-9),
    "float32": (1e-4, 1e-6),
    "bfloat16": (5e-2, 1e-2),
    "float16": (1e-2, 1e-3),
}


def _dtype_name(d) -> str:
    if isinstance(d, torch.dtype):
        return str(d).split(".")[-1]
    return str(d) if str(d) == "bfloat16" else np.dtype(d).name


def default_rtol_atol(*dtypes):
    """The loosest (rtol, atol) across ``dtypes`` (numpy or torch)."""
    rtol, atol = 0.0, 0.0
    for d in dtypes:
        r, a = _DTYPE_TOL.get(_dtype_name(d), (1e-4, 1e-6))
        rtol, atol = max(rtol, r), max(atol, a)
    return rtol or 1e-4, atol or 1e-6


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
        return (a.double() if a.dtype == torch.bfloat16 else a).numpy()
    return np.asarray(a)


def assert_almost_equal(a, b, rtol: Optional[float] = None,
                        atol: Optional[float] = None, names=("a", "b")):
    """Relative-threshold comparison; the tolerance comes from the
    operands' dtypes when not given."""
    dta = _dtype_name(getattr(a, "dtype", "float32"))
    dtb = _dtype_name(getattr(b, "dtype", "float32"))
    a, b = _np(a), _np(b)
    if rtol is None or atol is None:
        r, t = default_rtol_atol(dta, dtb)
        rtol = r if rtol is None else rtol
        atol = t if atol is None else atol
    np.testing.assert_allclose(
        a, b, rtol=rtol, atol=atol,
        err_msg=f"{names[0]} !~ {names[1]} (rtol={rtol}, atol={atol})")


def check_numeric_gradient(fn: Callable, inputs: Sequence,
                           eps: float = 1e-3, rtol: float = 1e-2,
                           atol: float = 1e-3,
                           argnums: Optional[Sequence[int]] = None):
    """Central differences against autograd; ``fn(*inputs)`` returns a
    tensor summed to the scalar, every evaluation in float32."""
    argnums = tuple(argnums if argnums is not None else range(len(inputs)))
    f32 = [torch.tensor(_np(x), dtype=torch.float32,
                        requires_grad=i in argnums)
           for i, x in enumerate(inputs)]
    grads = torch.autograd.grad(fn(*f32).float().sum(),
                                [f32[i] for i in argnums])
    for gi, ai in zip(grads, argnums):
        base = [np.array(_np(x), np.float64) for x in inputs]
        num = np.zeros_like(base[ai])
        flat = base[ai].reshape(-1)
        nflat = num.reshape(-1)
        with torch.no_grad():
            for k in range(flat.size):
                orig = flat[k]
                flat[k] = orig + eps
                up = float(fn(*[torch.tensor(b, dtype=torch.float32)
                                for b in base]).sum())
                flat[k] = orig - eps
                dn = float(fn(*[torch.tensor(b, dtype=torch.float32)
                                for b in base]).sum())
                flat[k] = orig
                nflat[k] = (up - dn) / (2 * eps)
        assert_almost_equal(gi, num, rtol, atol,
                            names=(f"grad[{ai}]", "numeric"))


def check_consistency(fn: Callable, inputs: Sequence,
                      dtypes=("float32", "bfloat16"),
                      jit_check: bool = True):
    """``fn`` across dtypes (and eager against ``torch.jit.trace``), held
    at each dtype pair's loosest tolerance.  Returns the float64 results
    by dtype."""
    results = {}
    for dt in dtypes:
        tdt = getattr(torch, _dtype_name(dt))
        args = [torch.tensor(_np(x)).to(tdt) for x in inputs]
        results[dt] = _np(fn(*args)).astype(np.float64)
        if jit_check:
            traced = torch.jit.trace(fn, tuple(args), check_trace=False)
            jitted = _np(traced(*args)).astype(np.float64)
            r, a = default_rtol_atol(dt)
            assert_almost_equal(results[dt], jitted, r, a,
                                names=(f"eager[{dt}]", f"jit[{dt}]"))
    ref_dt = dtypes[0]
    for dt in dtypes[1:]:
        r, a = default_rtol_atol(ref_dt, dt)
        assert_almost_equal(results[ref_dt], results[dt], r, a,
                            names=(f"{ref_dt}", f"{dt}"))
    return results


def rand_ndarray(shape, stype: str = "default", density: float = 0.5,
                 dtype="float32", rng: Optional[np.random.RandomState] = None):
    """A random dense tensor or ``ops.sparse.RowSparse``, drawn as the JAX
    package draws it (the same ``rng`` gives the same values).  CSR is
    ROADMAP Queue 1 item 8."""
    from dt_tpu_torch.ops import sparse

    rng = rng or np.random.RandomState(np.random.randint(1 << 31))
    dense = rng.uniform(-1, 1, shape).astype(dtype)
    if stype == "default":
        return torch.from_numpy(dense)
    if stype == "row_sparse":
        keep = rng.rand(shape[0]) < density
        dense[~keep] = 0
        nnz = max(int(keep.sum()), 1)
        return sparse.row_sparse_from_dense(torch.from_numpy(dense), nnz=nnz)
    if stype == "csr":
        return sparse.csr_from_dense(dense)
    raise ValueError(f"unknown stype {stype!r}")


def with_seed(seed: Optional[int] = None):
    """Seed numpy, python and torch per test, and print the seed on a
    failure so it reproduces."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            s = seed
            if s is None:
                s = int.from_bytes(os.urandom(4), "little")
            np.random.seed(s)
            random.seed(s)
            torch.manual_seed(s)
            try:
                return fn(*args, **kwargs)
            except Exception:
                print(f"*** test failure with seed {s}: re-run with "
                      f"@with_seed({s}) to reproduce ***")
                raise
        return wrapper
    return deco
