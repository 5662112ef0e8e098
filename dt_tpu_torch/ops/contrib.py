"""The remaining contrib ops: adaptive average pooling, count sketch,
row-wise Kronecker and Khatri-Rao products, FFT packing, quadratic,
index_copy (counterpart of ``dt_tpu/ops/contrib.py``).

Reference: ``src/operator/contrib/`` — ``adaptive_avg_pooling.cc``,
``count_sketch.cc``, ``krprod.cc``, ``fft.cc``/``ifft.cc``,
``quadratic_op.cc``, ``index_copy.cc``.  Images are NHWC, as in the JAX
module (a channels_last NCHW activation ``x`` is ``x.permute(0, 2, 3, 1)``).
No TPU kernel stands behind these ops: they are PyTorch code.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch


def _adaptive_mask(in_size: int, out_size: int, dtype, device
                   ) -> torch.Tensor:
    """(out, in) averaging weights: row i covers ``[floor(i*in/out),
    ceil((i+1)*in/out))`` with weight ``1/len`` (the adaptive-pool bins)."""
    i = torch.arange(out_size, device=device)
    lo = (i * in_size) // out_size
    hi = -((-(i + 1) * in_size) // out_size)
    pos = torch.arange(in_size, device=device)
    m = (pos[None, :] >= lo[:, None]) & (pos[None, :] < hi[:, None])
    return m.to(dtype) / (hi - lo).to(dtype)[:, None]


def adaptive_avg_pool2d(x: torch.Tensor,
                        output_size: Union[int, Tuple[int, int]]
                        ) -> torch.Tensor:
    """Adaptive average pooling, NHWC -> (N, OH, OW, C), torch's bins
    (``_contrib_AdaptiveAvgPooling2D``), as two masked contractions."""
    oh, ow = ((output_size, output_size) if isinstance(output_size, int)
              else output_size)
    n, h, w, c = x.shape
    hm = _adaptive_mask(h, oh, x.dtype, x.device)
    wm = _adaptive_mask(w, ow, x.dtype, x.device)
    return torch.einsum("ph,nhwc,qw->npqc", hm, x, wm)


def count_sketch(x: torch.Tensor, h: torch.Tensor, s: torch.Tensor,
                 out_dim: int) -> torch.Tensor:
    """Count sketch of ``x`` (..., in_dim) -> (..., out_dim):
    ``out[..., h[j]] += s[j] * x[..., j]`` (``count_sketch.cc``)."""
    signed = x * s.to(x.dtype)
    out = torch.zeros(x.shape[:-1] + (out_dim,), dtype=x.dtype,
                      device=x.device)
    return out.index_add(-1, h.long(), signed)


def row_wise_kronecker(matrices: Sequence[torch.Tensor]) -> torch.Tensor:
    """Row-wise Kronecker product of (N, k_i) matrices -> (N, prod k_i)
    (``krprod.h`` row_wise_kronecker)."""
    out = matrices[0]
    for m in matrices[1:]:
        out = (out[:, :, None] * m[:, None, :]).reshape(out.shape[0], -1)
    return out


def khatri_rao(matrices: Sequence[torch.Tensor]) -> torch.Tensor:
    """Column-wise Khatri-Rao product of (r_i, K) matrices -> (prod r_i, K)
    (``krprod.h`` khatri_rao)."""
    out = matrices[0]
    for m in matrices[1:]:
        out = (out[:, None, :] * m[None, :, :]).reshape(-1, out.shape[-1])
    return out


def fft(x: torch.Tensor) -> torch.Tensor:
    """Real (..., D) -> interleaved re/im (..., 2*D), ``_contrib_fft``'s
    packing (``fft.cc``)."""
    f = torch.fft.fft(x.float(), dim=-1)
    return torch.stack([f.real, f.imag], dim=-1).reshape(
        *x.shape[:-1], 2 * x.shape[-1])


def ifft(x: torch.Tensor) -> torch.Tensor:
    """Interleaved re/im (..., 2*D) -> real (..., D), unnormalized (times
    D, the cuFFT convention of ``_contrib_ifft``)."""
    d = x.shape[-1] // 2
    z = x.float().reshape(*x.shape[:-1], d, 2)
    f = torch.complex(z[..., 0], z[..., 1])
    return torch.fft.ifft(f, dim=-1).real * d


def quadratic(x: torch.Tensor, a: float = 0.0, b: float = 0.0,
              c: float = 0.0) -> torch.Tensor:
    """``a*x^2 + b*x + c`` (``quadratic_op.cc``)."""
    return a * x * x + b * x + c


def index_copy(old: torch.Tensor, index: torch.Tensor,
               new_rows: torch.Tensor) -> torch.Tensor:
    """``old`` with ``new_rows`` copied in at ``index`` along axis 0,
    returned as a new tensor (``index_copy.cc`` writes in place)."""
    return old.index_copy(0, index.long(), new_rows)
