"""The 2-bit wire codec in numpy: the host data plane's side of
``parallel.compression`` (the port's own copies of the JAX package's
oracles, ``dt_tpu/parallel/compression.py:75-119``).  It imports numpy
alone, so the scheduler and the standby, which decode contributions, never
load torch.

16 codes pack into one 32-bit word, element ``16w + i`` at bits ``2i`` of
word ``w``; code values 0 -> 0.0, 1 -> +threshold, 2 -> -threshold (code 3
unused).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

CODES_PER_WORD = 16  # 2-bit codes in one 32-bit word


def _padded_words(n: int) -> int:
    return -(-n // CODES_PER_WORD)


def np_quantize_2bit(grad: np.ndarray, residual: np.ndarray,
                     threshold: float = 0.5) -> Tuple[np.ndarray, np.ndarray]:
    flat = (grad + residual).ravel()
    n = flat.shape[0]
    codes = np.zeros(n, np.uint32)
    codes[flat >= threshold] = 1
    codes[flat <= -threshold] = 2
    decoded = np.zeros(n, np.float32)
    decoded[codes == 1] = threshold
    decoded[codes == 2] = -threshold
    new_residual = (flat - decoded).reshape(grad.shape).astype(residual.dtype)
    pad = _padded_words(n) * CODES_PER_WORD - n
    codes = np.pad(codes, (0, pad)).reshape(-1, CODES_PER_WORD)
    shifts = (np.arange(CODES_PER_WORD, dtype=np.uint32) * 2)
    packed = np.bitwise_or.reduce(codes << shifts[None, :], axis=1) \
        .astype(np.uint32)
    return packed, new_residual


def packed_chunks(packed: np.ndarray, n: int, per_elems: int):
    """Split a packed 2-bit stream into per-chunk (words, n_chunk) pairs on
    the element grid; ``per_elems`` must be a multiple of ``CODES_PER_WORD``
    so every chunk is whole words.  The slices are views."""
    if per_elems % CODES_PER_WORD:
        raise ValueError(f"per_elems {per_elems} must be a multiple of "
                         f"{CODES_PER_WORD}")
    words_per = per_elems // CODES_PER_WORD
    out = []
    for start in range(0, n, per_elems):
        w0 = start // CODES_PER_WORD
        out.append((packed[w0:w0 + words_per], min(per_elems, n - start)))
    return out


def np_dequantize_2bit(packed: np.ndarray, n: int, threshold: float = 0.5,
                       dtype=np.float32) -> np.ndarray:
    shifts = (np.arange(CODES_PER_WORD, dtype=np.uint32) * 2)
    codes = (packed[:, None] >> shifts[None, :]) & np.uint32(3)
    vals = np.zeros(codes.shape, dtype)
    vals[codes == 1] = threshold
    vals[codes == 2] = -threshold
    return vals.ravel()[:n]
