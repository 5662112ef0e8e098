"""2-bit gradient compression with error-feedback residual (counterpart of
``dt_tpu/parallel/compression.py``).

Workers quantize ``grad + residual`` to 2-bit codes {0, +threshold,
-threshold}, keep the quantization error as the next step's residual, and
the receiver dequantizes.  16 codes pack into one 32-bit word, element
``16w + i`` at bits ``2i`` of word ``w``.  Two implementations with one wire
format:

- torch, on the card: :func:`quantize_2bit` / :func:`dequantize_2bit` are
  the CUDA kernels' wrappers (``ops.kernels``), which run their plain
  versions on a CPU tensor.  Words are int32 tensors; ``.numpy().view(
  np.uint32)`` gives the wire's uint32 words.
- numpy, for the host data plane: :func:`np_quantize_2bit` /
  :func:`np_dequantize_2bit`, the port's own copies of the JAX package's
  oracles (``compression.py:75-119``), which both torch paths match bit for
  bit; they live in ``parallel.codec_np``, which imports no torch, so the
  scheduler's process never loads it.

Code values: 0 -> 0.0, 1 -> +threshold, 2 -> -threshold (code 3 unused).
"""

from __future__ import annotations

import numpy as np
import torch

from dt_tpu_torch.parallel.codec_np import (
    np_dequantize_2bit as np_dequantize_2bit,
    np_quantize_2bit as np_quantize_2bit,
    packed_chunks as packed_chunks,
)
from dt_tpu_torch.ops.kernels import (
    CODES_PER_WORD as CODES_PER_WORD,
    dequantize_2bit as dequantize_2bit,
    dequantize_2bit_plain as dequantize_2bit_plain,
    quantize_2bit as quantize_2bit,
    quantize_2bit_plain as quantize_2bit_plain,
)


class GradientCompression:
    """Stateful wrapper holding the error-feedback residual (reference
    ``GradientCompression`` + per-key residual buffers): a numpy residual
    for :meth:`compress` and a device one for :meth:`compress_on_device`."""

    def __init__(self, threshold: float = 0.5):
        if threshold <= 0:
            raise ValueError("threshold must be positive")
        self.threshold = threshold
        self._residual: np.ndarray = None
        self._residual_dev: torch.Tensor = None

    def compress(self, grad: np.ndarray) -> np.ndarray:
        if self._residual is None or self._residual.shape != grad.shape:
            self._residual = np.zeros_like(grad, np.float32)
        packed, self._residual = np_quantize_2bit(
            grad.astype(np.float32), self._residual, self.threshold)
        return packed

    def compress_on_device(self, grad: torch.Tensor) -> torch.Tensor:
        """Quantize on the card before the host fetch: only the int32 words
        (16x fewer bytes) leave the device, and the residual stays there.
        A CUDA tensor always launches the kernel (``ops.kernels.
        quantize_2bit``)."""
        grad = grad.float().contiguous()
        r = self._residual_dev
        if r is None or r.shape != grad.shape or r.device != grad.device:
            r = torch.zeros_like(grad)
        words, self._residual_dev = quantize_2bit(grad, r, self.threshold)
        return words

    def decompress(self, packed: np.ndarray, n: int) -> np.ndarray:
        return np_dequantize_2bit(packed, n, self.threshold)

    def decompress_on_device(self, words: torch.Tensor, n: int
                             ) -> torch.Tensor:
        """Words back to ``n`` f32 values on the words' device (the
        counterpart of the JAX package's ``dequantize_2bit``)."""
        return dequantize_2bit(words, n, self.threshold)
