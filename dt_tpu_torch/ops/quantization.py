"""INT8 quantized inference (counterpart of ``dt_tpu/ops/quantization.py``):
not ported yet.  ``quantized_conv2d`` is an int8 x int8 -> int32
convolution that no PyTorch CUDA call computes, so it needs a kernel of its
own; it comes with ``onnx.py`` and ``examples/quantize_model.py`` in
ROADMAP.md, Queue 1 item 8.  Every name of the JAX module raises here."""

from __future__ import annotations

_TODO = ("ops.quantization is not ported yet: the int8 path (quantize, "
         "requantize, quantized_dense/conv2d, calibration) comes with "
         "onnx.py in ROADMAP.md, Queue 1 item 8")

NAMES = ("quantize", "dequantize", "requantize", "quantized_dense",
         "quantized_conv2d", "MinMaxCollector", "entropy_calibrate",
         "quantize_params")


def __getattr__(name: str):
    if name in NAMES:
        raise NotImplementedError(_TODO)
    raise AttributeError(name)
