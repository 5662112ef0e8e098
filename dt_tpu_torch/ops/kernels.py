"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``fused_bn_inference`` replaces the Pallas TPU kernel of the same name
(``dt_tpu/ops/pallas/kernels.py:43,52``): inference BatchNorm, with an
optional ReLU, as one pass ``y = x * scale + bias`` over the ``(rows, C)``
view of an NHWC activation.  The CUDA source is ``csrc/bn_act.cu``.  It is
bound by bytes: it reads and writes ``2 * rows * C * itemsize`` bytes, and
its least time is that over the H100's 3.35 TB/s.

A kernel's wrapper (``bn_act``) launches the kernel for a CUDA tensor and
uses the plain version only for a CPU tensor; there is no fallback from one
to the other.  Each wrapper counts its launches in its ``launches``
attribute.
"""

from __future__ import annotations

import ctypes

import torch

from dt_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _bn_act_lib() -> ctypes.CDLL:
    lib = _build.library("bn_act")
    if lib.dt_bn_act.argtypes is None:
        v = ctypes.c_void_p
        lib.dt_bn_act.argtypes = [v, v, v, v, ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int, ctypes.c_int, v]
        lib.dt_bn_act.restype = ctypes.c_int
        lib.dt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def rows_view(x: torch.Tensor) -> torch.Tensor:
    """The ``(rows, C)`` view of a channels_last NCHW tensor (the same view
    as the TPU kernel's ``x.reshape(-1, c)`` of NHWC) or of a contiguous 2-D
    tensor.  Raises rather than copy: a copy would hide a layout bug."""
    if x.dim() == 4:
        if not x.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(
                "fused_bn_inference: a 4-D input must be channels_last "
                f"(NHWC in memory), got strides {tuple(x.stride())} for "
                f"shape {tuple(x.shape)}")
        return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])
    if x.dim() == 2:
        if not x.is_contiguous():
            raise ValueError("fused_bn_inference: a 2-D input must be "
                             "contiguous")
        return x
    raise ValueError("fused_bn_inference: input must be 4-D channels_last "
                     f"NCHW or 2-D (rows, C), got shape {tuple(x.shape)}")


def _like_input(y2: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if x.dim() == 4:
        n, c, h, w = x.shape
        return y2.view(n, h, w, c).permute(0, 3, 1, 2)
    return y2


def bn_scale_bias(gamma, beta, mean, var, eps: float, dtype: torch.dtype):
    """``scale = gamma * rsqrt(var + eps)`` and ``bias = beta - mean * gamma *
    rsqrt(var + eps)`` in f32, cast to ``dtype`` (``kernels.py:71-72``)."""
    gamma, beta, mean, var = (t.float() for t in (gamma, beta, mean, var))
    inv = torch.rsqrt(var + eps)
    scale = gamma * inv
    bias = beta - mean * gamma * inv
    return scale.to(dtype), bias.to(dtype)


def bn_act_plain(x2: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                 relu: bool) -> torch.Tensor:
    """The plain version of the kernel on the ``(rows, C)`` view: the same
    arithmetic, rounded at the same points (after the multiply, after the
    add), with a ReLU that keeps NaN."""
    y = x2 * scale
    y = y + bias
    if relu:
        y = torch.where(y < 0, torch.zeros_like(y), y)
    return y


def bn_act(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           relu: bool = False) -> torch.Tensor:
    """The kernel's wrapper: ``y = x * scale + bias`` (then ReLU) per
    channel, ``scale``/``bias`` of shape ``(C,)`` in ``x``'s dtype.  A CUDA
    tensor launches ``csrc/bn_act.cu`` and counts the launch in
    ``bn_act.launches``; a CPU tensor runs :func:`bn_act_plain`."""
    x2 = rows_view(x)
    if x.dtype not in _DTYPE_CODES:
        raise TypeError("fused_bn_inference: dtype must be float32 or "
                        f"bfloat16, got {x.dtype}")
    rows, c = x2.shape
    for name, t in (("scale", scale), ("bias", bias)):
        if (tuple(t.shape) != (c,) or t.dtype != x.dtype
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(
                f"fused_bn_inference: {name} must be contiguous ({c},) "
                f"{x.dtype} on {x.device}, got {tuple(t.shape)} {t.dtype} on "
                f"{t.device}")
    if x.device.type == "cpu":
        return _like_input(bn_act_plain(x2, scale, bias, relu), x)
    if x.device.type != "cuda":
        raise ValueError(f"fused_bn_inference: unsupported device {x.device}")
    y2 = torch.empty((rows, c), dtype=x.dtype, device=x.device)
    if rows == 0:
        return _like_input(y2, x)
    lib = _bn_act_lib()
    with torch.cuda.device(x.device):
        err = lib.dt_bn_act(x2.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                            y2.data_ptr(), rows, c, _DTYPE_CODES[x.dtype],
                            int(relu), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("fused_bn_inference: kernel launch failed: "
                           + lib.dt_cuda_error_string(err).decode())
    bn_act.launches += 1
    return _like_input(y2, x)


bn_act.launches = 0


def fused_bn_inference(x: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, mean: torch.Tensor,
                       var: torch.Tensor, *, eps: float = 1e-5,
                       relu: bool = False) -> torch.Tensor:
    """Inference BatchNorm (+ReLU) over the channel axis.

    ``x`` is NCHW in ``torch.channels_last`` memory format, or a contiguous
    ``(rows, C)`` matrix, in float32 or bfloat16; ``gamma``/``beta``/``mean``
    /``var`` are ``(C,)``.  The result has ``x``'s shape, dtype and layout.
    Scale and bias are computed as the TPU wrapper computes them, then
    :func:`bn_act` applies them.
    """
    c = x.shape[1] if x.dim() == 4 else x.shape[-1]
    for name, t in (("gamma", gamma), ("beta", beta), ("mean", mean),
                    ("var", var)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"fused_bn_inference: {name} must have shape "
                             f"({c},), got {tuple(t.shape)}")
    scale, bias = bn_scale_bias(gamma, beta, mean, var, eps, x.dtype)
    return bn_act(x, scale, bias, relu)
