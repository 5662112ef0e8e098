"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Each wrapper launches its kernel for a CUDA tensor and uses the plain version
only for a CPU tensor; there is no fallback from one to the other.  Each
wrapper counts its launches in its ``launches`` attribute.  Most of them are
bound by bytes; their least time is the bytes they must move over the H100's
3.35 TB/s.

- ``bn_act`` (``csrc/bn_act.cu``) replaces the Pallas TPU kernel
  ``_bn_act_kernel`` (``dt_tpu/ops/pallas/kernels.py:43``; ``kernels.py:N``
  below is that file): ``y = x * scale + bias`` (+ReLU) over the ``(rows,
  C)`` view of an NHWC activation.  It is the whole of
  ``fused_bn_inference`` and pass 2 of ``fused_bn_train``.
- ``bn_stats`` (``csrc/bn_train.cu``) replaces ``_bn_partials_kernel`` and
  the reduction after it (``kernels.py:101,107-140``): per-channel batch mean
  and ``E[x^2] - mean^2`` variance (clamped at 0), pass 1 of
  ``fused_bn_train``, in one launch whose geometry :func:`stats_geometry`
  picks.  Deterministic: no float atomics.  ``bn_sums``, the same launch
  stopped short of the finalize, writes each channel's f32 sum and sum of
  squares: pass 1 of a batch sharded over processes, whose sums cross the
  ranks before the mean and variance are formed (:func:`cross_rank_bn`).
- ``quantize_2bit`` and ``dequantize_2bit`` (``csrc/quant2.cu``) replace
  ``_quant2_kernel`` and ``_dequant2_kernel`` (``kernels.py:233,284``): the
  2-bit error-feedback gradient codec, 16 codes per 32-bit word, bit-exact
  against the numpy oracle.  Words are int32 tensors (torch's uint32 support
  is partial); ``.numpy().view(np.uint32)`` gives the wire's words.
- ``lstm_point`` (``csrc/lstm_point.cu``) replaces ``_lstm_point_kernel``
  (``kernels.py:319``): the pointwise stage of an LSTM cell, the forward of
  ``lstm_pointwise`` and so of ``lstm_cell_fused``, one step at a time.
- ``lstm_layer`` (``csrc/lstm_layer.cu``) replaces the same kernel on the
  path of the multi-layer LSTM (``dt_tpu/ops/rnn.py:84-114``): a whole
  layer window, every step's recurrent product and pointwise stage, in one
  thread-block-cluster launch, in f32 (CUDA cores) and bf16 (the product on
  the tensor cores, with the JAX package's bf16 roundings).  In practice
  bound by its serial chain of steps; :func:`lstm_layer_fused` is its
  differentiable form.
- ``lstm_layer_bwd`` (``csrc/lstm_layer_bwd.cu``) replaces the custom VJP
  of ``_lstm_point_kernel`` (``_lstm_pointwise_bwd``, ``kernels.py:381-404``)
  chained through a layer window: the BPTT recurrence of the cell's
  backward and ``dh = dG Wh^T``, one cluster launch a layer window, f32
  and bf16; the weight gradients are matrix products after it.

- ``nms_keep`` (``csrc/nms.cu``) replaces the greedy scan of the JAX
  package's ``nms`` (``dt_tpu/ops/detection.py:141-169``), a
  ``lax.fori_loop`` with no Pallas kernel behind it: the keep mask of
  score-sorted boxes, each image's prefix reordered by label
  (:func:`nms_label_runs`) and each label's run scanned by one warp.  Bound
  by operations (the pairs' IoUs at 67 TFLOP/s f32); in practice its mask
  kernel's correctly rounded IoUs take most of a call, then the serial
  chain of the longest run.

- ``qconv`` (``csrc/qconv.cu``) computes the JAX package's
  ``quantized_conv2d`` and ``quantized_dense`` (``dt_tpu/ops/
  quantization.py:52,65``), which are XLA int8 convolutions and products
  with an int32 accumulator, no Pallas kernel: an implicit GEMM on the
  int8 tensor cores (``wgmma`` s8 from a TMA / ``cp.async`` ring, A
  loaded by one of three routes, the weight packed K-major once by
  ``qconv_pack`` and cached) with the float epilogue fused and written in
  16-byte rows, bit-equal to its plain version.  Bound by bytes, mostly
  its output.

``flash_attn`` (``csrc/flash_attn.cu``, the flash-attention forward) is
bound by operations; its wrapper lives in ``ops.attention`` and its
signature here.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import time
import weakref
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from dt_tpu_torch.obs import device as obs_device
from dt_tpu_torch.obs import trace as obs_trace
from dt_tpu_torch.ops import _build, remat
from dt_tpu_torch.parallel.codec_np import CODES_PER_WORD

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_V, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# library -> C function -> argument types (every function returns a
# cudaError_t as int)
_SIGNATURES = {
    "bn_act": {"dt_bn_act": [_V, _V, _V, _V, _I64, _I64, _INT, _INT, _V]},
    # x, scratch, tickets, mean, var; rows, C; dtype, vec, bx, by, slices,
    # row blocks; stream
    "bn_train": {"dt_bn_stats": [_V] * 5 + [_I64] * 2 + [_INT] * 6 + [_V],
                 "dt_bn_sums": [_V] * 5 + [_I64] * 2 + [_INT] * 6 + [_V]},
    "quant2": {
        "dt_quantize_2bit": [_V, _V, _V, _V, _I64, ctypes.c_float, _V],
        "dt_dequantize_2bit": [_V, _V, _I64, ctypes.c_float, _V]},
    "lstm_point": {"dt_lstm_point": [_V, _V, _V, _V, _I64, _I64, _INT, _V]},
    # xw, h0, c0, wh, hs, cs, gates; T, B, H, n, rows, ks, clusters, wsm,
    # reverse; shared-memory bytes; stream
    "lstm_layer": {"dt_lstm_layer": [_V] * 7 + [_INT] * 9 + [_I64, _V],
                   # xw, b, h0, c0, wh, hs, cs, gates; T, B, H, n, rows, ks,
                   # clusters, wsm, reverse; shared-memory bytes; stream
                   "dt_lstm_layer_bf16": [_V] * 8 + [_INT] * 9 + [_I64, _V]},
    # gates, cs, c0, wh, dhs, dcs, dgates, dh0, dc0; T, B, H, n, rows, ks,
    # clusters, wsm, dtype, reverse; shared-memory bytes; stream
    "lstm_layer_bwd": {"dt_lstm_layer_bwd": [_V] * 9 + [_INT] * 10
                       + [_I64, _V]},
    # q, k, v, out, lse; batch, heads, sq, sk, d; (b, s, h) strides of q, k
    # and v; scale, causal, dtype; stream
    "flash_attn": {"dt_flash_attn_fwd": [_V] * 5 + [_I64] * 14
                   + [ctypes.c_float, _INT, _INT, _V]},
    # boxes, labels, counts, perm, mask scratch, keep; batch, N; threshold;
    # stream
    "nms": {"dt_nms": [_V] * 6 + [_I64] * 2 + [ctypes.c_float, _V]},
    # x, packed w, bias, divisor, out; batch, H, W, Cp; kh, kw, N, OH, OW,
    # sh, sw, pad top, pad left, dtype, BN, route, 16-byte stores;
    # shared-memory bytes; stream
    "qconv": {"dt_qconv": [_V] * 5 + [_I64] * 4 + [_INT] * 13 + [_I64, _V],
              # w, packed; kh, kw, kw padded, C, Cp, N; stream
              "dt_qconv_pack": [_V, _V] + [_INT] * 6 + [_V]},
}


def _lib(name: str) -> ctypes.CDLL:
    lib = _build.library(name)
    if lib.dt_cuda_error_string.restype is not ctypes.c_char_p:
        for fn, argtypes in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.dt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _launch(what: str, name: str, fn: str, device: torch.device,
            *args, sig=()) -> None:
    """Call ``fn`` of library ``name`` on ``device``'s current stream (the
    stream is appended to ``args``); raise if the launch failed.  With the
    device plane armed, the first launch of each shape and dtype of the
    tensors ``sig`` enters its compile ledger."""
    t0 = time.perf_counter() if obs_device.enabled() else None
    lib = _lib(name)
    with torch.cuda.device(device):
        err = getattr(lib, fn)(*args,
                               torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed: "
                           + lib.dt_cuda_error_string(err).decode())
    if t0 is not None:
        obs_device.note_launch(what, sig,
                               (time.perf_counter() - t0) * 1e3)


def _on_cuda(what: str, t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU one; raises otherwise."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {t.device}")
    return True


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """The BN wrappers' accumulation type: float32, but float64 for a
    float64 input (on the CPU only, where the plain versions run)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _check_dtype(what: str, x: torch.Tensor) -> None:
    """float32 and bfloat16 run on either device; float64 runs the plain
    versions on the CPU only (a test's well-conditioned reference)."""
    if x.dtype in _DTYPE_CODES or (x.dtype == torch.float64
                                   and x.device.type == "cpu"):
        return
    raise TypeError(f"{what}: dtype must be float32 or bfloat16 (or float64 "
                    f"on the CPU), got {x.dtype} on {x.device}")


def rows_view(x: torch.Tensor, what: str = "fused_bn_inference"
              ) -> torch.Tensor:
    """The ``(rows, C)`` view of a channels_last NCHW tensor (the same view
    as the TPU kernel's ``x.reshape(-1, c)`` of NHWC) or of a contiguous 2-D
    tensor.  Raises rather than copy: a copy would hide a layout bug."""
    if x.dim() == 4:
        if not x.is_contiguous(memory_format=torch.channels_last):
            raise ValueError(
                f"{what}: a 4-D input must be channels_last "
                f"(NHWC in memory), got strides {tuple(x.stride())} for "
                f"shape {tuple(x.shape)}")
        return x.permute(0, 2, 3, 1).reshape(-1, x.shape[1])
    if x.dim() == 2:
        if not x.is_contiguous():
            raise ValueError(f"{what}: a 2-D input must be contiguous")
        return x
    raise ValueError(f"{what}: input must be 4-D channels_last "
                     f"NCHW or 2-D (rows, C), got shape {tuple(x.shape)}")


def _like_input(y2: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    if x.dim() == 4:
        n, c, h, w = x.shape
        return y2.view(n, h, w, c).permute(0, 3, 1, 2)
    return y2


def bn_scale_bias(gamma, beta, mean, var, eps: float, dtype: torch.dtype):
    """``scale = gamma * rsqrt(var + eps)`` and ``bias = beta - mean * gamma *
    rsqrt(var + eps)`` in f32 (f64 for a float64 ``dtype``), cast to
    ``dtype`` (``kernels.py:71-72``)."""
    acc = _acc_dtype(dtype)
    gamma, beta, mean, var = (t.to(acc) for t in (gamma, beta, mean, var))
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
    _check_dtype("fused_bn_inference", x)
    rows, c = x2.shape
    for name, t in (("scale", scale), ("bias", bias)):
        if (tuple(t.shape) != (c,) or t.dtype != x.dtype
                or t.device != x.device or not t.is_contiguous()):
            raise ValueError(
                f"fused_bn_inference: {name} must be contiguous ({c},) "
                f"{x.dtype} on {x.device}, got {tuple(t.shape)} {t.dtype} on "
                f"{t.device}")
    if not _on_cuda("fused_bn_inference", x):
        return _like_input(bn_act_plain(x2, scale, bias, relu), x)
    y2 = torch.empty((rows, c), dtype=x.dtype, device=x.device)
    if rows == 0:
        return _like_input(y2, x)
    _launch("fused_bn_inference", "bn_act", "dt_bn_act", x.device,
            x2.data_ptr(), scale.data_ptr(), bias.data_ptr(), y2.data_ptr(),
            rows, c, _DTYPE_CODES[x.dtype], int(relu), sig=(x2,))
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


# ---------------------------------------------------------------------------
# Training BatchNorm: pass 1 (bn_stats) + pass 2 (bn_act), custom backward
# ---------------------------------------------------------------------------

class StatsGeometry(NamedTuple):
    """The launch of pass 1 for a ``(rows, C)`` input: a grid of
    ``(slices, row_blocks)`` blocks of ``(bx, by)`` threads, a thread
    loading ``vec`` channels at once; the threads of the grid take the rows
    round-robin."""
    vec: int
    bx: int
    by: int
    slices: int
    row_blocks: int

    def partial_bytes(self, c: int) -> int:
        """f32 sums and sums of squares of every row block (none for
        one)."""
        return 0 if self.row_blocks == 1 else 8 * c * self.row_blocks


_STATS_THREADS = 256
_SLICE_CHANNELS = (256, 32)  # widest and narrowest slice, in channels
_STATS_BLOCKS = 264  # ~2 per SM of the H100's 132: one wave fills it
_PARTIAL_SHARE = 16  # partials at most 1/16 of x's bytes ...
_PARTIAL_FLOOR = 64 * 1024  # ... or at most 64 KB
_PARTIAL_LOADS = 8  # rows of partials a thread of the last block adds
_MAX_TICKETS = 1 << 16  # ticket counters (one a slice) kept per device


def stats_geometry(rows: int, c: int, itemsize: int,
                   aligned: bool = True) -> StatsGeometry:
    """Pass 1's launch for a ``(rows, C)`` input of ``itemsize``-byte
    elements (``aligned``: x starts on 16 bytes).  Threads load 16 bytes of
    channels where the rows allow it.  Row blocks fill the card (~2 blocks
    an SM in all) as far as the partials stay within 1/16 of x's bytes (or
    64 KB) and within ``_PARTIAL_LOADS`` rows a thread of the slice's last
    block; slices of 256 channels narrow (to 32) while the grid is short of
    blocks."""
    vec = 16 // itemsize if aligned and (c * itemsize) % 16 == 0 else 1
    vecs = c // vec
    budget = max(rows * c * itemsize // _PARTIAL_SHARE, _PARTIAL_FLOOR)
    bx = min(vecs, max(1, _SLICE_CHANNELS[0] // vec))
    while True:
        by = _STATS_THREADS // bx
        slices = -(-vecs // bx)
        row_blocks = max(1, min(-(-_STATS_BLOCKS // slices),
                                by * _PARTIAL_LOADS, budget // (8 * c),
                                -(-rows // by), 65535))
        if (slices * row_blocks >= _STATS_BLOCKS or bx == 1
                or bx * vec <= _SLICE_CHANNELS[1]):
            return StatsGeometry(vec, bx, by, slices, row_blocks)
        bx //= 2


_tickets = {}  # device -> pass 1's ticket counters, zeroed once
_ticket_stream = {}  # device -> the stream of its last pass-1 launch


def _stats_tickets(device: torch.device) -> torch.Tensor:
    """The device's ticket counters, for a launch on the current stream.
    Every launch on a device shares them, so a launch on another stream
    than the last one first waits for that stream (outside CUDA graph
    capture, where the caller orders the streams)."""
    capturing = torch.cuda.is_current_stream_capturing()
    t = _tickets.get(device)
    if t is None:
        if capturing:
            raise RuntimeError(
                "fused_bn_train: the first bn_stats call on a device "
                "allocates and zeroes its tickets, which a CUDA graph "
                "capture cannot; call it once before capturing")
        t = torch.zeros(_MAX_TICKETS, dtype=torch.int32, device=device)
        _tickets[device] = t
    stream = torch.cuda.current_stream(device)
    last = _ticket_stream.get(device)
    if last is not None and last != stream and not capturing:
        stream.wait_stream(last)
    _ticket_stream[device] = stream
    return t


def bn_stats_plain(x2: torch.Tensor):
    """The plain version of pass 1 on the ``(rows, C)`` view: f32 (f64 for
    float64) ``mean = sum(x) / n`` and ``var = max(sum(x*x) / n - mean^2,
    0)`` (NaN kept), the TPU kernel's formula (``kernels.py:135-140``)."""
    x32 = x2.to(_acc_dtype(x2.dtype))
    n = x2.shape[0]
    mean = x32.sum(0) / n
    var = (x32 * x32).sum(0) / n - mean * mean
    return mean, torch.where(var < 0, torch.zeros_like(var), var)


def _pass1(x: torch.Tensor, fn: str):
    """One pass-1 launch of ``fn`` (``dt_bn_stats`` or ``dt_bn_sums``) on a
    CUDA ``x``'s ``(rows, C)`` view: its two ``(C,)`` f32 outputs."""
    x2 = rows_view(x, "fused_bn_train")
    rows, c = x2.shape
    geo = stats_geometry(rows, c, x.element_size(), x2.data_ptr() % 16 == 0)
    if geo.slices > _MAX_TICKETS:
        raise ValueError(f"fused_bn_train: a ({rows}, {c}) input needs "
                         f"{geo.slices} tickets, more than the "
                         f"{_MAX_TICKETS} kept")
    scratch = torch.empty(geo.partial_bytes(c) // 4, dtype=torch.float32,
                          device=x.device)
    out0 = torch.empty(c, dtype=torch.float32, device=x.device)
    out1 = torch.empty(c, dtype=torch.float32, device=x.device)
    _launch("fused_bn_train", "bn_train", fn, x.device,
            x2.data_ptr(), scratch.data_ptr(),
            _stats_tickets(x.device).data_ptr(), out0.data_ptr(),
            out1.data_ptr(), rows, c, _DTYPE_CODES[x.dtype], *geo, sig=(x2,))
    return out0, out1


def _check_pass1(x: torch.Tensor) -> torch.Tensor:
    """``x``'s ``(rows, C)`` view; raises for a dtype or a shape pass 1
    does not take."""
    x2 = rows_view(x, "fused_bn_train")
    _check_dtype("fused_bn_train", x)
    if x2.shape[0] == 0 or x2.shape[1] == 0:
        raise ValueError("fused_bn_train: batch statistics of an empty "
                         f"input {tuple(x.shape)}")
    return x2


def bn_stats(x: torch.Tensor):
    """Pass 1's wrapper: per-channel f32 batch ``(mean, var)`` of ``x``
    (channels_last NCHW or contiguous ``(rows, C)``, float32 or bfloat16).
    A CUDA tensor launches ``csrc/bn_train.cu`` once and counts the launch
    in ``bn_stats.launches``; a CPU tensor runs :func:`bn_stats_plain`.

    The kernel's tickets are shared by every launch on a device, so a call
    on another stream than the last call's waits for that stream first.
    Graph-safe once a call has run outside capture on the device; inside a
    capture the caller orders the streams."""
    x2 = _check_pass1(x)
    if not _on_cuda("fused_bn_train", x):
        return bn_stats_plain(x2)
    mean, var = _pass1(x, "dt_bn_stats")
    bn_stats.launches += 1
    return mean, var


bn_stats.launches = 0


def bn_sums_plain(x2: torch.Tensor):
    """The plain version of :func:`bn_sums` on the ``(rows, C)`` view: f32
    (f64 for float64) ``(sum(x), sum(x*x))`` over the rows."""
    x32 = x2.to(_acc_dtype(x2.dtype))
    return x32.sum(0), (x32 * x32).sum(0)


def bn_sums(x: torch.Tensor):
    """Pass 1 stopped short of the finalize: per-channel f32 ``(sum(x),
    sum(x*x))`` over ``x``'s rows (``x`` as for :func:`bn_stats`).  A CUDA
    tensor launches ``csrc/bn_train.cu``'s ``dt_bn_sums`` once (the same
    geometry and tickets as :func:`bn_stats`) and counts the launch in
    ``bn_sums.launches``; a CPU tensor runs :func:`bn_sums_plain`."""
    x2 = _check_pass1(x)
    if not _on_cuda("fused_bn_train", x):
        return bn_sums_plain(x2)
    s, q = _pass1(x, "dt_bn_sums")
    bn_sums.launches += 1
    return s, q


bn_sums.launches = 0


def _bwd_sums(x, y, gy, mean, var, eps: float, relu: bool):
    """The backward's local parts: ``(x2, gy32 with the ReLU's mask, x_hat,
    inv, dbeta = sum(gy), dgamma = sum(gy * x_hat))`` over ``x``'s rows."""
    if gy.dim() == 4:
        gy = gy.contiguous(memory_format=torch.channels_last)
    else:
        gy = gy.contiguous()
    x2 = rows_view(x, "fused_bn_train")
    acc = _acc_dtype(x.dtype)
    gy32 = rows_view(gy, "fused_bn_train").to(acc)
    if relu:
        gy32 = torch.where(rows_view(y, "fused_bn_train") > 0, gy32,
                           torch.zeros_like(gy32))
    inv = torch.rsqrt(var + eps)
    x_hat = (x2.to(acc) - mean) * inv
    return x2, gy32, x_hat, inv, gy32.sum(0), (gy32 * x_hat).sum(0)


def _bn_dx(x, gamma, gy32, x_hat, inv, dbeta, dgamma, n):
    """``dx`` of training BN over ``n`` rows in all, from the sums over
    those rows, in ``x``'s dtype and layout."""
    dx = (gamma.to(inv.dtype) * inv / n) * (n * gy32 - dbeta - x_hat * dgamma)
    return _like_input(dx.to(x.dtype), x)


def bn_train_backward(x, y, gy, gamma, mean, var, eps: float, relu: bool):
    """The backward of training BN (``_bn_train_bwd``, ``kernels.py:201-219``)
    in f32, with the ReLU's mask (``y > 0``) applied to ``gy`` first when the
    ReLU was fused in.  Returns ``(dx in x's dtype and layout, dgamma,
    dbeta)``."""
    x2, gy32, x_hat, inv, dbeta, dgamma = _bwd_sums(x, y, gy, mean, var,
                                                    eps, relu)
    dx = _bn_dx(x, gamma, gy32, x_hat, inv, dbeta, dgamma, x2.shape[0])
    return dx, dgamma, dbeta


class _FusedBNTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps, relu):
        mean, var = bn_stats(x)
        scale, bias = bn_scale_bias(gamma, beta, mean, var, eps, x.dtype)
        y = bn_act(x, scale, bias, relu)
        ctx.save_for_backward(x, gamma, mean, var, y if relu else None)
        ctx.eps, ctx.relu = eps, relu
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, gamma, mean, var, y = ctx.saved_tensors
        dx, dgamma, dbeta = bn_train_backward(x, y, gy, gamma, mean, var,
                                              ctx.eps, ctx.relu)
        return dx, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None, None


# the process group whose ranks hold the parts of one batch, inside
# ``cross_rank_bn`` (None: every batch is this process's alone)
_bn_group = None


@contextlib.contextmanager
def cross_rank_bn(group):
    """Within the block, training BN (:func:`fused_bn_train`) normalizes
    each rank's part of a batch sharded over ``group`` (a
    ``torch.distributed`` process group) with the whole batch's statistics,
    as GSPMD reduces the batch mean over the sharded axis.  ``None`` or a
    group of one rank leaves the one-device path as it is."""
    global _bn_group
    prev = _bn_group
    _bn_group = group if group is not None and \
        dist.get_world_size(group) > 1 else None
    try:
        yield
    finally:
        _bn_group = prev


def _group_sum(buf: torch.Tensor, group, span: str) -> None:
    """Sum ``buf`` over ``group``'s ranks in place.  With tracing on, the
    card's queue is drained first, so the span ``span`` times the
    collective alone."""
    tr = obs_trace.tracer()
    t0 = None
    if tr.on():
        if buf.is_cuda:
            torch.cuda.current_stream(buf.device).synchronize()
        t0 = tr.now()
    dist.all_reduce(buf, group=group)
    if t0 is not None:
        tr.complete_span(span, t0)


class _SyncBNTrain(torch.autograd.Function):
    """Training BN over a batch whose rows are spread over a process
    group's ranks.  Forward: :func:`bn_sums`, one all-reduce of ``[S, Q,
    n]``, then ``mean = S / N`` and ``var = max(Q / N - mean^2, 0)`` over
    the global count ``N`` (``kernels.py:135-140``) and pass 2
    (:func:`bn_act`) as on one device.  Backward: the local ``sum(gy)`` and
    ``sum(gy * x_hat)``, one all-reduce, then ``dx`` with the global sums
    and ``N``; ``dgamma``/``dbeta`` stay the local sums, which the mean of
    the ranks' gradients turns into the global batch's."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, relu, group):
        s, q = bn_sums(x)
        rows = rows_view(x, "fused_bn_train").shape[0]
        buf = torch.cat([s, q, torch.full((1,), float(rows),
                                          dtype=torch.float32,
                                          device=s.device)])
        _group_sum(buf, group, "mesh.bn_allreduce")
        c = s.shape[0]
        n = buf[2 * c]
        mean = buf[:c] / n
        var = buf[c:2 * c] / n - mean * mean
        var = torch.where(var < 0, torch.zeros_like(var), var)
        scale, bias = bn_scale_bias(gamma, beta, mean, var, eps, x.dtype)
        y = bn_act(x, scale, bias, relu)
        ctx.save_for_backward(x, gamma, mean, var, y if relu else None, n)
        ctx.eps, ctx.relu, ctx.group = eps, relu, group
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, gamma, mean, var, y, n = ctx.saved_tensors
        _, gy32, x_hat, inv, dbeta, dgamma = _bwd_sums(
            x, y, gy, mean, var, ctx.eps, ctx.relu)
        c = dbeta.shape[0]
        buf = torch.cat([dbeta, dgamma])
        _group_sum(buf, ctx.group, "mesh.bn_allreduce")
        dx = _bn_dx(x, gamma, gy32, x_hat, inv, buf[:c], buf[c:], n)
        return (dx, dgamma.to(gamma.dtype), dbeta.to(gamma.dtype), None,
                None, None)


def fused_bn_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   running_mean: torch.Tensor, running_var: torch.Tensor, *,
                   momentum: float = 0.9, eps: float = 1e-5,
                   relu: bool = False):
    """Training BatchNorm (+ReLU) over the channel axis: the batch's mean and
    variance (:func:`bn_stats`), then ``y = x * scale + bias`` (+ReLU) with
    ``scale``/``bias`` made from them in f32 and cast to ``x``'s dtype
    (:func:`bn_act`), as the TPU wrapper does (``kernels.py:107-165``).

    ``x`` as for :func:`fused_bn_inference`; ``gamma``/``beta`` f32 ``(C,)``,
    differentiable (backward: :func:`bn_train_backward`).  Inside
    :func:`cross_rank_bn` the statistics are those of the batch sharded over
    the group's ranks (:class:`_SyncBNTrain`).  The running stats
    are updated in place, under no_grad, to ``momentum * old + (1 -
    momentum) * batch`` in f32, except in the forward an ``ops.remat``
    checkpoint recomputes.  Returns ``(y, running_mean, running_var)``.
    """
    c = x.shape[1] if x.dim() == 4 else x.shape[-1]
    for name, t in (("gamma", gamma), ("beta", beta),
                    ("running_mean", running_mean),
                    ("running_var", running_var)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"fused_bn_train: {name} must have shape "
                             f"({c},), got {tuple(t.shape)}")
    if _bn_group is None:
        y, mean, var = _FusedBNTrain.apply(x, gamma, beta, eps, relu)
    else:
        y, mean, var = _SyncBNTrain.apply(x, gamma, beta, eps, relu,
                                          _bn_group)
    if remat.replaying():  # a recomputed forward moves nothing twice
        return y, running_mean, running_var
    with torch.no_grad():
        running_mean.copy_(running_mean * momentum + mean * (1.0 - momentum))
        running_var.copy_(running_var * momentum + var * (1.0 - momentum))
    return y, running_mean, running_var


# ---------------------------------------------------------------------------
# 2-bit gradient compression
# ---------------------------------------------------------------------------


def _words(n: int) -> int:
    return -(-n // CODES_PER_WORD)


def quantize_2bit_plain(grad: torch.Tensor, residual: torch.Tensor,
                        threshold: float = 0.5):
    """The plain version of the quantizer: ``x = grad + residual`` (f32),
    codes ``1 if x >= t, 2 if x <= -t, else 0`` with ``t`` the f32 value of
    ``threshold``, new residual ``x - decode(code)``, and element ``16w+i``
    at bits ``2i`` of word ``w`` (int32).  Returns ``(words, residual)``,
    the residual in ``grad``'s shape."""
    x = (grad.float() + residual.float()).reshape(-1)
    t = torch.full((), threshold, dtype=torch.float32, device=x.device)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    pos, neg = x >= t, x <= -t
    codes = torch.where(pos, 1, torch.where(neg, 2, 0)).to(torch.int64)
    decoded = torch.where(pos, t, torch.where(neg, -t, zero))
    new_residual = (x - decoded).reshape(grad.shape)
    n = x.numel()
    codes = torch.nn.functional.pad(codes, (0, _words(n) * CODES_PER_WORD - n))
    shifts = torch.arange(CODES_PER_WORD, device=x.device) * 2
    # disjoint 2-bit fields: the sum is the bitwise or, below 2**32 in int64
    words = (codes.view(-1, CODES_PER_WORD) << shifts).sum(1)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32), new_residual


def quantize_2bit(grad: torch.Tensor, residual: torch.Tensor,
                  threshold: float = 0.5):
    """The quantizer's wrapper: contiguous float32 ``grad`` and ``residual``
    of one shape -> ``(words, new_residual)``, ``ceil(n / 16)`` int32 words.
    A CUDA tensor launches ``csrc/quant2.cu`` and counts the launch in
    ``quantize_2bit.launches``; a CPU tensor runs
    :func:`quantize_2bit_plain`."""
    _check_flat("quantize_2bit", grad=grad, residual=residual)
    if residual.shape != grad.shape or residual.device != grad.device:
        raise ValueError("quantize_2bit: residual must match grad's shape "
                         f"and device, got {tuple(residual.shape)} on "
                         f"{residual.device} for {tuple(grad.shape)} on "
                         f"{grad.device}")
    if not _on_cuda("quantize_2bit", grad):
        return quantize_2bit_plain(grad, residual, threshold)
    n = grad.numel()
    words = torch.empty(_words(n), dtype=torch.int32, device=grad.device)
    new_residual = torch.empty_like(grad)
    if n == 0:
        return words, new_residual
    _launch("quantize_2bit", "quant2", "dt_quantize_2bit", grad.device,
            grad.data_ptr(), residual.data_ptr(), words.data_ptr(),
            new_residual.data_ptr(), n, float(threshold), sig=(grad,))
    quantize_2bit.launches += 1
    return words, new_residual


quantize_2bit.launches = 0


def dequantize_2bit_plain(words: torch.Tensor, n: int,
                          threshold: float = 0.5) -> torch.Tensor:
    """The plain version of the dequantizer: word ``w``'s code ``i`` ->
    element ``16w+i``, codes ``1 -> +t``, ``2 -> -t``, ``0, 3 -> 0`` (f32),
    trimmed to ``n``."""
    t = torch.full((), threshold, dtype=torch.float32, device=words.device)
    zero = torch.zeros((), dtype=torch.float32, device=words.device)
    shifts = torch.arange(CODES_PER_WORD, device=words.device) * 2
    codes = ((words.to(torch.int64) & 0xFFFFFFFF)[:, None] >> shifts) & 3
    vals = torch.where(codes == 1, t, torch.where(codes == 2, -t, zero))
    return vals.reshape(-1)[:n]


def dequantize_2bit(words: torch.Tensor, n: int,
                    threshold: float = 0.5) -> torch.Tensor:
    """The dequantizer's wrapper: ``ceil(n / 16)`` contiguous int32 words ->
    ``n`` float32 values.  A CUDA tensor launches ``csrc/quant2.cu`` and
    counts the launch in ``dequantize_2bit.launches``; a CPU tensor runs
    :func:`dequantize_2bit_plain`."""
    if words.dtype != torch.int32:
        raise TypeError(f"dequantize_2bit: words must be int32, got "
                        f"{words.dtype}")
    if words.dim() != 1 or not words.is_contiguous() or \
            words.numel() != _words(n):
        raise ValueError(f"dequantize_2bit: need {_words(n)} contiguous "
                         f"words for n={n}, got shape {tuple(words.shape)}")
    if not _on_cuda("dequantize_2bit", words):
        return dequantize_2bit_plain(words, n, threshold)
    out = torch.empty(n, dtype=torch.float32, device=words.device)
    if n == 0:
        return out
    _launch("dequantize_2bit", "quant2", "dt_dequantize_2bit", words.device,
            words.data_ptr(), out.data_ptr(), n, float(threshold),
            sig=(words,))
    dequantize_2bit.launches += 1
    return out


dequantize_2bit.launches = 0


def _check_flat(what: str, dtype: torch.dtype = torch.float32,
                **tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous "
                             f"{str(dtype).split('.')[-1]}, got {t.dtype} "
                             f"with strides {tuple(t.stride())}")


# ---------------------------------------------------------------------------
# LSTM cell pointwise stage
# ---------------------------------------------------------------------------


def lstm_pointwise_plain(gates: torch.Tensor, c: torch.Tensor):
    """The plain version of the pointwise stage (``kernels.py:319-327``):
    f32 gates ``(B, 4H)`` in order i, f, g, o and ``c`` ``(B, H)`` ->
    ``(h' f32, c' in c's dtype)`` with ``c' = sigmoid(f) * c + sigmoid(i) *
    tanh(g)`` and ``h' = sigmoid(o) * tanh(c')``, in f32."""
    g = gates.float()
    i, f, gg, o = g.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    gg = torch.tanh(gg)
    c_new = f * c.float() + i * gg
    return o * torch.tanh(c_new), c_new.to(c.dtype)


def lstm_point(gates: torch.Tensor, c: torch.Tensor):
    """The kernel's wrapper: contiguous f32 ``gates`` ``(B, 4H)`` and ``c``
    ``(B, H)`` (float32 or bfloat16) -> ``(h' f32, c' in c's dtype)``.  A
    CUDA tensor launches ``csrc/lstm_point.cu`` and counts the launch in
    ``lstm_point.launches``; a CPU tensor runs :func:`lstm_pointwise_plain`.
    """
    if gates.dim() != 2 or c.dim() != 2 or gates.shape[1] % 4 or \
            tuple(c.shape) != (gates.shape[0], gates.shape[1] // 4):
        raise ValueError(f"lstm_pointwise: need gates (B, 4H) and c (B, H), "
                         f"got {tuple(gates.shape)} and {tuple(c.shape)}")
    if gates.dtype != torch.float32 or c.dtype not in _DTYPE_CODES:
        raise TypeError(f"lstm_pointwise: gates must be float32 and c "
                        f"float32 or bfloat16, got {gates.dtype}, {c.dtype}")
    if gates.device != c.device or not (gates.is_contiguous()
                                        and c.is_contiguous()):
        raise ValueError("lstm_pointwise: gates and c must be contiguous on "
                         "one device")
    if not _on_cuda("lstm_pointwise", gates):
        return lstm_pointwise_plain(gates, c)
    rows, hidden = c.shape
    h_out = torch.empty((rows, hidden), dtype=torch.float32, device=c.device)
    c_out = torch.empty_like(c)
    if rows == 0 or hidden == 0:
        return h_out, c_out
    _launch("lstm_pointwise", "lstm_point", "dt_lstm_point", c.device,
            gates.data_ptr(), c.data_ptr(), h_out.data_ptr(),
            c_out.data_ptr(), rows, hidden, _DTYPE_CODES[c.dtype],
            sig=(gates,))
    lstm_point.launches += 1
    return h_out, c_out


lstm_point.launches = 0


def lstm_pointwise_backward(gates, c, gh, gc_out):
    """The backward of the pointwise stage (``_lstm_pointwise_bwd``,
    ``kernels.py:381-404``): it recomputes the activations from the saved
    pre-activations in f32 and returns ``(d_gates in gates' dtype, d_c in
    c's dtype)``."""
    c32 = c.float()
    gh, gc_out = gh.float(), gc_out.float()
    i, f, g, o = gates.float().chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    c_new = f * c32 + i * g
    tc = torch.tanh(c_new)
    dc_new = gc_out + gh * o * (1.0 - tc * tc)
    d_i = dc_new * g * i * (1.0 - i)
    d_f = dc_new * c32 * f * (1.0 - f)
    d_g = dc_new * i * (1.0 - g * g)
    d_o = gh * tc * o * (1.0 - o)
    d_gates = torch.cat([d_i, d_f, d_g, d_o], dim=-1).to(gates.dtype)
    return d_gates, (dc_new * f).to(c.dtype)


class _LSTMPointwise(torch.autograd.Function):
    @staticmethod
    def forward(ctx, gates, c):
        ctx.save_for_backward(gates, c)  # the primal dtypes, for the grads
        return lstm_point(gates.float().contiguous(), c.contiguous())

    @staticmethod
    def backward(ctx, gh, gc_out):
        gates, c = ctx.saved_tensors
        if gh is None:
            gh = torch.zeros(c.shape, dtype=torch.float32, device=c.device)
        if gc_out is None:
            gc_out = torch.zeros_like(c)
        return lstm_pointwise_backward(gates, c, gh, gc_out)


def lstm_pointwise(gates: torch.Tensor, c: torch.Tensor):
    """Fused i/f/g/o activations and state update after the gate matmuls
    (``kernels.py:330-346``): ``gates`` ``(B, 4H)`` (cast to f32 for the
    kernel) and ``c`` ``(B, H)`` -> ``(h' f32, c' in c's dtype)``, through
    :func:`lstm_point`.  Differentiable: the backward recomputes the
    activations (:func:`lstm_pointwise_backward`)."""
    return _LSTMPointwise.apply(gates, c)


def lstm_cell_fused(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor, w):
    """Drop-in for ``ops.rnn.lstm_cell`` (``kernels.py:410-421``): the gate
    matmuls as plain ``torch.matmul`` (``gates = (x @ wx + h @ wh).float() +
    b``), then :func:`lstm_pointwise` on f32 gates and f32 ``c``; both
    outputs in ``x``'s dtype.  ``w`` has ``wx`` (I, 4H), ``wh`` (H, 4H) and
    ``b`` (4H,)."""
    gates = (torch.matmul(x, w.wx) + torch.matmul(h, w.wh)).float() + w.b
    h_new, c_new = lstm_pointwise(gates, c.float())
    return h_new.to(x.dtype), c_new.to(x.dtype)


# ---------------------------------------------------------------------------
# LSTM layer: the whole window in one launch, forward and backward
# ---------------------------------------------------------------------------

_LAYER_THREADS = 512  # csrc/lstm_layer.cu NT
_LAYER_PAIRS = 4  # (row, unit) pairs a thread at most (PMAX)
_LAYER_KS_MAX = 8  # slices of the inputs at most (KS_MAX)
_LAYER_SMEM = 232448  # shared memory a block can use on the H100 (227 KB)
_LAYER_CLUSTER = 16  # blocks a cluster (a non-portable size above 8)
_LAYER_ROWS = 8  # batch rows a cluster the geometry aims at ...
_LAYER_CLUSTERS = 4  # ... over at most this many clusters (64 SMs)
_LAYER_BF16_ROWS = 16  # the bf16 kernel's rows a cluster at most (one m16)
_LAYER_BF16_KSPLIT = 8  # its slices of the k tiles at most (KSPLIT_MAX)
_LAYER_BF16_WARPS = _LAYER_THREADS // 32
_LAYER_BWD_KS_MAX = 32  # csrc/lstm_layer_bwd.cu KS_MAX


class LayerGeometry(NamedTuple):
    """The launch of one layer window: ``clusters`` clusters of ``n``
    blocks, each cluster ``rows`` batch rows; ``ks`` slices of the inputs
    a gate product (of the H inputs in f32, of the k tiles in bf16, of the
    4H inputs in the backward); ``wsm``: Wh in shared memory (else read
    from L2 every step); ``smem`` bytes of shared memory a block."""
    n: int
    rows: int
    clusters: int
    ks: int
    wsm: bool
    smem: int


def _layer_floats(hidden: int, n: int, rows: int, ks: int, wsm: bool):
    """(shared-memory floats a block, tiles of the gate product, pairs a
    block at most), as ``make_geo`` in ``csrc/lstm_layer.cu`` lays them
    out for f32: two h buffers (rows x (H4 + 4)), Wh's columns (H4 x C4)
    when ``wsm``, ``ks`` partial tiles (rows x C4) and c (rows x units)."""
    per = -(-hidden // n)
    c4 = -(-4 * per // 4) * 4
    h4 = -(-hidden // 4) * 4
    r4 = -(-rows // 4) * 4
    floats = 2 * r4 * (h4 + 4) + (h4 * c4 if wsm else 0) + ks * r4 * c4 \
        + rows * per
    return floats, (r4 // 4) * (c4 // 4), rows * per


def _layer_ks(hidden: int, n: int, rows: int) -> int:
    """Slices of the H inputs a gate product: as many as the threads left
    over by the tiles allow, 1 to 8."""
    tiles = _layer_floats(hidden, n, rows, 1, False)[1]
    return max(1, min(_LAYER_KS_MAX, _LAYER_THREADS // tiles))


def _layer_f32(hidden: int, n: int, rows: int, wsm: bool):
    """(bytes, ks, whether the threads take it) of the f32 forward."""
    ks = _layer_ks(hidden, n, rows)
    floats, tiles, pairs = _layer_floats(hidden, n, rows, ks, wsm)
    return floats * 4, ks, (tiles <= _LAYER_THREADS
                            and pairs <= _LAYER_PAIRS * _LAYER_THREADS)


def _layer_bytes_bf16(hidden: int, n: int, rows: int, wsm: bool):
    """(bytes, ks, whether the threads take it) of the bf16 forward, as
    ``bf::make_geo`` in ``csrc/lstm_layer.cu`` lays it out: two h buffers
    (rows x (K16 + 8) bf16), Wh's columns transposed (C8 x (K16 + 8) bf16)
    when ``wsm``, ``ks`` partial tiles (rows x C8 f32); ``ks`` slices of
    the K16 / 16 k tiles, as many as the 16 warps left over by the C8 / 8
    column tiles allow, 1 to 8."""
    per = -(-hidden // n)
    c8 = -(-4 * per // 8) * 8
    k16 = -(-hidden // 16) * 16
    hs = k16 + 8
    ks = max(1, min(k16 // 16, _LAYER_BF16_KSPLIT,
                    _LAYER_BF16_WARPS // (c8 // 8)))
    nbytes = 2 * (2 * rows * hs + (c8 * hs if wsm else 0)) \
        + 4 * ks * rows * c8
    return nbytes, ks, (rows <= _LAYER_BF16_ROWS
                        and rows * per <= _LAYER_PAIRS * _LAYER_THREADS)


def _layer_bwd_bytes(hidden: int, n: int, rows: int, wsm: bool,
                     itemsize: int):
    """(bytes, ks, whether the threads take it) of the backward, as
    ``make_geo`` in ``csrc/lstm_layer_bwd.cu`` lays it out: two dG buffers
    (rows x (4H + 4) elements), Wh's rows of the block's units (U4 x (4H +
    4)) when ``wsm``, ``ks`` partial tiles (rows x U4 f32); ``ks`` slices
    of the 4H inputs, as many as the threads left over by the 4 x 4 tiles
    allow, 1 to 32."""
    per = -(-hidden // n)
    u4 = -(-per // 4) * 4
    sc = 4 * hidden + 4
    tiles = -(-rows // 4) * (u4 // 4)
    ks = max(1, min(_LAYER_BWD_KS_MAX, _LAYER_THREADS // tiles))
    nbytes = itemsize * (2 * rows * sc + (u4 * sc if wsm else 0)) \
        + 4 * ks * rows * u4
    return nbytes, ks, (tiles <= _LAYER_THREADS
                        and rows * per <= _LAYER_PAIRS * _LAYER_THREADS)


def _layout(kind: str, dtype: torch.dtype):
    """The layout function of a kernel: ``kind`` "fwd" or "bwd"."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"lstm_layer: dtype must be float32 or bfloat16, "
                        f"got {dtype}")
    if kind == "bwd":
        size = torch.tensor([], dtype=dtype).element_size()
        return lambda h, n, r, wsm: _layer_bwd_bytes(h, n, r, wsm, size)
    return _layer_f32 if dtype == torch.float32 else _layer_bytes_bf16


def _rows_fit(layout, hidden: int, n: int, rows: int) -> bool:
    """Whether a cluster of ``n`` blocks takes ``rows`` batch rows: its
    buffers in 227 KB, its tiles and pairs in the threads."""
    nbytes, _, threads = layout(hidden, n, rows, False)
    return threads and nbytes <= _LAYER_SMEM


def layer_fits(batch: int, hidden: int,
               dtype: torch.dtype = torch.float32) -> bool:
    """Whether the layer kernels of ``dtype`` take ``batch`` rows of
    ``hidden`` units, forward and backward: whether one batch row fits a
    cluster (f32: up to H = 6404).  The shape test ``ops.rnn.lstm`` makes,
    before any launch, to choose between the layer kernels and stepping
    the fused cell."""
    if batch < 1 or hidden < 1:
        return False
    n = min(_LAYER_CLUSTER, hidden)
    return all(_rows_fit(_layout(kind, dtype), hidden, n, 1)
               for kind in ("fwd", "bwd"))


def _geometry(kind: str, batch: int, hidden: int,
              dtype: torch.dtype) -> LayerGeometry:
    """A cluster of ``min(16, H)`` blocks walks the steps for a share of
    the batch rows: ~8 rows a cluster over at most 4 clusters (64 of the
    H100's 132 SMs, all resident at once), fewer rows where the buffers
    would not fit 227 KB of shared memory or the tiles and pairs the
    threads (bf16 forward: at most 16 rows, one m16 tile, and fewer where
    that lets Wh's columns into shared memory); Wh goes into shared memory
    where it fits too."""
    layout = _layout(kind, dtype)
    if batch < 1 or hidden < 1:
        raise ValueError(f"lstm_layer: need B, H >= 1, got {batch}, "
                         f"{hidden}")
    n = min(_LAYER_CLUSTER, hidden)
    if not _rows_fit(layout, hidden, n, 1):
        raise ValueError(f"lstm_layer: H = {hidden} is too wide for the "
                         "kernel's shared memory")
    rows = -(-batch // min(_LAYER_CLUSTERS, -(-batch // _LAYER_ROWS)))
    if kind == "fwd" and dtype == torch.bfloat16:
        rows = min(rows, _LAYER_BF16_ROWS)
    while rows > 1 and not _rows_fit(layout, hidden, n, rows):
        rows -= 1
    if kind == "fwd" and dtype == torch.bfloat16:
        # the tensor-core product reads Wh's columns every step, from L2
        # in 2-byte pieces where they are not in shared memory (H 650 at 8
        # rows: 1.67 ms a PTB window on an H100, against ~0.12 ms at H
        # 200); fewer rows a cluster, in more clusters, make room for them
        # where any do
        fit = rows
        while fit > 1 and layout(hidden, n, fit, True)[0] > _LAYER_SMEM:
            fit -= 1
        if layout(hidden, n, fit, True)[0] <= _LAYER_SMEM:
            rows = fit
    clusters = -(-batch // rows)
    rows = -(-batch // clusters)  # the same clusters, rows evened out
    wsm = layout(hidden, n, rows, True)[0] <= _LAYER_SMEM
    nbytes, ks, _ = layout(hidden, n, rows, wsm)
    return LayerGeometry(n, rows, clusters, ks, wsm, nbytes)


def layer_geometry(batch: int, hidden: int,
                   dtype: torch.dtype = torch.float32) -> LayerGeometry:
    """The forward layer kernel's launch for ``batch`` rows of ``hidden``
    units in ``dtype`` (see :func:`_geometry`).  Raises ``ValueError``
    where one row does not fit."""
    return _geometry("fwd", batch, hidden, dtype)


def layer_bwd_geometry(batch: int, hidden: int,
                       dtype: torch.dtype = torch.float32) -> LayerGeometry:
    """The backward kernel's launch (``csrc/lstm_layer_bwd.cu``) for
    ``batch`` rows of ``hidden`` units in ``dtype``."""
    return _geometry("bwd", batch, hidden, dtype)


def lstm_layer_plain(xw: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                     wh: torch.Tensor, reverse: bool = False,
                     b: torch.Tensor = None):
    """The plain version of the layer kernel, a loop over the steps.  f32:
    ``xw`` (T, B, 4H) holds the bias (``b`` None), ``gates_t = xw_t +
    h_{t-1} @ wh`` and :func:`lstm_pointwise_plain`.  bf16 (the JAX
    package's roundings): ``xw = bf16(x @ wx)`` without the bias, ``b``
    (4H,); ``gates_t = f32(bf16(xw_t + bf16(h_{t-1} @ wh))) + f32(b)``, the
    pointwise stage in f32, h and c rounded to bf16.  ``h0``/``c0`` (B, H),
    ``wh`` (H, 4H) in ``xw``'s dtype -> ``(hs, cs)`` (T, B, H) in that
    dtype and f32 ``gates`` (T, B, 4H)."""
    steps = range(xw.shape[0] - 1, -1, -1) if reverse \
        else range(xw.shape[0])
    hs, cs, gates = [None] * xw.shape[0], [None] * xw.shape[0], \
        [None] * xw.shape[0]
    h, c = h0, c0
    for t in steps:
        if b is None:
            gates[t] = xw[t] + torch.matmul(h, wh)
            h, c = lstm_pointwise_plain(gates[t], c)
        else:
            gates[t] = (xw[t] + torch.matmul(h, wh)).float() + b.float()
            h, c = lstm_pointwise_plain(gates[t], c.float())
            h, c = h.to(xw.dtype), c.to(xw.dtype)
        hs[t], cs[t] = h, c
    return torch.stack(hs), torch.stack(cs), torch.stack(gates)


def lstm_layer(xw: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
               wh: torch.Tensor, reverse: bool = False,
               b: torch.Tensor = None):
    """The layer kernel's wrapper: contiguous ``xw`` (T, B, 4H),
    ``h0``/``c0`` (B, H) and ``wh`` (H, 4H), all float32 (``xw`` holds the
    bias, ``b`` None) or all bfloat16 (``xw`` without the bias, ``b`` (4H,)
    bfloat16) -> ``(hs, cs, gates)``, h and c after every step (T, B, H) in
    that dtype and the f32 gate pre-activations (T, B, 4H), in time order
    also under ``reverse``.  A CUDA tensor launches ``csrc/lstm_layer.cu``
    once (geometry from :func:`layer_geometry`) and counts the launch in
    ``lstm_layer.launches``; a CPU tensor runs :func:`lstm_layer_plain`."""
    if xw.dim() != 3 or xw.shape[2] % 4 or xw.shape[0] < 1:
        raise ValueError(f"lstm_layer: need xw (T >= 1, B, 4H), got "
                         f"{tuple(xw.shape)}")
    t, b_, four_h = xw.shape
    hidden = four_h // 4
    if tuple(h0.shape) != (b_, hidden) or tuple(c0.shape) != (b_, hidden) \
            or tuple(wh.shape) != (hidden, four_h):
        raise ValueError(f"lstm_layer: h0, c0 (B, H) and wh (H, 4H) do not "
                         f"fit xw {tuple(xw.shape)}: {tuple(h0.shape)}, "
                         f"{tuple(c0.shape)}, {tuple(wh.shape)}")
    if not (xw.device == h0.device == c0.device == wh.device):
        raise ValueError("lstm_layer: xw, h0, c0, wh must be on one device")
    if xw.dtype == torch.bfloat16:
        if b is None or tuple(b.shape) != (four_h,) or b.device != xw.device:
            raise ValueError("lstm_layer: a bfloat16 layer needs b (4H,) on "
                             "xw's device (its xw holds no bias)")
        _check_flat("lstm_layer", torch.bfloat16, xw=xw, h0=h0, c0=c0,
                    wh=wh, b=b)
    else:
        if b is not None:
            raise ValueError("lstm_layer: a float32 layer's xw holds the "
                             "bias; b must be None")
        _check_flat("lstm_layer", xw=xw, h0=h0, c0=c0, wh=wh)
    if not _on_cuda("lstm_layer", xw):
        return lstm_layer_plain(xw, h0, c0, wh, reverse, b)
    geo = layer_geometry(b_, hidden, xw.dtype)
    hs = torch.empty((t, b_, hidden), dtype=xw.dtype, device=xw.device)
    cs = torch.empty_like(hs)
    gates = torch.empty((t, b_, four_h), dtype=torch.float32,
                        device=xw.device)
    if b is None:
        _launch("lstm_layer", "lstm_layer", "dt_lstm_layer", xw.device,
                xw.data_ptr(), h0.data_ptr(), c0.data_ptr(), wh.data_ptr(),
                hs.data_ptr(), cs.data_ptr(), gates.data_ptr(), t, b_,
                hidden, geo.n, geo.rows, geo.ks, geo.clusters, int(geo.wsm),
                int(reverse), geo.smem, sig=(xw,))
    else:
        _launch("lstm_layer", "lstm_layer", "dt_lstm_layer_bf16", xw.device,
                xw.data_ptr(), b.data_ptr(), h0.data_ptr(), c0.data_ptr(),
                wh.data_ptr(), hs.data_ptr(), cs.data_ptr(), gates.data_ptr(),
                t, b_, hidden, geo.n, geo.rows, geo.ks, geo.clusters,
                int(geo.wsm), int(reverse), geo.smem, sig=(xw,))
    lstm_layer.launches += 1
    return hs, cs, gates


lstm_layer.launches = 0


def lstm_layer_bwd_plain(gates, cs, c0, wh, dhs, dcs, reverse: bool = False):
    """The plain version of the backward kernel: BPTT through one layer
    window from the saved f32 ``gates`` (T, B, 4H) and ``cs`` (T, B, H),
    ``c0`` (B, H) and ``wh`` (H, 4H).  From the last step processed to the
    first, :func:`lstm_pointwise_backward` at ``(gates_t, c_{t-1}, dhs_t +
    dh, dcs_t + dc)`` gives the step's gate gradient ``dG_t`` and ``dc_{t-1}
    = dc * f``, and ``dh_{t-1} = dG_t @ wh^T``.  In bf16 it makes the
    roundings of autograd through the stepped bf16 cell: ``dhs_t + dh`` and
    ``dcs_t + dc`` are bf16 sums, the cell's backward runs in f32, ``dG_t``
    and ``dc`` round to bf16 (the cotangents of ``.float()``), ``dh`` is a
    bf16 product.  Returns ``(dgates (T, B, 4H), dh0, dc0)`` in ``cs``'s
    dtype."""
    steps = gates.shape[0]
    dtype = cs.dtype
    dgates = torch.empty(gates.shape, dtype=dtype, device=gates.device)
    dh = torch.zeros_like(c0)
    dc = torch.zeros_like(c0)
    whT = wh.t()
    for s in range(steps - 1, -1, -1):
        t = steps - 1 - s if reverse else s
        c_prev = c0 if s == 0 else cs[t + 1 if reverse else t - 1]
        dg, dc = lstm_pointwise_backward(gates[t], c_prev.float(),
                                         dhs[t] + dh, dcs[t] + dc)
        dgates[t] = dg.to(dtype)
        dc = dc.to(dtype)
        dh = torch.matmul(dgates[t], whT)
    return dgates, dh, dc


def lstm_layer_bwd(gates, cs, c0, wh, dhs, dcs, reverse: bool = False):
    """The backward kernel's wrapper: contiguous f32 ``gates`` (T, B, 4H),
    ``cs``, ``dhs``, ``dcs`` (T, B, H), ``c0`` (B, H) and ``wh`` (H, 4H),
    all float32 or all bfloat16 -> ``(dgates, dh0, dc0)`` in that dtype (see
    :func:`lstm_layer_bwd_plain`).  A CUDA tensor launches
    ``csrc/lstm_layer_bwd.cu`` once (geometry from
    :func:`layer_bwd_geometry`) and counts the launch in
    ``lstm_layer_bwd.launches``; a CPU tensor runs
    :func:`lstm_layer_bwd_plain`."""
    if gates.dim() != 3 or gates.shape[2] % 4 or gates.shape[0] < 1:
        raise ValueError(f"lstm_layer_bwd: need gates (T >= 1, B, 4H), got "
                         f"{tuple(gates.shape)}")
    t, b, four_h = gates.shape
    hidden = four_h // 4
    if not all(tuple(a.shape) == (t, b, hidden) for a in (cs, dhs, dcs)) \
            or tuple(c0.shape) != (b, hidden) \
            or tuple(wh.shape) != (hidden, four_h):
        raise ValueError(f"lstm_layer_bwd: cs, dhs, dcs (T, B, H), c0 (B, "
                         f"H) and wh (H, 4H) do not fit gates "
                         f"{tuple(gates.shape)}")
    if not all(a.device == gates.device for a in (cs, c0, wh, dhs, dcs)):
        raise ValueError("lstm_layer_bwd: the tensors must be on one device")
    if cs.dtype not in _DTYPE_CODES:
        raise ValueError(f"lstm_layer_bwd: cs must be float32 or bfloat16, "
                         f"got {cs.dtype}")
    _check_flat("lstm_layer_bwd", gates=gates)
    _check_flat("lstm_layer_bwd", cs.dtype, cs=cs, c0=c0, wh=wh, dhs=dhs,
                dcs=dcs)
    if not _on_cuda("lstm_layer_bwd", gates):
        return lstm_layer_bwd_plain(gates, cs, c0, wh, dhs, dcs, reverse)
    geo = layer_bwd_geometry(b, hidden, cs.dtype)
    if wh.data_ptr() % 16:  # the L2 path reads Wh in 16- or 8-byte loads
        wh = wh.clone()
    dgates = torch.empty((t, b, four_h), dtype=cs.dtype, device=cs.device)
    dh0 = torch.empty((b, hidden), dtype=cs.dtype, device=cs.device)
    dc0 = torch.empty_like(dh0)
    _launch("lstm_layer_bwd", "lstm_layer_bwd", "dt_lstm_layer_bwd",
            gates.device, gates.data_ptr(), cs.data_ptr(), c0.data_ptr(),
            wh.data_ptr(), dhs.data_ptr(), dcs.data_ptr(), dgates.data_ptr(),
            dh0.data_ptr(), dc0.data_ptr(), t, b, hidden, geo.n, geo.rows,
            geo.ks, geo.clusters, int(geo.wsm), _DTYPE_CODES[cs.dtype],
            int(reverse), geo.smem, sig=(gates,))
    lstm_layer_bwd.launches += 1
    return dgates, dh0, dc0


lstm_layer_bwd.launches = 0


def lstm_layer_backward(x, h0, c0, wx, wh, hs, cs, gates, dhs, dcs,
                        reverse: bool):
    """The layer's backward from the saved ``hs``, ``cs`` and ``gates``:
    the BPTT recurrence is :func:`lstm_layer_bwd` (one launch on the card),
    then one matmul each gives ``dWh``, ``dWx`` and ``dx``, and a sum
    ``db``.  ``dhs`` and ``dcs`` (T, B, H) are the gradients reaching h_t
    and c_t from outside.  Returns ``(dx, dh0, dc0, dwx, dwh, db)``."""
    dgates, dh, dc = lstm_layer_bwd(gates, cs, c0, wh, dhs.contiguous(),
                                    dcs.contiguous(), reverse)
    h_prev = torch.cat([hs[1:], h0[None]]) if reverse \
        else torch.cat([h0[None], hs[:-1]])
    dg2 = dgates.reshape(-1, dgates.shape[-1])
    dwh = torch.matmul(h_prev.reshape(-1, h0.shape[-1]).t(), dg2)
    dwx = torch.matmul(x.reshape(-1, x.shape[-1]).t(), dg2)
    dx = torch.matmul(dg2, wx.t()).reshape(x.shape)
    return dx, dh, dc, dwx, dwh, dg2.float().sum(0).to(dg2.dtype)


class _LSTMLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h0, c0, wx, wh, b, reverse):
        t, bsz, inp = x.shape
        xw = torch.matmul(x.reshape(t * bsz, inp), wx)
        if x.dtype == torch.bfloat16:  # b joins each step's f32 gates
            hs, cs, gates = lstm_layer(xw.reshape(t, bsz, -1),
                                       h0.contiguous(), c0.contiguous(),
                                       wh.contiguous(), reverse,
                                       b=b.contiguous())
        else:
            hs, cs, gates = lstm_layer((xw + b).reshape(t, bsz, -1),
                                       h0.contiguous(), c0.contiguous(),
                                       wh.contiguous(), reverse)
        ctx.save_for_backward(x, h0, c0, wx, wh, hs, cs, gates)
        ctx.reverse = reverse
        return hs, cs

    @staticmethod
    def backward(ctx, dhs, dcs):
        return (*lstm_layer_backward(*ctx.saved_tensors, dhs, dcs,
                                     ctx.reverse), None)


def lstm_layer_fused(x: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                     w, reverse: bool = False):
    """One layer of the fused LSTM over a window (the JAX package's
    ``lax.scan`` of ``lstm_cell_fused``, ``dt_tpu/ops/rnn.py:84-114``),
    differentiable: ``x`` (T, B, I), ``h0``/``c0`` (B, H) and ``w`` (``wx``
    (I, 4H), ``wh`` (H, 4H), ``b`` (4H,)), all float32 or all bfloat16
    (``h0``/``c0`` are cast to ``x``'s dtype) -> ``(hs, cs)`` (T, B, H), h
    and c after every step in time order.  The input product ``x @ wx``
    (plus ``b`` in f32; in bf16 ``b`` joins the f32 gates in the kernel) is
    one ``torch.matmul``; the steps are :func:`lstm_layer`.  The backward is
    :func:`lstm_layer_backward`: :func:`lstm_layer_bwd`, then the weight
    gradients' matmuls."""
    return _LSTMLayer.apply(x, h0.to(x.dtype), c0.to(x.dtype), w.wx, w.wh,
                            w.b, bool(reverse))


# ---------------------------------------------------------------------------
# Greedy NMS scan
# ---------------------------------------------------------------------------

_NMS_BLOCK = 64  # boxes a mask word
_NMS_WINDOW = 32  # mask words a row of the scratch (csrc/nms.cu's kWin)
_INT32_MAX = 2 ** 31 - 1  # the reorder's key past an image's count


def _nms_check(boxes, labels, counts) -> None:
    if boxes.dim() != 3 or boxes.shape[2] != 4 or not boxes.is_contiguous():
        raise ValueError(f"nms_keep: boxes must be contiguous (B, N, 4), got "
                         f"{tuple(boxes.shape)}")
    b, n = boxes.shape[:2]
    if counts.dtype != torch.int32 or tuple(counts.shape) != (b,) \
            or counts.device != boxes.device:
        raise ValueError(f"nms_keep: counts must be int32 ({b},) on "
                         f"{boxes.device}")
    if labels is not None and (
            labels.dtype != torch.int32 or tuple(labels.shape) != (b, n)
            or labels.device != boxes.device or not labels.is_contiguous()):
        raise ValueError(f"nms_keep: labels must be contiguous int32 "
                         f"({b}, {n}) on {boxes.device}")


def _nms_over_rows(boxes: torch.Tensor, labels, lo: int, hi: int,
                  iou_threshold: float) -> torch.Tensor:
    """Rows ``lo:hi`` of one image's "over" matrix: ``over[i, j]`` is True
    where box ``j > i`` overlaps box ``i`` above the threshold (same label
    only, with ``labels``), computed as the JAX function's ``box_iou``."""
    from dt_tpu_torch.ops.detection import box_iou
    iou = box_iou(boxes[lo:hi], boxes)
    if labels is not None:
        iou = torch.where(labels[lo:hi, None] == labels[None, :], iou,
                          torch.zeros_like(iou))
    j = torch.arange(boxes.shape[0], device=boxes.device)
    return (iou > iou_threshold) & (j[None, :] > torch.arange(
        lo, hi, device=boxes.device)[:, None])


def _greedy_scan(boxes: torch.Tensor, labels, iou_threshold: float,
                 chunk: int) -> list:
    """The greedy walk over ``boxes`` (in order): their "over" matrix
    (:func:`_nms_over_rows`, ``chunk`` rows at a time) packed to bits on the
    host, each kept box ORing its row into the removed bits (Python
    integers).  Returns the kept positions."""
    k = boxes.shape[0]
    rows = []
    for lo in range(0, k, chunk):
        over = _nms_over_rows(boxes, labels, lo, min(k, lo + chunk),
                             iou_threshold)
        rows.append(np.packbits(over.cpu().numpy(), axis=1,
                                bitorder="little"))
    removed = 0
    kept = []
    for i in range(k):
        if (removed >> i) & 1:
            continue
        kept.append(i)
        removed |= int.from_bytes(rows[i // chunk][i % chunk].tobytes(),
                                  "little")
    return kept


def nms_keep_plain(boxes: torch.Tensor, labels, counts: torch.Tensor,
                   iou_threshold: float, chunk: int = 1024) -> torch.Tensor:
    """The plain version of the scan kernel: :func:`_greedy_scan` of each
    image's first ``count`` boxes.  With labels and a threshold >= 0, boxes
    of two labels never suppress each other (their IoU counts as 0), so
    each label's boxes are scanned alone, in their order: the same keep
    mask from a fraction of the pairs.  Any device, any float dtype."""
    b, n = boxes.shape[:2]
    keep = torch.zeros((b, n), dtype=torch.bool)
    for img, k in enumerate(counts.tolist()):
        if labels is not None and iou_threshold >= 0:
            lab = labels[img, :k]
            groups = [torch.nonzero(lab == v).flatten()
                      for v in torch.unique(lab)]
            group_labels = None
        else:
            groups = [torch.arange(k, device=boxes.device)]
            group_labels = None if labels is None else labels[img, :k]
        for pos in groups:
            kept = _greedy_scan(boxes[img, pos], group_labels,
                                iou_threshold, chunk)
            keep[img, pos.cpu()[kept]] = True
    return keep.to(boxes.device)


def nms_label_runs(boxes: torch.Tensor, labels: torch.Tensor,
                   counts: torch.Tensor):
    """Each image's first ``count`` boxes reordered stably by label, the
    scan kernel's labelled input: ``(perm, boxes, labels)``, ``perm`` int64
    (B, N) the caller's position of each new one, ``boxes`` (B, N, 4) in
    the new order and ``labels`` int32 (B, N), ascending along the prefix
    (each label's boxes one run, in their score order) and ``INT32_MAX``
    past it.  The prefix stays a prefix: its sort key is the label, every
    later box's ``INT32_MAX``, and among equal keys the stable sort keeps
    positions in order.  Plain PyTorch on either device, with no host
    sync (a count outside [0, N] is held to it, as the kernel does)."""
    b, n = labels.shape
    pos = torch.arange(n, device=labels.device)
    key = torch.where(pos[None, :] < counts[:, None].long(), labels,
                      _INT32_MAX)
    sorted_labels, perm = torch.sort(key, dim=1, stable=True)
    sorted_boxes = torch.gather(boxes, 1, perm[..., None].expand(b, n, 4))
    return perm, sorted_boxes.contiguous(), sorted_labels.contiguous()


def nms_keep(boxes: torch.Tensor, labels, counts: torch.Tensor,
             iou_threshold: float) -> torch.Tensor:
    """The scan kernel's wrapper: ``boxes`` (B, N, 4), each image's boxes
    sorted best score first; ``labels`` int32 (B, N) in that order or None
    (every box suppresses every other); ``counts`` int32 (B,), the boxes an
    image scans, a prefix of its order -> ``keep`` bool (B, N).  A CUDA
    tensor (f32) launches ``csrc/nms.cu`` (its mask and scan kernels) once
    a call and counts the call in ``nms_keep.launches``; with labels and a
    threshold >= 0 the prefix is first reordered by label
    (:func:`nms_label_runs`, PyTorch ops) so that each label is one run of
    its own.  The mask scratch holds 32 words (2,048 boxes) a row past its
    own word; a longer run's scan computes the IoUs past them itself.  A
    CPU tensor runs :func:`nms_keep_plain`.  Nothing waits for the host on
    the card."""
    _nms_check(boxes, labels, counts)
    if not _on_cuda("nms_keep", boxes):
        return nms_keep_plain(boxes, labels, counts, iou_threshold)
    if boxes.dtype != torch.float32:
        raise TypeError(f"nms_keep: boxes on the card must be float32, got "
                        f"{boxes.dtype}")
    b, n = boxes.shape[:2]
    perm = None
    if labels is not None and iou_threshold >= 0:
        perm, boxes, labels = nms_label_runs(boxes, labels, counts)
    win = min(-(-n // _NMS_BLOCK), _NMS_WINDOW)
    mask = torch.empty((b, win, n), dtype=torch.int64, device=boxes.device)
    keep = torch.empty((b, n), dtype=torch.bool, device=boxes.device)
    _launch("nms_keep", "nms", "dt_nms", boxes.device, boxes.data_ptr(),
            0 if labels is None else labels.data_ptr(), counts.data_ptr(),
            0 if perm is None else perm.data_ptr(), mask.data_ptr(),
            keep.data_ptr(), b, n, ctypes.c_float(iou_threshold),
            sig=(boxes,))
    nms_keep.launches += 1
    return keep


nms_keep.launches = 0


# ---------------------------------------------------------------------------
# int8 convolution (implicit GEMM) with the float epilogue
# ---------------------------------------------------------------------------

#: the deepest contraction whose int32 sum cannot overflow: 127^2 K < 2^31
QCONV_MAX_K = (2 ** 31 - 1) // (127 * 127)


def qconv_out_hw(hw, kernel, stride, pads):
    """``(OH, OW)`` of a convolution over ``hw`` with explicit ``pads``
    ``((top, bottom), (left, right))``."""
    return tuple((s + lo + hi - k) // st + 1
                 for s, k, st, (lo, hi) in zip(hw, kernel, stride, pads))


def _qconv_check(xq, wq, stride, pads, divisor, bias, dtype):
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"qconv: xq and wq must be int8, got {xq.dtype} and "
                        f"{wq.dtype}")
    if xq.dim() != 4 or wq.dim() != 4 or xq.shape[3] != wq.shape[2]:
        raise ValueError(f"qconv: need NHWC xq and HWIO wq with one C, got "
                         f"{tuple(xq.shape)} and {tuple(wq.shape)}")
    if min(stride) < 1 or min(p for pair in pads for p in pair) < 0:
        raise ValueError(f"qconv: strides must be >= 1 and pads >= 0, got "
                         f"{stride} and {pads}")
    k = wq.shape[0] * wq.shape[1] * wq.shape[2]
    if k > QCONV_MAX_K:
        raise ValueError(f"qconv: a contraction of {k} > {QCONV_MAX_K} "
                         "terms can overflow the int32 accumulator (127^2 K "
                         "must stay below 2^31)")
    if divisor.dim() != 0 or divisor.dtype != torch.float32:
        raise TypeError("qconv: divisor must be a 0-d float32 tensor")
    if bias is not None and (bias.dtype != torch.float32 or bias.dim() != 1
                             or bias.shape[0] != wq.shape[3]):
        raise ValueError(f"qconv: bias must be float32 ({wq.shape[3]},), "
                         f"got {bias.dtype} {tuple(bias.shape)}")
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"qconv: dtype must be float32 or bfloat16, got "
                        f"{dtype}")
    devices = {t.device for t in (xq, wq, divisor, bias) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"qconv: every tensor must be on one device, got "
                         f"{sorted(map(str, devices))}")


def qconv_acc_plain(xq: torch.Tensor, wq: torch.Tensor, stride, pads
                    ) -> torch.Tensor:
    """The int32 accumulator of the int8 convolution of NHWC ``xq`` with
    HWIO ``wq``, as float64 im2col + matmul cast back: every product is at
    most 128^2 and every sum below 2^31 < 2^53, so it is exact on either
    device (no FFT or Winograd algorithm can enter)."""
    kh, kw, c, n = wq.shape
    (pt, pb), (pl, pr) = pads
    x = F.pad(xq.permute(0, 3, 1, 2).to(torch.float64), (pl, pr, pt, pb))
    oh, ow = qconv_out_hw(xq.shape[1:3], (kh, kw), stride, pads)
    b = xq.shape[0]
    if min(b, oh, ow, n) <= 0:
        return torch.zeros((b, max(oh, 0), max(ow, 0), n), dtype=torch.int32,
                           device=xq.device)
    cols = F.unfold(x, (kh, kw), stride=tuple(stride))  # (B, C kh kw, L)
    w = wq.permute(3, 2, 0, 1).reshape(n, c * kh * kw).to(torch.float64)
    acc = torch.matmul(w, cols)  # (B, N, L)
    return acc.reshape(b, n, oh, ow).permute(0, 2, 3, 1).to(torch.int32)


def qconv_epilogue(acc: torch.Tensor, divisor: torch.Tensor, bias,
                   dtype: torch.dtype) -> torch.Tensor:
    """``(acc.to(f32) / divisor + bias).to(dtype)``, op by op as the JAX
    package orders it; ``divisor`` is a tensor on ``acc``'s device (a CPU
    scalar would turn the card's division into a multiply by its
    reciprocal)."""
    out = acc.to(torch.float32) / divisor
    if bias is not None:
        out = out + bias
    return out.to(dtype)


def qconv_plain(xq: torch.Tensor, wq: torch.Tensor, stride, pads,
                divisor: torch.Tensor, bias=None,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain version of the int8 convolution kernel: the exact int32
    accumulator (:func:`qconv_acc_plain`), then :func:`qconv_epilogue`."""
    _qconv_check(xq, wq, stride, pads, divisor, bias, dtype)
    return qconv_epilogue(qconv_acc_plain(xq, wq, stride, pads), divisor,
                          bias, dtype)


#: the kernel's tile: output pixels a block and bytes of K a stage
QCONV_BM, QCONV_BK = 128, 128
#: the H100's streaming multiprocessors
QCONV_SMS = 132
#: how a launch loads A, in the kernel's numbering: "tma" (1x1, stride 1,
#: no padding: x as an (M, Cp) matrix), "gather" (16-byte ``cp.async`` of
#: each tap's channels, Cp a multiple of 16) or "narrow" (C <= 4 and KW <=
#: 8, the stem: Cp 4, the filter's rows padded to 8 taps, 4-byte
#: ``cp.async`` of each tap's pixel)
QCONV_ROUTES = ("tma", "gather", "narrow")


class QconvPlan(NamedTuple):
    """How :func:`qconv` launches ``csrc/qconv.cu`` for one shape."""
    cp: int          # channels as the kernel reads them: C rounded up to
    #                  16, or 4 on the narrow route
    kwp: int         # filter width as the packed weight holds it (KW, or 8
    #                  on the narrow route)
    bn: int          # output channels a block (64 or 128)
    smem: int        # dynamic shared memory a block, bytes
    grid: int        # blocks: m tiles x n tiles
    route: str       # one of QCONV_ROUTES
    vec_out: bool    # the epilogue's 16-byte stores (N * esize % 16 == 0)


def qconv_smem(bn: int) -> int:
    """A block's dynamic shared memory at tile width ``bn``, as
    ``Cfg<BN>::SMEM`` in ``csrc/qconv.cu`` (the kernel refuses another
    value): 1 KB of alignment slack, the ring of A and B stages, each row's
    pixel (16 bytes) and two mbarriers a stage."""
    stages = 3 if bn == 128 else 4
    return 1024 + stages * (QCONV_BM + bn) * QCONV_BK + QCONV_BM * 16 \
        + 2 * stages * 8


def qconv_plan(x_shape, w_shape, stride, pads, dtype) -> QconvPlan:
    """The tile and route of one launch: BN 128 where N > 64 and the grid
    still fills the card's SMs, else 64; the tma route for 1x1, stride-1,
    unpadded layers (M < 2^31, TMA's coordinates), the narrow route for
    C <= 4 and KW <= 8 (the stem), the gather route otherwise; 16-byte
    output stores where a row of the output is a whole number of 16-byte
    chunks."""
    b, h, w, c = x_shape
    kh, kw, _, n = w_shape
    oh, ow = qconv_out_hw((h, w), (kh, kw), stride, pads)
    m = b * oh * ow
    m_tiles = -(-m // QCONV_BM)
    bn = 128 if n > 64 and m_tiles * -(-n // 128) >= QCONV_SMS else 64
    if (kh, kw) == (1, 1) and tuple(stride) == (1, 1) \
            and all(p == 0 for pair in pads for p in pair) and m < 2 ** 31:
        route = "tma"
    else:
        route = "narrow" if c <= 4 and kw <= 8 else "gather"
    cp, kwp = (4, 8) if route == "narrow" else (-(-c // 16) * 16, kw)
    return QconvPlan(cp=cp, kwp=kwp, bn=bn, smem=qconv_smem(bn),
                     grid=m_tiles * -(-n // bn), route=route,
                     vec_out=n * dtype.itemsize % 16 == 0)


def qconv_pad_channels(xq: torch.Tensor, cp: int) -> torch.Tensor:
    """``xq`` as the kernel reads it: contiguous, 16-byte aligned, its
    channels padded with int8 zeros to ``cp`` (exact: the quantization has
    no zero point, so a zero channel adds nothing to any sum; the pass is
    part of the call).  ``xq`` itself where it is that already."""
    if xq.shape[3] == cp and xq.is_contiguous() and xq.data_ptr() % 16 == 0:
        return xq
    if xq.shape[3] == cp:
        return xq.clone(memory_format=torch.contiguous_format)
    return F.pad(xq, (0, cp - xq.shape[3])).contiguous()


def qconv_pack_plain(wq: torch.Tensor, cp: int, kwp: int) -> torch.Tensor:
    """The plain version of ``dt_qconv_pack``: HWIO ``wq`` as ``(N, KH *
    kwp * cp)`` int8 rows, K contiguous in the kernel's order ``(ky * kwp +
    kx) * cp + c``, the taps past KW and the channels past C zero."""
    kh, kw, c, n = wq.shape
    w = F.pad(wq, (0, 0, 0, cp - c, 0, kwp - kw))
    return w.permute(3, 0, 1, 2).reshape(n, kh * kwp * cp).contiguous()


#: packed weights: key -> (weak reference to the weight's owner, its
#: version counter when packed, the packed copy)
_QCONV_PACKS: dict = {}


def _pack_key(wq: torch.Tensor, cp: int, kwp: int):
    """The cache key of ``wq``'s packed copy and the owner and version it is
    held against, or ``(None, None, None)`` for a weight whose writes
    cannot be seen (an inference tensor keeps no version counter).  The key
    is the storage and the view into it, so the fresh ``reshape`` views a
    caller makes on every call find one entry; the owner (the view's base,
    whose version counter every view shares) is held weakly, so a weight
    freed and another allocated at its address cannot hit its entry."""
    if wq.is_inference():
        return None, None, None
    owner = wq._base if wq._base is not None else wq
    key = (wq.device, wq.untyped_storage().data_ptr(), wq.storage_offset(),
           tuple(wq.shape), tuple(wq.stride()), cp, kwp)
    return key, owner, wq._version


def _drop_pack(key, _ref) -> None:
    _QCONV_PACKS.pop(key, None)


def qconv_pack(wq: torch.Tensor, cp: int, kwp: int) -> torch.Tensor:
    """The packed weight ``csrc/qconv.cu`` reads (:func:`qconv_pack_plain`
    for a CPU tensor).  On the card it is made once by ``dt_qconv_pack``
    (counted in ``qconv_pack.launches``) and served from a cache while the
    weight's owner lives and its version counter has not moved: an
    in-place write to the weight, or any view of it, packs it anew (a
    write through ``.data`` or another alias with its own version counter
    is not seen).  Not cached while a CUDA graph is captured (its copy
    would be the graph's) or for an inference tensor."""
    if not _on_cuda("qconv_pack", wq):
        return qconv_pack_plain(wq, cp, kwp)
    key, owner, version = _pack_key(wq, cp, kwp)
    hit = _QCONV_PACKS.get(key) if key is not None else None
    if hit is not None and hit[0]() is owner and hit[1] == version:
        return hit[2]
    kh, kw, c, n = wq.shape
    w = wq.contiguous()
    packed = torch.empty((n, kh * kwp * cp), dtype=torch.int8,
                         device=wq.device)
    _launch("qconv_pack", "qconv", "dt_qconv_pack", wq.device, w.data_ptr(),
            packed.data_ptr(), kh, kw, kwp, c, cp, n, sig=(w,))
    qconv_pack.launches += 1
    if key is not None and not torch.cuda.is_current_stream_capturing():
        _QCONV_PACKS[key] = (weakref.ref(owner,
                                         functools.partial(_drop_pack, key)),
                             version, packed)
    return packed


qconv_pack.launches = 0


def qconv(xq: torch.Tensor, wq: torch.Tensor, stride, pads,
          divisor: torch.Tensor, bias=None,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The int8 convolution kernel's wrapper: contiguous int8 NHWC ``xq``
    and HWIO ``wq``, ``stride`` ``(sh, sw)``, explicit ``pads`` ``((top,
    bottom), (left, right))``, a 0-d float32 ``divisor`` (``x_scale *
    w_scale``) and an optional float32 ``bias`` ``(N,)`` on one device ->
    ``(acc / divisor + bias)`` as ``dtype`` (float32 or bfloat16), NHWC.  A
    CUDA tensor launches ``csrc/qconv.cu`` once, as :func:`qconv_plan`
    says, on ``xq`` with its channels padded to the plan's Cp where C is
    not that (:func:`qconv_pad_channels`) and on the cached packed weight
    (:func:`qconv_pack`), and counts the launch in ``qconv.launches`` and
    its route's in ``qconv.routes``; a CPU tensor runs
    :func:`qconv_plain`."""
    _qconv_check(xq, wq, stride, pads, divisor, bias, dtype)
    if not _on_cuda("qconv", xq):
        return qconv_plain(xq, wq, stride, pads, divisor, bias, dtype)
    kh, kw, c, n = wq.shape
    b, h, w = xq.shape[:3]
    oh, ow = qconv_out_hw((h, w), (kh, kw), stride, pads)
    out = torch.empty((b, max(oh, 0), max(ow, 0), n), dtype=dtype,
                      device=xq.device)
    if out.numel() == 0:
        return out
    plan = qconv_plan(tuple(xq.shape), tuple(wq.shape), stride, pads, dtype)
    xk = qconv_pad_channels(xq, plan.cp)
    wp = qconv_pack(wq, plan.cp, plan.kwp)
    _launch("qconv", "qconv", "dt_qconv", xq.device, xk.data_ptr(),
            wp.data_ptr(), 0 if bias is None else bias.data_ptr(),
            divisor.data_ptr(), out.data_ptr(), b, h, w, plan.cp, kh, kw, n,
            oh, ow, stride[0], stride[1], pads[0][0], pads[1][0],
            _DTYPE_CODES[dtype], plan.bn, QCONV_ROUTES.index(plan.route),
            int(plan.vec_out), plan.smem, sig=(xq, wq))
    qconv.launches += 1
    qconv.routes[plan.route] += 1
    return out


qconv.launches = 0
qconv.routes = dict.fromkeys(QCONV_ROUTES, 0)
