"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

Each wrapper launches its kernel for a CUDA tensor and uses the plain version
only for a CPU tensor; there is no fallback from one to the other.  Each
wrapper counts its launches in its ``launches`` attribute.  All of them are
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
  picks.  Deterministic: no float atomics.
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
  thread-block-cluster launch.  Bound by operations (67 TFLOP/s f32) and,
  in practice, by its serial chain of steps; :func:`lstm_layer_fused` is
  its differentiable form, with an explicit BPTT backward in PyTorch.

``flash_attn`` (``csrc/flash_attn.cu``, the flash-attention forward) is
bound by operations; its wrapper lives in ``ops.attention`` and its
signature here.
"""

from __future__ import annotations

import ctypes
import time
from typing import NamedTuple

import torch

from dt_tpu_torch.obs import device as obs_device
from dt_tpu_torch.ops import _build
from dt_tpu_torch.parallel.codec_np import CODES_PER_WORD

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_V, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# library -> C function -> argument types (every function returns a
# cudaError_t as int)
_SIGNATURES = {
    "bn_act": {"dt_bn_act": [_V, _V, _V, _V, _I64, _I64, _INT, _INT, _V]},
    # x, scratch, tickets, mean, var; rows, C; dtype, vec, bx, by, slices,
    # row blocks; stream
    "bn_train": {"dt_bn_stats": [_V] * 5 + [_I64] * 2 + [_INT] * 6 + [_V]},
    "quant2": {
        "dt_quantize_2bit": [_V, _V, _V, _V, _I64, ctypes.c_float, _V],
        "dt_dequantize_2bit": [_V, _V, _I64, ctypes.c_float, _V]},
    "lstm_point": {"dt_lstm_point": [_V, _V, _V, _V, _I64, _I64, _INT, _V]},
    # xw, h0, c0, wh, hs, cs, gates; T, B, H, n, rows, ks, clusters, wsm,
    # reverse; shared-memory bytes; stream
    "lstm_layer": {"dt_lstm_layer": [_V] * 7 + [_INT] * 9 + [_I64, _V]},
    # q, k, v, out, lse; batch, heads, sq, sk, d; (b, s, h) strides of q, k
    # and v; scale, causal, dtype; stream
    "flash_attn": {"dt_flash_attn_fwd": [_V] * 5 + [_I64] * 14
                   + [ctypes.c_float, _INT, _INT, _V]},
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
    """The plain version of pass 1 on the ``(rows, C)`` view: f32 ``mean =
    sum(x) / n`` and ``var = max(sum(x*x) / n - mean^2, 0)`` (NaN kept), the
    TPU kernel's formula (``kernels.py:135-140``)."""
    x32 = x2.float()
    n = x2.shape[0]
    mean = x32.sum(0) / n
    var = (x32 * x32).sum(0) / n - mean * mean
    return mean, torch.where(var < 0, torch.zeros_like(var), var)


def bn_stats(x: torch.Tensor):
    """Pass 1's wrapper: per-channel f32 batch ``(mean, var)`` of ``x``
    (channels_last NCHW or contiguous ``(rows, C)``, float32 or bfloat16).
    A CUDA tensor launches ``csrc/bn_train.cu`` once and counts the launch
    in ``bn_stats.launches``; a CPU tensor runs :func:`bn_stats_plain`.

    The kernel's tickets are shared by every launch on a device, so a call
    on another stream than the last call's waits for that stream first.
    Graph-safe once a call has run outside capture on the device; inside a
    capture the caller orders the streams."""
    x2 = rows_view(x, "fused_bn_train")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError("fused_bn_train: dtype must be float32 or bfloat16, "
                        f"got {x.dtype}")
    rows, c = x2.shape
    if rows == 0 or c == 0:
        raise ValueError("fused_bn_train: batch statistics of an empty "
                         f"input {tuple(x.shape)}")
    if not _on_cuda("fused_bn_train", x):
        return bn_stats_plain(x2)
    geo = stats_geometry(rows, c, x.element_size(), x2.data_ptr() % 16 == 0)
    if geo.slices > _MAX_TICKETS:
        raise ValueError(f"fused_bn_train: a ({rows}, {c}) input needs "
                         f"{geo.slices} tickets, more than the "
                         f"{_MAX_TICKETS} kept")
    scratch = torch.empty(geo.partial_bytes(c) // 4, dtype=torch.float32,
                          device=x.device)
    mean = torch.empty(c, dtype=torch.float32, device=x.device)
    var = torch.empty(c, dtype=torch.float32, device=x.device)
    _launch("fused_bn_train", "bn_train", "dt_bn_stats", x.device,
            x2.data_ptr(), scratch.data_ptr(),
            _stats_tickets(x.device).data_ptr(), mean.data_ptr(),
            var.data_ptr(), rows, c, _DTYPE_CODES[x.dtype], *geo, sig=(x2,))
    bn_stats.launches += 1
    return mean, var


bn_stats.launches = 0


def bn_train_backward(x, y, gy, gamma, mean, var, eps: float, relu: bool):
    """The backward of training BN (``_bn_train_bwd``, ``kernels.py:201-219``)
    in f32, with the ReLU's mask (``y > 0``) applied to ``gy`` first when the
    ReLU was fused in.  Returns ``(dx in x's dtype and layout, dgamma,
    dbeta)``."""
    if gy.dim() == 4:
        gy = gy.contiguous(memory_format=torch.channels_last)
    else:
        gy = gy.contiguous()
    x2 = rows_view(x, "fused_bn_train")
    gy32 = rows_view(gy, "fused_bn_train").float()
    if relu:
        gy32 = torch.where(rows_view(y, "fused_bn_train") > 0, gy32,
                           torch.zeros_like(gy32))
    n = x2.shape[0]
    inv = torch.rsqrt(var + eps)
    x_hat = (x2.float() - mean) * inv
    dbeta = gy32.sum(0)
    dgamma = (gy32 * x_hat).sum(0)
    dx = (gamma.float() * inv / n) * (n * gy32 - dbeta - x_hat * dgamma)
    return _like_input(dx.to(x.dtype), x), dgamma, dbeta


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


def fused_bn_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   running_mean: torch.Tensor, running_var: torch.Tensor, *,
                   momentum: float = 0.9, eps: float = 1e-5,
                   relu: bool = False):
    """Training BatchNorm (+ReLU) over the channel axis: the batch's mean and
    variance (:func:`bn_stats`), then ``y = x * scale + bias`` (+ReLU) with
    ``scale``/``bias`` made from them in f32 and cast to ``x``'s dtype
    (:func:`bn_act`), as the TPU wrapper does (``kernels.py:107-165``).

    ``x`` as for :func:`fused_bn_inference`; ``gamma``/``beta`` f32 ``(C,)``,
    differentiable (backward: :func:`bn_train_backward`).  The running stats
    are updated in place, under no_grad, to ``momentum * old + (1 -
    momentum) * batch`` in f32.  Returns ``(y, running_mean, running_var)``.
    """
    c = x.shape[1] if x.dim() == 4 else x.shape[-1]
    for name, t in (("gamma", gamma), ("beta", beta),
                    ("running_mean", running_mean),
                    ("running_var", running_var)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"fused_bn_train: {name} must have shape "
                             f"({c},), got {tuple(t.shape)}")
    y, mean, var = _FusedBNTrain.apply(x, gamma, beta, eps, relu)
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


def _check_flat(what: str, **tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous float32, "
                             f"got {t.dtype} with strides {tuple(t.stride())}")


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
# LSTM layer: the whole window in one launch
# ---------------------------------------------------------------------------

_LAYER_THREADS = 512  # csrc/lstm_layer.cu NT
_LAYER_PAIRS = 4  # (row, unit) pairs a thread at most (PMAX)
_LAYER_KS_MAX = 8  # slices of the inputs at most (KS_MAX)
_LAYER_SMEM = 232448  # shared memory a block can use on the H100 (227 KB)
_LAYER_CLUSTER = 16  # blocks a cluster (a non-portable size above 8)
_LAYER_ROWS = 8  # batch rows a cluster the geometry aims at ...
_LAYER_CLUSTERS = 4  # ... over at most this many clusters (64 SMs)


class LayerGeometry(NamedTuple):
    """The launch of one layer window: ``clusters`` clusters of ``n``
    blocks, each cluster ``rows`` batch rows; ``ks`` slices of the H inputs
    a gate product; ``wsm``: Wh's columns in shared memory (else read from
    L2 every step); ``smem`` bytes of shared memory a block."""
    n: int
    rows: int
    clusters: int
    ks: int
    wsm: bool
    smem: int


def _layer_floats(hidden: int, n: int, rows: int, ks: int, wsm: bool):
    """(shared-memory floats a block, tiles of the gate product, pairs a
    block at most), as ``make_geo`` in ``csrc/lstm_layer.cu`` lays them
    out: two h buffers (rows x (H4 + 4)), Wh's columns (H4 x C4) when
    ``wsm``, ``ks`` partial tiles (rows x C4) and c (rows x units)."""
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


def _layer_rows_fit(hidden: int, n: int, rows: int) -> bool:
    """Whether a cluster of ``n`` blocks takes ``rows`` batch rows: the h
    buffers, partial tiles and c in 227 KB, the tiles and pairs in the
    threads."""
    floats, tiles, pairs = _layer_floats(hidden, n, rows,
                                         _layer_ks(hidden, n, rows), False)
    return (floats * 4 <= _LAYER_SMEM and tiles <= _LAYER_THREADS
            and pairs <= _LAYER_PAIRS * _LAYER_THREADS)


def layer_fits(batch: int, hidden: int) -> bool:
    """Whether the layer kernel takes ``batch`` rows of ``hidden`` units,
    that is whether one batch row fits a cluster (it does up to H = 6404):
    the shape test ``ops.rnn.lstm`` makes, before any launch, to choose
    between the layer kernel and stepping the fused cell."""
    return batch >= 1 and hidden >= 1 and _layer_rows_fit(
        hidden, min(_LAYER_CLUSTER, hidden), 1)


def layer_geometry(batch: int, hidden: int) -> LayerGeometry:
    """The layer kernel's launch for ``batch`` rows of ``hidden`` units.
    A cluster of ``min(16, H)`` blocks walks the steps for a share of the
    batch rows: ~8 rows a cluster over at most 4 clusters (64 of the H100's
    132 SMs, all resident at once), fewer rows where the h buffers, the
    partial tiles and c would not fit 227 KB of shared memory or the tiles
    and pairs the threads; Wh's columns go into shared memory where they
    fit too.  Raises ``ValueError`` where one row does not fit (where
    :func:`layer_fits` is False)."""
    if batch < 1 or hidden < 1:
        raise ValueError(f"lstm_layer: need B, H >= 1, got {batch}, "
                         f"{hidden}")
    if not layer_fits(batch, hidden):
        raise ValueError(f"lstm_layer: H = {hidden} is too wide for the "
                         "kernel's shared memory")
    n = min(_LAYER_CLUSTER, hidden)
    rows = -(-batch // min(_LAYER_CLUSTERS, -(-batch // _LAYER_ROWS)))
    while rows > 1 and not _layer_rows_fit(hidden, n, rows):
        rows -= 1
    clusters = -(-batch // rows)
    rows = -(-batch // clusters)  # the same clusters, rows evened out
    ks = _layer_ks(hidden, n, rows)
    wsm = _layer_floats(hidden, n, rows, ks, True)[0] * 4 <= _LAYER_SMEM
    return LayerGeometry(n, rows, clusters, ks, wsm,
                         _layer_floats(hidden, n, rows, ks, wsm)[0] * 4)


def lstm_layer_plain(xw: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                     wh: torch.Tensor, reverse: bool = False):
    """The plain version of the layer kernel, a loop over the steps:
    ``gates_t = xw_t + h_{t-1} @ wh`` and :func:`lstm_pointwise_plain`.
    ``xw`` (T, B, 4H), ``h0``/``c0`` (B, H), ``wh`` (H, 4H), all f32 ->
    ``(hs, cs)`` (T, B, H) and ``gates`` (T, B, 4H)."""
    steps = range(xw.shape[0] - 1, -1, -1) if reverse \
        else range(xw.shape[0])
    hs, cs, gates = [None] * xw.shape[0], [None] * xw.shape[0], \
        [None] * xw.shape[0]
    h, c = h0, c0
    for t in steps:
        gates[t] = xw[t] + torch.matmul(h, wh)
        h, c = lstm_pointwise_plain(gates[t], c)
        hs[t], cs[t] = h, c
    return torch.stack(hs), torch.stack(cs), torch.stack(gates)


def lstm_layer(xw: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
               wh: torch.Tensor, reverse: bool = False):
    """The layer kernel's wrapper: contiguous f32 ``xw`` (T, B, 4H) (the
    input product with the bias), ``h0``/``c0`` (B, H) and ``wh`` (H, 4H)
    -> ``(hs, cs, gates)``, h and c after every step (T, B, H) and the gate
    pre-activations (T, B, 4H), in time order also under ``reverse``.  A
    CUDA tensor launches ``csrc/lstm_layer.cu`` once (geometry from
    :func:`layer_geometry`) and counts the launch in
    ``lstm_layer.launches``; a CPU tensor runs :func:`lstm_layer_plain`."""
    if xw.dim() != 3 or xw.shape[2] % 4 or xw.shape[0] < 1:
        raise ValueError(f"lstm_layer: need xw (T >= 1, B, 4H), got "
                         f"{tuple(xw.shape)}")
    t, b, four_h = xw.shape
    hidden = four_h // 4
    if tuple(h0.shape) != (b, hidden) or tuple(c0.shape) != (b, hidden) \
            or tuple(wh.shape) != (hidden, four_h):
        raise ValueError(f"lstm_layer: h0, c0 (B, H) and wh (H, 4H) do not "
                         f"fit xw {tuple(xw.shape)}: {tuple(h0.shape)}, "
                         f"{tuple(c0.shape)}, {tuple(wh.shape)}")
    if not (xw.device == h0.device == c0.device == wh.device):
        raise ValueError("lstm_layer: xw, h0, c0, wh must be on one device")
    _check_flat("lstm_layer", xw=xw, h0=h0, c0=c0, wh=wh)
    if not _on_cuda("lstm_layer", xw):
        return lstm_layer_plain(xw, h0, c0, wh, reverse)
    geo = layer_geometry(b, hidden)
    hs = torch.empty((t, b, hidden), dtype=torch.float32, device=xw.device)
    cs = torch.empty_like(hs)
    gates = torch.empty_like(xw)
    _launch("lstm_layer", "lstm_layer", "dt_lstm_layer", xw.device,
            xw.data_ptr(), h0.data_ptr(), c0.data_ptr(), wh.data_ptr(),
            hs.data_ptr(), cs.data_ptr(), gates.data_ptr(), t, b, hidden,
            geo.n, geo.rows, geo.ks, geo.clusters, int(geo.wsm),
            int(reverse), geo.smem, sig=(xw,))
    lstm_layer.launches += 1
    return hs, cs, gates


lstm_layer.launches = 0


def lstm_layer_backward(x, h0, c0, wx, wh, hs, cs, gates, dhs, dcs,
                        reverse: bool):
    """Explicit BPTT through one layer window from the saved ``hs``, ``cs``
    and ``gates``: from the last step processed to the first,
    :func:`lstm_pointwise_backward` gives the step's gate gradient and
    ``dc_{t-1} = dc * f``, and ``dh_{t-1} = dG_t @ wh^T``; then one matmul
    each gives ``dWh``, ``dWx`` and ``dx``, and a sum ``db``.  ``dhs`` and
    ``dcs`` (T, B, H) are the gradients reaching h_t and c_t from outside.
    Returns ``(dx, dh0, dc0, dwx, dwh, db)``."""
    steps = x.shape[0]
    dgates = torch.empty_like(gates)
    dh = torch.zeros_like(h0)
    dc = torch.zeros_like(c0)
    whT = wh.t()
    for s in range(steps - 1, -1, -1):
        t = steps - 1 - s if reverse else s
        c_prev = c0 if s == 0 else cs[t + 1 if reverse else t - 1]
        dgates[t], dc = lstm_pointwise_backward(gates[t], c_prev,
                                                dhs[t] + dh, dcs[t] + dc)
        dh = torch.matmul(dgates[t], whT)
    h_prev = torch.cat([hs[1:], h0[None]]) if reverse \
        else torch.cat([h0[None], hs[:-1]])
    dg2 = dgates.reshape(-1, dgates.shape[-1])
    dwh = torch.matmul(h_prev.reshape(-1, h0.shape[-1]).t(), dg2)
    dwx = torch.matmul(x.reshape(-1, x.shape[-1]).t(), dg2)
    dx = torch.matmul(dg2, wx.t()).reshape(x.shape)
    return dx, dh, dc, dwx, dwh, dg2.sum(0)


class _LSTMLayer(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, h0, c0, wx, wh, b, reverse):
        t, bsz, inp = x.shape
        xw = (torch.matmul(x.reshape(t * bsz, inp), wx) + b) \
            .reshape(t, bsz, -1)
        hs, cs, gates = lstm_layer(xw, h0.contiguous(), c0.contiguous(),
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
    differentiable: f32 ``x`` (T, B, I), ``h0``/``c0`` (B, H) and ``w``
    (``wx`` (I, 4H), ``wh`` (H, 4H), ``b`` (4H,)) -> ``(hs, cs)`` (T, B,
    H), h and c after every step in time order.  The input product ``x @
    wx + b`` is one ``torch.matmul``; the steps are :func:`lstm_layer`.
    The backward is :func:`lstm_layer_backward`."""
    return _LSTMLayer.apply(x, h0, c0, w.wx, w.wh, w.b, bool(reverse))
