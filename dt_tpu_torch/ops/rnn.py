"""Recurrent ops: LSTM, GRU and vanilla cells, the multi-layer LSTM and
GRU, the bidirectional LSTM and the LSTM init (counterpart of
``dt_tpu/ops/rnn.py``).

Gate order i, f, g, o for the LSTM and r, z, n for the GRU, as the JAX
package and the reference's cuDNN convention have them.  The LSTM's time
loop, a ``lax.scan`` in the JAX package, is one launch a layer window on
the card in f32 and in bf16 (``ops.kernels.lstm_layer_fused``, the fused
cell's whole window), and its backward one more; a Python loop over the
steps otherwise (the layers too wide for the kernels).  The GRU and the
vanilla cell are plain PyTorch, as the JAX package computes them in ``jnp``
outside any Pallas kernel.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from dt_tpu_torch.config import resolve_device
from dt_tpu_torch.ops.kernels import (layer_fits, lstm_cell_fused,
                                      lstm_layer_fused)


class LSTMWeights(NamedTuple):
    """One layer's packed weights: wx (I, 4H), wh (H, 4H), b (4H,)."""
    wx: torch.Tensor
    wh: torch.Tensor
    b: torch.Tensor


class GRUWeights(NamedTuple):
    """One GRU layer's weights: wx (I, 3H), wh (H, 3H), bx (3H,), bh
    (3H,)."""
    wx: torch.Tensor
    wh: torch.Tensor
    bx: torch.Tensor
    bh: torch.Tensor


def lstm_cell(x: torch.Tensor, h: torch.Tensor, c: torch.Tensor,
              w: LSTMWeights) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LSTM step in plain PyTorch, the oracle of the fused cell: the
    matmuls in the input dtype, the gates and the state update in f32,
    both outputs in ``x``'s dtype (``rnn.py:47-59``)."""
    gates = (torch.matmul(x, w.wx) + torch.matmul(h, w.wh)).float() + w.b
    i, f, g, o = gates.chunk(4, dim=-1)
    i, f, o = torch.sigmoid(i), torch.sigmoid(f), torch.sigmoid(o)
    g = torch.tanh(g)
    new_c = f * c.float() + i * g
    new_h = o * torch.tanh(new_c)
    return new_h.to(x.dtype), new_c.to(x.dtype)


def gru_cell(x: torch.Tensor, h: torch.Tensor,
             w: GRUWeights) -> torch.Tensor:
    """One GRU step (``rnn.py:62-73``): gates r, z, n with the cuDNN-style
    separate hidden bias, ``n = tanh(nx + r * nh)``; the matmuls in the
    input dtype, the gates in f32, the output in ``x``'s dtype."""
    gx = torch.matmul(x, w.wx).float() + w.bx
    gh = torch.matmul(h, w.wh).float() + w.bh
    rx, zx, nx = gx.chunk(3, dim=-1)
    rh, zh, nh = gh.chunk(3, dim=-1)
    r = torch.sigmoid(rx + rh)
    z = torch.sigmoid(zx + zh)
    n = torch.tanh(nx + r * nh)
    new_h = (1.0 - z) * n + z * h.float()
    return new_h.to(x.dtype)


def vanilla_cell(x: torch.Tensor, h: torch.Tensor, wx: torch.Tensor,
                 wh: torch.Tensor, b: torch.Tensor,
                 act: str = "tanh") -> torch.Tensor:
    """The rnn_tanh / rnn_relu step (``rnn.py:76-81``); ``act`` other than
    ``"tanh"`` is the ReLU, as in the JAX package."""
    pre = (torch.matmul(x, wx) + torch.matmul(h, wh)).float() + b
    out = torch.tanh(pre) if act == "tanh" else torch.relu(pre)
    return out.to(x.dtype)


def _layer_route(x: torch.Tensor, h: torch.Tensor, w) -> bool:
    """Whether a layer runs as ``lstm_layer_fused``: an f32 ``x``, or a
    bf16 one with bf16 weights, of a shape the layer kernels take."""
    if x.dtype == torch.float32:
        return layer_fits(x.shape[1], h.shape[-1])
    return x.dtype == torch.bfloat16 \
        and all(a.dtype == torch.bfloat16 for a in (w.wx, w.wh, w.b)) \
        and layer_fits(x.shape[1], h.shape[-1], torch.bfloat16)


def lstm(x: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
         weights: Sequence[LSTMWeights], reverse: bool = False,
         fused: Optional[bool] = None
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-layer unidirectional LSTM over a sequence (``rnn.py:84-114``).

    ``x``: (T, B, I); ``h0``/``c0``: (L, B, H).  Returns (outputs (T, B, H),
    hT (L, B, H), cT (L, B, H)).  ``reverse`` runs each layer from the last
    step to the first.  ``fused`` picks the cell: ``None`` (the default) and
    ``True`` run the fused cell, a float32 or bfloat16 layer (its weights
    in ``x``'s dtype) as :func:`dt_tpu_torch.ops.kernels.lstm_layer_fused`
    (one CUDA launch a layer window on the card and one for its BPTT
    backward; their plain step loops on the CPU) where the layer kernels
    take the shape (:func:`dt_tpu_torch.ops.kernels.layer_fits`: f32 H up
    to 6404), and a wider layer or any other dtype step by step through
    :func:`dt_tpu_torch.ops.kernels.lstm_cell_fused` (the pointwise kernel,
    which takes any H); ``False`` runs the plain :func:`lstm_cell` step by
    step.  Both are hand kernels, chosen from the shape before any launch.
    The port reads no environment variable for this (the JAX package's
    default follows ``DT_PALLAS_RNN``).
    """
    outs = x
    hs, cs = [], []
    last = 0 if reverse else x.shape[0] - 1
    for layer, w in enumerate(weights):
        h, c = h0[layer], c0[layer]
        if fused is not False and _layer_route(outs, h, w):
            outs, c_all = lstm_layer_fused(outs, h, c, w, reverse)
            hs.append(outs[last])
            cs.append(c_all[last])
            continue
        cell = lstm_cell if fused is False else lstm_cell_fused
        steps = range(outs.shape[0] - 1, -1, -1) if reverse \
            else range(outs.shape[0])
        ys = [None] * outs.shape[0]
        for t in steps:
            h, c = cell(outs[t], h, c, w)
            ys[t] = h
        outs = torch.stack(ys)
        hs.append(h)
        cs.append(c)
    return outs, torch.stack(hs), torch.stack(cs)


def gru(x: torch.Tensor, h0: torch.Tensor, weights: Sequence[GRUWeights],
        reverse: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-layer unidirectional GRU (``rnn.py:117-130``): ``x`` (T, B,
    I), ``h0`` (L, B, H) -> (outputs (T, B, H), hT (L, B, H)); a Python
    loop over the steps of :func:`gru_cell`."""
    outs = x
    hs = []
    for layer, w in enumerate(weights):
        h = h0[layer]
        steps = range(outs.shape[0] - 1, -1, -1) if reverse \
            else range(outs.shape[0])
        ys = [None] * outs.shape[0]
        for t in steps:
            h = gru_cell(outs[t], h, w)
            ys[t] = h
        outs = torch.stack(ys)
        hs.append(h)
    return outs, torch.stack(hs)


def bidirectional_lstm(x: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
                       fwd: Sequence[LSTMWeights],
                       bwd: Sequence[LSTMWeights],
                       fused: Optional[bool] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bidirectional multi-layer LSTM (``rnn.py:133-150``; the reference's
    ``bidirectional=True``).  ``h0``/``c0``: (2L, B, H), forward and
    backward interleaved per layer; a layer's output is ``concat(fwd,
    bwd)`` (T, B, 2H), the next layer's input (cuDNN semantics).  Returns
    (outputs, hT (2L, B, H), cT (2L, B, H)).  Each direction is one
    :func:`lstm` layer, the backward one with ``reverse=True``, so with
    ``fused`` at its default an f32 or bf16 layer is one
    ``lstm_layer_fused`` launch a direction, and its backward one
    ``lstm_layer_bwd`` launch; ``fused=False`` runs the plain cell."""
    outs = x
    hs, cs = [], []
    for layer in range(len(fwd)):
        f, b = 2 * layer, 2 * layer + 1
        yf, hf, cf = lstm(outs, h0[f:f + 1], c0[f:f + 1], [fwd[layer]],
                          fused=fused)
        yb, hb, cb = lstm(outs, h0[b:b + 1], c0[b:b + 1], [bwd[layer]],
                          reverse=True, fused=fused)
        outs = torch.cat([yf, yb], dim=-1)
        hs += [hf[0], hb[0]]
        cs += [cf[0], cb[0]]
    return outs, torch.stack(hs), torch.stack(cs)


def init_lstm_weights(generator: torch.Generator, num_layers: int,
                      input_size: int, hidden_size: int,
                      dtype: torch.dtype = torch.float32,
                      device: Union[str, torch.device] = "cuda"
                      ) -> List[LSTMWeights]:
    """cuDNN-style init (``rnn.py:153-167``): ``wx`` (I, 4H) and ``wh``
    (H, 4H) uniform in [-1/sqrt(H), 1/sqrt(H)], ``b`` (4H,) zeros, in
    ``dtype``, on ``device`` (default ``"cuda"``); layer 0 takes
    ``input_size`` inputs and the others ``hidden_size``, as in the JAX
    package.  The draws come from ``generator``, on its own device, then
    move: the same law as the JAX package's, another stream (JAX's keys
    cannot be reproduced here)."""
    dev = resolve_device(device)
    scale = 1.0 / math.sqrt(hidden_size)

    def uniform(shape):
        u = torch.empty(shape, dtype=dtype, device=generator.device)
        return u.uniform_(-scale, scale, generator=generator).to(dev)

    ws = []
    for layer in range(num_layers):
        i = input_size if layer == 0 else hidden_size
        ws.append(LSTMWeights(
            wx=uniform((i, 4 * hidden_size)),
            wh=uniform((hidden_size, 4 * hidden_size)),
            b=torch.zeros(4 * hidden_size, dtype=dtype, device=dev)))
    return ws
