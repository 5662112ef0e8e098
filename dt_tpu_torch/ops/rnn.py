"""Recurrent ops: the LSTM cell and the multi-layer LSTM (counterpart of
``dt_tpu/ops/rnn.py:33-114``).

Gate order i, f, g, o, as the JAX package and the reference's cuDNN
convention have it.  The time loop, a ``lax.scan`` in the JAX package, is
one launch a layer on the card (``ops.kernels.lstm_layer_fused``, the fused
cell's whole window) and a Python loop over the steps otherwise.  ``gru``,
``bidirectional_lstm`` and ``init_lstm_weights`` (which uses JAX's RNG) are
for a later slice.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from dt_tpu_torch.ops.kernels import lstm_cell_fused, lstm_layer_fused


class LSTMWeights(NamedTuple):
    """One layer's packed weights: wx (I, 4H), wh (H, 4H), b (4H,)."""
    wx: torch.Tensor
    wh: torch.Tensor
    b: torch.Tensor


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


def lstm(x: torch.Tensor, h0: torch.Tensor, c0: torch.Tensor,
         weights: Sequence[LSTMWeights], reverse: bool = False,
         fused: Optional[bool] = None
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Multi-layer unidirectional LSTM over a sequence (``rnn.py:84-114``).

    ``x``: (T, B, I); ``h0``/``c0``: (L, B, H).  Returns (outputs (T, B, H),
    hT (L, B, H), cT (L, B, H)).  ``reverse`` runs each layer from the last
    step to the first.  ``fused`` picks the cell: ``None`` (the default) and
    ``True`` run the fused cell, a float32 layer as
    :func:`dt_tpu_torch.ops.kernels.lstm_layer_fused` (one CUDA launch a
    layer window on the card, its plain step loop on the CPU; BPTT
    backward) and any other dtype step by step through
    :func:`dt_tpu_torch.ops.kernels.lstm_cell_fused`; ``False`` runs the
    plain :func:`lstm_cell` step by step.  The port reads no environment
    variable for this (the JAX package's default follows
    ``DT_PALLAS_RNN``).
    """
    outs = x
    hs, cs = [], []
    last = 0 if reverse else x.shape[0] - 1
    for layer, w in enumerate(weights):
        h, c = h0[layer], c0[layer]
        if fused is not False and outs.dtype == torch.float32:
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
