"""LSTM word-level language model (counterpart of
``dt_tpu/models/lstm_lm.py``): embedding -> multi-layer LSTM
(``ops.rnn.lstm``, the fused cell with the CUDA pointwise kernel) -> a tied
or untied softmax head.

Variables are named as the JAX model names them: ``embed/embedding``,
``l<i>_wx`` (I, 4H), ``l<i>_wh`` (H, 4H), ``l<i>_b`` (4H,) and ``Dense_0``.
The LSTM weights are made in the compute ``dtype``, as the JAX model makes
them; the embedding and the head are f32 masters cast per call.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from dt_tpu_torch.models.common import Dense, Embed
from dt_tpu_torch.ops import nn as nn_ops
from dt_tpu_torch.ops import rnn as rnn_ops


class LSTMLanguageModel(nn.Module):
    def __init__(self, vocab_size: int = 10000, embed_dim: int = 200,
                 hidden: int = 200, num_layers: int = 2,
                 dropout: float = 0.2, tie_weights: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden = hidden
        self.num_layers = num_layers
        self.dropout = dropout
        self.tie_weights = tie_weights
        self.dtype = dtype
        self.embed = Embed(vocab_size, embed_dim, dtype)
        for i in range(num_layers):
            inp = embed_dim if i == 0 else hidden
            for name, shape in ((f"l{i}_wx", (inp, 4 * hidden)),
                                (f"l{i}_wh", (hidden, 4 * hidden)),
                                (f"l{i}_b", (4 * hidden,))):
                setattr(self, name, nn.Parameter(torch.zeros(shape,
                                                             dtype=dtype)))
        if not tie_weights:
            self.Dense_0 = Dense(hidden, vocab_size, dtype)

    def weights(self):
        """The layers' ``ops.rnn.LSTMWeights``."""
        return [rnn_ops.LSTMWeights(getattr(self, f"l{i}_wx"),
                                    getattr(self, f"l{i}_wh"),
                                    getattr(self, f"l{i}_b"))
                for i in range(self.num_layers)]

    def forward(self, tokens: torch.Tensor,
                state: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                training: bool = True,
                generator: Optional[torch.Generator] = None):
        """``tokens``: (T, B) integers; ``state``: ``(h0, c0)``, each (L, B,
        H), zeros when ``None``.  Returns ``(logits (T, B, V), (hT, cT))``.
        Dropout (on the embedding and on the LSTM's output, when training)
        draws from ``generator``."""
        b = tokens.shape[1]
        x = nn_ops.dropout(self.embed(tokens), self.dropout,
                           training=training, generator=generator)
        if state is None:
            zeros = torch.zeros((self.num_layers, b, self.hidden),
                                dtype=self.dtype, device=tokens.device)
            state = (zeros, zeros)
        y, h_t, c_t = rnn_ops.lstm(x, state[0], state[1], self.weights())
        y = nn_ops.dropout(y, self.dropout, training=training,
                           generator=generator)
        if self.tie_weights:
            logits = y @ self.embed.embedding.t().to(self.dtype)
        else:
            logits = self.Dense_0(y)
        return logits, (h_t, c_t)
