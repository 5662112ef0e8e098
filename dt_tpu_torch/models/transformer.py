"""Transformer language model (counterpart of
``dt_tpu/models/transformer.py:31-114, 269-309``).

Pre-norm decoder blocks with causal self-attention, named as the JAX modules
name themselves: ``embed/embedding``, ``pos_embed``, ``block<i>/
{LayerNorm_0, MultiHeadAttention_0/{qkv, proj}, LayerNorm_1, mlp_in,
mlp_out}``, ``LayerNorm_0`` and ``lm_head``, so ``interchange`` carries the
JAX variables in by name.  Params are f32 masters cast to the compute
``dtype`` per call, except ``pos_embed``, which the JAX model makes in
``dtype`` (a bf16 parameter under bf16, updated in bf16).

Attention, by ``seq_parallel``:
- ``None``: ``parallel.ring_attention.full_attention``;
- ``"flash"``: ``ops.attention.flash_attention`` (the CUDA kernel on the
  card), with queries and keys padded at the end to ``DEFAULT_BLOCK`` and
  the padded rows sliced off; the causal mask keeps the padded keys out of
  the real rows.
The port reads no environment variable here (the JAX package's ``None``
turns into flash under ``DT_PALLAS_ATTN=1``).  ``"ring"``, ``"ulysses"``,
``moe_experts > 0``, ``remat=True`` and the pipelined model come with the
parallel layer (ROADMAP Queue 1 item 6) and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from dt_tpu_torch.models.common import Dense, Embed, LayerNorm
from dt_tpu_torch.ops import nn as nn_ops
from dt_tpu_torch.ops.attention import DEFAULT_BLOCK, flash_attention
from dt_tpu_torch.parallel.ring_attention import full_attention

SEQ_PARALLEL = (None, "flash")
_LATER = "comes with the parallel layer (ROADMAP Queue 1 item 6)"


class MultiHeadAttention(nn.Module):
    """Causal self-attention: ``qkv`` (D -> 3D, no bias), heads of D / H,
    attention by ``seq_parallel``, ``proj`` (D -> D, no bias)."""

    def __init__(self, embed_dim: int, num_heads: int,
                 seq_parallel: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if seq_parallel not in SEQ_PARALLEL:
            raise NotImplementedError(
                f"seq_parallel={seq_parallel!r} {_LATER}; the port has "
                f"{SEQ_PARALLEL}")
        self.num_heads = num_heads
        self.seq_parallel = seq_parallel
        self.qkv = Dense(embed_dim, 3 * embed_dim, dtype, use_bias=False)
        self.proj = Dense(embed_dim, embed_dim, dtype, use_bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, d = x.shape
        heads = (b, s, self.num_heads, d // self.num_heads)
        q, k, v = (t.reshape(heads) for t in self.qkv(x).split(d, dim=-1))
        if self.seq_parallel == "flash":
            pad = (-s) % DEFAULT_BLOCK
            if pad:
                q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
            out = flash_attention(q, k, v, causal=True)[:, :s]
        else:
            out = full_attention(q, k, v, causal=True)
        return self.proj(out.reshape(b, s, d))


class DecoderBlock(nn.Module):
    """``x + attn(ln(x))``, then ``x + mlp(ln(x))`` with a tanh-GELU MLP of
    ``mlp_ratio * D``; dropout after each branch when training."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: int = 4,
                 seq_parallel: Optional[str] = None, dropout: float = 0.0,
                 moe_experts: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        if moe_experts:
            raise NotImplementedError(f"moe_experts > 0 {_LATER}")
        self.dropout = dropout
        self.LayerNorm_0 = LayerNorm(embed_dim)
        self.MultiHeadAttention_0 = MultiHeadAttention(
            embed_dim, num_heads, seq_parallel, dtype)
        self.LayerNorm_1 = LayerNorm(embed_dim)
        self.mlp_in = Dense(embed_dim, mlp_ratio * embed_dim, dtype)
        self.mlp_out = Dense(mlp_ratio * embed_dim, embed_dim, dtype)

    def forward(self, x: torch.Tensor, training: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.MultiHeadAttention_0(self.LayerNorm_0(x))
        h = nn_ops.dropout(h, self.dropout, training=training,
                           generator=generator)
        x = x + h
        h = self.mlp_out(nn_ops.activation(
            self.mlp_in(self.LayerNorm_1(x)), "gelu"))
        h = nn_ops.dropout(h, self.dropout, training=training,
                           generator=generator)
        return x + h


class TransformerLM(nn.Module):
    """Decoder-only LM: tokens ``(B, S)`` -> logits ``(B, S, V)`` in the
    compute ``dtype``.  The JAX model's mesh arguments (``mesh``,
    ``axis_name``, ``moe_axis``) come with the paths that use them."""

    def __init__(self, vocab_size: int = 32000, embed_dim: int = 512,
                 num_layers: int = 6, num_heads: int = 8,
                 max_len: int = 8192, seq_parallel: Optional[str] = None,
                 dropout: float = 0.0, moe_experts: int = 0,
                 dtype: torch.dtype = torch.float32, remat: bool = False):
        super().__init__()
        if remat:
            raise NotImplementedError(f"remat=True {_LATER}")
        self.num_layers = num_layers
        self.embed = Embed(vocab_size, embed_dim, dtype)
        self.pos_embed = nn.Parameter(
            torch.zeros(max_len, embed_dim, dtype=dtype))
        for i in range(num_layers):
            setattr(self, f"block{i}", DecoderBlock(
                embed_dim, num_heads, 4, seq_parallel, dropout, moe_experts,
                dtype))
        self.LayerNorm_0 = LayerNorm(embed_dim)
        self.lm_head = Dense(embed_dim, vocab_size, dtype, use_bias=False)

    def forward(self, tokens: torch.Tensor, training: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        s = tokens.shape[1]
        x = self.embed(tokens) + self.pos_embed[None, :s]
        for i in range(self.num_layers):
            x = getattr(self, f"block{i}")(x, training, generator)
        return self.lm_head(self.LayerNorm_0(x))
