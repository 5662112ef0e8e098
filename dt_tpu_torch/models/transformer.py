"""Transformer language models (counterpart of
``dt_tpu/models/transformer.py``).

Pre-norm decoder blocks with causal self-attention, named as the JAX modules
name themselves: ``embed/embedding``, ``pos_embed``, ``block<i>/
{LayerNorm_0, MultiHeadAttention_0/{qkv, proj}, LayerNorm_1, mlp_in,
mlp_out}`` (or ``moe/{router, wi, wo}``), ``LayerNorm_0`` and ``lm_head``, so
``interchange`` carries the JAX variables in by name.  Params are f32
masters cast to the compute ``dtype`` per call, except ``pos_embed``, which
the JAX model makes in ``dtype`` (a bf16 parameter under bf16, updated in
bf16).

Attention, by ``seq_parallel``:
- ``None``: ``parallel.ring_attention.full_attention``;
- ``"flash"``: ``ops.attention.flash_attention`` (the CUDA kernel on the
  card), with queries and keys padded at the end to ``DEFAULT_BLOCK`` and
  the padded rows sliced off; the causal mask keeps the padded keys out of
  the real rows;
- ``"ring"`` / ``"ulysses"``: ``parallel.ring_attention.ring_attention`` /
  ``parallel.ulysses.ulysses_attention`` over the ``mesh`` axis
  ``axis_name``; the block's other layers run replicated along that axis.
The port reads no environment variable here (the JAX package's ``None``
turns into flash under ``DT_PALLAS_ATTN=1``).  ``moe_experts > 0`` replaces
each FFN with ``parallel.moe.MoEMLP`` (experts over the ``moe_axis`` of the
mesh when it has one); ``remat=True`` recomputes each block in the backward
(``ops.remat``).

:class:`PipelinedTransformerLM` runs the decoder blocks as a GPipe pipeline
(``parallel.pipeline``), ``num_layers / num_stages`` blocks a stage over
the ``pipe`` axis of ``mesh``; each stage rank holds its own stage's
parameters only.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from dt_tpu_torch.models.common import Dense, Embed, LayerNorm
from dt_tpu_torch.ops import nn as nn_ops
from dt_tpu_torch.ops import remat as remat_lib
from dt_tpu_torch.ops.attention import DEFAULT_BLOCK, flash_attention
from dt_tpu_torch.parallel.moe import MoEMLP
from dt_tpu_torch.parallel.pipeline import pipeline_run
from dt_tpu_torch.parallel.ring_attention import (full_attention,
                                                  ring_attention)
from dt_tpu_torch.parallel.ulysses import ulysses_attention

SEQ_PARALLEL = (None, "flash", "ring", "ulysses")


class MultiHeadAttention(nn.Module):
    """Causal self-attention: ``qkv`` (D -> 3D, no bias), heads of D / H,
    attention by ``seq_parallel``, ``proj`` (D -> D, no bias)."""

    def __init__(self, embed_dim: int, num_heads: int,
                 seq_parallel: Optional[str] = None,
                 dtype: torch.dtype = torch.float32, mesh=None,
                 axis_name: str = "data"):
        super().__init__()
        if seq_parallel not in SEQ_PARALLEL:
            raise ValueError(f"seq_parallel={seq_parallel!r}; one of "
                             f"{SEQ_PARALLEL}")
        self.mesh_axes = ()
        if seq_parallel in ("ring", "ulysses"):
            if mesh is None:
                raise ValueError(f"seq_parallel={seq_parallel!r} needs a mesh")
            if mesh.axis_size(axis_name) > 1:
                self.mesh_axes = (axis_name,)
        self.num_heads = num_heads
        self.seq_parallel = seq_parallel
        self.mesh, self.axis_name = mesh, axis_name
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
        elif self.seq_parallel == "ring":
            out = ring_attention(q, k, v, self.mesh, axis_name=self.axis_name,
                                 causal=True)
        elif self.seq_parallel == "ulysses":
            out = ulysses_attention(q, k, v, self.mesh,
                                    axis_name=self.axis_name, causal=True)
        else:
            out = full_attention(q, k, v, causal=True)
        return self.proj(out.reshape(b, s, d))


class DecoderBlock(nn.Module):
    """``x + attn(ln(x))``, then ``x + ffn(ln(x))``: a tanh-GELU MLP of
    ``mlp_ratio * D``, or ``MoEMLP`` (``moe``) with ``moe_experts > 0``;
    dropout after each branch when training."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_ratio: int = 4,
                 seq_parallel: Optional[str] = None, dropout: float = 0.0,
                 moe_experts: int = 0, dtype: torch.dtype = torch.float32,
                 mesh=None, axis_name: str = "data",
                 moe_axis: str = "model"):
        super().__init__()
        self.dropout = dropout
        self.LayerNorm_0 = LayerNorm(embed_dim)
        self.MultiHeadAttention_0 = MultiHeadAttention(
            embed_dim, num_heads, seq_parallel, dtype, mesh, axis_name)
        self.LayerNorm_1 = LayerNorm(embed_dim)
        if moe_experts:
            self.moe = MoEMLP(embed_dim, moe_experts, mlp_ratio, mesh=mesh,
                              axis=moe_axis, dtype=dtype)
        else:
            self.mlp_in = Dense(embed_dim, mlp_ratio * embed_dim, dtype)
            self.mlp_out = Dense(mlp_ratio * embed_dim, embed_dim, dtype)

    def forward(self, x: torch.Tensor, training: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        h = self.MultiHeadAttention_0(self.LayerNorm_0(x))
        h = nn_ops.dropout(h, self.dropout, training=training,
                           generator=generator)
        x = x + h
        h = self.LayerNorm_1(x)
        if hasattr(self, "moe"):
            h = self.moe(h)
        else:
            h = self.mlp_out(nn_ops.activation(self.mlp_in(h), "gelu"))
        h = nn_ops.dropout(h, self.dropout, training=training,
                           generator=generator)
        return x + h


class TransformerLM(nn.Module):
    """Decoder-only LM: tokens ``(B, S)`` -> logits ``(B, S, V)`` in the
    compute ``dtype``.  ``mesh``/``axis_name`` serve ring and Ulysses
    attention, ``mesh``/``moe_axis`` expert parallelism; ``remat`` recomputes
    each block in the backward (its dropout masks replayed from
    ``generator``), the param tree unchanged."""

    def __init__(self, vocab_size: int = 32000, embed_dim: int = 512,
                 num_layers: int = 6, num_heads: int = 8,
                 max_len: int = 8192, seq_parallel: Optional[str] = None,
                 dropout: float = 0.0, moe_experts: int = 0,
                 dtype: torch.dtype = torch.float32, remat: bool = False,
                 mesh=None, axis_name: str = "data",
                 moe_axis: str = "model"):
        super().__init__()
        self.num_layers = num_layers
        self.remat = remat
        self.embed = Embed(vocab_size, embed_dim, dtype)
        self.pos_embed = nn.Parameter(
            torch.zeros(max_len, embed_dim, dtype=dtype))
        for i in range(num_layers):
            setattr(self, f"block{i}", DecoderBlock(
                embed_dim, num_heads, 4, seq_parallel, dropout, moe_experts,
                dtype, mesh, axis_name, moe_axis))
        self.LayerNorm_0 = LayerNorm(embed_dim)
        self.lm_head = Dense(embed_dim, vocab_size, dtype, use_bias=False)

    def forward(self, tokens: torch.Tensor, training: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        s = tokens.shape[1]
        x = self.embed(tokens) + self.pos_embed[None, :s]
        for i in range(self.num_layers):
            block = getattr(self, f"block{i}")
            if self.remat and torch.is_grad_enabled():
                x = remat_lib.checkpoint(
                    lambda h, blk=block: blk(h, training, generator), x,
                    generator=generator)
            else:
                x = block(x, training, generator)
        return self.lm_head(self.LayerNorm_0(x))


class PipeStage(nn.Module):
    """One pipeline stage (``transformer.py:117-131``): ``layers`` decoder
    blocks ``layer<i>`` in order, plain attention, no dropout."""

    def __init__(self, layers: int, embed_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = layers
        for i in range(layers):
            setattr(self, f"layer{i}", DecoderBlock(embed_dim, num_heads, 4,
                                                    None, 0.0, 0, dtype))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        for i in range(self.layers):
            h = getattr(self, f"layer{i}")(h, False)
        return h


class _PipeOuter(nn.Module):
    """The ends outside the pipe (``transformer.py:134-160``): the
    embedding and ``pos_embed`` (in ``dtype``) before it, ``ln_f`` and
    ``lm_head`` after it, replicated on every stage rank."""

    def __init__(self, vocab_size: int, embed_dim: int, max_len: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed = Embed(vocab_size, embed_dim, dtype)
        self.pos_embed = nn.Parameter(
            torch.zeros(max_len, embed_dim, dtype=dtype))
        self.ln_f = LayerNorm(embed_dim)
        self.lm_head = Dense(embed_dim, vocab_size, dtype, use_bias=False)

    def encode(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embed(tokens) + self.pos_embed[None, :tokens.shape[1]]

    def head(self, x: torch.Tensor) -> torch.Tensor:
        return self.lm_head(self.ln_f(x))


class PipelinedTransformerLM(nn.Module):
    """The TransformerLM with its decoder blocks run as a GPipe pipeline
    (``transformer.py:163-266``): the embedding and the head (``outer``) run
    replicated; the ``num_layers`` blocks fold into ``num_stages`` stages
    (``stages.<i>``), streamed through ``parallel.pipeline`` in
    ``num_micro`` microbatches over the ``axis_name`` axis of ``mesh``
    (stage ``i`` on the rank at position ``i``, which holds stage ``i``'s
    parameters only), optionally with the batch split over ``batch_axis``
    (dp x pp).  Without a mesh, or with an axis of one rank, it holds every
    stage and runs them in sequence on the whole batch: the oracle the
    pipelined schedule must match.  ``remat_stages`` recomputes each stage
    in the backward.  The JAX variables are ``{"outer": ..., "stages":
    ...}``, every stage leaf stacked on a leading axis of ``num_stages``:
    :meth:`jax_local_tree` and :meth:`jax_global_tree` map them to and from
    the stages this process holds.  No dropout inside the pipe, as in the
    JAX model."""

    def __init__(self, vocab_size: int = 32000, embed_dim: int = 512,
                 num_layers: int = 6, num_heads: int = 8,
                 max_len: int = 8192, num_stages: int = 2,
                 num_micro: int = 4, mesh=None, axis_name: str = "pipe",
                 batch_axis: Optional[str] = None,
                 remat_stages: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if num_layers % num_stages:
            raise ValueError(f"num_layers={num_layers} must divide into "
                             f"num_stages={num_stages}")
        self.num_stages, self.num_micro = num_stages, num_micro
        self.mesh, self.axis_name, self.batch_axis = mesh, axis_name, \
            batch_axis
        self.remat_stages = remat_stages
        self.dtype = dtype
        n = mesh.shape.get(axis_name, 1) if mesh is not None else 1
        self.pipelined = n > 1
        self.mesh_axes = (axis_name,) if self.pipelined else ()
        if self.pipelined and num_stages != n:
            raise ValueError(
                f"stacked params carry {num_stages} stages but the "
                f"{axis_name!r} axis has {n} devices; they must match (fold "
                f"multiple layers into one stage_fn to run more layers per "
                f"device)")
        self.held = [mesh.axis_index(axis_name)] if self.pipelined \
            else list(range(num_stages))
        self.outer = _PipeOuter(vocab_size, embed_dim, max_len, dtype)
        self.stages = nn.ModuleDict({
            str(i): PipeStage(num_layers // num_stages, embed_dim,
                              num_heads, dtype) for i in self.held})

    def _stage_fn(self, stage: PipeStage):
        if self.remat_stages and torch.is_grad_enabled():
            return lambda h: remat_lib.checkpoint(stage, h)
        return stage

    def forward(self, tokens: torch.Tensor,
                training: bool = False) -> torch.Tensor:
        x = self.outer.encode(tokens)
        if not self.pipelined:
            h = x
            for i in self.held:
                h = self._stage_fn(self.stages[str(i)])(h)
            return self.outer.head(h)
        m = self.num_micro
        dp = self.mesh.axis_size(self.batch_axis) if self.batch_axis else 1
        b = x.shape[0] * dp  # the global batch
        if b % m:
            raise ValueError(f"batch {b} must divide into num_micro={m} "
                             "microbatches")
        if (b // m) % dp:
            raise ValueError(
                f"microbatch size {b // m} (batch {b} / num_micro {m}) must "
                f"divide by the {self.batch_axis!r} axis ({dp} devices)")
        micro = x.reshape((m, x.shape[0] // m) + tuple(x.shape[1:]))
        stage = self.stages[str(self.held[0])]
        ys = pipeline_run(self._stage_fn(stage), list(stage.parameters()),
                          micro, self.mesh.axis_group(self.axis_name))
        return self.outer.head(ys.reshape(x.shape))

    def jax_local_tree(self, tree: dict) -> dict:
        """The JAX ``{"outer", "stages"}`` tree with its stacked stage
        leaves cut into the stages this process holds, ``{"stages": {"<i>":
        slice i}}``."""
        def pick(node, i):
            if isinstance(node, dict):
                return {k: pick(v, i) for k, v in node.items()}
            return node[i]
        out = {k: v for k, v in tree.items() if k != "stages"}
        if "stages" in tree:
            out["stages"] = {str(i): pick(tree["stages"], i)
                             for i in self.held}
        return out

    def jax_global_tree(self, tree: dict) -> dict:
        """The inverse of :meth:`jax_local_tree`: the held stages stacked on
        a leading axis (of ``num_stages`` when this process holds them all,
        else of 1: this rank's slice)."""
        def stack(nodes):
            if isinstance(nodes[0], dict):
                return {k: stack([n[k] for n in nodes]) for k in nodes[0]}
            if isinstance(nodes[0], torch.Tensor):
                return torch.stack(nodes)
            return np.stack(nodes)
        out = {k: v for k, v in tree.items() if k != "stages"}
        if "stages" in tree:
            out["stages"] = stack([tree["stages"][str(i)]
                                   for i in self.held])
        return out
