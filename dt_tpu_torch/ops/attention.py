"""Flash attention: the CUDA forward kernel beside its plain version, and the
blockwise backward (counterpart of ``dt_tpu/ops/pallas/attention.py``).

- :func:`flash_fwd` is the kernel's wrapper: ``(B, S, H, D)`` q/k/v -> the
  output ``(B, S, H, D)`` in q's dtype and the per-row logsumexp ``(B*H,
  S)`` in f32.  A CUDA tensor launches ``csrc/flash_attn.cu`` (replacing the
  TPU kernel ``_attn_kernel``, ``attention.py:40,100``: on the tensor cores
  through ``wgmma`` and TMA, bf16 directly and f32 as 3xTF32) and counts
  the launch in ``flash_fwd.launches``; a CPU tensor runs
  :func:`flash_attention_plain`.
- :func:`flash_attention_plain` is the plain version on the ``(B*H, S, D)``
  form: the TPU kernel's online softmax over kv blocks, with its skip of
  causal blocks past the diagonal and its constants.
- :func:`flash_attention_backward` ports ``_flash_bwd_blockwise``
  (``attention.py:136-186``): a loop over kv blocks that recomputes ``p``
  from the saved lse, all in f32.  The JAX backward is a ``lax.scan``, not
  a Pallas kernel, so plain PyTorch is its counterpart here.
- :func:`flash_attention` (``attention.py:213-236``) is the differentiable
  public function.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dt_tpu_torch.ops.kernels import _DTYPE_CODES, _launch, _on_cuda

NEG_INF = -1e30
DEFAULT_BLOCK = 128  # callers that pad (TransformerLM) key off this
HEAD_DIMS = (32, 64, 128)  # the kernel's template widths


def _to3(x: torch.Tensor) -> torch.Tensor:
    """``(B, S, H, D)`` -> ``(B*H, S, D)`` (a copy unless H == 1)."""
    b, s, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, s, d)


def _from3(x3: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """``(B*H, S, D)`` -> ``(B, S, H, D)``, contiguous."""
    bh, s, d = x3.shape
    return x3.view(b, h, s, d).permute(0, 2, 1, 3).contiguous()


def flash_attention_plain(q3: torch.Tensor, k3: torch.Tensor,
                          v3: torch.Tensor, *, scale: float, causal: bool,
                          block_q: int = DEFAULT_BLOCK,
                          block_k: int = DEFAULT_BLOCK
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version on ``(B*H, S, D)`` q/k/v: ``(out in q's dtype,
    lse (B*H, S) f32)``.  Each kv block is scored in f32, masked with
    ``NEG_INF``, and folded into the running max ``m``, sum ``l`` and
    accumulator as the TPU kernel folds it; a row's q block takes no part in
    a kv block that starts past its last row (the causal skip).  At the end
    ``l`` is clamped at 1e-30, ``out = acc / l`` and ``lse = m + log(l)``."""
    bh, sq, d = q3.shape
    sk = k3.shape[1]
    dev = q3.device
    qf = q3.float()
    rows = torch.arange(sq, device=dev)
    last_row = (rows // block_q) * block_q + block_q - 1  # of the row's block
    m = torch.full((bh, sq, 1), NEG_INF, device=dev)
    l = torch.zeros((bh, sq, 1), device=dev)
    acc = torch.zeros((bh, sq, d), device=dev)
    neg = torch.full((), NEG_INF, device=dev)
    for k0 in range(0, sk, block_k):
        kf = k3[:, k0:k0 + block_k].float()
        vf = v3[:, k0:k0 + block_k].float()
        s = torch.matmul(qf, kf.transpose(1, 2)) * scale
        if causal:
            keys = torch.arange(k0, k0 + kf.shape[1], device=dev)
            s = torch.where(rows[:, None] >= keys[None, :], s, neg)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new)
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(-1, keepdim=True)
        acc_new = acc * corr + torch.matmul(p, vf)
        if causal:  # the kernel skips this block for rows of earlier blocks
            live = (k0 <= last_row)[None, :, None]
            m_new = torch.where(live, m_new, m)
            l_new = torch.where(live, l_new, l)
            acc_new = torch.where(live, acc_new, acc)
        m, l, acc = m_new, l_new, acc_new
    l = torch.clamp(l, min=1e-30)
    out = (acc / l).to(q3.dtype)
    return out, (m + torch.log(l))[..., 0]


def _check_qkv(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be (B, S, H, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, h, d = q.shape
    if k.shape != v.shape or (k.shape[0], k.shape[2], k.shape[3]) != (b, h, d):
        raise ValueError(f"flash_attention: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPE_CODES:
        raise TypeError("flash_attention: q, k, v must share one dtype, "
                        f"float32 or bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v must be on one device")


def _bsh_strides(t: torch.Tensor):
    """The (B, S, H) element strides of a ``(B, S, H, D)`` view, an axis of
    size 1 given the stride of a dense layout (its own is arbitrary and
    never used, but a TMA map checks it)."""
    b, s, h, d = t.shape
    dense = (s * h * d, h * d, d)
    return [t.stride(i) if t.shape[i] > 1 else dense[i] for i in range(3)]


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              scale: float, causal: bool, block_q: int = DEFAULT_BLOCK,
              block_k: int = DEFAULT_BLOCK
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's wrapper: ``(B, S, H, D)`` q/k/v (strided views are
    taken as they are; D's stride must be 1) -> ``(out (B, S, H, D)
    contiguous in q's dtype, lse (B*H, S) f32)``.  A CUDA tensor launches
    ``csrc/flash_attn.cu`` (D in 32, 64, 128; on the tensor cores, bf16
    directly and f32 as 3xTF32; q, k and v start and stride on 16 bytes
    for its TMA loads, else ``ValueError``) and counts the launch; a CPU
    tensor runs :func:`flash_attention_plain` with ``block_q``/``block_k``
    (the kernel tiles by itself: its result does not depend on them)."""
    _check_qkv(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    if not _on_cuda("flash_attention", q):
        out3, lse = flash_attention_plain(_to3(q), _to3(k), _to3(v),
                                          scale=scale, causal=causal,
                                          block_q=block_q, block_k=block_k)
        return _from3(out3, b, h), lse
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes head dims "
                         f"{HEAD_DIMS}, got {d}")
    if b * h > 65535 or sq == 0 or sk == 0:
        raise ValueError(f"flash_attention: need 1 <= B*H <= 65535 and "
                         f"non-empty sequences, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    strides = []
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention: {name}'s last axis must be "
                             f"contiguous, got strides {tuple(t.stride())}")
        st = _bsh_strides(t)
        if t.data_ptr() % 16 or any(s * t.element_size() % 16 for s in st):
            raise ValueError(
                f"flash_attention: the kernel's TMA loads need {name}'s "
                "start and (B, S, H) strides on 16 bytes, got address "
                f"{t.data_ptr():#x} and strides {tuple(t.stride())} of "
                f"{t.element_size()}-byte elements")
        strides += st
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    _launch("flash_attention", "flash_attn", "dt_flash_attn_fwd", q.device,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, h, sq, sk, d, *strides, float(scale),
            int(causal), _DTYPE_CODES[q.dtype])
    flash_fwd.launches += 1
    return out, lse


flash_fwd.launches = 0


def flash_attention_backward(q3, k3, v3, o3, lse, do3, *, scale: float,
                             causal: bool, block_k: int = DEFAULT_BLOCK):
    """``(dq, dk, dv)`` on the ``(B*H, S, D)`` form from the saved ``lse``,
    block by kv block, all in f32 (``_flash_bwd_blockwise``): ``delta =
    sum(dO * O)``, ``p = exp(s - lse)`` (0 where masked), ``dv = p^T dO``,
    ``ds = p * (dO v^T - delta) * scale``, ``dq += ds k``, ``dk = ds^T q``.
    Like the JAX backward it does not skip causal blocks.  Gradients in the
    inputs' dtypes."""
    sk = k3.shape[1]
    qf = q3.float()
    dof = do3.float()
    delta = (dof * o3.float()).sum(-1, keepdim=True)  # (BH, S, 1)
    rows = torch.arange(q3.shape[1], device=q3.device)
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    zero = torch.zeros((), device=q3.device)
    for k0 in range(0, sk, block_k):
        kf = k3[:, k0:k0 + block_k].float()
        vf = v3[:, k0:k0 + block_k].float()
        s = torch.matmul(qf, kf.transpose(1, 2)) * scale
        p = torch.exp(s - lse[:, :, None])
        if causal:
            keys = torch.arange(k0, k0 + kf.shape[1], device=q3.device)
            p = torch.where(rows[:, None] >= keys[None, :], p, zero)
        dvs.append(torch.matmul(p.transpose(1, 2), dof))
        dp = torch.matmul(dof, vf.transpose(1, 2))
        ds = p * (dp - delta) * scale
        dq = dq + torch.matmul(ds, kf)
        dks.append(torch.matmul(ds.transpose(1, 2), qf))
    return (dq.to(q3.dtype), torch.cat(dks, 1).to(k3.dtype),
            torch.cat(dvs, 1).to(v3.dtype))


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale, causal, block_q, block_k):
        out, lse = flash_fwd(q, k, v, scale=scale, causal=causal,
                             block_q=block_q, block_k=block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal, ctx.block_k = scale, causal, block_k
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        b, _, h, _ = q.shape
        dq, dk, dv = flash_attention_backward(
            _to3(q), _to3(k), _to3(v), _to3(out), lse, _to3(dout),
            scale=ctx.scale, causal=ctx.causal, block_k=ctx.block_k)
        return (_from3(dq, b, h), _from3(dk, b, h), _from3(dv, b, h), None,
                None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False, scale: Optional[float] = None,
                    block_q: int = DEFAULT_BLOCK,
                    block_k: int = DEFAULT_BLOCK) -> torch.Tensor:
    """Fused attention of ``(B, S, H, D)`` q/k/v (``full_attention`` is the
    oracle), differentiable through :func:`flash_attention_backward`.
    ``scale`` defaults to ``D**-0.5``.  Sequence lengths must be multiples
    of the blocks (pad upstream, as ``TransformerLM`` does); else
    ``ValueError``, as in the JAX package."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s, sk = q.shape[1], k.shape[1]
    if s % block_q or sk % block_k:
        raise ValueError(f"seq lengths ({s}, {sk}) must be multiples of "
                         f"blocks ({block_q}, {block_k})")
    return _FlashAttention.apply(q, k, v, float(scale), bool(causal),
                                 block_q, block_k)
