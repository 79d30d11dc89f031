"""Attention (twin of ray_tpu/ops/attention.py): the flash kernels on a
CUDA device, a reference einsum elsewhere.

`attention` takes `[batch, heads, seq, head_dim]` tensors and supports GQA
by repeating K/V heads first. `attention_packed` takes the packed
`[batch, seq, heads·head_dim]` layout the q/k/v projections produce, with
K/V `[batch, seq, kv_heads·head_dim]` never repeated. On a CUDA tensor
whose shape passes the same gate as the reference's TPU dispatch
(head_dim >= 128 and seq >= 128) each runs its hand-written
forward/backward kernels (`FlashAttention`, `flash_attention_packed`);
otherwise each runs `causal_attention_reference`, the ground truth the
kernels are held against, the packed one through reshapes. No model path
calls `attention_packed`, in either package.
"""

from __future__ import annotations

from typing import Optional

import torch

_NEG = -1e30


def causal_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor,
                               sm_scale: Optional[float] = None,
                               causal: bool = True) -> torch.Tensor:
    """Ground-truth attention, [batch, heads, seq, head_dim] layout: float32
    logits, a -1e30 fill above the end-aligned causal diagonal, float32
    softmax cast to q's dtype before the PV product."""
    sq, d = q.shape[-2:]
    sk = k.shape[-2]
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(sk - sq)
        logits = torch.where(mask, logits, _NEG)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[b, kv_heads, s, d] -> [b, kv_heads * n_rep, s, d], each KV head
    repeated for its n_rep query heads."""
    if n_rep == 1:
        return k
    b, h, s, d = k.shape
    return k[:, :, None].expand(b, h, n_rep, s, d).reshape(b, h * n_rep, s, d)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              sm_scale: Optional[float] = None) -> torch.Tensor:
    """Multi-head attention, [batch, heads, seq, head_dim]; supports GQA."""
    n_rep = q.shape[1] // k.shape[1]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = sm_scale if sm_scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    if q.is_cuda and q.shape[-1] >= 128 and q.shape[-2] >= 128:
        from ray_tpu_torch.ops.kernels.flash_attention import FlashAttention

        b, h, sq, d = q.shape
        sk = k.shape[-2]
        out = FlashAttention.apply(q.reshape(b * h, sq, d),
                                   k.reshape(b * h, sk, d),
                                   v.reshape(b * h, sk, d), scale, causal)
        return out.reshape(b, h, sq, d)
    return causal_attention_reference(q, k, v, sm_scale=scale, causal=causal)


def attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     n_heads: int, n_kv_heads: int, causal: bool = True,
                     sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention over packed [batch, seq, heads·head_dim] tensors; supports
    GQA (k/v [batch, seq, n_kv_heads·head_dim])."""
    b, sq, hd = q.shape
    d = hd // n_heads
    sk = k.shape[1]
    scale = sm_scale if sm_scale is not None else 1.0 / (d ** 0.5)
    if q.is_cuda and d >= 128 and sq >= 128:
        from ray_tpu_torch.ops.kernels.flash_attention import (
            flash_attention_packed)

        return flash_attention_packed(q, k, v, n_heads, n_kv_heads, scale,
                                      causal)
    q4 = q.reshape(b, sq, n_heads, d).transpose(1, 2)
    k4 = k.reshape(b, sk, n_kv_heads, d).transpose(1, 2)
    v4 = v.reshape(b, sk, n_kv_heads, d).transpose(1, 2)
    n_rep = n_heads // n_kv_heads
    out = causal_attention_reference(q4, _repeat_kv(k4, n_rep),
                                     _repeat_kv(v4, n_rep), sm_scale=scale,
                                     causal=causal)
    return out.transpose(1, 2).reshape(b, sq, hd)
