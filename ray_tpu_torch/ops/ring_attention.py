"""Ring attention over the sp group (twin of ray_tpu/ops/ring_attention.py).

The sequence is split over the sp ranks. Each rank keeps its query block
and passes its K/V block around the ring, one step a rank: at step s it
holds the block that started on rank (i - s) mod sp, attends to it, and
merges the result into float32 accumulators `(o, m, l)` (the unnormalized
output, the running row max and the running sum of exps) with the
reference's online-softmax merge. Causality comes from global offsets
(the sp rank times the local length): the -1e30 fill where the query's
position is before the key's, so a block wholly in the future adds
nothing (its beta underflows to 0). `out = o / max(l, 1e-30)`.

The reference's `jax.lax.ppermute` is `_RingShift`: `batch_isend_irecv`
of the block to the next sp rank and from the previous one, whose
backward shifts the gradient the other way (ppermute's transpose). K and
V travel as one stacked tensor. The last step's shift, whose result the
reference discards, is not sent. Each step's block attention and merge
run under `torch.utils.checkpoint` (the reference's `jax.checkpoint`), so
the backward recomputes them instead of keeping an [s/sp, s/sp] block of
probabilities a step; the shifts stay outside it, so the backward does
not send them again.

The block attention is an einsum in the reference, not a Pallas kernel,
and stays plain PyTorch here. GQA: the caller repeats K/V to the query's
head count first (`models/transformer.py` `_attn_half`). `ring_attention`
takes each rank's local blocks `[batch, heads, seq/sp, head_dim]` and the
sp process group; it replaces `ring_attention_sharded`'s shard_map.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint

_NEG = -1e30


def _block_attend(q, k, v, q_off: int, k_off: int, causal: bool,
                  scale: float):
    """One query block against one K/V block, float32 statistics: the
    unnormalized output [b, h, sq, d], the row max m and sum l [b, h, sq]."""
    sq, sk = q.shape[-2], k.shape[-2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * scale
    if causal:
        q_pos = q_off + torch.arange(sq, device=q.device)[:, None]
        k_pos = k_off + torch.arange(sk, device=q.device)[None, :]
        logits = torch.where(q_pos >= k_pos, logits, _NEG)
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype), v).float()
    return o, m, l


def _step(q, kv, o, m, l, q_off: int, k_off: int, causal: bool,
          scale: float):
    """Attend to the held block and merge it into (o, m, l)."""
    ob, mb, lb = _block_attend(q, kv[0], kv[1], q_off, k_off, causal, scale)
    m_new = torch.maximum(m, mb)
    alpha = torch.exp(m - m_new)
    beta = torch.exp(mb - m_new)
    o = o * alpha[..., None] + ob * beta[..., None]
    l = l * alpha + lb * beta
    return o, m_new, l


def _shift(x: torch.Tensor, group, send_to: int, recv_from: int
           ) -> torch.Tensor:
    import torch.distributed as dist

    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, send_to, group),
           dist.P2POp(dist.irecv, out, recv_from, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """`x` sent to the next rank of the ring and the previous rank's
    received (global ranks `send_to`, `recv_from`); the gradient goes the
    other way."""

    @staticmethod
    def forward(ctx, x, group, send_to, recv_from):
        ctx.group, ctx.peers = group, (send_to, recv_from)
        return _shift(x.contiguous(), group, send_to, recv_from)

    @staticmethod
    def backward(ctx, grad):
        send_to, recv_from = ctx.peers
        return (_shift(grad.contiguous(), ctx.group, recv_from, send_to),
                None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group, *, causal: bool = True,
                   sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention of this rank's query block against the whole sequence,
    its K/V passed around the ring of `group` (the sp group). q, k, v:
    local blocks [batch, heads, seq/sp, head_dim], K/V heads repeated to
    the query's; returns the local output block in q's dtype."""
    import torch.distributed as dist

    n = dist.get_world_size(group)
    idx = dist.get_group_rank(group, dist.get_rank())
    ranks = dist.get_process_group_ranks(group)
    send_to, recv_from = ranks[(idx + 1) % n], ranks[(idx - 1) % n]
    sq = q.shape[-2]
    scale = sm_scale if sm_scale is not None else 1.0 / (q.shape[-1] ** 0.5)
    q_off = idx * sq
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    m = torch.full(q.shape[:-1], _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros(q.shape[:-1], dtype=torch.float32, device=q.device)
    kv = torch.stack([k, v])
    for s in range(n):
        # the held block started life on rank (idx - s) mod n
        k_off = ((idx - s) % n) * sq
        o, m, l = torch.utils.checkpoint.checkpoint(
            _step, q, kv, o, m, l, q_off, k_off, causal, scale,
            use_reentrant=False)
        if s + 1 < n:
            kv = _RingShift.apply(kv, group, send_to, recv_from)
    out = o / l.clamp_min(1e-30)[..., None]
    return out.to(q.dtype)
