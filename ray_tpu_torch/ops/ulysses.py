"""Ulysses sequence parallelism (twin of ray_tpu/ops/ulysses.py): an
all-to-all re-splits the sequence-split activations by heads, plain
attention runs on the full sequence and this rank's heads, and a second
all-to-all splits the output by sequence again.

Each all-to-all is `_AllToAll` over the sp group: `all_to_all_single` of
equal blocks, whose transpose is the same exchange, so its backward runs
it again on the gradient. Between them `ops.attention.attention` runs on
`[batch, heads/sp, seq, head_dim]`: on a CUDA tensor at head_dim >= 128
and seq >= 128 that launches the ported flash forward and backward
kernels, as the reference's `attention()` gate does
(ray_tpu/ops/attention.py:64). GQA: the KV heads cross the all-to-all
unexpanded, repeated only to the least multiple of sp
(`_repeat_kv_to_multiple`), and `attention` repeats them to the query's
count after the exchange. The query's local head count must be a multiple
of sp (a ValueError otherwise, as the reference).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ray_tpu_torch.ops.attention import attention


def _repeat_kv_to_multiple(t: torch.Tensor, sp: int) -> torch.Tensor:
    """Repeat KV heads (adjacently, GQA grouping order) by the least factor
    that makes the head count divisible by sp."""
    h = t.shape[1]
    if h % sp == 0:
        return t
    rep = sp // math.gcd(h, sp)
    b, _, s, d = t.shape
    return t[:, :, None].expand(b, h, rep, s, d).reshape(b, h * rep, s, d)


class _AllToAll(torch.autograd.Function):
    """`all_to_all_single` of `x`'s equal dim-0 blocks over `group`: block
    j goes to rank j, and rank i's block lands at i."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group), None


def _exchange(x: torch.Tensor, group) -> torch.Tensor:
    import torch.distributed as dist

    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def _scatter_heads(t: torch.Tensor, group, sp: int) -> torch.Tensor:
    """[b, h, s/sp, d] -> [b, h/sp, s, d]: head block j to sp rank j, the
    sequence blocks received concatenated in rank order."""
    b, h, s, d = t.shape
    x = t.reshape(b, sp, h // sp, s, d).transpose(0, 1)
    y = _AllToAll.apply(x, group)            # [sp (source), b, h/sp, s, d]
    return y.permute(1, 2, 0, 3, 4).reshape(b, h // sp, sp * s, d)


def _gather_heads(t: torch.Tensor, group, sp: int) -> torch.Tensor:
    """[b, h/sp, s, d] -> [b, h, s/sp, d]: sequence block j to sp rank j,
    the head blocks received concatenated in rank order."""
    b, hl, s, d = t.shape
    x = t.reshape(b, hl, sp, s // sp, d).permute(2, 0, 1, 3, 4)
    y = _AllToAll.apply(x, group)            # [sp (source), b, h/sp, s/sp, d]
    return y.transpose(0, 1).reshape(b, sp * hl, s // sp, d)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group, *, causal: bool = True,
                      sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention of this rank's sequence block over the whole sequence.
    q [b, h, s/sp, d], k/v [b, kv_heads, s/sp, d] (local blocks of the sp
    `group`); returns [b, h, s/sp, d]."""
    import torch.distributed as dist

    sp = dist.get_world_size(group)
    h = q.shape[1]
    if h % sp != 0:
        raise ValueError(f"local Q head count {h} not divisible by sp={sp}")
    k = _repeat_kv_to_multiple(k, sp)
    v = _repeat_kv_to_multiple(v, sp)
    q, k, v = (_scatter_heads(t, group, sp) for t in (q, k, v))
    out = attention(q, k, v, causal=causal, sm_scale=sm_scale)
    return _gather_heads(out, group, sp)
