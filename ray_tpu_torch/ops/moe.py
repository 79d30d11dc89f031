"""Mixture-of-Experts FFN (twin of ray_tpu/ops/moe.py): GShard-style top-2
gating with a static expert capacity and the dense dispatch/combine
contractions over stacked expert weights `[E, ...]`.

The capacity comes from shapes alone, `max(1, int(capacity_factor·T/E))`
with T every row of the call, and the routing is tensor arithmetic on the
device (argmax, running counts, one-hot masks): nothing reads a value back
to the host, so a caller that dispatches ahead of the device never waits
here. A token beyond its expert's capacity is dropped: its one-hot slot is
multiplied by `keep` = 0, as the reference's is. The contractions without a
batch dimension (the router product and the dispatch) go through
`named_matmul`, the ones the reference's `dots` remat policy saves; the
per-expert products are batched over E.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ray_tpu_torch.ops.layers import swiglu
from ray_tpu_torch.ops.remat import named_matmul


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """float32 one-hot over a new last axis of size n (jax.nn.one_hot)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).float()


def top2_gating(router_logits: torch.Tensor, capacity: int
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """router_logits [T, E] -> (dispatch [T, E, C] 0/1 float32, combine
    [T, E, C] float32, aux_loss float32 scalar), term for term as the
    reference: the pair of largest probabilities (ties to the first index)
    renormalised, first choices queued by a running count, second choices
    queued after all first choices, and the Switch/GShard load-balancing
    loss over the top-1 density."""
    T, E = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)

    idx1 = probs.argmax(dim=-1)                                  # [T]
    p1 = probs.gather(-1, idx1[:, None])[:, 0]
    masked = probs * (1.0 - _one_hot(idx1, E))
    idx2 = masked.argmax(dim=-1)
    p2 = masked.gather(-1, idx2[:, None])[:, 0]

    denom = torch.clamp(p1 + p2, min=1e-9)
    w1, w2 = p1 / denom, p2 / denom

    mask1 = _one_hot(idx1, E)                                    # [T, E]
    pos1 = (torch.cumsum(mask1, dim=0) - 1.0) * mask1
    mask2 = _one_hot(idx2, E)
    pos2 = (torch.cumsum(mask2, dim=0) + mask1.sum(dim=0, keepdim=True)
            - 1.0) * mask2

    keep1 = (pos1 < capacity).float() * mask1
    keep2 = (pos2 < capacity).float() * mask2

    def scatter(keep, pos, w):
        # [T, E] keep/pos + [T] weight -> [T, E, C]; a dropped token's
        # clipped slot is zeroed by keep before anything is added
        pos_idx = torch.clamp(pos, 0, capacity - 1).long()
        onehot_c = _one_hot(pos_idx, capacity) * keep[..., None]
        return onehot_c * w[:, None, None]

    combine = scatter(keep1, pos1, w1) + scatter(keep2, pos2, w2)
    dispatch = (combine > 0).float()

    density = mask1.mean(dim=0)                                  # [E]
    density_proxy = probs.mean(dim=0)
    aux_loss = (density * density_proxy).sum() * (E * E) / E
    return dispatch, combine, aux_loss


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor,
            capacity_factor: float = 1.25
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE SwiGLU FFN. x [B, S, d]; router_w [d, E]; expert weights stacked
    [E, d, ff] / [E, ff, d]. Returns (out [B, S, d], aux_loss)."""
    B, S, d = x.shape
    E = router_w.shape[-1]
    T = B * S
    capacity = max(1, int(capacity_factor * T / E))
    xt = x.reshape(T, d)

    router_logits = named_matmul(xt.float(), router_w.float(), "moe_router")
    dispatch, combine, aux = top2_gating(router_logits, capacity)

    # dispatch tokens to experts: [E, C, T] @ [T, d] -> [E, C, d]
    expert_in = named_matmul(dispatch.to(x.dtype).permute(1, 2, 0), xt,
                             "moe_dispatch")
    gate = torch.bmm(expert_in, w_gate)
    up = torch.bmm(expert_in, w_up)
    expert_out = torch.bmm(swiglu(gate, up), w_down)             # [E, C, d]
    # combine back: [T, E·C] @ [E·C, d]
    out = (combine.to(x.dtype).reshape(T, -1)
           @ expert_out.reshape(-1, d))
    return out.reshape(B, S, d), aux
