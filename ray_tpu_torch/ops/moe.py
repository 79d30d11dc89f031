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
per-expert products are batched over E (`torch.bmm`: there is no TPU
kernel on the expert path, the reference's einsums go to XLA).

Over a mesh (`par` from the sharded step) `moe_ffn` computes the same
function of the global batch, as GSPMD keeps the reference's meaning on
any mesh; the reference has no hand-written counterpart of this part (its
rules map "expert" to fsdp and GSPMD places the collectives), so the
port writes it with `parallel/expert.py`'s collectives:
- the float32 router logits of this rank's tokens are gathered into the
  global batch's token order (`b·S + s`), and every rank routes the same
  global `[T, E]` with the global capacity (`_route`), keeping only its own
  rows of dispatch and combine (`_slots`): the global `[T, E, C]` tensors
  are never built;
- this rank's partial `[E, C, d]` expert inputs (its tokens' slots) are
  summed over the data ranks, each fsdp rank receiving its own experts
  (`dispatch_to_experts`), whose SwiGLU runs on all C slots with d_ff
  split over tp (`copy_to_tp` on the input, `reduce_from_tp` on the
  `w_down` product: the router never passes through `copy_to_tp`, its
  branch being replicated over tp);
- the expert outputs are gathered over fsdp (`gather_experts`) for the
  combine of this rank's rows;
- the aux loss is the global one on every rank; the sharded step's token
  shares, which sum to 1 over the data ranks, count it once in the summed
  loss.
With no mesh (`SINGLE`) every collective is the identity and this is the
unsharded function, bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ray_tpu_torch.ops.layers import swiglu
from ray_tpu_torch.ops.remat import named_matmul
from ray_tpu_torch.parallel.expert import (dispatch_to_experts,
                                           gather_experts, gather_tokens,
                                           token_block)
from ray_tpu_torch.parallel.tensor import (SINGLE, Parallel, copy_to_tp,
                                           reduce_from_tp)


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
    loss over the top-1 density. `local_gating` with no mesh."""
    return local_gating(router_logits[None], capacity, SINGLE)


def _route(router_logits: torch.Tensor, capacity: int):
    """`top2_gating` on [T, E] before the one-hot over C: (keep1 [T, E],
    pos1 [T, E], w1 [T], keep2, pos2, w2, aux_loss). A token's rows depend
    on every earlier token (the queue positions) and the aux loss on all
    of them; `_slots` then needs only the rows it builds."""
    T, E = router_logits.shape
    probs = torch.softmax(router_logits.float(), dim=-1)

    idx1, idx2 = _choose(probs)                                  # [T] each
    p1 = probs.gather(-1, idx1[:, None])[:, 0]
    masked = probs * (1.0 - _one_hot(idx1, E))
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

    density = mask1.mean(dim=0)                                  # [E]
    density_proxy = probs.mean(dim=0)
    aux_loss = (density * density_proxy).sum() * (E * E) / E
    return keep1, pos1, w1, keep2, pos2, w2, aux_loss


def _choose(probs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each token's two experts [T]: the largest probability, then the
    largest of the others (ties to the first index)."""
    idx1 = probs.argmax(dim=-1)
    masked = probs * (1.0 - _one_hot(idx1, probs.shape[-1]))
    return idx1, masked.argmax(dim=-1)


def _slots(keep1, pos1, w1, keep2, pos2, w2, *, capacity: int):
    """(dispatch, combine) [T, E, C] of `_route`'s rows."""

    def scatter(keep, pos, w):
        # [T, E] keep/pos + [T] weight -> [T, E, C]; a dropped token's
        # clipped slot is zeroed by keep before anything is added
        pos_idx = torch.clamp(pos, 0, capacity - 1).long()
        onehot_c = _one_hot(pos_idx, capacity) * keep[..., None]
        return onehot_c * w[:, None, None]

    combine = scatter(keep1, pos1, w1) + scatter(keep2, pos2, w2)
    dispatch = (combine > 0).float()
    return dispatch, combine


def local_gating(router_logits: torch.Tensor, capacity: int,
                 par: Parallel
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`top2_gating` of the global batch, this rank's rows: its router
    logits [B, S, E] gathered into the global [T, E] in the global token
    order, routed with `capacity` (the global one), and (dispatch [B·S, E,
    C], combine [B·S, E, C], the global aux loss) of its own tokens. With
    no mesh (`SINGLE`) its tokens are the batch."""
    B, S, E = router_logits.shape
    logits = gather_tokens(router_logits, par)
    rows, seq = logits.shape[:2]
    *choices, aux = _route(logits.reshape(rows * seq, E), capacity)
    b0, s0 = token_block(par, B, S)

    def local(t):  # this rank's rows of a [T, ...] routing tensor
        t = t.reshape(rows, seq, *t.shape[1:])[b0:b0 + B, s0:s0 + S]
        return t.reshape(B * S, *t.shape[2:])

    dispatch, combine = _slots(*map(local, choices), capacity=capacity)
    return dispatch, combine, aux


def moe_ffn(x: torch.Tensor, router_w: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor,
            capacity_factor: float = 1.25, par: Parallel = SINGLE
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """MoE SwiGLU FFN. x [B, S, d]; router_w [d, E]; expert weights stacked
    [E, d, ff] / [E, ff, d]. Returns (out [B, S, d], aux_loss). Over a
    mesh (`par`), x is this rank's block of tokens, the expert weights its
    `[E/fsdp, ...]` experts with d_ff split over tp, and the function is
    the global batch's (module docstring); with no mesh every collective
    is the identity."""
    B, S, d = x.shape
    E = router_w.shape[-1]
    T = B * S * par.dp * par.fsdp * par.sp                # the global T
    capacity = max(1, int(capacity_factor * T / E))
    xt = x.reshape(B * S, d)

    router_logits = named_matmul(xt.float(), router_w.float(), "moe_router")
    dispatch, combine, aux = local_gating(router_logits.reshape(B, S, E),
                                          capacity, par)
    # this rank's tokens to their slots: [E, C, T_local] @ [T_local, d]
    partial = named_matmul(dispatch.to(x.dtype).permute(1, 2, 0), xt,
                           "moe_dispatch")
    expert_in = copy_to_tp(dispatch_to_experts(partial, par), par.tp_group)
    gate = torch.bmm(expert_in, w_gate)
    up = torch.bmm(expert_in, w_up)
    expert_out = reduce_from_tp(torch.bmm(swiglu(gate, up), w_down),
                                par.tp_group)              # [E/fsdp, C, d]
    expert_out = gather_experts(expert_out, par)           # [E, C, d]
    # combine back: [T_local, E·C] @ [E·C, d]
    out = (combine.to(x.dtype).reshape(B * S, -1)
           @ expert_out.reshape(-1, d))
    return out.reshape(B, S, d), aux
