"""Expert parallelism's collectives, written out. The reference has no
hand-written counterpart: its rules map the logical "expert" axis to fsdp
(ray_tpu/parallel/mesh.py:168), and GSPMD derives these collectives from
that annotation and `moe_ffn`'s einsums over the global batch
(ray_tpu/ops/moe.py:66-92). The port writes them, so that the sharded
`moe_ffn` (ops/moe.py) computes the reference's function of the global
batch term for term:

- `gather_tokens`: the float32 router logits of this rank's tokens
  `[B, S, E]` gathered into the global batch's `[B·dp·fsdp, S·sp, E]`, over
  every axis that holds other tokens: sp (positions), then fsdp and dp
  (rows, dp-major, as the batch is split). tp ranks hold the same tokens
  and take no part. Every rank then routes the same global tokens, with
  the global capacity and queue order. Backward: the gradient summed over
  those axes (each rank's loss reads the global logits through its own
  rows and through the global aux loss), then this rank's block.
- `dispatch_to_experts`: the partial `[E, C, d]` expert inputs a rank
  builds from its own tokens, summed over the data ranks (exact: every
  capacity slot holds at most one token, so the other ranks add zeros):
  reduce-scattered over fsdp along E, so that fsdp rank j gets the experts
  it holds (E/fsdp, those of its block of the expert leaves), then
  all-reduced over sp and dp. Backward: its transpose, the gradient
  all-reduced over dp and sp, then all-gathered over fsdp.
- `gather_experts`: the expert outputs `[E/fsdp, C, d]` of this rank's
  experts all-gathered over fsdp along E, for the combine of its own
  tokens. Backward: a summing reduce-scatter over fsdp.

`Parallel` (parallel/tensor.py) carries the groups; a mesh's groups are
always held, so a one-rank mesh runs every collective (each a copy).
Without a mesh (`SINGLE`, no groups) each function returns its input.
All collectives run on torch's current stream; on the card they go
through NCCL (the step refuses another backend). Each runs inside a
`torch.profiler.record_function` range named `ep/<collective>` (and
`ep/<collective>_bwd` in the backward), so that a profile can split the
NCCL time among them (`bench.profile_train`'s
`ep_collective_ms_per_step`); outside a profile a range costs a few
microseconds.
"""

from __future__ import annotations

import torch
from torch.profiler import record_function


def _dist():
    import torch.distributed as dist

    return dist


def _all_gather(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The blocks of `x` along `dim` from the `n` ranks of `group`, in rank
    order (gathered along dim 0, then moved into place)."""
    out = torch.empty((n * x.shape[0], *x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _dist().all_gather_into_tensor(out, x.contiguous(), group=group)
    if dim == 0:
        return out
    return out.unflatten(0, (n, x.shape[0])).movedim(0, dim).flatten(
        dim, dim + 1)


def _all_reduce(x: torch.Tensor, *groups) -> torch.Tensor:
    """`x` summed over each group in turn, in place."""
    for group in groups:
        _dist().all_reduce(x, group=group)
    return x


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par):
        ctx.par = par
        ctx.block = x.shape[:2]
        with record_function("ep/router_gather"):
            y = _all_gather(x, 1, par.sp_group, par.sp)
            y = _all_gather(y, 0, par.fsdp_group, par.fsdp)
            return _all_gather(y, 0, par.dp_group, par.dp)

    @staticmethod
    def backward(ctx, grad):
        par = ctx.par
        with record_function("ep/router_gather_bwd"):
            grad = _all_reduce(grad.contiguous().clone(), par.dp_group,
                               par.fsdp_group, par.sp_group)
        b0, s0 = token_block(par, *ctx.block)
        b, s = ctx.block
        return grad[b0:b0 + b, s0:s0 + s].contiguous(), None


class _DispatchToExperts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par):
        ctx.par = par
        x = x.contiguous()
        out = torch.empty((x.shape[0] // par.fsdp, *x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        with record_function("ep/dispatch_reduce_scatter"):
            _dist().reduce_scatter_tensor(out, x, group=par.fsdp_group)
        with record_function("ep/dispatch_all_reduce"):
            return _all_reduce(out, par.sp_group, par.dp_group)

    @staticmethod
    def backward(ctx, grad):
        par = ctx.par
        with record_function("ep/dispatch_all_reduce_bwd"):
            grad = _all_reduce(grad.contiguous().clone(), par.dp_group,
                               par.sp_group)
        with record_function("ep/dispatch_reduce_scatter_bwd"):
            return _all_gather(grad, 0, par.fsdp_group, par.fsdp), None


class _GatherExperts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, par):
        ctx.par = par
        with record_function("ep/combine_all_gather"):
            return _all_gather(x, 0, par.fsdp_group, par.fsdp)

    @staticmethod
    def backward(ctx, grad):
        par = ctx.par
        grad = grad.contiguous()
        out = torch.empty((grad.shape[0] // par.fsdp, *grad.shape[1:]),
                          dtype=grad.dtype, device=grad.device)
        with record_function("ep/combine_all_gather_bwd"):
            _dist().reduce_scatter_tensor(out, grad, group=par.fsdp_group)
        return out, None


def token_block(par, rows: int, seq: int) -> tuple:
    """(first row, first position) of this rank's `[rows, seq]` block of
    tokens in the global batch: rows split over (dp, fsdp) dp-major,
    positions over sp (`train.step.shard_batch`)."""
    return (par.dp_rank * par.fsdp + par.fsdp_rank) * rows, par.sp_rank * seq


def gather_tokens(x: torch.Tensor, par) -> torch.Tensor:
    """This rank's `[B, S, ...]` block -> the global `[B·dp·fsdp, S·sp,
    ...]`, the same on every data rank (module docstring)."""
    return x if par.fsdp_group is None else _GatherTokens.apply(x, par)


def dispatch_to_experts(x: torch.Tensor, par) -> torch.Tensor:
    """Partial `[E, C, d]` -> this fsdp rank's experts `[E/fsdp, C, d]`,
    summed over the data ranks (module docstring)."""
    return x if par.fsdp_group is None else _DispatchToExperts.apply(x, par)


def gather_experts(x: torch.Tensor, par) -> torch.Tensor:
    """This fsdp rank's experts `[E/fsdp, C, d]` -> all `[E, C, d]`."""
    return x if par.fsdp_group is None else _GatherExperts.apply(x, par)
