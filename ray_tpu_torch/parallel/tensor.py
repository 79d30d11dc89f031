"""Tensor parallelism's collectives, written out. The reference has no
twin of this module: there GSPMD inserts these collectives from the
sharding annotations of `DEFAULT_RULES` (heads, mlp and vocab over tp,
ray_tpu/parallel/mesh.py:159-169), and only the sequence-parallel
attention is written by hand (ops/ring_attention.py, ops/ulysses.py).

A split projection takes the full (replicated) input on every tp rank and
its own block of the weight's output columns, so every product after it
is a partial sum over tp until the next contraction over the split dim:

- `copy_to_tp`: the identity forward, an all-reduce of the gradient over
  tp backward. It goes on the normed input of each split projection (and
  on the features before the vocab-split head): each rank's gradient of
  that input is a partial sum over its columns.
- `reduce_from_tp`: an all-reduce forward, the identity backward. It goes
  on the output of `wo` and of `w_down` (the contraction over the split
  dim), before the residual add, so the residual stream stays replicated
  over tp and so does its gradient.
- `vocab_embed`: the embedding lookup on a `[V/tp, d]` block: a masked
  gather of the rows this rank holds, then `reduce_from_tp` (every token's
  row is held by exactly one rank, the others add zeros: exact).
- `vocab_nll`: the next-token NLL of `[..., V/tp]` logit blocks: the row
  max all-reduced (max), then the sum of exps (sum), the target's logit
  from the rank that holds it (sum); its backward is softmax minus one-hot
  on the local block, each rank's part of the full gradient. Plain
  PyTorch, as `token_nll` is.

`Parallel` is what the model's forward needs of a mesh: the fsdp gather
(`parallel.fsdp.FSDP.gather`), and the tp, sp, fsdp and dp groups with
this rank's place in them. `SINGLE` is one device: no gather, no group. A
tp group is held only when tp > 1, so a mesh with tp = 1 runs the unsplit
model; the sp, fsdp and dp groups are always held, for the
sequence-parallel attention and the expert-parallel MoE
(`parallel/expert.py`), whose router sees every data rank's tokens.

All collectives run on torch's current stream; on the card they go
through NCCL (the step refuses another backend).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch


def _dist():
    import torch.distributed as dist

    return dist


def _whole(path: str, t: Any) -> Any:
    return t


@dataclasses.dataclass(frozen=True)
class Parallel:
    """The mesh as the forward sees it (see the module docstring)."""
    gather: Callable[[str, Any], Any] = _whole
    tp_group: Any = None      # None when tp == 1
    tp: int = 1
    tp_rank: int = 0
    sp_group: Any = None      # None without a mesh
    sp: int = 1
    sp_rank: int = 0
    fsdp_group: Any = None    # None without a mesh
    fsdp: int = 1
    fsdp_rank: int = 0
    dp_group: Any = None      # None without a mesh
    dp: int = 1
    dp_rank: int = 0

    @classmethod
    def from_mesh(cls, mesh, gather: Callable[[str, Any], Any] = _whole
                  ) -> "Parallel":
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        tp = sizes["tp"]
        held = {f"{axis}{suffix}": value for axis in ("sp", "fsdp", "dp")
                for suffix, value in (("_group", mesh.get_group(axis)),
                                      ("", sizes[axis]),
                                      ("_rank", mesh.get_local_rank(axis)))}
        return cls(gather=gather,
                   tp_group=mesh.get_group("tp") if tp > 1 else None, tp=tp,
                   tp_rank=mesh.get_local_rank("tp"), **held)


SINGLE = Parallel()


def all_reduce_(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """`t` reduced over `group` in place (a no-op without a group)."""
    if group is not None:
        dist = _dist()
        dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM,
                               "max": dist.ReduceOp.MAX}[op], group=group)
    return t


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.contiguous().clone(), ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce_(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """Identity forward, gradient summed over tp backward; `x` itself
    without a group."""
    return x if group is None else _CopyToTP.apply(x, group)


def reduce_from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """`x` summed over tp forward, gradient as it is backward; `x` itself
    without a group."""
    return x if group is None else _ReduceFromTP.apply(x, group)


def vocab_embed(emb: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype,
                group, rank: int) -> torch.Tensor:
    """The rows of `tokens` from this rank's `[V/tp, d]` block of the
    embedding (rank r holds rows r·V/tp ...), summed over tp: each token's
    row comes from the rank that holds it, zeros from the others."""
    n = emb.shape[0]
    local = tokens - rank * n
    held = (local >= 0) & (local < n)
    rows = emb[local.clamp(0, n - 1)] * held[..., None].to(emb.dtype)
    return reduce_from_tp(rows, group).to(dtype)


class _VocabNLL(torch.autograd.Function):
    """-log softmax(logits)[target] over a vocab split across tp: `logits`
    [..., V/tp] float32 (rank r's columns r·V/tp ...), targets [...]."""

    @staticmethod
    def forward(ctx, logits, targets, group, rank):
        n = logits.shape[-1]
        m = all_reduce_(logits.amax(dim=-1), group, "max")
        e = torch.exp(logits - m[..., None])
        sumexp = all_reduce_(e.sum(dim=-1), group)
        local = targets.long() - rank * n
        held = (local >= 0) & (local < n)
        local = local.clamp(0, n - 1)
        tgt = logits.gather(-1, local[..., None])[..., 0] * held
        tgt = all_reduce_(tgt, group)
        nll = torch.log(sumexp) + m - tgt
        e.div_(sumexp[..., None])                   # the local softmax
        ctx.save_for_backward(e, local, held)
        return nll

    @staticmethod
    def backward(ctx, dnll):
        softmax, local, held = ctx.saved_tensors
        grad = softmax * dnll[..., None]
        grad.scatter_add_(-1, local[..., None],
                          -(dnll * held)[..., None].to(grad.dtype))
        return grad, None, None, None


def vocab_nll(logits: torch.Tensor, targets: torch.Tensor, group,
              rank: int) -> torch.Tensor:
    """Per-token NLL [...] of vocab-split float32 logits [..., V/tp]."""
    return _VocabNLL.apply(logits, targets, group, rank)


def check_split(cfg, tp: int) -> None:
    """Raise a ValueError naming the first of n_heads, n_kv_heads, d_ff and
    vocab_size that tp does not split. tp splits n_heads, d_ff and
    vocab_size in equal blocks; n_kv_heads too, or, with fewer KV heads
    than tp ranks, where n_kv_heads divides tp and tp divides
    n_kv_heads·head_dim (wk/wv's columns, GSPMD's even split): each rank's
    query heads then read one KV head, gathered over tp (`kv_projection`).
    The reference's step runs every layout GSPMD can split; the port's
    plan refuses the same ones the reference's does
    (ray_tpu/models/planning.py:59-62)."""
    for name in ("n_heads", "n_kv_heads", "d_ff", "vocab_size"):
        dim = getattr(cfg, name)
        if not dim % tp or (name == "n_kv_heads" and kv_gathered(cfg, tp)):
            continue
        raise ValueError(
            f"tp={tp} does not divide {name}={dim}: the port splits heads, "
            f"mlp and vocab over tp in equal blocks, and gathers K/V over "
            f"tp only where n_kv_heads divides tp and tp divides "
            f"n_kv_heads*head_dim (other layouts: ROADMAP.md queue A item "
            f"7.5)")


def kv_gathered(cfg, tp: int) -> bool:
    """Whether tp holds fewer KV heads than ranks in the layout the port
    runs: n_kv_heads divides tp, tp divides n_kv_heads·head_dim."""
    kv = cfg.n_kv_heads
    return (kv < tp and not tp % kv
            and not (kv * cfg.head_dim) % tp)


def local_heads(cfg, par: Parallel) -> tuple:
    """(query heads, KV heads) this rank computes: one KV head where tp
    holds fewer KV heads than ranks."""
    return cfg.n_heads // par.tp, max(cfg.n_kv_heads // par.tp, 1)


def kv_projection(w: torch.Tensor, cfg, par: Parallel) -> torch.Tensor:
    """The `wk` or `wv` columns this rank projects with. Where tp splits
    the KV heads, `w` itself (this rank's `[d, n_kv_heads·head_dim/tp]`
    block). Where it holds fewer KV heads than ranks, `w` stays split over
    tp on its columns as the reference's rules lay it out (so checkpoints
    and their reshards are unchanged); here it is gathered over tp (an
    all-gather forward, a summing reduce-scatter of its gradient
    backward) and cut to the head_dim columns of the one KV head this
    rank's query heads read (head `tp_rank // (tp / n_kv_heads)`). The
    ranks that share a KV head sum their gradients of it."""
    if par.tp_group is None or not kv_gathered(cfg, par.tp):
        return w
    from ray_tpu_torch.parallel.fsdp import _Gather

    full = _Gather.apply(w, w.dim() - 1, par.tp_group, par.tp)
    head = par.tp_rank // (par.tp // cfg.n_kv_heads)
    hd = cfg.head_dim
    return full[..., head * hd:(head + 1) * hd]
