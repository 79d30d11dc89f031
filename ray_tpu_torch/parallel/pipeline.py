"""Pipeline parallelism (twin of ray_tpu/parallel/pipeline.py): GPipe over
the `pp` mesh axis, composed with dp, fsdp and tp.

The layer-stacked leaves are split over pp (`PP_RULES`, the reference's
rules with "layers" on pp), so each stage holds L/pp contiguous layers;
every other leaf is laid out as in the sharded step and held by every
stage. Each rank runs its own stage of the schedule (`_GPipe`):

- **Forward.** At tick t (0 .. n_micro + pp - 2) stage r takes microbatch
  m = t - r: stage 0 embeds it, every other stage takes what its pp
  predecessor sent at the end of tick t - 1. The stage applies its layers
  (`_stage_fn`: `maybe_remat(_layer)` a layer, each leaf through
  `par.gather`, so fsdp's per-layer gather and its re-gather in the
  backward run inside a stage unchanged), and the last stage the final
  norm, the head and the loss. Each tick ends in one `batch_isend_irecv`
  over the pp group, between the same (dp, fsdp, tp) coordinates of
  neighbouring stages: the reference's `ppermute` shift. The reference
  computes garbage on the fill and drain ticks and never selects it
  (reference :84-91); here a stage skips those ticks, whose values never
  reach the loss.
- **Backward**, by hand: the mirror pipeline. Ticks run in reverse and
  stage r takes microbatch t - r again: one `torch.autograd.grad` over
  that microbatch's graph, from the loss's gradient on the last stage and
  from the gradient its successor sent on the others. It sends the
  gradient of its input [mb, s, d] to its predecessor, and adds the
  parameter gradients to those of the microbatches after it.
- **Loss.** The global mean over unmasked tokens, as `token_nll` gives it
  over [n_micro, mb, s, V] (reference :145-149): microbatch m's loss is
  `token_nll` of its tokens times its share of the rank's tokens, so the
  microbatches sum to the rank's mean, which the step scales by the
  rank's share of the global tokens as the sharded step does. The sum is
  all-reduced over pp: every rank holds the loss. Under tp the embedding
  and the head split the vocab (`vocab_embed`, `vocab_nll`).
- **Microbatches.** `n_micro` must divide the global batch of B rows (the
  reference's assertion, :126); each rank runs the microbatches whose
  rows it holds (its (dp, fsdp) block of b = B / (dp·fsdp) rows,
  `shard_batch`), cut by `micro_rows`. Where `n_micro` divides b, a rank
  cuts its own rows into `n_micro` microbatches of b / n_micro rows.
  Otherwise it takes the reference's global microbatches of B / n_micro
  rows (microbatch m is global rows [m·B/n_micro, (m+1)·B/n_micro)) and
  runs each one's part in its rows, in order: at dp 2 with 4 rows and
  n_micro 4, each rank runs 2 microbatches of 1 row. Every rank must then
  run as many as every other (each microbatch gathers the fsdp leaves).
  The loss is a global mean, so the split changes only the order of the
  sums.
- **Step.** `make_pp_train_step` is the sharded step (train/step.py) with
  `pp_loss_fn` for `loss_fn`: parallel/fsdp.py sums the gradients of the
  leaves every stage holds (only the first or the last stage's are not
  zero) over pp, and the norm's squares of the layer leaves over pp.

As in the reference: sp must be 1, MoE is refused, and the stage runs
`_layer` whatever `fused_ffn` and `fused_attn` say (:46), with whole
float32 logits whatever `loss_chunk` says (:128-134). All collectives run
on the current stream; on the card a hand-off goes through NCCL or fails.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional

import torch

from ray_tpu_torch.models.transformer import (ModelConfig, _layer,
                                              embed_tokens, gathered_layers,
                                              head_logits, maybe_remat,
                                              split_batch, token_nll,
                                              tree_leaves)
from ray_tpu_torch.ops.kernels._util import require_cuda
from ray_tpu_torch.ops.layers import rms_norm, rotary_embedding
from ray_tpu_torch.parallel.mesh import DEFAULT_RULES, AxisRules
from ray_tpu_torch.parallel.tensor import SINGLE, Parallel
from ray_tpu_torch.train.step import (_check_mesh, _sharded_step, _unflatten,
                                      default_optimizer, make_init_fn,
                                      state_shardings)

# The reference's rules with the layer stack split over pp (reference :176)
PP_RULES = AxisRules({**DEFAULT_RULES.rules, "layers": "pp"})


def _dist():
    import torch.distributed as dist

    return dist


@dataclasses.dataclass(frozen=True)
class Stages:
    """The pp group as this rank sees it: the group (None for one stage),
    the stage count, this rank's stage, and its neighbours' global ranks;
    and this rank's block of the batch's rows (`shard_batch`'s block
    `rows_index` of `rows_blocks`, the (dp, fsdp) ranks)."""
    group: Any = None
    n: int = 1
    index: int = 0
    prev: Optional[int] = None
    next: Optional[int] = None
    rows_index: int = 0
    rows_blocks: int = 1

    @classmethod
    def from_mesh(cls, mesh) -> "Stages":
        """This rank's stages of `mesh` (a collective over pp)."""
        names = mesh.mesh_dim_names
        fsdp = mesh.size(names.index("fsdp"))
        rows = {"rows_index": (mesh.get_local_rank("dp") * fsdp
                               + mesh.get_local_rank("fsdp")),
                "rows_blocks": mesh.size(names.index("dp")) * fsdp}
        n = mesh.size(names.index("pp"))
        if n == 1:
            return cls(**rows)
        dist = _dist()
        group = mesh.get_group("pp")
        ranks = dist.get_process_group_ranks(group)
        i = mesh.get_local_rank("pp")
        # NCCL leaves a group's first batch_isend_irecv undefined unless
        # every rank of the group joins it: a collective of all comes first
        dist.all_reduce(torch.zeros(1, device=mesh.device_type), group=group)
        return cls(group, n, i, ranks[i - 1] if i > 0 else None,
                   ranks[i + 1] if i + 1 < n else None, **rows)

    @property
    def first(self) -> bool:
        return self.index == 0

    @property
    def last(self) -> bool:
        return self.index == self.n - 1

    def hand_off(self, send: Optional[torch.Tensor], send_to: Optional[int],
                 recv: Optional[torch.Tensor], recv_from: Optional[int]
                 ) -> Optional[torch.Tensor]:
        """One tick's hand-off: `send` to global rank `send_to` and `recv`
        filled from `recv_from` in one batch_isend_irecv (either may be
        None); returns `recv`."""
        dist = _dist()
        ops = []
        if send is not None:
            ops.append(dist.P2POp(dist.isend, send, send_to, self.group))
        if recv is not None:
            ops.append(dist.P2POp(dist.irecv, recv, recv_from, self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return recv


def micro_rows(b: int, n_micro: int, index: int = 0, blocks: int = 1
               ) -> List[slice]:
    """The microbatches rank block `index` of `blocks` runs, as slices of
    its b rows (the module docstring's rule): `n_micro` of b / n_micro
    rows where `n_micro` divides b, else its parts of the global
    microbatches of B / n_micro rows. Raises ValueError where `n_micro`
    does not divide the global batch B = b·blocks, or where the blocks
    would run different numbers of microbatches."""
    B = b * blocks
    if B % n_micro:
        raise ValueError(f"the global batch of {B} rows is not divisible "
                         f"by n_micro {n_micro}")
    if b % n_micro == 0:
        mb = b // n_micro
        return [slice(m * mb, (m + 1) * mb) for m in range(n_micro)]
    mb = B // n_micro

    def cuts(i):
        lo, hi = i * b, (i + 1) * b
        edges = [lo, *range((lo // mb + 1) * mb, hi, mb), hi]
        return [slice(a - lo, z - lo) for a, z in zip(edges, edges[1:])]

    counts = {len(cuts(i)) for i in range(blocks)}
    if len(counts) > 1:
        raise ValueError(f"n_micro {n_micro} over {blocks} blocks of {b} "
                         f"rows gives the blocks {sorted(counts)} "
                         f"microbatches: each must run as many")
    return cuts(index)


def _stage_fn(cfg: ModelConfig, par: Parallel, layers_local: Dict[str, Any],
              x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
              ) -> torch.Tensor:
    """Apply this stage's L/pp layers to one microbatch [mb, s, d]."""
    layer = maybe_remat(functools.partial(_layer, cfg, par), cfg)
    for lp in gathered_layers(layers_local, par):
        x, _ = layer(x, lp, cos, sin)
    return x


def _final(params: Dict[str, Any], y: torch.Tensor, cfg: ModelConfig,
           par: Parallel) -> torch.Tensor:
    """The last stage's output -> float32 logits: the final norm and the
    head, as the dense forward applies them."""
    x = rms_norm(y, par.gather("final_norm", params["final_norm"]),
                 cfg.norm_eps)
    return head_logits(params, x, cfg, par)


class _GPipe:
    """One pass of the schedule (module docstring) on this rank over the
    microbatches of `inputs` [b, s] (`micro_rows`, `self.rows`): `forward`
    runs the ticks (keeping, to `record`, each microbatch's graph) and
    `backward` the mirror ticks. `last(params, m, y)` maps the last
    stage's output of microbatch m to what it yields."""

    def __init__(self, cfg: ModelConfig, par: Parallel, stages: Stages,
                 n_micro: int, inputs: torch.Tensor,
                 last: Callable[..., torch.Tensor]):
        b, s = inputs.shape
        self.rows = micro_rows(b, n_micro, stages.rows_index,
                               stages.rows_blocks)
        self.cfg, self.par, self.stages = cfg, par, stages
        self.n_micro, self.seq = len(self.rows), s
        self.inputs, self.last = inputs, last
        self.records: List[Any] = []

    def _ticks(self) -> range:
        return range(self.n_micro + self.stages.n - 1)

    def _takes(self, m: int) -> bool:
        return 0 <= m < self.n_micro

    def _activation(self, m: int) -> torch.Tensor:
        rows = self.rows[m]
        return torch.empty((rows.stop - rows.start, self.seq,
                            self.cfg.d_model),
                           dtype=self.cfg.dtype, device=self.inputs.device)

    def forward(self, params: Dict[str, Any], record: bool
                ) -> List[torch.Tensor]:
        """The forward ticks; the last stage's `last` values (detached) in
        microbatch order, [] on the other stages."""
        cfg, par, st = self.cfg, self.par, self.stages
        cos, sin = rotary_embedding(
            torch.arange(self.seq, device=self.inputs.device), cfg.head_dim,
            cfg.rope_theta)
        cos, sin = cos[None], sin[None]
        outputs: List[torch.Tensor] = []
        received = None
        for t in self._ticks():
            m, y = t - st.index, None
            if self._takes(m):
                with torch.set_grad_enabled(record):
                    if st.first:
                        x_in = None
                        x = embed_tokens(params, self.inputs[self.rows[m]],
                                         cfg, par)
                    else:
                        x = x_in = received.requires_grad_(record)
                    y = _stage_fn(cfg, par, params["layers"], x, cos, sin)
                    out = self.last(params, m, y) if st.last else y
                if record:
                    self.records.append((x_in, out))
                if st.last:
                    outputs.append(out.detach())
                del x, x_in, out
            # send what this stage made; take what it works on next tick
            received = st.hand_off(
                None if st.last or y is None else y.detach(), st.next,
                self._activation(t + 1 - st.index) if not st.first
                and self._takes(t + 1 - st.index) else None, st.prev)
        return outputs

    def backward(self, leaves: List[torch.Tensor], dloss: torch.Tensor
                 ) -> List[torch.Tensor]:
        """The mirror ticks over the recorded graphs: the gradient of the
        loss (`dloss` its cotangent) with respect to `leaves`, summed over
        the microbatches; zeros for a leaf this stage does not use."""
        st = self.stages
        grads: List[Optional[torch.Tensor]] = [None] * len(leaves)
        received = None
        for t in reversed(self._ticks()):
            m, dx = t - st.index, None
            if self._takes(m):
                x_in, out = self.records[m]
                self.records[m] = None
                inputs = ([] if x_in is None else [x_in]) + leaves
                got = list(torch.autograd.grad(
                    out, inputs, dloss if st.last else received,
                    allow_unused=True))
                if x_in is not None:
                    dx = got.pop(0)
                for i, g in enumerate(got):
                    if g is not None:
                        grads[i] = g if grads[i] is None else grads[i].add_(g)
                del x_in, out, got
            # send the input's gradient back; take the next one's
            received = st.hand_off(
                dx, st.prev,
                self._activation(t - 1 - st.index) if not st.last
                and self._takes(t - 1 - st.index) else None, st.next)
        return [torch.zeros_like(leaf) if g is None else g
                for leaf, g in zip(leaves, grads)]


class _Pipeline(torch.autograd.Function):
    """The pipeline's summed loss on every rank as a function of this
    rank's leaves (in `tree_leaves` order of `template`); its backward is
    the mirror pipeline."""

    @staticmethod
    def forward(ctx, pipe: _GPipe, template: Dict[str, Any], record: bool,
                *leaves: torch.Tensor) -> torch.Tensor:
        inner = [leaf.detach().requires_grad_(record) for leaf in leaves]
        outputs = pipe.forward(_unflatten(template, iter(inner)), record)
        st = pipe.stages
        loss = (torch.stack(outputs).sum() if outputs else torch.zeros(
            (), dtype=torch.float32, device=pipe.inputs.device))
        if st.n > 1:  # the last stage's loss to every stage
            _dist().all_reduce(loss, group=st.group)
        ctx.pipe, ctx.inner = pipe, inner
        return loss

    @staticmethod
    def backward(ctx, dloss: torch.Tensor):
        pipe, inner = ctx.pipe, ctx.inner
        ctx.pipe = ctx.inner = None
        return (None, None, None, *pipe.backward(inner, dloss))


def pipeline_blocks(cfg: ModelConfig, params: Dict[str, Any],
                    inputs: torch.Tensor, stages: Stages, n_micro: int,
                    last: Callable[..., torch.Tensor],
                    par: Parallel = SINGLE) -> List[torch.Tensor]:
    """The GPipe forward over the pp group (the module docstring's ticks):
    stage 0 embeds microbatch m of `inputs` [b, s], each stage applies its
    layers, the last stage `last(params, m, y)`; returns the last stage's
    values in microbatch order ([] on the other stages). Forward only:
    `pp_loss_fn` is the differentiable pipeline."""
    with torch.no_grad():
        return _GPipe(cfg, par, stages, n_micro, inputs, last).forward(
            params, record=False)


def pp_forward(params: Dict[str, Any], tokens: torch.Tensor,
               cfg: ModelConfig, stages: Stages, n_micro: int,
               par: Parallel = SINGLE) -> Optional[torch.Tensor]:
    """tokens [b, s] -> float32 logits [n, mb, s, vocab] of this rank's n
    microbatches of mb rows (`micro_rows`; under tp this rank's vocab
    block) on the last stage, None on the others. The embedding runs on
    stage 0, the final norm and the head on the last."""
    out = pipeline_blocks(cfg, params, tokens, stages, n_micro,
                          lambda p, m, y: _final(p, y, cfg, par), par)
    return torch.stack(out) if stages.last else None


def pp_loss_fn(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
               cfg: ModelConfig, stages: Stages, n_micro: int,
               par: Parallel = SINGLE):
    """Next-token cross entropy through the pipeline -> (loss, {"loss",
    "ntokens", "moe_aux"}): `loss_fn`'s batch forms and masking, dense
    layers only, the mean over this rank's unmasked tokens (the step scales
    it to the global mean), the same on every stage. Differentiable with
    respect to `params` (this rank's blocks) through the mirror pipeline;
    `moe_aux` is 0."""
    inputs, targets, mask = split_batch(batch)
    count = (mask.float().sum() if mask is not None else torch.full(
        (), float(targets.numel()), device=targets.device)).clamp_min(1.0)

    def last(p, m, y):
        rows = pipe.rows[m]
        t_m, k_m = targets[rows], None if mask is None else mask[rows]
        c_m = (k_m.float().sum() if k_m is not None else torch.full(
            (), float(t_m.numel()), device=t_m.device))
        return token_nll(_final(p, y, cfg, par), t_m, k_m, par) * (c_m / count)

    pipe = _GPipe(cfg, par, stages, n_micro, inputs, last)
    loss = _Pipeline.apply(pipe, params, torch.is_grad_enabled(),
                           *tree_leaves(params))
    return loss, {"loss": loss, "ntokens": targets.numel(),
                  "moe_aux": torch.zeros((), dtype=torch.float32,
                                         device=loss.device)}


def make_pp_train_step(cfg: ModelConfig, mesh, optimizer: Any = None,
                       n_micro: int = 4, device="cuda"):
    """Pipeline-parallel analog of `train.step.make_train_step`: returns
    (step_fn, init_fn, shardings), step_fn(state, batch) -> (state,
    metrics) with `batch` this rank's rows (`shard_batch`: over (dp,
    fsdp)), init_fn(seed) the unsharded init's draws, this rank's blocks
    kept, and shardings the state's (`state_shardings` over `PP_RULES`).
    The metrics are the sharded step's: `loss`, `grad_norm`, `step` (and
    `moe_aux`, 0). The mesh must have sp == 1; pp = 1 runs the schedule
    with one stage."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if sizes["sp"] != 1:
        raise ValueError("pipeline parallelism requires sp == 1 "
                         "(sequence parallelism composes with the non-pp "
                         "step)")
    if cfg.n_experts > 0:
        raise NotImplementedError("pp + MoE not yet supported")
    if cfg.n_layers % sizes["pp"]:
        raise ValueError(f"pp={sizes['pp']} does not divide n_layers="
                         f"{cfg.n_layers}: each stage holds L/pp layers")
    optimizer = optimizer or default_optimizer()
    dev = require_cuda(device)
    _check_mesh(cfg, mesh, dev)
    loss_of = functools.partial(pp_loss_fn, stages=Stages.from_mesh(mesh),
                                n_micro=n_micro)
    return (_sharded_step(cfg, optimizer, dev, None, mesh, PP_RULES, loss_of),
            make_init_fn(cfg, optimizer, dev, mesh=mesh, rules=PP_RULES),
            state_shardings(cfg, mesh, optimizer, PP_RULES))
