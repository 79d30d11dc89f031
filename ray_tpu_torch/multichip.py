"""The sharded training step on several cards: the dp/fsdp/tp/sp/pp part
of the reference's `dryrun_multichip` (__graft_entry__.py:45-174), run on
real cards at Llama-3-8B widths instead of jitted on a virtual mesh.

    python -m ray_tpu_torch.multichip --chips 4
    python -m ray_tpu_torch.multichip --chips 4 --cpu    # rehearsal: gloo, tiny

Spawns one rank a card (no torchrun needed; fails with fewer cards than
asked), each joining NCCL through `parallel.initialize_group`, and runs:

(a) parity: `bench.train_config_8b()` (8 layers), global batch chips x
    2048, 4 steps of `default_optimizer`, sharded fsdp=chips and dp=chips,
    against the unsharded step on the same batch (run first, on rank 0's
    card): step-1 loss within 1e-4 relative, step-1 grad norm within 1%,
    losses 2-4 within 1e-3; every kernel's launches each step those of the
    unsharded step (the flash kernels and K3 n_layers times).
(b) full depth: `ModelConfig.llama3_8b()` at 32 layers on the 8B plan's
    layout (fsdp=chips, max_seq_len 4096, loss_chunk 512, one 4096-token
    row a card), 6 steps under `default_optimizer` and then 6 under fused
    AdamW: finite losses, the last below the first; ms/step (steps 3-6),
    tokens/s a card, MFU (FLOPs as `bench.flops_per_token`), peak GiB a
    card, the profiler's collective ms/step over 2 more steps; the state's
    bytes a card equal `planning._budget`'s `local_bytes`; each beside
    the plan's projection.
(c) reshard: the 8-layer state after 2 steps at fsdp=chips saved
    (`save_checkpoint`, every rank its blocks) and restored onto
    dp 2 x fsdp chips/2, onto fsdp 2 x tp chips/2 and onto the pipeline at
    pp 2 x tp chips/2 (its rules: the layers over pp): every leaf bit for
    bit, on the target mesh; the next step's loss within 1e-6 relative of
    continuing at fsdp=chips (within (a)'s 1e-4 under tp, whose bf16
    partial sums add in another order, and on the pipeline, whose next
    step, n_micro 2, is held against the `_layer` path it runs, continued
    at fsdp=chips from the same checkpoint).
(d) collectives: `all_gather_into_tensor` and `reduce_scatter_tensor` over
    the fsdp group at the 8B layer shards' sizes, ms a call and GB/s
    (algorithm: the full tensor's bytes over the time; bus: times
    (n-1)/n), beside `planning.H100_NVLINK_BW`; and the tp all-reduce at a
    layer's activation size (4096 x 4096 bf16) over tp 2 and tp 4 (bus:
    times 2(n-1)/n).
(e) tp parity (four cards): the 8-layer 8B width at 4 x 2048, 4 steps of
    `default_optimizer`, against one card on the same batch, (a)'s bounds
    and launches: the reference plan's path (remat "dots", loss_chunk 512,
    no fused blocks) at tp 4 and at fsdp 2 x tp 2; the fused blocks at
    dp 2 x tp 2, and the all-kernel step there (fused AdamW, USE_K1 =
    USE_K2 = True). Then fewer KV heads than ranks (2 KV heads at tp 4,
    each rank's 8 query heads reading one KV head gathered over tp): the
    plan's path and the fused blocks at tp 4 against one card with 2 KV
    heads.
(f) sp parity (four cards): 8 layers at 1 x 8192, remat "dots",
    loss_chunk 512, against one card: sp 4 under Ulysses and under ring,
    tp 2 x sp 2 under Ulysses. Ulysses takes (a)'s bounds and launches;
    ring (a bf16 einsum where one card runs the flash kernels, which it
    never launches) a step-1 loss within 1e-3, grad norm within 2%,
    losses 2-4 within 5e-3.
(g) tp full depth (four cards): (b) on fsdp 2 x tp 2, 4 rows of 4096 a
    step ((b)'s 16384 tokens): the same checks and numbers, the collective
    ms/step split by NCCL operation (all-gather and reduce-scatter: fsdp;
    all-reduce: tp, and the fsdp all-reduce of the norms' gradients, a
    few hundred KB), beside `eightb_plan(n_chips=4, fsdp=2, tp=2)`.
(h) ep parity (four cards): Mixtral-8x7B's widths (`mixtral_config`) at 2
    layers, remat "dots", capacity factor 1.25, moe_aux_weight 0.02, 4 x
    2048 tokens, 4 steps of `default_optimizer` at fsdp 4 (2 experts a
    card), fsdp 2 x tp 2 and dp 2 x fsdp 2, then fsdp 4 under fused AdamW,
    each against one card on the same batch under the same optimizer, in
    float32 and in bf16. Every run records each token's two experts and
    kept bits at each step's forward (`_Routes`), and one card's step-1
    forward is rerun under each layout's step-1 routing. In bf16 a sum
    taken in another order (tp's all-reduces, the gradients'
    reduce-scatter) can flip a near-tied choice, and the capacity queue
    then moves other tokens, so the losses part by more than rounding.
    Checks: in float32, (a)'s bounds and step-1 moe_aux within 1e-4; in
    both dtypes, the one card's launches (flash forward 2·L, backward L,
    K1-K3 never, AdamW once a leaf under fused AdamW), and one card's
    forward under the layout's routing within 1e-4 of the layout's step-1
    loss and moe_aux. Logged beside them: the tokens whose first choice,
    second choice or kept bits differ from one card's, each step and
    layer. Per bf16 layout ms/step (steps 2-4), tokens/s, peak GiB a card
    and, over 2 more profiled steps, the NCCL ms/step by operation and by
    expert-parallel collective (router gather, dispatch reduce-scatter and
    all-reduce, combine all-gather, each forward and backward). With
    --cpu: `tiny_moe` at the same layouts, then the dryrun's MoE step
    (__graft_entry__.py:103-123; fsdp 2 x sp 2 under Ulysses here, one
    step, a finite loss).
(i) ep depth (four cards): Mixtral-8x7B's widths at 8 of 32 layers on
    fsdp 4, 4 x 2048 tokens, 6 steps of `default_optimizer` then 6 of fused
    AdamW: finite losses, the last below the first, each card's state
    bytes equal `planning._local_bytes` over the rules; ms/step (steps
    3-6), tokens/s a card, MFU over the active and over all parameters,
    peak GiB a card, NCCL ms/step by operation. If the 8 layers peak below
    45 GiB, 16 layers are tried under `default_optimizer` (4 steps) when
    the 8-layer peak plus its state predicts them below 72 GiB; what was
    predicted, and what ran, is reported either way.
(j) pp parity (four cards): the pipeline (`parallel/pipeline.py`) on
    `bench.train_config_8b()` (8 layers) with the fused blocks off (the
    stage runs `_layer`), remat "dots", whole logits, 4 x 2048, 4 steps:
    pp 2 x tp 2 at n_micro 4 (the dryrun's layout) under each optimizer,
    pp 4 at n_micro 4 and dp 2 x pp 2 at n_micro 2 and 4 (4: each rank
    runs its 2 of the 4 global microbatches) under
    `default_optimizer`, each against one card under the same optimizer
    within (a)'s bounds; each stage's launches a step exactly 2·L/pp·n_micro
    flash forwards (the recompute reruns them), L/pp·n_micro of each
    backward, K1-K3 none, AdamW once a local leaf (12) under fused AdamW,
    and one (dp, fsdp, tp) coordinate's stages one card's flash launches
    n_micro times over. Then the bubble sweep (timing only): pp 4, one row
    of 2048 a microbatch, n_micro 1, 2, 4, 8 rows a step, the step without
    its optimizer update: ms/step (steps 2-4), ms a row, the overhead as
    the reference's `perf_multichip` measures it beside the model (n_micro
    + pp - 1) / n_micro (__graft_entry__.py:313-345), each stage's P2P
    (NCCL SendRecv) and busy shares of a profiled step and its host's ms
    to issue a step (every phase logs these, `host_ms`). Then the dryrun's
    pp step (__graft_entry__.py:150-174): `tiny`, pp 2 x tp 2, n_micro 2,
    one step of `default_optimizer(1e-3)`, a finite loss.
(k) pp full depth (four cards): `ModelConfig.llama3_8b()` at 32 layers on
    pp 2 x tp 2, (g)'s 4 rows of 4096 a step, n_micro 4, remat "dots", 6
    steps under `default_optimizer`, then 6 under fused AdamW: finite
    losses, the last below the first; ms/step (steps 3-6), tokens/s a
    card, MFU, each stage's peak GiB, the NCCL ms/step by operation of 2
    profiled steps (the hand-offs' SendRecv apart from tp's AllReduce),
    and each stage's P2P share of a step without its update, with its
    host's ms to issue that step, beside the model's bubble (pp - 1) /
    (n_micro + pp - 1) = 1/5.
(l) trainer (run in the launching process, after the rank phases): the
    port's runtime with `{"GPU": chips}` on one node, a `MeshTrainer` of 1
    worker and then of `chips` `use_gpu` workers (`{"GPU": 1}` bundles on
    the CPU), each worker joining the group's world through
    `prepare_mesh(MeshConfig(fsdp=workers))` and running (a)'s 8-layer step
    on (a)'s batch: every worker's `get_gpu_ids()` its current card, the
    grants distinct, the losses within (a)'s bounds against the 1-worker
    fit.
(m) ppo learner: the dryrun's PPO learner part (__graft_entry__.py:
    176-198) on the cards: `PPOLearner(obs_dim=4, num_actions=2, lr=1e-3)`
    over `make_mesh(MeshConfig(dp=-1, fsdp=1, tp=1, sp=1))`, every rank
    the same 8·world-row batch from `np.random.default_rng(0)`, 4 updates:
    a finite loss, each update's total_loss within 1e-5 relative and the
    params within 1e-6 of the same learner on rank 0's card alone; then a
    `DQNLearner` on the mesh: its `td`, gathered over dp in row order,
    within 1e-5 of one card's.

Rank 0 prints each phase's numbers and writes them all as JSON (--json).
Every check raises, so a failing rank ends the run with a non-zero exit;
nothing is caught and passed over. With --cpu the same phases run on gloo
CPU ranks at `tiny` widths (with 4 KV heads in (e)-(f), so tp 4 and
Ulysses at sp 4 split them): a rehearsal of the control flow, no device
measurement. The --cpu rehearsal of (e) adds the dryrun's 8B-widths step
(2 layers, vocab 4096, 64 positions, float32, remat dots, fsdp 2 x tp 2,
one step, a finite loss), and of (f) its ring step at tp 2 x sp 2; (j)
and (k) there run `tiny` with 4 layers, and the profiles and launch
counts are the card's only.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import shutil
import socket
import statistics
import subprocess
import time
from pathlib import Path
from typing import Any, Dict, List

import torch

from ray_tpu_torch import bench
from ray_tpu_torch.ops.kernels._util import require_cuda

REPO = Path(__file__).resolve().parents[1]
PHASES = ("parity", "full_depth", "reshard", "collectives", "tp_parity",
          "sp_parity", "tp_full_depth", "ep_parity", "ep_depth", "pp_parity",
          "pp_full_depth", "trainer", "ppo_learner")
# (l) runs in the launching process (it starts the runtime's workers)
LAUNCHER_PHASES = ("trainer",)
# the phases that lay out four ranks as fsdp 2 x tp 2, tp 2 x sp 2, ...
FOUR_RANK_PHASES = ("tp_parity", "sp_parity", "tp_full_depth", "ep_parity",
                    "ep_depth", "pp_parity", "pp_full_depth")
# Parity of the sharded steps with the unsharded one: the same forward
# (step 1), gradients summed in another order (step-1 norm), then Adam's
# divide by each gradient's running magnitude (losses 2-4).
FIRST_LOSS_RTOL, GRAD_NORM_RTOL, LOSS_RTOL = 1e-4, 1e-2, 1e-3
# Ring attention's bf16 einsum against one card's flash kernels
RING_BOUNDS = (1e-3, 2e-2, 5e-3)
RESHARD_LOSS_RTOL = 1e-6
# (h): step-1 moe_aux against one card's (the same routing of the same
# tokens, its probabilities' means summed in another order)
AUX_RTOL = 1e-4
# (i): the layer counts, and the 16-layer try's gates: the 8 layers' peak
# below EP_TRY_PEAK_GIB and the predicted 16-layer peak below
# EP_PREDICT_LIMIT_GIB (10% below the card's 80 GB)
EP_DEPTH_LAYERS, EP_DEEPER_LAYERS = 8, 16
EP_TRY_PEAK_GIB, EP_PREDICT_LIMIT_GIB = 45.0, 72.0
SEED = 0
# A collective that waits longer than this for a rank fails (the rank 0
# reference of phase parity runs while the others wait); the whole run
# longer than RUN_TIMEOUT_S is ended.
GROUP_TIMEOUT_S, RUN_TIMEOUT_S = 1200.0, 3000.0


@dataclasses.dataclass
class Sizes:
    """The model and batch of each phase: 8B widths on the card, `tiny`
    on the CPU rehearsal."""
    parity_layers: int
    full_layers: int
    parity_seq: int
    full_seq: int
    loss_chunk: int
    sp_seq: int
    steps_parity: int = 4
    steps_full: int = 6

    def cfg(self, cpu: bool, n_layers: int, kv_heads: int = 0):
        """The fused 8B width of `n_layers` (`tiny` on the CPU, with
        `kv_heads` KV heads if given)."""
        from ray_tpu_torch.models import ModelConfig

        if cpu:
            tiny = ModelConfig.tiny()
            return dataclasses.replace(
                tiny, n_layers=n_layers, fused_ffn=True, fused_attn=True,
                remat="dots", n_kv_heads=kv_heads or tiny.n_kv_heads)
        return bench.train_config_8b(n_layers=n_layers)

    def moe_cfg(self, cpu: bool, n_layers: int):
        """Mixtral-8x7B's widths at `n_layers` (`tiny_moe` on the CPU),
        remat "dots", capacity factor 1.25, moe_aux_weight 0.02."""
        from ray_tpu_torch.models import ModelConfig

        base = ModelConfig.tiny_moe() if cpu else mixtral_config(n_layers)
        return dataclasses.replace(base, n_layers=n_layers, remat="dots",
                                   capacity_factor=1.25, moe_aux_weight=0.02)


def mixtral_config(n_layers: int):
    """Mixtral-8x7B's published widths (mistralai/Mixtral-8x7B-v0.1, its
    config.json): d 4096, 32/8 heads of 128, 8 experts of d_ff 14336,
    top-2, vocab 32000, rope_theta 1e6, RMSNorm eps 1e-5, untied head,
    router aux coefficient 0.02 (chip_smoke.py keeps the same config)."""
    from ray_tpu_torch.models import ModelConfig

    return ModelConfig(vocab_size=32000, d_model=4096, n_layers=n_layers,
                       n_heads=32, n_kv_heads=8, d_ff=14336,
                       max_seq_len=32768, rope_theta=1e6, norm_eps=1e-5,
                       n_experts=8, capacity_factor=1.25,
                       moe_aux_weight=0.02)


GPU_SIZES = Sizes(parity_layers=8, full_layers=32, parity_seq=2048,
                  full_seq=4096, loss_chunk=512, sp_seq=8192)
CPU_SIZES = Sizes(parity_layers=2, full_layers=4, parity_seq=32,
                  full_seq=64, loss_chunk=16, sp_seq=64)


class Rank:
    """One rank's context: its device, group size, sizes and log."""

    def __init__(self, rank: int, world: int, cpu: bool, seed: int,
                 ckpt_root: str):
        import torch.distributed as dist

        self.rank, self.world, self.cpu, self.seed = rank, world, cpu, seed
        self.dist = dist
        self.dev = torch.device("cpu") if cpu else torch.device(
            "cuda", torch.cuda.current_device())
        self.sizes = CPU_SIZES if cpu else GPU_SIZES
        self.peak = (bench.NOMINAL_CPU_FLOPS if cpu
                     else bench.PEAK_BF16_FLOPS_H100)
        self.ckpt_root = ckpt_root

    def log(self, msg: str) -> None:
        if self.rank == 0:
            print(f"multichip: {msg}", flush=True)

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def free(self) -> None:
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.dev)

    def peak_gib(self) -> float:
        return (torch.cuda.max_memory_allocated(self.dev) / 2 ** 30
                if self.dev.type == "cuda" else float("nan"))

    def from_rank0(self, value: Any) -> Any:
        out = [value]
        self.dist.broadcast_object_list(out, src=0)
        return out[0]

    def mesh(self, **kw):
        from ray_tpu_torch.parallel import MeshConfig, make_mesh

        return make_mesh(MeshConfig(**kw), device=self.dev.type)


def _kernels():
    from ray_tpu_torch.ops.kernels import adamw as aw
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.ops.kernels import fused_ffn as ff

    return (*fa.KERNELS, *ff.KERNELS, aw.adamw_update)


def _steps(r: Rank, step_fn, state, batch, n: int, routes=None):
    """n steps: each one's loss, grad norm, host ms (ending in a sync), the
    host's ms to issue it (the call's return: the whole step where the
    host holds the device, or the step waits for the device inside, as
    `default_optimizer`'s clip does) and kernel launches; with `routes` (a
    `_Routes`), each step's routing."""
    rows = []
    kernels = _kernels()
    with routes if routes is not None else contextlib.nullcontext():
        for _ in range(n):
            if routes is not None:
                routes.step()
            for k in kernels:  # the path's counts start here
                k.launches = 0
            r.sync()
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            issued = time.perf_counter()
            loss, norm = float(m["loss"]), float(m["grad_norm"])
            r.sync()
            rows.append({"loss": loss, "grad_norm": norm,
                         "moe_aux": float(m["moe_aux"]),
                         "ms": 1e3 * (time.perf_counter() - t0),
                         "host_ms": 1e3 * (issued - t0),
                         "launches": {k.__name__: k.launches
                                      for k in kernels}})
    return state, rows


def _brief(result: Dict[str, Any]) -> str:
    """A phase's result for the log: the steps as columns (losses, grad
    norms, ms, the first step's launches)."""
    out = dict(result)
    rows = out.pop("steps", None)
    if rows:
        out.update(losses=[x["loss"] for x in rows],
                   grad_norms=[x["grad_norm"] for x in rows],
                   ms=[round(x["ms"], 2) for x in rows],
                   host_ms=[round(x["host_ms"], 2) for x in rows],
                   launches_a_step=rows[0]["launches"])
        if any(x["moe_aux"] for x in rows):
            out["moe_aux"] = [x["moe_aux"] for x in rows]
    return json.dumps(out)


def _rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def parity(r: Rank) -> Dict[str, Any]:
    from ray_tpu_torch.train import (default_optimizer, make_train_step,
                                     shard_batch)

    sz = r.sizes
    cfg = sz.cfg(r.cpu, sz.parity_layers)
    batch = bench.make_batch(cfg, r.world, sz.parity_seq, r.seed + 1, r.dev)
    ref = None
    if r.rank == 0:
        step_fn, init_fn = make_train_step(
            cfg, default_optimizer(warmup_steps=2), r.dev)
        state, ref = _steps(r, step_fn, init_fn(r.seed), batch,
                            sz.steps_parity)
        ref = {"steps": ref, "peak_gib": r.peak_gib()}
        del state, step_fn, init_fn  # freed before the sharded runs
    r.free()
    ref = r.from_rank0(ref)
    r.log(f"parity: one card, {cfg.n_layers} layers, batch {r.world} x "
          f"{sz.parity_seq}: " + _brief(ref))
    out = {"layers": cfg.n_layers, "batch": [r.world, sz.parity_seq],
           "one_card": ref}
    L = cfg.n_layers
    for name, kw in (("fsdp", {"fsdp": r.world}), ("dp", {"dp": r.world})):
        mesh = r.mesh(**kw)
        step_fn, init_fn = make_train_step(
            cfg, default_optimizer(warmup_steps=2), r.dev, mesh=mesh)
        state, rows = _steps(r, step_fn, init_fn(r.seed),
                             shard_batch(batch, mesh), sz.steps_parity)
        out[name] = {"steps": rows, "peak_gib": r.peak_gib()}
        r.log(f"parity {name}={r.world}: " + _brief(out[name]))
        _compare(name, rows, ref["steps"])
        if not r.cpu:
            for got in rows:
                _check(all(got["launches"][k] == L for k in (
                    "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
                    "dw_gateup")), f"{name}: launches {got['launches']}")
        del state, step_fn, init_fn, mesh
        r.free()
    return out


def _compare(name: str, rows, want, bounds=(FIRST_LOSS_RTOL, GRAD_NORM_RTOL,
                                            LOSS_RTOL),
             launches: bool = True) -> None:
    """Raise unless a sharded run's steps agree with one card's: step-1
    loss and grad norm, then every later loss, within `bounds`; and (if
    `launches`) every kernel's launches, step by step."""
    misses = _mismatches(name, rows, want, bounds, launches)
    _check(not misses, "; ".join(misses))


def _mismatches(name: str, rows, want, bounds=(FIRST_LOSS_RTOL,
                                               GRAD_NORM_RTOL, LOSS_RTOL),
                launches: bool = True) -> List[str]:
    """`_compare`'s checks, each one that fails as a message."""
    first, norm, later = bounds
    out = []
    if _rel(rows[0]["loss"], want[0]["loss"]) > first:
        out.append(f"{name}: step-1 loss {rows[0]['loss']} vs "
                   f"{want[0]['loss']} (rel "
                   f"{_rel(rows[0]['loss'], want[0]['loss']):.3g}, limit "
                   f"{first})")
    if _rel(rows[0]["grad_norm"], want[0]["grad_norm"]) > norm:
        out.append(f"{name}: step-1 grad norm {rows[0]['grad_norm']} vs "
                   f"{want[0]['grad_norm']} (limit {norm})")
    for i in range(1, len(rows)):
        if _rel(rows[i]["loss"], want[i]["loss"]) > later:
            out.append(f"{name}: loss {i + 1} {rows[i]['loss']} vs "
                       f"{want[i]['loss']} (rel "
                       f"{_rel(rows[i]['loss'], want[i]['loss']):.3g}, "
                       f"limit {later})")
    if launches:
        for got, one in zip(rows, want):
            if got["launches"] != one["launches"]:
                out.append(f"{name}: launches {got['launches']} vs one "
                           f"card's {one['launches']}")
    return out


def _one_card(r: Rank, runs: Dict[str, Any], batch, steps: int,
              routes: Dict[str, Any] = None):
    """Each (cfg, optimizer maker, all kernels) of `runs` on rank 0's card
    alone, then broadcast: {key: {"steps", "peak_gib"}}. With `routes`,
    rank 0 also puts each run's routing there (`_Routes.steps`)."""
    from ray_tpu_torch.train import make_train_step

    ref = None
    if r.rank == 0:
        ref = {}
        for key, (cfg, make, all_kernels) in runs.items():
            rec = None if routes is None else _Routes(cfg.n_layers)
            with _kernel_flags(all_kernels):
                step_fn, init_fn = make_train_step(cfg, make(warmup_steps=2),
                                                   r.dev)
                state, rows = _steps(r, step_fn, init_fn(r.seed), batch,
                                     steps, rec)
            if rec is not None:
                routes[key] = rec.steps
            ref[key] = {"steps": rows, "peak_gib": r.peak_gib()}
            del state, step_fn, init_fn
            r.free()
    return r.from_rank0(ref)


@contextlib.contextmanager
def _kernel_flags(all_kernels: bool):
    """USE_K1 = USE_K2 = True inside (the all-kernel step), as before
    after."""
    from ray_tpu_torch.ops.kernels import fused_ffn as ff

    old = (ff.USE_K1, ff.USE_K2)
    if all_kernels:
        ff.USE_K1 = ff.USE_K2 = True
    try:
        yield
    finally:
        ff.USE_K1, ff.USE_K2 = old


def _sharded_runs(r: Rank, runs, batch, steps: int, ref, label: str):
    """Each (name, cfg, mesh kw, optimizer maker, all kernels, ref key,
    bounds, launches) of `runs` over the ranks against its one-card
    reference; returns {name: {"mesh", "steps", "peak_gib"}}."""
    from ray_tpu_torch.train import make_train_step, shard_batch

    out = {}
    for name, cfg, mesh_kw, make, all_kernels, key, bounds, launches in runs:
        mesh = r.mesh(**mesh_kw)
        with _kernel_flags(all_kernels):
            step_fn, init_fn = make_train_step(cfg, make(warmup_steps=2),
                                               r.dev, mesh=mesh)
            state, rows = _steps(r, step_fn, init_fn(r.seed),
                                 shard_batch(batch, mesh), steps)
        out[name] = {"mesh": mesh_kw, "steps": rows,
                     "peak_gib": r.peak_gib()}
        r.log(f"{label} {name}: " + _brief(out[name]))
        _compare(name, rows, ref[key]["steps"], bounds, launches)
        del state, step_fn, init_fn, mesh
        r.free()
    return out


def _need_four(r: Rank, phase: str) -> None:
    _check(r.world == 4, f"{phase} lays out 4 ranks, not {r.world}")


def tp_parity(r: Rank) -> Dict[str, Any]:
    """(e): the plan's path at tp 4 and fsdp 2 x tp 2, the fused blocks and
    the all-kernel step at dp 2 x tp 2, each against one card."""
    from ray_tpu_torch.train import default_optimizer, fused_adamw_optimizer

    _need_four(r, "tp_parity")
    sz = r.sizes
    fused = sz.cfg(r.cpu, sz.parity_layers, kv_heads=4)
    plan = dataclasses.replace(fused, fused_ffn=False, fused_attn=False,
                               remat="dots", loss_chunk=sz.loss_chunk)
    batch = bench.make_batch(fused, 4, sz.parity_seq, r.seed + 1, r.dev)
    # fewer KV heads than ranks (ROADMAP A.7.5): 2 at tp 4
    plan_kv2 = dataclasses.replace(plan, n_kv_heads=2)
    fused_kv2 = dataclasses.replace(fused, n_kv_heads=2)
    refs = {"plan": (plan, default_optimizer, False),
            "fused": (fused, default_optimizer, False),
            "all-kernel": (fused, fused_adamw_optimizer, True),
            "plan kv2": (plan_kv2, default_optimizer, False),
            "fused kv2": (fused_kv2, default_optimizer, False)}
    ref = _one_card(r, refs, batch, sz.steps_parity)
    for key, one in ref.items():
        r.log(f"tp parity: one card, {key}, {fused.n_layers} layers, batch "
              f"4 x {sz.parity_seq}: " + _brief(one))
    a = (FIRST_LOSS_RTOL, GRAD_NORM_RTOL, LOSS_RTOL)
    runs = [("plan tp4", plan, {"tp": 4}, default_optimizer, False, "plan",
             a, True),
            ("plan fsdp2xtp2", plan, {"fsdp": 2, "tp": 2},
             default_optimizer, False, "plan", a, True),
            ("fused dp2xtp2", fused, {"dp": 2, "tp": 2}, default_optimizer,
             False, "fused", a, True),
            ("all-kernel dp2xtp2", fused, {"dp": 2, "tp": 2},
             fused_adamw_optimizer, True, "all-kernel", a, True),
            ("plan tp4 kv2", plan_kv2, {"tp": 4}, default_optimizer, False,
             "plan kv2", a, True),
            ("fused tp4 kv2", fused_kv2, {"tp": 4}, default_optimizer,
             False, "fused kv2", a, True)]
    out = {"layers": fused.n_layers, "batch": [4, sz.parity_seq],
           "one_card": ref,
           **_sharded_runs(r, runs, batch, sz.steps_parity, ref,
                           "tp parity")}
    if r.cpu:
        out["eightb_widths"] = _eightb_widths_dryrun(r)
    return out


def _eightb_widths_dryrun(r: Rank) -> Dict[str, Any]:
    """The dryrun's 8B-widths step (__graft_entry__.py:125-149) on the CPU
    ranks: llama3_8b's widths, 2 layers, vocab 4096, 64 positions, float32,
    remat dots, fsdp 2 x tp 2, one step of 2 rows: a finite loss."""
    from ray_tpu_torch.models import ModelConfig
    from ray_tpu_torch.train import (default_optimizer, make_train_step,
                                     shard_batch)

    cfg = dataclasses.replace(ModelConfig.llama3_8b(), n_layers=2,
                              vocab_size=4096, max_seq_len=64,
                              dtype=torch.float32, remat="dots")
    mesh = r.mesh(fsdp=2, tp=2)
    step_fn, init_fn = make_train_step(cfg, default_optimizer(1e-3), r.dev,
                                       mesh=mesh)
    batch = shard_batch(bench.make_batch(cfg, 2, 64, r.seed + 4, r.dev),
                        mesh)
    _, m = step_fn(init_fn(r.seed), batch)
    loss = float(m["loss"])
    r.log(f"tp parity: 8B widths (d 4096, d_ff 14336, 32/8 heads), fsdp 2 x "
          f"tp 2, loss {loss:.4f}")
    _check(math.isfinite(loss), f"8B widths: loss {loss}")
    del step_fn, init_fn, mesh
    r.free()
    return {"loss": loss}


def sp_parity(r: Rank) -> Dict[str, Any]:
    """(f): sp 4 under Ulysses and ring, tp 2 x sp 2 under Ulysses (and, on
    the CPU, ring), each against one card at 1 x sp_seq."""
    from ray_tpu_torch.train import default_optimizer

    _need_four(r, "sp_parity")
    sz = r.sizes
    cfg = dataclasses.replace(
        sz.cfg(r.cpu, sz.parity_layers, kv_heads=4), fused_ffn=False,
        fused_attn=False, remat="dots", loss_chunk=sz.loss_chunk,
        max_seq_len=sz.sp_seq)
    batch = bench.make_batch(cfg, 1, sz.sp_seq, r.seed + 1, r.dev)
    ref = _one_card(r, {"plain": (cfg, default_optimizer, False)}, batch,
                    sz.steps_parity)
    r.log(f"sp parity: one card, {cfg.n_layers} layers, 1 x {sz.sp_seq}: "
          + _brief(ref["plain"]))
    a = (FIRST_LOSS_RTOL, GRAD_NORM_RTOL, LOSS_RTOL)
    uly = dataclasses.replace(cfg, seq_parallel="ulysses")
    ring = dataclasses.replace(cfg, seq_parallel="ring")
    runs = [("ulysses sp4", uly, {"sp": 4}, default_optimizer, False,
             "plain", a, True),
            ("ring sp4", ring, {"sp": 4}, default_optimizer, False, "plain",
             RING_BOUNDS, False),
            ("ulysses tp2xsp2", uly, {"tp": 2, "sp": 2}, default_optimizer,
             False, "plain", a, True)]
    if r.cpu:  # the dryrun's ring step at tp 2 x sp 2
        runs.append(("ring tp2xsp2", ring, {"tp": 2, "sp": 2},
                     default_optimizer, False, "plain", RING_BOUNDS, False))
    out = {"layers": cfg.n_layers, "batch": [1, sz.sp_seq], "one_card": ref,
           **_sharded_runs(r, runs, batch, sz.steps_parity, ref,
                           "sp parity")}
    for name, res in out.items():
        if name.startswith("ring"):  # the einsum route: no flash launch
            for x in res["steps"]:
                _check(all(x["launches"][k] == 0 for k in (
                    "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq")),
                    f"{name}: launches {x['launches']}")
    return out


def _moe_launches(cfg, n_leaves: int, fused: bool) -> Dict[str, int]:
    """The launches a MoE step makes on the card: under remat "dots" the
    flash forward twice a layer (the recompute reruns it) and the backward
    pair once, the fused-FFN kernels never (MoE refuses them), AdamW once
    a leaf under fused AdamW."""
    L = cfg.n_layers
    return {"flash_fwd": 2 * L, "flash_bwd_dkv": L, "flash_bwd_dq": L,
            "dw_gateup": 0, "dw_down": 0, "dgateup": 0,
            "adamw_update": n_leaves if fused else 0}


def _check_moe_launches(r: Rank, label: str, rows, want) -> None:
    if r.cpu:
        return
    for x in rows:
        _check(x["launches"] == want, f"{label}: launches {x['launches']} "
               f"vs {want}")


def _profiled(r: Rank, step_fn, state, batch, rows, tokens: int):
    """ms/step over steps 2 on, tokens/s, peak GiB, and 2 profiled steps:
    (state, numbers)."""
    ms = statistics.mean(x["ms"] for x in rows[1:])
    peak = r.peak_gib()
    state, prof = bench.profile_train(step_fn, state, batch, steps=2)
    return state, {
        "ms_per_step": ms, "tokens_per_sec": tokens / (ms / 1e3),
        "tokens_per_sec_per_card": tokens / (ms / 1e3) / r.world,
        "peak_gib": peak,
        "device_ms_per_step": prof["device_ms_per_step"],
        "device_idle_share": prof["device_idle_share"],
        "ms_per_step_by_kind": prof["ms_per_step_by_kind"],
        "collective_ms_per_step_by_op":
            prof["collective_ms_per_step_by_op"],
        "ep_collective_ms_per_step": prof["ep_collective_ms_per_step"]}


class _Routes:
    """The MoE layers' routing (ops/moe.py looks `_route` and `_choose` up
    at call time). While active, the first `layers` routings of each step
    (the forward's: remat's recompute routes again after them) are kept,
    on the device, as every token's two experts ("first", "second", [T])
    and kept bits ("kept", [T, 2]), one list a step (`step()` opens it).
    Given `forced` (one step's list), each of those routings takes its two
    experts from it, in call order, instead of from the probabilities."""

    def __init__(self, layers: int, forced=None):
        self.layers, self.forced = layers, forced
        self.steps: List[List[Dict[str, torch.Tensor]]] = []

    def step(self) -> None:
        self.steps.append([])

    def __enter__(self) -> "_Routes":
        from ray_tpu_torch.ops import moe

        self._real = route, choose = moe._route, moe._choose
        chosen = []

        def choosing(probs):
            n = len(self.steps[-1])
            if self.forced is not None and n < self.layers:
                chosen[:] = self.forced[n]["first"], self.forced[n]["second"]
            else:
                chosen[:] = choose(probs)
            return tuple(chosen)

        def routing(logits, capacity):
            out = route(logits, capacity)
            calls = self.steps[-1]
            if len(calls) < self.layers:
                calls.append({"first": chosen[0], "second": chosen[1],
                              "kept": torch.stack((out[0].sum(-1),
                                                   out[3].sum(-1)), -1) > 0})
            return out

        moe._route, moe._choose = routing, choosing
        return self

    def __exit__(self, *exc) -> None:
        from ray_tpu_torch.ops import moe

        moe._route, moe._choose = self._real


def _route_diff(a, b) -> List[List[int]]:
    """Per layer of one step's two routings (`_Routes`): the tokens whose
    first choice, second choice, and kept bits differ."""
    return [[int((x[k] != y[k]).reshape(len(x[k]), -1).any(-1).sum())
             for k in ("first", "second", "kept")] for x, y in zip(a, b)]


EP_LAYOUTS = (("fsdp4", {"fsdp": 4}, "default"),
              ("fsdp2xtp2", {"fsdp": 2, "tp": 2}, "default"),
              ("dp2xfsdp2", {"dp": 2, "fsdp": 2}, "default"),
              ("fsdp4 fused", {"fsdp": 4}, "fused"))


def ep_parity(r: Rank) -> Dict[str, Any]:
    """(h): the expert-parallel step at fsdp 4, fsdp 2 x tp 2 and dp 2 x
    fsdp 2 under default_optimizer and at fsdp 4 under fused AdamW, each
    against one card under the same optimizer, in bf16 (measured) and in
    float32; every layout runs and is logged, and the phase fails at its
    end if any check missed."""
    _need_four(r, "ep_parity")
    sz = r.sizes
    base = sz.moe_cfg(r.cpu, 2)
    batch = bench.make_batch(base, 4, sz.parity_seq, r.seed + 1, r.dev)
    out = {"layers": base.n_layers, "batch": [4, sz.parity_seq]}
    misses = []
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        out[name], missed = _ep_parity_runs(
            r, dataclasses.replace(base, dtype=dtype), batch, name)
        misses += missed
    if r.cpu:
        out["dryrun_moe"] = _dryrun_moe(r)
    r.log(f"ep parity: {len(misses)} checks missed: {misses}")
    _check(not misses, "ep parity: " + "; ".join(misses))
    return out


def _ep_parity_runs(r: Rank, cfg, batch, name: str):
    """(h) in cfg's dtype: (results, the checks missed). bf16 is measured
    (`_profiled`); float32 is also held to (a)'s bounds."""
    from ray_tpu_torch.models.transformer import init_params, tree_leaves
    from ray_tpu_torch.train import (default_optimizer,
                                     fused_adamw_optimizer, make_train_step,
                                     shard_batch)

    sz = r.sizes
    measured = cfg.dtype == torch.bfloat16
    label = f"ep parity {name}"
    n_leaves = len(list(tree_leaves(init_params(cfg, device="meta"))))
    makes = {"default": default_optimizer, "fused": fused_adamw_optimizer}
    routes = {}  # rank 0: each run's routing, step by step
    ref = _one_card(r, {k: (cfg, make, False) for k, make in makes.items()},
                    batch, sz.steps_parity, routes)
    for key, one in ref.items():
        r.log(f"{label}: one card, {key}, {cfg.n_layers} layers, batch 4 x "
              f"{sz.parity_seq}: " + _brief(one))
        _check_moe_launches(r, f"{label} one card {key}", one["steps"],
                            _moe_launches(cfg, n_leaves, key == "fused"))
    out = {"one_card": ref}
    misses = []
    unbounded = (math.inf,) * 3  # bf16: the launches alone
    for layout, mesh_kw, key in EP_LAYOUTS:
        r.free()
        mesh = r.mesh(**mesh_kw)
        step_fn, init_fn = make_train_step(cfg, makes[key](warmup_steps=2),
                                           r.dev, mesh=mesh)
        local = shard_batch(batch, mesh)
        rec = _Routes(cfg.n_layers)
        state, rows = _steps(r, step_fn, init_fn(r.seed), local,
                             sz.steps_parity, rec)
        numbers = {"peak_gib": r.peak_gib()}
        if measured:
            state, numbers = _profiled(r, step_fn, state, local, rows,
                                       4 * sz.parity_seq)
        routes[layout] = rec.steps
        out[layout] = {"mesh": mesh_kw, "optimizer": key, "steps": rows,
                       **numbers}
        r.log(f"{label} {layout}: " + _brief(out[layout]))
        misses += _mismatches(f"{name} {layout}", rows, ref[key]["steps"],
                              unbounded if measured else (
                                  FIRST_LOSS_RTOL, GRAD_NORM_RTOL,
                                  LOSS_RTOL))
        if not all(math.isfinite(x["loss"]) for x in rows):
            misses.append(f"{name} {layout}: losses {rows}")
        want = ref[key]["steps"][0]["moe_aux"]
        if not measured and _rel(rows[0]["moe_aux"], want) > AUX_RTOL:
            misses.append(f"{name} {layout}: step-1 moe_aux "
                          f"{rows[0]['moe_aux']} vs {want} (limit "
                          f"{AUX_RTOL})")
        del state, step_fn, init_fn, mesh, local, rec
        r.free()
    witness = _route_witness(r, cfg, batch, routes)
    for layout, _, _ in EP_LAYOUTS:
        w, first = witness[layout], out[layout]["steps"][0]
        out[layout]["routing"] = w
        r.log(f"{label} {layout}: routing against one card's (tokens "
              f"whose first choice, second choice, kept bits differ; each "
              f"step, each layer) {w['diff']}; one card's step-1 forward "
              f"under this routing: loss {w['loss']} (this layout "
              f"{first['loss']}), moe_aux {w['moe_aux']} (this layout "
              f"{first['moe_aux']})")
        for what, limit in (("loss", FIRST_LOSS_RTOL),
                            ("moe_aux", AUX_RTOL)):
            if not _rel(w[what], first[what]) <= limit:
                misses.append(f"{name} {layout}: one card's step-1 {what} "
                              f"under its routing {w[what]} vs "
                              f"{first[what]} (limit {limit})")
    out["one_card_forward"] = witness["one card"]
    r.log(f"{label}: one card's step-1 forward alone: "
          + json.dumps(witness["one card"]))
    return out, misses


def _route_witness(r: Rank, cfg, batch, routes) -> Dict[str, Any]:
    """On rank 0, then broadcast: each layout's routing against one
    card's under its optimizer, step by step (`_route_diff`), and one
    card's step-1 forward (the same params and batch) under the layout's
    step-1 routing: its loss and moe_aux. Under "one card", that forward
    under its own choices, beside the step's."""
    from ray_tpu_torch.models.transformer import init_params, loss_fn

    out = None
    if r.rank == 0:
        params = init_params(cfg, seed=r.seed, device=r.dev)

        def forward(rec):
            with torch.no_grad(), rec:
                rec.step()
                loss, aux = loss_fn(params, batch, cfg)
            return {"loss": float(loss), "moe_aux": float(aux["moe_aux"])}

        own = _Routes(cfg.n_layers)
        out = {"one card": forward(own)}
        out["one card"]["diff"] = _route_diff(routes["default"][0],
                                              own.steps[0])
        for layout, _, key in EP_LAYOUTS:
            got = routes[layout]
            out[layout] = {
                "diff": [_route_diff(a, b)
                         for a, b in zip(routes[key], got)],
                **forward(_Routes(cfg.n_layers, forced=got[0]))}
        del params
    r.free()
    return r.from_rank0(out)


def _dryrun_moe(r: Rank) -> Dict[str, Any]:
    """The dryrun's MoE step (__graft_entry__.py:103-123: `tiny_moe`, the
    experts over the fsdp axis, one step of `default_optimizer(1e-3)` on
    the dryrun's mesh and batch) on the CPU ranks: fsdp 2 x sp 2, with
    Ulysses for the sp axis (the port's step needs a sequence-parallel
    attention there), 4 rows of 64: a finite loss."""
    from ray_tpu_torch.models import ModelConfig
    from ray_tpu_torch.train import (default_optimizer, make_train_step,
                                     shard_batch)

    cfg = dataclasses.replace(ModelConfig.tiny_moe(), seq_parallel="ulysses")
    mesh = r.mesh(fsdp=2, sp=2)
    step_fn, init_fn = make_train_step(cfg, default_optimizer(1e-3), r.dev,
                                       mesh=mesh)
    batch = shard_batch(bench.make_batch(cfg, 4, 64, r.seed + 3, r.dev),
                        mesh)
    _, m = step_fn(init_fn(r.seed), batch)
    loss, aux = float(m["loss"]), float(m["moe_aux"])
    r.log(f"ep parity: the dryrun's MoE step, fsdp 2 x sp 2 (experts over "
          f"fsdp), loss {loss:.4f}, moe_aux {aux:.4f}")
    _check(math.isfinite(loss) and math.isfinite(aux),
           f"dryrun MoE: loss {loss}, moe_aux {aux}")
    del step_fn, init_fn, mesh
    r.free()
    return {"loss": loss, "moe_aux": aux}


def ep_depth(r: Rank) -> Dict[str, Any]:
    """(i): Mixtral-8x7B's widths at EP_DEPTH_LAYERS layers on fsdp 4 under
    each optimizer, then the EP_DEEPER_LAYERS try."""
    from ray_tpu_torch.train import default_optimizer, fused_adamw_optimizer

    _need_four(r, "ep_depth")
    layers = r.sizes.full_layers if r.cpu else EP_DEPTH_LAYERS
    runs = (("default", default_optimizer), ("fused", fused_adamw_optimizer))
    out = {"mesh": {"fsdp": 4}, "layers": layers,
           "runs": _ep_depth_runs(r, layers, runs, r.sizes.steps_full)}
    if r.cpu:
        return out
    peak = max(x["peak_gib"] for x in out["runs"].values())
    predicted = 2 * peak  # everything doubles but the logits and the batch
    deeper = {"layers": EP_DEEPER_LAYERS, "peak_gib_at_fewer": peak,
              "predicted_peak_gib": predicted}
    if peak < EP_TRY_PEAK_GIB and predicted < EP_PREDICT_LIMIT_GIB:
        deeper["runs"] = _ep_depth_runs(r, EP_DEEPER_LAYERS,
                                        runs[:1], 4)
    else:
        deeper["not_tried"] = (
            f"{layers} layers peaked at {peak:.2f} GiB (try below "
            f"{EP_TRY_PEAK_GIB}), predicting {predicted:.2f} GiB (limit "
            f"{EP_PREDICT_LIMIT_GIB})")
    r.log(f"ep depth {EP_DEEPER_LAYERS} layers: " + json.dumps(
        {k: v for k, v in deeper.items() if k != "runs"}))
    out["deeper"] = deeper
    return out


def _ep_depth_runs(r: Rank, layers: int, runs, steps: int
                   ) -> Dict[str, Any]:
    """`layers` of the MoE config on fsdp 4, 4 rows a step, `steps` steps
    under each (name, optimizer maker) of `runs`: checks and numbers."""
    from ray_tpu_torch.models import count_params
    from ray_tpu_torch.models.planning import _local_bytes, _tree_bytes
    from ray_tpu_torch.models.transformer import (init_params,
                                                  param_logical_axes,
                                                  tree_leaves)
    from ray_tpu_torch.train import make_train_step, shard_batch, to_local

    sz = r.sizes
    seq = sz.parity_seq
    cfg = sz.moe_cfg(r.cpu, layers)
    mesh = r.mesh(fsdp=4)
    batch = shard_batch(bench.make_batch(cfg, 4, seq, r.seed + 1, r.dev),
                        mesh)
    axes, sizes = param_logical_axes(cfg), {"fsdp": 4}
    meta = init_params(cfg, device="meta")
    # the parameters a token passes through: all but (E - 2) experts' three
    # matrices in every layer (top-2)
    dead = cfg.n_layers * (cfg.n_experts - 2) * 3 * cfg.d_model * cfg.d_ff
    out = {}
    for name, make in runs:
        r.free()
        optimizer = _GradBytes(make(warmup_steps=2))
        step_fn, init_fn = make_train_step(cfg, optimizer, r.dev, mesh=mesh)
        state = init_fn(r.seed)
        n_params = count_params(state.params)
        live = {"params": _tree_bytes(to_local(state.params)),
                "optimizer": _tree_bytes(to_local(state.opt_state))}
        state, rows = _steps(r, step_fn, state, batch, steps)
        live["grads"] = optimizer.nbytes
        opt_meta = make().init(meta)
        want = {"params": _local_bytes(meta, axes, sizes),
                "optimizer": sum(_local_bytes(getattr(opt_meta, m), axes,
                                              sizes) for m in ("mu", "nu"))}
        want["grads"] = want["params"]
        state, numbers = _profiled(r, step_fn, state, batch, rows[1:],
                                   4 * seq)
        ms = numbers["ms_per_step"]  # steps 3 on
        res = {"n_params": n_params, "active_params": n_params - dead,
               "steps": rows, **numbers, "live_bytes": live,
               "local_bytes": want,
               "mfu": bench.throughput(cfg, n_params, 1, seq, ms / 1e3,
                                       r.peak)["mfu"],
               "mfu_active": bench.throughput(cfg, n_params - dead, 1, seq,
                                              ms / 1e3, r.peak)["mfu"]}
        out[name] = res
        r.log(f"ep depth {layers} layers {name}: " + _brief(res))
        losses = [x["loss"] for x in rows]
        _check(all(math.isfinite(x) for x in losses)
               and all(math.isfinite(x["grad_norm"]) for x in rows),
               f"ep depth {name}: losses {losses}")
        _check(losses[-1] < losses[0],
               f"ep depth {name}: the loss did not fall: {losses}")
        _check(live == want, f"ep depth {name}: live bytes {live} vs "
               f"_local_bytes' {want}")
        _check_moe_launches(r, f"ep depth {name}", rows, _moe_launches(
            cfg, len(list(tree_leaves(meta))), name == "fused"))
        del state, step_fn, init_fn, optimizer
    del mesh, batch
    r.free()
    return out


class _GradBytes:
    """An optimizer that records the bytes of the gradients the step hands
    it (this rank's blocks)."""

    def __init__(self, optimizer):
        self.optimizer, self.nbytes = optimizer, None

    def init(self, params):
        return self.optimizer.init(params)

    def apply(self, grads, state, params, grad_norm=None):
        from ray_tpu_torch.models.planning import _tree_bytes

        self.nbytes = _tree_bytes(grads)
        return self.optimizer.apply(grads, state, params, grad_norm)


def full_depth(r: Rank) -> Dict[str, Any]:
    """(b): fsdp over every card, one row a card."""
    return _full_depth(r, "full depth", fsdp=r.world, tp=1)


def tp_full_depth(r: Rank) -> Dict[str, Any]:
    """(g): fsdp 2 x tp 2, (b)'s rows (one a card) over the 2 data
    shards."""
    _need_four(r, "tp_full_depth")
    return _full_depth(r, "tp full depth", fsdp=2, tp=2)


def _full_depth(r: Rank, label: str, fsdp: int, tp: int) -> Dict[str, Any]:
    """The full-depth run over fsdp x tp = world cards, `world` rows of
    full_seq a step under each optimizer: its checks and numbers beside
    the plan's."""
    from ray_tpu_torch.models import count_params, planning
    from ray_tpu_torch.models.planning import _tree_bytes
    from ray_tpu_torch.models.transformer import tree_leaves
    from ray_tpu_torch.train import (default_optimizer,
                                     fused_adamw_optimizer, make_train_step,
                                     shard_batch, to_local)

    sz = r.sizes
    seq = sz.full_seq
    cfg = dataclasses.replace(sz.cfg(r.cpu, sz.full_layers),
                              max_seq_len=seq, loss_chunk=sz.loss_chunk)
    layout = {"fsdp": fsdp, "tp": tp} if tp > 1 else {"fsdp": fsdp}
    mesh = r.mesh(**layout)
    batch = shard_batch(bench.make_batch(cfg, r.world, seq, r.seed + 1,
                                         r.dev), mesh)
    plan = planning.eightb_plan(n_chips=r.world, fsdp=fsdp, tp=tp,
                                batch_per_chip_tokens=seq, seq=seq)
    out = {"layers": cfg.n_layers, "seq": seq, "mesh": layout,
           "rows": r.world, "eightb_plan": plan}
    for name, make in (("default", default_optimizer),
                       ("fused", fused_adamw_optimizer)):
        r.free()
        optimizer = _GradBytes(make(warmup_steps=2))
        step_fn, init_fn = make_train_step(cfg, optimizer, r.dev, mesh=mesh)
        t0 = time.perf_counter()
        state = init_fn(r.seed)
        r.sync()
        init_s = time.perf_counter() - t0
        n_params = count_params(state.params)
        live = {"params": _tree_bytes(to_local(state.params)),
                "optimizer": _tree_bytes(to_local(state.opt_state))}
        state, rows = _steps(r, step_fn, state, batch, sz.steps_full)
        live["grads"] = optimizer.nbytes
        peak = r.peak_gib()
        budget = planning._budget(cfg, make(), r.world, fsdp, tp, seq, seq)
        ms = statistics.mean(x["ms"] for x in rows[2:])
        tput = bench.throughput(cfg, n_params, 1, seq, ms / 1e3, r.peak)
        state, prof = bench.profile_train(step_fn, state, batch, steps=2)
        res = {"n_params": n_params, "init_s": init_s, "steps": rows,
               "ms_per_step": ms, "tokens_per_sec_per_card":
                   tput["tokens_per_sec"], "mfu": tput["mfu"],
               "peak_gib": peak, "live_bytes": live,
               "plan_local_bytes": budget["local_bytes"],
               "plan": {"step_s": budget["step_s"],
                        "tokens_per_sec_per_chip":
                            budget["tokens_per_sec_per_chip"],
                        "mfu": budget["mfu"],
                        "per_chip_gib": {k: v / 2 ** 30 for k, v in
                                         budget["per_chip_bytes"].items()}},
               "profile": prof}
        out[name] = res
        r.log(f"{label} {name}: " + _brief(
            {k: v for k, v in res.items() if k != "profile"}))
        r.log(f"{label} {name} profile: device "
              f"{prof['device_ms_per_step']:.2f} ms/step in "
              f"{prof['ms_per_step']:.2f}, idle share "
              f"{prof['device_idle_share']:.4f}, by kind "
              f"{json.dumps(prof['ms_per_step_by_kind'])}, collectives by "
              f"op {json.dumps(prof['collective_ms_per_step_by_op'])}")
        losses = [x["loss"] for x in rows]
        _check(all(math.isfinite(x) for x in losses)
               and all(math.isfinite(x["grad_norm"]) for x in rows),
               f"{label} {name}: losses {losses}")
        _check(losses[-1] < losses[0],
               f"{label} {name}: the loss did not fall: {losses}")
        _check(live == budget["local_bytes"],
               f"{label} {name}: live bytes {live} vs the plan's "
               f"{budget['local_bytes']}")
        n_leaves = len(list(tree_leaves(state.params)))
        for x in rows:
            want_adamw = n_leaves if name == "fused" else 0
            _check(x["launches"]["adamw_update"] == (0 if r.cpu
                                                     else want_adamw),
                   f"full depth {name}: launches {x['launches']}")
            if not r.cpu:
                _check(all(x["launches"][k] == cfg.n_layers for k in (
                    "flash_fwd", "flash_bwd_dkv", "flash_bwd_dq",
                    "dw_gateup")), f"{label} {name}: {x['launches']}")
        del state, step_fn, init_fn, optimizer
    r.free()
    return out


# (j): each layout (name, mesh, n_micro, optimizer) against one card
PP_LAYOUTS = (("pp2xtp2", {"pp": 2, "tp": 2}, 4, "default"),
              ("pp2xtp2 fused", {"pp": 2, "tp": 2}, 4, "fused"),
              ("pp4", {"pp": 4}, 4, "default"),
              ("dp2xpp2", {"dp": 2, "pp": 2}, 2, "default"),
              # n_micro the global batch, not a rank's 2 rows: each rank
              # runs its 2 of the 4 global microbatches (ROADMAP A.7.6)
              ("dp2xpp2 n_micro 4", {"dp": 2, "pp": 2}, 4, "default"))
# (j)'s bubble sweep: pp 4, one row a microbatch
PP_SWEEP_MICRO = (1, 2, 4, 8)


def _pp_cfg(r: Rank, n_layers: int):
    """The pipeline's config: the 8B width (`tiny` on the CPU) of
    `n_layers`, the `_layer` path it runs whatever the fused flags say,
    remat "dots", whole logits."""
    return dataclasses.replace(r.sizes.cfg(r.cpu, n_layers), fused_ffn=False,
                               fused_attn=False, loss_chunk=0, remat="dots")


def _pp_launches(cfg, pp: int, n_micro: int, n_leaves: int,
                 fused: bool) -> Dict[str, int]:
    """A stage's launches a step: under remat "dots" the flash forward
    twice a layer a microbatch (the recompute reruns it), the backward
    pair once; K1-K3 never (the stage runs `_layer`); AdamW once a local
    leaf under fused AdamW (every stage holds every leaf: the layers as
    its block, the rest whole)."""
    layers = cfg.n_layers // pp * n_micro
    return {"flash_fwd": 2 * layers, "flash_bwd_dkv": layers,
            "flash_bwd_dq": layers, "dw_gateup": 0, "dw_down": 0,
            "dgateup": 0, "adamw_update": n_leaves if fused else 0}


def _stages_of(r: Rank, mesh, value) -> List[Any]:
    """`value` from every rank, as [(pp stage, (dp, fsdp, tp) coordinate,
    value)] in rank order (a collective)."""
    coord = mesh.get_coordinate()
    out = [None] * r.world
    r.dist.all_gather_object(out, (coord[1], (coord[0], coord[2], coord[3]),
                                   value))
    return out


class _NoUpdate:
    """An optimizer that leaves the state as it is: the step's forward,
    backward and gradient reductions alone (the reference's bubble
    evidence times the pipeline without its optimizer,
    __graft_entry__.py:318-325)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer

    def init(self, params):
        return self.optimizer.init(params)

    def apply(self, grads, state, params, grad_norm=None):
        return state


def _p2p_share(r: Rank, step_fn, state, batch) -> Dict[str, float]:
    """A profile of 2 steps on the card: ms/step, the P2P hand-offs'
    device ms/step (NCCL SendRecv: a stage waiting for its neighbour
    waits in them) and their share of the step, the compute's share (the
    device time outside the collectives)."""
    _, prof = bench.profile_train(step_fn, state, batch, steps=2)
    p2p = prof["collective_ms_per_step_by_op"].get("SendRecv", 0.0)
    compute = (prof["device_ms_per_step"]
               - prof["ms_per_step_by_kind"].get("collectives", 0.0))
    return {"ms_per_step": prof["ms_per_step"], "p2p_ms_per_step": p2p,
            "p2p_share": p2p / prof["ms_per_step"],
            "busy_share": compute / prof["ms_per_step"],
            "collective_ms_per_step_by_op":
                prof["collective_ms_per_step_by_op"]}


def pp_parity(r: Rank) -> Dict[str, Any]:
    """(j): the pipeline at pp 2 x tp 2 (both optimizers), pp 4 and dp 2 x
    pp 2 against one card, each stage's launches; the bubble sweep at pp
    4; the dryrun's pp step."""
    from ray_tpu_torch.models.transformer import init_params, tree_leaves
    from ray_tpu_torch.parallel.pipeline import (Stages, make_pp_train_step,
                                                 micro_rows)
    from ray_tpu_torch.train import (default_optimizer,
                                     fused_adamw_optimizer, shard_batch)

    _need_four(r, "pp_parity")
    sz = r.sizes
    cfg = _pp_cfg(r, max(sz.parity_layers, 4))
    n_leaves = len(list(tree_leaves(init_params(cfg, device="meta"))))
    batch = bench.make_batch(cfg, 4, sz.parity_seq, r.seed + 1, r.dev)
    makes = {"default": default_optimizer, "fused": fused_adamw_optimizer}
    ref = _one_card(r, {k: (cfg, make, False) for k, make in makes.items()},
                    batch, sz.steps_parity)
    for key, one in ref.items():
        r.log(f"pp parity: one card, {key}, {cfg.n_layers} layers, batch 4 "
              f"x {sz.parity_seq}: " + _brief(one))
    out = {"layers": cfg.n_layers, "batch": [4, sz.parity_seq],
           "one_card": ref}
    for name, mesh_kw, n_micro, key in PP_LAYOUTS:
        r.free()
        mesh = r.mesh(**mesh_kw)
        step_fn, init_fn, _ = make_pp_train_step(
            cfg, mesh, makes[key](warmup_steps=2), n_micro, r.dev)
        local = shard_batch(batch, mesh)
        st = Stages.from_mesh(mesh)
        # the microbatches a stage runs: n_micro, or its rows' share of
        # them where n_micro does not divide its rows
        n_local = len(micro_rows(local["inputs"].shape[0], n_micro,
                                 st.rows_index, st.rows_blocks))
        state, rows = _steps(r, step_fn, init_fn(r.seed), local,
                             sz.steps_parity)
        stages = _stages_of(r, mesh, {"launches": rows[0]["launches"],
                                      "peak_gib": r.peak_gib()})
        res = {"mesh": mesh_kw, "n_micro": n_micro, "optimizer": key,
               "microbatches_a_rank": n_local, "steps": rows,
               "stages": stages,
               "ms_per_step": statistics.mean(x["ms"] for x in rows[1:])}
        out[name] = res
        r.log(f"pp parity {name}, n_micro {n_micro}: " + _brief(res))
        _compare(name, rows, ref[key]["steps"], launches=False)
        if not r.cpu:
            pp = mesh_kw["pp"]
            want = _pp_launches(cfg, pp, n_local, n_leaves, key == "fused")
            for x in rows:
                _check(x["launches"] == want, f"pp parity {name}: launches "
                       f"{x['launches']} vs {want}")
            # one (dp, fsdp, tp) coordinate's stages: one card's flash
            # launches as many times over as a stage runs microbatches
            for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
                got = sum(v["launches"][k] for _, c, v in stages
                          if c == (0, 0, 0))
                one = ref[key]["steps"][0]["launches"][k]
                _check(got == one * n_local, f"pp parity {name}: {k} "
                       f"{got} over the stages vs one card's {one} x "
                       f"{n_local}")
        del state, step_fn, init_fn, mesh, local
    r.free()
    out["bubble_sweep"] = _pp_sweep(r, cfg)
    out["dryrun_pp"] = _dryrun_pp(r)
    return out


def _pp_sweep(r: Rank, cfg) -> List[Dict[str, Any]]:
    """(j)'s timing: pp 4, one row of parity_seq a microbatch, n_micro
    rows a step, the step without its optimizer update (`_NoUpdate`):
    ms/step (steps 2-4), ms a row, the overhead as the reference measures
    it (ms a row over the largest n_micro's, times that one's model)
    beside the model (n_micro + pp - 1) / n_micro, each stage's P2P and
    busy shares."""
    from ray_tpu_torch.parallel.pipeline import make_pp_train_step
    from ray_tpu_torch.train import default_optimizer, shard_batch

    pp, seq = 4, r.sizes.parity_seq
    mesh = r.mesh(pp=pp)
    rows = []
    for n_micro in PP_SWEEP_MICRO:
        r.free()
        batch = shard_batch(bench.make_batch(cfg, n_micro, seq, r.seed + 2,
                                             r.dev), mesh)
        step_fn, init_fn, _ = make_pp_train_step(
            cfg, mesh, _NoUpdate(default_optimizer()), n_micro, r.dev)
        state, steps = _steps(r, step_fn, init_fn(r.seed), batch,
                              r.sizes.steps_parity)
        ms = statistics.mean(x["ms"] for x in steps[1:])
        host = statistics.mean(x["host_ms"] for x in steps[1:])
        row = {"n_micro": n_micro, "rows": n_micro, "ms_per_step": ms,
               "host_ms_per_step": _stages_of(r, mesh, host),
               "ms_per_row": ms / n_micro,
               "model_overhead": (n_micro + pp - 1) / n_micro}
        if not r.cpu:
            row["stages"] = _stages_of(r, mesh, _p2p_share(r, step_fn,
                                                           state, batch))
        rows.append(row)
        del state, step_fn, init_fn, batch
    base = rows[-1]
    for row in rows:
        row["measured_overhead"] = (row["ms_per_row"] / base["ms_per_row"]
                                    * base["model_overhead"])
        r.log("pp bubble sweep, pp 4: " + json.dumps(row))
    del mesh
    r.free()
    return rows


def _dryrun_pp(r: Rank) -> Dict[str, Any]:
    """The dryrun's pp step (__graft_entry__.py:150-174): `tiny`, pp 2 x tp
    2, n_micro 2, one step of `default_optimizer(1e-3)` on 4 rows of 64: a
    finite loss."""
    from ray_tpu_torch.models import ModelConfig
    from ray_tpu_torch.parallel.pipeline import make_pp_train_step
    from ray_tpu_torch.train import default_optimizer, shard_batch

    cfg = ModelConfig.tiny()
    mesh = r.mesh(pp=2, tp=2)
    step_fn, init_fn, _ = make_pp_train_step(cfg, mesh, default_optimizer(
        1e-3), 2, r.dev)
    batch = shard_batch(bench.make_batch(cfg, 4, 64, r.seed + 2, r.dev),
                        mesh)
    _, m = step_fn(init_fn(r.seed), batch)
    loss = float(m["loss"])
    r.log(f"pp parity: the dryrun's pp step, pp 2 x tp 2, loss {loss:.4f}")
    _check(math.isfinite(loss), f"dryrun pp: loss {loss}")
    del step_fn, init_fn, mesh
    r.free()
    return {"loss": loss}


def pp_full_depth(r: Rank) -> Dict[str, Any]:
    """(k): Llama-3-8B at full depth on pp 2 x tp 2, (g)'s 4 rows of
    full_seq a step, n_micro 4, under each optimizer: checks and numbers
    beside (g)'s, then the bubble: each stage's P2P share of a step
    without its optimizer update."""
    from ray_tpu_torch.models import count_params
    from ray_tpu_torch.parallel.pipeline import make_pp_train_step
    from ray_tpu_torch.train import (default_optimizer,
                                     fused_adamw_optimizer, shard_batch)

    _need_four(r, "pp_full_depth")
    sz = r.sizes
    seq, n_micro, pp = sz.full_seq, 4, 2
    cfg = dataclasses.replace(_pp_cfg(r, sz.full_layers), max_seq_len=seq)
    mesh = r.mesh(pp=pp, tp=2)
    batch = shard_batch(bench.make_batch(cfg, 4, seq, r.seed + 1, r.dev),
                        mesh)
    out = {"layers": cfg.n_layers, "seq": seq, "rows": 4, "n_micro": n_micro,
           "mesh": {"pp": pp, "tp": 2},
           "model_bubble_share": (pp - 1) / (n_micro + pp - 1)}
    for name, make in (("default", default_optimizer),
                       ("fused", fused_adamw_optimizer)):
        r.free()
        step_fn, init_fn, _ = make_pp_train_step(cfg, mesh, make(
            warmup_steps=2), n_micro, r.dev)
        state = init_fn(r.seed)
        n_params = count_params(state.params)
        state, rows = _steps(r, step_fn, state, batch, sz.steps_full)
        ms = statistics.mean(x["ms"] for x in rows[2:])
        tput = bench.throughput(cfg, n_params, 1, seq, ms / 1e3, r.peak)
        res = {"n_params": n_params, "steps": rows, "ms_per_step": ms,
               "tokens_per_sec_per_card": tput["tokens_per_sec"],
               "mfu": tput["mfu"]}
        peak = r.peak_gib()
        if not r.cpu:
            state, prof = bench.profile_train(step_fn, state, batch, steps=2)
            res["profile"] = prof
        res["stages"] = _stages_of(r, mesh, {
            "peak_gib": peak, "collective_ms_per_step_by_op":
                res.get("profile", {}).get("collective_ms_per_step_by_op")})
        out[name] = res
        r.log(f"pp full depth {name}: " + _brief(
            {k: v for k, v in res.items() if k != "profile"}))
        losses = [x["loss"] for x in rows]
        _check(all(math.isfinite(x) for x in losses)
               and all(math.isfinite(x["grad_norm"]) for x in rows),
               f"pp full depth {name}: losses {losses}")
        _check(losses[-1] < losses[0],
               f"pp full depth {name}: the loss did not fall: {losses}")
        del state, step_fn, init_fn
    r.free()
    if not r.cpu:
        step_fn, init_fn, _ = make_pp_train_step(
            cfg, mesh, _NoUpdate(default_optimizer()), n_micro, r.dev)
        state, rows = _steps(r, step_fn, init_fn(r.seed), batch, 3)
        out["bubble"] = _stages_of(r, mesh, {
            **_p2p_share(r, step_fn, state, batch),
            "host_ms": [x["host_ms"] for x in rows[1:]],
            "synced_ms": [x["ms"] for x in rows[1:]]})
        r.log("pp full depth bubble (stage, coordinate, the step without "
              "its update): " + json.dumps(out["bubble"]))
        del state, step_fn, init_fn
    del mesh, batch
    r.free()
    return out


def reshard(r: Rank) -> Dict[str, Any]:
    """(c): saved at fsdp=world, restored onto dp 2 x fsdp world/2 (the
    result's top-level keys), onto fsdp 2 x tp world/2 ("to_tp") and onto
    the pipeline at pp 2 x tp world/2 ("to_pp")."""
    from ray_tpu_torch.parallel.fsdp import tree_paths
    from ray_tpu_torch.parallel.pipeline import make_pp_train_step
    from ray_tpu_torch.train import (abstract_like, default_optimizer,
                                     latest_checkpoint, load_checkpoint,
                                     make_train_step, save_checkpoint,
                                     shard_batch, state_shardings)

    sz = r.sizes
    cfg = sz.cfg(r.cpu, sz.parity_layers)
    # the pipeline runs `_layer` whatever the fused flags say: its next
    # loss is held against that path continued at fsdp=world
    plain = dataclasses.replace(cfg, fused_ffn=False, fused_attn=False)
    src = r.mesh(fsdp=r.world)
    targets = {"dp": ({"dp": 2, "fsdp": r.world // 2}, RESHARD_LOSS_RTOL),
               "tp": ({"fsdp": 2, "tp": r.world // 2}, FIRST_LOSS_RTOL),
               "pp": ({"pp": 2, "tp": r.world // 2}, FIRST_LOSS_RTOL)}
    batch = bench.make_batch(cfg, r.world, sz.parity_seq, r.seed + 1, r.dev)
    step_src, init_src = make_train_step(
        cfg, default_optimizer(warmup_steps=2), r.dev, mesh=src)
    state, _ = _steps(r, step_src, init_src(r.seed), shard_batch(batch, src),
                      2)
    root = Path(r.ckpt_root)
    if r.rank == 0:
        shutil.rmtree(root, ignore_errors=True)
    r.dist.barrier()
    results = {}
    try:
        r.sync()
        t0 = time.perf_counter()
        path = save_checkpoint(state, str(root), step=2)
        save_s = time.perf_counter() - t0
        on_disk = r.from_rank0(sum(f.stat().st_size for f in Path(
            path).rglob("*") if f.is_file()) if r.rank == 0 else None)
        for name, (layout, rtol) in targets.items():
            dst = r.mesh(**layout)
            if name == "pp":
                step_dst, _, sh = make_pp_train_step(
                    plain, dst, default_optimizer(warmup_steps=2), 2, r.dev)
            else:
                step_dst = make_train_step(
                    cfg, default_optimizer(warmup_steps=2), r.dev,
                    mesh=dst)[0]
                sh = state_shardings(cfg, dst, default_optimizer())
            target = abstract_like(state, sh)
            t0 = time.perf_counter()
            restored, meta = load_checkpoint(latest_checkpoint(str(root)),
                                             target)
            r.sync()
            load_s = time.perf_counter() - t0
            res = _check_restored(r, state, restored, dst, tree_paths)
            res.update({"to": layout, "restore_s": load_s, "meta": meta,
                        "step": restored.step,
                        "count": restored.opt_state.count})
            _check((restored.step, restored.opt_state.count) == (2, 2),
                   f"reshard: restored step {restored.step}, count "
                   f"{restored.opt_state.count}")
            _, m_dst = step_dst(restored, shard_batch(batch, dst))
            res["next_loss"] = {"resharded": float(m_dst["loss"])}
            results[name] = res
            del restored, target, step_dst, dst
            r.free()
        again, _ = load_checkpoint(latest_checkpoint(str(root)), abstract_like(
            state, state_shardings(plain, src, default_optimizer())))
        _, m = make_train_step(plain, default_optimizer(warmup_steps=2),
                               r.dev, mesh=src)[0](again,
                                                   shard_batch(batch, src))
        results["pp"]["next_loss"]["continued"] = float(m["loss"])
        del again
        r.free()
    finally:
        r.dist.barrier()
        if r.rank == 0:
            shutil.rmtree(root, ignore_errors=True)
    # the step updates the state in place: continue it after the restores
    _, m_src = step_src(state, shard_batch(batch, src))
    continued = float(m_src["loss"])
    for name, (layout, rtol) in targets.items():
        res = results[name]
        want = res["next_loss"].setdefault("continued", continued)
        r.log(f"reshard onto {layout}: " + json.dumps(res))
        _check(_rel(res["next_loss"]["resharded"], want) <= rtol,
               f"reshard onto {layout}: next loss "
               f"{res['next_loss']['resharded']} vs {want}")
    out = {"layers": cfg.n_layers, "from": {"fsdp": r.world},
           "bytes_on_disk": on_disk, "save_s": save_s, **results["dp"],
           "to_tp": results["tp"], "to_pp": results["pp"]}
    del state
    r.free()
    return out


def _check_restored(r: Rank, state, restored, dst, tree_paths
                    ) -> Dict[str, Any]:
    """Every leaf of `restored` equal to `state`'s whole and on `dst`."""
    trees = [{"params": s.params, "mu": s.opt_state.mu,
              "nu": s.opt_state.nu} for s in (state, restored)]
    differ, off_mesh = [], []
    for (path, a), (_, b) in zip(tree_paths(trees[0]), tree_paths(trees[1]),
                                 strict=True):
        if not torch.equal(a.full_tensor(), b.full_tensor()):
            differ.append(path)
        if b.device_mesh is not dst:
            off_mesh.append(path)
    n_leaves = len(list(tree_paths(trees[0])))
    _check(not differ, f"reshard: leaves differ after the restore: {differ}")
    _check(not off_mesh, f"reshard: leaves not on the target mesh: "
           f"{off_mesh}")
    return {"leaves": n_leaves, "bit_identical_leaves": n_leaves - len(differ)}


def collectives(r: Rank) -> Dict[str, Any]:
    """(d): the fsdp gather and reduce-scatter at each distinct shard size
    of the 8B step (bf16), and tp's activation all-reduce, timed by CUDA
    events over 20 calls after 5."""
    from ray_tpu_torch.models import ModelConfig, init_params
    from ray_tpu_torch.models.planning import H100_NVLINK_BW
    from ray_tpu_torch.models.transformer import param_logical_axes
    from ray_tpu_torch.parallel.fsdp import FSDP, tree_paths
    from ray_tpu_torch.train import state_shardings, default_optimizer

    cfg = (dataclasses.replace(ModelConfig.tiny(), dtype=torch.bfloat16)
           if r.cpu else ModelConfig.llama3_8b())
    mesh = r.mesh(fsdp=r.world)
    fsdp = FSDP(mesh, state_shardings(cfg, mesh, default_optimizer()).params,
                param_logical_axes(cfg))
    n = r.world
    shapes: Dict[tuple, List[str]] = {}  # a gathered shard (one layer's)
    for path, t in tree_paths(init_params(cfg, device="meta")):
        dim = fsdp.dims[path]
        if dim is not None:
            shape = list(t.shape[1:] if path.startswith("layers/")
                         else t.shape)
            shape[dim] //= n
            shapes.setdefault(tuple(shape), []).append(path)
    out = []
    for shape, paths in sorted(shapes.items()):
        shard = torch.randn(shape, device=r.dev).to(torch.bfloat16)
        full = torch.empty((n * shape[0], *shape[1:]), dtype=shard.dtype,
                           device=r.dev)
        row = {"leaves": paths, "shard": list(shape),
               "full_bytes": full.numel() * full.element_size()}
        for name, fn in (
                ("all_gather", lambda: r.dist.all_gather_into_tensor(
                    full, shard, group=fsdp.fsdp_group)),
                ("reduce_scatter", lambda: r.dist.reduce_scatter_tensor(
                    shard, full, group=fsdp.fsdp_group))):
            ms = _time_ms(r, fn)
            alg = row["full_bytes"] / (ms / 1e3)
            row[name] = {"ms": ms, "algbw_gb_s": alg / 1e9,
                         "busbw_gb_s": alg * (n - 1) / n / 1e9}
        out.append(row)
        r.log(f"collectives over fsdp={n}: " + json.dumps(row))
    # tp's all-reduce of a layer's activations ([tokens, d_model] bf16) over
    # the tp group of fsdp world/tp x tp, for each tp that divides world
    act = torch.randn((64, 128) if r.cpu else (4096, cfg.d_model),
                      device=r.dev).to(torch.bfloat16)
    tp_rows = []
    for tp in (t for t in (2, 4) if n % t == 0 and t <= n):
        group = r.mesh(fsdp=n // tp, tp=tp).get_group("tp")
        ms = _time_ms(r, lambda: r.dist.all_reduce(act, group=group))
        nbytes = act.numel() * act.element_size()
        alg = nbytes / (ms / 1e3)
        row = {"tp": tp, "shape": list(act.shape), "bytes": nbytes,
               "all_reduce": {"ms": ms, "algbw_gb_s": alg / 1e9,
                              "busbw_gb_s": alg * 2 * (tp - 1) / tp / 1e9}}
        tp_rows.append(row)
        r.log(f"collectives: tp all-reduce: " + json.dumps(row))
    return {"rows": out, "tp_all_reduce": tp_rows,
            "H100_NVLINK_BW_gb_s": H100_NVLINK_BW / 1e9}


PPO_LOSS_RTOL, PPO_PARAMS_ATOL, TD_RTOL = 1e-5, 1e-6, 1e-5


def ppo_learner(r: Rank) -> Dict[str, Any]:
    """(m): the dryrun's PPO learner part on a dp mesh of every rank, and
    DQN's gathered td, each against rank 0's card alone."""
    import numpy as np

    from ray_tpu_torch.parallel import MeshConfig, make_mesh
    from ray_tpu_torch.rllib.dqn import DQNLearner
    from ray_tpu_torch.rllib.ppo import PPOLearner

    mesh = make_mesh(MeshConfig(dp=-1, fsdp=1, tp=1, sp=1),
                     device=r.dev.type)
    rng = np.random.default_rng(0)
    n = 8 * r.world
    batch = {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n),
        "logp": rng.normal(size=n).astype(np.float32) * 0.1 - 0.7,
        "advantages": rng.normal(size=n).astype(np.float32),
        "returns": rng.normal(size=n).astype(np.float32),
    }
    dqn_batch = {
        "obs": rng.normal(size=(n, 4)).astype(np.float32),
        "actions": rng.integers(0, 2, n),
        "rewards": rng.normal(size=n).astype(np.float32),
        "next_obs": rng.normal(size=(n, 4)).astype(np.float32),
        "dones": rng.integers(0, 2, n).astype(np.float32),
    }
    updates = 4

    def run(**kw):
        ppo = PPOLearner(obs_dim=4, num_actions=2, lr=1e-3,
                         device=r.dev.type, **kw)
        losses = [float(ppo.update(batch)["total_loss"])
                  for _ in range(updates)]
        dqn = DQNLearner(4, 2, lr=1e-3, gamma=0.99, device=r.dev.type, **kw)
        _, td = dqn.update_batch(dqn_batch)
        on = [str(t.device) for t in ppo.params.values()]
        return {"losses": losses, "params": ppo.get_weights(), "td": td,
                "devices": sorted(set(on))}

    one = r.from_rank0(run() if r.rank == 0 else None)
    t0 = time.perf_counter()
    got = run(mesh=mesh)
    seconds = time.perf_counter() - t0
    _check(all(math.isfinite(v) for v in got["losses"]),
           f"ppo learner: a non-finite loss {got['losses']}")
    loss_rel = max(_rel(a, b) for a, b in zip(got["losses"],
                                              one["losses"]))
    params_diff = max(float(np.abs(got["params"][k] - one["params"][k]).max())
                      for k in one["params"])
    td_rel = float(np.max(np.abs(got["td"] - one["td"])
                          / np.maximum(np.abs(one["td"]), 1e-6)))
    out = {"batch_rows": n, "updates": updates, "losses": got["losses"],
           "one_card_losses": one["losses"], "loss_max_rel": loss_rel,
           "params_max_abs": params_diff, "td_max_rel": td_rel,
           "td_rows": int(len(got["td"])), "devices": got["devices"],
           "mesh_update_seconds": seconds}
    r.log("ppo learner: " + json.dumps(out))
    _check(loss_rel <= PPO_LOSS_RTOL,
           f"ppo learner: total_loss {got['losses']} against one card's "
           f"{one['losses']} (rel {loss_rel:.2e} > {PPO_LOSS_RTOL})")
    _check(params_diff <= PPO_PARAMS_ATOL,
           f"ppo learner: params {params_diff:.2e} from one card's after "
           f"{updates} updates (> {PPO_PARAMS_ATOL})")
    _check(len(got["td"]) == n and td_rel <= TD_RTOL,
           f"dqn learner: the gathered td ({len(got['td'])} rows) "
           f"{td_rel:.2e} from one card's")
    _check(got["devices"] == [str(r.dev)],
           f"ppo learner: params on {got['devices']}, not {r.dev}")
    out["continuous"] = continuous_learners(r, mesh)
    return out


def continuous_learners(r: Rank, mesh) -> Dict[str, Any]:
    """(m)'s continuous family: DDPG's learner (twin critics, the actor
    delayed by 2, polyak targets) and SAC's (its standard normals drawn
    from the learner's generator on the card: each rank draws the whole
    batch's and keeps its rows) on the dp mesh, 3 updates of a
    Pendulum-shaped batch, each against rank 0's card alone: losses
    within PPO_LOSS_RTOL, params and targets within PPO_PARAMS_ATOL."""
    import numpy as np

    from ray_tpu_torch.rllib.ddpg import DDPGLearner
    from ray_tpu_torch.rllib.sac import SACLearner

    rng = np.random.default_rng(1)
    n = 16 * r.world
    batch = {"obs": rng.normal(size=(n, 3)).astype(np.float32),
             "actions": rng.uniform(-1, 1, (n, 1)).astype(np.float32),
             "rewards": rng.normal(size=n).astype(np.float32),
             "next_obs": rng.normal(size=(n, 3)).astype(np.float32),
             "dones": np.zeros(n, np.float32)}
    makers = {
        "ddpg": lambda **kw: DDPGLearner(
            3, 1, 1.0, actor_lr=1e-3, critic_lr=1e-3, gamma=0.99, tau=0.05,
            twin_q=True, smooth_target_policy=False, target_noise=0.0,
            target_noise_clip=0.0, seed=2, policy_delay=2,
            device=r.dev.type, **kw),
        "sac": lambda **kw: SACLearner(
            3, 1, 1.0, lr=3e-4, gamma=0.99, tau=0.05, target_entropy=-1.0,
            seed=4, device=r.dev.type, **kw)}

    def run(name, **kw):
        learner = makers[name](**kw)
        losses = [learner.update_batch(batch)["total_loss"]
                  for _ in range(3)]
        flat = {f"{k}/{n}": v for k, tree in learner.get_weights().items()
                for n, v in (tree.items() if isinstance(tree, dict)
                             else [("", tree)])}
        flat.update({f"target/{k}/{n}": v.cpu().numpy()
                     for k, tree in learner.extra.items()
                     for n, v in tree.items()})
        on = {str(t.device) for tree in learner.params.values()
              for t in (tree.values() if isinstance(tree, dict) else [tree])}
        return {"losses": losses, "params": flat, "devices": sorted(on)}

    out = {}
    for name in makers:     # both learners' figures first, then the checks
        one = r.from_rank0(run(name) if r.rank == 0 else None)
        got = run(name, mesh=mesh)
        loss_rel = max(_rel(a, b) for a, b in zip(got["losses"],
                                                  one["losses"]))
        diffs = {k: float(np.abs(got["params"][k] - one["params"][k]).max())
                 for k in one["params"]}
        worst = max(diffs, key=diffs.get)
        out[name] = {"batch_rows": n, "updates": 3,
                     "losses": got["losses"],
                     "one_card_losses": one["losses"],
                     "loss_max_rel": loss_rel,
                     "params_max_abs": diffs[worst],
                     "params_max_abs_at": worst,
                     "devices": got["devices"]}
        r.log(f"{name} learner: " + json.dumps(out[name]))
    for name, o in out.items():
        _check(all(math.isfinite(v) for v in o["losses"])
               and o["loss_max_rel"] <= PPO_LOSS_RTOL,
               f"{name} learner: total_loss {o['losses']} against one "
               f"card's {o['one_card_losses']} (rel "
               f"{o['loss_max_rel']:.2e} > {PPO_LOSS_RTOL})")
        _check(o["params_max_abs"] <= PPO_PARAMS_ATOL,
               f"{name} learner: params {o['params_max_abs']:.2e} from one "
               f"card's after 3 updates, at {o['params_max_abs_at']} "
               f"(> {PPO_PARAMS_ATOL})")
        _check(o["devices"] == [str(r.dev)],
               f"{name} learner: params on {o['devices']}, not {r.dev}")
    return out


def _trainer_loop(config: Dict[str, Any]) -> None:
    """(l)'s worker loop: the group's world and a DeviceMesh through
    `MeshTrainer.prepare_mesh` (fsdp over the workers), (a)'s step on this
    worker's share of (a)'s batch; each step rank 0 reports the loss, the
    grad norm and every worker's grant, current card and process."""
    import os

    import torch.distributed as dist

    import ray_tpu_torch as rt
    from ray_tpu_torch.air import session
    from ray_tpu_torch.parallel import MeshConfig, shutdown_group
    from ray_tpu_torch.train import (MeshTrainer, default_optimizer,
                                     make_train_step, shard_batch)

    cpu = config["cpu"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = session.get_world_size()
    mesh = MeshTrainer.prepare_mesh(MeshConfig(fsdp=world),
                                    device="cpu" if cpu else "cuda")
    try:
        dev = torch.device("cpu") if cpu else torch.device(
            "cuda", torch.cuda.current_device())
        sizes = CPU_SIZES if cpu else GPU_SIZES
        cfg = sizes.cfg(cpu, sizes.parity_layers)
        batch = shard_batch(bench.make_batch(
            cfg, config["rows"], sizes.parity_seq, SEED + 1, dev), mesh)
        step_fn, init_fn = make_train_step(
            cfg, default_optimizer(warmup_steps=2), dev, mesh=mesh)
        state = init_fn(SEED)
        grants = [None] * world
        dist.all_gather_object(grants, {
            "rank": session.get_world_rank(), "gpu_ids": rt.get_gpu_ids(),
            "current_device": None if cpu else torch.cuda.current_device(),
            "pid": os.getpid()})
        for i in range(sizes.steps_parity):
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            loss, norm = float(m["loss"]), float(m["grad_norm"])
            session.report({"step": i + 1, "loss": loss, "grad_norm": norm,
                            "ms": 1e3 * (time.perf_counter() - t0),
                            "grants": grants})
    finally:
        shutdown_group()


def trainer(chips: int, cpu: bool) -> Dict[str, Any]:
    """(l), driven from the launching process: the port's runtime with
    `chips` GPUs on one node, a MeshTrainer of 1 worker, then one of
    `chips` workers (`use_gpu`; on the CPU `{"GPU": 1}` bundles and gloo),
    each fit (a)'s step on (a)'s batch. Checks: every worker's grant is its
    current card, the grants differ, and the losses are within (a)'s bounds
    against the 1-worker fit."""
    import ray_tpu_torch as rt
    from ray_tpu_torch import multichip  # the loop by reference, as __main__
    from ray_tpu_torch.air import ScalingConfig
    from ray_tpu_torch.train import MeshTrainer

    def log(msg):
        print(f"multichip: trainer: {msg}", flush=True)

    rt.init(num_cpus=max(8, 2 * chips), resources={"GPU": chips})
    out: Dict[str, Any] = {}
    try:
        for n in (1, chips):
            t0 = time.perf_counter()
            sc = (ScalingConfig(num_workers=n, resources_per_worker={
                "GPU": 1}) if cpu else ScalingConfig(num_workers=n,
                                                     use_gpu=True))
            result = MeshTrainer(
                multichip._trainer_loop, train_loop_config={"cpu": cpu,
                                                  "rows": chips},
                scaling_config=sc).fit()
            _check(result.error is None, f"trainer, {n} workers: "
                   f"{result.error}")
            hist = result.metrics_history
            grants = hist[-1]["grants"]
            rows = [{"loss": m["loss"], "grad_norm": m["grad_norm"],
                     "ms": m["ms"]} for m in hist]
            out[f"workers_{n}"] = {"steps": rows, "grants": grants,
                                   "seconds": time.perf_counter() - t0}
            log(f"{n} workers: losses {[x['loss'] for x in rows]}, grad "
                f"norms {[x['grad_norm'] for x in rows]}, ms "
                f"{[round(x['ms'], 2) for x in rows]}, grants {grants}, "
                f"{out[f'workers_{n}']['seconds']:.1f} s")
            ids = [g["gpu_ids"] for g in grants]
            _check(len(grants) == n and all(len(i) == 1 for i in ids)
                   and len({i[0] for i in ids}) == n,
                   f"trainer, {n} workers: grants {grants}")
            if not cpu:
                _check(all(g["current_device"] == g["gpu_ids"][0]
                           for g in grants),
                       f"trainer, {n} workers: current cards {grants}")
        _compare(f"trainer {chips} workers", out[f"workers_{chips}"]["steps"],
                 out["workers_1"]["steps"], launches=False)
    finally:
        rt.shutdown()
    return out


def _time_ms(r: Rank, fn) -> float:
    """ms a call of `fn` over 20 calls after 5 (CUDA events on the card,
    the host clock on the CPU)."""
    for _ in range(5):
        fn()
    r.sync()
    if r.cpu:
        t0 = time.perf_counter()
        for _ in range(20):
            fn()
        return 1e3 * (time.perf_counter() - t0) / 20
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(20):
        fn()
    b.record()
    r.sync()
    return a.elapsed_time(b) / 20


def _smi() -> List[str]:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()


def _rank_main(rank: int, world: int, port: int, opts: Dict[str, Any]
               ) -> None:
    from ray_tpu_torch.parallel import initialize_group, shutdown_group

    cpu = opts["cpu"]
    initialize_group(rank, world, device="cpu" if cpu else "cuda",
                     timeout=GROUP_TIMEOUT_S,
                     init_method=f"tcp://127.0.0.1:{port}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        r = Rank(rank, world, cpu, SEED, opts["ckpt_root"])
        if opts["full_layers"]:
            r.sizes = dataclasses.replace(r.sizes,
                                          full_layers=opts["full_layers"])
        results: Dict[str, Any] = {
            "chips": world, "device": "cpu" if cpu else
            torch.cuda.get_device_name(r.dev),
            "nvidia_smi": None if cpu else _smi(),
            "torch": torch.__version__}
        r.log(f"{world} ranks on {results['device']}: "
              f"{results['nvidia_smi']}")
        for phase in opts["phases"]:
            if phase in LAUNCHER_PHASES:
                continue
            t0 = time.perf_counter()
            results[phase] = globals()[phase](r)
            results[phase]["seconds"] = time.perf_counter() - t0
            r.log(f"{phase}: {results[phase]['seconds']:.1f} s")
        if rank == 0:
            path = Path(opts["json"])
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(results, indent=1))
    finally:
        shutdown_group()


def main(argv=None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="rehearse on gloo CPU ranks at tiny widths")
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--json", default=str(REPO / "build" /
                                          "MULTICHIP_torch.json"))
    ap.add_argument("--ckpt-root", default=str(REPO / "build" /
                                               "multichip_ckpt"))
    ap.add_argument("--full-layers", type=int, default=None,
                    help="depth of phase full_depth (default 32; fewer to "
                         "rehearse it on fewer cards)")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        raise ValueError(f"unknown phases {unknown}; choose from {PHASES}")
    if "reshard" in phases and (args.chips < 2 or args.chips % 2):
        raise ValueError("phase reshard restores onto dp 2 x fsdp chips/2: "
                         "--chips must be even")
    four = sorted(set(phases) & set(FOUR_RANK_PHASES))
    if four and args.chips != 4:
        raise ValueError(f"phases {four} lay out four ranks: --chips 4")
    if not args.cpu:
        require_cuda("cuda")
        have = torch.cuda.device_count()
        if have < args.chips:
            raise RuntimeError(f"--chips {args.chips} but this host has "
                               f"{have} cards")
        from ray_tpu_torch.ops.kernels import _util

        # built once here: every rank then loads the same libraries
        _util.build(["flash_attention", "fused_ffn", "adamw"])
    results: Dict[str, Any] = {}
    if any(p not in LAUNCHER_PHASES for p in phases):
        results = _run_ranks(args, phases)
    if "trainer" in phases:
        t0 = time.perf_counter()
        results["trainer"] = trainer(args.chips, args.cpu)
        results["trainer"]["seconds"] = time.perf_counter() - t0
        path = Path(args.json)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(results, indent=1))
    print(json.dumps({k: v for k, v in results.items()
                      if k in ("chips", "device", "nvidia_smi")}),
          flush=True)
    return results


def _run_ranks(args, phases: List[str]) -> Dict[str, Any]:
    """The rank phases: one process a card (gloo CPU ranks with --cpu),
    rank 0 writing the results to --json; returns them."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    opts = {"cpu": args.cpu, "phases": phases,
            "full_layers": args.full_layers, "json": args.json,
            "ckpt_root": args.ckpt_root}
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(rank, args.chips, port,
                                                  opts))
             for rank in range(args.chips)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + RUN_TIMEOUT_S
    try:
        while any(p.is_alive() for p in procs):
            failed = [p.exitcode for p in procs if p.exitcode]
            if failed or time.monotonic() > deadline:
                raise SystemExit(f"multichip: a rank failed (exit codes "
                                 f"{[p.exitcode for p in procs]}) or the "
                                 f"run outlasted {RUN_TIMEOUT_S} s")
            time.sleep(1.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        raise SystemExit(f"multichip: rank exit codes {codes}")
    return json.loads(Path(args.json).read_text())


if __name__ == "__main__":
    main()
