"""8B planning for H100s (twin of ray_tpu/models/planning.py): the memory
budget of `ModelConfig.llama3_8b()` training at full depth, sharded over
fsdp x tp cards of one NVLink domain, and a projected step time and MFU.

Everything is derived, not asserted: parameter, gradient and optimizer
bytes come from the meta-device `init_params` and `optimizer.init` (the
counterpart of the reference's `jax.eval_shape`: no weight is
materialized); activation bytes follow the reference's model of the
dots-remat saved set; the throughput projection applies the phase
efficiencies measured on the card (`measure_phase_eff`, on the real
8-layer all-kernel step under the same optimizer) to the 8B FLOP mix, with
the fsdp collectives' time modelled from their volume at NVLink's rate.
`_budget` does the arithmetic for any config, optimizer and mesh;
`eightb_plan` applies it to the 8B plan under `default_optimizer`, as the
reference does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch

from ray_tpu_torch.models.transformer import ModelConfig, init_params
from ray_tpu_torch.ops.kernels._util import require_cuda, tree_leaves
from ray_tpu_torch.ops.kernels.adamw import FusedAdamW

GIB = 1 << 30

# H100 SXM data sheet (dense rates at the 700 W limit; not measured): the
# bf16 tensor-core rate, HBM3 size and rate, and NVLink 4 a direction.
H100_PEAK_FLOPS = 989e12
H100_HBM_BYTES = 80e9
H100_HBM_BW = 3.35e12
H100_NVLINK_BW = 450e9

# Achieved fraction of each phase's ideal time, by optimizer, measured by
# `measure_phase_eff` (chip_smoke.py phase 14) on the real 8-layer
# all-kernel step at llama3_8b width, batch 2 x 2048, 4 steps, on an
# NVIDIA H100 80GB HBM3 at a 700.00 W power limit. "default" is
# `default_optimizer` (eager passes a leaf, one host sync a step): forward
# 51.099, backward 102.721, optimizer 122.024 ms against 23.712, 47.424 and
# 15.021 ideal; "fused" is `fused_adamw_optimizer` (one AdamW kernel a
# leaf): 50.754, 103.142, 23.850 ms against 23.712, 47.424, 18.359.
PHASE_EFF = {
    "default": {"forward": 0.4640, "backward": 0.4617, "optimizer": 0.1231},
    "fused": {"forward": 0.4672, "backward": 0.4598, "optimizer": 0.7698},
}


def _optimizer_kind(optimizer: Any) -> str:
    """PHASE_EFF's key for `optimizer`: "fused" for `FusedAdamW`, else
    "default" (the eager update of `default_optimizer`)."""
    return "fused" if isinstance(optimizer, FusedAdamW) else "default"


def _tree_bytes(tree: Any) -> int:
    """Bytes of the tensors of a tree of dicts and dataclasses (ints, such
    as an optimizer's update count, hold none on the device)."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return sum(_tree_bytes(getattr(tree, f.name))
                   for f in dataclasses.fields(tree))
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return 0


def _budget(cfg: ModelConfig, optimizer: Any, n_chips: int, fsdp: int,
            tp: int, tokens: int, seq: int) -> Dict[str, Any]:
    """Bytes and projected seconds of `cfg` trained with `optimizer` over
    fsdp x tp = n_chips cards, `tokens` tokens a card a step of `seq`-long
    sequences, at the phase efficiencies measured under that optimizer.
    Raises if the sharding does not divide."""
    if fsdp * tp != n_chips:
        raise ValueError(f"fsdp={fsdp} x tp={tp} is not n_chips={n_chips}")
    # tp shards heads/mlp; fsdp shards everything ZeRO-3 style
    for name, dim in (("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads),
                      ("d_ff", cfg.d_ff), ("vocab", cfg.vocab_size)):
        if dim % tp:
            raise ValueError(f"tp={tp} does not divide {name}={dim}")

    p_shape = init_params(cfg, device="meta")
    o_shape = optimizer.init(p_shape)
    n_params = sum(t.numel() for t in tree_leaves(p_shape))
    param_bytes = _tree_bytes(p_shape)
    opt_bytes = _tree_bytes(o_shape)
    grad_bytes = param_bytes                    # grads in the param dtype
    shards = fsdp * tp
    state_per_chip = (param_bytes + opt_bytes + grad_bytes) / shards

    # Activations under dots remat, per layer, per card: the saved set is
    # the dot outputs (qkv 2d as an upper bound at GQA, attn out d, attn
    # proj d, gate + up 2·d_ff, down d) + the layer's carry, in bf16, the
    # tokens split over fsdp and the widths over tp.
    d, dff = cfg.d_model, cfg.d_ff
    saved_per_token = 2 * d + d + d + 2 * dff + d + d
    act_bytes = tokens * saved_per_token * 2 / tp * cfg.n_layers
    # logits working set with the chunked loss (loss_chunk=512): chunk x V
    # float32
    logits_bytes = 512 * cfg.vocab_size * 4 / tp
    headroom = H100_HBM_BYTES - state_per_chip - act_bytes - logits_bytes

    # ---- throughput projection from the measured phase efficiencies
    kind = _optimizer_kind(optimizer)
    eff = PHASE_EFF[kind]
    attn_flops_tok = 6 * cfg.n_layers * cfg.d_model * seq
    flops_tok = 6 * n_params + attn_flops_tok
    fwd_ideal = flops_tok / 3 / H100_PEAK_FLOPS     # s/token/card at peak
    bwd_ideal = 2 * flops_tok / 3 / H100_PEAK_FLOPS
    # optimizer: a bandwidth-bound sweep of the card's share of the state
    opt_sweep_bytes = (param_bytes * 2 + opt_bytes * 2 + grad_bytes) / shards
    step_compute_s = tokens * (fwd_ideal / eff["forward"]
                               + bwd_ideal / eff["backward"])
    opt_s = opt_sweep_bytes / H100_HBM_BW / eff["optimizer"]
    # fsdp collectives per step: all-gather params forward and backward,
    # reduce-scatter grads, 3 param sweeps over NVLink (ZeRO-3), half of it
    # overlapped, and up to 0.3 of the compute hides the rest
    link_bytes = 3 * param_bytes / tp if shards > 1 else 0
    link_s = link_bytes / H100_NVLINK_BW * 0.5
    step_s = step_compute_s + opt_s + max(link_s - 0.3 * step_compute_s, 0)
    tok_s_chip = tokens / step_s
    return {
        "optimizer": kind,
        "phase_eff": dict(eff),
        "n_params": n_params,
        "param_bytes": param_bytes,
        "grad_bytes": grad_bytes,
        "optimizer_bytes": opt_bytes,
        "per_chip_bytes": {
            "params": param_bytes / shards,
            "grads": grad_bytes / shards,
            "optimizer": opt_bytes / shards,
            "activations": act_bytes,
            "logits": logits_bytes,
            "total": state_per_chip + act_bytes + logits_bytes,
            "headroom": headroom,
        },
        "flops_per_token": flops_tok,
        "nvlink_bytes_per_step": link_bytes,
        "step_s": step_s,
        "tokens_per_sec_per_chip": tok_s_chip,
        "mfu": tok_s_chip * flops_tok / H100_PEAK_FLOPS,
    }


def eightb_plan(n_chips: int = 4, fsdp: int = 4, tp: int = 1,
                batch_per_chip_tokens: int = 4096,
                seq: int = 4096) -> Dict[str, Any]:
    """The budget and projection dict for llama3_8b, 32 layers, on an
    fsdp x tp = n_chips set of H100s under `default_optimizer`. Raises if
    the sharding does not divide."""
    from ray_tpu_torch.train.step import default_optimizer

    cfg = dataclasses.replace(ModelConfig.llama3_8b(), max_seq_len=seq,
                              remat="dots")
    b = _budget(cfg, default_optimizer(), n_chips, fsdp, tp,
                batch_per_chip_tokens, seq)
    per = b["per_chip_bytes"]
    mfu = b["mfu"]
    return {
        "model": "llama3_8b",
        "n_params": b["n_params"],
        "cards": f"{n_chips} x H100 80GB (NVLink)",
        "mesh": {"fsdp": fsdp, "tp": tp},
        "per_chip": {
            "hbm_gib": round(H100_HBM_BYTES / GIB, 2),
            "params_gib": round(per["params"] / GIB, 3),
            "grads_gib": round(per["grads"] / GIB, 3),
            "optimizer_gib": round(per["optimizer"] / GIB, 3),
            "activations_gib": round(per["activations"] / GIB, 3),
            "logits_gib": round(per["logits"] / GIB, 3),
            "headroom_gib": round(per["headroom"] / GIB, 3),
        },
        "batch_per_chip_tokens": batch_per_chip_tokens,
        "seq": seq,
        "projection": {
            "basis": "phase efficiencies measured on an H100 under "
                     "default_optimizer (PHASE_EFF) + the fsdp collectives "
                     "at NVLink's data-sheet rate",
            "optimizer": "default_optimizer",
            "phase_eff": b["phase_eff"],
            "nvlink_param_traffic_gib_per_step": round(
                b["nvlink_bytes_per_step"] / GIB, 3),
            "step_s": round(b["step_s"], 4),
            "tokens_per_sec_per_chip": round(b["tokens_per_sec_per_chip"],
                                             1),
            "projected_mfu": round(mfu, 4),
            # the phase model cannot see what one card never exercised
            # (collectives under real traffic, stragglers, host input);
            # 0.75x is the bound claimed against the north star
            "conservative_mfu": round(mfu * 0.75, 4),
            "north_star_mfu": 0.40,
            "meets_north_star": bool(mfu * 0.75 >= 0.40),
        },
    }


def measure_phase_eff(cfg: ModelConfig, optimizer: Any,
                      batch: Dict[str, torch.Tensor], *, steps: int = 4,
                      seed: int = 0, device="cuda") -> Dict[str, Any]:
    """Each phase of the real training step (`make_train_step`'s, under
    `optimizer`) timed by CUDA events recorded where the step launches it,
    over `steps` steps after one warm step: the forward, the backward, and
    the optimizer (the global norm and the update); and the achieved
    fraction of each phase's ideal time (the FLOPs at H100_PEAK_FLOPS, the
    update's state sweep at H100_HBM_BW). Needs the card: CUDA events time
    nothing on the CPU."""
    from ray_tpu_torch.train.step import make_train_step

    dev = require_cuda(device)
    if dev.type != "cuda":
        raise ValueError("measure_phase_eff times the card: pass a CUDA "
                         "device")
    marks = []

    def on_phase(name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    step_fn, init_fn = make_train_step(cfg, optimizer, dev,
                                       on_phase=on_phase)
    state = init_fn(seed)
    n_params = sum(t.numel() for t in tree_leaves(state.params))
    param_bytes = _tree_bytes(state.params)
    opt_bytes = _tree_bytes(state.opt_state)
    tokens = batch["inputs"].numel()
    seq = batch["inputs"].shape[1]

    ms = {"forward": [], "backward": [], "optimizer": []}
    for i in range(steps + 1):
        marks.clear()
        state, _ = step_fn(state, batch)
        torch.cuda.synchronize(dev)
        if i:  # the first step is the warm one
            for (phase, a), (_, b) in zip(marks, marks[1:]):
                ms[phase].append(a.elapsed_time(b))
    del state
    flops_tok = 6 * n_params + 6 * cfg.n_layers * cfg.d_model * seq
    ideal_ms = {
        "forward": 1e3 * tokens * flops_tok / 3 / H100_PEAK_FLOPS,
        "backward": 1e3 * tokens * 2 * flops_tok / 3 / H100_PEAK_FLOPS,
        "optimizer": 1e3 * (param_bytes * 3 + opt_bytes * 2) / H100_HBM_BW,
    }
    mean_ms = {k: sum(v) / len(v) for k, v in ms.items()}
    return {"eff": {k: ideal_ms[k] / mean_ms[k] for k in ms},
            "ms": mean_ms, "ideal_ms": ideal_ms, "steps": steps,
            "tokens": tokens, "n_params": n_params,
            "optimizer": _optimizer_kind(optimizer)}
