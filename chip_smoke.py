#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (ray_tpu_torch) on one GPU.

    python3 chip_smoke.py            # full run: Llama-3-8B shapes

Phases (any failure exits non-zero and prints no result line):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build every kernel of the serving and training paths from the sources
     in the checkout (one nvcc per source, started together), and log
     ptxas's registers, spills and shared memory of the wgmma kernels (the
     flash forward, dq and dk/dv at each head_dim; K1's, K3's and K2's TMA
     and cp.async instances), of the float32 K3, K1 and K2 at each tile
     and of the float32 flash forward, dq and dk/dv at each head_dim and
     tile, and of the wide family (the wgmma bf16 forward, dq and dk/dv
     and the register-tiled float32 forward, dq and dk/dv at each plan,
     with the dynamic shared memory their launch sets), with any ptxas
     warning; fail if a 128 x 128 float32 tile (an 8 x 8 patch a thread),
     a float32 flash kernel at head_dim 128, a wide wgmma kernel or a wide
     float32 kernel spills, or if ptxas serialized a wide kernel's products
     (C7515);
  3. hold each quant kernel against its plain PyTorch version on the card,
     bit for bit, at every shape the serving path gives it (the quant
     kernel's stacked [L, in, out] leaves included) and at the six 8B
     weight shapes, and time kernel, plain version and the bound with CUDA
     events (L2 flushed between calls);
  4. serve 12 requests through ContinuousBatchingEngine at llama3_8b full
     width and depth with random bf16 weights from a seeded generator, once
     in bf16 and once in w8a16, checking token counts, vocabulary range,
     agreement with a teacher-forced prefill, and the kernels' launch counts
     on the w8a16 run (counters zeroed just before it, read just after);
  5. the w8a16 logits parity check (relative error < 0.08);
  6. decode tokens/s at 8 slots and prefill tokens/s (4 x 64) for both,
     and a torch.profiler window of each decode loop (device time per
     step, its top kernels, and the device-idle share of that window);
  7. with the serving weights freed: hold the flash forward, the two flash
     backward kernels and the fused-FFN K1, K2 and K3 kernels against their
     plain versions at the 8B training shapes and at shapes that do not
     tile (max abs error / max abs plain value < 1e-2), and the AdamW
     kernel bit for bit at every leaf shape of the 8-layer training tree
     and at an odd size; time kernel, plain version, bound and one PyTorch
     library call doing the same work; one summary line each for the wgmma
     flash kernels, K1, K3 and K2 at the 8B shape (ms a launch, bound,
     share, library, and the time of the kernel a redesign replaced, from
     PERF.md), K1's swiglu operand against the plain version's (dy the
     identity; at most one bf16 ulp) and K3's h operand (dgate the
     identity: dW_gate^T equal to the plain normed x); then rows that see
     no key (fault C.4): causal, sq 300 against sk 64, head_dim 64 and
     128, the [b·h, s, d] bf16 forward, dk/dv and dq kernels and the
     float32 forward against their plain versions (bf16 within 1e-2,
     float32 1e-4, lse 2e-5), and out exactly 0 on rows 0-235;
 7b. hold the RMSNorm forward and dx kernels against their plain versions
     at [4096, 4096] bf16 (the training batch at d_model), [8, 4096] bf16
     (the decode batch), [4096, 4096] f32 and [300, 130] bf16 (ragged rows
     and d), and the cross-entropy forward and backward at [4096, 128256]
     f32 (the model's logits) and bf16 and at [37, 3000] f32 with some
     labels -1: bf16 outputs within 1e-2 and f32 outputs within 1e-5 of the
     plain output's max, rstd, loss and lse within 2e-5 of each value; time
     each with its plain version, its bound and one library call
     (F.rms_norm and its autograd backward, F.cross_entropy and its
     backward);
  7c. hold the packed flash kernels (forward, dk/dv, dq over [b, s,
     heads x hd], GQA by index) against their plain versions at the 8B
     attention shape (q [2, 2048, 32 x 128], k/v [2, 2048, 8 x 128], bf16,
     causal) and at shapes that do not tile ([1, 200] with 8/2 heads, a
     decode window sq 64 against sk 300 at hd 64, s 130 at hd 32 not
     causal): outputs within 1e-2 of the plain output's max, lse within
     2e-5 of the plain lse's; time each with its plain version, its bound
     and scaled_dot_product_attention (enable_gqa) on the strided [b, h, s,
     hd] views and its backward, logging which SDPA backend runs; the same
     summary lines as phase 7, and phase 7's no-key-rows case in the packed
     layout;
 7d. hold the six float32 kernels (flash forward, dk/dv, dq; K3, K1, K2)
     against their plain versions with TF32 off (within 1e-4 of the plain
     max): the flash kernels at the 8B attention shape in float32, a ragged
     shape and the shape of the tiny variant below, the FFN kernels at the
     8B FFN shape in float32, T 512 x d 256 x d_ff 512, a ragged shape and
     the tiny variant's, dq, dk/dv, K3, K1 and K2 also bit-identical
     across two calls, each flash shape's planned tiles logged; time each
     with its float32 bound (67 TFLOP/s) and a library call, logging
     SDPA's float32 backend and the kernels its forward launches; one
     summary line each for the float32 flash forward, dk/dv, dq, K3, K1
     and K2 at the 8B shape and the tiny variant's (ms a launch, bound,
     share, library (dk/dv 4/7 and dq 3/7 of SDPA's one backward), and the
     first SIMT design's time from PERF.md); then
     train ModelConfig.tiny() in float32 widened to head_dim 128 (d_model
     256, 2 heads, 1 kv head; fused_ffn, fused_attn, USE_K1 = USE_K2 =
     True) for 3 steps at b 2 x s 128, each float32 kernel launched exactly
     n_layers times a step (counters zeroed before each step, read after),
     the losses within 1e-4 relative of the same model on the CPU;
 7e. the flash route beyond head_dim 128 (fault C.2): at head_dim 256
     (instantiated) and 96 and 192 (zero-padded to 128 and 256) in bf16 (b
     1, 8 heads over 2 kv heads, s 1024, causal) and at 256 in float32 (4
     over 2 heads, s 256, TF32 off), the three packed and the three [b·h,
     s, d] kernels against their plain versions (within 1e-2, float32
     1e-4, lse 2e-5), each launched once per shape and the wide family
     never, timed as the phase-7 and 7c rows are (0 calls a step); then
     ops.attention, ops.attention_packed and the fused attn_block at each
     bf16 shape against the einsum route in float32 (within 1e-2), each
     flash kernel launched once per entry where the reference's gate takes
     it (head_dim >= 128) and never below; then head_dim 320 (zero-padded
     to 384) and 512 through the wide family (csrc/flash_wide.cu) at the
     same shapes, bf16 and float32, causal and not, both layouts, against
     the plain versions (bf16 1e-2, float32 1e-4, lse 2e-5 of its max),
     every launch the wide family's (counted apart), the forward's out
     and lse, dk/dv and dq (the bf16 ones on wgmma, the float32 ones
     register-tiled) bit-identical across two calls in both layouts, the
     causal cases timed beside their bound, SDPA (its backend named) and
     the first (SIMT) design's time where a redesign replaced it, and the
     three entries at 320 and 512 against the einsum route, their wide
     launches the family's `launches`;
  8. train Llama-3-8B at full width with 8 of its 32 layers (random bf16
     weights, one batch of 2 x 2049 tokens reused) for 8 steps of
     default_optimizer(warmup_steps=2), checking finite losses and grad
     norms, the first loss against its expectation for this init, a falling
     loss, and that each of the four kernels of this path launches exactly
     n_layers times in every step and the packed flash kernels never
     (counters zeroed before the step, read after);
  9. ms/step, tokens/s and MFU over steps 3-8, peak device memory, and a
     torch.profiler window of 3 more steps;
 10. with that state freed, the all-kernel step: the same config, seed and
     batch with fused_ffn.USE_K1 = USE_K2 = True and
     fused_adamw_optimizer(warmup_steps=2), 8 steps, checking the same
     gates, six kernels at n_layers launches and the AdamW kernel at one
     launch per leaf in every step, losses 1-2 equal to phase 8's within
     1e-5 relative and step 1's grad norm within 1%; then phase 9's
     measurements for this path;
 10b. the RMSNorm and cross-entropy entries on the 8-layer model's own
     tensors (fresh params, same seed and batch): softmax_cross_entropy over
     its float32 logits [2, 2048, 128256] against token_nll (mean loss and
     its gradient within 1e-5 relative), rms_norm_fused on the batch's
     [2, 2048, 4096] bf16 embedding rows with the final_norm weight against
     ops.layers.rms_norm (within one bf16 ulp; dx and dw by autograd within
     1e-2), each of the four kernels launched exactly once (counters zeroed
     just before, read just after);
 10c. ops.attention_packed on layer 0's own q, k, v of the 8-layer model
     (fresh params, same seed and batch; rms_norm, projections and rotary
     as _attn_half builds them), forward and backward with a seeded bf16
     cotangent, against ops.attention on the [b, h, s, hd] views (the
     B1/B2 route) and against the float32 reference: output and dq/dk/dv
     within 1e-2 of the compared tensor's max, each packed kernel launched
     exactly once and the B1/B2 kernels never (counters zeroed just before,
     read just after); logs which outputs and lse are bit-identical across
     the two routes, and fails unless out, lse and dq are (one kernel body
     serves both routes);
 10d. serve Mixtral-8x7B at full width (d 4096, 32/8 heads, 8 experts of
     d_ff 14336, top-2, vocab 32000) with 8 of its 32 layers, capacity
     factor 8 (no token dropped), random bf16 weights from a seeded
     generator: phase 4's 12 requests in bf16 and w8a16 with phase 4's
     gates (greedy agreement pooled over requests 0-3), the quant and
     dequant kernels' launches on the w8a16 run against the counts the
     leaf list implies (the router stays bf16), phase 5's parity and phase
     6's decode measurements;
 10e. train it at 2 of 32 layers, capacity factor 1.25, moe_aux_weight
     0.02, remat "dots", batch 2 x 2049 reused: 8 steps of
     default_optimizer(warmup_steps=2) (finite losses and grad norms, the
     first loss within 0.5 of ln V + 0.02²·d/2 + 0.02·L, a drop of >= 0.5
     nats, moe_aux every step, the flash forward at 2·n_layers launches a
     step and the backward at n_layers, K1-K3 never), ms/step, peak GiB,
     tokens/s and MFU over the active and over all parameters; then 3
     steps of fused_adamw_optimizer (adamw_update once a leaf, 13 a step;
     step-1 loss equal to the default's within 1e-5 relative);
 10f. one forward and backward of loss_fn in each remat mode (none, full,
     dots, dots_sans_qkv, dots_plus_attn) on the same params and batch, for
     the phase-10e MoE config and for the 8-layer 8B width with
     fused_ffn=True, fused_attn=False: loss, moe_aux and grad norm equal to
     none's within 1e-6 relative, the flash forward at n_layers launches
     (none) or 2·n_layers (the rest), the backward at n_layers, K3 at
     n_layers on the dense config, peak memory and the memory the forward
     leaves for the backward each ordered none >= dots_plus_attn >= dots
     >= dots_sans_qkv >= full within 1%; each mode's GiB and the ms of a
     second, timed run;
 11. (run after phase 6, on phase 4's bf16 params, the w8a16 copy freed)
     HF conversion at llama3_8b full width and depth:
     params_from_hf_state_dict(state_dict_from_params(p)) equal to p bit
     for bit on every leaf, and an engine on the converted params giving
     phase 4's bf16 outputs token for token on requests 0-3; its seconds
     and peak memory logged;
 12. (then, with the 8B weights freed) the servebench runner,
     `servebench.main(["--full", "--no-latency", "--json", ...])` into
     build/: b1 in bf16 at max_len 2048, decode at 1/4/8 slots, w8a16 and
     prefill: rc 0, every required row but latency, the b1 config in
     bf16 on one card, w8a16 parity < 0.08, the quant kernel at 18
     launches (two w8a16 loads) and the dequant kernel at a positive
     multiple of 7·L + 2 (its launches a pass); the rows printed;
 13. (after 10f) checkpoint and resume at llama3_8b width with k layers,
     the most of 8, 4, 2, 1 whose two checkpoints (default and fused
     AdamW) fit the write budget of all of chip_smoke's checkpoints (30
     GiB: 2 layers, 11.90 + 14.87 GB) and each take at most half the free
     disk: 4 steps straight (losses and the final params kept on the
     host), then 2 steps, save_checkpoint(step=2) under build/, a restore
     into an abstract_like state, 2 more steps: losses 1-4 and the final
     params bit-identical to the straight run under default_optimizer and
     fused AdamW, the flash kernels and K3 at n_layers launches a step
     after the restore (AdamW once a leaf under fused AdamW); then
     latest_checkpoint and gc_checkpoints on that directory (a torn
     staging dir, a step dir without meta, an older complete save); save
     and restore seconds and GB/s logged; the directory deleted;
 14. print eightb_plan(); `_budget` at the 8-layer config on one card
     equal to phase 8's live params, grads and optimizer bytes exactly,
     its total beside phase 9's peak; the phase efficiencies of the real
     8-layer all-kernel step (`planning.measure_phase_eff`) under each
     optimizer beside the ones the planning module holds, and the 4-card
     projection under each;
 15. the sharded step at world 1: `parallel.initialize_group` with NCCL
     (one rank), `make_mesh(MeshConfig())`, and phase 8's config, seed and
     batch, 3 steps under each optimizer through `make_train_step(...,
     mesh=)` (the per-layer gathers, their reduce-scatters, the
     re-gathers in the backward, the gradient and loss reductions, all
     NCCL): losses, grad norms and the final params bit-identical to the
     unsharded step's, and each step launching the flash kernels and K3
     n_layers times and AdamW once a leaf under fused AdamW (0 under
     default_optimizer); the process group destroyed;
 15b. the tensor- and sequence-parallel code at tp = sp = 1 on a one-rank
     NCCL mesh, phase 8's width, seed and batch with the fused blocks off
     (remat "dots"), 3 default steps each: `seq_parallel="ulysses"` (its
     all-to-alls on the one-rank sp group, the flash kernels between them)
     bit-identical to the step without sp (losses, grad norms, final
     params), the flash forward 2·n_layers and each backward n_layers a
     step as there; `seq_parallel="ring"` (the bf16 einsum ring, no flash
     launch) within multichip's ring bounds of it (step-1 loss 1e-3, grad
     norm 2%, losses 2-3 5e-3); and the fused attention and FFN blocks on
     the step's [2, 2048, 4096] bf16 activations and layer 0's weights with
     a one-rank `tp_group` bit-identical to the blocks without one (output
     and every gradient; the flash pair and K3 once each a pass);
 15c. the expert-parallel code (the global router's token gather, the
     dispatch's reduce-scatter and all-reduces, the combine's all-gather,
     the expert leaves kept local) on a one-rank NCCL mesh: phase 10e's
     Mixtral-8x7B-width config, 3 steps under each optimizer, losses, grad
     norms, moe_aux and final params bit-identical to the unsharded MoE
     step, the same launches a step;
 16. print the kernels line (the float32 kernels as `<name>_f32`, the
     wide family as `<name>_wide`), the nvidia-smi line, and the result
     line.

Imports torch and the port only (never jax, never ray_tpu).
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# H100 SXM data sheet: HBM3 rate, the dense bf16 tensor-core rate and the
# float32 rate outside the tensor cores; a kernel's bound_ms is the larger
# of its bytes and its operations at these.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_OPS_PER_S = 989e12
PEAK_F32_OPS_PER_S = 67e12
NUM_SLOTS, MAX_LEN = 8, 1024
# Training: 8 layers of Llama-3-8B, batch 2 x 2048, 8 checked steps.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TIMED_FROM = 2, 2048, 8, 2
# Predicted in PERF.md before the first run: the loss on the one reused
# batch falls by at least this much (nats) from step 1 to step 8.
MIN_LOSS_DROP = 0.5
# Kernel against its plain version: both read the same bf16 inputs, the
# plain version computes in float32; bf16 output rounding (~4e-3 relative)
# and another summation order stay far below this share of the plain
# output's largest magnitude.
REL_ERR_LIMIT = 1e-2
# The all-kernel step against the default step: the same forward (losses 1
# and 2, step 1's lr is 0 on both paths) and, at step 1, gradients that
# differ only where K2 keeps d_s in float32 (the default path rounds it to
# bf16).
SAME_LOSS_RTOL = 1e-5
GRAD_NORM_RTOL = 1e-2
ADAMW_HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1)
# RMSNorm and cross-entropy against their plain versions: float32 outputs
# (another summation order) and the row statistics rstd, loss and lse (each
# value); bf16 outputs keep REL_ERR_LIMIT.
F32_REL_LIMIT = 1e-5
STAT_REL_LIMIT = 2e-5
# The cross-entropy entry on the 8B logits against token_nll: mean loss and
# gradient (relative to the gradient's largest magnitude).
ENTRY_RTOL = 1e-5


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def check_card(name: str) -> None:
    upper = name.upper()
    if "H100" not in upper or "PCIE" in upper or "NVL" in upper:
        fail(f"card {name!r} is not an H100 SXM: the bounds use its rates")


def kernel_shapes(cfg, num_slots: int):
    """{kernel: {shape: calls on the main path}}. The quant kernel runs once
    per leaf at load, on the stacked [L, in, out] leaves, the embedding and
    the LM head; the dequant kernel runs 7·L + 2 times per forward pass (one
    decode step here), on each layer's slices, the LM head and the embedding
    rows gathered for the slots. The six 2-D 8B weight shapes are checked
    for both kernels; those a kernel never gets on the path count 0."""
    L, d, f, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    qd, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    layer = [((d, qd), 1), ((d, kv), 2), ((qd, d), 1), ((d, f), 2),
             ((f, d), 1)]  # wq, wk/wv, wo, w_gate/w_up, w_down
    quant, dequant = {}, {}
    for shape in [s for s, _ in layer] + [(d, V), (V, d)]:
        quant[shape] = dequant[shape] = 0
    for shape, n in layer:
        quant[(L, *shape)] = quant.get((L, *shape), 0) + n
        dequant[shape] += n * L
    quant[(V, d)] += 1  # embed
    quant[(d, V)] += 1  # lm_head
    dequant[(d, V)] += 1
    dequant[(num_slots, 1, d)] = 1  # embedding rows gathered per step
    return {"quantize_int8": quant, "dequantize_int8": dequant}


# GPU clock cycles (about 0.5 ms) that the stream spins after each L2 flush,
# so that the timed call's host-side dispatch (argument checks, allocation,
# the ctypes call) is over before the start event: a call whose dispatch
# outlasted the flush would otherwise be timed with the gap before it.
HOLD_CYCLES = 1_000_000


def time_ms(torch, fn, flush, reps: int = 7) -> float:
    """Median of `reps` single-call CUDA-event timings after one warm-up,
    with the 50 MB L2 flushed before each call (weights arrive cold)."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(HOLD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def numel(shape) -> int:
    n = 1
    for k in shape:
        n *= k
    return n


def bound_ms(nbytes: int, ops: int, ops_per_s: float = PEAK_BF16_OPS_PER_S):
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * ops / ops_per_s
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def check_kernels(torch, quant, gen, shapes):
    """Phase 3: bit-exact agreement with the plain versions and times at
    every shape of `shapes`, largest first while the card is still empty
    (the plain version's float32 temporaries of the stacked w_down leaf
    take ~25 GB)."""
    bf16 = torch.bfloat16
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    rows = {name: [] for name in shapes}
    todo = sorted(set(shapes["quantize_int8"]) | set(shapes["dequantize_int8"]),
                  key=lambda s: -numel(s))
    for shape in todo:
        n, d = numel(shape), shape[-1]
        r = n // d
        x = torch.randn(shape, generator=gen, device="cuda", dtype=bf16)
        x.mul_(0.02)
        x.view(-1, d)[0] = 0  # an all-zero row takes the 1e-8 scale floor
        v, s = quant.quantize_int8(x)
        pv, ps = quant.quantize_int8_plain(x)
        torch.cuda.synchronize()
        q_err = max((v.int() - pv.int()).abs().max().item(),
                    (s - ps).abs().max().item())
        if not (torch.equal(v, pv) and torch.equal(s, ps)):
            fail(f"quantize_int8 differs from its plain version at {shape}: "
                 f"max abs err {q_err}")
        del pv, ps
        out = quant.dequantize_int8(v, s, bf16)
        pout = quant.dequantize_int8_plain(v, s, bf16)
        torch.cuda.synchronize()
        d_err = (out.float() - pout.float()).abs().max().item()
        if not torch.equal(out.view(torch.int16), pout.view(torch.int16)):
            fail(f"dequantize_int8 differs from its plain version at "
                 f"{shape}: max abs err {d_err}")
        del out, pout
        # bytes: each input read once, each output written once
        work = {
            "quantize_int8": (q_err, n * 2 + n + r * 4, n * 6,
                              lambda: quant.quantize_int8(x),
                              lambda: quant.quantize_int8_plain(x)),
            "dequantize_int8": (d_err, n + r * 4 + n * 2, n * 2,
                                lambda: quant.dequantize_int8(v, s, bf16),
                                lambda: quant.dequantize_int8_plain(v, s,
                                                                    bf16))}
        for name, (err, nbytes, ops, fn, plain) in work.items():
            if shape not in shapes[name]:
                continue
            b_ms, b_by = bound_ms(nbytes, ops)
            row = {"shape": list(shape), "calls": shapes[name][shape],
                   "max_abs_err": err, "ms": time_ms(torch, fn, flush),
                   "plain_ms": time_ms(torch, plain, flush),
                   "bound_ms": b_ms, "bound_by": b_by}
            rows[name].append(row)
            log(f"kernel {name} {list(shape)} bf16 ({row['calls']} calls on "
                f"the path): identical to plain (max_abs_err {err}); kernel "
                f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}), {b_ms / row['ms']:.3f} of bound")
        del x, v, s
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return rows


def make_requests(cfg, seed: int):
    import numpy as np

    rng = np.random.default_rng(seed)
    lens = [5, 9, 17, 30, 47, 64, 90, 130, 170, 220, 260, 300]
    return [(rng.integers(0, cfg.vocab_size, n).tolist(), 16 + (7 * i) % 33)
            for i, n in enumerate(lens)]


def teacher_forced_agreement(torch, params, cfg, seq, n_prompt):
    """Fraction of generated tokens equal to the argmax of one prefill over
    the finished sequence (a second route to the same greedy decisions)."""
    from ray_tpu_torch.models.inference import prefill

    n_gen = len(seq) - n_prompt
    tokens = torch.tensor([seq[:-1]] * n_gen, dtype=torch.int32,
                          device="cuda")
    idx = torch.arange(n_prompt - 1, len(seq) - 1, device="cuda")
    logits, _ = prefill(params, tokens, cfg, MAX_LEN, logits_index=idx)
    pred = logits.argmax(dim=-1).tolist()
    return sum(int(p == t) for p, t in zip(pred, seq[n_prompt:])) / n_gen


def serve(torch, params, cfg, requests, quantize: bool, label: str):
    from ray_tpu_torch.models.serving import ContinuousBatchingEngine

    t0 = time.perf_counter()
    eng = ContinuousBatchingEngine(params, cfg, num_slots=NUM_SLOTS,
                                   max_len=MAX_LEN, quantize_weights=quantize,
                                   device="cuda")
    rids = [eng.submit(p, max_new_tokens=n) for p, n in requests]
    eng.run_until_done()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    done = 0
    for rid, (prompt, n) in zip(rids, requests):
        out = eng.result(rid)
        if out is None:
            fail(f"{label}: request {rid} did not finish")
        if len(out) != len(prompt) + n or out[:len(prompt)] != prompt:
            fail(f"{label}: request {rid} returned {len(out) - len(prompt)} "
                 f"tokens, expected {n}")
        if not all(0 <= t < cfg.vocab_size for t in out):
            fail(f"{label}: request {rid} produced a token outside the "
                 f"vocabulary")
        done += 1
    log(f"serve {label}: {done}/{len(requests)} requests complete in "
        f"{dt:.2f} s ({eng.prefill_calls} prefill calls, {eng.decode_steps} "
        f"decode steps)")
    return eng, rids


def causal_pairs(sq: int, sk: int, causal: bool) -> int:
    """(query, key) pairs a row may attend: the work attention needs."""
    if not causal:
        return sq * sk
    off = sk - sq
    return sum(min(sk, max(0, r + off + 1)) for r in range(sq))


def flash_shapes():
    """(bh, sq, sk, head_dim, causal, calls per training step): the 8B
    step's shape (b 2 x 32 heads, s 2048, hd 128), then one that does not
    tile (sk not a multiple of the 64-key tile, sq != sk)."""
    return [(64, 2048, 2048, 128, True, 8), (8, 1000, 1100, 128, True, 0)]


def ffn_shapes():
    """(T, d, d_ff, calls per training step) of the fused-FFN kernels: the
    8B step's (4096 tokens), then one that tiles on no axis (output tiles
    128 x 256 for K1 and K2, 128 x 128 for K3; 64 tokens or 64 of d a
    stage)."""
    return [(4096, 4096, 14336, 8), (1000, 4000, 3000, 0)]


def adamw_shapes(cfg):
    """{leaf shape: leaves of that shape} of the training tree (the AdamW
    kernel runs once per leaf a step), then an odd size that is no leaf."""
    L, d, f, V = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    qd, kv = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    shapes = {}
    for shape in [(V, d), (d, V), (d,), (L, d), (L, d), (L, d, qd),
                  (L, d, kv), (L, d, kv), (L, qd, d), (L, d, f), (L, d, f),
                  (L, f, d)]:
        shapes[shape] = shapes.get(shape, 0) + 1
    shapes[(1000003,)] = 0
    return shapes


def fused_adamw_library(torch, p, g, mu, nu, lr, grad_scale, step):
    """torch._fused_adamw_ on one leaf, timed beside the kernel only;
    grad_scale = 1 / clip makes it scale g by the clip factor as the kernel
    does. It needs p, g, mu and nu of one dtype, so it runs on float32 p
    and g: 32 B/element where the kernel moves 22."""
    torch._fused_adamw_([p], [g], [mu], [nu], [], [step], amsgrad=False,
                        lr=lr, beta1=ADAMW_HYPER["b1"],
                        beta2=ADAMW_HYPER["b2"],
                        weight_decay=ADAMW_HYPER["wd"],
                        eps=ADAMW_HYPER["eps"], maximize=False,
                        grad_scale=grad_scale, found_inf=None)


def rel_err(torch, got, want):
    err = (got.float() - want.float()).abs().max().item()
    return err, err / max(want.float().abs().max().item(), 1e-30)


# Causal attention with sq > sk: rows r < sq - sk attend no key and give
# out 0 on the flash route (fault C.4). (b, heads, kv heads, sq, sk).
NO_KEY_SHAPE = (1, 2, 2, 300, 64)


def check_no_key_rows(torch, gen, packed: bool) -> None:
    """The flash kernels on rows that see no key, in one layout ([b·h, s,
    d] or packed), at head_dim 64 and 128: the bf16 forward, dk/dv and dq
    and the float32 forward against their plain versions (bf16 within
    REL_ERR_LIMIT, float32 within F32_KERNEL_LIMIT, lse within
    STAT_REL_LIMIT of its largest magnitude), and out exactly 0 on those
    rows."""
    from ray_tpu_torch.ops.kernels import flash_attention as fa

    b, h, kv, sq, sk = NO_KEY_SHAPE
    layout = "packed" if packed else "[b·h, s, d]"
    for d in (64, 128):
        scale = d ** -0.5
        for dtype in (torch.bfloat16, torch.float32):
            def randn(s, n):
                return torch.randn((b, s, n * d), generator=gen,
                                   device="cuda").to(dtype)

            q, do, k, v = randn(sq, h), randn(sq, h), randn(sk, kv), \
                randn(sk, kv)
            if packed:
                args = (h, kv, scale, True)
                fwd, fwd_plain = fa.flash_fwd_packed, fa.flash_fwd_packed_plain
                dkv, dkv_plain = (fa.flash_bwd_dkv_packed,
                                  fa.flash_bwd_dkv_packed_plain)
                dq, dq_plain = (fa.flash_bwd_dq_packed,
                                fa.flash_bwd_dq_packed_plain)
            else:
                q, do, k, v = (heads_view(t, n).reshape(b * n, -1, d)
                               .contiguous()
                               for t, n in ((q, h), (do, h), (k, kv), (v, kv)))
                args = (scale, True)
                fwd, fwd_plain = fa.flash_fwd, fa.flash_fwd_plain
                dkv, dkv_plain = fa.flash_bwd_dkv, fa.flash_bwd_dkv_plain
                dq, dq_plain = fa.flash_bwd_dq, fa.flash_bwd_dq_plain
            out, lse = fwd(q, k, v, *args)
            p_out, p_lse = fwd_plain(q, k, v, *args)
            limit = (F32_KERNEL_LIMIT if dtype == torch.float32
                     else REL_ERR_LIMIT)
            checks = [("out", rel_err(torch, out, p_out), limit),
                      ("lse", rel_err(torch, lse, p_lse), STAT_REL_LIMIT)]
            if dtype == torch.bfloat16:
                delta = (fa.flash_delta_packed(p_out, do, h) if packed
                         else fa.flash_delta(p_out, do))
                bwd = (q, k, v, do, p_lse, delta, *args)
                checks += [(name, rel_err(torch, got, want), limit)
                           for name, got, want in zip(
                               ("dk", "dv", "dq"),
                               (*dkv(*bwd), dq(*bwd)),
                               (*dkv_plain(*bwd), dq_plain(*bwd)))]
            torch.cuda.synchronize()
            zero = bool((out[:, :sq - sk] == 0).all())
            for name, (err, rel), lim in checks:
                if not rel < lim:
                    fail(f"rows that see no key ({layout}, head_dim {d}, "
                         f"{dtype}): {name} {rel} of the plain max from its "
                         f"plain version (max abs err {err}, limit {lim})")
            if not zero:
                fail(f"rows that see no key ({layout}, head_dim {d}, "
                     f"{dtype}): out is not 0 on rows 0-{sq - sk - 1}")
            log(f"no-key rows ({layout}, causal sq {sq} sk {sk}, head_dim "
                f"{d}, {str(dtype)[6:]}): "
                + ", ".join(f"{name} {rel:.3g}" for name, (_, rel), _ in
                            checks)
                + f" of the plain max; out 0 on rows 0-{sq - sk - 1}")


def check_train_kernels(torch, gen, cfg):
    """Phase 7: the training paths' kernels against their plain versions,
    and their times, bounds and a library call's time."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from ray_tpu_torch.ops.kernels import adamw as aw
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.ops.kernels import fused_ffn as ff

    bf16 = torch.bfloat16
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    rows = {"flash_fwd": [], "flash_bwd_dkv": [], "flash_bwd_dq": [],
            "dw_gateup": [], "dw_down": [], "dgateup": [],
            "adamw_update": []}

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda",
                            dtype=torch.float32) * scale).to(bf16)

    def record(name, shape, calls, errs, nbytes, ops, fn, plain, library,
               library_what, ops_per_s=PEAK_BF16_OPS_PER_S):
        b_ms, b_by = bound_ms(nbytes, ops, ops_per_s)
        err = max(e[0] for e in errs)
        rel = max(e[1] for e in errs)
        if not rel < REL_ERR_LIMIT:
            fail(f"{name} differs from its plain version at {shape}: max "
                 f"abs err {err}, {rel} of the plain output's max "
                 f"(limit {REL_ERR_LIMIT})")
        row = {"shape": list(shape), "calls": calls, "max_abs_err": err,
               "rel_err": rel, "ms": time_ms(torch, fn, flush),
               "plain_ms": time_ms(torch, plain, flush),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": (time_ms(torch, library, flush)
                              if library is not None else None),
               "library": library_what if library is not None else None}
        rows[name].append(row)
        lib = ("" if row["library_ms"] is None else
               f", library {row['library_ms']:.4f} ms ({library_what})")
        log(f"kernel {name} {list(shape)} bf16 ({calls} calls per training "
            f"step): max abs err {err:.3g} ({rel:.3g} of the plain max); "
            f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), {b_ms / row['ms']:.3f} of "
            f"bound{lib}")

    for bh, sq, sk, d, causal, calls in flash_shapes():
        shape = (bh, sq, sk, d)
        scale = d ** -0.5
        q, k, v, do = (randn(bh, n, d) for n in (sq, sk, sk, sq))
        out, lse = fa.flash_fwd(q, k, v, scale, causal)
        p_out, p_lse = fa.flash_fwd_plain(q, k, v, scale, causal)
        torch.cuda.synchronize()
        fwd_errs = [rel_err(torch, out, p_out), rel_err(torch, lse, p_lse)]
        del out, lse
        delta = fa.flash_delta(p_out, do)
        dk, dv = fa.flash_bwd_dkv(q, k, v, do, p_lse, delta, scale, causal)
        p_dk, p_dv = fa.flash_bwd_dkv_plain(q, k, v, do, p_lse, delta,
                                            scale, causal)
        dq = fa.flash_bwd_dq(q, k, v, do, p_lse, delta, scale, causal)
        p_dq = fa.flash_bwd_dq_plain(q, k, v, do, p_lse, delta, scale,
                                     causal)
        torch.cuda.synchronize()
        dkv_errs = [rel_err(torch, dk, p_dk), rel_err(torch, dv, p_dv)]
        dq_errs = [rel_err(torch, dq, p_dq)]
        del dk, dv, dq, p_dk, p_dv, p_dq
        torch.cuda.empty_cache()
        pairs = causal_pairs(sq, sk, causal)
        product = 2 * bh * pairs * d  # FLOP of one [sq, sk] x d product
        qo_bytes, kv_bytes = 2 * bh * sq * d, 2 * bh * sk * d
        lib_fwd = lib_bwd = lib_out = None
        if sq == sk and causal:  # SDPA's causal mask is end-aligned here
            q4, k4, v4 = (t.view(1, *t.shape).requires_grad_(True)
                          for t in (q, k, v))
            lib_out = sdpa(q4, k4, v4, is_causal=True)
            g4 = do.view(1, *do.shape)

            def lib_fwd():
                with torch.no_grad():
                    sdpa(q4, k4, v4, is_causal=True)

            def lib_bwd():
                torch.autograd.grad(lib_out, (q4, k4, v4), g4,
                                    retain_graph=True)
        record("flash_fwd", shape, calls, fwd_errs,
               2 * qo_bytes + 2 * kv_bytes + 4 * bh * sq, 2 * product,
               lambda: fa.flash_fwd(q, k, v, scale, causal),
               lambda: fa.flash_fwd_plain(q, k, v, scale, causal), lib_fwd,
               "torch scaled_dot_product_attention, causal, K/V repeated")
        lib_what = ("the backward of that call (dq, dk and dv in one "
                    "call)")
        record("flash_bwd_dkv", shape, calls, dkv_errs,
               2 * qo_bytes + 2 * kv_bytes + 8 * bh * sq + 2 * kv_bytes,
               4 * product,
               lambda: fa.flash_bwd_dkv(q, k, v, do, p_lse, delta, scale,
                                        causal),
               lambda: fa.flash_bwd_dkv_plain(q, k, v, do, p_lse, delta,
                                              scale, causal),
               lib_bwd, lib_what)
        record("flash_bwd_dq", shape, calls, dq_errs,
               2 * qo_bytes + 2 * kv_bytes + 8 * bh * sq + qo_bytes,
               3 * product,
               lambda: fa.flash_bwd_dq(q, k, v, do, p_lse, delta, scale,
                                       causal),
               lambda: fa.flash_bwd_dq_plain(q, k, v, do, p_lse, delta,
                                             scale, causal),
               lib_bwd, lib_what)
        lib_fwd = lib_bwd = lib_out = None
        del q, k, v, do, p_out, p_lse, delta
        torch.cuda.empty_cache()

    for T, d, dff, calls in ffn_shapes():
        x = randn(T, d)
        rstd = torch.rand((T, 1), generator=gen, device="cuda") + 0.5
        nw = randn(d, scale=0.1) + 1
        dgate, dup = randn(T, dff, scale=0.01), randn(T, dff, scale=0.01)
        dwg, dwu = ff.dw_gateup(x, rstd, nw, dgate, dup)
        p_dwg, p_dwu = ff.dw_gateup_plain(x, rstd, nw, dgate, dup)
        torch.cuda.synchronize()
        errs = [rel_err(torch, dwg, p_dwg), rel_err(torch, dwu, p_dwu)]
        del dwg, dwu, p_dwg, p_dwu
        h = ff.normed(x, rstd, nw)
        record("dw_gateup", (T, d, dff), calls, errs,
               2 * T * d + 4 * T + 2 * d + 2 * 2 * T * dff + 2 * 2 * d * dff,
               2 * 2 * T * d * dff,
               lambda: ff.dw_gateup(x, rstd, nw, dgate, dup),
               lambda: ff.dw_gateup_plain(x, rstd, nw, dgate, dup),
               lambda: (torch.matmul(h.T, dgate), torch.matmul(h.T, dup)),
               "two torch.matmul(h.T, .) on a precomputed h")
        del x, rstd, nw, dgate, dup, h
        torch.cuda.empty_cache()

        # K1 and K2 on their own inputs: the swiglu's operands and the
        # down projection's weight at the same (T, d, d_ff)
        gate, up = randn(T, dff), randn(T, dff)
        dy = randn(T, d, scale=0.01)
        wd = randn(dff, d, scale=dff ** -0.5)
        errs = [rel_err(torch, ff.dw_down(gate, up, dy),
                        ff.dw_down_plain(gate, up, dy))]
        dg, du = ff.dgateup(dy, wd, gate, up)
        p_dg, p_du = ff.dgateup_plain(dy, wd, gate, up)
        torch.cuda.synchronize()
        k2_errs = [rel_err(torch, dg, p_dg), rel_err(torch, du, p_du)]
        del dg, du, p_dg, p_du
        s_act = ff.swiglu_act(gate, up)
        record("dw_down", (T, d, dff), calls, errs,
               2 * 2 * T * dff + 2 * T * d + 2 * dff * d, 2 * T * d * dff,
               lambda: ff.dw_down(gate, up, dy),
               lambda: ff.dw_down_plain(gate, up, dy),
               lambda: torch.matmul(s_act.T, dy),
               "torch.matmul(s.T, dy) on a precomputed swiglu s")
        record("dgateup", (T, d, dff), calls, k2_errs,
               2 * T * d + 2 * dff * d + 2 * 2 * T * dff + 2 * 2 * T * dff,
               2 * T * d * dff,
               lambda: ff.dgateup(dy, wd, gate, up),
               lambda: ff.dgateup_plain(dy, wd, gate, up),
               lambda: torch.matmul(dy, wd.T),
               "torch.matmul(dy, w_down.T), the product alone: no "
               "epilogue")
        del gate, up, dy, wd, s_act
        torch.cuda.empty_cache()

    # AdamW: bit for bit, in place, on copies; largest leaf first
    lr, c1, c2 = 3e-4, aw.bias_correction(0.9, 3), aw.bias_correction(0.95, 3)
    clip = torch.tensor(0.37, device="cuda")
    inv_clip = clip.reciprocal()
    step = torch.full((), 3.0, device="cuda")
    for shape, calls in sorted(adamw_shapes(cfg).items(),
                               key=lambda kv: -numel(kv[0])):
        n = numel(shape)
        p, g = randn(n, scale=0.02), randn(n, scale=1e-3)
        mu = torch.randn(n, generator=gen, device="cuda") * 1e-4
        nu = torch.rand(n, generator=gen, device="cuda") * 1e-6
        want = [t.clone() for t in (p, mu, nu)]
        aw.adamw_update(p, g, mu, nu, lr, clip, c1, c2, **ADAMW_HYPER)
        aw.adamw_update_plain(want[0], g, want[1], want[2], lr, clip, c1, c2,
                              **ADAMW_HYPER)
        torch.cuda.synchronize()
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip((p, mu, nu), want))
        if not (torch.equal(p.view(torch.int16), want[0].view(torch.int16))
                and torch.equal(mu, want[1]) and torch.equal(nu, want[2])):
            fail(f"adamw_update differs from its plain version at {shape}: "
                 f"max abs err {err}")
        lib_p, lib_g = p.float(), g.float()
        # p, g read as bf16 and mu, nu as float32; p, mu, nu written back
        record("adamw_update", shape, calls, [(err, 0.0)], 22 * n, 17 * n,
               lambda: aw.adamw_update(p, g, mu, nu, lr, clip, c1, c2,
                                       **ADAMW_HYPER),
               lambda: aw.adamw_update_plain(want[0], g, want[1], want[2],
                                             lr, clip, c1, c2,
                                             **ADAMW_HYPER),
               lambda: fused_adamw_library(torch, lib_p, lib_g, want[1],
                                           want[2], lr, inv_clip, step),
               "torch._fused_adamw_ on float32 p and g (it takes no bf16 p "
               "beside float32 moments): 32 B/element",
               ops_per_s=PEAK_F32_OPS_PER_S)
        del p, g, mu, nu, want, lib_p, lib_g
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return rows


def norm_shapes():
    """(rows, d, dtype, calls on the main path) of the RMSNorm kernels: the
    8B training batch at d_model (2 x 2048 rows, phase 10b's shape), the
    decode batch of 8 slots, the training shape in float32, and ragged rows
    and d."""
    return [(4096, 4096, "bfloat16", 1), (8, 4096, "bfloat16", 0),
            (4096, 4096, "float32", 0), (300, 130, "bfloat16", 0)]


def xent_shapes():
    """(N, V, dtype, labels set to -1, calls on the main path) of the
    cross-entropy kernels: the 8B model's float32 logits for 2 x 2048 tokens
    (phase 10b's shape), the same in bf16, and a ragged vocabulary with
    every fourth label -1."""
    return [(4096, 128256, "float32", False, 1),
            (4096, 128256, "bfloat16", False, 0),
            (37, 3000, "float32", True, 0)]


def record_checked(torch, flush, rows, name, shape, dtype, calls, checks,
                   nbytes, ops, ops_per_s, fn, plain, library, library_what,
                   calls_what):
    """Fail unless every check holds, then time kernel, plain version and
    library call and append the row to `rows`. checks: (output, (max abs
    err, relative err), limit)."""
    for what, (err, rel), limit in checks:
        if not rel < limit:
            fail(f"{name} differs from its plain version at {shape} "
                 f"{dtype}: {what} max abs err {err}, relative {rel} "
                 f"(limit {limit})")
    b_ms, b_by = bound_ms(nbytes, ops, ops_per_s)
    row = {"shape": list(shape), "dtype": dtype, "calls": calls,
           "max_abs_err": max(c[1][0] for c in checks),
           "rel_err": {c[0]: c[1][1] for c in checks},
           "ms": time_ms(torch, fn, flush),
           "plain_ms": time_ms(torch, plain, flush),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": (time_ms(torch, library, flush)
                          if library is not None else None),
           "library": library_what if library is not None else None}
    rows.append(row)
    lib = ("" if row["library_ms"] is None else
           f", library {row['library_ms']:.4f} ms ({library_what})")
    log(f"kernel {name} {list(shape)} {dtype} ({calls} {calls_what}): rel "
        f"err {row['rel_err']}; kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
        f"{b_ms / row['ms']:.3f} of bound{lib}")


def stat_err(torch, got, want):
    """Largest |got - want| and largest |got - want| / |want| over the
    values of a row statistic (rstd, loss, lse)."""
    diff = (got - want).abs()
    return (diff.max().item(),
            (diff / want.abs().clamp_min(1e-30)).max().item())


def check_norm_xent_kernels(torch, gen):
    """Phase 7b: the RMSNorm and cross-entropy kernels against their plain
    versions, and their times, bounds and a library call's time."""
    import torch.nn.functional as F

    from ray_tpu_torch.ops.kernels import rmsnorm as rms
    from ray_tpu_torch.ops.kernels import xent

    t0 = time.perf_counter()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    rows = {k.__name__: [] for k in (*rms.KERNELS, *xent.KERNELS)}

    def record(name, shape, dtype, calls, checks, nbytes, ops, fn, plain,
               library, library_what):
        record_checked(torch, flush, rows[name], name, shape, dtype, calls,
                       checks, nbytes, ops, PEAK_F32_OPS_PER_S, fn, plain,
                       library, library_what, "calls in phase 10b")

    eps = 1e-5
    for n, d, dtype, calls in norm_shapes():
        dt = getattr(torch, dtype)
        size = dt.itemsize
        x = (torch.randn((n, d), generator=gen, device="cuda") * 2).to(dt)
        w = (torch.randn((d,), generator=gen, device="cuda") * 0.1
             + 1).to(dt)
        g = torch.randn((n, d), generator=gen, device="cuda").to(dt)
        limit = F32_REL_LIMIT if dt == torch.float32 else REL_ERR_LIMIT
        out, rstd = rms.rms_norm_fwd(x, w, eps)
        p_out, p_rstd = rms.rms_norm_fwd_plain(x, w, eps)
        dx = rms.rms_norm_bwd_dx(x, w, p_rstd, g)
        p_dx = rms.rms_norm_bwd_dx_plain(x, w, p_rstd, g)
        torch.cuda.synchronize()
        fwd_checks = [("out", rel_err(torch, out, p_out), limit),
                      ("rstd", stat_err(torch, rstd, p_rstd),
                       STAT_REL_LIMIT)]
        dx_checks = [("dx", rel_err(torch, dx, p_dx), limit)]
        del out, rstd, p_out, dx, p_dx
        xl = x.detach().requires_grad_(True)
        wl = w.detach().requires_grad_(True)
        lib_out = F.rms_norm(xl, (d,), wl, eps)
        record("rms_norm_fwd", (n, d), dtype, calls, fwd_checks,
               2 * n * d * size + d * size + 4 * n, 4 * n * d,
               lambda: rms.rms_norm_fwd(x, w, eps),
               lambda: rms.rms_norm_fwd_plain(x, w, eps),
               lambda: F.rms_norm(x, (d,), w, eps),
               "torch.nn.functional.rms_norm")
        record("rms_norm_bwd_dx", (n, d), dtype, calls, dx_checks,
               3 * n * d * size + d * size + 4 * n, 9 * n * d,
               lambda: rms.rms_norm_bwd_dx(x, w, p_rstd, g),
               lambda: rms.rms_norm_bwd_dx_plain(x, w, p_rstd, g),
               lambda: torch.autograd.grad(lib_out, (xl, wl), g,
                                           retain_graph=True),
               "the autograd backward of torch.nn.functional.rms_norm: "
               "dx and dw in one call")
        del x, w, g, p_rstd, xl, wl, lib_out
        torch.cuda.empty_cache()

    for n, v, dtype, ignore, calls in xent_shapes():
        dt = getattr(torch, dtype)
        size = dt.itemsize
        logits = (torch.randn((n, v), generator=gen, device="cuda")
                  * 2).to(dt)
        labels = torch.randint(0, v, (n,), generator=gen, device="cuda",
                               dtype=torch.int32)
        if ignore:
            labels[::4] = -1
        g = torch.randn((n,), generator=gen, device="cuda")
        limit = F32_REL_LIMIT if dt == torch.float32 else REL_ERR_LIMIT
        loss, lse = xent.xent_fwd(logits, labels)
        p_loss, p_lse = xent.xent_fwd_plain(logits, labels)
        dx = xent.xent_bwd(logits, labels, p_lse, g)
        p_dx = xent.xent_bwd_plain(logits, labels, p_lse, g)
        torch.cuda.synchronize()
        fwd_checks = [("loss", stat_err(torch, loss, p_loss),
                       STAT_REL_LIMIT),
                      ("lse", stat_err(torch, lse, p_lse), STAT_REL_LIMIT)]
        bwd_checks = [("dx", rel_err(torch, dx, p_dx), limit)]
        del loss, lse, p_loss, dx, p_dx
        torch.cuda.empty_cache()
        lib_fwd = lib_bwd = None
        if not ignore:  # cross_entropy's ignore index is -100, not -1
            labels64 = labels.long()
            ll = logits.detach().requires_grad_(True)
            lib_loss = F.cross_entropy(ll, labels64, reduction="none")
            lib_g = g.to(lib_loss.dtype)

            def lib_fwd():
                with torch.no_grad():
                    F.cross_entropy(logits, labels64, reduction="none")

            def lib_bwd():
                torch.autograd.grad(lib_loss, ll, lib_g, retain_graph=True)
        record("xent_fwd", (n, v), dtype, calls, fwd_checks,
               n * v * size + 12 * n, 4 * n * v,
               lambda: xent.xent_fwd(logits, labels),
               lambda: xent.xent_fwd_plain(logits, labels), lib_fwd,
               "torch.nn.functional.cross_entropy(reduction='none')")
        record("xent_bwd", (n, v), dtype, calls, bwd_checks,
               2 * n * v * size + 12 * n, 4 * n * v,
               lambda: xent.xent_bwd(logits, labels, p_lse, g),
               lambda: xent.xent_bwd_plain(logits, labels, p_lse, g),
               lib_bwd, "the autograd backward of that call")
        lib_fwd = lib_bwd = lib_loss = ll = None
        del logits, labels, g, p_lse
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    log(f"phase 7b: {time.perf_counter() - t0:.2f} s")
    return rows


def train(torch, card: str, seed: int, cfg, optimizer, kernels, want,
          label: str, steps: int = TRAIN_STEPS, profile: bool = True):
    """Phases 8-9 (and 10 for the all-kernel step, 10e for MoE): `steps`
    steps of the training step at Llama-3-8B (or Mixtral-8x7B) width with
    `optimizer`; `want` maps each kernel of `kernels` to its launches per
    step. Returns {"losses", "norms", "launches", "leaf_shapes", "ms_step",
    "peak_gib", "state_bytes"}, the last the live state's params,
    optimizer moments and (as the step hands them to the optimizer) grads,
    in bytes."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.models import count_params
    from ray_tpu_torch.models.planning import _tree_bytes
    from ray_tpu_torch.models.transformer import tree_leaves
    from ray_tpu_torch.train import make_train_step

    gc.collect()
    torch.cuda.empty_cache()
    log(f"train {label}: device memory allocated before the state: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    optimizer = GradBytes(optimizer)
    step_fn, init_fn = make_train_step(cfg, optimizer, device="cuda")
    state = init_fn(seed)
    n_params = count_params(state.params)
    state_bytes = {"params": _tree_bytes(state.params),
                   "optimizer": _tree_bytes(state.opt_state)}
    leaf_shapes = {}
    for t in tree_leaves(state.params):
        leaf_shapes[tuple(t.shape)] = leaf_shapes.get(tuple(t.shape), 0) + 1
    nu_dtype = str(state.opt_state.nu["embed"].dtype).replace("torch.", "")
    batch = bench.make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed + 1, "cuda")
    torch.cuda.synchronize()
    width = "mixtral-8x7b" if cfg.n_experts else "llama3_8b"
    log(f"train {label}: {width} width, {cfg.n_layers} layers, "
        f"{n_params / 1e9:.4f}B params, state (params, mu float32, nu "
        f"{nu_dtype}) built in {time.perf_counter() - t0:.2f} s; batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ + 1} tokens, reused every step")

    losses, norms, step_s = [], [], []
    launches = {k.__name__: 0 for k in kernels}
    for i in range(steps):
        for k in kernels:  # the main path's counts start here
            k.launches = 0
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        got = {k.__name__: k.launches for k in kernels}
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        aux = (f", moe_aux {float(metrics['moe_aux']):.5f}"
               if cfg.n_experts else "")
        log(f"train {label} step {i + 1}: loss {losses[-1]:.5f}, grad_norm "
            f"{norms[-1]:.5f}{aux}, {1e3 * step_s[-1]:.2f} ms, launches {got}, "
            f"allocated {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB, "
            f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        if got != want:
            fail(f"training step {i + 1} ({label}) launched {got}; expected "
                 f"{want}")
        for name, n in got.items():
            launches[name] += n
        if not (math.isfinite(losses[-1]) and math.isfinite(norms[-1])):
            fail(f"training step {i + 1} ({label}): loss {losses[-1]}, "
                 f"grad_norm {norms[-1]}")
    # logits z = x . W_head with rms(x) = 1 (final norm) and W_head ~
    # N(0, 0.02^2): z ~ N(0, 0.02^2 d), so E[loss] = ln V + var(z) / 2;
    # a MoE loss adds moe_aux_weight times the aux of near-uniform routing,
    # about 1 a layer
    expect = math.log(cfg.vocab_size) + 0.5 * 0.02 ** 2 * cfg.d_model
    if cfg.n_experts:
        expect += cfg.moe_aux_weight * cfg.n_layers
    log(f"train {label}: first loss {losses[0]:.5f}; ln(vocab) = "
        f"{math.log(cfg.vocab_size):.5f}, expected at this init "
        f"{expect:.5f}; last loss {losses[-1]:.5f}, drop "
        f"{losses[0] - losses[-1]:.5f} (predicted >= {MIN_LOSS_DROP} over "
        f"{TRAIN_STEPS} steps)")
    if abs(losses[0] - expect) > 0.5:
        fail(f"{label}: first loss {losses[0]} is not within 0.5 of {expect}")
    if steps >= TRAIN_STEPS and not losses[0] - losses[-1] >= MIN_LOSS_DROP:
        fail(f"{label}: loss fell by {losses[0] - losses[-1]} over "
             f"{steps} steps, predicted >= {MIN_LOSS_DROP}")

    timed = step_s[TIMED_FROM:]
    ms_step = 1e3 * statistics.mean(timed)
    tput = bench.throughput(cfg, n_params, TRAIN_BATCH, TRAIN_SEQ,
                            ms_step / 1e3, PEAK_BF16_OPS_PER_S)
    mfu = f"MFU {tput['mfu']:.4f}"
    if cfg.n_experts:
        # a token runs attention and two of the experts: 6 x those
        # parameters a token (the active MFU), beside 6 x all of them
        active = n_params - cfg.n_layers * (cfg.n_experts - 2) * 3 \
            * cfg.d_model * cfg.d_ff
        act = bench.throughput(cfg, active, TRAIN_BATCH, TRAIN_SEQ,
                               ms_step / 1e3, PEAK_BF16_OPS_PER_S)
        mfu = (f"MFU {act['mfu']:.4f} over 6 x {active / 1e9:.4f}B active "
               f"parameters a token ({tput['mfu']:.4f} over 6 x all "
               f"{n_params / 1e9:.4f}B)")
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"train {label}: {ms_step:.2f} ms/step (mean of steps "
        f"{TIMED_FROM + 1}-{steps}; min {1e3 * min(timed):.2f}, max "
        f"{1e3 * max(timed):.2f}), {tput['tokens_per_sec']:.1f} tokens/s, "
        f"{mfu} of {PEAK_BF16_OPS_PER_S / 1e12:.0f} TFLOP/s, peak device "
        f"memory {peak_gib:.2f} GiB [{card}]")
    state_bytes["grads"] = optimizer.nbytes
    result = {"losses": losses, "norms": norms, "launches": launches,
              "leaf_shapes": leaf_shapes, "ms_step": ms_step,
              "peak_gib": peak_gib, "state_bytes": state_bytes}
    if not profile:
        del state, step_fn, init_fn, batch, metrics
        gc.collect()
        torch.cuda.empty_cache()
        return result
    state, prof = bench.profile_train(step_fn, state, batch, steps=3,
                                      top=12)
    if prof["device_ms_per_step"] > 0:
        log(f"train {label} profile: device "
            f"{prof['device_ms_per_step']:.2f} ms/step "
            f"({prof['launches_per_step']:.0f} kernels/step) in a window of "
            f"{prof['ms_per_step']:.2f} ms/step, device-idle share "
            f"{prof['device_idle_share']:.4f} of that window [{card}]")
        log(f"train {label} profile by kind: " + ", ".join(
            f"{kind} {ms:.2f} ms/step" for kind, ms in sorted(
                prof["ms_per_step_by_kind"].items(), key=lambda kv: -kv[1])))
        for row in prof["top"]:
            log(f"  {row['ms_per_step']:.4f} ms/step ({row['share']:.3f}, "
                f"{row['calls_per_step']:.0f} calls) {row['name']}")
    else:
        log(f"train {label} profile: the profiler recorded no device time "
            f"(device-idle share not measured)")
    del state, step_fn, init_fn, batch, metrics
    gc.collect()
    torch.cuda.empty_cache()
    return result


def train_both(torch, card: str, seed: int, cfg):
    """Phases 8-10: the default step, then the all-kernel step on the same
    config, seed and batch, held against it. Returns ({kernel: {path:
    launches over the 8 steps}}, the default step's run as `train` returns
    it)."""
    from ray_tpu_torch.ops.kernels import adamw as aw
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.ops.kernels import fused_ffn as ff
    from ray_tpu_torch.train import default_optimizer, fused_adamw_optimizer

    L = cfg.n_layers
    # the packed kernels are on neither path: they must launch 0 times
    kernels = (*fa.KERNELS, *ff.KERNELS, aw.adamw_update,
               *fa.PACKED_KERNELS)
    default_want = {k.__name__: (L if k in (*fa.KERNELS, ff.dw_gateup)
                                 else 0) for k in kernels}
    base = train(torch, card, seed, cfg, default_optimizer(warmup_steps=2),
                 kernels, default_want, "default")
    n_leaves = sum(base["leaf_shapes"].values())
    want_shapes = {s: n for s, n in adamw_shapes(cfg).items() if n}
    if base["leaf_shapes"] != want_shapes:
        fail(f"the training tree's leaf shapes {base['leaf_shapes']} are not "
             f"the ones phase 7 checked the AdamW kernel at {want_shapes}")
    all_want = {k.__name__: L for k in (*fa.KERNELS, *ff.KERNELS)}
    all_want[aw.adamw_update.__name__] = n_leaves
    all_want.update({k.__name__: 0 for k in fa.PACKED_KERNELS})
    old = ff.USE_K1, ff.USE_K2, ff.USE_K3
    ff.USE_K1 = ff.USE_K2 = ff.USE_K3 = True
    try:
        allk = train(torch, card, seed, cfg,
                     fused_adamw_optimizer(warmup_steps=2), kernels,
                     all_want, "all-kernel")
    finally:
        ff.USE_K1, ff.USE_K2, ff.USE_K3 = old
    for i in range(2):
        a, b = allk["losses"][i], base["losses"][i]
        log(f"train all-kernel vs default: loss {i + 1} {a:.6f} vs {b:.6f} "
            f"(rel {abs(a - b) / abs(b):.3g}, limit {SAME_LOSS_RTOL})")
        if not abs(a - b) <= SAME_LOSS_RTOL * abs(b):
            fail(f"all-kernel loss {i + 1} {a} differs from the default "
                 f"path's {b}")
    a, b = allk["norms"][0], base["norms"][0]
    log(f"train all-kernel vs default: step 1 grad norm {a:.6f} vs {b:.6f} "
        f"(rel {abs(a - b) / abs(b):.3g}, limit {GRAD_NORM_RTOL})")
    if not abs(a - b) <= GRAD_NORM_RTOL * abs(b):
        fail(f"all-kernel step 1 grad norm {a} differs from the default "
             f"path's {b}")
    by_path = {k.__name__: {"default": base["launches"][k.__name__],
                            "all-kernel": allk["launches"][k.__name__]}
               for k in kernels}
    return by_path, base


def bf16_ulps(torch, got, want) -> float:
    """Largest |got - want| in units of the last place of bf16 at want."""
    want = want.float()
    mag = want.abs().clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - want).abs() / ulp).max().item()


def check_entries_on_model(torch, gen, seed: int, cfg, first_loss: float):
    """Phase 10b: softmax_cross_entropy and rms_norm_fused on the 8-layer
    model's own tensors, against the plain model functions, each of their
    four kernels launched exactly once. Returns {kernel: launches}."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.models import init_params
    from ray_tpu_torch.models.transformer import forward, token_nll
    from ray_tpu_torch.ops.kernels import rmsnorm as rms
    from ray_tpu_torch.ops.kernels import xent
    from ray_tpu_torch.ops.layers import rms_norm

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device="cuda")
    batch = bench.make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed + 1, "cuda")
    inputs, targets = batch["inputs"], batch["targets"]
    with torch.no_grad():
        logits = forward(params, inputs, cfg)
        act = params["embed"][inputs]
    weight = params["final_norm"]
    del params
    gc.collect()
    torch.cuda.empty_cache()
    V = cfg.vocab_size
    if logits.shape != (TRAIN_BATCH, TRAIN_SEQ, V) \
            or logits.dtype != torch.float32:
        fail(f"the model's logits are {tuple(logits.shape)} {logits.dtype}, "
             f"expected float32 [{TRAIN_BATCH}, {TRAIN_SEQ}, {V}]")
    g_act = torch.randn(act.shape, generator=gen, device="cuda").to(
        act.dtype)

    kernels = (*rms.KERNELS, *xent.KERNELS)
    for k in kernels:  # the main path's counts start here
        k.launches = 0
    lk = logits.detach().requires_grad_(True)
    loss_k = xent.softmax_cross_entropy(lk.view(-1, V),
                                        targets.reshape(-1)).mean()
    (grad_k,) = torch.autograd.grad(loss_k, lk)
    xk = act.detach().requires_grad_(True)
    wk = weight.detach().requires_grad_(True)
    out_k = rms.rms_norm_fused(xk, wk, cfg.norm_eps)
    dx_k, dw_k = torch.autograd.grad(out_k, (xk, wk), g_act)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}

    lr = logits.detach().requires_grad_(True)
    loss_r = token_nll(lr, targets)
    (grad_r,) = torch.autograd.grad(loss_r, lr)
    a, b = loss_k.item(), loss_r.item()
    g_err, g_rel = rel_err(torch, grad_k, grad_r)
    del lk, lr, grad_k, grad_r, logits
    torch.cuda.empty_cache()
    log(f"entries on the model: softmax_cross_entropy mean {a:.6f}, "
        f"token_nll {b:.6f} (rel {abs(a - b) / abs(b):.3g}, limit "
        f"{ENTRY_RTOL}; phase 8's step-1 loss {first_loss:.6f}); gradient "
        f"max abs err {g_err:.3g} ({g_rel:.3g} of its max, limit "
        f"{ENTRY_RTOL})")
    if not (math.isfinite(a) and abs(a - b) <= ENTRY_RTOL * abs(b)):
        fail(f"softmax_cross_entropy over the model's logits gives {a}, "
             f"token_nll {b}")
    if not g_rel <= ENTRY_RTOL:
        fail(f"the cross-entropy gradient over the model's logits differs "
             f"from token_nll's by {g_rel} of its max")

    xr = act.detach().requires_grad_(True)
    wr = weight.detach().requires_grad_(True)
    out_r = rms_norm(xr, wr, cfg.norm_eps)
    dx_r, dw_r = torch.autograd.grad(out_r, (xr, wr), g_act)
    ulps = bf16_ulps(torch, out_k, out_r)
    dx_err = rel_err(torch, dx_k, dx_r)
    dw_err = rel_err(torch, dw_k, dw_r)
    log(f"entries on the model: rms_norm_fused on {list(act.shape)} "
        f"{str(act.dtype).replace('torch.', '')} with final_norm: "
        f"{ulps:.3g} bf16 ulp from ops.layers.rms_norm (limit 1); dx "
        f"{dx_err[1]:.3g}, dw {dw_err[1]:.3g} of their max from autograd "
        f"through it (limit {REL_ERR_LIMIT})")
    if not ulps <= 1.0:
        fail(f"rms_norm_fused is {ulps} bf16 ulp from ops.layers.rms_norm")
    if not (dx_err[1] < REL_ERR_LIMIT and dw_err[1] < REL_ERR_LIMIT):
        fail(f"rms_norm_fused's dx/dw differ from autograd through "
             f"ops.layers.rms_norm: {dx_err}, {dw_err}")
    want = {k.__name__: 1 for k in kernels}
    log(f"entries on the model: launches {launches} (expected {want}); "
        f"phase {time.perf_counter() - t0:.2f} s")
    if launches != want:
        fail(f"phase 10b launched {launches}; expected {want}")
    return launches


def packed_shapes():
    """(b, heads, kv heads, sq, sk, head_dim, causal, calls in phase 10c) of
    the packed flash kernels: the 8B attention shape (b 2, 32 query and 8
    kv heads, s 2048, hd 128), then shapes that do not tile: a ragged
    sequence, a decode window (sq 64 against sk 300, n_rep 1, hd 64) and
    s 130 at hd 32, not causal."""
    return [(2, 32, 8, 2048, 2048, 128, True, 1),
            (1, 8, 2, 200, 200, 128, True, 0),
            (1, 2, 2, 64, 300, 64, True, 0),
            (1, 4, 1, 130, 130, 32, False, 0)]


def heads_view(t, n: int):
    """[b, s, n·d] -> the strided [b, n, s, d] view."""
    b, s, width = t.shape
    return t.view(b, s, n, width // n).transpose(1, 2)


def check_packed_kernels(torch, gen):
    """Phase 7c: the packed flash kernels against their plain versions,
    and their times, bounds and SDPA's time on the same strided heads."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from ray_tpu_torch.flashbench import sdpa_backend
    from ray_tpu_torch.ops.kernels import flash_attention as fa

    t0 = time.perf_counter()
    bf16 = torch.bfloat16
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    rows = {k.__name__: [] for k in fa.PACKED_KERNELS}

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf16)

    for b, h, kv, sq, sk, d, causal, calls in packed_shapes():
        shape = (b, h, kv, sq, sk, d)
        scale = d ** -0.5
        q, do = randn(b, sq, h * d), randn(b, sq, h * d)
        k, v = randn(b, sk, kv * d), randn(b, sk, kv * d)
        out, lse = fa.flash_fwd_packed(q, k, v, h, kv, scale, causal)
        p_out, p_lse = fa.flash_fwd_packed_plain(q, k, v, h, kv, scale,
                                                 causal)
        torch.cuda.synchronize()
        # lse relative to its largest magnitude: a causal row 0 has one
        # key, and its lse (that one score) may lie near 0
        fwd_checks = [("out", rel_err(torch, out, p_out), REL_ERR_LIMIT),
                      ("lse", rel_err(torch, lse, p_lse), STAT_REL_LIMIT)]
        del out, lse
        delta = fa.flash_delta_packed(p_out, do, h)
        bwd = (q, k, v, do, p_lse, delta, h, kv, scale, causal)
        dk, dv = fa.flash_bwd_dkv_packed(*bwd)
        p_dk, p_dv = fa.flash_bwd_dkv_packed_plain(*bwd)
        dq = fa.flash_bwd_dq_packed(*bwd)
        p_dq = fa.flash_bwd_dq_packed_plain(*bwd)
        torch.cuda.synchronize()
        dkv_checks = [("dk", rel_err(torch, dk, p_dk), REL_ERR_LIMIT),
                      ("dv", rel_err(torch, dv, p_dv), REL_ERR_LIMIT)]
        dq_checks = [("dq", rel_err(torch, dq, p_dq), REL_ERR_LIMIT)]
        del dk, dv, dq, p_dk, p_dv, p_dq
        torch.cuda.empty_cache()
        # FLOP as phase 7 (only the causal pairs); bytes: q, o, dO and dq
        # [b, sq, h·d], k, v, dk, dv [b, sk, kv·d], lse and delta [b, h, sq]
        product = 2 * b * h * causal_pairs(sq, sk, causal) * d
        qo_bytes, kv_bytes, row_bytes = (2 * b * sq * h * d,
                                         2 * b * sk * kv * d, 4 * b * h * sq)
        lib_fwd = lib_bwd = lib_out = None
        if sq == sk:  # SDPA's causal mask is end-aligned here
            leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
            views = [heads_view(t, n) for t, n in zip(leaves, (h, kv, kv))]
            lib_out = sdpa(*views, is_causal=causal, enable_gqa=True)
            g4 = heads_view(do, h)

            def lib_fwd():
                with torch.no_grad():
                    sdpa(*views, is_causal=causal, enable_gqa=True)

            def lib_bwd():
                torch.autograd.grad(lib_out, leaves, g4, retain_graph=True)

            if calls:
                log(f"SDPA at {list(shape)}: the dispatcher picks "
                    f"{sdpa_backend(*views, causal)}")
        lib_what = ("torch scaled_dot_product_attention on the strided "
                    "[b, h, s, d] views, enable_gqa")
        bwd_what = ("the autograd backward of that call (dq, dk and dv in "
                    "one call)")
        common = dict(torch=torch, flush=flush, shape=shape, dtype="bfloat16",
                      calls=calls, ops_per_s=PEAK_BF16_OPS_PER_S,
                      calls_what="calls in phase 10c")
        record_checked(rows=rows["flash_fwd_packed"], name="flash_fwd_packed",
                       checks=fwd_checks,
                       nbytes=2 * qo_bytes + 2 * kv_bytes + row_bytes,
                       ops=2 * product,
                       fn=lambda: fa.flash_fwd_packed(q, k, v, h, kv, scale,
                                                      causal),
                       plain=lambda: fa.flash_fwd_packed_plain(
                           q, k, v, h, kv, scale, causal),
                       library=lib_fwd, library_what=lib_what, **common)
        record_checked(rows=rows["flash_bwd_dkv_packed"],
                       name="flash_bwd_dkv_packed", checks=dkv_checks,
                       nbytes=2 * qo_bytes + 4 * kv_bytes + 2 * row_bytes,
                       ops=4 * product,
                       fn=lambda: fa.flash_bwd_dkv_packed(*bwd),
                       plain=lambda: fa.flash_bwd_dkv_packed_plain(*bwd),
                       library=lib_bwd, library_what=bwd_what, **common)
        record_checked(rows=rows["flash_bwd_dq_packed"],
                       name="flash_bwd_dq_packed", checks=dq_checks,
                       nbytes=3 * qo_bytes + 2 * kv_bytes + 2 * row_bytes,
                       ops=3 * product,
                       fn=lambda: fa.flash_bwd_dq_packed(*bwd),
                       plain=lambda: fa.flash_bwd_dq_packed_plain(*bwd),
                       library=lib_bwd, library_what=bwd_what, **common)
        lib_fwd = lib_bwd = lib_out = None
        del q, k, v, do, p_out, p_lse, delta, bwd
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    log(f"phase 7c: {time.perf_counter() - t0:.2f} s")
    return rows


def check_packed_entry_on_model(torch, gen, seed: int, cfg):
    """Phase 10c: ops.attention_packed on layer 0's own q, k, v of the
    8-layer model (fresh params, the seed and batch of phase 8), forward
    and backward, against the B1/B2 route (ops.attention on the [b, h, s,
    d] views) and the float32 reference; each packed kernel launched
    exactly once. Returns {kernel: launches}."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.models import init_params
    from ray_tpu_torch.ops.attention import (_repeat_kv, attention,
                                             attention_packed,
                                             causal_attention_reference)
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.ops.layers import (apply_rotary, rms_norm,
                                          rotary_embedding)

    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    params = init_params(cfg, seed=seed, device="cuda")
    batch = bench.make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed + 1, "cuda")
    b, s = batch["inputs"].shape
    with torch.no_grad():
        # layer 0's attention input as _attn_half builds it
        # (models/transformer.py:228-245; this config has fused_proj off)
        layer0 = {n: params["layers"][n][0]
                  for n in ("attn_norm", "wq", "wk", "wv")}
        x = params["embed"][batch["inputs"]]
        hn = rms_norm(x, layer0["attn_norm"], cfg.norm_eps)
        q, k, v = hn @ layer0["wq"], hn @ layer0["wk"], hn @ layer0["wv"]
        cos, sin = rotary_embedding(torch.arange(s, device="cuda"), hd,
                                    cfg.rope_theta)
        q = apply_rotary(q.view(b, s, H, hd), cos[None],
                         sin[None]).reshape(b, s, H * hd)
        k = apply_rotary(k.view(b, s, KV, hd), cos[None],
                         sin[None]).reshape(b, s, KV * hd)
    del params, layer0, x, hn
    gc.collect()
    torch.cuda.empty_cache()
    g = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)

    kernels = (*fa.PACKED_KERNELS, *fa.KERNELS)
    for kern in kernels:  # the main path's counts start here
        kern.launches = 0
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out_p = attention_packed(*leaves, n_heads=H, n_kv_heads=KV)
    grads_p = torch.autograd.grad(out_p, leaves, g)
    torch.cuda.synchronize()
    launches = {kern.__name__: kern.launches for kern in kernels}

    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out_b = attention(*(heads_view(t, n) for t, n in zip(leaves,
                                                         (H, KV, KV))))
    out_b = out_b.transpose(1, 2).reshape(b, s, H * hd)
    grads_b = torch.autograd.grad(out_b, leaves, g)

    # the float32 reference: [b, h, s, s] float32 logits (1.07 GB)
    leaves = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    q4, k4, v4 = (heads_view(t, n) for t, n in zip(leaves, (H, KV, KV)))
    ref = causal_attention_reference(q4, _repeat_kv(k4, H // KV),
                                     _repeat_kv(v4, H // KV))
    ref = ref.transpose(1, 2).reshape(b, s, H * hd)
    grads_r = torch.autograd.grad(ref, leaves, g.float())
    del leaves, q4, k4, v4
    torch.cuda.synchronize()

    names = ("out", "dq", "dk", "dv")
    errs = {}
    for name, p_t, b_t, r_t in zip(names, (out_p, *grads_p),
                                   (out_b, *grads_b), (ref, *grads_r)):
        errs[name] = {"vs_b1_b2": rel_err(torch, p_t, b_t)[1],
                      "b1_b2_vs_f32": rel_err(torch, b_t, r_t)[1],
                      "packed_vs_f32": rel_err(torch, p_t, r_t)[1]}
    same = {name: torch.equal(p_t, b_t) for name, p_t, b_t in
            zip(names, (out_p, *grads_p), (out_b, *grads_b))}
    del out_b, grads_b, ref, grads_r
    torch.cuda.empty_cache()
    # lse of the two routes, beside the counted run
    scale = hd ** -0.5
    _, lse_p = fa.flash_fwd_packed(q, k, v, H, KV, scale)
    flat = [heads_view(t, n).repeat_interleave(H // n, 1).reshape(
        b * H, s, hd) for t, n in ((q, H), (k, KV), (v, KV))]
    _, lse_b = fa.flash_fwd(*flat, scale)
    same["lse"] = torch.equal(lse_p.view(b * H, s), lse_b)
    del flat, lse_p, lse_b
    finite = all(bool(torch.isfinite(t).all()) for t in (out_p, *grads_p))
    log(f"packed entry on the model: layer 0's q {list(q.shape)}, k/v "
        f"{list(k.shape)} {str(q.dtype).replace('torch.', '')}; relative "
        f"errors {errs} (limit {REL_ERR_LIMIT}); bit-identical to the "
        f"B1/B2 route: {same}; finite {finite}")
    if not finite:
        fail("the packed entry's output or gradients on the model are not "
             "finite")
    if not (same["out"] and same["lse"] and same["dq"]):
        fail(f"the packed route's out, lse and dq are not bit-identical to "
             f"the B1/B2 route's: {same}")
    for name, e in errs.items():
        if not max(e.values()) < REL_ERR_LIMIT:
            fail(f"packed entry on the model: {name} {e} (limit "
                 f"{REL_ERR_LIMIT})")
    want = {kern.__name__: (1 if kern in fa.PACKED_KERNELS else 0)
            for kern in kernels}
    log(f"packed entry on the model: launches {launches} (expected "
        f"{want}); phase {time.perf_counter() - t0:.2f} s")
    if launches != want:
        fail(f"phase 10c launched {launches}; expected {want}")
    return {kern.__name__: launches[kern.__name__]
            for kern in fa.PACKED_KERNELS}


# Phase 7e (fault C.2): (b, heads, kv heads, s, head_dim, dtype) of the
# flash route beyond head_dim 128, causal: head_dim 256 (instantiated), 96
# and 192 (zero-padded to 128 and 256) in bf16 at s 1024, and head_dim 256
# in float32 on a small shape; the last is held within F32_KERNEL_LIMIT
# with TF32 off, the others within REL_ERR_LIMIT.
HEAD_DIM_SHAPES = [(1, 8, 2, 1024, 256, "bfloat16"),
                   (1, 8, 2, 1024, 96, "bfloat16"),
                   (1, 8, 2, 1024, 192, "bfloat16"),
                   (1, 4, 2, 256, 256, "float32")]


def flash_case(torch, fa, q, k, v, do, h: int, kv: int, causal: bool,
               lim: float) -> dict:
    """The three packed flash kernels on packed q, k, v, dO ([b, s, h·d],
    [b, s, kv·d]) and the three [b·h, s, d] ones on their flat views (K/V
    repeated per query head), each called once, against their plain
    versions. Returns {"checks": {layout: per kernel [(output, (max abs
    err, relative err), limit)]}, "layouts": {layout: (shape, bytes per
    kernel, kernel calls, plain calls)} for timing (causal pairs' work),
    "flat": the [b, s, n·d] -> [b·h, s, d] view}. The caller zeroes and
    reads the launch counters around it (the plain versions launch
    nothing)."""
    b, s, width = q.shape
    d = width // h
    scale = d ** -0.5
    esz = q.element_size()

    def flat(t, n):  # [b, s, n·d] -> [b·h, s, d], heads repeated to h
        return heads_view(t, n).repeat_interleave(h // n, 1).reshape(
            b * h, s, d).contiguous()

    q3, k3, v3, do3 = flat(q, h), flat(k, kv), flat(v, kv), flat(do, h)
    out, lse = fa.flash_fwd_packed(q, k, v, h, kv, scale, causal)
    p_out, p_lse = fa.flash_fwd_packed_plain(q, k, v, h, kv, scale, causal)
    delta = fa.flash_delta_packed(p_out, do, h)
    bwd = (q, k, v, do, p_lse, delta, h, kv, scale, causal)
    dk, dv = fa.flash_bwd_dkv_packed(*bwd)
    dq = fa.flash_bwd_dq_packed(*bwd)
    rows3 = (p_lse.view(b * h, s), delta.view(b * h, s))
    bwd3 = (q3, k3, v3, do3, *rows3, scale, causal)
    out3, lse3 = fa.flash_fwd(q3, k3, v3, scale, causal)
    dk3, dv3 = fa.flash_bwd_dkv(*bwd3)
    dq3 = fa.flash_bwd_dq(*bwd3)
    torch.cuda.synchronize()
    p_dk, p_dv = fa.flash_bwd_dkv_packed_plain(*bwd)
    p_dq = fa.flash_bwd_dq_packed_plain(*bwd)
    p_dk3, p_dv3 = fa.flash_bwd_dkv_plain(*bwd3)
    checks = {
        "packed": ([("out", rel_err(torch, out, p_out), lim),
                    ("lse", rel_err(torch, lse, p_lse), STAT_REL_LIMIT)],
                   [("dk", rel_err(torch, dk, p_dk), lim),
                    ("dv", rel_err(torch, dv, p_dv), lim)],
                   [("dq", rel_err(torch, dq, p_dq), lim)]),
        "flat": ([("out", rel_err(torch, out3, flat(p_out, h)), lim),
                  ("lse", rel_err(torch, lse3, rows3[0]), STAT_REL_LIMIT)],
                 [("dk", rel_err(torch, dk3, p_dk3), lim),
                  ("dv", rel_err(torch, dv3, p_dv3), lim)],
                 [("dq", rel_err(torch, dq3, flat(p_dq, h)), lim)])}
    del out, lse, dk, dv, dq, p_dk, p_dv, p_dq, out3, lse3, dk3, dv3, dq3
    del p_dk3, p_dv3
    torch.cuda.empty_cache()
    # bytes and FLOP as phases 7 and 7c (causal pairs only)
    qo, kvb, rowb = esz * b * s * h * d, esz * b * s * kv * d, 4 * b * h * s
    kv3 = esz * b * h * s * d  # K/V repeated per query head
    layouts = {
        "packed": ((b, h, kv, s, s, d),
                   (2 * qo + 2 * kvb + rowb, 2 * qo + 4 * kvb + 2 * rowb,
                    3 * qo + 2 * kvb + 2 * rowb),
                   (lambda: fa.flash_fwd_packed(q, k, v, h, kv, scale,
                                                causal),
                    lambda: fa.flash_bwd_dkv_packed(*bwd),
                    lambda: fa.flash_bwd_dq_packed(*bwd)),
                   (lambda: fa.flash_fwd_packed_plain(q, k, v, h, kv, scale,
                                                      causal),
                    lambda: fa.flash_bwd_dkv_packed_plain(*bwd),
                    lambda: fa.flash_bwd_dq_packed_plain(*bwd))),
        "flat": ((b * h, s, s, d),
                 (2 * qo + 2 * kv3 + rowb, 2 * qo + 4 * kv3 + 2 * rowb,
                  3 * qo + 2 * kv3 + 2 * rowb),
                 (lambda: fa.flash_fwd(q3, k3, v3, scale, causal),
                  lambda: fa.flash_bwd_dkv(*bwd3),
                  lambda: fa.flash_bwd_dq(*bwd3)),
                 (lambda: fa.flash_fwd_plain(q3, k3, v3, scale, causal),
                  lambda: fa.flash_bwd_dkv_plain(*bwd3),
                  lambda: fa.flash_bwd_dq_plain(*bwd3)))}
    return {"checks": checks, "layouts": layouts,
            "product": 2 * b * h * causal_pairs(s, s, True) * d}


def sdpa_library(torch, q, k, v, do, h: int, kv: int):
    """((forward, backward), (what, what)): one causal SDPA call on the
    strided [b, h, s, d] views of packed q, k, v (enable_gqa) and the
    autograd backward of it, the library yardsticks of the flash kernels,
    naming the backend PyTorch's dispatcher picks."""
    from torch.nn.attention import SDPBackend
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    views = [heads_view(t, n) for t, n in zip(leaves, (h, kv, kv))]
    backend = SDPBackend(torch._fused_sdp_choice(
        *views, is_causal=True, enable_gqa=True)).name
    out = sdpa(*views, is_causal=True, enable_gqa=True)
    g4 = heads_view(do, h)

    def forward():
        with torch.no_grad():
            sdpa(*views, is_causal=True, enable_gqa=True)

    def backward():
        torch.autograd.grad(out, leaves, g4, retain_graph=True)

    return (forward, backward), (
        f"torch scaled_dot_product_attention on the strided [b, h, s, d] "
        f"views, enable_gqa ({backend} backend)",
        "the autograd backward of that call")


def _fail_checks(name: str, what_shape: str, checks) -> None:
    for what, (err, rel), limit in checks:
        if not rel < limit:
            fail(f"{name} differs from its plain version at {what_shape}: "
                 f"{what} relative {rel} (limit {limit})")


def _time_case(torch, flush, case, lib, names, rows_of, dtype_name: str,
               calls: int, peak: float, calls_what: str) -> None:
    """record_checked for each layout and kernel of a `flash_case` into
    rows_of(layout, i) (None: checked, not timed)."""
    (lib_fwd, lib_bwd), (lib_what, bwd_what) = lib
    for layout, (shape, nbytes, fns, plains) in case["layouts"].items():
        for i, name in enumerate(names[layout]):
            rows = rows_of(layout, name)
            if rows is None:
                _fail_checks(name, f"{shape} {dtype_name}",
                             case["checks"][layout][i])
                continue
            record_checked(torch, flush, rows, name, shape, dtype_name,
                           calls, case["checks"][layout][i], nbytes[i],
                           (2, 4, 3)[i] * case["product"], peak, fns[i],
                           plains[i], (lib_fwd, lib_bwd, lib_bwd)[i],
                           (lib_what, bwd_what, bwd_what)[i], calls_what)


def check_head_dims(torch, gen, train_rows, packed_rows, f32_rows):
    """Phase 7e: the flash kernels at head_dim 256 and at padded head dims,
    through the packed and the [b·h, s, d] entries, against their plain
    versions (each kernel launched once per entry and shape), timed into
    the kernel rows as shapes the training step does not call (0 calls);
    then ops.attention, ops.attention_packed and the fused attn_block at
    each bf16 shape against the einsum route, none of it launching the
    wide family (head dims above 256: `check_wide_head_dims`)."""
    import importlib

    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.ops.kernels import fused_attn
    from ray_tpu_torch.ops.layers import rotary_embedding

    attn_mod = importlib.import_module("ray_tpu_torch.ops.attention")
    t0 = time.perf_counter()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    kernels = (*fa.KERNELS, *fa.PACKED_KERNELS)
    for b, h, kv, s, d, dtype_name in HEAD_DIM_SHAPES:
        dtype = getattr(torch, dtype_name)
        f32 = dtype == torch.float32

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        q, do = randn(b, s, h * d), randn(b, s, h * d)
        k, v = randn(b, s, kv * d), randn(b, s, kv * d)
        for kern in kernels:  # this shape's launches start here
            kern.launches = 0
        case = flash_case(torch, fa, q, k, v, do, h, kv, True,
                          F32_KERNEL_LIMIT if f32 else REL_ERR_LIMIT)
        launches = {kern.__name__: kern.launches for kern in kernels}
        log(f"head_dim {d} {dtype_name} (b {b}, {h}/{kv} heads, s {s}, "
            f"causal): launches {launches}")
        if launches != {kern.__name__: 1 for kern in kernels}:
            fail(f"phase 7e at head_dim {d} launched {launches}; expected "
                 f"one launch of each flash kernel")
        if any(kern.wide_launches for kern in kernels):
            fail(f"phase 7e at head_dim {d} launched the wide family: it "
                 f"serves head_dim above {fa.MAX_HEAD_DIM} only")
        suffix = "_f32" if f32 else ""
        names = {"packed": [f"{n.__name__}{suffix}"
                            for n in fa.PACKED_KERNELS],
                 "flat": [f"{n.__name__}{suffix}" for n in fa.KERNELS]}
        rows = {"packed": packed_rows if not f32 else None,
                "flat": train_rows if not f32 else f32_rows}
        _time_case(torch, flush, case, sdpa_library(torch, q, k, v, do, h,
                                                    kv), names,
                   lambda layout, name: (None if rows[layout] is None
                                         else rows[layout][name]),
                   dtype_name, 0,
                   PEAK_F32_OPS_PER_S if f32 else PEAK_BF16_OPS_PER_S,
                   "calls per training step")
        del case
        if not f32:
            check_entries_at_head_dim(torch, gen, attn_mod, fused_attn, fa,
                                      rotary_embedding, q, k, v, do, b, h,
                                      kv, s, d)
        del q, k, v, do
        torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    log(f"phase 7e: {time.perf_counter() - t0:.2f} s")


def check_entries_at_head_dim(torch, gen, attn_mod, fused_attn, fa,
                              rotary_embedding, q, k, v, do, b, h, kv, s, d):
    """ops.attention (the B1/B2 route) and ops.attention_packed forward and
    backward on the phase's q, k, v against the einsum reference in float32,
    and the fused attn_block at d_model h·d against its own einsum route
    (use_flash patched off); where the reference's gate takes the kernels
    (head_dim >= 128, s >= 128) each flash kernel launches once per entry,
    below it none."""
    n = 1 if fused_attn.use_flash(s, d, True) else 0
    kernels = (*fa.KERNELS, *fa.PACKED_KERNELS)
    for kern in kernels:
        kern.launches = 0
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out_b = attn_mod.attention(*(heads_view(t, n) for t, n in
                                 zip(leaves, (h, kv, kv))))
    out_b = out_b.transpose(1, 2).reshape(b, s, h * d)
    grads_b = torch.autograd.grad(out_b, leaves, do)
    out_p = attn_mod.attention_packed(*leaves, n_heads=h, n_kv_heads=kv)
    grads_p = torch.autograd.grad(out_p, leaves, do)
    torch.cuda.synchronize()
    got = {kern.__name__: kern.launches for kern in kernels}
    ref_leaves = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
    q4, k4, v4 = (heads_view(t, n) for t, n in zip(ref_leaves, (h, kv, kv)))
    ref = attn_mod.causal_attention_reference(
        q4, attn_mod._repeat_kv(k4, h // kv), attn_mod._repeat_kv(v4, h // kv))
    ref = ref.transpose(1, 2).reshape(b, s, h * d)
    grads_r = torch.autograd.grad(ref, ref_leaves, do.float())
    errs = {}
    for name, got_b, got_p, want in zip(("out", "dq", "dk", "dv"),
                                        (out_b, *grads_b), (out_p, *grads_p),
                                        (ref, *grads_r)):
        errs[name] = (rel_err(torch, got_b, want)[1],
                      rel_err(torch, got_p, want)[1])
    del leaves, out_b, grads_b, out_p, grads_p, ref_leaves, ref, grads_r
    del q4, k4, v4

    # the fused attention block at d_model h·d, flash route and einsum route
    D = h * d

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(q.dtype)

    x = randn(b, s, D)
    nw = randn(D, scale=0.1) + 1
    ws = [randn(*shape, scale=shape[0] ** -0.5) for shape in
          ((D, h * d), (D, kv * d), (D, kv * d), (h * d, D))]
    cos, sin = rotary_embedding(torch.arange(s, device="cuda"), d)
    dy = randn(b, s, D)
    before = {kern.__name__: kern.launches for kern in fa.KERNELS}
    results = []
    gate = fused_attn.use_flash
    for route in ("flash", "einsum"):
        if route == "einsum":
            fused_attn.use_flash = lambda *a: False
        try:
            xl = x.detach().requires_grad_(True)
            y = fused_attn.attn_block(xl, nw, *ws, cos[None], sin[None], h,
                                      kv)
            dx, = torch.autograd.grad(y, (xl,), dy)
            torch.cuda.synchronize()
        finally:
            fused_attn.use_flash = gate
        results.append((y, dx))
        if route == "flash":
            block = {n: kern.launches - before[n] for n, kern in
                     ((k.__name__, k) for k in fa.KERNELS)}
    errs["attn_block y"] = rel_err(torch, results[0][0], results[1][0])[1]
    errs["attn_block dx"] = rel_err(torch, results[0][1], results[1][1])[1]
    log(f"entries at head_dim {d}: relative errors {errs} (limit "
        f"{REL_ERR_LIMIT}); launches of attention + attention_packed {got}, "
        f"of attn_block {block}")
    want = {kern.__name__: n for kern in kernels}
    if got != want or block != {kern.__name__: n for kern in fa.KERNELS}:
        fail(f"the entries at head_dim {d} launched {got} and {block}; "
             f"expected one launch of each kernel per entry")
    for name, e in errs.items():
        if not max(e if isinstance(e, tuple) else (e,)) < REL_ERR_LIMIT:
            fail(f"entries at head_dim {d}: {name} {e} (limit "
                 f"{REL_ERR_LIMIT})")


# Phase 7e, the wide family (fault C.2): (b, heads, kv heads, s, head_dim,
# dtype) of the kernel checks, each causal and not, in both layouts; the
# causal ones timed. 320 is zero-padded to 384 (three 128-column slices),
# 512 takes four.
WIDE_SHAPES = [(1, 8, 2, 1024, 320, "bfloat16"),
               (1, 8, 2, 1024, 512, "bfloat16"),
               (1, 4, 2, 256, 320, "float32"),
               (1, 4, 2, 256, 512, "float32")]
WIDE_NAMES = {"flash_fwd": "flash_fwd_wide",
              "flash_bwd_dkv": "flash_bwd_dkv_wide",
              "flash_bwd_dq": "flash_bwd_dq_wide"}
# The wide kernels of the first (SIMT) design that a redesign replaced (all
# six: the bf16 dk/dv, dq and forward, the float32 dq, forward and dk/dv),
# ms a launch at phase 7e's causal shapes by head_dim, (packed, [b·h, s,
# d]), as PERF.md §6 records them (NVIDIA H100 80GB HBM3, 700 W).
WIDE_SIMT_MS = {("flash_bwd_dkv_wide", 320): (5.6142, 3.4027),
                ("flash_bwd_dkv_wide", 512): (9.0285, 5.1970),
                ("flash_bwd_dq_wide", 320): (3.2552, 3.2368),
                ("flash_bwd_dq_wide", 512): (5.7739, 5.3597),
                ("flash_fwd_wide", 320): (1.7819, 1.7600),
                ("flash_fwd_wide", 512): (2.8999, 2.8476),
                ("flash_bwd_dq_wide_f32", 320): (0.3540, 0.3532),
                ("flash_bwd_dq_wide_f32", 512): (0.5063, 0.5213),
                ("flash_fwd_wide_f32", 320): (0.2034, 0.2007),
                ("flash_fwd_wide_f32", 512): (0.2879, 0.2958),
                ("flash_bwd_dkv_wide_f32", 320): (0.6476, 0.3392),
                ("flash_bwd_dkv_wide_f32", 512): (0.7867, 0.4087)}


def check_wide_repeatable(torch, fa, q, k, v, do, h: int, kv: int,
                          causal: bool, what: str) -> None:
    """Phase 7e: the wide forward (out and lse), dk/dv and dq, packed and
    on the [b·h, s, d] views, called twice (the backward on the plain
    forward's lse and Δ), give the same bits (every output written once,
    no atomics)."""
    b, s, width = q.shape
    d = width // h
    scale = d ** -0.5

    def flat(x, n):
        return heads_view(x, n).repeat_interleave(h // n, 1).reshape(
            b * h, s, d).contiguous()

    p_out, p_lse = fa.flash_fwd_packed_plain(q, k, v, h, kv, scale, causal)
    delta = fa.flash_delta_packed(p_out, do, h)
    bwd = (q, k, v, do, p_lse, delta, h, kv, scale, causal)
    bwd3 = (flat(q, h), flat(k, kv), flat(v, kv), flat(do, h),
            p_lse.view(b * h, s), delta.view(b * h, s), scale, causal)
    fwd = (q, k, v, h, kv, scale, causal)
    fwd3 = (*bwd3[:3], scale, causal)
    for layout, f_args, args, fwd_fn, dkv, dq in (
            ("packed", fwd, bwd, fa.flash_fwd_packed,
             fa.flash_bwd_dkv_packed, fa.flash_bwd_dq_packed),
            ("flat", fwd3, bwd3, fa.flash_fwd, fa.flash_bwd_dkv,
             fa.flash_bwd_dq)):
        first = (*fwd_fn(*f_args), *dkv(*args), dq(*args))
        second = (*fwd_fn(*f_args), *dkv(*args), dq(*args))
        torch.cuda.synchronize()
        same = [bool(torch.equal(x, y)) for x, y in zip(first, second)]
        log(f"wide {what} {layout}: out, lse, dk, dv, dq bit-identical "
            f"across two calls {same}")
        if not all(same):
            fail(f"phase 7e, wide {what} {layout}: out, lse, dk, dv, dq "
                 f"differ between two calls ({same})")
    del p_out, p_lse, delta, bwd, bwd3, fwd, fwd3, first, second
    torch.cuda.empty_cache()


def check_wide_head_dims(torch, gen, card: str):
    """Phase 7e, head_dim 320 and 512 (fault C.2): the wide family
    (csrc/flash_wide.cu) through the packed entries (GQA by index) and the
    [b·h, s, d] ones, bf16 and float32, causal and not, against the plain
    versions (bf16 within 1e-2 of the plain max, float32 1e-4, lse 2e-5
    of its max), each wrapper launched once per call and every launch the
    wide family's, the forward, dk/dv and dq bit-identical across two
    calls (`check_wide_repeatable`); the causal cases timed beside their bound
    and SDPA (its backend named); then ops.attention, ops.attention_packed
    and the fused attn_block at each shape against the einsum route, with
    counters
    zeroed just before and read just after: the wide launches of that run
    are the family's launches on its path. Returns ({kernel: rows},
    {kernel: launches})."""
    import importlib

    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.ops.kernels import fused_attn
    from ray_tpu_torch.ops.layers import rotary_embedding

    attn_mod = importlib.import_module("ray_tpu_torch.ops.attention")
    t0 = time.perf_counter()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    kernels = (*fa.KERNELS, *fa.PACKED_KERNELS)
    rows = {}
    path_launches = {}
    for b, h, kv, s, d, dtype_name in WIDE_SHAPES:
        dtype = getattr(torch, dtype_name)
        f32 = dtype == torch.float32
        suffix = "_f32" if f32 else ""

        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        q, do = randn(b, s, h * d), randn(b, s, h * d)
        k, v = randn(b, s, kv * d), randn(b, s, kv * d)
        for causal in (True, False):
            for kern in kernels:
                kern.launches = kern.wide_launches = kern.f32_launches = 0
            case = flash_case(torch, fa, q, k, v, do, h, kv, causal,
                              F32_KERNEL_LIMIT if f32 else REL_ERR_LIMIT)
            got = {kern.__name__: (kern.launches, kern.wide_launches,
                                   kern.f32_launches)
                   for kern in kernels}
            want = {kern.__name__: (1, 1, int(f32)) for kern in kernels}
            log(f"wide head_dim {d} {dtype_name} (b {b}, {h}/{kv} heads, s "
                f"{s}, causal {causal}): (launches, wide, float32) "
                f"{got}")
            if got != want:
                fail(f"phase 7e at head_dim {d} {dtype_name} launched {got};"
                     f" expected {want}")
            check_wide_repeatable(torch, fa, q, k, v, do, h, kv, causal,
                                  f"head_dim {d} {dtype_name} causal "
                                  f"{causal}")
            names = {layout: [name + suffix for name in WIDE_NAMES.values()]
                     for layout in ("packed", "flat")}
            # not causal: checked, not timed
            _time_case(torch, flush, case,
                       sdpa_library(torch, q, k, v, do, h, kv), names,
                       lambda layout, name: (rows.setdefault(name, [])
                                             if causal else None),
                       dtype_name, 1,
                       PEAK_F32_OPS_PER_S if f32 else PEAK_BF16_OPS_PER_S,
                       "call per timed shape")
            del case
        # the entries at this head_dim: the family's launches on its path
        for kern in kernels:
            kern.wide_launches = 0
        check_entries_at_head_dim(torch, gen, attn_mod, fused_attn, fa,
                                  rotary_embedding, q, k, v, do, b, h, kv, s,
                                  d)
        for base, name in WIDE_NAMES.items():
            n = sum(kern.wide_launches for kern in kernels
                    if kern.__name__ in (base, base + "_packed"))
            path_launches[name + suffix] = (
                path_launches.get(name + suffix, 0) + n)
        del q, k, v, do
        torch.cuda.empty_cache()
    log(f"wide family launches on its path (ops.attention, "
        f"ops.attention_packed and attn_block at head_dim 320 and 512): "
        f"{path_launches}")
    for name, kernel_rows in rows.items():
        for r in kernel_rows:
            simt = WIDE_SIMT_MS.get((name, r["shape"][-1]))
            old = ("" if simt is None else f", the first (SIMT) design "
                   f"{simt[len(r['shape']) == 4]} ms")
            log(f"summary {name} {r['shape']} {r['dtype']}: {r['ms']:.4f} ms "
                f"a launch, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), "
                f"{r['bound_ms'] / r['ms']:.4f} of bound, plain "
                f"{r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms"
                f"{old} [{card}]")
    del flush
    torch.cuda.empty_cache()
    log(f"phase 7e, head_dim 320 and 512: {time.perf_counter() - t0:.2f} s")
    return rows, path_launches


# The first (wmma) designs of flash dk/dv, its packed run, K1, K3 and K2,
# ms a launch at the 8B shape, as PERF.md §6 records them before the wgmma
# redesigns replaced them; and the first (SIMT, 64 x 64 tiles, unsplit)
# float32 K1 and K2 by (T, d, d_ff): at the float32 tiny variant's shape
# (half the ms a step PERF.md §6 recorded) and at the 8B shape (ffnbench,
# before their redesign), as PERF.md gives them (NVIDIA H100 80GB HBM3,
# 700 W); the same for the first SIMT float32 flash forward, K3, dk/dv and
# dq.
OLD_MS = {"flash_bwd_dkv": 2.4535, "flash_bwd_dkv_packed": 2.7611,
          "dw_down": 4.8364, "dw_gateup": 6.3235, "dgateup": 3.0733,
          "dw_down_f32": {(256, 256, 256): 0.0796,
                          (4096, 4096, 14336): 28.2689},
          "dgateup_f32": {(256, 256, 256): 0.0567,
                          (4096, 4096, 14336): 22.4388},
          # PERF.md's times of the first SIMT design: a tiny-step launch
          # is half its per-step time (two launches a step)
          "flash_fwd_f32": {(4, 128, 128, 128): 0.0517,
                            (64, 2048, 2048, 128): 5.3116},
          "dw_gateup_f32": {(256, 256, 256): 0.0491,
                            (4096, 4096, 14336): 46.9911},
          "flash_bwd_dkv_f32": {(4, 128, 128, 128): 0.06625,
                                (64, 2048, 2048, 128): 6.6981},
          "flash_bwd_dq_f32": {(4, 128, 128, 128): 0.0603,
                               (64, 2048, 2048, 128): 5.8113}}
# SDPA computes dq, dk and dv in one backward call: the float32 dk/dv's
# share of it is 4 of the 7 products, dq's 3.
BWD_SHARE = {"flash_bwd_dkv_f32": 4 / 7, "flash_bwd_dq_f32": 3 / 7}


# Phases 10d-10f: Mixtral-8x7B (mistralai/Mixtral-8x7B-v0.1, its
# config.json) at full width, its depth cut to what one card holds: 8 of 32
# layers to serve (23.7 GB of bf16 weights, 35.6 GB while the w8a16 copy is
# made) and 2 of 32 to train (31.6 GB of params, grads and moments).
MOE_SERVE_LAYERS, MOE_TRAIN_LAYERS = 8, 2
# Serving routes without drops: capacity = T, as Mixtral itself routes (the
# reference's 1.25 would drop at least half of a decode step's top-2
# assignments at 8 slots); training keeps the reference's default.
MOE_SERVE_CAPACITY, MOE_TRAIN_CAPACITY = 8.0, 1.25
# The greedy-agreement gate of phase 4, pooled over the first requests: a
# router flip between the decode and prefill routes moves a whole expert's
# share, so one 16-token request is a noisy sample of it.
MOE_AGREEMENT_REQUESTS = 4
REMAT_MODES = ("none", "full", "dots", "dots_sans_qkv", "dots_plus_attn")
# Phase 10f: every mode's loss and grad norm against `none` (the same
# kernels recompute the same values), and the slack of the peak-memory
# order (none >= dots_plus_attn >= dots >= dots_sans_qkv >= full).
REMAT_RTOL = 1e-6
PEAK_SLACK = 0.01


def mixtral_config(n_layers: int, capacity_factor: float, **kw):
    """Mixtral-8x7B's published widths: d 4096, 32/8 heads of 128, 8
    experts of d_ff 14336, top-2, vocab 32000, rope_theta 1e6, RMSNorm eps
    1e-5, untied head, router aux coefficient 0.02."""
    from ray_tpu_torch.models import ModelConfig

    return ModelConfig(vocab_size=32000, d_model=4096, n_layers=n_layers,
                       n_heads=32, n_kv_heads=8, d_ff=14336,
                       max_seq_len=32768, rope_theta=1e6, norm_eps=1e-5,
                       n_experts=8, capacity_factor=capacity_factor,
                       moe_aux_weight=0.02, **kw)


def decode_rows(torch, params, cfg, card: str, prefix: str = "") -> None:
    """Phase 6's decode measurements: tokens/s and ms/step at NUM_SLOTS
    slots, then a torch.profiler window (device ms/step, idle share, top
    kernels), in bf16 and w8a16."""
    from ray_tpu_torch.models.servebench import measure_decode, profile_decode

    for label, quantize in (("bf16", False), ("w8a16", True)):
        dec = measure_decode(params, cfg, num_slots=NUM_SLOTS,
                             max_len=MAX_LEN, quantize_weights=quantize,
                             device="cuda")
        torch.cuda.empty_cache()
        log(f"{prefix}decode {label}: {dec['decode_tokens_per_s']} tok/s at "
            f"{NUM_SLOTS} slots, {dec['ms_per_step']} ms/step [{card}]")
        prof = profile_decode(params, cfg, num_slots=NUM_SLOTS,
                              max_len=MAX_LEN, quantize_weights=quantize,
                              device="cuda")
        torch.cuda.empty_cache()
        if prof["device_ms_per_step"] > 0:
            log(f"{prefix}decode {label} profile: device "
                f"{prof['device_ms_per_step']} ms/step "
                f"({prof['launches_per_step']} kernels/step) in a window of "
                f"{prof['ms_per_step']} ms/step, device-idle share "
                f"{prof['device_idle_share']} of that window [{card}]")
            for row in prof["top"]:
                log(f"  {row['ms_per_step']:.4f} ms/step "
                    f"({row['share']:.3f}) {row['name']}")
        else:
            log(f"{prefix}decode {label} profile: the profiler recorded no "
                f"device time (device-idle share not measured)")


def serve_moe(torch, card: str, seed: int) -> None:
    """Phase 10d: Mixtral-8x7B width, 8 layers, serves phase 4's requests
    in bf16 and w8a16 with phase 4's and 5's gates and phase 6's decode
    measurements."""
    from ray_tpu_torch.models import count_params, init_params
    from ray_tpu_torch.models.servebench import measure_quant_parity
    from ray_tpu_torch.ops.kernels import quant

    t0 = time.perf_counter()
    cfg = mixtral_config(MOE_SERVE_LAYERS, MOE_SERVE_CAPACITY)
    params = init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    log(f"moe serve: mixtral-8x7b width, {cfg.n_layers} of 32 layers, "
        f"{count_params(params) / 1e9:.3f}B params, {cfg.n_experts} experts "
        f"top-2 at capacity factor {cfg.capacity_factor}, random bf16 "
        f"weights (seed {seed}) in {time.perf_counter() - t0:.2f} s")
    requests = make_requests(cfg, seed)

    def agreement(p, eng, rids, label):
        fracs = [teacher_forced_agreement(torch, p, cfg, eng.result(rid),
                                          len(prompt))
                 for rid, (prompt, _) in zip(rids[:MOE_AGREEMENT_REQUESTS],
                                             requests)]
        n = [k for _, k in requests[:MOE_AGREEMENT_REQUESTS]]
        pooled = sum(f * k for f, k in zip(fracs, n)) / sum(n)
        log(f"serve {label}: teacher-forced agreement {pooled:.4f} over the "
            f"{sum(n)} tokens of requests 0-{len(n) - 1} (each: "
            f"{', '.join(f'{f:.3f}' for f in fracs)})")
        if pooled < 0.9:
            fail(f"{label} decode disagrees with teacher-forced prefill "
                 f"({pooled})")

    quant.dequantize_int8.launches = 0
    eng, rids = serve(torch, params, cfg, requests, False, "moe bf16")
    if quant.dequantize_int8.launches:
        fail("the MoE bf16 engine launched the dequant kernel")
    agreement(params, eng, rids, "moe bf16")
    del eng
    torch.cuda.empty_cache()

    for k in quant.KERNELS:  # the main path's counts start here
        k.launches = 0
    qeng, qrids = serve(torch, params, cfg, requests, True, "moe w8a16")
    launches = {k.__name__: k.launches for k in quant.KERNELS}
    qparams = qeng.params
    # one quant launch a quantized leaf at load (the 4-D expert leaves as
    # [L·E·in, out] rows); a pass dequantizes each of a layer's quantized
    # leaves once, then the LM head and the gathered embedding rows
    layer_leaves = {k: tuple(v["int8"].shape)
                    for k, v in qparams["layers"].items()
                    if isinstance(v, dict)}
    n_quant = len(layer_leaves) + 2
    per_pass = len(layer_leaves) * cfg.n_layers + 2
    want = {"quantize_int8": n_quant,
            "dequantize_int8": per_pass * (qeng.prefill_calls
                                           + qeng.decode_steps)}
    log(f"moe w8a16 leaves: {layer_leaves}, embed, lm_head; router kept "
        f"{str(qparams['layers']['router'].dtype).replace('torch.', '')}")
    log(f"launches on the MoE w8a16 serving path: {launches} (expected "
        f"{want}: {n_quant} leaves at load, {per_pass} a pass x "
        f"{qeng.prefill_calls} prefill calls + {qeng.decode_steps} decode "
        f"steps)")
    if launches != want:
        fail(f"MoE kernel launch counts {launches} != expected {want}")
    if isinstance(qparams["layers"]["router"], dict):
        fail("the router was quantized (the reference keeps it)")
    agreement(qparams, qeng, qrids, "moe w8a16")
    del qeng
    torch.cuda.empty_cache()

    parity = measure_quant_parity(params, cfg, max_len=MAX_LEN,
                                  qparams=qparams, device="cuda")
    log(f"moe w8a16 parity: logits rel err "
        f"{parity['logits_max_abs_diff_rel']} (limit 0.08), weight bytes "
        f"ratio {parity['weight_bytes_ratio']}")
    if not parity["logits_parity_ok"]:
        fail(f"MoE w8a16 logits rel err {parity['logits_max_abs_diff_rel']}")
    del qparams
    torch.cuda.empty_cache()
    decode_rows(torch, params, cfg, card, "moe ")
    log(f"moe serve: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; phase "
        f"{time.perf_counter() - t0:.2f} s")
    del params
    gc.collect()
    torch.cuda.empty_cache()


def train_moe(torch, card: str, seed: int) -> None:
    """Phase 10e: Mixtral-8x7B width, 2 layers, remat "dots", 8 steps of
    the default step, then 3 of the fused-AdamW step held against it."""
    from ray_tpu_torch.ops.kernels import adamw as aw
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.ops.kernels import fused_ffn as ff
    from ray_tpu_torch.train import default_optimizer, fused_adamw_optimizer

    cfg = mixtral_config(MOE_TRAIN_LAYERS, MOE_TRAIN_CAPACITY, remat="dots")
    L = cfg.n_layers
    kernels = (*fa.KERNELS, *ff.KERNELS, aw.adamw_update,
               *fa.PACKED_KERNELS)
    # the recompute reruns the flash forward; K1-K3 never run on MoE
    want = {k.__name__: 0 for k in kernels}
    want.update(flash_fwd=2 * L, flash_bwd_dkv=L, flash_bwd_dq=L)
    base = train(torch, card, seed, cfg, default_optimizer(warmup_steps=2),
                 kernels, want, "moe default")
    want["adamw_update"] = n_leaves = sum(base["leaf_shapes"].values())
    fused = train(torch, card, seed, cfg,
                  fused_adamw_optimizer(warmup_steps=2), kernels, want,
                  "moe fused-adamw", steps=3, profile=False)
    a, b = fused["losses"][0], base["losses"][0]
    log(f"train moe fused-adamw vs default: loss 1 {a:.6f} vs {b:.6f} (rel "
        f"{abs(a - b) / abs(b):.3g}, limit {SAME_LOSS_RTOL}); adamw_update "
        f"{n_leaves} launches a step, one a leaf")
    if not abs(a - b) <= SAME_LOSS_RTOL * abs(b):
        fail(f"MoE fused-adamw loss 1 {a} differs from the default's {b}")


def remat_modes(torch, card: str, seed: int, cfg, label: str) -> None:
    """Phase 10f: one forward and backward of `loss_fn` in each remat mode
    on the same params and batch: loss and grad norm as `none`'s, the
    flash forward at n_layers launches without remat and 2·n_layers with
    it, peak memory in the modes' order; each mode's peak GiB and ms (a
    second, timed run)."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.models import init_params
    from ray_tpu_torch.models.transformer import loss_fn, tree_leaves
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.ops.kernels import fused_ffn as ff
    from ray_tpu_torch.train.step import global_norm

    t0 = time.perf_counter()
    L = cfg.n_layers
    params = init_params(cfg, seed=seed, device="cuda")
    leaves = list(tree_leaves(params))
    for t in leaves:
        t.requires_grad_(True)
    batch = bench.make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed + 1, "cuda")
    kernels = (*fa.KERNELS, *ff.KERNELS)
    k3 = L if cfg.fused_ffn else 0  # the default fused-FFN block runs K3

    def run(mcfg):
        loss, aux = loss_fn(params, batch, mcfg)
        # what the forward left for the backward (allocator bookkeeping on
        # the host: no wait)
        saved = torch.cuda.memory_allocated() - held
        grads = torch.autograd.grad(loss, leaves)
        return (loss.detach(), aux["moe_aux"].detach(),
                global_norm(dict(enumerate(grads))), saved / 2 ** 30)

    rows = {}
    for mode in REMAT_MODES:
        mcfg = dataclasses.replace(cfg, remat=mode)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels:
            k.launches = 0
        loss, aux, gnorm, saved = run(mcfg)
        torch.cuda.synchronize()
        got = {k.__name__: k.launches for k in kernels}
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        t1 = time.perf_counter()
        run(mcfg)
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t1)
        rows[mode] = (float(loss), float(aux), float(gnorm), peak, ms,
                      saved)
        log(f"remat {label} {mode}: loss {float(loss):.7f}, moe_aux "
            f"{float(aux):.6f}, grad_norm {float(gnorm):.7f}, peak "
            f"{peak:.3f} GiB (params and batch {held / 2 ** 30:.3f}), "
            f"{saved:.3f} GiB held from the forward for the backward, "
            f"{ms:.2f} ms a forward and backward, launches {got} [{card}]")
        want = {k.__name__: 0 for k in kernels}
        want.update(flash_fwd=L if mode == "none" else 2 * L,
                    flash_bwd_dkv=L, flash_bwd_dq=L, dw_gateup=k3)
        if got != want:
            fail(f"remat {label} {mode} launched {got}; expected {want}")
    loss0, aux0, gnorm0 = rows["none"][:3]
    for mode, (loss, aux, gnorm, *_) in rows.items():
        for what, a, b in (("loss", loss, loss0), ("moe_aux", aux, aux0),
                           ("grad norm", gnorm, gnorm0)):
            if not abs(a - b) <= REMAT_RTOL * abs(b):
                fail(f"remat {label} {mode}: {what} {a} differs from none's "
                     f"{b}")
    order = ("none", "dots_plus_attn", "dots", "dots_sans_qkv", "full")
    same = all(r[:3] == rows["none"][:3] for r in rows.values())
    log(f"remat {label}: losses and grad norms equal to none's within "
        f"{REMAT_RTOL} (bit-identical: {same}); phase "
        f"{time.perf_counter() - t0:.2f} s")
    # peak memory, and what the forward held for the backward (each mode
    # keeps a subset of what the one before it keeps)
    for what, col in (("peak", 3), ("held from the forward", 5)):
        gib = [rows[m][col] for m in order]
        log(f"remat {label} {what} GiB: " + " >= ".join(
            f"{m} {g:.3f}" for m, g in zip(order, gib))
            + f" (slack {PEAK_SLACK})")
        for hi, lo in zip(gib, gib[1:]):
            if hi < lo * (1 - PEAK_SLACK):
                fail(f"remat {label}: {what} memory out of order {gib}")
    del params, leaves, batch
    gc.collect()
    torch.cuda.empty_cache()


def f32_summary(rows, card: str) -> None:
    """The redesigned float32 kernels (the flash forward, dk/dv and dq, K3,
    K1 and K2) at each shape their OLD_MS entry has: ms a launch, bound,
    share, the library call's time (dk/dv's and dq's share of SDPA's one
    backward, BWD_SHARE), and the first design's time."""
    for name in ("flash_fwd_f32", "flash_bwd_dkv_f32", "flash_bwd_dq_f32",
                 "dw_gateup_f32", "dw_down_f32", "dgateup_f32"):
        old = OLD_MS[name]
        share = BWD_SHARE.get(name, 1.0)
        for r in rows[name]:
            shape = tuple(r["shape"])
            if shape not in old:
                continue
            lib = r["library_ms"] * share
            part = (f"; {share * 7:.0f}/7 of it {lib:.4f} ms" if share < 1
                    else "")
            log(f"{name} at {list(shape)}: {r['ms']:.4f} ms a launch, bound "
                f"{r['bound_ms']:.4f} ms, {r['bound_ms'] / r['ms']:.3f} of "
                f"bound; library {r['library_ms']:.4f} ms ({r['library']}"
                f"{part}; {r['ms'] / lib:.2f}x it); the first SIMT design "
                f"{old[shape]} ms (PERF.md) [{card}]")


def redesign_summary(rows, names, card: str) -> None:
    """One line on each wgmma flash kernel at the 8B attention shape (the
    first row of each): ms a launch, bound and share, SDPA's forward and
    backward from the same run, the backward split between dk/dv and dq in
    proportion to their bounds (SDPA computes the three in one call; dk/dv
    is 4 products, dq 3), and the time of the kernel a redesign replaced."""
    fwd, dkv, dq = (rows[n][0] for n in names)
    bwd_bound = dkv["bound_ms"] + dq["bound_ms"]
    for i, (name, r) in enumerate(zip(names, (fwd, dkv, dq))):
        if r["library_ms"] is None:
            lib = "no library call at this shape"
        elif i == 0:
            lib = f"SDPA forward {r['library_ms']:.4f} ms"
        else:
            lib = (f"SDPA backward {r['library_ms']:.4f} ms, this kernel's "
                   f"bound share of it "
                   f"{r['library_ms'] * r['bound_ms'] / bwd_bound:.4f} ms")
        old = (f"; the kernel it replaced {OLD_MS[name]} ms (PERF.md)"
               if name in OLD_MS else "")
        log(f"{name} at {r['shape']}: {r['ms']:.4f} ms a launch, bound "
            f"{r['bound_ms']:.4f} ms, {r['bound_ms'] / r['ms']:.3f} of "
            f"bound; {lib}{old} [{card}]")


def ffn_summary(rows, name: str) -> str:
    """A wgmma fused-FFN kernel at the 8B shape (the first row): ms a
    launch, bound, share, the library call's time, and the time of the
    kernel its redesign replaced."""
    r = rows[name][0]
    return (f"{name} at {r['shape']}: {r['ms']:.4f} ms a launch, bound "
            f"{r['bound_ms']:.4f} ms, {r['bound_ms'] / r['ms']:.3f} of "
            f"bound; library {r['library_ms']:.4f} ms ({r['library']}); the "
            f"kernel it replaced {OLD_MS[name]} ms (PERF.md)")


def k3_k2_summary(torch, gen, rows, card: str) -> None:
    """The summary lines of the wgmma K3 and K2, and K3's h operand: with
    dgate the identity (T = d_ff = 256, d 4096), dW_gate[i, t] is the
    kernel's bf16 h of token t, d row i, exactly (one nonzero term a sum),
    which must equal the plain version's normed x."""
    from ray_tpu_torch.ops.kernels import fused_ffn as ff

    T, d = 256, 4096
    x = torch.randn((T, d), generator=gen, device="cuda").bfloat16()
    rstd = torch.rand((T, 1), generator=gen, device="cuda") + 0.5
    nw = (torch.randn((d,), generator=gen, device="cuda") * 0.1
          + 1).bfloat16()
    eye = torch.eye(T, device="cuda", dtype=torch.bfloat16)
    got = ff.dw_gateup(x, rstd, nw, eye, eye)[0].T
    want = ff.normed(x, rstd, nw)
    torch.cuda.synchronize()
    equal = torch.equal(got, want)
    differ = (got != want).float().mean().item()
    log(f"{ffn_summary(rows, 'dw_gateup')}; h operand ((x * rstd) * nw in "
        f"float32, rounded to bf16) against the plain version's at T {T} x "
        f"d {d}: equal {equal}, {differ:.3g} of the values differ [{card}]")
    log(f"{ffn_summary(rows, 'dgateup')} [{card}]")
    if not equal:
        fail(f"K3's h operand differs from the plain version's normed x in "
             f"{differ} of its values")


def k1_summary(torch, gen, rows, card: str) -> None:
    """The wgmma K1 at the 8B shape (ms a launch, bound, share, library,
    the kernel it replaced), and its swiglu operand against the plain
    version's: with dy the identity (T = d = 256), dW_down[m, t] is the
    kernel's bf16 swiglu of token t, d_ff row m, exactly (one nonzero term
    a sum). Its sigmoid is __expf and __fdividef."""
    from ray_tpu_torch.ops.kernels import fused_ffn as ff

    T, dff = 256, 14336
    gate = torch.randn((T, dff), generator=gen, device="cuda").bfloat16()
    up = torch.randn((T, dff), generator=gen, device="cuda").bfloat16()
    eye = torch.eye(T, device="cuda", dtype=torch.bfloat16)
    got = ff.dw_down(gate, up, eye).T
    want = ff.swiglu_act(gate, up)
    torch.cuda.synchronize()
    ulps = bf16_ulps(torch, got, want)
    differ = (got != want).float().mean().item()
    log(f"{ffn_summary(rows, 'dw_down')}; swiglu operand (__expf, "
        f"__fdividef) against the plain version's at T {T} x d_ff {dff}: "
        f"max {ulps:.3g} bf16 ulp, {differ:.3g} of the values differ "
        f"[{card}]")
    if not ulps <= 1:
        fail(f"K1's swiglu operand is {ulps} bf16 ulp from the plain "
             f"version's (one allowed)")


# The float32 kernels against their plain versions: both compute in full
# float32 (CUDA-core FMAs in the kernels, TF32 off for the plain versions'
# matmuls) and sum in another order.
F32_KERNEL_LIMIT = 1e-4
# The float32 tiny variant at head_dim 128 (ModelConfig.tiny() widened to
# d_model 256 with 2 heads and 1 kv head), trained at b 2 x s 128: the
# width at which the fused attention block takes the flash kernels.
F32_TINY = dict(d_model=256, n_heads=2, n_kv_heads=1)
F32_TINY_BATCH, F32_TINY_SEQ, F32_TINY_STEPS = 2, 128, 3
# its losses on the card against the same model, params and batch on the
# CPU
F32_LOSS_RTOL = 1e-4


def f32_tiny_config():
    from ray_tpu_torch.models import ModelConfig

    return dataclasses.replace(ModelConfig.tiny(), fused_ffn=True,
                               fused_attn=True, **F32_TINY)


def f32_flash_shapes(cfg):
    """(bh, sq, sk, head_dim, causal, calls per step of the f32 tiny
    variant) of the float32 flash kernels: the 8B attention shape, one that
    does not tile, and the tiny variant's own (b 2 x 2 heads, K/V repeated
    per query head, s 128)."""
    return [(64, 2048, 2048, 128, True, 0), (8, 1000, 1100, 64, True, 0),
            (F32_TINY_BATCH * cfg.n_heads, F32_TINY_SEQ, F32_TINY_SEQ,
             cfg.head_dim, True, cfg.n_layers)]


def f32_ffn_shapes(cfg):
    """(T, d, d_ff, calls per step of the f32 tiny variant) of the float32
    fused-FFN kernels: the 8B FFN shape, T 512 x d 256 x d_ff 512, one that
    tiles on no axis (and K1 and K2 split their reductions), and the tiny
    variant's own."""
    return [(4096, 4096, 14336, 0), (512, 256, 512, 0), (1000, 200, 328, 0),
            (F32_TINY_BATCH * F32_TINY_SEQ, cfg.d_model, cfg.d_ff,
             cfg.n_layers)]


# One float32 causal SDPA forward at [1, bh, s, d] under torch.profiler, in
# a process of its own: in chip_smoke's process a window that short
# recorded no kernel (twice), though in a fresh one it does, and after such
# a window SDPA's many-kernel backward at the tiny shape timed 3-4x slower
# (PERF.md).
SDPA_PROBE = """
import torch
from torch.nn.functional import scaled_dot_product_attention as sdpa
from ray_tpu_torch.flashbench import device_kernels
q, k, v = (torch.randn((1, {bh}, {s}, {d}), device="cuda") for _ in range(3))
def forward():
    with torch.no_grad():
        sdpa(q, k, v, is_causal=True)
print(device_kernels(forward))
"""


def sdpa_kernels(bh: int, s: int, d: int) -> str:
    """The kernels SDPA's float32 causal forward at [1, bh, s, d]
    launches, read by SDPA_PROBE."""
    proc = subprocess.run(
        [sys.executable, "-c", SDPA_PROBE.format(bh=bh, s=s, d=d)],
        cwd=HERE, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"the SDPA kernel probe failed:\n{proc.stderr[-2000:]}")
    return proc.stdout.strip()


def check_f32_kernels(torch, gen, cfg, card: str):
    """Phase 7d: the six float32 kernels (flash forward, dk/dv and dq, K3,
    K1, K2) against their plain versions, with their times, float32 bounds
    and a library call's time. Returns {kernel_f32: rows}."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    from ray_tpu_torch.flashbench import sdpa_backend
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.ops.kernels import fused_ffn as ff

    t0 = time.perf_counter()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    names = ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq", "dw_gateup",
             "dw_down", "dgateup")
    rows = {f"{n}_f32": [] for n in names}

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    def record(name, shape, calls, checks, nbytes, ops, fn, plain, library,
               library_what):
        record_checked(torch, flush, rows[name], name, shape, "float32",
                       calls, checks, nbytes, ops, PEAK_F32_OPS_PER_S, fn,
                       plain, library, library_what,
                       "calls per step of the f32 tiny variant")

    for bh, sq, sk, d, causal, calls in f32_flash_shapes(cfg):
        shape = (bh, sq, sk, d)
        scale = d ** -0.5
        q, k, v, do = (randn(bh, n, d) for n in (sq, sk, sk, sq))
        out, lse = fa.flash_fwd(q, k, v, scale, causal)
        p_out, p_lse = fa.flash_fwd_plain(q, k, v, scale, causal)
        delta = fa.flash_delta(p_out, do)
        bwd = (q, k, v, do, p_lse, delta, scale, causal)
        dk, dv = fa.flash_bwd_dkv(*bwd)
        p_dk, p_dv = fa.flash_bwd_dkv_plain(*bwd)
        dq = fa.flash_bwd_dq(*bwd)
        p_dq = fa.flash_bwd_dq_plain(*bwd)
        # dq and dk/dv sum in a fixed order (no atomics): a second call
        # gives the same bits
        same = {"flash_bwd_dkv": all(map(torch.equal, (dk, dv),
                                         fa.flash_bwd_dkv(*bwd))),
                "flash_bwd_dq": torch.equal(dq, fa.flash_bwd_dq(*bwd))}
        torch.cuda.synchronize()
        log(f"float32 flash at {list(shape)}: the forward's and dq's query "
            f"tile {fa.f32_fwd_tile(bh, sq)} (f32_fwd_tile), dk/dv's key "
            f"tile {fa.f32_dkv_tile(bh, sk)} (f32_dkv_tile); dq and dk/dv "
            f"bit-identical across two calls {same}")
        if not all(same.values()):
            fail(f"float32 dq/dk/dv at {list(shape)} differ between two "
                 f"calls: {same}")
        lim = F32_KERNEL_LIMIT
        fwd_checks = [("out", rel_err(torch, out, p_out), lim),
                      ("lse", rel_err(torch, lse, p_lse), lim)]
        dkv_checks = [("dk", rel_err(torch, dk, p_dk), lim),
                      ("dv", rel_err(torch, dv, p_dv), lim)]
        dq_checks = [("dq", rel_err(torch, dq, p_dq), lim)]
        del out, lse, dk, dv, dq, p_dk, p_dv, p_dq
        torch.cuda.empty_cache()
        product = 2 * bh * causal_pairs(sq, sk, causal) * d
        qo_bytes, kv_bytes, row_bytes = 4 * bh * sq * d, 4 * bh * sk * d, \
            4 * bh * sq
        lib_fwd = lib_bwd = lib_out = None
        if sq == sk:  # SDPA's causal mask is end-aligned here
            q4, k4, v4 = (t.view(1, *t.shape).requires_grad_(True)
                          for t in (q, k, v))
            lib_out = sdpa(q4, k4, v4, is_causal=causal)
            g4 = do.view(1, *do.shape)

            def lib_fwd():
                with torch.no_grad():
                    sdpa(q4, k4, v4, is_causal=causal)

            def lib_bwd():
                torch.autograd.grad(lib_out, (q4, k4, v4), g4,
                                    retain_graph=True)

            log(f"SDPA float32 at {list(shape)}: the dispatcher picks "
                f"{sdpa_backend(q4, k4, v4, causal)}; its forward launches "
                f"{sdpa_kernels(bh, sq, d)}")
        lib_what = "torch scaled_dot_product_attention in float32"
        bwd_what = "the backward of that call (dq, dk and dv in one call)"
        record("flash_fwd_f32", shape, calls, fwd_checks,
               2 * qo_bytes + 2 * kv_bytes + row_bytes, 2 * product,
               lambda: fa.flash_fwd(q, k, v, scale, causal),
               lambda: fa.flash_fwd_plain(q, k, v, scale, causal), lib_fwd,
               lib_what)
        record("flash_bwd_dkv_f32", shape, calls, dkv_checks,
               2 * qo_bytes + 4 * kv_bytes + 2 * row_bytes, 4 * product,
               lambda: fa.flash_bwd_dkv(*bwd),
               lambda: fa.flash_bwd_dkv_plain(*bwd), lib_bwd, bwd_what)
        record("flash_bwd_dq_f32", shape, calls, dq_checks,
               3 * qo_bytes + 2 * kv_bytes + 2 * row_bytes, 3 * product,
               lambda: fa.flash_bwd_dq(*bwd),
               lambda: fa.flash_bwd_dq_plain(*bwd), lib_bwd, bwd_what)
        lib_fwd = lib_bwd = lib_out = None
        del q, k, v, do, p_out, p_lse, delta, bwd
        torch.cuda.empty_cache()

    for T, d, dff, calls in f32_ffn_shapes(cfg):
        x = randn(T, d)
        rstd = torch.rand((T, 1), generator=gen, device="cuda") + 0.5
        nw = randn(d, scale=0.1) + 1
        dgate, dup = randn(T, dff, scale=0.01), randn(T, dff, scale=0.01)
        gate, up = randn(T, dff), randn(T, dff)
        dy = randn(T, d, scale=0.01)
        wd = randn(dff, d, scale=dff ** -0.5)
        lim = F32_KERNEL_LIMIT
        dwg, dwu = ff.dw_gateup(x, rstd, nw, dgate, dup)
        p_dwg, p_dwu = ff.dw_gateup_plain(x, rstd, nw, dgate, dup)
        dwd = ff.dw_down(gate, up, dy)
        p_dwd = ff.dw_down_plain(gate, up, dy)
        dg, du = ff.dgateup(dy, wd, gate, up)
        p_dg, p_du = ff.dgateup_plain(dy, wd, gate, up)
        # K3, K1 and K2 split no reduction with atomics: a second call
        # gives the same bits
        same = {"dw_gateup": all(map(torch.equal, (dwg, dwu),
                                     ff.dw_gateup(x, rstd, nw, dgate, dup))),
                "dw_down": torch.equal(dwd, ff.dw_down(gate, up, dy)),
                "dgateup": all(map(torch.equal, (dg, du),
                                   ff.dgateup(dy, wd, gate, up)))}
        torch.cuda.synchronize()
        log(f"float32 K3, K1 and K2 at {(T, d, dff)}: plan K3 "
            f"{ff.f32_plan(d, dff, T, 2)}, K1 {ff.f32_plan(dff, d, T)}, K2 "
            f"{ff.f32_plan(T, dff, d)}; two calls bit-identical {same}")
        if not all(same.values()):
            fail(f"float32 K3/K1/K2 at {(T, d, dff)} differ between two "
                 f"calls: {same}")
        k3_checks = [("dw_gate", rel_err(torch, dwg, p_dwg), lim),
                     ("dw_up", rel_err(torch, dwu, p_dwu), lim)]
        k1_checks = [("dw_down", rel_err(torch, dwd, p_dwd), lim)]
        k2_checks = [("dgate", rel_err(torch, dg, p_dg), lim),
                     ("dup", rel_err(torch, du, p_du), lim)]
        h = ff.normed(x, rstd, nw)
        s_act = ff.swiglu_act(gate, up)
        shape = (T, d, dff)
        record("dw_gateup_f32", shape, calls, k3_checks,
               4 * (T * d + T + d + 2 * T * dff + 2 * d * dff),
               2 * 2 * T * d * dff,
               lambda: ff.dw_gateup(x, rstd, nw, dgate, dup),
               lambda: ff.dw_gateup_plain(x, rstd, nw, dgate, dup),
               lambda: (torch.matmul(h.T, dgate), torch.matmul(h.T, dup)),
               "two float32 torch.matmul(h.T, .) on a precomputed h")
        record("dw_down_f32", shape, calls, k1_checks,
               4 * (2 * T * dff + T * d + dff * d), 2 * T * d * dff,
               lambda: ff.dw_down(gate, up, dy),
               lambda: ff.dw_down_plain(gate, up, dy),
               lambda: torch.matmul(s_act.T, dy),
               "float32 torch.matmul(s.T, dy) on a precomputed swiglu s")
        record("dgateup_f32", shape, calls, k2_checks,
               4 * (T * d + dff * d + 4 * T * dff), 2 * T * d * dff,
               lambda: ff.dgateup(dy, wd, gate, up),
               lambda: ff.dgateup_plain(dy, wd, gate, up),
               lambda: torch.matmul(dy, wd.T),
               "float32 torch.matmul(dy, w_down.T), the product alone")
        del x, rstd, nw, dgate, dup, gate, up, dy, wd, h, s_act
        del dwg, dwu, p_dwg, p_dwu, dwd, p_dwd, dg, du, p_dg, p_du
        torch.cuda.empty_cache()
    del flush
    f32_summary(rows, card)
    torch.cuda.empty_cache()
    log(f"phase 7d: {time.perf_counter() - t0:.2f} s")
    return rows


def train_f32_tiny(torch, seed: int, cfg):
    """Phase 7d's main path: the float32 tiny variant at head_dim 128,
    fused_ffn and fused_attn, USE_K1 = USE_K2 = True, F32_TINY_STEPS steps
    of default_optimizer on the card, each float32 kernel launched n_layers
    times a step (counters zeroed before each step, read after); the losses
    against the same params and batch on the CPU. Returns {kernel_f32:
    launches over the steps}."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.models import init_params
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.ops.kernels import fused_ffn as ff
    from ray_tpu_torch.train import default_optimizer, make_train_step
    from ray_tpu_torch.train.step import TrainState

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        return tree.to(dev)

    t0 = time.perf_counter()
    kernels = (*fa.KERNELS, *ff.KERNELS)
    L = cfg.n_layers
    want = {k.__name__: (L, L) for k in kernels}
    opt = default_optimizer(1e-3, warmup_steps=1)
    params = init_params(cfg, seed=seed, device="cpu")
    batch = bench.make_batch(cfg, F32_TINY_BATCH, F32_TINY_SEQ, seed + 1,
                             "cpu")
    curves = {}
    launches = {f"{k.__name__}_f32": 0 for k in kernels}
    old = ff.USE_K1, ff.USE_K2
    ff.USE_K1 = ff.USE_K2 = True
    try:
        for dev in ("cuda", "cpu"):
            step_fn, _ = make_train_step(cfg, opt, device=dev)
            p = to(params, dev)
            state = TrainState(params=p, opt_state=opt.init(p), step=0)
            losses = []
            for i in range(F32_TINY_STEPS):
                for k in kernels:  # the main path's counts start here
                    k.launches = k.f32_launches = 0
                state, metrics = step_fn(state, batch)
                losses.append(float(metrics["loss"]))
                if dev != "cuda":
                    continue
                got = {k.__name__: (k.launches, k.f32_launches)
                       for k in kernels}
                if got != want:
                    fail(f"f32 tiny step {i + 1} launched {got} (launches, "
                         f"float32 launches); expected {want}")
                for k in kernels:
                    launches[f"{k.__name__}_f32"] += k.f32_launches
            curves[dev] = losses
    finally:
        ff.USE_K1, ff.USE_K2 = old
    rel = max(abs(a - b) / abs(b) for a, b in zip(curves["cuda"],
                                                   curves["cpu"]))
    log(f"train f32 tiny (d_model {cfg.d_model}, head_dim {cfg.head_dim}, "
        f"{L} layers, b {F32_TINY_BATCH} x s {F32_TINY_SEQ}): losses "
        f"{curves['cuda']} on the card, {curves['cpu']} on the CPU (max rel "
        f"{rel:.3g}, limit {F32_LOSS_RTOL}); each float32 kernel "
        f"{L} launches a step; {time.perf_counter() - t0:.2f} s")
    if not all(math.isfinite(x) for x in curves["cuda"]):
        fail(f"f32 tiny losses {curves['cuda']} are not finite")
    if not rel <= F32_LOSS_RTOL:
        fail(f"f32 tiny losses on the card {curves['cuda']} differ from the "
             f"CPU's {curves['cpu']} by {rel} relative")
    return launches


# dynamic shared memory a block of each kernel ptxas_report logs, at head_dim
# d or float32 tile d: the wgmma kernels' bf16 tiles and 1 KB to align
# them (the forward's 128 query rows and two stages of 64-row K and V; dq's
# 128 rows of Q and dO and its K/V stages (one at d 256); dk/dv's K and V
# (128 keys, 64 at d 256), two stages of Q and dO and of lse and delta;
# K1's three stages of gate, up and dy; K3's four of x, dgate and dup (64 x
# 128 each) and 64 rstd values; K2's four of dy (128 x 64) and W_down (256
# x 64)); the float32 K1's three stages of gate, up and dy (16 x (d + 4)
# floats each), and K2's three of dy and W_down as loaded (d x 20 floats
# each) and two pairs of transposed tiles (16 x (d + 4)), K3's three of x
# and dgate|dup (16 x (d + 4) floats each); the float32
# forward's Q [rows][d], K and V slots [64][d] and P [rows][64]; the
# float32 dq's Q and dO [rows][d], K and V slots [32][d] and dS [rows][32];
# the float32 dk/dv's K and V [keys][d], Q and dO slots [32][d], P^T and
# dS^T [keys][32] and lse and delta slots [32]; the wide bf16 dq's and
# dk/dv's four-stage chunk ring (Q and dO chunks of 128 x 64, K and V of
# 64 x 64, lse and delta of 128 rows), at any head_dim; the wide bf16
# forward's by plan and head_dim (flash_attention.wide_fwd_plan: its ring,
# V slice and resident Q); the wide float32 dq's four-stage ring of Q and
# dO chunks [rows][64] and K and V chunks [32][64], dS [32][rows] and the
# rows' lse and delta; the wide float32 forward's and dk/dv's by tile and
# head_dim (flash_attention.wide_f32_smem: the forward's ring of K and V
# chunk pairs, resident Q, p, alpha and l; dk/dv's ring of Q and dO
# chunks, resident K and V, p and ds).
KERNEL_SMEM = {
    "flash_fwd_kernel": lambda d: 2 * (128 + 4 * 64) * d + 1024,
    "flash_bwd_dq_kernel": lambda d: (2 * (256 + (2 if d > 128 else 4) * 64)
                                      * d + 1024),
    "flash_bwd_dkv_kernel": lambda d: (2 * (2 * (64 if d > 128 else 128)
                                            + 4 * 64) * d + 4 * 4 * 64
                                       + 1024),
    "dw_down_kernel": lambda d: 2 * 3 * (2 * 64 * 128 + 64 * 256) + 1024,
    "dw_gateup_kernel": lambda d: 4 * (2 * 3 * 64 * 128 + 4 * 64) + 1024,
    "dgateup_kernel": lambda d: 2 * 4 * (128 + 256) * 64 + 1024,
    "dw_down_f32_kernel": lambda d: 4 * 3 * 3 * 16 * (d + 4),
    "dgateup_f32_kernel": lambda d: 4 * (3 * 2 * d * 20
                                         + 2 * 2 * 16 * (d + 4)),
    "dw_gateup_f32_kernel": lambda d: 4 * 3 * 2 * 16 * (d + 4),
    "flash_fwd_f32_kernel": lambda d, rows: 4 * (rows * d + 2 * 64 * d
                                                 + rows * 64),
    "flash_bwd_dq_f32_kernel": lambda d, rows: 4 * (2 * rows * d
                                                    + 2 * 32 * d
                                                    + rows * 32),
    "flash_bwd_dkv_f32_kernel": lambda d, keys: 4 * (2 * keys * d
                                                     + 2 * 32 * d
                                                     + 2 * keys * 32
                                                     + 2 * 32),
    "flash_wide_dq_wgmma_kernel": lambda: 4 * (2 * 2 * 64 * (128 + 64)
                                               + 4 * 2 * 128) + 1024,
    "flash_wide_dkv_wgmma_kernel": lambda: 4 * (2 * 2 * 64 * (128 + 64)
                                                + 4 * 2 * 128) + 1024,
    "flash_wide_fwd_wgmma_kernel": lambda d: _wide_fwd_plan(d)[2],
    "flash_wide_dq_f32_kernel": lambda rows: 4 * (4 * 64 * (2 * rows + 64)
                                                  + rows * (32 + 2)),
    "flash_wide_fwd_f32_kernel": lambda rows, d: _wide_f32_smem("fwd", rows,
                                                                d),
    "flash_wide_dkv_f32_kernel": lambda d: _wide_f32_smem("dkv", 16, d),
}
# The head dims at which phase 2 logs each wide float32 instantiation's
# dynamic shared memory, by (kernel, its template arguments): Q (K and V)
# resident at the plans' whole-head widths, streamed above them.
WIDE_F32_SMEM_AT = {
    ("flash_wide_fwd_f32_kernel", "32", "1"): (384, 512),
    ("flash_wide_fwd_f32_kernel", "16", "1"): (384, 512, 1024),
    ("flash_wide_fwd_f32_kernel", "16", "0"): (1152, 4096),
    ("flash_wide_dkv_f32_kernel", "1"): (384, 512),
    ("flash_wide_dkv_f32_kernel", "0"): (640, 4096),
}


def _wide_fwd_plan(d: int):
    from ray_tpu_torch.ops.kernels import flash_attention as fa

    return fa.wide_fwd_plan(d)


def _wide_f32_smem(kernel: str, rows: int, d: int) -> int:
    from ray_tpu_torch.ops.kernels import flash_attention as fa

    return fa.wide_f32_smem(kernel, rows, d)


def ptxas_report(procs) -> None:
    """Log ptxas's registers, spills and the dynamic shared memory of the
    wgmma kernels, the float32 K1, K2 and K3 and the float32 flash
    forward, dq and dk/dv at each instantiation, and the registers, spills
    and dynamic shared memory of the wide flash family's wgmma forward, dq
    and dk/dv and its float32 forward, dq and dk/dv at each plan (the
    `nvcc -Xptxas -v` runs started in phase 2), any warning ptxas gives,
    and any note that it serialized products; fail if a float32 K1, K2 or
    K3 with 128 x 128 tiles (8 x 8 accumulators a thread), a float32 flash
    kernel at head_dim 128, a wide wgmma kernel or a wide float32 kernel
    spills, or if ptxas serialized the products of a wide kernel
    (C7515)."""
    import re

    for name, (proc, out_path) in procs.items():
        log_text, _ = proc.communicate()
        out_path.unlink(missing_ok=True)
        if proc.returncode != 0:
            fail(f"nvcc -Xptxas -v on {name}.cu failed:\n{log_text}")
        lines = log_text.splitlines()
        for i, line in enumerate(lines):
            # warnings, and notes of products ptxas serialized (C7515)
            if "warning" in line.lower() or "Performance Loss" in line:
                log(f"ptxas {name}.cu: {line.strip()}")
                if "Performance Loss" in line and "flash_wide_" in line:
                    fail(f"ptxas serialized a wide kernel's products: "
                         f"{line.strip()}")
            w = re.search(r"Compiling entry function '.*?(flash_wide_"
                          r"(?:dq|dkv)_wgmma_kernel)", line)
            if w:  # the wide bf16 backward: wgmma, dynamic shared memory
                stats = " ".join(x.split(":", 1)[-1].strip()
                                 for x in lines[i + 1:i + 4]
                                 if "registers" in x or "spill" in x)
                log(f"ptxas {w.group(1)}: {stats}; dynamic shared memory "
                    f"{KERNEL_SMEM[w.group(1)]()} bytes a block")
                if not re.search(r"\b0 bytes spill stores", stats):
                    fail(f"ptxas: {w.group(1)} spills ({stats})")
                continue
            w = re.search(r"Compiling entry function '.*?(flash_wide_fwd_"
                          r"wgmma_kernel)ILb([01])E|(flash_wide_dq_f32_"
                          r"kernel)ILi(\d+)E", line)
            if w:  # the wide bf16 forward by plan, the float32 dq by tile
                stats = " ".join(x.split(":", 1)[-1].strip()
                                 for x in lines[i + 1:i + 4]
                                 if "registers" in x or "spill" in x)
                if w.group(1):
                    kernel, resident = w.group(1), w.group(2) == "1"
                    inst = "<Q resident>" if resident else "<Q streamed>"
                    smem = ", ".join(
                        f"{KERNEL_SMEM[kernel](d)} bytes at head_dim {d}"
                        for d in ((384, 512) if resident else (640,)))
                else:
                    kernel, rows = w.group(3), int(w.group(4))
                    inst = f"<{rows}>"
                    smem = f"{KERNEL_SMEM[kernel](rows)} bytes"
                log(f"ptxas {kernel}{inst}: {stats}; dynamic shared memory "
                    f"{smem} a block")
                if not re.search(r"\b0 bytes spill stores", stats):
                    fail(f"ptxas: {kernel}{inst} spills ({stats})")
                continue
            w = re.search(r"Compiling entry function '.*?(flash_wide_fwd_"
                          r"f32_kernel)ILi(\d+)ELb([01])E|(flash_wide_dkv_"
                          r"f32_kernel)ILb([01])E", line)
            if w:  # the wide float32 forward by (tile, Q resident), dk/dv
                stats = " ".join(x.split(":", 1)[-1].strip()
                                 for x in lines[i + 1:i + 4]
                                 if "registers" in x or "spill" in x)
                if w.group(1):
                    kernel, args = w.group(1), (w.group(2), w.group(3))
                    dims = WIDE_F32_SMEM_AT[(kernel, *args)]
                    smem = ", ".join(
                        f"{KERNEL_SMEM[kernel](int(args[0]), d)} bytes at "
                        f"head_dim {d}" for d in dims)
                else:
                    kernel, args = w.group(4), (w.group(5),)
                    dims = WIDE_F32_SMEM_AT[(kernel, *args)]
                    smem = ", ".join(f"{KERNEL_SMEM[kernel](d)} bytes at "
                                     f"head_dim {d}" for d in dims)
                inst = f"<{', '.join(args)}>"
                log(f"ptxas {kernel}{inst}: {stats}; dynamic shared memory "
                    f"{smem} a block")
                if not re.search(r"\b0 bytes spill stores", stats):
                    fail(f"ptxas: {kernel}{inst} spills ({stats})")
                continue
            m = re.search(r"Compiling entry function '.*?(flash_fwd_kernel|"
                          r"flash_bwd_dq_kernel|flash_bwd_dkv_kernel|"
                          r"flash_fwd_f32_kernel|flash_bwd_dq_f32_kernel|"
                          r"flash_bwd_dkv_f32_kernel|"
                          r"dw_down_kernel|dw_gateup_kernel|dgateup_kernel|"
                          r"dw_down_f32_kernel|dgateup_f32_kernel|"
                          r"dw_gateup_f32_kernel)"
                          r"I?L?([ib])(\d*)(?:ELi(\d+))?", line)
            if not m:
                continue
            kernel = m.group(1)
            if m.group(2) == "i":  # <head_dim or tile> or <head_dim, rows>
                params = tuple(int(g) for g in m.groups()[2:] if g)
                inst, d = f"<{', '.join(map(str, params))}>", params[0]
            else:  # an FFN kernel<bool>: the TMA ring or the cp.async one
                inst, d = ("<TMA>" if m.group(3) == "1" else "<cp.async>"), 0
                params = (0,)
            stats = " ".join(x.split(":", 1)[-1].strip()
                             for x in lines[i + 1:i + 4]
                             if "registers" in x or "spill" in x)
            log(f"ptxas {kernel}{inst}: {stats}; dynamic shared memory "
                f"{KERNEL_SMEM[kernel](*params)} bytes a block")
            if (kernel.endswith("_f32_kernel") and d == 128
                    and not re.search(r"\b0 bytes spill stores", stats)):
                fail(f"ptxas: {kernel}{inst} spills ({stats})")


# Phase 13: the layer counts tried for the checkpointed run, largest first;
# the first whose two checkpoints fit CKPT_WRITE_BUDGET together and whose
# larger one (fused AdamW, 10 B a parameter) takes at most half the free
# disk runs. The budget bounds all of chip_smoke's checkpoint writes: a
# one-card chip machine allows a command 45 GiB of writes, deleted files
# included, and k = 8 wrote 46.9 GiB (22.36 + 27.96 GB).
CKPT_LAYERS = (8, 4, 2, 1)
CKPT_STEPS, CKPT_AT = 4, 2
CKPT_WRITE_BUDGET = 30 * 2 ** 30


class GradBytes:
    """An optimizer that records the bytes of the gradients the training
    step hands it: the live grads of a step."""

    def __init__(self, optimizer):
        self.optimizer, self.nbytes = optimizer, None

    def init(self, params):
        return self.optimizer.init(params)

    def apply(self, grads, state, params, grad_norm=None):
        from ray_tpu_torch.models.planning import _tree_bytes

        self.nbytes = _tree_bytes(grads)
        return self.optimizer.apply(grads, state, params, grad_norm)


def convert_round_trip(torch, params, cfg, requests, want) -> None:
    """Phase 11: HF conversion at llama3_8b full width and depth, on phase
    4's bf16 params: state_dict_from_params, then params_from_hf_state_dict,
    equal to the params bit for bit on every leaf, and an engine on the
    converted params giving phase 4's bf16 outputs for requests 0-3 token
    for token."""
    from ray_tpu_torch.models.convert import (params_from_hf_state_dict,
                                              state_dict_from_params)
    from ray_tpu_torch.models.transformer import tree_leaves

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sd = state_dict_from_params(params, cfg)
    torch.cuda.synchronize()
    t_export = time.perf_counter() - t0
    sd_bytes = sum(t.numel() * t.element_size() for t in sd.values())
    n_sd = len(sd)
    t0 = time.perf_counter()
    back = params_from_hf_state_dict(sd, cfg, device="cuda")
    torch.cuda.synchronize()
    t_import = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    del sd
    gc.collect()
    torch.cuda.empty_cache()
    log(f"convert: state_dict_from_params {t_export:.2f} s "
        f"({sd_bytes / 1e9:.2f} GB in {n_sd} tensors), "
        f"params_from_hf_state_dict {t_import:.2f} s; peak device "
        f"memory {peak / 2 ** 30:.2f} GiB, {(peak - held) / 2 ** 30:.2f} GiB "
        f"above the {held / 2 ** 30:.2f} GiB held before")
    differ = [n for n, (a, b) in enumerate(zip(tree_leaves(params),
                                               tree_leaves(back),
                                               strict=True))
              if a.dtype != b.dtype or a.shape != b.shape
              or not torch.equal(a, b)]
    n_leaves = len(list(tree_leaves(params)))
    log(f"convert: params_from_hf_state_dict(state_dict_from_params(p)) "
        f"equal to p on {n_leaves - len(differ)} of {n_leaves} leaves, bit "
        f"for bit")
    if differ:
        fail(f"the conversion round trip changed leaves {differ}")
    eng, rids = serve(torch, back, cfg, requests, False, "bf16 converted")
    got = [eng.result(r) for r in rids]
    same = [i for i in range(len(requests)) if got[i] == want[i]]
    log(f"convert: the engine on the converted params gives phase 4's bf16 "
        f"outputs token for token on requests {same} of "
        f"0-{len(requests) - 1} (gate: 0-3)")
    if not all(i in same for i in range(4)):
        fail("the engine on the converted params differs from phase 4's "
             "bf16 outputs on requests 0-3")
    del eng, back
    gc.collect()
    torch.cuda.empty_cache()


def servebench_run(torch, card: str) -> None:
    """Phase 12: the servebench runner's full profile (b1 in bf16, max_len
    2048): rc 0, every required row but latency, w8a16 parity < 0.08, and
    the quant kernel at 9 launches a w8a16 load (the parity row's and the
    w8a16 decode row's), the dequant kernel at 7·L + 2 a pass."""
    from ray_tpu_torch.models import servebench
    from ray_tpu_torch.ops.kernels import quant

    out = HERE / "build" / "servebench_b1.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    for k in quant.KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    rc = servebench.main(["--full", "--no-latency", "--json", str(out)])
    sys.stdout.flush()
    launches = {k.__name__: k.launches for k in quant.KERNELS}
    if rc != 0:
        fail(f"servebench --full --no-latency exited {rc}")
    art = json.loads(out.read_text())
    missing = [r for r in servebench.REQUIRED_ROWS
               if r != "latency_under_load" and r not in art]
    if missing:
        fail(f"servebench artifact lacks rows {missing}")
    m = art["model"]
    if (m["d_model"], m["n_layers"], m["dtype"], m["max_len"],
            art["backend"], art["n_chips"]) != (2048, 16, "bfloat16", 2048,
                                                "cuda", 1):
        fail(f"servebench ran {m}, backend {art['backend']}, "
             f"{art['n_chips']} chips; expected b1 in bf16 on one card")
    q = art["w8a16"]
    per_pass = 7 * m["n_layers"] + 2
    log(f"servebench b1 [{card}]: " + "; ".join(
        f"{r['num_slots']} slots {r['decode_tokens_per_s']:.1f} tok/s "
        f"({r['ms_per_step']:.3f} ms/step)" for r in art["slot_sweep"])
        + f"; w8a16 {q['decode_tokens_per_s']:.1f} tok/s at 8 slots "
        f"({q['speedup_vs_unquantized']:.3f}x bf16), parity "
        f"{q['logits_max_abs_diff_rel']:.5f} (limit 0.08), weight bytes "
        f"{q['weight_bytes_ratio']:.4f}x, throughput claim validated: "
        f"{q['weight_traffic_halves_claim']['throughput_claim_validated_on_this_backend']}"
        f"; prefill {art['prefill']['prefill_tokens_per_s']:.1f} tok/s "
        f"(4 x 64), {art['prefill']['ms_per_call']:.3f} ms/call; launches "
        f"{launches}; phase {time.perf_counter() - t0:.2f} s")
    if not q["logits_max_abs_diff_rel"] < 0.08:
        fail(f"servebench w8a16 parity {q['logits_max_abs_diff_rel']}")
    if launches["quantize_int8"] != 18 or not launches["dequantize_int8"] \
            or launches["dequantize_int8"] % per_pass:
        fail(f"servebench launched {launches}: expected quant 18 (two w8a16 "
             f"loads) and dequant a positive multiple of {per_pass}")


def checkpoint_resume(torch, card: str, seed: int) -> None:
    """Phase 13: train llama3_8b width at k layers (the most of CKPT_LAYERS
    whose two checkpoints fit CKPT_WRITE_BUDGET and each take at most half
    the free disk) 4 steps straight,
    then 2 steps, save_checkpoint(step=2), restore into an abstract_like
    state, 2 more steps: losses 1-4 and the final params bit-identical to
    the straight run, under default_optimizer and fused AdamW; then
    latest_checkpoint and gc_checkpoints on the real directory."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.models.planning import _tree_bytes
    from ray_tpu_torch.models.transformer import tree_leaves
    from ray_tpu_torch.ops.kernels import adamw as aw
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.ops.kernels import fused_ffn as ff
    from ray_tpu_torch.train import (abstract_like, default_optimizer,
                                     fused_adamw_optimizer, gc_checkpoints,
                                     latest_checkpoint, load_checkpoint,
                                     make_init_fn, make_train_step,
                                     save_checkpoint)

    t_phase = time.perf_counter()
    root = HERE / "build" / "checkpoints"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free = shutil.disk_usage(root).free
    optimizers = {"default": lambda: default_optimizer(warmup_steps=2),
                  "fused AdamW": lambda: fused_adamw_optimizer(
                      warmup_steps=2)}
    for k in CKPT_LAYERS:
        cfg = bench.train_config_8b(n_layers=k)
        nbytes = {name: _tree_bytes(make_init_fn(cfg, make(), "meta")(seed))
                  for name, make in optimizers.items()}
        if (sum(nbytes.values()) <= CKPT_WRITE_BUDGET
                and max(nbytes.values()) <= free / 2):
            break
    else:
        fail(f"no checkpoint of {CKPT_LAYERS} layers fits half of "
             f"{free / 1e9:.1f} GB free and the write budget")
    log(f"checkpoint: {free / 1e9:.1f} GB free under {root.relative_to(HERE)}"
        f"; llama3_8b width at {k} layers, states of "
        + ", ".join(f"{n} {b / 1e9:.2f} GB" for n, b in nbytes.items())
        + f" ({sum(nbytes.values()) / 2 ** 30:.2f} GiB together, budget "
          f"{CKPT_WRITE_BUDGET / 2 ** 30:.0f} GiB)")
    batch = bench.make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed + 1, "cuda")
    L = cfg.n_layers
    written = 0
    try:
        for name, make in optimizers.items():
            step_fn, init_fn = make_train_step(cfg, make(), device="cuda")

            def run(state, n):
                losses = []
                for _ in range(n):
                    state, metrics = step_fn(state, batch)
                    losses.append(float(metrics["loss"]))
                return state, losses

            state, straight = run(init_fn(seed), CKPT_STEPS)
            final = [t.cpu() for t in tree_leaves(state.params)]
            del state
            gc.collect()
            torch.cuda.empty_cache()

            state, first = run(init_fn(seed), CKPT_AT)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = save_checkpoint(state, str(root), step=CKPT_AT,
                                   meta={"losses": first})
            save_s = time.perf_counter() - t0
            on_disk = sum(f.stat().st_size for f in Path(path).rglob("*")
                          if f.is_file())
            written += on_disk
            target = abstract_like(state)
            del state
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            state, meta = load_checkpoint(latest_checkpoint(str(root)),
                                          target)
            torch.cuda.synchronize()
            load_s = time.perf_counter() - t0
            del target
            if (meta["step"], state.step, state.opt_state.count) != (
                    CKPT_AT,) * 3 or meta["losses"] != first:
                fail(f"checkpoint {name}: restored meta {meta}, step "
                     f"{state.step}, count {state.opt_state.count}")
            kernels = (*fa.KERNELS, ff.dw_gateup, aw.adamw_update)
            for kern in kernels:
                kern.launches = 0
            state, more = run(state, CKPT_STEPS - CKPT_AT)
            launches = {kern.__name__: kern.launches for kern in kernels}
            n_leaves = len(final)
            want = {kern.__name__: (CKPT_STEPS - CKPT_AT) * (
                L if kern is not aw.adamw_update else
                n_leaves if name == "fused AdamW" else 0)
                for kern in kernels}
            differ = [i for i, (a, b) in enumerate(zip(
                tree_leaves(state.params), final, strict=True))
                if not torch.equal(a.cpu(), b)]
            log(f"checkpoint {name} [{card}]: save {save_s:.2f} s "
                f"({nbytes[name] / save_s / 1e9:.2f} GB/s of state, "
                f"{on_disk / 1e9:.2f} GB on disk), restore {load_s:.2f} s "
                f"({nbytes[name] / load_s / 1e9:.2f} GB/s); losses straight "
                f"{straight}, resumed {first + more}; final params "
                f"bit-identical on {n_leaves - len(differ)} of {n_leaves} "
                f"leaves; launches after the restore {launches}")
            if first + more != straight or differ:
                fail(f"checkpoint {name}: the resumed run differs from the "
                     f"straight one (losses {first + more} vs {straight}, "
                     f"leaves {differ})")
            if launches != want:
                fail(f"checkpoint {name}: the resumed steps launched "
                     f"{launches}; expected {want}")
            del state, final, step_fn, init_fn
            gc.collect()
            torch.cuda.empty_cache()

            # the directory contract on the real directory: a torn staging
            # dir, a step dir without its meta, and an older complete save
            (root / ".tmp-step_3-1").mkdir()
            (root / "step_5" / "state").mkdir(parents=True)
            save_checkpoint({"w": torch.zeros(1)}, str(root), 1)
            latest = latest_checkpoint(str(root))
            deleted = sorted(Path(p).name for p in gc_checkpoints(
                str(root), keep=1))
            kept = sorted(p.name for p in root.iterdir())
            log(f"checkpoint {name}: latest {Path(latest).name}, gc keep=1 "
                f"deleted {deleted}, kept {kept}")
            if Path(latest).name != f"step_{CKPT_AT}" \
                    or deleted != [".tmp-step_3-1", "step_1"] \
                    or kept != [f"step_{CKPT_AT}", "step_5"]:
                fail(f"checkpoint {name}: latest_checkpoint or "
                     f"gc_checkpoints broke the step-directory contract")
            for child in root.iterdir():
                shutil.rmtree(child)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"checkpoint: {written / 2 ** 30:.2f} GiB written (budget "
        f"{CKPT_WRITE_BUDGET / 2 ** 30:.0f} GiB); phase "
        f"{time.perf_counter() - t_phase:.2f} s")
    if written > CKPT_WRITE_BUDGET:
        fail(f"phase 13 wrote {written} bytes, over its budget")


def sharded_world_one(torch, card: str, seed: int, cfg):
    """Phase 15: the sharded step on a one-rank NCCL mesh against the
    unsharded step, phase 8's config, seed and batch, 3 steps under each
    optimizer: losses, grad norms and final params bit-identical, the flash
    kernels and K3 at n_layers launches a step, AdamW once a leaf under
    fused AdamW. Returns {kernel: {path: launches over the 3 sharded
    steps}}."""
    import torch.distributed as dist

    from ray_tpu_torch import bench
    from ray_tpu_torch.models.transformer import tree_leaves
    from ray_tpu_torch.ops.kernels import adamw as aw
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.ops.kernels import fused_ffn as ff
    from ray_tpu_torch.parallel import (MeshConfig, initialize_group,
                                        make_mesh, shutdown_group)
    from ray_tpu_torch.train import (default_optimizer,
                                     fused_adamw_optimizer, make_train_step,
                                     to_local)

    t0 = time.perf_counter()
    L, steps = cfg.n_layers, 3
    kernels = (*fa.KERNELS, ff.dw_gateup, aw.adamw_update)
    batch = bench.make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed + 1, "cuda")
    by_path = {k.__name__: {} for k in kernels}
    initialize_group(0, 1, device="cuda")
    try:
        mesh = make_mesh(MeshConfig())
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        log(f"sharded: process group {dist.get_backend()} of "
            f"{dist.get_world_size()}, mesh {shape}")
        if dist.get_backend() != "nccl":
            fail(f"the mesh's collectives run on {dist.get_backend()}")
        for name, make in (("default", default_optimizer),
                           ("fused AdamW", fused_adamw_optimizer)):
            runs = {}
            for label, m in (("unsharded", None), ("sharded", mesh)):
                gc.collect()
                torch.cuda.empty_cache()
                step_fn, init_fn = make_train_step(
                    cfg, make(warmup_steps=2), device="cuda", mesh=m)
                state = init_fn(seed)
                metrics, launches = [], []
                for _ in range(steps):
                    for k in kernels:  # the main path's counts start here
                        k.launches = 0
                    state, met = step_fn(state, batch)
                    metrics.append((float(met["loss"]),
                                    float(met["grad_norm"])))
                    launches.append({k.__name__: k.launches
                                     for k in kernels})
                final = [t.cpu() for t in tree_leaves(to_local(
                    state.params))]
                runs[label] = (metrics, launches, final)
                del state, step_fn, init_fn, met
            (m0, l0, p0), (m1, l1, p1) = runs["unsharded"], runs["sharded"]
            same = sum(torch.equal(a, b) for a, b in zip(p0, p1, strict=True))
            n_adamw = len(p0) if name == "fused AdamW" else 0
            want = {k.__name__: n_adamw if k is aw.adamw_update else L
                    for k in kernels}
            log(f"sharded {name} [{card}]: losses and grad norms "
                f"{m1} (unsharded {m0}); final params bit-identical on "
                f"{same} of {len(p0)} leaves; launches a step {l1[0]} "
                f"(unsharded {l0[0]})")
            if m1 != m0 or same != len(p0):
                fail(f"sharded {name}: the world-1 sharded step differs "
                     f"from the unsharded one")
            if any(x != want for x in l1) or l1 != l0:
                fail(f"sharded {name}: launches {l1}; expected {want} a "
                     f"step, as unsharded {l0}")
            for k in kernels:
                by_path[k.__name__][f"sharded world 1 ({name})"] = sum(
                    x[k.__name__] for x in l1)
            del runs, p0, p1
    finally:
        shutdown_group()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"sharded: phase {time.perf_counter() - t0:.2f} s")
    return by_path


def ep_world_one(torch, card: str, seed: int) -> dict:
    """Phase 15c: the expert-parallel code (the global router's gather,
    the dispatch's reduce-scatter and all-reduce, the combine's
    all-gather, the expert leaves kept local) on a one-rank NCCL mesh:
    phase 10e's Mixtral-8x7B-width config (2 layers, remat "dots"), 3
    steps under each optimizer, losses, grad norms, moe_aux and the final
    params bit-identical to the unsharded MoE step, and the same launches
    a step (flash forward 2·L, backward L, AdamW once a leaf under fused
    AdamW). Returns {kernel: {path: launches over the 3 sharded steps}}."""
    import torch.distributed as dist

    from ray_tpu_torch import bench
    from ray_tpu_torch.models.transformer import tree_leaves
    from ray_tpu_torch.ops.kernels import adamw as aw
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.parallel import (MeshConfig, initialize_group,
                                        make_mesh, shutdown_group)
    from ray_tpu_torch.train import (default_optimizer,
                                     fused_adamw_optimizer, make_train_step,
                                     to_local)

    t0 = time.perf_counter()
    cfg = mixtral_config(MOE_TRAIN_LAYERS, MOE_TRAIN_CAPACITY, remat="dots")
    L, steps = cfg.n_layers, 3
    kernels = (*fa.KERNELS, aw.adamw_update)
    batch = bench.make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed + 1, "cuda")
    by_path = {k.__name__: {} for k in kernels}
    initialize_group(0, 1, device="cuda")
    try:
        mesh = make_mesh(MeshConfig())
        if dist.get_backend() != "nccl":
            fail(f"the mesh's collectives run on {dist.get_backend()}")
        for name, make in (("default", default_optimizer),
                           ("fused AdamW", fused_adamw_optimizer)):
            runs = {}
            for label, m in (("unsharded", None), ("sharded", mesh)):
                gc.collect()
                torch.cuda.empty_cache()
                step_fn, init_fn = make_train_step(
                    cfg, make(warmup_steps=2), device="cuda", mesh=m)
                state = init_fn(seed)
                metrics, launches = [], []
                for _ in range(steps):
                    for k in kernels:  # the main path's counts start here
                        k.launches = 0
                    state, met = step_fn(state, batch)
                    metrics.append((float(met["loss"]),
                                    float(met["grad_norm"]),
                                    float(met["moe_aux"])))
                    launches.append({k.__name__: k.launches
                                     for k in kernels})
                final = [t.cpu() for t in tree_leaves(to_local(
                    state.params))]
                runs[label] = (metrics, launches, final)
                del state, step_fn, init_fn, met
            (m0, l0, p0), (m1, l1, p1) = runs["unsharded"], runs["sharded"]
            same = sum(torch.equal(a, b) for a, b in zip(p0, p1, strict=True))
            want = {"flash_fwd": 2 * L, "flash_bwd_dkv": L, "flash_bwd_dq": L,
                    "adamw_update": len(p0) if name == "fused AdamW" else 0}
            log(f"expert-parallel world 1, {name} [{card}]: losses, grad "
                f"norms and moe_aux {m1} (unsharded {m0}); final params "
                f"bit-identical on {same} of {len(p0)} leaves; launches a "
                f"step {l1[0]} (unsharded {l0[0]})")
            if m1 != m0 or same != len(p0):
                fail(f"expert-parallel {name}: the world-1 step differs "
                     f"from the unsharded MoE step")
            if any(x != want for x in l1) or l1 != l0:
                fail(f"expert-parallel {name}: launches {l1}; expected "
                     f"{want} a step, as unsharded {l0}")
            for k in kernels:
                by_path[k.__name__][f"expert-parallel world 1 ({name})"] = \
                    sum(x[k.__name__] for x in l1)
            del runs, p0, p1
    finally:
        shutdown_group()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"expert-parallel world 1: phase {time.perf_counter() - t0:.2f} s")
    return by_path


def tp_sp_world_one(torch, card: str, seed: int, cfg):
    """Phase 15b: the tp and sp code at tp = sp = 1 on a one-rank NCCL
    mesh (the docstring's item 15b). Returns {kernel: {path: launches}}."""
    import torch.distributed as dist

    from ray_tpu_torch import bench
    from ray_tpu_torch.models.transformer import tree_leaves
    from ray_tpu_torch.ops.kernels import flash_attention as fa
    from ray_tpu_torch.ops.kernels import fused_ffn as ff
    from ray_tpu_torch.ops.kernels.fused_attn import attn_block
    from ray_tpu_torch.ops.kernels.fused_ffn import ffn_block
    from ray_tpu_torch.ops.layers import rotary_embedding
    from ray_tpu_torch.parallel import (MeshConfig, initialize_group,
                                        make_mesh, shutdown_group)
    from ray_tpu_torch.train import (default_optimizer, make_train_step,
                                     to_local)

    t0 = time.perf_counter()
    L, steps = cfg.n_layers, 3
    plain = dataclasses.replace(cfg, fused_ffn=False, fused_attn=False)
    kernels = (*fa.KERNELS, ff.dw_gateup)
    batch = bench.make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed + 1, "cuda")
    by_path = {k.__name__: {} for k in kernels}
    initialize_group(0, 1, device="cuda")
    try:
        mesh = make_mesh(MeshConfig())
        if dist.get_backend() != "nccl":
            fail(f"the mesh's collectives run on {dist.get_backend()}")
        runs = {}
        for scheme in ("", "ulysses", "ring"):
            gc.collect()
            torch.cuda.empty_cache()
            step_fn, init_fn = make_train_step(
                dataclasses.replace(plain, seq_parallel=scheme),
                default_optimizer(warmup_steps=2), device="cuda", mesh=mesh)
            state = init_fn(seed)
            metrics, launches = [], []
            for _ in range(steps):
                for k in kernels:  # the main path's counts start here
                    k.launches = 0
                state, met = step_fn(state, batch)
                metrics.append((float(met["loss"]), float(met["grad_norm"])))
                launches.append({k.__name__: k.launches for k in kernels})
            final = [t.cpu() for t in tree_leaves(to_local(state.params))]
            runs[scheme or "none"] = (metrics, launches, final)
            log(f"tp/sp world 1, seq_parallel={scheme or 'none'} [{card}]: "
                f"losses and grad norms {metrics}; launches a step "
                f"{launches[0]}")
            for k in kernels:
                by_path[k.__name__][f"seq_parallel {scheme or 'none'} "
                                    f"world 1"] = sum(x[k.__name__]
                                                      for x in launches)
            del state, step_fn, init_fn, met
        (m0, l0, p0), (mu, lu, pu), (mr, lr, _) = (
            runs["none"], runs["ulysses"], runs["ring"])
        same = sum(torch.equal(a, b) for a, b in zip(p0, pu, strict=True))
        log(f"tp/sp world 1: ulysses bit-identical on {same} of {len(p0)} "
            f"leaves")
        if mu != m0 or same != len(p0):
            fail("ulysses at sp 1 differs from the step without sp")
        want = {"flash_fwd": 2 * L, "flash_bwd_dkv": L, "flash_bwd_dq": L,
                "dw_gateup": 0}
        if any(x != want for x in lu) or lu != l0:
            fail(f"ulysses launches {lu}; expected {want} a step, as "
                 f"without sp {l0}")
        if any(x != {k: 0 for k in want} for x in lr):
            fail(f"ring launches {lr}: the ring's einsum launches no "
                 f"kernel")
        first, norm, later = 1e-3, 2e-2, 5e-3  # multichip.RING_BOUNDS
        errs = [abs(a[0] - b[0]) / abs(b[0]) for a, b in zip(mr, m0)]
        norm_err = abs(mr[0][1] - m0[0][1]) / abs(m0[0][1])
        log(f"tp/sp world 1: ring against no sp, loss rel errs {errs}, "
            f"step-1 grad norm rel err {norm_err} (limits {first}, {norm}, "
            f"{later})")
        if errs[0] > first or norm_err > norm or max(errs[1:]) > later:
            fail("ring at sp 1 outside its bounds of the step without sp")
        del runs, p0, pu

        # the fused blocks with a one-rank tp group against none
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed + 7)
        d, hd = cfg.d_model, cfg.head_dim
        nq, nkv = cfg.n_heads, cfg.n_kv_heads

        def rnd(*shape, scale=1.0):
            return (torch.randn(shape, generator=gen, device="cuda")
                    * scale).to(torch.bfloat16)

        x = rnd(TRAIN_BATCH, TRAIN_SEQ, d)
        dy = rnd(TRAIN_BATCH, TRAIN_SEQ, d, scale=1e-2)
        cos, sin = rotary_embedding(torch.arange(TRAIN_SEQ, device="cuda"),
                                    hd, cfg.rope_theta)
        attn_w = [rnd(d, scale=0.0) + 1, rnd(d, nq * hd, scale=d ** -0.5),
                  rnd(d, nkv * hd, scale=d ** -0.5),
                  rnd(d, nkv * hd, scale=d ** -0.5),
                  rnd(nq * hd, d, scale=(nq * hd) ** -0.5)]
        ffn_w = [rnd(d, scale=0.0) + 1,
                 rnd(d, cfg.d_ff, scale=d ** -0.5),
                 rnd(d, cfg.d_ff, scale=d ** -0.5),
                 rnd(cfg.d_ff, d, scale=cfg.d_ff ** -0.5)]
        group = dist.group.WORLD
        for name, fn, ws, kw, want_k in (
                ("attn", attn_block, attn_w,
                 dict(cos=cos[None], sin=sin[None], n_heads=nq,
                      n_kv_heads=nkv), ("flash_fwd", "flash_bwd_dkv",
                                        "flash_bwd_dq")),
                ("ffn", ffn_block, ffn_w, {}, ("dw_gateup",))):
            outs = []
            for tp_group in (None, group):
                for k in kernels:
                    k.launches = 0
                leaves = [t.clone().requires_grad_(True) for t in (x, *ws)]
                if name == "attn":
                    y = fn(*leaves, kw["cos"], kw["sin"], kw["n_heads"],
                           kw["n_kv_heads"], cfg.norm_eps, tp_group=tp_group)
                else:
                    y = fn(*leaves, cfg.norm_eps, tp_group=tp_group)
                grads = torch.autograd.grad(y, leaves, dy)
                torch.cuda.synchronize()
                outs.append((y, grads, {k.__name__: k.launches
                                        for k in kernels}))
            (y0, g0, n0), (y1, g1, n1) = outs
            same = torch.equal(y0, y1) and all(
                torch.equal(a, b) for a, b in zip(g0, g1, strict=True))
            log(f"tp/sp world 1: {name} block with a one-rank tp group "
                f"bit-identical to none: {same}; launches {n1} (none: {n0})")
            if not same:
                fail(f"the {name} block with a one-rank tp group differs")
            if n1 != n0 or any(n1[k] != 1 for k in want_k):
                fail(f"{name} block launches {n1}; expected one each of "
                     f"{want_k}")
            for k in want_k:
                by_path[k][f"{name} block, one-rank tp group"] = n1[k]
            del outs, y0, y1, g0, g1, leaves, y, grads
    finally:
        shutdown_group()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"tp/sp world 1: phase {time.perf_counter() - t0:.2f} s")
    return by_path


def plan_phase(torch, card: str, seed: int, cfg, default_run) -> None:
    """Phase 14: print eightb_plan(); `_budget` at the 8-layer config on one
    card against the live state of phase 8 (params, grads, optimizer, byte
    for byte), its total beside phase 9's peak; then the phase efficiencies
    of the real 8-layer all-kernel step (`measure_phase_eff`) under each
    optimizer beside the ones the planning module holds, and the 32-layer
    4-card projection under each."""
    from ray_tpu_torch import bench
    from ray_tpu_torch.models import planning
    from ray_tpu_torch.ops.kernels import fused_ffn as ff
    from ray_tpu_torch.train import default_optimizer, fused_adamw_optimizer

    t0 = time.perf_counter()
    log(f"plan: eightb_plan() = {json.dumps(planning.eightb_plan())}")
    b = planning._budget(cfg, default_optimizer(), 1, 1, 1,
                         TRAIN_BATCH * TRAIN_SEQ, TRAIN_SEQ)
    budget = {"params": b["param_bytes"], "grads": b["grad_bytes"],
              "optimizer": b["optimizer_bytes"]}
    live = default_run["state_bytes"]
    log(f"plan: _budget at {cfg.n_layers} layers on one card {budget} "
        f"bytes; phase 8's live state {live}")
    if budget != live:
        fail(f"_budget's state bytes {budget} != the live state's {live}")
    total = b["per_chip_bytes"]["total"] / 2 ** 30
    log(f"plan: _budget's total {total:.2f} GiB (state, activations under "
        f"its dots-remat model, logits) against phase 9's measured peak "
        f"{default_run['peak_gib']:.2f} GiB: gap "
        f"{total - default_run['peak_gib']:+.2f} GiB [{card}]")
    old = ff.USE_K1, ff.USE_K2, ff.USE_K3
    ff.USE_K1 = ff.USE_K2 = ff.USE_K3 = True
    meas = {}
    try:
        batch = bench.make_batch(cfg, TRAIN_BATCH, TRAIN_SEQ, seed + 1,
                                 "cuda")
        for kind, make in (("default", default_optimizer),
                           ("fused", fused_adamw_optimizer)):
            meas[kind] = planning.measure_phase_eff(
                cfg, make(warmup_steps=2), batch, seed=seed)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        ff.USE_K1, ff.USE_K2, ff.USE_K3 = old
    del batch
    gc.collect()
    torch.cuda.empty_cache()
    for kind, m in meas.items():
        if m["optimizer"] != kind:
            fail(f"measure_phase_eff took {m['optimizer']} for {kind}")
        log(f"plan: phase efficiencies of the {cfg.n_layers}-layer "
            f"all-kernel step under the {kind} optimizer over {m['steps']} "
            f"steps [{card}]: " + ", ".join(
                f"{p} {m['ms'][p]:.3f} ms (ideal {m['ideal_ms'][p]:.3f}, "
                f"eff {m['eff'][p]:.4f}; planning.PHASE_EFF "
                f"{planning.PHASE_EFF[kind][p]})" for p in m['ms'])
            + f"; step {sum(m['ms'].values()):.3f} ms")
    cfg8 = dataclasses.replace(cfg, n_layers=32, max_seq_len=4096)
    for kind, make in (("default", default_optimizer),
                       ("fused", fused_adamw_optimizer)):
        p = planning._budget(cfg8, make(), 4, 4, 1, 4096, 4096)
        log(f"plan: 32 layers on 4 cards under the {kind} optimizer: "
            f"step {p['step_s']:.4f} s, projected MFU {p['mfu']:.4f}, "
            f"{p['per_chip_bytes']['total'] / 2 ** 30:.2f} GiB a card")
    log(f"plan: phase {time.perf_counter() - t0:.2f} s")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    sys.path.insert(0, str(HERE))
    try:
        import ray_tpu_torch
    except ImportError as e:
        fail(f"the ray_tpu_torch package is not beside this script ({e})")
    if Path(ray_tpu_torch.__file__).resolve().parent.parent != HERE:
        fail(f"ray_tpu_torch imported from {ray_tpu_torch.__file__}, not from "
             f"this checkout")
    from ray_tpu_torch import bench
    from ray_tpu_torch.models import ModelConfig, count_params, init_params
    from ray_tpu_torch.models.servebench import (measure_prefill,
                                                 measure_quant_parity)
    from ray_tpu_torch.ops.kernels import _util
    from ray_tpu_torch.ops.kernels import quant

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 1: the card
    card = smi_line()
    name = torch.cuda.get_device_name(0)
    check_card(name)
    log(f"card: {card} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    log(f"peak rates used for bounds: {PEAK_BYTES_PER_S / 1e12} TB/s, "
        f"bf16 tensor cores {PEAK_BF16_OPS_PER_S / 1e12} TFLOP/s dense "
        f"(H100 SXM data sheet)")

    # ---- phase 2: build, and beside it ptxas's report on the wgmma
    # kernels (flash forward, dq and dk/dv; K1, K3, K2)
    t0 = time.perf_counter()
    _util.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    ptxas = {}
    for src in ("flash_attention", "flash_wide", "fused_ffn"):
        obj = _util.BUILD_DIR / f"ptxas-{src}.o"
        ptxas[src] = (subprocess.Popen(
            [_util._nvcc(), *[f for f in _util.NVCC_FLAGS if f != "-shared"],
             "-Xptxas", "-v", "-c", "-o", str(obj),
             str(_util.CSRC_DIR / f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), obj)
    libs = _util.build(["quant", "flash_attention", "flash_wide",
                        "fused_ffn", "adamw", "rmsnorm", "xent"])
    for lib in libs.values():
        log(f"built {lib.relative_to(HERE)}")
    ptxas_report(ptxas)
    log(f"kernel build: {time.perf_counter() - t0:.2f} s")

    # ---- phase 3: kernels against their plain versions, before the
    # weights take the card's memory
    cfg = ModelConfig.llama3_8b()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    kernel_rows = check_kernels(torch, quant, gen,
                                kernel_shapes(cfg, NUM_SLOTS))

    # ---- phase 4: serve llama3_8b at full width and depth
    t0 = time.perf_counter()
    params = init_params(cfg, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    log(f"llama3_8b: {count_params(params) / 1e9:.3f}B params, "
        f"{cfg.n_layers} layers, random bf16 weights (seed {args.seed}) in "
        f"{time.perf_counter() - t0:.2f} s")
    requests = make_requests(cfg, args.seed)

    quant.dequantize_int8.launches = 0
    eng, rids = serve(torch, params, cfg, requests, False, "bf16")
    if quant.dequantize_int8.launches:
        fail("the bf16 engine launched the dequant kernel")
    bf16_out = [eng.result(r) for r in rids]
    agree = teacher_forced_agreement(torch, params, cfg, eng.result(rids[0]),
                                     len(requests[0][0]))
    log(f"serve bf16: teacher-forced agreement of request 0 = {agree:.3f}")
    if agree < 0.9:
        fail(f"bf16 decode disagrees with teacher-forced prefill ({agree})")
    del eng
    torch.cuda.empty_cache()

    for k in quant.KERNELS:  # the main path's counts start here
        k.launches = 0
    qeng, qrids = serve(torch, params, cfg, requests, True, "w8a16")
    launches = {k.__name__: k.launches for k in quant.KERNELS}
    per_pass = 7 * cfg.n_layers + 2  # projections, LM head, embed gather
    want = {"quantize_int8": 9,
            "dequantize_int8": per_pass * (qeng.prefill_calls
                                           + qeng.decode_steps)}
    log(f"launches on the w8a16 serving path: {launches} (expected {want})")
    if launches != want:
        fail(f"kernel launch counts {launches} != expected {want}")
    qparams = qeng.params
    agree = teacher_forced_agreement(torch, qparams, cfg,
                                     qeng.result(qrids[0]),
                                     len(requests[0][0]))
    log(f"serve w8a16: teacher-forced agreement of request 0 = {agree:.3f}")
    if agree < 0.9:
        fail(f"w8a16 decode disagrees with teacher-forced prefill ({agree})")
    del qeng
    torch.cuda.empty_cache()

    # ---- phase 5: w8a16 parity
    parity = measure_quant_parity(params, cfg, max_len=MAX_LEN,
                                  qparams=qparams, device="cuda")
    log(f"w8a16 parity: logits rel err {parity['logits_max_abs_diff_rel']} "
        f"(limit 0.08), weight bytes ratio {parity['weight_bytes_ratio']}")
    if not parity["logits_parity_ok"]:
        fail(f"w8a16 logits rel err {parity['logits_max_abs_diff_rel']}")

    # ---- phase 6: throughput
    decode_rows(torch, params, cfg, card)
    for label, p in (("bf16", params), ("w8a16", qparams)):
        pre = measure_prefill(p, cfg, max_len=MAX_LEN, device="cuda")
        log(f"prefill {label}: {pre['prefill_tokens_per_s']} tok/s "
            f"(batch 4 x 64), {pre['ms_per_call']} ms/call [{card}]")
    del p  # the loop variable would keep the w8a16 weights alive
    log(f"peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    # ---- phase 11: HF conversion of phase 4's params, round trip and
    # serving
    del qparams
    convert_round_trip(torch, params, cfg, requests, bf16_out)
    # ---- phase 12: the servebench runner at b1
    del params
    gc.collect()
    torch.cuda.empty_cache()
    servebench_run(torch, card)

    # ---- phase 7: training kernels against their plain versions, with
    # the serving weights freed and before the training state exists
    gc.collect()
    torch.cuda.empty_cache()
    log(f"device memory allocated after the serving phases: "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    train_cfg = bench.train_config_8b(n_layers=8)
    train_rows = check_train_kernels(torch, gen, train_cfg)
    redesign_summary(train_rows, ("flash_fwd", "flash_bwd_dkv",
                                  "flash_bwd_dq"), card)
    k1_summary(torch, gen, train_rows, card)
    k3_k2_summary(torch, gen, train_rows, card)
    check_no_key_rows(torch, gen, packed=False)
    # ---- phase 7b: the RMSNorm and cross-entropy kernels
    entry_rows = check_norm_xent_kernels(torch, gen)
    # ---- phase 7c: the packed flash kernels
    packed_rows = check_packed_kernels(torch, gen)
    redesign_summary(packed_rows, ("flash_fwd_packed", "flash_bwd_dkv_packed",
                                   "flash_bwd_dq_packed"), card)
    check_no_key_rows(torch, gen, packed=True)
    # ---- phase 7d: the float32 kernels, then the float32 tiny variant
    # trained through them
    f32_cfg = f32_tiny_config()
    f32_rows = check_f32_kernels(torch, gen, f32_cfg, card)
    f32_launches = train_f32_tiny(torch, args.seed, f32_cfg)
    # ---- phase 7e: head dims 256, 96 and 192 on the flash route, then
    # 320 and 512 through the wide family
    check_head_dims(torch, gen, train_rows, packed_rows, f32_rows)
    wide_rows, wide_launches = check_wide_head_dims(torch, gen, card)

    # ---- phases 8-10: train llama3_8b width, 8 layers, on the default
    # step and then the all-kernel step; measure both
    by_path, default_run = train_both(torch, card, args.seed, train_cfg)
    first_loss = default_run["losses"][0]
    # each kernel's launches on the path it was ported for: the default
    # step for the flash kernels and K3, the all-kernel step for the rest
    train_launches = {k: (n["default"] if n["default"] else n["all-kernel"])
                      for k, n in by_path.items() if k not in packed_rows}
    # ---- phase 10b: the RMSNorm and cross-entropy entries on the model
    entry_launches = check_entries_on_model(torch, gen, args.seed, train_cfg,
                                            first_loss)
    # ---- phase 10c: the packed flash-attention entry on the model
    entry_launches.update(check_packed_entry_on_model(torch, gen, args.seed,
                                                      train_cfg))
    # ---- phase 10d: serve Mixtral-8x7B width, 8 layers, bf16 and w8a16
    serve_moe(torch, card, args.seed)
    # ---- phase 10e: train Mixtral-8x7B width, 2 layers, remat "dots"
    train_moe(torch, card, args.seed)
    # ---- phase 10f: every remat mode on the MoE config and on the dense
    # 8B width with fused_ffn and a rematerialized attention half
    remat_modes(torch, card, args.seed,
                mixtral_config(MOE_TRAIN_LAYERS, MOE_TRAIN_CAPACITY), "moe")
    remat_modes(torch, card, args.seed,
                dataclasses.replace(train_cfg, fused_attn=False), "dense")
    # ---- phase 13: checkpoint and resume at 8B width
    checkpoint_resume(torch, card, args.seed)
    # ---- phase 14: the 8B plan against phase 8's live state
    plan_phase(torch, card, args.seed, train_cfg, default_run)
    # ---- phase 15: the sharded step on a one-rank NCCL mesh
    sharded_launches = sharded_world_one(torch, card, args.seed, train_cfg)
    # ---- phase 15b: the tp and sp code at tp = sp = 1, one-rank NCCL
    for kname, paths in tp_sp_world_one(torch, card, args.seed,
                                        train_cfg).items():
        sharded_launches.setdefault(kname, {}).update(paths)
    # ---- phase 15c: the expert-parallel code on a one-rank NCCL mesh
    for kname, paths in ep_world_one(torch, card, args.seed).items():
        sharded_launches.setdefault(kname, {}).update(paths)

    # ---- phase 16: report
    pallas = "ray_tpu/ops/pallas/"
    replaces = {"quantize_int8": pallas + "quant.py:19",
                "dequantize_int8": pallas + "quant.py:27",
                "flash_fwd": pallas + "flash_attention.py:38",
                "flash_bwd_dkv": pallas + "flash_attention.py:181",
                "flash_bwd_dq": pallas + "flash_attention.py:224",
                "dw_gateup": pallas + "fused_ffn.py:121",
                "dw_down": pallas + "fused_ffn.py:76",
                "dgateup": pallas + "fused_ffn.py:97",
                "adamw_update": pallas + "adamw.py:37",
                "rms_norm_fwd": pallas + "rmsnorm.py:25",
                "rms_norm_bwd_dx": pallas + "rmsnorm.py:33",
                "xent_fwd": pallas + "xent.py:28",
                "xent_bwd": pallas + "xent.py:59",
                "flash_fwd_packed": pallas + "flash_attention.py:385",
                "flash_bwd_dkv_packed": pallas + "flash_attention.py:442",
                "flash_bwd_dq_packed": pallas + "flash_attention.py:480"}
    # the float32 kernels replace the same TPU kernels, run in float32, and
    # the wide family the same three at head widths above 256
    replaces.update({k: replaces[k[:-4]] for k in f32_rows})
    replaces.update({k: replaces[k.split("_wide")[0]] for k in wide_rows})
    csrc = "ray_tpu_torch/ops/kernels/csrc/"
    source = {"quantize_int8": csrc + "quant.cu",
              "dequantize_int8": csrc + "quant.cu",
              "flash_fwd": csrc + "flash_attention.cu",
              "flash_bwd_dkv": csrc + "flash_attention.cu",
              "flash_bwd_dq": csrc + "flash_attention.cu",
              "dw_gateup": csrc + "fused_ffn.cu",
              "dw_down": csrc + "fused_ffn.cu",
              "dgateup": csrc + "fused_ffn.cu",
              "adamw_update": csrc + "adamw.cu",
              "rms_norm_fwd": csrc + "rmsnorm.cu",
              "rms_norm_bwd_dx": csrc + "rmsnorm.cu",
              "xent_fwd": csrc + "xent.cu",
              "xent_bwd": csrc + "xent.cu",
              "flash_fwd_packed": csrc + "flash_attention.cu",
              "flash_bwd_dkv_packed": csrc + "flash_attention.cu",
              "flash_bwd_dq_packed": csrc + "flash_attention.cu"}
    source.update({k: source[k[:-4]] for k in f32_rows})
    source.update({k: csrc + "flash_wide.cu" for k in wide_rows})
    norm_per = "one norm-and-gradient at the 8B training shape"
    xent_per = "one loss-and-gradient of the 8B logits"
    packed_per = "one forward-and-gradient at the 8B attention shape"
    per = {"quantize_int8": "one model load",
           "dequantize_int8": "one decode step",
           "rms_norm_fwd": norm_per, "rms_norm_bwd_dx": norm_per,
           "xent_fwd": xent_per, "xent_bwd": xent_per,
           **{k: packed_per for k in packed_rows},
           **{k: "one training step of the float32 tiny variant at "
                 "head_dim 128" for k in f32_rows},
           **{k: "one call at each timed shape of phase 7e (head_dim 320 "
                 "and 512, causal, both layouts); launches: ops.attention, "
                 "ops.attention_packed and attn_block at those widths"
              for k in wide_rows}}
    launches.update(train_launches)
    launches.update(entry_launches)
    launches.update(f32_launches)
    launches.update(wide_launches)
    kernels = []
    for kname, rows in {**kernel_rows, **train_rows, **entry_rows,
                        **packed_rows, **f32_rows, **wide_rows}.items():
        # times: the main path's calls for `per`, each shape timed once and
        # counted as often as the path calls it
        lib = [r for r in rows if r["calls"] and r.get("library_ms")]
        if not launches[kname] > 0:
            fail(f"{kname} was never launched on its path")
        kernels.append({
            "name": kname, "route": "cuda",
            "source": source[kname],
            "replaces": replaces[kname],
            "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["calls"] * r["ms"] for r in rows),
            "plain_ms": sum(r["calls"] * r["plain_ms"] for r in rows),
            "bound_ms": sum(r["calls"] * r["bound_ms"] for r in rows),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in rows) else "operations",
            "library_ms": (sum(r["calls"] * r["library_ms"] for r in lib)
                           if lib else None),
            "per": per.get(kname, "one training step"),
            "shapes": rows,
        })
        if kname in train_launches:
            kernels[-1]["launches_per_step"] = (train_launches[kname]
                                                / TRAIN_STEPS)
            kernels[-1]["launches_by_path"] = {
                **by_path[kname], **sharded_launches.get(kname, {})}
        if kname in f32_launches:
            kernels[-1]["launches_per_step"] = (f32_launches[kname]
                                                / F32_TINY_STEPS)
        if kname in train_launches or kname in entry_launches \
                or kname in f32_launches or kname in wide_launches:
            kernels[-1]["library"] = lib[0]["library"] if lib else None
    log(f"total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
