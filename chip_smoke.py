#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (ray_tpu_torch) on one GPU.

    python3 chip_smoke.py            # full run: Llama-3-8B shapes, 32 layers

Phases (any failure exits non-zero and prints no result line):
  1. require CUDA; print the card's name and power limit (nvidia-smi);
  2. build every kernel of the serving path from the sources in the
     checkout (one nvcc per source, started together);
  3. hold each kernel against its plain PyTorch version on the card, bit
     for bit, at every shape the serving path gives it (the quant kernel's
     stacked [L, in, out] leaves included) and at the six 8B weight shapes,
     and time kernel, plain version and the bound with CUDA events (L2
     flushed between calls);
  4. serve 12 requests through ContinuousBatchingEngine at llama3_8b full
     width and depth with random bf16 weights from a seeded generator, once
     in bf16 and once in w8a16, checking token counts, vocabulary range,
     agreement with a teacher-forced prefill, and the kernels' launch counts
     on the w8a16 run (counters zeroed just before it, read just after);
  5. the w8a16 logits parity check (relative error < 0.08);
  6. decode tokens/s at 8 slots and prefill tokens/s (4 x 64) for both,
     and a torch.profiler window of each decode loop (device time per
     step, its top kernels, and the device-idle share of that window);
  7. print the kernels line, the nvidia-smi line, and the result line.

Imports torch and the port only (never jax, never ray_tpu).
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent

# H100 SXM data sheet: HBM3 rate, and float32 outside the tensor cores
# (the kernels' arithmetic); bound_ms is the larger of bytes and operations.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
NUM_SLOTS, MAX_LEN = 8, 1024


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


def time_ms(torch, fn, flush, reps: int = 7) -> float:
    """Median of `reps` single-call CUDA-event timings after one warm-up,
    with the 50 MB L2 flushed before each call (weights arrive cold)."""
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
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


def bound_ms(nbytes: int, ops: int):
    bytes_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    ops_ms = 1e3 * ops / PEAK_F32_OPS_PER_S
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
    from ray_tpu_torch.models import ModelConfig, count_params, init_params
    from ray_tpu_torch.models.servebench import (measure_decode,
                                                 measure_prefill,
                                                 measure_quant_parity,
                                                 profile_decode)
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
        f"float32 {PEAK_F32_OPS_PER_S / 1e12} TFLOP/s (H100 SXM data sheet)")

    # ---- phase 2: build
    t0 = time.perf_counter()
    libs = _util.build(["quant"])
    for lib in libs.values():
        log(f"built {lib.relative_to(HERE)}")
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
    for label, quantize in (("bf16", False), ("w8a16", True)):
        dec = measure_decode(params, cfg, num_slots=NUM_SLOTS,
                             max_len=MAX_LEN, quantize_weights=quantize,
                             device="cuda")
        torch.cuda.empty_cache()
        log(f"decode {label}: {dec['decode_tokens_per_s']} tok/s at "
            f"{NUM_SLOTS} slots, {dec['ms_per_step']} ms/step [{card}]")
        prof = profile_decode(params, cfg, num_slots=NUM_SLOTS,
                              max_len=MAX_LEN, quantize_weights=quantize,
                              device="cuda")
        torch.cuda.empty_cache()
        if prof["device_ms_per_step"] > 0:
            log(f"decode {label} profile: device {prof['device_ms_per_step']}"
                f" ms/step ({prof['launches_per_step']} kernels/step) in a "
                f"window of {prof['ms_per_step']} ms/step, device-idle share "
                f"{prof['device_idle_share']} of that window [{card}]")
            for row in prof["top"]:
                log(f"  {row['ms_per_step']:.4f} ms/step "
                    f"({row['share']:.3f}) {row['name']}")
        else:
            log(f"decode {label} profile: the profiler recorded no device "
                f"time (device-idle share not measured)")
    for label, p in (("bf16", params), ("w8a16", qparams)):
        pre = measure_prefill(p, cfg, max_len=MAX_LEN, device="cuda")
        log(f"prefill {label}: {pre['prefill_tokens_per_s']} tok/s "
            f"(batch 4 x 64), {pre['ms_per_call']} ms/call [{card}]")
    log(f"peak device memory: "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")

    # ---- phase 7: report
    replaces = {"quantize_int8": "ray_tpu/ops/pallas/quant.py:19",
                "dequantize_int8": "ray_tpu/ops/pallas/quant.py:27"}
    per = {"quantize_int8": "one model load",
           "dequantize_int8": "one decode step"}
    kernels = []
    for kname, rows in kernel_rows.items():
        # times: the main path's calls for `per`, each shape timed once and
        # counted as often as the path calls it
        kernels.append({
            "name": kname, "route": "cuda",
            "source": "ray_tpu_torch/ops/kernels/csrc/quant.cu",
            "replaces": replaces[kname],
            "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": sum(r["calls"] * r["ms"] for r in rows),
            "plain_ms": sum(r["calls"] * r["plain_ms"] for r in rows),
            "bound_ms": sum(r["calls"] * r["bound_ms"] for r in rows),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes"
                                       for r in rows) else "operations",
            "library_ms": None,
            "per": per[kname],
            "shapes": rows,
        })
    log(f"total wall time {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
