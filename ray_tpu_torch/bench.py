"""Training throughput of the flagship transformer (twin of the training
half of bench.py:19-75).

    python -m ray_tpu_torch.bench          # one GPU: Llama-3-8B width, 8 layers
    python -m ray_tpu_torch.bench --cpu    # smoke path: `tiny` on the CPU

Prints ONE JSON line with the reference's keys: tokens/s, MFU, step time,
loss and n_params. FLOPs per token are counted as the reference counts them
(`bench.py:72-74`): 6·n_params plus 6·L·d·seq for causal attention. MFU is
measured against the H100 SXM's dense bf16 rate (989 TFLOP/s) on the card;
the CPU smoke path divides by a nominal 1 TFLOP/s, as the reference's CI
path does, and its numbers are no device measurement.

`profile_train` runs a few steps under torch.profiler: device time per step,
the device-idle share of the window and the kernels that take the time.
The transfer half of the reference's bench needs the runtime and waits for
its port (ROADMAP.md queue A item 8).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Any, Dict, Optional, Tuple

import torch

from ray_tpu_torch.models.transformer import ModelConfig, count_params
from ray_tpu_torch.ops.kernels._util import require_cuda
from ray_tpu_torch.train.step import default_optimizer, make_train_step

PEAK_BF16_FLOPS_H100 = 989e12   # H100 SXM data sheet, dense
NOMINAL_CPU_FLOPS = 1e12        # the reference's CI smoke-path divisor


def train_config_8b(n_layers: int = 8) -> ModelConfig:
    """Llama-3-8B at full width with its depth cut to fit one 80 GB card,
    run as the reference's bench runs its step (fused FFN and attention
    blocks; remat is then unused)."""
    return dataclasses.replace(ModelConfig.llama3_8b(), n_layers=n_layers,
                               fused_ffn=True, fused_attn=True, remat="dots")


def flops_per_token(cfg: ModelConfig, n_params: int, seq: int) -> int:
    attn_flops = 6 * cfg.n_layers * cfg.d_model * seq  # 12·L·d·s · 0.5 causal
    return 6 * n_params + attn_flops


def throughput(cfg: ModelConfig, n_params: int, batch_size: int, seq: int,
               step_s: float, peak_flops: float) -> Dict[str, float]:
    tokens_per_sec = batch_size * seq / step_s
    return {"tokens_per_sec": tokens_per_sec,
            "mfu": tokens_per_sec * flops_per_token(cfg, n_params, seq)
            / peak_flops}


def make_batch(cfg: ModelConfig, batch_size: int, seq: int, seed: int,
               device) -> Dict[str, torch.Tensor]:
    """{"inputs", "targets"} from one [b, seq + 1] draw of random tokens."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch_size, seq + 1),
                           generator=gen, device=dev)
    return {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_config(cfg: ModelConfig, batch_size: int, seq: int,
                 peak_flops: float, iters: int, device="cuda",
                 seed: int = 0) -> Dict[str, Any]:
    """One config's train step: the first step (kernel build and load
    included), one warm step, then `iters` timed steps ending in a sync."""
    dev = require_cuda(device)
    step_fn, init_fn = make_train_step(cfg, default_optimizer(), dev)
    state = init_fn(seed)
    n_params = count_params(state.params)
    batch = make_batch(cfg, batch_size, seq, seed + 1, dev)

    t0 = time.perf_counter()
    state, metrics = step_fn(state, batch)
    float(metrics["loss"])
    first_step_s = time.perf_counter() - t0
    state, metrics = step_fn(state, batch)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        state, metrics = step_fn(state, batch)
    loss = float(metrics["loss"])
    dt = (time.perf_counter() - t0) / iters
    return {**throughput(cfg, n_params, batch_size, seq, dt, peak_flops),
            "step_time_s": dt, "first_step_s": first_step_s, "loss": loss,
            "n_params": n_params}


_PORT_KERNELS = ("flash_fwd_kernel", "flash_bwd_dkv_kernel",
                 "flash_bwd_dq_kernel", "dw_gateup_kernel", "dw_down_kernel",
                 "dgateup_kernel", "adamw_kernel", "quant_rows",
                 "dequant_rows")


def _kernel_kind(name: str) -> str:
    """A device kernel's group for the time breakdown, from its name."""
    if any(k in name for k in _PORT_KERNELS):
        return "port kernels"
    low = name.lower()
    if any(k in low for k in ("gemm", "nvjet", "cutlass", "xmma")):
        return "cuBLAS matmuls"
    if any(k in low for k in ("memcpy", "memset", "copy")):
        return "copies and casts"
    if any(k in low for k in ("elementwise", "reduce", "softmax", "cat",
                              "index", "scatter", "gather")):
        return "elementwise and reductions"
    return "other"


def profile_train(step_fn, state, batch, *, steps: int = 3, top: int = 8
                  ) -> Tuple[Any, Dict[str, Any]]:
    """torch.profiler over `steps` training steps: device (kernel and copy)
    time per step, split by kind of kernel, the kernels that take most of
    it, and the device-idle share of the window's own host-clock time
    (synchronized at both ends, profiler overhead included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dev = next(iter(batch.values())).device
    _sync(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step_fn(state, batch)
        _sync(dev)
        window_ms = 1e3 * (time.perf_counter() - t0)
    # device-side rows only: a CPU op's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    device_us = sum(r[1] for r in rows)
    by_kind: Dict[str, float] = {}
    for key, us, _ in rows:
        kind = _kernel_kind(key)
        by_kind[kind] = by_kind.get(kind, 0.0) + us / 1e3 / steps
    return state, {
        "steps": steps,
        "ms_per_step": window_ms / steps,
        "device_ms_per_step": device_us / 1e3 / steps,
        "device_idle_share": 1 - device_us / 1e3 / window_ms,
        "launches_per_step": sum(r[2] for r in rows) / steps,
        "ms_per_step_by_kind": by_kind,
        "top": [{"name": k[:90], "ms_per_step": us / 1e3 / steps,
                 "share": us / device_us, "calls_per_step": n / steps}
                for k, us, n in rows[:top]] if device_us else [],
    }


def main(argv: Optional[list] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="smoke path: ModelConfig.tiny on the CPU")
    args = ap.parse_args(argv)
    if args.cpu:
        cfg, batch_size, seq = ModelConfig.tiny(), 4, 128
        device, peak, platform = "cpu", NOMINAL_CPU_FLOPS, "cpu"
        kind, iters = "cpu", 3
    else:
        require_cuda("cuda")
        cfg, batch_size, seq = train_config_8b(), 2, 2048
        device, peak, platform = "cuda", PEAK_BF16_FLOPS_H100, "gpu"
        kind, iters = torch.cuda.get_device_name(0), 10
    r = bench_config(cfg, batch_size, seq, peak, iters, device=device)
    result = {
        "metric": "train_tokens_per_sec_per_chip",
        "value": r["tokens_per_sec"],
        "unit": "tokens/s/chip",
        "vs_baseline": r["mfu"] / 0.40,
        "mfu": r["mfu"],
        "n_params": r["n_params"],
        "n_chips": 1,
        "platform": platform,
        "device": kind,
        "batch": batch_size,
        "seq": seq,
        "step_time_s": r["step_time_s"],
        "first_step_s": r["first_step_s"],
        "loss": r["loss"],
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
