"""Serving-engine measurements (twin of ray_tpu/models/servebench.py:69-152).

  * `measure_decode` — steady-state decode throughput with every slot busy;
  * `profile_decode` — the same loop under torch.profiler: device time per
    step, the kernels that take it, and the device-idle share of the
    profiled window;
  * `measure_prefill` — batched bucketed admission throughput;
  * `measure_quant_parity` — the w8a16 honesty check: prefill logits of the
    quantized model against the unquantized one, and the weight-bytes ratio.

Times are host-clock windows that end in a device synchronization, so they
cover the device work they dispatch. The latency-under-load row of the
reference needs the Serve runtime and waits for its port.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import torch

from ray_tpu_torch.models.transformer import tree_leaves

_PROMPT = [1, 2, 3, 4, 5, 6, 7]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def measure_decode(params, cfg, *, num_slots: int, max_len: int,
                   steps: int = 40, warm_steps: int = 10,
                   quantize_weights: bool = False,
                   device="cuda") -> Dict[str, float]:
    """Steady-state decode throughput with every slot occupied. The warm-up
    admits the requests and settles the allocator; the measured window
    stays inside one attention bucket."""
    from ray_tpu_torch.models.serving import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(params, cfg, num_slots=num_slots,
                                   max_len=max_len,
                                   quantize_weights=quantize_weights,
                                   device=device)
    for i in range(num_slots):
        eng.submit([t + i for t in _PROMPT], max_new_tokens=10 ** 6)
    for _ in range(warm_steps):
        eng.step()
    _sync(eng.device)
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    _sync(eng.device)
    dt = time.perf_counter() - t0
    steps_per_s = steps / dt
    return {
        "num_slots": num_slots,
        "steps_per_s": steps_per_s,
        "decode_tokens_per_s": steps_per_s * num_slots,
        "ms_per_step": 1e3 * dt / steps,
    }


def profile_decode(params, cfg, *, num_slots: int, max_len: int,
                   steps: int = 8, warm_steps: int = 4,
                   quantize_weights: bool = False, top: int = 6,
                   device="cuda") -> Dict[str, Any]:
    """Device time of the steady decode loop from torch.profiler's CUDA
    activity: kernel (and copy) time per step, and the kernels that take
    most of it. The window's own host-clock time (synchronized at both
    ends, profiler overhead included) gives its device-idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from ray_tpu_torch.models.serving import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(params, cfg, num_slots=num_slots,
                                   max_len=max_len,
                                   quantize_weights=quantize_weights,
                                   device=device)
    for i in range(num_slots):
        eng.submit([t + i for t in _PROMPT], max_new_tokens=10 ** 6)
    for _ in range(warm_steps):
        eng.step()
    _sync(eng.device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            eng.step()
        _sync(eng.device)
        window_ms = 1e3 * (time.perf_counter() - t0)
    # device-side rows only: a CPU op's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    device_us = sum(r[1] for r in rows)
    return {
        "steps": steps,
        "ms_per_step": window_ms / steps,
        "device_ms_per_step": device_us / 1e3 / steps,
        "device_idle_share": 1 - device_us / 1e3 / window_ms,
        "launches_per_step": sum(r[2] for r in rows) / steps,
        "top": [{"name": k[:80], "ms_per_step": us / 1e3 / steps,
                 "share": us / device_us}
                for k, us, _ in rows[:top]] if device_us else [],
    }


def measure_prefill(params, cfg, *, max_len: int, bucket: int = 64,
                    batch: int = 4, iters: int = 8,
                    device="cuda") -> Dict[str, float]:
    """Batched bucketed admission throughput: one `prefill_slots` call per
    iteration over `batch` prompts of `bucket` tokens."""
    from ray_tpu_torch.models.serving import prefill_slots

    dev = torch.device(device)
    tokens = torch.arange(1, bucket + 1, dtype=torch.int32,
                          device=dev)[None].repeat(batch, 1)
    true_len = torch.full((batch,), bucket, dtype=torch.int32, device=dev)
    prefill_slots(params, tokens, true_len, cfg, max_len)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        prefill_slots(params, tokens, true_len, cfg, max_len)
    _sync(dev)
    dt = time.perf_counter() - t0
    return {
        "batch": batch,
        "prompt_len": bucket,
        "prefill_tokens_per_s": iters * batch * bucket / dt,
        "ms_per_call": 1e3 * dt / iters,
    }


def measure_quant_parity(params, cfg, *, max_len: int,
                         qparams: Optional[Dict] = None,
                         device="cuda") -> Dict[str, Any]:
    """Logits max-abs-diff of the w8a16 model relative to the unquantized
    logit scale on a probe prompt, and the weight-bytes ratio. Pass
    `qparams` to reuse an already quantized tree."""
    from ray_tpu_torch.models.inference import prefill
    from ray_tpu_torch.models.serving import quantize_model_params

    if qparams is None:
        qparams = quantize_model_params(params, cfg)
    tokens = torch.tensor([_PROMPT + [9, 22, 7]], dtype=torch.int32,
                          device=torch.device(device))
    ref, _ = prefill(params, tokens, cfg, max_len)
    qlog, _ = prefill(qparams, tokens, cfg, max_len)
    rel = float((ref - qlog).abs().max() / (ref.abs().max() + 1e-6))
    return {
        "logits_max_abs_diff_rel": rel,
        "logits_parity_ok": rel < 0.08,
        "weight_bytes_ratio": _nbytes(qparams) / _nbytes(params),
    }
