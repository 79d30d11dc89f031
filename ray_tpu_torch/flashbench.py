"""Times the three flash kernels at the Llama-3-8B attention shape on one GPU.

    python -m ray_tpu_torch.flashbench            # bf16 and float32
    python -m ray_tpu_torch.flashbench --dtype bfloat16

At b·h 64, s 2048, head_dim 128, causal ([b·h, s, d] layout), for each
dtype: the forward, dk/dv and dq kernels against their plain versions
(max abs error over the plain output's max), each kernel's time (median of
7 CUDA-event timings after a warm-up, the 50 MB L2 flushed before each
call and the stream held ~0.5 ms after the flush, as chip_smoke.py times
them), its share of the bound (operations: 2, 4 and 3 products of
2·pairs·hd FLOP at 989 TFLOP/s in bf16, 67 in float32), and
scaled_dot_product_attention's forward and backward on the same tensors
(bf16 only). A quick check between full chip_smoke runs; it needs a GPU.
"""

from __future__ import annotations

import argparse
import statistics

import torch

from ray_tpu_torch.ops.kernels import flash_attention as fa

PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
HOLD_CYCLES = 1_000_000


def time_ms(fn, flush: torch.Tensor, reps: int = 7) -> float:
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


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def run(dtype: torch.dtype, bh: int = 64, s: int = 2048, d: int = 128,
        seed: int = 0) -> None:
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    q, k, v, do = (torch.randn((bh, s, d), generator=gen,
                               device="cuda").to(dtype) for _ in range(4))
    scale = d ** -0.5
    out, lse = fa.flash_fwd(q, k, v, scale)
    p_out, p_lse = fa.flash_fwd_plain(q, k, v, scale)
    delta = fa.flash_delta(p_out, do)
    bwd = (q, k, v, do, p_lse, delta, scale)
    dk, dv = fa.flash_bwd_dkv(*bwd)
    dq = fa.flash_bwd_dq(*bwd)
    p_dk, p_dv = fa.flash_bwd_dkv_plain(*bwd)
    p_dq = fa.flash_bwd_dq_plain(*bwd)
    torch.cuda.synchronize()
    name = str(dtype).replace("torch.", "")
    print(f"{name} errors: out {rel_err(out, p_out):.3g} lse "
          f"{rel_err(lse, p_lse):.3g} dk {rel_err(dk, p_dk):.3g} dv "
          f"{rel_err(dv, p_dv):.3g} dq {rel_err(dq, p_dq):.3g}", flush=True)
    del out, lse, dk, dv, dq, p_dk, p_dv, p_dq
    product = 2 * bh * (s * (s + 1) // 2) * d  # the causal pairs only
    for kname, fn, n_products in (
            ("flash_fwd", lambda: fa.flash_fwd(q, k, v, scale), 2),
            ("flash_bwd_dkv", lambda: fa.flash_bwd_dkv(*bwd), 4),
            ("flash_bwd_dq", lambda: fa.flash_bwd_dq(*bwd), 3)):
        ms = time_ms(fn, flush)
        bound = 1e3 * n_products * product / PEAK_OPS_PER_S[dtype]
        print(f"{name} {kname}: {ms:.4f} ms a launch, bound {bound:.4f} ms "
              f"(operations), {bound / ms:.3f} of bound", flush=True)
    if dtype == torch.bfloat16:
        q4, k4, v4 = (t.view(1, *t.shape).requires_grad_(True)
                      for t in (q, k, v))
        lib_out = sdpa(q4, k4, v4, is_causal=True)

        def lib_fwd():
            with torch.no_grad():
                sdpa(q4, k4, v4, is_causal=True)

        fwd_ms = time_ms(lib_fwd, flush)
        bwd_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, (q4, k4, v4), do.view(1, *do.shape),
            retain_graph=True), flush)
        print(f"{name} scaled_dot_product_attention: forward {fwd_ms:.4f} "
              f"ms, backward {bwd_ms:.4f} ms", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=["bfloat16", "float32"], default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flashbench needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    for name in ([args.dtype] if args.dtype else ["bfloat16", "float32"]):
        run(getattr(torch, name))
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
