"""Times the fused-FFN kernels K3, K1 and K2 on one GPU.

    python -m ray_tpu_torch.ffnbench
    python -m ray_tpu_torch.ffnbench --dtype float32
    python -m ray_tpu_torch.ffnbench --source OTHER/fused_ffn.cu
    python -m ray_tpu_torch.ffnbench --dtype float32 \\
        --source OTHER/fused_ffn.cu --other-unplanned

bf16 (the default) runs the Llama-3-8B training shape, T 4096, d 4096,
d_ff 14336; float32 runs that shape and then the float32 tiny training
step's (T 256, d 256, d_ff 256), where it also times K1 and K2 under each
plan of PLAN_SWEEP (the tile and split of the reduction that
`fused_ffn.f32_plan` picks, and the others). At each shape: each kernel
against its plain version (max abs error over the plain output's max), its
time (median of 7 CUDA-event timings after a warm-up, the 50 MB L2 flushed
before each call and the stream held ~0.5 ms after the flush, as
chip_smoke.py times them), its share of the bound (operations: 2·T·d·d_ff
FLOP a product, two for K3, at 989 TFLOP/s in bf16 or 67 TFLOP/s in
float32 on the CUDA cores) and the library call chip_smoke.py times beside
it (TF32 off). The kernels' C entry points are called on preallocated
outputs (and, for the float32 K1 and K2, the workspace of their plan).
With --source, the same C entry points built from another fused_ffn.cu
(an earlier commit's, or a variant; its directory must hold the hopper.cuh
it includes) are timed in turns with this tree's: other, tree, tree,
other, twice. --other-unplanned says that the other build's float32 K1 and
K2 take no workspace or plan (the arguments of the bf16 entries), as
before the float32 plan existed. A quick check between full chip_smoke
runs; it needs a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
from pathlib import Path

import torch

from ray_tpu_torch.flashbench import rel_err, time_ms
from ray_tpu_torch.ops.kernels import _util
from ray_tpu_torch.ops.kernels import fused_ffn as ff

PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
TINY = (256, 256, 256)  # the float32 tiny training step's (T, d, d_ff)
SHAPES = {torch.bfloat16: [(4096, 4096, 14336)],
          torch.float32: [(4096, 4096, 14336), TINY]}
PLAN_SWEEP = [ff.F32Plan(64, s) for s in (1, 2, 4, 8, 16)] + [
    ff.F32Plan(128, 1)]
NAMES = ("rt_dw_gateup", "rt_dw_down", "rt_dgateup")


def load_other(source: Path, dtype: torch.dtype,
               unplanned: bool) -> ctypes.CDLL:
    """`source` built with the port's nvcc flags (its own directory on the
    include path) into the build directory, its entries for `dtype`
    declared."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    out = _util.BUILD_DIR / f"libffnbench-{h.hexdigest()[:16]}.so"
    if not out.exists():
        _util.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_util._nvcc(), *_util.NVCC_FLAGS, "-I",
                        str(source.parent), "-o", str(out), str(source)],
                       check=True)
    lib = ctypes.CDLL(str(out))
    for name in NAMES:
        entry = name + ("_f32" if dtype == torch.float32 else "")
        sig = ff._SIGNATURES[name if unplanned else entry]
        getattr(lib, entry).argtypes, getattr(lib, entry).restype = sig
    return lib


def entries(lib: ctypes.CDLL, t, dims, dtype: torch.dtype, planned: bool,
            plan=None) -> dict:
    """The three entry points of `lib` for `dtype` on the tensors `t` at
    `dims` (T, d, d_ff), each launched on the current stream; the float32
    K1 and K2 on `plan` when given, else on their own (`f32_plan`)."""
    T, D, DFF = dims
    stream = torch.cuda.current_stream().cuda_stream
    f32 = dtype == torch.float32
    plans = {}
    if f32 and planned:  # (workspace pointer, T, d, d_ff, tile, splits)
        for name, (M, N, K) in (("rt_dw_down", (DFF, D, T)),
                                ("rt_dgateup", (T, DFF, D))):
            p = plan or ff.f32_plan(M, N, K)
            ws = (torch.empty((p.splits, M, N), dtype=torch.float32,
                              device="cuda") if p.splits > 1 else None)
            t.setdefault("workspaces", []).append(ws)  # alive while timed
            plans[name] = (None if ws is None else ws.data_ptr(), T, D, DFF,
                           p.tile, p.splits)

    def call(name, *tensors):
        fn = getattr(lib, name + ("_f32" if f32 else ""))
        args = plans.get(name, (T, D, DFF))
        code = fn(*(t[x].data_ptr() for x in tensors), *args, stream)
        if code:
            raise RuntimeError(f"CUDA error {code}")

    return {
        "dw_gateup": lambda: call("rt_dw_gateup", "x", "rstd", "nw", "dgate",
                                  "dup", "dwg", "dwu"),
        "dw_down": lambda: call("rt_dw_down", "gate", "up", "dy", "dwd"),
        "dgateup": lambda: call("rt_dgateup", "dy", "wd", "gate", "up", "dg",
                                "du"),
    }


def run(dims, dtype: torch.dtype, gen, flush, other) -> None:
    """Times the tree's three kernels at `dims`, and `other`'s in turns."""
    T, D, DFF = dims

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    t = {"x": randn(T, D), "nw": randn(D, scale=0.1) + 1,
         "rstd": torch.rand((T, 1), generator=gen, device="cuda") + 0.5,
         "dgate": randn(T, DFF, scale=0.01), "dup": randn(T, DFF, scale=0.01),
         "gate": randn(T, DFF), "up": randn(T, DFF),
         "dy": randn(T, D, scale=0.01), "wd": randn(DFF, D, scale=DFF ** -0.5)}
    for name, shape in (("dwg", (D, DFF)), ("dwu", (D, DFF)),
                        ("dwd", (DFF, D)), ("dg", (T, DFF)),
                        ("du", (T, DFF))):
        t[name] = torch.empty(shape, dtype=dtype, device="cuda")
    lib, _ = ff._entry("rt_dw_gateup", dtype)
    tree = entries(lib, t, dims, dtype, planned=True)

    plain = {"dw_gateup": ff.dw_gateup_plain(t["x"], t["rstd"], t["nw"],
                                             t["dgate"], t["dup"]),
             "dw_down": (ff.dw_down_plain(t["gate"], t["up"], t["dy"]),),
             "dgateup": ff.dgateup_plain(t["dy"], t["wd"], t["gate"],
                                         t["up"])}
    outs = {"dw_gateup": ("dwg", "dwu"), "dw_down": ("dwd",),
            "dgateup": ("dg", "du")}
    h = ff.normed(t["x"], t["rstd"], t["nw"])
    s_act = ff.swiglu_act(t["gate"], t["up"])
    library = {
        "dw_gateup": lambda: (torch.matmul(h.T, t["dgate"]),
                              torch.matmul(h.T, t["dup"])),
        "dw_down": lambda: torch.matmul(s_act.T, t["dy"]),
        "dgateup": lambda: torch.matmul(t["dy"], t["wd"].T)}
    product = 2 * T * D * DFF
    label = f"{str(dtype).replace('torch.', '')} {list(dims)}"
    for name, fn in tree.items():
        fn()
        torch.cuda.synchronize()
        err = max(rel_err(t[o], p) for o, p in zip(outs[name], plain[name]))
        ms = time_ms(fn, flush)
        bound = 1e3 * product * (2 if name == "dw_gateup" else 1) \
            / PEAK_OPS_PER_S[dtype]
        print(f"{name} {label}: {ms:.4f} ms a launch, bound {bound:.4f} ms "
              f"(operations), {bound / ms:.3f} of bound, library "
              f"{time_ms(library[name], flush):.4f} ms; max abs err "
              f"{err:.3g} of the plain max", flush=True)
    if dtype == torch.float32 and dims == TINY:
        # the plan f32_plan picks against the others a 64 or 128 tile can
        # take at this shape
        for plan in PLAN_SWEEP:
            fns = entries(lib, t, dims, dtype, True, plan)
            times = ", ".join(f"{name} {time_ms(fns[name], flush):.4f}"
                              for name in ("dw_down", "dgateup"))
            print(f"plan {tuple(plan)} {label}: {times} ms a launch",
                  flush=True)
    if other is None:
        return
    lib_other, planned = other
    others = entries(lib_other, t, dims, dtype, planned)
    for name in tree:
        others[name]()
        torch.cuda.synchronize()
        err = max(rel_err(t[o], p) for o, p in zip(outs[name], plain[name]))
        turns = []
        for _ in range(2):
            for who, fns in (("other", others), ("tree", tree),
                             ("tree", tree), ("other", others)):
                turns.append(f"{who} {time_ms(fns[name], flush):.4f}")
        print(f"{name} {label} in turns, ms a launch: {', '.join(turns)} "
              f"(other: max abs err {err:.3g} of the plain max)", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--source", type=Path, default=None)
    ap.add_argument("--other-unplanned", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ffnbench needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, args.dtype)
    print(torch.cuda.get_device_name(0), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    other = None
    if args.source is not None:
        other = (load_other(args.source, dtype, args.other_unplanned),
                 not args.other_unplanned)
        print(f"other: {args.source}", flush=True)
    for dims in SHAPES[dtype]:
        run(dims, dtype, gen, flush, other)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
