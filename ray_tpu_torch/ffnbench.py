"""Times the fused-FFN kernels K3, K1 and K2 on one GPU.

    python -m ray_tpu_torch.ffnbench
    python -m ray_tpu_torch.ffnbench --dtype float32
    python -m ray_tpu_torch.ffnbench --source OTHER/fused_ffn.cu
    python -m ray_tpu_torch.ffnbench --dtype float32 \\
        --source OTHER/fused_ffn.cu --other-unplanned dw_gateup

bf16 (the default) runs the Llama-3-8B training shape, T 4096, d 4096,
d_ff 14336; float32 runs that shape and then the float32 tiny training
step's (T 256, d 256, d_ff 256), where it also times K3, K1 and K2 under
each plan of PLAN_SWEEP (the tile and split of the reduction that
`fused_ffn.f32_plan` picks, and the others). At each shape: each kernel
against its plain version (max abs error over the plain output's max), its
time (median of 7 CUDA-event timings after a warm-up, the 50 MB L2 flushed
before each call and the stream held ~0.5 ms after the flush, as
chip_smoke.py times them), its share of the bound (operations: 2·T·d·d_ff
FLOP a product, two for K3, at 989 TFLOP/s in bf16 or 67 TFLOP/s in
float32 on the CUDA cores) and the library call chip_smoke.py times beside
it (TF32 off). The kernels' C entry points are called on preallocated
outputs (and, in float32, the workspace of their plan).
With --source, the same C entry points built from another fused_ffn.cu
(an earlier commit's, or a variant; its directory must hold the hopper.cuh
it includes) are timed in turns with this tree's: other, tree, tree,
other, twice. --other-unplanned NAME... names the kernels (dw_gateup,
dw_down, dgateup) whose float32 entries in the other build take no
workspace or plan (the arguments of the bf16 entries), as before the
float32 plan reached them: K3 before the float32 K3's redesign, all three
(the flag alone) before the float32 K1's and K2's. A quick check between
full chip_smoke runs; it needs a GPU.
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
NAMES = ("dw_gateup", "dw_down", "dgateup")  # C entries rt_<name>[_f32]
PLANNED = frozenset(NAMES)  # this tree: every float32 entry takes a plan
OUTPUTS = {"dw_gateup": ("dwg", "dwu"), "dw_down": ("dwd",),
           "dgateup": ("dg", "du")}


def product_dims(name: str, T: int, d: int, dff: int):
    """(M, N, K, outputs) of kernel `name`'s product at (T, d, d_ff)."""
    return {"dw_gateup": (d, dff, T, 2), "dw_down": (dff, d, T, 1),
            "dgateup": (T, dff, d, 1)}[name]


def add_outputs(t: dict, dims, dtype: torch.dtype) -> None:
    """The kernels' outputs at `dims` into `t`: dW_gate and dW_up the two
    halves of one [2, d, d_ff] tensor, as the wrapper allocates them."""
    T, D, DFF = dims
    t["dwg"], t["dwu"] = torch.empty((2, D, DFF), dtype=dtype,
                                     device="cuda")
    for name, shape in (("dwd", (DFF, D)), ("dg", (T, DFF)),
                        ("du", (T, DFF))):
        t[name] = torch.empty(shape, dtype=dtype, device="cuda")


def load_other(source: Path, dtype: torch.dtype,
               planned: frozenset) -> ctypes.CDLL:
    """`source` built with the port's nvcc flags (its own directory on the
    include path) into the build directory, its entries for `dtype`
    declared (the float32 entries of the kernels in `planned` with a
    plan)."""
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
    f32 = dtype == torch.float32
    for name in NAMES:
        entry = f"rt_{name}" + ("_f32" if f32 else "")
        sig = ff._SIGNATURES[entry if name in planned else f"rt_{name}"]
        getattr(lib, entry).argtypes, getattr(lib, entry).restype = sig
    return lib


def entries(lib: ctypes.CDLL, t, dims, dtype: torch.dtype,
            planned: frozenset, plan=None) -> dict:
    """The three entry points of `lib` for `dtype` on the tensors `t` at
    `dims` (T, d, d_ff), each launched on the current stream; the float32
    entries of the kernels in `planned` on `plan` when given, else on their
    own (`f32_plan`)."""
    T, D, DFF = dims
    stream = torch.cuda.current_stream().cuda_stream
    f32 = dtype == torch.float32
    plans = {}
    for name in planned if f32 else ():
        # (workspace pointer, T, d, d_ff, tile, splits)
        M, N, K, outputs = product_dims(name, T, D, DFF)
        p, ws = ff.f32_launch_plan(M, N, K, "cuda", outputs, plan)
        t.setdefault("workspaces", []).append(ws)  # alive while timed
        plans[name] = (None if ws is None else ws.data_ptr(), T, D, DFF,
                       p.tile, p.splits)

    def call(name, *tensors):
        fn = getattr(lib, f"rt_{name}" + ("_f32" if f32 else ""))
        args = plans.get(name, (T, D, DFF))
        code = fn(*(t[x].data_ptr() for x in tensors), *args, stream)
        if code:
            raise RuntimeError(f"CUDA error {code}")

    return {
        "dw_gateup": lambda: call("dw_gateup", "x", "rstd", "nw", "dgate",
                                  "dup", "dwg", "dwu"),
        "dw_down": lambda: call("dw_down", "gate", "up", "dy", "dwd"),
        "dgateup": lambda: call("dgateup", "dy", "wd", "gate", "up", "dg",
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
    add_outputs(t, dims, dtype)
    lib, _ = ff._entry("rt_dw_gateup", dtype)
    tree = entries(lib, t, dims, dtype, PLANNED)

    plain = {"dw_gateup": ff.dw_gateup_plain(t["x"], t["rstd"], t["nw"],
                                             t["dgate"], t["dup"]),
             "dw_down": (ff.dw_down_plain(t["gate"], t["up"], t["dy"]),),
             "dgateup": ff.dgateup_plain(t["dy"], t["wd"], t["gate"],
                                         t["up"])}
    outs = OUTPUTS
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
            fns = entries(lib, t, dims, dtype, PLANNED, plan)
            times = ", ".join(f"{name} {time_ms(fns[name], flush):.4f}"
                              for name in NAMES)
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
    ap.add_argument("--other-unplanned", nargs="*", choices=NAMES,
                    default=None, metavar="NAME")
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
        unplanned = args.other_unplanned
        if unplanned is not None and not unplanned:  # the flag alone: all
            unplanned = NAMES
        planned = PLANNED - frozenset(unplanned or ())
        other = (load_other(args.source, dtype, planned), planned)
        print(f"other: {args.source}", flush=True)
    for dims in SHAPES[dtype]:
        run(dims, dtype, gen, flush, other)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
