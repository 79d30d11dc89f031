"""Times the three flash kernels on one GPU.

    python -m ray_tpu_torch.flashbench            # bf16 and float32
    python -m ray_tpu_torch.flashbench --dtype float32
    python -m ray_tpu_torch.flashbench --dtype float32 \\
        --source OTHER/flash_attention.cu --other-unplanned dkv dq
    python -m ray_tpu_torch.flashbench --wide [--dtype float32] \\
        [--source OTHER/flash_wide.cu [--other-unplanned [NAME ...]]]

In the [b·h, s, d] layout, causal: bf16 at the Llama-3-8B attention shape
(b·h 64, s 2048, head_dim 128); float32 at the float32 tiny training
step's (b·h 4, s 128, head_dim 128) and then at that shape. At each shape:
the forward, dk/dv and dq kernels against their plain versions (max abs
error over the plain output's max), each kernel's time (median of 7
CUDA-event timings after a warm-up, the 50 MB L2 flushed before each call
and the stream held ~0.5 ms after the flush, as chip_smoke.py times them),
its share of the bound (operations: 2, 4 and 3 products of 2·pairs·hd FLOP
at 989 TFLOP/s in bf16, 67 in float32), and scaled_dot_product_attention's
forward and backward on the same tensors (TF32 off), with the backend
PyTorch's dispatcher picks and the kernels its forward launches (read by
torch.profiler). In float32 it also times each kernel at each plan it can
take (`flash_attention.F32_FWD_TILES`: the forward's and dq's query tile,
dk/dv's key tile; the plan's own is marked). With --source, the same C
entry points built from another flash_attention.cu (an earlier commit's,
or a variant; its directory must hold the hopper.cuh it includes) are
timed in turns with this tree's: other, tree, tree, other, twice.
--other-unplanned NAME... names the entries (fwd, dkv, dq) whose float32
kernel in the other build takes no plan (the bf16 entry's arguments): all
of them (the flag alone) before any plan existed (e.g. PR 9's), dkv and dq
for PR 10's. --wide times the wide family (csrc/flash_wide.cu) instead:
its three bf16 entries at the 8B attention shape (b·h 64, s 2048, causal)
and at chip_smoke phase 7e's (b·h 8, s 1024), at head_dim 320 (zero-padded
to 384, the bound at 320) and 512; with --dtype float32 its float32
entries at phase 7e's float32 shape (b·h 4, s 256; then b 1, 4 query
heads over 2 kv heads in the packed layout, no SDPA there) and then at
the 8B shape, each at every plan it can take (the dq's query tile,
`wide_f32_dq_tile`; the forward's and dk/dv's tile and slice width,
`wide_f32_fwd_plan`, `wide_f32_dkv_plan`), and the kernels SDPA's forward
and backward launch at the last shape named; with --source another
flash_wide.cu (`--other-unplanned fwd dkv` for PR 18's, whose float32 dq
alone takes a plan). A quick check between full chip_smoke runs; it needs
a GPU.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import statistics
import subprocess
from pathlib import Path

import torch

from ray_tpu_torch.ops.kernels import _util
from ray_tpu_torch.ops.kernels import flash_attention as fa

PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
HOLD_CYCLES = 1_000_000
# (b·h, s, head_dim): the 8B attention shape and the float32 tiny step's,
# whose many-kernel SDPA backward is timed before any torch.profiler window
# (after one it read 3-4x slower, PERF.md)
SHAPES = {torch.bfloat16: [(64, 2048, 128)],
          torch.float32: [(4, 128, 128), (64, 2048, 128)]}
# (b·h, s, head_dim) of --wide: the 8B attention shape at the wide family's
# head dims, then chip_smoke phase 7e's [b·h, s, d] shapes (b 1, 8 heads,
# s 1024), where the card is under-filled
WIDE_SHAPES = [(64, 2048, 320), (64, 2048, 512), (8, 1024, 320),
               (8, 1024, 512)]
# --wide --dtype float32: chip_smoke phase 7e's float32 [b·h, s, d] shapes
# (b 1, 4 heads, s 256) first, whose SDPA backward is timed before the one
# torch.profiler window (at the last shape), then the same in its packed
# layout (b 1, 4 query heads over 2 kv heads: `WIDE_F32_PACKED`), then the
# 8B attention shape
WIDE_F32_SHAPES = [(4, 256, 320), (4, 256, 512), (1, 256, 320),
                   (1, 256, 512), (64, 2048, 320), (64, 2048, 512)]
WIDE_F32_PACKED = {(1, 256, 320): (4, 2), (1, 256, 512): (4, 2)}
NAMES = ("rt_flash_fwd", "rt_flash_bwd_dkv", "rt_flash_bwd_dq")


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


def sdpa_backend(q, k, v, causal: bool = True) -> str:
    """The backend PyTorch's dispatcher picks for this SDPA call (GQA
    allowed)."""
    from torch.nn.attention import SDPBackend

    return SDPBackend(torch._fused_sdp_choice(
        q, k, v, is_causal=causal, enable_gqa=True)).name


def device_kernels(fn) -> list:
    """The names of the kernels one call of `fn` launches on the card (as
    servebench.profile_decode reads them)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA})


def load_other(source: Path, planned_names, wide: bool = False
               ) -> ctypes.CDLL:
    """`source` built with the port's nvcc flags (its own directory on the
    include path) into the build directory, its entries declared (the
    float32 ones not in `planned_names` without a plan; a flash_wide.cu's
    when `wide`)."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    out = _util.BUILD_DIR / f"libflashbench-{h.hexdigest()[:16]}.so"
    if not out.exists():
        _util.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run([_util._nvcc(), *_util.NVCC_FLAGS, "-I",
                        str(source.parent), "-o", str(out), str(source)],
                       check=True)
    lib = ctypes.CDLL(str(out))
    sigs = fa._WIDE_SIGNATURES if wide else fa._SIGNATURES
    for name in NAMES:
        if wide:
            name = name.replace("rt_flash_", "rt_flash_wide_")
        for entry in (name, f"{name}_f32"):
            sig = sigs[entry if _base(entry) in planned_names else name]
            getattr(lib, entry).argtypes, getattr(lib, entry).restype = sig
    return lib


# The entries whose float32 kernel takes a plan in this tree, the plan of
# each ([b·h, s, d] operands: b·h heads of s rows and s keys) as the
# arguments it adds, and every plan each can take at head_dim d; the wide
# family's plans also take the head_dim.
NAMES_SHORT = {"fwd": "rt_flash_fwd", "dkv": "rt_flash_bwd_dkv",
               "dq": "rt_flash_bwd_dq"}
PLANNED = frozenset(NAMES)
PLANS = {"rt_flash_fwd": lambda bh, s, d: (fa.f32_fwd_tile(bh, s),),
         "rt_flash_bwd_dkv": lambda bh, s, d: (fa.f32_dkv_tile(bh, s),),
         "rt_flash_bwd_dq": lambda bh, s, d: (fa.f32_fwd_tile(bh, s),)}
WIDE_PLANS = {"rt_flash_fwd": fa.wide_f32_fwd_plan,
              "rt_flash_bwd_dkv": fa.wide_f32_dkv_plan,
              "rt_flash_bwd_dq": lambda bh, s, d: (
                  fa.wide_f32_dq_tile(bh, s, d),)}


def every_plan(name: str, d: int, wide: bool) -> list:
    """Every plan entry `name` takes at head_dim d: a tile of
    F32_FWD_TILES; in the wide family the dq's tile, or the forward's and
    dk/dv's (tile, width) pairs that their entries take."""
    if not wide or name == "rt_flash_bwd_dq":
        return [(tile,) for tile in fa.F32_FWD_TILES]
    if name == "rt_flash_fwd":  # Q streams only in 16-row slices
        return [(tile, width) for tile in fa.WIDE_F32_FWD_TILES
                for width in dict.fromkeys((d, fa.WIDE_SLICE))
                if tile * d <= fa.WIDE_F32_ACC
                or (tile, width) == (16, fa.WIDE_SLICE)]
    tile = fa.WIDE_F32_DKV_TILE
    return [(tile, width) for width in dict.fromkeys((d, fa.WIDE_SLICE))
            if width == fa.WIDE_SLICE or 2 * tile * d <= fa.WIDE_F32_ACC]


def _base(entry: str) -> str:
    """"rt_flash_wide_bwd_dq_f32" -> "rt_flash_bwd_dq"."""
    return entry.replace("rt_flash_wide_", "rt_flash_").removesuffix("_f32")


def planned(name: str, layout, wide: bool) -> tuple:
    """The plan the wrappers pick for entry `name` at `layout` (batch,
    heads, n_rep, sq, sk, d): over the query heads, dk/dv's over the kv
    heads."""
    b, heads, n_rep, s, _, d = layout
    n = b * heads // (n_rep if name == "rt_flash_bwd_dkv" else 1)
    return (WIDE_PLANS if wide else PLANS)[name](n, s, d)


def entries(lib: ctypes.CDLL, t: dict, dtype: torch.dtype, scale: float,
            planned_names=PLANNED, plan=None, wide: bool = False,
            heads=(1, 1)) -> dict:
    """The three entry points of `lib` for `dtype` on the tensors `t`
    ([b, s, heads·d] q and dO, [b, s, kv heads·d] k and v: `heads`;
    [b·h, s, d] is (1, 1); causal), each launched on the current stream;
    each float32 one in `planned_names` at the plan `plan` (a tuple of its
    arguments), else at its wrapper's; the wide family's when `wide`."""
    b, s, width = t["q"].shape
    layout = (b, heads[0], heads[0] // heads[1], s, s, width // heads[0])
    stream = torch.cuda.current_stream().cuda_stream
    f32 = dtype == torch.float32

    def call(name, names):
        entry = name.replace("rt_flash_", "rt_flash_wide_") if wide else name
        fn = getattr(lib, entry + ("_f32" if f32 else ""))
        extra = ((plan or planned(name, layout, wide))
                 if f32 and name in planned_names else ())
        code = fn(*(t[x].data_ptr() for x in names), *layout, scale, 1,
                  *extra, stream)
        if code:
            raise RuntimeError(f"CUDA error {code}")

    return {
        "flash_fwd": lambda: call("rt_flash_fwd",
                                  ("q", "k", "v", "out", "lse")),
        "flash_bwd_dkv": lambda: call(
            "rt_flash_bwd_dkv",
            ("q", "k", "v", "do", "p_lse", "delta", "dk", "dv")),
        "flash_bwd_dq": lambda: call(
            "rt_flash_bwd_dq",
            ("q", "k", "v", "do", "p_lse", "delta", "dq")),
    }


def run(dtype: torch.dtype, shape, gen, flush, other,
        wide: bool = False, profile: bool = True, heads=(1, 1)) -> None:
    """Times the three entries at `shape` ([b·h, s, d]; or (b, s, d) over
    `heads` = (query heads, kv heads) in the packed layout) beside their
    plain versions and SDPA ([b·h, s, d] only; its forward's kernels read
    by torch.profiler when `profile`), and in turns with `other`'s."""
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    b, s, d = shape
    h, kv = heads
    # the wide family runs at head_dim kd, the operands zero-padded to it
    kd = fa.kernel_head_dim(d) if wide else d
    name = str(dtype).replace("torch.", "")
    label = (f"{name} {list(shape)}{' wide' if wide else ''}"
             f"{f' packed {h}/{kv} heads' if h > 1 else ''}")
    width = {"q": h, "k": kv, "v": kv, "do": h}
    t = {x: torch.randn((b, s, n * d), generator=gen,
                        device="cuda").to(dtype) for x, n in width.items()}
    scale = d ** -0.5
    if h > 1:
        p_out, t["p_lse"] = fa.flash_fwd_packed_plain(t["q"], t["k"],
                                                      t["v"], h, kv, scale)
        t["delta"] = fa.flash_delta_packed(p_out, t["do"], h)
        bwd = (t["q"], t["k"], t["v"], t["do"], t["p_lse"], t["delta"], h,
               kv, scale)
        want = {"flash_fwd": (p_out, t["p_lse"]),
                "flash_bwd_dkv": fa.flash_bwd_dkv_packed_plain(*bwd),
                "flash_bwd_dq": (fa.flash_bwd_dq_packed_plain(*bwd),)}
    else:
        p_out, t["p_lse"] = fa.flash_fwd_plain(t["q"], t["k"], t["v"], scale)
        t["delta"] = fa.flash_delta(p_out, t["do"])
        bwd = (t["q"], t["k"], t["v"], t["do"], t["p_lse"], t["delta"],
               scale)
        want = {"flash_fwd": (p_out, t["p_lse"]),
                "flash_bwd_dkv": fa.flash_bwd_dkv_plain(*bwd),
                "flash_bwd_dq": (fa.flash_bwd_dq_plain(*bwd),)}
    outs = {"flash_fwd": ("out", "lse"), "flash_bwd_dkv": ("dk", "dv"),
            "flash_bwd_dq": ("dq",)}
    kt = dict(t)  # the entries' operands
    for x, n in width.items():
        kt[x] = fa.pad_heads(t[x], n, d, kd)
    for x, like in (("out", "q"), ("dq", "q"), ("dk", "k"), ("dv", "k")):
        kt[x] = torch.empty_like(kt[like])
    kt["lse"] = torch.empty_like(t["p_lse"])

    def got(x):  # an entry's output at head_dim d
        n = kv if x in ("dk", "dv") else h
        return fa.unpad_heads(kt[x], n, d, kd) if x != "lse" else kt[x]

    lib, _ = (fa._wide_entry if wide else fa._entry)("rt_flash_fwd", dtype)
    tree = entries(lib, kt, dtype, scale, wide=wide, heads=heads)
    product = 2 * b * h * (s * (s + 1) // 2) * d  # the causal pairs only
    n_products = {"flash_fwd": 2, "flash_bwd_dkv": 4, "flash_bwd_dq": 3}
    for kname, fn in tree.items():
        fn()
        torch.cuda.synchronize()
        err = max(rel_err(got(o), w) for o, w in zip(outs[kname],
                                                     want[kname]))
        ms = time_ms(fn, flush)
        bound = 1e3 * n_products[kname] * product / PEAK_OPS_PER_S[dtype]
        print(f"{label} {kname}: {ms:.4f} ms a launch, bound {bound:.4f} ms "
              f"(operations), {bound / ms:.3f} of bound; max abs err "
              f"{err:.3g} of the plain max", flush=True)
    if dtype == torch.float32:
        for kname, entry in zip(tree, NAMES):
            mine = planned(entry, (b, h, h // kv, s, s, kd), wide)
            times = []
            for plan in every_plan(entry, kd, wide):
                fn = entries(lib, kt, dtype, scale, plan=plan, wide=wide,
                             heads=heads)[kname]
                fn()
                torch.cuda.synchronize()
                err = max(rel_err(got(o), w) for o, w in zip(outs[kname],
                                                             want[kname]))
                times.append(f"{plan}{' (plan)' if plan == mine else ''} "
                             f"{time_ms(fn, flush):.4f} (err {err:.2g})")
            print(f"{label} {kname} by plan, ms a launch: "
                  f"{', '.join(times)}", flush=True)
    if h == 1:  # SDPA on the [b·h, s, d] operands
        q4, k4, v4 = (t[x].view(1, *t[x].shape).requires_grad_(True)
                      for x in ("q", "k", "v"))
        lib_out = sdpa(q4, k4, v4, is_causal=True)

        def lib_fwd():
            with torch.no_grad():
                sdpa(q4, k4, v4, is_causal=True)

        def lib_bwd():
            torch.autograd.grad(lib_out, (q4, k4, v4),
                                t["do"].view(1, *t["do"].shape),
                                retain_graph=True)

        fwd_ms = time_ms(lib_fwd, flush)
        bwd_ms = time_ms(lib_bwd, flush)
        kernels = ""
        if profile:
            kernels = f"; forward kernels {device_kernels(lib_fwd)}"
            if wide:  # float32 at the 8B wide shape: CUDA or tensor cores
                kernels += f"; backward kernels {device_kernels(lib_bwd)}"
        print(f"{label} scaled_dot_product_attention: forward "
              f"{fwd_ms:.4f} ms, backward {bwd_ms:.4f} ms; backend "
              f"{sdpa_backend(q4, k4, v4)}{kernels}", flush=True)
    if other is None:
        return
    lib_other, planned_other = other
    others = entries(lib_other, kt, dtype, scale, planned_other, wide=wide,
                     heads=heads)
    for kname in tree:
        others[kname]()
        torch.cuda.synchronize()
        err = max(rel_err(got(o), w) for o, w in zip(outs[kname],
                                                     want[kname]))
        turns = []
        for _ in range(2):
            for who, fns in (("other", others), ("tree", tree),
                             ("tree", tree), ("other", others)):
                turns.append(f"{who} {time_ms(fns[kname], flush):.4f}")
        print(f"{label} {kname} in turns, ms a launch: {', '.join(turns)} "
              f"(other: max abs err {err:.3g} of the plain max)", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dtype", choices=["bfloat16", "float32"], default=None)
    ap.add_argument("--source", type=Path, default=None)
    ap.add_argument("--other-unplanned", nargs="*", choices=NAMES_SHORT,
                    default=None, metavar="NAME")
    ap.add_argument("--wide", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flashbench needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    other = None
    if args.source is not None:
        unplanned = args.other_unplanned
        if unplanned is not None and not unplanned:  # the flag alone: all
            unplanned = NAMES_SHORT
        planned_names = PLANNED - {NAMES_SHORT[n] for n in unplanned or ()}
        other = (load_other(args.source, planned_names, args.wide),
                 planned_names)
        print(f"other: {args.source}", flush=True)
    if args.wide:
        f32 = args.dtype == "float32"
        shapes = WIDE_F32_SHAPES if f32 else WIDE_SHAPES
        for i, shape in enumerate(shapes):
            run(torch.float32 if f32 else torch.bfloat16, shape, gen, flush,
                other, wide=True, profile=not f32 or i == len(shapes) - 1,
                heads=WIDE_F32_PACKED.get(shape, (1, 1)) if f32 else (1, 1))
            torch.cuda.empty_cache()
        return
    for name in ([args.dtype] if args.dtype else ["bfloat16", "float32"]):
        dtype = getattr(torch, name)
        for shape in SHAPES[dtype]:
            run(dtype, shape, gen, flush, other)
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
