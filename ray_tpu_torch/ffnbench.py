"""Times the bf16 fused-FFN kernels K3, K1 and K2 at the Llama-3-8B training
shape on one GPU.

    python -m ray_tpu_torch.ffnbench
    python -m ray_tpu_torch.ffnbench --source OTHER/fused_ffn.cu

At T 4096, d 4096, d_ff 14336: each kernel against its plain version (max
abs error over the plain output's max), its time (median of 7 CUDA-event
timings after a warm-up, the 50 MB L2 flushed before each call and the
stream held ~0.5 ms after the flush, as chip_smoke.py times them), its share
of the bound (operations: 2·T·d·d_ff FLOP a product, two for K3, at 989
TFLOP/s) and the library call chip_smoke.py times beside it. With
--source, the same C entry points built from another fused_ffn.cu (an
earlier commit's, or a variant; its directory must hold the hopper.cuh it
includes) are timed in turns with this tree's: other, tree, tree, other,
twice. A quick check between full chip_smoke runs; it needs a GPU.
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

PEAK_OPS_PER_S = 989e12
T, D, DFF = 4096, 4096, 14336


def load_other(source: Path) -> ctypes.CDLL:
    """`source` built with the port's nvcc flags (its own directory on the
    include path) into the build directory, with the bf16 signatures."""
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
    for name in ("rt_dw_gateup", "rt_dw_down", "rt_dgateup"):
        argtypes, restype = ff._SIGNATURES[name]
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = restype
    return lib


def entries(lib: ctypes.CDLL, t) -> dict:
    """The three bf16 entry points of `lib` on the tensors `t`, each
    launched on the current stream."""
    stream = torch.cuda.current_stream().cuda_stream

    def call(fn, *tensors):
        code = fn(*(x.data_ptr() for x in tensors), T, D, DFF, stream)
        if code:
            raise RuntimeError(f"CUDA error {code}")

    return {
        "dw_gateup": lambda: call(lib.rt_dw_gateup, t["x"], t["rstd"],
                                  t["nw"], t["dgate"], t["dup"], t["dwg"],
                                  t["dwu"]),
        "dw_down": lambda: call(lib.rt_dw_down, t["gate"], t["up"], t["dy"],
                                t["dwd"]),
        "dgateup": lambda: call(lib.rt_dgateup, t["dy"], t["wd"], t["gate"],
                                t["up"], t["dg"], t["du"]),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", type=Path, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ffnbench needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(torch.cuda.get_device_name(0), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).bfloat16()

    t = {"x": randn(T, D), "nw": randn(D, scale=0.1) + 1,
         "rstd": torch.rand((T, 1), generator=gen, device="cuda") + 0.5,
         "dgate": randn(T, DFF, scale=0.01), "dup": randn(T, DFF, scale=0.01),
         "gate": randn(T, DFF), "up": randn(T, DFF),
         "dy": randn(T, D, scale=0.01), "wd": randn(DFF, D, scale=DFF ** -0.5)}
    for name, shape in (("dwg", (D, DFF)), ("dwu", (D, DFF)),
                        ("dwd", (DFF, D)), ("dg", (T, DFF)),
                        ("du", (T, DFF))):
        t[name] = torch.empty(shape, dtype=torch.bfloat16, device="cuda")
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    lib, _ = ff._entry("rt_dw_gateup", torch.bfloat16)
    tree = entries(lib, t)

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
    for name, fn in tree.items():
        fn()
        torch.cuda.synchronize()
        err = max(rel_err(t[o], p) for o, p in zip(outs[name], plain[name]))
        ms = time_ms(fn, flush)
        bound = 1e3 * product * (2 if name == "dw_gateup" else 1) \
            / PEAK_OPS_PER_S
        print(f"{name}: {ms:.4f} ms a launch, bound {bound:.4f} ms "
              f"(operations), {bound / ms:.3f} of bound, library "
              f"{time_ms(library[name], flush):.4f} ms; max abs err "
              f"{err:.3g} of the plain max", flush=True)
    if args.source is not None:
        other = entries(load_other(args.source), t)
        for name in tree:
            other[name]()
            torch.cuda.synchronize()
            err = max(rel_err(t[o], p)
                      for o, p in zip(outs[name], plain[name]))
            turns = []
            for _ in range(2):
                for label, fns in (("other", other), ("tree", tree),
                                   ("tree", tree), ("other", other)):
                    turns.append(f"{label} {time_ms(fns[name], flush):.4f}")
            print(f"{name} in turns, ms a launch: {', '.join(turns)} (other "
                  f"{args.source}: max abs err {err:.3g} of the plain max)",
                  flush=True)


if __name__ == "__main__":
    main()
