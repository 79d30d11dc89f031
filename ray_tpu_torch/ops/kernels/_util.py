"""Shared helpers for the hand-written CUDA kernels (twin of
ray_tpu/ops/pallas/_util.py): size arithmetic, the device check every entry
point runs, the leaf order of a parameter tree, and the nvcc build step.

Kernels live in ``csrc/<name>.cu`` with a plain C interface. `build`
compiles each source with nvcc into
``build/torch_kernels/lib<name>-<hash>.so`` at the repository root, where the
hash covers the source text and the compiler flags, so an edit rebuilds and
an unchanged tree reuses the library. A build writes to a temporary file and
renames it into place, so concurrent builds never load a half-written
library. Libraries are loaded with ctypes; every C entry point returns
``cudaGetLastError()`` after its launch and ``check`` raises on non-zero.
Where a source holds bfloat16 and float32 kernels (flash attention, the
fused FFN), each entry point ``name`` has a float32 twin ``name_f32``
(`with_f32`, `dtype_entry`), and wrappers count launches with
`count_launch`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Any, Dict, Iterable, Sequence, Tuple

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
# No --use_fast_math: the quant kernel's IEEE division and rintf must match
# the plain PyTorch version bit for bit.
NVCC_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC")

Signature = Tuple[Sequence[type], type]

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOAD_LOCK = threading.Lock()


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def require_cuda(device) -> torch.device:
    """Resolve `device`; raise if it names CUDA and no CUDA device exists.
    Entry points default to "cuda" and never fall back to the CPU silently."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but CUDA is not available; "
            f"pass device='cpu' to run on the CPU")
    return dev


def check_cuda(tensors: Sequence[torch.Tensor], what: str) -> None:
    """Raise unless every tensor is contiguous and on one CUDA device (a
    wrapper runs its plain version only when every tensor is on the
    CPU)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: every tensor must be on one CUDA "
                             f"device (the plain version serves the CPU), "
                             f"got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")


def rows_vectorized(x: torch.Tensor, *others: torch.Tensor) -> bool:
    """Whether a row kernel may move 16 bytes at a time: the last axis of
    `x` a multiple of 16 bytes' worth of its elements, and every pointer
    16-byte aligned."""
    return (x.shape[-1] % (16 // x.element_size()) == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, *others)))


def tree_leaves(tree: Any):
    """Tensors of a nested-dict parameter tree, in sorted-key order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_leaves(tree[key])
    else:
        yield tree


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin directory "
                       "on PATH or set CUDA_HOME")


def library_path(name: str) -> Path:
    """Where `csrc/<name>.cu` builds to: keyed by its text and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str]) -> Dict[str, Path]:
    """Compile every named source that is not built yet, one nvcc process
    per source, all started together. Returns {name: library path}."""
    names = list(names)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(
            f"{out.stem}.{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, proc, tmp, out))
    failures = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed on {name}.cu "
                            f"(exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return {name: library_path(name) for name in names}


def load_library(name: str, signatures: Dict[str, Signature]) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<name>.cu`, declaring argtypes and
    restype for every listed entry point plus `rt_error_string`."""
    with _LOAD_LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            lib.rt_error_string.argtypes = [ctypes.c_int]
            lib.rt_error_string.restype = ctypes.c_char_p
            for fn, (argtypes, restype) in signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = restype
            _LOADED[name] = lib
        return lib


# Blocks that make about one wave of an H100's 132 SMs: the float32 kernels'
# host plans (flash_attention.f32_fwd_tile, fused_ffn.f32_plan) size their
# grids against it.
WAVE_BLOCKS = 128

# The dtypes of the flash and fused-FFN kernels: each C entry point `name`
# takes bfloat16, and `name_f32` the same operands in float32.
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def with_f32(signatures: Dict[str, Signature]) -> Dict[str, Signature]:
    """`signatures` and the float32 twin (`name_f32`) of each entry."""
    return {**signatures,
            **{f"{name}_f32": sig for name, sig in signatures.items()}}


def dtype_entry(library: str, signatures: Dict[str, Signature], name: str,
                dtype: torch.dtype):
    """(the library, its entry point `name` for operands of `dtype`)."""
    lib = load_library(library, signatures)
    return lib, getattr(lib, name + ("_f32" if dtype == torch.float32
                                     else ""))


def count_launch(wrapper, dtype: torch.dtype) -> None:
    """One launch of `wrapper`'s kernel; float32 launches also count in
    `wrapper.f32_launches`."""
    wrapper.launches += 1
    if dtype == torch.float32:
        wrapper.f32_launches += 1


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if code != 0:
        msg = lib.rt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on `t`'s device, as an integer handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
