"""Shared helpers for the hand-written CUDA kernels (twin of
ray_tpu/ops/pallas/_util.py): size arithmetic, the device check every entry
point runs, and the nvcc build step.

Kernels live in ``csrc/<name>.cu`` with a plain C interface. `build`
compiles each source with nvcc into
``build/torch_kernels/lib<name>-<hash>.so`` at the repository root, where the
hash covers the source text and the compiler flags, so an edit rebuilds and
an unchanged tree reuses the library. A build writes to a temporary file and
renames it into place, so concurrent builds never load a half-written
library. Libraries are loaded with ctypes; every C entry point returns
``cudaGetLastError()`` after its launch and ``check`` raises on non-zero.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

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


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error for its launch."""
    if code != 0:
        msg = lib.rt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on `t`'s device, as an integer handle."""
    return torch.cuda.current_stream(t.device).cuda_stream
