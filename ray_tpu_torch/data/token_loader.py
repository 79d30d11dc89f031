"""ctypes binding for the native token-batch loader (data/csrc/).

The LM-training input path: a C++ prefetch pool streams [batch, seq+1]
int32 windows out of a memory-mapped token file, so host IO overlaps device
compute (the role the reference's native object plane + datasource stack
plays for its training jobs). Falls back to a numpy implementation when the
toolchain is unavailable.

The source is the port's own copy of the reference's `src/loader/`, built
with g++ at first use into `build/torch_loader/libtt_loader-<hash>.so`.
`native()` says whether that library is the one in use (every loader
then runs on it), so a caller can refuse the fallback.
In "sequential" mode the batches are deterministic only with
`n_threads=1`: several prefetch threads take the epoch's windows row by
row and queue their batches as they finish them.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Iterator, Optional

import numpy as np

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(os.path.dirname(_HERE))
_SRC = os.path.join(_HERE, "csrc", "token_loader.cpp")
# the port's own directory: no name here can clash with ray_tpu's build/
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_loader")

_lib = None
_lib_lock = threading.Lock()
_lib_failed = False


def _load_lib():
    global _lib, _lib_failed
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            with open(_SRC, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()[:16]
            so_path = os.path.join(_BUILD_DIR, f"libtt_loader-{digest}.so")
            if not os.path.exists(so_path):
                os.makedirs(_BUILD_DIR, exist_ok=True)
                tmp = so_path + f".tmp{os.getpid()}"
                subprocess.run(
                    ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC,
                     "-lpthread"],
                    check=True, capture_output=True)
                os.replace(tmp, so_path)
            lib = ctypes.CDLL(so_path)
            lib.loader_open.restype = ctypes.c_void_p
            lib.loader_open.argtypes = [
                ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_uint64, ctypes.c_int]
            lib.loader_next.restype = ctypes.c_int
            lib.loader_next.argtypes = [ctypes.c_void_p,
                                        ctypes.POINTER(ctypes.c_int32)]
            lib.loader_num_tokens.restype = ctypes.c_uint64
            lib.loader_num_tokens.argtypes = [ctypes.c_void_p]
            lib.loader_batches_per_epoch.restype = ctypes.c_uint64
            lib.loader_batches_per_epoch.argtypes = [ctypes.c_void_p]
            lib.loader_close.argtypes = [ctypes.c_void_p]
            _lib = lib
        except Exception:
            logger.warning("native loader unavailable; using numpy fallback",
                           exc_info=True)
            _lib_failed = True
        return _lib


def native() -> bool:
    """Whether the native library is the one in use (it is built and
    loaded at the first call)."""
    return _load_lib() is not None


class TokenLoader:
    """Streams [batch, seq_len+1] int32 batches from a flat token file.

    mode="random": uniform windows (infinite). mode="sequential": per-epoch
    shuffled disjoint windows. Split a batch row into inputs/targets with
    `batch[:, :-1]` / `batch[:, 1:]` (or feed as {"tokens": batch}).
    """

    def __init__(self, path: str, *, batch: int, seq_len: int,
                 n_threads: int = 2, seed: int = 0, mode: str = "random"):
        assert mode in ("random", "sequential"), mode
        self.path = path
        self.batch = batch
        self.seq_len = seq_len
        self.mode = mode
        self._handle = None
        self._fallback: Optional[np.ndarray] = None
        self._rng = np.random.default_rng(seed)
        self._seed = seed
        self._cursor = 0     # fallback sequential position
        self._order: Optional[np.ndarray] = None
        lib = _load_lib()
        if lib is not None:
            self._handle = lib.loader_open(
                path.encode(), batch, seq_len, n_threads, seed,
                1 if mode == "sequential" else 0)
            if not self._handle:
                raise FileNotFoundError(
                    f"{path}: unreadable or smaller than one window")
            import weakref

            self._finalizer = weakref.finalize(
                self, lib.loader_close, self._handle)
        else:
            self._fallback = np.fromfile(path, dtype=np.int32)
            if len(self._fallback) < seq_len + 1:
                raise FileNotFoundError(
                    f"{path}: unreadable or smaller than one window")
        self._out = np.empty((batch, seq_len + 1), np.int32)

    @property
    def num_tokens(self) -> int:
        if self._handle:
            return _lib.loader_num_tokens(self._handle)
        return len(self._fallback)

    @property
    def batches_per_epoch(self) -> int:
        if self._handle:
            return _lib.loader_batches_per_epoch(self._handle)
        return (len(self._fallback) // (self.seq_len + 1)) // self.batch

    def next(self) -> np.ndarray:
        """Next [batch, seq_len+1] batch (a copy owned by the caller)."""
        if self._handle:
            rc = _lib.loader_next(
                self._handle,
                self._out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            if rc != 0:
                raise RuntimeError("loader stopped")
            return self._out.copy()
        w = self.seq_len + 1
        if self.mode == "sequential":
            n = len(self._fallback) // w
            starts = []
            for _ in range(self.batch):
                epoch, i = divmod(self._cursor, n)
                if self._order is None or i == 0:
                    self._order = np.random.default_rng(
                        self._seed + epoch).permutation(n)
                starts.append(self._order[i] * w)
                self._cursor += 1
        else:
            starts = self._rng.integers(0, len(self._fallback) - w + 1,
                                        self.batch)
        return np.stack([self._fallback[s:s + w] for s in starts])

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            yield self.next()

    def close(self) -> None:
        if self._handle:
            self._finalizer.detach()
            _lib.loader_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
