"""ctypes binding for the C++ shared-memory arena (core/csrc/arena.cpp, the
port's copy of ray_tpu's src/arena/arena.cpp).

Builds the shared library on demand with g++ (cached by source hash under
build/torch_runtime/); callers fall back to the file-per-object store path
when the toolchain is unavailable.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from typing import Optional

logger = logging.getLogger(__name__)

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(os.path.dirname(_HERE))
_SRC = os.path.join(_HERE, "csrc", "arena.cpp")
# the port's own directory: no name here can clash with ray_tpu's build/
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_runtime")

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
            so_path = os.path.join(_BUILD_DIR, f"libtt_arena-{digest}.so")
            if not os.path.exists(so_path):
                os.makedirs(_BUILD_DIR, exist_ok=True)
                tmp = so_path + f".tmp{os.getpid()}"
                subprocess.run(
                    ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, _SRC, "-lpthread"],
                    check=True, capture_output=True)
                os.replace(tmp, so_path)
            lib = ctypes.CDLL(so_path)
            lib.arena_create.restype = ctypes.c_void_p
            lib.arena_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
            lib.arena_attach.restype = ctypes.c_void_p
            lib.arena_attach.argtypes = [ctypes.c_char_p]
            lib.arena_alloc.restype = ctypes.c_uint64
            lib.arena_alloc.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
            lib.arena_free.restype = ctypes.c_int
            lib.arena_free.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
            lib.arena_used.restype = ctypes.c_uint64
            lib.arena_used.argtypes = [ctypes.c_void_p]
            lib.arena_capacity.restype = ctypes.c_uint64
            lib.arena_capacity.argtypes = [ctypes.c_void_p]
            lib.arena_base.restype = ctypes.c_void_p
            lib.arena_base.argtypes = [ctypes.c_void_p]
            lib.arena_close.argtypes = [ctypes.c_void_p]
            _lib = lib
        except Exception:
            logger.warning("arena C++ library unavailable; falling back to "
                           "file-per-object store", exc_info=True)
            _lib_failed = True
        return _lib


NIL = (1 << 64) - 1


class Arena:
    """One shared-memory arena (create in the store daemon, attach anywhere)."""

    def __init__(self, lib, handle, path: str):
        self._lib = lib
        self._handle = handle
        self.path = path
        base = lib.arena_base(handle)
        cap = lib.arena_capacity(handle)
        self._view = memoryview(
            (ctypes.c_ubyte * cap).from_address(base)).cast("B")

    @classmethod
    def create(cls, path: str, capacity: int) -> Optional["Arena"]:
        lib = _load_lib()
        if lib is None:
            return None
        handle = lib.arena_create(path.encode(), capacity)
        if not handle:
            return None
        return cls(lib, handle, path)

    @classmethod
    def attach(cls, path: str) -> Optional["Arena"]:
        lib = _load_lib()
        if lib is None:
            return None
        handle = lib.arena_attach(path.encode())
        if not handle:
            return None
        return cls(lib, handle, path)

    def alloc(self, size: int) -> Optional[int]:
        off = self._lib.arena_alloc(self._handle, size)
        return None if off == NIL else off

    def free(self, offset: int) -> bool:
        return self._lib.arena_free(self._handle, offset) == 0

    def view(self, offset: int, size: int) -> memoryview:
        return self._view[offset:offset + size]

    @property
    def used(self) -> int:
        return self._lib.arena_used(self._handle)

    @property
    def capacity(self) -> int:
        return self._lib.arena_capacity(self._handle)

    def close(self) -> None:
        try:
            self._view.release()
        except Exception:
            pass
        self._lib.arena_close(self._handle)

    def unlink(self) -> None:
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


# per-process cache of attached arenas (consumers)
_attached: dict = {}
_attached_lock = threading.Lock()


def attached_arena(path: str) -> Optional[Arena]:
    with _attached_lock:
        a = _attached.get(path)
        if a is None:
            a = Arena.attach(path)
            if a is not None:
                _attached[path] = a
        return a
