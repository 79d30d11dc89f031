"""ctypes binding for the native cluster scheduler
(core/csrc/cluster_scheduler.cpp, the port's copy of ray_tpu's
src/scheduler/cluster_scheduler.cpp).

Mirrors the reference's C++ scheduling stack
(src/ray/raylet/scheduling/cluster_resource_scheduler.cc,
policy/hybrid_scheduling_policy.cc, policy/bundle_scheduling_policy.cc):
the hot select/place decisions run in native code with fixed-point
resource math; `ray_tpu_torch.core.scheduler.SchedulingPolicy` delegates here
when the library is available and falls back to the pure-Python spec
otherwise.

Built on demand with g++ (cached by source hash under build/torch_runtime/),
same pattern as core/arena.py.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, List, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_REPO_ROOT = os.path.dirname(os.path.dirname(_HERE))
_SRC = os.path.join(_HERE, "csrc", "cluster_scheduler.cpp")
# the port's own directory: no name here can clash with ray_tpu's build/
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "torch_runtime")

_lib = None
_lib_lock = threading.Lock()
_lib_failed = False

_OUT_CAP = 1 << 16


def _load_lib():
    global _lib, _lib_failed
    with _lib_lock:
        if _lib is not None or _lib_failed:
            return _lib
        try:
            with open(_SRC, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()[:16]
            so_path = os.path.join(_BUILD_DIR, f"libtt_sched-{digest}.so")
            if not os.path.exists(so_path):
                os.makedirs(_BUILD_DIR, exist_ok=True)
                tmp = so_path + f".tmp{os.getpid()}"
                subprocess.run(
                    ["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                     "-o", tmp, _SRC],
                    check=True, capture_output=True)
                os.replace(tmp, so_path)
            lib = ctypes.CDLL(so_path)
            lib.sched_create.restype = ctypes.c_void_p
            lib.sched_create.argtypes = [ctypes.c_double]
            lib.sched_destroy.argtypes = [ctypes.c_void_p]
            lib.sched_clear.argtypes = [ctypes.c_void_p]
            lib.sched_set_threshold.argtypes = [
                ctypes.c_void_p, ctypes.c_double]
            lib.sched_upsert_node.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_char_p, ctypes.c_char_p]
            lib.sched_remove_node.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
            lib.sched_select.restype = ctypes.c_int
            lib.sched_select.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int]
            lib.sched_place_bundles.restype = ctypes.c_int
            lib.sched_place_bundles.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
                ctypes.c_char_p, ctypes.c_int]
            lib.sched_num_nodes.restype = ctypes.c_int
            lib.sched_num_nodes.argtypes = [ctypes.c_void_p]
            _lib = lib
        except Exception:
            _lib_failed = True
            _lib = None
        return _lib


def available() -> bool:
    return _load_lib() is not None


def _fmt_resources(res: Dict[str, float]) -> bytes:
    return ";".join(f"{k}={float(v)!r}" for k, v in res.items()).encode()


def _fmt_labels(labels: Dict[str, str]) -> bytes:
    return ";".join(f"{k}={v}" for k, v in (labels or {}).items()).encode()


class NativeScheduler:
    """Owns one native scheduler instance; callers sync node views then
    ask for select/place decisions."""

    def __init__(self, spread_threshold: float = 0.5):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError("native scheduler library unavailable")
        self._lib = lib
        self._handle = lib.sched_create(ctypes.c_double(spread_threshold))
        self._out = ctypes.create_string_buffer(_OUT_CAP)
        self._threshold = spread_threshold
        # last-synced wire view per node id; sync_nodes diffs against this so
        # steady-state decisions only re-parse nodes whose view changed
        self._view: Dict[bytes, tuple] = {}

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.sched_destroy(self._handle)
                self._handle = None
        except Exception:
            pass

    def set_spread_threshold(self, threshold: float) -> None:
        if threshold != self._threshold:
            self._lib.sched_set_threshold(
                self._handle, ctypes.c_double(threshold))
            self._threshold = threshold

    def sync_nodes(self, nodes) -> None:
        """Replace the full node view (list of core.scheduler.NodeView),
        upserting only nodes whose serialized view changed since the last
        sync and removing vanished ones."""
        seen = {}
        for n in nodes:
            wire = (_fmt_resources(n.total), _fmt_resources(n.available),
                    _fmt_labels(getattr(n, "labels", None)))
            seen[n.node_id] = wire
            if self._view.get(n.node_id) != wire:
                self._lib.sched_upsert_node(
                    self._handle, n.node_id.hex().encode(), *wire)
        for node_id in list(self._view):
            if node_id not in seen:
                self._lib.sched_remove_node(self._handle,
                                            node_id.hex().encode())
        self._view = seen

    def upsert_node(self, node_id: bytes, total: Dict[str, float],
                    available_res: Dict[str, float],
                    labels: Optional[Dict[str, str]] = None) -> None:
        self._lib.sched_upsert_node(
            self._handle, node_id.hex().encode(), _fmt_resources(total),
            _fmt_resources(available_res), _fmt_labels(labels or {}))

    def remove_node(self, node_id: bytes) -> None:
        self._lib.sched_remove_node(self._handle, node_id.hex().encode())

    def select(self, demand: Dict[str, float], strategy: str = "HYBRID",
               prefer_node: Optional[bytes] = None) -> Optional[bytes]:
        n = self._lib.sched_select(
            self._handle, _fmt_resources(demand), strategy.encode(),
            (prefer_node.hex() if prefer_node else "").encode(),
            self._out, _OUT_CAP)
        if n < 0:
            raise RuntimeError("native scheduler output buffer overflow")
        if n == 0:
            return None
        return bytes.fromhex(self._out.value.decode())

    def place_bundles(self, bundles: List[Dict[str, float]],
                      strategy: str) -> Optional[List[bytes]]:
        wire = "|".join(
            ";".join(f"{k}={float(v)!r}" for k, v in b.items())
            for b in bundles).encode()
        n = self._lib.sched_place_bundles(
            self._handle, wire, strategy.encode(), self._out, _OUT_CAP)
        if n < 0:
            raise RuntimeError("native scheduler output buffer overflow")
        if n == 0:
            return None
        return [bytes.fromhex(p) for p in self._out.value.decode().split(";")]
