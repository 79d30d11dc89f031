"""On-demand, dependency-free CPU and memory profiling for live workers.

The reference dashboard launches py-spy / memray against a worker pid on
demand (`dashboard/modules/reporter/profile_manager.py`). Neither tool is
assumed here; the same capability is built from the runtime itself:

  * CPU: an in-process sampling profiler — a daemon thread walks
    ``sys._current_frames()`` every ``interval`` seconds for ``duration``
    seconds and aggregates collapsed stacks (the folded format flamegraph
    tooling eats directly, one ``func;func;func count`` line each).
  * Memory: a ``tracemalloc`` window — tracing is switched on for the
    duration, and the report is the top allocation sites of everything
    still live at the end of the window, plus RSS before/after.

Both run *inside* the target worker (triggered by a raylet push, results
written to a per-request file the raylet serves back), so no ptrace
capability or external binary is needed — which also makes this work in
containers where py-spy's process_vm_readv is blocked.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time
from typing import Any, Dict, Optional

PROFILE_DIR = os.path.join(tempfile.gettempdir(), "ray_tpu_torch", "profiles")


def sample_cpu(duration_s: float, interval_s: float = 0.01,
               max_stacks: int = 200) -> Dict[str, Any]:
    """Sample every thread's Python stack for duration_s; returns collapsed
    stacks sorted by sample count (the hottest first)."""
    me = threading.get_ident()
    counts: Dict[str, int] = {}
    n_samples = 0
    deadline = time.monotonic() + duration_s
    while time.monotonic() < deadline:
        for tid, frame in sys._current_frames().items():
            if tid == me:
                continue
            parts = []
            f = frame
            while f is not None:
                code = f.f_code
                parts.append(f"{code.co_name} ({code.co_filename}:{f.f_lineno})")
                f = f.f_back
            stack = ";".join(reversed(parts))
            counts[stack] = counts.get(stack, 0) + 1
        n_samples += 1
        time.sleep(interval_s)
    top = sorted(counts.items(), key=lambda kv: -kv[1])[:max_stacks]
    return {
        "kind": "cpu",
        "pid": os.getpid(),
        "duration_s": duration_s,
        "interval_s": interval_s,
        "n_samples": n_samples,
        "stacks": [{"stack": s, "count": c} for s, c in top],
    }


def _rss_bytes() -> Optional[int]:
    try:
        with open("/proc/self/statm") as fh:
            return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None


def sample_memory(duration_s: float, top_n: int = 50) -> Dict[str, Any]:
    """Trace allocations for duration_s; report the top sites still live at
    the end of the window (tracemalloc only sees allocations made while
    tracing, so this is the reference's memray "live window" analog, not a
    full-heap census)."""
    import tracemalloc

    owned = not tracemalloc.is_tracing()
    rss_before = _rss_bytes()
    if owned:
        tracemalloc.start(16)
    try:
        time.sleep(duration_s)
        snap = tracemalloc.take_snapshot()
    finally:
        if owned:
            tracemalloc.stop()
    stats = snap.statistics("traceback")[:top_n]
    return {
        "kind": "memory",
        "pid": os.getpid(),
        "duration_s": duration_s,
        "rss_before": rss_before,
        "rss_after": _rss_bytes(),
        "note": "allocations made during the window and still live at its end",
        "sites": [{
            "size_bytes": st.size,
            "count": st.count,
            "traceback": [str(line) for line in st.traceback.format()],
        } for st in stats],
    }


def run_profile_request(payload: Dict[str, Any]) -> None:
    """Entry point for the worker's "profile" push: profile THIS process in
    a background thread and drop the JSON where the raylet can serve it."""
    token = payload["token"]
    kind = payload.get("profile_kind", "cpu")
    duration = min(float(payload.get("duration_s", 5.0)), 120.0)

    def work():
        try:
            if kind == "memory":
                result = sample_memory(duration)
            else:
                result = sample_cpu(duration)
        except Exception as e:  # the result file must always appear
            result = {"kind": kind, "pid": os.getpid(),
                      "error": f"{type(e).__name__}: {e}"}
        os.makedirs(PROFILE_DIR, exist_ok=True)
        _sweep_stale()
        path = os.path.join(PROFILE_DIR, f"{token}.json")
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(result, fh)
        os.replace(tmp, path)  # atomic: pollers never see a partial file

    threading.Thread(target=work, name="profile-request", daemon=True).start()


def trigger_profile(gcs, pid, kind: str, duration_s: float):
    """Fan a profile_worker request out to every alive raylet; returns
    [(node_address, pid, token)]. Shared by the CLI and the dashboard —
    a node dying between the GCS listing and the connect is survived
    (its workers simply don't report)."""
    from ray_tpu_torch.core import rpc as _rpc

    started = []
    for n in gcs.call("get_all_nodes", timeout=10):
        if not n["alive"]:
            continue
        try:
            c = _rpc.connect_with_retry(n["address"], timeout=5)
        except ConnectionError:
            continue  # raced a node death; the alive list was stale
        try:
            out = c.call("profile_worker", {
                "pid": pid, "profile_kind": kind, "duration_s": duration_s})
        except (ConnectionError, OSError, TimeoutError):
            continue
        finally:
            c.close()
        for s in out.get("started", []):
            started.append((n["address"], s["pid"], s["token"]))
    return started


def poll_profile_results(pending, deadline_monotonic: float,
                         poll_interval_s: float = 1.0):
    """Collect finished profiles for [(addr, pid, token)] tuples until all
    report or the deadline passes; returns (reports, still_pending).
    A node dying mid-profile costs only its own reports."""
    from ray_tpu_torch.core import rpc as _rpc

    reports = []
    pending = list(pending)
    while pending and time.monotonic() < deadline_monotonic:
        time.sleep(poll_interval_s)
        still = []
        for addr, pid, token in pending:
            try:
                c = _rpc.connect_with_retry(addr, timeout=5)
            except ConnectionError:
                continue  # node died; drop its token
            try:
                r = c.call("profile_result", {"token": token})
            except (ConnectionError, OSError, TimeoutError):
                continue
            finally:
                c.close()
            if r.get("result") is None:
                still.append((addr, pid, token))
            else:
                reports.append(r["result"])
        pending = still
    return reports, pending


def _sweep_stale(max_age_s: float = 600.0) -> None:
    """Reclaim result files whose caller never collected them (timed out,
    crashed): without this, periodic dashboard profiling grows the dir
    one file per worker per request forever."""
    cutoff = time.time() - max_age_s
    try:
        names = os.listdir(PROFILE_DIR)
    except OSError:
        return
    for name in names:
        path = os.path.join(PROFILE_DIR, name)
        try:
            if os.path.getmtime(path) < cutoff:
                os.unlink(path)
        except OSError:
            pass  # concurrent sweep/read; someone else won


def read_profile_result(token: str) -> Optional[Dict[str, Any]]:
    """Raylet-side: the finished profile for token, or None while running.
    The file is deleted on a successful read — each token is collected
    exactly once."""
    if not token.replace("-", "").isalnum():  # tokens name files; no paths
        raise ValueError(f"bad profile token {token!r}")
    path = os.path.join(PROFILE_DIR, f"{token}.json")
    try:
        with open(path) as fh:
            result = json.load(fh)
    except FileNotFoundError:
        return None
    try:
        os.unlink(path)
    except OSError:
        pass
    return result
