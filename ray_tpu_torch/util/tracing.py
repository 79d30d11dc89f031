"""Built-in timeline: chrome://tracing events + distributed trace context.

Equivalent of the reference's profile-event timeline
(`src/ray/core_worker/profile_event.h` -> `ray.timeline()`,
`python/ray/_private/state.py:851 chrome_tracing_dump:435`): lightweight
in-process event recording, dumped as chrome trace JSON.

Two properties make multi-process merges meaningful:

- **Epoch anchor.** Timestamps are wall-epoch MICROSECONDS, derived as
  `_epoch_us + (perf_counter() - _t0)`: one `(time.time(), perf_counter())`
  pair captured at import anchors the monotonic clock to the epoch, so
  spans are monotone within a process AND directly comparable across
  processes on one host. Cross-NODE skew is corrected at merge time from
  per-source clock offsets (task_events.py estimates them NTP-style from
  an RPC round-trip to the GCS).

- **Bounded ring.** The in-process buffer is capped
  (`tracing_max_buffer_size`, mirroring `task_events_max_buffer_size`):
  overflow drops the OLDEST spans and counts them; `drain()` hands the
  dropped count to the TaskEventBuffer so it rides the next flush and the
  GCS-side truncation accounting stays honest.

Trace context (the distributed half, gated on `tracing_enabled`): a
thread-local `(trace_id, parent_span_id)` pair. `span()` records both ids
plus its own fresh span_id on the event and re-parents nested spans under
itself; `ctx_scope()` adopts a context that crossed a process boundary
(TaskSpec.trace_ctx), making driver submit -> raylet lease -> worker
execute -> result delivery one causal tree under a single trace_id.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Deque, List, Optional, Tuple

_events: Deque[dict] = deque()
_lock = threading.Lock()
# epoch anchor: one wall/monotonic pair per process. perf_counter gives
# monotonicity (time.time() can step under NTP slew); the epoch term makes
# the absolute values line up across processes.
_t0 = time.perf_counter()
_epoch_us = time.time() * 1e6
_dropped = 0          # ring overflow since the last drain()
_total = 0            # events ever appended (drain cursors index into this)
# observers called with each completed span dict — the OpenTelemetry
# bridge (util/otel.py) and the worker's GCS profile-event shipper hook in
# here (reference: opt-in OTel spans + TaskEventBuffer profile events)
_span_hooks: List = []

_tls = threading.local()


def add_span_hook(fn) -> None:
    with _lock:
        if fn not in _span_hooks:
            _span_hooks.append(fn)


def remove_span_hook(fn) -> None:
    with _lock:
        if fn in _span_hooks:
            _span_hooks.remove(fn)


def _now_us() -> float:
    return _epoch_us + (time.perf_counter() - _t0) * 1e6


def now_us() -> float:
    """Epoch-anchored wall microseconds, monotone within this process."""
    return _now_us()


# --------------------------------------------------------------- trace ctx
def enabled() -> bool:
    """Whether distributed trace-context propagation is on (default off:
    local spans still record, but no ids are minted or shipped on specs)."""
    from ray_tpu_torch.core.config import get_config

    return get_config().tracing_enabled


def new_id() -> str:
    return os.urandom(8).hex()


def current_ctx() -> Optional[Tuple[str, str]]:
    """The thread's (trace_id, parent_span_id) or None outside a trace."""
    return getattr(_tls, "ctx", None)


def set_ctx(ctx: Optional[Tuple[str, str]]) -> None:
    _tls.ctx = tuple(ctx) if ctx else None


def start_trace() -> Tuple[str, str]:
    """Begin a new trace on this thread; returns (trace_id, "") — the empty
    parent marks subsequent spans as roots of the tree."""
    ctx = (new_id(), "")
    _tls.ctx = ctx
    return ctx


@contextmanager
def ctx_scope(ctx: Optional[Tuple[str, str]]):
    """Adopt a context that crossed a process/thread boundary (a
    TaskSpec.trace_ctx, a router request's captured ctx) for the duration
    of the block. None is a no-op so call sites need no conditional."""
    if not ctx:
        yield
        return
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = tuple(ctx)
    try:
        yield
    finally:
        _tls.ctx = prev


def _append(event: dict) -> None:
    """Caller must NOT hold _lock. Ring-bounded append + hook fanout."""
    global _dropped, _total
    from ray_tpu_torch.core.config import get_config

    limit = max(1, get_config().tracing_max_buffer_size)
    with _lock:
        _events.append(event)
        _total += 1
        while len(_events) > limit:
            _events.popleft()
            _dropped += 1
        # hooks observe completed SPANS only (the OTel bridge reads "dur")
        hooks = list(_span_hooks) if event.get("ph") == "X" else ()
    for h in hooks:
        try:
            h(event)
        except Exception:  # user hook: never let tracing kill the task
            pass


@contextmanager
def span(name: str, category: str = "task", **args):
    start = _now_us()
    ctx = getattr(_tls, "ctx", None)
    sid = prev = None
    if ctx is not None:
        sid = new_id()
        prev = ctx
        _tls.ctx = (ctx[0], sid)  # nested spans parent under this one
    try:
        yield
    finally:
        end = _now_us()
        if sid is not None:
            _tls.ctx = prev
        event = {
            "name": name, "cat": category, "ph": "X",
            "ts": start, "dur": end - start,
            "pid": os.getpid(), "tid": threading.get_ident() % 100000,
            "args": args,
        }
        if sid is not None:
            event["trace_id"] = ctx[0]
            event["span_id"] = sid
            event["parent_id"] = ctx[1]
        _append(event)


def add_complete(name: str, category: str, start_us: float, dur_us: float,
                 trace_id: Optional[str] = None,
                 span_id: Optional[str] = None,
                 parent_id: Optional[str] = None, **args) -> None:
    """Record a complete ("X") span with explicit timing/ids — for call
    sites that measure a window themselves (raylet queue wait, dispatch
    latency, serve ingress) rather than wrapping a block."""
    event = {
        "name": name, "cat": category, "ph": "X",
        "ts": start_us, "dur": max(0.0, dur_us),
        "pid": os.getpid(), "tid": threading.get_ident() % 100000,
        "args": args,
    }
    if trace_id:
        event["trace_id"] = trace_id
        event["span_id"] = span_id or new_id()
        event["parent_id"] = parent_id or ""
    _append(event)


def instant(name: str, category: str = "event", **args) -> None:
    _append({
        "name": name, "cat": category, "ph": "i", "ts": _now_us(),
        "pid": os.getpid(), "tid": threading.get_ident() % 100000,
        "s": "p", "args": args,
    })


def get_events() -> List[dict]:
    with _lock:
        return list(_events)


def drain(cursor: int) -> Tuple[List[dict], int, int]:
    """Events appended since `cursor` (a running sequence number), the new
    cursor, and how many of them overflowed the ring before this drain
    could ship them (NOT the raw eviction count — already-drained spans
    falling off the left edge are not a loss). The shipping path
    (TaskEventBuffer) uses this instead of list slicing so a ring overflow
    between flushes can never silently skew the window. A cursor from
    before a clear() (cursor > total) resyncs to the start."""
    global _dropped
    with _lock:
        if cursor > _total:
            cursor = 0  # clear() ran; resync
        start_seq = _total - len(_events)
        skipped = max(0, start_seq - cursor)
        fresh = list(_events)[max(0, cursor - start_seq):]
        _dropped = 0
        return fresh, _total, skipped


def recent_events(window_s: float) -> List[dict]:
    """Spans whose END falls within the last `window_s` seconds — the
    flight-recorder slice dumped next to a failed storm artifact."""
    floor = _now_us() - window_s * 1e6
    with _lock:
        return [e for e in _events
                if e.get("ts", 0) + e.get("dur", 0) >= floor]


def dump(path: str, extra_events: Optional[List[dict]] = None) -> None:
    events = get_events() + list(extra_events or [])
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)


def clear() -> None:
    global _dropped, _total
    with _lock:
        _events.clear()
        _dropped = 0
        _total = 0
