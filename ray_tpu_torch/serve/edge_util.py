"""Shared completion plumbing for the Serve edges (HTTP + gRPC).

Both edges run a dedicated asyncio loop thread and resolve request
lifecycles through the ownership layer's callbacks — object completion via
`add_done_callback`, stream items via `add_dynamic_return_callback` — so
no thread is ever parked per in-flight request or live stream. This module
is the single home for that plumbing; the edges stay thin."""

from __future__ import annotations

import asyncio
from typing import Any, Optional


def typed_error_kind(e: BaseException) -> Optional[str]:
    """Classify a serve-plane error for edge status mapping: "timeout"
    (end-to-end deadline spent), "shed" (admission control), or
    "route_not_found" (app ingress); None for everything else. One home
    for the isinstance-plus-type-name check — the NAME fallback matters
    because an error deserialized from a replica process must map the
    same as the live class."""
    from ray_tpu_torch.core.exceptions import (BackPressureError,
                                               GetTimeoutError,
                                               RequestTimeoutError)

    name = type(e).__name__
    if (isinstance(e, (RequestTimeoutError, GetTimeoutError,
                       asyncio.TimeoutError))
            or name in ("RequestTimeoutError", "GetTimeoutError")):
        return "timeout"
    if isinstance(e, BackPressureError) or name == "BackPressureError":
        return "shed"
    try:
        from ray_tpu_torch.serve.ingress import RouteNotFound

        if isinstance(e, RouteNotFound) or name == "RouteNotFound":
            return "route_not_found"
    except ImportError:
        pass
    return None


async def await_ref(loop, ref, timeout: float) -> None:
    """Resolve when the ownership layer reports `ref` terminal."""
    from ray_tpu_torch.core.api import _global_worker

    fut = loop.create_future()

    def done() -> None:
        try:
            loop.call_soon_threadsafe(
                lambda: fut.done() or fut.set_result(None))
        except RuntimeError:
            pass  # loop already stopped

    _global_worker().add_done_callback(ref, done)
    await asyncio.wait_for(fut, timeout=timeout)


async def await_next_stream_item(loop, gen, timeout: float) -> None:
    """Resolve when the generator's next item (or terminal state) is
    reported — `next(gen)` is then guaranteed non-blocking."""
    from ray_tpu_torch.core import worker as _worker_mod

    fut = loop.create_future()

    def ready() -> None:
        try:
            loop.call_soon_threadsafe(
                lambda: fut.done() or fut.set_result(None))
        except RuntimeError:
            pass

    _worker_mod.current_worker().add_dynamic_return_callback(
        gen._task_id, gen._i, ready)
    await asyncio.wait_for(fut, timeout=timeout)


async def fetch_value(loop, pool, ref, timeout: float) -> Any:
    """Fetch a terminal object's value: inline results resolve on the
    loop; plasma results (a blocking pull) hop to the pool."""
    import ray_tpu_torch
    from ray_tpu_torch.core.api import _global_worker

    out, ok = _global_worker().try_get_local(ref)
    if not ok:
        out = await loop.run_in_executor(
            pool, lambda: ray_tpu_torch.get(ref, timeout=timeout))
    return out
