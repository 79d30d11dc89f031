"""Trailing-edge debouncer for fire-and-forget control-plane notifies.

One shared implementation for the completion-path rate limits (raylet
resource reports, GCS resource broadcasts): `fn` runs at most once per
period, a call landing inside the quiet window arms ONE timer that fires
`fn` at the window's edge — so a burst coalesces but the final post-burst
state always goes out — and `force=True` bypasses the debounce entirely
(topology changes must never wait)."""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

logger = logging.getLogger(__name__)


class Debouncer:
    def __init__(self, fn: Callable[[], None],
                 period_fn: Callable[[], float],
                 skip_deferred: Optional[Callable[[], bool]] = None):
        """`period_fn` is re-read per call so config changes apply live;
        `skip_deferred` (e.g. shutdown-flag check) drops a timer fire whose
        process is already exiting."""
        self._fn = fn
        self._period_fn = period_fn
        self._skip_deferred = skip_deferred
        self._lock = threading.Lock()
        self._last = 0.0
        self._pending = False

    def __call__(self, force: bool = False) -> None:
        now = time.monotonic()
        if force:
            with self._lock:
                self._last = now
            self._fn()
            return
        period = self._period_fn()
        with self._lock:
            if now - self._last < period:
                if not self._pending:
                    self._pending = True
                    t = threading.Timer(self._last + period - now, self._fire)
                    t.daemon = True
                    t.start()
                return
            self._last = now
        self._fn()

    def _fire(self) -> None:
        with self._lock:
            self._pending = False
            self._last = time.monotonic()
        if self._skip_deferred is not None and self._skip_deferred():
            return
        try:
            self._fn()
        except Exception:
            logger.debug("deferred debounced call failed", exc_info=True)
