"""Worker-side batched task-event + profile-span shipping.

Equivalent of the reference's TaskEventBuffer
(`src/ray/core_worker/task_event_buffer.h`): task lifecycle transitions
(SUBMITTED/RUNNING/FINISHED/FAILED) and chrome-trace spans coalesce in the
emitting process and flush to the GCS as ONE `task_events_batch` notify per
`task_events_report_interval_ms` (and at shutdown), instead of one RPC per
transition plus a profile flush after every execution. A driver submitting
N tasks therefore issues O(elapsed/interval) control-plane RPCs, not O(N).

The buffer is bounded (`task_events_max_buffer_size`): overflow drops the
OLDEST events and counts them, and the dropped count rides the next flush so
the GCS-side truncation counter stays honest (mirroring the eviction
counter the GCS ring already keeps, gcs.py)."""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Optional

from ray_tpu_torch.core.config import get_config

logger = logging.getLogger(__name__)


class TaskEventBuffer:
    def __init__(self, worker):
        self._worker = worker
        self._lock = threading.Lock()
        self._events: deque = deque()
        self._dropped = 0
        # drain cursor into the tracing ring (sequence number, not a list
        # index — survives ring overflow between flushes)
        self._profile_sent = 0
        # spans the tracing ring dropped but whose count failed delivery —
        # re-shipped with the next flush so truncation stays honest
        self._spans_dropped_pending = 0
        # NTP-style clock offset vs the GCS (tracing_enabled only):
        # offset_us = t1 - (t0 + t2) / 2 from one clock_probe round-trip,
        # re-estimated every tracing_clock_probe_period_s and shipped with
        # each flush for merge-time cross-node alignment
        self._clock_offset_us: Optional[float] = None
        self._clock_probe_at = 0.0
        self._thread: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self._stopped = False
        self.flush_count = 0  # instrumentation for tests

    def record(self, spec, state: str) -> None:
        """Buffer one task-state transition (same payload the per-event
        notify used to carry). Starts the flush timer lazily so processes
        that never emit events never spawn the thread."""
        w = self._worker
        ev = {
            "task_id": spec.task_id.binary(),
            "name": spec.method_name,
            "type": spec.task_type.name,
            "state": state,
            "job_id": spec.job_id.binary(),
            "node_id": w.node_id,
            "worker_id": w.worker_id.binary(),
        }
        start = None
        with self._lock:
            self._events.append(ev)
            limit = max(1, get_config().task_events_max_buffer_size)
            while len(self._events) > limit:
                self._events.popleft()
                self._dropped += 1
            if self._thread is None and not self._stopped:
                start = threading.Thread(target=self._loop,
                                         name="task-events", daemon=True)
                self._thread = start
        if start is not None:
            start.start()

    def _loop(self) -> None:
        while not self._stopped and not self._worker._shutdown.is_set():
            self._wake.wait(get_config().task_events_report_interval_ms / 1000.0)
            self._wake.clear()
            try:
                self.flush()
            except Exception:
                logger.debug("task event flush failed", exc_info=True)

    def _probe_clock(self) -> None:
        """One clock_probe round-trip against the GCS: the midpoint of the
        local send/recv stamps estimates when t1 was read remotely, so
        offset = t1 - (t0 + t2) / 2 (classic NTP). Best-effort — a down
        link just leaves the previous estimate in place."""
        import time as _time

        try:
            t0 = _time.time() * 1e6
            reply = self._worker.gcs.call("clock_probe", timeout=2)
            t2 = _time.time() * 1e6
            self._clock_offset_us = reply["t1_us"] - (t0 + t2) / 2.0
        except Exception:
            logger.debug("clock probe failed", exc_info=True)

    def flush(self) -> None:
        """Ship everything buffered (task events, dropped count, and any
        tracing spans recorded since the last flush) in one GCS notify."""
        import time as _time

        from ray_tpu_torch.core.config import get_config as _get_config
        from ray_tpu_torch.util import tracing

        with self._lock:
            events = list(self._events)
            self._events.clear()
            dropped, self._dropped = self._dropped, 0
            fresh, self._profile_sent, spans_dropped = tracing.drain(
                self._profile_sent)
            spans_dropped += self._spans_dropped_pending
            self._spans_dropped_pending = 0
        if not events and not fresh and not dropped and not spans_dropped:
            return
        src = self._worker.worker_id.binary().hex()
        payload = {
            "events": events,
            "dropped": dropped,
            "src": src,
            "spans_dropped": spans_dropped,
            "profile_events": [{**e, "_src": src} for e in fresh],
        }
        if tracing.enabled():
            now = _time.monotonic()
            if (self._clock_offset_us is None or now >= self._clock_probe_at):
                self._clock_probe_at = now + max(
                    1.0, _get_config().tracing_clock_probe_period_s)
                self._probe_clock()
            if self._clock_offset_us is not None:
                payload["clock_offset_us"] = self._clock_offset_us
        # try_notify reports a down link (plain notify swallows it); fakes
        # and raw clients in tests surface failure by raising instead
        gcs = self._worker.gcs
        sender = getattr(gcs, "try_notify", None)
        try:
            delivered = (sender("task_events_batch", payload)
                         if sender is not None
                         else (gcs.notify("task_events_batch", payload), True)[1])
        except Exception:
            delivered = False
        if delivered:
            self.flush_count += 1
            return
        # Task events go back for the next tick (a GCS-restart window must
        # not silently lose lifecycle history); spans are best-effort, as
        # they were under per-execution flushing — but their DROP COUNT is
        # not (it's the only record those spans existed), so it re-rides.
        with self._lock:
            self._events.extendleft(reversed(events))
            self._dropped += dropped
            self._spans_dropped_pending += spans_dropped
            limit = max(1, get_config().task_events_max_buffer_size)
            while len(self._events) > limit:
                self._events.popleft()
                self._dropped += 1
        logger.debug("task event batch notify not delivered (GCS link down)")

    def stop(self) -> None:
        """Final flush at shutdown (the at-exit half of the batching
        contract: nothing buffered may be lost to a clean exit)."""
        self._stopped = True
        self._wake.set()
        try:
            self.flush()
        except Exception:
            logger.debug("final task event flush failed", exc_info=True)
