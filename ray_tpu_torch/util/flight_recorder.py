"""Storm flight recorder: the last N seconds of spans + a metrics snapshot,
dumped NEXT TO a failing storm artifact.

A storm that trips a violation (or hangs long enough for the faulthandler
watchdog) today leaves an artifact full of AGGREGATES — percentiles and
counters that say *that* it went wrong, not *what was happening*. The
flight record is the missing context: every span whose end falls inside
`tracing_flight_recorder_window_s` (the tracing ring is always recording,
even with distributed propagation off) plus the full process-local metrics
snapshot, written as `<artifact>.flightrec.json` so the two files travel
together into CI artifacts.

Best-effort by construction: a failing dump must never mask the violation
that triggered it — every error is swallowed into the logger and the
caller just gets None.
"""

from __future__ import annotations

import json
import logging
import os
from typing import Any, List, Optional

logger = logging.getLogger(__name__)


def _key(k: Any) -> str:
    if isinstance(k, tuple):
        return ",".join(map(str, k))
    return k if isinstance(k, str) else str(k)


def _json_safe(obj: Any) -> Any:
    """Metrics snapshots key series by TAG-VALUE TUPLES — stringify those
    (and anything else JSON rejects) without losing the tag values."""
    if isinstance(obj, dict):
        return {_key(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    return repr(obj)


def flight_record_path(artifact_path: str) -> str:
    return artifact_path + ".flightrec.json"


def dump_flight_record(artifact_path: str,
                       violations: Optional[List[str]] = None,
                       window_s: Optional[float] = None,
                       reason: str = "violations") -> Optional[str]:
    """Write `<artifact>.flightrec.json`; returns the path or None on any
    failure. `reason` distinguishes a violation dump from a watchdog one."""
    from ray_tpu_torch.core.config import get_config
    from ray_tpu_torch.util import metrics, tracing

    try:
        if window_s is None:
            window_s = get_config().tracing_flight_recorder_window_s
        path = flight_record_path(artifact_path)
        record = {
            "reason": reason,
            "violations": list(violations or []),
            "window_s": window_s,
            "pid": os.getpid(),
            "anchor_us": tracing.now_us(),
            "spans": _json_safe(tracing.recent_events(window_s)),
            "metrics": _json_safe(metrics.snapshot()),
        }
        with open(path, "w") as f:
            json.dump(record, f, indent=2, default=repr)
        logger.warning("flight record written to %s (%d spans, %s)",
                       path, len(record["spans"]), reason)
        return path
    except Exception:
        logger.warning("flight record dump failed", exc_info=True)
        return None
