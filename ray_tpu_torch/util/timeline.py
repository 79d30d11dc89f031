"""Fleet-merged chrome traces: offset alignment, merge, and validation.

The raw material is the span stream every process ships through the
`task_events_batch` channel (util/tracing.py -> core/task_events.py ->
gcs.py): epoch-anchored microsecond stamps tagged with a `_src` (worker or
node hex id) and, per source, an NTP-style clock offset estimated against
the GCS clock. This module is the merge half:

- `apply_offsets` rebases every span onto the GCS clock
  (`ts + offset[src]`), so one chrome timeline lines up across nodes;
- `merge_chrome` produces the chrome://tracing document
  (`{"traceEvents": [...]}`, "X" events with ts/dur in microseconds —
  extra keys like trace_id/span_id ride along, chrome ignores them);
- `validate_chrome` / `validate_chains` are the CI-facing checks: a
  structurally valid document, and per-trace parent links that all
  resolve (every span's parent_id names a span in the same trace, at
  least one root) — the "complete correctly-parented chain" assertion
  the traced storm makes per accepted request;
- `stage_segments` slices one task's spans into the critical-path stages
  (submit -> lease -> dispatch -> execution -> result-deliver) for the
  `ray_tpu_torch trace <task_id>` CLI.
"""

from __future__ import annotations

import json
import math
from typing import Dict, Iterable, List, Optional, Tuple

# critical-path stage order for one task (categories stamped by
# worker.py / raylet.py); serve/rl categories hang off the same tree but
# are not per-task stages
STAGE_ORDER = ("task_submit", "task_lease", "task_dispatch",
               "task_execution", "task_result")


def apply_offsets(spans: Iterable[dict],
                  offsets: Dict[str, float]) -> List[dict]:
    """Rebase spans onto the GCS clock: `offset = gcs_clock - src_clock`
    (the sign task_events.py's probe produces), so aligned ts = ts +
    offset. Sources without an estimate (same process as the GCS, or a
    probe that never completed) pass through unshifted. Returns copies."""
    out = []
    for s in spans:
        off = offsets.get(s.get("_src", ""), 0.0)
        if off:
            s = {**s, "ts": s.get("ts", 0.0) + off}
        else:
            s = dict(s)
        out.append(s)
    return out


def merge_chrome(spans: Iterable[dict],
                 offsets: Optional[Dict[str, float]] = None) -> dict:
    """One chrome-trace document from many sources' spans, clock-aligned
    and time-sorted. Drops nothing: non-span phases ("i" instants) merge
    too, chrome renders them as markers."""
    aligned = apply_offsets(spans, offsets or {})
    aligned.sort(key=lambda e: (e.get("ts", 0.0),
                                e.get("pid", 0), e.get("tid", 0)))
    return {"traceEvents": aligned}


def validate_chrome(doc: dict) -> List[str]:
    """Structural problems with a chrome-trace document (empty list =
    valid): JSON-serializable, a traceEvents list, every event carrying
    name/ph/ts/pid/tid with finite stamps, "X" events with non-negative
    dur, and ts non-decreasing in document order (merge_chrome sorts, so
    a violation means the merge or an offset went wrong)."""
    problems: List[str] = []
    try:
        doc = json.loads(json.dumps(doc))
    except (TypeError, ValueError) as e:
        return [f"not JSON-serializable: {e}"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    last_ts = -math.inf
    for i, e in enumerate(events):
        for k in ("name", "ph", "ts", "pid", "tid"):
            if k not in e:
                problems.append(f"event {i} missing {k!r}")
                break
        else:
            ts = e["ts"]
            if not isinstance(ts, (int, float)) or not math.isfinite(ts):
                problems.append(f"event {i} non-finite ts {ts!r}")
                continue
            if e["ph"] == "X":
                dur = e.get("dur")
                if (not isinstance(dur, (int, float))
                        or not math.isfinite(dur) or dur < 0):
                    problems.append(f"event {i} bad dur {dur!r}")
            if ts < last_ts:
                problems.append(
                    f"event {i} ts regresses ({ts} < {last_ts})")
            last_ts = ts
        if len(problems) >= 20:
            problems.append("... (truncated)")
            break
    return problems


def group_by_trace(spans: Iterable[dict]) -> Dict[str, List[dict]]:
    traces: Dict[str, List[dict]] = {}
    for s in spans:
        tid = s.get("trace_id")
        if tid:
            traces.setdefault(tid, []).append(s)
    return traces


def validate_chain(spans: List[dict]) -> dict:
    """One trace's parent-link health: every non-empty parent_id must name
    a span_id IN the trace, ids must be unique, and at least one root
    (parent_id == "") must exist. `processes` counts distinct emitting
    processes (shipping source, falling back to pid) — the storm asserts
    chains span >=3 of them (driver/proxy, raylet, replica worker)."""
    ids = [s.get("span_id") for s in spans if s.get("span_id")]
    idset = set(ids)
    missing = sorted({s.get("parent_id") for s in spans
                      if s.get("parent_id") and
                      s.get("parent_id") not in idset})
    roots = sum(1 for s in spans if s.get("parent_id") == "")
    procs = {s.get("_src") or f"pid:{s.get('pid')}" for s in spans}
    return {
        "spans": len(spans),
        "roots": roots,
        "duplicate_ids": len(ids) - len(idset),
        "missing_parents": missing,
        "processes": len(procs),
        "complete": (len(spans) > 0 and roots >= 1 and not missing
                     and len(ids) == len(idset)),
    }


def validate_chains(spans: Iterable[dict],
                    trace_ids: Optional[Iterable[str]] = None
                    ) -> Dict[str, dict]:
    """validate_chain over every trace present (or the requested ids —
    an id with no spans at all reports as an empty, incomplete chain)."""
    traces = group_by_trace(spans)
    if trace_ids is None:
        keys = list(traces)
    else:
        keys = list(trace_ids)
    return {t: validate_chain(traces.get(t, [])) for t in keys}


def stage_segments(spans: Iterable[dict],
                   task_id: str) -> List[Tuple[str, float, float]]:
    """The critical-path segments of ONE task: `(stage, start_us, dur_us)`
    in STAGE_ORDER for every stage span stamped with this task_id (args
    carry it). Retried tasks can own several spans per stage; all are
    returned, stage-ordered then time-ordered, so gaps between segments
    read as the queue/wire time between stages."""
    rank = {c: i for i, c in enumerate(STAGE_ORDER)}
    segs = []
    for s in spans:
        if s.get("cat") not in rank:
            continue
        if (s.get("args") or {}).get("task_id") != task_id:
            continue
        segs.append((s["cat"], float(s.get("ts", 0.0)),
                     float(s.get("dur", 0.0))))
    segs.sort(key=lambda t: (rank[t[0]], t[1]))
    return segs
