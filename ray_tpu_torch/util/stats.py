"""Tiny shared statistics helpers (no numpy dependency on hot paths)."""

from __future__ import annotations

from typing import List, Optional


def percentile(sorted_vals: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile of an ALREADY-SORTED list; None when empty.
    Shared by the serve storm harness and the worker pool's fork-latency
    stats — one index formula, one rounding behavior."""
    if not sorted_vals:
        return None
    idx = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[idx]
