"""User-facing metrics: Counter / Gauge / Histogram + Prometheus text export.

Mirrors `ray.util.metrics` (reference `python/ray/util/metrics.py`) and the
Prometheus export path (reference metrics_agent -> scrape endpoint); here a
process-local registry renders the standard text exposition format, served
by the dashboard (`ray_tpu_torch.dashboard`).
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

# RLock: get_or_create holds it across lookup+construction (the Metric ctor
# re-enters it to self-register), so two threads can never race to register
# the same name and split increments across duplicate instances.
_registry_lock = threading.RLock()
_registry: List["Metric"] = []


class Metric:
    def __init__(self, name: str, description: str = "",
                 tag_keys: Sequence[str] = ()):
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys)
        self._default_tags: Dict[str, str] = {}
        self._values: Dict[Tuple, float] = {}
        # per-source series merged in from other processes (see
        # merge_snapshot); combined with local values at export time
        self._remote: Dict[str, Dict[str, Any]] = {}
        self._lock = threading.Lock()
        with _registry_lock:
            _registry.append(self)

    def _combined_values(self) -> Dict[Tuple, float]:
        """Local + remote series: counters sum per tag key, gauges take the
        remote value when present (the remote process owns that series)."""
        out = dict(self._values)
        additive = getattr(self, "kind", "") == "counter"
        for entry in self._remote.values():
            for k, v in entry.get("values", {}).items():
                if additive:
                    out[k] = out.get(k, 0.0) + v
                else:
                    out[k] = v
        return out

    def set_default_tags(self, tags: Dict[str, str]):
        self._default_tags = dict(tags)
        return self

    def _key(self, tags: Optional[Dict[str, str]]) -> Tuple:
        merged = dict(self._default_tags)
        if tags:
            merged.update(tags)
        return tuple(sorted(merged.items()))

    def _fmt_labels(self, key: Tuple) -> str:
        if not key:
            return ""
        inner = ",".join(f'{k}="{v}"' for k, v in key)
        return "{" + inner + "}"


class Counter(Metric):
    kind = "counter"

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        with self._lock:
            k = self._key(tags)
            self._values[k] = self._values.get(k, 0.0) + value


class Gauge(Metric):
    kind = "gauge"

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        with self._lock:
            self._values[self._key(tags)] = value


class Histogram(Metric):
    kind = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Sequence[float] = (0.01, 0.1, 1, 10, 100),
                 tag_keys: Sequence[str] = ()):
        super().__init__(name, description, tag_keys)
        self.boundaries = sorted(boundaries)
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}
        self._totals: Dict[Tuple, int] = {}

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        with self._lock:
            k = self._key(tags)
            counts = self._counts.setdefault(k, [0] * (len(self.boundaries) + 1))
            for i, b in enumerate(self.boundaries):
                if value <= b:
                    counts[i] += 1
                    break
            else:
                counts[-1] += 1
            self._sums[k] = self._sums.get(k, 0.0) + value
            self._totals[k] = self._totals.get(k, 0) + 1


def export_prometheus() -> str:
    """Render all registered metrics in Prometheus text format."""
    lines: List[str] = []
    with _registry_lock:
        metrics = list(_registry)
    for m in metrics:
        lines.append(f"# HELP {m.name} {m.description}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        if isinstance(m, Histogram):
            with m._lock:
                # combine local + merged remote series additively per tag key
                counts_by_k = {k: list(v) for k, v in m._counts.items()}
                sums = dict(m._sums)
                totals = dict(m._totals)
                for entry in m._remote.values():
                    for k, v in entry.get("counts", {}).items():
                        cur = counts_by_k.setdefault(
                            k, [0] * (len(m.boundaries) + 1))
                        for i, c in enumerate(v):
                            cur[i] += c
                    for k, v in entry.get("sums", {}).items():
                        sums[k] = sums.get(k, 0.0) + v
                    for k, v in entry.get("totals", {}).items():
                        totals[k] = totals.get(k, 0) + v
            for k, counts in counts_by_k.items():
                cum = 0
                for i, b in enumerate(m.boundaries):
                    cum += counts[i]
                    labels = dict(k)
                    labels["le"] = str(b)
                    inner = ",".join(f'{kk}="{vv}"' for kk, vv in sorted(labels.items()))
                    lines.append(f"{m.name}_bucket{{{inner}}} {cum}")
                cum += counts[-1]
                labels = dict(k)
                labels["le"] = "+Inf"
                inner = ",".join(f'{kk}="{vv}"' for kk, vv in sorted(labels.items()))
                lines.append(f"{m.name}_bucket{{{inner}}} {cum}")
                lines.append(f"{m.name}_sum{m._fmt_labels(k)} {sums.get(k, 0.0)}")
                lines.append(f"{m.name}_count{m._fmt_labels(k)} {totals.get(k, 0)}")
        else:
            with m._lock:
                combined = m._combined_values()
            for k, v in combined.items():
                lines.append(f"{m.name}{m._fmt_labels(k)} {v}")
    return "\n".join(lines) + "\n"


def get_or_create(kind: str, name: str, description: str = "",
                  **kwargs) -> Metric:
    """Get the registered metric `name`, creating it on first use — the
    one lazy-singleton helper for framework-internal metrics."""
    cls = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}[kind]
    with _registry_lock:
        for m in _registry:
            if m.name == name:
                return m
        return cls(name, description, **kwargs)


def snapshot(prefix: str = "") -> Dict[str, Dict[str, Any]]:
    """Serializable dump of this process's metrics (optionally filtered by
    name prefix) for shipping to another process's registry."""
    with _registry_lock:
        metrics = [m for m in _registry if m.name.startswith(prefix)]
    out: Dict[str, Dict[str, Any]] = {}
    for m in metrics:
        with m._lock:
            entry: Dict[str, Any] = {
                "kind": m.kind, "description": m.description,
                "tag_keys": m.tag_keys, "values": dict(m._values),
            }
            if isinstance(m, Histogram):
                entry["boundaries"] = list(m.boundaries)
                entry["counts"] = {k: list(v) for k, v in m._counts.items()}
                entry["sums"] = dict(m._sums)
                entry["totals"] = dict(m._totals)
            out[m.name] = entry
    return out


def merge_snapshot(snap: Dict[str, Dict[str, Any]], source: str = "remote") -> None:
    """Install another process's snapshot into this registry under `source`.

    Remote series are kept SEPARATE from local values and re-installed
    wholesale on every merge (idempotent per scrape); export combines them
    — additively for counters/histograms, remote-wins for gauges. This way
    mixed traffic (e.g. driver-side handle calls + HTTP-proxy requests)
    reports the sum instead of the proxy clobbering local counts."""
    for name, entry in snap.items():
        kwargs = {"tag_keys": entry.get("tag_keys", ())}
        if entry["kind"] == "histogram":
            kwargs["boundaries"] = entry.get(
                "boundaries", (0.01, 0.1, 1, 10, 100))
        m = get_or_create(entry["kind"], name,
                          entry.get("description", ""), **kwargs)
        with m._lock:
            m._remote[source] = entry
