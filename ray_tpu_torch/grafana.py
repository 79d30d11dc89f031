"""Grafana dashboard factory: default cluster + user-metric dashboards.

Reference parity: dashboard/modules/metrics/grafana_dashboard_factory.py —
emits Grafana dashboard JSON whose panels query the Prometheus metrics the
framework exports (`ray_tpu_torch/dashboard.py` `/metrics`). `python -m
ray_tpu_torch metrics export-dashboards` (CLI) writes the JSON files a
Grafana provisioning dir can point at, by default under the ignored
`build/`.

The port's series are the reference's with `ray_tpu_torch_` for
`ray_tpu_`; the dashboards' uids, titles, tags and file names are the
port's own, so both packages' dashboards provision side by side.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, List, Optional

DEFAULT_OUT_DIR = str(Path(__file__).resolve().parents[1] / "build"
                      / "grafana_dashboards_torch")


def _panel(panel_id: int, title: str, exprs: List[str], *,
           unit: str = "short", x: int = 0, y: int = 0,
           w: int = 12, h: int = 8) -> Dict[str, Any]:
    return {
        "id": panel_id,
        "title": title,
        "type": "timeseries",
        "gridPos": {"x": x, "y": y, "w": w, "h": h},
        "fieldConfig": {"defaults": {"unit": unit}},
        "targets": [
            {"expr": expr, "refId": chr(ord("A") + i), "legendFormat": ""}
            for i, expr in enumerate(exprs)
        ],
        "datasource": {"type": "prometheus", "uid": "${datasource}"},
    }


def _dashboard(uid: str, title: str,
               panels: List[Dict[str, Any]]) -> Dict[str, Any]:
    return {
        "uid": uid,
        "title": title,
        "tags": ["ray_tpu_torch"],
        "timezone": "browser",
        "refresh": "10s",
        "schemaVersion": 38,
        "templating": {"list": [{
            "name": "datasource", "type": "datasource",
            "query": "prometheus", "label": "Data source",
        }]},
        "panels": panels,
        "time": {"from": "now-30m", "to": "now"},
    }


def generate_default_dashboard() -> Dict[str, Any]:
    """Core-runtime dashboard: tasks, actors, objects, nodes, scheduler."""
    rows = [
        ("Tasks finished",
         ["rate(ray_tpu_torch_tasks_finished_total[1m])"], "ops"),
        ("Tasks pending", ["ray_tpu_torch_tasks_pending"], "short"),
        ("Actors alive", ["ray_tpu_torch_actors_alive"], "short"),
        ("Nodes alive", ["ray_tpu_torch_nodes_alive"], "short"),
        ("Object store used bytes",
         ["ray_tpu_torch_object_store_used_bytes",
          "ray_tpu_torch_object_store_capacity_bytes"], "bytes"),
        ("Objects spilled to disk",
         ["ray_tpu_torch_object_store_spilled_objects"], "short"),
    ]
    panels = []
    for i, (title, exprs, unit) in enumerate(rows):
        panels.append(_panel(i + 1, title, exprs, unit=unit,
                             x=(i % 2) * 12, y=(i // 2) * 8))
    return _dashboard("ray-tpu-torch-core", "ray_tpu_torch core", panels)


def generate_train_dashboard() -> Dict[str, Any]:
    """Training dashboard: throughput, loss, checkpointing, mesh health."""
    rows = [
        ("Train tokens/s", ["ray_tpu_torch_train_tokens_per_sec"],
         "short"),
        ("Train loss", ["ray_tpu_torch_train_loss"], "short"),
        ("Step time", ["ray_tpu_torch_train_step_seconds"], "s"),
        ("MFU", ["ray_tpu_torch_train_mfu"], "percentunit"),
        ("Checkpoint save seconds",
         ["ray_tpu_torch_checkpoint_save_seconds"], "s"),
        ("Trials running", ["ray_tpu_torch_tune_trials_running"],
         "short"),
    ]
    panels = []
    for i, (title, exprs, unit) in enumerate(rows):
        panels.append(_panel(i + 1, title, exprs, unit=unit,
                             x=(i % 2) * 12, y=(i // 2) * 8))
    return _dashboard("ray-tpu-torch-train", "ray_tpu_torch train", panels)


def generate_serve_dashboard() -> Dict[str, Any]:
    """Serving dashboard: QPS, latency, queue depth, replicas."""
    rows = [
        ("Requests/s", ["rate(ray_tpu_torch_serve_requests_total[1m])"],
         "reqps"),
        ("Errors/s", ["rate(ray_tpu_torch_serve_errors_total[1m])"],
         "reqps"),
        ("Latency p50/p99", [
            "histogram_quantile(0.5, "
            "rate(ray_tpu_torch_serve_latency_seconds_bucket[1m]))",
            "histogram_quantile(0.99, "
            "rate(ray_tpu_torch_serve_latency_seconds_bucket[1m]))",
        ], "s"),
        ("Replica queue depth", ["ray_tpu_torch_serve_queue_depth"],
         "short"),
        ("Replicas per deployment", ["ray_tpu_torch_serve_replicas"],
         "short"),
    ]
    panels = []
    for i, (title, exprs, unit) in enumerate(rows):
        panels.append(_panel(i + 1, title, exprs, unit=unit,
                             x=(i % 2) * 12, y=(i // 2) * 8))
    return _dashboard("ray-tpu-torch-serve", "ray_tpu_torch serve", panels)


_FACTORIES = {
    "core": generate_default_dashboard,
    "train": generate_train_dashboard,
    "serve": generate_serve_dashboard,
}


def export_dashboards(out_dir: str,
                      which: Optional[List[str]] = None) -> List[str]:
    """Write dashboard JSON files for Grafana provisioning; returns paths."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for name in which or sorted(_FACTORIES):
        path = os.path.join(out_dir, f"ray_tpu_torch_{name}.json")
        with open(path, "w") as f:
            json.dump(_FACTORIES[name](), f, indent=2)
        paths.append(path)
    return paths
