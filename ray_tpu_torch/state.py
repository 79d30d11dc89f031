"""State observability API: list cluster entities.

Mirrors the reference's state API surface
(`python/ray/experimental/state/api.py:115` — `ray list actors/tasks/
nodes/...` and `ray summary`), backed by the GCS tables and the task-event
buffer instead of a separate aggregator service.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ray_tpu_torch.core.api import _global_worker


def list_nodes() -> List[Dict[str, Any]]:
    w = _global_worker()
    out = []
    for n in w.gcs.call("get_all_nodes"):
        out.append({
            "node_id": n["node_id"].hex(),
            "address": n["address"],
            "alive": n["alive"],
            "resources_total": n["resources_total"],
            "resources_available": n["resources_available"],
            "labels": n.get("labels", {}),
        })
    return out


def list_actors() -> List[Dict[str, Any]]:
    w = _global_worker()
    out = []
    for a in w.gcs.call("list_actors"):
        out.append({
            "actor_id": a["actor_id"].hex(),
            "class_name": a.get("class_name", ""),
            "name": a.get("name"),
            "state": a["state"],
            "address": a.get("address", ""),
            "num_restarts": a.get("num_restarts", 0),
        })
    return out


def list_tasks(limit: int = 1000) -> List[Dict[str, Any]]:
    w = _global_worker()
    out = []
    for t in w.gcs.call("list_task_events", {"limit": limit}):
        if "__truncated__" in t:
            # history window overflowed: surface it instead of presenting a
            # silently-complete-looking listing (weak spot flagged in review)
            out.append({"task_id": "", "name": "(truncated)",
                        "type": "META", "state":
                        f"+{t['__truncated__']} older tasks evicted",
                        "node_id": ""})
            continue
        out.append({
            "task_id": t["task_id"].hex(),
            "name": t.get("name", ""),
            "type": t.get("type", ""),
            "state": t.get("state", ""),
            "node_id": t.get("node_id", b"").hex() if t.get("node_id") else "",
        })
    return out


def list_placement_groups() -> List[Dict[str, Any]]:
    w = _global_worker()
    out = []
    for p in w.gcs.call("list_placement_groups"):
        out.append({
            "placement_group_id": p["pg_id"].hex(),
            "state": p["state"],
            "strategy": p["strategy"],
            "bundles": p["bundles"],
            "name": p.get("name"),
        })
    return out


def list_jobs() -> List[Dict[str, Any]]:
    w = _global_worker()
    out = []
    for j in w.gcs.call("get_jobs"):
        out.append({
            "job_id": j["job_id"].hex(),
            "status": j.get("status"),
            "start_time": j.get("start_time"),
        })
    return out


def summarize_tasks() -> Dict[str, int]:
    counts: Dict[str, int] = {}
    for t in list_tasks():
        key = f"{t['name']}:{t['state']}"
        counts[key] = counts.get(key, 0) + 1
    return counts
