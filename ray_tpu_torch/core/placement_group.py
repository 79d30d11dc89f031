"""Placement group API.

Mirrors the reference's `python/ray/util/placement_group.py:33,136` with the
four strategies (STRICT_PACK/PACK/SPREAD/STRICT_SPREAD) plus a GPU
helper: `nvlink_domain_placement_group` reserves one NVLink domain's worth
of hosts (STRICT_PACK over nodes sharing an `nvlink_domain` label) so NCCL
collectives over the group ride NVLink.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Optional

from ray_tpu_torch.core.ids import PlacementGroupID


@dataclass
class PlacementGroup:
    id: PlacementGroupID
    bundles: List[Dict[str, float]]
    strategy: str
    name: Optional[str] = None

    def ready(self, timeout: float = 30.0) -> bool:
        from ray_tpu_torch.core.api import _global_worker

        w = _global_worker()
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            info = w.gcs.call("get_placement_group", {"pg_id": self.id})
            if info and info["state"] == "CREATED":
                return True
            if info and info["state"] == "INFEASIBLE":
                # terminal: a replacement head resumed this group's
                # interrupted creation and could not satisfy it — polling
                # longer will never help
                return False
            time.sleep(0.05)
        return False

    def ready_or_raise(self, timeout: float = 30.0) -> "PlacementGroup":
        """`ready()` that surfaces terminal infeasibility as the typed
        `PlacementInfeasibleError` (matched BY TYPE by elastic shrink and
        chaos tests) instead of an indistinguishable False/hang."""
        from ray_tpu_torch.core.api import _global_worker
        from ray_tpu_torch.core.exceptions import PlacementInfeasibleError

        w = _global_worker()
        deadline = time.monotonic() + timeout
        info = None
        while time.monotonic() < deadline:
            info = w.gcs.call("get_placement_group", {"pg_id": self.id})
            if info and info["state"] == "CREATED":
                return self
            if info and info["state"] in ("INFEASIBLE", "PENDING"):
                raise PlacementInfeasibleError(
                    f"placement group {self.id.hex()[:8]} infeasible: "
                    f"{info.get('error', 'no feasible placement')}")
            time.sleep(0.05)
        raise PlacementInfeasibleError(
            f"placement group {self.id.hex()[:8]} not created within "
            f"{timeout}s (state: {info['state'] if info else 'unknown'})")

    @property
    def bundle_count(self) -> int:
        return len(self.bundles)

    def bundle_node_ids(self) -> Optional[List[bytes]]:
        from ray_tpu_torch.core.api import _global_worker

        info = _global_worker().gcs.call("get_placement_group", {"pg_id": self.id})
        return info.get("placement") if info else None


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: Optional[str] = None,
) -> PlacementGroup:
    from ray_tpu_torch.core.api import _global_worker

    if strategy not in ("PACK", "STRICT_PACK", "SPREAD", "STRICT_SPREAD"):
        raise ValueError(f"invalid strategy {strategy}")
    w = _global_worker()
    pg_id = PlacementGroupID.from_random()
    w.gcs.call("create_placement_group", {
        "pg_id": pg_id, "bundles": bundles, "strategy": strategy, "name": name})
    return PlacementGroup(pg_id, bundles, strategy, name)


def remove_placement_group(pg: PlacementGroup) -> None:
    from ray_tpu_torch.core.api import _global_worker

    _global_worker().gcs.call("remove_placement_group", {"pg_id": pg.id})


def placement_group_table(pg: Optional[PlacementGroup] = None) -> Dict:
    """Debug table of one/all placement groups (reference
    `python/ray/util/placement_group.py:248`)."""
    from ray_tpu_torch.core.api import _global_worker

    w = _global_worker()
    if pg is not None:
        info = w.gcs.call("get_placement_group", {"pg_id": pg.id})
        return {pg.id.hex(): info} if info else {}
    infos = w.gcs.call("list_placement_groups", {}) or []
    return {i["pg_id"].hex() if hasattr(i["pg_id"], "hex") else str(i["pg_id"]): i
            for i in infos}


def get_current_placement_group() -> Optional[PlacementGroup]:
    """The PG the current task/actor is scheduled into, if any (reference
    `python/ray/util/placement_group.py:296`)."""
    from ray_tpu_torch.core.api import get_runtime_context

    try:
        ctx = get_runtime_context()
    except Exception:
        return None
    pg_id = getattr(ctx, "placement_group_id", None)
    if pg_id is None:
        return None
    from ray_tpu_torch.core.api import _global_worker

    info = _global_worker().gcs.call("get_placement_group", {"pg_id": pg_id})
    if not info:
        return None
    return PlacementGroup(pg_id, info.get("bundles", []),
                          info.get("strategy", "PACK"), info.get("name"))


def nvlink_domain_placement_group(
    num_hosts: int,
    gpus_per_host: Optional[int] = None,
    extra_resources: Optional[Dict[str, float]] = None,
) -> PlacementGroup:
    """Reserve `num_hosts` hosts of one NVLink domain (one GPU bundle per
    host)."""
    from ray_tpu_torch.core.config import get_config

    gpus = gpus_per_host or get_config().gpus_per_host
    bundle = {"GPU": float(gpus), **(extra_resources or {})}
    return placement_group([dict(bundle) for _ in range(num_hosts)], strategy="STRICT_PACK")
