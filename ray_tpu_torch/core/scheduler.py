"""Scheduling policies: hybrid pack/spread, spread, affinity, PG bundles.

Equivalent of the reference's pluggable policies under
`src/ray/raylet/scheduling/policy/` — notably the hybrid policy
(`hybrid_scheduling_policy.cc:48-170`): score = critical-resource
utilization, truncated to 0 below `scheduler_spread_threshold` (0.5), so
work packs onto the preferred node until half-utilized, then spreads to the
least-utilized feasible node. Bundle placement mirrors
`bundle_scheduling_policy.cc` (STRICT_PACK/PACK/SPREAD/STRICT_SPREAD).

GPU extension: nodes carry an `nvlink_domain` label and `place_bundles`
supports domain-aware packing — a STRICT_PACK group of
GPU bundles lands on hosts of one NVLink domain (same `nvlink_domain`
label), which is the placement that lets NCCL collectives ride NVLink
instead of the network.
"""

from __future__ import annotations

import os
import random
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.task_spec import SchedulingStrategy

EPSILON = 1e-9
# hosts sharing this label form one NVLink domain (core/node.py)
NVLINK_DOMAIN_LABEL = "nvlink_domain"


@dataclass
class NodeView:
    node_id: bytes
    total: Dict[str, float]
    available: Dict[str, float]
    labels: Dict[str, str] = field(default_factory=dict)

    def is_feasible(self, demand: Dict[str, float]) -> bool:
        """Could this node *ever* run the demand (vs. total)?"""
        return all(self.total.get(r, 0.0) + EPSILON >= q for r, q in demand.items())

    def is_available(self, demand: Dict[str, float]) -> bool:
        return all(self.available.get(r, 0.0) + EPSILON >= q for r, q in demand.items())

    def utilization(self) -> float:
        """Critical-resource utilization (max over resources)."""
        util = 0.0
        for r, tot in self.total.items():
            if tot > 0:
                util = max(util, 1.0 - self.available.get(r, 0.0) / tot)
        return util


class SchedulingPolicy:
    """Scheduling decisions, natively accelerated when the C++ library
    builds (core/native_scheduler.py); the Python paths below remain the
    executable spec and the fallback."""

    def __init__(self):
        self._native = None
        self._native_lock = threading.Lock()
        if os.environ.get("RAY_TPU_TORCH_NATIVE_SCHEDULER", "1") != "0":
            try:
                from ray_tpu_torch.core.native_scheduler import NativeScheduler

                self._native = NativeScheduler(
                    get_config().scheduler_spread_threshold)
            except Exception:
                self._native = None

    def _native_select(self, nodes: List[NodeView], demand: Dict[str, float],
                       strategy: str, prefer_node: Optional[bytes]):
        # One lock around sync+select: callers (raylet dispatch loop, GCS rpc
        # + health threads) share this policy, and the native node table is
        # stateful between the two calls.
        with self._native_lock:
            self._native.set_spread_threshold(
                get_config().scheduler_spread_threshold)
            self._native.sync_nodes(nodes)
            return self._native.select(demand, strategy, prefer_node)

    def select_node(
        self,
        nodes: List[NodeView],
        demand: Dict[str, float],
        strategy: Optional[SchedulingStrategy] = None,
        prefer_node: Optional[bytes] = None,
        pg_table: Optional[dict] = None,
    ) -> Optional[bytes]:
        strategy = strategy or SchedulingStrategy()

        # Placement-group targeting: run on the node holding the bundle.
        if strategy.placement_group_id is not None and pg_table is not None:
            pg = pg_table.get(strategy.placement_group_id)
            if not pg or not pg.get("placement"):
                return None
            idx = strategy.bundle_index if strategy.bundle_index >= 0 else 0
            if idx >= len(pg["placement"]):
                return None
            return pg["placement"][idx]

        if strategy.node_id is not None:
            for n in nodes:
                if n.node_id == strategy.node_id and (n.is_feasible(demand)):
                    return n.node_id
            if not strategy.soft:
                return None
            if self._native is not None:
                return self._native_select(nodes, demand, "HYBRID", prefer_node)
            return self._hybrid([n for n in nodes if n.is_feasible(demand)],
                                demand, prefer_node)

        if self._native is not None:
            native_strategy = "SPREAD" if strategy.name == "SPREAD" else "HYBRID"
            return self._native_select(nodes, demand, native_strategy,
                                       prefer_node)

        feasible = [n for n in nodes if n.is_feasible(demand)]
        if not feasible:
            return None

        if strategy.name == "SPREAD":
            avail = [n for n in feasible if n.is_available(demand)] or feasible
            return min(avail, key=lambda n: (n.utilization(), n.node_id)).node_id

        return self._hybrid(feasible, demand, prefer_node)

    def _hybrid(self, feasible: List[NodeView], demand: Dict[str, float],
                prefer_node: Optional[bytes]) -> Optional[bytes]:
        if not feasible:
            return None
        threshold = get_config().scheduler_spread_threshold

        def score(n: NodeView):
            util = n.utilization()
            truncated = 0.0 if util < threshold else util
            # Prefer nodes that can run it *now*; among them the preferred
            # (usually local) node wins ties, mirroring the reference's
            # top-k-with-local-preference ordering.
            unavailable = 0 if n.is_available(demand) else 1
            not_preferred = 0 if n.node_id == prefer_node else 1
            return (unavailable, truncated, not_preferred, n.node_id)

        return min(feasible, key=score).node_id

    # ---------------------------------------------------------- PG bundles
    def place_bundles(
        self,
        nodes: List[NodeView],
        bundles: List[Dict[str, float]],
        strategy: str,
    ) -> Optional[List[bytes]]:
        """Return a node id per bundle, or None if infeasible."""
        if strategy not in ("STRICT_PACK", "PACK", "STRICT_SPREAD", "SPREAD"):
            raise ValueError(f"unknown placement strategy {strategy}")
        if self._native is not None:
            try:
                with self._native_lock:
                    self._native.sync_nodes(nodes)
                    return self._native.place_bundles(bundles, strategy)
            except RuntimeError:
                pass  # e.g. output-buffer overflow on huge placements
        if strategy in ("STRICT_PACK", "PACK"):
            return self._pack(nodes, bundles, strict=(strategy == "STRICT_PACK"))
        return self._spread(nodes, bundles, strict=(strategy == "STRICT_SPREAD"))

    def _pack(self, nodes: List[NodeView], bundles, strict: bool) -> Optional[List[bytes]]:
        # NVLink-domain awareness: try to satisfy all bundles within one
        # domain's hosts first (same nvlink_domain label), then any single
        # node (strict), then first-fit-decreasing across nodes (non-strict).
        slices: Dict[str, List[NodeView]] = {}
        for n in nodes:
            s = n.labels.get(NVLINK_DOMAIN_LABEL)
            if s:
                slices.setdefault(s, []).append(n)
        candidate_groups = list(slices.values())
        if strict:
            candidate_groups = [[n] for n in nodes] + candidate_groups
        else:
            candidate_groups = candidate_groups + [nodes]
        for group in candidate_groups:
            placement = self._first_fit(group, bundles)
            if placement is not None:
                return placement
        return None if strict else self._first_fit(nodes, bundles)

    def _spread(self, nodes: List[NodeView], bundles, strict: bool) -> Optional[List[bytes]]:
        remaining = {n.node_id: dict(n.available) for n in nodes}
        order = sorted(nodes, key=lambda n: (n.utilization(), n.node_id))
        placement: List[bytes] = []
        used: set = set()
        for b in bundles:
            chosen = None
            for n in order:
                if strict and n.node_id in used:
                    continue
                if all(remaining[n.node_id].get(r, 0.0) + EPSILON >= q for r, q in b.items()):
                    chosen = n.node_id
                    break
            if chosen is None:
                if strict:
                    return None
                # fall back to any feasible node
                for n in order:
                    if all(remaining[n.node_id].get(r, 0.0) + EPSILON >= q for r, q in b.items()):
                        chosen = n.node_id
                        break
                if chosen is None:
                    return None
            for r, q in b.items():
                remaining[chosen][r] = remaining[chosen].get(r, 0.0) - q
            used.add(chosen)
            placement.append(chosen)
            # re-sort so spreading stays balanced
            order = sorted(order, key=lambda n: (1.0 - min(
                (remaining[n.node_id].get(r, 0.0) / t if t else 1.0)
                for r, t in (n.total.items() if n.total else [("CPU", 1.0)])), n.node_id))
        return placement

    @staticmethod
    def _first_fit(group: List[NodeView], bundles) -> Optional[List[bytes]]:
        remaining = {n.node_id: dict(n.available) for n in group}
        placement: List[bytes] = []
        for b in bundles:
            chosen = None
            for n in group:
                if all(remaining[n.node_id].get(r, 0.0) + EPSILON >= q for r, q in b.items()):
                    chosen = n.node_id
                    break
            if chosen is None:
                return None
            for r, q in b.items():
                remaining[chosen][r] = remaining[chosen].get(r, 0.0) - q
            placement.append(chosen)
        return placement
