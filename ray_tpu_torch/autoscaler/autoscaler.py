"""StandardAutoscaler: demand-driven node provisioning AND node-level
recovery.

Mirrors the reference's monitor loop (`python/ray/autoscaler/_private/
autoscaler.py:172,374` + `resource_demand_scheduler.py:101,169`): read
pending resource demands from the control plane, bin-pack them onto the
configured node types, launch what's missing through the NodeProvider, and
terminate nodes idle past the timeout.

The autoscaler is also the cluster's NODE-FAILURE control loop (reference
`autoscaler.py` terminate-and-replace of failed nodes): every tick it
reconciles its `_launched` set against BOTH the provider's
`non_terminated_nodes()` view (a preempted slice just vanishes) and the
GCS live-node view (the health loop marks a silent raylet dead). A dead
node is reaped at the provider (idempotent — it may already be gone) and
the capacity it held is relaunched to satisfy `min_workers` + standing
demand. Launch failures back off under full jitter with a per-node-type
circuit breaker, so a crashing provider throttles recovery instead of
hot-looping it; provider exceptions NEVER kill the update thread.

GPU-first: a node type's `resources` may include {"GPU": cards} and its
`labels` an `nvlink_domain`; a STRICT_PACK GPU demand therefore scales
whole NVLink domains (all hosts share the domain label), not individual
hosts.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import NodeProvider
from ray_tpu_torch.core import rpc
from ray_tpu_torch.util.backoff import ExponentialBackoff

logger = logging.getLogger(__name__)


@dataclass
class NodeType:
    name: str
    resources: Dict[str, float]
    min_workers: int = 0
    max_workers: int = 10
    labels: Dict[str, str] = field(default_factory=dict)


@dataclass
class _LaunchBreaker:
    """Per-node-type launch-failure state: consecutive failures drive a
    full-jitter backoff window during which launches of the type are
    skipped; at `threshold` failures the circuit counts as OPEN (observable
    in the report). One successful launch closes it."""

    failures: int = 0
    open_until: float = 0.0
    backoff: ExponentialBackoff = field(
        default_factory=lambda: ExponentialBackoff(base_s=0.5, cap_s=30.0))


def _node_metrics() -> dict:
    # one registration site for the node-failure metric family (names must
    # stay byte-identical across modules for get_or_create to share them)
    from ray_tpu_torch.core.gcs import _node_metrics as gcs_node_metrics

    return gcs_node_metrics()


class StandardAutoscaler:
    def __init__(self, gcs_address: str, provider: NodeProvider,
                 node_types: List[NodeType],
                 update_interval_s: float = 1.0,
                 idle_timeout_s: float = 60.0,
                 launch_failure_threshold: int = 3):
        # Reconnecting: the autoscaler must survive a GCS restart (its demand
        # polls would otherwise raise RpcDisconnected forever) — and follow
        # a REPLACEMENT/promoted head via the address file when configured
        # (a head failover must not orphan the node-recovery control loop).
        self.gcs = rpc.ReconnectingClient(
            gcs_address, resolve=rpc.read_gcs_address_file)
        self.provider = provider
        self.node_types = {t.name: t for t in node_types}
        self.update_interval_s = update_interval_s
        self.idle_timeout_s = idle_timeout_s
        self.launch_failure_threshold = max(1, launch_failure_threshold)
        self._launched: Dict[str, str] = {}      # provider id -> node type
        self._idle_since: Dict[str, float] = {}
        self._node_hex: Dict[str, str] = {}      # provider id -> cluster hexid
        self._breakers: Dict[str, _LaunchBreaker] = {}
        # --- reconcile counters (autoscaler_report -> gcs_stats) ---
        self._launches = 0
        self._relaunches = 0
        self._launch_failures = 0
        self._terminations = 0
        self._terminate_failures = 0
        self._deaths: Dict[str, int] = {}        # reason -> count
        # deaths whose replacement launch hasn't happened yet: the next
        # successful launches up to this count are RELAUNCHES
        self._replace_deficit = 0
        # guards the dicts stats() iterates (_deaths/_breakers/_launched)
        # against the update thread mutating them mid-copy
        self._stats_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- control
    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
        self.gcs.close()

    def _loop(self) -> None:
        while not self._stop.wait(self.update_interval_s):
            try:
                self.update()
            except Exception:
                # the loop survives ANYTHING — a flaky provider or a
                # reconnecting GCS throttles recovery, never stops it
                logger.exception("autoscaler update failed")

    def stats(self) -> dict:
        with self._stats_lock:
            return {
                "tracked_nodes": len(self._launched),
                "launches": self._launches,
                "relaunches": self._relaunches,
                "launch_failures": self._launch_failures,
                "terminations": self._terminations,
                "terminate_failures": self._terminate_failures,
                "deaths_by_reason": dict(self._deaths),
                "breakers": {
                    name: {"failures": b.failures,
                           "open": b.failures >= self.launch_failure_threshold
                           and time.monotonic() < b.open_until}
                    for name, b in self._breakers.items()},
            }

    # -------------------------------------------------------------- update
    def update(self) -> None:
        """One reconcile pass (reference StandardAutoscaler.update:374):
        reap-and-replace dead nodes first, then minimums, then demand."""
        try:
            demands: List[Dict[str, float]] = \
                self.gcs.call("get_pending_demands")
        except Exception:
            logger.warning("autoscaler demand poll failed (GCS "
                           "reconnecting?); reconciling without demand")
            demands = []
        try:
            view: dict = self.gcs.call("get_cluster_view")
        except Exception:
            view = {}

        self._reconcile_dead_nodes(view)

        # ensure minimums (replacements for reaped nodes land here/below)
        counts: Dict[str, int] = {}
        for t in self._launched.values():
            counts[t] = counts.get(t, 0) + 1
        for t in self.node_types.values():
            while counts.get(t.name, 0) < t.min_workers:
                if not self._launch(t):
                    break  # breaker open / provider down: next tick retries
                counts[t.name] = counts.get(t.name, 0) + 1

        # bin-pack unmet demand onto hypothetical nodes
        to_launch = self._nodes_to_launch(demands, view, counts)
        for type_name in to_launch:
            self._launch(self.node_types[type_name])

        self._terminate_idle(view)
        self._report()

    # ---------------------------------------------------- death reconcile
    def _hex_for(self, pid: str) -> Optional[str]:
        """Provider id -> cluster node hexid, when the provider can map it
        (the fake provider exposes its raylet; cloud providers rely on the
        vanished-from-provider signal instead).

        Known limitation: on GCE/Kube a raylet that dies while its VM/pod
        stays provider-listed (wedged host) is detected by the GCS but
        cannot be mapped back to a provider id here, so it is not
        terminate-and-replaced — preemption (the dominant cloud failure,
        which DOES vanish from the provider) is covered; wedged-host reap
        needs an id handshake (raylet labels carrying the provider id) and
        is future work."""
        cached = self._node_hex.get(pid)
        if cached is not None:
            return cached
        raylet = (self.provider.raylet_for(pid)
                  if hasattr(self.provider, "raylet_for") else None)
        if raylet is None:
            return None
        hexid = raylet.node_id.hex()
        self._node_hex[pid] = hexid
        return hexid

    def _reconcile_dead_nodes(self, view: dict) -> None:
        """Reap-and-replace: a launched node that VANISHED from the
        provider (preemption) or whose raylet the GCS marked dead (health
        loop) leaves `_launched`, is terminated at the provider
        (idempotent: it may already be gone — double reap is a no-op), and
        bumps the replace deficit so the minimum/demand passes below count
        their launches as relaunches."""
        try:
            live = set(self.provider.non_terminated_nodes())
        except Exception:
            logger.exception("non_terminated_nodes failed; skipping "
                             "provider-side reconcile this tick")
            live = None
        dead: List[tuple] = []
        for pid in list(self._launched):
            if live is not None and pid not in live:
                dead.append((pid, "vanished"))
                continue
            hexid = self._hex_for(pid)
            if hexid is not None:
                n = view.get(hexid)
                if n is not None and not n.get("alive", True):
                    dead.append((pid, "health_check"))
        for pid, reason in dead:
            with self._stats_lock:
                node_type = self._launched.pop(pid, None)
                self._idle_since.pop(pid, None)
                self._node_hex.pop(pid, None)
                self._deaths[reason] = self._deaths.get(reason, 0) + 1
                self._replace_deficit += 1
            logger.warning("autoscaler: node %s (%s) is dead (%s); reaping "
                           "and replacing", pid, node_type, reason)
            # ray_tpu_torch_node_deaths_total is counted ONCE, by the GCS: its
            # health loop detects every real death (a vanished node's
            # raylet stops heartbeating too) — incrementing here as well
            # would double-count each preemption. "vanished" stays in this
            # loop's own deaths_by_reason report.
            if reason != "vanished":
                self._terminate(pid)

    def _terminate(self, pid: str) -> None:
        try:
            self.provider.terminate_node(pid)
            self._terminations += 1
        except Exception:
            # termination is idempotent at the provider; a transient API
            # error here must not stall the reconcile loop — the node is
            # already out of `_launched`, a later vanish confirms the reap
            self._terminate_failures += 1
            logger.exception("terminate_node(%s) failed", pid)

    def _nodes_to_launch(self, demands, view, counts) -> List[str]:
        """First-fit-decreasing over available + hypothetical capacity
        (reference ResourceDemandScheduler.get_nodes_to_launch)."""
        # capacity pool: available resources on live nodes
        pools = [dict(n["available"]) for n in view.values() if n["alive"]]
        launches: List[str] = []

        def fits(pool, d):
            return all(pool.get(r, 0.0) + 1e-9 >= q for r, q in d.items())

        def charge(pool, d):
            for r, q in d.items():
                pool[r] = pool.get(r, 0.0) - q

        for demand in sorted(demands, key=lambda d: -sum(d.values())):
            placed = False
            for pool in pools:
                if fits(pool, demand):
                    charge(pool, demand)
                    placed = True
                    break
            if placed:
                continue
            # need a new node: pick the cheapest node type that fits
            for t in sorted(self.node_types.values(),
                            key=lambda t: sum(t.resources.values())):
                current = counts.get(t.name, 0) + launches.count(t.name)
                if current >= t.max_workers:
                    continue
                if fits(dict(t.resources), demand):
                    pool = dict(t.resources)
                    charge(pool, demand)
                    pools.append(pool)
                    launches.append(t.name)
                    placed = True
                    break
            if not placed:
                logger.warning("demand %s infeasible on all node types", demand)
        return launches

    def _launch(self, t: NodeType) -> bool:
        """Guarded launch: False when the type's breaker window is open or
        the provider failed (which arms/extends the window). A create_node
        exception can therefore never escape to the update thread — it
        becomes backoff state."""
        with self._stats_lock:
            br = self._breakers.setdefault(t.name, _LaunchBreaker())
        now = time.monotonic()
        if now < br.open_until:
            return False
        try:
            pid = self.provider.create_node(t.name, t.resources, t.labels)
        except Exception as e:
            br.failures += 1
            self._launch_failures += 1
            delay = br.backoff.next_delay()
            br.open_until = time.monotonic() + delay
            if br.failures >= self.launch_failure_threshold:
                logger.error(
                    "launch circuit for node type %s OPEN: %d consecutive "
                    "create_node failures (last: %s); next attempt in "
                    "%.2fs", t.name, br.failures, e, delay)
            else:
                logger.warning("create_node(%s) failed (%s); backing off "
                               "%.2fs", t.name, e, delay)
            return False
        br.failures = 0
        br.open_until = 0.0
        br.backoff.reset()
        with self._stats_lock:
            self._launched[pid] = t.name
            self._launches += 1
            relaunch = self._replace_deficit > 0
            if relaunch:
                self._replace_deficit -= 1
                self._relaunches += 1
        if relaunch:
            try:
                _node_metrics()["relaunches"].inc()
            except Exception:
                pass
            logger.info("autoscaler relaunched node type %s as %s "
                        "(replacing dead capacity)", t.name, pid)
        else:
            logger.info("autoscaler launching node type %s %s", t.name,
                        t.resources)
        return True

    def _terminate_idle(self, view) -> None:
        """Scale down nodes that have been fully idle past the timeout."""
        now = time.monotonic()
        # map provider nodes to cluster nodes by address is provider-specific;
        # the fake provider exposes raylet handles, so compare resources.
        for pid in list(self._launched):
            t = self.node_types[self._launched[pid]]
            raylet = (self.provider.raylet_for(pid)
                      if hasattr(self.provider, "raylet_for") else None)
            if raylet is None:
                continue
            n = view.get(raylet.node_id.hex())
            if n is None:
                continue
            busy = any(n["available"].get(r, 0.0) + 1e-9 < q
                       for r, q in n["total"].items()) or n.get("pending_demands")
            count_of_type = sum(1 for v in self._launched.values() if v == t.name)
            if busy or count_of_type <= t.min_workers:
                self._idle_since.pop(pid, None)
                continue
            first_idle = self._idle_since.setdefault(pid, now)
            if now - first_idle > self.idle_timeout_s:
                logger.info("terminating idle node %s", pid)
                try:
                    self.gcs.call("drain_node", {"node_id": raylet.node_id.binary()})
                except Exception:
                    pass
                self._terminate(pid)
                with self._stats_lock:
                    self._launched.pop(pid, None)
                    self._idle_since.pop(pid, None)
                    self._node_hex.pop(pid, None)

    def _report(self) -> None:
        """Ship the reconcile counters to the GCS (gcs_stats surfaces them
        beside the head's own death accounting)."""
        try:
            self.gcs.notify("autoscaler_report", self.stats())
        except Exception:
            logger.debug("autoscaler report lost (GCS reconnecting?)",
                         exc_info=True)
