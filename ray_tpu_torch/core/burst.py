"""Burst-elasticity chaos harness: scale a synthetic fleet 10 -> 1000
workers under queued load with seeded worker kills — and, in `--nodes`
mode, a multi-raylet NODE kill storm: whole nodes (raylet + its workers +
its fork templates) SIGKILLed together under closed-loop load, with the
autoscaler as the recovery control loop (dead-node reap-and-replace) and
warm node onboarding (hot-env template prewarm) measured end to end.

This is the elasticity story behind "millions of users" made into a
repeatable scenario: a small serving/RL-style fleet of actors is already
busy with a continuous stream of calls when demand arrives and the fleet
must burst to two orders of magnitude more workers — the thing a 4.5 s
cold worker start made a non-starter and the warm worker pool
(`core/worker_pool.py` fork-template zygotes) exists to make routine.
While the fleet scales, a seeded kill loop SIGKILLs random live workers
(fleet actors restart on fresh — warm — workers; the raylet's
recently-completed failover covers results dying in their buffers).

The harness asserts the elasticity contract:

  * every lease is served — each fleet actor ends up alive on a worker
    that was started either by a WARM FORK or a COLD FALLBACK spawn
    (`registered_warm + registered_cold` covers every worker; a lease
    served by neither means the pool invented a worker it can't account
    for, or dropped one);
  * every seeded kill recovers — killed actors come back and answer;
  * the load stream never wedges — every submitted call resolves as a
    result or a typed error within the deadline.

Writes a JSON artifact with cold-vs-warm start counts, fork latency
p50/p99, and actors-to-first-ping for the scale-up wave: by default
`build/BURST_torch.json` (`build/NODESTORM_torch.json`,
`build/PARTITION_torch.json`, `build/CROSSBURST_torch.json` for the other
scenarios; git ignores build/, and no artifact of the JAX package is ever
written). The harness does no device work, so it runs on any host. Run
directly:

    python -m ray_tpu_torch.core.burst                # full 10 -> 1000 profile
    python -m ray_tpu_torch.core.burst --quick        # 4 -> 40 CI profile
    python -m ray_tpu_torch.core.burst --nodes        # multi-node kill storm
    python -m ray_tpu_torch.core.burst --nodes --quick  # CI node-storm profile
    python -m ray_tpu_torch.core.burst --partition --quick  # partition storm
    python -m ray_tpu_torch.core.burst --nodes --target 40 --quick  # cross-node

The node storm asserts the NODE failure-domain contract:

  * every seeded node kill is DETECTED — the GCS declares the node dead
    through missed heartbeats alone (no drain notify), within the
    `health_check_period_ms + health_check_timeout_ms` bound;
  * every kill is REPLACED — the autoscaler reaps the corpse at the
    provider and relaunches capacity back to `min_workers`;
  * replacement nodes onboard WARM — the register_node reply's hot env
    keys pre-spawn fork templates, and node-join-to-first-warm-lease is
    tracked as a first-class number;
  * actors with `max_restarts` land on surviving/replacement nodes and
    every closed-loop call resolves (zero hung).
"""

from __future__ import annotations

import json
import logging
import os
import random
import shutil
import sys
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

_BUILD = Path(__file__).resolve().parents[2] / "build"
# the CLI's artifact by scenario (git ignores build/)
DEFAULT_ARTIFACTS = {
    "burst": str(_BUILD / "BURST_torch.json"),
    "nodes": str(_BUILD / "NODESTORM_torch.json"),
    "partition": str(_BUILD / "PARTITION_torch.json"),
    "cross": str(_BUILD / "CROSSBURST_torch.json"),
}


@dataclass
class BurstProfile:
    n_start: int = 10            # steady-state fleet before the burst
    n_target: int = 1000         # fleet size after the burst
    n_kills: int = 8             # seeded SIGKILLs during the scale-up
    kill_period_s: float = 1.0
    load_inflight: int = 32      # closed-loop in-flight calls on the fleet
    load_warmup_s: float = 2.0   # load runs this long before the burst
    seed: int = 0
    call_timeout_s: float = 120.0
    settle_timeout_s: float = 180.0


QUICK_PROFILE = dict(n_start=4, n_target=40, n_kills=3,
                     kill_period_s=0.5, load_inflight=8,
                     load_warmup_s=1.0, settle_timeout_s=90.0)


class _LoadGen:
    """Closed-loop call stream against the live fleet: keeps
    `inflight` calls outstanding, counts resolutions by outcome. Calls to
    killed actors resolve as typed errors (counted, not fatal) — the one
    forbidden outcome is a call that never resolves."""

    def __init__(self, actors: List, inflight: int, timeout_s: float):
        import ray_tpu_torch

        self._ray = ray_tpu_torch
        self._actors = actors        # shared, grows under the lock
        self._lock = threading.Lock()
        self._inflight = inflight
        self._timeout_s = timeout_s
        self._stop = threading.Event()
        self.completed = 0
        self.errored = 0
        self.hung = 0
        self._threads = [threading.Thread(target=self._run, daemon=True,
                                          name=f"burst-load-{i}")
                         for i in range(min(4, inflight))]

    def add_actors(self, actors: List) -> None:
        with self._lock:
            self._actors.extend(actors)

    def start(self) -> None:
        for t in self._threads:
            t.start()

    def stop(self) -> Dict[str, int]:
        self._stop.set()
        # join budget covers the WORST legal iteration — every in-flight
        # get of the batch timing out serially plus one blocked submission
        # — so "hung" means a call that truly never resolved, not a thread
        # that resolved several slow typed timeouts back to back
        per_thread = max(1, self._inflight // max(1, len(self._threads)))
        budget = (per_thread + 1) * self._timeout_s + 10
        deadline = time.monotonic() + budget
        for t in self._threads:
            t.join(timeout=max(1.0, deadline - time.monotonic()))
            if t.is_alive():
                self.hung += 1
        return {"completed": self.completed, "errored": self.errored,
                "hung": self.hung}

    def _run(self) -> None:
        rng = random.Random(threading.get_ident())
        per_thread = max(1, self._inflight // max(1, len(self._threads)))
        while not self._stop.is_set():
            with self._lock:
                targets = [rng.choice(self._actors)
                           for _ in range(per_thread)]
            refs = [a.work.remote(1) for a in targets]
            for r in refs:
                try:
                    self._ray.get(r, timeout=self._timeout_s)
                    with self._lock:
                        self.completed += 1
                except Exception:
                    # typed resolution (actor died mid-kill, retry budget,
                    # timeout) — the contract only forbids silent hangs,
                    # and a worker killed mid-call surfaces here
                    with self._lock:
                        self.errored += 1


def _pool_stats() -> Dict[str, Any]:
    from ray_tpu_torch.core.worker import current_worker

    return current_worker().raylet.call("worker_pool_stats", {}, timeout=30)


def _list_workers() -> List[Dict[str, Any]]:
    from ray_tpu_torch.core.worker import current_worker

    try:
        return current_worker().raylet.call("list_workers", {}, timeout=30)
    except Exception:
        return []


def _idle_worker_count() -> int:
    return sum(1 for w in _list_workers() if w.get("idle"))


def _flight_record(out_path: Optional[str], violations: List[str],
                   reason: str = "violations") -> None:
    """On a failed storm, dump the flight record (last
    tracing_flight_recorder_window_s of spans + metrics snapshot) next to
    the artifact — the context the aggregate numbers lack. No-op when the
    storm passed or writes no artifact."""
    if not out_path or not violations:
        return
    from ray_tpu_torch.util.flight_recorder import dump_flight_record

    dump_flight_record(out_path, violations, reason=reason)


def run_burst(profile: Optional[BurstProfile] = None,
              out_path: Optional[str] = None) -> Dict[str, Any]:
    """Run one burst on the CURRENT cluster (caller already init'd).
    Returns the result dict; the caller asserts on `ok` / `violations`."""
    import ray_tpu_torch

    p = profile or BurstProfile()
    rng = random.Random(p.seed)

    @ray_tpu_torch.remote
    class FleetWorker:
        def __init__(self):
            self._n = 0

        def work(self, x):
            self._n += 1
            return (os.getpid(), self._n)

        def ping(self):
            return os.getpid()

    def make_actors(n: int) -> List:
        return [FleetWorker.options(num_cpus=0, max_restarts=4).remote()
                for _ in range(n)]

    stats0 = _pool_stats()
    # leases may legitimately be served by workers that were ALREADY idle
    # when the burst began (e.g. envelope phases that ran before
    # --elastic): those start nothing and are still warm-pool-served
    idle0 = _idle_worker_count()
    violations: List[str] = []

    # ---- phase 1: steady-state fleet under load -------------------------
    fleet = make_actors(p.n_start)
    pids = ray_tpu_torch.get([a.ping.remote() for a in fleet],
                       timeout=p.settle_timeout_s)
    load = _LoadGen(list(fleet), p.load_inflight, p.call_timeout_s)
    load.start()
    time.sleep(p.load_warmup_s)

    # ---- phase 2: burst to n_target under load + seeded kills -----------
    kills_done = []
    kill_stop = threading.Event()

    def killer():
        # SIGKILL a random live worker every kill_period_s — drawn from a
        # LIVE snapshot so mid-burst forks are fair game too (a recovery
        # bug specific to freshly-forked workers must not hide behind a
        # victim list frozen at burst start). The actor restarts
        # (max_restarts) on a fresh — warm — worker, and results buffered
        # in the dead process fail over via recent_done.
        while len(kills_done) < p.n_kills and not kill_stop.is_set():
            live = [w["pid"] for w in _list_workers()] or list(pids)
            victim = rng.choice(live)
            try:
                os.kill(victim, 9)
                kills_done.append(victim)
            except OSError:
                pass  # raced its own exit; snapshot refreshes next tick
            if kill_stop.wait(p.kill_period_s):
                return

    t0 = time.perf_counter()
    wave = make_actors(p.n_target - p.n_start)
    load.add_actors(wave)
    kt = threading.Thread(target=killer, daemon=True, name="burst-killer")
    kt.start()
    # first-ping with kill-recovery: the killer may SIGKILL a wave actor
    # mid-ping (typed error); the restarted actor is re-pinged until the
    # settle budget runs out — only an actor that NEVER answers violates
    wave_pids = []
    deadline = t0 + p.settle_timeout_s
    pending = [(a, a.ping.remote()) for a in wave]
    while pending and time.perf_counter() < deadline:
        retry = []
        for a, r in pending:
            try:
                wave_pids.append(ray_tpu_torch.get(
                    r, timeout=max(0.5, deadline - time.perf_counter())))
            except Exception:
                retry.append((a, a.ping.remote()))
        pending = retry
        if pending:
            time.sleep(0.2)
    if pending:
        violations.append(
            f"{len(pending)} scale-up actors never answered first ping")
    t_wave = time.perf_counter() - t0
    # a fast scale-up must not let the chaos off the hook: the killer
    # finishes its seeded budget (bounded) before recovery is judged
    kt.join(timeout=p.n_kills * p.kill_period_s + 10)
    kill_stop.set()
    kt.join(timeout=10)

    # ---- phase 3: settle — every actor (incl. killed ones) answers ------
    recovered = 0
    t_settle0 = time.perf_counter()
    deadline = t_settle0 + p.settle_timeout_s
    for a in fleet + list(wave):
        try:
            ray_tpu_torch.get(a.ping.remote(),
                        timeout=max(1.0, deadline - time.perf_counter()))
            recovered += 1
        except Exception as e:
            violations.append(f"actor never recovered: {type(e).__name__}")
    load_counts = load.stop()
    if load_counts["hung"]:
        violations.append(f"{load_counts['hung']} load calls never resolved")

    stats1 = _pool_stats()
    warm = stats1["registered_warm"] - stats0["registered_warm"]
    cold = stats1["registered_cold"] - stats0["registered_cold"]
    total_actors = p.n_target
    # every lease must be served by a warm fork, a cold fallback, or a
    # worker that was already idle at burst start; kills and restarts only
    # ADD workers on top of the fleet itself
    if warm + cold + idle0 < recovered:
        violations.append(
            f"workers unaccounted for: {recovered} live actors but only "
            f"{warm} warm + {cold} cold starts recorded "
            f"(+{idle0} pre-burst idle)")
    if recovered < total_actors:
        violations.append(
            f"only {recovered}/{total_actors} leases ended up served")

    result = {
        "suite": "burst-elasticity (warm worker pool chaos)",
        "profile": {
            "n_start": p.n_start, "n_target": p.n_target,
            "n_kills": p.n_kills, "seed": p.seed,
            "load_inflight": p.load_inflight,
        },
        "scale_up": {
            "actors_to_first_ping_s": round(t_wave, 2),
            "actors_per_s": round((p.n_target - p.n_start) / t_wave, 1),
            "distinct_workers": len(set(wave_pids)),
        },
        "worker_pool": {
            "warm_starts": warm, "cold_starts": cold,
            "pre_burst_idle_workers": idle0,
            "warm_fraction": round(warm / max(1, warm + cold), 3),
            "fork_p50_ms": stats1["fork_p50_ms"],
            "fork_p99_ms": stats1["fork_p99_ms"],
            "template_respawns": stats1["template_respawns"]
            - stats0["template_respawns"],
        },
        "chaos": {
            "kills": len(kills_done),
            "actors_recovered": recovered,
        },
        "load": load_counts,
        "violations": violations,
        "ok": not violations,
    }
    for a in fleet + list(wave):
        try:
            ray_tpu_torch.kill(a)
        except Exception:
            pass
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2)
            f.write("\n")
    _flight_record(out_path, violations)
    return result


# --------------------------------------------------------------------------
# node kill storm (multi-raylet, autoscaler-driven recovery)


@dataclass
class NodeStormProfile:
    n_nodes: int = 4             # fleet nodes the autoscaler maintains
    node_cpus: float = 2.0
    actors_per_node: int = 4     # fleet capacity == actors: survivors stay
    #                              FULL, so restarts MUST land on replacements
    n_node_kills: int = 3        # seeded whole-node SIGKILLs
    kill_period_s: float = 5.0
    load_inflight: int = 16
    load_warmup_s: float = 2.0
    seed: int = 0
    call_timeout_s: float = 60.0
    settle_timeout_s: float = 120.0
    detect_timeout_s: float = 30.0
    # fast-detection knobs patched into the shared config for the run
    health_check_period_ms: int = 500
    health_check_timeout_ms: int = 3000


NODE_QUICK_PROFILE = dict(n_nodes=3, actors_per_node=3, n_node_kills=2,
                          kill_period_s=4.0, load_inflight=8,
                          load_warmup_s=1.0, settle_timeout_s=90.0)


def run_node_storm(profile: Optional[NodeStormProfile] = None,
                   out_path: Optional[str] = None) -> Dict[str, Any]:
    """One node kill storm on a fresh in-process multi-raylet cluster.
    Boots its own Cluster + FakeNodeProvider + StandardAutoscaler; the
    caller must NOT have ray_tpu_torch initialized."""
    import ray_tpu_torch
    from ray_tpu_torch.autoscaler import FakeNodeProvider, NodeType, \
        StandardAutoscaler
    from ray_tpu_torch.core.cluster import Cluster
    from ray_tpu_torch.core.config import get_config

    p = profile or NodeStormProfile()
    rng = random.Random(p.seed)
    cfg = get_config()
    saved = (cfg.health_check_period_ms, cfg.health_check_timeout_ms)
    cfg.health_check_period_ms = p.health_check_period_ms
    cfg.health_check_timeout_ms = p.health_check_timeout_ms
    detection_bound_s = (p.health_check_period_ms
                         + p.health_check_timeout_ms) / 1000.0

    violations: List[str] = []
    removed_events: Dict[str, float] = {}   # node hexid -> t_removed
    events_lock = threading.Lock()

    def on_nodes_event(msg):
        if msg.get("event") == "removed":
            with events_lock:
                removed_events.setdefault(msg["node_id"].hex(),
                                          time.monotonic())

    # boot INSIDE the try: a failed boot must still restore the patched
    # health-check config and tear down whatever came up
    cluster = None
    provider = None
    autoscaler = None
    load: Optional[_LoadGen] = None
    try:
        cluster = Cluster()
        cluster.add_node(num_cpus=4, resources={"head": 1})
        cluster.connect()
        provider = FakeNodeProvider(cluster.gcs_address)
        fleet_cap = float(p.actors_per_node)
        autoscaler = StandardAutoscaler(
            cluster.gcs_address, provider,
            [NodeType("storm", {"CPU": p.node_cpus, "fleet": fleet_cap},
                      min_workers=p.n_nodes,
                      max_workers=p.n_nodes + p.n_node_kills + 2)],
            update_interval_s=0.25, idle_timeout_s=10_000.0)
        from ray_tpu_torch.core.worker import current_worker

        driver = current_worker()
        driver.subscribe_channel("nodes", on_nodes_event)
        autoscaler.start()

        # ---- phase 1: the fleet forms -----------------------------------
        deadline = time.monotonic() + p.settle_timeout_s

        def alive_fleet_nodes() -> List[dict]:
            nodes = driver.gcs.call("get_all_nodes", {}, timeout=10)
            return [n for n in nodes if n.get("alive")
                    and "fleet" in n.get("resources_total", {})]

        while len(alive_fleet_nodes()) < p.n_nodes:
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"fleet never formed: {len(alive_fleet_nodes())}"
                    f"/{p.n_nodes} nodes")
            time.sleep(0.2)
        initial_pids = set(provider.non_terminated_nodes())

        @ray_tpu_torch.remote
        class FleetWorker:
            def __init__(self):
                self._n = 0

            def work(self, x):
                self._n += 1
                return (os.getpid(), self._n)

            def ping(self):
                return os.getpid()

        n_actors = p.n_nodes * p.actors_per_node
        fleet = [FleetWorker.options(num_cpus=0, max_restarts=8,
                                     resources={"fleet": 1.0}).remote()
                 for _ in range(n_actors)]
        ray_tpu_torch.get([a.ping.remote() for a in fleet],
                    timeout=p.settle_timeout_s)
        load = _LoadGen(list(fleet), p.load_inflight, p.call_timeout_s)
        load.start()
        time.sleep(p.load_warmup_s)

        # ---- phase 2: seeded whole-node kills under load ----------------
        kills: List[Dict[str, Any]] = []
        killed_pids: set = set()
        for _ in range(p.n_node_kills):
            # a LIVE victim drawn from the provider view (replacements are
            # fair game once they joined), mapped to its cluster node id
            # BEFORE the kill so detection can be attributed. Excludes
            # nodes WE killed, not just detected ones: a corpse stays
            # provider-listed until the autoscaler reaps it, and drawing
            # it twice would record two kills for one node.
            candidates = []
            with events_lock:
                seen_dead = set(removed_events)
            for pid in provider.non_terminated_nodes():
                raylet = provider.raylet_for(pid)
                if raylet is not None and pid not in killed_pids \
                        and raylet.node_id.hex() not in seen_dead:
                    candidates.append((pid, raylet.node_id.hex()))
            if not candidates:
                violations.append("no live node left to kill")
                break
            pid, hexid = rng.choice(candidates)
            logger.warning("node storm: SIGKILLing node %s (%s)",
                           pid, hexid[:8])
            t_kill = time.monotonic()
            provider.kill_node(pid)
            killed_pids.add(pid)
            kills.append({"pid": pid, "node": hexid, "t_kill": t_kill})
            time.sleep(p.kill_period_s)

        # ---- phase 3: every kill detected, every node replaced ----------
        detect_deadline = time.monotonic() + p.detect_timeout_s
        for k in kills:
            while True:
                with events_lock:
                    t_removed = removed_events.get(k["node"])
                if t_removed is not None:
                    k["detect_s"] = round(t_removed - k["t_kill"], 3)
                    break
                if time.monotonic() > detect_deadline:
                    violations.append(
                        f"node kill {k['node'][:8]} never detected")
                    break
                time.sleep(0.1)
        detect_lat = sorted(k["detect_s"] for k in kills
                            if "detect_s" in k)
        for k in kills:
            if "detect_s" in k and k["detect_s"] > detection_bound_s * 1.5:
                violations.append(
                    f"detection of {k['node'][:8]} took {k['detect_s']}s "
                    f"(> 1.5x the {detection_bound_s}s health bound)")

        replace_deadline = time.monotonic() + p.settle_timeout_s
        while len(alive_fleet_nodes()) < p.n_nodes:
            if time.monotonic() > replace_deadline:
                violations.append(
                    f"fleet never healed: {len(alive_fleet_nodes())}"
                    f"/{p.n_nodes} alive nodes after the storm")
                break
            time.sleep(0.2)

        # ---- phase 4: settle — every actor answers, placement is live ---
        recovered = 0
        settle_deadline = time.monotonic() + p.settle_timeout_s
        last_err: Dict[int, str] = {}
        watchdog_recorder: Optional[threading.Timer] = None
        if os.environ.get("RAY_TPU_TORCH_NODE_STORM_DUMP_STACKS"):
            # watchdog: if the settle phase wedges (a ping .remote() or
            # get() blocking past its budget), dump every thread so the
            # stuck frame is named instead of inferred — and the flight
            # record too, since a hang means the violations path that
            # normally dumps it may never run
            import faulthandler

            faulthandler.dump_traceback_later(
                p.settle_timeout_s * 0.8, exit=False, file=sys.stderr)
            if out_path:
                watchdog_recorder = threading.Timer(
                    p.settle_timeout_s * 0.8,
                    _flight_record, (out_path, ["settle phase wedged"],
                                     "watchdog"))
                watchdog_recorder.daemon = True
                watchdog_recorder.start()
        pending = [(a, a.ping.remote()) for a in fleet]
        while pending and time.monotonic() < settle_deadline:
            retry = []
            for a, r in pending:
                # per-get budget bounded: one wedged ref must not burn the
                # whole settle budget serially and mask the others
                per_get = min(10.0, max(
                    0.5, settle_deadline - time.monotonic()))
                try:
                    ray_tpu_torch.get(r, timeout=per_get)
                    recovered += 1
                except Exception as e:
                    last_err[id(a)] = f"{type(e).__name__}: {e}"[:160]
                    retry.append((a, a.ping.remote()))
            pending = retry
            if pending:
                time.sleep(0.3)
        if pending:
            # "?" = no get() error was ever recorded, i.e. the ping
            # .remote() itself blocked out the settle budget (an actor
            # stuck RESTARTING blocks submission in _wait_actor_address) —
            # pull the GCS state so the failure names the stuck actor
            errs: Dict[str, int] = {}
            for a, _ in pending:
                key = last_err.get(id(a), "?")
                if key == "?":
                    try:
                        info = driver.get_actor_info(actor_id=a._actor_id)
                        key = (f"no get error; GCS state="
                               f"{info.get('state') if info else None}")
                    except Exception:
                        pass
                errs[key] = errs.get(key, 0) + 1
            violations.append(
                f"{len(pending)} actors never recovered from node kills "
                f"(last errors: {errs})")
            if os.environ.get("RAY_TPU_TORCH_NODE_STORM_DUMP_STACKS"):
                import faulthandler

                faulthandler.dump_traceback(file=sys.stderr)
        if os.environ.get("RAY_TPU_TORCH_NODE_STORM_DUMP_STACKS"):
            import faulthandler

            faulthandler.cancel_dump_traceback_later()
        if watchdog_recorder is not None:
            watchdog_recorder.cancel()
        load_counts = load.stop()
        load = None  # stopped; the finally must not re-join it
        if load_counts["hung"]:
            violations.append(
                f"{load_counts['hung']} load calls never resolved")

        # placement: every actor sits on an ALIVE node; count how many
        # landed on replacement (post-storm) nodes
        alive_ids = {n["node_id"] for n in
                     driver.gcs.call("get_all_nodes", {}, timeout=10)
                     if n.get("alive")}
        on_replacements = 0
        replacement_pids = [pid for pid in provider.non_terminated_nodes()
                            if pid not in initial_pids]
        replacement_ids = {provider.raylet_for(pid).node_id.binary()
                           for pid in replacement_pids
                           if provider.raylet_for(pid) is not None}
        for a in fleet:
            info = driver.get_actor_info(actor_id=a._actor_id)
            if not info or info.get("state") != "ALIVE":
                continue
            nid = info.get("node_id")
            if nid is not None and nid not in alive_ids:
                violations.append(
                    f"actor {info['actor_id']} reports a DEAD node")
            if nid in replacement_ids:
                on_replacements += 1
        if kills and not on_replacements:
            violations.append("no restarted actor landed on a replacement "
                              "node (survivors were full — placement is "
                              "wrong)")

        # ---- warm onboarding numbers ------------------------------------
        warm_joins = []
        for pid in replacement_pids:
            raylet = provider.raylet_for(pid)
            if raylet is None:
                continue
            s = raylet._worker_pool.stats()
            if s.get("join_to_first_warm_lease_s") is not None:
                warm_joins.append(s["join_to_first_warm_lease_s"])
        if replacement_pids and not warm_joins:
            violations.append("no replacement node served a warm (forked) "
                              "lease — onboarding prewarm is not working")

        gcs_node_stats = driver.gcs.call("gcs_stats", {}, timeout=10) \
            .get("node_failure", {})
        auto_stats = autoscaler.stats()
        if auto_stats["relaunches"] < len(kills):
            violations.append(
                f"autoscaler relaunched {auto_stats['relaunches']} "
                f"< {len(kills)} kills")

        result = {
            "suite": "node-kill-storm (autoscaler node failure domain)",
            "profile": {
                "n_nodes": p.n_nodes, "actors_per_node": p.actors_per_node,
                "n_node_kills": p.n_node_kills, "seed": p.seed,
                "load_inflight": p.load_inflight,
                "health_check_period_ms": p.health_check_period_ms,
                "health_check_timeout_ms": p.health_check_timeout_ms,
            },
            "chaos": {
                "node_kills": len(kills),
                "detected": len(detect_lat),
                "detection_bound_s": detection_bound_s,
                "node_death_detection_s": {
                    "p50": detect_lat[len(detect_lat) // 2]
                    if detect_lat else None,
                    "max": detect_lat[-1] if detect_lat else None,
                },
                "kills": [{"node": k["node"][:8],
                           "detect_s": k.get("detect_s")} for k in kills],
            },
            "onboarding": {
                "node_join_to_first_warm_lease_s":
                    sorted(warm_joins)[len(warm_joins) // 2]
                    if warm_joins else None,
                "per_replacement": warm_joins,
                "replacements": len(replacement_pids),
            },
            "actors": {
                "total": n_actors,
                "recovered": recovered,
                "on_replacement_nodes": on_replacements,
            },
            "autoscaler": auto_stats,
            "gcs_node_failure": gcs_node_stats,
            "load": load_counts,
            "violations": violations,
            "ok": not violations,
        }
        for a in fleet:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
        if out_path:
            with open(out_path, "w") as f:
                json.dump(result, f, indent=2)
                f.write("\n")
        _flight_record(out_path, violations)
        return result
    finally:
        if load is not None:
            # an exception escaped mid-storm: silence the load threads
            # BEFORE tearing the cluster down under them
            try:
                load.stop()
            except Exception:
                pass
        if autoscaler is not None:
            try:
                autoscaler.stop()
            except Exception:
                pass
        if provider is not None:
            for pid in provider.non_terminated_nodes():
                try:
                    provider.terminate_node(pid)
                except Exception:
                    pass
        if cluster is not None:
            try:
                cluster.shutdown()
            except Exception:
                logger.exception("node storm cluster shutdown failed")
        cfg.health_check_period_ms, cfg.health_check_timeout_ms = saved


# --------------------------------------------------------------------------
# partition-heal storm (peer-scoped partitions, incarnation fencing,
# gray-failure quarantine — the partition failure domain end to end)


@dataclass
class PartitionStormProfile:
    n_nodes: int = 4             # autoscaler-maintained fleet nodes
    node_cpus: float = 2.0
    actors_per_node: int = 3     # capacity == actors: restarts NEED the
    #                              replacement, survivors stay full
    n_partitions: int = 3        # death-bound partition+heal cycles
    partition_hold_s: float = 6.0   # > death bound: node declared dead,
    #                                 actors restarted, THEN the heal
    quarantine_cycles: int = 1   # short partitions that must NOT kill
    quarantine_hold_s: float = 1.6  # inside (quarantine, death) window
    head_in_minority: bool = True   # final cycle cuts the head from the
    #                                 store side: the head lease's fencing
    #                                 promotes the standby
    load_inflight: int = 12
    load_warmup_s: float = 1.5
    seed: int = 0
    call_timeout_s: float = 60.0
    settle_timeout_s: float = 120.0
    # fast failure-detection knobs patched into the shared config
    health_check_period_ms: int = 500
    health_check_timeout_ms: int = 3000
    node_quarantine_timeout_ms: int = 1200
    head_lease_ttl_s: float = 1.5


PARTITION_QUICK_PROFILE = dict(n_nodes=3, actors_per_node=2,
                               n_partitions=2, partition_hold_s=5.0,
                               quarantine_cycles=1, load_inflight=8,
                               load_warmup_s=1.0, settle_timeout_s=90.0)


def run_partition_storm(profile: Optional[PartitionStormProfile] = None,
                        out_path: Optional[str] = None) -> Dict[str, Any]:
    """One partition-heal storm on a fresh multi-raylet cluster.

    Per death cycle: blackhole a minority {one fleet node} from the
    majority {head + rest + store} mid-load, with the provider's
    termination of the unreachable host HELD (the cloud API "deletes" a VM
    it cannot reach — a zombie raylet survives the autoscaler's reap).
    Assert: the node is QUARANTINED before the death bound, declared dead
    AT the bound, its named actors restart (incarnation+1) on the
    replacement the autoscaler launches; then HEAL and assert convergence
    — the zombie is fenced on its first heartbeat, kills its superseded
    workers, rejoins as a fresh node; every named actor answers from
    exactly ONE live incarnation (a deliberately stale handle probe must
    be served by the NEW instance, never the old one); zero hung calls;
    relaunches never exceed true deaths (no double replacement).

    Quarantine cycles hold the partition INSIDE the death bound: the node
    must be quarantined (no new dispatch) and then recover with its actors
    intact — zero deaths, zero relaunches, same pids.

    The final cycle puts the HEAD in the minority (cut from the store
    side): its lease renewals starve, the warm standby promotes via the
    epoch CAS, the old head self-fences through the existing lease path,
    and the healed fleet re-adopts the new head.
    """
    import ray_tpu_torch
    from ray_tpu_torch.autoscaler import FakeNodeProvider, NodeType, \
        StandardAutoscaler
    from ray_tpu_torch.core import rpc
    from ray_tpu_torch.core.cluster import Cluster
    from ray_tpu_torch.core.config import get_config

    p = profile or PartitionStormProfile()
    rng = random.Random(p.seed)
    cfg = get_config()
    saved = (cfg.health_check_period_ms, cfg.health_check_timeout_ms,
             cfg.node_quarantine_timeout_ms, cfg.head_lease_ttl_s,
             cfg.gcs_address_file)
    cfg.health_check_period_ms = p.health_check_period_ms
    cfg.health_check_timeout_ms = p.health_check_timeout_ms
    cfg.node_quarantine_timeout_ms = p.node_quarantine_timeout_ms
    cfg.head_lease_ttl_s = p.head_lease_ttl_s
    import tempfile

    # the address file lets the autoscaler, raylets and workers follow the
    # promoted head after the head-in-minority cycle
    addr_file = os.path.join(tempfile.mkdtemp(prefix="rtt-pstorm-"),
                             "gcs_address")
    cfg.gcs_address_file = addr_file
    death_bound_s = (p.health_check_period_ms
                     + p.health_check_timeout_ms) / 1000.0

    violations: List[str] = []
    cycles: List[Dict[str, Any]] = []
    cluster = provider = autoscaler = standby = None
    load: Optional[_LoadGen] = None
    old_head = None
    zombies: List[Any] = []
    inj = rpc.install_fault_injector("", seed=p.seed)
    try:
        cluster = Cluster(
            snapshot_uri=f"memory://partition-storm-{os.getpid()}")
        # tight snapshot cadence: the standby promotes from the tailed
        # snapshot, and the failure-domain counters it restores should be
        # near-live, not up to 5 s stale
        cluster.gcs._snapshot_interval_s = 0.5
        head_raylet = cluster.add_node(num_cpus=4, resources={"head": 1})
        cluster.connect()
        from ray_tpu_torch.core.worker import current_worker

        driver = current_worker()
        provider = FakeNodeProvider(cluster.gcs_address)
        fleet_cap = float(p.actors_per_node)
        autoscaler = StandardAutoscaler(
            cluster.gcs_address, provider,
            [NodeType("storm", {"CPU": p.node_cpus, "fleet": fleet_cap},
                      min_workers=p.n_nodes,
                      max_workers=p.n_nodes + p.n_partitions + 3)],
            update_interval_s=0.25, idle_timeout_s=10_000.0)
        autoscaler.start()
        if p.head_in_minority:
            standby = cluster.start_standby()

        def node_failure_stats() -> Dict[str, Any]:
            return driver.gcs.call("gcs_stats", {},
                                   timeout=10)["node_failure"]

        def alive_fleet_nodes() -> List[dict]:
            nodes = driver.gcs.call("get_all_nodes", {}, timeout=10)
            return [n for n in nodes if n.get("alive")
                    and "fleet" in n.get("resources_total", {})]

        deadline = time.monotonic() + p.settle_timeout_s
        while len(alive_fleet_nodes()) < p.n_nodes:
            if time.monotonic() > deadline:
                raise RuntimeError("fleet never formed")
            time.sleep(0.2)

        @ray_tpu_torch.remote
        class FleetWorker:
            def __init__(self):
                self._n = 0

            def work(self, x):
                self._n += 1
                return self.ping()

            def ping(self):
                from ray_tpu_torch.core.worker import current_worker as _cw

                return (os.getpid(), _cw()._actor_incarnation)

        n_actors = p.n_nodes * p.actors_per_node
        fleet = [FleetWorker.options(num_cpus=0, max_restarts=16,
                                     name=f"storm-{i}",
                                     resources={"fleet": 1.0}).remote()
                 for i in range(n_actors)]
        ray_tpu_torch.get([a.ping.remote() for a in fleet],
                    timeout=p.settle_timeout_s)
        load = _LoadGen(list(fleet), p.load_inflight, p.call_timeout_s)
        load.start()
        time.sleep(p.load_warmup_s)

        current_head = cluster.gcs.address

        def majority_for(minority: set) -> set:
            members = {current_head, head_raylet.address, "store"}
            for pid in provider.non_terminated_nodes():
                raylet = provider.raylet_for(pid)
                if raylet is not None and raylet.address not in minority:
                    members.add(raylet.address)
            return members - minority

        def await_counter(read, key, floor, timeout, what) -> Optional[float]:
            t0 = time.monotonic()
            while time.monotonic() - t0 < timeout:
                try:
                    if read()[key] >= floor:
                        return time.monotonic() - t0
                except Exception:
                    pass
                time.sleep(0.1)
            violations.append(f"{what} never observed ({key} < {floor})")
            return None

        def actor_infos():
            return {a: driver.get_actor_info(actor_id=a._actor_id)
                    for a in fleet}

        # ---------------- death-bound partition + heal cycles ------------
        for ci in range(p.n_partitions):
            candidates = []
            for pid in provider.non_terminated_nodes():
                raylet = provider.raylet_for(pid)
                if raylet is not None:
                    candidates.append((pid, raylet))
            if not candidates:
                violations.append("no fleet node left to partition")
                break
            victim_pid, victim = rng.choice(candidates)
            victim_node_id = victim.node_id.binary()
            infos0 = actor_infos()
            victims = [(a, i) for a, i in infos0.items()
                       if i and i.get("node_id") == victim_node_id
                       and i.get("state") == "ALIVE"]
            probe = None
            if victims:
                a, i = victims[0]
                try:
                    old_pid, _old_inc = ray_tpu_torch.get(a.ping.remote(),
                                                    timeout=20)
                    probe = (a, i["address"], i["incarnation"], old_pid)
                except Exception:
                    probe = None
            nf0 = node_failure_stats()
            auto0 = autoscaler.stats()
            minority = {victim.address}
            inj.define_group("minority", minority)
            inj.define_group("majority", majority_for(minority))
            provider.hold_termination(victim_pid)
            logger.warning("partition storm: cycle %d cuts node %s (%s) "
                           "from the majority", ci, victim_pid,
                           victim.node_id.hex()[:8])
            t_cut = time.monotonic()
            inj.partition("minority", "majority")

            # one poll loop, both timestamps anchored at the cut: the
            # quarantine must be OBSERVED strictly before the death (the
            # gray-failure ramp precedes the crash-stop declaration)
            t_quarantine = t_death = None
            poll_deadline = time.monotonic() + death_bound_s * 3
            while time.monotonic() < poll_deadline:
                try:
                    nf = node_failure_stats()
                except Exception:
                    time.sleep(0.1)
                    continue
                now = time.monotonic() - t_cut
                if t_quarantine is None and nf["quarantines_total"] \
                        >= nf0["quarantines_total"] + 1:
                    t_quarantine = now
                if nf["deaths_total"] >= nf0["deaths_total"] + 1:
                    t_death = now
                    break
                time.sleep(0.1)
            if t_death is None:
                violations.append(
                    f"cycle {ci}: partitioned node never declared dead")
            if t_quarantine is None:
                violations.append(
                    f"cycle {ci}: node was never quarantined before death")
            elif t_death is not None and t_quarantine >= t_death:
                violations.append(
                    f"cycle {ci}: quarantine ({t_quarantine:.2f}s) did not "
                    f"precede death ({t_death:.2f}s)")
            # hold the partition out, then heal
            remaining = p.partition_hold_s - (time.monotonic() - t_cut)
            if remaining > 0:
                time.sleep(remaining)
            t_heal = time.monotonic()
            inj.heal()
            zombie = provider.release_zombie(victim_pid)
            if zombie is not None:
                zombies.append(zombie)
            elif t_death is not None:
                violations.append(
                    f"cycle {ci}: no zombie survived the reap (terminate "
                    f"hold did not engage)")

            # ---- convergence ----
            await_counter(node_failure_stats, "fences_total",
                          nf0["fences_total"] + 1, p.settle_timeout_s,
                          f"cycle {ci}: zombie fence")
            await_counter(lambda: autoscaler.stats(), "relaunches",
                          auto0["relaunches"] + 1, p.settle_timeout_s,
                          f"cycle {ci}: autoscaler relaunch")
            # zombie rejoined as a FRESH node (same address, new identity)
            if zombie is not None:
                t0 = time.monotonic()
                rejoined = False
                while time.monotonic() - t0 < p.settle_timeout_s:
                    for n in alive_fleet_nodes():
                        if n["address"] == zombie.address \
                                and n["node_id"] != victim_node_id:
                            rejoined = True
                            break
                    if rejoined:
                        break
                    time.sleep(0.2)
                if not rejoined:
                    violations.append(
                        f"cycle {ci}: fenced node never rejoined fresh")
            # every victim actor ALIVE again with a bumped incarnation and
            # answering from exactly ONE live instance
            converge_deadline = time.monotonic() + p.settle_timeout_s
            for a, i0 in victims:
                ok = False
                while time.monotonic() < converge_deadline:
                    info = driver.get_actor_info(actor_id=a._actor_id)
                    if info and info["state"] == "ALIVE" \
                            and info["incarnation"] > i0["incarnation"]:
                        ok = True
                        break
                    time.sleep(0.2)
                if not ok:
                    violations.append(
                        f"cycle {ci}: actor {i0['actor_id']} never came "
                        f"back with a new incarnation: {info}")
                    continue
                pids = set()
                for _ in range(3):
                    try:
                        rpid, rinc = ray_tpu_torch.get(
                            a.ping.remote(),
                            timeout=max(1.0, converge_deadline
                                        - time.monotonic()))
                        pids.add(rpid)
                        if rinc != info["incarnation"]:
                            violations.append(
                                f"cycle {ci}: answer from incarnation "
                                f"{rinc} != live {info['incarnation']} — "
                                f"duplicate instance")
                    except Exception as e:
                        violations.append(
                            f"cycle {ci}: converged actor stopped "
                            f"answering: {type(e).__name__}")
                        break
                if len(pids) > 1:
                    violations.append(
                        f"cycle {ci}: named actor answered from "
                        f"{len(pids)} pids — duplicate live instances")
            # stale-handle probe: force the pre-partition (address,
            # incarnation) back into the driver's cache and call — the
            # fence must route it to the NEW instance (the old one is
            # dead/fenced and can never answer)
            probe_ok = None
            if probe is not None:
                a, old_addr, old_inc, old_pid = probe
                with driver._actor_seq_lock:
                    driver._actor_addresses[a._actor_id] = old_addr
                    driver._actor_incarnations[a._actor_id] = old_inc
                try:
                    rpid, rinc = ray_tpu_torch.get(a.ping.remote(), timeout=30)
                    probe_ok = rpid != old_pid
                    if not probe_ok:
                        violations.append(
                            f"cycle {ci}: STALE instance answered the "
                            f"stale-handle probe (pid {rpid})")
                except Exception as e:
                    probe_ok = False
                    violations.append(
                        f"cycle {ci}: stale-handle probe never converged: "
                        f"{type(e).__name__}: {e}"[:200])
            t_converged = time.monotonic()
            cycles.append({
                "kind": "death", "node": victim.node_id.hex()[:8],
                "quarantine_s": round(t_quarantine, 3)
                if t_quarantine is not None else None,
                "death_detect_s": round(t_death, 3)
                if t_death is not None else None,
                "heal_to_convergence_s": round(t_converged - t_heal, 3),
                "stale_handle_probe_served_by_new": probe_ok,
            })

        # ---------------- quarantine-and-recover cycles ------------------
        for ci in range(p.quarantine_cycles):
            infos0 = actor_infos()
            hosting = {i["node_id"] for i in infos0.values()
                       if i and i.get("state") == "ALIVE"
                       and i.get("node_id")}
            candidates = [(pid, provider.raylet_for(pid))
                          for pid in provider.non_terminated_nodes()
                          if provider.raylet_for(pid) is not None]
            if not candidates:
                violations.append("no fleet node left to quarantine")
                break
            # prefer a node that HOSTS actors: the point is proving they
            # survive quarantine+recovery with zero relaunches
            hosting_candidates = [(pid, r) for pid, r in candidates
                                  if r.node_id.binary() in hosting]
            victim_pid, victim = rng.choice(hosting_candidates
                                            or candidates)
            victim_node_id = victim.node_id.binary()
            held = {i["actor_id"]: i["incarnation"]
                    for i in infos0.values()
                    if i and i.get("node_id") == victim_node_id}
            nf0 = node_failure_stats()
            auto0 = autoscaler.stats()
            minority = {victim.address}
            inj.define_group("minority", minority)
            inj.define_group("majority", majority_for(minority))
            logger.warning("partition storm: quarantine cycle grays out "
                           "node %s", victim.node_id.hex()[:8])
            t_cut = time.monotonic()
            inj.partition("minority", "majority")
            t_q = await_counter(
                node_failure_stats, "quarantines_total",
                nf0["quarantines_total"] + 1, death_bound_s * 2,
                "quarantine cycle: node never quarantined")
            remaining = p.quarantine_hold_s - (time.monotonic() - t_cut)
            if remaining > 0:
                time.sleep(remaining)
            t_heal = time.monotonic()
            inj.heal()
            t_rec = await_counter(
                node_failure_stats, "quarantine_recoveries_total",
                nf0["quarantine_recoveries_total"] + 1, death_bound_s * 2,
                "quarantine cycle: node never recovered")
            nf1 = node_failure_stats()
            auto1 = autoscaler.stats()
            if nf1["deaths_total"] != nf0["deaths_total"]:
                violations.append("quarantine cycle: node was declared "
                                  "DEAD inside the quarantine window")
            if auto1["relaunches"] != auto0["relaunches"]:
                violations.append("quarantine cycle: autoscaler replaced a "
                                  "quarantined (recoverable) node")
            kept = 0
            for aid, inc in held.items():
                info = driver.gcs.call("get_actor_info",
                                       {"actor_id": aid}, timeout=10)
                if info and info["state"] == "ALIVE" \
                        and info["incarnation"] == inc:
                    kept += 1
                else:
                    violations.append(
                        f"quarantine cycle: actor {aid} did not keep its "
                        f"incarnation across recovery: {info}")
            if not held:
                violations.append("quarantine cycle: victim hosted no "
                                  "actors — nothing proven")
            cycles.append({
                "kind": "quarantine", "node": victim.node_id.hex()[:8],
                "quarantine_s": round(t_q, 3) if t_q is not None else None,
                # await started at the heal: this IS heal->recovery
                "heal_to_recovery_s": round(t_rec, 3)
                if t_rec is not None else None,
                "actors_kept": kept, "actors_held": len(held),
            })

        # ---------------- head-in-minority cycle -------------------------
        if p.head_in_minority and standby is not None:
            stats0 = driver.gcs.call("gcs_stats", {}, timeout=10)
            epoch0 = stats0["fence_epoch"]
            old_head = cluster.gcs
            minority = {current_head}
            inj.define_group("minority", minority)
            inj.define_group("majority", majority_for(minority))
            logger.warning("partition storm: head-in-minority cycle cuts "
                           "the head %s from the store side", current_head)
            t_cut = time.monotonic()
            inj.partition("minority", "majority")
            promoted = standby.wait_promoted(p.settle_timeout_s)
            if promoted is None:
                violations.append("head-in-minority: standby never "
                                  "promoted (lease starvation failed)")
            t_heal = time.monotonic()
            inj.heal()
            if promoted is not None:
                cluster.adopt_promoted(standby)
                current_head = promoted.address
                # the old head self-fences via the existing lease path
                # (reads the bumped epoch) once healed
                t0 = time.monotonic()
                while not old_head._fenced.is_set() \
                        and time.monotonic() - t0 < p.settle_timeout_s:
                    time.sleep(0.1)
                if not old_head._fenced.is_set():
                    violations.append("head-in-minority: old head never "
                                      "self-fenced after the heal")
                # the fleet re-adopts the promoted head
                stats1: Dict[str, Any] = {}
                t0 = time.monotonic()
                while time.monotonic() - t0 < p.settle_timeout_s:
                    try:
                        stats1 = driver.gcs.call("gcs_stats", {},
                                                 timeout=5)
                        if stats1["fence_epoch"] > epoch0 \
                                and stats1["nodes_alive"] >= p.n_nodes:
                            break
                    except Exception:
                        pass
                    time.sleep(0.2)
                else:
                    violations.append("head-in-minority: fleet never "
                                      "re-adopted the promoted head")
                cycles.append({
                    "kind": "head_in_minority",
                    "epoch": f"{epoch0}->{stats1.get('fence_epoch')}",
                    "promotion": stats1.get("promotion"),
                    "heal_to_convergence_s":
                        round(time.monotonic() - t_heal, 3),
                })

        # ---------------- final convergence sweep ------------------------
        final_deadline = time.monotonic() + p.settle_timeout_s
        for idx, a in enumerate(fleet):
            try:
                named = ray_tpu_torch.get_actor(f"storm-{idx}")
                rpid, rinc = ray_tpu_torch.get(
                    named.ping.remote(),
                    timeout=max(1.0, final_deadline - time.monotonic()))
                info = driver.get_actor_info(actor_id=a._actor_id)
                if info is None or rinc != info["incarnation"]:
                    violations.append(
                        f"final: storm-{idx} answered from incarnation "
                        f"{rinc}, GCS records "
                        f"{info and info['incarnation']}")
            except Exception as e:
                violations.append(
                    f"final: storm-{idx} unresolvable: "
                    f"{type(e).__name__}: {e}"[:160])
        load_counts = load.stop()
        load = None
        if load_counts["hung"]:
            violations.append(
                f"{load_counts['hung']} load calls never resolved")
        nf_final = node_failure_stats()
        auto_final = autoscaler.stats()
        if auto_final["relaunches"] > nf_final["deaths_total"]:
            violations.append(
                f"autoscaler double-replaced: {auto_final['relaunches']} "
                f"relaunches > {nf_final['deaths_total']} true deaths")

        result = {
            "suite": "partition-heal storm (partition failure domain)",
            "profile": {
                "n_nodes": p.n_nodes, "actors_per_node": p.actors_per_node,
                "n_partitions": p.n_partitions,
                "quarantine_cycles": p.quarantine_cycles,
                "head_in_minority": p.head_in_minority, "seed": p.seed,
                "health_check_period_ms": p.health_check_period_ms,
                "health_check_timeout_ms": p.health_check_timeout_ms,
                "node_quarantine_timeout_ms": p.node_quarantine_timeout_ms,
                "death_bound_s": death_bound_s,
            },
            "cycles": cycles,
            "counters": {
                "deaths_total": nf_final["deaths_total"],
                "quarantines_total": nf_final["quarantines_total"],
                "quarantine_recoveries_total":
                    nf_final["quarantine_recoveries_total"],
                "fences_total": nf_final["fences_total"],
                "stale_incarnation_rejections":
                    nf_final["stale_incarnation_rejections"],
                "driver_stale_reply_rejections":
                    driver.stale_reply_rejections,
                "relaunches": auto_final["relaunches"],
                "partition_drops": inj.stats["partition"],
            },
            "heal_to_convergence_s": {
                "max": max((c["heal_to_convergence_s"] for c in cycles
                            if c.get("heal_to_convergence_s") is not None),
                           default=None),
                "per_cycle": [c.get("heal_to_convergence_s")
                              for c in cycles],
            },
            "load": load_counts,
            "violations": violations,
            "ok": not violations,
        }
        for a in fleet:
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
        if out_path:
            with open(out_path, "w") as f:
                json.dump(result, f, indent=2)
                f.write("\n")
        _flight_record(out_path, violations)
        return result
    finally:
        if load is not None:
            try:
                load.stop()
            except Exception:
                pass
        try:
            inj.heal()
        except Exception:
            pass
        rpc.clear_fault_injector()
        for z in zombies:
            try:
                z.stop()
            except Exception:
                pass
        if autoscaler is not None:
            try:
                autoscaler.stop()
            except Exception:
                pass
        if provider is not None:
            for pid in provider.non_terminated_nodes():
                try:
                    provider.terminate_node(pid)
                except Exception:
                    pass
        if old_head is not None:
            try:
                old_head.kill()
            except Exception:
                pass
        if cluster is not None:
            try:
                cluster.shutdown()
            except Exception:
                logger.exception("partition storm cluster shutdown failed")
        (cfg.health_check_period_ms, cfg.health_check_timeout_ms,
         cfg.node_quarantine_timeout_ms, cfg.head_lease_ttl_s,
         cfg.gcs_address_file) = saved
        shutil.rmtree(os.path.dirname(addr_file), ignore_errors=True)


def _partition_storm_main(args) -> int:
    kw: Dict[str, Any] = dict(PARTITION_QUICK_PROFILE) if args.quick else {}
    kw["seed"] = args.seed
    p = PartitionStormProfile(**kw)
    result = run_partition_storm(p, out_path=args.json)
    print(json.dumps(result, indent=2))
    c = result["counters"]
    print(f"[partition-storm] seed={p.seed} nodes={p.n_nodes} "
          f"partitions={p.n_partitions}+{p.quarantine_cycles}q"
          f"{'+head' if p.head_in_minority else ''} | "
          f"deaths={c['deaths_total']} quarantines={c['quarantines_total']} "
          f"(recovered {c['quarantine_recoveries_total']}) "
          f"fences={c['fences_total']} relaunches={c['relaunches']} "
          f"stale_rejections={c['stale_incarnation_rejections']} | "
          f"heal->convergence max "
          f"{result['heal_to_convergence_s']['max']}s | "
          f"load={result['load']}", file=sys.stderr)
    if not result["ok"]:
        print("[partition-storm] VIOLATIONS:", file=sys.stderr)
        for v in result["violations"]:
            print(f"  - {v}", file=sys.stderr)
        return 1
    return 0


def _node_storm_main(args) -> int:
    kw: Dict[str, Any] = dict(NODE_QUICK_PROFILE) if args.quick else {}
    kw["seed"] = args.seed
    if args.kills is not None:
        kw["n_node_kills"] = args.kills
    p = NodeStormProfile(**kw)
    result = run_node_storm(p, out_path=args.json)
    print(json.dumps(result, indent=2))
    c, o = result["chaos"], result["onboarding"]
    print(f"[node-storm] seed={p.seed} nodes={p.n_nodes} "
          f"kills={c['node_kills']} detected={c['detected']} "
          f"(p50 {c['node_death_detection_s']['p50']}s, bound "
          f"{c['detection_bound_s']}s) | replacements={o['replacements']} "
          f"join->first-warm-lease={o['node_join_to_first_warm_lease_s']}s "
          f"| actors recovered={result['actors']['recovered']}"
          f"/{result['actors']['total']} "
          f"(on replacements: {result['actors']['on_replacement_nodes']}) "
          f"| load={result['load']}", file=sys.stderr)
    if not result["ok"]:
        print("[node-storm] VIOLATIONS:", file=sys.stderr)
        for v in result["violations"]:
            print(f"  - {v}", file=sys.stderr)
        return 1
    return 0


# --------------------------------------------------------------------------
# cross-node worker burst: the worker-burst axis composed with --nodes


@dataclass
class CrossNodeBurstProfile:
    n_nodes: int = 4             # autoscaler-maintained fleet nodes
    node_cpus: float = 4.0
    n_start: int = 10
    n_target: int = 1000         # burst ACROSS the node fleet
    load_inflight: int = 32
    load_warmup_s: float = 2.0
    seed: int = 0
    call_timeout_s: float = 120.0
    settle_timeout_s: float = 300.0


CROSS_QUICK_PROFILE = dict(n_nodes=3, n_start=4, n_target=40,
                           load_inflight=8, load_warmup_s=1.0,
                           settle_timeout_s=120.0)


def run_cross_node_burst(profile: Optional[CrossNodeBurstProfile] = None,
                         out_path: Optional[str] = None) -> Dict[str, Any]:
    """Burst the worker fleet n_start -> n_target ACROSS a multi-raylet
    cluster (`--nodes` composed with the worker-burst axis).
    SPREAD-scheduled actors under closed-loop load;
    asserts every actor answers, the wave genuinely lands on multiple
    nodes, every lease is served by a warm fork or a cold fallback
    (aggregated across EVERY raylet's pool), and no load call hangs."""
    import ray_tpu_torch
    from ray_tpu_torch.autoscaler import FakeNodeProvider, NodeType, \
        StandardAutoscaler
    from ray_tpu_torch.core.cluster import Cluster
    from ray_tpu_torch.core.task_spec import SchedulingStrategy

    p = profile or CrossNodeBurstProfile()
    violations: List[str] = []
    cluster = provider = autoscaler = None
    load: Optional[_LoadGen] = None
    try:
        cluster = Cluster()
        head_raylet = cluster.add_node(num_cpus=4, resources={"head": 1})
        cluster.connect()
        from ray_tpu_torch.core.worker import current_worker

        driver = current_worker()
        provider = FakeNodeProvider(cluster.gcs_address)
        # per-node "slot" capacity: a REAL consumable resource (zero-cpu
        # actors leave utilization flat, which degenerates SPREAD onto one
        # node) sized so the full burst fits with ~25% slack per node
        slot_cap = float(-(-p.n_target * 5 // (p.n_nodes * 4)))
        autoscaler = StandardAutoscaler(
            cluster.gcs_address, provider,
            [NodeType("burst", {"CPU": p.node_cpus, "slot": slot_cap},
                      min_workers=p.n_nodes, max_workers=p.n_nodes + 2)],
            update_interval_s=0.25, idle_timeout_s=10_000.0)
        autoscaler.start()

        def fleet_raylets():
            out = [head_raylet]
            for pid in provider.non_terminated_nodes():
                r = provider.raylet_for(pid)
                if r is not None:
                    out.append(r)
            return out

        deadline = time.monotonic() + p.settle_timeout_s
        while len(provider.non_terminated_nodes()) < p.n_nodes:
            if time.monotonic() > deadline:
                raise RuntimeError("node fleet never formed")
            time.sleep(0.2)

        def pool_totals() -> Dict[str, int]:
            tot = {"registered_warm": 0, "registered_cold": 0}
            for r in fleet_raylets():
                s = r._worker_pool.stats()
                tot["registered_warm"] += s["registered_warm"]
                tot["registered_cold"] += s["registered_cold"]
            return tot

        def idle_total() -> int:
            n = 0
            for r in fleet_raylets():
                with r._lock:
                    n += sum(len(pool) for pool in r._idle_pools.values())
            return n

        @ray_tpu_torch.remote
        class FleetWorker:
            def __init__(self):
                self._n = 0

            def work(self, x):
                self._n += 1
                return (os.getpid(), self._n)

            def ping(self):
                return os.getpid()

        def make_actors(n: int) -> List:
            return [FleetWorker.options(
                num_cpus=0, max_restarts=4, resources={"slot": 1.0},
                scheduling_strategy=SchedulingStrategy(
                    name="SPREAD")).remote() for _ in range(n)]

        stats0 = pool_totals()
        idle0 = idle_total()
        fleet = make_actors(p.n_start)
        ray_tpu_torch.get([a.ping.remote() for a in fleet],
                    timeout=p.settle_timeout_s)
        load = _LoadGen(list(fleet), p.load_inflight, p.call_timeout_s)
        load.start()
        time.sleep(p.load_warmup_s)

        t0 = time.perf_counter()
        wave = make_actors(p.n_target - p.n_start)
        load.add_actors(wave)
        wave_pids = []
        deadline = t0 + p.settle_timeout_s
        pending = [(a, a.ping.remote()) for a in wave]
        while pending and time.perf_counter() < deadline:
            retry = []
            for a, r in pending:
                try:
                    wave_pids.append(ray_tpu_torch.get(
                        r, timeout=max(0.5,
                                       deadline - time.perf_counter())))
                except Exception:
                    retry.append((a, a.ping.remote()))
            pending = retry
            if pending:
                time.sleep(0.2)
        if pending:
            violations.append(f"{len(pending)} cross-node scale-up actors "
                              f"never answered first ping")
        t_wave = time.perf_counter() - t0
        load_counts = load.stop()
        load = None
        if load_counts["hung"]:
            violations.append(
                f"{load_counts['hung']} load calls never resolved")

        # distribution: the wave must genuinely land across nodes
        nodes_used = set()
        for a in fleet + list(wave):
            info = driver.get_actor_info(actor_id=a._actor_id)
            if info and info.get("node_id"):
                nodes_used.add(info["node_id"])
        if len(nodes_used) < min(p.n_nodes, 2):
            violations.append(
                f"burst landed on only {len(nodes_used)} node(s) of "
                f"{p.n_nodes + 1} — not a cross-node burst")
        stats1 = pool_totals()
        warm = stats1["registered_warm"] - stats0["registered_warm"]
        cold = stats1["registered_cold"] - stats0["registered_cold"]
        answered = p.n_target - len(pending)
        if warm + cold + idle0 < answered:
            violations.append(
                f"workers unaccounted for across nodes: {answered} actors "
                f"but only {warm} warm + {cold} cold starts "
                f"(+{idle0} pre-burst idle)")

        result = {
            "suite": "cross-node worker burst (--nodes x worker-burst)",
            "profile": {"n_nodes": p.n_nodes, "n_start": p.n_start,
                        "n_target": p.n_target, "seed": p.seed,
                        "load_inflight": p.load_inflight},
            "scale_up": {
                "actors_to_first_ping_s": round(t_wave, 2),
                "actors_per_s": round((p.n_target - p.n_start)
                                      / max(t_wave, 1e-9), 1),
                "distinct_workers": len(set(wave_pids)),
                "nodes_used": len(nodes_used),
            },
            "worker_pool": {"warm_starts": warm, "cold_starts": cold,
                            "pre_burst_idle_workers": idle0,
                            "warm_fraction":
                                round(warm / max(1, warm + cold), 3)},
            "load": load_counts,
            "violations": violations,
            "ok": not violations,
        }
        for a in fleet + list(wave):
            try:
                ray_tpu_torch.kill(a)
            except Exception:
                pass
        if out_path:
            with open(out_path, "w") as f:
                json.dump(result, f, indent=2)
                f.write("\n")
        _flight_record(out_path, violations)
        return result
    finally:
        if load is not None:
            try:
                load.stop()
            except Exception:
                pass
        if autoscaler is not None:
            try:
                autoscaler.stop()
            except Exception:
                pass
        if provider is not None:
            for pid in provider.non_terminated_nodes():
                try:
                    provider.terminate_node(pid)
                except Exception:
                    pass
        if cluster is not None:
            try:
                cluster.shutdown()
            except Exception:
                logger.exception("cross-node burst cluster shutdown failed")


def _cross_node_burst_main(args) -> int:
    kw: Dict[str, Any] = dict(CROSS_QUICK_PROFILE) if args.quick else {}
    kw["seed"] = args.seed
    if args.start is not None:
        kw["n_start"] = args.start
    if args.target is not None:
        kw["n_target"] = args.target
    p = CrossNodeBurstProfile(**kw)
    result = run_cross_node_burst(p, out_path=args.json)
    print(json.dumps(result, indent=2))
    su, wp = result["scale_up"], result["worker_pool"]
    print(f"[cross-burst] seed={p.seed} {p.n_start} -> {p.n_target} "
          f"workers across {su['nodes_used']} nodes in "
          f"{su['actors_to_first_ping_s']}s | warm={wp['warm_starts']} "
          f"cold={wp['cold_starts']} (warm fraction {wp['warm_fraction']}) "
          f"| load={result['load']}", file=sys.stderr)
    if not result["ok"]:
        print("[cross-burst] VIOLATIONS:", file=sys.stderr)
        for v in result["violations"]:
            print(f"  - {v}", file=sys.stderr)
        return 1
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--quick", action="store_true",
                    help="scaled-down CI profile (4 -> 40 workers)")
    ap.add_argument("--nodes", action="store_true",
                    help="multi-raylet NODE kill storm (autoscaler-driven "
                         "replacement + warm onboarding); with --target: "
                         "worker burst ACROSS the node fleet instead")
    ap.add_argument("--partition", action="store_true",
                    help="partition-heal storm: peer-scoped partitions, "
                         "gray-failure quarantine, incarnation fencing, "
                         "head-in-minority lease fencing")
    ap.add_argument("--seed", type=int,
                    default=int(os.environ.get(
                        "RAY_TPU_TORCH_FAULT_INJECTION_SEED", "0")))
    ap.add_argument("--start", type=int, default=None)
    ap.add_argument("--target", type=int, default=None)
    ap.add_argument("--kills", type=int, default=None)
    ap.add_argument("--json", default=None,
                    help="write the result here (default: the scenario's "
                         "file under build/, e.g. "
                         f"{DEFAULT_ARTIFACTS['burst']})")
    args = ap.parse_args(argv)
    scenario = ("partition" if args.partition
                else "cross" if args.nodes and args.target is not None
                else "nodes" if args.nodes else "burst")
    if args.json is None:
        args.json = DEFAULT_ARTIFACTS[scenario]
    os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)

    if args.partition:
        return _partition_storm_main(args)
    if args.nodes and args.target is not None:
        return _cross_node_burst_main(args)
    if args.nodes:
        return _node_storm_main(args)

    kw: Dict[str, Any] = dict(QUICK_PROFILE) if args.quick else {}
    kw["seed"] = args.seed
    if args.start is not None:
        kw["n_start"] = args.start
    if args.target is not None:
        kw["n_target"] = args.target
    if args.kills is not None:
        kw["n_kills"] = args.kills
    p = BurstProfile(**kw)

    import ray_tpu_torch

    # enough CPU headroom that the fleet (num_cpus=0 actors) and the load
    # stream never contend on scheduler admission
    ray_tpu_torch.init(num_cpus=8)
    try:
        result = run_burst(p, out_path=args.json)
    finally:
        ray_tpu_torch.shutdown()

    print(json.dumps(result, indent=2))
    wp, su = result["worker_pool"], result["scale_up"]
    print(f"[burst] seed={p.seed} {p.n_start} -> {p.n_target} workers in "
          f"{su['actors_to_first_ping_s']}s | warm={wp['warm_starts']} "
          f"cold={wp['cold_starts']} (warm fraction "
          f"{wp['warm_fraction']}) fork p50/p99 = {wp['fork_p50_ms']}/"
          f"{wp['fork_p99_ms']} ms | kills={result['chaos']['kills']} "
          f"recovered={result['chaos']['actors_recovered']}",
          file=sys.stderr)
    if not result["ok"]:
        print("[burst] VIOLATIONS:", file=sys.stderr)
        for v in result["violations"]:
            print(f"  - {v}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
