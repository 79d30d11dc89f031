"""The port's autoscaler core against ray_tpu's.

Decisions: both packages' `StandardAutoscaler` run the same seeded
scenarios tick by tick (pending demands, a cluster view, a provider that
fails launches and loses nodes on a numpy-seeded schedule, a clock the test
advances), with "TPU" and `tpu_slice` mapped to "GPU" and `nvlink_domain`;
they must launch the same node types, reap and terminate the same nodes and
report the same counters and breaker states at every tick. The GCS link is
a stub and each breaker's jitter a `random.Random` of the seed, so nothing
but the two packages' code differs.

Runtime: the reference's autoscaler tests (tests/test_node_failure.py and
test_dag_workflow_autoscaler.py's scale-up), run on the port's runtime with
its `FakeNodeProvider`'s in-process raylets.
"""

import os
import random
import time

import numpy as np
import pytest

import ray_tpu.autoscaler.autoscaler as ref_auto
import ray_tpu.util.backoff as ref_backoff
import ray_tpu_torch
import ray_tpu_torch.autoscaler.autoscaler as port_auto
import ray_tpu_torch.util.backoff as port_backoff
from ray_tpu_torch.autoscaler import (FakeNodeProvider, NodeType,
                                      StandardAutoscaler)
from ray_tpu_torch.core.cluster import Cluster
from ray_tpu_torch.core.config import get_config

from torch_runtime import rerun_if_killed

PACKAGES = {"ref": (ref_auto, ref_backoff), "port": (port_auto,
                                                      port_backoff)}


def _to_port(d):
    """A reference resource or label dict in the port's names."""
    names = {"TPU": "GPU", "tpu_slice": "nvlink_domain"}
    return {names.get(k, k): v for k, v in d.items()}


def _to_ref(d):
    names = {"GPU": "TPU", "nvlink_domain": "tpu_slice"}
    return {names.get(k, k): v for k, v in d.items()}


# ------------------------------------------------------ decision parity


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now


class _StubGcs:
    """The GCS link: the scenario's demands and view for this tick."""

    def __init__(self):
        self.demands, self.view, self.calls = [], {}, []

    def call(self, method, payload=None, timeout=None):
        self.calls.append(method)
        if method == "get_pending_demands":
            return self.demands
        if method == "get_cluster_view":
            return self.view
        return True

    def notify(self, method, payload=None):
        pass

    def close(self):
        pass


class _NodeId:
    def __init__(self, i):
        self._b = i.to_bytes(16, "big")

    def hex(self):
        return self._b.hex()

    def binary(self):
        return self._b


class _Raylet:
    def __init__(self, i):
        self.node_id = _NodeId(i)


class _ScriptedProvider:
    """Launches fail where the script says; nodes get sequential ids."""

    def __init__(self, fail_next):
        self.fail_next = fail_next   # callable: does this create fail?
        self.nodes = {}
        self.created, self.terminated = [], []
        self._n = 0

    def create_node(self, node_type, resources, labels):
        if self.fail_next():
            raise RuntimeError("cloud API 500 (scripted)")
        self._n += 1
        pid = f"n{self._n}"
        self.nodes[pid] = _Raylet(self._n)
        self.created.append((node_type, dict(resources), dict(labels)))
        return pid

    def terminate_node(self, pid):
        self.terminated.append(pid)
        self.nodes.pop(pid, None)

    def non_terminated_nodes(self):
        return list(self.nodes)

    def raylet_for(self, pid):
        return self.nodes.get(pid)


def _scenario(seed):
    """A seeded schedule in the reference's names: node types, then per tick
    the demands, which launches fail, which nodes vanish or die, and how
    busy each live node is."""
    rng = np.random.default_rng(seed)
    types = []
    for k in range(int(rng.integers(1, 4))):
        res = {"CPU": float(rng.choice([2, 4, 8]))}
        if rng.random() < 0.6:
            res["TPU"] = float(rng.choice([1, 4, 8]))
        labels = {"tpu_slice": f"s{k}"} if "TPU" in res else {}
        types.append(dict(name=f"t{k}", resources=res,
                          min_workers=int(rng.integers(0, 2)),
                          max_workers=int(rng.integers(1, 5)),
                          labels=labels))
    ticks = []
    for _ in range(30):
        demands = []
        for _ in range(int(rng.integers(0, 5))):
            d = {"CPU": float(rng.choice([0.5, 1, 2, 4, 9]))}
            if rng.random() < 0.5:
                d["TPU"] = float(rng.choice([1, 2, 4, 16]))
            demands.append(d)
        ticks.append(dict(
            demands=demands,
            fail=[bool(x) for x in rng.random(8) < 0.35],
            vanish=int(rng.integers(0, 6)) == 0,
            die=int(rng.integers(0, 6)) == 0,
            busy=[float(x) for x in rng.random(16)],
            pick=int(rng.integers(0, 1 << 30)),
            dt=float(rng.choice([0.05, 0.5, 2.0, 40.0])),
        ))
    return types, ticks


def _run_scenario(pkg, seed, monkeypatch):
    auto_mod, backoff_mod = PACKAGES[pkg]
    to = _to_port if pkg == "port" else (lambda d: d)
    types, ticks = _scenario(seed)
    clock = _Clock()
    gcs = _StubGcs()
    monkeypatch.setattr(auto_mod.rpc, "ReconnectingClient",
                        lambda *a, **k: gcs)
    monkeypatch.setattr(auto_mod, "time", clock)
    monkeypatch.setattr(backoff_mod, "random", random.Random(seed))
    fails = []
    provider = _ScriptedProvider(lambda: fails.pop(0) if fails else False)
    node_types = [auto_mod.NodeType(t["name"], to(t["resources"]),
                                    t["min_workers"], t["max_workers"],
                                    to(t["labels"])) for t in types]
    scaler = auto_mod.StandardAutoscaler(
        "stub:0", provider, node_types, update_interval_s=1.0,
        idle_timeout_s=30.0, launch_failure_threshold=3)
    dead = set()
    trace = []
    for tick in ticks:
        fails[:] = list(tick["fail"])
        live = sorted(provider.nodes, key=lambda p: int(p[1:]))
        if live and tick["vanish"]:
            provider.nodes.pop(live[tick["pick"] % len(live)])
        elif live and tick["die"]:
            dead.add(live[tick["pick"] % len(live)])
        view = {}
        for i, pid in enumerate(sorted(provider.nodes,
                                       key=lambda p: int(p[1:]))):
            ntype = scaler._launched.get(pid)
            total = dict(scaler.node_types[ntype].resources) if ntype \
                else {"CPU": 1.0}
            busy = tick["busy"][i % len(tick["busy"])]
            avail = {r: (q if busy < 0.5 else q * busy)
                     for r, q in total.items()}
            view[provider.nodes[pid].node_id.hex()] = {
                "alive": pid not in dead, "total": total,
                "available": avail}
        gcs.demands = [to(d) for d in tick["demands"]]
        gcs.view = view
        n_created, n_term = len(provider.created), len(provider.terminated)
        scaler.update()
        trace.append({
            "created": [(t, _to_ref(r), _to_ref(lb)) for t, r, lb
                        in provider.created[n_created:]],
            "terminated": provider.terminated[n_term:],
            "stats": scaler.stats(),
        })
        clock.now += tick["dt"]
    return trace


@pytest.mark.parametrize("seed", range(12))
def test_autoscaler_decisions_match_reference(seed, monkeypatch):
    ref = _run_scenario("ref", seed, monkeypatch)
    port = _run_scenario("port", seed, monkeypatch)
    for i, (r, p) in enumerate(zip(ref, port)):
        assert p == r, f"seed {seed} tick {i}: port {p} != reference {r}"
    # the scenarios exercise what they claim to
    assert ref[-1]["stats"]["launches"] > 0


def test_nodes_to_launch_matches_reference_on_seeded_tables():
    """First-fit-decreasing over live capacity, then the cheapest node type
    that fits, bounded by max_workers: 300 seeded tables."""
    rng = np.random.default_rng(23)
    for case in range(300):
        types, demands, view, counts = [], [], {}, {}
        for k in range(int(rng.integers(1, 5))):
            res = {"CPU": float(rng.choice([1, 2, 4, 8, 16]))}
            if rng.random() < 0.5:
                res["TPU"] = float(rng.choice([1, 4, 8]))
            types.append((f"t{k}", res, int(rng.integers(0, 4))))
            counts[f"t{k}"] = int(rng.integers(0, 3))
        for i in range(int(rng.integers(0, 6))):
            avail = {"CPU": float(rng.integers(0, 9))}
            if rng.random() < 0.5:
                avail["TPU"] = float(rng.integers(0, 5))
            view[f"{i:032x}"] = {"alive": bool(rng.random() < 0.8),
                                 "available": avail, "total": avail}
        for _ in range(int(rng.integers(0, 10))):
            d = {"CPU": float(rng.choice([0.25, 1, 2, 3, 8, 20]))}
            if rng.random() < 0.4:
                d["TPU"] = float(rng.choice([1, 2, 4, 8]))
            demands.append(d)
        got = {}
        for pkg, to in (("ref", lambda d: d), ("port", _to_port)):
            auto_mod = PACKAGES[pkg][0]
            scaler = object.__new__(auto_mod.StandardAutoscaler)
            scaler.node_types = {n: auto_mod.NodeType(n, to(r), 0, mx)
                                 for n, r, mx in types}
            got[pkg] = scaler._nodes_to_launch(
                [to(d) for d in demands],
                {h: dict(v, available=to(v["available"]),
                         total=to(v["total"])) for h, v in view.items()},
                dict(counts))
        assert got["port"] == got["ref"], (case, types, demands, view)


def test_launch_breaker_trips_at_the_same_counts(monkeypatch):
    """A provider that always fails: each package's breaker opens after
    the threshold and paces attempts by the same jittered windows."""
    seen = {}
    for pkg in ("ref", "port"):
        auto_mod, backoff_mod = PACKAGES[pkg]
        clock = _Clock()
        gcs = _StubGcs()
        monkeypatch.setattr(auto_mod.rpc, "ReconnectingClient",
                            lambda *a, **k: gcs)
        monkeypatch.setattr(auto_mod, "time", clock)
        monkeypatch.setattr(backoff_mod, "random", random.Random(7))
        provider = _ScriptedProvider(lambda: True)
        scaler = auto_mod.StandardAutoscaler(
            "stub:0", provider,
            [auto_mod.NodeType("fleet", {"CPU": 2.0}, 1, 4)],
            launch_failure_threshold=3)
        steps = []
        for _ in range(60):
            scaler.update()
            st = scaler.stats()
            steps.append((st["launch_failures"],
                          st["breakers"]["fleet"]["failures"],
                          st["breakers"]["fleet"]["open"]))
            clock.now += 0.05
        seen[pkg] = steps
    assert seen["port"] == seen["ref"]
    opened = [i for i, s in enumerate(seen["ref"]) if s[2]]
    assert opened and seen["ref"][opened[0]][1] == 3
    assert seen["ref"][-1][0] < 60  # paced, not one attempt a tick


# ------------------------------------------- the reference's runtime tests


@pytest.fixture
def fast_health():
    """Shrink the health-check clock so node-death detection is test-speed;
    must run BEFORE the cluster boots (the GCS health loop caches the
    period at start)."""
    cfg = get_config()
    saved = (cfg.health_check_period_ms, cfg.health_check_timeout_ms)
    cfg.health_check_period_ms = 200
    cfg.health_check_timeout_ms = 1500
    yield cfg
    cfg.health_check_period_ms, cfg.health_check_timeout_ms = saved


def _fleet_nodes(driver):
    return [n for n in driver.gcs.call("get_all_nodes", {}, timeout=10)
            if n.get("alive") and "fleet" in n.get("resources_total", {})]


def _make_autoscaler(cluster, provider, n, cap=2.0, **kw):
    return StandardAutoscaler(
        cluster.gcs_address, provider,
        [NodeType("fleet", {"CPU": 2.0, "fleet": cap},
                  min_workers=n, max_workers=n + 4)],
        update_interval_s=0.2, idle_timeout_s=10_000.0, **kw)


def _await_fleet(driver, provider, n=1, timeout=30.0):
    """Wait until the autoscaler's fleet is up in both views: the GCS
    (raylets register from inside create_node, so this view leads) and the
    provider listing (a node is listed only once fully booted)."""
    deadline = time.monotonic() + timeout
    while (len(_fleet_nodes(driver)) < n
           or len(provider.non_terminated_nodes()) < n):
        assert time.monotonic() < deadline, "fleet never formed"
        time.sleep(0.1)


def _teardown(cluster, autoscaler=None, provider=None):
    """Exception-proof teardown: a provider failure raising here must never
    skip cluster.shutdown()."""
    if autoscaler is not None:
        try:
            autoscaler.stop()
        except Exception:
            pass
    if provider is not None:
        for pid in list(provider.non_terminated_nodes()):
            try:
                provider.terminate_node(pid)
            except Exception:
                pass
    cluster.shutdown()


def _await_stat(autoscaler, key, minimum=1, timeout=10.0):
    deadline = time.monotonic() + timeout
    while autoscaler.stats()[key] < minimum:
        assert time.monotonic() < deadline, \
            f"{key} never reached {minimum}: {autoscaler.stats()}"
        time.sleep(0.05)


def _driver():
    from ray_tpu_torch.core.worker import current_worker

    return current_worker()


def _replaces_dead_node():
    cluster = Cluster()
    cluster.add_node(num_cpus=2, resources={"head": 1})
    cluster.connect()
    provider = FakeNodeProvider(cluster.gcs_address)
    autoscaler = _make_autoscaler(cluster, provider, 1)
    try:
        autoscaler.start()
        driver = _driver()
        _await_fleet(driver, provider)
        victim = provider.non_terminated_nodes()[0]
        victim_hex = provider.raylet_for(victim).node_id.hex()
        provider.kill_node(victim)

        deadline = time.monotonic() + 30
        while True:
            fleet = _fleet_nodes(driver)
            if fleet and all(n["node_id"].hex() != victim_hex
                             for n in fleet):
                break
            assert time.monotonic() < deadline, \
                f"dead node never replaced: {autoscaler.stats()}"
            time.sleep(0.1)
        _await_stat(autoscaler, "relaunches")
        stats = autoscaler.stats()
        assert stats["deaths_by_reason"].get("health_check", 0) >= 1
        # the corpse was reaped at the provider, not left to leak
        assert victim not in provider.non_terminated_nodes()
        # the relaunch is counted in the port's own metric family
        from ray_tpu_torch.util import metrics

        snap = metrics.snapshot("ray_tpu_torch_node_relaunches_total")
        assert sum(snap["ray_tpu_torch_node_relaunches_total"]
                   ["values"].values()) >= 1, snap
    finally:
        _teardown(cluster, autoscaler, provider)


def test_autoscaler_replaces_dead_node(fast_health):
    """A whole-node SIGKILL (no drain notify) is detected by the health
    loop, reaped at the provider, and relaunched to min_workers."""
    rerun_if_killed(_replaces_dead_node)


class _FlakyProvider(FakeNodeProvider):
    """create_node fails N times then works; terminate_node fails once."""

    def __init__(self, gcs_address, create_failures=2):
        super().__init__(gcs_address)
        self.create_calls = 0
        self.create_failures = create_failures
        self.terminate_calls = 0
        self._terminate_failed = False

    def create_node(self, node_type, resources, labels):
        self.create_calls += 1
        if self.create_calls <= self.create_failures:
            raise RuntimeError("cloud API 500 (injected)")
        return super().create_node(node_type, resources, labels)

    def terminate_node(self, provider_node_id):
        self.terminate_calls += 1
        if not self._terminate_failed:
            self._terminate_failed = True
            raise RuntimeError("cloud API timeout (injected)")
        super().terminate_node(provider_node_id)


def _survives_flaky_provider():
    cluster = Cluster()
    cluster.add_node(num_cpus=2, resources={"head": 1})
    cluster.connect()
    provider = _FlakyProvider(cluster.gcs_address, create_failures=2)
    autoscaler = _make_autoscaler(cluster, provider, 1)
    try:
        autoscaler.start()
        driver = _driver()
        _await_fleet(driver, provider)
        _await_stat(autoscaler, "launch_failures", minimum=2)
        _await_stat(autoscaler, "launches")
        assert autoscaler._thread.is_alive()

        # flaky terminate: kill the node; the first terminate raises, the
        # reconcile survives it and the replacement still lands
        victim = provider.non_terminated_nodes()[0]
        provider.kill_node(victim)
        deadline = time.monotonic() + 30
        while autoscaler.stats()["relaunches"] < 1:
            assert time.monotonic() < deadline, \
                f"no relaunch after flaky terminate: {autoscaler.stats()}"
            time.sleep(0.1)
        assert autoscaler._thread.is_alive()
        assert autoscaler.stats()["terminate_failures"] >= 1
    finally:
        provider._terminate_failed = True  # disarm the injected failure
        _teardown(cluster, autoscaler, provider)


def test_autoscaler_survives_flaky_provider(fast_health):
    """A create_node/terminate_node exception must not kill the update
    thread: the loop logs, backs off, and keeps reconciling until the
    fleet forms."""
    rerun_if_killed(_survives_flaky_provider)


class _AlwaysFailingProvider(FakeNodeProvider):
    def __init__(self, gcs_address):
        super().__init__(gcs_address)
        self.create_calls = 0

    def create_node(self, node_type, resources, labels):
        self.create_calls += 1
        raise RuntimeError("cloud is down (injected)")


def test_launch_failure_circuit_breaker(fast_health):
    """A provider that fails every create must not be hot-looped: the
    per-type breaker opens after the threshold and launches are paced by
    full-jitter backoff, so attempts stay far below the tick count."""
    cluster = Cluster()
    cluster.add_node(num_cpus=2, resources={"head": 1})
    cluster.connect()
    provider = _AlwaysFailingProvider(cluster.gcs_address)
    autoscaler = StandardAutoscaler(
        cluster.gcs_address, provider,
        [NodeType("fleet", {"CPU": 2.0}, min_workers=1, max_workers=4)],
        update_interval_s=0.05, idle_timeout_s=10_000.0,
        launch_failure_threshold=3)
    try:
        autoscaler.start()
        time.sleep(1.5)  # ~30 ticks at 50 ms
        stats = autoscaler.stats()
        assert stats["launch_failures"] >= 3, stats
        assert stats["breakers"]["fleet"]["failures"] >= 3
        # without the breaker this would be ~30 attempts (one per tick)
        assert provider.create_calls <= 12, \
            f"breaker did not pace launches: {provider.create_calls} calls"
        assert autoscaler._thread.is_alive()
    finally:
        _teardown(cluster, autoscaler)


def test_fake_provider_terminate_idempotent():
    provider = FakeNodeProvider("127.0.0.1:1")  # never dialed
    # unknown id: no-op, no raise
    provider.terminate_node("fake-never-existed")
    provider.terminate_node("fake-never-existed")


def _actor_restarts_on_replacement_node():
    cluster = Cluster()
    cluster.add_node(num_cpus=2, resources={"head": 1})
    cluster.connect()
    provider = FakeNodeProvider(cluster.gcs_address)
    autoscaler = _make_autoscaler(cluster, provider, 1)
    try:
        autoscaler.start()
        driver = _driver()
        _await_fleet(driver, provider)

        @ray_tpu_torch.remote
        class Pinned:
            def ping(self):
                return os.getpid()

        a = Pinned.options(num_cpus=0, max_restarts=2,
                           resources={"fleet": 1.0}).remote()
        pid0 = ray_tpu_torch.get(a.ping.remote(), timeout=30)
        victim = provider.non_terminated_nodes()[0]
        victim_id = provider.raylet_for(victim).node_id.binary()
        info = driver.get_actor_info(actor_id=a._actor_id)
        assert info["node_id"] == victim_id
        provider.kill_node(victim)

        # the actor must come back on the replacement — a different node id
        deadline = time.monotonic() + 45
        while True:
            info = driver.get_actor_info(actor_id=a._actor_id)
            if info["state"] == "ALIVE" and info["node_id"] != victim_id:
                break
            assert time.monotonic() < deadline, \
                f"actor never restarted on the replacement: {info}"
            time.sleep(0.2)
        pid1 = ray_tpu_torch.get(a.ping.remote(), timeout=30)
        assert pid1 != pid0
        repl = [p for p in provider.non_terminated_nodes() if p != victim]
        repl_ids = {provider.raylet_for(p).node_id.binary() for p in repl
                    if provider.raylet_for(p) is not None}
        assert info["node_id"] in repl_ids
    finally:
        _teardown(cluster, autoscaler, provider)


def test_actor_restarts_on_replacement_node(fast_health):
    """The actor's node dies; the only capacity for it is the autoscaler's
    replacement node (survivors hold no 'fleet'), so the restart must land
    there: the restart path waits for capacity instead of failing."""
    rerun_if_killed(_actor_restarts_on_replacement_node)


def _scales_up_for_demand():
    cluster = Cluster()
    try:
        cluster.add_node(num_cpus=1)
        cluster.connect()
        provider = FakeNodeProvider(cluster.gcs_address)
        autoscaler = StandardAutoscaler(
            cluster.gcs_address, provider,
            [NodeType("cpu4", {"CPU": 4.0}, min_workers=0, max_workers=3)],
            update_interval_s=0.3)
        autoscaler.start()
        try:
            @ray_tpu_torch.remote(num_cpus=4)
            def big_task():
                return "ran"

            # infeasible on the 1-CPU node; the autoscaler must add a node
            ref = big_task.remote()
            assert ray_tpu_torch.get(ref, timeout=90) == "ran"
            assert len(provider.non_terminated_nodes()) >= 1
        finally:
            autoscaler.stop()
            for pid in provider.non_terminated_nodes():
                provider.terminate_node(pid)
    finally:
        cluster.shutdown()


def test_autoscaler_scales_up_for_demand():
    rerun_if_killed(_scales_up_for_demand)
