"""The port's runtime harnesses against ray_tpu's, on the same inputs.

- Flight records: the same spans give records with the same keys.
- Seeded plans: jobstorm's victims and the node and partition storms' kill
  orders come from the seed alone once the cluster is fixed. Both packages'
  storms run against one stand-in cluster (every call answers at once, the
  same way for both), so only their seeded choices can differ, and those
  must be equal.
- Microbenchmark and envelope: the same rows in the same order, the same
  keys and counts at scale 0.01 (no rate is compared: rates are the host's).
- `bench_broadcast_1k`: the same fleet view (GPU/`nvlink_domain` for
  TPU/`tpu_slice`), the same scheduling choices.
- The transfer bench at 24 MiB: the reference's keys.
- `--kill-head`'s verdict: the same synthetic records, the same verdicts.
- Slow: each storm's quick contract on the port (`violations == []`), the
  `--kill-head` storm's artifact under the given path.
"""

import importlib.util
import json
import math
import os
import threading
import time
import types
from pathlib import Path

import pytest

import ray_tpu
import ray_tpu_torch
from torch_runtime import rerun_if_killed

REPO = Path(__file__).resolve().parents[1]
PKGS = {"ref": ray_tpu, "port": ray_tpu_torch}


def _mod(pkg, name):
    return importlib.import_module(f"{PKGS[pkg].__name__}.{name}")


# --------------------------------------------------------- flight records


def test_flight_records_have_the_reference_keys(tmp_path):
    records = {}
    for pkg in PKGS:
        tracing = _mod(pkg, "util.tracing")
        fr = _mod(pkg, "util.flight_recorder")
        tag = f"harness-parity-{pkg}-{os.getpid()}"
        with tracing.span(tag, "storm", phase="fill"):
            pass
        with tracing.ctx_scope(tracing.start_trace()):
            with tracing.span(tag, "storm", phase="traced"):
                pass
        # a gauge and a histogram in each package's registry, whatever ran
        # before in this process, so each kind's keys are compared
        metrics = _mod(pkg, "util.metrics")
        metrics.get_or_create("gauge", f"harness_parity_{pkg}").set(1.0)
        metrics.get_or_create("histogram",
                              f"harness_parity_{pkg}_seconds").observe(0.5)
        path = fr.dump_flight_record(str(tmp_path / f"{pkg}.json"),
                                     ["a violation"], window_s=60.0)
        assert path == fr.flight_record_path(str(tmp_path / f"{pkg}.json"))
        rec = json.loads(Path(path).read_text())
        rec["spans"] = [s for s in rec["spans"] if s["name"] == tag]
        records[pkg] = rec
    ref, port = records["ref"], records["port"]
    assert set(port) == set(ref)
    assert (port["reason"], port["violations"], port["window_s"]) == \
        (ref["reason"], ref["violations"], ref["window_s"])
    assert [sorted(s) for s in port["spans"]] == \
        [sorted(s) for s in ref["spans"]]
    assert len(ref["spans"]) == 2
    assert {tuple(sorted(e)) for e in port["metrics"].values()} <= \
        {tuple(sorted(e)) for e in ref["metrics"].values()}


# ------------------------------------------------------------ seeded plans


class _Proc:
    def __init__(self, pid):
        self.pid = pid

    def poll(self):
        return 0

    def kill(self):
        pass

    def wait(self, timeout=None):
        return 0


class _PlanSeen(Exception):
    """Raised by the stand-in GCS once the storm has made its choices."""


def _jobstorm_plan(pkg, seed, monkeypatch, **profile):
    js = _mod(pkg, "core.jobstorm")
    kills = []

    def spawn(p, gcs, idx, detached):
        lines = [(0.0, f"JOB {idx:08x}"), (0.0, "PUT 00 owner:0"),
                 (0.0, "VICTIM_READY")]
        return {"idx": idx, "proc": _Proc(90000 + idx), "detached": detached,
                "lines": lines, "eof": None, "start": time.monotonic()}

    class Cluster:
        gcs_address = "stub:0"
        _raylets = []

        def add_node(self, **kw):
            pass

        def connect(self):
            pass

        def shutdown(self):
            pass

    class Gcs:
        def call(self, *a, **k):
            raise _PlanSeen

    fake_os = types.SimpleNamespace(
        kill=lambda pid, sig: kills.append(pid - 90000),
        getpid=os.getpid, environ=os.environ, path=os.path,
        pathsep=os.pathsep, listdir=os.listdir)
    fake_time = types.SimpleNamespace(sleep=lambda s: None,
                                      monotonic=time.monotonic,
                                      time=time.time)
    monkeypatch.setattr(js, "Cluster", Cluster)
    monkeypatch.setattr(js, "_spawn_driver", spawn)
    monkeypatch.setattr(js, "os", fake_os)
    monkeypatch.setattr(js, "time", fake_time)
    monkeypatch.setattr(js, "rpc", types.SimpleNamespace(
        connect_with_retry=lambda *a, **k: Gcs()))
    monkeypatch.setattr(PKGS[pkg], "shutdown", lambda: None)
    with pytest.raises(_PlanSeen):
        js.run_jobstorm(js.JobStormProfile(seed=seed, **profile))
    return kills


@pytest.mark.parametrize("profile", [{}, {"n_jobs": 4, "n_kill": 2},
                                     {"n_jobs": 9, "n_kill": 5,
                                      "detached_every": 4}])
def test_jobstorm_kills_the_reference_drivers(profile, monkeypatch):
    plans = set()
    for seed in range(16):
        ref = _jobstorm_plan("ref", seed, monkeypatch, **profile)
        port = _jobstorm_plan("port", seed, monkeypatch, **profile)
        assert port == ref, (seed, port, ref)
        plans.add(tuple(ref))
    assert len(plans) > 1  # the seed, not the code, picks the victims


class _NodeId:
    def __init__(self, i):
        self._b = i.to_bytes(16, "big")

    def hex(self):
        return self._b.hex()

    def binary(self):
        return self._b


class _World:
    """A stand-in cluster for the node and partition storms: every call
    answers at once, and the same way for both packages. Killed or
    partitioned nodes are replaced at once; counters grow on every read,
    so each wait of a storm ends on its first poll."""

    def __init__(self):
        self.nodes = {}          # provider id -> raylet stand-in
        self.kills, self.holds, self.minorities = [], [], []
        self.n = 0
        self.min_workers = 0
        self.on_nodes = None
        self.reads = 0
        self.actors = []

    def launch(self):
        self.n += 1
        r = types.SimpleNamespace(
            node_id=_NodeId(self.n), address=f"10.0.0.{self.n}:7000",
            _worker_pool=types.SimpleNamespace(
                stats=lambda: {"join_to_first_warm_lease_s": 0.1}))
        self.nodes[f"fake-storm-{self.n}"] = r

    def replace(self, pid):
        r = self.nodes.pop(pid)
        if self.on_nodes is not None:
            self.on_nodes({"event": "removed", "node_id": r.node_id})
        self.launch()

    # ---- the provider
    def provider(self, gcs_address):
        w = self
        return types.SimpleNamespace(
            non_terminated_nodes=lambda: list(w.nodes),
            raylet_for=lambda pid: w.nodes.get(pid),
            kill_node=lambda pid, vanish=False: (w.kills.append(pid),
                                                 w.replace(pid)),
            hold_termination=lambda pid: (w.holds.append(pid),
                                          w.replace(pid)),
            release_zombie=lambda pid: None,
            terminate_node=lambda pid: w.nodes.pop(pid, None))

    def autoscaler(self, gcs_address, provider, node_types, **kw):
        w = self
        w.min_workers = node_types[0].min_workers

        def start():
            for _ in range(w.min_workers):
                w.launch()

        def stats():
            w.reads += 1
            return {"relaunches": w.reads}

        return types.SimpleNamespace(start=start, stop=lambda: None,
                                     stats=stats)

    # ---- the cluster and its driver
    def cluster(self, snapshot_uri=None):
        head = types.SimpleNamespace(address="10.0.0.0:7000")
        gcs = types.SimpleNamespace(_snapshot_interval_s=5.0,
                                    address="10.0.0.0:6379",
                                    _fenced=threading.Event(),
                                    kill=lambda: None)
        return types.SimpleNamespace(
            gcs_address="10.0.0.0:6379", gcs=gcs,
            add_node=lambda **kw: head, connect=lambda: None,
            start_standby=lambda: types.SimpleNamespace(
                wait_promoted=lambda t: None),
            shutdown=lambda: None)

    def counters(self):
        self.reads += 1
        k = self.reads
        return {"node_failure": {
            "deaths_total": k, "quarantines_total": k,
            "quarantine_recoveries_total": k, "fences_total": k,
            "stale_incarnation_rejections": 0},
            "fence_epoch": k, "nodes_alive": 64}

    def actor_info(self, actor_id):
        i = int.from_bytes(actor_id, "big")
        self.reads += 1
        return {"state": "ALIVE", "node_id": _NodeId(1 + i % 2).binary(),
                "incarnation": self.reads, "actor_id": actor_id,
                "address": f"actor-{i}"}

    def driver(self):
        w = self

        def call(method, payload=None, timeout=None):
            if method == "get_all_nodes":
                return [{"alive": True, "resources_total": {"fleet": 1.0},
                         "node_id": r.node_id.binary(),
                         "address": r.address} for r in w.nodes.values()]
            if method == "gcs_stats":
                return w.counters()
            if method == "get_actor_info":
                return w.actor_info(payload["actor_id"])
            raise AssertionError(method)

        def subscribe(channel, cb):
            w.on_nodes = cb

        return types.SimpleNamespace(
            gcs=types.SimpleNamespace(call=call),
            subscribe_channel=subscribe,
            get_actor_info=lambda actor_id: w.actor_info(actor_id),
            _actor_seq_lock=threading.Lock(), _actor_addresses={},
            _actor_incarnations={}, stale_reply_rejections=0)

    # ---- the API the storms call
    def remote(self, cls):
        w = self

        class Ref:
            def __init__(self, v):
                self.v = v

        class Method:
            def remote(self, *a):
                return Ref((4242, 1))

        class Actor:
            def __init__(self):
                self._actor_id = len(w.actors).to_bytes(16, "big")
                w.actors.append(self)
                self.ping = self.work = Method()

        class Remote:
            def options(self, **kw):
                return self

            def remote(self):
                return Actor()

        w.Ref, w.Actor = Ref, Actor
        return Remote()

    def get(self, x, timeout=None):
        return [r.v for r in x] if isinstance(x, list) else x.v

    def injector(self, spec, seed=0):
        w = self
        groups = {}

        def define_group(name, members):
            groups[name] = set(members)

        def partition(a, b):
            w.minorities.append(sorted(groups[a]))

        return types.SimpleNamespace(define_group=define_group,
                                     partition=partition, heal=lambda: 0,
                                     stats={"partition": 0})


class _Load:
    def __init__(self, *a, **k):
        pass

    def start(self):
        pass

    def add_actors(self, actors):
        pass

    def stop(self):
        return {"completed": 0, "errored": 0, "hung": 0}


def _storm_plan(pkg, kind, seed, monkeypatch):
    rt = PKGS[pkg]
    burst = _mod(pkg, "core.burst")
    w = _World()
    for mod, name, value in (
            (_mod(pkg, "autoscaler"), "FakeNodeProvider", w.provider),
            (_mod(pkg, "autoscaler"), "StandardAutoscaler", w.autoscaler),
            (_mod(pkg, "core.cluster"), "Cluster", w.cluster),
            (_mod(pkg, "core.worker"), "current_worker", w.driver),
            (_mod(pkg, "core.rpc"), "install_fault_injector", w.injector),
            (_mod(pkg, "core.rpc"), "clear_fault_injector", lambda: None),
            (rt, "remote", w.remote), (rt, "get", w.get),
            (rt, "kill", lambda a: None),
            (rt, "get_actor", lambda name: w.Actor()),
            (burst, "_LoadGen", _Load),
            (burst, "time", types.SimpleNamespace(
                sleep=lambda s: None, monotonic=time.monotonic,
                perf_counter=time.perf_counter))):
        monkeypatch.setattr(mod, name, value)
    if kind == "nodes":
        burst.run_node_storm(burst.NodeStormProfile(
            n_nodes=4, n_node_kills=4, seed=seed, settle_timeout_s=2.0,
            detect_timeout_s=2.0))
        return w.kills
    burst.run_partition_storm(burst.PartitionStormProfile(
        n_nodes=4, n_partitions=3, quarantine_cycles=2,
        head_in_minority=False, seed=seed, settle_timeout_s=2.0,
        partition_hold_s=0.0, quarantine_hold_s=0.0))
    return w.holds, w.minorities


@pytest.mark.parametrize("kind", ["nodes", "partition"])
def test_storm_kill_order_matches_reference(kind, monkeypatch):
    plans = set()
    for seed in range(8):
        ref = _storm_plan("ref", kind, seed, monkeypatch)
        port = _storm_plan("port", kind, seed, monkeypatch)
        assert port == ref, (seed, port, ref)
        plans.add(json.dumps(ref))
    assert len(plans) > 1  # the seed picks the victims


# ------------------------------------------- microbenchmark and envelope


@pytest.fixture(scope="module")
def envelopes():
    """`run_envelope(scale=0.01)` of each package, each on a runtime of its
    own, with the quick microbenchmark (the same rows at short timers)."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for pkg in ("ref", "port"):
            micro = _mod(pkg, "microbenchmark")
            full = micro.run_microbenchmark
            mp.setattr(micro, "run_microbenchmark",
                       lambda batch=100, quick=False, _f=full:
                       _f(batch=batch, quick=True))
            env = _mod(pkg, "envelope")
            assert not PKGS[pkg].is_initialized()
            out[pkg] = rerun_if_killed(env.run_envelope, 0.01)
            assert not PKGS[pkg].is_initialized()
    finally:
        mp.undo()
    return out


def test_microbenchmark_rows_match_reference(envelopes):
    names = {pkg: [r["benchmark"] for r in art["microbenchmark"]]
             for pkg, art in envelopes.items()}
    assert names["port"] == names["ref"]
    for r in envelopes["port"]["microbenchmark"]:
        assert math.isfinite(r["rate"]) and r["rate"] > 0, r
    units = {pkg: [r["unit"] for r in art["microbenchmark"]]
             for pkg, art in envelopes.items()}
    assert units["port"] == units["ref"]


def test_envelope_keys_and_counts_match_reference(envelopes):
    ref, port = envelopes["ref"], envelopes["port"]
    assert set(port) == set(ref)
    for key in ("queued_tasks", "concurrent_actors", "placement_groups",
                "broadcast_1k_nodes", "broadcast"):
        assert set(port[key]) == set(ref[key]), key
    counts = ("n_tasks", "n_actors", "distinct_workers", "n_pgs",
              "n_nodes", "n_changed", "size_mib", "n_receivers")
    for key in ("queued_tasks", "concurrent_actors", "placement_groups",
                "broadcast_1k_nodes", "broadcast"):
        for c in counts:
            if c in ref[key]:
                assert port[key][c] == ref[key][c], (key, c)
    # the counts tests/test_envelope.py asserts of the reference
    assert port["queued_tasks"]["n_tasks"] == 200
    assert port["concurrent_actors"]["n_actors"] == 2
    assert port["concurrent_actors"]["distinct_workers"] == 2
    assert port["placement_groups"]["n_pgs"] == 1
    assert port["broadcast"]["aggregate_gbps"] > 0
    assert set(ref["hardware"]) <= set(port["hardware"])
    assert {"gpu", "gpu_power_limit"} <= set(port["hardware"])


def test_broadcast_1k_schedules_like_the_reference(monkeypatch):
    """The 1,000-node view in GPU terms: the same wire sizes' shape and the
    same node chosen by every select_node call of the bench, beside direct
    GPU/TPU demands on the same view."""
    picks, views = {}, {}
    for pkg in PKGS:
        sched = _mod(pkg, "core.scheduler")
        seen = picks.setdefault(pkg, [])
        orig = sched.SchedulingPolicy.select_node

        def select(self, nodes, demand, *a, _o=orig, _s=seen, _v=views,
                   _p=pkg, **k):
            _v[_p] = nodes
            out = _o(self, nodes, demand, *a, **k)
            _s.append(out)
            return out

        monkeypatch.setattr(sched.SchedulingPolicy, "select_node", select)
        out = _mod(pkg, "envelope").bench_broadcast_1k(n_nodes=200)
        assert out["n_nodes"] == 200
    assert picks["port"] == picks["ref"] and len(picks["ref"]) == 51
    # the accelerator demand on the same fleet view
    for demand in ({"CPU": 1.0, "TPU": 2.0}, {"CPU": 8.0, "TPU": 1.0},
                   {"TPU": 3.0}):
        got = {}
        for pkg in PKGS:
            d = demand if pkg == "ref" else {
                ("GPU" if k == "TPU" else k): v for k, v in demand.items()}
            got[pkg] = _mod(pkg, "core.scheduler").SchedulingPolicy() \
                .select_node(views[pkg], d)
        assert got["port"] == got["ref"], demand
    assert {"GPU", "CPU", "memory"} == set(views["port"][0].total)
    assert views["port"][0].labels == {"nvlink_domain": "s0"}


# ----------------------------------------------------------- the transfer


def test_transfer_bench_gives_the_reference_keys():
    spec = importlib.util.spec_from_file_location("_root_bench",
                                                  REPO / "bench.py")
    root_bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(root_bench)
    from ray_tpu_torch import bench

    ref = root_bench._bench_transfer(24)
    port = bench._bench_transfer(24)
    assert set(port) == set(ref)
    assert port["transfer_mib"] == ref["transfer_mib"] == 24
    assert port["transfer_gbps"] > 0 and \
        port["loopback_tcp_1stream_gbps"] > 0


# --------------------------------------------------- --kill-head verdicts


def _storm_result():
    return {"seed": 3, "duration_s": 10.0, "offered_rps": 320.0,
            "zero_hung": True, "replicas": {"kills": 2},
            "requests": {"submitted": 1000, "accepted": 700, "shed": 200,
                         "timeout": 60, "replica_death": 30,
                         "other_error": 10, "hung": 0}}


HEAD_RECORDS = {
    "promoted_within_budget": {
        "epoch_before": 1, "epoch_after": 2, "new_address": "10.0.0.2:6379",
        "promotion": {"latency_s": 0.4, "tailed_version": 7}},
    "promoted_over_budget": {
        "epoch_before": 1, "epoch_after": 2, "new_address": "10.0.0.2:6379",
        "promotion": {"latency_s": 9.5, "tailed_version": 7}},
    "never_promoted": {
        "epoch_before": 1, "error": "promotion failed: timed out"},
}


@pytest.mark.parametrize("case", sorted(HEAD_RECORDS))
def test_kill_head_verdicts_match_reference(case, tmp_path, monkeypatch,
                                            capsys):
    got = {}
    for pkg in PKGS:
        storm = _mod(pkg, "serve.storm")
        env = _mod(pkg, "envelope")
        # a 64-node fleet keeps the verdict's broadcast row quick
        monkeypatch.setattr(env, "bench_broadcast_1k",
                            lambda _f=env.bench_broadcast_1k: _f(64))
        path = tmp_path / f"{pkg}.json"
        args = types.SimpleNamespace(promotion_budget=2.0, lease_ttl=1.0,
                                     headfail_json=str(path))
        failed = storm._report_head_kill(dict(HEAD_RECORDS[case]),
                                         _storm_result(), args)
        got[pkg] = (failed, json.loads(path.read_text()))
    (rf, ra), (pf, pa) = got["ref"], got["port"]
    assert pf == rf == (case != "promoted_within_budget")
    assert set(pa) == set(ra)
    assert pa["passed"] == ra["passed"] == (not rf)
    assert pa["storm"] == ra["storm"]
    assert pa["promotion_latency_s"] == ra["promotion_latency_s"]
    assert set(pa["broadcast_1k_nodes"]) == set(ra["broadcast_1k_nodes"])
    capsys.readouterr()


def test_kill_head_no_longer_raises_and_defaults_under_build():
    from ray_tpu_torch.serve import storm

    assert Path(storm.HEADFAIL_ARTIFACT).parent == REPO / "build"
    assert Path(storm.HEADFAIL_ARTIFACT).name == "HEADFAIL_torch.json"
    assert storm.KILLHEAD_QUICK_PROFILE == _mod(
        "ref", "serve.storm").KILLHEAD_QUICK_PROFILE



# ------------------------------- jobstorm's survivors on a slow-start host


def test_dead_owner_does_not_hold_a_live_owners_results():
    """A worker's result flush serves its owners one after another. A
    dead owner's port refuses at once, and the flush must move on: the
    live owner behind it gets its result at once (ray_tpu's flush dials
    with a 30 s retry loop first, which starved jobstorm's survivors after
    a kill on the GPU host)."""
    import socket
    import threading

    from ray_tpu_torch.core import rpc
    from ray_tpu_torch.core.result_buffer import ResultBuffer
    from ray_tpu_torch.core.worker import CoreWorker

    got = []
    srv = rpc.RpcServer("127.0.0.1")
    srv.register("report_task_result",
                 lambda conn, req_id, payload: got.append(
                     (time.monotonic(), payload)))
    srv.start()
    with socket.socket() as s:  # a port nothing listens on
        s.bind(("127.0.0.1", 0))
        dead = f"127.0.0.1:{s.getsockname()[1]}"
    w = types.SimpleNamespace(_peers={}, _peers_lock=threading.Lock(),
                              _shutdown=threading.Event(),
                              raylet_address="127.0.0.1:0", actor_id=None)
    w.peer = types.MethodType(CoreWorker.peer, w)
    buf = ResultBuffer(w)
    try:
        t0 = time.monotonic()
        buf.report(dead, b"t-dead", [1])
        buf.report(srv.address, b"t-live", [2])
        deadline = t0 + 20
        while not got and time.monotonic() < deadline:
            time.sleep(0.02)
        assert got, "the live owner never got its result"
        assert got[0][0] - t0 < 5.0, got[0][0] - t0
        assert got[0][1]["batch"] == [(b"t-live", [2])]
    finally:
        buf.stop()
        srv.stop()


def test_jobstorm_warms_every_template_before_its_drivers():
    """Every node's default-env template is booted, and each waited for,
    before the drivers start (the port's template imports torch, seconds
    on a GPU host)."""
    from ray_tpu_torch.core import jobstorm

    class _Pool:
        def __init__(self, boot_s):
            self.boot_s, self._templates, self.asked = boot_s, {}, []

        def prewarm(self, hot_envs):
            self.asked.append(list(hot_envs))
            slot = types.SimpleNamespace(state="booting")
            self._templates[None] = slot

            def boot():
                time.sleep(self.boot_s)
                slot.state = "ready"

            threading.Thread(target=boot, daemon=True).start()

    pools = [_Pool(0.3), _Pool(0.6)]
    cluster = types.SimpleNamespace(_raylets=[
        types.SimpleNamespace(_worker_pool=p) for p in pools])
    took = jobstorm._warm_templates(cluster)
    assert [p.asked for p in pools] == [[[{"env_key": None}]]] * 2
    assert all(p._templates[None].state == "ready" for p in pools)
    assert 0.6 <= took < 5.0


# ------------------------------------------------ the storms' contracts


def _seed():
    return int(os.environ.get("RAY_TPU_TORCH_FAULT_INJECTION_SEED",
                              "20260807"))


@pytest.mark.slow
def test_memstorm_quick_contract_holds(tmp_path):
    from ray_tpu_torch.core.memstorm import (MemStormProfile, QUICK_PROFILE,
                                             run_memstorm)

    artifact = str(tmp_path / "STORESTORM.json")
    result = rerun_if_killed(
        run_memstorm, MemStormProfile(**dict(QUICK_PROFILE, seed=_seed())),
        artifact)
    assert result["violations"] == [] and result["ok"], result["violations"]
    c = result["counters"]
    assert c["spilled_bytes_total"] > 0 and c["restored_bytes_total"] > 0
    assert c["spill_failures"].get("enospc", 0) > 0
    assert c["lost_spills"] > 0 and c["puts_rejected_typed"] >= 1
    assert c["degraded_enters"] >= 1 and c["degraded_heals"] >= 1
    assert result["phases"]["oom"]["oom_kills"] >= 1
    assert json.loads(Path(artifact).read_text())["ok"]


@pytest.mark.slow
def test_jobstorm_quick_contract_holds(tmp_path):
    from ray_tpu_torch.core.jobstorm import (JobStormProfile, QUICK_PROFILE,
                                             run_jobstorm)

    result = rerun_if_killed(
        run_jobstorm, JobStormProfile(**dict(QUICK_PROFILE, seed=_seed())),
        str(tmp_path / "JOBSTORM.json"))
    assert result["violations"] == [] and result["ok"], result["violations"]
    assert result["zero_leaks"] and result["detached_survived"]
    assert result["phases"]["survivors"]["cuda_contexts"] == 0
    assert result["counters"]["jobs_reaped"] >= 2


def _burst(profile, out):
    from ray_tpu_torch.core.burst import run_burst

    ray_tpu_torch.init(num_cpus=8)
    try:
        return run_burst(profile, out_path=out)
    finally:
        ray_tpu_torch.shutdown()


@pytest.mark.slow
def test_burst_quick_contract_holds(tmp_path):
    from ray_tpu_torch.core.burst import BurstProfile, QUICK_PROFILE

    result = rerun_if_killed(_burst, BurstProfile(**dict(QUICK_PROFILE,
                                                         seed=_seed())),
                             str(tmp_path / "BURST.json"))
    assert result["violations"] == [] and result["ok"], result["violations"]
    assert result["chaos"]["kills"] >= 1
    assert result["chaos"]["actors_recovered"] == result["profile"][
        "n_target"]


@pytest.mark.slow
def test_node_storm_quick_contract_holds(tmp_path):
    from ray_tpu_torch.core.burst import (NODE_QUICK_PROFILE,
                                          NodeStormProfile, run_node_storm)

    result = rerun_if_killed(
        run_node_storm,
        NodeStormProfile(**dict(NODE_QUICK_PROFILE, seed=_seed())),
        str(tmp_path / "NODESTORM.json"))
    assert result["violations"] == [] and result["ok"], result["violations"]
    assert result["chaos"]["detected"] == result["chaos"]["node_kills"] >= 1


@pytest.mark.slow
def test_partition_storm_quick_contract_holds(tmp_path):
    from ray_tpu_torch.core.burst import (PARTITION_QUICK_PROFILE,
                                          PartitionStormProfile,
                                          run_partition_storm)

    result = rerun_if_killed(
        run_partition_storm,
        PartitionStormProfile(**dict(PARTITION_QUICK_PROFILE,
                                     seed=_seed())),
        str(tmp_path / "PARTITION.json"))
    assert result["violations"] == [] and result["ok"], result["violations"]
    assert result["counters"]["fences_total"] >= 1


@pytest.mark.slow
def test_cross_node_burst_quick_contract_holds(tmp_path):
    from ray_tpu_torch.core.burst import (CROSS_QUICK_PROFILE,
                                          CrossNodeBurstProfile,
                                          run_cross_node_burst)

    result = rerun_if_killed(
        run_cross_node_burst,
        CrossNodeBurstProfile(**dict(CROSS_QUICK_PROFILE, seed=_seed())),
        str(tmp_path / "CROSSBURST.json"))
    assert result["violations"] == [] and result["ok"], result["violations"]
    assert result["scale_up"]["nodes_used"] >= 2


@pytest.mark.slow
def test_kill_head_storm_writes_its_artifact_where_asked(tmp_path):
    from ray_tpu_torch.serve import storm

    reference = (REPO / "HEADFAIL_r11.json").read_bytes()
    headfail = tmp_path / "HEADFAIL.json"
    rc = rerun_if_killed(storm.main, [
        "--kill-head", "--quick", "--json", str(tmp_path / "storm.json"),
        "--headfail-json", str(headfail)])
    art = json.loads(headfail.read_text())
    assert art["bench"] == "head_failover_storm"
    assert art["storm"]["zero_hung"]
    assert art["epochs"]["after"] > art["epochs"]["before"]
    assert art["promotion_latency_s"] is not None
    # the verdict's error-spike and latency bounds are the reference's,
    # calibrated by core count; both packages' verdicts vary from run to
    # run on a loaded host, so the exit code is held to the verdict
    assert rc == (0 if art["passed"] else 1), art
    # the JAX package's artifact is never written
    assert (REPO / "HEADFAIL_r11.json").read_bytes() == reference
