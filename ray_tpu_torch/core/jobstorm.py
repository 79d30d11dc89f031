"""Job storm: the job failure domain under fire.

N concurrent driver *processes* (separate OS processes joining one cluster)
each run nested task trees, named + detached actors, and large plasma puts.
A seeded subset is SIGKILLed mid-flight — the exact failure the driver-death
fate-sharing path (gcs.py `_on_driver_conn_close` -> `_reap_job`) exists for.
The harness then asserts the blast radius is exactly one job wide:

  - every killed job is marked DEAD and fully reaped (workers killed, queued
    tasks cancelled, primary object copies dropped, function exports freed)
    within `reap_bound_s` of the SIGKILL;
  - detached actors owned by the corpses survive and answer a *fresh* driver
    process by name, with their pre-kill state intact;
  - cross-job `get()` of a reaped job's object raises the typed
    `OwnerDiedError` — never a hang, never a bare socket error;
  - surviving drivers keep making progress: their task throughput during the
    kill window stays above a CPU-calibrated fraction of their pre-storm
    baseline, and every one of them drains CLEAN (exit 0, no hung get);
  - nothing leaks: no worker process, queued task, or object-table entry
    still attributed to a dead job after the reap settles, and no /dev/shm
    segment of any store survives cluster shutdown.

Run `python -m ray_tpu_torch.core.jobstorm --quick` for the CI profile.
The CLI writes its artifact to `build/JOBSTORM_torch.json` unless `--json`
says otherwise (git ignores build/; the JAX package's JOBSTORM_r20.json is
never written). The same module doubles as the victim / verifier driver
entrypoint (`--victim`, `--verify`) so the remote functions live in an
importable module, not a `-c` __main__. No driver asks for a card, so none
makes a CUDA context, and the storm runs on any host.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import random
import signal
import subprocess
import sys
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.core import rpc
from ray_tpu_torch.core.cluster import Cluster
from ray_tpu_torch.core.exceptions import OwnerDiedError
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.object_ref import ObjectRef

logger = logging.getLogger(__name__)

_REPO_ROOT = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", ".."))
DEFAULT_ARTIFACT = str(Path(_REPO_ROOT) / "build" / "JOBSTORM_torch.json")


# ----------------------------------------------------------------- workload

@ray_tpu_torch.remote
def _storm_leaf(x):
    return x + 1


# Near-zero CPU demand: tree parents BLOCK in get() while their children run,
# and a blocked parent does not release its CPU grant — at full fanout the
# inner nodes would deadlock the cluster if each held a whole core.
@ray_tpu_torch.remote(num_cpus=0.05)
def _storm_tree(depth, fanout):
    """Nested task tree; returns the node count of the subtree."""
    if depth <= 0:
        return 1
    refs = [_storm_tree.remote(depth - 1, fanout) for _ in range(fanout)]
    return 1 + sum(ray_tpu_torch.get(refs, timeout=120.0))


@ray_tpu_torch.remote
class StormCounter:
    def __init__(self):
        self._n = 0

    def bump(self):
        self._n += 1
        return self._n

    def value(self):
        return self._n


# ------------------------------------------------------------------ profile

@dataclass
class JobStormProfile:
    n_jobs: int = 6            # concurrent driver processes
    n_kill: int = 3            # SIGKILLed mid-flight (seeded choice)
    detached_every: int = 2    # every k-th driver also owns a detached actor
    driver_duration_s: float = 22.0
    baseline_s: float = 4.0    # pre-kill throughput measurement window
    kill_gap_s: float = 1.2    # stagger between SIGKILLs
    tick_sleep_s: float = 0.15
    fanout: int = 2
    tree_depth: int = 2
    put_mb: float = 4.0        # large plasma put pinned by each driver
    reap_bound_s: float = 6.0  # SIGKILL -> job DEAD + reaped
    get_timeout_s: float = 60.0   # every driver-side get is bounded by this
    drain_grace_s: float = 30.0
    seed: int = 0


QUICK_PROFILE: Dict[str, Any] = dict(
    n_jobs=4, n_kill=2, driver_duration_s=14.0, baseline_s=3.0,
    kill_gap_s=1.0, tree_depth=1, put_mb=1.0, drain_grace_s=25.0,
)


def full_profile_kwargs() -> Dict[str, Any]:
    """Machine calibration for the FULL profile (the quick CI profile is
    light enough to hold its defaults everywhere): the storm's job count
    and bounds assume ~8 effective CPUs. On smaller boxes only the
    TIMEOUTS stretch — the load stays, the patience grows — so pure
    timesharing (6 driver processes + cluster + workers on one core)
    doesn't convert slow ticks into false hung-call violations. The
    drain grace must cover a worst-case final-tick get, so it tracks
    the stretched get timeout."""
    try:
        n = len(os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        n = os.cpu_count() or 1
    kw: Dict[str, Any] = {}
    if n < 8:
        f = 8.0 / max(1, n)
        kw["get_timeout_s"] = min(240.0, 60.0 * f)
        kw["reap_bound_s"] = min(15.0, 6.0 * f)
        kw["tick_sleep_s"] = 0.25
        kw["drain_grace_s"] = kw["get_timeout_s"] + 30.0
    return kw


def throughput_floor_frac() -> float:
    """Survivor throughput floor during the storm, as a fraction of the
    pre-kill baseline — machine-calibrated like serve.storm's
    error_spike_bound(): 0.25 at >= 8 effective CPUs, linearly relaxed
    to 0.05 on a single-core box where driver respawn churn alone can
    eat most of the machine."""
    try:
        n = len(os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        n = os.cpu_count() or 1
    if n >= 8:
        return 0.25
    return max(0.05, 0.25 * n / 8.0)


# ---------------------------------------------------- victim / verifier CLI

def run_victim(args) -> int:
    """One storm driver: register, create a named (+ optionally detached)
    counter actor, pin a large put, then tick task trees until the duration
    elapses — or until the host SIGKILLs us mid-tick.  Every get is bounded
    by --get-timeout so a hang is a *detected* failure, not a stuck CI job.
    Protocol lines on stdout (flush=True): JOB / DET / PUT / VICTIM_READY /
    TICK <n> <completed> / CUDA_CONTEXT <0|1> / CLEAN <completed> /
    DRIVER_ERROR <msg>. CUDA_CONTEXT says whether this driver, which never
    asks for a card, made a CUDA context (it must not)."""
    try:
        ray_tpu_torch.init(address=args.address)
        from ray_tpu_torch.core.api import _global_worker
        w = _global_worker()
        print(f"JOB {w.job_id.hex()}", flush=True)
        to = args.get_timeout
        cnt = StormCounter.options(name=f"storm-cnt-{args.index}").remote()
        det = None
        if args.detached:
            det = StormCounter.options(
                name=f"storm-det-{args.index}", lifetime="detached").remote()
            # Pre-kill state the post-mortem verifier asserts on.
            ray_tpu_torch.get(det.bump.remote(), timeout=to)
            print(f"DET storm-det-{args.index}", flush=True)
        pin = ray_tpu_torch.put(b"\x5a" * int(args.put_mb * 1024 * 1024))
        print(f"PUT {pin.hex()} {pin.owner_address}", flush=True)
        print("VICTIM_READY", flush=True)

        deadline = time.monotonic() + args.duration
        ticks = completed = 0
        while time.monotonic() < deadline:
            refs = [_storm_leaf.remote(i) for i in range(2)]
            refs.append(_storm_tree.remote(args.tree_depth, args.fanout))
            vals = ray_tpu_torch.get(refs, timeout=to)
            completed += len(refs) - 1 + vals[-1]  # leaves + tree node count
            ray_tpu_torch.get(cnt.bump.remote(), timeout=to)
            completed += 1
            ticks += 1
            print(f"TICK {ticks} {completed}", flush=True)
            time.sleep(args.tick_sleep)
        if det is not None:
            ray_tpu_torch.get(det.bump.remote(), timeout=to)
        assert pin is not None  # keep the put pinned for the whole run
        print(f"CUDA_CONTEXT {int(_cuda_initialized())}", flush=True)
        print(f"CLEAN {completed}", flush=True)
        ray_tpu_torch.shutdown()
        return 0
    except BaseException as e:  # noqa: BLE001 - reported to the host verbatim
        print(f"DRIVER_ERROR {type(e).__name__}: {e}", flush=True)
        return 1


def run_verifier(args) -> int:
    """The 'next driver': a FRESH process that joins the cluster after the
    kills and resolves each dead job's detached actor by name — the
    proof that detached lifetime really outlives its owner.
    Prints `DETOK <name> <value-before> <value-after-bump>` per actor."""
    try:
        ray_tpu_torch.init(address=args.address)
        to = args.get_timeout
        for name in [n for n in args.names.split(",") if n]:
            h = ray_tpu_torch.get_actor(name)
            v = ray_tpu_torch.get(h.value.remote(), timeout=to)
            b = ray_tpu_torch.get(h.bump.remote(), timeout=to)
            print(f"DETOK {name} {v} {b}", flush=True)
        ray_tpu_torch.shutdown()
        return 0
    except BaseException as e:  # noqa: BLE001
        print(f"VERIFY_ERROR {type(e).__name__}: {e}", flush=True)
        return 1


def _cuda_initialized() -> bool:
    """Whether this process made a CUDA context; asks without making one."""
    torch = sys.modules.get("torch")
    return torch is not None and torch.cuda.is_initialized()


# ------------------------------------------------------------- host harness

def _pump(rec: Dict[str, Any]) -> None:
    try:
        for line in rec["proc"].stdout:
            rec["lines"].append((time.monotonic(), line.rstrip("\n")))
    except Exception:
        pass
    rec["eof"] = time.monotonic()


def _tagged(rec: Dict[str, Any], tag: str) -> List:
    return [(t, ln) for t, ln in list(rec["lines"])
            if ln == tag or ln.startswith(tag + " ")]


def _wait_line(rec: Dict[str, Any], tag: str, timeout: float):
    deadline = time.monotonic() + timeout
    while True:
        hits = _tagged(rec, tag)
        if hits:
            return hits[0]
        if rec["proc"].poll() is not None and rec["eof"] is not None:
            hits = _tagged(rec, tag)
            return hits[0] if hits else None
        if time.monotonic() >= deadline:
            return None
        time.sleep(0.05)


def _completed_at(rec: Dict[str, Any], t_edge: float) -> int:
    best = 0
    for t, ln in list(rec["lines"]):
        if ln.startswith("TICK ") and t <= t_edge:
            best = int(ln.split()[2])
    return best


def _spawn_driver(p: JobStormProfile, gcs: str, idx: int,
                  detached: bool) -> Dict[str, Any]:
    argv = [sys.executable, "-m", "ray_tpu_torch.core.jobstorm", "--victim",
            "--address", gcs, "--index", str(idx),
            "--duration", str(p.driver_duration_s),
            "--put-mb", str(p.put_mb), "--fanout", str(p.fanout),
            "--tree-depth", str(p.tree_depth),
            "--tick-sleep", str(p.tick_sleep_s),
            "--get-timeout", str(p.get_timeout_s)]
    if detached:
        argv.append("--detached")
    env = dict(os.environ)
    env["PYTHONPATH"] = _REPO_ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env)
    rec: Dict[str, Any] = {"idx": idx, "proc": proc, "detached": detached,
                           "lines": [], "eof": None, "start": time.monotonic()}
    threading.Thread(target=_pump, args=(rec,), daemon=True,
                     name=f"jobstorm-pump-{idx}").start()
    return rec


def _warm_templates(cluster: Cluster, timeout: float = 90.0) -> float:
    """Boot every node's default-env fork template before the drivers
    start, and wait for each (returns the seconds it took). The port's
    template imports torch, 6-11 s cold on a GPU host: a storm begun
    before that would measure the boots, not the job failure domain (a
    survivor's task spilled to a node whose template was still booting
    waited out the import while the other node had idle workers)."""
    t0 = time.monotonic()
    for r in cluster._raylets:
        r._worker_pool.prewarm([{"env_key": None}])
    deadline = t0 + timeout
    for r in cluster._raylets:
        while time.monotonic() < deadline:
            slot = r._worker_pool._templates.get(None)
            if slot is not None and slot.state in ("ready", "failed",
                                                   "cold_only"):
                break
            time.sleep(0.05)
    return time.monotonic() - t0


def run_jobstorm(profile: Optional[JobStormProfile] = None,
                 out_path: Optional[str] = None) -> Dict[str, Any]:
    p = profile or JobStormProfile()
    assert p.n_kill < p.n_jobs, "need at least one surviving driver"
    rng = random.Random(p.seed)
    violations: List[str] = []
    phases: Dict[str, Any] = {}
    cluster: Optional[Cluster] = None
    drivers: List[Dict[str, Any]] = []
    stats_c = None
    t0 = time.monotonic()
    try:
        cluster = Cluster()
        cluster.add_node(num_cpus=8)
        cluster.add_node(num_cpus=4)
        cluster.connect()
        # the leak sweep looks only at this cluster's own stores: each
        # prefix is `rtt-<this pid>-<random>-`, so segments of the JAX
        # runtime, of other processes and of earlier clusters never count
        shm_prefixes = [r.store._prefix for r in cluster._raylets]
        stats_c = rpc.connect_with_retry(cluster.gcs_address, timeout=10)
        phases["warm_templates_s"] = round(_warm_templates(cluster), 2)

        def gcs_jobs() -> Dict[str, dict]:
            st = stats_c.call("gcs_stats", timeout=10)
            return {j["job_id"]: j for j in st.get("jobs", [])}

        # ---- spawn N driver processes and wait for their steady state
        for i in range(p.n_jobs):
            drivers.append(_spawn_driver(p, cluster.gcs_address, i,
                                         detached=(i % p.detached_every == 0)))
        for rec in drivers:
            if _wait_line(rec, "VICTIM_READY", timeout=90.0) is None:
                violations.append(f"driver {rec['idx']} never became ready")
            jl = _tagged(rec, "JOB")
            pl = _tagged(rec, "PUT")
            rec["job_hex"] = jl[0][1].split()[1] if jl else None
            if pl:
                _, oid_hex, owner = pl[0][1].split()
                rec["put"] = (oid_hex, owner)
        if violations:
            raise RuntimeError(f"spawn failed: {violations}")
        t_ready = time.monotonic()
        phases["spawn"] = {"drivers": p.n_jobs,
                           "detached_owners":
                               sum(1 for r in drivers if r["detached"]),
                           "s": round(t_ready - t0, 2)}

        # ---- baseline throughput window
        time.sleep(p.baseline_s)

        # ---- the storm: seeded staggered SIGKILLs, >=1 detached owner dies
        kill_idx = sorted(rng.sample(range(p.n_jobs), p.n_kill))
        if not any(drivers[i]["detached"] for i in kill_idx):
            owners = [i for i in range(p.n_jobs) if drivers[i]["detached"]]
            kill_idx = sorted(set(kill_idx[1:] + [rng.choice(owners)]))
        t_first_kill = time.monotonic()
        for i in kill_idx:
            rec = drivers[i]
            os.kill(rec["proc"].pid, signal.SIGKILL)
            rec["killed_mono"] = time.monotonic()
            rec["killed_wall"] = time.time()
            time.sleep(p.kill_gap_s)

        # every killed job must go DEAD + carry a reap record within bound
        reap_lat: Dict[int, float] = {}
        for i in kill_idx:
            rec = drivers[i]
            deadline = rec["killed_mono"] + p.reap_bound_s
            entry = None
            while time.monotonic() < deadline:
                entry = gcs_jobs().get(rec["job_hex"])
                if entry and entry.get("status") == "DEAD" \
                        and entry.get("reap"):
                    break
                time.sleep(0.1)
            if not (entry and entry.get("status") == "DEAD"
                    and entry.get("reap")):
                violations.append(
                    f"job {rec['job_hex']} (driver {i}) not reaped within "
                    f"{p.reap_bound_s}s of SIGKILL")
            else:
                reap_lat[i] = max(0.0, entry["end_time"] - rec["killed_wall"])
        t_storm_end = time.monotonic()

        # ---- leak scan: nothing may still be attributed to a dead job
        dead_bin = {bytes.fromhex(drivers[i]["job_hex"]) for i in kill_idx
                    if drivers[i]["job_hex"]}
        leaked_workers = leaked_objs = -1
        settle_deadline = time.monotonic() + 5.0
        while time.monotonic() < settle_deadline:
            leaked_workers = leaked_objs = 0
            dead_handle_pids = 0
            for r in cluster._raylets:
                with r._lock:
                    for h in r._workers.values():
                        if (h.current_task is not None
                                and h.current_task.job_id.binary()
                                in dead_bin):
                            leaked_workers += 1
                        try:
                            os.kill(h.pid, 0)
                        except OSError:
                            dead_handle_pids += 1
                    leaked_objs += sum(1 for jid in r._obj_jobs.values()
                                       if jid in dead_bin)
            if leaked_workers == 0 and leaked_objs == 0 \
                    and dead_handle_pids == 0:
                break
            time.sleep(0.2)
        if leaked_workers:
            violations.append(
                f"{leaked_workers} worker(s) still running dead jobs' tasks")
        if leaked_objs:
            violations.append(
                f"{leaked_objs} object(s) still attributed to dead jobs")
        jobs_now = gcs_jobs()
        stranded_actors = 0
        for i in kill_idx:
            e = jobs_now.get(drivers[i]["job_hex"]) or {}
            stranded_actors += max(
                0, e.get("live_actors", 0) - e.get("detached_actors", 0))
        if stranded_actors:
            violations.append(
                f"{stranded_actors} non-detached actor(s) of dead jobs alive")
        phases["storm"] = {
            "killed": kill_idx,
            "reap_latency_s": {str(i): round(v, 3)
                               for i, v in reap_lat.items()},
            "reap_latency_max_s":
                round(max(reap_lat.values()), 3) if reap_lat else None,
            "leaked_workers": leaked_workers,
            "leaked_objects": leaked_objs,
            "stranded_actors": stranded_actors,
            "s": round(time.monotonic() - t_first_kill, 2)}

        # ---- cross-job get of reaped objects: typed OwnerDiedError, no hang
        xjob = {"typed_owner_died": 0, "mistyped": 0, "hung": 0}
        for i in kill_idx:
            put = drivers[i].get("put")
            if not put:
                continue
            oid_hex, owner = put
            ref = ObjectRef(ObjectID(bytes.fromhex(oid_hex)),
                            owner_address=owner)
            try:
                ray_tpu_torch.get(ref, timeout=10.0)
                xjob["mistyped"] += 1
                violations.append(
                    f"cross-job get of dead job {i}'s object SUCCEEDED")
            except OwnerDiedError:
                xjob["typed_owner_died"] += 1
            except TimeoutError:
                xjob["hung"] += 1
                violations.append(
                    f"cross-job get of dead job {i}'s object timed out "
                    "instead of raising OwnerDiedError")
            except Exception as e:  # noqa: BLE001
                xjob["mistyped"] += 1
                violations.append(
                    f"cross-job get of dead job {i}'s object raised "
                    f"{type(e).__name__}, wanted OwnerDiedError")
        phases["cross_job_get"] = xjob

        # ---- detached actors answer a FRESH driver process, state intact
        det_names = [f"storm-det-{i}" for i in kill_idx
                     if drivers[i]["detached"]]
        det_ok = 0
        if det_names:
            argv = [sys.executable, "-m", "ray_tpu_torch.core.jobstorm", "--verify",
                    "--address", cluster.gcs_address,
                    "--names", ",".join(det_names),
                    "--get-timeout", str(p.get_timeout_s)]
            env = dict(os.environ)
            env["PYTHONPATH"] = (_REPO_ROOT + os.pathsep
                                 + env.get("PYTHONPATH", ""))
            vp = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True,
                                  env=env)
            vrec: Dict[str, Any] = {"idx": "verify", "proc": vp, "lines": [],
                                    "eof": None}
            threading.Thread(target=_pump, args=(vrec,), daemon=True).start()
            drivers.append(vrec)  # cleanup sweep covers it too
            try:
                rc = vp.wait(timeout=90.0)
            except subprocess.TimeoutExpired:
                rc = None
                violations.append("detached-actor verifier driver hung")
            for _, ln in _tagged(vrec, "DETOK"):
                _, name, before, after = ln.split()
                det_ok += 1
                # bump() before the kill means value >= 1 survived the owner
                if int(before) < 1 or int(after) != int(before) + 1:
                    violations.append(
                        f"detached actor {name} lost its pre-kill state "
                        f"(value={before}, bump={after})")
            if rc != 0 or det_ok != len(det_names):
                err = _tagged(vrec, "VERIFY_ERROR")
                violations.append(
                    f"detached actors dead after owner kill: "
                    f"{det_ok}/{len(det_names)} answered "
                    f"(rc={rc}{', ' + err[0][1] if err else ''})")
        phases["detached"] = {"expected": len(det_names), "answered": det_ok}

        # ---- drain survivors: all must CLEAN (exit 0) with zero hung gets
        survivors = [r for r in drivers
                     if isinstance(r["idx"], int) and r["idx"] not in kill_idx]
        hung_drivers = errored = cuda_drivers = 0
        for rec in survivors:
            budget = max(1.0, rec["start"] + p.driver_duration_s
                         + p.drain_grace_s - time.monotonic())
            try:
                rc = rec["proc"].wait(timeout=budget)
            except subprocess.TimeoutExpired:
                hung_drivers += 1
                violations.append(
                    f"surviving driver {rec['idx']} hung past its duration "
                    f"+ {p.drain_grace_s}s grace")
                continue
            if rc != 0 or not _tagged(rec, "CLEAN"):
                errored += 1
                err = _tagged(rec, "DRIVER_ERROR")
                violations.append(
                    f"surviving driver {rec['idx']} did not drain clean "
                    f"(rc={rc}{', ' + err[0][1] if err else ''})")
            if any(ln.split()[1] != "0"
                   for _, ln in _tagged(rec, "CUDA_CONTEXT")):
                cuda_drivers += 1
                violations.append(
                    f"surviving driver {rec['idx']} made a CUDA context "
                    f"without asking for a card")

        # ---- survivor throughput: storm-window rate vs pre-kill baseline
        floor = throughput_floor_frac()
        rates = {}
        for rec in survivors:
            base_n = (_completed_at(rec, t_first_kill)
                      - _completed_at(rec, t_ready))
            base_rate = base_n / max(1e-6, t_first_kill - t_ready)
            storm_n = (_completed_at(rec, t_storm_end)
                       - _completed_at(rec, t_first_kill))
            storm_rate = storm_n / max(1e-6, t_storm_end - t_first_kill)
            rates[str(rec["idx"])] = {
                "baseline_per_s": round(base_rate, 2),
                "storm_per_s": round(storm_rate, 2)}
            if base_n >= 3 and storm_rate < floor * base_rate:
                violations.append(
                    f"survivor {rec['idx']} throughput dipped below "
                    f"{floor:.2f}x baseline during the storm "
                    f"({storm_rate:.1f}/s vs {base_rate:.1f}/s)")
            if storm_n == 0 and t_storm_end - t_first_kill > 2.0:
                violations.append(
                    f"survivor {rec['idx']} starved (0 tasks) during the "
                    "storm window")
        phases["survivors"] = {"n": len(survivors),
                               "hung": hung_drivers, "errored": errored,
                               "cuda_contexts": cuda_drivers,
                               "throughput_floor_frac": round(floor, 3),
                               "rates": rates}

        # ---- control-plane counters for the artifact + sanity floor
        final = stats_c.call("gcs_stats", timeout=10)
        jf = final.get("job_failure", {})
        if jf.get("jobs_reaped", 0) < len(kill_idx):
            violations.append(
                f"gcs reap counter {jf.get('jobs_reaped')} < kills "
                f"{len(kill_idx)}")
        if det_names and jf.get("detached_spared", 0) < len(det_names):
            violations.append(
                f"detached_spared counter {jf.get('detached_spared')} < "
                f"detached owners killed {len(det_names)}")

        # ---- full teardown, then the shm-segment leak sweep
        ray_tpu_torch.shutdown()
        cluster.shutdown()
        cluster = None
        leaked_shm = [f for f in os.listdir("/dev/shm")
                      if any(f.startswith(pre) for pre in shm_prefixes)]
        if leaked_shm:
            violations.append(
                f"{len(leaked_shm)} shm segment(s) leaked past cluster "
                f"shutdown: {leaked_shm[:4]}")
        phases["teardown"] = {"leaked_shm_segments": len(leaked_shm)}

        result = {
            "suite": "job storm (job failure domain)",
            "profile": {
                "n_jobs": p.n_jobs, "n_kill": p.n_kill,
                "detached_every": p.detached_every,
                "driver_duration_s": p.driver_duration_s,
                "tree_depth": p.tree_depth, "fanout": p.fanout,
                "put_mb": p.put_mb, "reap_bound_s": p.reap_bound_s,
                "seed": p.seed,
            },
            "phases": phases,
            "counters": {
                "jobs_reaped": jf.get("jobs_reaped", 0),
                "actors_killed": jf.get("actors_killed", 0),
                "detached_spared": jf.get("detached_spared", 0),
                "queued_cancelled": jf.get("queued_cancelled", 0),
                "workers_killed": jf.get("workers_killed", 0),
                "objects_dropped": jf.get("objects_dropped", 0),
                "bytes_dropped": jf.get("bytes_dropped", 0),
                "functions_freed": jf.get("functions_freed", 0),
            },
            "zero_hung": hung_drivers == 0 and xjob["hung"] == 0,
            "zero_leaks": (leaked_workers == 0 and leaked_objs == 0
                           and not leaked_shm),
            "detached_survived": det_ok == len(det_names),
            "violations": violations,
            "ok": not violations,
            "wall_s": round(time.monotonic() - t0, 2),
        }
        if out_path:
            with open(out_path, "w") as f:
                json.dump(result, f, indent=2)
                f.write("\n")
        return result
    finally:
        for rec in drivers:
            proc = rec.get("proc")
            if proc is not None and proc.poll() is None:
                try:
                    proc.kill()
                except OSError:
                    pass
        if cluster is not None:
            try:
                ray_tpu_torch.shutdown()
            except Exception:
                pass
            try:
                cluster.shutdown()
            except Exception:
                logger.exception("jobstorm cluster shutdown failed")


# --------------------------------------------------------------------- main

def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.WARNING)
    ap = argparse.ArgumentParser(
        description="job storm: the job failure domain under fire")
    ap.add_argument("--quick", action="store_true", help="small CI profile")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=DEFAULT_ARTIFACT,
                    help=f"write the result artifact here (default "
                         f"{DEFAULT_ARTIFACT})")
    # internal subprocess modes
    ap.add_argument("--victim", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--verify", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--address", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--index", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--detached", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--duration", type=float, default=20.0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--put-mb", type=float, default=4.0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--fanout", type=int, default=2, help=argparse.SUPPRESS)
    ap.add_argument("--tree-depth", type=int, default=2,
                    help=argparse.SUPPRESS)
    ap.add_argument("--tick-sleep", type=float, default=0.15,
                    help=argparse.SUPPRESS)
    ap.add_argument("--get-timeout", type=float, default=60.0,
                    help=argparse.SUPPRESS)
    ap.add_argument("--names", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.victim:
        return run_victim(args)
    if args.verify:
        return run_verifier(args)

    kw: Dict[str, Any] = (dict(QUICK_PROFILE) if args.quick
                          else full_profile_kwargs())
    kw["seed"] = args.seed
    p = JobStormProfile(**kw)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
    result = run_jobstorm(p, out_path=args.json)
    print(json.dumps(result, indent=2))
    c = result["counters"]
    st = result["phases"].get("storm", {})
    det = result["phases"].get("detached", {})
    sv = result["phases"].get("survivors", {})
    print(f"[jobstorm] seed={p.seed} jobs={p.n_jobs} killed={p.n_kill} | "
          f"reaped={c['jobs_reaped']} "
          f"reap_max={st.get('reap_latency_max_s')}s "
          f"actors_killed={c['actors_killed']} "
          f"detached_spared={c['detached_spared']} "
          f"workers_killed={c['workers_killed']} "
          f"objects_dropped={c['objects_dropped']} "
          f"({c['bytes_dropped']} B) "
          f"functions_freed={c['functions_freed']} | "
          f"detached_answered={det.get('answered')}/{det.get('expected')} "
          f"survivors_hung={sv.get('hung')} "
          f"leaks={st.get('leaked_workers')}w/"
          f"{st.get('leaked_objects')}o/"
          f"{result['phases'].get('teardown', {}).get('leaked_shm_segments')}shm",
          file=sys.stderr)
    if not result["ok"]:
        print("[jobstorm] VIOLATIONS:", file=sys.stderr)
        for v in result["violations"]:
            print(f"  - {v}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
