"""Traffic-storm chaos harness for the serve plane.

Drives sustained synthetic load at a configurable multiple of a
deployment's estimated capacity (default ~4x) against a multi-replica
autoscaling deployment while chaos runs underneath it: the runtime's
seeded `FaultInjector` drops/severs router->replica submissions at the named
`serve_replica_call` boundary, and a kill loop hard-kills a live replica
every few seconds (the health check replaces it; in-flight requests fail
over). The harness then asserts the serve plane's overload contract:

  EVERY submitted request resolves — as a result, a typed
  `RequestTimeoutError`, or a typed `BackPressureError` shed — within its
  deadline (+ grace). Zero hung requests, ever.

Results (accepted/shed/retried counts, p50/p99 latency of accepted
requests, the injection seed) are written as a JSON artifact, by default
`build/SERVESTORM_torch.json` (git ignores build/; the JAX package's
SERVESTORM_r09.json is never written). Run directly:

    python -m ray_tpu_torch.serve.storm          # 30 s storm, writes artifact
    python -m ray_tpu_torch.serve.storm --quick  # ~6 s CI profile

`--kill-head` kills the GCS head mid-storm and holds the warm standby's
promotion to its budget; its verdict lands in `build/HEADFAIL_torch.json`
(`--headfail-json`; the JAX package's HEADFAIL_r11.json is never written).

    python -m ray_tpu_torch.serve.storm --kill-head --quick   # ~10 s
"""

from __future__ import annotations

import json
import logging
import os as _os
import queue
import random
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

# under build/, which git ignores
DEFAULT_ARTIFACT = str(Path(__file__).resolve().parents[2] / "build"
                       / "SERVESTORM_torch.json")
HEADFAIL_ARTIFACT = str(Path(__file__).resolve().parents[2] / "build"
                        / "HEADFAIL_torch.json")
DEFAULT_FAULT_SPEC = "drop:serve_replica_call:0.02"


@dataclass
class StormProfile:
    """One storm's shape. Capacity is estimated as
    `num_replicas * replica_concurrency / service_time_s`; the offered
    rate is `overload * capacity`."""

    duration_s: float = 30.0
    overload: float = 4.0
    request_timeout_s: float = 2.0
    service_time_s: float = 0.1
    num_replicas: int = 2
    max_replicas: int = 4
    replica_concurrency: int = 4
    max_queue_per_replica: int = 8
    retry_budget: int = 3
    kill_period_s: float = 5.0
    fault_spec: str = DEFAULT_FAULT_SPEC
    seed: int = 0
    submitter_threads: int = 4
    resolve_grace_s: float = 10.0

    @property
    def capacity_rps(self) -> float:
        # the controller floors replica max_concurrency at 4 — use the
        # effective value so "4x capacity" means what it says. With the
        # defaults the offered rate exceeds even the fully-autoscaled
        # (max_replicas) capacity 2x, so overload persists through scale-up.
        return (self.num_replicas * max(4, self.replica_concurrency)
                / self.service_time_s)

    @property
    def offered_rps(self) -> float:
        return self.overload * self.capacity_rps


QUICK_PROFILE = dict(duration_s=6.0, kill_period_s=2.0)
# --kill-head needs a window on BOTH sides of the promotion; the lease TTL
# is squeezed so expiry->promotion fits the CI budget
KILLHEAD_QUICK_PROFILE = dict(duration_s=10.0, kill_period_s=3.0)


@dataclass
class _Outcomes:
    submitted: int = 0
    accepted: int = 0       # resolved with a result
    shed: int = 0           # typed BackPressureError (router or submit)
    timeout: int = 0        # typed RequestTimeoutError / GetTimeoutError
    replica_death: int = 0  # typed ActorDiedError & co past the budget
    other_error: int = 0
    hung: int = 0           # never resolved: the contract violation
    latencies_ms: List[float] = field(default_factory=list)


from ray_tpu_torch.util import tracing as _tracing  # noqa: E402
from ray_tpu_torch.util.stats import percentile as _percentile  # noqa: E402


class LoadGenerator:
    """Paced open-loop load generator against a serve handle (the storm's
    submit/collect machinery, extracted so other benches can reuse it):
    `threads` submitter threads offer `rps` total, a collector thread
    classifies every resolution into typed outcome buckets with accepted-
    request latencies, and `stop_and_drain()` blocks until every submitted
    request resolves (result / typed shed / typed timeout) or the grace
    expires — the remainder is `hung`, the contract violation.

    The storm harness runs one of these with a kill loop + fault injector
    underneath; servebench runs one clean for p50/p99 latency rows."""

    def __init__(self, handle, *, rps: float, request_timeout_s: float,
                 payload_fn=None, threads: int = 4,
                 rng: Optional[random.Random] = None,
                 resolve_grace_s: float = 10.0, trace: bool = False):
        from ray_tpu_torch.core.api import _global_worker

        self.handle = handle
        self.rps = rps
        self.request_timeout_s = request_timeout_s
        self.payload_fn = payload_fn or (lambda idx, i: (idx, i))
        self.threads = threads
        self.rng = rng or random.Random(0)
        self.resolve_grace_s = resolve_grace_s
        # trace=True: each request roots its own trace and accepted
        # requests record their trace_id — the traced storm asserts every
        # one of those resolves to a complete cross-process span chain
        self.trace = trace
        self.trace_ids: List[str] = []  # accepted requests only
        self.outcomes = _Outcomes()
        self.elapsed_s = 0.0
        self._worker = _global_worker()
        self._lock = threading.Lock()
        self._done_q: "queue.Queue" = queue.Queue()
        self._outstanding = threading.Semaphore(0)  # one release/resolution
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self._collector_t: Optional[threading.Thread] = None
        self._t_start = 0.0

    @staticmethod
    def classify(err: Optional[BaseException]) -> str:
        from ray_tpu_torch.core.exceptions import (ActorDiedError,
                                                   BackPressureError,
                                                   GetTimeoutError,
                                                   RequestTimeoutError,
                                                   WorkerCrashedError)

        if err is None:
            return "accepted"
        if isinstance(err, BackPressureError):
            return "shed"
        if isinstance(err, (RequestTimeoutError, GetTimeoutError)):
            return "timeout"
        if isinstance(err, (ActorDiedError, WorkerCrashedError,
                            ConnectionError)):
            return "replica_death"
        return "other_error"

    def _collector(self) -> None:
        import ray_tpu_torch

        while True:
            item = self._done_q.get()
            if item is None:
                return
            ref, t0, t1, trace_id = item
            err = None
            try:
                ray_tpu_torch.get(ref, timeout=5)  # terminal: instant
            except Exception as e:
                err = e
            kind = self.classify(err)
            out = self.outcomes
            with self._lock:
                setattr(out, kind, getattr(out, kind) + 1)
                if kind == "accepted":
                    out.latencies_ms.append((t1 - t0) * 1e3)
                    if trace_id is not None:
                        self.trace_ids.append(trace_id)
            self._outstanding.release()

    def _submitter(self, idx: int) -> None:
        from ray_tpu_torch.core.exceptions import BackPressureError

        out = self.outcomes
        interval = self.threads / self.rps
        next_t = time.perf_counter() + self.rng.random() * interval
        i = 0
        while not self._stop.is_set():
            now = time.perf_counter()
            if now < next_t:
                time.sleep(min(interval, next_t - now))
                continue
            next_t += interval
            i += 1
            with self._lock:
                out.submitted += 1
            t0 = time.perf_counter()
            tctx = (_tracing.new_id(), "") if self.trace else None
            try:
                with _tracing.ctx_scope(tctx):
                    ref = self.handle.remote(
                        self.payload_fn(idx, i),
                        _timeout_s=self.request_timeout_s)
            except BackPressureError:
                with self._lock:
                    out.shed += 1
                self._outstanding.release()
                continue
            except Exception:
                with self._lock:
                    out.other_error += 1
                self._outstanding.release()
                continue
            self._worker.add_done_callback(
                ref, lambda r=ref, t=t0,
                tid=(tctx[0] if tctx else None): self._done_q.put(
                    (r, t, time.perf_counter(), tid)))

    def start(self) -> "LoadGenerator":
        self._collector_t = threading.Thread(target=self._collector,
                                             daemon=True)
        self._collector_t.start()
        self._threads = [
            threading.Thread(target=self._submitter, args=(k,), daemon=True)
            for k in range(self.threads)]
        self._t_start = time.perf_counter()
        for t in self._threads:
            t.start()
        return self

    def stop_and_drain(self) -> _Outcomes:
        """Stop offering load, then wait until every submitted request
        resolves (deadline + grace); stragglers count as `hung`."""
        self._stop.set()
        for t in self._threads:
            t.join(timeout=10)
        self.elapsed_s = time.perf_counter() - self._t_start
        deadline = time.monotonic() + self.request_timeout_s \
            + self.resolve_grace_s
        with self._lock:
            submitted = self.outcomes.submitted
        resolved = 0
        while resolved < submitted and time.monotonic() < deadline:
            if self._outstanding.acquire(timeout=0.25):
                resolved += 1
        self._done_q.put(None)
        self._collector_t.join(timeout=10)
        with self._lock:
            self.outcomes.hung = submitted - resolved
        return self.outcomes

    def run(self, duration_s: float) -> _Outcomes:
        self.start()
        time.sleep(duration_s)
        return self.stop_and_drain()


def run_storm(profile: Optional[StormProfile] = None,
              out_path: Optional[str] = DEFAULT_ARTIFACT) -> Dict[str, Any]:
    """Run one storm against a fresh deployment on the CURRENT cluster
    (caller has already ray_tpu_torch.init'd). Returns the result dict (also
    written to `out_path` unless None). Raises nothing on a dirty storm —
    the caller asserts on `result["requests"]["hung"]` etc."""
    from ray_tpu_torch.core import rpc as _rpc
    from ray_tpu_torch.core.config import get_config
    from ray_tpu_torch.serve.config import get_serve_config

    p = profile or StormProfile()
    rng = random.Random(p.seed)
    cfg = get_serve_config()
    saved = {k: getattr(cfg, k) for k in
             ("max_queue_per_replica", "request_retry_budget")}
    cfg.max_queue_per_replica = p.max_queue_per_replica
    cfg.request_retry_budget = p.retry_budget
    core_cfg = get_config()
    saved_traces = core_cfg.tracing_max_traces
    if _tracing.enabled():
        # one trace per submitted request: a quick storm roots a few
        # thousand, which brushes the default per-trace eviction cap —
        # evicting a live trace would read as a broken chain
        core_cfg.tracing_max_traces = max(saved_traces, 50_000)
    injector = (_rpc.install_fault_injector(p.fault_spec, p.seed)
                if p.fault_spec else None)
    try:
        return _run_storm_inner(p, rng, injector, out_path)
    finally:
        # an aborted storm must not leave the process dropping 2% of every
        # replica call (or storm-sized caps) for whatever runs next
        if injector is not None:
            _rpc.clear_fault_injector()
        for k, v in saved.items():
            setattr(cfg, k, v)
        core_cfg.tracing_max_traces = saved_traces


def _collect_trace_report(trace_ids: List[str],
                          out_path: Optional[str]) -> Dict[str, Any]:
    """Post-drain tracing verdict: pull the fleet's spans + clock offsets
    from the GCS, validate every accepted request's chain (parent links
    resolve, >=3 distinct processes), and write the merged chrome trace
    next to the artifact."""
    from ray_tpu_torch.core.api import _global_worker
    from ray_tpu_torch.core.config import get_config
    from ray_tpu_torch.util import timeline

    w = _global_worker()
    # flush our own spans, then poll: worker processes ship theirs on the
    # report-interval cadence, so keep re-pulling until the chain census
    # stops improving (stragglers can be a couple of intervals behind)
    interval_s = max(0.5, get_config().task_events_report_interval_ms / 1e3)
    deadline = time.monotonic() + max(8.0, 6 * interval_s)
    spans, offsets, chains = [], {}, {}
    complete: List[str] = []
    cross3: List[str] = []
    while True:
        w.task_events.flush()
        spans = w.gcs.call("get_profile_events", {}, timeout=30)
        offsets = w.gcs.call("get_span_offsets", {}, timeout=10)
        chains = timeline.validate_chains(spans, trace_ids)
        complete = [t for t, c in chains.items() if c["complete"]]
        cross3 = [t for t in complete if chains[t]["processes"] >= 3]
        if len(cross3) >= len(trace_ids) or time.monotonic() > deadline:
            break
        time.sleep(interval_s)
    doc = timeline.merge_chrome(spans, offsets)
    problems = timeline.validate_chrome(doc)
    chrome_path = None
    if out_path:
        chrome_path = out_path + ".trace.json"
        with open(chrome_path, "w") as f:
            json.dump(doc, f)
    incomplete_sample = [
        {"trace_id": t, **{k: v for k, v in chains[t].items()
                           if k != "missing_parents"},
         "missing_parents": chains[t]["missing_parents"][:3]}
        for t in trace_ids if not chains[t]["complete"]][:5]
    return {
        "enabled": True,
        "accepted_traced": len(trace_ids),
        "complete_chains": len(complete),
        "complete_fraction": round(
            len(complete) / max(1, len(trace_ids)), 4),
        "chains_3plus_processes": len(cross3),
        "cross3_fraction": round(len(cross3) / max(1, len(trace_ids)), 4),
        "incomplete_sample": incomplete_sample,
        "chrome_events": len(doc["traceEvents"]),
        "chrome_valid": not problems,
        "chrome_problems": problems[:5],
        "chrome_path": chrome_path,
        "clock_sources": len(offsets),
        "max_abs_clock_offset_us": round(
            max((abs(v) for v in offsets.values()), default=0.0), 1),
    }


def _run_storm_inner(p: StormProfile, rng: random.Random, injector,
                     out_path: Optional[str]) -> Dict[str, Any]:
    import ray_tpu_torch
    from ray_tpu_torch import serve

    service_time_s = p.service_time_s
    traced = _tracing.enabled()

    @ray_tpu_torch.remote
    def _nested_echo(i):
        return i

    @serve.deployment(
        name="storm_target",
        num_replicas=p.num_replicas,
        max_concurrent_queries=p.replica_concurrency,
        autoscaling_config=serve.AutoscalingConfig(
            min_replicas=p.num_replicas, max_replicas=p.max_replicas,
            target_num_ongoing_requests_per_replica=p.replica_concurrency,
            upscale_delay_s=1.0, downscale_delay_s=30.0),
    )
    class StormTarget:
        def __call__(self, i):
            if traced:
                # nested task: the replica's execution span becomes the
                # parent of a submit->lease->dispatch->execute chain in a
                # THIRD process (a pool worker), so every accepted
                # request's trace crosses driver -> replica -> worker
                ray_tpu_torch.get(_nested_echo.remote(i), timeout=30)
            time.sleep(service_time_s)
            return i

    handle = serve.run(StormTarget.bind(), name="storm")
    # warm: every replica answered once before the clock starts
    ray_tpu_torch.get([handle.remote(i) for i in range(p.num_replicas * 2)],
                      timeout=60)
    serve.reset_router_stats()

    stop = threading.Event()
    kills = 0

    gen = LoadGenerator(handle, rps=p.offered_rps,
                        request_timeout_s=p.request_timeout_s,
                        threads=p.submitter_threads, rng=rng,
                        resolve_grace_s=p.resolve_grace_s, trace=traced)

    def killer() -> None:
        # victims come from the HANDLE's push-refreshed replica set (local,
        # no controller RPC: under a storm the controller's exec slots are
        # busy autoscaling/health-checking and an RPC here can starve)
        nonlocal kills
        while not stop.wait(p.kill_period_s):
            try:
                with handle._lock:
                    replicas = list(handle._replicas)
                if len(replicas) < 2:
                    continue  # never kill the last replica
                victim = replicas[rng.randrange(len(replicas))]
                ray_tpu_torch.kill(victim)
                kills += 1
                logger.info("storm killed replica %s", victim)
            except Exception:
                logger.warning("storm kill pass failed", exc_info=True)

    # kill_period_s <= 0 disables the kill loop entirely (the traced storm
    # runs kill-free: a hard-killed replica takes its unflushed spans with
    # it, which would charge span loss against chain completeness). The
    # guard matters — stop.wait(0) returns immediately, so an unguarded
    # thread would busy-kill replicas back to back.
    kill_t = None
    if p.kill_period_s > 0:
        kill_t = threading.Thread(target=killer, daemon=True)
        kill_t.start()
    gen.start()
    time.sleep(p.duration_s)
    stop.set()
    # Every submitted request must RESOLVE (result / typed timeout / typed
    # shed) within deadline + grace; anything left is a hung request.
    out = gen.stop_and_drain()
    if kill_t is not None:
        kill_t.join(timeout=p.kill_period_s + 10)
    elapsed = gen.elapsed_s
    tracing_blk = (_collect_trace_report(gen.trace_ids, out_path)
                   if traced else None)

    stats = serve.router_stats()
    lat = sorted(out.latencies_ms)
    result: Dict[str, Any] = {
        "bench": "serve_storm",
        "round": 9,  # the reference artifact's schema, SERVESTORM_r09
        "seed": p.seed,
        "fault_spec": p.fault_spec,
        "fault_stats": dict(injector.stats) if injector else {},
        "duration_s": round(elapsed, 2),
        "capacity_rps_est": round(p.capacity_rps, 1),
        "offered_rps": round(p.offered_rps, 1),
        "overload_x": p.overload,
        "request_timeout_s": p.request_timeout_s,
        "replicas": {"min": p.num_replicas, "max": p.max_replicas,
                     "concurrency": p.replica_concurrency,
                     "kills": kills},
        "requests": {
            "submitted": out.submitted,
            "accepted": out.accepted,
            "shed": out.shed,
            "timeout": out.timeout,
            "replica_death": out.replica_death,
            "other_error": out.other_error,
            "hung": out.hung,
        },
        "router": stats,
        "latency_ms": {
            "p50_accepted": round(_percentile(lat, 0.50) or 0.0, 2),
            "p99_accepted": round(_percentile(lat, 0.99) or 0.0, 2),
        },
        "zero_hung": out.hung == 0,
    }
    if tracing_blk is not None:
        result["tracing"] = tracing_blk
    serve.delete("storm_target")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2, sort_keys=True)
    return result


class HeadKiller:
    """Mid-storm head kill-and-promote (`--kill-head`): snapshots the
    active head, starts a warm StandbyHead, crash-stops the head (no lease
    relinquish — the HARD failure: promotion waits out the TTL), adopts the
    promoted head and drives a probe actor through it so the tracked
    promotion latency (lease-expiry -> first-scheduled-task) has a far
    edge even on an otherwise idle control plane."""

    def __init__(self, cluster, kill_after_s: float, lease_ttl_s: float):
        self.cluster = cluster
        self.kill_after_s = kill_after_s
        self.lease_ttl_s = lease_ttl_s
        self.record: Dict[str, Any] = {}
        self._cancel = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="storm-head-killer", daemon=True)

    def start(self) -> "HeadKiller":
        self._thread.start()
        return self

    def join(self, timeout: float) -> None:
        self._cancel.set()
        self._thread.join(timeout)

    def _run(self) -> None:
        import ray_tpu_torch

        if self._cancel.wait(self.kill_after_s):
            return
        rec = self.record
        try:
            self.cluster.gcs._write_snapshot()
        except Exception:
            logger.exception("pre-kill snapshot failed; standby promotes "
                             "from the periodic loop's last write")
        standby = self.cluster.start_standby()
        time.sleep(max(0.3, self.lease_ttl_s / 2))  # one standby tail poll
        rec["epoch_before"] = self.cluster.gcs.fence_epoch
        rec["killed_at"] = time.time()
        logger.warning("storm killing the ACTIVE HEAD (epoch %d)",
                       rec["epoch_before"])
        self.cluster.gcs.kill()
        try:
            rec["new_address"] = self.cluster.adopt_promoted(
                standby, timeout=self.lease_ttl_s * 10 + 30)
        except Exception as e:
            rec["error"] = f"promotion failed: {e}"
            logger.exception("standby promotion failed")
            return
        rec["epoch_after"] = self.cluster.gcs.fence_epoch

        @ray_tpu_torch.remote
        class _PromotionProbe:
            def ping(self):
                return 1

        try:
            probe = _PromotionProbe.options(num_cpus=0).remote()
            ray_tpu_torch.get(probe.ping.remote(), timeout=60)
            ray_tpu_torch.kill(probe)
        except Exception as e:
            rec["probe_error"] = str(e)
        rec["promotion"] = dict(self.cluster.gcs.promotion or {})
        lat = rec["promotion"].get("latency_s")
        logger.warning("head promoted: epoch %d -> %d at %s, "
                       "lease-expiry->first-scheduled-task %.3fs",
                       rec["epoch_before"], rec["epoch_after"],
                       rec["new_address"], lat if lat is not None else -1.0)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    import ray_tpu_torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--overload", type=float, default=4.0)
    ap.add_argument("--seed", type=int, default=None,
                    help="fault-injection + kill-choice seed (default: "
                         "RAY_TPU_TORCH_FAULT_INJECTION_SEED or 0)")
    ap.add_argument("--quick", action="store_true",
                    help="short CI profile (~6 s; ~10 s with --kill-head)")
    ap.add_argument("--json", default=DEFAULT_ARTIFACT,
                    help=f"artifact path (default {DEFAULT_ARTIFACT})")
    ap.add_argument("--traced", action="store_true",
                    help="run with distributed tracing enabled: every "
                         "request roots a trace, the merged chrome "
                         "timeline lands next to the artifact, and the "
                         "run fails unless >=99%% of accepted requests "
                         "have complete cross-process span chains. "
                         "Disables the replica kill loop (a hard-killed "
                         "replica loses its unflushed spans); the fault "
                         "injector still drops submissions, so failover "
                         "retries stay in the traces")
    ap.add_argument("--kill-period", type=float, default=None,
                    help="override the replica kill period in seconds; 0 "
                         "disables the kill loop (an untraced kill-free "
                         "baseline comparable to --traced)")
    ap.add_argument("--kill-head", action="store_true",
                    help="kill-and-promote the GCS head mid-storm: a warm "
                         "standby takes over via the lease/fencing-epoch "
                         "CAS; asserts zero hung requests, bounded "
                         "promotion latency and no typed-error spike "
                         "beyond the shed baseline")
    ap.add_argument("--headfail-json", default=HEADFAIL_ARTIFACT,
                    help="promotion-latency artifact for --kill-head "
                         f"(default {HEADFAIL_ARTIFACT})")
    ap.add_argument("--promotion-budget", type=float, default=None,
                    help="max allowed lease-expiry -> first-scheduled-task "
                         "latency in seconds (--kill-head); default is "
                         "machine-calibrated from effective CPU count "
                         f"({PROMOTION_BUDGET_S}s at >= "
                         f"{_ERROR_SPIKE_FULL_CPUS} cpus, relaxed toward "
                         f"{_PROMOTION_BUDGET_1CPU_S}s at 1)")
    ap.add_argument("--lease-ttl", type=float, default=1.0,
                    help="head lease TTL for the --kill-head run")
    args = ap.parse_args(argv)

    import os

    for path in (args.json, args.kill_head and args.headfail_json):
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)

    seed = (args.seed if args.seed is not None
            else int(os.environ.get("RAY_TPU_TORCH_FAULT_INJECTION_SEED",
                                    "0")))
    kw: Dict[str, Any] = dict(seed=seed, overload=args.overload,
                              duration_s=args.duration)
    if args.quick:
        kw.update(KILLHEAD_QUICK_PROFILE if args.kill_head
                  else QUICK_PROFILE)
    if args.kill_period is not None:
        kw["kill_period_s"] = args.kill_period
    if args.traced:
        from ray_tpu_torch.core.config import get_config

        # env AND the live config: worker subprocesses (replicas, pool
        # workers) build their config from the inherited environment, so
        # flipping only the driver's loaded config would leave every other
        # process untraced and the chains single-process
        os.environ["RAY_TPU_TORCH_TRACING_ENABLED"] = "1"
        get_config().tracing_enabled = True
        kw["kill_period_s"] = 0.0  # hard-killed replicas lose their spans
    profile = StormProfile(**kw)

    # the storm's replicas take no card: the GPU resource only gives the
    # node a GPU host's shape
    cluster = None
    killer = None
    if args.kill_head:
        from ray_tpu_torch.core.cluster import Cluster
        from ray_tpu_torch.core.config import get_config

        get_config().head_lease_ttl_s = args.lease_ttl
        cluster = Cluster(
            snapshot_uri=f"memory://storm-head-{os.getpid()}")
        cluster.add_node(resources={
            "CPU": float(max(8, profile.max_replicas + 2)), "GPU": 8.0})
        cluster.connect()
        killer = HeadKiller(cluster, kill_after_s=profile.duration_s * 0.4,
                            lease_ttl_s=args.lease_ttl).start()
    else:
        ray_tpu_torch.init(num_cpus=max(8, profile.max_replicas + 2),
                           resources={"GPU": 8})
    try:
        result = run_storm(profile, out_path=args.json)
        if killer is not None:
            killer.join(timeout=args.lease_ttl * 10 + 90)
    finally:
        try:
            from ray_tpu_torch import serve

            serve.shutdown()
        finally:
            ray_tpu_torch.shutdown()
            if cluster is not None:
                cluster.shutdown()

    req = result["requests"]
    print(f"serve storm: seed={result['seed']} "
          f"offered={result['offered_rps']}rps "
          f"(~{result['overload_x']}x capacity "
          f"{result['capacity_rps_est']}rps) for {result['duration_s']}s, "
          f"kills={result['replicas']['kills']}")
    print(f"  submitted={req['submitted']} accepted={req['accepted']} "
          f"shed={req['shed']} timeout={req['timeout']} "
          f"replica_death={req['replica_death']} "
          f"other={req['other_error']} hung={req['hung']}")
    print(f"  router retries={result['router']['retries']} "
          f"failovers={result['router']['failovers']} "
          f"p50_accepted={result['latency_ms']['p50_accepted']}ms "
          f"p99_accepted={result['latency_ms']['p99_accepted']}ms")
    if args.json:
        print(f"  artifact: {args.json}")
    failed = False
    if req["hung"] or not result["zero_hung"]:
        print(f"STORM FAILED: {req['hung']} hung request(s) "
              f"(seed {result['seed']})")
        failed = True
    if args.traced:
        tr = result.get("tracing") or {}
        print(f"  tracing: {tr.get('complete_chains')}/"
              f"{tr.get('accepted_traced')} complete chains "
              f"({tr.get('cross3_fraction', 0):.1%} across >=3 processes), "
              f"{tr.get('chrome_events')} events -> {tr.get('chrome_path')} "
              f"(valid={tr.get('chrome_valid')}), "
              f"max clock offset "
              f"{tr.get('max_abs_clock_offset_us', 0) / 1e3:.2f}ms "
              f"over {tr.get('clock_sources')} sources")
        if tr.get("cross3_fraction", 0.0) < 0.99:
            print(f"STORM FAILED: only {tr.get('cross3_fraction', 0):.1%} "
                  f"of accepted requests have complete >=3-process span "
                  f"chains (need 99%); sample: "
                  f"{tr.get('incomplete_sample')}")
            failed = True
        if not tr.get("chrome_valid"):
            print(f"STORM FAILED: merged chrome trace invalid: "
                  f"{tr.get('chrome_problems')}")
            failed = True
    if args.kill_head:
        failed |= _report_head_kill(killer.record, result, args)
    if failed:
        return 1
    print("storm clean: every request resolved within its deadline")
    return 0



# Typed errors that are NOT overload responses (shed/timeout are the serve
# plane doing its job at 4x load): a head failover must not spike these
# beyond a small fraction of traffic. Baseline for the --kill-head quick
# profile this check runs under (HEADFAIL_r11): replica_death+other ~= 6%
# of submitted. (The full SERVESTORM_r09 profile runs longer with more
# replica kills and sits near 35% — it is not the baseline here.)
ERROR_SPIKE_MAX_FRACTION = 0.10

# The 10% bound was calibrated on multi-core hardware, where a killed
# replica's replacement boots while the storm's load loop keeps running on
# other cores. On a starved 1-2 CPU box the respawn path CONTENDS with the
# load generator, so the death window stretches and replica_death errors
# pile up with no control-plane regression at all: a pristine-tree control
# run on a 1-CPU host measures ~42% (vs ~6% on real hardware). Scale the
# bound by detected parallelism — full strictness at >= 8 CPUs, linearly
# relaxed toward 60% at 1 CPU — so the stage stays meaningful on real
# hardware without flaking on constrained CI boxes.
_ERROR_SPIKE_FULL_CPUS = 8
_ERROR_SPIKE_1CPU_MAX = 0.60


def _effective_cpus() -> int:
    """EFFECTIVE parallelism, not host core count: a cgroup/affinity-
    limited CI runner on a big host is exactly the starved case the
    calibration exists for."""
    try:
        return len(_os.sched_getaffinity(0)) or 1
    except (AttributeError, OSError):
        return _os.cpu_count() or 1


def error_spike_bound() -> float:
    cpus = _effective_cpus()
    if cpus >= _ERROR_SPIKE_FULL_CPUS:
        return ERROR_SPIKE_MAX_FRACTION
    frac = (_ERROR_SPIKE_FULL_CPUS - cpus) / (_ERROR_SPIKE_FULL_CPUS - 1)
    return round(ERROR_SPIKE_MAX_FRACTION
                 + (_ERROR_SPIKE_1CPU_MAX - ERROR_SPIKE_MAX_FRACTION) * frac,
                 4)


# The 1.0s promotion budget has the same hardware assumption as the error
# spike bound: the standby's lease CAS + snapshot restore + raylet
# re-adoption race the load generator for cores. On a 1-CPU box the whole
# promotion pipeline timeshares with request traffic, so the same healthy
# control plane measures several times the multi-core latency. Calibrate
# identically: full strictness at >= _ERROR_SPIKE_FULL_CPUS, linearly
# relaxed toward _PROMOTION_BUDGET_1CPU_S at 1 CPU. An explicit
# --promotion-budget always wins.
PROMOTION_BUDGET_S = 1.0
_PROMOTION_BUDGET_1CPU_S = 4.0


def promotion_budget_bound() -> float:
    cpus = _effective_cpus()
    if cpus >= _ERROR_SPIKE_FULL_CPUS:
        return PROMOTION_BUDGET_S
    frac = (_ERROR_SPIKE_FULL_CPUS - cpus) / (_ERROR_SPIKE_FULL_CPUS - 1)
    return round(PROMOTION_BUDGET_S
                 + (_PROMOTION_BUDGET_1CPU_S - PROMOTION_BUDGET_S) * frac, 3)


def _report_head_kill(rec: Dict[str, Any], result: Dict[str, Any],
                      args) -> bool:
    """Print + persist the kill-head verdict (HEADFAIL artifact). Returns
    True when the run FAILED (no promotion, promotion over budget, or a
    typed-error spike beyond the shed baseline)."""
    from ray_tpu_torch.envelope import bench_broadcast_1k

    failed = False
    promotion = rec.get("promotion") or {}
    latency = promotion.get("latency_s")
    req = result["requests"]
    errs = req["replica_death"] + req["other_error"]
    err_frac = errs / max(1, req["submitted"])
    bound = error_spike_bound()
    promo_budget = (args.promotion_budget
                    if args.promotion_budget is not None
                    else promotion_budget_bound())
    print(f"  head kill: epochs {rec.get('epoch_before')} -> "
          f"{rec.get('epoch_after')} new_head={rec.get('new_address')} "
          f"lease_ttl={args.lease_ttl}s")
    if rec.get("error") or latency is None:
        print(f"HEADFAIL: standby never promoted / never scheduled "
              f"({rec.get('error') or rec.get('probe_error')})")
        failed = True
    else:
        print(f"  promotion latency (lease-expiry -> first-scheduled-task): "
              f"{latency:.3f}s (budget {promo_budget}s at "
              f"{_effective_cpus()} effective cpus, tailed "
              f"snapshot v{promotion.get('tailed_version')})")
        if latency > promo_budget:
            print(f"HEADFAIL: promotion latency {latency:.3f}s over the "
                  f"{promo_budget}s budget")
            failed = True
    print(f"  typed-error spike check: replica_death+other = {errs} "
          f"({err_frac:.1%} of submitted, max {bound:.0%} at "
          f"{_effective_cpus()} effective cpus "
          f"[{ERROR_SPIKE_MAX_FRACTION:.0%} on >= "
          f"{_ERROR_SPIKE_FULL_CPUS}]; shed baseline {req['shed']} "
          f"+ timeout {req['timeout']})")
    if err_frac > bound:
        print("HEADFAIL: typed-error spike beyond the shed baseline")
        failed = True

    artifact = {
        "bench": "head_failover_storm",
        "round": 11,  # the reference artifact's schema, HEADFAIL_r11
        "seed": result["seed"],
        "lease_ttl_s": args.lease_ttl,
        "promotion_budget_s": promo_budget,
        "epochs": {"before": rec.get("epoch_before"),
                   "after": rec.get("epoch_after")},
        "promotion": promotion,
        "promotion_latency_s": latency,
        "new_head_address": rec.get("new_address"),
        "storm": {
            "duration_s": result["duration_s"],
            "offered_rps": result["offered_rps"],
            "requests": dict(req),
            "zero_hung": result["zero_hung"],
            "error_spike_fraction": round(err_frac, 4),
            "error_spike_max_fraction": bound,
            "error_spike_base_fraction": ERROR_SPIKE_MAX_FRACTION,
            "error_spike_cpus": _effective_cpus(),
            "replica_kills": result["replicas"]["kills"],
        },
        "broadcast_1k_nodes": bench_broadcast_1k(),
        "passed": not failed,
    }
    if args.headfail_json:
        with open(args.headfail_json, "w") as f:
            json.dump(artifact, f, indent=2, sort_keys=True)
        print(f"  headfail artifact: {args.headfail_json}")
    return failed


if __name__ == "__main__":
    import sys

    sys.exit(main())
