"""Scalability-envelope benchmark: a scaled-to-one-box analog of the
reference's release envelope (`release/benchmarks/README.md:5-31` — many
tasks/actors/PGs, 1 GiB broadcast, deep task queues) plus the core
primitive-rate suite (`python/ray/_private/ray_perf.py:93-282`).

One command (`python -m ray_tpu_torch.envelope`) writes a JSON artifact,
by default `build/ENVELOPE_torch.json` (git ignores build/; the JAX
package's ENVELOPE_r*.json are never written), with config + hardware
metadata so the numbers can be read against the reference's table. The
reference runs its envelope on 64×64-core nodes; the scaled counts here are
chosen to finish in minutes on one small box — the artifact records the
scale so nothing silently pretends otherwise. The benches measure the host
runtime and do no device work, so they run on any host; the hardware block
names the host's first card and its power limit where it has one.
"""

from __future__ import annotations

import json
import os
import platform
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

DEFAULT_ARTIFACT = str(Path(__file__).resolve().parents[1] / "build"
                       / "ENVELOPE_torch.json")


def _card() -> Tuple[Optional[str], Optional[str]]:
    """The first card's name and power limit as nvidia-smi reports them,
    or (None, None) on a host without one. Read from nvidia-smi, never
    through torch.cuda: the benches run in a driver that must not make a
    CUDA context."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None, None
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines or "," not in lines[0]:
        return None, None
    name, limit = (s.strip() for s in lines[0].split(",", 1))
    return name, limit


def _hardware() -> Dict:
    gpu, power_limit = _card()
    return {
        "host": platform.node(),
        "platform": platform.platform(),
        "cpus": os.cpu_count(),
        "mem_gib": round(os.sysconf("SC_PAGE_SIZE")
                         * os.sysconf("SC_PHYS_PAGES") / 2**30, 1),
        "python": platform.python_version(),
        "gpu": gpu,
        "gpu_power_limit": power_limit,
    }


def bench_queued_tasks(n_tasks: int = 20_000) -> Dict:
    """Deep task queue on one node (reference: 1M+ queued on m4.16xlarge).
    Measures submission rate (queue ingest) and end-to-end drain rate."""
    import ray_tpu_torch

    @ray_tpu_torch.remote
    def noop():
        return None

    t0 = time.perf_counter()
    refs = [noop.remote() for _ in range(n_tasks)]
    t_submit = time.perf_counter() - t0
    ray_tpu_torch.get(refs)
    t_total = time.perf_counter() - t0
    return {
        "n_tasks": n_tasks,
        "submit_per_s": round(n_tasks / t_submit, 1),
        "end_to_end_per_s": round(n_tasks / t_total, 1),
    }


def _worker_pool_stats() -> Dict:
    from ray_tpu_torch.core.worker import current_worker

    try:
        return current_worker().raylet.call("worker_pool_stats", {},
                                            timeout=30)
    except Exception:
        return {}


def bench_concurrent_actors(n_actors: int = 200) -> Dict:
    """Concurrent alive actors (reference: 40k+ across 2000 nodes). All
    created at once, then one round-trip call to every actor while all are
    alive proves liveness rather than just registration. Reports the warm
    worker pool's share of the burst: every actor lease should be served
    by a template fork, not a cold import-paying spawn."""
    import ray_tpu_torch

    @ray_tpu_torch.remote
    class A:
        def ping(self):
            return os.getpid()

    s0 = _worker_pool_stats()
    t0 = time.perf_counter()
    actors = [A.options(num_cpus=0).remote() for _ in range(n_actors)]
    pids = ray_tpu_torch.get([a.ping.remote() for a in actors], timeout=600)
    t_up = time.perf_counter() - t0

    t0 = time.perf_counter()
    ray_tpu_torch.get([a.ping.remote() for a in actors], timeout=600)
    t_round = time.perf_counter() - t0
    s1 = _worker_pool_stats()
    for a in actors:
        ray_tpu_torch.kill(a)
    out = {
        "n_actors": n_actors,
        "distinct_workers": len(set(pids)),
        "create_to_first_ping_s": round(t_up, 2),
        "alive_roundtrip_calls_per_s": round(n_actors / t_round, 1),
    }
    if s0 and s1:
        warm = s1["registered_warm"] - s0["registered_warm"]
        cold = s1["registered_cold"] - s0["registered_cold"]
        out["warm_starts"] = warm
        out["cold_starts"] = cold
        out["warm_start_fraction"] = round(warm / max(1, warm + cold), 3)
        out["fork_p50_ms"] = s1.get("fork_p50_ms")
        out["fork_p99_ms"] = s1.get("fork_p99_ms")
    return out


def bench_placement_groups(n_pgs: int = 30) -> Dict:
    """Simultaneous placement groups (reference: 1,000+ across the fleet)."""
    import ray_tpu_torch
    from ray_tpu_torch.core.placement_group import placement_group, remove_placement_group

    t0 = time.perf_counter()
    pgs = [placement_group([{"CPU": 0.01}], strategy="PACK")
           for _ in range(n_pgs)]
    for pg in pgs:
        pg.ready(timeout=120)
    t_up = time.perf_counter() - t0
    for pg in pgs:
        remove_placement_group(pg)
    return {"n_pgs": n_pgs, "create_per_s": round(n_pgs / t_up, 1)}


def bench_broadcast_1k(n_nodes: int = 1000, n_changed: int = 1) -> Dict:
    """Control-plane gossip + scheduler cost at fleet scale (simulated 1k
    raylets, measured rather than assumed). Every raylet
    subscribes to CH_RESOURCES, so a FULL-view publish costs
    O(nodes) payload x O(nodes) subscribers = O(nodes²) bytes per tick;
    the delta encoding ships only the changed entries. Both wire shapes
    are sized with the exact pickle the rpc layer sends, and one
    SchedulingPolicy pass over the full fleet view is timed — the per-
    broadcast work each raylet's _schedule() pays."""
    import pickle

    from ray_tpu_torch.core.scheduler import NodeView, SchedulingPolicy

    nodes = {}
    for i in range(n_nodes):
        nid = i.to_bytes(16, "big")
        nodes[nid.hex()] = {
            "address": f"10.{i >> 16 & 255}.{i >> 8 & 255}.{i & 255}:6379",
            "object_store_address":
                f"10.{i >> 16 & 255}.{i >> 8 & 255}.{i & 255}:6380",
            "total": {"CPU": 96.0, "GPU": 4.0, "memory": 4.0 * 1024**3},
            "available": {"CPU": 42.0, "GPU": 2.0, "memory": 2.0 * 1024**3},
            "labels": {"nvlink_domain": f"s{i % 64}"},
            "alive": True,
        }
    hexids = list(nodes)
    full_msg = {"kind": "full", "seq": 1, "epoch": 1, "nodes": nodes}
    delta_msg = {"kind": "delta", "seq": 2, "prev": 1, "epoch": 1,
                 "changed": {h: nodes[h] for h in hexids[:n_changed]},
                 "removed": []}
    full_bytes = len(pickle.dumps(full_msg, protocol=5))
    delta_bytes = len(pickle.dumps(delta_msg, protocol=5))

    views = [NodeView(bytes.fromhex(h), v["total"], v["available"],
                      v["labels"]) for h, v in nodes.items()]
    policy = SchedulingPolicy()
    policy.select_node(views, {"CPU": 1.0})  # warm native sync/caches
    iters = 50
    t0 = time.perf_counter()
    for _ in range(iters):
        policy.select_node(views, {"CPU": 1.0})
    select_us = (time.perf_counter() - t0) / iters * 1e6

    rate_hz = 10.0  # the debounce ceiling (resource_broadcast_period_ms)
    return {
        "n_nodes": n_nodes,
        "n_changed": n_changed,
        "full_publish_bytes": full_bytes,
        "delta_publish_bytes": delta_bytes,
        "delta_to_full_ratio": round(delta_bytes / full_bytes, 5),
        "full_gossip_bytes_per_s_at_10hz": int(
            full_bytes * n_nodes * rate_hz),
        "delta_gossip_bytes_per_s_at_10hz": int(
            delta_bytes * n_nodes * rate_hz),
        "select_node_us_at_scale": round(select_us, 1),
    }


def bench_broadcast(size_mib: int = 1024, n_receivers: int = 3) -> Dict:
    """1 GiB object broadcast over an in-process multi-raylet Cluster
    (reference: 1 GiB to 50+ nodes). The object is PUSHed from the owning
    node to every receiver's store (the `ray_tpu_torch.push` plane serve/rllib
    use for weight fan-out)."""
    import ray_tpu_torch.core.rpc as rpc
    from ray_tpu_torch.core.cluster import Cluster
    from ray_tpu_torch.core.ids import ObjectID

    store_bytes = 2 * (size_mib << 20)
    cluster = Cluster()
    src = cluster.add_node(num_cpus=1, object_store_memory=store_bytes)
    dsts = [cluster.add_node(num_cpus=1, object_store_memory=store_bytes)
            for _ in range(n_receivers)]
    try:
        oid = ObjectID.from_random()
        src.store.put_bytes(
            oid, np.ones(size_mib << 20, dtype=np.uint8).data)
        t0 = time.perf_counter()
        clients, futures = [], []
        for node in dsts:
            cli = rpc.connect_with_retry(node.address, timeout=10)
            clients.append(cli)
            futures.append(cli.call_future(
                "pull_object", {"object_id": oid, "source": src.address}))
        for fut, cli in zip(futures, clients):
            fut.result(timeout=600)
            cli.close()
        dt = time.perf_counter() - t0
        moved_bits = size_mib * (1 << 20) * 8 * n_receivers
        return {
            "size_mib": size_mib,
            "n_receivers": n_receivers,
            "wall_s": round(dt, 2),
            "aggregate_gbps": round(moved_bits / dt / 1e9, 2),  # decimal Gbit/s
        }
    finally:
        cluster.shutdown()


def run_envelope(scale: float = 1.0, elastic: bool = False) -> Dict:
    """Run every envelope bench inside one fresh runtime; returns the
    artifact dict (the CLI writes it to `--out`). With `elastic`, the
    burst-elasticity chaos scenario (core/burst.py: 10 -> 1000 workers
    under load with seeded kills) runs too and lands in the artifact."""
    import ray_tpu_torch
    from ray_tpu_torch.microbenchmark import run_microbenchmark

    results: Dict = {
        "suite": "scalability-envelope (scaled to one box)",
        "reference": "release/benchmarks/README.md:5-31; ray_perf.py:93-282",
        "hardware": _hardware(),
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S"),
    }
    def log(msg):
        print(f"[envelope] {msg}", file=sys.stderr, flush=True)

    own = not ray_tpu_torch.is_initialized()
    if own:
        ray_tpu_torch.init(num_cpus=8)
    try:
        log("queued_tasks...")
        results["queued_tasks"] = bench_queued_tasks(int(20_000 * scale))
        log("concurrent_actors...")
        results["concurrent_actors"] = bench_concurrent_actors(int(200 * scale))
        log("placement_groups...")
        results["placement_groups"] = bench_placement_groups(
            max(1, int(30 * scale)))
        log("microbenchmark...")
        results["microbenchmark"] = run_microbenchmark()
        log("broadcast_1k...")
        results["broadcast_1k_nodes"] = bench_broadcast_1k(
            max(8, int(1000 * scale)))
        if elastic:
            from ray_tpu_torch.core.burst import BurstProfile, run_burst

            log("elastic burst...")
            if scale >= 1.0:
                profile = BurstProfile()
            else:
                profile = BurstProfile(
                    n_start=max(2, int(10 * scale)),
                    n_target=max(4, int(1000 * scale)),
                    n_kills=max(1, int(8 * scale)))
            results["elastic_burst"] = run_burst(profile)
    finally:
        if own:
            ray_tpu_torch.shutdown()
    # broadcast boots its own multi-raylet cluster
    log("broadcast...")
    results["broadcast"] = bench_broadcast(int(1024 * scale) or 24)
    log("done")
    return results


def main(argv: List[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=DEFAULT_ARTIFACT,
                    help=f"write artifact JSON here (default "
                         f"{DEFAULT_ARTIFACT})")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="scale factor on every count (CI smoke uses 0.01)")
    ap.add_argument("--elastic", action="store_true",
                    help="also run the burst-elasticity chaos scenario "
                         "(10 -> 1000 workers under load + seeded kills)")
    args = ap.parse_args(argv)
    art = run_envelope(scale=args.scale, elastic=args.elastic)
    text = json.dumps(art, indent=2)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
