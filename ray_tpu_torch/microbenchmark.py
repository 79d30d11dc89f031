"""Core-primitive microbenchmarks (reference `python/ray/_private/ray_perf.py:93-282`,
run by `ray microbenchmark`): ops/s for tasks, actor calls, and object
put/get, plus submission-side metrics for the task-path fast lanes — p50
`.remote()` call latency and per-task TaskSpec wire bytes (which the
export-once function table drops from O(closure) to O(FunctionID)).

Requires an initialized runtime (`ray_tpu_torch.init()` first or run via the CLI,
which boots one).

CLI:
  python -m ray_tpu_torch.microbenchmark              # full suite, one JSON row/line
  python -m ray_tpu_torch.microbenchmark --quick --json   # CI smoke: small
                                          # batches, short timers, one JSON doc
  python -m ray_tpu_torch.microbenchmark --objplane  # object-plane rows only,
                                          # to build/OBJPLANE_torch.json

The rows measure the host runtime (no device work), so it runs on any host.
"""

from __future__ import annotations

import os
import pickle
import time
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np

import ray_tpu_torch

OBJPLANE_ARTIFACT = str(Path(__file__).resolve().parents[1] / "build"
                        / "OBJPLANE_torch.json")


def _rate(fn: Callable[[], int], min_seconds: float = 2.0) -> float:
    """ops/s: run batches of fn until min_seconds elapsed."""
    fn()  # warm up (worker spawn, compile)
    done = 0
    t0 = time.perf_counter()
    while True:
        done += fn()
        dt = time.perf_counter() - t0
        if dt >= min_seconds:
            return done / dt


@ray_tpu_torch.remote
def _noop():
    return None


@ray_tpu_torch.remote
def _noop_arg(x):
    return x


def _make_closure_fn(nbytes: int = 1024 * 1024):
    """A remote no-op capturing `nbytes` of state. Built INSIDE a function
    on purpose: a nested def is always cloudpickled BY VALUE, so the
    payload genuinely rides the export/spec — a module-level def would be
    pickled by reference whenever this module is imported (CLI subcommand,
    pytest) and the benchmark would measure a ~100-byte spec."""
    payload = b"c" * nbytes

    @ray_tpu_torch.remote
    def _noop_closure():
        return len(payload)

    return _noop_closure


@ray_tpu_torch.remote
class _BenchActor:
    def method(self):
        return None

    def echo(self, x):
        return x


def _submission_metrics(record, quick: bool) -> None:
    """Submission-side fast-lane metrics: p50 time of an individual
    `.remote()` call, and the pickled TaskSpec size for a closure-heavy
    function on its first vs steady-state submission."""
    from ray_tpu_torch.core import api as _api

    n = 50 if quick else 300
    lat: List[float] = []
    refs = []
    ray_tpu_torch.get(_noop.remote())  # ensure export + a warm worker
    for _ in range(n):
        t0 = time.perf_counter()
        refs.append(_noop.remote())
        lat.append(time.perf_counter() - t0)
    ray_tpu_torch.get(refs)
    lat.sort()
    record("task_submit_p50", lat[len(lat) // 2] * 1e6, unit="us")

    w = _api._global_worker()
    if not hasattr(w, "_spec_bytes_probe"):
        return  # client mode: specs are built server-side
    payload = b"z" * (256 * 1024)

    @ray_tpu_torch.remote
    def _closure_heavy():
        return len(payload)

    sizes: List[int] = []
    w._spec_bytes_probe = lambda spec: sizes.append(
        len(pickle.dumps(spec, protocol=5)))
    try:
        ray_tpu_torch.get(_closure_heavy.remote())
        ray_tpu_torch.get(_closure_heavy.remote())
    finally:
        w._spec_bytes_probe = None
    record("task_wire_bytes_first", sizes[0], unit="bytes")
    record("task_wire_bytes_steady", sizes[1], unit="bytes")


def _completion_metrics(record, quick: bool) -> None:
    """Return-path fast-lane metrics: p50 end-to-end latency of one task
    (submit -> result landed at the owner, the adaptive-flush idle path) and
    drain throughput of a deep queue of no-ops (the batched path: dominated
    by result delivery, task_done handling and scheduler wakeups, not by
    submission)."""
    ray_tpu_torch.get(_noop.remote())  # warm worker + export
    n = 30 if quick else 100
    lat: List[float] = []
    for _ in range(n):
        t0 = time.perf_counter()
        ray_tpu_torch.get(_noop.remote())
        lat.append(time.perf_counter() - t0)
    lat.sort()
    record("task_e2e_p50", lat[len(lat) // 2] * 1e6, unit="us")

    depth = 200 if quick else 2000
    t0 = time.perf_counter()
    ray_tpu_torch.get([_noop.remote() for _ in range(depth)])
    record("task_completions_per_s", depth / (time.perf_counter() - t0))


def run_microbenchmark(batch: int = 100, quick: bool = False) -> List[Dict]:
    """`quick` = CI smoke mode: small batches and short timers so the whole
    suite runs in seconds on CPU while still driving every primitive."""
    min_seconds = 0.2 if quick else 2.0
    if quick:
        batch = min(batch, 25)
    results: List[Dict] = []

    def record(name: str, rate: float, unit: str = "ops/s"):
        results.append({"benchmark": name, "rate": round(rate, 1), "unit": unit})

    def rate(fn):
        return _rate(fn, min_seconds=min_seconds)

    # tasks: batched submit + get
    record("tasks_sync_batch", rate(
        lambda: len(ray_tpu_torch.get([_noop.remote() for _ in range(batch)]))))

    # single task round-trip latency expressed as ops/s
    record("task_roundtrip", rate(
        lambda: (ray_tpu_torch.get(_noop.remote()), 1)[1]))

    arg = b"y" * 1024
    record("tasks_1kb_arg_batch", rate(
        lambda: len(ray_tpu_torch.get([_noop_arg.remote(arg) for _ in range(batch)]))))

    # the function-table acceptance benchmark: same 1 MiB-closure function
    # submitted N times (export-once -> specs carry a 16-byte id)
    closure_fn = _make_closure_fn()
    record("tasks_1mb_closure_batch", rate(
        lambda: len(ray_tpu_torch.get([closure_fn.remote() for _ in range(batch)]))))

    a = _BenchActor.options(num_cpus=0).remote()
    record("actor_calls_sync_batch", rate(
        lambda: len(ray_tpu_torch.get([a.method.remote() for _ in range(batch)]))))
    record("actor_call_roundtrip", rate(
        lambda: (ray_tpu_torch.get(a.method.remote()), 1)[1]))
    record("actor_echo_1kb_batch", rate(
        lambda: len(ray_tpu_torch.get([a.echo.remote(arg) for _ in range(batch)]))))

    small = b"x" * 1024
    record("put_1kb", rate(
        lambda: ([ray_tpu_torch.put(small) for _ in range(batch)], batch)[1]))

    _object_plane_metrics(record, rate, batch, quick)

    _submission_metrics(record, quick)
    _completion_metrics(record, quick)

    ray_tpu_torch.kill(a)
    return results


def _object_plane_metrics(record, rate, batch: int, quick: bool) -> None:
    """Data-plane rows (the zero-copy object plane). Row names
    are scale-independent — the zero-copy path made the full sizes cheap
    enough for the quick/CI profile, so the regression floors always
    compare like with like."""
    # same-node put+get of a 10 MB numpy array: put is one obj_create
    # round-trip + one aligned write into a (usually recycled) segment;
    # get attaches the segment and deserializes in place
    big = np.zeros(10 * 1024 * 1024 // 8)
    def put_get_big():
        ref = ray_tpu_torch.put(big)
        out = ray_tpu_torch.get(ref)
        return int(out.nbytes)
    record("put_get_10mb_bytes", rate(put_get_big), unit="bytes/s")

    # 100 MB numpy roundtrip: the zero-copy headline — the returned array
    # is a read-only view into shared memory, so the cycle cost is ONE
    # aligned write plus control overhead
    huge = np.zeros(100 * 1024 * 1024 // 8)
    def np_roundtrip():
        out = ray_tpu_torch.get(ray_tpu_torch.put(huge))
        assert not out.flags.writeable  # views, not copies
        return int(out.nbytes)
    record("np_roundtrip_100mb", rate(np_roundtrip), unit="bytes/s")
    del huge

    # 32 MB raw-bytes roundtrip: serve payloads / rollout blobs are plain
    # `bytes`, not numpy — the serializer's out-of-band blob lane
    # must put them on the same zero-copy plane (in-band pickle costs two
    # extra full-memory passes per cycle: one into the pickle stream, one
    # into the frame)
    blob = b"\x00" * (32 * 1024 * 1024)
    def bytes_roundtrip():
        out = ray_tpu_torch.get(ray_tpu_torch.put(blob))
        assert len(out) == len(blob)
        return len(blob)
    record("put_get_32mb_raw_bytes", rate(bytes_roundtrip), unit="bytes/s")
    del blob

    # 1 MB arg fanned out to a batch of tasks through ONE shared ref: every
    # executor materializes the arg (and its 1 MB echo) through the
    # object plane — tasks/s, the RLAX rollout-traffic shape
    @ray_tpu_torch.remote
    def _echo_arg(x):
        return x
    arg = np.zeros(1 << 20, dtype=np.uint8)
    arg_ref = ray_tpu_torch.put(arg)
    fan = max(4, batch // 4) if quick else batch
    record("arg_1mb_fanout", rate(
        lambda: len(ray_tpu_torch.get([_echo_arg.remote(arg_ref)
                                 for _ in range(fan)]))))


def run_objplane(quick: bool = False):
    """The object-plane benchmark (`--objplane`'s artifact): just the
    data-plane rows, at full sizes, on an initialized runtime."""
    results: List[Dict] = []

    def record(name: str, rate_v: float, unit: str = "ops/s"):
        results.append({"benchmark": name, "rate": round(rate_v, 1),
                        "unit": unit})

    def rate(fn):
        return _rate(fn, min_seconds=0.5 if quick else 2.0)

    ray_tpu_torch.get(_noop.remote())  # warm worker + export
    _object_plane_metrics(record, rate, batch=100, quick=quick)
    return results


def main(argv=None) -> int:
    import argparse
    import json

    parser = argparse.ArgumentParser(prog="ray_tpu_torch.microbenchmark")
    parser.add_argument("--json", action="store_true", dest="as_json",
                        help="emit one JSON document instead of a row per line")
    parser.add_argument("--quick", action="store_true",
                        help="CI smoke mode: small batches, short timers")
    parser.add_argument("--batch", type=int, default=100)
    parser.add_argument("--objplane", metavar="PATH", default=None,
                        nargs="?", const=OBJPLANE_ARTIFACT,
                        help="run ONLY the object-plane rows (full sizes) "
                             "and write their artifact JSON here (default "
                             f"{OBJPLANE_ARTIFACT})")
    args = parser.parse_args(argv)

    own_cluster = not ray_tpu_torch.is_initialized()
    if own_cluster:
        ray_tpu_torch.init(num_cpus=4)
    try:
        if args.objplane:
            from ray_tpu_torch.envelope import _hardware

            rows = run_objplane(quick=args.quick)
            # the reference's baseline is a figure of another host and
            # runtime, not of this one: no baseline, so no speedup
            art = {
                "bench": "object-plane (zero-copy pin protocol)",
                "quick": args.quick,
                "hardware": _hardware(),
                "baseline": None,
                "results": rows,
                "put_get_10mb_speedup": None,
            }
            text = json.dumps(art, indent=2)
            os.makedirs(os.path.dirname(os.path.abspath(args.objplane)),
                        exist_ok=True)
            with open(args.objplane, "w") as f:
                f.write(text + "\n")
            print(text)
            return 0
        rows = run_microbenchmark(batch=args.batch, quick=args.quick)
        if args.as_json:
            print(json.dumps({"quick": args.quick, "batch": args.batch,
                              "results": rows}))
        else:
            for row in rows:
                print(json.dumps(row))
    finally:
        if own_cluster:
            ray_tpu_torch.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
