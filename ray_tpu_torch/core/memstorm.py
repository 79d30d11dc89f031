"""Store storm: the storage failure domain under compound fire.

Drives a single-node cluster's object store at a multiple of its shm
capacity so spilling is the steady state, then layers every storage
failure mode on top — seeded through the `fs:<site>` fault points the
store itself exercises (`core/object_store.py`):

  * ENOSPC windows: every spill dir refuses writes
    (``fs:spill_write:enospc``) — the store must walk its retry ladder,
    enter SPILL-DEGRADED, flip puts to typed ``ObjectStoreFullError``
    backpressure, and SELF-HEAL through its probe once the window lifts;
  * spill corruption: seeded bitflip/torn envelopes at spill-write time
    and EIO at restore time — a later read must detect the damage via
    the checksummed envelope (never return corrupt bytes), mark the copy
    LOST, and route task-produced objects into lineage reconstruction;
  * long-held reader pins past ``max_pinned_fraction`` — further readers
    must degrade to bounded copy-only grants (``pin_cap``), not wedge
    the store and not report objects lost;
  * memory-monitor OOM kills of producer workers mid-storm
    (deterministic ``memory_monitor_worker_budget_bytes`` mode) —
    retriable producers complete, a no-retry hog surfaces a typed
    ``OutOfMemoryError``.

The storm asserts the storage contract:

  * ZERO hung gets — every get resolves within its budget as a value,
    a reconstructed value, or a TYPED error;
  * ZERO silent corruption — every resolved value's crc32 matches the
    payload recomputed from (seed, index): a bitflipped spill that
    round-trips unnoticed fails the run;
  * typed backpressure — puts during the degraded window fail with
    ``ObjectStoreFullError``, nothing else;
  * post-heal convergence — after the chaos lifts and refs drop, the
    store exits degraded state, sheds its pins, and settles back under
    the spill threshold.

Writes a JSON artifact, by default `build/STORESTORM_torch.json` (git
ignores build/; the JAX package's STORESTORM_r18.json is never written).
The storm does no device work, so it runs on any host. Run directly:

    python -m ray_tpu_torch.core.memstorm             # full profile
    python -m ray_tpu_torch.core.memstorm --quick     # CI profile
"""

from __future__ import annotations

import argparse
import gc
import json
import logging
import os
import shutil
import sys
import tempfile
import time
import zlib
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

DEFAULT_ARTIFACT = str(Path(__file__).resolve().parents[2] / "build"
                       / "STORESTORM_torch.json")


@dataclass
class MemStormProfile:
    capacity_mb: int = 128        # object store shm budget
    object_mb: int = 3            # per-object payload
    overcommit: float = 3.0       # live object bytes vs capacity
    wave: int = 8                 # concurrent producer tasks per wave
    corrupt_prob: float = 0.35    # bitflip prob during the corrupt window
    restore_eio_prob: float = 0.3  # EIO prob during the restore window
    restore_eio_gets: int = 24    # gets swept inside the restore window
    degrade_cycles: int = 2       # ENOSPC -> degraded -> heal cycles
    max_pinned_fraction: float = 0.35
    held_pins: int = 18           # held readers (held bytes > pin cap)
    oom_hogs: int = 8             # retriable hogs (4 concurrent ~2x budget)
    hog_mb: int = 260
    oom_budget_mb: int = 700      # memory_monitor_worker_budget_bytes
    seed: int = 0
    put_full_timeout_s: float = 1.5
    get_timeout_s: float = 60.0
    settle_timeout_s: float = 90.0


QUICK_PROFILE = dict(capacity_mb=64, object_mb=2, overcommit=2.5,
                     wave=6, restore_eio_gets=12, degrade_cycles=1,
                     held_pins=14, oom_hogs=4, hog_mb=150,
                     oom_budget_mb=400, settle_timeout_s=60.0)


def _payload(seed: int, i: int, nbytes: int):
    """Deterministic position-dependent payload for (seed, i): the
    consumer recomputes it to verify end-to-end integrity, so a spill
    bitflip that survives the envelope check cannot go unnoticed."""
    import numpy as np

    base = np.arange(nbytes, dtype=np.uint64)
    return ((base * 2654435761 + seed * 1000003 + i) & 0xFF).astype(
        np.uint8)


def _crc(seed: int, i: int, nbytes: int) -> int:
    return zlib.crc32(_payload(seed, i, nbytes))


def run_memstorm(profile: Optional[MemStormProfile] = None,
                 out_path: Optional[str] = None) -> Dict[str, Any]:
    """One store storm on a fresh single-node in-process cluster (the
    raylet + store run in THIS process, so the installed fault injector
    reaches the spill fault points). The caller must NOT have ray_tpu_torch
    initialized."""
    import numpy as np

    import ray_tpu_torch
    from ray_tpu_torch.core import rpc
    from ray_tpu_torch.core.cluster import Cluster
    from ray_tpu_torch.core.config import get_config
    from ray_tpu_torch.core.exceptions import (ObjectLostError,
                                         ObjectStoreFullError,
                                         OutOfMemoryError)

    p = profile or MemStormProfile()
    capacity = p.capacity_mb << 20
    nbytes = p.object_mb << 20
    cfg = get_config()
    saved = (cfg.object_spill_dirs, cfg.spill_degraded_probe_period_s,
             cfg.put_full_timeout_s, cfg.max_pinned_fraction,
             cfg.memory_monitor_worker_budget_bytes,
             cfg.memory_usage_threshold, cfg.memory_monitor_refresh_ms,
             cfg.memory_monitor_kill_cooldown_ms)
    extra_spill_root = tempfile.mkdtemp(prefix="rtt-memstorm-spill-")
    cfg.object_spill_dirs = extra_spill_root
    cfg.spill_degraded_probe_period_s = 0.3
    cfg.put_full_timeout_s = p.put_full_timeout_s
    cfg.max_pinned_fraction = p.max_pinned_fraction
    cfg.memory_monitor_worker_budget_bytes = p.oom_budget_mb << 20
    cfg.memory_usage_threshold = 0.9
    cfg.memory_monitor_refresh_ms = 100
    cfg.memory_monitor_kill_cooldown_ms = 500

    violations: List[str] = []
    phases: Dict[str, Any] = {}
    inj = rpc.install_fault_injector("", seed=p.seed)
    cluster = None
    raylet = None
    try:
        cluster = Cluster()
        raylet = cluster.add_node(num_cpus=4,
                                  object_store_memory=capacity)
        cluster.connect()
        store = raylet.store
        threshold = cfg.object_spilling_threshold

        @ray_tpu_torch.remote(max_retries=4)
        def produce(seed, i, nbytes):
            return _payload(seed, i, nbytes)

        @ray_tpu_torch.remote(max_retries=6)
        def hog(i, ballast_mb):
            import numpy as _np
            import time as _t

            ballast = _np.ones((ballast_mb << 20) // 8)
            _t.sleep(1.0)
            return i + int(ballast[0])

        @ray_tpu_torch.remote(max_retries=0)
        def uber_hog(ballast_mb):
            import numpy as _np
            import time as _t

            ballast = _np.ones((ballast_mb << 20) // 8)
            _t.sleep(30.0)
            return int(ballast[0])

        task_refs: List[Any] = []   # (ref, i) — lineage-recoverable
        put_refs: List[Any] = []    # (ref, i) — no lineage (driver puts)

        def produce_wave(start: int, count: int) -> None:
            idx = list(range(start, start + count))
            for chunk in range(0, len(idx), p.wave):
                batch = idx[chunk:chunk + p.wave]
                refs = [produce.remote(p.seed, i, nbytes) for i in batch]
                # resolve the wave so production can't outrun the store
                ray_tpu_torch.get(refs, timeout=p.get_timeout_s)
                task_refs.extend(zip(refs, batch))

        # ---- phase 1: fill to overcommit (spilling = steady state) ------
        t0 = time.monotonic()
        n_fill = max(p.wave, int(p.overcommit * capacity / nbytes))
        produce_wave(0, n_fill)
        st = store.stats()
        if st["spilled_bytes_total"] == 0:
            violations.append(
                f"fill never spilled: {st['used_bytes']}B used of "
                f"{capacity}B with {n_fill} x {nbytes}B live objects")
        phases["fill"] = {
            "objects": n_fill, "s": round(time.monotonic() - t0, 2),
            "spilled_bytes_total": st["spilled_bytes_total"]}

        # ---- restore bandwidth: gets over the cold (spilled) tail -------
        # the oldest fill objects were evicted first; reading them back
        # measures the verified-restore path (envelope check included)
        restored0 = st["restored_bytes_total"]
        t0 = time.monotonic()
        for ref, i in task_refs[:p.wave]:
            arr = ray_tpu_torch.get(ref, timeout=p.get_timeout_s)
            del arr
        restore_s = time.monotonic() - t0
        restored_delta = (store.stats()["restored_bytes_total"]
                          - restored0)
        spill_restore_gbps = (
            round(restored_delta / restore_s / 1e9, 3)
            if restored_delta and restore_s > 0 else None)
        phases["restore_bandwidth"] = {
            "restored_bytes": restored_delta,
            "s": round(restore_s, 3),
            "spill_restore_gbps": spill_restore_gbps}

        # ---- phase 2: corrupt window (bitflip + torn spill envelopes) ---
        t0 = time.monotonic()
        r_bitflip = inj.fs("spill_write", "bitflip", prob=p.corrupt_prob)
        r_torn = inj.fs("spill_write", "torn", prob=p.corrupt_prob / 2)
        n_extra = max(p.wave, int(0.5 * capacity / nbytes))
        produce_wave(n_fill, n_extra)
        r_bitflip.armed = False
        r_torn.armed = False
        phases["corrupt_window"] = {
            "objects": n_extra, "s": round(time.monotonic() - t0, 2)}

        # ---- phase 3: ENOSPC -> degraded -> typed backpressure -> heal --
        cycles = []
        puts_rejected_typed = 0
        for cyc in range(p.degrade_cycles):
            t0 = time.monotonic()
            r_enospc = inj.fs("spill_write", "enospc", prob=1.0)
            typed = untyped = 0
            # drive puts into the window: the ladder fails every dir,
            # the store degrades, and puts flip to bounded typed errors
            for k in range(64):
                i = 100_000 + cyc * 1000 + k
                try:
                    put_refs.append((ray_tpu_torch.put(_payload(p.seed, i,
                                                          nbytes)), i))
                except ObjectStoreFullError:
                    typed += 1
                    if typed >= 2:
                        break
                except Exception as e:
                    untyped += 1
                    violations.append(
                        f"degraded put raised untyped "
                        f"{type(e).__name__}: {e}"[:160])
                    break
            if typed == 0:
                violations.append(
                    f"cycle {cyc}: ENOSPC window never produced a typed "
                    f"ObjectStoreFullError put rejection")
            puts_rejected_typed += typed
            if not store.stats()["spill_degraded"]:
                violations.append(
                    f"cycle {cyc}: store never entered spill-degraded "
                    f"state under all-dirs ENOSPC")
            t_degraded = time.monotonic()
            r_enospc.armed = False
            # self-heal: the probe runs on allocation pressure; small
            # puts tick it until the store exits degraded state
            healed = False
            heal_deadline = time.monotonic() + p.settle_timeout_s
            while time.monotonic() < heal_deadline:
                try:
                    i = 200_000 + cyc * 1000 + int(
                        (time.monotonic() - t_degraded) * 100)
                    put_refs.append((ray_tpu_torch.put(_payload(p.seed, i,
                                                          nbytes)), i))
                except ObjectStoreFullError:
                    pass  # still degraded/full: keep ticking the probe
                if not store.stats()["spill_degraded"]:
                    healed = True
                    break
                time.sleep(0.1)
            if not healed:
                violations.append(
                    f"cycle {cyc}: store never healed after the ENOSPC "
                    f"window lifted")
            cycles.append({
                "typed_put_rejections": typed,
                "heal_s": round(time.monotonic() - t_degraded, 2)
                if healed else None,
                "s": round(time.monotonic() - t0, 2)})
        phases["degrade_cycles"] = cycles

        # ---- phase 4: long-held reader pins past the cap ----------------
        t0 = time.monotonic()
        pin_cap0 = store.stats()["pin_cap_refusals"]
        held = []
        rng_idx = [(i * 7919) % len(task_refs)
                   for i in range(p.held_pins)]
        for j in sorted(set(rng_idx))[:p.held_pins]:
            ref, i = task_refs[j]
            arr = ray_tpu_torch.get(ref, timeout=p.get_timeout_s)
            if zlib.crc32(np.ascontiguousarray(arr)) != _crc(p.seed, i,
                                                             nbytes):
                violations.append(
                    f"held-pin get of object {i} returned corrupt bytes")
            held.append(arr)
        held_bytes = sum(a.nbytes for a in held)
        # with the cap exceeded, further reads must still resolve —
        # served as bounded copy-only grants, not wedges or false losses
        extra_ok = 0
        for j in range(p.held_pins, p.held_pins + 6):
            ref, i = task_refs[(j * 104729) % len(task_refs)]
            arr = ray_tpu_torch.get(ref, timeout=p.get_timeout_s)
            if zlib.crc32(np.ascontiguousarray(arr)) == _crc(p.seed, i,
                                                             nbytes):
                extra_ok += 1
            del arr
        pin_cap_refusals = store.stats()["pin_cap_refusals"] - pin_cap0
        if held_bytes > p.max_pinned_fraction * capacity \
                and pin_cap_refusals == 0:
            violations.append(
                f"{held_bytes}B held past the "
                f"{p.max_pinned_fraction:.2f} cap but pin_cap_refusals "
                f"never fired")
        phases["pin_pressure"] = {
            "held": len(held), "held_bytes": held_bytes,
            "reads_past_cap_ok": extra_ok,
            "pin_cap_refusals": pin_cap_refusals,
            "s": round(time.monotonic() - t0, 2)}
        del held
        gc.collect()

        # ---- phase 5: memory-monitor OOM kills of producers -------------
        t0 = time.monotonic()
        kills0 = raylet.oom_kills_total
        hog_refs = [hog.remote(i, p.hog_mb) for i in range(p.oom_hogs)]
        hogs_ok = 0
        for i, r in enumerate(hog_refs):
            try:
                if ray_tpu_torch.get(r, timeout=p.settle_timeout_s * 2) == i + 1:
                    hogs_ok += 1
                else:
                    violations.append(f"hog {i} returned a wrong value")
            except Exception as e:
                violations.append(
                    f"retriable hog {i} never completed: "
                    f"{type(e).__name__}")
        typed_oom = False
        try:
            ray_tpu_torch.get(uber_hog.remote(int(p.oom_budget_mb * 1.3)),
                        timeout=p.settle_timeout_s * 2)
            violations.append("uber-hog exceeding the budget succeeded")
        except OutOfMemoryError:
            typed_oom = True
        except Exception as e:
            violations.append(
                f"uber-hog died untyped: {type(e).__name__}: {e}"[:160])
        oom_kills = raylet.oom_kills_total - kills0
        if oom_kills == 0:
            violations.append("memory monitor never killed a worker "
                              "under 2x budget oversubscription")
        phases["oom"] = {
            "hogs_completed": hogs_ok, "of": p.oom_hogs,
            "oom_kills": oom_kills, "typed_oom_error": typed_oom,
            "s": round(time.monotonic() - t0, 2)}

        # ---- phase 6: resolution sweep (zero hung, zero corruption) -----
        t0 = time.monotonic()
        outcomes = {"verified": 0, "typed_lost": 0, "hung": 0,
                    "crc_mismatch": 0, "untyped": 0}
        restore_window = min(p.restore_eio_gets, len(task_refs))
        r_eio = inj.fs("spill_restore", "eio", prob=p.restore_eio_prob)
        deadline = time.monotonic() + p.settle_timeout_s * 2
        for n, (ref, i) in enumerate(task_refs + put_refs):
            if n == restore_window:
                r_eio.armed = False
            is_put = n >= len(task_refs)
            per_get = min(p.get_timeout_s,
                          max(1.0, deadline - time.monotonic()))
            try:
                arr = ray_tpu_torch.get(ref, timeout=per_get)
            except ObjectLostError:
                if is_put:
                    # driver puts have no lineage: a lost spilled copy
                    # legitimately resolves as a typed loss
                    outcomes["typed_lost"] += 1
                else:
                    outcomes["untyped"] += 1
                    violations.append(
                        f"task object {i} lost despite lineage "
                        f"(reconstruction failed)")
                continue
            except ray_tpu_torch.GetTimeoutError:
                outcomes["hung"] += 1
                violations.append(f"get of object {i} hung past "
                                  f"{per_get:.0f}s")
                continue
            except Exception as e:
                outcomes["untyped"] += 1
                violations.append(
                    f"get of object {i} raised "
                    f"{type(e).__name__}: {e}"[:160])
                continue
            if zlib.crc32(np.ascontiguousarray(arr)) == _crc(p.seed, i,
                                                             nbytes):
                outcomes["verified"] += 1
            else:
                outcomes["crc_mismatch"] += 1
                violations.append(
                    f"SILENT CORRUPTION: object {i} resolved with a "
                    f"wrong checksum")
            del arr
        r_eio.armed = False
        phases["sweep"] = dict(outcomes,
                               total=len(task_refs) + len(put_refs),
                               s=round(time.monotonic() - t0, 2))

        # ---- phase 7: post-heal convergence -----------------------------
        t0 = time.monotonic()
        task_refs.clear()
        put_refs.clear()
        gc.collect()
        converged = False
        conv_deadline = time.monotonic() + p.settle_timeout_s
        while time.monotonic() < conv_deadline:
            st = store.stats()
            if not st["spill_degraded"] and st["pinned_bytes"] == 0 \
                    and st["used_bytes"] <= threshold * capacity:
                converged = True
                break
            gc.collect()
            time.sleep(0.2)
        st = store.stats()
        if not converged:
            violations.append(
                f"store never converged post-heal: used="
                f"{st['used_bytes']}B (threshold "
                f"{int(threshold * capacity)}B) pinned="
                f"{st['pinned_bytes']}B degraded="
                f"{st['spill_degraded']}")
        phases["convergence"] = {
            "converged": converged,
            "used_fraction": round(st["used_bytes"] / capacity, 3),
            "s": round(time.monotonic() - t0, 2)}

        result = {
            "suite": "store storm (storage failure domain)",
            "profile": {
                "capacity_mb": p.capacity_mb, "object_mb": p.object_mb,
                "overcommit": p.overcommit,
                "corrupt_prob": p.corrupt_prob,
                "restore_eio_prob": p.restore_eio_prob,
                "degrade_cycles": p.degrade_cycles,
                "max_pinned_fraction": p.max_pinned_fraction,
                "held_pins": p.held_pins, "oom_hogs": p.oom_hogs,
                "oom_budget_mb": p.oom_budget_mb, "seed": p.seed,
            },
            "phases": phases,
            "counters": {
                "spilled_bytes_total": st["spilled_bytes_total"],
                "restored_bytes_total": st["restored_bytes_total"],
                "spill_failures": st["spill_failures"],
                "lost_spills": st["lost_spills"],
                "put_backpressure": st["put_backpressure"],
                "pin_cap_refusals": st["pin_cap_refusals"],
                "degraded_enters": st["degraded_enters"],
                "degraded_heals": st["degraded_heals"],
                "puts_rejected_typed": puts_rejected_typed,
                "fs_faults_injected": inj.stats["fs"],
            },
            "spill_restore_gbps": spill_restore_gbps,
            "zero_hung": phases["sweep"]["hung"] == 0,
            "zero_silent_corruption":
                phases["sweep"]["crc_mismatch"] == 0,
            "violations": violations,
            "ok": not violations,
        }
        if out_path:
            with open(out_path, "w") as f:
                json.dump(result, f, indent=2)
                f.write("\n")
        return result
    finally:
        rpc.clear_fault_injector()
        if cluster is not None:
            try:
                cluster.shutdown()
            except Exception:
                logger.exception("memstorm cluster shutdown failed")
        shutil.rmtree(extra_spill_root, ignore_errors=True)
        (cfg.object_spill_dirs, cfg.spill_degraded_probe_period_s,
         cfg.put_full_timeout_s, cfg.max_pinned_fraction,
         cfg.memory_monitor_worker_budget_bytes,
         cfg.memory_usage_threshold, cfg.memory_monitor_refresh_ms,
         cfg.memory_monitor_kill_cooldown_ms) = saved


def main(argv: Optional[List[str]] = None) -> int:
    logging.basicConfig(level=logging.WARNING)
    ap = argparse.ArgumentParser(
        description="store storm: the storage failure domain under fire")
    ap.add_argument("--quick", action="store_true",
                    help="small CI profile")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=DEFAULT_ARTIFACT,
                    help=f"write the result artifact here (default "
                         f"{DEFAULT_ARTIFACT})")
    args = ap.parse_args(argv)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
    kw: Dict[str, Any] = dict(QUICK_PROFILE) if args.quick else {}
    kw["seed"] = args.seed
    p = MemStormProfile(**kw)
    result = run_memstorm(p, out_path=args.json)
    print(json.dumps(result, indent=2))
    c = result["counters"]
    sw = result["phases"]["sweep"]
    print(f"[memstorm] seed={p.seed} capacity={p.capacity_mb}MB "
          f"overcommit={p.overcommit}x | gets={sw['total']} "
          f"verified={sw['verified']} typed_lost={sw['typed_lost']} "
          f"hung={sw['hung']} crc_mismatch={sw['crc_mismatch']} | "
          f"spilled={c['spilled_bytes_total']} "
          f"restored={c['restored_bytes_total']} "
          f"spill_failures={c['spill_failures']} "
          f"lost_spills={c['lost_spills']} | "
          f"backpressure={c['put_backpressure']} "
          f"pin_cap={c['pin_cap_refusals']} "
          f"degraded={c['degraded_enters']}/"
          f"heals={c['degraded_heals']} "
          f"oom_kills={result['phases']['oom']['oom_kills']}",
          file=sys.stderr)
    if not result["ok"]:
        print("[memstorm] VIOLATIONS:", file=sys.stderr)
        for v in result["violations"]:
            print(f"  - {v}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
