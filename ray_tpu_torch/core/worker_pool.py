"""Warm worker pool: fork-template ("zygote") workers + demand-driven prestart.

Equivalent of the reference's per-runtime-env worker pool with prestart
(`src/ray/raylet/worker_pool.cc:1363` PrestartWorkers, `worker_pool.h:156`),
re-designed around the one cost that dominates this runtime's actor fan-out:
a cold `subprocess.Popen(python -m ray_tpu_torch.core.worker_main)` pays the full
interpreter + `ray_tpu_torch`/numpy import bill per worker, serialized on small
hosts by `maximum_startup_concurrency` (the JAX package's CPU-host
ENVELOPE_r06: 200 actors took 49.2 s to first ping — almost all of it
import CPU).

The subsystem has three parts:

* **Template ("zygote") process** — one per runtime-env key, spawned once
  with the env's interpreter and env vars. It imports `ray_tpu_torch` + the worker
  machinery (and any `RAY_TPU_TORCH_WORKER_TEMPLATE_PRELOAD` modules), then parks
  single-threaded on a command pipe. Each granted lease costs one
  `os.fork()` (~1 ms) instead of one cold boot (~100-200 ms of import CPU
  that serializes under load): the child closes the template's control fds,
  re-seeds, and runs the exact same `worker_main.run_worker` path a cold
  worker runs — so from registration onward the raylet cannot tell them
  apart except for the stats it keeps.

* **Demand-driven prestart** — the reference policy (~1 worker per CPU up to
  the current backlog) replaces the previously-dead `num_prestart_workers`
  knob, which survives as the FLOOR of the policy: the default env keeps at
  least that many task workers alive (busy, idle or starting) from raylet
  boot onward, and the idle reaper will not shrink the idle pool below the
  floor.

* **Graceful degradation** — anything the fork path cannot serve falls back
  to the cold `Popen` path the raylet has always had: platforms without
  `os.fork`, container runtime envs (`command_prefix` crosses a process
  boundary a host-side fork cannot), runtime envs not yet built (their
  creation runs on the cold path's env-creation thread), a template that crashed
  or timed out booting. Template crashes respawn under `util/backoff.py`
  full-jitter; while the backoff clock runs, leases are served cold.

Forked workers are adopted into the raylet's existing lifecycle through a
Popen-compatible `ForkedWorkerProc` shim, so idle-kill, `max_calls` recycle,
memory-pressure kills, `recent_done` failover and shutdown treat them
identically to spawned workers.
"""

from __future__ import annotations

import logging
import os
import select
import signal
import subprocess
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.util.backoff import ExponentialBackoff

logger = logging.getLogger(__name__)

# Modules a template pre-imports so forked children never pay for them.
# Everything here is import-only (no threads, no sockets, no locks held)
# — the template MUST stay single-threaded or fork() inherits torn state.
_DEFAULT_PRELOAD = (
    "ray_tpu_torch",
    "ray_tpu_torch.core.worker",
    "ray_tpu_torch.core.worker_main",
    "ray_tpu_torch.core.serialization",
    "ray_tpu_torch.core.result_buffer",
    "ray_tpu_torch.core.task_events",
    "numpy",
)


def _native_threads() -> int:
    """Threads of this process as the kernel counts them (Python's
    `threading` misses native pools such as OpenBLAS's or torch's)."""
    try:
        return len(os.listdir("/proc/self/task"))
    except OSError:
        return threading.active_count()


def _preload_torch() -> None:
    """Import torch in the template WITHOUT touching CUDA.

    A process that initialized CUDA cannot hand a usable context to a
    forked child, and even `torch.cuda.is_available()` initializes the
    driver, so the template calls nothing under `torch.cuda`: each forked
    worker that uses a card creates its own context on first use, and
    workers that never touch a card create none. The import starts no
    intra-op pool (that starts on the first parallel op); a pool that is
    live at fork time would be lost in every child, so it is logged."""
    before = _native_threads()
    import torch  # noqa: F401

    grown = _native_threads() - before
    if grown > 0:
        logger.warning("worker template: importing torch started %d native "
                       "threads; forked workers do not inherit them", grown)


def fork_supported() -> bool:
    return hasattr(os, "fork") and os.name == "posix"


class ForkedWorkerProc:
    """Popen-compatible handle for a worker forked from a template.

    The child's PARENT is the template (which reaps it via SIGCHLD=SIG_IGN),
    so the raylet cannot `waitpid` it — liveness is probed with signal 0 and
    kills are plain `os.kill`. Implements the slice of the Popen surface the
    raylet's lifecycle code touches (`pid`, `poll`, `wait`, `terminate`,
    `kill`, `returncode`) so forked workers ride `_starting`, the reaper,
    idle-kill and `stop()` unchanged.
    """

    forked = True

    def __init__(self, pid: int):
        self.pid = pid
        self.returncode: Optional[int] = None
        # signal-0 liveness lies once the (template-reaped) pid is reused
        # by an unrelated process: the raylet reaper expires shims still
        # unregistered past worker_register_timeout_s using this stamp
        self.started_at = time.monotonic()

    def poll(self) -> Optional[int]:
        if self.returncode is not None:
            return self.returncode
        try:
            os.kill(self.pid, 0)
        except OSError:
            # exit status is unknowable from here (the template reaped it)
            self.returncode = -1
            return self.returncode
        # signal 0 succeeds on a ZOMBIE: a child that outlived its template
        # (e.g. shutdown closes the zygote first) reparents to init and
        # lingers unreaped — without this check, wait() spins its full
        # timeout per worker at raylet stop
        try:
            with open(f"/proc/{self.pid}/stat", "rb") as f:
                stat = f.read()
            if stat[stat.rfind(b")") + 2:stat.rfind(b")") + 3] == b"Z":
                self.returncode = -1
        except (OSError, IndexError):
            pass  # no /proc (non-Linux): keep the signal-0 answer
        return self.returncode

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.monotonic() + timeout
        while self.poll() is None:
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(f"forked:{self.pid}", timeout)
            time.sleep(0.02)
        return self.returncode

    def terminate(self) -> None:
        self._signal(signal.SIGTERM)

    def kill(self) -> None:
        self._signal(signal.SIGKILL)

    def _signal(self, sig: int) -> None:
        try:
            os.kill(self.pid, sig)
        except OSError:
            self.returncode = self.returncode if self.returncode is not None else -1


# --------------------------------------------------------------------------
# template-side (runs inside the zygote process; see worker_main --template)


def template_main(args) -> None:
    """Zygote main loop: preload imports once, then serve fork requests.

    Protocol (newline-delimited, commands on stdin, replies on --reply-fd):
      -> READY <pid>       after preload completes
      FORK ->  OK <pid>    one forked worker (or ERR <msg>)
      PING ->  PONG        liveness probe
      EXIT / stdin EOF     template exits
    The reply channel is a dedicated inherited fd — stdout stays pointed at
    the raylet's console so forked workers print like cold-spawned ones.
    """
    # children are reaped by the kernel; the zygote never waits on them
    signal.signal(signal.SIGCHLD, signal.SIG_IGN)

    preload = list(_DEFAULT_PRELOAD)
    extra = os.environ.get("RAY_TPU_TORCH_WORKER_TEMPLATE_PRELOAD", "")
    preload += [m.strip() for m in extra.split(",") if m.strip()]
    import importlib

    for mod in preload:
        try:
            importlib.import_module(mod)
        except Exception as e:  # a missing optional preload must not kill
            logger.warning("template preload of %s failed: %s", mod, e)
    try:
        _preload_torch()
    except Exception as e:
        logger.warning("template preload of torch failed: %s", e)
    if threading.active_count() > 1:
        # fork() from a multi-threaded process duplicates locks mid-flight;
        # nothing in the default preload starts threads, but a user preload
        # might — warn loudly, the forked children may deadlock.
        logger.warning(
            "worker template is multi-threaded after preload (%d threads); "
            "forked workers may inherit torn state",
            threading.active_count())

    reply = os.fdopen(args.reply_fd, "w", buffering=1)
    reply.write(f"READY {os.getpid()}\n")
    for line in sys.stdin:
        cmd = line.strip()
        if cmd == "FORK":
            try:
                pid = os.fork()
            except OSError as e:
                reply.write(f"ERR fork failed: {e}\n")
                continue
            if pid == 0:
                _forked_child_main(args)  # never returns
            reply.write(f"OK {pid}\n")
        elif cmd == "PING":
            reply.write("PONG\n")
        elif cmd == "EXIT":
            break


def _forked_child_main(args) -> None:
    """Runs in the forked child: shed the template's control channel, then
    become a normal worker. Exits via os._exit so the template's inherited
    interpreter state (atexit hooks from preloaded modules) never runs
    twice."""
    code = 0
    try:
        try:
            os.close(args.reply_fd)
        except OSError:
            pass
        # fd 0 is the template's command pipe: a user task reading stdin
        # must see EOF, not steal FORK commands meant for the template
        try:
            devnull = os.open(os.devnull, os.O_RDONLY)
            os.dup2(devnull, 0)
            os.close(devnull)
        except OSError:
            pass
        # the template ignores SIGCHLD so the kernel auto-reaps its forks;
        # a WORKER must not inherit that — user code running subprocesses
        # would get ECHILD from waitpid and read every exit as rc=0
        signal.signal(signal.SIGCHLD, signal.SIG_DFL)
        import random

        random.seed()  # the template's RNG state is shared by every child
        try:
            import numpy

            # numpy is preloaded in the template: without a reseed every
            # forked worker would draw the SAME 'random' numpy stream
            numpy.random.seed()
        except ImportError:
            pass
        torch = sys.modules.get("torch")
        if torch is not None:
            # the same for torch's CPU generator; the CUDA generators are
            # created per process on the child's first CUDA use
            torch.default_generator.seed()
        os.environ["RAY_TPU_TORCH_WORKER_FORKED"] = "1"
        from ray_tpu_torch.core.worker_main import run_worker

        run_worker(args.raylet, args.gcs, log_level=args.log_level)
    except BaseException:
        import traceback

        traceback.print_exc()
        code = 1
    finally:
        os._exit(code)


# --------------------------------------------------------------------------
# raylet-side


class WorkerTemplate:
    """Raylet-side handle to one zygote process."""

    def __init__(self, argv: List[str], env: Dict[str, str]):
        r, w = os.pipe()
        try:
            self.proc = subprocess.Popen(
                argv + ["--reply-fd", str(w)], env=env,
                stdin=subprocess.PIPE, pass_fds=(w,))
        except BaseException:
            os.close(r)
            raise
        finally:
            os.close(w)
        self._reply_fd = r
        self._buf = b""
        self._io_lock = threading.Lock()
        self._close_lock = threading.Lock()
        self._closed = False

    @property
    def pid(self) -> int:
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc.poll() is None

    def _readline(self, timeout: float) -> str:
        deadline = time.monotonic() + timeout
        while b"\n" not in self._buf:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError("template reply timed out")
            ready, _, _ = select.select([self._reply_fd], [], [],
                                        min(remaining, 0.5))
            if not ready:
                if not self.alive():
                    raise ConnectionError("template process died")
                continue
            chunk = os.read(self._reply_fd, 4096)
            if not chunk:
                raise ConnectionError("template reply channel closed")
            self._buf += chunk
        line, _, self._buf = self._buf.partition(b"\n")
        return line.decode()

    def wait_ready(self, timeout: float) -> None:
        with self._io_lock:
            line = self._readline(timeout)
        if not line.startswith("READY"):
            raise ConnectionError(f"unexpected template greeting: {line!r}")

    def fork(self, timeout: float) -> int:
        """Request one forked worker; returns its pid. Raises on a dead or
        unresponsive template (callers respawn/fall back cold)."""
        with self._io_lock:
            try:
                self.proc.stdin.write(b"FORK\n")
                self.proc.stdin.flush()
            except (OSError, ValueError) as e:
                raise ConnectionError(f"template stdin closed: {e}") from None
            line = self._readline(timeout)
        if line.startswith("OK "):
            return int(line.split()[1])
        raise ConnectionError(f"template fork failed: {line!r}")

    def close(self) -> None:
        # idempotent + thread-safe: stop() and a fork-failure retire thread
        # can both reach here; a second os.close of the (since recycled)
        # reply fd would close an unrelated live descriptor. The flag rides
        # its OWN lock — _io_lock may be held for up to the boot timeout by
        # a reader waiting on a wedged template, and close() must not wait
        # behind it to terminate that very template.
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        # terminate FIRST: a reader blocked in _readline notices the death
        # within its 0.5 s select tick and releases _io_lock
        try:
            self.proc.terminate()
        except OSError:
            pass
        try:
            if self.proc.stdin:
                self.proc.stdin.close()
        except (OSError, ValueError):
            pass
        try:
            self.proc.wait(timeout=2)
        except (OSError, subprocess.TimeoutExpired):
            try:
                self.proc.kill()
            except OSError:
                pass
        with self._io_lock:  # reader gone: the fd is safe to retire
            try:
                os.close(self._reply_fd)
            except OSError:
                pass


@dataclass
class _TemplateSlot:
    """Per-env-key template state (state machine: absent -> booting ->
    ready | failed-with-backoff -> ready ...; cold_only is terminal)."""

    env_key: Optional[str]
    runtime_env: Optional[dict] = None
    handle: Optional[WorkerTemplate] = None
    state: str = "absent"  # absent | booting | ready | failed | cold_only
    backoff: ExponentialBackoff = field(
        default_factory=lambda: ExponentialBackoff(
            base_s=get_config().worker_template_backoff_base_ms / 1000.0,
            cap_s=get_config().worker_template_backoff_cap_ms / 1000.0))
    retry_at: float = 0.0
    last_fork: float = field(default_factory=time.monotonic)
    holds_env_ref: bool = False
    boots: int = 0


class WorkerPool:
    """Per-raylet warm worker pool: owns the templates, the prestart policy
    and the warm/cold accounting; delegates cold spawns back to the raylet's
    original `_spawn_worker` path (which also owns runtime-env creation)."""

    def __init__(self, raylet):
        self._raylet = raylet
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # (env_key, kind) -> [target_demand, runtime_env]; targets are
        # absolute backlog counts (callers re-arm with totals), served by
        # one thread. demand and prestart entries stay SEPARATE per env:
        # their serve-side dedup baselines differ (see _serve)
        self._pending: Dict[Tuple[Optional[str], str], list] = {}
        self._templates: Dict[Optional[str], _TemplateSlot] = {}
        self._shutdown = threading.Event()
        # ---- stats (guarded by _lock) ----
        self.warm_starts = 0        # forks handed to the raylet
        self.cold_starts = 0        # Popen spawns delegated
        self.registered_warm = 0    # forked workers that completed register
        self.registered_cold = 0
        self.template_boots = 0
        self.template_respawns = 0
        self.fork_failures = 0
        self._fork_latencies_ms: deque = deque(maxlen=4096)
        # node-join -> first-warm-lease (the warm-onboarding number): set
        # once, when the FIRST forked worker completes registration
        self.join_to_first_warm_lease_s: Optional[float] = None
        # recent lease traffic per env key (env_key -> [monotonic, renv]);
        # shipped to the GCS in heartbeats so joining nodes prewarm
        self._hot: Dict[Optional[str], list] = {}
        self._thread = threading.Thread(
            target=self._run, name="worker-pool", daemon=True)
        self._thread.start()
        from ray_tpu_torch.util import metrics as _metrics

        self._m_warm = _metrics.get_or_create(
            "counter", "ray_tpu_torch_worker_warm_starts_total",
            "workers started by forking a warm template")
        self._m_cold = _metrics.get_or_create(
            "counter", "ray_tpu_torch_worker_cold_starts_total",
            "workers started by cold Popen spawn")
        self._m_respawn = _metrics.get_or_create(
            "counter", "ray_tpu_torch_worker_template_respawns_total",
            "template crash-respawns")
        self._m_fork_ms = _metrics.get_or_create(
            "histogram", "ray_tpu_torch_worker_fork_latency_ms",
            "FORK request to child-pid reply latency")

    # ------------------------------------------------------------- policy
    def prestart_target(self, backlog: int, env_key: Optional[str]) -> int:
        """Reference prestart policy (~1 per CPU up to the backlog), floored
        by `num_prestart_workers` for the default env."""
        cfg = get_config()
        cpus = int(self._raylet.resources_total.get("CPU", 0)) or (
            os.cpu_count() or 1)
        target = min(max(0, backlog), cpus)
        if env_key is None:
            target = max(target, cfg.num_prestart_workers)
        return target

    def floor(self) -> int:
        """Minimum default-env task-worker population (busy, idle or
        starting) maintained from boot; the reaper's idle-kill also never
        shrinks the idle pool below this."""
        return max(0, get_config().num_prestart_workers)

    # ------------------------------------------------------------ request
    def request(self, env_key: Optional[str], runtime_env: Optional[dict],
                needed: int, kind: str = "demand") -> None:
        """Ask for the env's worker count to reach `needed` (an absolute
        backlog figure). Never blocks: callers hold the raylet lock.

        kind="demand": backed by real queued work. The figure goes stale
        between request and serve (workers register and consume backlog
        in the window), so serve re-reads the live backlog and spawns for
        min(requested, live) — without the re-read a 200-actor burst
        forks ~2x the fleet. kind="prestart": anticipatory (per-submit
        policy, boot floor); deduped against idle AND starting workers.
        """
        if needed <= 0 or self._shutdown.is_set():
            return
        with self._cv:
            # lease-traffic recency per env (warm-onboarding signal)
            hot = self._hot.setdefault(env_key, [0.0, None])
            hot[0] = time.monotonic()
            if runtime_env is not None:
                hot[1] = runtime_env
            entry = self._pending.get((env_key, kind))
            if entry is None:
                self._pending[(env_key, kind)] = [needed, runtime_env]
            else:
                entry[0] = max(entry[0], needed)
                if runtime_env is not None:
                    entry[1] = runtime_env
            self._cv.notify()

    def shed_demand(self) -> int:
        """Job reap: drop every queued spawn figure. The purged backlog may
        have been the demand behind them, and serving a stale figure forks
        workers into a vacuum. Safe for surviving jobs: serve re-reads the
        LIVE backlog before spawning anyway, and every submit/schedule pass
        re-arms its own demand. Returns the number of entries dropped."""
        with self._cv:
            n = len(self._pending)
            self._pending.clear()
        return n

    def prewarm(self, hot_envs) -> None:
        """Warm node onboarding: boot fork templates for the fleet's hot
        runtime-env keys (shipped in the register_node reply) so this
        node's FIRST lease of each hot env is a ~1 ms fork instead of a
        cold multi-second boot. Queued onto the pool serve thread; never
        blocks the caller (the raylet's registration path)."""
        if self._shutdown.is_set():
            return
        for ent in hot_envs or ():
            key = ent.get("env_key")
            with self._cv:
                hot = self._hot.setdefault(key, [0.0, None])
                hot[0] = time.monotonic()
                if ent.get("runtime_env") is not None:
                    hot[1] = ent["runtime_env"]
                if (key, "prewarm") not in self._pending:
                    self._pending[(key, "prewarm")] = \
                        [0, ent.get("runtime_env")]
                self._cv.notify()

    def hot_envs(self, ttl_s: float = 300.0) -> List[Dict]:
        """Env keys with lease traffic in the last `ttl_s` (heartbeat
        payload -> GCS hot-env table -> joiners' prewarm)."""
        now = time.monotonic()
        with self._lock:
            # prune long-cold keys so env churn can't grow the table
            # without bound (heartbeats call this every period)
            for k in [k for k, rec in self._hot.items()
                      if now - rec[0] > max(ttl_s, 3600.0)]:
                del self._hot[k]
            return [{"env_key": k, "runtime_env": rec[1]}
                    for k, rec in self._hot.items()
                    if now - rec[0] <= ttl_s]

    def stats(self) -> Dict:
        with self._lock:
            lat = sorted(self._fork_latencies_ms)
            tmpl = {
                (k if k is not None else ""): {
                    "state": s.state, "boots": s.boots,
                    "pid": s.handle.pid if s.handle else None,
                }
                for k, s in self._templates.items()}
            return {
                "fork_supported": fork_supported(),
                "warm_starts": self.warm_starts,
                "cold_starts": self.cold_starts,
                "registered_warm": self.registered_warm,
                "registered_cold": self.registered_cold,
                "template_boots": self.template_boots,
                "template_respawns": self.template_respawns,
                "fork_failures": self.fork_failures,
                "fork_p50_ms": _pct(lat, 0.50),
                "fork_p99_ms": _pct(lat, 0.99),
                "join_to_first_warm_lease_s": self.join_to_first_warm_lease_s,
                "templates": tmpl,
            }

    def note_registered(self, proc, forked: bool = False) -> None:
        """Raylet callback on worker registration: classify the start. The
        worker's own `forked` payload flag backstops the proc-shim check
        for the adoption race (child registers before the fork reply is
        processed)."""
        warm = forked or bool(getattr(proc, "forked", False))
        first_warm = False
        with self._lock:
            if warm:
                if self.registered_warm == 0 \
                        and self.join_to_first_warm_lease_s is None:
                    joined = getattr(self._raylet, "_joined_at", None)
                    if joined is not None:
                        self.join_to_first_warm_lease_s = round(
                            time.monotonic() - joined, 3)
                        first_warm = True
                self.registered_warm += 1
            else:
                self.registered_cold += 1
        if first_warm:
            # close the node-join -> first-warm-lease measurement at the GCS
            # (off the pool lock; best-effort one-shot)
            try:
                self._raylet.note_first_warm_lease(
                    self.join_to_first_warm_lease_s)
            except Exception:
                logger.debug("first-warm-lease report failed", exc_info=True)

    # ----------------------------------------------------------- lifecycle
    def health_tick(self) -> None:
        """Called from the raylet reaper (~1 Hz): collapse dead templates
        into the failed/backoff state and close idle non-default templates
        (releasing their env ref so runtime-env gc can reclaim the env)."""
        now = time.monotonic()
        cfg = get_config()
        # pass 1, pool lock only: dead templates -> failed; collect idle
        # candidates. NO raylet calls under the pool lock — raylet threads
        # call request() while holding the raylet lock, so a pool-lock ->
        # raylet-lock acquisition here is an ABBA deadlock.
        candidates: List[Tuple[Optional[str], _TemplateSlot]] = []
        with self._lock:
            for key, slot in self._templates.items():
                if slot.state == "ready" and slot.handle is not None \
                        and not slot.handle.alive():
                    logger.warning(
                        "worker template for env %s died (pid %d); backoff "
                        "respawn armed", key or "<default>", slot.handle.pid)
                    self._mark_failed_locked(slot)
                elif (slot.state == "ready" and key is not None
                      and now - slot.last_fork
                      > cfg.worker_template_idle_s):
                    candidates.append((key, slot))
        # pass 2, no pool lock: consult the raylet; pass 3 re-checks the
        # slot under the pool lock before retiring it (a fork may have
        # raced in between)
        idle_keys = [k for k, _ in candidates
                     if not self._raylet._has_workers_for(k)]
        to_close: List[Tuple[_TemplateSlot, WorkerTemplate]] = []
        with self._lock:
            for key, slot in candidates:
                if key in idle_keys and slot.state == "ready" \
                        and slot.handle is not None \
                        and now - slot.last_fork > cfg.worker_template_idle_s:
                    to_close.append((slot, slot.handle))
                    slot.handle = None
                    slot.state = "absent"
        for slot, handle in to_close:
            logger.info("closing idle worker template for env %s",
                        slot.env_key)
            handle.close()
            self._release_env_ref(slot)
        # prestart floor maintenance for the default env (boot + after
        # idle-kill sweeps): keep >= floor workers idle or starting. The
        # request carries (floor - idle) so the serve-side dedup against
        # in-flight starts lands the total exactly at the floor.
        fl = self.floor()
        if fl > 0 and not self._shutdown.is_set():
            if self._raylet._idle_count(None) < fl:
                self.request(None, None, fl, kind="prestart")

    def stop(self) -> None:
        self._shutdown.set()
        with self._cv:
            self._pending.clear()
            slots = list(self._templates.values())
            self._templates.clear()
            self._cv.notify_all()
        for slot in slots:
            if slot.handle is not None:
                slot.handle.close()
            self._release_env_ref(slot)

    def reset_for_fence(self) -> None:
        """Node fencing (partition failure domain): SIGKILL every template
        — their forked children and any state they'd hand out belong to a
        node identity that was declared dead — but keep the pool SERVING:
        the fenced raylet rejoins as a fresh node and must boot templates
        again on demand/prewarm. Unlike kill_all this does NOT shut the
        pool down."""
        with self._cv:
            self._pending.clear()
            slots = list(self._templates.values())
            self._templates.clear()
            self._cv.notify_all()
        for slot in slots:
            handle = slot.handle
            if handle is not None:
                try:
                    handle.proc.kill()
                except OSError:
                    pass
            self._release_env_ref(slot)
        with self._lock:
            # the fresh identity re-measures its own onboarding
            self.join_to_first_warm_lease_s = None

    def kill_all(self) -> None:
        """Whole-node crash simulation: SIGKILL every template outright —
        no EXIT handshake, no graceful close — the way templates die when
        their node dies (chaos harness; see Raylet.crash)."""
        self._shutdown.set()
        with self._cv:
            self._pending.clear()
            slots = list(self._templates.values())
            self._templates.clear()
            self._cv.notify_all()
        for slot in slots:
            handle = slot.handle
            if handle is not None:
                try:
                    handle.proc.kill()
                except OSError:
                    pass

    # ------------------------------------------------------------ internals
    def _release_env_ref(self, slot: _TemplateSlot) -> None:
        # check-and-clear under the pool lock: stop() and a failure-retire
        # thread racing here must release the env ref exactly once
        with self._lock:
            release = slot.holds_env_ref
            slot.holds_env_ref = False
        if release and slot.env_key is not None:
            try:
                self._raylet._env_manager.release(slot.env_key)
            except Exception:
                logger.exception("template env release failed")

    def _mark_failed_locked(self, slot: _TemplateSlot) -> None:
        handle, slot.handle = slot.handle, None
        slot.state = "failed"
        slot.retry_at = time.monotonic() + slot.backoff.next_delay()
        # close + env-ref release off-thread: both do IO (process wait,
        # flock'd refcount file) the pool lock must not be held across.
        # Releasing at failure matters: a failed slot with no further
        # demand is never revisited, and a kept ref would block runtime-env
        # gc of the (possibly huge) env dir for the raylet's lifetime — a
        # respawn re-acquires in _boot_template, and live workers hold
        # their own refs meanwhile.
        release = slot.holds_env_ref
        slot.holds_env_ref = False

        def retire():
            if handle is not None:
                handle.close()
            if release and slot.env_key is not None:
                try:
                    self._raylet._env_manager.release(slot.env_key)
                except Exception:
                    logger.exception("template env release failed")

        threading.Thread(target=retire, daemon=True,
                         name="template-close").start()

    def _run(self) -> None:
        while not self._shutdown.is_set():
            with self._cv:
                while not self._pending and not self._shutdown.is_set():
                    self._cv.wait(timeout=1.0)
                if self._shutdown.is_set():
                    return
                (env_key, kind), (target, runtime_env) = next(
                    iter(self._pending.items()))
                del self._pending[(env_key, kind)]
            try:
                self._serve(env_key, runtime_env, target, kind)
            except Exception:
                logger.exception("worker pool serve failed for env %s",
                                 env_key)

    def _serve(self, env_key: Optional[str], runtime_env: Optional[dict],
               target: int, kind: str = "demand") -> None:
        raylet = self._raylet
        if self._shutdown.is_set() or raylet._shutdown.is_set():
            return
        cfg0 = get_config()
        if kind == "prewarm":
            # onboarding: make the TEMPLATE ready, fork nothing — the first
            # real lease pays ~1 ms instead of a cold boot
            if not cfg0.worker_template_enabled or not fork_supported():
                return
            if env_key is not None:
                if raylet._env_manager.creation_error(env_key) is not None \
                        or not self._env_ready(env_key):
                    return  # env not built on this node: cold path owns it
            slot = self._slot(env_key, runtime_env)
            if slot.state != "absent":
                return
            if env_key is None:
                self._boot_template(slot)
            else:
                # non-default zygotes boot off-thread, same as _serve's
                # demand path: a slow venv boot must not block other envs
                slot.state = "booting"
                threading.Thread(
                    target=self._boot_template, args=(slot,),
                    name="template-prewarm", daemon=True).start()
            return
        if kind == "demand":
            # clamp the (possibly stale) figure to the LIVE backlog before
            # deduping against in-flight starts and idle workers (an idle
            # worker serves a queued task without any spawn)
            target = min(target, raylet._live_demand(env_key))
            deficit = target - raylet._spawn_inflight(env_key) \
                - raylet._idle_count(env_key)
        else:
            # prestart: anticipatory — clamped to the env's OWN live
            # backlog (the per-submit hook passes the global queue depth,
            # which would overspawn for a lightly-loaded env sharing the
            # node), floored for the default env, and deduped against
            # every task-capable worker of the env (busy ones hold their
            # CPU; replacing them with fresh idlers would fork without
            # bound) plus in-flight starts. Dedicated actor workers don't
            # count: they never return to the pool.
            target = min(target, raylet._live_demand(env_key))
            if env_key is None:
                target = max(target, self.floor())
            deficit = target - raylet._task_worker_count(env_key) \
                - raylet._spawn_inflight(env_key)
        if deficit <= 0:
            return
        cfg = get_config()
        if not cfg.worker_template_enabled or not fork_supported():
            self._cold(env_key, runtime_env, deficit)
            return
        if env_key is not None:
            # a not-yet-built env goes through the cold path's creator
            # thread (pip installs can take minutes; this thread must stay
            # responsive for every other env's forks). Once built, later
            # leases come back here and boot the template.
            if raylet._env_manager.creation_error(env_key) is not None:
                return
            if not self._env_ready(env_key):
                self._cold(env_key, runtime_env, deficit)
                return
        slot = self._slot(env_key, runtime_env)
        if slot.state == "cold_only":
            self._cold(env_key, runtime_env, deficit)
            return
        if slot.state == "failed":
            if time.monotonic() < slot.retry_at:
                self._cold(env_key, runtime_env, deficit)
                return
            slot.state = "absent"  # backoff elapsed: try a respawn
        if slot.state == "booting":
            # an async (non-default-env) boot is in flight on its own
            # thread; this round goes cold rather than waiting on it
            self._cold(env_key, runtime_env, deficit)
            return
        if slot.state == "absent":
            if env_key is not None:
                # non-default envs boot OFF the serve thread: a slow pip-env
                # zygote (venv python, cold page cache) must not head-of-
                # line-block every other env's forks for up to the 60 s
                # boot budget. This round is served cold; the next request
                # finds the template ready.
                slot.state = "booting"
                threading.Thread(
                    target=self._boot_template, args=(slot,),
                    name="template-boot", daemon=True).start()
                self._cold(env_key, runtime_env, deficit)
                return
            # The DEFAULT env boots synchronously on purpose: its zygote is
            # plain sys.executable importing in-tree modules (~0.3 s), it
            # is the first thing a fresh cluster needs, and serving the
            # wait-long burst cold would eat the startup-concurrency
            # budget the template exists to retire. Worst case is bounded
            # by worker_template_boot_timeout_s, after which the failed
            # state routes everything cold.
            if not self._boot_template(slot):
                self._cold(env_key, runtime_env, deficit)
                return
        # ready: serve the deficit with forks
        forked = 0
        for _ in range(deficit):
            with self._lock:
                handle = slot.handle  # health_tick may retire it concurrently
            if handle is None:
                # health_tick idle-retired a HEALTHY template between our
                # state check and this fork: that's not a failure — re-queue
                # the remaining work so the next serve round re-boots it
                self.request(env_key, runtime_env, target, kind)
                return
            t0 = time.monotonic()
            try:
                pid = handle.fork(cfg.worker_template_fork_timeout_s)
            except (ConnectionError, TimeoutError, ValueError, OSError) as e:
                logger.warning(
                    "fork from template for env %s failed (%s); cold "
                    "fallback under backoff", env_key or "<default>", e)
                with self._lock:
                    self.fork_failures += 1
                    self._mark_failed_locked(slot)
                # serve the REST of this round's deficit cold: the original
                # figure already carried the idle/task-worker dedup, so the
                # shortfall is exactly what the forks didn't cover
                remaining = deficit - forked
                if remaining > 0:
                    self._cold(env_key, runtime_env, remaining)
                return
            forked += 1
            dt_ms = (time.monotonic() - t0) * 1000.0
            slot.last_fork = time.monotonic()
            raylet._adopt_forked(pid, env_key)
            with self._lock:
                self.warm_starts += 1
                self._fork_latencies_ms.append(dt_ms)
            self._m_warm.inc()
            self._m_fork_ms.observe(dt_ms)

    def _slot(self, env_key: Optional[str],
              runtime_env: Optional[dict]) -> _TemplateSlot:
        with self._lock:
            slot = self._templates.get(env_key)
            if slot is None:
                slot = _TemplateSlot(env_key=env_key, runtime_env=runtime_env)
                self._templates[env_key] = slot
            if runtime_env is not None:
                slot.runtime_env = runtime_env
            return slot

    def _env_ready(self, env_key: str) -> bool:
        base = self._raylet._env_manager.base_dir
        return os.path.exists(os.path.join(base, env_key, ".ready"))

    def _boot_template(self, slot: _TemplateSlot) -> bool:
        """Spawn + await one zygote (blocking; runs on the pool thread)."""
        raylet = self._raylet
        cfg = get_config()
        try:
            python = sys.executable
            ctx_env_vars: Dict[str, str] = {}
            if slot.env_key is not None:
                ctx = raylet._env_manager.context_for(slot.runtime_env or {})
                if ctx.command_prefix:
                    # container envs wrap the worker argv in an engine CLI:
                    # a host-side fork can't cross that boundary
                    slot.state = "cold_only"
                    return False
                python = ctx.python
                ctx_env_vars = dict(ctx.env_vars)
                if not slot.holds_env_ref:
                    raylet._env_manager.acquire(slot.env_key)
                    slot.holds_env_ref = True
            env = raylet._build_worker_env(slot.env_key)
            env.update(ctx_env_vars)
            argv = [python, "-m", "ray_tpu_torch.core.worker_main", "--template",
                    "--raylet", raylet.address, "--gcs", raylet.gcs_address,
                    "--node-id", raylet.node_id.hex()]
            slot.state = "booting"
            respawn = slot.boots > 0
            handle = WorkerTemplate(argv, env)
            # visible on the slot immediately so a failed boot (timeout,
            # crash) is closed by _mark_failed_locked, never leaked
            slot.handle = handle
            handle.wait_ready(cfg.worker_template_boot_timeout_s)
            slot.state = "ready"
            # a stale pre-close stamp would let health_tick idle-retire a
            # just-booted template before it serves its first fork
            slot.last_fork = time.monotonic()
            slot.backoff.reset()
            slot.boots += 1
            with self._lock:
                self.template_boots += 1
                if respawn:
                    self.template_respawns += 1
            if respawn:
                self._m_respawn.inc()
            logger.info("worker template for env %s ready (pid %d)",
                        slot.env_key or "<default>", handle.pid)
            return True
        except Exception as e:
            logger.warning(
                "worker template boot for env %s failed (%s); cold fallback "
                "under backoff", slot.env_key or "<default>", e)
            with self._lock:
                self._mark_failed_locked(slot)
            return False

    def _cold(self, env_key: Optional[str], runtime_env: Optional[dict],
              deficit: int) -> None:
        """Cold Popen fallback, bounded by the classic startup-concurrency
        budget (multi-second boots must not all serialize at once)."""
        raylet = self._raylet
        if self._shutdown.is_set() or raylet._shutdown.is_set():
            return
        budget = get_config().maximum_startup_concurrency \
            - raylet._starting_count()
        n = max(0, min(deficit, budget))
        if n <= 0:
            return
        # count only spawns that actually happened: for a still-creating
        # venv env every call but the first is suppressed, and counting
        # them would inflate cold_starts (skewing warm_start_fraction)
        spawned = sum(1 for _ in range(n)
                      if raylet._spawn_worker(env_key, runtime_env))
        if spawned:
            with self._lock:
                self.cold_starts += spawned
            self._m_cold.inc(spawned)


def _pct(sorted_vals, q: float) -> Optional[float]:
    from ray_tpu_torch.util.stats import percentile

    v = percentile(sorted_vals, q)
    return None if v is None else round(v, 3)
