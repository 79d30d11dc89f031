"""Serve: model serving on actors.

Mirrors the reference's anatomy (SURVEY §3.5): a detached ServeController
actor (`python/ray/serve/controller.py:73`) reconciles per-deployment target
replica counts into replica actors (`_private/deployment_state.py:1009`);
handles route requests with power-of-two-choices over client-tracked
in-flight counts (`_private/router.py:263,224`); replicas report queue
lengths and a queue-based policy autoscales within [min,max]
(`_private/autoscaling_policy.py:127`); config updates reach handles via
versioned long-polls (`_private/long_poll.py`). The HTTP ingress is a
proxy actor running a stdlib threading HTTP server (the reference uses
uvicorn/Starlette — an external dep this build avoids).

GPU twist: a deployment pins each replica to a card through
`ray_actor_options={"num_gpus": 1}` (or `{"resources": {"GPU": n}}`); the
runtime makes the grant's card the replica's current CUDA device. Model
weights travel to replicas inside the deployment's pickled definition, as
host tensors: a replica puts them on its own card (a CUDA tensor would
unpickle onto the driver's device index, not the replica's grant).
"""

from __future__ import annotations

import heapq
import json
import logging
import random
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.core import rpc as _rpc
from ray_tpu_torch.core.exceptions import (ActorDiedError,
                                           BackPressureError,
                                           ObjectLostError,
                                           RequestTimeoutError,
                                           WorkerCrashedError)
from ray_tpu_torch.util import tracing

logger = logging.getLogger(__name__)

CONTROLLER_NAME = "_serve_controller"
SERVE_VERSIONS_CHANNEL = "serve_replica_versions"
PROXY_NAME = "_serve_http_proxy"
GRPC_PROXY_NAME = "_serve_grpc_proxy"

# The named fault-injection point at the router->replica call boundary
# (rpc.fault_point): chaos rules like `sever:serve_replica_call:0.02`
# sever/drop/delay individual replica submissions without touching the
# rest of the worker's links, driving the failover path deterministically.
REPLICA_CALL_FAULT_POINT = "serve_replica_call"


def _serve_cfg():
    """Serve runtime knobs; imported lazily (serve.config imports this
    module for the declarative-deploy half)."""
    from ray_tpu_torch.serve.config import get_serve_config

    return get_serve_config()


# Process-local router outcome counters (storm harness + tests read these
# without a metrics scrape; the tagged metrics below feed dashboards).
_router_stats_lock = threading.Lock()
_router_stats: Dict[str, int] = {
    "retries": 0, "failovers": 0, "shed": 0, "timeouts": 0}


def _bump_router_stat(key: str, n: int = 1) -> None:
    with _router_stats_lock:
        _router_stats[key] = _router_stats.get(key, 0) + n


def router_stats() -> Dict[str, int]:
    """Snapshot of this process's router outcome counters: `retries`
    (re-routed attempts), `failovers` (requests that succeeded only after
    a retry), `shed` (admission-control rejections), `timeouts` (promises
    failed by the deadline reaper), `client_cancels` (in-flight replica
    attempts cancelled because the client disconnected)."""
    with _router_stats_lock:
        return dict(_router_stats)


def reset_router_stats() -> None:
    with _router_stats_lock:
        for k in _router_stats:
            _router_stats[k] = 0


_router_pool_lock = threading.Lock()
_router_pool_inst = None


def _router_pool():
    """Small shared executor for router work that must not run on the RPC
    reader thread: failover resubmissions (socket sends + backoff sleeps)
    and plasma-sized result relays (a blocking pull)."""
    global _router_pool_inst
    with _router_pool_lock:
        if _router_pool_inst is None:
            from concurrent.futures import ThreadPoolExecutor

            _router_pool_inst = ThreadPoolExecutor(
                max_workers=8, thread_name_prefix="serve-router")
        return _router_pool_inst


class _DeadlineReaper:
    """Shared wall-clock timer for the router. Two entry kinds: `watch`
    entries resolve still-pending router promises with a typed
    RequestTimeoutError at their deadline — the guarantee that no serve
    request outlives its deadline even when every other signal (replica
    death notice, result push) is lost — and `schedule` entries run a
    (cheap) callable at a time, which failover uses for its backoff waits
    so no router-pool thread ever sleeps. One heap + one lazy thread per
    process."""

    def __init__(self):
        self._cv = threading.Condition()
        self._heap: List[tuple] = []
        self._seq = 0
        self._thread: Optional[threading.Thread] = None

    def watch(self, deadline_ts: float, promise, name: str,
              timeout_s: float) -> None:
        # store the bare ObjectID, NOT the ObjectRef: holding the ref would
        # pin every promise (and its inline result blob) in the worker's
        # object table for the full timeout after the request completed —
        # memory scaling with rps x timeout x response size. With only the
        # id, a completed-and-dropped promise is freed normally and the
        # expire entry finds nothing to do.
        self._push(deadline_ts, ("expire", promise.id, name, timeout_s))

    def schedule(self, when_ts: float, fn: Callable[[], None]) -> None:
        """Run `fn` at wall-clock `when_ts` on the timer thread — `fn`
        must be cheap/non-blocking (hand real work to the router pool)."""
        self._push(when_ts, ("call", fn))

    def _push(self, ts: float, entry: tuple) -> None:
        with self._cv:
            self._seq += 1
            # the unique seq means heapq never compares the entry payload
            heapq.heappush(self._heap, (ts, self._seq, entry))
            t = self._thread
            if t is None or not t.is_alive():
                t = threading.Thread(target=self._loop,
                                     name="serve-deadline-reaper", daemon=True)
                self._thread = t
                t.start()
            self._cv.notify_all()

    def _loop(self) -> None:
        from ray_tpu_torch.core.api import _global_worker

        while True:
            with self._cv:
                if not self._heap:
                    self._cv.wait(timeout=1.0)
                    if not self._heap:
                        # exit decision under the cv (watch() holds it while
                        # pushing + checking liveness) so no entry strands
                        self._thread = None
                        return
                due = self._heap[0][0]
                wait = due - time.time()
                if wait > 0:
                    self._cv.wait(timeout=min(wait, 1.0))
                    continue
                _, _, entry = heapq.heappop(self._heap)
            try:
                if entry[0] == "call":
                    entry[1]()
                    continue
                _, oid, name, timeout_s = entry
                from ray_tpu_torch.core.object_ref import ObjectRef

                # ad-hoc ref (never _counted): carries the id for the
                # table lookup without touching the distributed refcount
                promise = ObjectRef(oid)
                w = _global_worker()
                state, _ = w.peek_local(promise)
                timed_out = state == "pending" and w.fulfill_promise(
                    promise, error=RequestTimeoutError(
                        f"request to {name} exceeded its "
                        f"{timeout_s:.1f}s deadline"))
                if timed_out:
                    _bump_router_stat("timeouts")
                    _serve_metrics()["timeouts"].inc(
                        tags={"deployment": name})
                # registry cleanup ALWAYS happens here (bounded lifetime:
                # one expire entry per request); on a real timeout also
                # CANCEL the in-flight replica attempt through the
                # runtime's task cancellation — nobody will read the
                # result, so the replica should stop computing it
                with _inflight_lock:
                    req = _inflight_requests.pop(oid, None)
                if timed_out and req is not None \
                        and req.current_ref is not None:
                    try:
                        w.cancel(req.current_ref)
                    except Exception:
                        logger.debug("post-deadline replica cancel failed",
                                     exc_info=True)
            except Exception:
                logger.exception("deadline reaper entry failed")


_deadline_reaper = _DeadlineReaper()

# promise.id -> live _RouterRequest: lets the deadline reaper and the HTTP
# edge's disconnect path CANCEL the replica attempt behind an abandoned
# request (rides the runtime's real task cancellation). Entries are popped
# at fulfillment, at cancel, or — worst case — by the request's own
# deadline-reaper expire entry, so the registry lifetime is bounded by the
# request timeout.
_inflight_requests: Dict[bytes, "_RouterRequest"] = {}
_inflight_lock = threading.Lock()


def cancel_inflight(promise_ref) -> bool:
    """Best-effort cancellation of the replica attempt behind a router
    promise (client disconnected / caller abandoned the request): the
    in-flight `handle_request` task is cancelled through `ray_tpu_torch.cancel`
    — cooperative interruption on the replica — and the promise resolves
    to the typed TaskCancelledError so any residual waiter unblocks.
    Returns False when the request already completed."""
    from ray_tpu_torch.core.api import _global_worker
    from ray_tpu_torch.core.exceptions import TaskCancelledError

    with _inflight_lock:
        req = _inflight_requests.pop(promise_ref.id, None)
    if req is None:
        return False
    w = _global_worker()
    cancelled = w.fulfill_promise(
        req.promise, error=TaskCancelledError(
            "serve request cancelled (client disconnected)"))
    if req.current_ref is not None:
        try:
            w.cancel(req.current_ref)
        except Exception:
            logger.debug("inflight replica cancel failed", exc_info=True)
    if cancelled:
        _bump_router_stat("client_cancels")
    return cancelled

# errors that mean "this replica (or the link to it) died mid-request" —
# the request itself is intact and an idempotent one may be re-routed
# (ConnectionError covers rpc.RpcDisconnected, e.g. a severed submission)
_RETRYABLE_ERRORS = (ActorDiedError, WorkerCrashedError, ObjectLostError,
                     ConnectionError)


@dataclass
class AutoscalingConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    target_num_ongoing_requests_per_replica: float = 2.0
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 5.0


def _cfg_eq(a, b) -> bool:
    """Structural equality robust to ndarray-bearing configs (== on those
    raises) and to handle-bearing init args: compare pickled bytes, treat
    any serialization asymmetry as 'changed' (the safe direction — it
    falls back to a full rolling update)."""
    if a is b:
        return True
    try:
        return cloudpickle.dumps(a) == cloudpickle.dumps(b)
    except Exception:  # arbitrary user objects: any pickling error = not equal
        return False


def _replica_key(r) -> bytes:
    """Stable identity for a replica handle: the ACTOR id, not id(handle) —
    handle objects are recreated (and their id() reused by the allocator),
    and controller-local maps die with the controller."""
    aid = getattr(r, "_actor_id", None) or getattr(r, "actor_id", None)
    return aid.binary() if hasattr(aid, "binary") else bytes(str(aid), "utf8")


@ray_tpu_torch.remote
class _ReplicaActor:
    def __init__(self, def_blob: bytes, init_args, init_kwargs,
                 def_version: int = 0, user_config: Any = None):
        # deploy spans (timeline()): the replica's share of a deploy; the
        # blob's get is the worker's task::get_arg before this runs
        with tracing.span("serve::replica_unpickle", "serve",
                          bytes=len(def_blob)):
            target = cloudpickle.loads(def_blob)
        with tracing.span("serve::replica_construct", "serve"):
            if isinstance(target, type):
                self._callable = target(*init_args, **(init_kwargs or {}))
            else:
                self._callable = target
        if user_config is not None:
            self.reconfigure(user_config)
        self._inflight = 0
        # The deployment-definition version this replica was built from
        # lives ON the replica: a restarted controller recovers it by
        # asking, instead of defaulting every pre-restart replica to
        # "current" and silently skipping their rollout (reference keeps
        # the version in DeploymentReplica state, deployment_state.py).
        self._def_version = def_version
        # Replica lifecycle hook: deployments that run background machinery
        # (e.g. LLMDeployment's engine driver thread) start it here, once
        # the instance is fully constructed/reconfigured. A raising hook
        # fails replica construction — the controller retries elsewhere.
        start = getattr(self._callable, "__serve_start__", None)
        if callable(start):
            start()

    def def_version(self) -> int:
        return self._def_version

    def prepare_stop(self) -> bool:
        """Graceful-stop lifecycle hook (`__serve_stop__`), invoked
        best-effort by the controller before a kill. Hard kills (crashes,
        chaos) skip it — hooks must not be load-bearing for correctness."""
        stop = getattr(self._callable, "__serve_stop__", None)
        if callable(stop):
            stop()
        return True

    def reconfigure(self, user_config) -> bool:
        """Apply a new user_config in place (reference replica
        reconfigure): class deployments implement reconfigure(cfg)."""
        fn = getattr(self._callable, "reconfigure", None)
        if fn is None:
            raise ValueError(
                "deployment got user_config but defines no reconfigure()")
        fn(user_config)
        return True

    def handle_request(self, method_name: str, args, kwargs,
                       deadline_ts: Optional[float] = None):
        # Remaining-time check BEFORE dispatch: a request whose end-to-end
        # deadline expired while queued on this replica is dropped with the
        # typed error instead of occupying an execution slot — under
        # overload the slots go to requests that can still meet their
        # deadline (reference request_timeout_s semantics).
        if deadline_ts is not None and time.time() >= deadline_ts:
            raise RequestTimeoutError(
                f"request expired in replica queue (deadline exceeded by "
                f"{time.time() - deadline_ts:.3f}s before dispatch)")
        from ray_tpu_torch.serve import batching as _batching

        self._inflight += 1
        prev = _batching.push_request_deadline(deadline_ts)
        try:
            # function deployments and class __call__ both route through the
            # callable itself; named methods are looked up on the instance
            fn = (self._callable if method_name == "__call__"
                  else getattr(self._callable, method_name))
            return fn(*args, **(kwargs or {}))
        finally:
            _batching.pop_request_deadline(prev)
            self._inflight -= 1

    def health(self) -> bool:
        return True


@ray_tpu_torch.remote
class ServeController:
    """Reconciles deployment target state into replica actors."""

    _KV_KEY = "controller_state"

    def __init__(self):
        self._deployments: Dict[str, dict] = {}
        self._replicas: Dict[str, List[Any]] = {}
        self._replica_def_version: Dict[bytes, int] = {}  # actor id -> def ver
        self._version_queries: Dict[bytes, Any] = {}  # in-flight def_version asks
        self._versions: Dict[str, int] = {}
        self._version_cv = threading.Condition()
        self._probes: Dict[str, dict] = {}  # deployment -> {replica: ref}
        self._shutdown = False
        import uuid

        # distinguishes controller incarnations: a handle comparing versions
        # across a controller restart (or a torn-down-and-rebooted cluster)
        # must not mistake a coincidentally-equal version for "no change"
        self._incarnation = uuid.uuid4().hex
        self._restoring = True
        try:
            self._restore_state()
        finally:
            self._restoring = False
        self._thread = threading.Thread(target=self._reconcile_loop, daemon=True)
        self._thread.start()

    # -------------------------------------------------------- fault tolerance
    def _checkpoint(self) -> None:
        """Persist deployment specs + live replica actor ids to the GCS KV
        (reference serve checkpoints its state the same way,
        serve/_private/storage/kv_store.py): a crashed controller's
        replacement re-adopts running replicas instead of orphaning them."""
        state = {
            "deployments": {
                name: {k: d[k] for k in (
                    "def_blob", "init_args", "init_kwargs", "target",
                    "actor_options", "autoscaling", "max_concurrency",
                    "def_version", "app_ingress", "user_config") if k in d}
                for name, d in self._deployments.items()},
            "replicas": {name: [r.actor_id for r in rs]
                         for name, rs in self._replicas.items()},
        }
        try:
            from ray_tpu_torch.core.api import _global_worker

            with tracing.span("serve::checkpoint_pickle", "serve"):
                value = cloudpickle.dumps(state)
            with tracing.span("serve::checkpoint_kv_put", "serve",
                              bytes=len(value)):
                _global_worker().gcs.call("kv_put", {
                    "namespace": "serve", "key": self._KV_KEY,
                    "value": value}, timeout=5)
        except Exception:
            logger.debug("serve controller checkpoint failed", exc_info=True)

    def _restore_state(self) -> None:
        """Fresh controller: re-adopt the previous incarnation's deployments
        and still-alive replicas from the KV checkpoint. Replica definition
        versions are NOT in the checkpoint — they are recovered from the
        replicas themselves (_replica_version), so a redeploy right after a
        controller crash still rolls pre-crash replicas."""
        from ray_tpu_torch.core.actor import ActorHandle
        from ray_tpu_torch.core.api import _global_worker

        from ray_tpu_torch.util.backoff import ExponentialBackoff

        # Retry the checkpoint read across a control-plane outage: a
        # controller restarting DURING a head replacement would otherwise
        # cold-start and silently orphan every running replica. Bounded —
        # a checkpoint that truly doesn't exist still cold-starts fast.
        backoff = ExponentialBackoff(base_s=0.2, cap_s=2.0)
        blob = None
        for attempt in range(4):
            try:
                blob = _global_worker().gcs.call(
                    "kv_get", {"namespace": "serve", "key": self._KV_KEY},
                    timeout=5)
                break
            except (OSError, RuntimeError, TimeoutError):  # GCS unreachable
                if attempt == 3:
                    logger.warning(
                        "serve controller checkpoint unreadable (GCS down?); "
                        "cold-starting without re-adoption")
                    return
                backoff.sleep()
        if not blob:
            return
        try:
            state = cloudpickle.loads(blob)
        except Exception:
            logger.exception("corrupt serve controller checkpoint; ignoring")
            return
        for name, d in state.get("deployments", {}).items():
            self._deployments[name] = {
                **d, "last_scale_up": 0.0, "last_scale_down": 0.0,
                "_draining": []}
        for name, aids in state.get("replicas", {}).items():
            live = []
            for aid in aids:
                try:
                    info = _global_worker().get_actor_info(actor_id=aid)
                    if info and info.get("state") == "ALIVE":
                        live.append(ActorHandle(aid, "_ReplicaActor"))
                except (OSError, RuntimeError, TimeoutError, KeyError,
                        ValueError) as e:
                    logger.debug("replica %s liveness probe failed: %s",
                                 aid, e)
            if live:
                self._replicas[name] = live
        for name in self._deployments:
            self._bump_version(name)
        if self._deployments:
            logger.info("serve controller restored %d deployment(s), "
                        "re-adopted %d replica(s) from checkpoint",
                        len(self._deployments),
                        sum(len(v) for v in self._replicas.values()))

    def _bump_version(self, name: str) -> None:
        with self._version_cv:
            v = self._versions[name] = self._versions.get(name, 0) + 1
            self._version_cv.notify_all()
        # version bumps mark every deployment/replica-set change: checkpoint
        # here so the KV state trails live state by at most one change
        if not getattr(self, "_restoring", False):
            self._checkpoint()
        # Push the bump to handles over GCS pubsub: handles fetch the new
        # replica set with a NON-blocking get_replicas, so no controller
        # exec thread is ever parked on a handle's long-poll (reference
        # LongPollHost is async for the same reason, long_poll.py:186).
        try:
            from ray_tpu_torch.core.api import _global_worker

            _global_worker().publish(SERVE_VERSIONS_CHANNEL,
                                     {"name": name, "version": v})
        except (OSError, RuntimeError):
            logger.debug("version push for %s lost", name, exc_info=True)
            # handles fall back to their periodic poll

    # -------------------------------------------------------------- deploy
    def deploy(self, name: str, def_blob: bytes, init_args, init_kwargs,
               num_replicas: int, actor_options: Optional[dict],
               autoscaling: Optional[AutoscalingConfig], max_concurrency: int,
               app_ingress: bool = False, user_config: Any = None):
        existing = self._deployments.get(name)
        if (existing is not None
                and not _cfg_eq(existing.get("user_config"), user_config)
                and existing["def_blob"] == def_blob
                and _cfg_eq(existing["init_args"], init_args)
                and _cfg_eq(existing["init_kwargs"], init_kwargs)
                and _cfg_eq(existing["actor_options"],
                            dict(actor_options or {}))
                and _cfg_eq(existing["autoscaling"], autoscaling)
                and existing["max_concurrency"] == max_concurrency
                and existing.get("app_ingress", False) == bool(app_ingress)):
            # user_config-only redeploy: push reconfigure() into live
            # replicas in place — no version bump, no rolling restart
            # (reference lightweight-update path, deployment_state.py).
            # The in-flight rolling candidate (if any) must get the new
            # config too — it may be promoted to serving next.
            targets = list(self._replicas.get(name, []))
            if existing.get("_rolling") is not None:
                targets.append(existing["_rolling"][0])
            try:
                ray_tpu_torch.get([r.reconfigure.remote(user_config)
                                   for r in targets], timeout=30)
            except Exception as e:
                # a replica rejected the config (no reconfigure(), or it
                # raised): fall through to a ROLLING redeploy so state
                # and reality re-converge instead of silently diverging
                logger.warning(
                    "in-place reconfigure of %s failed (%s); falling back "
                    "to rolling update", name, e)
            else:
                existing["user_config"] = user_config
                existing["target"] = (num_replicas if autoscaling is None
                                      else autoscaling.min_replicas)
                self._reconcile_one(name)
                return True
        # Redeploy = ROLLING update (reference DeploymentState version
        # rollout): old replicas keep serving; the reconcile loop replaces
        # them one at a time with health-checked new-definition replicas.
        def_version = (existing.get("def_version", 0) + 1) if existing else 0
        carried_draining = []
        if existing is not None:
            # a redeploy mid-rollout must not orphan the in-flight replica
            # (not serving yet — safe to kill) or the draining ones
            if existing.get("_rolling") is not None:
                self._kill_replica(name, existing["_rolling"][0])
            carried_draining = existing.get("_draining", [])
        self._deployments[name] = {
            "def_blob": def_blob,
            "init_args": init_args,
            "init_kwargs": init_kwargs,
            "target": num_replicas if autoscaling is None else autoscaling.min_replicas,
            "actor_options": dict(actor_options or {}),
            "autoscaling": autoscaling,
            "max_concurrency": max_concurrency,
            "app_ingress": bool(app_ingress),
            "user_config": user_config,
            "last_scale_up": 0.0,
            "last_scale_down": 0.0,
            "def_version": def_version,
            "_draining": carried_draining,
        }
        self._reconcile_one(name)
        return True

    def reconfigure_deployment(self, name: str, user_config: Any) -> bool:
        """Lightweight update: push a new user_config into every live
        replica (and the in-flight rolling candidate) IN PLACE — no def_blob
        re-ship, no version bump, no rolling restart.  This is the weight
        broadcast path the RL fleet rides: the learner publishes
        {weights, epoch} here and each replica's reconfigure() applies (or
        epoch-fences) it.  Unlike the deploy() fallback, a replica failure
        here does NOT trigger a rolling redeploy — the caller owns retry
        policy — but the accepted config is recorded so reconcile hands it
        to any replacement replicas it starts later.
        """
        existing = self._deployments.get(name)
        if existing is None:
            raise KeyError(f"no deployment named {name!r}")
        targets = list(self._replicas.get(name, []))
        if existing.get("_rolling") is not None:
            targets.append(existing["_rolling"][0])
        # Record first: a replica that dies mid-push gets replaced by the
        # reconcile loop, and the replacement must init with the NEW config
        # (otherwise a crash window could resurrect fenced-out weights).
        existing["user_config"] = user_config
        self._checkpoint()
        errors = 0
        for r in targets:
            try:
                ray_tpu_torch.get(r.reconfigure.remote(user_config),
                                  timeout=30)
            except Exception:
                errors += 1
                logger.warning("reconfigure push to a %s replica lost "
                               "(replica will pick config up on replace)",
                               name, exc_info=True)
        return errors == 0

    def delete_deployment(self, name: str):
        d = self._deployments.pop(name, None)
        self._probes.pop(name, None)
        doomed = list(self._replicas.pop(name, []))
        if d is not None:
            doomed += [r for r, _dl in d.get("_draining", [])]
            if d.get("_rolling") is not None:
                doomed.append(d["_rolling"][0])
        for r in doomed:
            self._kill_replica(name, r)
        self._bump_version(name)
        return d is not None

    def shutdown(self):
        self._shutdown = True
        for name in list(self._deployments):
            self.delete_deployment(name)
        try:
            from ray_tpu_torch.core.api import _global_worker

            _global_worker().gcs.call("kv_del", {
                "namespace": "serve", "key": self._KV_KEY}, timeout=5)
        except (OSError, TimeoutError) as e:
            logger.debug("serve KV cleanup lost: %s", e)
        return True

    # ----------------------------------------------------------- discovery
    def get_replicas(self, name: str, known_version: int = -1,
                     timeout_s: float = 2.0):
        """Versioned long-poll (reference LongPollHost, long_poll.py:186):
        event-driven — the wait wakes on the version bump, not a poll."""
        deadline = time.monotonic() + timeout_s
        with self._version_cv:
            while self._versions.get(name, 0) == known_version:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._version_cv.wait(timeout=remaining)
        return {
            "version": self._versions.get(name, 0),
            "incarnation": self._incarnation,
            "replicas": list(self._replicas.get(name, [])),
            "app_ingress": bool(
                self._deployments.get(name, {}).get("app_ingress", False)),
        }

    def list_deployments(self):
        return {
            name: {"target": d["target"],
                   "replicas": len(self._replicas.get(name, []))}
            for name, d in self._deployments.items()
        }

    def metrics_snapshot(self):
        """Per-deployment queue depth (last autoscale poll) + replica
        counts, for the driver's Prometheus export."""
        return {
            name: {"replicas": len(self._replicas.get(name, [])),
                   "queue_depth": d.get("last_queue_depth", 0)}
            for name, d in self._deployments.items()
        }

    # ----------------------------------------------------------- reconcile
    def _reconcile_loop(self):
        last_health = 0.0
        while not self._shutdown:
            time.sleep(0.25)
            try:
                now = time.monotonic()
                probe = now - last_health >= 1.0
                if probe:
                    last_health = now
                for name in list(self._deployments):
                    if probe:
                        self._health_check(name)
                    self._autoscale(name)
                    self._reconcile_one(name)
            except Exception:
                logger.exception("reconcile failed")

    def _health_check(self, name: str):
        """Drop replicas whose health probe ERRORS (actor process gone);
        the reconcile pass right after replaces them (reference
        DeploymentState check_and_update_replicas). Probes are
        asynchronous — a busy replica (probe queued behind requests) never
        blocks the reconcile loop and never counts as dead."""
        replicas = self._replicas.get(name, [])
        if not replicas:
            self._probes.pop(name, None)
            return
        probes = self._probes.setdefault(name, {})
        for r in replicas:
            if r not in probes:
                probes[r] = r.health.remote()
        dead = []
        for r in list(probes):
            if r not in replicas:  # replica already scaled away
                probes.pop(r)
                continue
            ready, _ = ray_tpu_torch.wait([probes[r]], num_returns=1,
                                          timeout=0)
            if not ready:
                continue  # still queued/running — busy is not dead
            ref = probes.pop(r)
            try:
                ray_tpu_torch.get(ref)
            except Exception:
                logger.warning("replica of %s failed health check; "
                               "replacing", name)
                dead.append(r)
                self._kill_replica(name, r)
        if dead:
            self._replicas[name] = [r for r in replicas if r not in dead]
            self._bump_version(name)

    def _blob_arg(self, d: dict):
        """Large deployment definitions (model weights baked into the
        class) ship as ONE plasma object with an owner-directed push
        broadcast (`ray_tpu_torch.push`, reference push_manager.h:29): every
        replica node reads a local copy instead of each replica re-shipping
        the blob from the controller. Small definitions stay by-value."""
        blob = d["def_blob"]
        if len(blob) < (1 << 20):
            return blob
        ref = d.get("_def_blob_ref")
        if ref is None:
            with tracing.span("serve::put_definition", "serve",
                              bytes=len(blob)):
                ref = ray_tpu_torch.put(blob)
                try:
                    ray_tpu_torch.push(ref)
                except Exception:
                    logger.debug("def-blob push skipped", exc_info=True)
            d["_def_blob_ref"] = ref
        return ref

    def _new_replica(self, d: dict):
        opts = dict(d["actor_options"])
        opts["max_concurrency"] = max(d["max_concurrency"], 4)
        ver = d.get("def_version", 0)
        replica = _ReplicaActor.options(**opts).remote(
            self._blob_arg(d), d["init_args"], d["init_kwargs"],
            def_version=ver, user_config=d.get("user_config"))
        self._replica_def_version[_replica_key(replica)] = ver
        return replica

    def _replica_version(self, r) -> Optional[int]:
        """Definition version of a replica; None while unknown. Unknown
        versions (controller restarted: the map is empty) are recovered
        asynchronously from the replica itself so a redeploy after a
        controller restart still rolls pre-restart replicas."""
        key = _replica_key(r)
        v = self._replica_def_version.get(key)
        if v is not None:
            return v
        probe = self._version_queries.get(key)
        if probe is None:
            try:
                probe = r.def_version.remote()
            except Exception:
                return None
            self._version_queries[key] = probe
        done, _ = ray_tpu_torch.wait([probe], num_returns=1, timeout=0)
        if not done:
            return None
        self._version_queries.pop(key, None)
        try:
            v = int(ray_tpu_torch.get(probe, timeout=1))
        except Exception:
            return None  # health check handles dead replicas
        self._replica_def_version[key] = v
        return v

    def _kill_replica(self, name: str, r) -> None:
        self._replica_def_version.pop(_replica_key(r), None)
        self._version_queries.pop(_replica_key(r), None)
        self._evict_stats_client(r)
        try:
            # fire-and-forget graceful-stop hook; never waited on (a dead
            # replica would stall the reconcile loop)
            r.prepare_stop.remote()
        except Exception:
            pass
        try:
            ray_tpu_torch.kill(r)
        except (OSError, RuntimeError, ValueError, KeyError):
            pass  # replica already dead — the goal state

    def _reconcile_one(self, name: str):
        d = self._deployments.get(name)
        if d is None:
            return
        replicas = self._replicas.setdefault(name, [])
        changed = False
        while len(replicas) < d["target"]:
            replicas.append(self._new_replica(d))
            changed = True
        while len(replicas) > d["target"]:
            # Downscale DRAINS like a rolling update: the displaced replica
            # leaves the routable set now (handles stop picking it on the
            # version bump) but keeps serving its in-flight requests until
            # idle, hard-killed only past the same drain_deadline_s knob.
            r = replicas.pop()
            d.setdefault("_draining", []).append(
                (r, time.monotonic() + _serve_cfg().drain_deadline_s))
            changed = True
        if self._advance_rollout(name, d, replicas):
            changed = True
        if changed:
            self._bump_version(name)

    def _advance_rollout(self, name: str, d: dict, replicas: List[Any]) -> bool:
        """One rolling-update step per reconcile pass (reference
        DeploymentState rollout): start a new-definition replica, wait for
        its health probe, then swap it in for ONE stale replica — the old
        version keeps serving throughout, and the displaced replica drains
        (kill once idle, or after the configurable drain_deadline_s)."""
        ver = d.get("def_version", 0)
        # reap draining replicas that are idle (or past deadline)
        draining = d.setdefault("_draining", [])
        still = []
        for r, deadline in draining:
            idle = False
            try:
                idle = self._worker_stats(r).get("load", 0) == 0
            except Exception:
                # transient stats failure must NOT count as idle (it would
                # kill a busy replica mid-request); the deadline bounds us
                idle = False
            if idle or time.monotonic() > deadline:
                self._kill_replica(name, r)
            else:
                still.append((r, deadline))
        d["_draining"] = still

        stale = [r for r in replicas
                 if self._replica_version(r) not in (None, ver)]
        roll = d.get("_rolling")
        if roll is None:
            if stale and len(replicas) >= d["target"]:
                nr = self._new_replica(d)
                d["_rolling"] = (nr, nr.health.remote())
            return False
        nr, probe = roll
        done, _ = ray_tpu_torch.wait([probe], num_returns=1, timeout=0)
        if not done:
            return False
        ok = False
        try:
            ok = bool(ray_tpu_torch.get(probe, timeout=1))
        except Exception:
            ok = False
        d["_rolling"] = None
        if not ok:
            self._kill_replica(name, nr)  # failed rollout step; retried next pass
            return False
        victim = next((r for r in replicas
                       if self._replica_version(r) not in (None, ver)), None)
        if victim is None:
            # the stale replica disappeared meanwhile (health-check kill +
            # refill at the current version): the set is already current,
            # and appending would overshoot target — next pass would kill
            # the fresh replica mid-request
            self._kill_replica(name, nr)
            return False
        replicas.append(nr)
        replicas.remove(victim)
        d["_draining"].append(
            (victim, time.monotonic() + _serve_cfg().drain_deadline_s))
        return True

    def _evict_stats_client(self, replica) -> None:
        cache = getattr(self, "_stats_clients", None)
        if not cache:
            return
        client = cache.pop(replica.actor_id, None)
        if client is not None:
            try:
                client.close()
            except OSError:
                pass  # socket already dropped

    def _worker_stats(self, replica) -> dict:
        """actor_stats RPC to the worker hosting `replica` (address cached;
        invalidated on connection errors so replaced replicas re-resolve)."""
        from ray_tpu_torch.core import rpc as _rpc
        from ray_tpu_torch.core.api import _global_worker

        cache = getattr(self, "_stats_clients", None)
        if cache is None:
            cache = self._stats_clients = {}
        key = replica.actor_id
        client = cache.get(key)
        if client is None:
            info = _global_worker().get_actor_info(actor_id=key)
            if not info or not info.get("address"):
                raise RuntimeError("no address for replica")
            client = _rpc.connect_with_retry(info["address"], timeout=3)
            cache[key] = client
        try:
            return client.call("actor_stats", timeout=3)
        except Exception:
            self._evict_stats_client(replica)
            raise

    def _autoscale(self, name: str):
        """Queue-length-driven scaling (reference autoscaling_policy.py:127)."""
        d = self._deployments.get(name)
        if d is None or d["autoscaling"] is None:
            return
        cfg: AutoscalingConfig = d["autoscaling"]
        replicas = self._replicas.get(name, [])
        if not replicas:
            return
        # out-of-band load probe against each replica's WORKER (answered
        # from its RPC thread): an actor-method probe would queue behind
        # the very requests being measured and always read a drained queue
        qlens = []
        for r in replicas:
            try:
                stats = self._worker_stats(r)
                # `load` excludes our own health probes (they queue on the
                # same worker and would inflate every sample by 1)
                qlens.append(stats.get(
                    "load", stats["executing"] + stats["queued"]))
            except Exception:
                # partial stats must not drive scaling: a wrongly-low total
                # would trigger a scale-down of an overloaded deployment
                return
        total = sum(qlens)
        d["last_queue_depth"] = total
        desired = max(
            cfg.min_replicas,
            min(cfg.max_replicas,
                int(-(-total // max(cfg.target_num_ongoing_requests_per_replica, 1e-9)))
                or cfg.min_replicas))
        now = time.monotonic()
        if desired > d["target"] and now - d["last_scale_up"] > cfg.upscale_delay_s:
            d["target"] = desired
            d["last_scale_up"] = now
        elif desired < d["target"] and now - d["last_scale_down"] > cfg.downscale_delay_s:
            d["target"] = d["target"] - 1
            d["last_scale_down"] = now


# ------------------------------------------------------------------ handle


class DeploymentHandle:
    """Routes calls to replicas: power-of-two-choices over client-side
    in-flight counts (reference router.py:263). Thread-free data plane: the
    in-flight decrement is a completion callback on the ownership layer
    (no per-request thread), and replica-set updates arrive via ONE
    background long-poll loop per handle (reference LongPollClient,
    long_poll.py:68) instead of per-request controller polls."""

    def __init__(self, deployment_name: str, method_name: str = "__call__"):
        self._name = deployment_name
        self._method = method_name
        self._version = -1
        self._incarnation = None  # controller incarnation the version is from
        self._stream = False
        self._timeout_s: Optional[float] = None  # None -> config default
        self._idempotent = True  # False disables mid-request failover
        self._replicas: List[Any] = []
        # keyed by replica actor id, NOT list index: a replica-set change
        # must not let stale completions decrement a new replica's count
        self._inflight: Dict[bytes, int] = {}
        self._lock = threading.Lock()
        self._refresher: Optional[threading.Thread] = None
        self._bumped = threading.Event()  # set by the pubsub push
        self._sub_cb = None
        self._closed = False

    def _controller(self):
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)

    _rkey = staticmethod(_replica_key)

    def _apply(self, info: dict) -> None:
        with self._lock:
            inc = info.get("incarnation")
            if inc != getattr(self, "_incarnation", None):
                self._incarnation = inc
                self._version = -1  # new controller: any version is news
            self._app_ingress = info.get("app_ingress", False)
            if info["version"] != self._version:
                self._version = info["version"]
                self._replicas = info["replicas"]
                # keep counts for surviving replicas; drop departed ones
                live = {self._rkey(r) for r in self._replicas}
                self._inflight = {k: v for k, v in self._inflight.items()
                                  if k in live}

    def _refresh(self, block: bool = True):
        # Cold start only (a handle with no replica set yet): a bounded 2s
        # server-side long-poll per round, NOT a busy poll — steady-state
        # refresh is push-driven and non-blocking (_ensure_refresher).
        deadline = time.monotonic() + 30
        while True:
            info = ray_tpu_torch.get(self._controller().get_replicas.remote(
                self._name, self._version, 0.0 if not block else 2.0))
            self._apply(info)
            with self._lock:
                if self._replicas or not block or time.monotonic() > deadline:
                    return

    def _ensure_refresher(self) -> None:
        """Replica-set updates are PUSH-driven: the controller publishes
        version bumps over GCS pubsub and this loop answers each with a
        non-blocking get_replicas — no controller exec thread is parked per
        handle (any number of handles costs the controller one fan-out
        publish). A slow periodic poll backstops lost pushes. Both the loop
        and the pubsub callback hold the handle WEAKLY, so a dropped handle
        is collectable: its loop exits and its subscription self-removes."""
        import weakref

        with self._lock:
            t = self._refresher
            if t is not None and t.is_alive():
                return

            wself = weakref.ref(self)

            def on_bump(msg):
                s = wself()
                if s is None:  # handle was GC'd: self-unsubscribe
                    try:
                        from ray_tpu_torch.core.api import _global_worker

                        _global_worker().unsubscribe_channel(
                            SERVE_VERSIONS_CHANNEL, on_bump)
                    except (OSError, KeyError, ValueError):
                        pass  # worker shutting down; channel dies with it
                    return
                if msg.get("name") == s._name:
                    s._bumped.set()

            def loop():
                # Subscribe from the refresher thread, never the request
                # path: a stalled GCS must not wedge remote() calls (and
                # the handle lock is not held here).
                s = wself()
                if s is None:
                    return
                if s._sub_cb is None:
                    try:
                        from ray_tpu_torch.core.api import _global_worker

                        _global_worker().subscribe_channel(
                            SERVE_VERSIONS_CHANNEL, on_bump)
                        s._sub_cb = on_bump
                    except Exception:
                        pass  # poll-only fallback
                # plain Event/str locals do not pin the handle
                bumped, name = s._bumped, s._name
                del s
                failures = 0
                while failures < 5:
                    bumped.wait(timeout=5.0)
                    bumped.clear()
                    s = wself()
                    if s is None or s._closed:
                        return
                    try:
                        info = ray_tpu_torch.get(
                            s._controller().get_replicas.remote(
                                name, s._version, 0.0), timeout=30)
                        s._apply(info)
                        failures = 0
                    except Exception:
                        # Controller gone (serve.shutdown) or unreachable:
                        # exit after a few strikes rather than spinning
                        # forever; the next remote() restarts the loop.
                        failures += 1
                    del s  # don't pin the handle across the wait
                    if failures:
                        time.sleep(1.0)
                s = wself()
                if s is not None:
                    with s._lock:
                        if s._refresher is threading.current_thread():
                            s._refresher = None

            t = threading.Thread(target=loop,
                                 name=f"serve-refresh-{self._name}",
                                 daemon=True)
            self._refresher = t
            t.start()

    def close(self) -> None:
        self._closed = True
        self._bumped.set()
        if self._sub_cb is not None:
            try:
                from ray_tpu_torch.core.api import _global_worker

                _global_worker().unsubscribe_channel(
                    SERVE_VERSIONS_CHANNEL, self._sub_cb)
            except (OSError, KeyError, ValueError):
                pass  # worker shutting down; channel dies with it
            self._sub_cb = None

    def options(self, method_name: str = "__call__", stream: bool = False,
                timeout_s: Optional[float] = None,
                idempotent: bool = True) -> "DeploymentHandle":
        h = DeploymentHandle(self._name, method_name)
        h._stream = stream
        h._timeout_s = timeout_s
        h._idempotent = idempotent
        return h

    # ------------------------------------------------------------- routing
    def _inc(self, key: bytes) -> None:
        with self._lock:
            self._inflight[key] = self._inflight.get(key, 0) + 1

    def _dec(self, key: bytes) -> None:
        with self._lock:
            self._inflight[key] = max(0, self._inflight.get(key, 1) - 1)

    def _pick_replica(self, exclude=()):
        """Power-of-two-choices among replicas that are under the
        configured in-flight cap and not in `exclude` (replicas already
        tried by this request's failover). Returns (replica, key) or
        (None, None) when no replica is eligible — the admission-control
        shed signal when `exclude` is empty."""
        cap = _serve_cfg().max_queue_per_replica
        with self._lock:
            candidates = []
            for r in self._replicas:
                k = self._rkey(r)
                if k in exclude:
                    continue
                if self._inflight.get(k, 0) < cap:
                    candidates.append((r, k))
            if not candidates:
                return None, None
            if len(candidates) == 1:
                return candidates[0]
            a, b = random.sample(range(len(candidates)), 2)
            pick = (a if self._inflight.get(candidates[a][1], 0)
                    <= self._inflight.get(candidates[b][1], 0) else b)
            return candidates[pick]

    def _resolve_deadline(self, timeout_s: Optional[float],
                          deadline_ts: Optional[float]):
        """(deadline_ts, timeout_s): explicit deadline wins (an ingress
        already started the request's clock at parse time), else per-call
        timeout, else the handle default, else the config default. Wall
        clock, so the deadline survives the hop into the replica process."""
        if deadline_ts is not None:
            return deadline_ts, max(0.0, deadline_ts - time.time())
        t = timeout_s if timeout_s is not None else self._timeout_s
        if t is None:
            t = _serve_cfg().request_timeout_s
        return time.time() + t, t

    def remote(self, *args, _timeout_s: Optional[float] = None,
               _deadline_ts: Optional[float] = None, **kwargs):
        _serve_metrics()["requests"].inc(tags={"deployment": self._name})
        # Route span: joins the caller's trace (e.g. the proxy's ingress
        # span) or roots a fresh one. Its span id rides the request as
        # trace_ctx so EVERY replica attempt — including failover retries —
        # parents under this one routing decision.
        route_ctx = None
        t_route = 0.0
        if tracing.enabled():
            amb = tracing.current_ctx()
            route_ctx = (amb[0] if amb else tracing.new_id(),
                         tracing.new_id())
            t_route = tracing.now_us()
        deadline_ts, timeout_s = self._resolve_deadline(
            _timeout_s, _deadline_ts)
        with self._lock:
            have = bool(self._replicas)
        if not have:
            self._refresh()
            with self._lock:
                if not self._replicas:
                    raise RuntimeError(
                        f"deployment {self._name} has no replicas")
        self._ensure_refresher()
        if getattr(self, "_stream", False):
            return self._submit_stream(args, kwargs, deadline_ts)

        replica, key = self._pick_replica()
        if replica is None:
            self._shed()
        budget = (_serve_cfg().request_retry_budget
                  if self._idempotent else 0)
        req = _RouterRequest(self, args, kwargs, deadline_ts, timeout_s,
                             budget)
        req.trace_ctx = route_ctx
        try:
            req._submit_to(replica, key)
        except Exception as e:
            # a submit-time severed link is the same failure class as a
            # mid-request death: route it through the failover budget
            if isinstance(e, _RETRYABLE_ERRORS) and req.retries_left > 0:
                req.tried.add(key)
                _router_pool().submit(req._failover, e)
            else:
                # resolve the already-watched promise so the reaper
                # doesn't later count a spurious timeout for an error
                # the caller received synchronously
                from ray_tpu_torch.core.api import _global_worker

                _global_worker().fulfill_promise(req.promise, error=e)
                req._deregister()
                raise
        if route_ctx is not None:
            amb = tracing.current_ctx()
            tracing.add_complete(
                f"route::{self._name}", "serve_route",
                t_route, tracing.now_us() - t_route,
                trace_id=route_ctx[0], span_id=route_ctx[1],
                parent_id=amb[1] if amb else "",
                deployment=self._name)
        return req.promise

    def _submit_stream(self, args, kwargs, deadline_ts: float):
        """Streaming call (reference handle.options(stream=True)): the
        replica method returns a generator; items arrive as a dynamic-
        return stream consumable while the replica still runs. Failover
        covers the SUBMIT boundary only — once items may have been
        produced, a replay could duplicate them, so a mid-stream death
        surfaces as the typed ActorDiedError instead (promptly: the
        ownership layer fails the stream when the actor dies)."""
        from ray_tpu_torch.core.api import _global_worker

        budget = _serve_cfg().request_retry_budget if self._idempotent else 0
        tried: set = set()
        last_err: Optional[Exception] = None
        route_ctx = None
        t_route = 0.0
        if tracing.enabled():
            amb = tracing.current_ctx()
            route_ctx = (amb[0] if amb else tracing.new_id(),
                         tracing.new_id())
            t_route = tracing.now_us()
        for attempt in range(budget + 1):
            replica, key = self._pick_replica(tried)
            if replica is None:
                if last_err is not None:
                    raise last_err
                self._shed()
            self._inc(key)
            try:
                _rpc.fault_point(REPLICA_CALL_FAULT_POINT)
                with tracing.ctx_scope(route_ctx):
                    gen = replica.handle_request.options(
                        num_returns="dynamic").remote(
                            self._method, args, kwargs, deadline_ts)
            except Exception as e:
                self._dec(key)
                if isinstance(e, _RETRYABLE_ERRORS) and attempt < budget:
                    tried.add(key)
                    last_err = e
                    _bump_router_stat("retries")
                    continue
                raise
            _global_worker().add_done_callback(
                gen._gen_ref, lambda k=key: self._dec(k))
            if route_ctx is not None:
                amb = tracing.current_ctx()
                tracing.add_complete(
                    f"route::{self._name}", "serve_route",
                    t_route, tracing.now_us() - t_route,
                    trace_id=route_ctx[0], span_id=route_ctx[1],
                    parent_id=amb[1] if amb else "",
                    deployment=self._name, stream=True)
            return gen
        raise last_err  # budget spent

    def _shed(self):
        _bump_router_stat("shed")
        _serve_metrics()["shed"].inc(tags={"deployment": self._name})
        cfg = _serve_cfg()
        with self._lock:
            n = len(self._replicas)
        raise BackPressureError(
            f"deployment {self._name} shed request: all {n} replicas at "
            f"the in-flight cap ({cfg.max_queue_per_replica})")

    def __reduce__(self):
        # routing options must survive serialization: a handle passed into
        # another deployment keeps its stream/timeout/idempotence behavior
        return (_rebuild_handle,
                (self._name, self._method, getattr(self, "_stream", False),
                 self._timeout_s, self._idempotent))


def _rebuild_handle(name: str, method: str, stream: bool,
                    timeout_s: Optional[float] = None,
                    idempotent: bool = True) -> "DeploymentHandle":
    h = DeploymentHandle(name, method)
    h._stream = stream
    h._timeout_s = timeout_s
    h._idempotent = idempotent
    return h


class _RouterRequest:
    """One routed unary request. Owns the caller-visible PROMISE ref
    (worker.create_promise) and chases replica attempts until success, a
    non-retryable error, a spent retry budget, or the deadline — so a
    replica dying mid-request re-routes the work without changing the ref
    the caller (or the HTTP edge's completion callback) is holding.
    Completion callbacks run on the RPC reader thread and only relay
    blobs; anything that sleeps or touches sockets (failover resubmits,
    plasma-sized result pulls) hops to the shared router pool."""

    __slots__ = ("h", "args", "kwargs", "deadline_ts", "retries_left",
                 "tried", "promise", "backoff", "retried", "trace_ctx",
                 "current_ref")

    def __init__(self, h: DeploymentHandle, args, kwargs,
                 deadline_ts: float, timeout_s: float, budget: int):
        from ray_tpu_torch.core.api import _global_worker
        from ray_tpu_torch.util.backoff import ExponentialBackoff

        cfg = _serve_cfg()
        self.h = h
        self.args = args
        self.kwargs = kwargs
        self.deadline_ts = deadline_ts
        self.retries_left = budget
        self.tried: set = set()
        self.retried = False
        self.backoff = ExponentialBackoff(
            base_s=cfg.retry_backoff_base_ms / 1000.0,
            cap_s=cfg.retry_backoff_cap_ms / 1000.0)
        self.promise = _global_worker().create_promise()
        self.trace_ctx = None  # (trace_id, route span id) when tracing is on
        self.current_ref = None  # latest replica attempt (cancellation target)
        with _inflight_lock:
            _inflight_requests[self.promise.id] = self
        _deadline_reaper.watch(deadline_ts, self.promise, h._name, timeout_s)

    def _deregister(self) -> None:
        """Request resolved: drop it from the cancellation registry (the
        reaper's expire entry remains the backstop cleanup)."""
        with _inflight_lock:
            _inflight_requests.pop(self.promise.id, None)

    def _submit_to(self, replica, key: bytes) -> None:
        h = self.h
        h._inc(key)
        try:
            _rpc.fault_point(REPLICA_CALL_FAULT_POINT)
            # every attempt (first submit AND pool-thread failovers) submits
            # under the route span's context, so retries stay in-trace
            with tracing.ctx_scope(self.trace_ctx):
                ref = replica.handle_request.remote(
                    h._method, self.args, self.kwargs, self.deadline_ts)
        except BaseException:
            h._dec(key)
            raise
        self.current_ref = ref  # cancellation target for disconnect/expiry
        from ray_tpu_torch.core.api import _global_worker

        _global_worker().add_done_callback(
            ref, lambda: self._on_done(ref, key))

    def _on_done(self, ref, key: bytes) -> None:
        """Attempt completed (runs on the RPC reader thread: cheap,
        non-blocking — classify and relay, or hand off to the pool)."""
        from ray_tpu_torch.core import serialization
        from ray_tpu_torch.core.api import _global_worker

        h = self.h
        h._dec(key)
        w = _global_worker()
        state, blob = w.peek_local(ref)
        if state == "inline":
            # count the failover only if this result actually WON the
            # promise — a success landing after the deadline reaper already
            # timed the request out must not count as both
            if (w.fulfill_promise_blob(self.promise, blob, is_error=False)
                    and self.retried):
                _bump_router_stat("failovers")
            self._deregister()
            return
        if state == "plasma":
            _router_pool().submit(self._relay_plasma, ref)
            return
        if state != "error":
            logger.warning("router attempt for %s resolved in unexpected "
                           "state %r", h._name, state)
            return
        try:
            err = serialization.loads(blob)
        except Exception as e:
            err = e
        if (isinstance(err, _RETRYABLE_ERRORS) and self.retries_left > 0
                and time.time() < self.deadline_ts):
            self.tried.add(key)
            _router_pool().submit(self._failover, err)
            return
        w.fulfill_promise_blob(self.promise, blob, is_error=True)
        self._deregister()

    def _relay_plasma(self, ref) -> None:
        """Pool: pull a plasma-sized result and resolve the promise.
        Costs one deserialize+reserialize (the promise stores the value
        inline under its own id — the store copy lives under the ATTEMPT's
        id, which the caller never sees); true zero-copy would need object
        aliasing in the store. Serve results are overwhelmingly small, so
        this path is rare; revisit if large-result serving appears."""
        from ray_tpu_torch.core.api import _global_worker

        try:
            value = ray_tpu_torch.get(
                ref, timeout=max(1.0, self.deadline_ts - time.time() + 5.0))
        except Exception as e:
            _global_worker().fulfill_promise(self.promise, error=e)
            self._deregister()
            return
        if (_global_worker().fulfill_promise(self.promise, value=value)
                and self.retried):
            _bump_router_stat("failovers")
        self._deregister()

    def _failover(self, err: BaseException, ready: bool = False) -> None:
        """Pool: budget/deadline-bounded re-route onto a surviving replica.
        The full-jitter backoff wait (util/backoff.py) is SCHEDULED on the
        shared timer, never slept in the pool — a mass replica kill with
        many requests in flight must not park every pool thread in sleeps
        and starve plasma relays. The root-cause error is preserved across
        no-eligible-replica scans (each still charges the budget, so the
        loop stays bounded even before the deadline)."""
        from ray_tpu_torch.core.api import _global_worker

        h = self.h
        if time.time() >= self.deadline_ts:
            return  # the deadline reaper resolves the promise (typed)
        if self.retries_left <= 0:
            _global_worker().fulfill_promise(self.promise, error=err)
            self._deregister()
            return
        if not ready:
            remaining = self.deadline_ts - time.time()
            delay = min(self.backoff.next_delay(), max(0.0, remaining))
            _deadline_reaper.schedule(
                time.time() + delay,
                lambda: _router_pool().submit(self._failover, err, True))
            return
        self.retries_left -= 1
        try:
            # the controller may already have replaced the dead replica:
            # pick up the freshest set without parking on a long-poll
            h._refresh(block=False)
        except Exception:
            pass  # stale set still usable; push refresh is the backstop
        replica, key = h._pick_replica(self.tried)
        if replica is None:
            # keep the root-cause error: the controller may replace the
            # dead replica before the next scan, and if the budget runs
            # out the caller should see what actually failed
            self._failover(err)
            return
        self.retried = True
        _bump_router_stat("retries")
        _serve_metrics()["retries"].inc(tags={"deployment": h._name})
        try:
            self._submit_to(replica, key)
        except Exception as e:
            self.tried.add(key)
            self._failover(e)


# ------------------------------------------------------------------ public


@dataclass
class Deployment:
    func_or_class: Any
    name: str
    num_replicas: int = 1
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    autoscaling_config: Optional[AutoscalingConfig] = None
    max_concurrent_queries: int = 8
    init_args: tuple = ()
    init_kwargs: Optional[dict] = None
    # pushed to replicas via their reconfigure() method; changing ONLY
    # this on redeploy updates live replicas in place, no restart
    # (reference deployment user_config / Deployment.reconfigure)
    user_config: Optional[Any] = None

    def bind(self, *args, **kwargs) -> "Deployment":
        import dataclasses as dc

        return dc.replace(self, init_args=args, init_kwargs=kwargs)

    def options(self, **opts) -> "Deployment":
        import dataclasses as dc

        return dc.replace(self, **opts)


def deployment(_func_or_class=None, *, name: Optional[str] = None,
               num_replicas: int = 1, ray_actor_options: Optional[dict] = None,
               autoscaling_config: Optional[dict] = None,
               max_concurrent_queries: int = 8,
               user_config: Optional[Any] = None):
    """`@serve.deployment` (reference python/ray/serve/api.py:261)."""

    def wrap(target):
        auto = None
        if autoscaling_config:
            auto = AutoscalingConfig(**autoscaling_config) \
                if isinstance(autoscaling_config, dict) else autoscaling_config
        return Deployment(
            func_or_class=target,
            name=name or getattr(target, "__name__", "deployment"),
            num_replicas=num_replicas,
            ray_actor_options=dict(ray_actor_options or {}),
            autoscaling_config=auto,
            max_concurrent_queries=max_concurrent_queries,
            user_config=user_config,
        )

    return wrap(_func_or_class) if _func_or_class is not None else wrap


def _get_or_create_controller():
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        return ServeController.options(
            # handles are push-driven (pubsub bump -> non-blocking
            # get_replicas), so concurrency only needs to cover bursts of
            # deploy/status/refresh calls, not a parked poll per handle
            name=CONTROLLER_NAME, num_cpus=0, max_concurrency=64).remote()


def _collect_graph(root: Deployment, order: List[Deployment],
                   seen: set, visiting: set) -> None:
    """Topo-sort the deployment DAG reachable through bound init args
    (reference deployment-graph build, _private/deployment_graph_build.py)."""
    if id(root) in visiting:
        raise ValueError(f"deployment graph has a cycle at {root.name!r}")
    if id(root) in seen:
        return
    visiting.add(id(root))
    for a in list(root.init_args) + list((root.init_kwargs or {}).values()):
        if isinstance(a, Deployment):
            _collect_graph(a, order, seen, visiting)
    visiting.discard(id(root))
    seen.add(id(root))
    order.append(root)


_handle_cache: Dict[tuple, DeploymentHandle] = {}
_handle_cache_lock = threading.Lock()


def _cached_handle(name: str, method: str = "__call__",
                   stream: bool = False) -> DeploymentHandle:
    """One long-lived handle per (deployment, method, stream) in this
    process: repeated lookups reuse the replica set, in-flight accounting,
    and the single pubsub refresher instead of growing a handle per call."""
    from ray_tpu_torch.core.api import _global_worker

    try:
        world = _global_worker().address
    except Exception:
        world = None
    with _handle_cache_lock:
        h = _handle_cache.get((name, method, stream))
        # a cached handle from a torn-down-and-rebooted cluster (its worker
        # address differs) holds dead replicas — replace it
        if h is None or h._closed or getattr(h, "_world", None) != world:
            h = DeploymentHandle(name, method)
            h._stream = stream
            h._world = world
            _handle_cache[(name, method, stream)] = h
        return h


def _close_cached_handles() -> None:
    with _handle_cache_lock:
        handles = list(_handle_cache.values())
        _handle_cache.clear()
    for h in handles:
        h.close()


def _resolve_arg(a):
    return DeploymentHandle(a.name) if isinstance(a, Deployment) else a


def run(target: Deployment, *, name: str = "default") -> DeploymentHandle:
    """Deploy (a graph of) deployments and return the root handle
    (reference serve.run, api.py:460). Bound init args that are themselves
    deployments deploy first and arrive as DeploymentHandles — the
    composition model of the reference's deployment graphs."""
    controller = _get_or_create_controller()
    order: List[Deployment] = []
    _collect_graph(target, order, set(), set())
    names = [d.name for d in order]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate deployment names in graph: {names}")
    for d in order:
        init_args = tuple(_resolve_arg(a) for a in d.init_args)
        init_kwargs = {k: _resolve_arg(v)
                       for k, v in (d.init_kwargs or {}).items()} or None
        # deploy spans (timeline()): the driver's share of a deploy; the
        # submit puts a large definition into the object store, and waits
        # for a controller that this call has just started
        with tracing.span("serve::pickle_definition", "serve",
                          deployment=d.name):
            def_blob = cloudpickle.dumps(d.func_or_class)
        with tracing.span("serve::submit_deploy", "serve",
                          deployment=d.name, bytes=len(def_blob)):
            ref = controller.deploy.remote(
                d.name,
                def_blob,
                init_args,
                init_kwargs,
                d.num_replicas,
                d.ray_actor_options,
                d.autoscaling_config,
                d.max_concurrent_queries,
                getattr(d.func_or_class, "_serve_app_ingress", False),
                d.user_config,
            )
        with tracing.span("serve::await_deploy", "serve", deployment=d.name):
            ray_tpu_torch.get(ref)
    handle = _cached_handle(target.name)
    handle._refresh()
    return handle


def _serve_metrics() -> Dict[str, Any]:
    """Per-process serve metric instances (lazily registered so importing
    serve doesn't pollute the registry of processes that never serve)."""
    from ray_tpu_torch.util.metrics import get_or_create

    return {
        "requests": get_or_create(
            "counter", "ray_tpu_torch_serve_requests_total", "handle calls",
            tag_keys=("deployment",)),
        "errors": get_or_create(
            "counter", "ray_tpu_torch_serve_errors_total", "failed requests",
            tag_keys=("deployment",)),
        "shed": get_or_create(
            "counter", "ray_tpu_torch_serve_shed_total",
            "requests rejected by admission control",
            tag_keys=("deployment",)),
        "retries": get_or_create(
            "counter", "ray_tpu_torch_serve_retries_total",
            "failover re-routes after replica loss",
            tag_keys=("deployment",)),
        "timeouts": get_or_create(
            "counter", "ray_tpu_torch_serve_timeouts_total",
            "requests failed at their end-to-end deadline",
            tag_keys=("deployment",)),
        "latency": get_or_create(
            "histogram", "ray_tpu_torch_serve_latency_seconds",
            "request latency",
            boundaries=(0.005, 0.02, 0.1, 0.5, 2, 10),
            tag_keys=("deployment",)),
        "queue_depth": get_or_create(
            "gauge", "ray_tpu_torch_serve_queue_depth",
            "total replica queue depth", tag_keys=("deployment",)),
        "replicas": get_or_create(
            "gauge", "ray_tpu_torch_serve_replicas", "running replicas",
            tag_keys=("deployment",)),
    }


def _update_serve_gauges() -> None:
    """Pull serve series from the processes that own them (called by the
    dashboard on /metrics scrape): request/error/latency live in the HTTP
    proxy actor, queue depth + replica counts in the controller."""
    from ray_tpu_torch.util import metrics as metrics_mod

    # The single driver-started proxy plus every per-node proxy
    # (PROXY_NAME:<hex8>): each merges under its own source so counters sum.
    proxy_names = [PROXY_NAME]
    try:
        from ray_tpu_torch import state as _state

        # unnamed actors list name=None — the .get default only covers a
        # MISSING key (an AttributeError here would drop every per-node
        # proxy from scrapes)
        proxy_names += [a["name"] for a in _state.list_actors()
                        if (a.get("name") or "").startswith(PROXY_NAME + ":")
                        and a.get("state") == "ALIVE"]
    except (OSError, RuntimeError, TimeoutError, KeyError, ValueError) as e:
        # RuntimeError covers RpcCallError: scrapes can race teardown, and
        # per-node proxies are optional — the driver proxy still collects
        logger.debug("proxy discovery via state API failed: %s", e)
    for name in proxy_names:
        try:
            proxy = ray_tpu_torch.get_actor(name)
            metrics_mod.merge_snapshot(
                ray_tpu_torch.get(proxy.metrics_snapshot.remote(),
                                  timeout=5),
                source=name)
        except Exception:
            pass  # ingress not running (handle-only traffic counts locally)
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        return
    snap = ray_tpu_torch.get(controller.metrics_snapshot.remote(),
                             timeout=5)
    m = _serve_metrics()
    for name, info in snap.items():
        m["queue_depth"].set(float(info["queue_depth"]),
                             tags={"deployment": name})
        m["replicas"].set(float(info["replicas"]),
                          tags={"deployment": name})


def status() -> Dict[str, Any]:
    """Deployment -> {target, replicas} (reference serve.status)."""
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        return {}
    return ray_tpu_torch.get(controller.list_deployments.remote())


def delete(name: str) -> bool:
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        return False
    return ray_tpu_torch.get(controller.delete_deployment.remote(name))


def get_deployment_handle(name: str) -> DeploymentHandle:
    return _cached_handle(name)


def reconfigure(name: str, user_config: Any) -> bool:
    """Push a new user_config to a live deployment in place (lightweight
    update: no rolling restart).  Returns True if every live replica
    acknowledged; False if some pushes were lost (stragglers converge when
    the reconcile loop replaces them).  Raises KeyError for unknown names."""
    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    return ray_tpu_torch.get(
        controller.reconfigure_deployment.remote(name, user_config))


def shutdown() -> None:
    _close_cached_handles()
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        return
    try:
        ray_tpu_torch.get(controller.shutdown.remote(), timeout=30)
        ray_tpu_torch.kill(controller)
    except (OSError, TimeoutError, ValueError, KeyError, RuntimeError) as e:
        logger.debug("controller teardown best-effort: %s", e)


# ------------------------------------------------------------------ http


@ray_tpu_torch.remote
class _HTTPProxyActor:
    """HTTP ingress (reference HTTPProxyActor, _private/http_proxy.py:250,
    434): an asyncio HTTP/1.1 edge whose request lifecycle is event-driven
    (completion via add_done_callback — no thread parked per request), with
    raw/binary bodies and chunked streaming responses. Implementation:
    serve/http_proxy.py."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        from ray_tpu_torch.serve.http_proxy import AsyncHTTPProxy

        self._server = AsyncHTTPProxy(
            host, port,
            get_handle=_cached_handle,
            get_stream_handle=lambda name, method="__call__": _cached_handle(
                name, method, stream=True))
        self.port = self._server.port

    def get_port(self) -> int:
        return self.port

    def metrics_snapshot(self):
        """This proxy process's serve series, for the driver's exporter."""
        from ray_tpu_torch.util import metrics as metrics_mod

        return metrics_mod.snapshot("ray_tpu_torch_serve_")


def start_http_proxy(port: int = 0):
    """Start the HTTP ingress actor; returns (actor_handle, port)."""
    actor = _HTTPProxyActor.options(
        num_cpus=0, max_concurrency=8, name=PROXY_NAME).remote(port)
    return actor, ray_tpu_torch.get(actor.get_port.remote())


def start_http_proxies_per_node(port: int = 0):
    """One HTTP ingress actor pinned to EVERY alive node (reference
    HTTPProxyActor-per-node, `_private/http_proxy.py:434` /
    `http_state.py`): each proxy binds 0.0.0.0 so an external load balancer
    (or local clients) can reach every node. Returns
    [(node_id_hex, node_host, handle, port)].

    With a fixed `port`, every node listens on the same port (one proxy per
    HOST — in-process test clusters share one host, where only the first
    bind succeeds); with port=0 each proxy picks a free port. Actors are
    created in parallel; nodes that died since the snapshot (or whose bind
    failed) are skipped with a warning rather than hanging the caller."""
    from ray_tpu_torch.core.task_spec import SchedulingStrategy

    started = []
    for n in ray_tpu_torch.nodes():
        if not n.get("alive", True):
            continue
        node_id = n["node_id"]
        host = str(n.get("address", "127.0.0.1")).rsplit(":", 1)[0]
        actor = _HTTPProxyActor.options(
            num_cpus=0, max_concurrency=8,
            name=f"{PROXY_NAME}:{node_id.hex()[:8]}",
            scheduling_strategy=SchedulingStrategy(
                name=None, node_id=node_id)).remote(port, "0.0.0.0")
        started.append((node_id.hex(), host, actor))
    out = []
    for node_hex, host, actor in started:
        try:
            out.append((node_hex, host, actor,
                        ray_tpu_torch.get(actor.get_port.remote(),
                                          timeout=60)))
        except Exception as e:
            logger.warning("per-node proxy on %s failed: %s", node_hex[:8], e)
    return out


# ------------------------------------------------------------------ grpc


@ray_tpu_torch.remote
class _GrpcProxyActor:
    """gRPC ingress actor (reference's gRPC proxy role, serve.proto:235):
    a grpc.aio edge exposing /rayserve.Ingress/Predict + PredictStream with
    deployment routing via metadata. Implementation: serve/grpc_ingress.py."""

    def __init__(self, port: int, host: str = "127.0.0.1"):
        from ray_tpu_torch.serve.grpc_ingress import GrpcIngress

        self._server = GrpcIngress(
            host, port,
            get_handle=_cached_handle,
            get_stream_handle=lambda name, method="__call__": _cached_handle(
                name, method, stream=True))
        self.port = self._server.port

    def get_port(self) -> int:
        return self.port


def start_grpc_proxy(port: int = 0):
    """Start the gRPC ingress actor; returns (actor_handle, port).
    Requires grpcio (baked into standard images; raises cleanly without)."""
    actor = _GrpcProxyActor.options(
        num_cpus=0, max_concurrency=8, name=GRPC_PROXY_NAME).remote(port)
    return actor, ray_tpu_torch.get(actor.get_port.remote())


# ------------------------------------------------------------------- rpc


@ray_tpu_torch.remote
class _RPCProxyActor:
    """Binary RPC ingress on the framework's native framed protocol —
    the role of the reference's gRPC ingress (`serve.proto:235`) without
    protobuf: clients send `serve_request {deployment, method, payload}`
    and get the pickled result back. Suited to service-to-service calls
    where JSON-over-HTTP overhead matters."""

    def __init__(self, port: int):
        from concurrent.futures import ThreadPoolExecutor

        from ray_tpu_torch.core.rpc import RpcServer

        proxy = self
        pool = ThreadPoolExecutor(max_workers=16,
                                  thread_name_prefix="serve-rpc")

        def handle(conn, req_id, payload):
            def run():
                try:
                    name = payload["deployment"]
                    method = payload.get("method", "__call__")
                    h = proxy._handles.setdefault(
                        (name, method), DeploymentHandle(name, method))
                    result = ray_tpu_torch.get(
                        h.remote(*payload.get("args", ()),
                                 **payload.get("kwargs", {})),
                        timeout=payload.get("timeout", 60))
                    conn.reply(req_id, result)
                except Exception as e:
                    conn.reply(req_id, f"{e}", is_error=True)

            pool.submit(run)  # keep the rpc loop free for other requests
            return RpcServer.DEFERRED

        self._handles: Dict[tuple, DeploymentHandle] = {}
        self._server = RpcServer(host="127.0.0.1", port=port)
        self._server.register("serve_request", handle)
        self._server.start()
        self.port = self._server.port

    def get_port(self) -> int:
        return self.port


def start_rpc_proxy(port: int = 0):
    """Start the binary RPC ingress; returns (actor_handle, port).

    Client side:
        from ray_tpu_torch.core.rpc import RpcClient
        c = RpcClient(f"127.0.0.1:{port}")
        c.call("serve_request", {"deployment": "Model", "args": (x,)})
    """
    actor = _RPCProxyActor.options(num_cpus=0, max_concurrency=8).remote(port)
    return actor, ray_tpu_torch.get(actor.get_port.remote())
