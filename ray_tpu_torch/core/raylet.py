"""Raylet: the per-node manager.

Equivalent of the reference's `NodeManager` + `WorkerPool` + `LocalTaskManager`
(`src/ray/raylet/node_manager.h:115`, `worker_pool.h:156`,
`local_task_manager.h:58`): grants workers to queued tasks when resources are
available, spawns/reuses worker subprocesses, schedules across the cluster
with the hybrid policy using a resource view streamed from the GCS (the
reference's RaySyncer role), spills tasks back to other raylets, hosts the
node's shared-memory object store, and serves inter-node object transfer
(reference `ObjectManager`/`PullManager`/`PushManager`).
"""

from __future__ import annotations

import logging
import os
import socket as _socket_mod
import subprocess
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.core import rpc
from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.ids import ActorID, NodeID, ObjectID, TaskID, WorkerID
from ray_tpu_torch.core.exceptions import ObjectStoreFullError
from ray_tpu_torch.core.object_store import (SharedObjectStore,
                                       sweep_stale_spill_dirs)
from ray_tpu_torch.core.scheduler import NodeView, SchedulingPolicy
from ray_tpu_torch.core.runtime_env_manager import env_key as _env_key
from ray_tpu_torch.core.task_spec import TaskSpec, TaskType
from ray_tpu_torch.util import tracing

logger = logging.getLogger(__name__)


def _resident_bytes(pid: int) -> int:
    """A process's resident bytes, or 0 where they cannot be read."""
    try:
        import psutil
    except ImportError:
        return 0
    try:
        return psutil.Process(pid).memory_info().rss
    except psutil.Error:
        return 0


@dataclass
class WorkerHandle:
    worker_id: WorkerID
    conn: rpc.ServerConnection            # registration connection (for pushes)
    address: str                          # the worker's own core-worker server
    pid: int
    proc: Optional[subprocess.Popen] = None
    actor_id: Optional[ActorID] = None    # dedicated actor worker
    current_task: Optional[TaskSpec] = None
    task_started: float = 0.0             # monotonic start of current_task
    idle_since: float = field(default_factory=time.monotonic)
    env_key: Optional[str] = None         # pip runtime-env pool this worker serves
    is_driver: bool = False
    # resources held for the actor's lifetime: (bundle_key | None, demand)
    actor_charge: Optional[Tuple[Optional[Tuple], Dict[str, float]]] = None
    # GPU indices granted for the current task / actor lifetime
    gpu_grant: Optional[Tuple[Optional[List[int]], float]] = None
    # recently completed tasks (task_id, owner_address, t_done): their
    # batched results may still sit in the worker's ResultBuffer when the
    # process dies, so unexpected disconnects fail them over to the owners
    recent_done: deque = field(default_factory=lambda: deque(maxlen=128))
    # resident bytes at registration, before any task ran: the memory
    # monitor's budget mode counts only the growth past it
    mem_baseline: int = 0


@dataclass
class _QueuedTask:
    spec: TaskSpec
    spillback_count: int = 0
    # enqueue stamp (tracing epoch-us) for the lease span: submit-arrival to
    # worker-grant is the queueing stage of the critical path. 0.0 = untraced.
    queued_us: float = 0.0


class _PullBudget:
    """Byte-budget admission control for chunked pulls (reference
    PullManager's active-bundle quota, pull_manager.h:52): callers block
    until their object's bytes fit under the cap, so a burst of huge pulls
    can't overcommit store memory. Requests larger than the cap are clamped
    (a single object must always be admittable)."""

    def __init__(self, max_bytes: int):
        self._max = max(1, max_bytes)
        self._used = 0
        self._cv = threading.Condition()
        self._queue: deque = deque()  # FIFO tickets: no starvation of big pulls

    def acquire(self, n: int) -> None:
        n = min(n, self._max)
        ticket = object()
        with self._cv:
            self._queue.append(ticket)
            # Only the queue head may admit: without the ticket order a large
            # pull starves forever behind a stream of small ones re-grabbing
            # freed bytes.
            while self._queue[0] is not ticket or self._used + n > self._max:
                self._cv.wait(timeout=1.0)
            self._queue.popleft()
            self._used += n
            self._cv.notify_all()  # wake the next head

    def release(self, n: int) -> None:
        n = min(n, self._max)
        with self._cv:
            self._used -= n
            self._cv.notify_all()


class Raylet:
    def __init__(
        self,
        gcs_address: str,
        resources: Optional[Dict[str, float]] = None,
        labels: Optional[Dict[str, str]] = None,
        host: str = "127.0.0.1",
        object_store_memory: Optional[int] = None,
        worker_env: Optional[Dict[str, str]] = None,
    ):
        self.node_id = NodeID.from_random()
        self.gcs_address = gcs_address
        cfg = get_config()
        if resources is None:
            resources = {"CPU": float(os.cpu_count() or 1)}
        resources.setdefault("memory", 4 * 1024**3)
        self.resources_total = dict(resources)
        self.resources_available = dict(resources)
        self.labels = dict(labels or {})
        self.worker_env = dict(worker_env or {})

        self._server = rpc.RpcServer(host)
        self._server.register_all(self)
        self.store = SharedObjectStore(capacity=object_store_memory)
        try:
            # collect spill dirs leaked by SIGKILLed prior stores (kill
            # storms do this every run); re-swept hourly by _reaper_loop
            sweep_stale_spill_dirs()
        except Exception:
            logger.exception("startup spill dir sweep failed")
        # bulk transfer side channel: raw sockets, shm->kernel->shm copies
        # only (see data_plane.py; reference object_manager.h:117 keeps bulk
        # chunk streams off the control plane the same way)
        from ray_tpu_torch.core.data_plane import DataPlanePool, DataPlaneServer

        self._data_plane = DataPlaneServer(self.store, host=host)
        self._data_pool = DataPlanePool()

        self._lock = threading.RLock()
        self._policy = SchedulingPolicy()
        self._queue: deque[_QueuedTask] = deque()
        self._workers: Dict[WorkerID, WorkerHandle] = {}
        # idle workers keyed by runtime-env pool: O(1) acquire per dispatch
        # instead of an O(n) scan over every idle worker of every env
        self._idle_pools: Dict[Optional[str], deque[WorkerID]] = {}
        # debounced resource broadcast (at most one report_resources notify
        # per resource_broadcast_period_ms, trailing edge guaranteed)
        from ray_tpu_torch.util.debounce import Debouncer

        self._resource_report_debounce = Debouncer(
            self._send_resource_report,
            lambda: get_config().resource_broadcast_period_ms / 1000.0,
            skip_deferred=lambda: self._shutdown.is_set())
        self._starting: List[subprocess.Popen] = []
        self._starting_env: Dict[int, str] = {}  # pid -> env_key
        self._starting_envfile: Dict[int, str] = {}  # pid -> {ENVFILE} path
        self._env_spawning: set = set()          # env_keys mid-creation
        self._pending_actor_specs: deque = deque()
        from ray_tpu_torch.core.runtime_env_manager import RuntimeEnvManager

        self._env_manager = RuntimeEnvManager()
        # warm worker pool: fork-template (zygote) processes + demand-driven
        # prestart; cold Popen spawns remain the fallback path
        from ray_tpu_torch.core.worker_pool import WorkerPool

        self._worker_pool = WorkerPool(self)

        # cluster view: node_id hex -> {address, total, available, labels, alive}
        self._cluster_view: Dict[str, dict] = {}
        self._raylet_clients: Dict[str, rpc.RpcClient] = {}

        # per-pg bundle reservations: (pg_id, idx) -> remaining resources
        self._bundles: Dict[Tuple, Dict[str, float]] = {}
        self._bundles_committed: Dict[Tuple, bool] = {}
        # original reservation per bundle (re-reported to the GCS on
        # re-registration so a replacement head re-pins them) + prepare
        # time for 2PC orphan cleanup (a head that died between prepare
        # and commit leaks the reservation; the reaper returns it)
        self._bundle_reservations: Dict[Tuple, Dict[str, float]] = {}
        self._bundle_prepared_at: Dict[Tuple, float] = {}

        # head re-resolution: a new GCS address learned in-band (the
        # replacement head dials us and announces itself) overrides the
        # boot-time address; the address file (config gcs_address_file)
        # overrides both. Read on every reconnect attempt.
        self._gcs_address_override: Optional[str] = None
        # fencing: the highest head lease epoch this raylet has adopted.
        # Announces/publishes from a STALE head (epoch below this) are
        # logged and dropped — a fenced head cannot flap our GCS link.
        self._gcs_epoch: int = 0
        self._session_id: Optional[str] = None  # cluster session fingerprint
        self._fencing_drops = 0
        # node incarnation (partition failure domain): stamped by the GCS
        # at registration, echoed in every heartbeat. A typed fence reply
        # (this identity was declared dead while we were partitioned) makes
        # this raylet kill its workers — they host actor incarnations that
        # were restarted elsewhere — and rejoin as a FRESH node.
        self.incarnation: int = 0
        self._fenced_count = 0
        self._fencing_now = False  # one self-fence at a time
        # delta-encoded resource broadcasts: last applied publish seq (None
        # until the first full lands) + one catch-up fetch at a time
        self._bcast_seen_seq: Optional[int] = None
        self._catchup_inflight = False

        # object pulls in flight: object_id -> list[(conn, req_id, pin)]
        self._pending_pulls: Dict[ObjectID, List[Tuple]] = {}
        # zero-copy reader pins per server connection (id(conn) -> {oid:
        # count}): a reader worker that dies without unpinning has its
        # pins reaped when its connection drops — the cross-process half
        # of the pin lifecycle (finalizers cover the in-process half)
        self._conn_pins: Dict[int, Dict[ObjectID, int]] = {}
        # admission control for chunked pulls (reference pull_manager.h:52):
        # bounds the total bytes of concurrently-materializing inbound objects
        self._pull_budget = _PullBudget(cfg.pull_admission_max_bytes)

        self._gcs: Optional[rpc.RpcClient] = None
        # Per-card GPU index assignment (reference worker GPU-id grants):
        # index -> remaining capacity. Integer demands take whole cards;
        # fractional demands pack onto one card (best fit). Assigned ids
        # ship with the execute_task/become_actor push so get_gpu_ids()
        # reports DISJOINT devices across concurrent tasks.
        self._gpu_slots: Dict[int, float] = {
            i: 1.0 for i in range(int(self.resources_total.get("GPU", 0)))}
        self._start_time = time.time()
        # workers we SIGKILLed for memory pressure: their death notification
        # carries reason="oom" so exhausted retries surface OutOfMemoryError
        self._oom_killed: set = set()
        self.oom_kills_total = 0  # monotonic; read by memstorm/tests
        # workers we SIGKILLed for a force-cancel or a job reap: their death
        # notification carries reason="cancelled" so the owner (if any is
        # left) resolves the typed error with no retry
        self._cancel_killed: set = set()
        # primary copy -> owning job (stamped at obj_create): a job reap
        # deletes the dead job's objects by this index; entries die with
        # the object (delete/reap) and are pruned against the store on reap
        self._obj_jobs: Dict[ObjectID, bytes] = {}
        # recently reaped jobs: a reaped worker's death must not dial the
        # dead driver (the owner-notify paths skip these)
        self._reaped_jobs: Dict[bytes, float] = {}
        # cumulative reap counters, returned per reap + summed by the GCS
        self.job_reap_stats = {
            "jobs": 0, "queued_cancelled": 0, "workers_killed": 0,
            "actor_specs_dropped": 0, "objects_dropped": 0,
            "bytes_dropped": 0}
        # Raylets have no TaskEventBuffer (that is a worker-side object), so
        # lease spans ship on the heartbeat cadence via the same
        # task_events_batch channel: drain cursor + carry-over drop count +
        # NTP-style clock offset, mirroring task_events.py.
        self._spans_sent = 0
        self._spans_dropped_pending = 0
        self._clock_offset_us: Optional[float] = None
        self._clock_probe_at = 0.0
        self._shutdown = threading.Event()
        self._threads: List[threading.Thread] = []

    # ------------------------------------------------------------------ boot
    def start(self) -> str:
        self._server.start()
        # Reconnecting link: a restarted GCS gets this node re-registered and
        # re-subscribed before any other call proceeds (GCS fault tolerance);
        # the resolver lets the link follow a REPLACEMENT head to a new
        # address (control-plane HA).
        self._gcs = rpc.ReconnectingClient(
            self.gcs_address, push_handler=self._on_gcs_push,
            on_reconnect=self._replay_gcs_registration,
            resolve=self._resolve_gcs_address,
            origin=self._server.address)
        self._joined_at = time.monotonic()
        reply = self._gcs.call("register_node", self._registration_payload())
        if isinstance(reply, dict) and reply.get("fenced"):
            # a brand-new node id can only be fenced by id collision or a
            # confused head — there is nothing to kill; surface it
            raise RuntimeError(
                f"GCS fenced our registration: {reply.get('reason')}")
        self._note_head_identity(reply)
        for n in reply["nodes"]:
            self._note_node(n)
        # warm node onboarding: pre-spawn fork templates for the fleet's
        # hot runtime-env keys so this node serves warm leases immediately
        # (node-join-to-first-warm-lease is the tracked number)
        self._worker_pool.prewarm(reply.get("hot_envs"))
        self._gcs.call("subscribe", {"channels": ["resources", "nodes", "control"],
                                     "origin": self._server.address})
        t = threading.Thread(target=self._heartbeat_loop, name="raylet-heartbeat", daemon=True)
        t.start()
        self._threads.append(t)
        t2 = threading.Thread(target=self._reaper_loop, name="raylet-reaper", daemon=True)
        t2.start()
        self._threads.append(t2)
        t3 = threading.Thread(target=self._memory_monitor_loop,
                              name="raylet-memory-monitor", daemon=True)
        t3.start()
        self._threads.append(t3)
        logger.info("raylet %s on %s resources=%s", self.node_id.hex()[:8],
                    self._server.address, self.resources_total)
        return self._server.address

    @property
    def address(self) -> str:
        return self._server.address

    def _registration_payload(self) -> dict:
        with self._lock:
            available = dict(self.resources_available)
            # PG bundle re-pinning: report the reservations this node still
            # holds so a replacement head (whose snapshot may trail a
            # commit) re-anchors its PG table to what the fleet holds
            bundles = [
                {"pg_id": key[0], "bundle_index": key[1],
                 "resources": dict(self._bundle_reservations.get(key, {})),
                 "committed": bool(self._bundles_committed.get(key))}
                for key in self._bundles]
        return {
            "node_id": self.node_id.binary(),
            "address": self._server.address,
            "resources": self.resources_total,
            # On RE-registration the node may be mid-load: a restarted GCS
            # must not advertise full capacity for a saturated node.
            "resources_available": available,
            "labels": self.labels,
            "bundles": bundles,
            "start_time": self._start_time,
            # incarnation echo: a re-register with the incarnation we hold
            # KEEPS it (no bump); 0 = fresh join, the GCS issues the next
            "incarnation": self.incarnation,
        }

    def _resolve_gcs_address(self) -> Optional[str]:
        """Current-best GCS address for a reconnect attempt: the address
        file (authoritative — operators/replacement heads publish there)
        beats the in-band announce, which beats the boot-time address.
        An empty/unreadable address file reads as "no answer" (keep the
        last-known address and retry), never as an address."""
        return rpc.read_gcs_address_file() or self._gcs_address_override

    def _note_head_identity(self, reply: dict) -> None:
        """Record the head's fencing epoch + cluster session id from a
        registration reply (the fingerprint promote_announce checks), and
        the node incarnation the head stamped us with."""
        epoch = reply.get("epoch")
        if epoch is not None:
            with self._lock:
                self._gcs_epoch = max(self._gcs_epoch, int(epoch))
        sid = reply.get("session_id")
        if sid:
            self._session_id = sid
        inc = reply.get("incarnation")
        if inc is not None:
            self.incarnation = int(inc)

    def _replay_gcs_registration(self, raw: rpc.RpcClient) -> None:
        """Re-register on a fresh GCS connection (uses the RAW client — the
        wrapper's lock is held during replay)."""
        reply = raw.call("register_node", self._registration_payload(), timeout=30)
        if isinstance(reply, dict) and reply.get("fenced"):
            # our identity was declared dead while we were away (partition
            # heal): kill the superseded workers and rejoin FRESH. Raising
            # aborts installing this connection; the fence itself kicks a
            # reconnect that registers the fresh identity.
            self._self_fence(reply.get("reason") or "registration fenced")
            raise rpc.RpcDisconnected(
                f"registration fenced: {reply.get('reason')}")
        # the link may have followed a head replacement: workers spawned
        # from now on (and rpc_get_gcs_address callers) get the live head
        self.gcs_address = raw.address
        self._note_head_identity(reply)
        for n in reply.get("nodes", []):
            self._note_node(n)
        with self._lock:
            self._bcast_seen_seq = None  # new head: wait for its first full
        raw.call("subscribe", {"channels": ["resources", "nodes", "control"],
                               "origin": self._server.address},
                 timeout=30)
        self._worker_pool.prewarm(reply.get("hot_envs"))
        logger.info("raylet %s re-registered with GCS at %s (epoch %s, "
                    "incarnation %s)", self.node_id.hex()[:8], raw.address,
                    reply.get("epoch"), reply.get("incarnation"))

    def _stale_announce(self, payload: dict, rpc_name: str) -> bool:
        """Fencing gate for head announces: an epoch below the one this
        raylet already adopted means a FENCED head is calling — log and
        drop (no GCS-client flap), count the rejection."""
        epoch = payload.get("epoch")
        if epoch is None:
            return False  # legacy announce: can't judge, accept
        with self._lock:
            if int(epoch) >= self._gcs_epoch:
                return False
            self._fencing_drops += 1
            known = self._gcs_epoch
        logger.warning(
            "raylet %s: dropped %s from STALE head %s (epoch %s < adopted "
            "%d)", self.node_id.hex()[:8], rpc_name,
            payload.get("address"), epoch, known)
        try:
            from ray_tpu_torch.core.gcs import _head_metrics  # shared definition

            _head_metrics()["fencing"].inc(tags={"site": "raylet_announce"})
        except Exception:
            pass
        return True

    def _adopt_announce(self, payload: dict) -> None:
        """Record the announced head (address + epoch) and kick the
        reconnect loop off-thread (announce handlers run on the RPC loop;
        closing the client there would self-deadlock). A re-announce of the
        head we already have a live link to is a no-op — the paced
        re-announce backstop must not flap a healthy link."""
        address = payload["address"]
        with self._lock:
            self._gcs_epoch = max(self._gcs_epoch,
                                  int(payload.get("epoch", 0)))
        if address == self.gcs_address and self._gcs is not None \
                and not self._gcs.closed:
            cli = getattr(self._gcs, "_client", None)
            if cli is not None and not cli.closed:
                return  # already on this head over a live link
        with self._lock:
            self._bcast_seen_seq = None  # new head numbers its own stream
        self._gcs_address_override = address
        threading.Thread(target=self._kick_gcs_reconnect,
                         name="gcs-address-kick", daemon=True).start()

    def _kick_gcs_reconnect(self) -> None:
        gcs = self._gcs
        if gcs is None or gcs.closed:
            return
        cli = getattr(gcs, "_client", None)
        if cli is not None and not cli.closed:
            cli.close()  # on_disconnect schedules the reconnect

    def rpc_new_gcs_address(self, conn, req_id, payload):
        """In-band head-replacement announce: a replacement GCS restored
        this node from its snapshot and is telling us where it lives now.
        Records the override and kicks the reconnect loop by dropping the
        stale link. Epoch-fenced: a revived stale head's announce is
        dropped instead of flapping our link to the real head."""
        if self._stale_announce(payload, "new_gcs_address"):
            return False
        logger.info("raylet %s: GCS announced new address %s",
                    self.node_id.hex()[:8], payload["address"])
        self._adopt_announce(payload)
        return True

    def rpc_promote_announce(self, conn, req_id, payload):
        """Promoted-head announce with one-RPC re-adoption: epoch-fenced
        like new_gcs_address, and when the caller presents OUR cluster
        session id the reply carries this node's full registration payload
        — the new head adopts us from its snapshot-known provisional entry
        to a live node in this single round trip (no re-registration on
        the failover critical path). The background reconnect still runs
        (idempotently) to re-establish subscriptions/pushes."""
        if self._stale_announce(payload, "promote_announce"):
            return {"adopted": False, "reason": "stale_epoch"}
        logger.info("raylet %s: head promotion announced from %s (epoch %s)",
                    self.node_id.hex()[:8], payload.get("address"),
                    payload.get("epoch"))
        self._adopt_announce(payload)
        sid = payload.get("session_id")
        if not sid or sid != self._session_id:
            return {"adopted": False, "reason": "session_mismatch"}
        return {"adopted": True, **self._registration_payload()}

    def rpc_get_gcs_address(self, conn, req_id, payload):
        """Workers/drivers re-resolve the head through their raylet: the
        raylet's own reconnect loop tracks the replacement head, so its
        current gcs_address is the freshest in-band answer."""
        return self._gcs_address_override or self.gcs_address

    def note_first_warm_lease(self, seconds: float) -> None:
        """Pool callback: this node served its FIRST warm (forked) lease
        `seconds` after joining. One-shot, best-effort report to the GCS
        (ray_tpu_torch_node_join_warm_lease_seconds + gcs_stats)."""
        try:
            self._gcs.notify("report_warm_lease", {
                "node_id": self.node_id.binary(),
                "join_to_first_warm_lease_s": seconds})
        except (OSError, RuntimeError) as e:
            logger.debug("warm-lease report lost (GCS down?): %s", e)

    def crash(self) -> None:
        """Whole-node crash for the chaos harness: the raylet, its workers
        and its fork templates die together — SIGKILL, no graceful
        teardown, no drain notify. The GCS must detect this through missed
        heartbeats alone, exactly like a real node loss."""
        self._shutdown.set()
        try:
            self._worker_pool.kill_all()
        except Exception:
            logger.exception("worker pool kill_all failed")
        with self._lock:
            workers = list(self._workers.values())
            starting = list(self._starting)
        for p in starting:
            try:
                p.kill()
            except OSError:
                pass
        for w in workers:
            if w.is_driver:
                continue  # the driver is not OUR process tree
            try:
                if w.proc is not None:
                    w.proc.kill()
                else:
                    os.kill(w.pid, 9)
            except OSError:
                pass
        if self._gcs:
            self._gcs.close()
        # snapshot under the lock: concurrent _peer() dials install into
        # this dict, and an unlocked iteration can raise mid-teardown
        with self._lock:
            clients = list(self._raylet_clients.values())
        for c in clients:
            c.close()
        self._data_pool.close()
        self._data_plane.stop()
        self._server.stop()
        self.store.shutdown()

    def _self_fence(self, reason: str) -> None:
        """Typed fence response received (our node identity was declared
        dead — e.g. a partition was healed after the cluster moved on):
        kill every worker and fork template on this node (their actor
        incarnations were restarted elsewhere; letting them keep answering
        is the two-addresses-per-named-actor split-brain), reset to a
        FRESH node identity, and re-register. The process, its server and
        its object store survive — only the node identity and the worker
        population are replaced. Runs off-thread: callers sit on the
        heartbeat loop or inside the GCS client's reconnect lock."""
        with self._lock:
            if self._fencing_now or self._shutdown.is_set():
                return
            self._fencing_now = True
            self._fenced_count += 1
        threading.Thread(target=self._do_self_fence, args=(reason,),
                         name="raylet-self-fence", daemon=True).start()

    def _do_self_fence(self, reason: str) -> None:
        old_hex = self.node_id.hex()[:8]
        logger.warning(
            "raylet %s FENCED (incarnation %d): %s — killing workers and "
            "rejoining as a fresh node", old_hex, self.incarnation, reason)
        try:
            with self._lock:
                workers = [w for w in self._workers.values()
                           if not w.is_driver]
                for w in workers:
                    # suppress actor_failed: those actors were restarted
                    # elsewhere while we were declared dead — reporting
                    # their "death" now would poke the LIVE instance
                    w.actor_id = None
                    self._workers.pop(w.worker_id, None)
                self._idle_pools.clear()
                starting = list(self._starting)
                self._starting.clear()
                starting_envs = list(self._starting_env.values())
                self._starting_env.clear()
                queued = [qt.spec for qt in self._queue]
                self._queue.clear()
                self._pending_actor_specs.clear()
                self._bundles.clear()
                self._bundles_committed.clear()
                self._bundle_reservations.clear()
                self._bundle_prepared_at.clear()
                self.resources_available = dict(self.resources_total)
                self._gpu_slots = {
                    i: 1.0 for i in range(
                        int(self.resources_total.get("GPU", 0)))}
            for p in starting:
                try:
                    p.kill()
                except OSError:
                    pass
            for ek in starting_envs:
                self._env_manager.release(ek)
            for w in workers:
                if w.env_key:
                    self._env_manager.release(w.env_key)
                try:
                    if w.proc is not None:
                        w.proc.kill()
                    else:
                        os.kill(w.pid, 9)
                except OSError:
                    pass
            # templates die too (their forked children would inherit the
            # superseded actor state); the pool stays SERVING — the fresh
            # identity reboots templates on demand / prewarm
            try:
                self._worker_pool.reset_for_fence()
            except Exception:
                logger.exception("worker pool fence reset failed")
            # tasks we held (queued or mid-run) fail over at their owners
            # exactly like a worker crash: retry budgets apply, owners on
            # live nodes resubmit through their own raylets
            for w in workers:
                if w.current_task is not None:
                    self._notify_owner_worker_died(w.current_task)
                self._failover_recent_done(w.recent_done)
            for spec in queued:
                self._notify_owner_worker_died(spec)
            # fresh identity: new node id, incarnation reissued by the GCS
            from ray_tpu_torch.core.ids import NodeID as _NodeID

            with self._lock:
                self.node_id = _NodeID.from_random()
                self.incarnation = 0
                self._start_time = time.time()
                self._joined_at = time.monotonic()
                self._bcast_seen_seq = None
            logger.warning("raylet %s rejoining as fresh node %s after "
                           "fence", old_hex, self.node_id.hex()[:8])
            self._kick_gcs_reconnect()
        finally:
            with self._lock:
                self._fencing_now = False

    def stop(self) -> None:
        self._shutdown.set()
        self._worker_pool.stop()
        with self._lock:
            workers = list(self._workers.values())
            starting = list(self._starting)
            envfiles = list(self._starting_envfile.values())
            self._starting_envfile.clear()
        for path in envfiles:
            try:
                os.unlink(path)
            except OSError:
                pass
        for p in starting:
            try:
                p.terminate()
            except OSError:
                pass  # already exited
        for w in workers:
            if w.proc is not None:
                try:
                    w.proc.terminate()
                except OSError:
                    pass  # already exited
        for w in workers:
            if w.proc is not None:
                try:
                    w.proc.wait(timeout=2)
                except (OSError, subprocess.TimeoutExpired):
                    try:
                        w.proc.kill()
                    except OSError:
                        pass  # exited between wait and kill
        if self._gcs:
            self._gcs.close()
        # snapshot under the lock: concurrent _peer() dials install into
        # this dict, and an unlocked iteration can raise mid-teardown
        with self._lock:
            clients = list(self._raylet_clients.values())
        for c in clients:
            c.close()
        self._data_pool.close()
        self._data_plane.stop()
        self._server.stop()
        self.store.shutdown()

    # ----------------------------------------------------- gcs pubsub intake
    def _on_gcs_push(self, method: str, payload):
        if method != "pubsub":
            return
        ch, msg = payload["channel"], payload["message"]
        if ch == "resources":
            self._apply_resource_broadcast(msg)
            self._schedule()
        elif ch == "nodes":
            if msg.get("event") == "removed":
                hexid = msg["node_id"].hex()
                with self._lock:
                    self._cluster_view.pop(hexid, None)
                    c = self._raylet_clients.pop(hexid, None)
                if c:
                    c.close()
        elif ch == "control":
            if msg.get("cmd") == "gc":
                with self._lock:
                    workers = list(self._workers.values())
                for w in workers:
                    if w.conn.alive:
                        w.conn.push("global_gc", {})

    def _apply_resource_broadcast(self, msg) -> None:
        """Apply one CH_RESOURCES publish. Three wire shapes: the legacy
        full-view dict, {"kind": "full"} (replace wholesale, reset the
        sequence), and {"kind": "delta"} (apply changed/removed on top of
        the view IF our last-applied seq is the delta's base — otherwise a
        gap: ignore it and pull one consistent full via get_resources_full).
        Epoch-stamped publishes from a head staler than the one we adopted
        are dropped."""
        if not isinstance(msg, dict) or "kind" not in msg:
            # legacy full-view dict (pre-delta heads)
            with self._lock:
                for hexid, v in msg.items():
                    if hexid == self.node_id.hex():
                        continue
                    self._cluster_view[hexid] = v
            return
        me = self.node_id.hex()
        need_catchup = False
        with self._lock:
            epoch = int(msg.get("epoch", 0))
            if epoch and epoch < self._gcs_epoch:
                self._fencing_drops += 1
                return  # stale head still publishing into a dead channel
            if msg["kind"] == "full":
                self._cluster_view = {h: v for h, v in msg["nodes"].items()
                                      if h != me}
                self._bcast_seen_seq = msg["seq"]
            elif self._bcast_seen_seq is not None \
                    and msg.get("prev") == self._bcast_seen_seq:
                for h, v in msg.get("changed", {}).items():
                    if h != me:
                        self._cluster_view[h] = v
                for h in msg.get("removed", ()):
                    self._cluster_view.pop(h, None)
                self._bcast_seen_seq = msg["seq"]
            else:
                # gap (missed publish / fresh subscription): one catch-up
                # fetch at a time; deltas keep arriving and are ignored
                # until the full view re-anchors the sequence
                if not self._catchup_inflight:
                    self._catchup_inflight = True
                    need_catchup = True
        if need_catchup:
            threading.Thread(target=self._broadcast_catchup,
                             name="bcast-catchup", daemon=True).start()

    def _broadcast_catchup(self) -> None:
        """Pull one consistent full resource view (we run OFF the push
        reader thread: a blocking call there would deadlock the reply)."""
        try:
            full = self._gcs.call("get_resources_full", {}, timeout=10)
        except Exception:
            logger.debug("broadcast catch-up fetch failed; next delta gap "
                         "will retry", exc_info=True)
            full = None
        me = self.node_id.hex()
        with self._lock:
            self._catchup_inflight = False
            if not isinstance(full, dict):
                return
            self._cluster_view = {h: v for h, v in full["nodes"].items()
                                  if h != me}
            self._bcast_seen_seq = full["seq"]
            self._gcs_epoch = max(self._gcs_epoch,
                                  int(full.get("epoch", 0)))
        self._schedule()

    def _note_node(self, n: dict) -> None:
        hexid = n["node_id"].hex()
        if hexid == self.node_id.hex():
            return
        with self._lock:
            self._cluster_view[hexid] = {
                "address": n["address"],
                "total": n["resources_total"],
                "available": n["resources_available"],
                "labels": n.get("labels", {}),
                "alive": n.get("alive", True),
            }

    def _peer(self, address: str) -> rpc.RpcClient:
        # Dial OUTSIDE self._lock: this is the raylet's main state lock,
        # and connect_with_retry spins its full timeout when the target is
        # dead (an owner whose node was killed). Holding the lock through
        # that stalls heartbeats and task dispatch for seconds per corpse.
        with self._lock:
            c = self._raylet_clients.get(address)
            if c is not None and not c.closed:
                return c
        c = rpc.connect_with_retry(address, timeout=3,
                                   origin=self._server.address)
        with self._lock:
            existing = self._raylet_clients.get(address)
            if existing is not None and not existing.closed:
                c.close()
                return existing
            self._raylet_clients[address] = c
            return c

    def _node_stats(self) -> dict:
        """Per-node physical utilization for the dashboard/state API
        (reference dashboard agent's psutil reporter,
        dashboard/modules/reporter/reporter_agent.py)."""
        try:
            import psutil

            vm = psutil.virtual_memory()
            st = self.store.stats()
            return {
                "cpu_percent": psutil.cpu_percent(interval=None),
                "mem_used": vm.used,
                "mem_total": vm.total,
                "object_store_used": st.get("used_bytes", 0),
                # storage failure-domain block: aggregated per node into
                # gcs_stats["storage"] (used/pinned/pool/spilled/degraded)
                "object_store": {
                    "used_bytes": st.get("used_bytes", 0),
                    "capacity_bytes": st.get("capacity_bytes", 0),
                    "pinned_bytes": st.get("pinned_bytes", 0),
                    "pool_bytes": st.get("pool_bytes", 0),
                    "spilled_bytes": st.get("spilled_bytes", 0),
                    "spill_degraded": st.get("spill_degraded", False),
                },
                "num_workers": len(self._workers),
            }
        except (OSError, ValueError, KeyError) as e:
            logger.debug("node stats unavailable: %s", e)
            return {}

    def _heartbeat_loop(self) -> None:
        period = get_config().health_check_period_ms / 1000.0
        while not self._shutdown.wait(period):
            with self._lock:
                demands = [self._effective_demand(qt.spec)
                           for qt in list(self._queue)[:100]]
            try:
                reply = self._gcs.call("heartbeat", {
                    "node_id": self.node_id.binary(),
                    "incarnation": self.incarnation,
                    "resources_available": dict(self.resources_available),
                    "pending_demands": demands,
                    "node_stats": self._node_stats(),
                    # recent lease traffic per env key: feeds the GCS
                    # hot-env table that joining nodes prewarm from
                    "hot_envs": self._worker_pool.hot_envs(),
                }, timeout=5)
                if isinstance(reply, dict):
                    if reply.get("fenced"):
                        # our identity was invalidated (declared dead during
                        # a partition): kill the superseded workers, rejoin
                        # as a fresh node
                        self._self_fence(reply.get("reason")
                                         or "heartbeat fenced")
                    elif reply.get("unknown"):
                        # this head never saw our registration (replacement
                        # head restored an older snapshot): re-register —
                        # same identity, workers intact
                        logger.warning(
                            "raylet %s unknown to the head; re-registering",
                            self.node_id.hex()[:8])
                        threading.Thread(target=self._kick_gcs_reconnect,
                                         name="gcs-rereg-kick",
                                         daemon=True).start()
            except Exception:
                if not self._shutdown.is_set():
                    logger.warning("heartbeat to GCS failed")
            # Periodic retry for queued tasks — independent of the GCS call
            # (local dispatch needs no GCS, and a down control plane is
            # exactly when the retry matters): scheduling is otherwise
            # event-driven (resource broadcasts fire on ACTIVITY), so on an
            # idle cluster a task queued behind a dead/suspect target would
            # starve forever — e.g. a lineage reconstruction spilled to a
            # node that died with no other traffic to re-trigger dispatch.
            try:
                if demands:
                    self._schedule()
                # Backstop for the actor-spawn pipeline (primary re-arm is
                # in the registration handler): if pending actor specs
                # outlive every in-flight spawn, respawn here.
                with self._lock:
                    if self._pending_actor_specs and not self._starting:
                        by_env: Dict = {}
                        for s in self._pending_actor_specs:
                            ek = _env_key(s.runtime_env)
                            by_env.setdefault(ek, [0, s.runtime_env])[0] += 1
                        for ek, (count, renv) in by_env.items():
                            self._maybe_spawn(ek, renv, needed=count)
            except Exception:
                if not self._shutdown.is_set():
                    logger.exception("periodic schedule retry failed")
            try:
                self._ship_spans()
            except Exception:
                logger.debug("raylet span flush failed", exc_info=True)

    def _ship_spans(self) -> None:
        """Flush locally recorded spans (lease spans, mostly) to the GCS on
        the heartbeat cadence via the task_events_batch channel — the raylet
        process has no TaskEventBuffer, so it ships its own tracing ring."""
        if not self.ship_spans or not tracing.enabled():
            return
        fresh, self._spans_sent, spans_dropped = tracing.drain(self._spans_sent)
        spans_dropped += self._spans_dropped_pending
        self._spans_dropped_pending = 0
        if not fresh and not spans_dropped:
            return
        now = time.monotonic()
        if self._clock_offset_us is None or now >= self._clock_probe_at:
            self._clock_probe_at = now + max(
                1.0, get_config().tracing_clock_probe_period_s)
            try:
                t0 = time.time() * 1e6
                reply = self._gcs.call("clock_probe", timeout=2)
                t2 = time.time() * 1e6
                self._clock_offset_us = reply["t1_us"] - (t0 + t2) / 2.0
            except Exception:
                logger.debug("raylet clock probe failed", exc_info=True)
        src = self.node_id.hex()
        payload = {
            "events": [],
            "dropped": 0,
            "src": src,
            "spans_dropped": spans_dropped,
            "profile_events": [{**e, "_src": src} for e in fresh],
        }
        if self._clock_offset_us is not None:
            payload["clock_offset_us"] = self._clock_offset_us
        try:
            delivered = self._gcs.try_notify("task_events_batch", payload)
        except Exception:
            delivered = False
        if not delivered:
            # spans are best-effort but their drop count is not (it is the
            # only record they existed) — re-ride it on the next heartbeat
            self._spans_dropped_pending += spans_dropped

    def _report_resources(self) -> None:
        """Debounced resource broadcast: at most one GCS notify per
        resource_broadcast_period_ms. Completions used to push one report
        (and one cluster-wide broadcast echo, which re-triggered _schedule
        on every subscribed raylet) per finished task; under a deep queue
        that was a measurable slice of the per-completion budget. A burst
        arms ONE trailing timer so the final post-burst state always lands
        within a period — never a stale view, never a notify storm."""
        self._resource_report_debounce()

    def _send_resource_report(self) -> None:
        try:
            self._gcs.notify("report_resources", {
                "node_id": self.node_id.binary(),
                "available": dict(self.resources_available),
            })
        except OSError as e:
            logger.debug("resource broadcast to GCS failed: %s", e)

    # ------------------------------------------------------- worker lifecycle
    def rpc_register_worker(self, conn, req_id, payload):
        wid: WorkerID = payload["worker_id"]
        handle = WorkerHandle(
            worker_id=wid, conn=conn, address=payload["address"], pid=payload["pid"],
        )
        if payload.get("worker_type") != "driver" \
                and get_config().memory_monitor_worker_budget_bytes > 0:
            handle.mem_baseline = _resident_bytes(handle.pid)
        with self._lock:
            # adopt the Popen (or forked-worker shim) if we started it
            for p in self._starting:
                if p.pid == payload["pid"]:
                    handle.proc = p
                    self._starting.remove(p)
                    break
            spawned_env = self._starting_env.pop(payload["pid"], None)
            handle.env_key = payload.get("env_key") or spawned_env
            self._workers[wid] = handle
            envfile = self._starting_envfile.pop(payload["pid"], None)
        if envfile is not None:
            # the worker booted: its {ENVFILE} env file has been consumed
            try:
                os.unlink(envfile)
            except OSError:
                pass
        if payload.get("worker_type") != "driver":
            self._worker_pool.note_registered(
                handle.proc, forked=bool(payload.get("forked")))
        if handle.env_key:
            # URI-style env refcount: alive while any worker serves it.
            # Bumped OUTSIDE the raylet lock (flock'd disk IO must never
            # stall scheduling), keyed off the SAME value the disconnect
            # release uses; if the worker vanished in the window, undo.
            self._env_manager.acquire(handle.env_key)
            with self._lock:
                gone = wid not in self._workers
            if gone:
                self._env_manager.release(handle.env_key)
        with self._lock:
            conn.on_close.append(lambda c, wid=wid: self._on_worker_disconnect(wid))
            if payload.get("worker_type") == "driver":
                handle.is_driver = True
                return {"node_id": self.node_id.binary(), "gcs_address": self.gcs_address}
            # a fresh worker: give it a pending actor spec (from the same
            # runtime-env pool) or mark idle
            spec = self._claim_pending_actor_spec(handle)
            if spec is not None:
                # Keep the spawn pipeline primed: creations that arrived
                # while the startup-concurrency budget was full never got a
                # spawn (budget 0), so each registration must re-arm it or
                # a 200-actor burst stalls once the first batch boots.
                remaining = sum(1 for s in self._pending_actor_specs
                                if _env_key(s.runtime_env) == handle.env_key)
                if remaining:
                    self._maybe_spawn(handle.env_key, spec.runtime_env,
                                      needed=remaining)
            else:
                self._idle_pools.setdefault(
                    handle.env_key, deque()).append(wid)
        if spawned_env:
            # the spawn lease handed off to the worker's own reference
            self._env_manager.release(spawned_env)
        self._schedule()
        return {"node_id": self.node_id.binary(), "gcs_address": self.gcs_address}

    def _build_worker_env(self, env_key: Optional[str] = None
                          ) -> Dict[str, str]:
        """Environment dict for a worker OR a fork-template process (the
        template captures it once; every forked child inherits it)."""
        env = dict(os.environ)
        env.update(self.worker_env)
        # Nothing here hides a card: CUDA_VISIBLE_DEVICES passes through as
        # the node has it, and a worker learns its grant from get_gpu_ids().
        # Workers must find ray_tpu_torch even when it is on sys.path but not
        # installed (driver ran `sys.path.insert`): prepend our package root.
        import ray_tpu_torch

        pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(ray_tpu_torch.__file__)))
        existing = env.get("PYTHONPATH", "")
        if pkg_root not in existing.split(os.pathsep):
            env["PYTHONPATH"] = pkg_root + (os.pathsep + existing if existing else "")
        if env_key is not None:
            env["RAY_TPU_TORCH_RUNTIME_ENV_KEY"] = env_key
        else:
            env.pop("RAY_TPU_TORCH_RUNTIME_ENV_KEY", None)
        env.pop("RAY_TPU_TORCH_WORKER_FORKED", None)
        return env

    def _spawn_worker(self, env_key: Optional[str] = None,
                      runtime_env: Optional[dict] = None) -> bool:
        """Cold-spawn one worker; False when the spawn was suppressed
        (another spawn of a still-creating env is already in flight)."""
        env = self._build_worker_env(env_key)
        python = sys.executable
        if env_key is not None:
            # venv-backed pip env: resolve (and lazily create) the
            # interpreter off the scheduler thread, then spawn from it
            with self._lock:
                if env_key in self._env_spawning:
                    return False  # one spawn per env at a time while creating
                self._env_spawning.add(env_key)

            def create_and_spawn():
                # spawn LEASE: hold the env's refcount from resolution until
                # the worker registers (which takes its own reference), so a
                # gc tick can't delete the env out from under a booting
                # worker; released at registration or on spawn failure
                self._env_manager.acquire(env_key)
                try:
                    ctx = self._env_manager.context_for(runtime_env)
                    env.update(ctx.env_vars)  # plugin-contributed worker env
                    self._launch_worker(ctx.python, env,
                                        command_prefix=ctx.command_prefix)
                except Exception as e:  # ANY plugin/spawn failure fails tasks
                    logger.warning("%s", e)
                    self._env_manager.release(env_key)
                    self._fail_env_tasks(env_key, str(e))
                finally:
                    with self._lock:
                        self._env_spawning.discard(env_key)

            threading.Thread(target=create_and_spawn, daemon=True,
                             name="runtime-env-create").start()
            return True
        self._launch_worker(python, env)
        return True

    def _launch_worker(self, python: str, env: Dict[str, str],
                       command_prefix=None) -> None:
        argv = [python, "-m", "ray_tpu_torch.core.worker_main",
                "--raylet", self._server.address, "--gcs", self.gcs_address,
                "--node-id", self.node_id.hex()]
        envfile = None
        if command_prefix:
            prefix = list(command_prefix)
            if "{ENVFILE}" in prefix:
                # container boundary: the worker env crosses via an env
                # file (Popen's env= only reaches the engine CLI itself)
                import tempfile

                fd, envfile = tempfile.mkstemp(prefix="rtt-worker-",
                                               suffix=".env")
                with os.fdopen(fd, "w") as f:
                    for k, v in env.items():
                        if "\n" not in v:
                            f.write(f"{k}={v}\n")
                prefix = [envfile if a == "{ENVFILE}" else a for a in prefix]
            argv = prefix + argv
        proc = subprocess.Popen(argv, env=env)
        with self._lock:
            self._starting.append(proc)
            key = env.get("RAY_TPU_TORCH_RUNTIME_ENV_KEY")
            if key:
                self._starting_env[proc.pid] = key
            if envfile is not None:
                # tracked for cleanup at registration / startup-death (the
                # reaper also sweeps stale files as a crash backstop)
                self._starting_envfile[proc.pid] = envfile

    def _fail_env_tasks(self, env_key: str, msg: str) -> None:
        """Fail every queued task/actor whose pip env could not be built."""
        with self._lock:
            bad_tasks = [qt for qt in self._queue
                         if _env_key(qt.spec.runtime_env) == env_key]
            for qt in bad_tasks:
                self._queue.remove(qt)
            bad_actors = [s for s in self._pending_actor_specs
                          if _env_key(s.runtime_env) == env_key]
            for s in bad_actors:
                self._pending_actor_specs.remove(s)
        for qt in bad_tasks:
            self._notify_owner_task_failed(qt.spec, msg)
        for s in bad_actors:
            try:
                self._gcs.notify("actor_failed", {
                    "actor_id": s.actor_id, "reason": msg,
                    "node_id": self.node_id.binary()})
            except OSError as e:
                logger.warning("actor_failed notify lost (GCS down?): %s", e)

    def _on_worker_disconnect(self, wid: WorkerID) -> None:
        with self._lock:
            handle = self._workers.pop(wid, None)
            if handle is None:
                return
        if handle.env_key:
            self._env_manager.release(handle.env_key)
        with self._lock:
            pool = self._idle_pools.get(handle.env_key)
            if pool is not None:
                try:
                    pool.remove(wid)
                except ValueError:
                    pass
            spec = handle.current_task
            actor_id = handle.actor_id
        if self._shutdown.is_set():
            return
        was_oom = wid in self._oom_killed
        self._oom_killed.discard(wid)
        was_cancel = wid in self._cancel_killed
        self._cancel_killed.discard(wid)
        if handle.gpu_grant is not None:
            self._release_gpus(*handle.gpu_grant)
            handle.gpu_grant = None
        if spec is not None:
            self._release_resources(spec)
            if not self._job_reaped(spec.job_id):
                # reaped jobs skip the notify: the owner IS the dead driver
                # (or one of its killed workers) — dialing it buys nothing
                reason = ("cancelled" if was_cancel
                          else "oom" if was_oom else "")
                self._notify_owner_worker_died(spec, reason=reason)
        # Batched-result loss failover: tasks completed in the last few
        # flush intervals may have died with their results still in the
        # worker's ResultBuffer (task_done precedes result delivery under
        # load). task_worker_died is idempotent at the owner — a task whose
        # results already landed was popped from its pending table — so
        # over-notifying is safe; an owner that DID lose the results retries
        # or fails the task instead of hanging on it forever. Clean exits
        # (max_calls recycle, idle kill) pop the handle before the
        # disconnect fires and never reach this; retiring workers get the
        # same backstop after a grace delay in rpc_task_done.
        self._failover_recent_done(handle.recent_done)
        self._release_actor_charge(handle)
        if actor_id is not None:
            try:
                self._gcs.notify("actor_failed", {
                    "actor_id": actor_id,
                    "reason": f"worker process {handle.pid} died",
                    # node-scoped: the GCS ignores this if the actor is no
                    # longer hosted here (late report racing a restart)
                    "node_id": self.node_id.binary()})
            except OSError as e:
                logger.warning("actor_failed notify lost (GCS down?): %s", e)
        self._schedule()

    def _failover_recent_done(self, recent_done, extra_window: float = 0.0
                              ) -> None:
        """Notify owners of recently completed tasks that their worker is
        gone; owners whose results already landed treat it as a no-op. The
        window scales with the configured flush interval — results can sit
        buffered in the worker for about that long (`extra_window` covers
        deliberate delays, e.g. the retiring-worker grace). Entries group
        per owner and an owner is dialed ONCE: a dead owner (the common
        paired failure — driver died, then its worker) costs one bounded
        connect attempt, not one per completed task."""
        window = extra_window + max(
            5.0, 10 * get_config().result_buffer_flush_interval_ms / 1000.0)
        now = time.monotonic()
        by_owner: Dict[str, list] = {}
        for task_id, owner, t_done in list(recent_done):
            if now - t_done <= window:
                by_owner.setdefault(owner, []).append(task_id)
        for owner, task_ids in by_owner.items():
            try:
                peer = self._peer(owner)
                for task_id in task_ids:
                    peer.notify("task_worker_died",
                                {"task_id": task_id, "reason": ""})
            except Exception:
                logger.debug("recent-done failover notify to %s lost", owner)

    def _notify_owner_task_failed(self, spec: TaskSpec, msg: str) -> None:
        try:
            owner = self._peer(spec.owner_address)
            owner.notify("task_failed", {"task_id": spec.task_id, "error": msg})
        except Exception:
            logger.warning("could not notify owner of failed task %s", spec.task_id)

    def _notify_owner_worker_died(self, spec: TaskSpec, reason: str = "") -> None:
        try:
            owner = self._peer(spec.owner_address)
            owner.notify("task_worker_died",
                         {"task_id": spec.task_id, "reason": reason})
        except Exception:
            logger.warning("could not notify owner of dead worker for task %s", spec.task_id)

    # ------------------------------------------------- cancellation / reap
    def _job_reaped(self, job_id) -> bool:
        key = job_id.binary() if hasattr(job_id, "binary") else job_id
        with self._lock:
            return key in self._reaped_jobs

    def rpc_cancel_task(self, conn, req_id, payload):
        """Owner-side cancel reaching the task's node of record. Queued:
        dequeue + typed ack to the owner (no children can exist — the task
        never ran). Running: push the cooperative interrupt to the hosting
        worker (which fans out any recursive child cancels as their owner);
        force=True SIGKILLs after a short grace so the interrupt gets a
        chance to propagate first. Not here at all: forward once along the
        owner-recorded spill hop, else stay silent — the owner's failsafe
        owns resolution for acks lost in transit."""
        task_id: TaskID = payload["task_id"]
        force = bool(payload.get("force"))
        with self._lock:
            qt = next((q for q in self._queue
                       if q.spec.task_id == task_id), None)
            if qt is not None:
                self._queue.remove(qt)
        if qt is not None:
            try:
                self._peer(qt.spec.owner_address).notify("task_cancelled", {
                    "task_id": task_id,
                    "detail": (f"task {qt.spec.method_name} was cancelled "
                               f"while queued")})
            except Exception:
                logger.debug("task_cancelled ack lost", exc_info=True)
            return True
        with self._lock:
            target = next((h for h in self._workers.values()
                           if h.current_task is not None
                           and h.current_task.task_id == task_id), None)
        if target is None:
            hint = payload.get("spilled_node_id")
            if hint is not None and hint != self.node_id.binary():
                v = self._cluster_view.get(hint.hex())
                if v is not None:
                    fwd = dict(payload)
                    fwd.pop("spilled_node_id", None)
                    try:
                        self._peer(v["address"]).notify("cancel_task", fwd)
                    except Exception:
                        logger.debug("cancel forward to %s lost",
                                     hint.hex()[:8], exc_info=True)
            return True
        try:
            target.conn.push("cancel_task", {
                "task_id": task_id, "force": force,
                "recursive": bool(payload.get("recursive"))})
        except Exception:
            logger.debug("cancel push to worker %d lost", target.pid,
                         exc_info=True)
        if force:
            t = threading.Timer(
                get_config().task_cancel_force_grace_ms / 1000.0,
                self._force_kill_cancelled, args=(task_id,))
            t.daemon = True
            t.start()
        return True

    def _force_kill_cancelled(self, task_id: TaskID) -> None:
        """force=True escalation: the cooperative grace expired and a
        worker is STILL on the task — SIGKILL it. The disconnect path then
        reports reason="cancelled" and the owner resolves typed,
        non-retryable (it zeroed the retry budget at cancel)."""
        with self._lock:
            target = next((h for h in self._workers.values()
                           if h.current_task is not None
                           and h.current_task.task_id == task_id), None)
            if target is None:
                return  # interrupt landed (or task finished) in the grace
            self._cancel_killed.add(target.worker_id)
        logger.info("force-cancel: killing worker %d still running task "
                    "after grace", target.pid)
        try:
            if target.proc is not None:
                target.proc.kill()
            else:
                os.kill(target.pid, 9)
        except OSError:
            self._cancel_killed.discard(target.worker_id)

    def rpc_reap_job(self, conn, req_id, payload):
        """GCS push: a job died (driver SIGKILL/OOM/preemption) — purge
        every trace of it from this node: queued tasks (no owner ack; the
        owner IS the corpse), running task workers (SIGKILL, marked so the
        disconnect path skips the dead-owner notify), pending actor specs,
        and the job's primary object copies. Actor WORKERS are killed by
        the GCS's per-actor kill_actor_worker pushes riding the same reap —
        not here — so a detached actor's worker is never touched. Returns
        this node's reap counters for the GCS rollup."""
        job_id: bytes = payload["job_id"]
        pace = max(0.0, get_config().job_reap_pacing_ms / 1000.0)
        now = time.monotonic()
        with self._lock:
            self._reaped_jobs[job_id] = now
            for k, ts in list(self._reaped_jobs.items()):
                if now - ts > 600.0:
                    del self._reaped_jobs[k]
            doomed_q = [qt for qt in self._queue
                        if qt.spec.job_id.binary() == job_id]
            for qt in doomed_q:
                self._queue.remove(qt)
            doomed_specs = [
                s for s in self._pending_actor_specs
                if getattr(s, "job_id", None) is not None
                and s.job_id.binary() == job_id]
            for s in doomed_specs:
                self._pending_actor_specs.remove(s)
            victims = [h for h in self._workers.values()
                       if h.actor_id is None
                       and h.current_task is not None
                       and h.current_task.job_id.binary() == job_id]
            for h in victims:
                self._cancel_killed.add(h.worker_id)
            doomed_objs = [oid for oid, jid in self._obj_jobs.items()
                           if jid == job_id]
            for oid in doomed_objs:
                self._obj_jobs.pop(oid, None)
        for h in victims:
            try:
                if h.proc is not None:
                    h.proc.kill()
                else:
                    os.kill(h.pid, 9)
            except OSError:
                pass  # exited on its own between pick and kill
            if pace:
                time.sleep(pace)
        bytes_dropped = 0
        for oid in doomed_objs:
            loc = self.store.lookup(oid)
            if loc is not None:
                bytes_dropped += loc[1]
            self.store.delete(oid)
            self._resolve_pulls(oid, "owner job reaped")
        # spawn demand queued for the purged backlog would fork workers
        # into a vacuum; serve re-reads live backlog, this just drops the
        # stale figures ahead of it
        self._worker_pool.shed_demand()
        counters = {
            "queued_cancelled": len(doomed_q),
            "workers_killed": len(victims),
            "actor_specs_dropped": len(doomed_specs),
            "objects_dropped": len(doomed_objs),
            "bytes_dropped": bytes_dropped,
        }
        with self._lock:
            self.job_reap_stats["jobs"] += 1
            for k, v in counters.items():
                self.job_reap_stats[k] += v
        if any(counters.values()):
            logger.info(
                "reaped job %s: %d queued tasks, %d workers, %d pending "
                "actors, %d objects (%d bytes)", job_id.hex()[:8],
                counters["queued_cancelled"], counters["workers_killed"],
                counters["actor_specs_dropped"], counters["objects_dropped"],
                bytes_dropped)
        self._schedule()
        return counters

    # ---------------------------------------------------------- memory guard
    def _memory_monitor_loop(self) -> None:
        """Node memory watchdog (reference MemoryMonitor, memory_monitor.h:52):
        when usage crosses the watermark, SIGKILL a worker running the
        NEWEST retriable task (reference retriable-LIFO killing policy,
        worker_killing_policy.h:34). The owner resubmits it (kills are
        cooldown-paced so a retry has a window to succeed); with retries
        exhausted the caller sees OutOfMemoryError."""
        try:
            import psutil
        except ImportError:
            return
        cfg = get_config()
        period = cfg.memory_monitor_refresh_ms / 1000.0
        last_kill = 0.0
        while not self._shutdown.wait(period):
            try:
                usage = self._memory_usage_fraction(psutil)
            except (OSError, ValueError) as e:
                logger.debug("memory probe failed: %s", e)
                continue
            if usage <= cfg.memory_usage_threshold:
                continue
            # Cooldown between kills: a SIGKILLed worker's memory takes time
            # to return to the OS; killing every tick would cascade through
            # innocent workers before pressure can drop.
            now = time.monotonic()
            if now - last_kill < cfg.memory_monitor_kill_cooldown_ms / 1000.0:
                continue
            if self._kill_memory_victim(usage):
                last_kill = time.monotonic()

    def _kill_memory_victim(self, usage: float) -> bool:
        """Pick, flag and SIGKILL atomically under the lock so the signal
        can't land on a worker that finished its task (or became an actor
        worker) between selection and kill."""
        cfg = get_config()
        min_age = cfg.memory_monitor_min_task_age_ms / 1000.0
        now = time.monotonic()
        with self._lock:
            candidates = [
                w for w in self._workers.values()
                if w.current_task is not None and not w.is_driver
                and w.actor_id is None and now - w.task_started >= min_age]
            if not candidates:
                return False
            # Retriable first, newest first (cheapest work to redo); never
            # drivers or actor workers (actor death is a bigger blast
            # radius — reference group-by-owner policy escalates there).
            retriable = [w for w in candidates
                         if w.current_task.max_retries != 0]
            pool = retriable or candidates
            victim = max(pool, key=lambda w: w.task_started)
            logger.warning(
                "memory pressure %.0f%% > %.0f%%: killing worker %d running "
                "task %s", usage * 100,
                get_config().memory_usage_threshold * 100, victim.pid,
                victim.current_task.method_name)
            self._oom_killed.add(victim.worker_id)
            try:
                if victim.proc is not None:
                    victim.proc.kill()
                else:
                    os.kill(victim.pid, 9)
            except OSError:
                # it exited on its own between pick and kill
                self._oom_killed.discard(victim.worker_id)
                return False
            self.oom_kills_total += 1
        return True

    def _memory_usage_fraction(self, psutil) -> float:
        cfg = get_config()
        budget = cfg.memory_monitor_worker_budget_bytes
        if budget > 0:
            # Budget mode counts only the workers the kill policy may touch:
            # actor-held memory must not trigger an endless kill loop of
            # innocent task workers it can never relieve. Each worker counts
            # its growth past its resident size at registration, the memory
            # its tasks took. Every worker starts with torch resident (a
            # fork of the template, or its own import): most of it shared
            # with the template on Linux, but in every worker's RSS, and a
            # host that reports no shared pages (gVisor) shows the whole of
            # it in every worker's unique set too. Counting that start in
            # every worker tripped the budget with no task memory at all.
            with self._lock:
                workers = [(w.pid, w.mem_baseline)
                           for w in self._workers.values()
                           if not w.is_driver and w.actor_id is None]
            total = 0
            for pid, baseline in workers:
                try:
                    rss = psutil.Process(pid).memory_info().rss
                except psutil.Error:
                    continue  # raced a worker exit
                total += max(0, rss - baseline)
            return total / budget
        return psutil.virtual_memory().percent / 100.0

    def _reaper_loop(self) -> None:
        """Reap dead spawned processes + kill long-idle workers + reclaim
        long-unreferenced runtime envs + collect stale spill dirs."""
        cfg = get_config()
        last_env_gc = time.monotonic()
        last_spill_gc = time.monotonic()
        while not self._shutdown.wait(1.0):
            if time.monotonic() - last_spill_gc >= 3600.0:
                # hourly: spill dirs leaked by SIGKILLed stores (keyed by
                # pid; the startup sweep in __init__ covers the common
                # case, this covers raylets outliving their killed peers)
                last_spill_gc = time.monotonic()
                try:
                    sweep_stale_spill_dirs()
                except Exception:
                    logger.exception("stale spill dir sweep failed")
            if time.monotonic() - last_env_gc >= 60.0:
                last_env_gc = time.monotonic()
                try:
                    # idle grace matches the worker-pool idle policy: an env
                    # whose last worker left may get a new task momentarily
                    self._env_manager.gc(
                        min_idle_s=cfg.idle_worker_killing_time_s)
                except Exception:
                    logger.exception("runtime env gc failed")
                self._sweep_stale_envfiles()
            # 2PC orphan cleanup: a bundle PREPARED but never committed
            # means the head died (or gave up) between phases — nothing
            # will ever commit or return it, so the reservation would leak
            # node capacity forever. Return it after the prepare timeout
            # (a resumed creation re-prepares it idempotently first).
            now_mono = time.monotonic()
            prep_timeout = cfg.bundle_prepare_timeout_s
            with self._lock:
                orphans = [k for k, t in self._bundle_prepared_at.items()
                           if not self._bundles_committed.get(k)
                           and now_mono - t > prep_timeout]
            for pg_id, idx in orphans:
                pid = pg_id.hex()[:8] if hasattr(pg_id, "hex") else str(pg_id)
                logger.warning(
                    "returning orphaned uncommitted bundle (%s, %d): "
                    "prepared over %.0fs ago, never committed",
                    pid, idx, prep_timeout)
                self.rpc_return_bundle(None, 0, {
                    "pg_id": pg_id, "bundle_index": idx})
            with self._lock:
                starting = list(self._starting)
            for p in starting:
                expired = (getattr(p, "forked", False) and p.poll() is None
                           and time.monotonic() - p.started_at
                           > cfg.worker_register_timeout_s)
                if expired:
                    # a forked worker that never registered within the
                    # budget: signal-0 liveness can't be trusted (the
                    # template reaped it and the pid may be an unrelated
                    # process by now) — expire the slot, return its lease
                    logger.warning(
                        "forked worker pid %d never registered within %ss; "
                        "expiring", p.pid, cfg.worker_register_timeout_s)
                if p.poll() is not None or expired:
                    with self._lock:
                        try:
                            self._starting.remove(p)
                        except ValueError:
                            pass
                        dead_env = self._starting_env.pop(p.pid, None)
                        dead_envfile = self._starting_envfile.pop(p.pid, None)
                    if dead_env:
                        # died before registering: return its spawn lease
                        self._env_manager.release(dead_env)
                    if dead_envfile:
                        try:
                            os.unlink(dead_envfile)
                        except OSError:
                            pass
                    logger.warning("worker pid %d exited during startup rc=%s", p.pid, p.returncode)
            # warm-pool upkeep: dead templates -> backoff respawn state,
            # idle env templates closed, default-env prestart floor topped up
            try:
                self._worker_pool.health_tick()
            except Exception:
                logger.exception("worker pool health tick failed")
            # idle killing (the default-env pool never shrinks below the
            # prestart floor: killing a floor worker would just respawn it
            # next tick — a kill/respawn flap instead of a warm reserve)
            now = time.monotonic()
            to_kill: List[WorkerHandle] = []
            with self._lock:
                for pool_key, pool in self._idle_pools.items():
                    keep = self._worker_pool.floor() if pool_key is None else 0
                    for wid in list(pool):
                        if len(pool) <= keep:
                            break
                        w = self._workers.get(wid)
                        # no `proc is not None` guard: the exit push below
                        # is graceful for ANY worker, and a forked worker
                        # that registered after its shim expired has
                        # proc=None — it must still be idle-killable
                        if w and now - w.idle_since > cfg.idle_worker_killing_time_s:
                            pool.remove(wid)
                            self._workers.pop(wid, None)
                            to_kill.append(w)
            for w in to_kill:
                if w.env_key:
                    # popped here, so _on_worker_disconnect won't release
                    self._env_manager.release(w.env_key)
                try:
                    w.conn.push("exit", {})
                except OSError:
                    pass  # connection already dropped; process reaper owns it

    def _sweep_stale_envfiles(self, max_age_s: float = 3600.0) -> None:
        """Crash backstop for the tracked {ENVFILE} cleanup: a raylet that
        died between mkstemp and registration leaves rtt-worker-*.env
        files behind; sweep ones old enough that no live spawn owns them."""
        import glob
        import tempfile

        with self._lock:
            live = set(self._starting_envfile.values())
        cutoff = time.time() - max_age_s
        pattern = os.path.join(tempfile.gettempdir(), "rtt-worker-*.env")
        for path in glob.glob(pattern):
            if path in live:
                continue
            try:
                if os.path.getmtime(path) < cutoff:
                    os.unlink(path)
            except OSError:
                pass  # raced another sweeper or the owner

    # -------------------------------------------------------- observability
    def rpc_worker_pool_stats(self, conn, req_id, payload):
        """Warm/cold start counters + fork latency percentiles + template
        states (envelope, burst harness, dashboards)."""
        return self._worker_pool.stats()

    def rpc_object_store_stats(self, conn, req_id, payload):
        """Store usage for `ray_tpu_torch memory` (reference scripts.py:1881)."""
        return {"node_id": self.node_id.binary(), **self.store.stats()}

    def rpc_list_workers(self, conn, req_id, payload):
        """Worker pids/state for `ray_tpu_torch stack` + debugging."""
        with self._lock:
            return [{
                "pid": w.pid,
                "worker_id": w.worker_id,
                "actor_id": w.actor_id.binary() if w.actor_id else None,
                "idle": w.current_task is None and w.actor_id is None,
                "env_key": w.env_key,
            } for w in self._workers.values() if not w.is_driver]

    def rpc_profile_worker(self, conn, req_id, payload):
        """Start an on-demand cpu/memory profile in a worker (reference
        dashboard's py-spy/memray trigger, `profile_manager.py` role).
        Returns a token; poll rpc_profile_result for the report."""
        import uuid

        pid = payload.get("pid")
        token = uuid.uuid4().hex
        with self._lock:
            targets = [w for w in self._workers.values()
                       if not w.is_driver and (pid is None or w.pid == pid)]
        if pid is not None and not targets:
            return {"error": f"no worker with pid {pid} on this node"}
        started = []
        for w in targets:
            if w.conn.alive:
                w.conn.push("profile", {
                    "token": f"{token}-{w.pid}",
                    "profile_kind": payload.get("profile_kind", "cpu"),
                    "duration_s": payload.get("duration_s", 5.0),
                })
                started.append({"pid": w.pid, "token": f"{token}-{w.pid}"})
        return {"started": started}

    def rpc_profile_result(self, conn, req_id, payload):
        from ray_tpu_torch.util.profiler import read_profile_result

        return {"result": read_profile_result(payload["token"])}

    # set True by node_main (standalone daemon): chaos kill may hard-exit.
    # In-process raylets (driver-embedded head, test Cluster) refuse — the
    # exit would take the driver down with it.
    allow_chaos_kill = False

    # set True by node_main: a STANDALONE raylet process ships its own
    # tracing ring (it has no worker-side TaskEventBuffer). In-process
    # raylets must leave shipping to the driver worker's buffer — two
    # drain cursors on one process-wide ring would double-ship every span.
    ship_spans = False

    def rpc_worker_log(self, conn, req_id, payload):
        """Worker stdout/stderr lines -> GCS CH_LOGS fan-out."""
        payload = dict(payload)
        payload["node_id"] = self.node_id.binary()
        try:
            self._gcs.notify("publish_logs", payload)
        except (OSError, RuntimeError):
            pass  # GCS reconnecting; log fan-out is best-effort
        return True

    def rpc_die(self, conn, req_id, payload):
        """Chaos kill for fault-injection tests (reference
        `ray kill_random_node`, scripts.py:1325): hard-exit the node."""
        if not self.allow_chaos_kill:
            logger.warning("chaos kill refused: raylet is driver-embedded")
            return False
        logger.warning("raylet dying on chaos request")
        threading.Thread(target=lambda: (time.sleep(0.1), os._exit(1)),
                         daemon=True).start()
        return True

    # ------------------------------------------------------------ scheduling
    def rpc_submit_task(self, conn, req_id, payload):
        spec: TaskSpec = payload["spec"]
        self._submit(spec, payload.get("spillback_count", 0))
        return True

    def _submit(self, spec: TaskSpec, spillback_count: int) -> None:
        qt = _QueuedTask(spec, spillback_count)
        if spec.trace_ctx is not None:
            qt.queued_us = tracing.now_us()
        with self._lock:
            self._queue.append(qt)
            # Deep-queue regime: a FIFO submission behind >SCAN_MAX blocked
            # tickets cannot dispatch before them, and every event that
            # frees capacity (task done, worker ready, resource update)
            # calls _schedule itself — so skip the per-submit scan and keep
            # submission O(1) under a 20k-task burst (envelope phase 1).
            deep = len(self._queue) > self._SCHED_SCAN_BLOCKED_MAX
            if not deep:
                # Demand-driven prestart (reference PrestartWorkers,
                # worker_pool.cc:1363): keep ~1 worker/CPU booting ahead of
                # the dispatch pass so a burst's first wave doesn't pay a
                # worker boot inline. Dedup against idle here, against
                # in-flight starts in the pool; O(1) per submit, and the
                # deep regime skips it (demand is already saturated).
                ekey = _env_key(spec.runtime_env)
                idle = len(self._idle_pools.get(ekey) or ())
                target = self._worker_pool.prestart_target(
                    len(self._queue), ekey)
                if target > idle:
                    self._worker_pool.request(
                        ekey, spec.runtime_env, target, kind="prestart")
        if not deep:
            self._schedule()

    def _assign_gpus(self, amount: float) -> Optional[List[int]]:
        """Caller holds self._lock. Returns card indices for `amount` GPU
        (whole cards for integer demands; one shared card for fractions),
        or None when accounting says yes but no slot fits (fragmentation —
        fall back to unindexed execution rather than deadlock)."""
        if amount <= 0 or not self._gpu_slots:
            return []
        if amount < 1.0:
            # best fit: the most-used slot that still has room
            best = None
            for i, rem in self._gpu_slots.items():
                if rem >= amount and (best is None
                                      or rem < self._gpu_slots[best]):
                    best = i
            if best is None:
                return None
            self._gpu_slots[best] -= amount
            return [best]
        need = int(amount)
        free = [i for i, rem in self._gpu_slots.items() if rem >= 1.0]
        if len(free) < need:
            return None
        for i in free[:need]:
            self._gpu_slots[i] = 0.0
        return free[:need]

    def _release_gpus(self, ids: Optional[List[int]], amount: float) -> None:
        if not ids:
            return
        with self._lock:
            if amount < 1.0:
                self._gpu_slots[ids[0]] = min(
                    1.0, self._gpu_slots.get(ids[0], 0.0) + amount)
            else:
                for i in ids:
                    self._gpu_slots[i] = 1.0

    # Bounded scheduling scan: _schedule runs on every task completion, so
    # an unbounded drain is O(queue) work per completion — O(n^2) for a
    # deep queue (the r05 envelope's 10k-task phase measured ~5 tasks/s and
    # the lock hold starved heartbeats until the GCS declared the node
    # dead). After this many non-dispatchable tickets the pass stops and
    # the remainder stays queued untouched — bounded work per completion,
    # at worst a window of head-of-line blocking for heterogeneous demands
    # (the reference's LocalTaskManager caps its dispatch scans the same
    # way).
    _SCHED_SCAN_BLOCKED_MAX = 256

    def _schedule(self) -> None:
        """Drain the queue: dispatch locally or spill to a better node.

        Mirrors ClusterTaskManager::QueueAndScheduleTask + LocalTaskManager
        dispatch (`cluster_task_manager.cc:44,418`).
        """
        dispatched_any = False
        spawn_wants: Dict[Optional[str], list] = {}  # env_key -> [count, env]
        with self._lock:
            pending: deque[_QueuedTask] = deque()
            blocked = 0
            while self._queue:
                if blocked >= self._SCHED_SCAN_BLOCKED_MAX:
                    break
                qt = self._queue.popleft()
                spec = qt.spec
                demand = self._effective_demand(spec)
                target = self._choose_node(spec, qt.spillback_count)
                if target is None:
                    # infeasible anywhere right now — keep queued
                    pending.append(qt)
                    blocked += 1
                    continue
                if target != self.node_id.hex():
                    if not self._spill_to(target, qt):
                        pending.append(qt)
                        blocked += 1
                    continue
                if not self._resources_ok(spec, demand):
                    pending.append(qt)
                    blocked += 1
                    continue
                ekey = _env_key(spec.runtime_env)
                if ekey is not None:
                    env_err = self._env_manager.creation_error(ekey)
                    if env_err is not None:
                        self._notify_owner_task_failed(spec, env_err)
                        continue
                handle = self._acquire_worker(ekey)
                if handle is None:
                    pending.append(qt)
                    blocked += 1
                    w = spawn_wants.setdefault(ekey, [0, spec.runtime_env])
                    w[0] += 1
                    continue
                self._charge_resources(spec, demand)
                handle.current_task = spec
                handle.task_started = time.monotonic()
                gpu_amount = demand.get("GPU", 0.0)
                gpu_ids = self._assign_gpus(gpu_amount)
                handle.gpu_grant = (gpu_ids, gpu_amount)
                push_payload = {"spec": spec, "gpu_ids": gpu_ids or []}
                if spec.trace_ctx is not None and qt.queued_us:
                    # lease span: queue-arrival -> worker grant, parented
                    # under the submitter's span; dispatch_us lets the
                    # executor open its dispatch span where the lease ends
                    # (push-to-run gap = worker wakeup + arg resolution)
                    t_now = tracing.now_us()
                    tracing.add_complete(
                        f"lease::{spec.method_name}", "task_lease",
                        qt.queued_us, t_now - qt.queued_us,
                        trace_id=spec.trace_ctx[0],
                        parent_id=spec.trace_ctx[1],
                        task_id=spec.task_id.binary().hex(),
                        node_id=self.node_id.hex())
                    push_payload["dispatch_us"] = t_now
                handle.conn.push("execute_task", push_payload)
                dispatched_any = True
            if self._queue:
                # Early break with an unexamined tail: the blocked head
                # tickets rotate BEHIND the tail, so successive passes walk
                # the whole queue round-robin — a task behind 256 blocked
                # tickets is examined on the next pass instead of starving
                # behind the same head forever.
                self._queue.extend(pending)
            else:
                self._queue = pending
            for ekey, (count, renv) in spawn_wants.items():
                self._maybe_spawn(ekey, renv, needed=count)
        if dispatched_any:
            self._report_resources()

    def _effective_demand(self, spec: TaskSpec) -> Dict[str, float]:
        demand = dict(spec.resources)
        if not demand and spec.task_type == TaskType.NORMAL:
            demand = {"CPU": 1.0}
        return demand

    def _choose_node(self, spec: TaskSpec, spillback_count: int) -> Optional[str]:
        """Returns node hex id, possibly self; None if infeasible."""
        if spillback_count >= 1 or spec.scheduling.placement_group_id is not None:
            # spilled tasks run where they land if feasible; PG tasks were
            # routed to the bundle's node already
            return self.node_id.hex()
        demand = self._effective_demand(spec)
        views = [NodeView(self.node_id.binary(), self.resources_total,
                          self.resources_available, self.labels)]
        addr_by_hex = {self.node_id.hex(): self._server.address}
        for hexid, v in self._cluster_view.items():
            if not v.get("alive", True) or v.get("quarantined"):
                # quarantined: alive but degraded — takes no NEW dispatch
                continue
            views.append(NodeView(bytes.fromhex(hexid), v["total"], v["available"], v.get("labels", {})))
            addr_by_hex[hexid] = v["address"]
        chosen = self._policy.select_node(views, demand, spec.scheduling,
                                          prefer_node=self.node_id.binary())
        if chosen is None:
            return None
        return chosen.hex()

    def _spill_to(self, target_hex: str, qt: _QueuedTask) -> bool:
        v = self._cluster_view.get(target_hex)
        if v is None:
            return False
        try:
            peer = self._peer(v["address"])
            peer.notify("submit_task", {"spec": qt.spec, "spillback_count": qt.spillback_count + 1})
            # Tell the owner where its task went (best-effort): a spilled
            # task can only reach one hop, so this is its node of record —
            # if that whole node later dies (raylet included), the owner's
            # node-death failover is the only surviving signal.
            try:
                self._peer(qt.spec.owner_address).notify("task_spilled", {
                    "task_id": qt.spec.task_id,
                    "node_id": bytes.fromhex(target_hex)})
            except Exception:
                logger.debug("task_spilled notify to owner lost",
                             exc_info=True)
            return True
        except Exception:
            # Mark the target suspect so we do not deterministically re-pick
            # it while the GCS death notice is still in flight.
            logger.warning("spillback to %s failed; marking node suspect", target_hex[:8])
            v["alive"] = False
            return False

    def _resources_ok(self, spec: TaskSpec, demand: Dict[str, float]) -> bool:
        pg = spec.scheduling.placement_group_id
        if pg is not None:
            key = (pg, max(spec.scheduling.bundle_index, 0))
            pool = self._bundles.get(key)
            if pool is None:
                return False
            return all(pool.get(r, 0.0) + 1e-9 >= q for r, q in demand.items())
        return all(self.resources_available.get(r, 0.0) + 1e-9 >= q for r, q in demand.items())

    def _charge_resources(self, spec: TaskSpec, demand: Dict[str, float]) -> None:
        pg = spec.scheduling.placement_group_id
        pool = self.resources_available
        if pg is not None:
            pool = self._bundles[(pg, max(spec.scheduling.bundle_index, 0))]
        for r, q in demand.items():
            pool[r] = pool.get(r, 0.0) - q

    def _release_resources(self, spec: TaskSpec) -> None:
        demand = self._effective_demand(spec)
        with self._lock:
            pg = spec.scheduling.placement_group_id
            pool = self.resources_available
            if pg is not None:
                key = (pg, max(spec.scheduling.bundle_index, 0))
                pool = self._bundles.get(key)
                if pool is None:
                    return
            for r, q in demand.items():
                pool[r] = pool.get(r, 0.0) + q

    def _acquire_worker(self, env_key: Optional[str] = None
                        ) -> Optional[WorkerHandle]:
        """Pop an idle worker from the matching runtime-env pool: O(1) per
        dispatch (plus skipped dead connections) instead of a linear scan
        over every idle worker of every env on a busy mixed-env node."""
        pool = self._idle_pools.get(env_key)
        while pool:
            wid = pool.popleft()
            w = self._workers.get(wid)
            if w is None or not w.conn.alive:
                continue  # raced a disconnect; entry already stale
            return w
        if pool is not None and not pool:
            self._idle_pools.pop(env_key, None)  # drop drained env pools
        return None

    def _starting_for(self, env_key: Optional[str]) -> int:
        return sum(1 for p in self._starting
                   if self._starting_env.get(p.pid) == env_key)

    # ------------------------------------------------- worker-pool surface
    # Thread-safe accessors for the WorkerPool (its serve thread runs
    # outside the raylet lock; everything below takes it).
    def _spawn_inflight(self, env_key: Optional[str]) -> int:
        with self._lock:
            return self._starting_for(env_key)

    def _starting_count(self) -> int:
        with self._lock:
            return len(self._starting)

    def _has_workers_for(self, env_key: Optional[str]) -> bool:
        with self._lock:
            return any(w.env_key == env_key and not w.is_driver
                       for w in self._workers.values())

    def _idle_count(self, env_key: Optional[str]) -> int:
        with self._lock:
            pool = self._idle_pools.get(env_key)
            return len(pool) if pool else 0

    def _task_worker_count(self, env_key: Optional[str]) -> int:
        """Live task-capable (non-driver, non-actor) workers of an env —
        busy OR idle. The prestart policy dedups against this: a busy
        worker still occupies its CPU, so prestarting 'replacements' for
        busy workers just forks an unbounded stream of idlers."""
        with self._lock:
            return sum(1 for w in self._workers.values()
                       if not w.is_driver and w.actor_id is None
                       and w.env_key == env_key)

    def _live_demand(self, env_key: Optional[str]) -> int:
        """Workers this env could consume RIGHT NOW: pending actor specs
        (one dedicated worker each) plus queued tasks that are dispatchable
        under CURRENT resources (cumulatively simulated over a bounded
        scan). Counting every queued task would let a stale spawn request
        fork for tasks that have no CPU to run on — the per-completion
        release->handoff window makes such requests a steady drip under a
        deep queue."""
        from itertools import islice

        with self._lock:
            n = sum(1 for s in self._pending_actor_specs
                    if _env_key(s.runtime_env) == env_key)
            avail = dict(self.resources_available)
            bundle_avail: Dict[Tuple, Dict[str, float]] = {}
            for qt in islice(self._queue, 512):
                spec = qt.spec
                if _env_key(spec.runtime_env) != env_key:
                    continue
                demand = self._effective_demand(spec)
                pg = spec.scheduling.placement_group_id
                if pg is not None:
                    # PG tasks charge their bundle, not the node pool —
                    # simulated cumulatively too, else 64 queued tasks on a
                    # 1-CPU bundle all count as live demand
                    key = (pg, max(spec.scheduling.bundle_index, 0))
                    pool = bundle_avail.get(key)
                    if pool is None:
                        src = self._bundles.get(key)
                        if src is None:
                            continue
                        pool = bundle_avail[key] = dict(src)
                else:
                    pool = avail
                if all(pool.get(r, 0.0) + 1e-9 >= q
                       for r, q in demand.items()):
                    for r, q in demand.items():
                        pool[r] = pool.get(r, 0.0) - q
                    n += 1
            return n

    def _adopt_forked(self, pid: int, env_key: Optional[str]) -> None:
        """A template just forked worker `pid` for us: thread it into the
        startup pipeline exactly like a cold Popen (same registration
        adoption, same reaper poll, same spawn-lease refcount). Handles the
        race where the child registered before the fork reply was read."""
        from ray_tpu_torch.core.worker_pool import ForkedWorkerProc

        shim = ForkedWorkerProc(pid)
        with self._lock:
            # a NEW fork with pid P proves any older _starting entry for P
            # is dead (live pids are unique) — drop it now or the pid-keyed
            # _starting_env entry is overwritten and one env lease leaks
            stale = [p for p in self._starting if p.pid == pid]
            for p in stale:
                self._starting.remove(p)
            stale_env = self._starting_env.pop(pid, None) if stale else None
        if stale_env is not None:
            self._env_manager.release(stale_env)
        if env_key is not None:
            # spawn LEASE, mirroring the cold path: hold the env's refcount
            # until the worker registers (takes its own) or dies booting.
            # Taken BEFORE the shim is visible in _starting so registration
            # can never release it first (flock IO stays off the raylet
            # lock, same as the cold path).
            self._env_manager.acquire(env_key)
        with self._lock:
            raced = None
            for w in self._workers.values():
                if w.pid == pid:
                    # raced its own registration: it already took its env
                    # ref there; just give the handle a killable proc
                    raced = w
                    break
            if raced is None:
                self._starting.append(shim)
                if env_key is not None:
                    self._starting_env[pid] = env_key
                return
            if raced.proc is None:
                raced.proc = shim
        if env_key is not None:
            self._env_manager.release(env_key)  # return the unused lease

    def _maybe_spawn(self, env_key: Optional[str] = None,
                     runtime_env: Optional[dict] = None,
                     needed: int = 1) -> None:
        """Ask the warm pool to bring this env's worker count up to
        `needed` (an absolute backlog figure — the pool dedups against
        in-flight starts, so every scheduling pass during a worker's boot
        re-arming with the same count cannot overspawn). The pool serves
        it with template forks when it can, cold Popen spawns (bounded by
        maximum_startup_concurrency) when it can't."""
        if env_key is not None and \
                self._env_manager.creation_error(env_key) is not None:
            return  # creation already failed; don't respawn forever
        self._worker_pool.request(env_key, runtime_env, needed)

    def rpc_task_done(self, conn, req_id, payload):
        wid: WorkerID = payload["worker_id"]
        retiring = bool(payload.get("retiring"))
        with self._lock:
            w = self._workers.get(wid)
            if w is None:
                return True
            spec = w.current_task
            w.current_task = None
            grant, w.gpu_grant = w.gpu_grant, None
            if spec is not None:
                w.recent_done.append(
                    (spec.task_id, spec.owner_address, time.monotonic()))
            if retiring:
                # max_calls recycling: the worker exits after this notify.
                # Drop it NOW so no task is dispatched into the closing
                # process, and so its disconnect reads as clean (reference
                # worker_pool DisconnectWorker on max-calls exit).
                self._workers.pop(wid, None)
        # the card indices go back with the GPU count, under one hold of
        # the lock: a task scheduled on the count alone would find no free
        # index and run with get_gpu_ids() == []
        with self._lock:
            if grant is not None:
                self._release_gpus(*grant)
            if spec is not None:
                self._release_resources(spec)
        if retiring:
            if w.env_key:
                self._env_manager.release(w.env_key)
            # A retiring worker drains its ResultBuffer before os._exit, but
            # that final drain can fail against a transiently-down owner and
            # the clean pop above means no disconnect failover will fire.
            # After a grace exceeding the drain's WORST case (per-owner 2s
            # short-timeout reconnect plus the 5s in-flight wait — firing
            # mid-drain would spuriously retry a task that succeeded), send
            # the idempotent failover anyway: owners that got their results
            # no-op, an owner that lost them unsticks.
            entries = list(w.recent_done)
            if entries:
                grace = 10.0
                t = threading.Timer(
                    grace, lambda: self._failover_recent_done(
                        entries, extra_window=grace))
                t.daemon = True
                t.start()
            self._schedule()
            self._report_resources()
            return True
        # Completion fast lane: hand the next queued same-env task straight
        # to the just-freed worker. When the handoff consumed exactly what
        # the finished task released (the homogeneous deep-queue regime) no
        # other ticket became dispatchable, so the full _schedule() pass —
        # O(blocked-scan) policy evaluations per completion — is skipped.
        handed = self._try_handoff(w)
        if handed is not None and spec is not None and \
                self._effective_demand(spec) == self._effective_demand(handed) \
                and self._pool_key(spec) == self._pool_key(handed):
            # the handoff re-charged exactly the pool the finished task
            # released into: no other ticket became dispatchable
            self._report_resources()
            return True
        if handed is None:
            with self._lock:
                if w.actor_id is None and w.conn.alive:
                    # a pending actor spec of this env takes the worker
                    # before it pools: only fresh registrations claimed
                    # specs before, so a spec could coexist with an idle
                    # same-env worker forever (the warm pool's demand
                    # dedup counts that idle worker and spawns nothing)
                    if self._claim_pending_actor_spec(w) is None:
                        w.idle_since = time.monotonic()
                        self._idle_pools.setdefault(
                            w.env_key, deque()).append(wid)
        self._schedule()
        self._report_resources()
        return True

    @staticmethod
    def _pool_key(spec: TaskSpec):
        """Identity of the resource pool a task charges: None for the node
        pool, (pg_id, bundle) for a placement-group bundle. The handoff may
        only skip the full _schedule() pass when release and re-charge hit
        the SAME pool — equal demand dicts against different pools still
        leave freed capacity behind."""
        pg = spec.scheduling.placement_group_id
        return None if pg is None else (pg, max(spec.scheduling.bundle_index, 0))

    def _try_handoff(self, w: WorkerHandle) -> Optional[TaskSpec]:
        """Dispatch the HEAD queued task into the just-freed worker without
        a full _schedule() scan. Returns the dispatched spec, or None when
        the head needs anything the fast lane can't do (another env's pool,
        spilling to a peer, a spawn, infeasible resources) — then the caller
        falls back to the full pass, so behavior degrades to the old path
        rather than diverging from it."""
        with self._lock:
            # Liveness re-checked UNDER the lock: _on_worker_disconnect
            # serializes on it, so a worker whose disconnect already ran
            # (popped from _workers, current_task seen as None — nobody
            # would ever fail the task over) can't receive a dispatch here.
            if (w.actor_id is not None or not w.conn.alive
                    or self._workers.get(w.worker_id) is not w):
                return None
            if not self._queue:
                return None
            qt = self._queue[0]
            spec = qt.spec
            if _env_key(spec.runtime_env) != w.env_key:
                return None
            if w.env_key is not None and \
                    self._env_manager.creation_error(w.env_key) is not None:
                return None
            demand = self._effective_demand(spec)
            if not self._resources_ok(spec, demand):
                return None
            if self._choose_node(spec, qt.spillback_count) != self.node_id.hex():
                return None  # wants another node: let _schedule spill it
            self._queue.popleft()
            self._charge_resources(spec, demand)
            w.current_task = spec
            w.task_started = time.monotonic()
            gpu_amount = demand.get("GPU", 0.0)
            gpu_ids = self._assign_gpus(gpu_amount)
            w.gpu_grant = (gpu_ids, gpu_amount)
            w.conn.push("execute_task", {
                "spec": spec, "gpu_ids": gpu_ids or []})
            return spec

    # ---------------------------------------------------------------- actors
    def rpc_create_actor(self, conn, req_id, payload):
        """Push from GCS: lease a dedicated worker and instantiate."""
        spec = payload["spec"]
        ekey = _env_key(spec.runtime_env)
        if ekey is not None:
            env_err = self._env_manager.creation_error(ekey)
            if env_err is not None:
                self._gcs.notify("actor_failed", {
                    "actor_id": spec.actor_id, "reason": env_err,
                    "node_id": self.node_id.binary()})
                return True
        with self._lock:
            handle = self._acquire_worker(ekey)
            if handle is None:
                self._pending_actor_specs.append(spec)
                needed = sum(1 for s in self._pending_actor_specs
                             if _env_key(s.runtime_env) == ekey)
                self._maybe_spawn(ekey, spec.runtime_env, needed=needed)
                return True
            self._assign_actor(handle, spec)
        return True

    def _claim_pending_actor_spec(self, handle: WorkerHandle):
        """Caller holds self._lock. Hand the worker a pending actor spec of
        its runtime-env pool (assigning it as the actor) — the ONE claim
        policy shared by fresh registrations and workers going idle.
        Returns the claimed spec, or None."""
        for s in self._pending_actor_specs:
            if _env_key(s.runtime_env) == handle.env_key:
                self._pending_actor_specs.remove(s)
                self._assign_actor(handle, s)
                return s
        return None

    def _assign_actor(self, handle: WorkerHandle, spec) -> None:
        handle.actor_id = spec.actor_id
        # charge actor resources against the node (held for actor lifetime,
        # released on worker death/kill via _release_actor_charge)
        demand = dict(spec.resources)
        pg = spec.scheduling.placement_group_id
        key = None
        if pg is not None:
            key = (pg, max(spec.scheduling.bundle_index, 0))
            pool = self._bundles.get(key)
            if pool is None:
                key = None
                pool = self.resources_available
        else:
            pool = self.resources_available
        for r, q in demand.items():
            pool[r] = pool.get(r, 0.0) - q
        handle.actor_charge = (key, demand)
        gpu_amount = demand.get("GPU", 0.0)
        gpu_ids = self._assign_gpus(gpu_amount)
        handle.gpu_grant = (gpu_ids, gpu_amount)
        handle.conn.push("become_actor", {
            "spec": spec, "gpu_ids": gpu_ids or [],
            # the incarnation this worker instantiates (GCS-stamped at
            # dispatch): its replies carry it, fence checks compare to it
            "incarnation": getattr(spec, "incarnation", 0)})

    def _release_actor_charge(self, handle: WorkerHandle) -> None:
        charge = handle.actor_charge
        if charge is None:
            return
        handle.actor_charge = None
        if handle.gpu_grant is not None:
            self._release_gpus(*handle.gpu_grant)
            handle.gpu_grant = None
        key, demand = charge
        with self._lock:
            pool = self._bundles.get(key) if key is not None else self.resources_available
            if pool is None:
                return
            for r, q in demand.items():
                pool[r] = pool.get(r, 0.0) + q
        self._report_resources()

    def rpc_kill_actor_worker(self, conn, req_id, payload):
        actor_id = payload["actor_id"]
        with self._lock:
            target = None
            for w in self._workers.values():
                if w.actor_id == actor_id:
                    target = w
                    break
        if target is not None:
            target.actor_id = None  # suppress actor_failed report: this is a kill
            if target.proc is not None:
                try:
                    target.proc.kill()
                except (OSError, ProcessLookupError):
                    pass  # already exited
            else:
                try:
                    target.conn.push("exit", {})
                except (OSError, RuntimeError):
                    pass  # worker link already down; reaper will SIGKILL
        return True

    # ------------------------------------------------------------- placement
    def rpc_prepare_bundle(self, conn, req_id, payload):
        key = (payload["pg_id"], payload["bundle_index"])
        resources = payload["resources"]
        with self._lock:
            if key in self._bundles:
                # Idempotent re-prepare: a replacement head resuming an
                # interrupted 2-phase creation (or a client retry of the
                # create RPC) re-sends prepares the old head already made;
                # the reservation is held — re-charging it would leak. The
                # prepare clock RESTARTS (a creation is actively in flight
                # again — the orphan reaper must not fire mid-resume).
                if not self._bundles_committed.get(key):
                    self._bundle_prepared_at[key] = time.monotonic()
                return True
            if not all(self.resources_available.get(r, 0.0) + 1e-9 >= q
                       for r, q in resources.items()):
                return False
            for r, q in resources.items():
                self.resources_available[r] = self.resources_available.get(r, 0.0) - q
            self._bundles[key] = dict(resources)
            self._bundle_reservations[key] = dict(resources)
            self._bundles_committed[key] = False
            self._bundle_prepared_at[key] = time.monotonic()
        self._report_resources()
        return True

    def rpc_commit_bundle(self, conn, req_id, payload):
        key = (payload["pg_id"], payload["bundle_index"])
        with self._lock:
            self._bundles_committed[key] = True
            self._bundle_prepared_at.pop(key, None)
        return True

    def rpc_return_bundle(self, conn, req_id, payload):
        key = (payload["pg_id"], payload["bundle_index"])
        with self._lock:
            pool = self._bundles.pop(key, None)
            self._bundles_committed.pop(key, None)
            reserved = self._bundle_reservations.pop(key, None)
            self._bundle_prepared_at.pop(key, None)
            if pool is None:
                return True
        # return the bundle's whole original reservation to the node. An
        # actor still charged inside it (a kill is asynchronous: the
        # trainer kills its workers, then removes their group at once)
        # releases its charge later against the missing bundle, which drops
        # it: returning only what is left in the bundle would lose that
        # charge for the node's lifetime (PG removal implies its tasks are
        # done)
        resources = payload.get("resources") or reserved or pool
        with self._lock:
            for r, q in resources.items():
                self.resources_available[r] = self.resources_available.get(r, 0.0) + q
        self._report_resources()
        return True

    # ------------------------------------------------------------ object plane
    def rpc_obj_create(self, conn, req_id, payload):
        """Worker asks to allocate a segment it will write directly
        (file segments via writev — see _put_to_store; the reply's
        `recycled` flag reports whether the reuse pool served it, mostly
        for tests/diagnostics: a recycled segment's hot pages make the
        write run at memory bandwidth)."""
        object_id, size = payload["object_id"], payload["size"]
        info: dict = {}
        try:
            shm = self.store.create(object_id, size, info=info)
            name = shm.name
            shm.close()
            jid = payload.get("job_id")
            if jid is not None:
                # job attribution of the primary copy: a dead job's reap
                # deletes its objects by this index
                with self._lock:
                    self._obj_jobs[object_id] = jid
            return {"ok": True, "name": name,
                    "recycled": info.get("recycled", False)}
        except FileExistsError:
            return {"ok": False, "exists": True}
        except ObjectStoreFullError as e:
            # typed backpressure: the WORKER bounds its retry window
            # (put_full_timeout_s) — this handler runs on the rpc loop and
            # must not block on headroom itself. `fatal` short-circuits the
            # retry loop for objects that can never fit.
            return {"ok": False, "full": True,
                    "degraded": self.store.stats()["spill_degraded"],
                    "fatal": size > self.store.capacity,
                    "error": str(e)}

    def rpc_obj_seal(self, conn, req_id, payload):
        """Fire-and-forget on the put hot path (the single-writer seal
        piggybacks on the same ordered connection as obj_create, so a
        blocking round-trip buys nothing)."""
        self.store.seal(payload["object_id"])
        self._resolve_pulls(payload["object_id"])
        return True

    def rpc_obj_pin(self, conn, req_id, payload):
        """Pin a local sealed object for a zero-copy reader; reply is the
        authoritative (segment_name, size) or None. Issued as a CALL
        pipelined with the reader's optimistic attach: the reader only
        trusts its views once this reply confirms the name it attached —
        which makes segment recycling safe (a recycled inode can't match).
        Pins are tracked per connection and reaped if the reader dies."""
        loc = self.store.pin(payload["object_id"])
        if loc is not None:
            self._track_pin(conn, payload["object_id"])
        return loc

    def rpc_obj_unpin(self, conn, req_id, payload):
        """Notify: a reader's last view over the segment was GC'd (or its
        optimistic attach failed and this is the compensating release)."""
        oid = payload["object_id"]
        key = id(conn) if conn is not None else None
        with self._lock:
            m = self._conn_pins.get(key)
            if m is None or oid not in m:
                return True  # pin never landed (or already reaped): no-op
            m[oid] -= 1
            if m[oid] <= 0:
                m.pop(oid, None)
        self.store.unpin(oid)
        return True

    def _track_pin(self, conn, oid) -> None:
        key = id(conn) if conn is not None else None
        with self._lock:
            m = self._conn_pins.get(key)
            if m is None:
                m = self._conn_pins[key] = {}
                if conn is not None:
                    conn.on_close.append(
                        lambda c, k=key: self._reap_conn_pins(k))
            m[oid] = m.get(oid, 0) + 1
        if conn is not None and not getattr(conn, "alive", True):
            # the connection may have closed BEFORE our on_close append —
            # its callbacks already ran and will never fire again (a pin
            # taken for a deferred pull reply whose requester crashed
            # mid-pull). Reap now; _reap_conn_pins pops the map under the
            # lock, so racing with a late callback is idempotent.
            self._reap_conn_pins(key)

    def _reap_conn_pins(self, key: int) -> None:
        """A pinning reader's connection died: release everything it held
        (reference: plasma client disconnect releases its refs)."""
        with self._lock:
            m = self._conn_pins.pop(key, None)
        if not m:
            return
        for oid, count in m.items():
            for _ in range(count):
                self.store.unpin(oid)
        logger.debug("reaped %d pins from dead reader connection",
                     sum(m.values()))

    def rpc_obj_put_bytes(self, conn, req_id, payload):
        object_id = payload["object_id"]
        try:
            self.store.put_bytes(object_id, payload["data"])
        except FileExistsError:
            pass
        except ObjectStoreFullError as e:
            return {"ok": False, "full": True,
                    "degraded": self.store.stats()["spill_degraded"],
                    "fatal": len(payload["data"]) > self.store.capacity,
                    "error": str(e)}
        self._resolve_pulls(object_id)
        return True

    def rpc_obj_lookup(self, conn, req_id, payload):
        return self.store.lookup(payload["object_id"])

    def rpc_obj_delete(self, conn, req_id, payload):
        with self._lock:
            self._obj_jobs.pop(payload["object_id"], None)
        self.store.delete(payload["object_id"])
        # a pull parked on the (now unreachable) seal must not hang
        self._resolve_pulls(payload["object_id"], "object deleted")
        return True

    def rpc_obj_stats(self, conn, req_id, payload):
        return self.store.stats()

    def rpc_fetch_object(self, conn, req_id, payload):
        """Peer raylet requests the object bytes (single-shot transfer;
        small-object fast path — big objects go through the chunk RPCs).
        The copy into the reply frame is the wire's — read_bytes rides a
        pinned view, no extra staging."""
        data = self.store.read_bytes(payload["object_id"])
        return data  # None if not here

    def rpc_fetch_object_meta(self, conn, req_id, payload):
        """Size probe before a chunked pull (cf. reference object directory);
        carries the data-plane address so the puller can ride raw sockets."""
        loc = self.store.lookup(payload["object_id"])
        if loc is None:
            return None
        return {"size": loc[1], "data_addr": self._data_plane.address,
                "segment": loc[0], "hostname": _socket_mod.gethostname()}

    def rpc_data_plane_addr(self, conn, req_id, payload):
        return self._data_plane.address

    def rpc_fetch_object_chunk(self, conn, req_id, payload):
        """Serve one bounded slice of a sealed object, read straight out of
        the shm segment — the sender never materializes the whole object
        (reference ObjectBufferPool chunk reads, object_manager.proto:61).
        Pinned for the read so memory pressure can't spill the segment
        between a peer's chunks (each spill would cost a full restore)."""
        with self.store.pinned_view(payload["object_id"]) as buf:
            if buf is None:
                return None
            off = payload["offset"]
            ln = payload["length"]
            return bytes(buf.view[off:off + ln])

    def rpc_pull_object(self, conn, req_id, payload):
        """Worker asks: make object local, reply (name,size) when done.

        `source` is the raylet address believed to hold a copy (from the
        owner's location table, cf. OwnershipBasedObjectDirectory).
        """
        object_id: ObjectID = payload["object_id"]
        pin = bool(payload.get("pin"))
        if pin:
            loc, reason = self.store.pin_ex(object_id)
            if loc is not None:
                self._track_pin(conn, object_id)
                return loc
            if reason == "pin_cap":
                # resident, but indefinite reader pins are at the
                # max_pinned_fraction cap: grant a TRANSIENT pin with a
                # copy-only marker — the reader copies out inside a bounded
                # window and unpins, instead of wedging the store (or
                # spuriously reporting the object lost)
                loc = self.store.pin(object_id, transient=True)
                if loc is not None:
                    self._track_pin(conn, object_id)
                    return (loc[0], loc[1], "copy_only")
        else:
            loc = self.store.lookup(object_id)
            if loc is not None:
                return loc
        with self._lock:
            waiters = self._pending_pulls.setdefault(object_id, [])
            waiters.append((conn, req_id, pin))
            first = len(waiters) == 1
        if first:
            t = threading.Thread(
                target=self._do_pull, args=(object_id, payload.get("source")),
                daemon=True)
            t.start()
        return rpc.RpcServer.DEFERRED

    def _do_pull(self, object_id: ObjectID, source: Optional[str]) -> None:
        err = None
        try:
            if source and source != self._server.address:
                peer = self._peer(source)
                cfg = get_config()
                chunk = cfg.object_transfer_chunk_size_bytes
                meta = peer.call("fetch_object_meta", {"object_id": object_id},
                                 timeout=30)
                if meta is None:
                    err = f"object {object_id} not found at {source}"
                elif self._try_adopt_local(object_id, meta, peer):
                    pass  # same-host kernel-side copy succeeded
                elif meta["size"] <= chunk:
                    # small objects NEVER wait on the pull budget: a 2 MiB
                    # fetch queuing FIFO behind a multi-GiB admission ticket
                    # would turn milliseconds into tens of seconds
                    data = peer.call("fetch_object", {"object_id": object_id},
                                     timeout=cfg.object_transfer_chunk_timeout_s)
                    if data is not None:
                        try:
                            # bounded wait for headroom: this thread may
                            # block, the rpc loop does not
                            self.store.put_bytes(
                                object_id, data,
                                timeout_s=min(cfg.put_full_timeout_s, 5.0))
                        except FileExistsError:
                            pass
                        except ObjectStoreFullError as e:
                            err = f"pull target store full: {e}"
                    else:
                        err = f"object {object_id} not found at {source}"
                else:
                    err = self._pull_chunked(peer, object_id, meta["size"],
                                             meta.get("data_addr"))
            else:
                # source is THIS raylet (or unknown) and lookup missed: a
                # local producer may have created-but-not-yet-sealed the
                # segment (seal is a fire-and-forget notify on the put fast
                # path) — wait for the seal, BOUNDED so a writer that died
                # mid-put can't park the waiters forever.
                if self.store.status(object_id) == "unsealed":
                    deadline = (time.monotonic()
                                + get_config().object_transfer_chunk_timeout_s)
                    while time.monotonic() < deadline:
                        if self.store.status(object_id) != "unsealed":
                            break
                        with self._lock:
                            if object_id not in self._pending_pulls:
                                return  # seal/delete already resolved them
                        time.sleep(0.05)
                    if self.store.contains(object_id):
                        self._resolve_pulls(object_id)
                        return
                    err = f"object {object_id} was created but never sealed"
                else:
                    err = f"no source for object {object_id}"
        except Exception as e:
            err = f"pull failed: {e}"
        self._resolve_pulls(object_id, err)

    def _try_adopt_local(self, object_id: ObjectID, meta: dict,
                         peer: rpc.RpcClient) -> bool:
        """Same-host fast path: the source raylet shares this machine's
        /dev/shm, so 'transfer' is a kernel-side copy_file_range of the
        segment file (no sockets, no fault-zeroing). False → fall through
        to the data-plane/RPC pull paths."""
        seg = meta.get("segment")
        if (not seg or seg.startswith("@")
                or meta.get("hostname") != _socket_mod.gethostname()):
            return False  # cheap rejections BEFORE touching the pull budget
        size = meta["size"]
        # small copies are instant — admission control only gates sizes that
        # could meaningfully overcommit store memory
        gate = size > get_config().object_transfer_chunk_size_bytes
        if gate:
            self._pull_budget.acquire(size)
        try:
            ok = self.store.adopt_local_copy(object_id, seg, size)
            if ok and not self._adopt_source_stable(peer, object_id, seg):
                # the source store may RECYCLE a deleted segment's inode
                # (reuse pool) — an adopt that raced the delete could have
                # copied overwritten bytes. The source re-confirming the
                # same (object, segment) AFTER our copy proves the entry
                # was live for the whole window; otherwise discard.
                self.store.delete(object_id)
                return False
            return ok
        except FileExistsError:
            return False  # concurrent materialization: chunked path waits on it
        except Exception:
            logger.warning("same-host adopt of %s failed; falling back",
                           object_id, exc_info=True)
            return False
        finally:
            if gate:
                self._pull_budget.release(size)

    @staticmethod
    def _adopt_source_stable(peer: rpc.RpcClient, object_id: ObjectID,
                             seg: str) -> bool:
        """Post-copy verification for the same-host adopt fast path: the
        source still holds `object_id` in the SAME segment AFTER our
        kernel-side copy. True means no delete (and so no inode recycle)
        could have raced the copy window."""
        try:
            meta = peer.call("fetch_object_meta", {"object_id": object_id},
                             timeout=10)
        except Exception:
            return False
        return meta is not None and meta.get("segment") == seg

    def _pull_chunked(self, peer: rpc.RpcClient, object_id: ObjectID,
                      size: int, data_addr: Optional[str] = None) -> Optional[str]:
        """Materialize a big object directly into a pre-created shm segment,
        sealing when complete (reference ObjectManager chunk pulls) — peak
        extra memory is bounded, never 2x the object. Preferred path: striped
        raw-socket fetch over the peer's data plane (shm->kernel->shm, no
        serialization); fallback: pipelined RPC chunks.

        Returns an error string, or None on success."""
        cfg = get_config()
        self._pull_budget.acquire(size)
        try:
            try:
                shm = self.store.create_blocking(
                    object_id, size, min(cfg.put_full_timeout_s, 5.0))
            except ObjectStoreFullError as e:
                return f"pull target store full: {e}"
            except FileExistsError:
                # A local producer (e.g. lineage re-execution) or another pull
                # beat us to the entry — but it may be UNSEALED; report success
                # only once it seals, else waiters get a spurious lost-object.
                deadline = time.monotonic() + cfg.object_transfer_chunk_timeout_s
                while time.monotonic() < deadline:
                    if self.store.contains(object_id):
                        return None
                    time.sleep(0.05)
                return f"local copy of {object_id} never sealed"
            ok = False
            err = None
            try:
                if data_addr:
                    err = self._pull_data_plane(data_addr, object_id, size, shm)
                    ok = err is None
                    if not ok:
                        logger.warning(
                            "data-plane pull of %s from %s failed (%s); "
                            "falling back to RPC chunks", object_id,
                            data_addr, err)
                if not ok:
                    err = self._pull_rpc_chunks(peer, object_id, size, shm)
                    ok = err is None
            finally:
                shm.close()
                if not ok:
                    self.store.delete(object_id)  # discard partial segment
            if not ok:
                return err
            self.store.seal(object_id)
            return None
        finally:
            self._pull_budget.release(size)

    def _pull_data_plane(self, data_addr: str, object_id: ObjectID,
                         size: int, shm) -> Optional[str]:
        """Parallel-range pull: the object splits into N CONTIGUOUS ranges,
        one persistent raw socket streaming each straight into its slice of
        the destination segment — a single request/response round trip per
        stream, so the sender never idles between chunks (per-chunk RPCs
        would stall a full RTT every 16 MiB). The GIL releases during the
        kernel copies, so streams genuinely overlap; stream count adapts to
        the host's cores (extra streams on one core just thrash the GIL)."""
        cfg = get_config()
        n_streams = max(1, min(cfg.object_transfer_parallel_streams,
                               os.cpu_count() or 1,
                               size // (8 << 20) or 1))
        dest = memoryview(shm.buf)
        # 1 MiB-aligned contiguous ranges
        step = -(-size // n_streams)
        step = (step + ((1 << 20) - 1)) & ~((1 << 20) - 1)
        ranges = [(off, min(step, size - off))
                  for off in range(0, size, step)]

        def stripe(off: int, ln: int) -> None:
            client = None
            broken = False
            try:
                client = self._data_pool.acquire(data_addr)
                if not client.fetch_into(object_id, off, ln,
                                         dest[off:off + ln]):
                    raise ConnectionError(f"object gone at {data_addr}")
            except Exception:
                broken = True
                raise
            finally:
                if client is not None:
                    self._data_pool.release(client, broken=broken)

        from ray_tpu_torch.core.data_plane import fan_out

        errors = fan_out([lambda r=r: stripe(*r) for r in ranges],
                         timeout=cfg.object_transfer_chunk_timeout_s * 2)
        return errors[0] if errors else None

    def _pull_rpc_chunks(self, peer: rpc.RpcClient, object_id: ObjectID,
                         size: int, shm) -> Optional[str]:
        """Fallback: pipelined chunk fetch over the control RPC channel."""
        cfg = get_config()
        chunk = cfg.object_transfer_chunk_size_bytes
        inflight: deque = deque()
        offset = 0
        while offset < size or inflight:
            while (offset < size
                   and len(inflight) < cfg.object_transfer_inflight_chunks):
                ln = min(chunk, size - offset)
                inflight.append((offset, ln, peer.call_future(
                    "fetch_object_chunk",
                    {"object_id": object_id, "offset": offset,
                     "length": ln})))
                offset += ln
            off, ln, fut = inflight.popleft()
            data = fut.result(timeout=cfg.object_transfer_chunk_timeout_s)
            if data is None or len(data) != ln:
                return (f"chunk at {off} of {object_id} unavailable "
                        f"at {peer.address}")
            shm.buf[off:off + ln] = data
        return None

    def rpc_push_object(self, conn, req_id, payload):
        """Owner-directed push (reference push_manager.h:29): stream a
        locally-held object into target raylets' stores so N readers don't
        all serialize on one source copy. Each completed delivery registers
        the new location with the owner, making it immediately pullable."""
        threading.Thread(
            target=self._push_to_targets,
            args=(payload["object_id"], list(payload.get("targets", ())),
                  payload.get("owner_address", "")),
            name="obj-push", daemon=True).start()
        return True

    def _push_to_targets(self, object_id: ObjectID, targets: List[str],
                         owner: str) -> None:
        # pinned for the whole fan-out: a spill mid-push would unlink the
        # segment under N concurrent streams
        with self.store.pinned_view(object_id) as buf:
            if buf is None:
                logger.warning("push of %s requested but object not local",
                               object_id)
                return
            src = memoryview(buf.view)

            def push_one(target: str) -> None:
                client = None
                broken = False
                try:
                    data_addr = self._peer(target).call(
                        "data_plane_addr", {}, timeout=10)
                    client = self._data_pool.acquire(data_addr)
                    try:
                        outcome = client.push_from(object_id, src)
                    except Exception:
                        broken = True
                        raise
                    finally:
                        self._data_pool.release(client, broken=broken)
                    # register ONLY delivered copies: a SKIP may mean a
                    # concurrent unsealed create that later fails — the
                    # target's own pull registers itself when it seals
                    if owner and outcome == "ok":
                        # one-shot notify; owner-side registration is
                        # idempotent and best-effort (pull still works
                        # through the primary copy if this is lost)
                        c = rpc.connect_with_retry(owner, timeout=5)
                        try:
                            c.notify("add_object_location",
                                     {"object_id": object_id,
                                      "raylet": target})
                        finally:
                            c.close()
                except Exception as e:
                    logger.warning("push of %s to %s failed: %s",
                                   object_id, target, e)

            from ray_tpu_torch.core.data_plane import fan_out

            fan_out([lambda t=t: push_one(t) for t in targets],
                    timeout=get_config().object_transfer_chunk_timeout_s * 4)

    def _resolve_pulls(self, object_id: ObjectID, err: Optional[str] = None) -> None:
        with self._lock:
            waiters = self._pending_pulls.pop(object_id, [])
        if not waiters:
            return
        loc = self.store.lookup(object_id)
        for conn, req_id, pin in waiters:
            if pin:
                # pin BEFORE the reply so the object can't evict (or its
                # segment recycle) in the reply->attach window — cross-node
                # pulls land sealed-and-pinnable. A pin that misses means
                # the object vanished again: error, the reader re-pulls.
                pinned, reason = self.store.pin_ex(object_id)
                if pinned is None and reason == "pin_cap":
                    # at the max_pinned_fraction cap: transient copy-only
                    # grant, same contract as rpc_pull_object's cap path
                    pinned = self.store.pin(object_id, transient=True)
                    if pinned is not None:
                        pinned = (pinned[0], pinned[1], "copy_only")
                if pinned is not None:
                    self._track_pin(conn, object_id)
                    conn.reply(req_id, pinned)
                else:
                    conn.reply(req_id,
                               err or f"object {object_id} unavailable",
                               is_error=True)
            elif loc is not None:
                conn.reply(req_id, loc)
            else:
                conn.reply(req_id, err or f"object {object_id} unavailable", is_error=True)

    # ------------------------------------------------------------------ info
    def rpc_node_info(self, conn, req_id, payload):
        with self._lock:
            return {
                "node_id": self.node_id.binary(),
                "address": self._server.address,
                "resources_total": dict(self.resources_total),
                "resources_available": dict(self.resources_available),
                "labels": dict(self.labels),
                "num_workers": len(self._workers),
                "queued_tasks": len(self._queue),
            }
