"""CoreWorker: per-process runtime for drivers and workers.

Equivalent of the reference's `CoreWorker` (`src/ray/core_worker/
core_worker.h:284`) + its Cython binding (`python/ray/_raylet.pyx:1730`):
task submission, the ownership table with reference counting
(`reference_count.h:61` — semantics re-implemented, not translated), object
put/get against the two-tier store, task retries, the direct actor transport
(per-caller sequence numbers, `transport/sequential_actor_submit_queue.h`),
and the execution loop that runs user functions in worker processes
(`_raylet.pyx:718 execute_task`).

Every process (driver or worker) hosts a core-worker RPC server; results are
pushed directly from executor to owner (ownership-based result routing), and
borrowers talk to owners for locations — raylets only handle scheduling and
the node-local object store.
"""

from __future__ import annotations

import asyncio
import heapq
import inspect
import logging
import os
import queue
import random
import threading
import time
import traceback
import weakref
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ray_tpu_torch.core import rpc, serialization
from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.exceptions import (
    ActorDiedError,
    GetTimeoutError,
    ObjectLostError,
    ObjectStoreFullError,
    OwnerDiedError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)
from ray_tpu_torch.core.function_table import FunctionTableClient
from ray_tpu_torch.core.ids import ActorID, JobID, ObjectID, TaskID, WorkerID, _TaskIDCounter
from ray_tpu_torch.core.task_events import TaskEventBuffer
from ray_tpu_torch.util import tracing
from ray_tpu_torch.core.object_store import attach_object
from ray_tpu_torch.core.object_ref import ObjectRef, ObjectRefGenerator
from ray_tpu_torch.core.serialization import SerializedObject
from ray_tpu_torch.core.task_spec import (
    ActorCreationSpec,
    TaskSpec,
    TaskType,
)

logger = logging.getLogger(__name__)

_current_worker: Optional["CoreWorker"] = None
_worker_lock = threading.Lock()


def current_worker() -> Optional["CoreWorker"]:
    return _current_worker


def set_current_worker(w: Optional["CoreWorker"]) -> None:
    global _current_worker
    with _worker_lock:
        _current_worker = w


def _send_unpin(worker_ref, oid) -> None:
    """weakref.finalize target for zero-copy reader views: module-level so
    the finalizer holds no strong reference to the worker — a leaked view
    must never keep a shut-down CoreWorker (and its sockets) alive."""
    w = worker_ref()
    if w is None or w._shutdown.is_set():
        return  # raylet-side conn-close reaping covers this case
    try:
        w.raylet.notify("obj_unpin", {"object_id": oid})
    except Exception:
        pass  # raylet gone: its store died with it


_cuda_cards: Optional[int] = None

# A closed borrower connection's borrows are released this long after the
# close: the borrower's owner link reconnects and replays its live borrows
# (`ReferenceCounter._replay_borrows`), and a replay that lands after the
# object's free finds nothing to borrow (ROADMAP C.7). A borrower that died
# never replays, and its objects go this much later. The reconnect
# backoff's cap (`reconnect_backoff_cap_ms`).
BORROW_RECONNECT_WINDOW_S = 10.0


def _select_granted_gpu(gpu_ids: List[int]) -> None:
    """Make the grant's first card this thread's current CUDA device, so a
    task's CUDA work, and the CUDA tensors it gets, land on the card it was
    granted. Only a granted worker touches CUDA (and so makes a context);
    nothing happens without torch, without CUDA, or for an index the
    process cannot see (a resource declared beyond the node's cards)."""
    global _cuda_cards
    if not gpu_ids:
        return
    if _cuda_cards is None:
        import importlib.util

        if importlib.util.find_spec("torch") is None:
            _cuda_cards = 0
        else:
            import torch

            _cuda_cards = (torch.cuda.device_count()
                           if torch.cuda.is_available() else 0)
    if gpu_ids[0] < _cuda_cards:
        import torch

        torch.cuda.set_device(gpu_ids[0])


# ---------------------------------------------------------------------------


@dataclass
class _ObjectState:
    """Owner-side record for one owned object."""

    state: str = "pending"          # pending | inline | plasma | error
    inline_blob: Optional[bytes] = None
    location: Optional[str] = None  # raylet address holding the primary copy
    extra_locations: List[str] = field(default_factory=list)  # pulled copies
    size: int = 0
    # (segment_name, attach_size) of the primary copy at `location`: lets a
    # co-located reader attach the shm segment directly — no pull_object
    # round-trip (stale after spill/restore; readers fall back and re-learn)
    segment: Optional[Tuple[str, int]] = None
    local_refs: int = 0
    borrowers: int = 0
    submitted_task_deps: int = 0    # in-flight tasks depending on this object
    shipped: bool = False           # a ref to this object was serialized out
    container_pinned: int = 0       # live owned containers holding our ref
    contained_pins: List["ObjectID"] = field(default_factory=list)  # inner oids we pin
    contained_borrows: List = field(default_factory=list)  # counted refs we borrow
    free_after: Optional[float] = None  # deferred-free deadline (monotonic)
    waiters: List[Tuple] = field(default_factory=list)  # (conn, req_id) info waiters
    callbacks: List[Callable] = field(default_factory=list)  # done callbacks


class ReferenceCounter:
    """Ownership + borrowed reference tracking (reference semantics of
    `src/ray/core_worker/reference_count.h`). Borrows are registered with
    the owner at deserialization time over a per-owner reconnecting link
    and are CONNECTION-SCOPED on the owner (a dead borrower's dropped link
    releases them — the reference's WaitForRefRemoved liveness role — and
    a reconnect replays live borrows). Transitive borrowers register with
    the owner directly rather than through per-hop borrow tables."""

    def __init__(self, worker: "CoreWorker"):
        self._worker = worker
        self._borrowed: Dict[ObjectID, dict] = {}
        # one reconnecting link per owner: borrow registrations ride it, and
        # on every fresh connection the live borrows are REPLAYED — so a
        # transient drop (which the owner treats as borrower death and
        # releases) re-establishes the borrow instead of silently losing it
        self._owner_links: Dict[str, rpc.ReconnectingClient] = {}
        self._lock = threading.RLock()

    def owner_link(self, owner: str) -> rpc.ReconnectingClient:
        with self._lock:
            link = self._owner_links.get(owner)
            if link is None or link.closed:
                link = rpc.ReconnectingClient(
                    owner,
                    on_reconnect=lambda raw, o=owner: self._replay_borrows(o, raw),
                    origin=self._worker.raylet_address)
                self._owner_links[owner] = link
            return link

    def _replay_borrows(self, owner: str, raw: "rpc.RpcClient") -> None:
        with self._lock:
            oids = [oid for oid, e in self._borrowed.items()
                    if e["owner"] == owner and e["count"] > 0]
        for oid in oids:
            raw.notify("add_borrower", {"object_id": oid})

    def close(self) -> None:
        with self._lock:
            links, self._owner_links = list(self._owner_links.values()), {}
        for link in links:
            link.close()

    def add_borrowed(self, ref: ObjectRef) -> None:
        w = self._worker
        if ref.owner_address == w.address:
            return  # we own it
        with self._lock:
            e = self._borrowed.get(ref.id)
            if e is None:
                self._borrowed[ref.id] = {"count": 1, "owner": ref.owner_address, "registered": False}
                self._register_borrow(ref)
            else:
                e["count"] += 1

    def _register_borrow(self, ref: ObjectRef) -> None:
        if not ref.owner_address:
            return
        try:
            self.owner_link(ref.owner_address).notify(
                "add_borrower", {"object_id": ref.id})
            self._borrowed[ref.id]["registered"] = True
        except Exception:
            # NOT silent: an unregistered borrow leaves only the owner's
            # free-grace window protecting the object; the reconnect replay
            # re-attempts, and lineage recovery backstops the loss
            logger.debug("borrow registration for %s with %s failed",
                         ref.id, ref.owner_address, exc_info=True)

    def remove_local(self, ref: ObjectRef) -> None:
        # The full decrement/pop happens under the lock; only the (idempotent)
        # owner notification runs outside it, so concurrent removers can never
        # interleave on the same entry (reference holds its mutex across the
        # whole RemoveLocalReference body, reference_count.h:109).
        notify_owner = None
        with self._lock:
            e = self._borrowed.get(ref.id)
            if e is not None:
                e["count"] -= 1
                if e["count"] <= 0:
                    self._borrowed.pop(ref.id, None)
                    if e.get("registered"):
                        notify_owner = e["owner"]
        if e is None:
            self._worker._remove_owned_local_ref(ref.id)
        elif notify_owner is not None:
            # Off-thread: remove_local runs from ObjectRef.__del__, and
            # peer() can block up to rpc_connect_timeout_s reconnecting to a
            # dead owner — never stall whatever thread triggered the GC.
            self._worker._notify_owner_async(
                notify_owner, "remove_borrower", {"object_id": ref.id})


# ---------------------------------------------------------------------------


class CoreWorker:
    def __init__(
        self,
        mode: str,                       # "driver" | "worker"
        raylet_address: str,
        gcs_address: str,
        job_id: Optional[JobID] = None,
        host: str = "127.0.0.1",
        connect_timeout: Optional[float] = None,
        log_to_driver: bool = True,
    ):
        self.mode = mode
        self.log_to_driver = log_to_driver
        self.worker_id = WorkerID.from_random()
        self.job_id = job_id or JobID.from_random()
        self.raylet_address = raylet_address
        self.gcs_address = gcs_address

        self._server = rpc.RpcServer(host)
        self._server.register_all(self)
        self._server.start()

        self.reference_counter = ReferenceCounter(self)
        self._objects: Dict[ObjectID, _ObjectState] = {}
        self._obj_lock = threading.RLock()
        self._obj_cv = threading.Condition(self._obj_lock)

        # Lineage table (cf. reference object_recovery_manager.h:41): the
        # creating TaskSpec of every owned task output, retained even after
        # the object's data is freed so a lost primary can be recomputed.
        # Insertion-ordered; FIFO-evicted at lineage_table_max_entries.
        self._lineage: Dict[ObjectID, TaskSpec] = {}
        self._lineage_attempts: Dict[TaskID, int] = {}
        # per-task record of arg pins actually taken (guarded by _obj_lock)
        self._task_pins: Dict[TaskID, List[ObjectID]] = {}
        # application pubsub subscriptions (channel -> callbacks)
        self._channel_callbacks: Dict[str, List[Callable]] = {}
        self._channel_cb_lock = threading.Lock()
        # streaming (num_returns="dynamic") tasks we own: task id ->
        # {"refs": [ObjectRef...], "done": bool, "error": Exception|None}
        # (guarded by _obj_lock; _obj_cv signals arrivals)
        self._dynamic_returns: Dict[TaskID, dict] = {}
        # dynamic return ids with lineage entries, for whole-task eviction
        self._task_dynamic_ids: Dict[TaskID, List[ObjectID]] = {}

        # borrows keyed by the borrower's server connection (see
        # rpc_add_borrower): conn id -> {object_id: count}
        self._conn_borrows: Dict[int, Dict[ObjectID, int]] = {}
        # objects whose local pulled copy we already announced to the owner
        from collections import OrderedDict

        self._registered_copies: "OrderedDict[ObjectID, bool]" = OrderedDict()
        self._registered_copies_lock = threading.Lock()
        # zero-copy object plane: worker-side location cache of local
        # (segment_name, attach_size) per object — repeat gets of a hot
        # object skip owner resolution AND pull_object entirely (validated
        # by the pin-confirm protocol, so a stale entry can only cost a
        # fallback, never wrong data)
        self._seg_cache: "OrderedDict[ObjectID, Tuple[str, int]]" = OrderedDict()
        self._seg_cache_lock = threading.Lock()
        # writer-side mapping cache: segment name -> persistent writable
        # mmap. The store's reuse pool hands the same segments back to hot
        # writers; writing through a mapping whose page tables are already
        # populated runs at memory bandwidth (~2x the writev path, ~10x a
        # fresh mapping's zero-fault+copy). Bounded LRU (entries + bytes).
        self._write_maps: "OrderedDict[str, Any]" = OrderedDict()
        self._write_maps_bytes = 0
        self._write_maps_lock = threading.Lock()
        # shared outstanding wait-futures: (owner, oid) -> Future (LRU-capped)
        self._wait_futures: "OrderedDict[tuple, Any]" = OrderedDict()
        self._wait_futures_lock = threading.Lock()

        # grace-deferred plasma frees (see _maybe_free)
        self._deferred_frees: deque = deque()
        # owned refs nested in an inline actor-creation argument, by actor:
        # pinned until the actor is ALIVE or DEAD (_pin_for_creation)
        self._creation_pins: Dict[ActorID, List[ObjectID]] = {}
        self._creation_lock = threading.Lock()
        self._creation_watcher: Optional[threading.Thread] = None
        self._free_sweeper: Optional[threading.Thread] = None
        # background owner notifications (ref releases from __del__)
        self._owner_notify_q: "queue.Queue[Tuple[str, str, dict]]" = queue.Queue()
        self._owner_notify_thread: Optional[threading.Thread] = None
        self._owner_notify_lock = threading.Lock()

        self._task_counter = _TaskIDCounter(self.worker_id)
        self._put_counter = 0
        self._put_lock = threading.Lock()
        # Root task id for the process; per-execution-thread ids live in TLS
        # so concurrent actor methods attribute puts correctly.
        self._root_task_id = TaskID(self.worker_id.binary())
        self._tls = threading.local()

        self._peers: Dict[str, rpc.RpcClient] = {}
        self._peers_lock = threading.Lock()

        # Delayed resubmits (task retries) ride ONE shared timer thread
        # instead of one threading.Timer per retry: a burst of failed tasks
        # must not fork hundreds of timer threads. Heap of
        # (due_monotonic, seq, spec); seq breaks ties (specs don't compare).
        self._resubmit_heap: list = []
        self._resubmit_cv = threading.Condition()
        self._resubmit_thread: Optional[threading.Thread] = None
        self._resubmit_seq = 0

        # pending task specs for retry: task_id -> [spec, retries_left].
        # Touched by user threads (submit), the RPC reader (results, death
        # notifications) and the GCS push thread (actor death fan-out), so all
        # compound read-modify-write goes through _pending_lock.
        self._pending_tasks: Dict[TaskID, list] = {}
        self._pending_lock = threading.Lock()
        # node-level failure domain: last known node (binary id) a pending
        # task was spilled to. A raylet that spills a task notifies the
        # owner (rpc_task_spilled); when the GCS announces that node's death
        # on the nodes channel — or a post-reconnect reconciliation finds it
        # gone — the owner fails the task over exactly as if the raylet had
        # pushed task_worker_died (the raylet is dead and never will).
        # Guarded by _pending_lock; entries die with their pending entry.
        self._task_locations: Dict[TaskID, bytes] = {}
        # workers subscribe to the nodes channel LAZILY, on their first
        # spill notification — most (and every warm-forked) worker never
        # owns a spilled task, and an eager subscribe would put a blocking
        # GCS RPC + a permanent fan-out target on the ~1 ms fork hot path.
        # Drivers subscribe eagerly at registration. Guarded by
        # _pending_lock.
        self._nodes_subscribed = False
        # two-strike absence tracking for the post-reconnect reconciliation:
        # a node missing from get_all_nodes may simply not have re-registered
        # yet, so only a node absent across two spaced checks fails over.
        self._absent_nodes: set = set()

        # --- cancellation (job failure domain) ---
        # Owner side: ids cancel() claimed while the task was still pending.
        # Makes double-cancel idempotent, suppresses every retry path, and
        # demotes a LATE success report to the typed error so a cancelled
        # ref resolves deterministically. Guarded by _pending_lock.
        self._cancelled_tasks: Dict[TaskID, float] = {}
        # Executor side: ids cancelled before/while queued in THIS process
        # (the actor-mailbox purge — _execute_task raises instead of
        # running them) + the thread currently executing each task (the
        # cooperative-interrupt injection target). Own lock: cancel pushes
        # arrive on RPC reader threads while exec threads mutate the map.
        self._cancel_lock = threading.Lock()
        self._cancelled_exec: set = set()
        self._exec_thread_ids: Dict[TaskID, int] = {}

        # actor state (when this worker hosts an actor)
        self.actor_id: Optional[ActorID] = None
        self._actor_instance: Any = None
        self._actor_creation_spec: Optional[ActorCreationSpec] = None
        # the incarnation THIS process instantiates (GCS-stamped restart
        # count at dispatch): replies carry it, and calls resolved against
        # a different incarnation are refused (partition failure domain —
        # a superseded instance must never service a call)
        self._actor_incarnation: int = 0
        self._actor_seq_lock = threading.Lock()
        self._actor_next_seq: Dict[bytes, int] = {}       # caller -> expected seq
        self._actor_ooo_buffer: Dict[bytes, Dict[int, TaskSpec]] = {}

        # actor submission (when this worker calls actors)
        self._actor_seq_counters: Dict[ActorID, int] = {}
        self._actor_addresses: Dict[ActorID, str] = {}
        # incarnation the address above was learned WITH: stamped into
        # every outgoing actor task so the target can fence a stale handle
        # (or discover it is itself superseded)
        self._actor_incarnations: Dict[ActorID, int] = {}
        self._actor_dead: Dict[ActorID, str] = {}
        self._actor_cv = threading.Condition()  # pubsub wakes address waits
        # fenced-call resends (target refused our incarnation): bounded per
        # task so a confused topology can't ping-pong a call forever
        self._fence_resends: Dict[TaskID, int] = {}
        # late replies dropped for carrying a superseded incarnation
        self.stale_reply_rejections = 0

        # execution
        self._registered = threading.Event()
        self._task_queue: "queue.Queue[TaskSpec]" = queue.Queue()
        # actor concurrency groups: name -> dedicated queue (reference
        # actor.py:65; threads started in _init_actor)
        self._group_queues: Dict[str, "queue.Queue[TaskSpec]"] = {}
        # default-pool threads (group pools track nothing: their threads
        # are daemons sized once at creation)
        self._default_exec_threads: List[threading.Thread] = []
        self._executing_count = 0
        self._fn_call_counts: Dict[int, int] = {}
        # GPU indices granted by the raylet (get_gpu_ids surface)
        self._task_gpu_ids: Dict[TaskID, List[int]] = {}
        # tracing: raylet dispatch stamps awaiting execution (epoch us)
        self._task_dispatch_us: Dict[TaskID, float] = {}
        self._actor_gpu_ids: List[int] = []
        # executing+queued actor tasks excluding control-plane probes, so a
        # load reading is never inflated by the health checks that sample it
        self._load_count = 0
        self._exec_count_lock = threading.Lock()
        self._exec_threads_lock = threading.Lock()
        self._shutdown = threading.Event()
        # optional submission-side instrumentation: called with each
        # outgoing TaskSpec (microbenchmark wire-bytes probe); None = off
        self._spec_bytes_probe = None

        # origin = OUR RAYLET's address: workers and drivers belong to
        # their node for partition purposes, so cutting a node group also
        # blackholes its workers' control-plane and peer traffic
        self.raylet = rpc.connect_with_retry(
            raylet_address, push_handler=self._on_raylet_push,
            timeout=connect_timeout or get_config().rpc_connect_timeout_s,
            origin=raylet_address)
        # Reconnecting control-plane link: survives a GCS restart by
        # re-registering this process's durable facts (job, subscriptions,
        # hosted actor) on every fresh connection. The resolver follows a
        # REPLACEMENT head to a new address: the address file when
        # configured, else this node's raylet (whose own reconnect loop
        # tracks the head) answers get_gcs_address.
        self.gcs = rpc.ReconnectingClient(
            gcs_address, push_handler=self._on_gcs_push,
            on_reconnect=self._replay_gcs_state,
            resolve=self._resolve_gcs_address,
            origin=raylet_address)

        # task-path fast lanes: export-once function table + batched
        # task-event/profile shipping (both ride self.gcs)
        self.function_table = FunctionTableClient(self)
        self.task_events = TaskEventBuffer(self)
        # completion-path fast lane: per-owner batched result delivery
        from ray_tpu_torch.core.result_buffer import ResultBuffer

        self.result_buffer = ResultBuffer(self)

        # Visible to task code before the first task can possibly arrive.
        set_current_worker(self)

        self.node_id: bytes = b""
        reply = self.raylet.call("register_worker", {
            "worker_id": self.worker_id,
            "worker_type": mode,
            "address": self._server.address,
            "pid": os.getpid(),
            "env_key": os.environ.get("RAY_TPU_TORCH_RUNTIME_ENV_KEY"),
            # set by worker_pool._forked_child_main: this process was forked
            # from a warm template rather than cold-spawned
            "forked": os.environ.get("RAY_TPU_TORCH_WORKER_FORKED") == "1",
        })
        self.node_id = reply["node_id"]
        self._registered.set()

        if mode == "worker":
            self._start_exec_threads(1)

        if mode == "driver":
            self.gcs.call("register_job", {
                "job_id": self.job_id.binary(),
                "driver_address": self._server.address,
            })
            # "nodes" rides along: node death is an OWNER-side failure
            # signal — a task spilled to a raylet that dies whole-node has
            # nobody left to push task_worker_died, so the owner reacts to
            # the GCS membership event instead.
            channels = ["actors", "nodes"]
            if self.log_to_driver:
                channels.append("logs")
            self.gcs.call("subscribe", {"channels": channels,
                                        "origin": self.raylet_address})
            with self._pending_lock:
                self._nodes_subscribed = True
        # workers own the subtasks they submit and get the same node-death
        # signal, but subscribe lazily on their first spill notification
        # (_ensure_nodes_subscribed) — see _nodes_subscribed.

    # ------------------------------------------------------------------ util
    @property
    def address(self) -> str:
        return self._server.address

    def peer(self, address: str,
             connect_timeout_s: Optional[float] = None,
             retry: bool = True) -> rpc.RpcClient:
        """Cached connection to another worker/raylet. The dial happens
        OUTSIDE the cache lock: connect_with_retry spins for the full
        connect timeout when the target is dead (SIGKILLed worker whose
        address we still hold), and holding the lock through that would
        serialize every other peer() caller in the process behind one
        corpse — under a node kill storm that stalls submissions to
        perfectly healthy actors for 30 s at a time. `retry=False` dials
        once: a dead peer's refusal raises at once."""
        with self._peers_lock:
            c = self._peers.get(address)
            if c is not None and not c.closed:
                return c
        timeout = connect_timeout_s or get_config().rpc_connect_timeout_s
        if retry:
            c = rpc.connect_with_retry(address, timeout=timeout,
                                       origin=self.raylet_address)
        else:
            c = rpc.RpcClient(address, connect_timeout=timeout,
                              origin=self.raylet_address)
        with self._peers_lock:
            existing = self._peers.get(address)
            if existing is not None and not existing.closed:
                # a concurrent dial won the install race: use the shared
                # client, drop ours
                c.close()
                return existing
            self._peers[address] = c
            return c

    def shutdown(self) -> None:
        self._shutdown.set()
        # final buffer flushes BEFORE the links close: a clean exit may not
        # lose buffered results or lifecycle events (the at-shutdown half of
        # the batching contract)
        self.result_buffer.stop()
        self.task_events.stop()
        self.reference_counter.close()
        if self.mode == "driver":
            try:
                self.gcs.call("mark_job_finished", {"job_id": self.job_id.binary()}, timeout=2)
            except (OSError, TimeoutError, rpc.RpcDisconnected) as e:
                logger.debug("mark_job_finished lost at shutdown: %s", e)
        for c in list(self._peers.values()):
            c.close()
        try:
            self.raylet.close()
        except OSError:
            pass  # connection already dead
        try:
            self.gcs.close()
        except OSError:
            pass  # connection already dead
        self._server.stop()

    # ------------------------------------------------------------ submission
    def submit_task(
        self,
        func: Callable,
        args: tuple,
        kwargs: dict,
        *,
        num_returns: int = 1,
        resources: Optional[Dict[str, float]] = None,
        scheduling=None,
        max_retries: int = 0,
        retry_exceptions: bool = False,
        runtime_env: Optional[dict] = None,
        max_calls: int = 0,
    ) -> List[ObjectRef]:
        from ray_tpu_torch.core.task_spec import SchedulingStrategy

        if runtime_env and runtime_env.get("py_modules"):
            from ray_tpu_torch.runtime_env import upload_py_modules

            runtime_env = upload_py_modules(runtime_env, self.gcs)
        task_id = self._task_counter.next_task_id()
        # Export-once fast lane: first submission of a callable pickles it
        # once and exports the blob to the GCS function table; afterwards
        # the spec carries only the 16-byte content hash (the fallback
        # ships the blob inline for unexportable one-shot callables).
        function_id, function_blob = self.function_table.export(func)
        spec = TaskSpec(
            task_id=task_id,
            job_id=self.job_id,
            task_type=TaskType.NORMAL,
            function_blob=function_blob,
            function_id=function_id,
            method_name=getattr(func, "__name__", "anonymous"),
            args=self._serialize_args(args, task_id),
            kwargs_blob=serialization.dumps(kwargs) if kwargs else None,
            num_returns=num_returns,
            resources=dict(resources or {}),
            scheduling=scheduling or SchedulingStrategy(),
            max_retries=max_retries,
            retry_exceptions=retry_exceptions,
            owner_address=self.address,
            owner_worker_id=self.worker_id,
            runtime_env=runtime_env,
            max_calls=max_calls,
            parent_task_id=self._parent_for_submit(),
        )
        t_sub = self._stamp_trace_ctx(spec)
        refs = self._register_returns(spec)
        with self._pending_lock:
            self._pending_tasks[task_id] = [spec, max_retries]
        self._emit_task_event(spec, "SUBMITTED")
        probe = self._spec_bytes_probe
        if probe is not None:
            try:
                probe(spec)
            except Exception:
                logger.debug("spec bytes probe failed", exc_info=True)
        self.raylet.notify("submit_task", {"spec": spec})
        self._record_submit_span(spec, t_sub)
        return refs

    def flush_profile_events(self) -> None:
        """Force-flush this process's event buffer (task events + tracing
        spans) to the GCS so `timeline()` on any driver aggregates
        cluster-wide events NOW instead of at the next batch interval
        (reference ProfileEvent -> TaskEventBuffer -> GCS)."""
        self.task_events.flush()

    def _emit_task_event(self, spec: TaskSpec, state: str) -> None:
        """Best-effort task lifecycle record, coalesced in the worker-side
        TaskEventBuffer and shipped on its flush timer (reference
        TaskEventBuffer -> GcsTaskManager)."""
        try:
            self.task_events.record(spec, state)
        except Exception:
            logger.debug("task event record failed", exc_info=True)

    def _stamp_trace_ctx(self, spec: TaskSpec) -> float:
        """Tracing-enabled only: mint the submit-stage span id and stamp
        (trace_id, submit span_id) into the spec BEFORE it serializes, so
        the raylet's lease span and the executor's run/result spans parent
        under this submission. Returns the submit-span start stamp (0.0
        when tracing is off — the hot path pays one config read)."""
        if not tracing.enabled():
            return 0.0
        ctx = tracing.current_ctx()
        # no ambient trace -> this submission roots its own (detached: the
        # thread's TLS stays clean so unrelated submissions don't coalesce
        # into one giant trace)
        trace_id = ctx[0] if ctx else tracing.new_id()
        spec.trace_ctx = (trace_id, tracing.new_id())
        return tracing.now_us()

    def _record_submit_span(self, spec: TaskSpec, t_sub: float) -> None:
        if spec.trace_ctx is None or not t_sub:
            return
        parent = tracing.current_ctx()
        tracing.add_complete(
            f"submit::{spec.method_name}", "task_submit",
            t_sub, tracing.now_us() - t_sub,
            trace_id=spec.trace_ctx[0], span_id=spec.trace_ctx[1],
            parent_id=parent[1] if parent else "",
            task_id=spec.task_id.binary().hex())

    def _register_returns(self, spec: TaskSpec) -> List[ObjectRef]:
        refs = []
        cfg = get_config()
        with self._obj_lock:
            for oid in spec.return_object_ids():
                st = self._objects.get(oid)
                if st is None:
                    st = _ObjectState()
                    self._objects[oid] = st
                st.state = "pending"
                st.local_refs += 1
                r = ObjectRef(oid, owner_address=self.address)
                r._counted = True
                refs.append(r)
                if spec.task_type == TaskType.NORMAL:
                    self._lineage[oid] = spec
            if spec.num_returns == -1:
                self._dynamic_returns[spec.task_id] = {
                    "refs": [], "done": False, "error": None}
            while len(self._lineage) > cfg.lineage_table_max_entries:
                # Evict a whole task's returns together and drop its retry
                # counter so _lineage_attempts can't grow unboundedly.
                old = self._lineage.pop(next(iter(self._lineage)))
                for roid in old.return_object_ids():
                    self._lineage.pop(roid, None)
                for roid in self._task_dynamic_ids.pop(old.task_id, ()):
                    self._lineage.pop(roid, None)
                self._lineage_attempts.pop(old.task_id, None)
        return refs

    def _serialize_args(self, args: tuple,
                        task_id: Optional[TaskID] = None,
                        creation_of: Optional[ActorID] = None
                        ) -> List[Tuple]:
        """Inline small values; pass refs through; promote big args to the
        object store (cf. reference: big args -> plasma `Put`). For the
        creation of actor `creation_of`, owned refs nested in an inline
        value stay pinned until the actor is up (`_pin_for_creation`)."""
        out: List[Tuple] = []
        cfg = get_config()
        for a in args:
            if isinstance(a, ObjectRef):
                out.append(("ref", a.id, a.owner_address))
                self._pin_for_submission(a, task_id)
            else:
                s = serialization.serialize(a)
                self._mark_shipped(s.contained_refs)
                if s.total_bytes <= cfg.max_direct_call_object_size:
                    out.append(("value", s.to_bytes()))
                    if creation_of is not None:
                        self._pin_for_creation(creation_of, s.contained_refs)
                else:
                    ref = self.put(a)
                    # Pin: the promoted ref's only Python instance dies right
                    # here, so without the task-dep pin the object would be
                    # freed before the executor fetches it.
                    self._pin_for_submission(ref, task_id)
                    out.append(("ref", ref.id, ref.owner_address))
        return out

    def _pin_for_submission(self, ref: ObjectRef,
                            task_id: Optional[TaskID]) -> None:
        """Pin an owned arg for a task's lifetime. Pins are RECORDED per
        task so the unpin decrements exactly what was pinned: an arg whose
        entry was already freed at pin time must not be decremented at
        report time (it may have been recreated by recursive recovery in
        between, and an unmatched decrement would drive the count negative
        and let a later task's dep be freed out from under it). task_id
        None (actor-creation args) pins for the actor's lifetime."""
        if ref.owner_address != self.address:
            return
        with self._obj_lock:
            st = self._objects.get(ref.id)
            if st is not None:
                st.submitted_task_deps += 1
                st.shipped = True  # the executor materializes a borrow
                if task_id is not None:
                    self._task_pins.setdefault(task_id, []).append(ref.id)

    def _pin_for_creation(self, actor_id: ActorID, refs) -> None:
        """Owned refs nested in an inline argument of actor `actor_id`'s
        creation: pinned until the actor is ALIVE (its `__init__` has
        deserialized them and sent their borrows, which the free grace then
        covers in flight) or DEAD. Marked shipped alone they would live only
        the grace past the owner's last ref, and an actor's worker may start
        later than that: a fresh node's first lease waits for its fork
        template's boot (ROADMAP C.7)."""
        oids = []
        with self._obj_lock:
            for r in refs or ():
                st = (self._objects.get(r.id)
                      if r.owner_address == self.address else None)
                if st is not None:
                    st.submitted_task_deps += 1
                    oids.append(r.id)
        if not oids:
            return
        with self._creation_lock:
            self._creation_pins.setdefault(actor_id, []).extend(oids)
            if self._creation_watcher is None:
                self._creation_watcher = threading.Thread(
                    target=self._creation_watch_loop, name="creation-pins",
                    daemon=True)
                self._creation_watcher.start()

    def _creation_watch_loop(self) -> None:
        """Release each actor's creation pins once it is ALIVE or DEAD: the
        driver's actor pubsub where it has seen the change, else a GCS
        poll (workers subscribe to no actor channel). Exits when none is
        left."""
        while not self._shutdown.is_set():
            with self._creation_lock:
                pending = list(self._creation_pins)
                if not pending:
                    self._creation_watcher = None
                    return
            for aid in pending:
                settled = aid in self._actor_addresses or aid in self._actor_dead
                if not settled:
                    try:
                        info = self.gcs.call("get_actor_info",
                                             {"actor_id": aid}, timeout=10)
                    except Exception:
                        continue  # control plane busy or restarting
                    settled = info is None or info["state"] in ("ALIVE",
                                                                "DEAD")
                if settled:
                    with self._creation_lock:
                        oids = self._creation_pins.pop(aid, [])
                    with self._obj_lock:
                        for oid in oids:
                            st = self._objects.get(oid)
                            if st is not None:
                                st.submitted_task_deps -= 1
                                self._maybe_free(oid, st)
            self._shutdown.wait(0.2)

    def _mark_shipped(self, refs) -> None:
        """Mark owned objects whose refs were serialized into an outgoing
        payload: their frees get the borrow-in-flight grace period."""
        for r in refs or ():
            if r.owner_address == self.address:
                with self._obj_lock:
                    st = self._objects.get(r.id)
                    if st is not None:
                        st.shipped = True

    def _unpin_after_task(self, spec: TaskSpec) -> None:
        """Release exactly the pins _pin_for_submission recorded for this
        task (pop makes a double report idempotent)."""
        with self._obj_lock:
            for oid in self._task_pins.pop(spec.task_id, ()):
                st = self._objects.get(oid)
                if st is not None:
                    st.submitted_task_deps -= 1
                    self._maybe_free(oid, st)

    # ------------------------------------------------------------------ put
    @property
    def _current_task_id(self) -> TaskID:
        return getattr(self._tls, "task_id", self._root_task_id)

    def put(self, value: Any) -> ObjectRef:
        with self._put_lock:
            self._put_counter += 1
            put_index = self._put_counter
        oid = ObjectID.for_put(self._current_task_id, put_index)
        s = serialization.serialize(value)
        cfg = get_config()
        with self._obj_lock:
            st = _ObjectState(local_refs=1)
            self._objects[oid] = st
        if s.total_bytes <= cfg.max_direct_call_object_size:
            blob = s.to_bytes()
            with self._obj_lock:
                st.state = "inline"
                st.inline_blob = blob
                st.size = len(blob)
                self._obj_cv.notify_all()
        else:
            seg = self._put_to_store(oid, s)
            with self._obj_lock:
                st.state = "plasma"
                st.location = self.raylet_address
                st.size = s.total_bytes
                st.segment = seg
                self._obj_cv.notify_all()
        # Refs nested in the stored value: shipping them into the store means
        # borrows can materialize later from any reader. Owned inner objects
        # additionally get a CONTAINER PIN — they stay alive as long as the
        # enclosing object does, because a reader may deserialize the payload
        # (and only then register its borrow) arbitrarily late. The reference
        # tracks this as nested-ref containment in its borrow tables
        # (reference_count.h:834); a grace window alone cannot cover it.
        self._mark_shipped(s.contained_refs)
        with self._obj_lock:
            seen = set()
            for r in s.contained_refs or ():
                if (r.owner_address == self.address and r.id != oid
                        and r.id not in seen and r.id in self._objects):
                    seen.add(r.id)
                    self._objects[r.id].container_pinned += 1
                    st.contained_pins.append(r.id)
        self._notify_info_waiters(oid)
        ref = ObjectRef(oid, owner_address=self.address)
        ref._counted = True
        return ref

    # ------------------------------------------------------------- promises
    def create_promise(self) -> ObjectRef:
        """An owned object with no producing task: the creator resolves it
        later via fulfill_promise(). Every consumer path (get/wait/
        add_done_callback/try_get_local) works unchanged. Serve's router
        returns one per routed request so a mid-request replica failover
        can re-point the work without changing the caller-visible ref."""
        with self._put_lock:
            self._put_counter += 1
            put_index = self._put_counter
        oid = ObjectID.for_put(self._current_task_id, put_index)
        with self._obj_lock:
            self._objects[oid] = _ObjectState(local_refs=1)
        ref = ObjectRef(oid, owner_address=self.address)
        ref._counted = True
        return ref

    def fulfill_promise(self, ref: ObjectRef, value: Any = None,
                        error: Optional[BaseException] = None) -> bool:
        """Resolve a pending promise with a value or an exception. First
        resolution wins; returns False if the promise was already terminal
        (a lost race with the deadline reaper is normal, not an error)."""
        if error is not None:
            return self.fulfill_promise_blob(
                ref, serialization.dumps(error), is_error=True)
        s = serialization.serialize(value)
        self._mark_shipped(s.contained_refs)
        ok = self.fulfill_promise_blob(ref, s.to_bytes(), is_error=False)
        if ok:
            # same nested-ref containment as put(): owned refs inside the
            # stored value get a container pin for the promise's lifetime —
            # a reader may deserialize (and only then register its borrow)
            # arbitrarily late, which the shipped grace window alone cannot
            # cover (reference reference_count.h:834)
            with self._obj_lock:
                st = self._objects.get(ref.id)
                if st is not None:
                    seen = set()
                    for r in s.contained_refs or ():
                        if (r.owner_address == self.address and r.id != ref.id
                                and r.id not in seen
                                and r.id in self._objects):
                            seen.add(r.id)
                            self._objects[r.id].container_pinned += 1
                            st.contained_pins.append(r.id)
        return ok

    def fulfill_promise_blob(self, ref: ObjectRef, blob: bytes,
                             is_error: bool) -> bool:
        """Resolve a promise with an already-serialized payload — the
        zero-reserialization path for relaying another owned object's
        terminal inline/error blob (serve router success/error relay)."""
        with self._obj_lock:
            st = self._objects.get(ref.id)
            if st is None or st.state != "pending":
                return False
            st.state = "error" if is_error else "inline"
            st.inline_blob = blob
            st.size = len(blob)
            self._obj_cv.notify_all()
        self._notify_info_waiters(ref.id)
        return True

    def peek_local(self, ref: ObjectRef):
        """(state, inline_blob) snapshot of an owned object's record —
        (None, None) if unknown. Non-blocking; lets completion callbacks
        classify a terminal object without a get()."""
        with self._obj_lock:
            st = self._objects.get(ref.id)
            if st is None:
                return None, None
            return st.state, st.inline_blob

    def _put_to_store(self, oid: ObjectID,
                      s: SerializedObject) -> Optional[Tuple[str, int]]:
        """Write a serialized object into the node store and seal it.

        One control round-trip total: obj_create is the only CALL (the
        allocation decision must come back); the seal rides the same
        ordered connection as a fire-and-forget notify. The write itself
        picks the cheapest memory path: a recycled segment's pages are
        already faulted, so memcpy through a mapping runs at memory
        bandwidth; a fresh file takes os.writev, which populates tmpfs
        pages directly instead of zero-faulting a fresh mapping first
        (the buffer-protocol put fast path — numpy/JAX host array buffers
        go straight from the array to the segment, no flatten).

        Returns (segment_name, attach_size), or None if the object
        already existed.

        Store-full backpressure: a typed `full` refusal retries with
        backoff for at most `put_full_timeout_s` — eviction, spilling and
        reader unpins happen on the raylet in the meantime — then raises
        ObjectStoreFullError (immediately when the store marks the refusal
        `fatal`: the object can never fit)."""
        size = s.framed_size
        cfg = get_config()
        deadline = time.monotonic() + cfg.put_full_timeout_s
        attempt = 0
        while True:
            # job_id rides along so the raylet can attribute the primary
            # copy: a dead job's reap deletes its objects by this stamp
            r = self.raylet.call("obj_create",
                                 {"object_id": oid, "size": size,
                                  "job_id": self.job_id.binary()})
            if r.get("ok"):
                break
            if not r.get("full"):
                return None  # already exists
            remaining = deadline - time.monotonic()
            if r.get("fatal") or remaining <= 0:
                raise ObjectStoreFullError(
                    r.get("error")
                    or f"object store full putting {oid} ({size} bytes)")
            attempt += 1
            time.sleep(min(0.05 * attempt, 0.5, max(remaining, 0.01)))
        name = r["name"]
        if name.startswith("@"):
            buf = attach_object(name, size)  # arena slot: write in place
            try:
                s.write_into(buf.view)
            finally:
                buf.close()
        else:
            dst = self._writer_map_view(name, size)
            if dst is not None:
                # hottest path: a recycled segment THIS process has written
                # before — page tables already populated, pure memcpy
                try:
                    s.write_into(dst)
                finally:
                    dst.release()
            else:
                # writev, never a fresh writer-side mapping: a fresh
                # mapping zero-faults every page before the copy, and even
                # on a recycled (hot) segment populating the page table
                # costs ~5x the fd write path. Cache a mapping for the
                # segment's NEXT reuse by this process.
                from ray_tpu_torch.core.object_store import _SHM_DIR

                fd = os.open(os.path.join(_SHM_DIR, name), os.O_WRONLY)
                try:
                    s.write_to_fd(fd)
                finally:
                    os.close(fd)
                self._writer_map_add(name)
        self.raylet.notify("obj_seal", {"object_id": oid})
        seg = None
        if not name.startswith("@"):
            seg = (name, size)
            self._seg_cache_put(oid, name, size)
        return seg

    # ------------------------------------------------------------------ get
    def get(self, refs: List[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        deadline = None if timeout is None else time.monotonic() + timeout
        return [self._get_one(r, deadline) for r in refs]

    def try_get_local(self, ref: ObjectRef):
        """(value, True) when the owned object is terminal AND resolvable
        without blocking (inline or error blob in the local table) — the
        post-completion fast path for event-loop callers (serve's HTTP
        edge). (None, False) means call get() on a thread that may block."""
        if ref.owner_address not in ("", self.address):
            return None, False
        with self._obj_lock:
            st = self._objects.get(ref.id)
            if st is None or st.state != "inline":
                # plasma needs a fetch; errors go through get() so exception
                # rewrapping semantics stay in one place
                return None, False
            blob = st.inline_blob
        return serialization.loads(blob), True

    def get_async(self, ref: ObjectRef) -> Future:
        fut: Future = Future()

        def run():
            try:
                fut.set_result(self._get_one(ref, None))
            except Exception as e:
                fut.set_exception(e)

        threading.Thread(target=run, daemon=True).start()
        return fut

    def _get_one(self, ref: ObjectRef, deadline: Optional[float]) -> Any:
        recoveries = 0
        failed_sources: set = set()
        while True:
            info = self._resolve(ref, deadline)
            kind = info["kind"]
            if kind == "inline":
                return serialization.loads(info["data"])
            if kind == "plasma":
                source = info.get("raylet")
                if source in failed_sources:
                    # Re-resolved to a location that already failed: the copy
                    # really is gone. Lineage recovery (reference
                    # object_recovery_manager.h:96): recompute by re-executing
                    # the creating task, then resolve the fresh location.
                    if (recoveries < get_config().lineage_reconstruction_max_retries
                            and self._recover_object(ref)):
                        recoveries += 1
                        failed_sources.clear()
                        continue
                    raise ObjectLostError(
                        f"object {ref.id} lost from {source} and could not "
                        f"be reconstructed")
                try:
                    value = self._fetch_plasma(ref, info, deadline)
                    self._note_pulled_copy(ref)
                    return value
                except ObjectLostError:
                    # First failure of this source: tell the owner so other
                    # resolvers stop being pointed at the stale copy, then
                    # re-resolve before spending a reconstruction — another
                    # location (or a concurrent getter's recovery) may serve.
                    self._note_location_failed(ref, source)
                    failed_sources.add(source)
                    continue
            if kind == "error":
                err = serialization.loads(info["data"])
                if isinstance(err, TaskError) and err.cause is not None:
                    # Re-raise the user's original exception type with the
                    # remote traceback attached (cf. reference
                    # as_instanceof_cause).
                    raise err.cause from err
                raise err
            raise ObjectLostError(f"object {ref.id} in unexpected state {kind}")

    def _resolve(self, ref: ObjectRef, deadline: Optional[float]) -> dict:
        """Find where the object's bytes are (blocking until produced)."""
        if ref.owner_address in ("", self.address):
            with self._obj_cv:
                st = self._objects.get(ref.id)
            if st is None:
                # Data already freed, but if the lineage survives we can
                # recompute (needed when a reconstructed task's own args were
                # freed after its first run). Outside the cv: _try_reconstruct
                # does network sends and must not run under _obj_lock.
                if ref.id in self._lineage and self._try_reconstruct(ref.id):
                    with self._obj_cv:
                        st = self._objects.get(ref.id)
            if st is None:
                raise ObjectLostError(
                    f"object {ref.id} is not owned by this process and has no owner address")
            with self._obj_cv:
                while st.state == "pending":
                    remaining = None if deadline is None else deadline - time.monotonic()
                    if remaining is not None and remaining <= 0:
                        raise GetTimeoutError(f"get() timed out waiting for {ref.id}")
                    self._obj_cv.wait(timeout=min(remaining, 1.0) if remaining else 1.0)
                if st.state == "inline":
                    return {"kind": "inline", "data": st.inline_blob}
                if st.state == "error":
                    return {"kind": "error", "data": st.inline_blob}
                info = {"kind": "plasma", "raylet": st.location,
                        "size": st.size}
                if st.segment is not None:
                    info["segment"] = st.segment
                    info["segment_at"] = st.location
                return info
        # borrowed: ask the owner
        timeout = None if deadline is None else max(deadline - time.monotonic(), 0.01)
        try:
            info = self.peer(ref.owner_address).call(
                "get_object_info", {"object_id": ref.id, "wait": True},
                timeout=timeout)
        except (rpc.RpcDisconnected, OSError):
            # conn severed mid-call OR connect refused outright — either
            # way the ownership record is gone with the process (cross-job
            # get of a reaped job's object lands here)
            raise OwnerDiedError(
                f"owner {ref.owner_address} of object {ref.id} died") from None
        except TimeoutError:
            raise GetTimeoutError(f"get() timed out waiting for {ref.id}") from None
        if info is None:
            raise ObjectLostError(f"owner has no record of object {ref.id}")
        return info

    def _fetch_plasma(self, ref: ObjectRef, info: dict, deadline: Optional[float]) -> Any:
        """Materialize a plasma object's value.

        Same-node fast path (zero-copy): when the segment name is known —
        from the worker-side location cache or the owner's reply — attach
        it and deserialize IN PLACE, pipelined with an authoritative
        obj_pin round-trip; the returned value's large buffers are
        read-only views into shared memory, pinned on the raylet until the
        reader's last view is GC'd. Fallback: pull_object (which pins
        before replying), then attach; only arena-resident objects (and
        zero-copy-disabled configs) pay a copy out of the segment."""
        source = info["raylet"]
        zc = get_config().object_zero_copy_enabled
        if zc:
            cached = self._seg_cache_get(ref.id)
            if cached is None and info.get("segment") is not None \
                    and info.get("segment_at") == self.raylet_address:
                cached = tuple(info["segment"])
            if cached is not None and not cached[0].startswith("@"):
                value, ok = self._pinned_load(ref.id, cached[0], cached[1])
                if ok:
                    return value
        last_err: object = None
        for _ in range(3):
            timeout = None if deadline is None else max(deadline - time.monotonic(), 0.01)
            try:
                # ALWAYS pin the pull — even on the copy path. The store's
                # segment-reuse pool means an unpinned segment deleted
                # mid-copy could be recycled and overwritten under the
                # reader (pre-pool, the open mapping kept the dead inode's
                # bytes stable); the pin blocks the delete until the copy
                # (or the zero-copy reader's last view) releases it.
                loc = self.raylet.call(
                    "pull_object",
                    {"object_id": ref.id, "source": source, "pin": True},
                    timeout=timeout)
            except TimeoutError:
                raise GetTimeoutError(
                    f"get() timed out pulling {ref.id}") from None
            except Exception as e:
                # Source raylet dead or pull failed — surface as lost so
                # _get_one can attempt lineage recovery.
                raise ObjectLostError(
                    f"object {ref.id} could not be pulled from {source}: {e}"
                ) from None
            name, size = loc[0], loc[1]
            # a third "copy_only" element means the raylet granted a
            # TRANSIENT pin (indefinite reader pins are at the
            # max_pinned_fraction cap): copy out inside the bounded pin
            # window instead of arming a finalizer-held zero-copy view
            copy_only = len(loc) > 2 and loc[2] == "copy_only"
            if zc and not copy_only and not name.startswith("@"):
                value, ok = self._pinned_load(ref.id, name, size,
                                              pre_pinned=True)
                if ok:
                    return value
                last_err = "pinned segment vanished"
                continue
            # copy path: arena-resident objects (their slots recycle on
            # free, so views may only alias shm UNDER a pin — the pull
            # reply's pin covers exactly this copy window), pin-cap
            # copy_only grants, or zc disabled
            try:
                buf = attach_object(name, size)
            except FileNotFoundError as e:
                # Segment was spilled/evicted between lookup and attach; the
                # next pull_object restores it from spill.
                self._unpin_notify(ref.id)
                last_err = e
                continue
            try:
                data = bytes(buf.view)  # one copy out of shm: values own their memory
            finally:
                buf.close()
                self._unpin_notify(ref.id)
            return serialization.loads(data)
        raise ObjectLostError(f"object {ref.id} vanished during fetch: {last_err}")

    # ------------------------------------------------ zero-copy pin plumbing
    def _pinned_load(self, oid: ObjectID, name: str, size: int,
                     pre_pinned: bool = False):
        """Attach a local segment and deserialize in place, returning
        (value, ok). The attach + deserialize run OPTIMISTICALLY, pipelined
        with the obj_pin round-trip; the value is only trusted once the pin
        reply confirms the exact segment we attached (which is what makes
        the store's segment recycling safe — a recycled inode can never
        confirm). With `pre_pinned` the pin is already held (pull_object
        reply / a mismatch retry), so no confirmation round-trip is needed.
        On ok=True an unpin finalizer is armed on the mapping: it fires
        when the reader's LAST view over the segment is GC'd."""
        fut = None
        if not pre_pinned:
            try:
                fut = self.raylet.call_future("obj_pin", {"object_id": oid})
            except Exception:
                return None, False
        attached = None
        value = None
        err = None
        try:
            attached = attach_object(name, size, copy_on_write=True)
            value = serialization.loads_view(attached.view)
        except Exception as e:
            # garbage from a recycled segment can fail to unpickle; a
            # vanished one fails to open — either way the pin reply decides
            err = e
        if fut is not None:
            try:
                loc = fut.result(
                    timeout=get_config().rpc_connect_timeout_s)
            except Exception:
                # reply lost/timed out — but the pin REQUEST may still be
                # in flight and land later. The compensating unpin rides
                # the same ordered connection, so it is processed after
                # the pin if it landed (and is a tracked-map no-op if it
                # didn't) — without this, a slow raylet leaks a pin that
                # blocks reclaim for the connection's lifetime.
                self._unpin_notify(oid)
                self._seg_cache_drop(oid)
                return None, False
            if loc is None:
                # pin missed: the object is gone here (deleted, or spilled
                # and not restorable) — nothing to release, fall back
                self._seg_cache_drop(oid)
                return None, False
            if tuple(loc) != (name, size):
                self._seg_cache_drop(oid)
                if loc[0].startswith("@"):
                    # the object now lives in the ARENA (deleted + re-put
                    # by lineage re-execution): arena slots are not
                    # zero-copy eligible — release the pin and let the
                    # pull path's pinned copy handle it
                    self._unpin_notify(oid)
                    return None, False
                # pinned, but the segment moved (spill+restore): retry on
                # the authoritative location with the pin already held
                return self._pinned_load(oid, loc[0], loc[1],
                                         pre_pinned=True)
        if err is not None:
            # the pin IS held (confirmed or pre-held) but the local attach/
            # decode failed: release it and fall back to the pull path
            self._unpin_notify(oid)
            self._seg_cache_drop(oid)
            return None, False
        self._seg_cache_put(oid, name, size)
        self._arm_unpin_finalizer(oid, attached)
        return value, True

    def _arm_unpin_finalizer(self, oid: ObjectID, attached) -> None:
        """Tie the raylet-side pin to the mapping's lifetime: every view
        handed out by loads_view keeps the mmap alive (buffer-protocol
        exporter chain), so the finalizer fires exactly when the reader's
        last view dies — including 'immediately', for values that kept no
        buffer (pure-payload pickles)."""
        weakref.finalize(attached._shm._mmap, _send_unpin,
                         weakref.ref(self), oid)

    def _unpin_notify(self, oid: ObjectID) -> None:
        try:
            self.raylet.notify("obj_unpin", {"object_id": oid})
        except Exception:
            logger.debug("obj_unpin for %s lost", oid, exc_info=True)

    def _seg_cache_put(self, oid: ObjectID, name: str, size: int) -> None:
        with self._seg_cache_lock:
            self._seg_cache[oid] = (name, size)
            self._seg_cache.move_to_end(oid)
            cap = get_config().object_location_cache_entries
            while len(self._seg_cache) > cap:
                self._seg_cache.popitem(last=False)

    def _seg_cache_get(self, oid: ObjectID) -> Optional[Tuple[str, int]]:
        with self._seg_cache_lock:
            e = self._seg_cache.get(oid)
            if e is not None:
                self._seg_cache.move_to_end(oid)
            return e

    def _seg_cache_drop(self, oid: ObjectID) -> None:
        with self._seg_cache_lock:
            self._seg_cache.pop(oid, None)

    _WRITE_MAPS_MAX = 16

    def _writer_map_view(self, name: str, size: int):
        """Writable view over the cached mapping of a segment obj_create
        just granted us (create grants exclusive write ownership until
        seal, so writing through a retained mapping is safe — stale
        entries for names the store has moved on from are never handed
        back by create). The view is exported UNDER the lock: a racing
        LRU eviction's close() then raises BufferError and is skipped,
        so a concurrent put can never be handed a closed mapping."""
        with self._write_maps_lock:
            m = self._write_maps.get(name)
            if m is None or len(m) < size:
                return None
            self._write_maps.move_to_end(name)
            return memoryview(m)[:size]

    def _writer_map_add(self, name: str) -> None:
        import mmap as _mmap

        from ray_tpu_torch.core.object_store import _SHM_DIR

        path = os.path.join(_SHM_DIR, name)
        try:
            fd = os.open(path, os.O_RDWR)
            try:
                m = _mmap.mmap(fd, os.fstat(fd).st_size)
            finally:
                os.close(fd)
        except (OSError, ValueError):
            return
        evicted = []
        with self._write_maps_lock:
            old = self._write_maps.pop(name, None)
            if old is not None:
                self._write_maps_bytes -= len(old)
                evicted.append(old)
            self._write_maps[name] = m
            self._write_maps_bytes += len(m)
            cap_bytes = get_config().object_segment_pool_bytes
            while self._write_maps and (
                    len(self._write_maps) > self._WRITE_MAPS_MAX
                    or self._write_maps_bytes > cap_bytes):
                _, old = self._write_maps.popitem(last=False)
                self._write_maps_bytes -= len(old)
                evicted.append(old)
        for old in evicted:
            try:
                old.close()
            except (BufferError, ValueError):
                pass  # transient exported view; GC unmaps

    def _note_pulled_copy(self, ref: ObjectRef) -> None:
        """A successful pull materialized a copy on OUR raylet: register it
        with the owner so later readers spread across holders (once per
        object — repeat gets of a hot ref must not spam the owner)."""
        with self._registered_copies_lock:
            if ref.id in self._registered_copies:
                self._registered_copies.move_to_end(ref.id)
                return
            self._registered_copies[ref.id] = True
            # bounded LRU: evict the COLDEST entry instead of clearing the
            # whole set (a clear made every hot ref re-notify its owner at
            # once — exactly wrong at the 10k-objects-per-get envelope)
            if len(self._registered_copies) > 100_000:
                self._registered_copies.popitem(last=False)
        try:
            if ref.owner_address in ("", self.address):
                with self._obj_lock:
                    st = self._objects.get(ref.id)
                    if (st is not None and st.state == "plasma"
                            and self.raylet_address != st.location
                            and self.raylet_address not in st.extra_locations):
                        st.extra_locations.append(self.raylet_address)
            else:
                self.peer(ref.owner_address).notify(
                    "add_object_location",
                    {"object_id": ref.id, "raylet": self.raylet_address})
        except (OSError, RuntimeError, TimeoutError):
            logger.debug("copy registration for %s failed", ref.id,
                         exc_info=True)

    def _note_location_failed(self, ref: ObjectRef, source: Optional[str]) -> None:
        if not source:
            return
        try:
            if ref.owner_address in ("", self.address):
                self._drop_location(ref.id, source)
            else:
                self.peer(ref.owner_address).notify(
                    "object_location_failed",
                    {"object_id": ref.id, "raylet": source})
        except (OSError, RuntimeError, TimeoutError):
            logger.debug("location-failed report for %s lost", ref.id,
                         exc_info=True)

    # ------------------------------------------------------ lineage recovery
    def _recover_object(self, ref: ObjectRef) -> bool:
        """Arrange for a lost object to be recomputed. Returns True if a
        reconstruction was started (or is already in flight) and the caller
        should re-resolve; False if the object is unrecoverable."""
        if ref.owner_address in ("", self.address):
            return self._try_reconstruct(ref.id)
        try:
            return bool(self.peer(ref.owner_address).call(
                "reconstruct_object", {"object_id": ref.id}, timeout=30))
        except (OSError, RuntimeError, TimeoutError):  # owner gone: unrecoverable via that owner
            return False

    def rpc_reconstruct_object(self, conn, req_id, payload):
        """A borrower's pull failed: recompute the object we own
        (reference ObjectRecoveryManager::ReconstructObject)."""
        return self._try_reconstruct(payload["object_id"])

    def _try_reconstruct(self, oid: ObjectID) -> bool:
        """Owner-side: re-execute the creating task of a lost object
        (lineage re-execution, reference object_recovery_manager.h:96).
        Bounded per creating task by lineage_reconstruction_max_retries.
        Callers must NOT hold _obj_lock: the trailing notifies do network I/O.
        """
        cfg = get_config()
        # Owner-side liveness probe first (reference ObjectRecoveryManager
        # pins/locates before reconstructing): if ANY known location still
        # holds the object, repair the directory instead of re-executing —
        # a reader's failed pull of one stale copy must not re-run tasks.
        with self._obj_lock:
            st0 = self._objects.get(oid)
            locs = ([st0.location] + list(st0.extra_locations)
                    if st0 is not None and st0.state == "plasma" else [])
        live = None
        for loc in locs:
            if not loc:
                continue
            try:
                if loc == self.raylet_address:
                    found = self.raylet.call("obj_lookup", {"object_id": oid},
                                             timeout=3)
                else:
                    # short-lived, short-timeout probe: peer() would retry
                    # connecting to a dead raylet for rpc_connect_timeout_s
                    # (30s) — far too long for a liveness check, and this
                    # runs on the RPC handler path for borrower-triggered
                    # reconstructions
                    probe = rpc.RpcClient(loc, connect_timeout=2)
                    try:
                        found = probe.call("obj_lookup", {"object_id": oid},
                                           timeout=3)
                    finally:
                        probe.close()
                if found is not None:
                    live = loc
                    break
            except Exception:
                continue
        if live is not None:
            with self._obj_lock:
                st0 = self._objects.get(oid)
                if st0 is not None and st0.state == "plasma":
                    if live != st0.location:
                        st0.segment = None  # name was the OLD primary's
                    st0.location = live
                    st0.extra_locations = []  # dead copies re-register on pull
            return True
        with self._obj_lock:
            spec = self._lineage.get(oid)
            if spec is None:
                return False
            # The in-flight check and the pending-table insertion are one
            # critical section: without it two concurrent getters both see
            # not-in-flight and double-submit (double execution + one
            # balancing unpin for two pins).
            with self._pending_lock:
                if spec.task_id in self._pending_tasks:
                    submit = False
                else:
                    attempts = self._lineage_attempts.get(spec.task_id, 0)
                    if attempts >= cfg.lineage_reconstruction_max_retries:
                        return False
                    self._lineage_attempts[spec.task_id] = attempts + 1
                    self._pending_tasks[spec.task_id] = [spec, 0]
                    submit = True
            # All returns of the task are recomputed together (incl. any
            # dynamic generator items — same deterministic ids); reset their
            # states so concurrent getters block until the re-run reports.
            for roid in (spec.return_object_ids()
                         + list(self._task_dynamic_ids.get(spec.task_id, ()))):
                st = self._objects.get(roid)
                if st is None:
                    st = _ObjectState()
                    self._objects[roid] = st
                if st.state == "plasma" or submit:
                    st.state = "pending"
            if submit:
                # Re-pin argument objects we own for the duration of the
                # re-run (balanced by _unpin_after_task on result report);
                # pinned before the release so the report can't unpin first.
                for a in spec.args:
                    if a[0] == "ref" and a[2] == self.address:
                        self._pin_for_submission(
                            ObjectRef(a[1], owner_address=a[2]), spec.task_id)
        if submit:
            logger.info("reconstructing %s by re-executing task %s",
                        oid, spec.method_name)
            self._emit_task_event(spec, "SUBMITTED")
            self.raylet.notify("submit_task", {"spec": spec})
        return True

    # ------------------------------------------------------------------ wait
    def wait(self, refs: List[ObjectRef], num_returns: int, timeout: Optional[float],
             fetch_local: bool = True):
        if len({r.id for r in refs}) != len(refs):
            # the reference rejects duplicates too; silently collapsing them
            # would make len(ready)+len(pending) != len(refs)
            raise ValueError("wait() got duplicate object refs")
        deadline = None if timeout is None else time.monotonic() + timeout
        if all(r.owner_address in ("", self.address) for r in refs):
            return self._wait_owned(refs, num_returns, deadline)
        # Borrowed refs ride the owners' DEFERRED-REPLY path: one
        # get_object_info(wait=True) future per ref, resolved by the owner
        # when the object turns terminal — no per-tick RPC storm and no
        # get_check_interval_s latency floor (the old design polled every
        # owner for every ref each interval; reference WaitManager is
        # event-driven end to end). An owner's error/disconnect counts the
        # ref ready: the subsequent get() surfaces the real failure.
        # Futures are CACHED per (owner, object): the canonical poll loop —
        # wait(timeout=...) in a while — reuses one outstanding deferred
        # call instead of parking a fresh owner-side waiter per tick.
        from concurrent.futures import FIRST_COMPLETED
        from concurrent.futures import wait as futures_wait

        owned_ids = {r.id for r in refs
                     if r.owner_address in ("", self.address)}
        owned = [r for r in refs if r.id in owned_ids]
        futures: Dict[ObjectRef, Any] = {}
        ready: List[ObjectRef] = []
        ready_ids = set()
        for r in refs:
            if r.id in owned_ids:
                continue
            f = self._borrowed_wait_future(r)
            if f is None:
                ready.append(r)  # owner unreachable: ready-with-error
                ready_ids.add(r.id)
            else:
                futures[r] = f
        while True:
            for r in [r for r, f in futures.items() if f.done()]:
                self._drop_wait_future(r, futures.pop(r))
                ready.append(r)
                ready_ids.add(r.id)
            owned_pending = []
            for r in owned:
                if r.id in ready_ids:
                    continue
                with self._obj_lock:
                    st = self._objects.get(r.id)
                    terminal = st is not None and st.state != "pending"
                if terminal:
                    ready.append(r)
                    ready_ids.add(r.id)
                else:
                    owned_pending.append(r)
            pending = owned_pending + list(futures)
            if len(ready) >= num_returns or not pending:
                break
            remaining = None if deadline is None else deadline - time.monotonic()
            if remaining is not None and remaining <= 0:
                break
            # owned refs have no future to park on: bound the sleep so
            # their cv-side transitions are observed promptly
            slice_s = min(0.2, remaining) if remaining is not None else \
                (0.2 if owned_pending else None)
            if futures:
                futures_wait(list(futures.values()), timeout=slice_s,
                             return_when=FIRST_COMPLETED)
            else:
                with self._obj_cv:
                    self._obj_cv.wait(timeout=slice_s or 5.0)
        # preserve input order within each bucket for determinism
        order = {id(r): i for i, r in enumerate(refs)}
        ready.sort(key=lambda r: order[id(r)])
        pending.sort(key=lambda r: order[id(r)])
        return ready[:num_returns], pending + ready[num_returns:]

    def _borrowed_wait_future(self, ref: ObjectRef):
        """One OUTSTANDING get_object_info(wait=True) future per borrowed
        object: repeated wait() calls share it, so a poll loop parks exactly
        one owner-side waiter per object instead of one per tick."""
        key = (ref.owner_address, ref.id)
        with self._wait_futures_lock:
            f = self._wait_futures.get(key)
            if f is not None and not f.done():
                self._wait_futures.move_to_end(key)
                return f
            try:
                f = self.peer(ref.owner_address).call_future(
                    "get_object_info", {"object_id": ref.id, "wait": True})
            except Exception:
                self._wait_futures.pop(key, None)
                return None
            self._wait_futures[key] = f
            # bounded LRU: a stream of abandoned timed-out waits over
            # distinct refs must not grow this forever (evicting a live
            # entry only means a later wait() re-issues the call)
            while len(self._wait_futures) > 4096:
                self._wait_futures.popitem(last=False)
            return f

    def _drop_wait_future(self, ref: ObjectRef, fut) -> None:
        with self._wait_futures_lock:
            if self._wait_futures.get((ref.owner_address, ref.id)) is fut:
                self._wait_futures.pop((ref.owner_address, ref.id), None)

    def _wait_owned(self, refs: List[ObjectRef], num_returns: int,
                    deadline: Optional[float]):
        """Event-driven wait for refs we own: sleeps on the object condition
        variable (notified at every state transition) instead of polling —
        no get_check_interval_s latency floor (reference WaitManager is
        likewise event-driven)."""
        with self._obj_cv:
            while True:
                ready = []
                pending = []
                for r in refs:
                    st = self._objects.get(r.id)
                    if st is not None and st.state != "pending":
                        ready.append(r)
                    else:
                        pending.append(r)
                if len(ready) >= num_returns or not pending:
                    break
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    break
                self._obj_cv.wait(timeout=min(remaining, 5.0) if remaining else 5.0)
        return ready[:num_returns], pending + ready[num_returns:]

    # -------------------------------------------------- owner-side RPC surface
    def rpc_get_object_info(self, conn, req_id, payload):
        oid: ObjectID = payload["object_id"]
        wait = payload.get("wait", False)
        with self._obj_lock:
            st = self._objects.get(oid)
            if st is None:
                return None
            if st.state == "pending":
                if not wait:
                    return {"kind": "pending"}
                st.waiters.append((conn, req_id))
                return rpc.RpcServer.DEFERRED
            return self._info_payload(st)

    def _info_payload(self, st: _ObjectState) -> dict:
        if st.state == "inline":
            return {"kind": "inline", "data": st.inline_blob}
        if st.state == "error":
            return {"kind": "error", "data": st.inline_blob}
        # Location spreading (reference OwnershipBasedObjectDirectory with
        # multiple locations): readers that pulled a copy register it, and
        # later readers are pointed at a random holder — a 1 GiB broadcast
        # fans out across copies instead of hammering the primary. The
        # primary's segment name rides along so a reader CO-LOCATED with it
        # attaches directly, skipping the pull_object round-trip.
        locs = [st.location] + st.extra_locations
        info = {"kind": "plasma", "raylet": random.choice(locs),
                "size": st.size}
        if st.segment is not None:
            info["segment"] = st.segment
            info["segment_at"] = st.location
        return info

    def rpc_add_object_location(self, conn, req_id, payload):
        """A reader materialized a copy of our object on its raylet."""
        with self._obj_lock:
            st = self._objects.get(payload["object_id"])
            loc = payload["raylet"]
            if (st is not None and st.state == "plasma"
                    and loc != st.location and loc not in st.extra_locations):
                st.extra_locations.append(loc)
        return True

    def rpc_object_location_failed(self, conn, req_id, payload):
        """A reader's pull from `raylet` failed: prune the stale copy
        (evicted or node died) so resolvers stop being pointed at it."""
        self._drop_location(payload["object_id"], payload["raylet"])
        return True

    def _drop_location(self, oid: ObjectID, loc: str) -> None:
        """Prune a stale PULLED copy. The pinned primary is never dropped on
        a reader's report alone (a transient pull failure would orphan the
        pinned plasma copy); primary repair happens in _try_reconstruct's
        owner-side liveness probe."""
        with self._obj_lock:
            st = self._objects.get(oid)
            if st is not None and loc in st.extra_locations:
                st.extra_locations.remove(loc)

    def add_done_callback(self, ref: ObjectRef, cb: Callable[[], None]) -> None:
        """Invoke `cb` (cheap, non-blocking!) when the owned object reaches a
        terminal state — the thread-free alternative to polling/`get_async`
        for completion accounting (e.g. Serve's in-flight router counts).
        Fires immediately if already terminal; runs on the RPC reader thread
        otherwise."""
        with self._obj_lock:
            st = self._objects.get(ref.id)
            if st is not None and st.state == "pending":
                st.callbacks.append(cb)
                return
        try:
            cb()
        except Exception:
            logger.exception("done callback failed")

    def _notify_info_waiters(self, oid: ObjectID) -> None:
        with self._obj_lock:
            st = self._objects.get(oid)
            if st is None or st.state == "pending":
                return
            waiters, st.waiters = st.waiters, []
            callbacks, st.callbacks = st.callbacks, []
            payload = self._info_payload(st)
        for conn, req_id in waiters:
            try:
                conn.reply(req_id, payload)
            except OSError as e:
                logger.debug("waiter connection dropped before reply: %s", e)
        for cb in callbacks:
            try:
                cb()
            except Exception:
                logger.exception("done callback failed")

    def rpc_report_task_result(self, conn, req_id, payload):
        """Executor pushed results for task(s) we own. Accepts both the
        legacy single-task payload and the ResultBuffer's multi-task batch
        (`{"batch": [(task_id, results), ...]}`, applied in completion
        order); object-state wakeups coalesce into ONE `_obj_cv.notify_all()`
        per call instead of one per result entry. Actor replies carry the
        reporting instance's incarnation: a LATE reply from a superseded
        instance (partition heal) is rejected here rather than applied."""
        batch = payload.get("batch")
        if batch is None:
            batch = [(payload["task_id"], payload["results"])]
        reporter_inc = payload.get("actor_incarnation")
        for task_id, results in batch:
            if reporter_inc is not None \
                    and self._reject_stale_reply(task_id, reporter_inc):
                continue
            try:
                self._handle_task_result(task_id, results)
            except Exception:
                # tasks were isolated per-RPC before batching; one bad
                # entry must not strand the other tasks riding the batch
                logger.exception("failed to apply results of task %s", task_id)
        with self._obj_cv:
            self._obj_cv.notify_all()
        return True

    def _reject_stale_reply(self, task_id: TaskID, reporter_inc: int) -> bool:
        """True when this reply comes from an actor incarnation OLDER than
        the one the call was pinned to — it must not resolve the task's
        objects (the pinned incarnation's own reply, or a failover path,
        owns that)."""
        with self._pending_lock:
            pend = self._pending_tasks.get(task_id)
            if pend is None:
                return False  # unknown task: normal idempotent-drop path
            spec = pend[0]
            pinned = getattr(spec, "actor_incarnation", None)
            if spec.task_type != TaskType.ACTOR_TASK or pinned is None \
                    or reporter_inc >= pinned:
                return False
        self.stale_reply_rejections += 1
        try:
            from ray_tpu_torch.util.metrics import get_or_create

            get_or_create(
                "counter", "ray_tpu_torch_stale_incarnation_rejections_total",
                "messages rejected for carrying a superseded node/actor "
                "incarnation", tag_keys=("site",)).inc(
                    tags={"site": "task_reply"})
        except Exception:
            pass
        logger.warning(
            "rejected late reply for task %s from superseded actor "
            "incarnation %d (call pinned to %d)", task_id, reporter_inc,
            pinned)
        return True

    def _handle_task_result(self, task_id: TaskID, results) -> None:
        """Apply one task's reported results. Does NOT notify _obj_cv — the
        batch handler wakes waiters once per batch."""
        # Application-level retry (cf. reference retry_exceptions): resubmit
        # instead of recording the error while budget remains. The retry
        # decision (read budget, decrement, or pop) is atomic so a concurrent
        # worker-death notification can't double-spend the budget.
        with self._pending_lock:
            pend = self._pending_tasks.get(task_id)
            cancelled = task_id in self._cancelled_tasks
            retry = (pend is not None and pend[0].retry_exceptions and pend[1] > 0
                     and not cancelled
                     and any(e[0] == "error" for e in results))
            if retry:
                pend[1] -= 1
                retries_left = pend[1]
            else:
                self._pending_tasks.pop(task_id, None)
                self._fence_resends.pop(task_id, None)
            self._task_locations.pop(task_id, None)
        if cancelled:
            if pend is None:
                # the ref already resolved to TaskCancelledError (dequeue
                # ack, kill report, or failsafe): a straggling report must
                # not overwrite the typed terminal state with a value
                return
            # the task outran the cancel (completed in the race window):
            # the outcome is still deterministic — demote to the typed error
            blob = serialization.dumps(TaskCancelledError(
                f"task {pend[0].method_name} was cancelled"))
            results = [("error", e[1], blob) for e in results]
        if retry:
            delay = get_config().task_retry_delay_ms / 1000.0
            spec = pend[0]
            logger.warning("task %s raised; retrying (%d left)", spec.method_name, retries_left)
            self._resubmit_later(spec, delay)
            return
        for entry in results:
            kind, oid = entry[0], entry[1]
            contained = ()
            with self._obj_lock:
                st = self._objects.get(oid)
                if st is None:
                    st = _ObjectState()
                    self._objects[oid] = st
                if kind == "inline":
                    st.state = "inline"
                    st.inline_blob = entry[2]
                    st.size = len(entry[2])
                    contained = entry[3] if len(entry) > 3 else ()
                elif kind == "plasma":
                    st.state = "plasma"
                    st.location = entry[2]
                    st.extra_locations = []  # stale copies died with the old run
                    st.size = entry[3]
                    contained = entry[4] if len(entry) > 4 else ()
                    st.segment = entry[5] if len(entry) > 5 else None
                elif kind == "error":
                    st.state = "error"
                    st.inline_blob = entry[2]
            if contained:
                self._adopt_contained_refs(oid, contained)
            self._notify_info_waiters(oid)
            # The last ref may have died while the task was still pending
            # (_maybe_free's pending guard kept the entry); now that the
            # state is terminal, free if fully unreferenced.
            with self._obj_lock:
                st = self._objects.get(oid)
                if st is not None:
                    self._maybe_free(oid, st)
        self._finish_dynamic(task_id, results)
        if pend is not None:
            self._unpin_after_task(pend[0])

    # -------------------------------------------------- dynamic returns
    def rpc_report_dynamic_return(self, conn, req_id, payload):
        """Executor push: the NEXT object streamed out of a generator task
        we own (num_returns="dynamic", reference _raylet.pyx:997). The
        object registers like a static return, gains a lineage entry (ids
        are deterministic in (task, index), so re-executing the generator
        recovers any lost item), and its ref is appended for the streaming
        ObjectRefGenerator."""
        task_id: TaskID = payload["task_id"]
        entry = payload["entry"]
        kind, oid = entry[0], entry[1]
        contained = ()
        with self._obj_lock:
            st = self._objects.get(oid)
            if st is None:
                st = _ObjectState()
                self._objects[oid] = st
            if kind == "inline":
                st.state = "inline"
                st.inline_blob = entry[2]
                st.size = len(entry[2])
                contained = entry[3] if len(entry) > 3 else ()
            else:
                st.state = "plasma"
                st.location = entry[2]
                st.extra_locations = []
                st.size = entry[3]
                contained = entry[4] if len(entry) > 4 else ()
                st.segment = entry[5] if len(entry) > 5 else None
            with self._pending_lock:
                pend = self._pending_tasks.get(task_id)
                spec = pend[0] if pend else None
            if spec is not None and spec.task_type == TaskType.NORMAL:
                self._lineage[oid] = spec
                dyn = self._task_dynamic_ids.setdefault(task_id, [])
                if oid not in dyn:
                    dyn.append(oid)
            rec = self._dynamic_returns.get(task_id)
            fire = []
            if (rec is not None and not rec["done"]
                    and oid not in rec.setdefault("seen", set())):
                rec["seen"].add(oid)
                # the record's ref holds one refcount unit until the app's
                # ObjectRefGenerator (or the record itself) drops it
                st.local_refs += 1
                ref = ObjectRef(oid, owner_address=self.address)
                ref._counted = True
                rec["refs"].append(ref)
                fire = self._drain_dynamic_waiters(rec)
            self._obj_cv.notify_all()
        for cb in fire:
            try:
                cb()
            except Exception:
                logger.exception("dynamic-return callback failed")
        if contained:
            self._adopt_contained_refs(oid, contained)
        self._notify_info_waiters(oid)
        return True

    def next_dynamic_return(self, task_id: TaskID, i: int):
        """Streaming accessor for ObjectRefGenerator on the owner: block
        until the i-th dynamic return is reported. Returns (ref, done,
        error); ref None means the stream ended."""
        with self._obj_lock:
            while True:
                rec = self._dynamic_returns.get(task_id)
                if rec is None:
                    return None, True, None
                if i < len(rec["refs"]):
                    return rec["refs"][i], False, None
                if rec["done"]:
                    return None, True, rec["error"]
                if self._shutdown.is_set():
                    return None, True, None
                self._obj_cv.wait(timeout=1.0)

    def object_size(self, ref: ObjectRef):
        """Size in bytes of a TERMINAL owned object (None while pending or
        unknown) — the streaming executor's byte-budget accounting reads
        this without fetching values."""
        with self._obj_lock:
            st = self._objects.get(ref.id)
            if st is not None and st.state in ("inline", "plasma"):
                return st.size
        return None

    def add_dynamic_return_callback(self, task_id: TaskID, i: int,
                                    cb) -> None:
        """Event-driven streaming: invoke `cb()` (from whichever thread
        reports the item) once the i-th dynamic return is available OR the
        stream is terminal — at that point the generator's `__next__` is
        guaranteed non-blocking. Fires immediately if already satisfied.
        The async HTTP edge relays token streams with this instead of
        parking a thread per live stream."""
        with self._obj_lock:
            rec = self._dynamic_returns.get(task_id)
            if rec is None or i < len(rec["refs"]) or rec["done"]:
                satisfied = True
            else:
                rec.setdefault("waiters", []).append((i, cb))
                satisfied = False
        if satisfied:
            cb()

    @staticmethod
    def _drain_dynamic_waiters(rec) -> list:
        """Under _obj_lock: pop the waiters whose item (or terminal state)
        is now available; caller invokes them OUTSIDE the lock."""
        waiters = rec.get("waiters")
        if not waiters:
            return []
        n = len(rec["refs"])
        fire = [cb for i, cb in waiters if i < n or rec["done"]]
        if fire:
            rec["waiters"] = [(i, cb) for i, cb in waiters
                              if not (i < n or rec["done"])]
        return fire

    def make_dynamic_generator(self, gen_ref: ObjectRef) -> ObjectRefGenerator:
        """Owner-side streaming generator for a just-submitted dynamic task
        (holds gen_ref so the record and items outlive the submit call)."""
        g = ObjectRefGenerator([], task_id=gen_ref.id.task_id(), done=False)
        g._gen_ref = gen_ref
        return g

    def _finish_dynamic(self, task_id: TaskID, results) -> None:
        """Terminal report arrived for a (possibly) dynamic task: wake the
        streaming iterator, carrying the task error if it failed."""
        with self._obj_lock:
            rec = self._dynamic_returns.get(task_id)
            if rec is None or rec["done"]:
                return
            err = None
            for e in results:
                if e[0] == "error":
                    try:
                        err = serialization.loads(e[2])
                    except Exception:
                        err = TaskError("generator task failed")
            rec["done"] = True
            rec["error"] = err
            fire = self._drain_dynamic_waiters(rec)
            self._obj_cv.notify_all()
        for cb in fire:
            try:
                cb()
            except Exception:
                logger.exception("dynamic-return callback failed")

    def _report_dynamic(self, spec: TaskSpec, entry) -> None:
        """Deliver one streamed item to the owner. Raises on failure (after
        one reconnect retry): a silently-dropped item would leave a hole the
        completed generator still references — failing the whole task (the
        caller of this helper runs inside the executor's try) is the honest
        outcome, and retries/lineage can then re-run the generator."""
        payload = {"task_id": spec.task_id, "entry": entry}
        if spec.owner_address == self.address:
            self.rpc_report_dynamic_return(None, 0, payload)
            return
        try:
            self.peer(spec.owner_address).notify("report_dynamic_return", payload)
        except Exception:
            with self._peers_lock:  # stale conn: retry on a fresh one
                self._peers.pop(spec.owner_address, None)
            self.peer(spec.owner_address).notify("report_dynamic_return", payload)

    _PROBE_METHODS = frozenset({"health", "__ray_ready__", "__ray_terminate__"})

    def rpc_actor_stats(self, conn, req_id, payload):
        """Out-of-band load probe: executing + queued task counts, answered
        from the RPC thread so it can NOT be delayed by the exec queue it
        measures (Serve autoscaling reads this; cf. reference replicas
        pushing queue metrics to the controller out-of-band). `load` excludes
        control-plane probes (health checks) that would otherwise inflate
        every sample by the probe itself."""
        return {"executing": self._executing_count,
                "queued": self._task_queue.qsize(),
                "load": self._load_count}

    def rpc_owner_stats(self, conn, req_id, payload):
        """Live ownership footprint of this process (`ray_tpu_torch jobs` dials
        each RUNNING job's driver for the per-job live numbers the GCS
        doesn't track centrally)."""
        with self._pending_lock:
            pending = len(self._pending_tasks)
        with self._obj_lock:
            owned = len(self._objects)
            owned_bytes = sum((st.size or 0)
                              for st in self._objects.values())
        return {"job_id": self.job_id.binary(), "pending_tasks": pending,
                "owned_objects": owned, "owned_bytes": owned_bytes}

    def rpc_task_spilled(self, conn, req_id, payload):
        """Raylet push: our task was spilled to another node. Recording the
        target is what lets node-level failure reach the owner — when that
        node dies whole (raylet included), no raylet survives to push
        task_worker_died, so the owner fails over on the GCS membership
        event instead (see _fail_tasks_on_node)."""
        task_id: TaskID = payload["task_id"]
        with self._pending_lock:
            if task_id in self._pending_tasks:
                self._task_locations[task_id] = payload["node_id"]
        self._ensure_nodes_subscribed()
        return True

    def _ensure_nodes_subscribed(self) -> None:
        """Lazy nodes-channel subscription: first spill only (workers).
        After the subscribe lands, one spaced reconciliation covers a node
        death that slipped into the subscribe race window."""
        with self._pending_lock:
            if self._nodes_subscribed:
                return
            self._nodes_subscribed = True
        try:
            self.gcs.call("subscribe", {"channels": ["nodes"],
                                        "origin": self.raylet_address})
        except Exception:
            with self._pending_lock:
                self._nodes_subscribed = False
            logger.warning("nodes-channel subscribe failed; relying on "
                           "reconciliation", exc_info=True)
            return
        t = threading.Timer(3.0, self._reconcile_task_locations)
        t.daemon = True
        t.start()

    def _fail_tasks_on_node(self, node_id: bytes, reason: str) -> None:
        """Node-death failover: every pending task last seen on `node_id`
        is treated exactly like a worker death there (retry budget applies).
        Popping the location first makes the event + reconciliation paths
        idempotent — a task only fails over once per (re)submission; its
        next spill records a fresh location."""
        with self._pending_lock:
            doomed = [tid for tid, loc in self._task_locations.items()
                      if loc == node_id]
            for tid in doomed:
                self._task_locations.pop(tid, None)
        for tid in doomed:
            logger.warning("task %s was on dead node %s; failing over",
                           tid, node_id.hex()[:8])
            self.rpc_task_worker_died(None, 0, {
                "task_id": tid, "reason": f"node died: {reason}"})

    def _reconcile_task_locations(self) -> None:
        """Post-reconnect backstop for missed node-removal events: compare
        recorded spill locations against the rebuilt GCS membership. A node
        PRESENT but dead fails over immediately; a node ABSENT might just
        not have re-registered yet (a fresh no-snapshot head starts empty),
        so absence only counts on the second spaced check."""
        with self._pending_lock:
            locs = {tid: loc for tid, loc in self._task_locations.items()}
        if not locs:
            return
        try:
            nodes = self.gcs.call("get_all_nodes", {}, timeout=10)
        except Exception:
            logger.debug("task-location reconcile fetch failed",
                         exc_info=True)
            return
        present = {n["node_id"]: n.get("alive", True) for n in nodes}
        rearm = False
        for node_id in set(locs.values()):
            alive = present.get(node_id)
            if alive is False:
                self._fail_tasks_on_node(node_id, "dead after GCS restart")
            elif alive is None:
                if node_id in self._absent_nodes:
                    self._absent_nodes.discard(node_id)
                    self._fail_tasks_on_node(
                        node_id, "gone after GCS restart")
                else:
                    # first strike: give the raylet one more window to
                    # re-register before declaring its tasks lost
                    self._absent_nodes.add(node_id)
                    rearm = True
            else:
                self._absent_nodes.discard(node_id)
        if rearm:
            t = threading.Timer(5.0, self._reconcile_task_locations)
            t.daemon = True
            t.start()

    def rpc_task_worker_died(self, conn, req_id, payload):
        """Raylet push: the worker running our task died. Retry or fail."""
        task_id: TaskID = payload["task_id"]
        with self._pending_lock:
            pend = self._pending_tasks.get(task_id)
            if pend is None:
                return True
            self._task_locations.pop(task_id, None)
            spec = pend[0]
            retry = pend[1] > 0
            if retry:
                pend[1] -= 1
                retries_left = pend[1]
            else:
                self._pending_tasks.pop(task_id, None)
        if retry:
            logger.warning("task %s worker died (%s); retrying (%d left)",
                           spec.method_name, payload.get("reason") or "crash",
                           retries_left)
            self._resubmit_later(spec, get_config().task_retry_delay_ms / 1000.0)
            return True
        if payload.get("reason") == "cancelled":
            # force=True escalation: the raylet SIGKILLed the worker on our
            # cancel — non-retryable by construction (the cancel zeroed the
            # budget), resolved typed
            err_blob = serialization.dumps(TaskCancelledError(
                f"task {spec.method_name} was force-cancelled "
                f"(worker killed)"))
        elif payload.get("reason") == "oom":
            from ray_tpu_torch.core.exceptions import OutOfMemoryError

            err_blob = serialization.dumps(OutOfMemoryError(
                f"task {spec.method_name} was killed by the memory monitor "
                f"under node memory pressure (retries exhausted)"))
        else:
            err_blob = serialization.dumps(WorkerCrashedError(
                f"worker died while running {spec.method_name}"))
        for oid in spec.return_object_ids():
            with self._obj_lock:
                st = self._objects.get(oid)
                if st is not None and st.state == "pending":
                    st.state = "error"
                    st.inline_blob = err_blob
                    self._obj_cv.notify_all()
            self._notify_info_waiters(oid)
        self._finish_dynamic(task_id, [("error", None, err_blob)])
        self._unpin_after_task(spec)
        return True

    def rpc_task_failed(self, conn, req_id, payload):
        """Raylet push: task cannot run (e.g. runtime-env creation failed).
        Deterministic — fail the returns without retrying."""
        task_id: TaskID = payload["task_id"]
        with self._pending_lock:
            pend = self._pending_tasks.pop(task_id, None)
            self._task_locations.pop(task_id, None)
        if pend is None:
            return True
        spec = pend[0]
        from ray_tpu_torch.core.exceptions import RuntimeEnvSetupError

        err_blob = serialization.dumps(RuntimeEnvSetupError(payload["error"]))
        for oid in spec.return_object_ids():
            with self._obj_lock:
                st = self._objects.get(oid)
                if st is not None and st.state == "pending":
                    st.state = "error"
                    st.inline_blob = err_blob
                    self._obj_cv.notify_all()
            self._notify_info_waiters(oid)
        self._finish_dynamic(task_id, [("error", None, err_blob)])
        self._unpin_after_task(spec)
        return True

    def rpc_add_borrower(self, conn, req_id, payload):
        """Borrow registration, scoped to the borrower's CONNECTION: if the
        borrower process dies, its connection drop releases every borrow it
        held — a died borrower can no longer leak objects forever (the
        liveness role of the reference's WaitForRefRemoved long-polls,
        reference_count.h:834)."""
        oid = payload["object_id"]
        with self._obj_lock:
            st = self._objects.get(oid)
            if st is None:
                return True
            st.borrowers += 1
            if conn is not None:
                key = id(conn)
                m = self._conn_borrows.get(key)
                if m is None:
                    m = self._conn_borrows[key] = {}
                    conn.on_close.append(
                        lambda c, k=key: self._on_borrower_conn_close(k))
                m[oid] = m.get(oid, 0) + 1
        return True

    def rpc_remove_borrower(self, conn, req_id, payload):
        """Symmetric to rpc_add_borrower: the decrement is honored only when
        THIS connection's map recorded the borrow. A remove arriving on a
        fresh connection after the old one's close already released the
        borrow must be a no-op — an unconditional decrement would free an
        object out from under a different live borrower."""
        oid = payload["object_id"]
        with self._obj_lock:
            recorded = conn is None  # internal calls bypass conn accounting
            if conn is not None:
                m = self._conn_borrows.get(id(conn))
                if m is not None and m.get(oid, 0) > 0:
                    recorded = True
                    left = m[oid] - 1
                    if left > 0:
                        m[oid] = left
                    else:
                        m.pop(oid, None)
            st = self._objects.get(oid)
            if st is not None and recorded:
                st.borrowers = max(0, st.borrowers - 1)
                self._maybe_free(oid, st)
        return True

    def rpc_remove_borrowers(self, conn, req_id, payload):
        """Batched rpc_remove_borrower: one notify releases many borrows
        (the borrower's owner-notify loop coalesces a GC storm per owner
        before it reaches the wire)."""
        for oid in payload["object_ids"]:
            self.rpc_remove_borrower(conn, req_id, {"object_id": oid})
        return True

    def _on_borrower_conn_close(self, conn_key: int) -> None:
        """The borrower's process or its link died: release every borrow
        registered over that connection, BORROW_RECONNECT_WINDOW_S
        later. A live borrower's link reconnects and replays its borrows
        within that window (counted afresh on the new connection), so an
        object it still holds is never freed in between; a dead borrower's
        borrows go when the window ends."""
        with self._obj_lock:
            m = self._conn_borrows.pop(conn_key, None)
        if not m:
            return
        t = threading.Timer(BORROW_RECONNECT_WINDOW_S,
                            self._release_conn_borrows, args=(m,))
        t.daemon = True
        t.start()

    def _release_conn_borrows(self, m: Dict[ObjectID, int]) -> None:
        with self._obj_lock:
            for oid, count in m.items():
                st = self._objects.get(oid)
                if st is not None:
                    st.borrowers = max(0, st.borrowers - count)
                    self._maybe_free(oid, st)
        logger.debug("released %d borrows of a closed borrower connection",
                     sum(m.values()))

    # ------------------------------------------------------------- ref count
    def _remove_owned_local_ref(self, oid: ObjectID) -> None:
        with self._obj_lock:
            st = self._objects.get(oid)
            if st is None:
                return
            st.local_refs -= 1
            self._maybe_free(oid, st)

    def add_local_ref(self, oid: ObjectID) -> None:
        with self._obj_lock:
            st = self._objects.get(oid)
            if st is not None:
                st.local_refs += 1

    def _maybe_free(self, oid: ObjectID, st: _ObjectState) -> None:
        """Caller holds _obj_lock. Free the object when fully unreferenced.

        Objects whose refs were serialized outward get a grace period before
        the plasma delete: a receiver's add_borrower notify may still be in
        flight when the owner's last local ref dies (the reference resolves
        this with the full borrow-table protocol, reference_count.h:834; the
        grace window + lineage recovery approximate it)."""
        if (st.local_refs > 0 or st.borrowers > 0
                or st.submitted_task_deps > 0 or st.container_pinned > 0):
            st.free_after = None
            return
        if st.state == "pending":
            return  # task still running; lineage bookkeeping keeps it
        if st.shipped and st.state in ("plasma", "inline"):
            # Inline objects race identically: the receiver's add_borrower
            # notify may be in flight when the owner's last ref dies.
            if st.free_after is None:
                grace_ms = get_config().object_free_grace_period_ms
                if oid not in self._lineage:
                    # No lineage means no reconstruction backstop (puts and
                    # actor returns, worker.py _register_returns): a borrow
                    # landing after the free would be an UNRECOVERABLE loss,
                    # so give the registration far longer to arrive — it may
                    # be stuck behind an owner-link reconnect backoff.
                    grace_ms *= 10
                st.free_after = time.monotonic() + grace_ms / 1000.0
                self._deferred_frees.append(oid)
                self._ensure_free_sweeper()
            return
        self._objects.pop(oid, None)
        self._release_contained_pins(st)
        self._drop_dynamic_record(oid)
        self._delete_plasma(oid, st)

    def _drop_dynamic_record(self, oid: ObjectID) -> None:
        """Caller holds _obj_lock. The first return object of a task was
        freed; if it was a generator's main object, drop the streaming
        record (its counted item refs release on GC)."""
        if oid.return_index() == 1:
            self._dynamic_returns.pop(oid.task_id(), None)

    def _release_contained_pins(self, st: _ObjectState) -> None:
        """Caller holds _obj_lock. The container object is gone: drop the
        pins it held on owned refs nested inside its payload, and the
        counted borrow refs for other-owned inner objects (their __del__
        notifies the owners off-thread)."""
        pins, st.contained_pins = st.contained_pins, []
        st.contained_borrows = []
        for inner in pins:
            ist = self._objects.get(inner)
            if ist is not None:
                ist.container_pinned = max(0, ist.container_pinned - 1)
                self._maybe_free(inner, ist)

    def _adopt_contained_refs(self, container_oid: ObjectID, contained) -> None:
        """A task return we own carries nested refs: keep each inner object
        alive for the CONTAINER's lifetime — a reader may deserialize the
        payload (registering its own borrow only then) arbitrarily late.
        Caller-owned inner refs get a container pin (like put()); refs owned
        elsewhere (e.g. the executing actor) get a counted borrow held by
        the container (reference nested-ref tracking, reference_count.h:834)."""
        borrows = []
        for ioid, iowner in contained:
            if iowner == self.address:
                with self._obj_lock:
                    cst = self._objects.get(container_oid)
                    ist = self._objects.get(ioid)
                    # a re-reported task (retry/reconstruction) must not
                    # double-pin: ids are deterministic across re-runs
                    if (cst is not None and ist is not None
                            and ioid != container_oid
                            and ioid not in cst.contained_pins):
                        ist.container_pinned += 1
                        cst.contained_pins.append(ioid)
            else:
                with self._obj_lock:
                    cst = self._objects.get(container_oid)
                    if cst is not None and any(
                            b.id == ioid for b in cst.contained_borrows):
                        continue  # re-report: borrow already held
                r = ObjectRef(ioid, owner_address=iowner)
                self.reference_counter.add_borrowed(r)
                r._counted = True
                borrows.append(r)
        if borrows:
            with self._obj_lock:
                cst = self._objects.get(container_oid)
                if cst is not None:
                    cst.contained_borrows.extend(borrows)
            # container already freed: `borrows` dies here and the refs'
            # __del__ releases the just-taken borrows

    def _delete_plasma(self, oid: ObjectID, st: _ObjectState) -> None:
        if st.state != "plasma":
            return
        for loc in [st.location] + st.extra_locations:
            if not loc:
                continue
            try:
                if loc == self.raylet_address:
                    self.raylet.notify("obj_delete", {"object_id": oid})
                else:
                    self.peer(loc).notify("obj_delete", {"object_id": oid})
            except OSError as e:
                # location holder died; its store died with it
                logger.debug("obj_delete to %s lost: %s", loc, e)

    # ------------------------------------------------------------- push
    def push_object(self, ref: ObjectRef, node_ids=None) -> int:
        """Owner-directed broadcast (reference push_manager.h:29): stream an
        owned, sealed plasma object into other nodes' stores AHEAD of
        demand, so N downstream readers hit a local copy instead of all
        pulling from one source. node_ids: restrict targets (hex or bytes
        node ids); None = every other alive node. Returns the number of
        push targets. Fire-and-forget: delivery registers new locations
        with this owner as copies land."""
        if ref.owner_address not in ("", self.address):
            raise ValueError("push() requires a ref owned by this process")
        with self._obj_lock:
            st = self._objects.get(ref.id)
            if st is None or st.state != "plasma" or not st.location:
                raise ValueError(
                    "push() needs a sealed plasma object (small objects are "
                    "inlined and need no push)")
            location = st.location
            have = {location, *st.extra_locations}
        if node_ids is not None:
            wanted = {n.hex() if isinstance(n, (bytes, bytearray)) else str(n)
                      for n in node_ids}
        targets = []
        for n in self.gcs.call("get_all_nodes", {}):
            if not n.get("alive") or n["address"] in have:
                continue
            if node_ids is not None:
                nid = n["node_id"]
                nid_hex = nid.hex() if isinstance(nid, (bytes, bytearray)) else str(nid)
                if nid_hex not in wanted:
                    continue
            targets.append(n["address"])
        if not targets:
            return 0
        payload = {"object_id": ref.id, "targets": targets,
                   "owner_address": self.address}
        if location == self.raylet_address:
            self.raylet.notify("push_object", payload)
        else:
            self.peer(location).notify("push_object", payload)
        try:
            from ray_tpu_torch.util.metrics import get_or_create

            get_or_create("counter", "ray_tpu_torch_push_requests_total",
                          "push() broadcasts dispatched").inc()
            get_or_create("counter", "ray_tpu_torch_push_targets_total",
                          "cumulative push fan-out targets").inc(
                              len(targets))
        except (ValueError, KeyError) as e:
            logger.debug("push metrics unavailable: %s", e)
        return len(targets)

    def _notify_owner_async(self, owner: str, method: str, payload: dict) -> None:
        self._owner_notify_q.put((owner, method, payload))
        # The lock pairs with the loop's exit decision: either the live
        # thread sees our item (queue non-empty under the lock), or it has
        # cleared _owner_notify_thread and we start a fresh one — an item
        # can never be stranded behind a thread that decided to exit.
        with self._owner_notify_lock:
            t = self._owner_notify_thread
            if t is None or not t.is_alive():
                t = threading.Thread(target=self._owner_notify_loop,
                                     name="owner-notify", daemon=True)
                self._owner_notify_thread = t
                t.start()

    def _owner_notify_loop(self) -> None:
        while not self._shutdown.is_set():
            try:
                item = self._owner_notify_q.get(timeout=5)
            except queue.Empty:
                with self._owner_notify_lock:
                    if self._owner_notify_q.empty():
                        self._owner_notify_thread = None
                        return  # idle: next release starts a fresh thread
                continue
            # Drain everything already queued: a GC storm's remove_borrower
            # releases coalesce into ONE batched notify per owner per drain
            # instead of one RPC per dropped ref (completion-path fast lane).
            items = [item]
            while True:
                try:
                    items.append(self._owner_notify_q.get_nowait())
                except queue.Empty:
                    break
            sends: List[Tuple[str, str, dict]] = []
            batches: Dict[str, list] = {}
            for owner, method, payload in items:
                if method == "remove_borrower":
                    b = batches.get(owner)
                    if b is None:
                        b = batches[owner] = []
                        sends.append((owner, "remove_borrowers",
                                      {"object_ids": b}))
                    b.append(payload["object_id"])
                else:
                    sends.append((owner, method, payload))
            for owner, method, payload in sends:
                try:
                    # Same link the borrow was registered over: the owner's
                    # conn-scoped accounting only honors removes that arrive
                    # on the connection that recorded the add.
                    self.reference_counter.owner_link(owner).notify(method, payload)
                except (OSError, RuntimeError, TimeoutError):
                    logger.debug("%s notify to %s failed", method, owner)

    def _ensure_free_sweeper(self) -> None:
        if self._free_sweeper is None or not self._free_sweeper.is_alive():
            t = threading.Thread(target=self._free_sweep_loop,
                                 name="free-sweeper", daemon=True)
            self._free_sweeper = t
            t.start()

    def _free_sweep_loop(self) -> None:
        while not self._shutdown.is_set():
            time.sleep(0.1)
            due: List[Tuple[ObjectID, _ObjectState]] = []
            now = time.monotonic()
            with self._obj_lock:
                remaining: deque = deque()
                while self._deferred_frees:
                    oid = self._deferred_frees.popleft()
                    st = self._objects.get(oid)
                    if st is None or st.free_after is None:
                        continue  # resurrected or already freed
                    if st.free_after > now:
                        remaining.append(oid)
                        continue
                    if (st.local_refs > 0 or st.borrowers > 0
                            or st.submitted_task_deps > 0
                            or st.container_pinned > 0):
                        st.free_after = None  # a borrow landed within grace
                        continue
                    self._objects.pop(oid, None)
                    self._release_contained_pins(st)
                    self._drop_dynamic_record(oid)
                    due.append((oid, st))
                self._deferred_frees = remaining
                if not self._deferred_frees and not due:
                    # Nothing left: exit instead of idling forever. Cleared
                    # under _obj_lock, which every _ensure_free_sweeper caller
                    # holds, so a concurrent deferral can't miss the restart.
                    self._free_sweeper = None
                    return
            for oid, st in due:
                self._delete_plasma(oid, st)

    # --------------------------------------------------------------- actors
    def create_actor(self, spec: ActorCreationSpec, class_name: str) -> None:
        if spec.runtime_env and spec.runtime_env.get("py_modules"):
            from ray_tpu_torch.runtime_env import upload_py_modules

            spec.runtime_env = upload_py_modules(spec.runtime_env, self.gcs)
        # owning job: the fate-sharing reap kills non-detached actors of a
        # dead job by this stamp (detached actors are GCS-owned and exempt)
        spec.job_id = self.job_id
        r = self.gcs.call("register_actor", {
            "spec": spec, "owner_address": self.address, "class_name": class_name})
        if isinstance(r, dict) and r.get("error"):
            raise ValueError(r["error"])

    def submit_actor_task(
        self,
        actor_id: ActorID,
        method_name: str,
        args: tuple,
        kwargs: dict,
        num_returns: int = 1,
        concurrency_group: str = None,
    ) -> List[ObjectRef]:
        task_id = self._task_counter.next_task_id()
        with self._actor_seq_lock:
            seq = self._actor_seq_counters.get(actor_id, 0)
            self._actor_seq_counters[actor_id] = seq + 1
        spec = TaskSpec(
            task_id=task_id,
            job_id=self.job_id,
            task_type=TaskType.ACTOR_TASK,
            function_blob=None,
            method_name=method_name,
            args=self._serialize_args(args, task_id),
            kwargs_blob=serialization.dumps(kwargs) if kwargs else None,
            num_returns=num_returns,
            owner_address=self.address,
            owner_worker_id=self.worker_id,
            actor_id=actor_id,
            sequence_number=seq,
            caller_id=self.worker_id,
            concurrency_group=concurrency_group,
            parent_task_id=self._parent_for_submit(),
        )
        t_sub = self._stamp_trace_ctx(spec)
        refs = self._register_returns(spec)
        with self._pending_lock:
            self._pending_tasks[task_id] = [spec, 0]
        self._emit_task_event(spec, "SUBMITTED")
        self._send_actor_task(actor_id, spec, attempts=0)
        self._record_submit_span(spec, t_sub)
        return refs

    def _send_actor_task(self, actor_id: ActorID, spec: TaskSpec, attempts: int) -> None:
        dead_reason = self._actor_dead.get(actor_id)
        if dead_reason is not None:
            self._fail_task(spec, ActorDiedError(dead_reason))
            return
        addr = self._actor_addresses.get(actor_id)
        if addr is None:
            addr = self._wait_actor_address(actor_id, spec)
            if addr is None:
                return  # _fail_task already called
        # pin the call to the incarnation this address was learned with:
        # the target refuses a mismatch, so the call can never be serviced
        # by a superseded instance a partition kept alive (nor accepted by
        # a newer one the caller hasn't resolved yet)
        spec.actor_incarnation = self._actor_incarnations.get(actor_id)
        try:
            # short dial budget: this address came from a LIVE registration
            # (GCS state or a pubsub push), so a refused connect means the
            # actor's worker died — fail fast into the re-resolve path
            # below instead of spinning the full 30 s connect retry on a
            # corpse (a node kill makes every stale-address submit hit
            # this)
            self.peer(addr, connect_timeout_s=min(
                5.0, get_config().rpc_connect_timeout_s)).notify(
                    "push_actor_task", {"spec": spec})
        except Exception:
            # stale address: refresh once, then give up to GCS state
            self._actor_addresses.pop(actor_id, None)
            if attempts < 3:
                time.sleep(0.2 * (attempts + 1))
                self._send_actor_task(actor_id, spec, attempts + 1)
            else:
                self._fail_task(spec, ActorDiedError(
                    f"actor {actor_id} unreachable"))

    def _wait_actor_address(self, actor_id: ActorID, spec: TaskSpec,
                            timeout: float = 60.0) -> Optional[str]:
        """Wait for the actor to become ALIVE: pubsub pushes (drivers are
        subscribed to the actors channel) wake the condition variable
        instantly; an authoritative GCS poll runs as a 1 s fallback so
        non-subscribed workers still converge without hammering the GCS at
        the old 100 ms cadence."""
        deadline = time.monotonic() + timeout
        poll_next = 0.0
        while time.monotonic() < deadline:
            addr = self._actor_addresses.get(actor_id)
            if addr is not None:
                return addr
            dead = self._actor_dead.get(actor_id)
            if dead is not None:
                self._fail_task(spec, ActorDiedError(dead))
                return None
            now = time.monotonic()
            if now >= poll_next:
                poll_next = now + 1.0
                info = self.gcs.call("get_actor_info", {"actor_id": actor_id},
                                     timeout=10)
                if info is None:
                    self._fail_task(spec, ActorDiedError(f"actor {actor_id} unknown"))
                    return None
                if info["state"] == "ALIVE":
                    if info.get("incarnation") is not None:
                        self._actor_incarnations[actor_id] = \
                            info["incarnation"]
                    self._actor_addresses[actor_id] = info["address"]
                    return info["address"]
                if info["state"] == "DEAD":
                    self._actor_dead[actor_id] = info["death_cause"] or "actor died"
                    self._fail_task(spec, ActorDiedError(self._actor_dead[actor_id]))
                    return None
            with self._actor_cv:
                self._actor_cv.wait(timeout=0.1)
        self._fail_task(spec, ActorDiedError(f"timed out waiting for actor {actor_id}"))
        return None

    def _resubmit_later(self, spec: TaskSpec, delay: float) -> None:
        """Schedule a delayed task resubmission on the shared retry timer
        (one thread for all in-flight retry delays; started lazily, exits
        when the heap drains)."""
        with self._resubmit_cv:
            self._resubmit_seq += 1
            heapq.heappush(self._resubmit_heap,
                           (time.monotonic() + delay, self._resubmit_seq, spec))
            t = self._resubmit_thread
            if t is None or not t.is_alive():
                t = threading.Thread(target=self._resubmit_loop,
                                     name="task-resubmit", daemon=True)
                self._resubmit_thread = t
                t.start()
            self._resubmit_cv.notify_all()

    def _resubmit_loop(self) -> None:
        while not self._shutdown.is_set():
            with self._resubmit_cv:
                if not self._resubmit_heap:
                    self._resubmit_cv.wait(timeout=1.0)
                    if not self._resubmit_heap:
                        # Exit decision under the cv: _resubmit_later holds it
                        # while pushing + checking liveness, so an item can
                        # never strand behind a thread that chose to exit.
                        self._resubmit_thread = None
                        return
                due, _, spec = self._resubmit_heap[0]
                wait = due - time.monotonic()
                if wait > 0:
                    self._resubmit_cv.wait(timeout=wait)
                    continue
                heapq.heappop(self._resubmit_heap)
            try:
                self.raylet.notify("submit_task", {"spec": spec})
            except Exception:
                logger.warning("delayed resubmit of %s lost (raylet down?)",
                               spec.method_name)

    def _fail_task(self, spec: TaskSpec, err: Exception) -> None:
        with self._pending_lock:
            self._pending_tasks.pop(spec.task_id, None)
            self._task_locations.pop(spec.task_id, None)
            if (spec.task_id in self._cancelled_tasks
                    and not isinstance(err, TaskCancelledError)):
                # once cancel() claimed the task, every failure path
                # resolves typed — an actor-death or timeout racing the
                # cancel must not change the contract
                err = TaskCancelledError(
                    f"task {spec.method_name} was cancelled ({err})")
        self._fence_resends.pop(spec.task_id, None)
        blob = serialization.dumps(err)
        for oid in spec.return_object_ids():
            with self._obj_lock:
                st = self._objects.get(oid)
                if st is not None:
                    st.state = "error"
                    st.inline_blob = blob
                    self._obj_cv.notify_all()
            self._notify_info_waiters(oid)
        self._finish_dynamic(spec.task_id, [("error", None, blob)])
        self._unpin_after_task(spec)

    # --------------------------------------------------------------- cancel
    def _parent_for_submit(self) -> Optional[TaskID]:
        """Lineage stamp for recursive cancellation: the task THIS thread
        was executing when it submitted (None for driver-root submits)."""
        cur = self._current_task_id
        return None if cur == self._root_task_id else cur

    def cancel(self, ref: ObjectRef, *, force: bool = False,
               recursive: bool = False) -> None:
        """Cancel the task producing `ref`. Best-effort on the work, hard
        guarantee on the ref: once claimed here, the ref resolves to
        TaskCancelledError — via raylet dequeue (still queued), cooperative
        interrupt (running; force=True escalates to SIGKILL through the
        worker-died path), actor-mailbox purge, or the local failsafe if
        every downstream ack is lost. A task that already completed keeps
        its value (reference semantics). recursive=True walks the lineage
        (parent_task_id) hop by hop so the whole tree dies leaf-ward."""
        self.cancel_task(ref.id.task_id(), force=force, recursive=recursive)

    def cancel_task(self, task_id: TaskID, *, force: bool = False,
                    recursive: bool = False) -> None:
        now = time.monotonic()
        with self._pending_lock:
            pend = self._pending_tasks.get(task_id)
            already = task_id in self._cancelled_tasks
            if pend is None:
                return  # completed (value stands) or never ours: no-op
            self._cancelled_tasks[task_id] = now
            # opportunistic prune: the guard entries only matter while a
            # straggler report can still arrive
            if len(self._cancelled_tasks) > 64:
                for tid, ts in list(self._cancelled_tasks.items()):
                    if now - ts > 600.0 and tid not in self._pending_tasks:
                        del self._cancelled_tasks[tid]
            pend[1] = 0  # a cancelled task is never retried
            spec = pend[0]
            location = self._task_locations.get(task_id)
        if already:
            return  # double-cancel: the first claim owns resolution
        self._emit_task_event(spec, "CANCELLED")
        payload = {"task_id": task_id, "force": force,
                   "recursive": recursive, "owner_address": self.address}
        try:
            if spec.task_type == TaskType.ACTOR_TASK:
                # the call sits in the target actor's mailbox (queued) or on
                # one of its exec threads (running): cancel at the actor
                addr = self._actor_addresses.get(spec.actor_id)
                if addr is not None:
                    self.peer(addr, connect_timeout_s=min(
                        5.0, get_config().rpc_connect_timeout_s)).notify(
                            "cancel_task", payload)
                else:
                    # still parked on actor resolution: nothing downstream
                    # holds it — resolve right here
                    self._fail_cancelled(spec)
                    return
            else:
                if location is not None:
                    # spilled: our raylet forwards to the node holding it
                    payload["spilled_node_id"] = location
                self.raylet.notify("cancel_task", payload)
        except Exception:
            logger.debug("cancel notify for %s lost", task_id, exc_info=True)
        # Failsafe: a cancelled ref may NEVER hang. If no downstream ack
        # (dequeue notify, cooperative error report, kill report) resolves
        # the ref within the window, resolve it typed locally.
        t = threading.Timer(get_config().task_cancel_resolution_timeout_s,
                            self._cancel_failsafe, args=(task_id,))
        t.daemon = True
        t.start()

    def _cancel_failsafe(self, task_id: TaskID) -> None:
        with self._pending_lock:
            pend = self._pending_tasks.get(task_id)
        if pend is None:
            return
        logger.warning(
            "cancel of %s got no downstream resolution within %.1fs; "
            "resolving locally", pend[0].method_name,
            get_config().task_cancel_resolution_timeout_s)
        self._fail_cancelled(pend[0], "cancelled (no executor ack)")

    def _fail_cancelled(self, spec: TaskSpec, detail: str = "") -> None:
        self._fail_task(spec, TaskCancelledError(
            detail or f"task {spec.method_name} was cancelled"))

    def rpc_task_cancelled(self, conn, req_id, payload):
        """Raylet ack: the task was dequeued (or purged in a job reap)
        before running — resolve its refs to the typed error."""
        task_id: TaskID = payload["task_id"]
        with self._pending_lock:
            pend = self._pending_tasks.get(task_id)
            self._cancelled_tasks.setdefault(task_id, time.monotonic())
        if pend is not None:
            self._fail_cancelled(pend[0], payload.get("detail") or "")
        return True

    def rpc_cancel_task(self, conn, req_id, payload):
        """Executor-side cancel (pushed by an owner at the hosting actor's
        address, or relayed by our raylet for a plain task running here)."""
        self._handle_exec_cancel(payload["task_id"],
                                 force=bool(payload.get("force")),
                                 recursive=bool(payload.get("recursive")),
                                 owner_address=payload.get("owner_address"))
        return True

    def _handle_exec_cancel(self, task_id: TaskID, *, force: bool,
                            recursive: bool,
                            owner_address: Optional[str] = None) -> None:
        """This PROCESS hosts the task (queued in a mailbox/exec queue, or
        running on an exec thread): cancel it, children first."""
        if recursive:
            # tasks WE submitted while executing task_id are our pending
            # entries stamped with it as parent — full owner-side cancel
            # for each (they may be queued here, remote, or actor calls)
            with self._pending_lock:
                kids = [tid for tid, (spec, _r) in self._pending_tasks.items()
                        if spec.parent_task_id == task_id]
            for kid in kids:
                try:
                    self.cancel_task(kid, force=force, recursive=True)
                except Exception:
                    logger.debug("recursive cancel of child %s failed",
                                 kid, exc_info=True)
        with self._cancel_lock:
            self._cancelled_exec.add(task_id)
            thread_ident = self._exec_thread_ids.get(task_id)
        if thread_ident is not None:
            self._inject_cancel(task_id, thread_ident)
        elif owner_address:
            # Mailbox purge: the call is parked in this process's exec
            # queue (possibly behind a long-running method) and nothing
            # reports for it until it would have been dequeued — resolve
            # the owner's ref NOW. The eventual precancelled dequeue ships
            # a duplicate typed error the owner drops as a straggler.
            try:
                self.peer(owner_address, connect_timeout_s=min(
                    5.0, get_config().rpc_connect_timeout_s)).notify(
                        "task_cancelled",
                        {"task_id": task_id,
                         "detail": "cancelled while queued (mailbox purge)"})
            except Exception:
                logger.debug("mailbox-purge ack to %s lost", owner_address,
                             exc_info=True)

    def _inject_cancel(self, task_id: TaskID, thread_ident: int) -> None:
        """Cooperative interruption of a RUNNING task: raise
        TaskCancelledError inside the executing thread at its next bytecode
        boundary (a task parked in a long C call only observes it on
        return — force=True exists for those). The exec loop also guards
        against an injection landing after the task finished."""
        import ctypes

        res = ctypes.pythonapi.PyThreadState_SetAsyncExc(
            ctypes.c_ulong(thread_ident),
            ctypes.py_object(TaskCancelledError))
        if res > 1:
            # invalid state: undo so an unrelated thread isn't poisoned
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(thread_ident), None)
        logger.info("injected cancel into thread running task %s", task_id)

    def _log_print_queue(self) -> "queue.Queue":
        q = getattr(self, "_log_queue", None)
        if q is None:
            q = queue.Queue()
            self._log_queue = q

            def printer():
                import sys as _sys

                while not self._shutdown.is_set():
                    try:
                        msg = q.get(timeout=0.5)
                    except queue.Empty:
                        continue
                    out = (_sys.stderr if msg.get("stream") == "stderr"
                           else _sys.stdout)
                    for line in msg.get("lines", []):
                        print(f"(pid={msg.get('pid')}) {line}", file=out)

            threading.Thread(target=printer, name="log-printer",
                             daemon=True).start()
        return q

    def _resolve_gcs_address(self) -> Optional[str]:
        """Current-best GCS address for a reconnect attempt (control-plane
        HA): the address file when configured, else ask our raylet — its
        own reconnect loop follows a promoted/replacement head, so its
        answer is the freshest in-band source. None = keep the last-known
        address and retry; an EMPTY answer (torn address file mid-failover,
        a raylet with nothing better than our own guess) is never treated
        as an address to dial."""
        addr = rpc.read_gcs_address_file()
        if addr:
            return addr
        raylet = getattr(self, "raylet", None)
        if raylet is not None and not raylet.closed:
            try:
                return raylet.call("get_gcs_address", {}, timeout=2) or None
            except Exception:
                pass
        return None

    def _replay_gcs_state(self, raw: rpc.RpcClient) -> None:
        """Rebuild this process's GCS-side state after a GCS restart (uses
        the RAW client — the reconnecting wrapper's lock is held)."""
        # the link may have followed a head replacement to a new address
        self.gcs_address = raw.address
        # re-export the function table entries this process owns: a fresh
        # GCS (no snapshot) must still resolve ids from in-flight specs
        self.function_table.replay_exports(raw)
        if self.mode == "driver":
            raw.call("register_job", {
                "job_id": self.job_id.binary(),
                "driver_address": self._server.address,
            }, timeout=30)
            channels = ["actors", "nodes"]
            if self.log_to_driver:
                channels.append("logs")
            raw.call("subscribe", {"channels": channels,
                                   "origin": self.raylet_address},
                     timeout=30)
        else:
            # workers subscribe to the nodes channel LAZILY (first spill
            # only — see _nodes_subscribed): re-establish the subscription
            # across the reconnect only if it existed; an unconditional
            # subscribe would make every warm-forked worker a permanent
            # nodes-channel fan-out target after any head failover
            with self._pending_lock:
                resub = self._nodes_subscribed
            if resub:
                raw.call("subscribe", {"channels": ["nodes"],
                                       "origin": self.raylet_address},
                         timeout=30)
        # The reconnect window may have swallowed node-removal events for
        # nodes holding our spilled tasks (the classic pairing: node death
        # AND a GCS restart). Reconcile the location table against the
        # rebuilt membership off-thread, after re-registrations settle.
        with self._pending_lock:
            has_locs = bool(self._task_locations)
        if has_locs:
            t = threading.Timer(3.0, self._reconcile_task_locations)
            t.daemon = True
            t.start()
        with self._channel_cb_lock:
            dynamic = [ch for ch, cbs in self._channel_callbacks.items() if cbs]
        if dynamic:
            raw.call("subscribe", {"channels": dynamic,
                                   "origin": self.raylet_address},
                     timeout=30)
        if self.actor_id is not None and self._actor_instance is not None:
            spec = self._actor_creation_spec
            reply = raw.call("reregister_actor", {
                "actor_id": self.actor_id,
                "address": self.address,
                "node_id": self.node_id,
                "incarnation": self._actor_incarnation,
                "spec": spec,
            }, timeout=30)
            if isinstance(reply, dict) and reply.get("fenced"):
                # our incarnation was superseded while this process was
                # unreachable (the actor lives elsewhere now): exit rather
                # than ever answering a call again
                logger.warning(
                    "actor %s incarnation %d fenced at re-register: %s — "
                    "exiting", self.actor_id, self._actor_incarnation,
                    reply.get("reason"))
                self._fenced_exit()
                return
            logger.info("actor %s re-registered with restarted GCS",
                        self.actor_id)

    # ---------------------------------------------------------- app pubsub
    def subscribe_channel(self, channel: str, callback) -> None:
        """Subscribe to an application pubsub channel; `callback(message)`
        runs on the GCS push reader thread (keep it non-blocking). Survives
        GCS restart: dynamic channels are replayed on re-subscribe."""
        with self._channel_cb_lock:
            cbs = self._channel_callbacks.setdefault(channel, [])
            first = not cbs
            cbs.append(callback)
        if first:
            self.gcs.call("subscribe", {"channels": [channel],
                                        "origin": self.raylet_address},
                          timeout=30)

    def unsubscribe_channel(self, channel: str, callback) -> None:
        with self._channel_cb_lock:
            cbs = self._channel_callbacks.get(channel, [])
            if callback in cbs:
                cbs.remove(callback)
            empty = not cbs
            if empty:
                self._channel_callbacks.pop(channel, None)
        if empty:
            try:  # drop the GCS-side fan-out entry too
                self.gcs.notify("unsubscribe", {"channels": [channel]})
            except OSError as e:
                logger.debug("unsubscribe lost (GCS down?): %s", e)

    def publish(self, channel: str, message) -> None:
        self.gcs.notify("publish", {"channel": channel, "message": message})

    def _on_gcs_push(self, method: str, payload) -> None:
        if method != "pubsub":
            return
        with self._channel_cb_lock:
            cbs = list(self._channel_callbacks.get(payload["channel"], ()))
        for cb in cbs:
            try:
                cb(payload["message"])
            except Exception:
                logger.exception("pubsub callback failed on %s",
                                 payload["channel"])
        if payload["channel"] == "logs":
            msg = payload["message"]
            # only this driver's job (unattributed lines pass through);
            # printed from a dedicated thread so a blocked stdout can't
            # stall the rpc reader that also carries actor updates
            job = msg.get("job_id")
            if job is not None and job != self.job_id.binary():
                return
            self._log_print_queue().put(msg)
            return
        if payload["channel"] == "nodes":
            msg = payload["message"]
            if msg.get("event") == "removed":
                self._fail_tasks_on_node(msg["node_id"],
                                         msg.get("reason") or "node removed")
            return
        if payload["channel"] == "actors":
            msg = payload["message"]
            aid = msg["actor_id"]
            state = msg["state"]
            if state == "ALIVE":
                if msg.get("incarnation") is not None:
                    self._actor_incarnations[aid] = msg["incarnation"]
                self._actor_addresses[aid] = msg["address"]
                self._actor_dead.pop(aid, None)
            elif state == "DEAD":
                self._actor_addresses.pop(aid, None)
                self._actor_incarnations.pop(aid, None)
                self._actor_dead[aid] = msg.get("death_cause") or "actor died"
                self._fail_inflight_actor_tasks(aid, self._actor_dead[aid])
            else:  # RESTARTING: old incarnation's in-flight tasks are lost,
                # and the fresh incarnation expects sequence numbers from 0.
                self._actor_addresses.pop(aid, None)
                self._actor_incarnations.pop(aid, None)
                with self._actor_seq_lock:
                    self._actor_seq_counters.pop(aid, None)
                self._fail_inflight_actor_tasks(
                    aid, "actor restarting; in-flight call lost")
            with self._actor_cv:
                self._actor_cv.notify_all()

    def _fail_inflight_actor_tasks(self, actor_id: ActorID, reason: str) -> None:
        """The actor process died: calls sent to it will never report back.
        Fail their pending return objects so ray.get() unblocks."""
        with self._pending_lock:
            doomed = [spec for spec, _r in self._pending_tasks.values()
                      if spec.task_type == TaskType.ACTOR_TASK
                      and spec.actor_id == actor_id]
        for spec in doomed:
            self._fail_task(spec, ActorDiedError(reason))

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        self.gcs.call("kill_actor", {"actor_id": actor_id, "no_restart": no_restart})

    def get_actor_info(self, actor_id: Optional[ActorID] = None,
                       name: Optional[str] = None, namespace: str = ""):
        payload: dict = {}
        if name is not None:
            payload = {"name": name, "namespace": namespace}
        else:
            payload = {"actor_id": actor_id}
        return self.gcs.call("get_actor_info", payload)

    # ------------------------------------------------------------- execution
    def _on_raylet_push(self, method: str, payload) -> None:
        if method == "execute_task":
            spec = payload["spec"]
            ids = payload.get("gpu_ids")
            if ids:
                self._task_gpu_ids[spec.task_id] = list(ids)
            d_us = payload.get("dispatch_us")
            if d_us is not None and spec.trace_ctx is not None:
                # raylet's dispatch stamp: _execute_task turns it into the
                # dispatch-stage span (push -> execution start)
                self._task_dispatch_us[spec.task_id] = d_us
            self._task_queue.put(spec)
        elif method == "become_actor":
            self._actor_gpu_ids = list(payload.get("gpu_ids") or [])
            self._become_actor(payload["spec"],
                               payload.get("incarnation"))
        elif method == "cancel_task":
            self._handle_exec_cancel(payload["task_id"],
                                     force=bool(payload.get("force")),
                                     recursive=bool(payload.get("recursive")))
        elif method == "global_gc":
            import gc

            gc.collect()
        elif method == "profile":
            # on-demand cpu/memory profile of this worker (reference
            # dashboard py-spy/memray role); runs in a daemon thread and
            # drops its result file for the raylet to serve
            from ray_tpu_torch.util.profiler import run_profile_request

            run_profile_request(payload)
        elif method == "exit":
            logger.info("worker exiting on raylet request")
            try:
                self.result_buffer.stop()
                self.task_events.flush()
            except Exception:
                pass
            os._exit(0)

    def _actor_group_for(self, spec: TaskSpec) -> Optional[str]:
        """Concurrency group for an actor call: the call-site override
        (method.options(concurrency_group=...)) wins, else the method's
        @method(concurrency_group=...) annotation; unknown names fall back
        to the default pool rather than stranding the call."""
        group = spec.concurrency_group
        if group is None and self._actor_instance is not None:
            fn = getattr(type(self._actor_instance), spec.method_name, None)
            group = getattr(fn, "_ray_tpu_method_opts", {}).get(
                "concurrency_group")
        if group is not None and group not in self._group_queues:
            # a typo'd group must FAIL the call, not silently land in the
            # default pool it was trying to escape (reference raises too)
            raise ValueError(
                f"actor has no concurrency group {group!r} "
                f"(declared: {sorted(self._group_queues) or 'none'})")
        return group

    def _enqueue_actor_task(self, spec: TaskSpec) -> None:
        # Load accounting happens HERE — only for tasks that actually enter
        # the exec queue (the matching decrement runs at execution end);
        # duplicate/stranded pushes must not inflate the load reading.
        if spec.method_name not in self._PROBE_METHODS:
            with self._exec_count_lock:
                self._load_count += 1
        try:
            group = self._actor_group_for(spec)
        except ValueError as e:
            # report the error to the caller's return objects; raising in
            # the push handler would vanish silently (pushes have no reply)
            with self._exec_count_lock:
                if spec.method_name not in self._PROBE_METHODS:
                    self._load_count -= 1  # undo the accounting above
            blob = serialization.dumps(
                TaskError.from_exception(spec.method_name, e))
            results = [("error", oid, blob)
                       for oid in spec.return_object_ids()]
            try:
                if spec.owner_address == self.address:
                    self.rpc_report_task_result(
                        None, 0, {"task_id": spec.task_id,
                                  "results": results})
                else:
                    self.peer(spec.owner_address).notify(
                        "report_task_result",
                        {"task_id": spec.task_id, "results": results})
            except Exception:
                logger.warning("could not report bad-group error for %s",
                               spec.method_name)
            return
        (self._group_queues[group] if group else self._task_queue).put(spec)

    def rpc_push_actor_task(self, conn, req_id, payload) -> None:
        """Direct actor transport target (callers push here). Incarnation
        fence first: a call pinned to a different incarnation than the one
        this process instantiates is REFUSED — the caller re-resolves and
        resends (rpc_actor_call_fenced) — and a call pinned to a NEWER
        incarnation additionally proves this process is a superseded
        zombie (its actor was restarted elsewhere during a partition): it
        self-terminates instead of ever answering again."""
        spec: TaskSpec = payload["spec"]
        pinned = getattr(spec, "actor_incarnation", None)
        if pinned is not None and spec.actor_id is not None \
                and (spec.actor_id != self.actor_id
                     or pinned != self._actor_incarnation):
            self._refuse_fenced_call(spec, pinned)
            return
        caller = spec.caller_id.binary() if spec.caller_id else b""
        with self._actor_seq_lock:
            expected = self._actor_next_seq.get(caller, 0)
            if spec.sequence_number == expected:
                self._actor_next_seq[caller] = expected + 1
                self._enqueue_actor_task(spec)
                # flush any buffered successors
                buf = self._actor_ooo_buffer.get(caller, {})
                nxt = expected + 1
                while nxt in buf:
                    self._enqueue_actor_task(buf.pop(nxt))
                    self._actor_next_seq[caller] = nxt + 1
                    nxt += 1
            else:
                self._actor_ooo_buffer.setdefault(caller, {})[spec.sequence_number] = spec

    def _fenced_exit(self) -> None:
        """This process was proven a SUPERSEDED actor incarnation: flush
        the delivery buffers and exit off-thread (callers sit on RPC
        reader / reconnect-lock paths), never to answer again."""
        def die():
            try:
                self.result_buffer.stop()
                self.task_events.flush()
            except Exception:
                pass
            os._exit(0)

        threading.Thread(target=die, name="fenced-exit",
                         daemon=True).start()

    def _refuse_fenced_call(self, spec: TaskSpec, pinned: int) -> None:
        """Executor side of the incarnation fence: tell the owner (it
        re-resolves and resends), then — if the call proves a NEWER
        incarnation exists — terminate this superseded instance."""
        superseded = (spec.actor_id == self.actor_id
                      and pinned > self._actor_incarnation)
        logger.warning(
            "refusing actor call %s pinned to incarnation %s (this worker "
            "instantiates %s of %s)%s", spec.method_name, pinned,
            self._actor_incarnation, self.actor_id,
            " — superseded, terminating" if superseded else "")
        try:
            self.peer(spec.owner_address).notify("actor_call_fenced", {
                "task_id": spec.task_id, "actor_id": spec.actor_id,
                "pinned": pinned, "actual": self._actor_incarnation})
        except Exception:
            logger.debug("fence notify to owner %s lost",
                         spec.owner_address, exc_info=True)
        if superseded:
            # the cluster moved past us while we were partitioned; exit
            # before any stale state can answer (raylet-side fencing kills
            # us too — this is the faster, call-triggered path)
            self._fenced_exit()

    def rpc_actor_call_fenced(self, conn, req_id, payload):
        """Owner side: the target refused our call's incarnation pin. The
        cached (address, incarnation) is stale — drop it, re-resolve from
        the GCS and resend with a fresh sequence number (ordering against
        the refused send is void: nothing executed). Bounded per task; a
        call that keeps getting fenced fails typed."""
        task_id: TaskID = payload["task_id"]
        actor_id = payload["actor_id"]
        with self._pending_lock:
            pend = self._pending_tasks.get(task_id)
        if pend is None:
            return True  # already failed/completed elsewhere
        spec = pend[0]
        resends = self._fence_resends.get(task_id, 0)
        if resends >= 3:
            self._fence_resends.pop(task_id, None)
            self._fail_task(spec, ActorDiedError(
                f"actor {actor_id} fenced call {resends + 1}x "
                f"(cluster incarnation view never converged)"))
            return True
        self._fence_resends[task_id] = resends + 1
        pinned = payload.get("pinned")
        with self._actor_seq_lock:
            cached_inc = self._actor_incarnations.get(actor_id)
            if cached_inc is not None and (pinned is None
                                           or cached_inc == pinned):
                # the cache still holds the STALE view this fence reports:
                # invalidate it once and restart the per-caller sequence —
                # the re-resolve lands on a new incarnation that expects 0.
                # A later fence for the same stale view finds the cache
                # already refreshed (cached != pinned) or empty and keeps
                # counting, so two fenced tasks can never both take seq 0.
                self._actor_addresses.pop(actor_id, None)
                self._actor_incarnations.pop(actor_id, None)
                self._actor_seq_counters.pop(actor_id, None)
            seq = self._actor_seq_counters.get(actor_id, 0)
            self._actor_seq_counters[actor_id] = seq + 1
            spec.sequence_number = seq

        def resend():
            self._send_actor_task(actor_id, spec, attempts=0)

        # off the push reader thread: _send_actor_task may block resolving
        threading.Thread(target=resend, name="fenced-resend",
                         daemon=True).start()
        return True

    @property
    def placement_group_id(self):
        """PG of the currently-executing task, else the hosting actor's PG."""
        pg = getattr(self._tls, "placement_group_id", None)
        if pg is not None:
            return pg
        spec = self._actor_creation_spec
        return spec.scheduling.placement_group_id if spec is not None else None

    def _become_actor(self, spec: ActorCreationSpec,
                      incarnation: Optional[int] = None) -> None:
        self.actor_id = spec.actor_id
        # set BEFORE callers can learn our address (creation_done comes
        # later): every arriving call is fence-checked against this
        if incarnation is None:
            incarnation = getattr(spec, "incarnation", 0)
        self._actor_incarnation = int(incarnation or 0)
        self._actor_creation_spec = spec
        threading.Thread(target=self._init_actor, args=(spec,), daemon=True).start()

    def _init_actor(self, spec: ActorCreationSpec) -> None:
        try:
            # become_actor can be pushed before our register reply lands.
            self._registered.wait(timeout=30)
            cls = self.function_table.resolve(
                getattr(spec, "class_fn_id", None), spec.class_blob)
            _select_granted_gpu(self._actor_gpu_ids)
            args, kwargs = self._deserialize_args(spec.init_args, spec.init_kwargs_blob)
            if spec.runtime_env:
                self._apply_runtime_env(spec.runtime_env)
            self._actor_instance = cls(*args, **kwargs)
            # dedicated pools BEFORE creation_done: callers only learn our
            # address afterwards, so no task can race an unrouted group
            for gname, gsize in (spec.concurrency_groups or {}).items():
                q: "queue.Queue[TaskSpec]" = queue.Queue()
                self._group_queues[gname] = q
                with self._exec_threads_lock:
                    for _ in range(max(1, int(gsize))):
                        self._spawn_exec_thread(q, f"task-exec-{gname}")
            self._start_exec_threads(max(1, spec.max_concurrency))
            # spec included so a GCS that restarted DURING our __init__ (and
            # so never saw the registration) can rebuild the actor record;
            # incarnation lets it reject a SUPERSEDED dispatch completing
            # late (the actor was restarted elsewhere mid-partition)
            self.gcs.call("actor_creation_done", {
                "actor_id": spec.actor_id, "success": True,
                "address": self.address, "node_id": self.node_id,
                "incarnation": self._actor_incarnation,
                "spec": spec})
        except Exception as e:
            logger.exception("actor creation failed")
            self.gcs.call("actor_creation_done", {
                "actor_id": spec.actor_id, "success": False,
                "error": f"{e}\n{traceback.format_exc()}"})

    def _apply_runtime_env(self, env: dict) -> None:
        import sys as _sys

        for k, v in env.get("env_vars", {}).items():
            os.environ[k] = str(v)
        if env.get("working_dir"):
            os.chdir(env["working_dir"])
        if env.get("py_modules"):
            from ray_tpu_torch.runtime_env import ensure_py_modules

            cache = os.path.expanduser("~/.cache/ray_tpu_torch/py_modules")
            os.makedirs(cache, exist_ok=True)
            for path in ensure_py_modules(env, self.gcs, cache):
                if path not in _sys.path:
                    _sys.path.insert(0, path)

    def _start_exec_threads(self, n: int) -> None:
        # Must be mutually exclusive: for an actor worker this is reached from
        # BOTH __init__ (mode=="worker") and the _init_actor thread; without
        # the lock each can observe len() < n and over-spawn, after which a
        # max_concurrency=1 actor executes queued calls concurrently and the
        # per-caller FIFO guarantee (reference
        # transport/actor_scheduling_queue.h) is violated.
        with self._exec_threads_lock:
            while len(self._default_exec_threads) < n:
                self._spawn_exec_thread(self._task_queue, "task-exec",
                                        self._default_exec_threads)

    def _spawn_exec_thread(self, q: "queue.Queue", name: str,
                           tracking: Optional[List[threading.Thread]] = None
                           ) -> None:
        """Caller holds _exec_threads_lock."""
        t = threading.Thread(target=self._exec_loop, args=(q,),
                             name=name, daemon=True)
        t.start()
        if tracking is not None:
            tracking.append(t)

    def _exec_loop(self, q: Optional["queue.Queue"] = None) -> None:
        q = q if q is not None else self._task_queue
        while not self._shutdown.is_set():
            try:
                spec = q.get(timeout=0.2)
            except queue.Empty:
                continue
            except TaskCancelledError:
                # an interrupt injected in the window after its task
                # finished lands here: the thread must survive it
                continue
            try:
                self._execute_task(spec)
            except TaskCancelledError:
                # injection raced the task's finally block; the task's own
                # except path already reported — keep the thread alive
                continue

    def _execute_task(self, spec: TaskSpec) -> None:
        """Run one task and route results to its owner
        (cf. reference `_raylet.pyx:718 execute_task`)."""
        prev_task_id = getattr(self._tls, "task_id", None)
        self._tls.task_id = spec.task_id
        self._tls.job_id = spec.job_id  # log attribution (tee -> driver)
        prev_pg = getattr(self._tls, "placement_group_id", None)
        self._tls.placement_group_id = spec.scheduling.placement_group_id
        # GPU grant for get_gpu_ids(): the task's own, else the actor's
        self._tls.gpu_ids = self._task_gpu_ids.pop(
            spec.task_id, None) or list(self._actor_gpu_ids)
        _select_granted_gpu(self._tls.gpu_ids)
        # adopt the submitter's trace context: the execute/result spans —
        # and any task this task submits — join the same causal tree
        prev_ctx = tracing.current_ctx()
        traced = spec.trace_ctx is not None and tracing.enabled()
        if traced:
            tracing.set_ctx(spec.trace_ctx)
            d_us = self._task_dispatch_us.pop(spec.task_id, None)
            if d_us is not None:
                # dispatch stage: raylet push -> execution start (epoch-
                # anchored stamps; same-host clocks agree, cross-node skew
                # is corrected at merge from the clock-probe offsets)
                tracing.add_complete(
                    f"dispatch::{spec.method_name}", "task_dispatch",
                    d_us, tracing.now_us() - d_us,
                    trace_id=spec.trace_ctx[0],
                    parent_id=spec.trace_ctx[1],
                    task_id=spec.task_id.binary().hex())
        else:
            self._task_dispatch_us.pop(spec.task_id, None)
        self._emit_task_event(spec, "RUNNING")
        with self._exec_count_lock:
            self._executing_count += 1
        # cancellation: a task purged while queued (actor mailbox, exec
        # queue) reports typed WITHOUT running; a task that starts registers
        # its thread so a later cancel can inject the interrupt into it
        with self._cancel_lock:
            precancelled = spec.task_id in self._cancelled_exec
            if not precancelled:
                self._exec_thread_ids[spec.task_id] = threading.get_ident()
        failed = False
        results = []
        try:
            if precancelled:
                raise TaskCancelledError(
                    f"task {spec.method_name} was cancelled before execution")
            if spec.task_type == TaskType.ACTOR_TASK:
                if spec.method_name == "__ray_terminate__":
                    self.result_buffer.stop()
                    self.task_events.flush()
                    os._exit(0)
                fn = getattr(self._actor_instance, spec.method_name)
            else:
                # LRU of deserialized functions, GCS fetch on miss — the
                # executor half of the export-once fast lane (replaces a
                # cloudpickle.loads of the full blob on EVERY execution)
                fn = self.function_table.resolve(
                    spec.function_id, spec.function_blob)
                if spec.runtime_env:
                    self._apply_runtime_env(spec.runtime_env)
            args, kwargs = self._deserialize_args(spec.args, spec.kwargs_blob)
            with tracing.span(f"task::{spec.method_name}",
                              "task_execution",
                              task_id=spec.task_id.binary().hex()):
                value = fn(*args, **kwargs)
            if inspect.isasyncgen(value):
                raise TypeError(
                    "async generator returns are not supported; collect "
                    "results into a list inside the task")
            if inspect.iscoroutine(value):
                # async tasks / actor methods (reference async actors): one
                # PERSISTENT event loop per exec thread, so loop-bound actor
                # state (asyncio.Lock/Queue created in one call) stays valid
                # across calls. With max_concurrency=1 every call shares the
                # single loop, matching the reference's semantics.
                loop = getattr(self._tls, "aio_loop", None)
                if loop is None or loop.is_closed():
                    loop = asyncio.new_event_loop()
                    self._tls.aio_loop = loop
                with tracing.span(f"task::{spec.method_name}::await",
                                  "task_execution",
                                  task_id=spec.task_id.binary().hex()):
                    value = loop.run_until_complete(value)
            if spec.num_returns == -1:
                # Generator task: stream each yielded object to the owner AS
                # PRODUCED (reference streaming generators, _raylet.pyx:178);
                # the main return materializes afterwards as a completed
                # ObjectRefGenerator so borrowers get the full sequence.
                value = self._stream_dynamic_returns(spec, value)
                values = [value]
            elif spec.num_returns == 1:
                values = [value]
            else:
                values = list(value)
                if len(values) != spec.num_returns:
                    raise ValueError(
                        f"task declared num_returns={spec.num_returns} but returned "
                        f"{len(values)} values")
            # Own refs nested in a return value (e.g. an actor handing out
            # refs to objects it created) escape to the caller. Their
            # descriptors ship WITH the result so the caller — who owns the
            # enclosing return object — can keep them alive for the
            # container's lifetime (pin if caller-owned, borrow otherwise),
            # mirroring put()'s container pins.
            for oid, v in zip(spec.return_object_ids(), values):
                results.append(self._build_result_entry(oid, v))
        except TaskCancelledError as e:
            # ships the typed error DIRECTLY (not wrapped in TaskError):
            # the owner's ref must resolve to TaskCancelledError by type
            blob = serialization.dumps(TaskCancelledError(
                str(e) or f"task {spec.method_name} was cancelled"))
            results = [("error", oid, blob) for oid in spec.return_object_ids()]
            failed = True
        except Exception as e:
            from ray_tpu_torch.core.exceptions import ActorError
            cls = ActorError if spec.task_type == TaskType.ACTOR_TASK else TaskError
            te = cls.from_exception(spec.method_name, e)
            blob = serialization.dumps(te)
            results = [("error", oid, blob) for oid in spec.return_object_ids()]
            failed = True
        finally:
            with self._cancel_lock:
                self._exec_thread_ids.pop(spec.task_id, None)
                self._cancelled_exec.discard(spec.task_id)
            if traced:
                tracing.set_ctx(prev_ctx)
            if prev_task_id is None:
                del self._tls.task_id
            else:
                self._tls.task_id = prev_task_id
            self._tls.placement_group_id = prev_pg
            with self._exec_count_lock:
                self._executing_count -= 1
                if (spec.task_type == TaskType.ACTOR_TASK
                        and spec.method_name not in self._PROBE_METHODS):
                    self._load_count -= 1
        self._emit_task_event(spec, "FAILED" if failed else "FINISHED")
        t_res = tracing.now_us() if traced else 0.0
        try:
            if spec.owner_address == self.address:
                self.rpc_report_task_result(None, 0, {
                    "task_id": spec.task_id, "results": results,
                    "actor_incarnation": self._actor_incarnation
                    if self.actor_id is not None else None})
            else:
                # batched fast lane: coalesces per owner under load, delivers
                # immediately when idle, requeues on a down owner link
                self.result_buffer.report(spec.owner_address, spec.task_id,
                                          results)
        except Exception:
            logger.warning("could not deliver results of %s to owner %s",
                           spec.method_name, spec.owner_address)
        if t_res:
            # result-deliver stage (the batched lane measures the hand-off
            # into the owner-bound buffer; delivery itself is async)
            tracing.add_complete(
                f"result::{spec.method_name}", "task_result",
                t_res, tracing.now_us() - t_res,
                trace_id=spec.trace_ctx[0], parent_id=spec.trace_ctx[1],
                task_id=spec.task_id.binary().hex(), failed=failed)
        if spec.task_type != TaskType.ACTOR_TASK:
            recycle = False
            if spec.max_calls > 0 and self.mode == "worker":
                # worker recycling (reference max_calls): if this function
                # just hit its budget, retire — the task_done notify tells
                # the raylet to drop us from the pool FIRST so the next
                # task can't be dispatched into the exiting process.
                # Keyed on the FunctionID content hash; a blob-fallback spec
                # (GCS blip during export) hashes to the SAME key, so one
                # function never splits across two counters.
                from ray_tpu_torch.core.ids import FunctionID

                key = spec.function_id or FunctionID.for_blob(
                    spec.function_blob).binary()
                with self._exec_count_lock:
                    self._fn_call_counts[key] = (
                        self._fn_call_counts.get(key, 0) + 1)
                    recycle = self._fn_call_counts[key] >= spec.max_calls
            try:
                self.raylet.notify("task_done", {
                    "worker_id": self.worker_id, "retiring": recycle})
            except OSError as e:
                logger.debug("task_done notify lost (raylet down?): %s", e)
            if recycle:
                logger.info("max_calls=%d reached for %s; recycling worker",
                            spec.max_calls, spec.method_name)
                self.result_buffer.stop()
                self.task_events.flush()
                os._exit(0)

    def _stream_dynamic_returns(self, spec: TaskSpec, value) -> ObjectRefGenerator:
        """Executor side of num_returns="dynamic": iterate the task's
        generator, storing + reporting one object per yielded item (ids
        deterministic in the item index, ids.py for_dynamic_return). Returns
        the completed ObjectRefGenerator used as the task's main return."""
        if not (inspect.isgenerator(value) or hasattr(value, "__next__")):
            # iterATORs only, not iterABLEs: accepting any __iter__ would
            # silently stream a mistakenly-returned str per character or a
            # dict per key (the exact bug this error exists to catch)
            raise TypeError(
                "a num_returns='dynamic' task must return a generator or "
                f"iterator, got {type(value).__name__}")
        item_refs: List[ObjectRef] = []
        for i, item in enumerate(value):
            oid_i = ObjectID.for_dynamic_return(spec.task_id, i)
            self._report_dynamic(spec, self._build_result_entry(oid_i, item))
            item_refs.append(ObjectRef(oid_i, owner_address=spec.owner_address))
        return ObjectRefGenerator(item_refs, done=True)

    def _build_result_entry(self, oid: ObjectID, value) -> tuple:
        """Serialize one return object into a result entry (shared by the
        static return loop and dynamic item streaming): inline below the
        direct-call threshold, plasma above, contained-ref descriptors
        always attached for owner-side container protection."""
        s = serialization.serialize(value)
        self._mark_shipped(s.contained_refs)
        contained = list({(r.id, r.owner_address or self.address)
                          for r in (s.contained_refs or ())})
        if s.total_bytes <= get_config().max_direct_call_object_size:
            return ("inline", oid, s.to_bytes(), contained)
        seg = self._put_to_store(oid, s)
        # the segment name rides the result entry so a CO-LOCATED owner can
        # zero-copy attach its task results without a pull round-trip
        return ("plasma", oid, self.raylet_address, s.total_bytes, contained,
                seg)

    def _deserialize_args(self, args: List[Tuple], kwargs_blob: Optional[bytes]):
        out = []
        for a in args:
            if a[0] == "value":
                out.append(serialization.loads(a[1]))
            else:
                _, oid, owner = a
                ref = ObjectRef(oid, owner_address=owner)
                with tracing.span("task::get_arg", "task_execution",
                                  object_id=oid.hex()):
                    out.append(self._get_one(ref, deadline=None))
        kwargs = serialization.loads(kwargs_blob) if kwargs_blob else {}
        return out, kwargs
