"""GCS: the cluster control plane.

Equivalent of the reference's GCS server (`src/ray/gcs/gcs_server/
gcs_server.h:77`): node membership + health (GcsNodeManager,
GcsHealthCheckManager), actor lifecycle with restart-on-failure
(GcsActorManager `gcs_actor_manager.h:281`), placement groups with 2-phase
reserve/commit (GcsPlacementGroupManager `gcs_placement_group_manager.h:223`),
jobs, internal KV, pubsub fan-out, and the cluster resource view that backs
scheduling (GcsResourceManager). Storage is in-memory (the reference's
default `InMemoryStoreClient`, `gcs_table_storage.h:354`); a persistence
hook can be added behind the same table interface.
"""

from __future__ import annotations

import os
import logging
import socket
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core import rpc
from ray_tpu_torch.core.config import get_config
from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, PlacementGroupID
from ray_tpu_torch.core.scheduler import SchedulingPolicy, NodeView
from ray_tpu_torch.core.task_spec import ActorCreationSpec, ActorInfo, ActorState

logger = logging.getLogger(__name__)

# Pubsub channels (cf. reference src/ray/protobuf/pubsub.proto:28-46)
CH_NODES = "nodes"
CH_ACTORS = "actors"
CH_RESOURCES = "resources"
CH_ERRORS = "errors"
CH_CONTROL = "control"  # cluster-wide commands (global_gc, ...)
CH_LOGS = "logs"        # worker stdout/stderr fan-out to drivers


def _head_metrics() -> dict:
    """Lazy HA metric handles (util/metrics.py): shared names across the
    active head, a promoted standby and the raylet-side announce drops."""
    from ray_tpu_torch.util.metrics import get_or_create

    return {
        "failovers": get_or_create(
            "counter", "ray_tpu_torch_head_failovers_total",
            "standby head promotions"),
        "promotion_s": get_or_create(
            "gauge", "ray_tpu_torch_head_promotion_seconds",
            "lease-expiry -> first-scheduled-task latency of the last "
            "promotion"),
        "fencing": get_or_create(
            "counter", "ray_tpu_torch_fencing_rejections_total",
            "stale-head writes/announces rejected by the fencing epoch",
            tag_keys=("site",)),
    }


def _node_metrics() -> dict:
    """Node-failure-domain metric handles: shared names between the GCS
    (which declares deaths and ingests warm-lease joins) and the autoscaler
    (which counts relaunches)."""
    from ray_tpu_torch.util.metrics import get_or_create

    return {
        "deaths": get_or_create(
            "counter", "ray_tpu_torch_node_deaths_total",
            "nodes declared dead", tag_keys=("reason",)),
        "relaunches": get_or_create(
            "counter", "ray_tpu_torch_node_relaunches_total",
            "autoscaler replacements launched for dead nodes"),
        "join_warm": get_or_create(
            "gauge", "ray_tpu_torch_node_join_warm_lease_seconds",
            "node join -> first warm (forked) lease latency of the most "
            "recent joiner"),
        # --- partition failure domain (incarnation fencing + quarantine) ---
        "fenced": get_or_create(
            "counter", "ray_tpu_torch_node_fenced_total",
            "nodes told to fence (stale incarnation after a partition "
            "heal): the zombie kills its workers and rejoins fresh"),
        "quarantines": get_or_create(
            "counter", "ray_tpu_torch_node_quarantines_total",
            "nodes quarantined for degraded heartbeat delivery (no new "
            "dispatch, autoscaler holds replacement)"),
        "stale_rejections": get_or_create(
            "counter", "ray_tpu_torch_stale_incarnation_rejections_total",
            "messages rejected for carrying a superseded node/actor "
            "incarnation", tag_keys=("site",)),
    }


def _job_metrics() -> dict:
    """Job failure-domain metric handles: driver-death fate-sharing reaps
    declared by the GCS (conn-close fast path, probe backstop, or
    post-failover snapshot probe)."""
    from ray_tpu_torch.util.metrics import get_or_create

    return {
        "reaps": get_or_create(
            "counter", "ray_tpu_torch_job_reaps_total",
            "dead jobs reaped (driver-death fate-sharing): non-detached "
            "actors killed, tasks cancelled, leases and demand released, "
            "owned objects dropped, function exports freed"),
    }


class GcsServer:
    def __init__(self, host: str = "127.0.0.1",
                 snapshot_path: Optional[str] = None,
                 snapshot_interval_s: float = 5.0,
                 port: int = 0,
                 snapshot_uri: Optional[str] = None,
                 preloaded_snapshot: Optional[bytes] = None,
                 lease_grant: Optional[dict] = None):
        """Control-plane persistence rides a pluggable `SnapshotStore`
        (snapshot_store.py — the role Redis plays for the reference's HA
        GCS, `gcs_table_storage.h`): the durable tables (internal KV, jobs,
        function table, actor metadata, node table, placement groups)
        serialize into versioned, checksummed, atomically-swapped blobs
        selected by `snapshot_uri` ("file://<dir>" or "memory://<name>";
        `snapshot_path` is the legacy spelling of a file store; config
        `gcs_snapshot_uri` is the env-driven default). A restarted head on
        the SAME address rebuilds live state from re-registrations alone; a
        REPLACEMENT head on a new address additionally restores the node
        and PG tables from the snapshot, dials the snapshot-known raylets
        to announce its address, and re-adopts them as they re-register
        (see _readopt_loop). Actor liveness still comes only from worker
        re-registration — the snapshot restores identity and restart
        budgets, never liveness."""
        self._server = rpc.RpcServer(host, port)
        self._server.register_all(self)
        self._lock = threading.RLock()
        from ray_tpu_torch.core.snapshot_store import VersionedSnapshots, \
            store_from_uri

        uri = snapshot_uri or (get_config().gcs_snapshot_uri or None)
        if uri is None and snapshot_path:
            uri = f"file://{self._migrate_legacy_snapshot(snapshot_path)}"
        self._snapshot_uri = uri
        self._snapshots: Optional[VersionedSnapshots] = None
        if uri:
            self._snapshots = VersionedSnapshots(
                store_from_uri(uri), prefix="gcs",
                keep=get_config().gcs_snapshot_keep)
        self._snapshot_interval_s = snapshot_interval_s
        self._dirty = False
        self._snapshot_write_lock = threading.Lock()
        self._snapshots_written = 0
        self._snapshot_last_version = 0

        # --- lease / fencing (head_lease.py): the active head renews a TTL
        # lease stored beside the snapshots; the lease EPOCH is the fencing
        # token every durable write and raylet-facing announce carries. A
        # head whose epoch trails the store's is FENCED: its snapshot saves
        # raise, its announces are dropped by raylets, and on_fenced fires
        # (node_main exits there; tests assert on it).
        import uuid as _uuid

        from ray_tpu_torch.core.head_lease import HeadLease

        self.session_id: str = _uuid.uuid4().hex[:16]
        self._restored_fence_epoch = 0  # epoch floor carried by the snapshot
        self._preloaded_snapshot = preloaded_snapshot
        self._lease: Optional[HeadLease] = None
        self._lease_owner: str = ""
        self._lease_draining = False
        self.fence_epoch: int = 0
        self._fenced = threading.Event()
        self._fencing_rejections = 0
        self.on_fenced = None  # callback: a newer head took over
        # set by a promoting StandbyHead: lease-expiry/promotion timestamps;
        # first_schedule_at lands when this head first dispatches work
        self.promotion: Optional[dict] = None
        if self._snapshots is not None:
            self._lease = HeadLease(self._snapshots.store)
            if lease_grant is not None:
                # a StandbyHead already won the acquire CAS for us
                self._lease_owner = lease_grant["owner"]
                self.fence_epoch = lease_grant["epoch"]
                self.promotion = {
                    "epoch": self.fence_epoch,
                    "lease_expired_at": lease_grant.get("lease_expired_at"),
                    "promoted_at": None,
                    "first_schedule_at": None,
                    "tailed_version": lease_grant.get("tailed_version"),
                }
            else:
                from ray_tpu_torch.core.head_lease import new_owner_token

                self._lease_owner = new_owner_token()

        # --- delta-encoded resource fan-out state: per-publish sequence,
        # the set of nodes whose view changed since the last publish, and
        # a full-snapshot latch (topology change / new subscriber / first
        # publish). Guarded by self._lock.
        self._bcast_seq = 0
        self._bcast_dirty: set = set()        # node hexids changed
        self._bcast_removed: set = set()      # node hexids removed
        self._bcast_full_needed = True
        self._bcast_fulls = 0
        self._bcast_deltas = 0
        self._bcast_bytes = 0                 # payload bytes x subscribers
        # 2-phase PG creations serialize here: a client retry racing the
        # restored head's resume of the same (idempotent) creation must not
        # run two concurrent placements and leak the loser's reservations
        self._pg_2pc_lock = threading.Lock()
        self._pg_retry_active = False  # one paced PENDING-retry pass at a time
        # nodes restored from the snapshot, awaiting raylet re-registration
        # (address -> node_id); the readopt loop dials them to announce the
        # new head address, and the health loop reaps silent ones
        self._restored_nodes: Dict[str, bytes] = {}

        # --- node failure domain (autoscaler-driven replacement + warm
        # onboarding) ---
        # hot runtime-env keys: env keys with recent lease traffic, fed by
        # raylet heartbeats and shipped in the register_node reply so a
        # JOINING raylet pre-spawns fork templates for them (warm node
        # onboarding). key -> {"runtime_env": ..., "last_seen": monotonic}.
        self._hot_envs: Dict[Optional[str], dict] = {}
        # death accounting (ray_tpu_torch_node_deaths_total{reason=}); graceful
        # drains are tallied apart — scale-down is not failure
        self._node_deaths: Dict[str, int] = {}
        self._node_drains = 0
        # the autoscaler's own reconcile counters, reported each tick via
        # rpc_autoscaler_report so gcs_stats is the one observability stop
        self._autoscaler_stats: dict = {}
        # node-join -> first-warm-lease samples reported by joining raylets
        from collections import deque as _deque

        self._warm_lease_joins: "_deque" = _deque(maxlen=100)
        # actors whose restart found no capacity RIGHT NOW (their node died
        # and the replacement has not joined yet): actor_id -> next retry
        # monotonic. The health loop re-runs scheduling paced; a node
        # registration makes every entry immediately due.
        self._pending_restarts: Dict[ActorID, float] = {}
        # first time each actor was parked (bounds the total wait: past
        # actor_restart_pending_timeout_s the restart is declared DEAD)
        self._pending_restart_since: Dict[ActorID, float] = {}
        self._restart_retry_active = False
        self._bundle_resched_active = False
        # debounced resource fan-out (completion-path fast lane): at most
        # one CH_RESOURCES publish per resource_broadcast_period_ms
        from ray_tpu_torch.util.debounce import Debouncer

        self._bcast_debounce = Debouncer(
            self._publish_resources,
            lambda: get_config().resource_broadcast_period_ms / 1000.0,
            skip_deferred=lambda: self._shutdown.is_set())

        # node table: node_id(bytes) -> info dict
        self._nodes: Dict[bytes, dict] = {}
        self._raylet_clients: Dict[bytes, rpc.RpcClient] = {}
        self._last_heartbeat: Dict[bytes, float] = {}

        # --- partition failure domain: incarnation fencing + quarantine ---
        # per-node-IDENTITY incarnation: monotonically increasing, stamped
        # at registration, snapshot-persisted. Declaring a node dead
        # INVALIDATES its identity (added to _dead_node_ids): a zombie that
        # comes back after a partition heal gets a typed fence reply on its
        # next heartbeat/register — it must kill its workers (they host
        # actor incarnations that were restarted elsewhere) and rejoin as a
        # fresh node. (Reference: Ray's fault model treats asymmetric
        # reachability as first-class; the incarnation is the fencing token
        # at node granularity, like the head-lease epoch at head
        # granularity.)
        self._node_incarnations: Dict[bytes, int] = {}
        # invalidated identities, INSERTION-ORDERED so the bound evicts the
        # oldest and the snapshot persists the newest (a dict used as an
        # ordered set: values unused)
        self._dead_node_ids: Dict[bytes, None] = {}
        self._node_fences = 0
        # gray-failure quarantine: degraded-heartbeat nodes are quarantined
        # (no new leases/dispatch; the autoscaler holds its replacement)
        # BEFORE the death bound and rejoin without replacement on recovery
        self._node_quarantines = 0
        self._quarantine_recoveries = 0
        # stale-incarnation rejections by site (heartbeat/register/
        # reregister_actor/actor_creation_done/actor_failed)
        self._stale_rejections: Dict[str, int] = {}

        # kv: namespace -> key -> value
        self._kv: Dict[str, Dict[bytes, Any]] = {}

        # function table: content-addressed export-once function/class
        # pickles (reference function_manager.py export path). Durable via
        # the snapshot: actor restart-on-failure resolves class blobs here.
        # Insertion-ordered for FIFO eviction at function_table_max_bytes.
        self._functions: Dict[bytes, bytes] = {}
        self._function_bytes = 0
        self._function_puts = 0  # put RPCs since boot (export-once proof)
        self._function_evictions = 0

        # recent worker log lines for `ray_tpu_torch logs`
        from collections import deque

        self._recent_logs = deque(maxlen=1000)

        # actors
        self._actors: Dict[ActorID, ActorInfo] = {}
        self._actor_specs: Dict[ActorID, ActorCreationSpec] = {}
        self._actor_owners: Dict[ActorID, str] = {}
        self._named_actors: Dict[tuple, ActorID] = {}  # (namespace, name) -> id

        # actors restored from a snapshot, awaiting worker re-registration
        self._awaiting_rereg: Dict[ActorID, float] = {}

        # placement groups
        self._pgs: Dict[PlacementGroupID, dict] = {}

        # jobs
        self._jobs: Dict[bytes, dict] = {}
        # --- job failure domain (driver-death fate-sharing) ---
        # live driver conn IDENTITY per job: the conn-close hook only reaps
        # if ITS conn is still the registered one — a reconnecting driver
        # re-registers on a new conn first, and the old conn's late close
        # must not reap the live job
        self._job_conns: Dict[bytes, int] = {}
        # probe backstop: RUNNING jobs with no live conn (close hook lost,
        # or restored from a snapshot after failover) get their
        # driver_address probed once this monotonic deadline passes
        self._job_probe_after: Dict[bytes, float] = {}
        # snapshot-restored jobs flipped RUNNING->FAILED that still need a
        # probe-then-reap (a surviving driver re-registers and escapes)
        self._restored_unreaped: Dict[bytes, None] = {}
        # function exports by owning job: an export is freed at reap only
        # when the dead job was its LAST owner (shared content-addressed
        # blobs survive)
        self._function_jobs: Dict[bytes, set] = {}
        self._job_reap_stats: Dict[str, int] = {
            "jobs_reaped": 0, "actors_killed": 0, "detached_spared": 0,
            "queued_cancelled": 0, "workers_killed": 0,
            "objects_dropped": 0, "bytes_dropped": 0, "functions_freed": 0}

        # task events: ring buffer of recent task lifecycle records
        # (reference GcsTaskManager + per-worker TaskEventBuffer,
        # src/ray/core_worker/task_event_buffer.h)
        self._task_events: Dict[bytes, dict] = {}
        self._task_events_order: List[bytes] = []
        self._task_events_dropped = 0  # evictions since boot (truncation flag)
        self._max_task_events = 10000
        self._task_counts = {"submitted": 0, "finished": 0, "failed": 0}
        self._profile_events: List[dict] = []

        # distributed tracing (observability plane): spans carrying a
        # trace_id index into a bounded ring of traces (oldest trace
        # evicted whole); per-source clock offsets from worker clock
        # probes align the merged timeline; per-stage latencies feed the
        # p50/p99 roll-up in gcs_stats
        self._traces: "OrderedDict[str, List[dict]]" = OrderedDict()
        self._traces_evicted = 0
        self._spans_dropped = 0       # worker-side ring overflow, summed
        self._span_clock_offsets: Dict[str, float] = {}  # src -> offset_us
        self._stage_lat_us: Dict[str, List[float]] = {}

        # pubsub: channel -> list[ServerConnection]
        self._subs: Dict[str, List[rpc.ServerConnection]] = {}

        self._policy = SchedulingPolicy()
        self._shutdown = threading.Event()
        self._health_thread: Optional[threading.Thread] = None

    @staticmethod
    def _migrate_legacy_snapshot(snapshot_path: str) -> str:
        """Legacy `snapshot_path` pointed at a single pickle FILE; the
        store needs a directory. If an old-format file exists there, root
        the store beside it (`<path>.d`) and import the pickle as version
        1 — a pre-HA head's snapshot still restores after an upgrade.
        Returns the directory to root the FileSnapshotStore on."""
        if not os.path.isfile(snapshot_path):
            return snapshot_path
        from ray_tpu_torch.core.snapshot_store import FileSnapshotStore, \
            VersionedSnapshots

        root = snapshot_path + ".d"
        try:
            store = FileSnapshotStore(root)
            if not store.list_keys(prefix="gcs-"):
                with open(snapshot_path, "rb") as f:
                    legacy = f.read()
                VersionedSnapshots(store, prefix="gcs").save(legacy)
                logger.info("migrated legacy GCS snapshot %s into store %s",
                            snapshot_path, root)
        except Exception:
            logger.exception("legacy snapshot migration failed; starting "
                             "from the store at %s", root)
        return root

    # ------------------------------------------------------------------ boot
    def start(self) -> str:
        self._load_snapshot()
        if self._lease is not None and self.fence_epoch == 0:
            # operator-started head: force-take the lease (epoch bump). Any
            # previous holder — a head this one replaces — is fenced from
            # this point; only a StandbyHead waits out the TTL instead.
            # The snapshot's persisted fence_epoch floors the new epoch: a
            # torn/lost lease RECORD must not reset the epoch below one the
            # fleet already adopted (that would invert every fencing check).
            self.fence_epoch = self._lease.acquire(
                self._lease_owner, force=True, settle_s=0,
                floor=self._restored_fence_epoch + 1)
        self._server.start()
        if self._lease is not None:
            # partition sidedness for the lease_renew fault point: a net
            # split that cuts this head from the store's side starves its
            # renewals (head-in-minority composes the head lease's fencing)
            self._lease.origin = self._server.address
        if self.promotion is not None:
            self.promotion["promoted_at"] = time.time()
        self._write_address_file()
        self._health_thread = threading.Thread(
            target=self._health_loop, name="gcs-health", daemon=True
        )
        self._health_thread.start()
        if self._snapshots is not None:
            threading.Thread(target=self._snapshot_loop, name="gcs-snapshot",
                             daemon=True).start()
        if self._lease is not None:
            threading.Thread(target=self._lease_loop, name="gcs-lease",
                             daemon=True).start()
        if self._restored_nodes or any(
                p.get("state") == "PREPARING" for p in self._pgs.values()):
            threading.Thread(target=self._readopt_loop, name="gcs-readopt",
                             daemon=True).start()
        logger.info("GCS listening on %s (session %s epoch %d)",
                    self._server.address, self.session_id, self.fence_epoch)
        return self._server.address

    def _write_address_file(self) -> None:
        """Publish this head's address for re-resolution (config
        gcs_address_file): raylets/workers/drivers re-read the file on
        every reconnect attempt, so a replacement head on a new address is
        found without restarting anything. Atomic swap through a tmp file
        unique per WRITER (pid + thread + object id — an old and a new head
        in one process must not stomp each other's tmp) and fsynced before
        the rename — a reader never sees a half-written or empty address,
        and `read_gcs_address_file` treats an empty read as "no answer"
        (retry), never as an address."""
        path = get_config().gcs_address_file
        if not path:
            return
        try:
            tmp = (f"{path}.tmp{os.getpid()}."
                   f"{threading.get_ident()}.{id(self)}")
            with open(tmp, "w") as f:
                f.write(self._server.address)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except OSError:
            logger.exception("could not write GCS address file %s", path)

    # ------------------------------------------------------- lease / fencing
    def _lease_loop(self) -> None:
        """Renew the head lease every ttl/3. A renewal WRITE lost to the
        injected `lease_renew` fault (or a store blip) just shortens the
        runway — the lease expires and a standby takes over; a renewal that
        READS a bumped epoch means that already happened: fence ourselves."""
        from ray_tpu_torch.core.head_lease import LeaseLostError

        cfg = get_config()
        period = cfg.head_lease_renew_period_s or (self._lease.ttl_s / 3.0)
        while not self._shutdown.wait(period):
            if self._fenced.is_set():
                return
            try:
                if self._lease_draining:
                    # rolling upgrade: no renewals (we relinquished), but
                    # keep READING so the successor's epoch bump fences —
                    # and thereby retires — this head automatically
                    self._lease.check(self.fence_epoch)
                    continue
                self._lease.renew(self._lease_owner, self.fence_epoch,
                                  address=self._server.address,
                                  snapshot_version=self._snapshot_last_version)
            except LeaseLostError as e:
                self._note_fenced(f"lease renewal: {e}")
                return
            except rpc.RpcDisconnected as e:
                logger.warning("head lease renewal lost (%s); lease expires "
                               "unless a later renewal lands", e)
            except Exception:
                logger.exception("head lease renewal failed")

    def _note_fenced(self, reason: str) -> None:
        if self._fenced.is_set():
            return
        self._fenced.set()
        logger.warning("GCS %s FENCED (epoch %d): %s — retiring",
                       self._server.address, self.fence_epoch, reason)
        cb = self.on_fenced
        if cb is not None:
            try:
                cb()
            except Exception:
                logger.exception("on_fenced callback failed")
        # A fenced head must stop SERVING, not just stop writing: still-
        # connected clients would otherwise keep reading (and mutating) a
        # dead epoch's view — e.g. its health loop declaring the departed
        # fleet dead and publishing actor deaths to subscribed drivers.
        # Dropping the connections makes every client re-resolve (via
        # address file / raylet answerback) to the head that fenced us.
        threading.Thread(target=self._retire_after_fence,
                         name="gcs-fenced-retire", daemon=True).start()

    def _retire_after_fence(self) -> None:
        time.sleep(0.05)  # let in-flight replies (incl. our rejection) flush
        if not self._shutdown.is_set():
            self.retire()

    def rpc_head_fenced(self, conn, req_id, payload):
        """A successor head telling us it bumped the lease epoch (the
        promoted standby dials the address the old lease record carried).
        Shrinks the stale-serving window from a lease-read period to one
        RPC; epoch-checked so a confused caller can't fence the real
        head."""
        if int(payload.get("epoch", 0)) > self.fence_epoch:
            self._note_fenced(
                f"successor at {payload.get('address')} announced epoch "
                f"{payload.get('epoch')}")
            return True
        return False

    def _reject_fenced_write(self, site: str) -> None:
        self._fencing_rejections += 1
        try:
            _head_metrics()["fencing"].inc(tags={"site": site})
        except Exception:
            pass
        self._note_fenced(f"write rejected at {site}")

    def drain_lease(self) -> None:
        """Rolling head upgrade, step 1: stop renewing and expire the lease
        NOW so a standby promotes immediately (no TTL wait). This head keeps
        serving reads until the standby's epoch bump fences it; call
        `retire()` once the standby is active."""
        if self._lease is None:
            raise RuntimeError("no snapshot store — no lease to drain")
        self._lease_draining = True
        self._lease.relinquish(self._lease_owner, self.fence_epoch)
        logger.info("GCS %s relinquished head lease (epoch %d) for rolling "
                    "upgrade", self._server.address, self.fence_epoch)

    def retire(self) -> None:
        """Rolling head upgrade, step 3: the standby is active; stop without
        fighting it for the store (no final snapshot flush)."""
        self._fenced.set()
        self._shutdown.set()
        for c in self._raylet_clients.values():
            c.close()
        self._server.stop()

    def _note_first_schedule(self) -> None:
        """Stamp a promoted head's first dispatched work: the far edge of
        the tracked promotion latency (lease-expiry -> first-scheduled-task,
        HEADFAIL artifact + ray_tpu_torch_head_promotion_seconds)."""
        p = self.promotion
        if p is None or p.get("first_schedule_at") is not None:
            return
        p["first_schedule_at"] = time.time()
        expired = p.get("lease_expired_at")
        if expired is not None:
            p["latency_s"] = p["first_schedule_at"] - expired
            try:
                _head_metrics()["promotion_s"].set(p["latency_s"])
            except Exception:
                pass

    # ------------------------------------------------------- persistence
    def _load_snapshot(self) -> None:
        if self._snapshots is None:
            return
        import pickle

        try:
            if self._preloaded_snapshot is not None:
                # a promoting StandbyHead hands over its tailed payload:
                # restore is a deserialize, not a store walk (warm takeover)
                payload = self._preloaded_snapshot
            else:
                payload = self._snapshots.load_latest()
            if payload is None:
                return
            data = pickle.loads(payload)
            with self._lock:
                # the cluster session survives head changes: raylets use it
                # as the fingerprint for one-RPC re-adoption; the persisted
                # fence_epoch floors any later lease acquire (a torn lease
                # record must not reset the epoch under the fleet)
                self.session_id = data.get("session_id", self.session_id)
                self._restored_fence_epoch = int(data.get("fence_epoch", 0))
                self._kv = data.get("kv", {})
                self._functions = data.get("functions", {})
                self._function_bytes = sum(
                    len(b) for b in self._functions.values())
                for jid, job in data.get("jobs", {}).items():
                    job = dict(job)
                    if job.get("status") == "RUNNING":
                        # its driver may have died with the old head;
                        # nothing will ever mark it finished. But a
                        # SURVIVING driver re-registers (replay) and
                        # revives the entry — so flip it FAILED now and
                        # only REAP after the health loop's probe finds
                        # its driver_address actually dead.
                        job["status"] = "FAILED"
                        job.setdefault("end_time", time.time())
                        self._restored_unreaped[jid] = None
                    self._jobs[jid] = job
                # Actors come back as awaiting-re-registration: their budget
                # and identity restore from the snapshot, liveness only from
                # the worker's reregister_actor (the source of truth). The
                # health loop reaps those that never re-announce.
                for aid, m in data.get("actor_meta", {}).items():
                    info = ActorInfo(
                        actor_id=aid, name=m["name"], namespace=m["namespace"],
                        state=ActorState.RESTARTING,
                        max_restarts=m["max_restarts"],
                        num_restarts=m["num_restarts"],
                        class_name=m.get("class_name", ""),
                    )
                    self._actors[aid] = info
                    self._actor_owners[aid] = m.get("owner", "")
                    if m.get("spec") is not None:
                        self._actor_specs[aid] = m["spec"]
                    if m["name"]:
                        self._named_actors[(m["namespace"], m["name"])] = aid
                    self._awaiting_rereg[aid] = time.monotonic()
                # Node table: restored entries let a REPLACEMENT head (new
                # address) know which raylets exist and where, so it can
                # dial them and announce itself (_readopt_loop). They stay
                # provisional ("restored") until the raylet re-registers;
                # the heartbeat timeout reaps ones that never do.
                now = time.monotonic()
                for nid, n in data.get("nodes", {}).items():
                    n = dict(n)
                    n["alive"] = True
                    n["restored"] = True
                    self._nodes[nid] = n
                    self._last_heartbeat[nid] = now
                    self._restored_nodes[n["address"]] = nid
                # fencing state: per-identity incarnation counters and the
                # invalidated (dead) identities survive a head change, so
                # a partition-era zombie can't slip past a fresh head
                for nid, inc in data.get("node_incarnations", {}).items():
                    self._node_incarnations[nid] = max(
                        self._node_incarnations.get(nid, 0), int(inc))
                for nid in data.get("dead_nodes", ()):
                    self._dead_node_ids[nid] = None
                nfc = data.get("node_failure_counters")
                if nfc:
                    self._node_deaths.update(nfc.get("deaths", {}))
                    self._node_drains += int(nfc.get("drains", 0))
                    self._node_fences += int(nfc.get("fences", 0))
                    self._node_quarantines += int(
                        nfc.get("quarantines", 0))
                    self._quarantine_recoveries += int(
                        nfc.get("quarantine_recoveries", 0))
                    self._stale_rejections.update(
                        nfc.get("stale_rejections", {}))
                # Placement groups: bundle reservations live on in the
                # raylets (which survived the head), so the restored table
                # — bundles, strategy, bundle->node placement — makes PG
                # state consistent again the moment nodes re-register. A
                # creation the old head died inside (PREPARING) is resumed
                # or failed by the readopt loop; it must not hang forever.
                for pid, p in data.get("pgs", {}).items():
                    self._pgs[pid] = dict(p)
                # hot runtime-env keys survive head changes (stored as
                # AGES — monotonic stamps don't cross processes): a node
                # joining right after a failover still gets its
                # warm-onboarding hints
                for key, rec in data.get("hot_envs", {}).items():
                    self._hot_envs[key] = {
                        "last_seen": now - float(rec.get("age_s", 0.0)),
                        "runtime_env": rec.get("runtime_env")}
            logger.info("GCS restored %d KV namespaces, %d jobs, %d actor "
                        "records, %d nodes, %d placement groups from %s",
                        len(self._kv), len(data.get("jobs", {})),
                        len(data.get("actor_meta", {})),
                        len(data.get("nodes", {})), len(data.get("pgs", {})),
                        self._snapshot_uri)
        except Exception:
            logger.exception("snapshot restore failed; starting fresh")

    def _write_snapshot(self) -> None:
        import pickle

        with self._snapshot_write_lock:  # stop() vs loop: one writer at a time
            if self._lease is not None:
                # fencing gate: a stale head's snapshot write is REJECTED,
                # not raced — the standby that bumped the epoch owns the
                # store now (split-brain prevention, proven by
                # test_head_failover.py's revived-head test)
                from ray_tpu_torch.core.head_lease import LeaseLostError

                try:
                    self._lease.check(self.fence_epoch)
                except LeaseLostError:
                    self._reject_fenced_write("snapshot_save")
                    raise
            with self._lock:
                data = {"session_id": self.session_id,
                        "fence_epoch": self.fence_epoch,
                        "kv": {ns: dict(t) for ns, t in self._kv.items()},
                        # function table: actor restart after a GCS restart
                        # resolves class blobs from here
                        "functions": dict(self._functions),
                        "jobs": dict(self._jobs),
                        # durable actor metadata: restart budgets, names and
                        # owners survive a GCS restart (reference persists the
                        # actor table in Redis, gcs_table_storage.h:50)
                        "actor_meta": {
                            aid: {"name": i.name, "namespace": i.namespace,
                                  "max_restarts": i.max_restarts,
                                  "num_restarts": i.num_restarts,
                                  "class_name": i.class_name,
                                  "owner": self._actor_owners.get(aid, ""),
                                  # full creation spec: restart-on-failure of
                                  # a restored actor needs the class blob
                                  "spec": self._actor_specs.get(aid)}
                            for aid, i in self._actors.items()
                            if i.state != ActorState.DEAD},
                        # node table: a replacement head must know which
                        # raylets to dial (per-node live stats stay out —
                        # they are rebuilt from heartbeats)
                        "nodes": {
                            nid: {k: n.get(k) for k in (
                                "node_id", "address", "object_store_address",
                                "resources_total", "resources_available",
                                "labels", "start_time", "incarnation")}
                            for nid, n in self._nodes.items() if n["alive"]},
                        # incarnation fencing survives head failover: the
                        # per-identity counters (for live nodes) and the
                        # invalidated identities — a zombie that heartbeats
                        # the REPLACEMENT head still gets fenced
                        "node_incarnations": {
                            nid: inc for nid, inc
                            in self._node_incarnations.items()
                            if nid in self._nodes},
                        "dead_nodes": list(self._dead_node_ids)[-4096:],
                        # failure-domain counters: a promoted head keeps
                        # reporting cumulative cluster history, not a
                        # counter reset (gcs_stats consistency across
                        # failover)
                        "node_failure_counters": {
                            "deaths": dict(self._node_deaths),
                            "drains": self._node_drains,
                            "fences": self._node_fences,
                            "quarantines": self._node_quarantines,
                            "quarantine_recoveries":
                                self._quarantine_recoveries,
                            "stale_rejections":
                                dict(self._stale_rejections)},
                        # placement groups with their bundle->node
                        # assignments: raylets keep the reservations, the
                        # head keeps the map (satellite: a restored head
                        # must not forget PGs whose bundles still run)
                        "pgs": {pid: dict(p)
                                for pid, p in self._pgs.items()},
                        # hot env keys as AGES (monotonic stamps don't
                        # cross processes): warm onboarding survives a
                        # head replacement
                        "hot_envs": {
                            k: {"age_s": max(0.0, time.monotonic()
                                             - rec.get("last_seen", 0.0)),
                                "runtime_env": rec.get("runtime_env")}
                            for k, rec in self._hot_envs.items()
                            if time.monotonic() - rec.get("last_seen", 0.0)
                            <= self._HOT_ENV_TTL_S}}
                self._dirty = False
            try:
                self._snapshot_last_version = self._snapshots.save(
                    pickle.dumps(data, protocol=5))
                self._snapshots_written += 1
            except Exception:
                self._dirty = True  # failed write must be retried
                raise

    def _snapshot_loop(self) -> None:
        while not self._shutdown.wait(self._snapshot_interval_s):
            if self._fenced.is_set():
                return  # a newer head owns the store; stop retrying writes
            if self._dirty:
                try:
                    self._write_snapshot()
                except Exception:
                    logger.exception("snapshot write failed")
        # stop() performs the final flush (single writer, serialized above)

    def _readopt_loop(self) -> None:
        """Replacement/promoted-head re-adoption: dial every snapshot-known
        raylet with a fencing-epoch'd `promote_announce` (the in-band
        'callback' flavor of re-resolution — works with no address file). A
        raylet of the SAME cluster session replies with its full
        registration payload in that ONE round trip, so it is adopted as a
        live node immediately — no full re-registration on the failover
        critical path (its reconnect loop still re-subscribes in the
        background, idempotently). Then resume any placement-group creation
        the old head died inside: with idempotent prepare_bundle on the
        raylets, re-running the 2-phase protocol either completes the PG or
        marks it INFEASIBLE — clients polling it never hang."""
        with self._lock:
            targets = dict(self._restored_nodes)
        for address, node_id in targets.items():
            if self._shutdown.is_set():
                return
            self._announce_to(address, node_id)
        # interrupted 2-phase creations: finish or fail them
        with self._lock:
            preparing = [pid for pid, p in self._pgs.items()
                         if p.get("state") == "PREPARING"]
        for pid in preparing:
            if self._shutdown.is_set():
                return
            with self._lock:
                p = self._pgs.get(pid)
                if p is None or p.get("state") != "PREPARING":
                    continue
                bundles, strategy, name = p["bundles"], p["strategy"], p.get("name")
            try:
                result = self._create_placement_group(pid, bundles, strategy,
                                                      name)
            except Exception as e:
                # one bad resume must not kill the thread and strand every
                # LATER interrupted group in PREPARING forever
                logger.exception("resume of placement group %s failed", pid)
                result = {"ok": False, "error": f"resume failed: {e}"}
            if not result.get("ok"):
                with self._lock:
                    p = self._pgs.get(pid)
                    if p is not None and p.get("state") != "CREATED":
                        p["state"] = "INFEASIBLE"
                        p["error"] = result.get("error", "resume failed")
                        self._dirty = True
                logger.warning("placement group %s interrupted by head "
                               "replacement could not be completed: %s",
                               pid, result.get("error"))

    def _announce_to(self, address: str, node_id: bytes) -> bool:
        """Dial one snapshot-known raylet and announce this head, carrying
        the fencing epoch + session id. Same-session raylets reply with
        their registration payload (one-RPC re-adoption); a raylet that
        already adopted a NEWER head rejects us — we are stale, fence.
        Returns True when the node left the provisional set."""
        try:
            client = rpc.connect_with_retry(address, timeout=5,
                                            origin=self._server.address)
        except Exception:
            # raylet gone with the old head; the heartbeat timeout will
            # reap its restored entry
            logger.info("restored node %s at %s unreachable",
                        node_id.hex()[:8], address)
            return False
        reply = None
        try:
            reply = client.call("promote_announce", {
                "address": self._server.address,
                "epoch": self.fence_epoch,
                "session_id": self.session_id,
            }, timeout=5)
        except rpc.RpcCallError:
            # raylet predates promote_announce: legacy one-way announce
            # (now also epoch-stamped so a stale head still gets dropped)
            try:
                client.notify("new_gcs_address",
                              {"address": self._server.address,
                               "epoch": self.fence_epoch})
            except OSError:
                client.close()
                return False
        except (OSError, TimeoutError, rpc.RpcDisconnected):
            client.close()
            return False
        if isinstance(reply, dict) and reply.get("adopted"):
            # one-RPC re-adoption: the reply IS the registration payload
            self._adopt_node(reply, client)
            return True
        if isinstance(reply, dict) and reply.get("reason") == "stale_epoch":
            client.close()
            self._reject_fenced_write("announce")
            return False
        # announced (legacy or session mismatch): the raylet's kicked
        # reconnect loop re-registers the normal way
        with self._lock:
            n = self._nodes.get(node_id)
            if n is not None and n.get("restored"):
                old = self._raylet_clients.get(node_id)
                self._raylet_clients[node_id] = client
                self._last_heartbeat[node_id] = time.monotonic()
            else:
                # re-registration beat us: keep its client, drop ours
                old = client
        if old is not None:
            old.close()
        return False

    def _adopt_node(self, payload: dict, client: rpc.RpcClient) -> None:
        """Install a node from a promote_announce reply exactly as
        register_node would, reusing the announce connection as the
        dispatch client — the raylet is live without a second RPC."""
        node_id = payload["node_id"]
        self._install_node(payload, client)
        logger.info("re-adopted raylet %s in one RPC (session match)",
                    node_id.hex()[:8])

    _REANNOUNCE_PERIOD_S = 2.0

    def _maybe_reannounce_restored(self) -> None:
        """Health-loop backstop for the one-shot readopt pass: keep dialing
        nodes still provisional ('restored') — a raylet unreachable during
        promotion deserves more than one chance before the heartbeat reaper
        takes it. Paced, off-thread, one pass at a time; every dial carries
        the fencing epoch (satellite: no epoch-less announces anywhere)."""
        now = time.monotonic()
        with self._lock:
            if getattr(self, "_reannounce_active", False):
                return
            last = getattr(self, "_last_reannounce", 0.0)
            if not self._restored_nodes \
                    or now - last < self._REANNOUNCE_PERIOD_S:
                return
            self._reannounce_active = True
            self._last_reannounce = now
            targets = dict(self._restored_nodes)

        def run():
            try:
                for address, node_id in targets.items():
                    if self._shutdown.is_set():
                        return
                    self._announce_to(address, node_id)
            finally:
                with self._lock:
                    self._reannounce_active = False

        threading.Thread(target=run, name="gcs-reannounce",
                         daemon=True).start()

    @property
    def address(self) -> str:
        return self._server.address

    def stop(self) -> None:
        self._shutdown.set()
        if self._snapshots is not None and self._dirty \
                and not self._fenced.is_set():
            from ray_tpu_torch.core.head_lease import LeaseLostError

            try:
                self._write_snapshot()
            except LeaseLostError:
                logger.warning("final snapshot flush fenced: a newer head "
                               "owns the store")
            except OSError:
                logger.exception("final snapshot flush failed")
        for c in self._raylet_clients.values():
            c.close()
        self._server.stop()

    def kill(self) -> None:
        """Crash-stop for HA tests: tear the process-level state down the
        way a SIGKILLed head would leave it — NO final snapshot flush (a
        replacement restores from whatever the periodic loop last wrote),
        connections just dropped."""
        self._shutdown.set()
        for c in self._raylet_clients.values():
            c.close()
        self._server.stop()

    # ---------------------------------------------------------------- pubsub
    def _publish(self, channel: str, message: Any) -> None:
        # Partition-aware fan-out: pushes ride server->client connections,
        # which the client-send FaultInjector never sees — consult the
        # partition rules directly so a blackholed side receives no pubsub
        # either (a partitioned raylet must not learn cluster events).
        inj = rpc.get_fault_injector()
        me = self._server.address if inj is not None else None
        for conn in list(self._subs.get(channel, [])):
            if not conn.alive:
                continue
            if inj is not None and conn.origin is not None \
                    and inj.partition_drop(me, conn.origin):
                continue
            conn.push("pubsub", {"channel": channel, "message": message})

    def rpc_subscribe(self, conn, req_id, payload):
        channels = payload["channels"]
        origin = payload.get("origin")
        if origin:
            # the subscriber's NODE identity: lets the partition injector
            # judge pushes on this connection (see _publish)
            conn.origin = origin
        for ch in channels:
            subs = self._subs.setdefault(ch, [])
            if conn not in subs:
                subs.append(conn)
                conn.on_close.append(lambda c, ch=ch: self._unsub(ch, c))
        if CH_RESOURCES in channels:
            # a fresh subscriber has no base view to apply deltas onto
            with self._lock:
                self._bcast_full_needed = True
        return True

    def rpc_publish(self, conn, req_id, payload):
        """Generic application-level publish: fan a message out to every
        subscriber of an arbitrary channel (reference GcsPublisher allows
        app channels the same way, pubsub.proto:28-46). Serve's controller
        uses this to PUSH replica-set version bumps to handles instead of
        parking their long-polls on its exec threads."""
        self._publish(payload["channel"], payload["message"])
        return True

    def rpc_unsubscribe(self, conn, req_id, payload):
        for ch in payload["channels"]:
            self._unsub(ch, conn)
        return True

    def _unsub(self, channel: str, conn) -> None:
        try:
            self._subs.get(channel, []).remove(conn)
        except ValueError:
            pass

    def rpc_publish_logs(self, conn, req_id, payload):
        """Raylet-forwarded worker stdout/stderr -> CH_LOGS subscribers
        (the reference's log_monitor tail-to-driver, log_monitor.py)."""
        self._recent_logs.append(payload)
        self._publish(CH_LOGS, payload)
        return True

    def rpc_get_recent_logs(self, conn, req_id, payload):
        """Last `lines` individual log lines, flattened across publish
        batches (one entry per line, newest last)."""
        n = payload.get("lines", 200) if payload else 200
        if n <= 0:
            return []
        flat = []
        for entry in self._recent_logs:
            for line in entry.get("lines", []):
                flat.append({"pid": entry.get("pid"),
                             "stream": entry.get("stream"),
                             "node_id": entry.get("node_id"),
                             "lines": [line]})
        return flat[-n:]

    def rpc_global_gc(self, conn, req_id, payload):
        """Broadcast a gc request to every raylet -> every worker
        (reference `ray global_gc`, scripts.py:2161)."""
        self._publish(CH_CONTROL, {"cmd": "gc"})
        return True

    # ----------------------------------------------------------------- nodes
    def _count_stale(self, site: str) -> None:
        with self._lock:
            self._stale_rejections[site] = \
                self._stale_rejections.get(site, 0) + 1
        try:
            _node_metrics()["stale_rejections"].inc(tags={"site": site})
        except Exception:
            pass

    def _fence_node_reply(self, node_id: bytes, site: str,
                          reason: str) -> dict:
        """Typed fence response for a node presenting an invalidated
        identity: the raylet that receives it kills its workers (their
        actor incarnations were restarted elsewhere while it was declared
        dead) and rejoins as a FRESH node."""
        with self._lock:
            self._node_fences += 1
            self._dirty = True  # counters are snapshot state
        self._count_stale(site)
        try:
            _node_metrics()["fenced"].inc()
        except Exception:
            pass
        logger.warning("fencing node %s at %s: %s", node_id.hex()[:8],
                       site, reason)
        return {"fenced": True, "reason": reason, "site": site,
                "epoch": self.fence_epoch}

    def rpc_register_node(self, conn, req_id, payload):
        node_id: bytes = payload["node_id"]
        with self._lock:
            n = self._nodes.get(node_id)
            dead = (node_id in self._dead_node_ids
                    or (n is not None and not n.get("alive", True)))
        if dead:
            # a node identity declared dead can never re-register: the
            # cluster already acted on its death (actors restarted,
            # autoscaler replaced it) — the zombie must rejoin fresh
            return self._fence_node_reply(
                node_id, "register",
                "node identity was declared dead; rejoin with a fresh id")
        self._install_node(payload)
        with self._lock:
            nodes = [self._public_node(n) for n in self._nodes]
            hot = self._hot_envs_payload_locked()
            incarnation = self._node_incarnations.get(node_id, 0)
        # epoch + session ride the reply: the raylet uses the epoch to fence
        # stale-head announces and the session id as its re-adoption
        # fingerprint across head promotions; hot_envs is the warm-onboarding
        # hint — the joiner pre-spawns fork templates for these keys so a
        # replacement node serves warm leases immediately. The incarnation
        # is the node's fencing token: heartbeats echo it back.
        return {"nodes": nodes, "epoch": self.fence_epoch,
                "session_id": self.session_id, "hot_envs": hot,
                "incarnation": incarnation}

    def _install_node(self, payload: dict,
                      client: Optional[rpc.RpcClient] = None) -> None:
        """Shared node-installation path for register_node and the
        promote_announce one-RPC re-adoption (which passes the announce
        connection as the dispatch `client`)."""
        node_id: bytes = payload["node_id"]
        with self._lock:
            stale = self._raylet_clients.pop(node_id, None)
            # Incarnation stamping: a raylet re-registering with the
            # incarnation it already holds (link blip, head re-adoption)
            # KEEPS it — no bump, so an in-flight heartbeat can't race a
            # re-register into a spurious mismatch. A fresh join (no or
            # older incarnation) gets the identity's next monotonic value.
            known = self._node_incarnations.get(node_id, 0)
            offered = int(payload.get("incarnation") or 0)
            incarnation = offered if offered >= known and offered > 0 \
                else known + 1
            self._node_incarnations[node_id] = incarnation
            self._nodes[node_id] = {
                "node_id": node_id,
                "address": payload["address"],
                "object_store_address": payload.get("object_store_address", payload["address"]),
                "resources_total": dict(payload["resources"]),
                # re-registration after a GCS restart reports true availability
                "resources_available": dict(
                    payload.get("resources_available", payload["resources"])),
                "labels": payload.get("labels", {}),
                "alive": True,
                "incarnation": incarnation,
                "start_time": payload.get("start_time") or time.time(),
            }
            self._restored_nodes.pop(payload["address"], None)
            self._last_heartbeat[node_id] = time.monotonic()
            self._dirty = True  # membership is snapshot state
            self._bcast_dirty.add(node_id.hex())
            self._bcast_removed.discard(node_id.hex())
            self._bcast_full_needed = True  # topology: next publish is full
            if client is not None:
                self._raylet_clients[node_id] = client
            else:
                try:
                    self._raylet_clients[node_id] = rpc.connect_with_retry(
                        payload["address"], timeout=10,
                        origin=self._server.address)
                except Exception:
                    logger.exception("GCS could not connect back to raylet %s", payload["address"])
            # fresh capacity: every capacity-starved restart is due NOW
            for aid in self._pending_restarts:
                self._pending_restarts[aid] = 0.0
        if stale is not None and stale is not client:
            stale.close()
        # Bundle re-pinning: the raylet reports the PG bundle reservations
        # it still holds. A head replacement may have restored a snapshot
        # older than a commit — adopt the raylet's committed bundles into
        # the known PG table so placement reflects what the fleet actually
        # holds (the raylet, not the snapshot, is the source of truth for
        # reservations it charged).
        stale_bundles = []
        with self._lock:
            for b in payload.get("bundles", ()):
                pg = self._pgs.get(b["pg_id"])
                if pg is None or not b.get("committed"):
                    continue
                placement = pg.get("placement")
                idx = b["bundle_index"]
                if placement is None or idx >= len(placement) \
                        or placement[idx] == node_id:
                    continue
                holder = self._nodes.get(placement[idx])
                if holder is not None and holder.get("alive"):
                    # the bundle was rescheduled onto a LIVE node while
                    # this raylet was away (falsely-dead node, heartbeat
                    # starvation, re-registering after the bundle resched
                    # moved its bundles): this raylet's reservation is the
                    # stale one — return it instead of stealing the
                    # placement back and leaking the live holder's charge
                    stale_bundles.append((b["pg_id"], idx))
                else:
                    placement[idx] = node_id
                    self._dirty = True
        for pg_id, idx in stale_bundles:
            c = self._raylet_client(node_id)
            if c is None:
                break
            try:
                c.notify("return_bundle",
                         {"pg_id": pg_id, "bundle_index": idx})
                logger.warning("raylet %s re-registered holding bundle "
                               "(%s, %d) that was rescheduled; returning "
                               "its stale reservation",
                               node_id.hex()[:8], pg_id, idx)
            except OSError:
                pass
        self._publish(CH_NODES, {"event": "added", "node": self._public_node(node_id)})
        self._broadcast_resources(force=True)

    def _public_node(self, node_id: bytes) -> dict:
        n = self._nodes[node_id]
        out = {k: n[k] for k in (
            "node_id", "address", "object_store_address", "resources_total",
            "resources_available", "labels", "alive")}
        if n.get("stats"):
            out["stats"] = n["stats"]
        if n.get("join_to_first_warm_lease_s") is not None:
            # warm-onboarding observability: how long this node took from
            # join to its first forked lease (set once, by report_warm_lease)
            out["join_to_first_warm_lease_s"] = n["join_to_first_warm_lease_s"]
        return out

    def rpc_heartbeat(self, conn, req_id, payload):
        node_id = payload["node_id"]
        with self._lock:
            n = self._nodes.get(node_id)
            dead = (node_id in self._dead_node_ids
                    or (n is not None and not n.get("alive", True)))
        if dead:
            # zombie raylet (declared dead during a partition, network
            # healed): its identity is invalidated — typed fence reply
            # makes it kill its workers and rejoin as a fresh node
            return self._fence_node_reply(
                node_id, "heartbeat",
                "heartbeat from a node identity declared dead")
        if n is None:
            # unknown (not invalidated) identity: a registration this head
            # never saw (e.g. landed after the snapshot a replacement head
            # restored). Not a fence — the raylet just re-registers.
            return {"unknown": True}
        recovered = False
        with self._lock:
            self._last_heartbeat[node_id] = time.monotonic()
            n = self._nodes.get(node_id)
            if n is not None and n.pop("quarantined", None):
                # gray-failure recovery: heartbeats resumed before the
                # death bound — the node rejoins scheduling with its
                # actors/leases intact, no replacement launched
                self._quarantine_recoveries += 1
                self._dirty = True  # counters are snapshot state
                self._bcast_dirty.add(node_id.hex())
                self._bcast_full_needed = True
                recovered = True
        if recovered:
            logger.warning("node %s recovered from quarantine (heartbeats "
                           "resumed)", node_id.hex()[:8])
            self._publish(CH_NODES, {"event": "recovered",
                                     "node_id": node_id})
            self._broadcast_resources(force=True)
        with self._lock:
            n = self._nodes.get(node_id)
            if n is not None and "resources_available" in payload:
                if n["resources_available"] != payload["resources_available"]:
                    self._bcast_dirty.add(node_id.hex())
                n["resources_available"] = payload["resources_available"]
            if n is not None:
                n["pending_demands"] = payload.get("pending_demands", [])
                # per-node physical utilization (reference reporter agent):
                # ALWAYS overwritten (an empty report clears the entry —
                # stale samples must not masquerade as live data) and
                # timestamped so readers can judge freshness
                stats = payload.get("node_stats") or {}
                if stats:
                    stats["sampled_at"] = time.time()
                    n["stats"] = stats
                else:
                    n.pop("stats", None)
            # hot runtime-env tracking (warm node onboarding): raylets
            # report env keys with recent lease traffic; joiners get the
            # fleet-wide view in their register_node reply
            now_mono = time.monotonic()
            for ent in payload.get("hot_envs", ()):
                key = ent.get("env_key")
                rec = self._hot_envs.setdefault(key, {})
                rec["last_seen"] = now_mono
                if ent.get("runtime_env") is not None:
                    rec["runtime_env"] = ent["runtime_env"]
            # opportunistic prune: keys cold past the TTL leave the table
            # (and the snapshot) instead of accumulating across env churn
            for key in [k for k, rec in self._hot_envs.items()
                        if now_mono - rec.get("last_seen", 0.0)
                        > self._HOT_ENV_TTL_S]:
                del self._hot_envs[key]
        return True

    _HOT_ENV_TTL_S = 600.0

    def _hot_envs_payload_locked(self) -> list:
        """Caller holds self._lock. Recently-hot env keys (most recent
        first, capped) for a joining raylet's template prewarm."""
        now = time.monotonic()
        out = []
        for key, rec in sorted(self._hot_envs.items(),
                               key=lambda kv: -kv[1].get("last_seen", 0.0)):
            if now - rec.get("last_seen", 0.0) > self._HOT_ENV_TTL_S:
                continue
            out.append({"env_key": key,
                        "runtime_env": rec.get("runtime_env")})
            if len(out) >= 8:
                break
        return out

    def rpc_autoscaler_report(self, conn, req_id, payload):
        """The autoscaler's reconcile counters (launches, relaunches,
        deaths seen, breaker state), refreshed every tick; surfaced via
        gcs_stats so node-level recovery is observable in one place."""
        with self._lock:
            self._autoscaler_stats = dict(payload or {})
        return True

    def rpc_report_warm_lease(self, conn, req_id, payload):
        """A joined raylet served its first WARM (forked) lease: the far
        edge of node-join-to-first-warm-lease — the number warm onboarding
        exists to shrink."""
        sample = {"node_id": payload["node_id"].hex(),
                  "join_to_first_warm_lease_s":
                      float(payload["join_to_first_warm_lease_s"]),
                  "at": time.time()}
        with self._lock:
            self._warm_lease_joins.append(sample)
            n = self._nodes.get(payload["node_id"])
            if n is not None:
                n["join_to_first_warm_lease_s"] = \
                    sample["join_to_first_warm_lease_s"]
        try:
            _node_metrics()["join_warm"].set(
                sample["join_to_first_warm_lease_s"])
        except Exception:
            pass
        return True

    def rpc_get_pending_demands(self, conn, req_id, payload):
        """Aggregate unscheduled resource demand (autoscaler input; reference
        load_metrics.py)."""
        with self._lock:
            out = []
            for n in self._nodes.values():
                if n["alive"]:
                    out.extend(n.get("pending_demands", []))
            return out

    def rpc_report_resources(self, conn, req_id, payload):
        """Raylet resource view update (reference RaySyncer role)."""
        node_id = payload["node_id"]
        with self._lock:
            n = self._nodes.get(node_id)
            if n is not None:
                n["resources_available"] = payload["available"]
                self._bcast_dirty.add(node_id.hex())
        self._broadcast_resources()
        return True

    def _broadcast_resources(self, force: bool = False) -> None:
        """Debounced CH_RESOURCES fan-out: every subscribed raylet runs a
        scheduling pass on each broadcast, so per-completion rebroadcasts
        multiplied control-plane work by the node count. At most one publish
        per resource_broadcast_period_ms; a burst arms one trailing timer so
        the final view always lands. Topology changes (node added/removed)
        pass force=True — membership must never wait out a debounce."""
        self._bcast_debounce(force=force)

    def _publish_resources(self) -> None:
        """One CH_RESOURCES publish: a per-node DELTA of the views that
        changed since the last publish (so steady-state gossip is O(changed
        nodes), not O(nodes) payload x O(nodes) subscribers — the former
        full-snapshot fan-out was O(nodes²) bytes at fleet scale), or a
        FULL snapshot on topology change / new subscriber / first publish.
        Every message carries a sequence number (raylets detect gaps and
        catch up via get_resources_full) and the fencing epoch (a stale
        head's publishes are ignored)."""
        import pickle as _pickle

        with self._lock:
            subs = len(self._subs.get(CH_RESOURCES, ()))
            self._bcast_seq += 1
            seq = self._bcast_seq
            full = (self._bcast_full_needed
                    or not get_config().resource_broadcast_delta_enabled)
            if full:
                msg = {"kind": "full", "seq": seq, "epoch": self.fence_epoch,
                       "nodes": self._cluster_view_locked()}
                self._bcast_fulls += 1
                self._bcast_full_needed = False
            else:
                changed = {}
                for hexid in self._bcast_dirty:
                    try:
                        n = self._nodes.get(bytes.fromhex(hexid))
                    except ValueError:
                        continue
                    if n is not None and n["alive"]:
                        changed[hexid] = self._node_view(n)
                msg = {"kind": "delta", "seq": seq, "prev": seq - 1,
                       "epoch": self.fence_epoch, "changed": changed,
                       "removed": sorted(self._bcast_removed)}
                self._bcast_deltas += 1
            self._bcast_dirty.clear()
            self._bcast_removed.clear()
        # accounting (bytes that hit subscriber sockets) rides the same
        # pickle the rpc layer would produce; one dumps per debounce period
        try:
            self._bcast_bytes += len(_pickle.dumps(msg, protocol=5)) \
                * max(1, subs)
        except Exception:
            pass
        self._publish(CH_RESOURCES, msg)

    def rpc_get_resources_full(self, conn, req_id, payload):
        """Subscriber catch-up: a raylet that missed a delta (gap in the
        sequence) pulls one consistent full view + the seq it is current
        as of, then resumes applying deltas from there."""
        with self._lock:
            return {"kind": "full", "seq": self._bcast_seq,
                    "epoch": self.fence_epoch,
                    "nodes": self._cluster_view_locked()}

    @staticmethod
    def _node_view(n: dict) -> dict:
        return {
            "address": n["address"],
            "object_store_address": n["object_store_address"],
            "total": dict(n["resources_total"]),
            "available": dict(n["resources_available"]),
            "labels": dict(n["labels"]),
            "alive": n["alive"],
            # quarantined nodes stay ALIVE (no replacement, actors kept)
            # but take no NEW dispatch anywhere in the fleet
            "quarantined": bool(n.get("quarantined")),
        }

    def _cluster_view_locked(self) -> dict:
        return {nid.hex(): self._node_view(n)
                for nid, n in self._nodes.items()}

    def cluster_view(self) -> dict:
        with self._lock:
            return self._cluster_view_locked()

    def rpc_get_cluster_view(self, conn, req_id, payload):
        return self.cluster_view()

    def rpc_get_all_nodes(self, conn, req_id, payload):
        with self._lock:
            return [self._public_node(n) for n in self._nodes]

    def rpc_drain_node(self, conn, req_id, payload):
        """Graceful removal (autoscaler downscale)."""
        self._mark_node_dead(payload["node_id"], "drained")
        return True

    def _health_loop(self) -> None:
        cfg = get_config()
        period = cfg.health_check_period_ms / 1000.0
        timeout = cfg.health_check_timeout_ms / 1000.0
        # gray-failure quarantine bound: strictly INSIDE the death bound
        # (0 = half of it), so a degraded node stops receiving new
        # dispatch before it is declared dead — and crash-stop detection
        # latency is untouched (the death check below is independent)
        q_ms = cfg.node_quarantine_timeout_ms
        quarantine_s = (q_ms / 1000.0) if q_ms > 0 else timeout / 2.0
        quarantine_s = min(quarantine_s, timeout * 0.9)
        while not self._shutdown.wait(period):
            now = time.monotonic()
            dead = []
            suspects = []
            with self._lock:
                for nid, last in self._last_heartbeat.items():
                    n = self._nodes.get(nid, {})
                    if not n.get("alive"):
                        continue
                    if now - last > timeout:
                        dead.append(nid)
                    elif now - last > quarantine_s \
                            and not n.get("quarantined"):
                        n["quarantined"] = True
                        self._node_quarantines += 1
                        self._dirty = True  # counters are snapshot state
                        self._bcast_dirty.add(nid.hex())
                        self._bcast_full_needed = True
                        suspects.append(nid)
            for nid in suspects:
                logger.warning(
                    "node %s heartbeat delivery degraded (> %.1fs silent); "
                    "QUARANTINED — no new dispatch, replacement held until "
                    "the %.1fs death bound", nid.hex()[:8], quarantine_s,
                    timeout)
                try:
                    _node_metrics()["quarantines"].inc()
                except Exception:
                    pass
                self._publish(CH_NODES, {"event": "quarantined",
                                         "node_id": nid})
            if suspects:
                self._broadcast_resources(force=True)
            for nid in dead:
                logger.warning("node %s missed heartbeats; marking dead", nid.hex()[:8])
                self._mark_node_dead(nid, "health check failed")
            # Reap snapshot-restored actors whose worker never re-announced
            # (the process died together with the old GCS's view of it).
            reap = []
            with self._lock:
                for aid, since in list(self._awaiting_rereg.items()):
                    if now - since > 60.0:
                        self._awaiting_rereg.pop(aid, None)
                        info = self._actors.get(aid)
                        if info is not None and info.state == ActorState.RESTARTING:
                            reap.append(aid)
            for aid in reap:
                with self._lock:
                    info = self._actors[aid]
                    info.state = ActorState.DEAD
                    info.death_cause = "did not re-register after GCS restart"
                    self._dirty = True
                self._publish(CH_ACTORS, {
                    "actor_id": aid, "state": "DEAD", "address": "",
                    "death_cause": info.death_cause})
            # PENDING placement groups are retryable (transient prepare
            # failure, capacity that has since arrived): re-run their 2PC
            # off-thread, paced, so a blip never strands a group forever.
            self._maybe_retry_pending_pgs()
            # actors whose restart found no capacity (node death ahead of
            # the replacement) retry here until a node can hold them
            self._maybe_retry_actor_restarts()
            # bundles stranded on dead nodes move to live capacity
            self._maybe_reschedule_lost_bundles()
            # still-provisional snapshot-restored nodes get re-dialed (with
            # the fencing epoch) until they adopt us or the reaper wins
            self._maybe_reannounce_restored()
            # driver-death backstop: RUNNING jobs with no live conn and
            # snapshot-restored unreaped jobs get probed within
            # job_reap_detection_bound_s
            self._maybe_probe_dead_drivers(time.monotonic())

    _RESTART_RETRY_INTERVAL_S = 1.0

    def _maybe_retry_actor_restarts(self) -> None:
        """Paced, off-thread re-scheduling of RESTARTING actors that had no
        capacity at failure time (reference GcsActorManager keeps such
        actors PENDING until a node can hold them). A node registration
        makes every entry immediately due (_install_node)."""
        now = time.monotonic()
        with self._lock:
            if self._restart_retry_active or self._shutdown.is_set():
                return
            due = [aid for aid, t in self._pending_restarts.items()
                   if now >= t]
            if not due:
                return
            self._restart_retry_active = True

        def run():
            try:
                pending_timeout = get_config().actor_restart_pending_timeout_s
                for aid in due:
                    if self._shutdown.is_set():
                        return
                    expired = None
                    with self._lock:
                        info = self._actors.get(aid)
                        if info is None \
                                or info.state != ActorState.RESTARTING:
                            self._pending_restarts.pop(aid, None)
                            self._pending_restart_since.pop(aid, None)
                            continue
                        since = self._pending_restart_since.get(aid)
                        if since is not None and pending_timeout > 0 and \
                                time.monotonic() - since > pending_timeout:
                            # the wait is bounded: a restart nothing can
                            # ever place (node type unlaunchable, breaker
                            # stuck open) must fail typed, not hang refs
                            info.state = ActorState.DEAD
                            info.death_cause = (
                                "restart failed: no feasible capacity "
                                f"within {pending_timeout:.0f}s")
                            self._pending_restarts.pop(aid, None)
                            self._pending_restart_since.pop(aid, None)
                            self._dirty = True
                            expired = info
                    if expired is not None:
                        logger.warning("actor %s restart expired after "
                                       "%.0fs with no capacity; marking "
                                       "DEAD", aid, pending_timeout)
                        self._publish(CH_ACTORS, {
                            "actor_id": aid, "state": expired.state.value,
                            "address": "",
                            "death_cause": expired.death_cause})
                        continue
                    if self._schedule_actor(aid, require_available=True):
                        with self._lock:
                            self._pending_restarts.pop(aid, None)
                            self._pending_restart_since.pop(aid, None)
                    else:
                        with self._lock:
                            self._pending_restarts[aid] = time.monotonic() \
                                + self._RESTART_RETRY_INTERVAL_S
            finally:
                with self._lock:
                    self._restart_retry_active = False

        threading.Thread(target=run, name="gcs-actor-restart-retry",
                         daemon=True).start()

    _BUNDLE_RESCHED_INTERVAL_S = 2.0

    def _maybe_reschedule_lost_bundles(self) -> None:
        """CREATED placement groups with bundles on dead nodes get those
        bundles re-placed on surviving/replacement capacity (reference
        GcsPlacementGroupManager bundle rescheduling on node death). Only
        the LOST bundles move — surviving reservations are never touched,
        so no double-charge and no full re-placement churn."""
        now = time.monotonic()
        with self._lock:
            if self._bundle_resched_active or self._shutdown.is_set():
                return
            alive = {nid for nid, n in self._nodes.items() if n["alive"]}
            work = []
            for pid, p in self._pgs.items():
                if p.get("state") != "CREATED" or not p.get("placement"):
                    continue
                lost = [i for i, nid in enumerate(p["placement"])
                        if nid not in alive]
                if lost and now - p.get("_last_resched", 0.0) \
                        > self._BUNDLE_RESCHED_INTERVAL_S:
                    work.append((pid, lost))
            if not work:
                return
            self._bundle_resched_active = True

        def run():
            try:
                for pid, lost in work:
                    if self._shutdown.is_set():
                        return
                    try:
                        self._reschedule_bundles(pid, lost)
                    except Exception:
                        logger.exception("bundle reschedule of %s failed",
                                         pid)
            finally:
                with self._lock:
                    self._bundle_resched_active = False

        threading.Thread(target=run, name="gcs-bundle-resched",
                         daemon=True).start()

    def _reschedule_bundles(self, pg_id: PlacementGroupID,
                            lost_indices: List[int]) -> None:
        with self._lock:
            p = self._pgs.get(pg_id)
            if p is None or p.get("state") != "CREATED":
                return
            p["_last_resched"] = time.monotonic()
            bundles = p["bundles"]
            placement = list(p["placement"])
            strategy = p["strategy"]
            views = [
                NodeView(nid, n["resources_total"],
                         n["resources_available"], n["labels"])
                for nid, n in self._nodes.items()
                if n["alive"] and not n.get("quarantined")]
        held = {placement[i] for i in range(len(placement))
                if i not in lost_indices}
        for idx in lost_indices:
            bundle = bundles[idx]
            candidates = views
            if strategy == "STRICT_SPREAD":
                candidates = [v for v in views if v.node_id not in held]
            elif strategy == "STRICT_PACK":
                # co-locate with surviving bundles when possible; a strict
                # pack broken by node death prefers partial locality over
                # staying broken forever
                candidates = [v for v in views if v.node_id in held] or views
            avail = [v for v in candidates if v.is_available(bundle)]
            if not avail:
                continue  # paced retry finds replacement capacity later
            target = min(avail,
                         key=lambda v: (v.utilization(), v.node_id)).node_id
            client = self._raylet_client(target)
            if client is None:
                continue
            try:
                if not client.call("prepare_bundle", {
                        "pg_id": pg_id, "bundle_index": idx,
                        "resources": bundle}, timeout=10):
                    continue
                client.notify("commit_bundle",
                              {"pg_id": pg_id, "bundle_index": idx})
            except (OSError, TimeoutError, rpc.RpcCallError,
                    rpc.RpcDisconnected) as e:
                logger.info("bundle reschedule prepare on %s failed: %s",
                            target.hex()[:8], e)
                continue
            with self._lock:
                p = self._pgs.get(pg_id)
                if p is None or not p.get("placement") \
                        or idx >= len(p["placement"]):
                    # group removed while we re-placed: return the bundle
                    try:
                        client.notify("return_bundle", {
                            "pg_id": pg_id, "bundle_index": idx})
                    except OSError:
                        pass
                    continue
                p["placement"][idx] = target
                self._dirty = True
            held.add(target)
            logger.warning("rescheduled bundle (%s, %d) onto %s after node "
                           "death", pg_id, idx, target.hex()[:8])

    _PG_RETRY_INTERVAL_S = 5.0

    def _maybe_retry_pending_pgs(self) -> None:
        now = time.monotonic()
        with self._lock:
            if self._pg_retry_active or self._shutdown.is_set():
                return
            if not any(n["alive"] for n in self._nodes.values()):
                return
            due = [pid for pid, p in self._pgs.items()
                   if p.get("state") == "PENDING"
                   and now - p.get("_last_attempt", 0.0)
                   > self._PG_RETRY_INTERVAL_S]
            if not due:
                return
            self._pg_retry_active = True

        def run():
            try:
                for pid in due:
                    if self._shutdown.is_set():
                        return
                    with self._lock:
                        p = self._pgs.get(pid)
                        if p is None or p.get("state") != "PENDING":
                            continue
                        bundles, strategy = p["bundles"], p["strategy"]
                        name = p.get("name")
                    try:
                        self._create_placement_group(pid, bundles, strategy,
                                                     name)
                    except Exception:
                        logger.exception("retry of pending placement group "
                                         "failed")
                    finally:
                        # stamped AFTER the attempt (creation overwrites the
                        # entry) so the pace holds even across failures
                        with self._lock:
                            p = self._pgs.get(pid)
                            if p is not None:
                                p["_last_attempt"] = time.monotonic()
            finally:
                with self._lock:
                    self._pg_retry_active = False

        threading.Thread(target=run, name="gcs-pg-retry", daemon=True).start()

    def _raylet_client(self, node_id: bytes) -> Optional[rpc.RpcClient]:
        """Live dispatch client for a node, reconnecting a dead one (a
        severed link — injected fault, transient network blip — must not
        permanently cut the head off from an otherwise-alive raylet)."""
        with self._lock:
            c = self._raylet_clients.get(node_id)
            n = self._nodes.get(node_id)
        if c is not None and not c.closed:
            return c
        if n is None or not n.get("alive"):
            return None
        try:
            fresh = rpc.connect_with_retry(n["address"], timeout=3,
                                           origin=self._server.address)
        except Exception:
            logger.info("could not reconnect to raylet %s at %s",
                        node_id.hex()[:8], n["address"])
            return None
        with self._lock:
            cur = self._raylet_clients.get(node_id)
            if cur is not None and not cur.closed:
                keep = cur  # a re-registration raced us in; use its client
            else:
                self._raylet_clients[node_id] = fresh
                keep = fresh
        if keep is not fresh:
            fresh.close()
        return keep

    def _mark_node_dead(self, node_id: bytes, reason: str) -> None:
        with self._lock:
            n = self._nodes.get(node_id)
            if n is None or not n["alive"]:
                return
            n["alive"] = False
            n.pop("quarantined", None)
            # invalidate the identity: from here on, any heartbeat/register
            # presenting this node_id is a zombie and gets fenced. Bounded:
            # the OLDEST invalidations evict past the cap (zombies return
            # within heal timescales, not after 4096 later deaths).
            self._dead_node_ids[node_id] = None
            while len(self._dead_node_ids) > 4096:
                self._dead_node_ids.pop(next(iter(self._dead_node_ids)))
            self._restored_nodes.pop(n.get("address"), None)
            self._dirty = True  # membership is snapshot state
            self._bcast_removed.add(node_id.hex())
            self._bcast_dirty.discard(node_id.hex())
            self._bcast_full_needed = True  # topology: next publish is full
            client = self._raylet_clients.pop(node_id, None)
            tag = reason.replace(" ", "_")
            if tag == "drained":
                # graceful removal (autoscaler downscale, operator drain)
                # is not a DEATH: counting it would make the headline
                # failure metric fire on routine scale-down
                self._node_drains += 1
                tag = None
            else:
                self._node_deaths[tag] = self._node_deaths.get(tag, 0) + 1
        if tag is not None:
            try:
                _node_metrics()["deaths"].inc(tags={"reason": tag})
            except Exception:
                pass
        if client:
            client.close()
        self._publish(CH_NODES, {"event": "removed", "node_id": node_id, "reason": reason})
        self._broadcast_resources(force=True)
        # Fail over actors that lived on the dead node.
        with self._lock:
            affected = [a for a in self._actors.values() if a.node_id == node_id and a.state == ActorState.ALIVE]
        for info in affected:
            self._handle_actor_failure(info.actor_id, f"node {node_id.hex()[:8]} died: {reason}")
        # A creation/restart DISPATCHED to this node before it died will
        # never report actor_creation_done, and a successful dispatch left
        # _pending_restarts — nothing retries it. Re-park such actors
        # due-now for the paced retry (no budget charge: that incarnation
        # never ran). This is the kill-storm race — a second node kill
        # landing inside another restart's dispatch->done window.
        with self._lock:
            now = time.monotonic()
            stranded = []
            for a in self._actors.values():
                if a.node_id == node_id and a.state in (
                        ActorState.PENDING, ActorState.RESTARTING):
                    a.state = ActorState.RESTARTING
                    a.address = ""
                    self._pending_restarts[a.actor_id] = 0.0
                    self._pending_restart_since.setdefault(a.actor_id, now)
                    stranded.append(a.actor_id)
            if stranded:
                self._dirty = True
        for aid in stranded:
            logger.warning("actor %s creation was in flight on dead node "
                           "%s; re-parking for retry", aid,
                           node_id.hex()[:8])
            self._publish(CH_ACTORS, {"actor_id": aid, "state": "RESTARTING",
                                      "address": "", "death_cause": ""})
        # bundles the dead node held move to surviving/replacement nodes
        self._maybe_reschedule_lost_bundles()

    # ---------------------------------------------------------------- kv
    def rpc_kv_put(self, conn, req_id, payload):
        ns = payload.get("namespace", "")
        with self._lock:
            table = self._kv.setdefault(ns, {})
            exists = payload["key"] in table
            if payload.get("overwrite", True) or not exists:
                table[payload["key"]] = payload["value"]
                self._dirty = True
                return True
            return False

    def rpc_kv_get(self, conn, req_id, payload):
        ns = payload.get("namespace", "")
        with self._lock:
            return self._kv.get(ns, {}).get(payload["key"])

    def rpc_kv_del(self, conn, req_id, payload):
        ns = payload.get("namespace", "")
        with self._lock:
            removed = self._kv.get(ns, {}).pop(payload["key"], None) is not None
            self._dirty = self._dirty or removed
            return removed

    def rpc_kv_keys(self, conn, req_id, payload):
        ns = payload.get("namespace", "")
        prefix = payload.get("prefix", b"")
        with self._lock:
            return [k for k in self._kv.get(ns, {}) if k.startswith(prefix)]

    def rpc_kv_exists(self, conn, req_id, payload):
        ns = payload.get("namespace", "")
        with self._lock:
            return payload["key"] in self._kv.get(ns, {})

    # ------------------------------------------------------- function table
    def rpc_function_put(self, conn, req_id, payload):
        """Export-once function/class blob, keyed by content hash
        (reference function_manager.py export to GCS). Idempotent: the same
        id always maps to the same bytes, so a duplicate put (replay after
        a GCS restart, two submitters racing) is a no-op."""
        with self._lock:
            self._function_puts += 1
            jid = payload.get("job_id")
            if jid is not None:
                # job ownership index: the fate-sharing reap frees an
                # export only when the dead job was its LAST owner
                self._function_jobs.setdefault(
                    payload["function_id"], set()).add(jid)
            if payload["function_id"] not in self._functions:
                self._functions[payload["function_id"]] = payload["blob"]
                self._function_bytes += len(payload["blob"])
                self._dirty = True
                # Byte-budget FIFO eviction: a driver minting unbounded
                # DISTINCT closures (new lambda per batch) must not grow
                # the table and its snapshot forever. An evicted function
                # fails its executor fetch — loudly, and only in that
                # pathological pattern (steady workloads re-use ids).
                budget = get_config().function_table_max_bytes
                while self._function_bytes > budget and len(self._functions) > 1:
                    old_id = next(iter(self._functions))
                    self._function_bytes -= len(self._functions.pop(old_id))
                    self._function_jobs.pop(old_id, None)
                    self._function_evictions += 1
                    logger.warning(
                        "function table over %d bytes; evicted oldest "
                        "export %s (%d evictions total) — raise "
                        "RAY_TPU_TORCH_FUNCTION_TABLE_MAX_BYTES or stop "
                        "creating distinct closures per submission",
                        budget, old_id.hex()[:12], self._function_evictions)
        return True

    def rpc_function_get(self, conn, req_id, payload):
        """Executor miss path: fetch a blob for local deserialization."""
        with self._lock:
            return self._functions.get(payload["function_id"])

    def rpc_function_table_stats(self, conn, req_id, payload):
        with self._lock:
            return {"entries": len(self._functions),
                    "bytes": self._function_bytes,
                    "puts": self._function_puts,
                    "evictions": self._function_evictions}

    # ------------------------------------------------------------ head stats
    def rpc_gcs_stats(self, conn, req_id, payload):
        """Control-plane observability in one call: lease/fencing state,
        snapshot counters, broadcast (full vs delta) accounting, and the
        last promotion record — the numbers the HA metrics export
        (`ray_tpu_torch_head_failovers_total`, `ray_tpu_torch_head_promotion_seconds`,
        `ray_tpu_torch_fencing_rejections_total`) are derived from."""
        with self._lock:
            alive = sum(1 for n in self._nodes.values() if n["alive"])
            provisional = sum(1 for n in self._nodes.values()
                              if n["alive"] and n.get("restored"))
            # storage failure-domain roll-up: per-node object_store blocks
            # (heartbeat node_stats) summed fleet-wide + the degraded list
            storage = {"used_bytes": 0, "capacity_bytes": 0,
                       "pinned_bytes": 0, "pool_bytes": 0,
                       "spilled_bytes": 0, "nodes_reporting": 0,
                       "nodes_spill_degraded": []}
            for nid, n in self._nodes.items():
                blk = (n.get("stats") or {}).get("object_store")
                if not n["alive"] or not blk:
                    continue
                storage["nodes_reporting"] += 1
                for k in ("used_bytes", "capacity_bytes", "pinned_bytes",
                          "pool_bytes", "spilled_bytes"):
                    storage[k] += blk.get(k, 0)
                if blk.get("spill_degraded"):
                    storage["nodes_spill_degraded"].append(nid.hex())
            bcast = {"seq": self._bcast_seq, "fulls": self._bcast_fulls,
                     "deltas": self._bcast_deltas,
                     "bytes_sent": self._bcast_bytes,
                     "delta_enabled":
                         get_config().resource_broadcast_delta_enabled}
            joins = list(self._warm_lease_joins)
            # observability plane: span shipping + per-stage critical-path
            # latency roll-up (submit/lease/dispatch/run/result-deliver)
            from ray_tpu_torch.util.stats import percentile as _pct

            stage_lat = {}
            for stage, window in self._stage_lat_us.items():
                vals = sorted(window)
                stage_lat[stage] = {
                    "count": len(vals),
                    "p50_us": round(_pct(vals, 0.50) or 0.0, 1),
                    "p99_us": round(_pct(vals, 0.99) or 0.0, 1),
                }
            tracing_blk = {
                "enabled": get_config().tracing_enabled,
                "traces": len(self._traces),
                "traces_evicted": self._traces_evicted,
                "spans_buffered": len(self._profile_events),
                "spans_dropped": self._spans_dropped,
                "clock_sources": len(self._span_clock_offsets),
                "stage_latency_us": stage_lat,
            }
            node_failure = {
                "deaths_by_reason": dict(self._node_deaths),
                "deaths_total": sum(self._node_deaths.values()),
                "drains_total": self._node_drains,
                "autoscaler": dict(self._autoscaler_stats),
                "pending_actor_restarts": len(self._pending_restarts),
                # partition failure domain: incarnation fences, gray-failure
                # quarantine state machine, stale-incarnation rejections
                # (the gcs_stats face of ray_tpu_torch_node_fenced_total /
                # ray_tpu_torch_node_quarantines_total /
                # ray_tpu_torch_stale_incarnation_rejections_total)
                "fences_total": self._node_fences,
                "quarantines_total": self._node_quarantines,
                "quarantine_recoveries_total": self._quarantine_recoveries,
                "nodes_quarantined": sum(
                    1 for n in self._nodes.values()
                    if n["alive"] and n.get("quarantined")),
                "stale_incarnation_rejections": dict(self._stale_rejections),
                "stale_incarnation_rejections_total": sum(
                    self._stale_rejections.values()),
                "hot_env_keys": [e["env_key"]
                                 for e in self._hot_envs_payload_locked()],
                "warm_lease_joins": joins[-10:],
                "node_join_to_first_warm_lease_s":
                    joins[-1]["join_to_first_warm_lease_s"] if joins
                    else None,
            }
            # job failure domain: per-job live-actor roll-up + fate-sharing
            # reap counters (the gcs_stats face of ray_tpu_torch_job_reaps_total;
            # `ray_tpu_torch jobs` renders this block)
            live_actors: Dict[bytes, int] = {}
            detached_actors: Dict[bytes, int] = {}
            for aid, spec in self._actor_specs.items():
                info = self._actors.get(aid)
                if info is None or info.state == ActorState.DEAD:
                    continue
                sj = getattr(spec, "job_id", None)
                sjb = sj.binary() if hasattr(sj, "binary") else sj
                if sjb is None:
                    continue
                # live_actors counts EVERY non-dead actor of the job;
                # detached_actors is the subset a reap would spare, so
                # live - detached == what fate-sharing still owes the reaper
                live_actors[sjb] = live_actors.get(sjb, 0) + 1
                if getattr(spec, "lifetime", "non_detached") == "detached":
                    detached_actors[sjb] = detached_actors.get(sjb, 0) + 1
            jobs_blk = []
            for jid, j in self._jobs.items():
                jobs_blk.append({
                    "job_id": jid.hex() if isinstance(jid, bytes) else str(jid),
                    "status": j.get("status"),
                    "driver_address": j.get("driver_address", ""),
                    "start_time": j.get("start_time"),
                    "end_time": j.get("end_time"),
                    "death_cause": j.get("death_cause"),
                    "live_actors": live_actors.get(jid, 0),
                    "detached_actors": detached_actors.get(jid, 0),
                    "reap": j.get("reap"),
                })
            job_failure = dict(self._job_reap_stats)
            job_failure["jobs_tracked"] = len(self._jobs)
            job_failure["jobs_running"] = sum(
                1 for j in self._jobs.values()
                if j.get("status") == "RUNNING")
        return {
            "address": self._server.address,
            "session_id": self.session_id,
            "fence_epoch": self.fence_epoch,
            "fenced": self._fenced.is_set(),
            "lease_ttl_s": self._lease.ttl_s if self._lease else None,
            "nodes_alive": alive,
            "nodes_provisional": provisional,
            "snapshots": {"written": self._snapshots_written,
                          "last_version": self._snapshot_last_version,
                          "uri": self._snapshot_uri},
            "fencing_rejections": self._fencing_rejections,
            "broadcast": bcast,
            "node_failure": node_failure,
            "job_failure": job_failure,
            "jobs": jobs_blk,
            "storage": storage,
            "tracing": tracing_blk,
            "promotion": dict(self.promotion) if self.promotion else None,
        }

    # ---------------------------------------------------------------- jobs
    def rpc_register_job(self, conn, req_id, payload):
        job_id = payload["job_id"]
        with self._lock:
            self._dirty = True
            existing = self._jobs.get(job_id)
            if existing is not None:
                # re-registration: a driver reconnecting after a head
                # failover (its job may have been flipped FAILED at
                # snapshot restore) or after a conn blip. Revive it —
                # liveness comes from the driver itself, not the table.
                existing["status"] = "RUNNING"
                existing.pop("end_time", None)
                existing["driver_address"] = payload.get(
                    "driver_address", existing.get("driver_address", ""))
            else:
                self._jobs[job_id] = {
                    "job_id": job_id,
                    "driver_address": payload.get("driver_address", ""),
                    "start_time": time.time(),
                    "status": "RUNNING",
                }
            # adopt THIS conn as the driver's identity; any older conn's
            # close hook is superseded and must not reap
            self._job_conns[job_id] = id(conn)
            self._job_probe_after.pop(job_id, None)
            self._restored_unreaped.pop(job_id, None)
        conn.on_close.append(
            lambda c, jid=job_id: self._on_driver_conn_close(jid, id(c)))
        return True

    def rpc_mark_job_finished(self, conn, req_id, payload):
        with self._lock:
            j = self._jobs.get(payload["job_id"])
            if j:
                j["status"] = payload.get("status", "SUCCEEDED")
                j["end_time"] = time.time()
                self._dirty = True
                # clean exit: the later conn close finds status != RUNNING
                # and does nothing — finished jobs are NOT reaped (their
                # detached AND non-detached actors keep today's semantics)
                self._job_conns.pop(payload["job_id"], None)
        return True

    def rpc_get_jobs(self, conn, req_id, payload):
        with self._lock:
            return list(self._jobs.values())

    # ----------------------------- driver-death fate-sharing (job reap)
    def _on_driver_conn_close(self, job_id: bytes, conn_id: int) -> None:
        with self._lock:
            if self._job_conns.get(job_id) != conn_id:
                return  # superseded by a reconnect: not the live driver
            self._job_conns.pop(job_id, None)
            j = self._jobs.get(job_id)
            if j is None or j.get("status") != "RUNNING":
                return  # clean exit already marked finished
            addr = j.get("driver_address", "")
        # Conn loss is not proof of death (a blip severs the socket while
        # the driver lives and reconnects). Probe the driver's own RPC
        # server: refused -> the process is gone, reap now; accepting ->
        # arm the health-loop backstop and let re-registration cancel it.
        if self._driver_alive(addr):
            with self._lock:
                self._job_probe_after[job_id] = (
                    time.monotonic()
                    + get_config().job_reap_detection_bound_s)
            return
        # reap OFF the RPC loop: it fans out calls to every raylet
        threading.Thread(
            target=self._fail_and_reap_job,
            args=(job_id, "driver connection closed"),
            name="gcs-job-reap", daemon=True).start()

    @staticmethod
    def _driver_alive(address: str) -> bool:
        """Cheap liveness probe of the driver's worker RPC server: a bare
        TCP connect. A dead process's port refuses; a live driver's server
        accepts even while its GCS conn is severed."""
        if not address:
            return False
        host, _, port = address.rpartition(":")
        try:
            s = socket.create_connection((host, int(port)), timeout=1.0)
            s.close()
            return True
        except (OSError, ValueError):
            return False

    def _maybe_probe_dead_drivers(self, now: float) -> None:
        """Health-loop backstop: RUNNING jobs with no live driver conn
        (close hook lost with an old head, blip-severed socket) and
        snapshot-restored jobs flipped FAILED get their driver probed
        within job_reap_detection_bound_s; dead ones are reaped."""
        bound = get_config().job_reap_detection_bound_s
        due = []
        with self._lock:
            for jid, j in self._jobs.items():
                running = j.get("status") == "RUNNING"
                restored = jid in self._restored_unreaped
                if not (running or restored):
                    continue
                if running and jid in self._job_conns:
                    continue  # live conn: the close hook covers it
                after = self._job_probe_after.get(jid)
                if after is None:
                    self._job_probe_after[jid] = now + bound
                elif now >= after:
                    due.append((jid, j.get("driver_address", "")))
        for jid, addr in due:
            if self._driver_alive(addr):
                # alive but not (re-)registered yet — replay in progress
                # or a long blip; keep probing, never reap a live driver
                with self._lock:
                    self._job_probe_after[jid] = now + bound
                continue
            self._fail_and_reap_job(jid, "driver unreachable")

    def _fail_and_reap_job(self, job_id: bytes, cause: str) -> None:
        with self._lock:
            j = self._jobs.get(job_id)
            if j is None:
                return
            if j.get("status") != "RUNNING" \
                    and job_id not in self._restored_unreaped:
                return
            self._restored_unreaped.pop(job_id, None)
            self._job_probe_after.pop(job_id, None)
            self._job_conns.pop(job_id, None)
            j["status"] = "DEAD"
            j.setdefault("end_time", time.time())
            j["death_cause"] = cause
            self._dirty = True
        logger.warning("job %s driver died (%s); reaping its actors, "
                       "tasks, leases and objects", job_id.hex()[:8], cause)
        self._reap_job(job_id, cause)

    def _reap_job(self, job_id: bytes, cause: str) -> None:
        """Fate-sharing sweep for a dead job: kill its non-detached actors
        (detached ones are GCS-owned and survive), call reap_job on every
        alive raylet (queued-task purge, worker kills, lease/demand
        release, owned-object drop), and free function exports the job was
        the last owner of. Counters land in gcs_stats.job_failure and
        ray_tpu_torch_job_reaps_total."""
        pacing = get_config().job_reap_pacing_ms / 1000.0
        with self._lock:
            doomed, spared = [], 0
            for aid, spec in list(self._actor_specs.items()):
                sj = getattr(spec, "job_id", None)
                sjb = sj.binary() if hasattr(sj, "binary") else sj
                if sjb != job_id:
                    continue
                if getattr(spec, "lifetime", "non_detached") == "detached":
                    spared += 1
                    continue
                info = self._actors.get(aid)
                if info is None or info.state == ActorState.DEAD:
                    continue
                doomed.append(aid)
            node_ids = [nid for nid, n in self._nodes.items()
                        if n.get("alive")]
        for aid in doomed:
            self._kill_actor_for_reap(aid, cause)
            if pacing:
                time.sleep(pacing)
        totals = {"queued_cancelled": 0, "workers_killed": 0,
                  "objects_dropped": 0, "bytes_dropped": 0}
        for nid in node_ids:
            client = self._raylet_client(nid)
            if client is None:
                continue
            try:
                r = client.call("reap_job", {"job_id": job_id}, timeout=10)
            except (OSError, TimeoutError, rpc.RpcCallError,
                    rpc.RpcDisconnected) as e:
                logger.info("reap_job on raylet %s failed: %s",
                            nid.hex()[:8], e)
                continue
            for k in totals:
                totals[k] += (r or {}).get(k, 0)
            if pacing:
                time.sleep(pacing)
        freed = 0
        with self._lock:
            # exports still referenced by a SURVIVING actor's creation spec
            # (a spared detached actor, another job's actor) must outlive
            # the job: a later restart resolves its class through them
            keep_fids = set()
            for aid, spec in self._actor_specs.items():
                info = self._actors.get(aid)
                if info is None or info.state == ActorState.DEAD:
                    continue
                fid = getattr(spec, "class_fn_id", None)
                if fid is not None:
                    keep_fids.add(fid)
            for fid, jobs in list(self._function_jobs.items()):
                jobs.discard(job_id)
                if jobs or fid in keep_fids:
                    continue
                self._function_jobs.pop(fid, None)
                blob = self._functions.pop(fid, None)
                if blob is not None:
                    self._function_bytes -= len(blob)
                    freed += 1
                    self._dirty = True
            st = self._job_reap_stats
            st["jobs_reaped"] += 1
            st["actors_killed"] += len(doomed)
            st["detached_spared"] += spared
            st["functions_freed"] += freed
            for k, v in totals.items():
                st[k] += v
            j = self._jobs.get(job_id)
            if j is not None:
                j["reap"] = {"actors_killed": len(doomed),
                             "detached_spared": spared,
                             "functions_freed": freed, **totals}
                self._dirty = True
        try:
            _job_metrics()["reaps"].inc()
        except Exception:
            pass
        logger.warning(
            "job %s reaped: %d actors killed (%d detached spared), %d "
            "queued tasks cancelled, %d workers killed, %d objects "
            "(%d bytes) dropped, %d function exports freed",
            job_id.hex()[:8], len(doomed), spared,
            totals["queued_cancelled"], totals["workers_killed"],
            totals["objects_dropped"], totals["bytes_dropped"], freed)

    def _kill_actor_for_reap(self, actor_id: ActorID, cause: str) -> None:
        """rpc_kill_actor's no-restart path, with an owner-died death
        cause: exhaust the budget, notify the hosting raylet, publish
        DEAD so in-flight callers fail typed instead of hanging."""
        death_cause = f"owner job died: {cause}"
        with self._lock:
            info = self._actors.get(actor_id)
            if info is None or info.state == ActorState.DEAD:
                return
            info.max_restarts = info.num_restarts  # exhaust budget
            info.state = ActorState.DEAD
            info.death_cause = death_cause
            node_id = info.node_id
            info.address = ""
            self._awaiting_rereg.pop(actor_id, None)
            self._dirty = True
            client = self._raylet_clients.get(node_id) if node_id else None
        if client is not None:
            try:
                client.notify("kill_actor_worker", {"actor_id": actor_id})
            except OSError as e:
                logger.debug("reap kill_actor notify to dead raylet: %s", e)
        self._publish(CH_ACTORS, {"actor_id": actor_id, "state": "DEAD",
                                  "address": "",
                                  "death_cause": death_cause})

    # ------------------------------------------------------------ task events
    def _ingest_task_event(self, payload) -> None:
        """Caller holds self._lock. One task lifecycle record into the ring."""
        key = payload["task_id"]
        e = self._task_events.get(key)
        if e is None:
            if len(self._task_events_order) >= self._max_task_events:
                old = self._task_events_order.pop(0)
                self._task_events.pop(old, None)
                # surfaced by list_task_events so `ray_tpu_torch list tasks`
                # can SAY history was truncated instead of silently
                # showing a complete-looking window
                self._task_events_dropped += 1
            e = {"task_id": key}
            self._task_events[key] = e
            self._task_events_order.append(key)
        state = payload.get("state")
        # Count each task's SUBMITTED once per live entry. Batched buffers
        # mean a worker's RUNNING can now land before the driver's
        # SUBMITTED, so the count keys on a per-entry flag rather than on
        # entry creation; a terminal event recreating an evicted entry
        # (>10k tasks in flight) still can't inflate the running total, or
        # the derived pending count (submitted - finished - failed) would
        # drift upward forever.
        if state == "SUBMITTED" and not e.get("_counted_submitted"):
            e["_counted_submitted"] = True
            self._task_counts["submitted"] += 1
        if e.get("_terminal") and state not in ("FINISHED", "FAILED"):
            # A non-terminal event arriving AFTER the terminal one (e.g.
            # the driver's buffered SUBMITTED flushing behind the worker's
            # FINISHED) is recorded in the history but must not regress the
            # displayed state — no further event would ever repair it.
            e.setdefault("events", []).append((state or "?", time.time()))
            return
        e.update({k: v for k, v in payload.items() if k != "task_id"})
        e.setdefault("events", []).append((state or "?", time.time()))
        # running totals survive the event-window eviction above (the
        # dashboard's _total series must not saturate at the window)
        if state in ("FINISHED", "FAILED") and not e.get("_terminal"):
            e["_terminal"] = True
            self._task_counts[state.lower()] += 1

    def rpc_task_event(self, conn, req_id, payload):
        """Best-effort single task lifecycle record (legacy per-event wire
        format; in-tree emitters batch via task_events_batch)."""
        with self._lock:
            self._ingest_task_event(payload)
        return True

    def rpc_task_events_batch(self, conn, req_id, payload):
        """One worker-side TaskEventBuffer flush (reference
        TaskEventBuffer -> GcsTaskManager): a batch of task-state
        transitions, the emitter's dropped-event count, and any tracing
        spans recorded since its last flush — one notify per interval per
        process instead of one per transition."""
        with self._lock:
            for ev in payload.get("events", ()):
                self._ingest_task_event(ev)
            # events the WORKER dropped (its bounded buffer overflowed) are
            # history lost forever, same class as our ring eviction
            self._task_events_dropped += int(payload.get("dropped", 0))
            # spans the worker's tracing ring dropped: same honesty
            # contract for the timeline (surfaced in gcs_stats)
            self._spans_dropped += int(payload.get("spans_dropped", 0))
            src = payload.get("src")
            offset = payload.get("clock_offset_us")
            if src and offset is not None:
                self._span_clock_offsets[src] = float(offset)
            profile = payload.get("profile_events")
            if profile:
                self._append_profile_events(profile)
        return True

    def rpc_list_task_events(self, conn, req_id, payload):
        limit = (payload or {}).get("limit", 1000)
        if limit <= 0:
            return []
        with self._lock:
            keys = self._task_events_order[-limit:]
            # underscore keys (_terminal, _counted_submitted) are GCS
            # bookkeeping, not part of the listing surface
            out = [{f: v for f, v in self._task_events[k].items()
                    if not f.startswith("_")} for k in keys]
            dropped = self._task_events_dropped
        if dropped:
            # sideband metadata row: EVICTED history is gone forever —
            # distinct from limit windowing, where a larger limit still
            # reaches the older retained entries. The row counts against
            # the limit so consumers never receive more than they asked.
            if len(out) >= limit:
                out = out[1:]
            out.append({"__truncated__": dropped})
        return out

    # stages of the per-task critical path (span categories); each keeps a
    # bounded latency window for the p50/p99 roll-up in gcs_stats
    _TRACE_STAGES = ("task_submit", "task_lease", "task_dispatch",
                     "task_execution", "task_result")
    _STAGE_WINDOW = 10_000

    def _append_profile_events(self, events) -> None:
        """Caller holds self._lock. Capped ring so the GCS can't grow
        unboundedly. Spans carrying a trace_id additionally index into the
        per-trace ring (whole-trace eviction, oldest first) and feed the
        per-stage latency windows."""
        self._profile_events.extend(events)
        if len(self._profile_events) > 100_000:
            self._profile_events = self._profile_events[-100_000:]
        max_traces = max(1, get_config().tracing_max_traces)
        for e in events:
            tid = e.get("trace_id")
            if tid:
                spans = self._traces.get(tid)
                if spans is None:
                    while len(self._traces) >= max_traces:
                        self._traces.popitem(last=False)
                        self._traces_evicted += 1
                    spans = self._traces[tid] = []
                spans.append(e)
            cat = e.get("cat")
            if cat in self._TRACE_STAGES and "dur" in e:
                window = self._stage_lat_us.setdefault(cat, [])
                window.append(float(e["dur"]))
                if len(window) > self._STAGE_WINDOW:
                    del window[:len(window) - self._STAGE_WINDOW]

    def rpc_profile_events(self, conn, req_id, payload):
        """Chrome-trace spans shipped by workers (reference ProfileEvent
        buffer; legacy per-flush wire format — in-tree emitters batch via
        task_events_batch)."""
        with self._lock:
            self._append_profile_events(payload.get("events", []))
        return True

    def rpc_get_profile_events(self, conn, req_id, payload):
        with self._lock:
            return list(self._profile_events)

    # ------------------------------------------------------------- tracing
    def rpc_clock_probe(self, conn, req_id, payload):
        """Server-side wall stamp for NTP-style offset estimation: the
        caller brackets this call with local stamps t0/t2 and computes
        offset = t1 - (t0 + t2) / 2 (task_events.py). The GCS clock is the
        fleet's reference frame for merged timelines."""
        return {"t1_us": time.time() * 1e6}

    def rpc_get_span_offsets(self, conn, req_id, payload):
        """Per-source clock offsets (src hex -> offset_us vs this GCS),
        applied at merge time to align spans from different nodes."""
        with self._lock:
            return dict(self._span_clock_offsets)

    def rpc_get_trace(self, conn, req_id, payload):
        """Spans of one causal tree, by trace_id or by task_id (any span
        whose trace contains the task). Returns spans + the offsets needed
        to align them."""
        payload = payload or {}
        trace_id = payload.get("trace_id")
        task_id = payload.get("task_id")
        with self._lock:
            spans: List[dict] = []
            if trace_id:
                spans = list(self._traces.get(trace_id, ()))
            elif task_id:
                for tid, tspans in self._traces.items():
                    if any((s.get("args") or {}).get("task_id") == task_id
                           for s in tspans):
                        trace_id = tid
                        spans = list(tspans)
                        break
            return {"trace_id": trace_id, "spans": spans,
                    "offsets": dict(self._span_clock_offsets)}

    def rpc_list_traces(self, conn, req_id, payload):
        """Newest-first trace summaries for `ray_tpu_torch timeline --trace`
        discovery."""
        limit = (payload or {}).get("limit", 50)
        with self._lock:
            items = list(self._traces.items())[-limit:]
        out = []
        for tid, spans in reversed(items):
            ts = [s.get("ts", 0) for s in spans]
            out.append({"trace_id": tid, "spans": len(spans),
                        "first_ts_us": min(ts) if ts else 0,
                        "last_ts_us": max(ts) if ts else 0})
        return out

    def rpc_task_counts(self, conn, req_id, payload):
        """Cumulative task totals (unwindowed, unlike list_task_events)."""
        with self._lock:
            c = dict(self._task_counts)
        c["pending"] = max(0, c["submitted"] - c["finished"] - c["failed"])
        return c

    # ---------------------------------------------------------------- actors
    def rpc_register_actor(self, conn, req_id, payload):
        """Register + schedule an actor (cf. gcs_actor_manager.cc:246,271)."""
        spec: ActorCreationSpec = payload["spec"]
        owner_address: str = payload.get("owner_address", "")
        with self._lock:
            # Idempotent: a retried register (reconnecting client re-sending
            # after the reply was lost in a GCS crash) must not schedule a
            # second worker for the same actor id.
            existing_info = self._actors.get(spec.actor_id)
            if existing_info is not None and existing_info.state != ActorState.DEAD:
                return {"ok": True}
            if spec.name:
                key = (spec.namespace, spec.name)
                if key in self._named_actors:
                    existing = self._named_actors[key]
                    if self._actors[existing].state != ActorState.DEAD:
                        return {"error": f"actor name '{spec.name}' already taken"}
                self._named_actors[key] = spec.actor_id
            info = ActorInfo(
                actor_id=spec.actor_id,
                name=spec.name,
                namespace=spec.namespace,
                state=ActorState.PENDING,
                max_restarts=spec.max_restarts,
                class_name=payload.get("class_name", ""),
            )
            self._actors[spec.actor_id] = info
            self._actor_specs[spec.actor_id] = spec
            self._actor_owners[spec.actor_id] = owner_address
            self._dirty = True
        ok = self._schedule_actor(spec.actor_id)
        if not ok:
            err = (f"no feasible node for actor resources {spec.resources} "
                   f"(cluster: {self.cluster_view()})")
            with self._lock:
                info = self._actors[spec.actor_id]
                info.state = ActorState.DEAD
                info.death_cause = err
            self._publish(CH_ACTORS, {"actor_id": spec.actor_id, "state": "DEAD",
                                      "address": "", "death_cause": err})
            return {"error": err}
        return {"ok": True}

    def _schedule_actor(self, actor_id: ActorID,
                        require_available: bool = False) -> bool:
        """Pick a node for the actor and ask its raylet to create it
        (cf. GcsActorScheduler::Schedule, gcs_actor_scheduler.cc:49).

        `require_available=True` (the RESTART path) only accepts nodes that
        can hold the actor's demand NOW: a restart after node death must
        land on a surviving node with capacity or WAIT for the autoscaler's
        replacement (pending-restart retry) — queuing it on a full survivor
        would strand it behind capacity that may never free."""
        with self._lock:
            spec = self._actor_specs.get(actor_id)
            if spec is None:
                # Snapshot-restored actor whose spec didn't survive and whose
                # worker never re-registered: nothing to schedule from.
                return False
            views = [
                NodeView(nid, n["resources_total"], n["resources_available"], n["labels"])
                for nid, n in self._nodes.items()
                if n["alive"] and not n.get("quarantined")
            ]
        if require_available and spec.scheduling.placement_group_id is None:
            views = [v for v in views if v.is_available(spec.resources)]
        target = self._policy.select_node(views, spec.resources, spec.scheduling, prefer_node=None,
                                          pg_table=self._pgs)
        if target is None:
            return False
        if require_available:
            # PG-routed restarts come back as the bundle's node: reject a
            # dead one (its bundle is awaiting reschedule) instead of
            # dispatching into the void
            with self._lock:
                n = self._nodes.get(target)
                if n is None or not n.get("alive"):
                    return False
        with self._lock:
            info = self._actors[actor_id]
            info.node_id = target
            # the actor's restart count IS its incarnation: the hosting
            # worker learns it here and stamps every reply with it, and
            # handles refuse to let a superseded instance service a call —
            # exactly-one-live-instance across a partition heal
            spec.incarnation = info.num_restarts
            # optimistic charge of the head's resource view: without it a
            # burst of creations all reads the same stale availability and
            # piles onto one node (the raylet's charge only flows back on
            # its next debounced report). The raylet's reports overwrite
            # the view wholesale, so this converges to truth either way.
            if spec.scheduling.placement_group_id is None:
                n = self._nodes.get(target)
                if n is not None:
                    avail = n["resources_available"]
                    for r, q in spec.resources.items():
                        avail[r] = avail.get(r, 0.0) - q
                    self._bcast_dirty.add(target.hex())
        client = self._raylet_client(target)
        if client is None:
            return False
        try:
            client.notify("create_actor", {"spec": spec})
        except Exception:
            logger.exception("failed to dispatch actor creation to %s", target.hex()[:8])
            return False
        self._note_first_schedule()
        return True

    def rpc_actor_creation_done(self, conn, req_id, payload):
        actor_id = payload["actor_id"]
        with self._lock:
            info = self._actors.get(actor_id)
            if info is not None and payload.get("success", True):
                done_inc = payload.get("incarnation")
                if done_inc is not None and done_inc < info.num_restarts:
                    # a SUPERSEDED dispatch completing late (the node it
                    # went to was partitioned/declared dead and the actor
                    # was restarted elsewhere): marking ALIVE at its
                    # address would resurrect the zombie instance — reject
                    # and kill the stale worker instead
                    stale_node = payload.get("node_id")
                    kill_client = self._raylet_clients.get(stale_node) \
                        if stale_node else None
                    logger.warning(
                        "rejecting stale actor_creation_done for %s "
                        "(incarnation %s < current %s)", actor_id,
                        done_inc, info.num_restarts)
                else:
                    kill_client = "accept"
            else:
                kill_client = "accept"
        if kill_client != "accept":
            self._count_stale("actor_creation_done")
            if kill_client is not None:
                try:
                    kill_client.notify("kill_actor_worker",
                                       {"actor_id": actor_id})
                except OSError:
                    pass
            return False
        with self._lock:
            info = self._actors.get(actor_id)
            if info is None:
                spec: Optional[ActorCreationSpec] = payload.get("spec")
                if spec is None or not payload.get("success", True):
                    return False
                # The GCS restarted between dispatching this creation and its
                # completion: rebuild the record from the worker's spec so
                # the actor still becomes ALIVE.
                info = ActorInfo(
                    actor_id=actor_id, name=spec.name,
                    namespace=spec.namespace, state=ActorState.PENDING,
                    max_restarts=spec.max_restarts, class_name="")
                self._actors[actor_id] = info
                self._actor_specs[actor_id] = spec
                if spec.name:
                    self._named_actors[(spec.namespace, spec.name)] = actor_id
            if payload.get("success", True):
                n = self._nodes.get(payload["node_id"])
                if n is not None and not n.get("alive", True):
                    # success racing the node's death (the creation landed,
                    # then the node was killed): the address is a corpse —
                    # keep the actor RESTARTING and let the paced retry
                    # place it on live capacity instead. An UNKNOWN node
                    # stays on the ALIVE path: after a GCS restart the
                    # done can beat the node's re-registration, and
                    # re-parking then would double-create the actor.
                    info.state = ActorState.RESTARTING
                    info.address = ""
                    info.node_id = payload["node_id"]
                    self._pending_restarts[actor_id] = 0.0
                    self._pending_restart_since.setdefault(
                        actor_id, time.monotonic())
                    self._dirty = True
                    logger.warning("actor %s creation reported from dead "
                                   "node %s; re-parking for retry",
                                   actor_id, payload["node_id"].hex()[:8])
                else:
                    info.state = ActorState.ALIVE
                    info.address = payload["address"]
                    info.node_id = payload["node_id"]
                    self._pending_restarts.pop(actor_id, None)
                    self._pending_restart_since.pop(actor_id, None)
            else:
                info.state = ActorState.DEAD
                info.death_cause = payload.get("error", "creation failed")
            self._dirty = True
        self._publish(CH_ACTORS, {"actor_id": actor_id, "state": info.state.value,
                                  "address": info.address, "death_cause": info.death_cause,
                                  "incarnation": info.num_restarts})
        return True

    def rpc_reregister_actor(self, conn, req_id, payload):
        """A live actor worker re-announces itself after a GCS restart
        (reference: GCS rebuilds the actor table from Redis +
        resubscription; here the worker IS the source of truth). Restores
        the ALIVE record, the creation spec (so restart-on-failure still
        works) and the named-actor binding. Incarnation-fenced: a zombie
        instance (its actor was restarted elsewhere while its node was
        partitioned) re-announcing a SUPERSEDED incarnation is rejected
        with a typed fence reply — the worker exits instead of taking the
        record back from the live instance."""
        actor_id: ActorID = payload["actor_id"]
        spec: Optional[ActorCreationSpec] = payload.get("spec")
        offered = payload.get("incarnation")
        with self._lock:
            info = self._actors.get(actor_id)
            stale = (info is not None and offered is not None
                     and (offered < info.num_restarts
                          or (info.state == ActorState.ALIVE
                              and offered == info.num_restarts
                              and info.address
                              and info.address != payload["address"])))
        if stale:
            self._count_stale("reregister_actor")
            logger.warning(
                "rejecting reregister of actor %s from %s: incarnation %s "
                "superseded (current %s at %s)", actor_id,
                payload["address"], offered, info.num_restarts, info.address)
            return {"fenced": True,
                    "reason": "actor incarnation superseded"}
        with self._lock:
            info = self._actors.get(actor_id)
            if info is None:
                # No snapshot record: rebuild identity from the spec. The
                # restart budget (num_restarts) is preserved whenever the
                # snapshot had it — a GCS restart must not reset it.
                info = ActorInfo(
                    actor_id=actor_id,
                    name=spec.name if spec else None,
                    namespace=spec.namespace if spec else "",
                    state=ActorState.ALIVE,
                    max_restarts=spec.max_restarts if spec else 0,
                )
                self._actors[actor_id] = info
            info.state = ActorState.ALIVE
            info.address = payload["address"]
            info.node_id = payload.get("node_id")
            self._awaiting_rereg.pop(actor_id, None)
            self._pending_restarts.pop(actor_id, None)
            self._pending_restart_since.pop(actor_id, None)
            if spec is not None:
                self._actor_specs[actor_id] = spec
                if spec.name:
                    self._named_actors[(spec.namespace, spec.name)] = actor_id
            self._dirty = True
        self._publish(CH_ACTORS, {"actor_id": actor_id, "state": "ALIVE",
                                  "address": payload["address"],
                                  "death_cause": "",
                                  "incarnation": info.num_restarts})
        return True

    def rpc_actor_failed(self, conn, req_id, payload):
        """Worker-death report from a raylet. Node-scoped: a report from a
        node that no longer HOSTS the actor (a fenced zombie killing its
        superseded workers, a late report racing a restart) must not charge
        the budget or restart the live instance."""
        actor_id = payload["actor_id"]
        reporter = payload.get("node_id")
        if reporter is not None:
            with self._lock:
                info = self._actors.get(actor_id)
                mismatch = (info is not None and info.node_id is not None
                            and info.node_id != reporter)
            if mismatch:
                self._count_stale("actor_failed")
                logger.info(
                    "ignoring actor_failed for %s from node %s: actor is "
                    "hosted on %s", actor_id, reporter.hex()[:8],
                    info.node_id.hex()[:8])
                return False
        self._handle_actor_failure(actor_id, payload.get("reason", "worker died"))
        return True

    def _handle_actor_failure(self, actor_id: ActorID, reason: str) -> None:
        """Restart budget logic (cf. gcs_actor_manager.cc:1149 reschedule)."""
        with self._lock:
            info = self._actors.get(actor_id)
            if info is None or info.state == ActorState.DEAD:
                return
            can_restart = info.max_restarts == -1 or info.num_restarts < info.max_restarts
            if can_restart:
                info.num_restarts += 1
                info.state = ActorState.RESTARTING
                info.address = ""
            else:
                info.state = ActorState.DEAD
                info.death_cause = reason
            self._dirty = True
        if info.state == ActorState.RESTARTING:
            self._publish(CH_ACTORS, {"actor_id": actor_id, "state": info.state.value,
                                      "address": "", "death_cause": ""})
            if not self._schedule_actor(actor_id, require_available=True):
                # No capacity RIGHT NOW (the actor's node just died and its
                # replacement hasn't joined): keep it RESTARTING and let the
                # paced health-loop retry land it on a surviving or
                # replacement node — killing it here would turn every
                # transient capacity dip into a permanent actor loss.
                with self._lock:
                    if info.state == ActorState.RESTARTING:
                        self._pending_restarts[actor_id] = time.monotonic() \
                            + self._RESTART_RETRY_INTERVAL_S
                        self._pending_restart_since.setdefault(
                            actor_id, time.monotonic())
                logger.info("actor %s restart has no feasible capacity yet; "
                            "queued for paced retry", actor_id)
        else:
            self._publish(CH_ACTORS, {"actor_id": actor_id, "state": info.state.value,
                                      "address": "", "death_cause": info.death_cause})

    def rpc_get_actor_info(self, conn, req_id, payload):
        with self._lock:
            if "name" in payload:
                aid = self._named_actors.get((payload.get("namespace", ""), payload["name"]))
                if aid is None:
                    return None
            else:
                aid = payload["actor_id"]
            info = self._actors.get(aid)
            if info is None:
                return None
            return {
                "actor_id": info.actor_id,
                "name": info.name,
                "state": info.state.value,
                "address": info.address,
                "node_id": info.node_id,
                "num_restarts": info.num_restarts,
                # the restart count doubles as the live incarnation: handles
                # pin calls to it so a superseded instance can never serve
                "incarnation": info.num_restarts,
                "death_cause": info.death_cause,
                "class_name": info.class_name,
            }

    def rpc_list_actors(self, conn, req_id, payload):
        with self._lock:
            return [
                {"actor_id": a.actor_id, "name": a.name, "state": a.state.value,
                 "address": a.address, "class_name": a.class_name,
                 "num_restarts": a.num_restarts}
                for a in self._actors.values()
            ]

    def rpc_kill_actor(self, conn, req_id, payload):
        actor_id = payload["actor_id"]
        no_restart = payload.get("no_restart", True)
        with self._lock:
            info = self._actors.get(actor_id)
            if info is None:
                return False
            node_id = info.node_id
            client = self._raylet_clients.get(node_id) if node_id else None
            if no_restart:
                info.max_restarts = info.num_restarts  # exhaust budget
                info.state = ActorState.DEAD
                info.death_cause = "killed via ray.kill()"
                info.address = ""
        if client is not None:
            try:
                client.notify("kill_actor_worker", {"actor_id": actor_id})
            except OSError as e:
                # the raylet hosting the actor is gone — the kill outcome
                # it was asked for has already happened
                logger.debug("kill_actor notify to dead raylet: %s", e)
        if no_restart:
            self._publish(CH_ACTORS, {"actor_id": actor_id, "state": "DEAD",
                                      "address": "", "death_cause": "killed via ray.kill()"})
        else:
            self._handle_actor_failure(actor_id, "killed via ray.kill(no_restart=False)")
        return True

    # ------------------------------------------------------------ placement
    def rpc_create_placement_group(self, conn, req_id, payload):
        """2-phase bundle reservation (cf. gcs_placement_group_scheduler.h),
        run OFF the RPC loop (prepare calls block) and replied via
        Deferred. Idempotent per pg_id: a client whose create call died
        with the old head re-sends it to the replacement, which either
        finds the PG already CREATED (snapshot/resume) or re-runs the
        protocol — raylet-side prepare_bundle is idempotent, so a bundle
        the old head already reserved is not double-charged."""
        threading.Thread(
            target=self._create_pg_and_reply,
            args=(conn, req_id, payload), name="gcs-pg-create",
            daemon=True).start()
        return rpc.RpcServer.DEFERRED

    def _create_pg_and_reply(self, conn, req_id, payload) -> None:
        try:
            result = self._create_placement_group(
                payload["pg_id"], payload["bundles"], payload["strategy"],
                payload.get("name"))
        except Exception as e:
            logger.exception("placement group creation failed")
            result = f"placement group creation failed: {e}"
            try:
                conn.reply(req_id, result, is_error=True)
            except (OSError, RuntimeError):
                pass  # head shutting down mid-creation; client will retry
            return
        try:
            conn.reply(req_id, result)
        except (OSError, RuntimeError):
            pass  # head shutting down mid-creation; client will retry

    def _create_placement_group(self, pg_id: PlacementGroupID,
                                bundles: List[Dict[str, float]],
                                strategy: str, name) -> dict:
        with self._pg_2pc_lock:
            with self._lock:
                existing = self._pgs.get(pg_id)
                if existing is not None and existing.get("state") == "CREATED":
                    return {"ok": True, "placement": existing["placement"]}
                # PREPARING is durable: if this head dies mid-protocol, its
                # replacement sees the marker and resumes or fails the PG
                # instead of leaving clients polling forever.
                self._pgs[pg_id] = {
                    "state": "PREPARING", "bundles": bundles,
                    "strategy": strategy, "name": name, "placement": None}
                self._dirty = True
                views = [
                    NodeView(nid, n["resources_total"], n["resources_available"], n["labels"])
                    for nid, n in self._nodes.items()
                    if n["alive"] and not n.get("quarantined")
                ]
            placement = self._policy.place_bundles(views, bundles, strategy)
            if placement is None:
                with self._lock:
                    self._pgs[pg_id].update(state="PENDING", placement=None)
                    self._dirty = True
                return {"ok": False, "error": "infeasible"}
            # Phase 1: prepare on each raylet; rollback on any failure.
            prepared = []
            ok = True
            for idx, node_id in enumerate(placement):
                client = self._raylet_client(node_id)
                if client is None:
                    ok = False
                    break
                try:
                    r = client.call("prepare_bundle", {
                        "pg_id": pg_id, "bundle_index": idx, "resources": bundles[idx]}, timeout=10)
                except (OSError, TimeoutError, rpc.RpcCallError,
                        rpc.RpcDisconnected) as e:
                    logger.info("prepare_bundle on %s failed: %s",
                                node_id.hex()[:8], e)
                    r = False
                if not r:
                    ok = False
                    break
                prepared.append((idx, node_id))
            if not ok:
                for idx, node_id in prepared:
                    c = self._raylet_client(node_id)
                    if c:
                        try:
                            c.notify("return_bundle", {"pg_id": pg_id, "bundle_index": idx})
                        except OSError as e:
                            logger.debug("return_bundle to dead raylet: %s", e)
                # PENDING is retryable: the paced health-loop retry re-runs
                # the 2PC, so a transient prepare failure (link blip, node
                # mid-death) heals instead of stranding the group
                with self._lock:
                    self._pgs[pg_id].update(state="PENDING", placement=None)
                    self._dirty = True
                return {"ok": False, "error": "prepare failed"}
            # Phase 2: commit. Tolerant per node: a raylet dying between
            # prepare and commit must not blow up the whole creation — its
            # uncommitted reservation returns via the 2PC orphan reaper and
            # the node-death path fails over whatever ran there.
            for idx, node_id in prepared:
                client = self._raylet_client(node_id)
                try:
                    if client is None:
                        raise OSError("raylet client gone")
                    client.notify("commit_bundle",
                                  {"pg_id": pg_id, "bundle_index": idx})
                except OSError as e:
                    logger.warning(
                        "commit_bundle (%s, %d) to %s lost: %s", pg_id, idx,
                        node_id.hex()[:8], e)
            with self._lock:
                self._pgs[pg_id] = {
                    "state": "CREATED", "bundles": bundles, "strategy": strategy,
                    "name": name, "placement": placement,
                }
                self._dirty = True
            return {"ok": True, "placement": placement}

    def rpc_get_placement_group(self, conn, req_id, payload):
        with self._lock:
            pg = self._pgs.get(payload["pg_id"])
            if pg is None and "name" in payload:
                for pid, p in self._pgs.items():
                    if p.get("name") == payload["name"]:
                        pg = dict(p); pg["pg_id"] = pid
                        break
            return pg

    def rpc_remove_placement_group(self, conn, req_id, payload):
        pg_id = payload["pg_id"]
        with self._lock:
            pg = self._pgs.pop(pg_id, None)
            self._dirty = self._dirty or pg is not None
        if pg and pg.get("placement"):
            for idx, node_id in enumerate(pg["placement"]):
                c = self._raylet_clients.get(node_id)
                if c:
                    try:
                        c.notify("return_bundle", {"pg_id": pg_id, "bundle_index": idx})
                    except OSError as e:
                        logger.debug("return_bundle to dead raylet: %s", e)
        return pg is not None

    def rpc_list_placement_groups(self, conn, req_id, payload):
        with self._lock:
            return [
                {"pg_id": pid, "state": p["state"], "strategy": p["strategy"],
                 "bundles": p["bundles"], "name": p.get("name"),
                 "placement": p.get("placement")}
                for pid, p in self._pgs.items()
            ]


class StandbyHead:
    """Warm standby GCS (ROADMAP item 5; Ray 2.x GCS fault-tolerance
    design): tails the `VersionedSnapshots` stream so its in-memory copy of
    the control-plane state is always ≤1 snapshot behind, watches the head
    lease, and when the lease EXPIRES (crash) or is RELINQUISHED (rolling
    upgrade, `GcsServer.drain_lease`) takes over via the lease-epoch CAS:

        acquire(expect_epoch=<the epoch we saw expire>) -> epoch+1

    Promotion then boots a `GcsServer` pre-seeded with the tailed payload
    (restore = one deserialize, no store walk) whose readopt pass dials the
    snapshot-known raylets with `promote_announce` — same-session raylets
    re-adopt in that one RPC, giving sub-second failover. The OLD head, if
    it revives, is fenced: its epoch trails the store's, so its snapshot
    saves raise and its announces are dropped.

    Run standalone with `ray_tpu_torch start --standby --snapshot-uri ...`.
    """

    def __init__(self, snapshot_uri: str, host: str = "127.0.0.1",
                 port: int = 0):
        from ray_tpu_torch.core.head_lease import HeadLease, new_owner_token
        from ray_tpu_torch.core.snapshot_store import (VersionedSnapshots,
                                                 store_from_uri)

        self._uri = snapshot_uri
        self._host = host
        self._port = port
        store = store_from_uri(snapshot_uri)
        self._snaps = VersionedSnapshots(
            store, prefix="gcs", keep=get_config().gcs_snapshot_keep)
        self._lease = HeadLease(store)
        self._owner = new_owner_token()
        self._tailed: Optional[bytes] = None
        self._tailed_version = 0
        self._tailed_epoch = 0  # fence_epoch persisted in the tailed payload
        self._seen_epoch = 0
        self._stop_evt = threading.Event()
        self._promoted_evt = threading.Event()
        self._promoted: Optional[GcsServer] = None
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------- lifecycle
    def start(self) -> "StandbyHead":
        self._thread = threading.Thread(target=self._run, name="gcs-standby",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop tailing. Does NOT stop a promoted GcsServer — once promoted
        it is the cluster's head and owns its own lifecycle."""
        self._stop_evt.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    @property
    def promoted(self) -> Optional[GcsServer]:
        return self._promoted

    def wait_promoted(self, timeout: Optional[float] = None
                      ) -> Optional[GcsServer]:
        self._promoted_evt.wait(timeout)
        return self._promoted

    def stats(self) -> dict:
        return {"tailed_version": self._tailed_version,
                "seen_epoch": self._seen_epoch,
                "promoted": self._promoted is not None,
                "snapshot_uri": self._uri}

    # ------------------------------------------------------------- tail loop
    def _run(self) -> None:
        from ray_tpu_torch.core.head_lease import LeaseHeldError, LeaseLostError

        cfg = get_config()
        poll = cfg.head_standby_poll_s or max(
            0.05, cfg.head_lease_ttl_s / 4.0)
        while not self._stop_evt.wait(poll):
            try:
                self._tail_once()
            except Exception:
                logger.exception("standby snapshot tail failed")
            try:
                rec = self._lease.read()
            except Exception:
                logger.exception("standby lease read failed")
                continue
            if rec is None:
                # no head has ever claimed the lease; without a snapshot
                # there is nothing to take over — stay standby
                continue
            self._seen_epoch = max(self._seen_epoch, int(rec.get("epoch", 0)))
            if rec.get("expires_at", 0.0) > time.time():
                continue
            # expired/relinquished: claim it. expect_epoch pins the CAS to
            # the epoch we SAW expire — a head that renewed (or another
            # standby that won) in the window refuses us — and the floor
            # (highest epoch seen on the lease OR in the snapshot stream)
            # stops a torn lease record from resetting the epoch under the
            # fleet.
            try:
                epoch = self._lease.acquire(
                    self._owner, expect_epoch=rec["epoch"],
                    floor=max(self._seen_epoch, self._tailed_epoch) + 1)
            except (LeaseHeldError, LeaseLostError) as e:
                logger.info("standby promotion attempt refused: %s", e)
                continue
            try:
                self._promote(epoch, old_lease=rec)
                return
            except Exception:
                # a failed boot (port taken, store error) with the epoch
                # already claimed would otherwise leave the cluster
                # HEADLESS: hand the lease back (expire-now at our epoch)
                # so another standby — or this loop's next pass — can claim
                # epoch+1, and keep tailing.
                logger.exception("promotion to epoch %d failed; "
                                 "relinquishing the lease and retrying",
                                 epoch)
                try:
                    self._lease.relinquish(self._owner, epoch)
                except Exception:
                    logger.exception("post-failure lease relinquish failed")
                self._seen_epoch = max(self._seen_epoch, epoch)

    def _tail_once(self) -> None:
        newest = self._snaps.latest_version()
        if newest <= self._tailed_version:
            return
        payload, version = self._snaps.load_latest_with_version()
        if payload is not None:
            self._tailed = payload
            self._tailed_version = version
            try:
                import pickle

                self._tailed_epoch = int(
                    pickle.loads(payload).get("fence_epoch", 0))
            except Exception:
                logger.debug("tailed snapshot carries no readable "
                             "fence_epoch", exc_info=True)

    def _promote(self, epoch: int, old_lease: dict) -> None:
        lease_expired_at = old_lease.get("expires_at")
        logger.warning("standby promoting to active head: epoch %d "
                       "(tailed snapshot v%d)", epoch, self._tailed_version)
        # one last tail: the dead head's final flush may have landed after
        # our previous poll
        try:
            self._tail_once()
        except Exception:
            logger.exception("pre-promotion tail failed; promoting from v%d",
                             self._tailed_version)
        gcs = GcsServer(
            host=self._host, port=self._port, snapshot_uri=self._uri,
            preloaded_snapshot=self._tailed,
            lease_grant={"owner": self._owner, "epoch": epoch,
                         "lease_expired_at": lease_expired_at,
                         "tailed_version": self._tailed_version})
        gcs.start()
        try:
            _head_metrics()["failovers"].inc()
        except Exception:
            pass
        self._fence_predecessor(old_lease, gcs)
        self._promoted = gcs
        self._promoted_evt.set()

    def _fence_predecessor(self, old_lease: dict, gcs: GcsServer) -> None:
        """Best-effort direct fence of a still-RUNNING predecessor (lease
        starved, process alive): dial the address its lease record carried
        and tell it the epoch moved on. Without this it self-fences on its
        next lease read anyway — this just collapses the stale-serving
        window to one RPC."""
        address = old_lease.get("address")
        if not address or address == gcs.address:
            return

        def run():
            try:
                client = rpc.connect_with_retry(address, timeout=2)
                try:
                    client.call("head_fenced",
                                {"epoch": gcs.fence_epoch,
                                 "address": gcs.address}, timeout=3)
                finally:
                    client.close()
            except Exception:
                logger.info("predecessor head at %s unreachable for direct "
                            "fence (already dead?)", address)

        threading.Thread(target=run, name="gcs-fence-predecessor",
                         daemon=True).start()
