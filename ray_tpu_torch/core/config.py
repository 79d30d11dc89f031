"""Env-overridable configuration registry.

Equivalent of the reference's `RAY_CONFIG(type, name, default)` macro table
(`src/ray/common/ray_config_def.h:1-814`, 199 knobs): every knob defined here
can be overridden on any process via the `RAY_TPU_TORCH_<NAME>` environment
variable, so daemons spawned as subprocesses inherit overrides naturally.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, fields
from typing import Any


def _coerce(value: str, typ: type) -> Any:
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if typ is int:
        return int(value)
    if typ is float:
        return float(value)
    return value


@dataclass
class Config:
    # --- object store (cf. ray_config_def.h:213 max_direct_call_object_size) ---
    max_direct_call_object_size: int = 100 * 1024  # inline objects <= 100 KiB
    task_rpc_inlined_bytes_limit: int = 10 * 1024 * 1024
    object_store_memory: int = 2 * 1024 * 1024 * 1024  # per-node shm budget
    object_spilling_threshold: float = 0.8
    min_spilling_size: int = 100 * 1024 * 1024
    object_transfer_chunk_bytes: int = 8 * 1024 * 1024
    # --- zero-copy object plane (pin protocol; ROADMAP item 3) ---
    # same-node get() of a sealed plasma object attaches the shm segment
    # and deserializes IN PLACE: pickle-5 buffers stay read-only views
    # into the mapping, refcount-pinned on the raylet until the reader's
    # last view is GC'd (finalizer-driven obj_unpin; the raylet reaps a
    # dead reader's pins at connection close). Off -> every get copies.
    object_zero_copy_enabled: bool = True
    # worker-side LRU of (segment, size) locations: repeat gets of a hot
    # object skip owner resolution AND the pull round-trip entirely
    object_location_cache_entries: int = 4096
    # deleted file segments park here (bucketed by page-rounded size)
    # instead of unlinking: a recycled segment hands the next same-size
    # put ALREADY-FAULTED tmpfs pages (~4-5x the fresh-page write path).
    # Drained first under memory pressure; 0 disables recycling.
    object_segment_pool_bytes: int = 256 * 1024 * 1024
    # --- storage failure domain (checksummed spills, disk-full ladder,
    # store-full admission; cf. reference ObjectStoreFullError +
    # local_object_manager.h spill IO workers) ---
    # ":"-separated fallback spill directories. A spill write that fails
    # with ENOSPC/EIO retries down this list under backoff; empty = the
    # per-pid session spill dir only.
    object_spill_dirs: str = ""
    # per-directory write retries (with backoff) before the next dir
    spill_write_retries: int = 2
    spill_retry_backoff_ms: int = 50
    # once EVERY spill dir has failed the store goes spill-degraded: it
    # stops spilling (puts flip to backpressure) and probes the dirs at
    # this period until one heals. 0 disables the self-heal probe.
    spill_degraded_probe_period_s: float = 2.0
    # put()/obj_create block at most this long for eviction/unpin headroom
    # before failing with typed ObjectStoreFullError
    put_full_timeout_s: float = 10.0
    # reader pins may hold at most this fraction of capacity: the first
    # pin that would cross it is refused (readers fall back to a bounded
    # copy window), so pinned entries can never wedge eviction entirely
    max_pinned_fraction: float = 0.75

    # --- health / heartbeats (cf. gcs_health_check_manager.h) ---
    health_check_period_ms: int = 1000
    health_check_timeout_ms: int = 10000
    num_heartbeats_timeout: int = 5
    # gray-failure quarantine (partition failure domain): a node silent
    # past this bound — but not yet past the death bound — takes no NEW
    # dispatch and the autoscaler holds its replacement; it rejoins with
    # its actors intact if heartbeats resume before the death bound.
    # 0 = half of health_check_timeout_ms (always clamped inside it).
    node_quarantine_timeout_ms: int = 0

    # --- scheduling (cf. hybrid_scheduling_policy.cc, ray_config_def.h:193) ---
    scheduler_spread_threshold: float = 0.5
    worker_lease_timeout_ms: int = 30000
    max_pending_lease_requests_per_scheduling_category: int = 10

    # --- worker pool (cf. worker_pool.h:156, PrestartWorkers
    # worker_pool.cc:1363) ---
    # FLOOR of the demand-driven prestart policy (~1 worker/CPU up to the
    # current backlog): the default env keeps at least this many task
    # workers ALIVE (busy, idle or starting) from raylet boot onward, and
    # the idle reaper never shrinks the idle pool below this.
    num_prestart_workers: int = 0
    worker_register_timeout_s: int = 60
    idle_worker_killing_time_s: int = 300
    maximum_startup_concurrency: int = 8
    # --- warm worker pool (fork-template zygotes; core/worker_pool.py) ---
    # One template process per runtime-env key imports ray_tpu_torch once and
    # os.fork()s a ready worker per granted lease; disable to force the
    # classic cold-Popen path everywhere.
    worker_template_enabled: bool = True
    worker_template_boot_timeout_s: float = 60.0
    worker_template_fork_timeout_s: float = 10.0
    # template crash -> respawn under full-jitter backoff (cold fallback
    # serves leases while the clock runs)
    worker_template_backoff_base_ms: int = 500
    worker_template_backoff_cap_ms: int = 30000
    # non-default-env templates close after this long with no fork and no
    # live worker (releasing their env ref so runtime-env gc can reclaim)
    worker_template_idle_s: float = 300.0

    # --- resource reporting / syncer ---
    resource_broadcast_period_ms: int = 100

    # --- core worker ---
    task_retry_delay_ms: int = 100
    max_task_retries_default: int = 0
    actor_max_restarts_default: int = 0
    get_check_interval_s: float = 0.05
    # Lineage-based object recovery (cf. reference
    # object_recovery_manager.h:41, task_manager.h:90): how many times a lost
    # task output may be recomputed by re-executing its creating task, and how
    # many creating specs the owner retains (FIFO-evicted beyond this).
    lineage_reconstruction_max_retries: int = 3
    lineage_table_max_entries: int = 10000
    # Grace before freeing a plasma object whose ref was serialized outward:
    # absorbs the window where a receiver's add_borrower notify is in flight
    # while the owner's last local ref dies (lineage recovery is the backstop
    # if the race is still lost).
    object_free_grace_period_ms: int = 500

    # --- memory monitor (cf. reference memory_monitor.h:52 +
    # worker_killing_policy.h:34: kill retriable tasks under node pressure) ---
    memory_monitor_refresh_ms: int = 250
    memory_usage_threshold: float = 0.95
    # 0 = monitor whole-node memory via psutil; >0 = budget for the summed
    # RSS of this raylet's task workers (deterministic for tests/containers)
    memory_monitor_worker_budget_bytes: int = 0
    # don't kill a task younger than this (it hasn't allocated yet), and
    # wait this long between kills (let the previous kill's memory return)
    memory_monitor_min_task_age_ms: int = 500
    memory_monitor_kill_cooldown_ms: int = 1000

    # --- data streaming executor (cf. reference streaming_executor.py:45:
    # operator-level backpressure; here: bounded in-flight block tasks
    # AND a per-operator byte budget on produced-but-unconsumed blocks,
    # the reference's per-op resource quota) ---
    data_max_inflight_blocks: int = 8
    data_op_memory_budget_bytes: int = 256 * 1024 * 1024

    # --- object transfer (cf. reference object_manager.h:117 64MiB chunks,
    # pull_manager.h:52 admission control, push_manager.h:29) ---
    object_transfer_chunk_size_bytes: int = 16 * 1024 * 1024
    object_transfer_inflight_chunks: int = 4
    object_transfer_chunk_timeout_s: float = 60.0
    # striped raw-socket pulls over the dedicated data plane (data_plane.py);
    # chunks interleave across this many persistent connections
    object_transfer_parallel_streams: int = 4
    # total bytes of concurrently-admitted chunked pulls per raylet; pulls
    # beyond it queue rather than overcommitting store memory
    pull_admission_max_bytes: int = 2 * 1024 * 1024 * 1024

    # --- task-path fast lanes ---
    # Export-once function table (cf. reference function_manager.py): the
    # submitter pickles a callable once, exports the blob to the GCS keyed
    # by its content hash, and every TaskSpec carries only the FunctionID.
    # Disabled -> every spec ships the full pickle (the fallback wire
    # format, kept for anonymous one-shot callables).
    function_table_enabled: bool = True
    # executor-side LRU of DESERIALIZED functions/classes per process
    function_cache_max_entries: int = 256
    # GCS-side table byte budget: beyond it the OLDEST exports evict (with
    # a warning — a task whose function was evicted fails its fetch). Keeps
    # a driver minting unbounded distinct closures from growing the GCS and
    # its snapshot forever.
    function_table_max_bytes: int = 1024 * 1024 * 1024
    # Worker-side TaskEventBuffer (cf. reference task_event_buffer.h,
    # task_events_report_interval_ms): task-state transitions and tracing
    # spans coalesce in-process and flush to the GCS on this timer (and at
    # shutdown) instead of one notify per transition.
    task_events_report_interval_ms: int = 200
    # bounded buffer: oldest events drop (counted) beyond this
    task_events_max_buffer_size: int = 10000

    # --- distributed tracing (util/tracing.py; cf. reference ProfileEvent
    # + opt-in OpenTelemetry context propagation) ---
    # Default-off master switch for trace-CONTEXT propagation: when on,
    # submits stamp (trace_id, parent span_id) into every TaskSpec, the
    # serve path and rollout->learner loop carry the same context, and the
    # raylet ships its lease spans. Local chrome-trace spans record either
    # way — the knob only gates the cross-process causal tree, so the
    # default keeps the task hot path free of any per-submit id minting.
    tracing_enabled: bool = False
    # in-process span ring bound (mirrors task_events_max_buffer_size):
    # oldest spans drop (counted; the count rides the next task-events
    # flush) so fork-template replicas / learner actors can't grow forever
    tracing_max_buffer_size: int = 20000
    # GCS-side trace ring: distinct trace_ids retained (oldest evicted)
    tracing_max_traces: int = 2000
    # NTP-style clock probe against the GCS (offset = t1 - (t0+t2)/2 from
    # one RPC round-trip): re-estimated at this period per process, shipped
    # with each task-events flush for merge-time alignment
    tracing_clock_probe_period_s: float = 30.0
    # storm flight recorder: seconds of span history dumped next to the
    # artifact when a harness violation fires
    tracing_flight_recorder_window_s: float = 30.0

    # --- completion-path fast lanes ---
    # Executor-side ResultBuffer (result_buffer.py): while a delivery is in
    # flight, further results batch per owner until this interval's edge;
    # with nothing in flight a result ships as soon as the flush thread
    # wakes, so a sequential caller's round-trips never wait out the
    # interval.
    result_buffer_flush_interval_ms: int = 10
    # per-result delivery attempts (one flush retry each) before results to
    # an unreachable owner are dropped with a warning
    result_delivery_max_attempts: int = 5

    # --- rpc ---
    rpc_connect_timeout_s: float = 30.0
    rpc_call_timeout_s: float = 0.0  # 0 = no timeout
    # Reconnect loops (control-plane links, owner links) sleep with
    # exponential backoff + full jitter between attempts (util/backoff.py)
    # instead of fixed sleeps: after a head replacement every process
    # reconnects at once, and jitter decorrelates the herd.
    reconnect_backoff_base_ms: int = 100
    reconnect_backoff_cap_ms: int = 10000

    # --- control-plane HA (cf. reference gcs_table_storage.h) ---
    # SnapshotStore URI for GCS persistence: "file:///path" or
    # "memory://name"; empty = no persistence. A replacement head started
    # on a NEW address restores node/actor/PG/KV state from this store.
    gcs_snapshot_uri: str = ""
    # retained snapshot versions (newest wins; corrupt falls back older)
    gcs_snapshot_keep: int = 3
    # Head re-resolution: a file holding the current GCS address. The GCS
    # writes it at boot; raylets/workers/drivers re-read it on every
    # reconnect attempt, so a replacement head on a new address is found
    # without any process restart. Empty = rely on the in-band announce
    # (the new head dials snapshot-known raylets) + static addresses.
    gcs_address_file: str = ""
    # a 2-phase PG bundle prepared but never committed (the head died
    # between phases) is returned to the node pool after this timeout
    bundle_prepare_timeout_s: float = 30.0
    # an actor whose restart found no capacity waits (paced retries) for a
    # surviving/replacement node at most this long before going DEAD —
    # unbounded waiting would hang every ref of a permanently-infeasible
    # restart (node type no longer launchable, breaker stuck open)
    actor_restart_pending_timeout_s: float = 120.0
    # --- standby head / lease fencing (core/head_lease.py) ---
    # TTL of the active head's lease (stored beside the snapshots); the
    # head renews every ttl/3, a standby promotes once it expires. Lower =
    # faster failover, more store writes.
    head_lease_ttl_s: float = 3.0
    # explicit renew period; 0 = ttl/3
    head_lease_renew_period_s: float = 0.0
    # standby snapshot-tail + lease-watch poll period; 0 = ttl/4
    head_standby_poll_s: float = 0.0
    # CH_RESOURCES fan-out ships per-node DELTAS between full snapshots
    # (full on topology change / subscriber catch-up) so gossip volume is
    # O(changes), not O(nodes) per publish x O(nodes) subscribers
    resource_broadcast_delta_enabled: bool = True

    # --- fault injection (deterministic chaos; see rpc.FaultInjector) ---
    # Rules at named client-side RPC boundaries, ";"-separated:
    #   drop:<method>[:<prob>]          lose the message
    #   delay:<method>:<ms>[:<prob>]    stall before send
    #   sever_once:<method>             cut the connection at first match
    #   sever:<method>[:<prob>]         cut the connection per match
    #   fs:<site>:<mode>[:<prob>]       filesystem fault at a named site
    #                                   (spill_write, spill_restore; modes
    #                                   enospc, eio, torn, bitflip)
    # <method> may be "*". Empty = injection disabled (zero overhead).
    fault_injection_spec: str = ""
    # seeds the injector's RNG so probabilistic faults replay exactly
    fault_injection_seed: int = 0

    # --- completion-path retry ---
    # cap for the owner-down result-redelivery backoff (base is the flush
    # interval; full jitter)
    result_retry_backoff_cap_ms: int = 2000

    # --- job failure domain (cancellation + driver-death fate-sharing) ---
    # RAY_TPU_TORCH_JOB_REAP_DETECTION_BOUND_S: ceiling from driver death to the
    # GCS *initiating* the fleet reap. Conn-close detection is immediate;
    # this bounds the backstop paths (health-loop probe of a RUNNING job
    # whose driver link is gone, and post-failover probe of snapshot-
    # restored jobs whose conn-close hooks died with the old head).
    job_reap_detection_bound_s: float = 3.0
    # RAY_TPU_TORCH_JOB_REAP_PACING_MS: sleep between per-target reap steps
    # (per-raylet purge notify, per-actor kill) so reaping a large job is a
    # paced drain, not a thundering herd against surviving tenants.
    job_reap_pacing_ms: int = 10
    # owner-side failsafe: after cancel() is sent, if no downstream ack
    # (dequeue notify, cooperative error, kill report) resolved the ref
    # within this window, the owner resolves it to TaskCancelledError
    # itself — a cancelled ref may never hang on a lost notify
    task_cancel_resolution_timeout_s: float = 10.0
    # force=True: cooperative interrupt is pushed first (lets a recursive
    # cancel fan out to children), SIGKILL follows after this grace
    task_cancel_force_grace_ms: int = 200

    # --- logging / session ---
    session_dir_root: str = os.path.join(tempfile.gettempdir(), "ray_tpu_torch")
    log_to_driver: bool = True

    # --- GPU topology ---
    gpus_per_host: int = 8  # an HGX H100 host's NVLink domain

    def __post_init__(self):
        for f in fields(self):
            env = os.environ.get(f"RAY_TPU_TORCH_{f.name.upper()}")
            if env is not None:
                setattr(self, f.name, _coerce(env, type(getattr(self, f.name))))


_config: Config | None = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config()
    return _config


def reset_config() -> None:
    global _config
    _config = None
