"""Task/actor specifications that travel on the wire.

Equivalent of the reference's `TaskSpecification`
(`src/ray/common/task/task_spec.h`): everything a raylet/worker needs to
schedule and execute a task, including ownership info for the result path.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.ids import ActorID, JobID, ObjectID, PlacementGroupID, TaskID, WorkerID


class TaskType(Enum):
    NORMAL = 0
    ACTOR_CREATION = 1
    ACTOR_TASK = 2


@dataclass
class SchedulingStrategy:
    """Where a task may run (cf. python/ray/util/scheduling_strategies.py:15,41)."""

    # "DEFAULT" (hybrid), "SPREAD", or None when pg/node targeted
    name: str = "DEFAULT"
    node_id: Optional[bytes] = None       # NodeAffinity
    soft: bool = False
    placement_group_id: Optional[PlacementGroupID] = None
    bundle_index: int = -1


@dataclass
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    task_type: TaskType
    # Function: either a serialized callable (normal tasks / actor creation)
    # or a method name (actor tasks).
    function_blob: Optional[bytes]
    method_name: str
    language_hint: str = "python"
    # Export-once fast lane (reference function_manager.py): when set, the
    # callable's pickle lives in the GCS function table under this content
    # hash and `function_blob` is None — the spec ships O(16 bytes) instead
    # of O(closure). Executors resolve through a per-process LRU with a GCS
    # fetch miss path; `function_blob` survives as the fallback wire format
    # for one-shot/unexportable callables.
    function_id: Optional[bytes] = None

    # Arguments: positional list of either ("value", bytes) inline serialized
    # or ("ref", ObjectID, owner_address) for object refs the executor must
    # resolve before running (cf. reference dependency resolution).
    args: List[Tuple] = field(default_factory=list)
    kwargs_blob: Optional[bytes] = None

    # -1 = dynamic (generator task, num_returns="dynamic"): one declared
    # return (the generator object); item objects are created as the
    # executor yields them (cf. reference _raylet.pyx:178 dynamic returns)
    num_returns: int = 1
    resources: Dict[str, float] = field(default_factory=dict)
    scheduling: SchedulingStrategy = field(default_factory=SchedulingStrategy)
    max_retries: int = 0
    retry_exceptions: bool = False

    # Ownership: address of the owner's core-worker RPC server, and its id.
    owner_address: str = ""
    owner_worker_id: Optional[WorkerID] = None

    # Lineage for recursive cancellation: the task the SUBMITTER was
    # executing when it submitted this one (None for driver-root submits).
    # Each owner only knows its own children — a recursive cancel walks the
    # tree hop by hop: cancel(A) reaches A's executor, which cancels its
    # pending tasks whose parent_task_id == A, and so on leaf-ward
    # (cf. reference TaskSpec parent_task_id / CancelTask recursive=True).
    parent_task_id: Optional[TaskID] = None

    # Actor fields
    actor_id: Optional[ActorID] = None
    actor_creation_spec: Optional["ActorCreationSpec"] = None
    # incarnation fencing (partition failure domain): the actor RESTART
    # count the caller's handle resolved this call against. The hosting
    # worker refuses a mismatch — a call can never be serviced by a
    # superseded instance that a partition kept alive, and a zombie
    # learning of a newer incarnation self-terminates. None = resolved
    # before the caller learned an incarnation (first call racing
    # creation): accepted by any incarnation.
    actor_incarnation: Optional[int] = None
    sequence_number: int = 0  # per-caller ordering for actor tasks
    caller_id: Optional[WorkerID] = None
    # call-site concurrency-group override (reference actor.py:82
    # method.options(concurrency_group=...)); None = method annotation
    concurrency_group: Optional[str] = None

    # runtime env (conda/pip not supported; env vars + working dir are)
    runtime_env: Optional[dict] = None

    # worker recycling: the executing worker exits after running this
    # function max_calls times (reference remote_function.py _max_calls —
    # bounds leaks from native libraries); 0 = unlimited
    max_calls: int = 0

    # distributed tracing (util/tracing.py, gated on tracing_enabled):
    # (trace_id, parent span_id) stamped at submit so the raylet's lease
    # span and the executor's run/result spans join the submitter's causal
    # tree. None when tracing is off — the spec pays no wire cost.
    trace_ctx: Optional[Tuple[str, str]] = None

    def return_object_ids(self) -> List[ObjectID]:
        n = 1 if self.num_returns == -1 else self.num_returns
        return [ObjectID.for_task_return(self.task_id, i + 1) for i in range(n)]


@dataclass
class ActorCreationSpec:
    actor_id: ActorID
    name: Optional[str]            # named actor (get_actor lookup)
    namespace: str
    max_restarts: int
    max_task_retries: int
    max_concurrency: int
    lifetime: str                  # "non_detached" | "detached"
    # Owning job (stamped by the creating worker): the fate-sharing reap
    # kills a dead job's non-detached actors by this field; detached actors
    # are GCS-owned and ignore it. None only for specs predating the stamp.
    job_id: Optional[JobID] = None
    # cloudpickled class — None when the class rides the function table
    class_blob: Optional[bytes] = None
    # export-once id of the class pickle (same fast lane as
    # TaskSpec.function_id): repeated actor creations of one class ship
    # 16 bytes instead of the class closure
    class_fn_id: Optional[bytes] = None
    init_args: List[Tuple] = field(default_factory=list)
    init_kwargs_blob: Optional[bytes] = None
    resources: Dict[str, float] = field(default_factory=dict)
    scheduling: SchedulingStrategy = field(default_factory=SchedulingStrategy)
    runtime_env: Optional[dict] = None
    # named thread pools: methods annotated (or called) with a group run on
    # that group's threads (reference actor.py:65 concurrency_groups)
    concurrency_groups: Optional[Dict[str, int]] = None
    # incarnation this creation/restart instantiates (stamped by the GCS at
    # dispatch = ActorInfo.num_restarts): the hosting worker adopts it, its
    # replies carry it, and every fence check compares against it
    incarnation: int = 0


class ActorState(Enum):
    PENDING = "PENDING_CREATION"
    ALIVE = "ALIVE"
    RESTARTING = "RESTARTING"
    DEAD = "DEAD"


@dataclass
class ActorInfo:
    actor_id: ActorID
    name: Optional[str]
    namespace: str
    state: ActorState
    address: str = ""              # actor worker's core-worker RPC address
    node_id: Optional[bytes] = None
    num_restarts: int = 0
    max_restarts: int = 0
    death_cause: str = ""
    class_name: str = ""
