"""Exception types surfaced by the runtime.

Mirrors the reference's `python/ray/exceptions.py` surface (RayError,
RayTaskError, RayActorError, WorkerCrashedError, ObjectLostError,
GetTimeoutError) without its dependency on serialized C++ status codes.
"""

from __future__ import annotations

import traceback


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A task raised an exception during execution.

    Wraps the remote traceback so `get()` on the result re-raises with the
    remote stack attached (cf. reference RayTaskError.as_instanceof_cause).
    """

    def __init__(self, function_name: str, remote_traceback: str, cause: Exception | None = None):
        self.function_name = function_name
        self.remote_traceback = remote_traceback
        self.cause = cause
        super().__init__(f"task {function_name} failed:\n{remote_traceback}")

    def __reduce__(self):
        return (type(self), (self.function_name, self.remote_traceback, self.cause))

    @classmethod
    def from_exception(cls, function_name: str, exc: Exception) -> "TaskError":
        tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
        try:
            import cloudpickle

            cloudpickle.dumps(exc)
            cause = exc
        except Exception:
            cause = None  # unpicklable cause: carry only the traceback text
        return cls(function_name, tb, cause)


class ActorError(TaskError):
    """An actor method raised an exception."""


class ActorDiedError(RayTpuError):
    """The actor is dead (crashed, killed, or out of restarts)."""


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly."""


class OutOfMemoryError(WorkerCrashedError):
    """The raylet's memory monitor killed the worker under node memory
    pressure and the task's retry budget is exhausted (reference
    worker_killing_policy.h:34 + OutOfMemoryError in ray.exceptions)."""


class TaskCancelledError(RayTpuError):
    """The task was cancelled — by `ray_tpu_torch.cancel()` (directly, or as part
    of a `recursive=True` tree walk) or by the job failure domain reaping a
    dead driver's work. A cancelled ref ALWAYS resolves to this error: the
    owner stamps it whether the task was still queued (raylet dequeue), was
    interrupted mid-execution (cooperative exception injection, or SIGKILL
    under force=True), or completed in the race window after cancel() was
    called (the late value is dropped so the outcome is deterministic).
    Never retried. Matched BY TYPE by callers, the workflow engine and the
    job storm; don't match the message."""


class ObjectLostError(RayTpuError):
    """An object was lost (e.g. node died) and could not be reconstructed."""


class OwnerDiedError(ObjectLostError):
    """The object's owner process is dead, so the value can never be
    produced or re-resolved: the owner holds the authoritative location
    and lineage for its objects (ownership model), and the job failure
    domain drops a dead job's primary copies during the reap. Surfaced by
    cross-job `get()` of a reaped job's object. A subclass of
    ObjectLostError so existing lost-object handling still applies;
    matched BY TYPE by the job storm — don't match the message."""


class ObjectStoreFullError(RayTpuError):
    """The local object store could not admit an object: eviction, spilling
    and pin release freed no headroom within `put_full_timeout_s` (or the
    store is spill-degraded — every configured spill dir is failing — and
    puts are flipped to backpressure). A typed, bounded outcome instead of
    silent overcommit past capacity (reference ObjectStoreFullError in
    ray.exceptions + plasma's PlasmaStoreFull). Matched BY TYPE by callers
    and the store storm; don't match the message."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """`get()` timed out."""


class RuntimeEnvSetupError(RayTpuError):
    """Failed to set up the runtime environment for a task/actor."""


class PendingCallsLimitExceeded(RayTpuError):
    """Back-pressure: too many in-flight calls to an actor."""


class RequestTimeoutError(RayTpuError, TimeoutError):
    """A serve request exceeded its end-to-end deadline (reference
    `RequestTimeoutError` semantics of serve's request_timeout_s). Raised
    at whichever point first observes expiry — the replica's pre-dequeue
    check, the batcher's batch-assembly check, or the router's deadline
    reaper — and mapped to HTTP 504 at the ingress. Matched BY TYPE by the
    storm harness and the edges; don't match the message."""


class BackPressureError(RayTpuError):
    """A serve request was shed by admission control: every replica of the
    target deployment is at its configured in-flight cap (or the ingress
    itself is at its cap). A fast, typed rejection — mapped to HTTP 503 —
    so sustained overload degrades to bounded-latency sheds instead of
    unbounded queue growth. Matched BY TYPE (edges, storm harness)."""


class PlacementInfeasibleError(RayTpuError):
    """A placement group's bundles cannot be satisfied by the current
    cluster. Raised at the reservation source and matched BY TYPE (elastic
    shrink in train/trainer.py keys on it); matching the message string
    would let a reword silently disable elastic recovery."""
