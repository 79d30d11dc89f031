"""Public API: init / remote / get / put / wait / actors / cluster info.

Mirrors the reference's `python/ray/_private/worker.py` public surface
(`ray.init:1115`, `get:2391`, `put:2538`, `wait:2600`, `get_actor:2722`,
`remote:2929`, `shutdown:1659`).
"""

from __future__ import annotations

import atexit
import os
import functools
import logging
import threading
from typing import Any, Dict, List, Optional, Sequence, Union

from ray_tpu_torch.core.actor import ActorClass, ActorHandle
from ray_tpu_torch.core.ids import ActorID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.task_spec import SchedulingStrategy

logger = logging.getLogger(__name__)

_worker = None
_node = None
_init_lock = threading.RLock()


def _global_worker():
    if _worker is not None:
        return _worker
    # Inside a worker process the CoreWorker was created by worker_main.
    from ray_tpu_torch.core.worker import current_worker

    w = current_worker()
    if w is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")
    return w


def is_initialized() -> bool:
    if _worker is not None:
        return True
    from ray_tpu_torch.core.worker import current_worker

    return current_worker() is not None


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[int] = None,
    resources: Optional[Dict[str, float]] = None,
    labels: Optional[Dict[str, str]] = None,
    object_store_memory: Optional[int] = None,
    ignore_reinit_error: bool = False,
    log_level: str = "WARNING",
    log_to_driver: bool = True,
) -> dict:
    """Start (or connect to) a cluster and connect this process as a driver.

    With no address, boots a head node in-process: GCS + raylet threads,
    worker subprocesses on demand (cf. reference `ray.init` local-cluster
    start, SURVEY §3.1). With `address="host:port"` (a GCS address),
    connects to an existing cluster as a driver only.
    """
    global _worker, _node
    with _init_lock:
        if _worker is not None:
            if ignore_reinit_error:
                return {"gcs_address": _worker.gcs_address}
            raise RuntimeError("ray_tpu_torch.init() called twice; use ignore_reinit_error=True")

        logging.basicConfig(level=log_level)
        from ray_tpu_torch.core.worker import CoreWorker, set_current_worker

        if address is not None and address.startswith("ray://"):
            # Remote-driver client mode (reference Ray Client,
            # python/ray/util/client/worker.py:81): a thin client over one
            # RPC connection; the real driver lives in the client server.
            ignored = {"num_cpus": num_cpus, "resources": resources,
                       "labels": labels,
                       "object_store_memory": object_store_memory}
            bad = [k for k, v in ignored.items() if v is not None]
            if bad:
                raise ValueError(
                    f"{bad} cannot be set in client mode — the cluster was "
                    f"configured where the client server runs")
            from ray_tpu_torch.client import ClientWorker

            _worker = ClientWorker(address)
            atexit.register(shutdown)
            return {"gcs_address": _worker.gcs_address, "client": True}

        if address is None:
            # cluster-launcher integration (`ray_tpu_torch exec/attach` export
            # this; reference RAY_ADDRESS): join instead of booting a head
            address = os.environ.get("RAY_TPU_TORCH_ADDRESS") or None
            if address is not None and (num_cpus is not None or resources):
                logger.warning(
                    "RAY_TPU_TORCH_ADDRESS=%s: joining the existing cluster; "
                    "init()'s num_cpus/resources apply only when booting a "
                    "local head and are ignored here", address)
        if address is None:
            from ray_tpu_torch.core.node import HeadNode

            _node = HeadNode(
                num_cpus=num_cpus,
                resources=resources,
                labels=labels,
                object_store_memory=object_store_memory,
            )
            _node.start()
            gcs_address = _node.gcs_address
            raylet_address = _node.raylet_address
        else:
            gcs_address = address
            # find a raylet to attach to: ask GCS for nodes
            from ray_tpu_torch.core import rpc as _rpc

            c = _rpc.connect_with_retry(gcs_address)
            nodes_ = c.call("get_all_nodes")
            c.close()
            alive = [n for n in nodes_ if n["alive"]]
            if not alive:
                raise ConnectionError("no alive nodes in cluster")
            raylet_address = alive[0]["address"]

        _worker = CoreWorker(
            mode="driver", raylet_address=raylet_address,
            gcs_address=gcs_address, log_to_driver=log_to_driver)
        set_current_worker(_worker)
        atexit.register(shutdown)
        return {"gcs_address": gcs_address, "raylet_address": raylet_address}


def shutdown() -> None:
    global _worker, _node
    with _init_lock:
        if _worker is not None:
            try:
                _worker.shutdown()
            except Exception:  # teardown: any half-open link may raise
                pass
            from ray_tpu_torch.core.worker import set_current_worker

            set_current_worker(None)
            _worker = None
        if _node is not None:
            try:
                _node.stop()
            except Exception:
                pass
            _node = None
        try:
            atexit.unregister(shutdown)
        except Exception:
            pass


# ------------------------------------------------------------------ remote


class RemoteFunction:
    """Wrapper produced by `@remote` on a function
    (cf. reference `python/ray/remote_function.py:34`)."""

    def __init__(self, fn, options: Optional[dict] = None):
        self._fn = fn
        self._opts = dict(options or {})
        functools.update_wrapper(self, fn)

    def options(self, **opts) -> "RemoteFunction":
        merged = dict(self._opts)
        merged.update(opts)
        return RemoteFunction(self._fn, merged)

    def remote(self, *args, **kwargs):
        w = _global_worker()
        o = self._opts
        resources = dict(o.get("resources") or {})
        if o.get("num_cpus") is not None:
            resources["CPU"] = float(o["num_cpus"])
        if o.get("num_gpus") is not None:
            resources["GPU"] = float(o["num_gpus"])
        scheduling = o.get("scheduling_strategy")
        if scheduling is None:
            scheduling = SchedulingStrategy(name=o.get("scheduling", "DEFAULT"))
            pg = o.get("placement_group")
            if pg is not None:
                scheduling.placement_group_id = pg.id
                scheduling.bundle_index = o.get("placement_group_bundle_index", -1)
        num_returns = o.get("num_returns", 1)
        if num_returns in ("dynamic", "streaming"):
            num_returns = -1  # generator task (reference num_returns="dynamic")
        refs = w.submit_task(
            self._fn, args, kwargs,
            num_returns=num_returns,
            resources=resources,
            scheduling=scheduling,
            max_retries=o.get("max_retries", 0),
            retry_exceptions=o.get("retry_exceptions", False),
            runtime_env=o.get("runtime_env"),
            max_calls=int(o.get("max_calls") or 0),
        )
        if num_returns == -1:
            return w.make_dynamic_generator(refs[0])
        return refs[0] if num_returns == 1 else refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote functions cannot be called directly; use "
            f"`{self._fn.__name__}.remote(...)`.")


def remote(*args, **kwargs):
    """`@remote` decorator for functions and classes, with or without options."""
    if len(args) == 1 and not kwargs and (callable(args[0]) or isinstance(args[0], type)):
        target = args[0]
        if isinstance(target, type):
            return ActorClass(target)
        return RemoteFunction(target)

    def decorator(target):
        if isinstance(target, type):
            return ActorClass(target, kwargs)
        return RemoteFunction(target, kwargs)

    return decorator


def method(**opts):
    """Per-method options decorator (parity shim; options resolved call-side)."""

    def decorator(fn):
        fn._ray_tpu_method_opts = opts
        return fn

    return decorator


# ------------------------------------------------------------------ objects


def put(value: Any) -> ObjectRef:
    """Store `value` and return its ref. A torch tensor goes in as its raw
    bytes: a CPU tensor with no copy but the store's, a CUDA tensor staged
    to the host once here (core/serialization.py)."""
    return _global_worker().put(value)


def push(ref: ObjectRef, node_ids=None) -> int:
    """Proactively broadcast an owned plasma object to other nodes' object
    stores (reference PushManager semantics, push_manager.h:29): downstream
    consumers then read a local copy instead of serializing on one source.
    Returns the number of nodes the push was dispatched to."""
    return _global_worker().push_object(ref, node_ids)


def get(refs: Union[ObjectRef, Sequence[ObjectRef]], *, timeout: Optional[float] = None):
    """The values behind `refs`. A large CPU tensor comes back as a
    copy-on-write view on the store's segment (an in-place write changes
    only this process's tensor); a CUDA tensor comes back on this thread's
    current CUDA device, and raises `CudaUnavailableError` where CUDA is
    not available."""
    from ray_tpu_torch.core.object_ref import ObjectRefGenerator

    if isinstance(refs, ObjectRefGenerator):
        raise TypeError(
            "got an ObjectRefGenerator (num_returns='dynamic' task); iterate "
            "it for item refs — e.g. [ray_tpu_torch.get(r) for r in gen]")
    w = _global_worker()
    if isinstance(refs, ObjectRef):
        return w.get([refs], timeout=timeout)[0]
    if not isinstance(refs, (list, tuple)):
        raise TypeError(f"get() expects an ObjectRef or list, got {type(refs)}")
    return w.get(list(refs), timeout=timeout)


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
):
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    return _global_worker().wait(list(refs), num_returns, timeout, fetch_local)


# ------------------------------------------------------------------ actors


def get_actor(name: str, namespace: str = "") -> ActorHandle:
    info = _global_worker().get_actor_info(name=name, namespace=namespace)
    if info is None or info["state"] == "DEAD":
        raise ValueError(f"no live actor named '{name}'")
    return ActorHandle(info["actor_id"], info.get("class_name", ""))


def kill(actor: ActorHandle, *, no_restart: bool = True) -> None:
    _global_worker().kill_actor(actor.actor_id, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False,
           recursive: bool = False) -> None:
    """Cancel the task that produces `ref` (reference `ray.cancel`).

    Best-effort on the work, hard guarantee on the ref: once the owner
    claims the cancel, `get(ref)` resolves to `TaskCancelledError` — never
    hangs — whether the task was still queued (raylet dequeue), running
    (cooperative exception injection at the next bytecode boundary), or a
    queued actor call (purged from the actor's mailbox). A task that
    already completed keeps its value. `force=True` escalates a running
    task to SIGKILL of its worker (non-retryable); `recursive=True` walks
    each owner's child-task table (parent_task_id lineage) so the whole
    tree dies leaf-ward with no orphaned grandchildren."""
    w = _global_worker()
    w.cancel(ref, force=force, recursive=recursive)


# ------------------------------------------------------------------ cluster


def nodes() -> List[dict]:
    return _global_worker().gcs.call("get_all_nodes")


def cluster_resources() -> Dict[str, float]:
    total: Dict[str, float] = {}
    for n in nodes():
        if n["alive"]:
            for r, q in n["resources_total"].items():
                total[r] = total.get(r, 0.0) + q
    return total


def available_resources() -> Dict[str, float]:
    total: Dict[str, float] = {}
    for n in nodes():
        if n["alive"]:
            for r, q in n["resources_available"].items():
                total[r] = total.get(r, 0.0) + q
    return total


class RuntimeContext:
    def __init__(self, worker):
        self._w = worker

    @property
    def job_id(self):
        return self._w.job_id

    @property
    def node_id(self):
        return self._w.node_id

    @property
    def worker_id(self):
        return self._w.worker_id

    @property
    def actor_id(self):
        return self._w.actor_id

    @property
    def gcs_address(self):
        return self._w.gcs_address

    @property
    def placement_group_id(self):
        return getattr(self._w, "placement_group_id", None)

    def get(self):
        return {
            "job_id": self.job_id,
            "node_id": self.node_id,
            "worker_id": self.worker_id,
            "actor_id": self.actor_id,
            "placement_group_id": self.placement_group_id,
        }


def get_runtime_context() -> RuntimeContext:
    from ray_tpu_torch.core.worker import current_worker

    w = current_worker() or _global_worker()
    return RuntimeContext(w)


def get_gpu_ids() -> List[int]:
    """GPU indices the raylet granted the current task or actor (reference
    `ray.get_gpu_ids`): DISJOINT across concurrent tasks on a node — whole
    cards for integer `num_gpus`, one shared card index (best fit) for
    fractional ones. [] when nothing is reserved.

    The runtime does not set CUDA_VISIBLE_DEVICES: a warm worker outlives
    one grant and its CUDA context cannot be re-pointed, so every card of
    the node stays visible. Instead the worker makes the grant's first
    index torch's current device (`torch.cuda.set_device`) before the task
    or the actor's `__init__` and each of its calls, so their CUDA work
    lands on the card granted."""
    from ray_tpu_torch.core.worker import current_worker

    w = current_worker() or _global_worker()
    ids = getattr(getattr(w, "_tls", None), "gpu_ids", None)
    if ids is None:
        ids = list(getattr(w, "_actor_gpu_ids", []) or [])
    return list(ids)


def timeline() -> List[dict]:
    """Cluster-wide chrome-trace events: this process's spans plus the
    worker spans aggregated in the GCS (reference `ray.timeline()`,
    _private/state.py:851)."""
    from ray_tpu_torch.util.tracing import get_events

    events = get_events()
    try:
        w = _global_worker()
        w.flush_profile_events()
        remote = w.gcs.call("get_profile_events", timeout=10)
        # dedupe by origin worker id (pids collide across hosts)
        local_src = w.worker_id.binary().hex()
        events = events + [e for e in remote if e.get("_src") != local_src]
    except Exception:
        pass
    return events
