"""Actor API: ActorClass / ActorHandle / ActorMethod.

Mirrors the reference's `python/ray/actor.py` surface (ActorClass:377,
ActorHandle:1022, ActorMethod:92): `@ray.remote` on a class yields an
ActorClass whose `.remote(...)` creates the actor via the control plane and
returns a handle; method calls submit actor tasks over the direct
worker-to-worker transport with per-caller ordering.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.core.ids import ActorID
from ray_tpu_torch.core.task_spec import ActorCreationSpec, SchedulingStrategy


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str, num_returns: int = 1,
                 concurrency_group: str = None):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group

    def remote(self, *args, **kwargs):
        return self._handle._invoke(self._name, args, kwargs,
                                    self._num_returns,
                                    self._concurrency_group)

    def options(self, num_returns: int = 1, concurrency_group: str = None):
        return ActorMethod(self._handle, self._name, num_returns,
                           concurrency_group)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor methods cannot be called directly; use "
            f"`actor.{self._name}.remote(...)`.")


class ActorHandle:
    def __init__(self, actor_id: ActorID, class_name: str = ""):
        self._actor_id = actor_id
        self._class_name = class_name

    @property
    def actor_id(self) -> ActorID:
        return self._actor_id

    def _invoke(self, method_name: str, args, kwargs, num_returns,
                concurrency_group=None):
        from ray_tpu_torch.core.api import _global_worker

        if num_returns in ("dynamic", "streaming"):
            num_returns = -1  # generator method (reference num_returns="dynamic")
        w = _global_worker()
        refs = w.submit_actor_task(
            self._actor_id, method_name, args, kwargs, num_returns=num_returns,
            concurrency_group=concurrency_group)
        if num_returns == -1:
            return w.make_dynamic_generator(refs[0])
        return refs[0] if num_returns == 1 else refs

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __repr__(self):
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._class_name))


class ActorClass:
    def __init__(self, cls: type, default_options: Optional[dict] = None):
        self._cls = cls
        self._opts: Dict[str, Any] = dict(default_options or {})

    def options(self, **opts) -> "ActorClass":
        merged = dict(self._opts)
        merged.update(opts)
        return ActorClass(self._cls, merged)

    def remote(self, *args, **kwargs) -> ActorHandle:
        from ray_tpu_torch.core.api import _global_worker
        from ray_tpu_torch.core import serialization

        w = _global_worker()
        o = self._opts
        resources = dict(o.get("resources") or {})
        if o.get("num_cpus") is not None:
            resources["CPU"] = float(o["num_cpus"])
        if o.get("num_gpus") is not None:
            resources["GPU"] = float(o["num_gpus"])
        scheduling = o.get("scheduling_strategy")
        if scheduling is None:
            scheduling = SchedulingStrategy()
            pg = o.get("placement_group")
            if pg is not None:
                scheduling.placement_group_id = pg.id
                scheduling.bundle_index = o.get("placement_group_bundle_index", -1)

        # export-once class pickle (same fast lane as task functions):
        # repeated .remote() of one ActorClass ships a 16-byte id, and the
        # hosting worker resolves it through its deserialized-class LRU.
        # Client-mode workers have no function table — ship the blob and
        # let the server-side driver's spec pass through unchanged.
        ft = getattr(w, "function_table", None)
        if ft is not None:
            class_fn_id, class_blob = ft.export(self._cls)
        else:
            import cloudpickle

            class_fn_id, class_blob = None, cloudpickle.dumps(self._cls)
        actor_id = ActorID.from_random()
        spec = ActorCreationSpec(
            actor_id=actor_id,
            name=o.get("name"),
            namespace=o.get("namespace", ""),
            max_restarts=o.get("max_restarts", 0),
            max_task_retries=o.get("max_task_retries", 0),
            max_concurrency=o.get("max_concurrency", 1),
            lifetime=o.get("lifetime", "non_detached"),
            concurrency_groups=o.get("concurrency_groups"),
            class_blob=class_blob,
            class_fn_id=class_fn_id,
            init_args=w._serialize_args(args, creation_of=actor_id),
            init_kwargs_blob=serialization.dumps(kwargs) if kwargs else None,
            resources=resources,
            scheduling=scheduling,
            runtime_env=o.get("runtime_env"),
        )
        w.create_actor(spec, class_name=self._cls.__name__)
        return ActorHandle(spec.actor_id, self._cls.__name__)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actors cannot be instantiated directly; use "
            f"`{self._cls.__name__}.remote(...)`.")
