"""Thin client: the worker-interface shim behind `ray://` addresses.

Counterpart of the reference's client worker
(`python/ray/util/client/worker.py:81`): implements the same method surface
the public API layer (`core/api.py`, `core/actor.py`) calls on a driver
CoreWorker, but forwards every operation over one RPC connection to a
`ClientServer`. ObjectRefs travel as plain (id, owner) pairs — the server
session pins the real references while the client holds them.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Tuple

import cloudpickle

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.ids import ActorID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.rpc import RpcCallError, connect_with_retry

logger = logging.getLogger(__name__)


def _parse_ray_address(address: str) -> str:
    assert address.startswith("ray://"), address
    return address[len("ray://"):]


class _GcsProxy:
    """Duck-types `worker.gcs` for placement groups / state / cluster info."""

    def __init__(self, client: "ClientWorker"):
        self._client = client

    def call(self, method: str, payload: Any = None, timeout: Optional[float] = None):
        return self._client._call("cl_gcs_call",
                                  {"method": method, "payload": payload},
                                  timeout=timeout)["result"]


class ClientWorker:
    """Driver-worker stand-in connected to a ClientServer."""

    def __init__(self, address: str, connect_timeout: float = 30.0):
        self._address = address
        self._rpc = connect_with_retry(_parse_ray_address(address),
                                       timeout=connect_timeout)
        self.gcs = _GcsProxy(self)
        info = self._call("cl_ping", {})
        self.job_id = info["job_id"]
        self.node_id = info["node_id"]
        self.gcs_address = info["gcs_address"]
        self.worker_id = b"client"
        self.actor_id = None
        self.address = address
        self.current_placement_group_id = None

    # ------------------------------------------------------------ plumbing

    def _call(self, method: str, payload: dict, timeout: Optional[float] = None):
        result = self._rpc.call(method, payload, timeout=timeout)
        if isinstance(result, dict) and "error_blob" in result:
            raise cloudpickle.loads(result["error_blob"])
        return result

    def shutdown(self) -> None:
        try:
            self._rpc.close()
        except OSError:
            pass

    # ------------------------------------------------------------- objects

    def put(self, value: Any) -> ObjectRef:
        return self._call("cl_put", {"blob": serialization.dumps(value)})["ref"]

    def get(self, refs: List[ObjectRef], timeout: Optional[float] = None) -> List[Any]:
        r = self._call("cl_get", {"refs": refs, "timeout": timeout})
        return serialization.loads(r["blob"])

    def get_async(self, ref: ObjectRef):
        from concurrent.futures import Future
        import threading

        fut: Future = Future()

        def run():
            try:
                fut.set_result(self.get([ref])[0])
            except BaseException as e:
                fut.set_exception(e)

        threading.Thread(target=run, daemon=True).start()
        return fut

    def wait(self, refs: List[ObjectRef], num_returns: int,
             timeout: Optional[float], fetch_local: bool = True
             ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        r = self._call("cl_wait", {
            "refs": refs, "num_returns": num_returns, "timeout": timeout,
            "fetch_local": fetch_local})
        return r["ready"], r["not_ready"]

    def free(self, refs: List[ObjectRef]) -> None:
        self._call("cl_release",
                   {"ref_ids": [r.id.binary() for r in refs]})

    # --------------------------------------------------------------- tasks

    def submit_task(self, func, args: tuple, kwargs: dict, **opts) -> List[ObjectRef]:
        return self._call("cl_task", {
            "func_blob": cloudpickle.dumps(func),
            "args_blob": cloudpickle.dumps((args, kwargs)),
            "opts": opts,
        })["refs"]

    def _serialize_args(self, args: tuple, creation_of=None) -> List[Tuple]:
        """Actor init args cross the wire as inline values/refs; the server
        driver re-serializes them with its own object-store thresholds (and
        pins the refs they hold, `creation_of` unused here)."""
        out: List[Tuple] = []
        for a in args:
            if isinstance(a, ObjectRef):
                out.append(("ref", a.id, a.owner_address))
            else:
                s = serialization.serialize(a)
                out.append(("value", s.to_bytes()))
        return out

    # -------------------------------------------------------------- actors

    def create_actor(self, spec, class_name: str) -> None:
        self._call("cl_actor_create", {"spec": spec, "class_name": class_name})

    def submit_actor_task(self, actor_id: ActorID, method_name: str,
                          args: tuple, kwargs: dict,
                          num_returns: int = 1,
                          concurrency_group: str = None) -> List[ObjectRef]:
        return self._call("cl_actor_task", {
            "actor_id": actor_id,
            "method": method_name,
            "args_blob": cloudpickle.dumps((args, kwargs)),
            "num_returns": num_returns,
            "concurrency_group": concurrency_group,
        })["refs"]

    def get_actor_info(self, actor_id: Optional[ActorID] = None,
                       name: Optional[str] = None, namespace: str = ""):
        return self._call("cl_actor_info", {
            "actor_id": actor_id, "name": name, "namespace": namespace,
        })["info"]

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        self._call("cl_kill_actor",
                   {"actor_id": actor_id, "no_restart": no_restart})


def connect(address: str, connect_timeout: float = 30.0) -> ClientWorker:
    """Connect to a `ray://host:port` client server."""
    return ClientWorker(address, connect_timeout=connect_timeout)
