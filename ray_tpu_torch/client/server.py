"""Client server: hosts remote drivers for "ray://" clients.

Mirrors the reference's client server/proxier
(`python/ray/util/client/server/proxier.py`): runs inside a process that is
already connected to the cluster as a driver, accepts thin-client
connections, and executes their API calls against the real driver worker.
Per-connection session state pins every ObjectRef a client holds (so the
ownership layer doesn't free it under the client) and tracks actors the
client created; disconnect releases the pins and kills the session's
non-detached actors — the same lifetime a real driver gives them.

Blocking operations (get/wait/task submission) run on a thread pool and
reply asynchronously so one slow client can't stall the RPC loop.
"""

from __future__ import annotations

import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict

from ray_tpu_torch.core import serialization
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.rpc import RpcServer

import cloudpickle

logger = logging.getLogger(__name__)


class _Session:
    """Per-connection state: pinned refs + owned actors."""

    def __init__(self):
        self.refs: Dict[bytes, ObjectRef] = {}
        self.actors: list = []  # (actor_id, detached)
        self.lock = threading.Lock()

    def pin(self, ref: ObjectRef) -> None:
        with self.lock:
            self.refs[ref.id.binary()] = ref

    def pin_all(self, refs) -> None:
        with self.lock:
            for r in refs:
                self.refs[r.id.binary()] = r


class ClientServer:
    """Serve "ray://" clients from an init()'d driver process."""

    def __init__(self, host: str = "0.0.0.0", port: int = 0):
        from ray_tpu_torch.core.api import _global_worker

        self._worker = _global_worker()  # raises if init() wasn't called
        self._pool = ThreadPoolExecutor(max_workers=16,
                                        thread_name_prefix="client-server")
        self._server = RpcServer(host=host, port=port)
        for name in ("put", "get", "wait", "task", "actor_create",
                     "actor_task", "actor_info", "kill_actor", "gcs_call",
                     "release", "ping"):
            self._server.register(f"cl_{name}",
                                  self._make_handler(getattr(self, f"_{name}")))
        self._server.start()

    @property
    def address(self) -> str:
        return self._server.address

    @property
    def port(self) -> int:
        return self._server.port

    def stop(self) -> None:
        self._server.stop()
        self._pool.shutdown(wait=False)

    # ------------------------------------------------------------ plumbing

    def _make_handler(self, fn):
        def handler(conn, req_id, payload):
            if conn.ident is None:
                conn.ident = _Session()
                conn.on_close.append(self._cleanup_session)

            def run():
                try:
                    result = fn(conn.ident, payload or {})
                    conn.reply(req_id, result)
                except BaseException as e:  # ship the typed exception over
                    try:
                        blob = cloudpickle.dumps(e)
                    except Exception:
                        blob = cloudpickle.dumps(RuntimeError(repr(e)))
                    conn.reply(req_id, {"error_blob": blob})

            self._pool.submit(run)
            return RpcServer.DEFERRED

        return handler

    def _cleanup_session(self, conn) -> None:
        session: _Session = conn.ident
        if session is None:
            return
        with session.lock:
            session.refs.clear()
            actors = list(session.actors)
            session.actors.clear()
        for actor_id, detached in actors:
            if not detached:
                try:
                    self._worker.kill_actor(actor_id, True)
                except Exception:
                    pass

    # ------------------------------------------------------------ handlers

    def _ping(self, session, payload):
        w = self._worker
        return {"job_id": w.job_id, "node_id": w.node_id,
                "gcs_address": w.gcs_address}

    def _put(self, session, payload):
        value = serialization.loads(payload["blob"])
        ref = self._worker.put(value)
        session.pin(ref)
        return {"ref": ref}

    def _get(self, session, payload):
        values = self._worker.get(payload["refs"], timeout=payload.get("timeout"))
        return {"blob": serialization.dumps(values)}

    def _wait(self, session, payload):
        ready, not_ready = self._worker.wait(
            payload["refs"], payload["num_returns"], payload.get("timeout"),
            payload.get("fetch_local", True))
        return {"ready": ready, "not_ready": not_ready}

    def _task(self, session, payload):
        func = cloudpickle.loads(payload["func_blob"])
        args, kwargs = cloudpickle.loads(payload["args_blob"])
        refs = self._worker.submit_task(func, args, kwargs, **payload["opts"])
        session.pin_all(refs)
        return {"refs": refs}

    def _actor_create(self, session, payload):
        spec = payload["spec"]
        self._worker.create_actor(spec, class_name=payload["class_name"])
        session.actors.append((spec.actor_id, spec.lifetime == "detached"))
        return {"actor_id": spec.actor_id}

    def _actor_task(self, session, payload):
        args, kwargs = cloudpickle.loads(payload["args_blob"])
        refs = self._worker.submit_actor_task(
            payload["actor_id"], payload["method"], args, kwargs,
            num_returns=payload.get("num_returns", 1),
            concurrency_group=payload.get("concurrency_group"))
        session.pin_all(refs)
        return {"refs": refs}

    def _actor_info(self, session, payload):
        return {"info": self._worker.get_actor_info(**payload)}

    def _kill_actor(self, session, payload):
        self._worker.kill_actor(payload["actor_id"], payload.get("no_restart", True))
        return {}

    def _gcs_call(self, session, payload):
        return {"result": self._worker.gcs.call(payload["method"],
                                                payload.get("payload"))}

    def _release(self, session, payload):
        with session.lock:
            for rid in payload["ref_ids"]:
                session.refs.pop(rid, None)
        return {}


def main(argv=None) -> int:
    """`python -m ray_tpu_torch.client.server [--address GCS] [--port N]` — boot
    (or join) a cluster and serve clients; prints `ray://host:port`."""
    import argparse

    import ray_tpu_torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--address", default=None,
                    help="GCS address to join; omit to boot a head in-process")
    ap.add_argument("--host", default="0.0.0.0", help="bind host")
    ap.add_argument("--port", type=int, default=0,
                    help="bind port (0 = ephemeral)")
    ap.add_argument("--num-cpus", type=int, default=None)
    ap.add_argument("--resources", default=None,
                    help='json dict, e.g. \'{"GPU": 8}\'')
    args = ap.parse_args(argv)

    resources = None
    if args.resources:
        import json

        resources = json.loads(args.resources)
    ray_tpu_torch.init(address=args.address, num_cpus=args.num_cpus,
                       resources=resources)
    server = ClientServer(host=args.host, port=args.port)
    advertise = args.host
    if advertise in ("0.0.0.0", "::"):
        import socket

        try:
            advertise = socket.gethostbyname(socket.gethostname())
        except OSError:
            advertise = "127.0.0.1"
    print(f"ray://{advertise}:{server.port}", flush=True)
    threading.Event().wait()  # serve until killed
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
