"""gRPC ingress for Serve (reference `src/ray/protobuf/serve.proto:235`,
`serve/_private/grpc_util.py`).

The reference serves user-defined protobuf services over a gRPC proxy next
to HTTP. This edge exposes the equivalent surface as a GENERIC bytes
service — `/rayserve.Ingress/Predict` (unary) and
`/rayserve.Ingress/PredictStream` (server-streaming) — with the target
deployment/method carried in request metadata, so applications bring any
payload encoding (their own protobufs, JSON, raw tensors) without a
codegen step. Built on grpc.aio inside a dedicated loop thread; request
completion and stream items ride the same ownership-layer callbacks as the
HTTP edge (thread-free, no per-stream parking).

Routing metadata: `deployment` (required), `method` (default `__call__`),
`content-type` (`application/json` decodes the request bytes to a JSON
payload; anything else passes raw bytes through), `timeout-s` (per-request
end-to-end deadline, default `ServeConfig.request_timeout_s`). Responses:
bytes pass through; str encodes utf-8; other values JSON-encode.

Overload robustness mirrors the HTTP edge: the deadline is threaded
through the router into the replica; expiry aborts with
DEADLINE_EXCEEDED, an admission-control shed (typed BackPressureError)
aborts with RESOURCE_EXHAUSTED — both with the typed error name in the
status details.
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Tuple

logger = logging.getLogger(__name__)

# backstop past the request deadline (the router's deadline reaper
# resolves the promise AT the deadline; this only fires if that broke)
_EDGE_GRACE_S = 5.0

SERVICE = "rayserve.Ingress"


def _decode(body: bytes, content_type: str) -> Any:
    if "json" in content_type:
        return json.loads(body) if body else {}
    return body


def _encode(out: Any) -> bytes:
    if isinstance(out, (bytes, bytearray, memoryview)):
        return bytes(out)
    if isinstance(out, str):
        return out.encode()
    return json.dumps({"result": out}).encode()


class GrpcIngress:
    """grpc.aio server on its own loop thread (the HTTP edge's anatomy)."""

    def __init__(self, host: str, port: int, get_handle, get_stream_handle):
        import grpc

        self._get_handle = get_handle
        self._get_stream_handle = get_stream_handle
        self._pool = ThreadPoolExecutor(max_workers=8,
                                        thread_name_prefix="serve-grpc")
        self._loop = asyncio.new_event_loop()
        self.port: int = 0
        started = threading.Event()

        from ray_tpu_torch.serve.edge_util import (
            await_next_stream_item, await_ref, fetch_value)

        async def _abort_typed(context, e: BaseException):
            """Typed status mapping (the HTTP edge's 504/503 analog)."""
            from ray_tpu_torch.serve.edge_util import typed_error_kind

            kind = typed_error_kind(e)
            if kind == "timeout":
                code = grpc.StatusCode.DEADLINE_EXCEEDED
            elif kind == "shed":
                code = grpc.StatusCode.RESOURCE_EXHAUSTED
            elif isinstance(e, ValueError):
                # bad routing/timeout metadata (the HTTP edge's 400)
                code = grpc.StatusCode.INVALID_ARGUMENT
            else:
                raise e
            await context.abort(code, f"{type(e).__name__}: {e}")

        async def predict(request: bytes, context) -> bytes:
            try:
                name, method, payload, deadline_ts, timeout_s = \
                    self._route(request, context)
                ref = await self._submit(self._get_handle(name, method),
                                         payload, deadline_ts)
                await await_ref(self._loop, ref, timeout_s + _EDGE_GRACE_S)
                return _encode(await fetch_value(
                    self._loop, self._pool, ref, timeout_s + _EDGE_GRACE_S))
            except Exception as e:
                await _abort_typed(context, e)

        async def predict_stream(request: bytes, context):
            try:
                name, method, payload, deadline_ts, timeout_s = \
                    self._route(request, context)
                gen = await self._submit(
                    self._get_stream_handle(name, method), payload,
                    deadline_ts)
                while True:
                    remaining = deadline_ts - time.time()
                    if remaining <= 0:
                        from ray_tpu_torch.core.exceptions import \
                            RequestTimeoutError

                        raise RequestTimeoutError(
                            "stream exceeded its request deadline")
                    if not gen._done:
                        await await_next_stream_item(
                            self._loop, gen, remaining + _EDGE_GRACE_S)
                    try:
                        ref = next(gen)
                    except StopIteration:
                        break
                    yield _encode(await fetch_value(
                        self._loop, self._pool, ref,
                        remaining + _EDGE_GRACE_S))
            except Exception as e:
                await _abort_typed(context, e)

        def run() -> None:
            asyncio.set_event_loop(self._loop)

            async def serve() -> None:
                handler = grpc.method_handlers_generic_handler(SERVICE, {
                    "Predict": grpc.unary_unary_rpc_method_handler(predict),
                    "PredictStream": grpc.unary_stream_rpc_method_handler(
                        predict_stream),
                })
                self._server = grpc.aio.server()
                self._server.add_generic_rpc_handlers((handler,))
                self.port = self._server.add_insecure_port(f"{host}:{port}")
                await self._server.start()
                started.set()

            self._loop.run_until_complete(serve())
            self._loop.run_forever()

        self._thread = threading.Thread(target=run, name="serve-grpc-loop",
                                        daemon=True)
        self._thread.start()
        if not started.wait(timeout=10):
            raise RuntimeError("gRPC ingress failed to start")

    # --------------------------------------------------------------- helpers
    @staticmethod
    def _route(request: bytes, context):
        from ray_tpu_torch.serve.config import get_serve_config

        md = dict(context.invocation_metadata())
        name = md.get("deployment")
        if not name:
            raise ValueError("missing 'deployment' metadata")
        method = md.get("method", "__call__")
        payload = _decode(request, md.get("content-type", "application/json"))
        import math

        try:
            timeout_s = float(md.get("timeout-s") or
                              get_serve_config().request_timeout_s)
        except ValueError:
            raise ValueError(f"bad timeout-s metadata: {md.get('timeout-s')!r}")
        if not math.isfinite(timeout_s) or timeout_s <= 0:
            raise ValueError(f"timeout-s must be finite and > 0, "
                             f"got {md.get('timeout-s')!r}")
        return name, method, payload, time.time() + timeout_s, timeout_s

    async def _submit(self, handle, payload, deadline_ts):
        if getattr(handle, "_replicas", None):
            return handle.remote(payload, _deadline_ts=deadline_ts)
        return await self._loop.run_in_executor(
            self._pool,
            lambda: handle.remote(payload, _deadline_ts=deadline_ts))

    def stop(self) -> None:
        async def _shutdown() -> None:
            await self._server.stop(grace=None)
            self._loop.stop()

        try:
            asyncio.run_coroutine_threadsafe(_shutdown(), self._loop)
        except Exception:
            pass
        self._pool.shutdown(wait=False)
