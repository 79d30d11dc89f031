"""Asyncio HTTP ingress for Serve (reference `serve/_private/http_proxy.py:250`).

The previous edge was a ThreadingHTTPServer parking one OS thread per
in-flight request on a blocking 60 s `ray_tpu_torch.get`. This proxy is a
stdlib-only asyncio HTTP/1.1 server whose request lifecycle is event-driven
end to end: submission runs on a small executor pool (it can touch sockets),
completion rides the ownership layer's `add_done_callback` (thread-free, the
same mechanism the handle router uses for in-flight accounting), and only
the final value fetch — instant once the object is terminal — touches the
pool again.

Features the reference edge has that the old one lacked:
- raw/binary request bodies (any content type; JSON stays convenient)
- binary/text responses (bytes -> octet-stream, str -> text/plain)
- STREAMING responses: `POST /<deployment>/stream` (or `?stream=1`) iterates
  a num_returns="dynamic" replica generator and relays each item as an HTTP
  chunk as it is produced — token streaming for the LLM engine
  (reference streaming HTTP responses, http_proxy.py + serve handles'
  `options(stream=True)`).
- keep-alive connections.

Overload robustness: every request carries an end-to-end deadline
(`?timeout_s=` query param or `X-Request-Timeout-S` header; default
`ServeConfig.request_timeout_s`) threaded through the router into the
replica. Deadline expiry answers 504 and an admission-control shed — the
router's per-replica in-flight cap, or this proxy's own in-flight cap —
answers 503, both with the typed error name in the JSON body, so a hung or
dying replica can never hold a proxy connection open forever.
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple
from urllib.parse import parse_qsl, urlparse

from ray_tpu_torch.util import tracing

logger = logging.getLogger(__name__)

_MAX_HEADER_BYTES = 64 * 1024
_MAX_BODY_BYTES = 512 * 1024 * 1024
# grace past the request deadline before the edge's own await gives up: the
# router's deadline reaper resolves the promise AT the deadline, so this
# backstop only fires if the promise machinery itself is broken
_EDGE_GRACE_S = 5.0


def _error_payload(e: BaseException) -> bytes:
    """JSON error body with the TYPED name — clients and the storm harness
    key on `type`, not the message."""
    return json.dumps({"error": str(e), "type": type(e).__name__}).encode()


def _error_status(e: BaseException) -> int:
    """Map typed serve errors to HTTP statuses (504 deadline, 503 shed,
    404 unmatched app route, 500 everything else)."""
    from ray_tpu_torch.serve.edge_util import typed_error_kind

    return {"route_not_found": 404, "shed": 503,
            "timeout": 504}.get(typed_error_kind(e), 500)


class _BadRequest(Exception):
    pass


class AsyncHTTPProxy:
    """HTTP/1.1 server on a dedicated asyncio loop thread."""

    def __init__(self, host: str, port: int, get_handle, get_stream_handle):
        """`get_handle(name)` / `get_stream_handle(name)` return Serve
        deployment handles (injected so this module stays import-light)."""
        self._get_handle = get_handle
        self._get_stream_handle = get_stream_handle
        # proxy-level admission control: in-flight requests this edge will
        # hold before shedding with 503 (mutated only on the loop thread)
        self._inflight = 0
        # submissions + ready-object fetches; sized generously because every
        # operation on it is short (submit) or instant (terminal-state get).
        # Streams don't park threads here: item arrival is event-driven
        # (add_dynamic_return_callback), so live-stream count is unbounded.
        self._pool = ThreadPoolExecutor(max_workers=32,
                                        thread_name_prefix="serve-http")
        self._loop = asyncio.new_event_loop()
        self.port: int = 0
        started = threading.Event()

        def run() -> None:
            asyncio.set_event_loop(self._loop)

            async def serve() -> None:
                server = await asyncio.start_server(
                    self._handle_conn, host, port)
                self.port = server.sockets[0].getsockname()[1]
                started.set()

            self._loop.run_until_complete(serve())
            self._loop.run_forever()

        self._thread = threading.Thread(target=run, name="serve-http-loop",
                                        daemon=True)
        self._thread.start()
        if not started.wait(timeout=10):
            raise RuntimeError("HTTP proxy failed to start")

    # ------------------------------------------------------------ request IO
    async def _read_request(self, reader) -> Optional[dict]:
        try:
            line = await reader.readline()
        except (ConnectionError, asyncio.IncompleteReadError):
            return None
        if not line:
            return None
        try:
            method, target, _version = line.decode("latin1").split(None, 2)
        except ValueError:
            raise _BadRequest("malformed request line")
        headers: Dict[str, str] = {}
        total = len(line)
        while True:
            line = await reader.readline()
            total += len(line)
            if total > _MAX_HEADER_BYTES:
                raise _BadRequest("headers too large")
            if line in (b"\r\n", b"\n", b""):
                break
            k, _, v = line.decode("latin1").partition(":")
            headers[k.strip().lower()] = v.strip()
        length = int(headers.get("content-length", 0) or 0)
        if length > _MAX_BODY_BYTES:
            raise _BadRequest("body too large")
        try:
            body = await reader.readexactly(length) if length else b""
        except (ConnectionError, asyncio.IncompleteReadError):
            return None  # client aborted mid-body: routine disconnect
        return {"method": method.upper(), "target": target,
                "headers": headers, "body": body,
                "close": headers.get("connection", "").lower() == "close"}

    @staticmethod
    def _response(status: int, body: bytes, content_type: str,
                  close: bool) -> bytes:
        reason = {200: "OK", 400: "Bad Request", 404: "Not Found",
                  500: "Internal Server Error", 503: "Service Unavailable",
                  504: "Gateway Timeout"}.get(status, "")
        return (f"HTTP/1.1 {status} {reason}\r\n"
                f"Content-Type: {content_type}\r\n"
                f"Content-Length: {len(body)}\r\n"
                f"Connection: {'close' if close else 'keep-alive'}\r\n"
                "\r\n").encode("latin1") + body

    @staticmethod
    def _encode_result(out: Any) -> Tuple[bytes, str]:
        if isinstance(out, (bytes, bytearray, memoryview)):
            return bytes(out), "application/octet-stream"
        if isinstance(out, str):
            return out.encode(), "text/plain; charset=utf-8"
        return json.dumps({"result": out}).encode(), "application/json"

    # ------------------------------------------------------------- lifecycle
    async def _handle_conn(self, reader, writer) -> None:
        try:
            while True:
                try:
                    req = await self._read_request(reader)
                except _BadRequest as e:
                    writer.write(self._response(
                        400, json.dumps({"error": str(e)}).encode(),
                        "application/json", True))
                    await writer.drain()
                    break
                if req is None:
                    break
                try:
                    await self._dispatch(req, writer)
                except (ConnectionError, asyncio.IncompleteReadError):
                    break
                if req["close"]:
                    break
        except Exception:
            logger.exception("http connection failed")
        finally:
            try:
                writer.close()
            except OSError:
                pass

    def _parse_target(self, req: dict):
        """Route `/<deployment>[/<method>]` with `?stream=1` selecting the
        chunked streaming path (the method must return a generator).
        Returns (name, method, payload, stream, subpath, query, timeout_s):
        app-ingress deployments re-route on subpath at dispatch time; the
        per-request deadline comes from `?timeout_s=` / the
        `X-Request-Timeout-S` header, default ServeConfig.request_timeout_s."""
        from ray_tpu_torch.serve.config import get_serve_config

        parsed = urlparse(req["target"])
        parts = [p for p in parsed.path.split("/") if p]
        query = dict(parse_qsl(parsed.query))
        stream = query.pop("stream", "0") in ("1", "true")
        import math

        raw_timeout = (query.pop("timeout_s", None)
                       or req["headers"].get("x-request-timeout-s"))
        try:
            timeout_s = float(raw_timeout) if raw_timeout else \
                get_serve_config().request_timeout_s
        except ValueError:
            raise _BadRequest(f"bad timeout_s: {raw_timeout!r}")
        # NaN passes a naive <= 0 check and poisons the deadline math;
        # inf would park a reaper entry forever
        if not math.isfinite(timeout_s) or timeout_s <= 0:
            raise _BadRequest(f"timeout_s must be finite and > 0, "
                              f"got {raw_timeout!r}")
        if not parts:
            raise _BadRequest("no deployment in path")
        name = parts[0]
        method = parts[1] if len(parts) > 1 else "__call__"
        subpath = "/" + "/".join(parts[1:])
        if req["method"] == "GET":
            payload: Any = query
        else:
            ctype = req["headers"].get("content-type", "application/json")
            if "json" in ctype:
                try:
                    payload = json.loads(req["body"]) if req["body"] else {}
                except ValueError as e:
                    raise _BadRequest(f"bad JSON body: {e}")
            elif ("form-urlencoded" in ctype or ctype.startswith("text/")):
                # clients (urllib!) that omit an explicit JSON content type
                # still overwhelmingly send JSON; fall back to raw on parse
                # failure instead of rejecting
                try:
                    payload = json.loads(req["body"]) if req["body"] else {}
                except ValueError:
                    payload = req["body"]
            else:
                payload = req["body"]  # raw/binary passthrough
        return name, method, payload, stream, subpath, query, timeout_s

    async def _is_app_ingress(self, name: str) -> bool:
        """Whether `name` is an @serve.ingress app deployment. The flag
        stays CURRENT: the one-shot refresh seeds it and the handle's
        push-driven refresher keeps tracking redeploys (a deployment can
        gain or lose its app between versions)."""
        call_handle = self._get_handle(name, "__call__")
        if not hasattr(call_handle, "_app_ingress"):
            await self._loop.run_in_executor(
                self._pool, lambda: call_handle._refresh(block=False))
            call_handle._ensure_refresher()
        return getattr(call_handle, "_app_ingress", False)

    async def _dispatch(self, req: dict, writer) -> None:
        from ray_tpu_torch.core.exceptions import BackPressureError
        from ray_tpu_torch.serve.api import _serve_metrics
        from ray_tpu_torch.serve.config import get_serve_config
        from ray_tpu_torch.serve.edge_util import await_ref, fetch_value

        t0 = time.monotonic()
        try:
            name, method, payload, stream, subpath, query, timeout_s = \
                self._parse_target(req)
        except _BadRequest as e:
            writer.write(self._response(
                400, json.dumps({"error": str(e)}).encode(),
                "application/json", req["close"]))
            await writer.drain()
            return
        deadline_ts = time.time() + timeout_s
        # proxy-level admission control (shed site #1): bound the requests
        # this edge holds open so a storm degrades to fast 503s here
        # before it can exhaust proxy memory/file descriptors
        if self._inflight >= get_serve_config().proxy_max_inflight:
            e = BackPressureError(
                f"proxy at in-flight cap "
                f"({get_serve_config().proxy_max_inflight}); request shed")
            writer.write(self._response(
                503, _error_payload(e), "application/json", req["close"]))
            await writer.drain()
            return
        self._inflight += 1
        # Ingress span roots the request's trace. The ids are minted HERE
        # (explicitly, not via thread-local start_trace): _dispatch is a
        # coroutine, and thread-local context must never span an await — it
        # is adopted only inside the synchronous submit windows below.
        ing_ctx = None
        t_ing = 0.0
        if tracing.enabled():
            ing_ctx = (tracing.new_id(), tracing.new_id())
            t_ing = tracing.now_us()
        # no requests.inc here: the handle's remote() counts it (this
        # process), exactly as the edge always has
        try:
            # app-ingress deployments take the FULL request envelope on
            # __call__ and route the subpath in-replica (serve.ingress)
            app_ingress = await self._is_app_ingress(name)
            if stream:
                if app_ingress:
                    raise _BadRequest(
                        "app-ingress deployments do not support ?stream=1")
                await self._dispatch_stream(name, method, payload, req,
                                            writer, deadline_ts,
                                            trace_ctx=ing_ctx)
            else:
                if app_ingress:
                    method = "__call__"
                    payload = {
                        "method": req["method"], "path": subpath,
                        "query": query,
                        "payload": (None if req["method"] == "GET"
                                    else payload),
                    }
                handle = self._get_handle(name, method)
                if getattr(handle, "_replicas", None):
                    # warm handle: submission is sample + one socket send —
                    # cheaper than a thread hop (synchronous window: the
                    # ingress ctx is safe to adopt, no await inside)
                    with tracing.ctx_scope(ing_ctx):
                        ref = handle.remote(payload,
                                            _deadline_ts=deadline_ts)
                else:
                    def _submit():
                        with tracing.ctx_scope(ing_ctx):
                            return handle.remote(payload,
                                                 _deadline_ts=deadline_ts)
                    ref = await self._loop.run_in_executor(
                        self._pool, _submit)
                # the router's deadline reaper resolves the promise AT the
                # deadline; the edge timeout is only the backstop behind it
                try:
                    await await_ref(self._loop, ref,
                                    timeout_s + _EDGE_GRACE_S)
                    out = await fetch_value(self._loop, self._pool, ref,
                                            timeout_s + _EDGE_GRACE_S)
                    body, ctype = self._encode_result(out)
                    writer.write(self._response(200, body, ctype,
                                                req["close"]))
                    await writer.drain()
                except (ConnectionError, asyncio.CancelledError):
                    # client went away while the request was in flight:
                    # cancel the replica attempt through the router so the
                    # replica stops computing a result nobody will read
                    from ray_tpu_torch.serve.api import cancel_inflight

                    cancel_inflight(ref)
                    raise
        except _BadRequest as e:
            writer.write(self._response(
                400, json.dumps({"error": str(e)}).encode(),
                "application/json", req["close"]))
            await writer.drain()
        except Exception as e:
            _serve_metrics()["errors"].inc(tags={"deployment": name})
            # typed mapping: 504 on deadline expiry, 503 on shed, 404 on
            # unmatched app routes, 500 otherwise — with the error type
            # name in the body (works for both the live exception and its
            # deserialized-from-the-replica form)
            writer.write(self._response(
                _error_status(e), _error_payload(e),
                "application/json", req["close"]))
            await writer.drain()
        finally:
            self._inflight -= 1
            _serve_metrics()["latency"].observe(
                time.monotonic() - t0, tags={"deployment": name})
            if ing_ctx is not None:
                tracing.add_complete(
                    f"ingress::{name}", "serve_ingress",
                    t_ing, tracing.now_us() - t_ing,
                    trace_id=ing_ctx[0], span_id=ing_ctx[1], parent_id="",
                    deployment=name, method=req.get("method", ""))

    async def _dispatch_stream(self, name: str, method: str, payload: Any,
                               req: dict, writer,
                               deadline_ts: Optional[float] = None,
                               trace_ctx=None) -> None:
        """Chunked-encoding relay of a streaming deployment: each object the
        replica's generator yields becomes one HTTP chunk as soon as it is
        reported — tokens reach the client while the model still decodes.
        Item arrival rides the same add_done_callback mechanism as the
        non-streaming path (reference http_proxy.py's async streaming
        model), so there is NO thread-per-live-stream and no stream cap.
        The request deadline bounds the WHOLE stream: when it expires
        mid-stream, a typed error chunk + clean terminator go out instead
        of the connection hanging on a stalled replica."""
        from ray_tpu_torch.serve.config import get_serve_config
        from ray_tpu_torch.serve.edge_util import (
            await_next_stream_item, fetch_value)

        if deadline_ts is None:
            deadline_ts = time.time() + get_serve_config().request_timeout_s

        def _remaining() -> float:
            return max(0.001, deadline_ts - time.time() + _EDGE_GRACE_S)

        # submit BEFORE the 200 goes out: submission failures (no replicas,
        # unknown deployment, back-pressure shed) still produce a clean
        # typed 503/500 via the caller
        handle = self._get_stream_handle(name, method)
        if getattr(handle, "_replicas", None):
            with tracing.ctx_scope(trace_ctx):
                gen = handle.remote(payload, _deadline_ts=deadline_ts)
        else:
            def _submit():
                with tracing.ctx_scope(trace_ctx):
                    return handle.remote(payload, _deadline_ts=deadline_ts)
            gen = await self._loop.run_in_executor(self._pool, _submit)
        writer.write((
            "HTTP/1.1 200 OK\r\n"
            "Content-Type: application/x-ndjson\r\n"
            "Transfer-Encoding: chunked\r\n"
            f"Connection: {'close' if req['close'] else 'keep-alive'}\r\n"
            "\r\n").encode("latin1"))
        await writer.drain()

        # Once chunked 200 headers are out, an HTTP 500 can never follow —
        # writing one mid-body would corrupt framing and desync keep-alive.
        # Errors become a final error chunk + a CLEAN chunk terminator.
        try:
            while True:
                if time.time() >= deadline_ts:
                    from ray_tpu_torch.core.exceptions import RequestTimeoutError

                    raise RequestTimeoutError(
                        "stream exceeded its request deadline")
                if not gen._done:
                    await await_next_stream_item(self._loop, gen,
                                                 _remaining())
                try:
                    ref = next(gen)
                except StopIteration:
                    break
                item = await fetch_value(self._loop, self._pool, ref,
                                         _remaining())
                if isinstance(item, (bytes, bytearray, memoryview)):
                    chunk = bytes(item)
                elif isinstance(item, str):
                    chunk = item.encode()
                else:
                    chunk = json.dumps(item).encode() + b"\n"
                writer.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
                await writer.drain()
        except Exception as e:
            from ray_tpu_torch.serve.api import _serve_metrics

            _serve_metrics()["errors"].inc(tags={"deployment": name})
            err = json.dumps({"error": str(e),
                              "type": type(e).__name__}).encode() + b"\n"
            writer.write(f"{len(err):x}\r\n".encode() + err + b"\r\n")
        writer.write(b"0\r\n\r\n")
        await writer.drain()

    def stop(self) -> None:
        try:
            self._loop.call_soon_threadsafe(self._loop.stop)
        except RuntimeError:
            pass  # loop already closed
        self._pool.shutdown(wait=False)
