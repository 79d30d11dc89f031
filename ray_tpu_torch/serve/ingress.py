"""App ingress: mount a multi-route application on a deployment.

Mirrors the reference's `@serve.ingress(fastapi_app)` (python/ray/serve/
api.py:160): a deployment whose HTTP surface is a ROUTED APP — path
patterns with parameters, per-route HTTP methods, and middleware hooks —
instead of the default `/<deployment>/<method>` convention. The app is a
dependency-free FastAPI-shaped router: `@app.get("/items/{item_id}")`
handlers, `@app.middleware` wrappers, 404s for unmatched routes.

The HTTP edge detects app-mounted deployments through the controller's
replica info and forwards the FULL sub-path request envelope; dispatch
(routing, parameter extraction, middleware) runs IN the replica, so every
replica scales the whole app."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["App", "Request", "RouteNotFound", "ingress"]


class RouteNotFound(Exception):
    """No route matched (the edge maps this to HTTP 404)."""


class Request:
    """The per-request envelope a routed handler receives."""

    __slots__ = ("method", "path", "query", "payload", "path_params",
                 "headers")

    def __init__(self, method: str = "GET", path: str = "/",
                 query: Optional[Dict[str, str]] = None, payload: Any = None,
                 path_params: Optional[Dict[str, str]] = None,
                 headers: Optional[Dict[str, str]] = None):
        self.method = method.upper()
        self.path = path or "/"
        self.query = dict(query or {})
        self.payload = payload
        self.path_params = dict(path_params or {})
        self.headers = dict(headers or {})


def _compile_pattern(path: str) -> List[Tuple[str, str]]:
    """'/items/{item_id}' -> [("lit","items"), ("param","item_id")]."""
    parts = []
    for seg in path.split("/"):
        if not seg:
            continue
        if seg.startswith("{") and seg.endswith("}"):
            parts.append(("param", seg[1:-1]))
        else:
            parts.append(("lit", seg))
    return parts


class App:
    """Route + middleware registry (FastAPI-shaped, stdlib-only)."""

    def __init__(self):
        self._routes: List[Tuple[str, List[Tuple[str, str]], Callable]] = []
        self._middlewares: List[Callable] = []

    # ------------------------------------------------------------ decorators
    def route(self, path: str, methods=("GET", "POST")):
        def deco(fn):
            takes_self = _takes_self(fn)  # once, at registration
            for m in methods:
                self._routes.append(
                    (m.upper(), _compile_pattern(path), fn, takes_self))
            return fn

        return deco

    def get(self, path: str):
        return self.route(path, methods=("GET",))

    def post(self, path: str):
        return self.route(path, methods=("POST",))

    def put(self, path: str):
        return self.route(path, methods=("PUT",))

    def delete(self, path: str):
        return self.route(path, methods=("DELETE",))

    def middleware(self, fn: Callable) -> Callable:
        """`fn(request, call_next) -> response` wrappers, outermost first
        (reference Starlette middleware model)."""
        self._middlewares.append(fn)
        return fn

    # -------------------------------------------------------------- dispatch
    def match(self, method: str, path: str):
        """(handler, path_params, takes_self) or None."""
        segs = [s for s in path.split("/") if s]
        for m, pattern, fn, takes_self in self._routes:
            if m != method.upper() or len(pattern) != len(segs):
                continue
            params: Dict[str, str] = {}
            ok = True
            for (kind, val), seg in zip(pattern, segs):
                if kind == "lit":
                    if val != seg:
                        ok = False
                        break
                else:
                    params[val] = seg
            if ok:
                return fn, params, takes_self
        return None

    def dispatch(self, instance: Any, request: Request) -> Any:
        hit = self.match(request.method, request.path)
        if hit is None:
            raise RouteNotFound(
                f"{request.method} {request.path} matched no route")
        fn, params, takes_self = hit
        request.path_params = params

        def call_handler(req: Request) -> Any:
            if instance is not None and takes_self:
                return fn(instance, req, **req.path_params)
            return fn(req, **req.path_params)

        call = call_handler
        for mw in reversed(self._middlewares):
            call = (lambda req, _mw=mw, _next=call: _mw(req, _next))
        return call(request)


def _takes_self(fn: Callable) -> bool:
    import inspect

    try:
        params = list(inspect.signature(fn).parameters)
    except (TypeError, ValueError):
        return False
    return bool(params) and params[0] == "self"


def ingress(app: App):
    """Class decorator mounting `app` as the deployment's request surface
    (reference serve.ingress, python/ray/serve/api.py:160). The wrapped
    class's `__call__` receives the edge's request envelope and dispatches
    through the app's routes + middleware."""

    def deco(cls):
        if not isinstance(cls, type):
            raise TypeError("serve.ingress decorates a class (put it UNDER "
                            "@serve.deployment)")

        def __call__(self, request: Any) -> Any:
            if not isinstance(request, dict):
                raise TypeError(
                    "app-ingress deployments take the edge's request "
                    "envelope; call them over HTTP or pass a dict like "
                    '{"method": "GET", "path": "/..."}')
            return app.dispatch(self, Request(**request))

        cls.__call__ = __call__
        cls._serve_app = app
        cls._serve_app_ingress = True
        return cls

    return deco
