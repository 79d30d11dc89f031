"""Serve configuration: runtime robustness knobs + declarative deploy.

Runtime knobs (`ServeConfig`): the serving plane's overload/robustness
parameters — end-to-end request deadline, admission-control caps, the
failover retry budget, and the replica drain deadline. Env-overridable per
process as `RAY_TPU_TORCH_SERVE_<NAME>` (the core `Config` pattern), so the
controller/proxy/replica worker processes a raylet spawns inherit
overrides naturally.

Declarative deploy (reference `python/ray/serve/schema.py` + `serve
deploy` in `python/ray/serve/scripts.py`), YAML or JSON:

    applications:
      - name: my_app              # optional; defaults to the root deployment
        import_path: pkg.mod:app  # module attr holding a (bound) Deployment
        deployments:              # optional per-deployment overrides
          - name: Model
            num_replicas: 3

`deploy_config_file` imports each application's root deployment, applies
overrides, and `serve.run`s it.
"""

from __future__ import annotations

import importlib
import os
from dataclasses import dataclass, fields
from typing import Any, Dict, List

from ray_tpu_torch.serve import api as serve_api


@dataclass
class ServeConfig:
    """Serve-plane robustness knobs (reference: serve's
    `request_timeout_s` / `max_queued_requests` / drain semantics)."""

    # Default end-to-end deadline for a serve request (ingress parse ->
    # replica completion). Every request carries a deadline: expired ones
    # resolve with a typed RequestTimeoutError instead of hanging.
    request_timeout_s: float = 60.0
    # Rolling-update / downscale drain: a displaced replica keeps serving
    # its in-flight requests until idle, killed unconditionally after this
    # deadline. (Was a hardcoded 30.0 in the rolling-update path.)
    drain_deadline_s: float = 30.0
    # Admission control at the router: a replica with this many in-flight
    # requests (tracked client-side, the same counts power-of-two routing
    # uses) stops being eligible; when EVERY replica is at the cap the
    # request is shed with a typed BackPressureError (HTTP 503).
    max_queue_per_replica: int = 32
    # Admission control at the ingress: concurrent in-flight requests one
    # proxy will hold before shedding (bounds proxy memory under a storm).
    proxy_max_inflight: int = 2048
    # Mid-request failover: how many times the router re-routes an
    # idempotent request after a replica death / severed replica link
    # before surfacing the typed error. 0 disables failover.
    request_retry_budget: int = 2
    # Full-jitter backoff between failover attempts (util/backoff.py).
    retry_backoff_base_ms: float = 20.0
    retry_backoff_cap_ms: float = 500.0

    def __post_init__(self):
        for f in fields(self):
            env = os.environ.get(f"RAY_TPU_TORCH_SERVE_{f.name.upper()}")
            if env is not None:
                typ = type(getattr(self, f.name))
                setattr(self, f.name,
                        typ(env) if typ is not bool
                        else env.lower() in ("1", "true", "yes", "on"))


_serve_config: ServeConfig | None = None


def get_serve_config() -> ServeConfig:
    global _serve_config
    if _serve_config is None:
        _serve_config = ServeConfig()
    return _serve_config


def set_serve_config(**overrides) -> ServeConfig:
    """In-process overrides (tests, embedded drivers). Worker processes
    read env (`RAY_TPU_TORCH_SERVE_*`) instead — set those before `init()` so
    spawned controller/replica/proxy processes inherit them."""
    cfg = get_serve_config()
    for k, v in overrides.items():
        if not hasattr(cfg, k):
            raise ValueError(f"unknown serve config field {k!r}")
        setattr(cfg, k, v)
    return cfg


def reset_serve_config() -> None:
    global _serve_config
    _serve_config = None


def load_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    if not isinstance(cfg, dict) or "applications" not in cfg:
        raise ValueError(f"{path}: expected a mapping with 'applications'")
    return cfg


def _import_target(import_path: str) -> serve_api.Deployment:
    if ":" not in import_path:
        raise ValueError(
            f"import_path {import_path!r} must be 'module.path:attribute'")
    mod_name, attr = import_path.split(":", 1)
    target = getattr(importlib.import_module(mod_name), attr)
    if not isinstance(target, serve_api.Deployment):
        raise TypeError(f"{import_path} is {type(target)}, not a Deployment")
    return target


def _apply_overrides(root: serve_api.Deployment,
                     overrides: List[Dict[str, Any]]) -> serve_api.Deployment:
    by_name = {o["name"]: {k: v for k, v in o.items() if k != "name"}
               for o in overrides}
    # memoized by identity: a diamond graph's shared node must stay one
    # object, or serve.run sees two same-named deployments and rejects it
    rewritten: Dict[int, serve_api.Deployment] = {}
    in_progress: set = set()

    def rewrite(d: serve_api.Deployment) -> serve_api.Deployment:
        if id(d) in rewritten:
            return rewritten[id(d)]
        if id(d) in in_progress:
            raise ValueError(f"deployment graph has a cycle at {d.name!r}")
        in_progress.add(id(d))
        new_args = tuple(rewrite(a) if isinstance(a, serve_api.Deployment)
                         else a for a in d.init_args)
        new_kwargs = {k: rewrite(v) if isinstance(v, serve_api.Deployment)
                      else v for k, v in (d.init_kwargs or {}).items()} or None
        out = d.options(init_args=new_args, init_kwargs=new_kwargs)
        if out.name in by_name:
            out = out.options(**by_name[out.name])
        in_progress.discard(id(d))
        rewritten[id(d)] = out
        return out

    return rewrite(root)


def deploy_config(cfg: Dict[str, Any]) -> Dict[str, str]:
    """Deploy every application in an in-memory config dict (the REST
    `PUT /api/serve/applications` body — reference `serve deploy` REST
    mode); returns {app_name: root deployment name}."""
    if not isinstance(cfg, dict) or "applications" not in cfg:
        raise ValueError("expected a mapping with 'applications'")
    deployed: Dict[str, str] = {}
    for app in cfg["applications"]:
        root = _import_target(app["import_path"])
        if app.get("deployments"):
            root = _apply_overrides(root, app["deployments"])
        serve_api.run(root, name=app.get("name", root.name))
        deployed[app.get("name", root.name)] = root.name
    return deployed


def deploy_config_file(path: str) -> Dict[str, Any]:
    """Deploy every application in the config file; returns {app_name: root}."""
    return deploy_config(load_config(path))
