"""Runtime-env manager: pluggable per-env worker environments.

Equivalent of the reference's runtime-env agent + plugin architecture
(`dashboard/modules/runtime_env/runtime_env_agent.py:161`,
`_private/runtime_env/{plugin,pip,conda}.py`): every runtime-env FIELD that
needs machinery is a PLUGIN — a named unit with a spec normalizer, a
create step (run once per content-addressed key under a cross-process
lock), a context hook (which interpreter / env vars workers get), and a
delete step driven by URI-style reference counts. `pip` (virtualenv) and
`conda` ship built in; third parties register theirs with
`register_plugin` without touching the manager.

Lightweight fields (env_vars, working_dir) are applied in-process by the
worker (`core/worker.py _apply_runtime_env`) and need no plugin.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

_DEFAULT_BASE = os.path.join(tempfile.gettempdir(), "ray_tpu_torch",
                             "runtime_envs")


@dataclass
class EnvContext:
    """What a plugin contributes to worker startup.

    command_prefix wraps the worker's argv (container engines, launchers):
    the raylet runs `command_prefix + [python, -m, worker_main, ...]`.
    A literal "{ENVFILE}" element is replaced at spawn time with the path
    of a KEY=VALUE file holding the worker's environment (how env vars
    cross a container boundary)."""

    python: str = sys.executable
    env_vars: Dict[str, str] = field(default_factory=dict)
    command_prefix: List[str] = field(default_factory=list)


class RuntimeEnvPlugin:
    """One runtime-env field's machinery (reference RuntimeEnvPlugin,
    _private/runtime_env/plugin.py). Subclass and `register_plugin()`.

    name:   the runtime_env dict key this plugin owns (e.g. "pip")
    pooled: True if workers must be pooled per env key (an interpreter or
            sys.path change); False for fields any worker can apply
    """

    name: str = ""
    pooled: bool = True

    def key_spec(self, value: Any) -> Any:
        """Normalized, hashable spec for content addressing."""
        return value

    def create(self, value: Any, env_dir: str) -> None:
        """Build the environment under env_dir (called once per key,
        cross-process locked). Raise on failure."""

    def modify_context(self, value: Any, env_dir: str,
                       ctx: EnvContext) -> None:
        """Point the worker context at the built environment."""

    def delete(self, env_dir: str) -> None:
        """Reclaim the built environment (refcount hit zero)."""
        shutil.rmtree(env_dir, ignore_errors=True)


# ------------------------------------------------------------ registration

_plugins: Dict[str, RuntimeEnvPlugin] = {}
_plugins_lock = threading.Lock()


def register_plugin(plugin: RuntimeEnvPlugin) -> None:
    if not plugin.name:
        raise ValueError("plugin needs a name (the runtime_env key it owns)")
    with _plugins_lock:
        _plugins[plugin.name] = plugin


def unregister_plugin(name: str) -> None:
    with _plugins_lock:
        _plugins.pop(name, None)


def _active_plugins(runtime_env: dict) -> List[RuntimeEnvPlugin]:
    with _plugins_lock:
        plugins = list(_plugins.values())
    return [p for p in plugins if runtime_env.get(p.name)]


# ---------------------------------------------------------------- builtins


class PipPlugin(RuntimeEnvPlugin):
    """Virtualenv-backed pip env (--system-site-packages so jax/numpy
    resolve from the base image, like the reference's pip plugin)."""

    name = "pip"

    def key_spec(self, value):
        return sorted(self._packages(value))

    def _packages(self, value) -> List[str]:
        if isinstance(value, dict):  # {"packages": [...]} form
            value = value.get("packages", [])
        return [str(p) for p in value or []]

    def create(self, value, env_dir: str) -> None:
        import sysconfig

        pip = self._packages(value)
        py = os.path.join(env_dir, "bin", "python")
        logger.info("creating pip runtime env at %s (pip=%s)", env_dir, pip)
        subprocess.run(
            [sys.executable, "-m", "venv", "--system-site-packages", env_dir],
            check=True, capture_output=True)
        # When this process itself runs in a venv, --system-site-packages
        # points at the *base* interpreter, not our parent venv — link the
        # parent's site-packages too (after the env's own dir, so installed
        # packages shadow inherited ones).
        child_purelib = subprocess.run(
            [py, "-c",
             "import sysconfig; print(sysconfig.get_paths()['purelib'])"],
            check=True, capture_output=True, text=True).stdout.strip()
        parent_purelib = sysconfig.get_paths()["purelib"]
        if parent_purelib != child_purelib:
            with open(os.path.join(child_purelib, "_parent_site.pth"),
                      "w") as f:
                f.write(parent_purelib + "\n")
        if pip:
            r = subprocess.run(
                [py, "-m", "pip", "install", "--no-input", *pip],
                capture_output=True, text=True, timeout=600)
            if r.returncode != 0:
                raise RuntimeError(r.stderr[-2000:])

    def modify_context(self, value, env_dir: str, ctx: EnvContext) -> None:
        ctx.python = os.path.join(env_dir, "bin", "python")


class CondaPlugin(RuntimeEnvPlugin):
    """Conda env support (reference _private/runtime_env/conda.py):
    `{"conda": {"dependencies": [...]}}` builds a prefix env;
    `{"conda": "existing-env-name"}` reuses a named env. Requires a conda
    binary on PATH."""

    name = "conda"

    def key_spec(self, value):
        if isinstance(value, str):
            return value
        return json.dumps(value, sort_keys=True)

    @staticmethod
    def _conda() -> str:
        exe = shutil.which("conda") or shutil.which("mamba")
        if exe is None:
            raise RuntimeError(
                "runtime_env 'conda' requires a conda/mamba binary on PATH")
        return exe

    def create(self, value, env_dir: str) -> None:
        import tempfile

        conda = self._conda()
        if isinstance(value, str):
            return  # named env: nothing to build
        deps = list((value or {}).get("dependencies", []))
        spec = {"dependencies": deps or [f"python={sys.version_info.major}."
                                         f"{sys.version_info.minor}"]}
        os.makedirs(os.path.dirname(env_dir), exist_ok=True)
        fd, spec_path = tempfile.mkstemp(suffix=".yaml")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"name": "rtt", **spec}, f)  # yaml-subset JSON
            r = subprocess.run(
                [conda, "env", "create", "-p", env_dir, "-f", spec_path],
                capture_output=True, text=True, timeout=1800)
            if r.returncode != 0:
                raise RuntimeError(r.stderr[-2000:])
        finally:
            os.unlink(spec_path)

    def modify_context(self, value, env_dir: str, ctx: EnvContext) -> None:
        if isinstance(value, str):
            conda_root = os.path.dirname(os.path.dirname(self._conda()))
            py = os.path.join(conda_root, "envs", value, "bin", "python")
            if not os.path.exists(py):
                # validate NOW: a bad named env must fail the queued tasks,
                # not FileNotFoundError the spawn thread later
                raise RuntimeError(
                    f"conda env {value!r} not found (no {py})")
            ctx.python = py
        else:
            ctx.python = os.path.join(env_dir, "bin", "python")


class _PyModulesPlugin(RuntimeEnvPlugin):
    """py_modules mutate sys.path for the worker's lifetime, so workers are
    pooled per package set; the download/sys.path work happens in-worker
    (runtime_env.ensure_py_modules)."""

    name = "py_modules"

    def key_spec(self, value):
        return sorted(str(m.get("uri", m) if isinstance(m, dict) else m)
                      for m in value or [])


def build_container_command(spec: dict, *, engine: str,
                            pkg_root: Optional[str] = None,
                            base_dir: str = _DEFAULT_BASE) -> List[str]:
    """Assemble the `docker|podman run` prefix that wraps a worker
    (reference python/ray/_private/runtime_env/container.py
    `get_container_option` → worker command wrapping). Pure function so
    request shape is unit-testable without a container daemon.

    The container shares the host network (raylet/GCS run on host TCP
    ports), the shared-memory arena (/dev/shm bind mount), the runtime-env
    base dir (session artifacts), and a read-only mount of the framework
    source; the worker env crosses the boundary via --env-file (the
    "{ENVFILE}" placeholder is materialized at spawn)."""
    image = spec.get("image")
    if not image:
        raise ValueError("container runtime_env needs an 'image'")
    if pkg_root is None:
        import ray_tpu_torch

        pkg_root = os.path.dirname(
            os.path.dirname(os.path.abspath(ray_tpu_torch.__file__)))
    cmd = [engine, "run", "--rm", "--network=host",
           "-v", "/dev/shm:/dev/shm",
           "-v", f"{base_dir}:{base_dir}",
           "-v", f"{pkg_root}:{pkg_root}:ro",
           "--env-file", "{ENVFILE}"]
    cmd += [str(o) for o in spec.get("run_options", [])]
    cmd.append(image)
    return cmd


class ContainerPlugin(RuntimeEnvPlugin):
    """`{"container": {"image": ..., "run_options": [...], "engine": ...,
    "python": ...}}` runs the worker inside a container (reference
    `python/ray/_private/runtime_env/container.py`). Requires docker or
    podman on PATH at create time; `python` names the interpreter INSIDE
    the image (default python3)."""

    name = "container"

    @staticmethod
    def _norm(value) -> dict:
        if isinstance(value, str):
            return {"image": value}
        return dict(value or {})

    def key_spec(self, value):
        return json.dumps(self._norm(value), sort_keys=True)

    @staticmethod
    def _engine(spec: dict) -> str:
        eng = spec.get("engine")
        if eng:
            if shutil.which(eng) is None:
                raise RuntimeError(
                    f"container engine {eng!r} not found on PATH")
            return eng
        for cand in ("podman", "docker"):
            if shutil.which(cand):
                return cand
        raise RuntimeError(
            "runtime_env 'container' requires docker or podman on PATH")

    def create(self, value, env_dir: str) -> None:
        spec = self._norm(value)
        if not spec.get("image"):
            raise RuntimeError("container runtime_env needs an 'image'")
        self._engine(spec)  # fail fast where no container runtime exists
        os.makedirs(env_dir, exist_ok=True)

    def modify_context(self, value, env_dir: str, ctx: EnvContext) -> None:
        spec = self._norm(value)
        ctx.command_prefix = build_container_command(
            spec, engine=self._engine(spec))
        # the interpreter path must resolve INSIDE the image
        ctx.python = spec.get("python", "python3")


register_plugin(PipPlugin())
register_plugin(CondaPlugin())
register_plugin(_PyModulesPlugin())
register_plugin(ContainerPlugin())


# ------------------------------------------------------------------- keys


def env_key(runtime_env: Optional[dict]) -> Optional[str]:
    """Stable key for envs that need a dedicated worker pool; None when any
    worker can run the task after in-process env application."""
    if not runtime_env:
        return None
    active = [p for p in _active_plugins(runtime_env) if p.pooled]
    if not active:
        return None
    spec = {p.name: p.key_spec(runtime_env[p.name]) for p in active}
    return hashlib.sha1(
        json.dumps(spec, sort_keys=True).encode()).hexdigest()[:16]


class RuntimeEnvManager:
    """Creates, caches, refcounts and deletes plugin-built environments;
    thread-safe, one creation per key (cross-process file lock)."""

    def __init__(self, base_dir: str = _DEFAULT_BASE):
        self.base_dir = base_dir
        self._lock = threading.Lock()
        self._locks: Dict[str, threading.Lock] = {}
        self._failed: Dict[str, str] = {}
        self._refs: Dict[str, int] = {}  # URI-style env refcounts
        self._zero_since: Dict[str, float] = {}  # key -> t at refcount 0

    def _key_lock(self, key: str) -> threading.Lock:
        with self._lock:
            return self._locks.setdefault(key, threading.Lock())

    def creation_error(self, key: str) -> Optional[str]:
        return self._failed.get(key)

    # ---------------------------------------------------------- refcounts
    # Counts are kept BOTH in-process (fast) and in an on-disk counter file
    # mutated under the key's cross-process flock: the base dir is shared
    # across raylets on a host, and a gc() in one process must never delete
    # an env another raylet's live workers run from.

    def _refs_path(self, key: str) -> str:
        return os.path.join(self.base_dir, f".{key}.refs")

    def _bump_disk_refs(self, key: str, delta: int) -> int:
        import fcntl

        os.makedirs(self.base_dir, exist_ok=True)
        with open(os.path.join(self.base_dir, f".{key}.lock"), "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            try:
                try:
                    with open(self._refs_path(key)) as f:
                        n = int(f.read().strip() or 0)
                except (FileNotFoundError, ValueError):
                    n = 0
                n = max(0, n + delta)
                with open(self._refs_path(key), "w") as f:
                    f.write(str(n))
                return n
            finally:
                fcntl.flock(lk, fcntl.LOCK_UN)

    def acquire(self, key: str) -> None:
        """One more worker serves this env (reference URI refcounting,
        runtime_env_agent URI cache)."""
        with self._lock:
            self._refs[key] = self._refs.get(key, 0) + 1
            self._zero_since.pop(key, None)
        self._bump_disk_refs(key, +1)

    def release(self, key: str) -> int:
        """A worker for this env exited; returns the remaining local count.
        Envs at zero (here AND on disk) become gc-eligible after an idle
        grace period."""
        with self._lock:
            n = max(0, self._refs.get(key, 0) - 1)
            self._refs[key] = n
            if n == 0:
                self._zero_since[key] = time.monotonic()
        self._bump_disk_refs(key, -1)
        return n

    def gc(self, min_idle_s: float = 0.0) -> List[str]:
        """Delete built envs unreferenced (cross-process) for at least
        min_idle_s; returns deleted keys. An instant-delete-at-zero would
        churn envs that the next task reuses, so callers pass a grace."""
        import fcntl

        now = time.monotonic()
        with self._lock:
            dead = [k for k, n in self._refs.items()
                    if n == 0 and now - self._zero_since.get(k, now) >= min_idle_s]
        deleted = []
        for key in dead:
            with self._key_lock(key):
                env_dir = os.path.join(self.base_dir, key)
                if not os.path.exists(env_dir):
                    continue
                with open(os.path.join(self.base_dir, f".{key}.lock"),
                          "w") as lk:
                    fcntl.flock(lk, fcntl.LOCK_EX)
                    try:
                        try:
                            with open(self._refs_path(key)) as f:
                                disk_refs = int(f.read().strip() or 0)
                        except (FileNotFoundError, ValueError):
                            disk_refs = 0
                        with self._lock:
                            local = self._refs.get(key, 0)
                        if disk_refs > 0 or local > 0:
                            continue  # another raylet (or a racing
                            # acquire) still serves this env
                        for plugin in list(_plugins.values()):
                            marker = os.path.join(env_dir,
                                                  f".built.{plugin.name}")
                            if os.path.exists(marker):
                                try:
                                    plugin.delete(env_dir)
                                except Exception:
                                    logger.exception("env delete failed: %s",
                                                     key)
                        shutil.rmtree(env_dir, ignore_errors=True)
                        try:
                            os.unlink(self._refs_path(key))
                        except FileNotFoundError:
                            pass
                        deleted.append(key)
                    finally:
                        fcntl.flock(lk, fcntl.LOCK_UN)
        with self._lock:
            for key in deleted:
                self._refs.pop(key, None)
                self._zero_since.pop(key, None)
        return deleted

    # ------------------------------------------------------------- create
    def python_for(self, runtime_env: dict) -> str:
        """Blocking: the env's python executable (see context_for)."""
        return self.context_for(runtime_env).python

    def context_for(self, runtime_env: dict) -> EnvContext:
        """Blocking: the full worker context (interpreter + plugin env
        vars), running every active plugin's create step on first use.
        Raises RuntimeError on (possibly cached) failure."""
        import fcntl

        key = env_key(runtime_env)
        assert key is not None
        if runtime_env.get("pip") and runtime_env.get("conda"):
            # both want to own the interpreter; the reference rejects the
            # combination too
            raise RuntimeError(
                "runtime_env 'pip' and 'conda' are mutually exclusive "
                "(put pip packages inside the conda dependencies instead)")
        if runtime_env.get("container") and (runtime_env.get("pip")
                                             or runtime_env.get("conda")):
            raise RuntimeError(
                "runtime_env 'container' cannot be combined with "
                "'pip'/'conda' — bake the packages into the image "
                "(the reference imposes the same constraint)")
        active = [p for p in _active_plugins(runtime_env) if p.pooled]

        def contexts(env_dir: str) -> EnvContext:
            ctx = EnvContext()
            for p in active:
                try:
                    p.modify_context(runtime_env[p.name], env_dir, ctx)
                except Exception as e:
                    # cache: a broken context is as fatal as a failed build
                    msg = f"runtime env context failed ({p.name}): {e}"
                    self._failed[key] = msg
                    raise RuntimeError(msg) from None
            return ctx

        with self._key_lock(key):
            if key in self._failed:
                raise RuntimeError(self._failed[key])
            env_dir = os.path.join(self.base_dir, key)
            ready = os.path.join(env_dir, ".ready")
            if os.path.exists(ready):
                return contexts(env_dir)
            # cross-process lock: multiple raylets (in-process Cluster or
            # co-hosted nodes) share the base dir — exactly one builds the
            # env, the rest wait and reuse it
            os.makedirs(self.base_dir, exist_ok=True)
            with open(os.path.join(self.base_dir, f".{key}.lock"), "w") as lk:
                fcntl.flock(lk, fcntl.LOCK_EX)
                try:
                    if not os.path.exists(ready):
                        for p in active:
                            try:
                                p.create(runtime_env[p.name], env_dir)
                            except Exception as e:
                                msg = (f"runtime env creation failed "
                                       f"({p.name}): {e}")
                                self._failed[key] = msg
                                raise RuntimeError(msg) from None
                            os.makedirs(env_dir, exist_ok=True)
                            with open(os.path.join(
                                    env_dir, f".built.{p.name}"), "w"):
                                pass
                        with open(ready, "w") as f:
                            f.write(json.dumps(
                                {p.name: True for p in active}))
                    return contexts(env_dir)
                finally:
                    fcntl.flock(lk, fcntl.LOCK_UN)