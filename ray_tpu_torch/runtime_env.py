"""RuntimeEnv: per-task/actor environment configuration.

Mirrors the reference's public dataclass
(`python/ray/runtime_env/runtime_env.py`). `env_vars` and `working_dir` are
applied in-process by the executing worker (core/worker.py
`_apply_runtime_env`); `pip` resolves to a cached virtualenv-backed worker
pool on each node (core/runtime_env_manager.py, the equivalent of the
reference's `_private/runtime_env/pip.py` + per-env worker pools in
`src/ray/raylet/worker_pool.cc:1664`). `conda` rides the plugin API
(core/runtime_env_manager.py CondaPlugin; requires a conda binary on
PATH), and third-party plugins register their own fields the same way
(reference `_private/runtime_env/plugin.py`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Union


class RuntimeEnv(dict):
    def __init__(self, *, env_vars: Optional[Dict[str, str]] = None,
                 working_dir: Optional[str] = None,
                 pip: Optional[Union[List[str], Dict]] = None,
                 py_modules: Optional[List[str]] = None,
                 conda: Optional[Union[str, Dict]] = None):
        super().__init__()
        if conda:
            # named env (str) or {"dependencies": [...]} spec; built by the
            # CondaPlugin at worker-pool creation time
            self["conda"] = conda
        if env_vars:
            self["env_vars"] = dict(env_vars)
        if working_dir:
            self["working_dir"] = working_dir
        if py_modules:
            self["py_modules"] = list(py_modules)
        if pip:
            if isinstance(pip, str):
                # requirements.txt path, read client-side like the reference
                with open(pip) as f:
                    pip = [ln.strip() for ln in f
                           if ln.strip() and not ln.startswith("#")]
            self["pip"] = list(pip) if not isinstance(pip, dict) else pip


# ------------------------------------------------- py_modules packaging
# Reference: python/ray/_private/runtime_env/packaging.py — local modules
# zip into content-addressed packages hosted in the control plane KV;
# workers download + extract once per package and prepend to sys.path.

PKG_NS = "runtime_env_packages"


def _zip_module(path: str) -> bytes:
    import io
    import os
    import zipfile

    buf = io.BytesIO()
    base = os.path.basename(os.path.normpath(path))
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        if os.path.isfile(path):
            zf.writestr(zipfile.ZipInfo(base), open(path, "rb").read())
        else:
            for root, dirs, files in os.walk(path):
                dirs.sort()
                for name in sorted(files):
                    if name.endswith(".pyc") or "__pycache__" in root:
                        continue
                    full = os.path.join(root, name)
                    rel = os.path.join(base, os.path.relpath(full, path))
                    # fixed timestamp -> content-addressed hash is stable
                    info = zipfile.ZipInfo(rel)
                    zf.writestr(info, open(full, "rb").read())
    return buf.getvalue()


def upload_py_modules(env: dict, gcs_client) -> dict:
    """Driver-side: replace local py_modules paths with KV package URIs."""
    import hashlib

    mods = env.get("py_modules")
    if not mods or all(isinstance(m, dict) for m in mods):
        return env
    out = []
    for m in mods:
        if isinstance(m, dict):  # already packaged
            out.append(m)
            continue
        blob = _zip_module(m)
        digest = hashlib.sha256(blob).hexdigest()[:32]
        gcs_client.call("kv_put", {
            "namespace": PKG_NS, "key": digest.encode(), "value": blob,
            "overwrite": False})
        out.append({"uri": digest})
    env = dict(env)
    env["py_modules"] = out
    return env


def ensure_py_modules(env: dict, gcs_client, cache_dir: str) -> list:
    """Worker-side: download + extract each package; returns sys.path
    entries to prepend."""
    import io
    import os
    import zipfile

    paths = []
    for m in env.get("py_modules", []):
        uri = m["uri"] if isinstance(m, dict) else m
        target = os.path.join(cache_dir, uri)
        if not os.path.exists(target):
            blob = gcs_client.call(
                "kv_get", {"namespace": PKG_NS, "key": uri.encode()})
            if blob is None:
                raise RuntimeError(f"py_modules package {uri} not found")
            tmp = f"{target}.tmp{os.getpid()}"
            with zipfile.ZipFile(io.BytesIO(bytes(blob))) as zf:
                zf.extractall(tmp)
            try:
                os.replace(tmp, target)
            except OSError:
                pass  # another worker won the race; its copy is identical
        paths.append(target)
    return paths
