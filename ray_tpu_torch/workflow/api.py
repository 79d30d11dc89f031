"""Workflows: durable DAG execution with storage-backed step checkpoints.

Mirrors the reference workflow library's capability
(`python/ray/workflow/workflow_executor.py`, `workflow_storage.py`,
`event_listener.py`): every step's result is persisted under the
workflow's storage directory before dependents run, so a crashed/cancelled
workflow `resume()`s from the last completed step instead of recomputing.
INDEPENDENT steps execute concurrently (one in-flight task per ready DAG
node, like the reference executor's dag-level parallelism), steps can
block on DURABLE EVENTS (`wait_for_event` / `send_event` — delivery is
persisted, so an event received before a crash survives the resume), and
workflows are manageable: `cancel`, `get_output`, `delete`, `get_status`,
`list_all`.

    @workflow.step
    def add(a, b): return a + b

    out = workflow.run(add.step(add.step(1, 2), 3), workflow_id="w1",
                       storage="/tmp/wf")
"""

from __future__ import annotations

import hashlib
import json
import os
import pickle
import time
from typing import Any, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.core.exceptions import TaskCancelledError

_DEFAULT_STORAGE = os.path.join(
    os.environ.get("RAY_TPU_TORCH_WORKFLOW_STORAGE",
                   os.path.expanduser("~/.ray_tpu_torch/workflows")))


class WorkflowStep:
    """A lazy step invocation (node in the workflow DAG)."""

    def __init__(self, fn, args, kwargs, name: Optional[str] = None,
                 max_retries: int = 0):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.name = name or fn.__name__
        self.max_retries = max_retries

    def step_id(self) -> str:
        """Deterministic id from the step's position in the DAG."""
        h = hashlib.blake2b(digest_size=8)
        h.update(self.name.encode())
        for a in self.args:
            h.update(a.step_id().encode() if isinstance(a, WorkflowStep)
                     else repr(a).encode())
        for k, v in sorted(self.kwargs.items()):
            h.update(k.encode())
            h.update(v.step_id().encode() if isinstance(v, WorkflowStep)
                     else repr(v).encode())
        return f"{self.name}-{h.hexdigest()}"


class WorkflowCancelledError(TaskCancelledError, RuntimeError):
    """The workflow was cancelled (workflow.cancel) mid-execution.

    A subclass of the runtime's typed TaskCancelledError: callers that
    match cancellation BY TYPE (the job storm, generic task supervisors)
    catch workflow cancellation the same way; RuntimeError is kept as a
    base for pre-existing handlers."""


class EventStep(WorkflowStep):
    """A DAG node that becomes ready when a named DURABLE event arrives
    (reference workflow events, `python/ray/workflow/event_listener.py`):
    `send_event` persists the payload under the workflow's storage, so an
    event delivered before a crash is still there after resume()."""

    def __init__(self, event_name: str):
        super().__init__(fn=None, args=(), kwargs={},
                         name=f"event::{event_name}")
        self.event_name = event_name

    def step_id(self) -> str:
        return f"event-{self.event_name}"


def wait_for_event(event_name: str) -> EventStep:
    """A step whose value is the event's payload; dependents run only
    after `send_event(workflow_id, event_name, ...)`."""
    return EventStep(event_name)


def send_event(workflow_id: str, event_name: str, payload=None, *,
               storage: Optional[str] = None, create: bool = False) -> None:
    """Deliver (and persist) an event. The workflow must EXIST — a typo'd
    id errors instead of silently minting a ghost directory — unless
    create=True, the explicit pre-delivery form for events that arrive
    before the workflow starts (delivery is durable either way)."""
    st = _Storage(storage or _DEFAULT_STORAGE, workflow_id, create=create)
    if not st.exists():
        raise ValueError(f"no workflow {workflow_id!r} under storage "
                         "(send_event(..., create=True) pre-delivers)")
    st.save_event(event_name, payload)


class _StepBuilder:
    def __init__(self, fn, **opts):
        self.fn = fn
        self.opts = opts

    def step(self, *args, **kwargs) -> WorkflowStep:
        return WorkflowStep(self.fn, args, kwargs, **self.opts)

    def options(self, **opts) -> "_StepBuilder":
        merged = dict(self.opts)
        merged.update(opts)
        return _StepBuilder(self.fn, **merged)


def step(fn=None, *, name: Optional[str] = None, max_retries: int = 0):
    """Decorator: `@workflow.step` (reference workflow step API)."""
    if fn is not None:
        return _StepBuilder(fn)

    def deco(f):
        return _StepBuilder(f, name=name, max_retries=max_retries)

    return deco


# ------------------------------------------------------------------ storage


class _Storage:
    def __init__(self, root: str, workflow_id: str, create: bool = False):
        """create=False (read/manage paths) must not resurrect deleted
        workflows or mint ghost dirs for typo'd ids."""
        self.dir = os.path.join(root, workflow_id)
        if create:
            os.makedirs(os.path.join(self.dir, "steps"), exist_ok=True)

    def exists(self) -> bool:
        return os.path.isdir(self.dir)

    def _path(self, step_id: str) -> str:
        return os.path.join(self.dir, "steps", step_id + ".pkl")

    def has(self, step_id: str) -> bool:
        return os.path.exists(self._path(step_id))

    def load(self, step_id: str):
        with open(self._path(step_id), "rb") as f:
            return pickle.load(f)

    def save(self, step_id: str, value) -> None:
        tmp = self._path(step_id) + ".tmp"
        with open(tmp, "wb") as f:
            cloudpickle.dump(value, f)
        os.replace(tmp, self._path(step_id))

    def set_meta(self, **kv) -> None:
        path = os.path.join(self.dir, "meta.json")
        meta = {}
        if os.path.exists(path):
            with open(path) as f:
                meta = json.load(f)
        meta.update(kv)
        with open(path, "w") as f:
            json.dump(meta, f)

    def get_meta(self) -> dict:
        path = os.path.join(self.dir, "meta.json")
        if not os.path.exists(path):
            return {}
        with open(path) as f:
            return json.load(f)

    def save_dag(self, root_step: WorkflowStep) -> None:
        with open(os.path.join(self.dir, "dag.pkl"), "wb") as f:
            cloudpickle.dump(root_step, f)

    def load_dag(self) -> WorkflowStep:
        with open(os.path.join(self.dir, "dag.pkl"), "rb") as f:
            return pickle.load(f)

    def _event_path(self, name: str) -> str:
        return os.path.join(self.dir, "events", name + ".pkl")

    def save_event(self, name: str, payload) -> None:
        os.makedirs(os.path.join(self.dir, "events"), exist_ok=True)
        tmp = self._event_path(name) + ".tmp"
        with open(tmp, "wb") as f:
            cloudpickle.dump(payload, f)
        os.replace(tmp, self._event_path(name))

    def has_event(self, name: str) -> bool:
        return os.path.exists(self._event_path(name))

    def load_event(self, name: str):
        with open(self._event_path(name), "rb") as f:
            return pickle.load(f)


# ---------------------------------------------------------------- executor


@ray_tpu_torch.remote
def _run_step(fn_blob: bytes, args, kwargs):
    fn = cloudpickle.loads(fn_blob)
    return fn(*args, **kwargs)


def _execute(root: WorkflowStep, storage: _Storage):
    """Topological executor: every READY node (deps persisted) runs as its
    own in-flight task, so independent DAG branches execute CONCURRENTLY
    (reference workflow_executor dag parallelism); results persist before
    dependents become ready. Event steps become ready when their event
    file exists; cancel() flips the persisted status and the loop raises.
    """
    nodes: Dict[str, WorkflowStep] = {}
    deps: Dict[str, List[str]] = {}

    def visit(n: WorkflowStep) -> str:
        sid = n.step_id()
        if sid in nodes:
            return sid
        nodes[sid] = n
        child_ids = [visit(a) for a in n.args if isinstance(a, WorkflowStep)]
        child_ids += [visit(v) for v in n.kwargs.values()
                      if isinstance(v, WorkflowStep)]
        deps[sid] = child_ids
        return sid

    root_id = visit(root)
    results: Dict[str, Any] = {
        sid: storage.load(sid) for sid in nodes if storage.has(sid)}
    attempts_left = {sid: nodes[sid].max_retries for sid in nodes}
    inflight: Dict[Any, str] = {}  # result ref -> step id
    last_exc: Optional[Exception] = None

    def resolved(v):
        return results[v.step_id()] if isinstance(v, WorkflowStep) else v

    while root_id not in results:
        if storage.get_meta().get("status") == "CANCELED":
            # drain ALREADY-FINISHED in-flight steps so their results
            # persist for a later resume, then CANCEL the rest through the
            # runtime's real cancel (their refs resolve to the typed
            # TaskCancelledError instead of running to completion)
            if inflight:
                done, running = ray_tpu_torch.wait(list(inflight),
                                             num_returns=len(inflight),
                                             timeout=5.0)
                for ref in done:
                    sid = inflight.pop(ref)
                    try:
                        value = ray_tpu_torch.get(ref)
                    except Exception:
                        continue
                    storage.save(sid, value)
                    results[sid] = value
                for ref in running:
                    try:
                        ray_tpu_torch.cancel(ref)
                    except Exception:
                        pass  # best-effort: the step re-runs on resume()
            raise WorkflowCancelledError(
                f"workflow cancelled with {len(results)}/{len(nodes)} "
                f"steps complete")
        launched = False
        for sid, n in nodes.items():
            if (sid in results or sid in inflight.values()
                    or any(d not in results for d in deps[sid])):
                continue
            if isinstance(n, EventStep):
                if storage.has_event(n.event_name):
                    value = storage.load_event(n.event_name)
                    storage.save(sid, value)
                    results[sid] = value
                    launched = True
                continue  # not delivered yet: poll next loop
            args = [resolved(a) for a in n.args]
            kwargs = {k: resolved(v) for k, v in n.kwargs.items()}
            ref = _run_step.remote(cloudpickle.dumps(n.fn), args, kwargs)
            inflight[ref] = sid
            launched = True
        if root_id in results:
            break
        if not inflight:
            if launched:
                continue
            if any(isinstance(nodes[s], EventStep) for s in nodes
                   if s not in results):
                time.sleep(0.2)  # waiting purely on external events
                continue
            raise last_exc or RuntimeError("workflow made no progress")
        done, _ = ray_tpu_torch.wait(list(inflight), num_returns=1, timeout=1.0)
        for ref in done:
            sid = inflight.pop(ref)
            try:
                value = ray_tpu_torch.get(ref)
            except Exception as e:
                if attempts_left[sid] > 0:
                    attempts_left[sid] -= 1
                    last_exc = e
                    continue  # becomes ready again next loop
                raise
            storage.save(sid, value)
            results[sid] = value
    return results[root_id]


def _run_to_completion(st: _Storage, root: WorkflowStep):
    """Shared status-transition policy for run()/resume()."""
    st.set_meta(status="RUNNING")
    try:
        out = _execute(root, st)
        st.set_meta(status="SUCCEEDED", end_time=time.time())
        return out
    except WorkflowCancelledError as e:
        # status already CANCELED (don't overwrite with FAILED) — but
        # RECORD the typed error so get_status/list_all surface why
        st.set_meta(error=str(e), end_time=time.time())
        raise
    except Exception as e:
        st.set_meta(status="FAILED", error=str(e), end_time=time.time())
        raise


def run(root: WorkflowStep, *, workflow_id: Optional[str] = None,
        storage: Optional[str] = None):
    workflow_id = workflow_id or f"wf-{int(time.time() * 1000)}"
    st = _Storage(storage or _DEFAULT_STORAGE, workflow_id, create=True)
    if st.get_meta().get("status") == "CANCELED":
        # a cancel that landed before the (async) driver started must
        # stick; resume() is the explicit un-cancel path
        raise WorkflowCancelledError(
            f"workflow {workflow_id!r} was cancelled before it started")
    st.save_dag(root)
    st.set_meta(start_time=time.time())
    return _run_to_completion(st, root)


def run_async(root: WorkflowStep, *, workflow_id: Optional[str] = None,
              storage: Optional[str] = None):
    """Run in a background task; returns an ObjectRef of the result."""

    @ray_tpu_torch.remote
    def driver(blob, wf_id, storage_root):
        from ray_tpu_torch.workflow import api as wf_api

        node = cloudpickle.loads(blob)
        return wf_api.run(node, workflow_id=wf_id, storage=storage_root)

    return driver.remote(cloudpickle.dumps(root),
                         workflow_id or f"wf-{int(time.time() * 1000)}",
                         storage or _DEFAULT_STORAGE)


def resume(workflow_id: str, *, storage: Optional[str] = None):
    """Resume from persisted step results (completed steps are not re-run)."""
    st = _Storage(storage or _DEFAULT_STORAGE, workflow_id)
    if not st.exists():
        raise ValueError(f"no workflow {workflow_id!r} under storage")
    root = st.load_dag()
    return _run_to_completion(st, root)


def get_status(workflow_id: str, *, storage: Optional[str] = None) -> Optional[str]:
    st = _Storage(storage or _DEFAULT_STORAGE, workflow_id)
    return st.get_meta().get("status")


def cancel(workflow_id: str, *, storage: Optional[str] = None) -> None:
    """Cancel a running workflow (reference workflow.cancel): the executor
    observes the persisted status flip, drains finished in-flight steps
    (their results persist for a later resume()), and stops launching new
    ones; steps already running on workers run to completion."""
    st = _Storage(storage or _DEFAULT_STORAGE, workflow_id)
    if not st.exists():
        raise ValueError(f"no workflow {workflow_id!r} under storage")
    st.set_meta(status="CANCELED", end_time=time.time())


def get_output(workflow_id: str, *, storage: Optional[str] = None):
    """Result of a SUCCEEDED workflow from storage (reference
    workflow.get_output), without re-running anything."""
    st = _Storage(storage or _DEFAULT_STORAGE, workflow_id)
    meta = st.get_meta()
    if meta.get("status") != "SUCCEEDED":
        raise ValueError(
            f"workflow {workflow_id!r} is {meta.get('status')!r}, "
            "not SUCCEEDED; resume() it first")
    root = st.load_dag()
    return st.load(root.step_id())


def delete(workflow_id: str, *, storage: Optional[str] = None) -> None:
    """Remove a workflow's storage (reference workflow.delete)."""
    import shutil

    st = _Storage(storage or _DEFAULT_STORAGE, workflow_id)
    shutil.rmtree(st.dir, ignore_errors=True)


def list_all(storage: Optional[str] = None) -> List[Dict[str, Any]]:
    root = storage or _DEFAULT_STORAGE
    out = []
    if not os.path.isdir(root):
        return out
    for wf_id in sorted(os.listdir(root)):
        st = _Storage(root, wf_id)
        meta = st.get_meta()
        out.append({"workflow_id": wf_id, **meta})
    return out
