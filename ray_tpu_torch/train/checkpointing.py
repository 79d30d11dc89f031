"""Checkpoints of a training state (twin of ray_tpu/train/checkpointing.py),
on torch.distributed.checkpoint (DCP).

`save_sharded` writes a state, `restore_sharded` reads one back into a
target of the same structure: nested dicts and dataclasses (`TrainState`,
`AdamWState`, `FusedAdamWState`) of tensors (or DTensors) and Python ints,
the ints (the update count, the step) restored with the tensors. DCP is
the format a sharded state reshards through: on one device it runs in a
single process, with no process group; under a process group every rank
writes its own blocks (a collective save), and a restore into DTensors of
another mesh (`abstract_like(state, shardings)`, e.g. `state_shardings`
of the target mesh) reads each rank's new blocks. The step directories
work under a process group too: rank 0 stages and commits the directory,
and `latest_checkpoint` and `gc_checkpoints` run on rank 0 and hand their
result to every rank (so every rank calls them, as it calls the save).
The ranks share one file system. Each save sets the Prometheus gauge
`ray_tpu_torch_checkpoint_save_seconds` to its seconds, as the reference
sets `ray_tpu_checkpoint_save_seconds`.

The port's training update writes the state in place, so a save is
synchronous (no `async_save`), and a restore fills the target's own
tensors: pass `abstract_like(state)` (or a freshly initialized state),
never the live state a run goes on with.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import re
import shutil
import time
import warnings
from typing import Any, Callable, Optional, Tuple

import torch

logger = logging.getLogger(__name__)


_last_save_seconds: list = []


def pop_last_save_seconds() -> Any:
    """Seconds the most recent save_sharded took, or None; reading it
    clears it (the reference reports it once, with the next metrics)."""
    return _last_save_seconds.pop() if _last_save_seconds else None


def _is_dataclass(x: Any) -> bool:
    return dataclasses.is_dataclass(x) and not isinstance(x, type)


def _state_dict(state: Any) -> Any:
    """`state` as the nested dicts DCP writes: a dataclass becomes a dict of
    its fields; tensors and other values are leaves."""
    if _is_dataclass(state):
        return {f.name: _state_dict(getattr(state, f.name))
                for f in dataclasses.fields(state)}
    if isinstance(state, dict):
        return {k: _state_dict(v) for k, v in state.items()}
    return state


def _rebuild(template: Any, sd: Any,
             leaf: Callable[[Any], Any] = lambda x: x) -> Any:
    """`template`'s structure (its dataclasses included) over the leaves of
    `sd`, its `_state_dict` form, each passed through `leaf`."""
    if _is_dataclass(template):
        return dataclasses.replace(template, **{
            f.name: _rebuild(getattr(template, f.name), sd[f.name], leaf)
            for f in dataclasses.fields(template)})
    if isinstance(template, dict):
        return {k: _rebuild(v, sd[k], leaf) for k, v in template.items()}
    return leaf(sd)


def _group() -> bool:
    """Whether a process group exists (the collective checkpoint path)."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _rank0_result(fn, *args):
    """fn(*args) on rank 0, its result handed to every rank; alone, just
    fn(*args)."""
    if not _group():
        return fn(*args)
    import torch.distributed as dist

    out = [fn(*args) if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(out, src=0)
    return out[0]


def _single_process(fn, *args, **kwargs):
    """A DCP call; with no process group DCP runs in this process alone and
    says so in a warning, which is the intent here."""
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", message=".*assuming the intent is to (save|load) in a "
                              "single process")
        return fn(*args, **kwargs)


def save_sharded(state: Any, path: str) -> str:
    """Write a state checkpoint with DCP; returns the path."""
    import torch.distributed.checkpoint as dcp

    t0 = time.monotonic()
    path = os.path.abspath(path)
    _single_process(dcp.save, _state_dict(state), checkpoint_id=path)
    _last_save_seconds[:] = [time.monotonic() - t0]
    from ray_tpu_torch.util.metrics import get_or_create

    get_or_create("gauge", "ray_tpu_torch_checkpoint_save_seconds",
                  "last checkpoint save time").set(_last_save_seconds[0])
    return path


def restore_sharded(path: str, target: Any) -> Any:
    """Restore into `target`'s structure and tensors: each tensor of
    `target` is overwritten in place (its shape and dtype must match the
    saved one), each int replaced; returns the restored state."""
    import torch.distributed.checkpoint as dcp

    sd = _state_dict(target)
    _single_process(dcp.load, sd, checkpoint_id=os.path.abspath(path))
    return _rebuild(target, sd)


def _zip(sd: Any, shardings: Any) -> Any:
    """A `_state_dict` tree and the shardings of its state (dicts and
    dataclasses of NamedShardings) as one tree of pairs."""
    if isinstance(sd, dict):
        return {k: _zip(v, shardings[k] if isinstance(shardings, dict)
                        else getattr(shardings, k)) for k, v in sd.items()}
    return (sd, shardings)


def _empty_on(x: Any, sharding: Any) -> Any:
    """An uninitialized DTensor of tensor `x`'s global shape and dtype with
    `sharding`'s placements on its mesh; an int as it is."""
    from ray_tpu_torch.parallel.mesh import NamedSharding

    if not isinstance(x, torch.Tensor):
        return x
    if not isinstance(sharding, NamedSharding):
        raise TypeError(f"abstract_like: a tensor's sharding must be a "
                        f"NamedSharding (e.g. from train.step."
                        f"state_shardings), got {type(sharding).__name__}")
    local = [n for _, n in sharding.block(x.shape)]
    return sharding.from_local(
        torch.empty(local, dtype=x.dtype, device=sharding.mesh.device_type))


def abstract_like(state: Any, shardings: Optional[Any] = None) -> Any:
    """A state of `state`'s structure with uninitialized tensors of each
    leaf's shape, dtype and device (and its ints), to restore into. With
    `shardings` (a tree of NamedShardings of `state`'s structure, e.g.
    `state_shardings(cfg, mesh, optimizer)`), each tensor is an empty
    DTensor of its global shape on that sharding's mesh: `state` may live
    on another mesh, or be unsharded."""
    if shardings is not None:
        return _rebuild(state, _zip(_state_dict(state), shardings),
                        lambda pair: _empty_on(*pair))
    return _rebuild(state, _state_dict(state),
                    lambda x: (torch.empty_like(x)
                               if isinstance(x, torch.Tensor) else x))


# ---------------------------------------------------------------------------
# Step-numbered checkpoint directories with atomic completion, a
# latest-complete pointer, and keep-last-K retention.  A crash between "DCP
# finished writing" and "rename landed" leaves only a torn .tmp-* directory
# that latest_checkpoint() never resolves, so a restart always resumes from
# a checkpoint whose state AND meta are both fully on disk.
# ---------------------------------------------------------------------------

_STEP_DIR_RE = re.compile(r"^step_(\d+)$")
_TMP_PREFIX = ".tmp-"
_META_NAME = "meta.json"
_STATE_NAME = "state"


def checkpoint_path(root: str, step: int) -> str:
    return os.path.join(os.path.abspath(root), f"step_{step}")


def save_checkpoint(state: Any, root: str, step: int,
                    meta: Optional[dict] = None) -> str:
    """Atomically save `state` (+ JSON-serializable `meta`) as step `step`.

    Everything is written under a hidden `.tmp-step_N-<pid>` staging dir
    first; the final `os.replace` onto `step_N` is the commit point.  A
    directory named `step_N` therefore always holds a complete save.
    Under a process group every rank calls it: rank 0 stages the directory
    (its pid names it), every rank writes its blocks, and rank 0 writes
    the meta and commits after a barrier.
    """
    if _group():
        return _save_checkpoint_collective(state, root, step, meta)
    root = os.path.abspath(root)
    os.makedirs(root, exist_ok=True)
    final = checkpoint_path(root, step)
    tmp = os.path.join(root, f"{_TMP_PREFIX}step_{step}-{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        save_sharded(state, os.path.join(tmp, _STATE_NAME))
        with open(os.path.join(tmp, _META_NAME), "w") as f:
            json.dump({"step": step, **(meta or {})}, f)
        if os.path.exists(final):  # e.g. re-save after a rolled-back restart
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def _save_checkpoint_collective(state: Any, root: str, step: int,
                                meta: Optional[dict]) -> str:
    import torch.distributed as dist

    rank0 = dist.get_rank() == 0
    root = os.path.abspath(root)
    final = checkpoint_path(root, step)
    name = [f"{_TMP_PREFIX}step_{step}-{os.getpid()}" if rank0 else None]
    dist.broadcast_object_list(name, src=0)
    tmp = os.path.join(root, name[0])
    if rank0:
        os.makedirs(root, exist_ok=True)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    dist.barrier()
    try:
        save_sharded(state, os.path.join(tmp, _STATE_NAME))
        dist.barrier()
        if rank0:
            with open(os.path.join(tmp, _META_NAME), "w") as f:
                json.dump({"step": step, **(meta or {})}, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
    except BaseException:
        if rank0:
            shutil.rmtree(tmp, ignore_errors=True)
        raise
    dist.barrier()
    return final


def _complete_steps(root: str) -> list:
    """(step, path) for every COMPLETE checkpoint under root, ascending."""
    root = os.path.abspath(root)
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = _STEP_DIR_RE.match(name)
        if not m:
            continue
        path = os.path.join(root, name)
        # The rename is the commit point, but guard against a partially
        # rm'd directory anyway: meta.json + state dir must both exist.
        if (os.path.isfile(os.path.join(path, _META_NAME))
                and os.path.isdir(os.path.join(path, _STATE_NAME))):
            out.append((int(m.group(1)), path))
    out.sort()
    return out


def latest_checkpoint(root: str) -> Optional[str]:
    """Path of the newest *complete* checkpoint under `root`, or None.

    In-progress / torn `.tmp-*` staging dirs and step dirs missing their
    meta or state are ignored, so a crash mid-save can never be resumed
    from.
    """
    steps = _rank0_result(_complete_steps, root)
    return steps[-1][1] if steps else None


def load_checkpoint(path: str, target: Any) -> Tuple[Any, dict]:
    """Restore (state, meta) from a complete checkpoint directory into
    `target` (see `restore_sharded`)."""
    with open(os.path.join(path, _META_NAME)) as f:
        meta = json.load(f)
    state = restore_sharded(os.path.join(path, _STATE_NAME), target)
    return state, meta


def gc_checkpoints(root: str, keep: int) -> list:
    """Keep the newest `keep` complete checkpoints; delete the rest plus
    any torn `.tmp-*` staging dirs.  Returns the deleted paths (under a
    process group, rank 0 deletes and every rank gets the list)."""
    return _rank0_result(_gc_checkpoints, os.path.abspath(root), keep)


def _gc_checkpoints(root: str, keep: int) -> list:
    deleted = []
    steps = _complete_steps(root)
    for _, path in steps[:-keep] if keep > 0 else steps:
        shutil.rmtree(path, ignore_errors=True)
        deleted.append(path)
    if os.path.isdir(root):
        for name in os.listdir(root):
            if name.startswith(_TMP_PREFIX):
                path = os.path.join(root, name)
                shutil.rmtree(path, ignore_errors=True)
                deleted.append(path)
    if deleted:
        logger.info("checkpoint GC removed %d dirs under %s",
                    len(deleted), root)
    return deleted
