"""Collective communication groups over actors.

API mirror of the reference's `ray.util.collective`
(`python/ray/util/collective/collective.py:120` init_collective_group,
`allreduce:258`, `broadcast:373`, `allgather:423`, `reducescatter:472`),
the port of ray_tpu's `util/collective.py`. Both backends reduce through
one rendezvous actor, as ray_tpu's "xla" and "host" backends do:

  - backend="nccl" takes the place of ray_tpu's "xla": the name of the
    device backend, reduced through the rendezvous actor like "host". No
    NCCL-backed collective runs here; a job that wants NCCL over its cards
    builds a `torch.distributed` group (`parallel.distributed.
    initialize_group`, which rendezvouses through this runtime's KV).
  - backend="host" (the gloo replacement): CPU arrays reduced through a
    rendezvous actor; used for control-plane tensors and CI, where the
    reference uses pygloo.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch

_groups: Dict[str, "_GroupHandle"] = {}


@ray_tpu_torch.remote
class _RendezvousActor:
    """Barrier + reduction point for one collective group (host backend)."""

    def __init__(self, world_size: int):
        self.world_size = world_size
        self._rounds: Dict[tuple, dict] = {}

    def _round(self, op_id: tuple):
        r = self._rounds.get(op_id)
        if r is None:
            r = {"values": {}, "done": False}
            self._rounds[op_id] = r
        return r

    def submit(self, op_id: tuple, rank: int, value):
        r = self._round(op_id)
        r["values"][rank] = value
        return len(r["values"]) == self.world_size

    def fetch(self, op_id: tuple, op: str, rank: int):
        r = self._rounds.get(op_id)
        if r is None or len(r["values"]) < self.world_size:
            return None
        vals = [r["values"][i] for i in range(self.world_size)]
        r.setdefault("fetched", set()).add(rank)
        if len(r["fetched"]) == self.world_size:
            self._rounds.pop(op_id, None)
        if op == "gather":
            result = vals
        else:
            acc = np.asarray(vals[0], dtype=np.float64 if op != "concat" else None)
            for v in vals[1:]:
                if op == "sum":
                    acc = acc + np.asarray(v, dtype=np.float64)
                elif op == "max":
                    acc = np.maximum(acc, v)
                elif op == "min":
                    acc = np.minimum(acc, v)
            result = acc
        return result

    def clear(self, op_id: tuple):
        self._rounds.pop(op_id, None)
        return True


class _GroupHandle:
    def __init__(self, name: str, world_size: int, rank: int, backend: str,
                 actor):
        self.name = name
        self.world_size = world_size
        self.rank = rank
        self.backend = backend
        self.actor = actor
        self._seq = 0

    def next_op(self, kind: str) -> tuple:
        self._seq += 1
        return (kind, self._seq)


def init_collective_group(world_size: int, rank: int, backend: str = "host",
                          group_name: str = "default") -> None:
    """Join a collective group; rank 0 creates the rendezvous actor and
    registers it under a name; others look it up (control-plane KV role)."""
    actor_name = f"_collective:{group_name}"
    if rank == 0:
        actor = _RendezvousActor.options(name=actor_name, num_cpus=0).remote(world_size)
    else:
        actor = _wait_for_actor(actor_name)
    _groups[group_name] = _GroupHandle(group_name, world_size, rank, backend, actor)


def _wait_for_actor(name: str, timeout: float = 30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            return ray_tpu_torch.get_actor(name)
        except ValueError:
            time.sleep(0.1)
    raise TimeoutError(f"collective rendezvous actor {name} not found")


def destroy_collective_group(group_name: str = "default") -> None:
    g = _groups.pop(group_name, None)
    if g is not None and g.rank == 0:
        try:
            ray_tpu_torch.kill(g.actor)
        except (ValueError, RuntimeError, OSError, TimeoutError):
            pass  # rendezvous actor / control plane already gone


def _collective(value, op: str, group_name: str):
    g = _groups[group_name]
    op_id = g.next_op(op)
    ray_tpu_torch.get(g.actor.submit.remote(op_id, g.rank, np.asarray(value)))
    while True:
        out = ray_tpu_torch.get(g.actor.fetch.remote(op_id, op, g.rank))
        if out is not None:
            break
        time.sleep(0.01)
    return out


def allreduce(tensor, group_name: str = "default", op: str = "sum"):
    out = _collective(tensor, op, group_name)
    return np.asarray(out, dtype=np.asarray(tensor).dtype)


def allgather(tensor, group_name: str = "default") -> List[Any]:
    return _collective(tensor, "gather", group_name)


def broadcast(tensor, src_rank: int = 0, group_name: str = "default"):
    vals = _collective(tensor, "gather", group_name)
    return vals[src_rank]


def reducescatter(tensor, group_name: str = "default", op: str = "sum"):
    g = _groups[group_name]
    reduced = allreduce(tensor, group_name, op)
    chunks = np.array_split(reduced, g.world_size)
    return chunks[g.rank]


def barrier(group_name: str = "default") -> None:
    _collective(np.zeros(1), "sum", group_name)


def get_rank(group_name: str = "default") -> int:
    return _groups[group_name].rank


def get_collective_group_size(group_name: str = "default") -> int:
    return _groups[group_name].world_size
