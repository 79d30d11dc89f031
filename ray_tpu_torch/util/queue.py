"""Distributed FIFO queue (actor-backed).

Mirrors `ray.util.queue.Queue` (reference `python/ray/util/queue.py`).
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, List, Optional

import ray_tpu_torch


@ray_tpu_torch.remote
class _QueueActor:
    def __init__(self, maxsize: int = 0):
        self._maxsize = maxsize
        self._q = collections.deque()

    def put(self, item) -> bool:
        if self._maxsize and len(self._q) >= self._maxsize:
            return False
        self._q.append(item)
        return True

    def get_batch(self, max_items: int = 100) -> List[Any]:
        out = []
        while self._q and len(out) < max_items:
            out.append(self._q.popleft())
        return out

    def qsize(self) -> int:
        return len(self._q)


class Queue:
    """Client facade; pass the Queue object (it pickles by actor handle)."""

    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        opts = dict(actor_options or {})
        opts.setdefault("num_cpus", 0)
        self._actor = _QueueActor.options(**opts).remote(maxsize)

    def put(self, item, block: bool = True, timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if ray_tpu_torch.get(self._actor.put.remote(item)):
                return
            if not block or (deadline and time.monotonic() > deadline):
                raise TimeoutError("queue full")
            time.sleep(0.05)

    def get_batch(self, max_items: int = 100) -> List[Any]:
        return ray_tpu_torch.get(self._actor.get_batch.remote(max_items))

    def get(self, block: bool = True, timeout: Optional[float] = None):
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            batch = self.get_batch(1)
            if batch:
                return batch[0]
            if not block or (deadline and time.monotonic() > deadline):
                raise TimeoutError("queue empty")
            time.sleep(0.02)

    def qsize(self) -> int:
        return ray_tpu_torch.get(self._actor.qsize.remote())

    def __reduce__(self):
        q = object.__new__(Queue)
        return (_rebuild_queue, (self._actor,))


def _rebuild_queue(actor):
    q = object.__new__(Queue)
    q._actor = actor
    return q
