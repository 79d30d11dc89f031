"""ActorPool: load-balance tasks over a fixed set of actors.

Mirrors `ray.util.ActorPool` (reference `python/ray/util/actor_pool.py`).
"""

from __future__ import annotations

from typing import Any, Callable, List

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: List[Any]):
        self._idle = list(actors)
        self._future_to_actor = {}
        self._pending_submits: List[tuple] = []
        self._result_queue: List[Any] = []

    def submit(self, fn: Callable, value: Any) -> None:
        if self._idle:
            actor = self._idle.pop()
            ref = fn(actor, value)
            self._future_to_actor[ref] = actor
        else:
            self._pending_submits.append((fn, value))

    def get_next(self, timeout: float = None) -> Any:
        if not self._future_to_actor:
            raise StopIteration("no pending results")
        refs = list(self._future_to_actor)
        ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("get_next timed out")
        ref = ready[0]
        actor = self._future_to_actor.pop(ref)
        self._return_actor(actor)
        return ray_tpu_torch.get(ref)

    def get_next_unordered(self, timeout: float = None) -> Any:
        return self.get_next(timeout)

    def _return_actor(self, actor) -> None:
        if self._pending_submits:
            fn, value = self._pending_submits.pop(0)
            ref = fn(actor, value)
            self._future_to_actor[ref] = actor
        else:
            self._idle.append(actor)

    def map(self, fn: Callable, values: List[Any]):
        for v in values:
            self.submit(fn, v)
        for _ in values:
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: List[Any]):
        return self.map(fn, values)

    def has_next(self) -> bool:
        return bool(self._future_to_actor)

    def has_free(self) -> bool:
        return bool(self._idle)
