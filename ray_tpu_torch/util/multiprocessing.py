"""multiprocessing.Pool API over the task runtime.

Mirrors the reference's `ray.util.multiprocessing.Pool`
(`python/ray/util/multiprocessing/pool.py`): the stdlib Pool surface —
apply/apply_async/map/map_async/imap/imap_unordered/starmap — where each
work item runs as a cluster task instead of a forked local process.
"""

from __future__ import annotations

import itertools
from typing import Any, Callable, Iterable, List, Optional, Sequence

import ray_tpu_torch


class AsyncResult:
    def __init__(self, refs: List[Any], single: bool):
        self._refs = refs
        self._single = single

    def get(self, timeout: Optional[float] = None):
        results = ray_tpu_torch.get(self._refs, timeout=timeout)
        return results[0] if self._single else results

    def wait(self, timeout: Optional[float] = None) -> None:
        ray_tpu_torch.wait(self._refs, num_returns=len(self._refs), timeout=timeout)

    def ready(self) -> bool:
        done, _ = ray_tpu_torch.wait(self._refs, num_returns=len(self._refs),
                               timeout=0)
        return len(done) == len(self._refs)

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("result is not ready")  # stdlib Pool contract
        try:
            ray_tpu_torch.get(self._refs, timeout=0)
            return True
        except Exception:
            return False


@ray_tpu_torch.remote
def _run_chunk(fn: Callable, chunk: List[Any], star: bool) -> List[Any]:
    if star:
        return [fn(*args) for args in chunk]
    return [fn(x) for x in chunk]


class Pool:
    """Task-backed process pool. All chunks are submitted eagerly — actual
    execution concurrency is bounded by cluster CPU resources (each chunk
    is a 1-CPU task queued by the scheduler), not by `processes`, which
    only feeds the default-chunksize heuristic. `chunksize` groups items
    per task like the stdlib."""

    def __init__(self, processes: Optional[int] = None):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        self._processes = processes or int(
            ray_tpu_torch.cluster_resources().get("CPU", 4))
        self._closed = False

    # ---------------------------------------------------------------- sync
    def apply(self, fn: Callable, args: Sequence = (), kwds: Optional[dict] = None):
        return self.apply_async(fn, args, kwds).get()

    def map(self, fn: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> List[Any]:
        return self.map_async(fn, iterable, chunksize).get()

    def starmap(self, fn: Callable, iterable: Iterable[Sequence],
                chunksize: Optional[int] = None) -> List[Any]:
        refs = self._submit_chunks(fn, list(iterable), chunksize, star=True)
        return list(itertools.chain.from_iterable(ray_tpu_torch.get(refs)))

    # --------------------------------------------------------------- async
    def apply_async(self, fn: Callable, args: Sequence = (),
                    kwds: Optional[dict] = None) -> AsyncResult:
        self._check_open()
        kwds = kwds or {}

        @ray_tpu_torch.remote
        def _apply(f, a, kw):
            return f(*a, **kw)

        return AsyncResult([_apply.remote(fn, list(args), kwds)], single=True)

    def map_async(self, fn: Callable, iterable: Iterable,
                  chunksize: Optional[int] = None) -> AsyncResult:
        refs = self._submit_chunks(fn, list(iterable), chunksize, star=False)
        return _ChunkedResult(refs)

    # ---------------------------------------------------------------- imap
    def imap(self, fn: Callable, iterable: Iterable,
             chunksize: Optional[int] = None):
        items = list(iterable)
        refs = self._submit_chunks(fn, items, chunksize, star=False)
        for ref in refs:
            yield from ray_tpu_torch.get(ref)

    def imap_unordered(self, fn: Callable, iterable: Iterable,
                       chunksize: Optional[int] = None):
        items = list(iterable)
        refs = self._submit_chunks(fn, items, chunksize, star=False)
        remaining = list(refs)
        while remaining:
            done, remaining = ray_tpu_torch.wait(remaining, num_returns=1)
            for ref in done:
                yield from ray_tpu_torch.get(ref)

    # ------------------------------------------------------------ lifecycle
    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True

    def join(self) -> None:
        pass

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc) -> None:
        self.terminate()

    # ------------------------------------------------------------ internals
    def _check_open(self) -> None:
        if self._closed:
            raise ValueError("Pool not running")

    def _submit_chunks(self, fn: Callable, items: List[Any],
                       chunksize: Optional[int], star: bool) -> List[Any]:
        self._check_open()
        if not items:
            return []
        if chunksize is None:
            chunksize = max(1, len(items) // (self._processes * 4) or 1)
        return [
            _run_chunk.remote(fn, items[i:i + chunksize], star)
            for i in range(0, len(items), chunksize)]


class _ChunkedResult(AsyncResult):
    def __init__(self, refs: List[Any]):
        super().__init__(refs, single=False)

    def get(self, timeout: Optional[float] = None):
        chunks = ray_tpu_torch.get(self._refs, timeout=timeout)
        return list(itertools.chain.from_iterable(chunks))
