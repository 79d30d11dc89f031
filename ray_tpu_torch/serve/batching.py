"""`@serve.batch`: opportunistic dynamic request batching.

Reference: `python/ray/serve/batching.py:206` — individual calls to the
decorated method queue up; one underlying invocation receives the whole
batch (a list) and returns a list of per-call results. Batches close when
`max_batch_size` requests are waiting or the oldest has waited
`batch_wait_timeout_s`.

The reference implementation is asyncio-based (its replicas run an event
loop); replicas here execute calls on threads (max_concurrency > 1), so
the batcher is a condition-variable queue: callers block on their own
event, one caller per batch is elected leader and runs the underlying
function for everyone. This is exactly the hand-off continuous-batching
LLM engines use between request threads and the model loop
(`serve/llm_engine.py`), generalized to any callable.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Any, Callable, List, Optional

from ray_tpu_torch.core.exceptions import RequestTimeoutError

# Per-thread serve-request context: the replica's handle_request pushes the
# request's end-to-end deadline before dispatching into user code, so a
# @serve.batch waiter knows its own deadline without threading it through
# user signatures. Stack-disciplined (push returns the previous value) so
# nested deployment calls within one thread restore correctly.
_request_ctx = threading.local()


def push_request_deadline(deadline_ts: Optional[float]) -> Optional[float]:
    prev = getattr(_request_ctx, "deadline_ts", None)
    _request_ctx.deadline_ts = deadline_ts
    return prev


def pop_request_deadline(prev: Optional[float]) -> None:
    _request_ctx.deadline_ts = prev


def current_request_deadline() -> Optional[float]:
    """Wall-clock deadline of the serve request on this thread (None
    outside a deadline-carrying request)."""
    return getattr(_request_ctx, "deadline_ts", None)


class _Waiter:
    __slots__ = ("arg", "event", "result", "error", "deadline_ts")

    def __init__(self, arg):
        self.arg = arg
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None
        self.deadline_ts = current_request_deadline()


class _Batcher:
    def __init__(self, fn: Callable[[List[Any]], List[Any]],
                 max_batch_size: int, batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout = batch_wait_timeout_s
        self._cv = threading.Condition()
        self._lock = self._cv  # one lock: queue state + leader election
        self._queue: List[_Waiter] = []
        self._leader_running = False

    def submit(self, self_arg, arg):
        w = _Waiter(arg)
        lead = False
        with self._lock:
            self._queue.append(w)
            if len(self._queue) >= self.max_batch_size:
                self._cv.notify_all()  # wake the leader: batch is full
            if not self._leader_running:
                self._leader_running = True
                lead = True
        if lead:
            self._lead(self_arg)
        w.event.wait()
        if w.error is not None:
            raise w.error
        return w.result

    def _lead(self, self_arg) -> None:
        """The elected leader waits for the batch window, drains the queue,
        runs the underlying fn once, and distributes results."""
        deadline = time.monotonic() + self.timeout
        with self._cv:
            while (len(self._queue) < self.max_batch_size
                   and (remaining := deadline - time.monotonic()) > 0):
                self._cv.wait(timeout=remaining)
        with self._lock:
            batch, self._queue = (self._queue[:self.max_batch_size],
                                  self._queue[self.max_batch_size:])
            if self._queue:
                # late arrivals get their own leader: hand off before
                # running so the next window opens immediately
                threading.Thread(target=self._relead, args=(self_arg,),
                                 daemon=True).start()
            else:
                self._leader_running = False
        # Drop waiters whose end-to-end deadline expired while queued for
        # the batch window: they get the typed error immediately and the
        # underlying invocation is spent only on requests a caller is
        # still waiting for (the same pre-dequeue discipline the replica
        # applies before dispatch).
        now = time.time()
        expired = [w for w in batch
                   if w.deadline_ts is not None and now >= w.deadline_ts]
        if expired:
            batch = [w for w in batch if w not in expired]
            for w in expired:
                w.error = RequestTimeoutError(
                    "request expired in batch queue before the batch ran")
                w.event.set()
            if not batch:
                return
        try:
            args = [w.arg for w in batch]
            results = (self.fn(self_arg, args) if self_arg is not _NO_SELF
                       else self.fn(args))
            if len(results) != len(batch):
                raise ValueError(
                    f"batched function returned {len(results)} results "
                    f"for a batch of {len(batch)}")
            for w, r in zip(batch, results):
                w.result = r
        except BaseException as e:
            for w in batch:
                w.error = e
        finally:
            for w in batch:
                w.event.set()

    def _relead(self, self_arg) -> None:
        with self._lock:
            if not self._queue:
                self._leader_running = False
                return
        self._lead(self_arg)


_NO_SELF = object()


def batch(_func=None, *, max_batch_size: int = 10,
          batch_wait_timeout_s: float = 0.01):
    """Decorate a function/method taking a LIST of requests and returning a
    LIST of results; callers invoke it with single requests (reference
    `serve.batch`). Works on plain functions and on methods (per-instance
    batch queues)."""

    def wrap(fn):
        attr = f"__serve_batcher_{fn.__name__}"

        @functools.wraps(fn)
        def method_wrapper(self, arg):
            b = getattr(self, attr, None)
            if b is None:
                b = _Batcher(fn, max_batch_size, batch_wait_timeout_s)
                setattr(self, attr, b)
            return b.submit(self, arg)

        shared = _Batcher(fn, max_batch_size, batch_wait_timeout_s)

        @functools.wraps(fn)
        def func_wrapper(arg):
            return shared.submit(_NO_SELF, arg)

        import inspect

        params = list(inspect.signature(fn).parameters)
        is_method = params and params[0] == "self"
        out = method_wrapper if is_method else func_wrapper
        out._serve_batch_config = {  # type: ignore[attr-defined]
            "max_batch_size": max_batch_size,
            "batch_wait_timeout_s": batch_wait_timeout_s,
        }
        return out

    return wrap(_func) if _func is not None else wrap
