"""joblib backend over the task runtime.

Mirrors the reference's `ray.util.joblib.register_ray`
(`python/ray/util/joblib/__init__.py` + `ray_backend.py`): after
`register_backend()`, `joblib.parallel_backend("ray_tpu_torch")` routes
scikit-learn / joblib.Parallel work through cluster tasks instead of
local processes. Gated on joblib being importable (it ships with
scikit-learn; absent in a minimal image the call raises ImportError).
"""

from __future__ import annotations

import threading
from typing import Any, Callable, List

import ray_tpu_torch


def register_backend() -> None:
    from joblib import register_parallel_backend
    from joblib._parallel_backends import ParallelBackendBase

    class RayTpuBackend(ParallelBackendBase):
        supports_timeout = False
        uses_threads = False
        supports_sharedmem = False

        def configure(self, n_jobs: int = 1, parallel=None, **kwargs) -> int:
            if not ray_tpu_torch.is_initialized():
                ray_tpu_torch.init()
            self.parallel = parallel
            return self.effective_n_jobs(n_jobs)

        def effective_n_jobs(self, n_jobs: int) -> int:
            if n_jobs in (None, -1):
                return int(ray_tpu_torch.cluster_resources().get("CPU", 1))
            return max(1, n_jobs)

        def apply_async(self, func: Callable, callback=None):
            @ray_tpu_torch.remote
            def _run(f):
                return f()

            ref = _run.remote(func)
            result = _ImmediateResult(ref)
            if callback is not None:
                # fire the completion callback when the task actually
                # finishes (a synchronous callback would make joblib's
                # dispatcher believe every batch completes instantly and
                # flood the queue / collapse batch-size auto-tuning)
                def _notify():
                    try:
                        ray_tpu_torch.wait([ref], num_returns=1, timeout=None)
                    finally:
                        callback(result)

                threading.Thread(target=_notify, daemon=True).start()
            return result

        def abort_everything(self, ensure_ready: bool = True) -> None:
            pass

    register_parallel_backend("ray_tpu_torch", RayTpuBackend)


class _ImmediateResult:
    """joblib future shim: joblib calls .get() to collect the batch."""

    def __init__(self, ref: Any):
        self._ref = ref

    def get(self, timeout: float = None) -> List[Any]:
        return ray_tpu_torch.get(self._ref, timeout=timeout)
