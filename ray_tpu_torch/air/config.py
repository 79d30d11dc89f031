"""AIR-style run configuration dataclasses.

Mirrors the reference's `python/ray/air/config.py` (ScalingConfig:89,
RunConfig:705, CheckpointConfig:577, FailureConfig:518): `use_gpu` +
`gpus_per_worker` (one card a worker, as the reference's
`ScalingConfig(use_gpu=True)` gives), and `topology` for NVLink-domain-aware
placement.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class ScalingConfig:
    num_workers: int = 1
    use_gpu: bool = False
    gpus_per_worker: int = 1             # GPUs per worker
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    topology: Optional[str] = None       # e.g. "8xH100": informs packing
    # Elastic recovery (SURVEY hard-part #7): when a retry's placement group
    # is infeasible on the surviving cluster (slice/node loss), shrink the
    # request — halve num_workers, then halve the per-worker GPU count —
    # instead of failing. The train loop sees the smaller grant, builds a
    # smaller mesh, and the DCP restore re-lays the checkpoint onto it.
    elastic: bool = False

    def worker_resources(self) -> Dict[str, float]:
        if self.resources_per_worker is not None:
            return dict(self.resources_per_worker)
        if self.use_gpu:
            return {"GPU": float(self.gpus_per_worker)}
        return {"CPU": 1.0}

    def strategy(self) -> str:
        # GPU workers must land in one NVLink domain: STRICT_PACK over its
        # hosts (the scheduler groups by the nvlink_domain label).
        if self.use_gpu and self.placement_strategy == "PACK":
            return "STRICT_PACK"
        return self.placement_strategy


@dataclass
class FailureConfig:
    max_failures: int = 0


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    verbose: int = 0
    # stop criteria: a tune.Stopper, {"metric": threshold} dict, or
    # callable(trial_id, result) -> bool (reference RunConfig/tune.run stop)
    stop: Any = None
    # tune.Callback instances (loggers, trackers); None = the default
    # CSV/JSON/TensorBoard trio when an experiment dir exists (reference
    # RunConfig(callbacks=...) + DEFAULT_LOGGERS)
    callbacks: Optional[List[Any]] = None
