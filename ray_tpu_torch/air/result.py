"""Result of a training/tuning run (cf. reference `python/ray/air/result.py`)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint


@dataclass
class Result:
    metrics: Dict[str, Any]
    checkpoint: Optional[Checkpoint] = None
    error: Optional[Exception] = None
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)
    path: Optional[str] = None

    @property
    def config(self):
        return self.metrics.get("config")
