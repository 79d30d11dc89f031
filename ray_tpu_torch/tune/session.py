"""Per-trial session for function trainables (tune.report analog)."""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint

_ctx = threading.local()


class StopTrial(Exception):
    """Raised inside the trainable thread when the scheduler stops a trial."""


def _set(report_fn, checkpoint: Optional[Checkpoint]) -> None:
    _ctx.report_fn = report_fn
    _ctx.checkpoint = checkpoint


def _clear() -> None:
    _ctx.report_fn = None
    _ctx.checkpoint = None


def report(metrics: Dict[str, Any], *, checkpoint: Optional[Checkpoint] = None) -> None:
    fn = getattr(_ctx, "report_fn", None)
    if fn is None:
        raise RuntimeError("tune.report() called outside a trial")
    fn(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return getattr(_ctx, "checkpoint", None)
