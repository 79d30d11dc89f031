"""Worker-side training session API.

Mirrors the reference's `python/ray/air/session.py` surface
(`report:43`, `get_checkpoint:97`, `get_world_rank:230`,
`get_dataset_shard:359`): inside a `train_loop_per_worker`, `session.report`
streams metrics/checkpoints back to the trainer and `get_world_rank/size`
expose the worker's position in the group.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint

_ctx = threading.local()


class _Session:
    def __init__(self, rank: int, world_size: int, report_fn,
                 checkpoint: Optional[Checkpoint], dataset_shards: Optional[dict],
                 trial_info: Optional[dict] = None, use_gpu: bool = False):
        self.rank = rank
        self.world_size = world_size
        self.report_fn = report_fn
        self.checkpoint = checkpoint
        self.dataset_shards = dataset_shards or {}
        self.trial_info = trial_info or {}
        # a `ScalingConfig(use_gpu=True)` train worker: its device is its
        # grant's first card (`train.torch.get_device`)
        self.use_gpu = use_gpu


def _set_session(s: Optional[_Session]) -> None:
    _ctx.session = s


def _get_session() -> _Session:
    s = getattr(_ctx, "session", None)
    if s is None:
        raise RuntimeError(
            "session API used outside a train worker (no active session)")
    return s


def report(metrics: Dict[str, Any], *, checkpoint: Optional[Checkpoint] = None) -> None:
    # piggy-back system metrics recorded worker-side since the last report
    # (checkpoint save time — the driver exports them as gauges)
    try:
        from ray_tpu_torch.train.checkpointing import pop_last_save_seconds

        save_s = pop_last_save_seconds()
        if save_s is not None and "checkpoint_save_seconds" not in metrics:
            metrics = {**metrics, "checkpoint_save_seconds": save_s}
    except ImportError:
        pass
    _get_session().report_fn(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return _get_session().checkpoint


def get_world_rank() -> int:
    return _get_session().rank


def get_world_size() -> int:
    return _get_session().world_size


def get_dataset_shard(name: str = "train"):
    return _get_session().dataset_shards.get(name)


def get_trial_name() -> Optional[str]:
    return _get_session().trial_info.get("name")
