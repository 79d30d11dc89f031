"""`ray_tpu_torch.util`: parity with `ray.util` (reference `python/ray/util/`).

Exposes placement groups (`python/ray/util/placement_group.py:136`),
ActorPool (`python/ray/util/actor_pool.py`), scheduling strategies
(`python/ray/util/scheduling_strategies.py:15,41`), metrics facade
(`python/ray/util/metrics.py`), and the collective namespace.
"""

from ray_tpu_torch.core.placement_group import (
    PlacementGroup,
    placement_group,
    placement_group_table,
    remove_placement_group,
    get_current_placement_group,
)
from ray_tpu_torch.util.actor_pool import ActorPool
from ray_tpu_torch.util import collective
from ray_tpu_torch.util import metrics
from ray_tpu_torch.util import queue
from ray_tpu_torch.util import multiprocessing

__all__ = [
    "PlacementGroup",
    "placement_group",
    "placement_group_table",
    "remove_placement_group",
    "get_current_placement_group",
    "ActorPool",
    "collective",
    "metrics",
    "queue",
    "multiprocessing",
]
