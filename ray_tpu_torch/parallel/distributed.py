"""Process-group initialization (twin of ray_tpu/parallel/distributed.py),
on `torch.distributed`.

`initialize_group(rank, world_size)` joins this process to a world of
`world_size` processes: NCCL on the card (one rank a card, the card
chosen before the group exists), gloo on the CPU. The reference's rules
hold: idempotent for one group, a RuntimeError for a second one, a world
of 1 allowed, and `timeout` the process group's, so a rank that never
arrives or a collective that hangs fails instead of stalling.

Rendezvous comes from `init_method` (e.g. "tcp://localhost:29500") or
from the environment `torchrun` and `torch.multiprocessing` launchers set
(MASTER_ADDR, MASTER_PORT); a world of 1 needs neither. The reference's
rendezvous through the runtime's KV store waits for the runtime's port
(ROADMAP.md queue A item 8), and `initialize_from_session` for the Train
session's (item 9).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch

from ray_tpu_torch.ops.kernels._util import require_cuda

logger = logging.getLogger(__name__)

_initialized_group: Optional[str] = None


def _local_rank(rank: int) -> int:
    """The card of this rank on its host: LOCAL_RANK where a launcher set
    it, else the rank modulo the host's cards."""
    local = os.environ.get("LOCAL_RANK")
    return int(local) if local is not None else rank % max(
        torch.cuda.device_count(), 1)


def initialize_group(rank: int, world_size: int, *,
                     group_name: str = "default", timeout: float = 120.0,
                     device="cuda", init_method: Optional[str] = None
                     ) -> None:
    """Join this process into a torch.distributed world of `world_size`
    processes as `rank`: NCCL with this rank's card set as the current
    device (a rank without a card raises), or gloo for device="cpu".
    Idempotent for `group_name`; initializing a different group raises."""
    global _initialized_group
    import torch.distributed as dist

    dev = require_cuda(device)
    if _initialized_group is not None:
        if _initialized_group == group_name:
            return
        raise RuntimeError(
            f"process already in torch.distributed group "
            f"{_initialized_group!r}")
    if dist.is_initialized():
        raise RuntimeError("a torch.distributed process group exists that "
                           "initialize_group did not create")
    kwargs = {"backend": "gloo", "rank": rank, "world_size": world_size,
              "timeout": datetime.timedelta(seconds=timeout)}
    if dev.type == "cuda":
        local = _local_rank(rank)
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank} needs card {local}, but this host has "
                f"{torch.cuda.device_count()}")
        torch.cuda.set_device(local)
        kwargs.update(backend="nccl",
                      device_id=torch.device("cuda", local))
    if init_method is not None:
        kwargs["init_method"] = init_method
    elif world_size == 1 and "MASTER_ADDR" not in os.environ:
        kwargs["store"] = dist.HashStore()
    logger.info("rank %d/%d joining torch.distributed (%s)", rank,
                world_size, kwargs["backend"])
    dist.init_process_group(**kwargs)
    _initialized_group = group_name


def initialize_from_session(group_name: str = "default",
                            timeout: float = 120.0) -> None:
    """Inside a Train worker, rank and world come from the session: the
    Train runtime is not ported yet (ROADMAP.md queue A item 9)."""
    raise NotImplementedError(
        "initialize_from_session needs the Train session, which is not "
        "ported yet (ROADMAP.md, queue A item 9); call initialize_group "
        "with the rank and world size")


def shutdown_group(group_name: str = "default") -> None:
    """Leave the process group `initialize_group` created (no-op if none)."""
    global _initialized_group
    import torch.distributed as dist

    if _initialized_group is None:
        return
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized_group = None
