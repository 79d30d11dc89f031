"""Process-group initialization (twin of ray_tpu/parallel/distributed.py),
on `torch.distributed`.

`initialize_group(rank, world_size)` joins this process to a world of
`world_size` processes: NCCL on the card (one rank a card, the card
chosen before the group exists), gloo on the CPU. The reference's rules
hold: idempotent for one group, a RuntimeError for a second one, a world
of 1 allowed, and `timeout` the process group's, so a rank that never
arrives or a collective that hangs fails instead of stalling.

Rendezvous comes, in this order, from `init_method` (e.g.
"tcp://localhost:29500"); inside a task or actor of the port's runtime
(`ray_tpu_torch.core`), from its KV store, as the reference's does: rank 0
binds a free port and publishes `host:port` under the group's key, every
rank reads it (a world of 1 too); from the environment `torchrun` and
`torch.multiprocessing` launchers set (MASTER_ADDR, MASTER_PORT); a world
of 1 needs none of them. `initialize_from_session` takes the rank and
the world size from the AIR session (`ray_tpu_torch.air.session`).
"""

from __future__ import annotations

import datetime
import logging
import os
import socket
import sys
import time
from typing import Optional

import torch

from ray_tpu_torch.ops.kernels._util import require_cuda

logger = logging.getLogger(__name__)

_KV_NS = "_torch_distributed"
_initialized_group: Optional[str] = None


def _runtime_worker():
    """The port runtime's worker of this process when it runs a task or an
    actor, else None. Looked up without importing the runtime."""
    worker_mod = sys.modules.get("ray_tpu_torch.core.worker")
    w = worker_mod.current_worker() if worker_mod is not None else None
    return w if w is not None and getattr(w, "mode", None) == "worker" \
        else None


def _kv_rendezvous(worker, rank: int, group_name: str,
                   timeout: float) -> str:
    """The reference's rendezvous: rank 0 binds a free port on its host and
    publishes `host:port` under the group's KV key; every other rank polls
    the key until a coordinator listens there. Returns the init_method."""
    key = f"coordinator:{group_name}".encode()
    gcs = worker.gcs
    if rank == 0:
        addr = worker.address
        host = addr.rsplit(":", 1)[0] if ":" in addr else "127.0.0.1"
        # hold the bound socket until the key is out, then hand the port to
        # the process group's store, which binds it again
        s = socket.socket()
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind((host, 0))
        coord = f"{s.getsockname()[0]}:{s.getsockname()[1]}"
        gcs.call("kv_put", {"namespace": _KV_NS, "key": key,
                            "value": coord.encode()})
        s.close()
        return f"tcp://{coord}"
    # a stale key from an earlier run of this group may still be in the KV:
    # accept only a coordinator that is listening
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = gcs.call("kv_get", {"namespace": _KV_NS, "key": key})
        if v:
            host, port = v.decode().rsplit(":", 1)
            try:
                socket.create_connection((host, int(port)), timeout=1).close()
                return f"tcp://{v.decode()}"
            except OSError:
                pass
        time.sleep(0.1)
    raise TimeoutError(f"rank {rank}: no live coordinator for group "
                       f"{group_name!r} within {timeout}s")


def _local_rank(rank: int) -> int:
    """The card of this rank on its host: LOCAL_RANK where a launcher set
    it; inside a task or actor of the port's runtime granted GPUs, the
    grant's first card (a Train worker's bundle need not be its rank's
    card); else the rank modulo the host's cards."""
    local = os.environ.get("LOCAL_RANK")
    if local is not None:
        return int(local)
    api = sys.modules.get("ray_tpu_torch.core.api")
    ids = api.get_gpu_ids() if api is not None and _runtime_worker() \
        is not None else []
    return ids[0] if ids else rank % max(torch.cuda.device_count(), 1)


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
    worker = _runtime_worker()
    if init_method is not None:
        kwargs["init_method"] = init_method
    elif worker is not None and "MASTER_ADDR" not in os.environ:
        kwargs["init_method"] = _kv_rendezvous(worker, rank, group_name,
                                               timeout)
    elif world_size == 1 and "MASTER_ADDR" not in os.environ:
        kwargs["store"] = dist.HashStore()
    logger.info("rank %d/%d joining torch.distributed (%s)", rank,
                world_size, kwargs["backend"])
    dist.init_process_group(**kwargs)
    _initialized_group = group_name


def initialize_from_session(group_name: str = "default",
                            timeout: float = 120.0, *,
                            device="cuda") -> None:
    """Inside a Train worker: rank/world come from the AIR session
    (`device` as `initialize_group` takes it)."""
    from ray_tpu_torch.air import session

    initialize_group(session.get_world_rank(), session.get_world_size(),
                     group_name=group_name, timeout=timeout, device=device)


def shutdown_group(group_name: str = "default") -> None:
    """Leave the process group `initialize_group` created (no-op if none)."""
    global _initialized_group
    import torch.distributed as dist

    if _initialized_group is None:
        return
    if dist.is_initialized():
        dist.destroy_process_group()
    worker = _runtime_worker()
    if worker is not None:
        try:
            worker.gcs.call("kv_del", {
                "namespace": _KV_NS,
                "key": f"coordinator:{group_name}".encode()})
        except (OSError, RuntimeError, TimeoutError):
            pass  # control plane already down at interpreter exit
    _initialized_group = None
