"""TorchTrainer: torch.distributed DDP over the actor worker group.

Mirrors the reference's Torch backend (`python/ray/train/torch/config.py:29`,
`_setup_torch_process_group:69` and `train_loop_utils.py prepare_model/
prepare_data_loader`): the trainer reserves a rendezvous port, every worker
actor joins a process group before the user loop runs, and
`prepare_model`/`prepare_data_loader` wrap the user's module/loader in DDP +
DistributedSampler. gloo (CPU) is the default backend, as the reference's;
with `ScalingConfig(use_gpu=True)` and no `torch_config` the group is NCCL,
each worker's `get_device()` is its grant's first card, and a worker granted
no card raises instead of running on the CPU.
"""

from __future__ import annotations

import logging
import socket
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air import session as air_session
from ray_tpu_torch.train.trainer import DataParallelTrainer, _takes_arg

logger = logging.getLogger(__name__)

_MASTER_KEY = "_torch_master_addr"


@dataclass
class TorchConfig:
    backend: str = "gloo"
    init_timeout_s: float = 120.0


def get_device():
    """This worker's device: the grant's first card in a `use_gpu` worker
    (it raises if the worker holds no card), else the CPU, as the
    reference's always is."""
    import torch

    try:
        use_gpu = air_session._get_session().use_gpu
    except RuntimeError:  # outside a train worker
        use_gpu = False
    if not use_gpu:
        return torch.device("cpu")
    import ray_tpu_torch

    ids = ray_tpu_torch.get_gpu_ids()
    if not ids or not torch.cuda.is_available() \
            or ids[0] >= torch.cuda.device_count():
        raise RuntimeError(
            f"a use_gpu worker has no card: grant {ids}, "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" visible")
    return torch.device("cuda", ids[0])


def prepare_model(model):
    """Move to `get_device()` and wrap in DDP when world_size > 1
    (reference train_loop_utils.py:25)."""
    import torch.distributed as dist

    device = get_device()
    model = model.to(device)
    if dist.is_initialized() and dist.get_world_size() > 1:
        from torch.nn.parallel import DistributedDataParallel

        if device.type == "cuda":
            return DistributedDataParallel(model, device_ids=[device.index])
        return DistributedDataParallel(model)
    return model


def prepare_data_loader(loader):
    """Re-batch with a DistributedSampler so each rank sees its shard."""
    import torch.distributed as dist
    import torch.utils.data as tud

    if not (dist.is_initialized() and dist.get_world_size() > 1):
        return loader
    sampler = tud.distributed.DistributedSampler(loader.dataset)
    return tud.DataLoader(loader.dataset, batch_size=loader.batch_size,
                          sampler=sampler, num_workers=0,
                          collate_fn=loader.collate_fn)


def _wrap_with_process_group(train_loop: Callable, torch_config: TorchConfig):
    def wrapped(config: Dict[str, Any]):
        import datetime

        import torch.distributed as dist

        addr = config.pop(_MASTER_KEY)
        rank = air_session.get_world_rank()
        world = air_session.get_world_size()
        kwargs = {}
        if torch_config.backend == "nccl":
            kwargs["device_id"] = get_device()
        dist.init_process_group(
            torch_config.backend, init_method=f"tcp://{addr}",
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=torch_config.init_timeout_s),
            **kwargs)
        try:
            train_loop(config) if _takes_arg(train_loop) else train_loop()
        finally:
            dist.destroy_process_group()

    return wrapped


class TorchTrainer(DataParallelTrainer):
    """(reference `python/ray/train/torch/torch_trainer.py`)."""

    def __init__(self, train_loop_per_worker: Callable, *,
                 torch_config: Optional[TorchConfig] = None, **kwargs):
        sc = kwargs.get("scaling_config")
        self._torch_config = torch_config or TorchConfig(
            backend="nccl" if sc is not None and sc.use_gpu else "gloo")
        super().__init__(
            _wrap_with_process_group(train_loop_per_worker,
                                     self._torch_config),
            **kwargs)

    def _fit_once(self, checkpoint):
        # fresh rendezvous address per attempt (reference config.py:69 picks
        # a port on the rank-0 node; workers here share this host)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        self._config[_MASTER_KEY] = f"127.0.0.1:{port}"
        return super()._fit_once(checkpoint)
