"""Trainers: distributed training orchestration over actor worker groups.

Mirrors the reference's Train anatomy (SURVEY §3.4): `BaseTrainer.fit`
(`python/ray/train/base_trainer.py:555`) -> BackendExecutor creates a
placement group (`_internal/backend_executor.py:154`) -> WorkerGroup of
actors, one per host, each running the user `train_loop_per_worker` with a
session that streams results back -> TrainingIterator collects them.

On the GPU:
  - the worker group reserves `{"GPU": n}` bundles, STRICT_PACK over hosts
    with the same `nvlink_domain` label (`ScalingConfig(use_gpu=True)`), so
    the group's NCCL world rides NVLink; the runtime makes each worker's
    first granted card current in every actor call;
  - each worker joins a torch.distributed world through the control-plane
    KV (`ray_tpu_torch.parallel.initialize_from_session`, replacing
    `_setup_torch_process_group`, reference train/torch/config.py:69);
  - gradient traffic never touches the runtime: it is NCCL collectives
    inside the step (the same property as the reference, where NCCL
    bypasses Ray);
  - a report leaves a worker on the host: one-element tensors as Python
    numbers, a checkpoint's CUDA tensors as CPU tensors of the same bits,
    so the driver, which holds no card, never makes a CUDA context.
"""

from __future__ import annotations

import logging
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air import (
    Checkpoint,
    CheckpointConfig,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.air import session as air_session
from ray_tpu_torch.air.checkpoint import host_metrics
from ray_tpu_torch.core.exceptions import PlacementInfeasibleError
from ray_tpu_torch.core.placement_group import placement_group, remove_placement_group
from ray_tpu_torch.util.queue import Queue

logger = logging.getLogger(__name__)


@ray_tpu_torch.remote
class TrainWorker:
    """One member of the worker group (reference: `_TrainSession`,
    train/_internal/session.py:63)."""

    def __init__(self, rank: int, world_size: int, result_queue: Queue,
                 coordinator: Optional[str] = None, use_gpu: bool = False):
        self.rank = rank
        self.world_size = world_size
        self.queue = result_queue
        self.coordinator = coordinator
        self.use_gpu = use_gpu

    def run(self, train_loop: Callable, config: Dict[str, Any],
            checkpoint: Optional[Checkpoint], dataset_shards: Optional[dict]) -> dict:
        def report_fn(metrics, ckpt):
            entry = {"rank": self.rank, "metrics": host_metrics(metrics)}
            if ckpt is not None and self.rank == 0:
                entry["checkpoint"] = ckpt
            self.queue.put(entry)

        air_session._set_session(air_session._Session(
            self.rank, self.world_size, report_fn, checkpoint, dataset_shards,
            use_gpu=self.use_gpu))
        try:
            if self.use_gpu:  # no card: fail here, never train on the CPU
                from ray_tpu_torch.train.torch import get_device

                get_device()
            train_loop(config) if _takes_arg(train_loop) else train_loop()
            return {"rank": self.rank, "status": "done"}
        except Exception as e:
            return {"rank": self.rank, "status": "error",
                    "error": f"{e}\n{traceback.format_exc()}"}
        finally:
            air_session._set_session(None)


# reported-metric key -> exported Prometheus series (ray_tpu_torch/grafana.py
# train dashboard panels)
_TRAIN_GAUGE_KEYS = {
    "loss": "ray_tpu_torch_train_loss",
    "tokens_per_sec": "ray_tpu_torch_train_tokens_per_sec",
    "step_time_s": "ray_tpu_torch_train_step_seconds",
    "mfu": "ray_tpu_torch_train_mfu",
    "checkpoint_save_seconds": "ray_tpu_torch_checkpoint_save_seconds",
}


def _update_train_gauges(metrics: Dict[str, Any]) -> None:
    from ray_tpu_torch.util.metrics import get_or_create

    for key, series in _TRAIN_GAUGE_KEYS.items():
        v = metrics.get(key)
        if isinstance(v, (int, float)):
            get_or_create("gauge", series, f"train {key}").set(float(v))


def _takes_arg(fn: Callable) -> bool:
    import inspect

    try:
        return len(inspect.signature(fn).parameters) > 0
    except (TypeError, ValueError):
        return False


class DataParallelTrainer:
    """Runs `train_loop_per_worker` on `scaling_config.num_workers` actors.

    (reference: `python/ray/train/data_parallel_trainer.py:56`)
    """

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        self._train_loop = train_loop_per_worker
        self._config = dict(train_loop_config or {})
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self._datasets = dict(datasets or {})
        self._resume_checkpoint = resume_from_checkpoint

    def fit(self) -> Result:
        failures_left = self.run_config.failure_config.max_failures
        checkpoint = self._resume_checkpoint
        history: List[Dict[str, Any]] = []
        # elastic _shrink mutates the scaling config; work on a per-fit
        # copy so the caller's object (and the next fit) keep the original
        import dataclasses as _dc

        original_sc = self.scaling_config
        self.scaling_config = _dc.replace(original_sc)
        try:
            return self._fit_loop(failures_left, checkpoint, history)
        finally:
            self.scaling_config = original_sc

    def _fit_loop(self, failures_left, checkpoint, history) -> Result:
        while True:
            result = self._fit_once(checkpoint)
            # the returned Result spans ALL attempts: a recovered run's
            # pre-failure iterations are part of its history
            history.extend(result.metrics_history)
            if result.error is None or failures_left == 0:
                result.metrics_history = history
                return result
            failures_left -= 1
            checkpoint = result.checkpoint or checkpoint
            if (self.scaling_config.elastic
                    and isinstance(result.error, PlacementInfeasibleError)
                    and not self._shrink()):
                result.metrics_history = history
                return result  # nothing left to shrink to
            logger.warning("training attempt failed (%s); restarting "
                           "(%d retries left)", result.error, failures_left)

    def _shrink(self) -> bool:
        """Elastic topology shrink after a node loss: halve the worker
        count first (fewest moving parts), then the per-worker GPU grant.
        Returns False when already at 1 worker x 1 GPU."""
        sc = self.scaling_config
        if sc.num_workers > 1:
            sc.num_workers = max(1, sc.num_workers // 2)
        elif sc.resources_per_worker and sc.resources_per_worker.get("GPU", 0) > 1:
            sc.resources_per_worker = dict(sc.resources_per_worker)
            sc.resources_per_worker["GPU"] = max(
                1.0, sc.resources_per_worker["GPU"] // 2)
        elif (sc.resources_per_worker is None and sc.use_gpu
              and sc.gpus_per_worker > 1):
            # (gpus_per_worker only reaches worker_resources() when
            # resources_per_worker is unset)
            sc.gpus_per_worker = max(1, sc.gpus_per_worker // 2)
        else:
            return False
        logger.warning("elastic shrink: retrying with num_workers=%d, "
                       "resources=%s", sc.num_workers, sc.worker_resources())
        return True

    def _fit_once(self, checkpoint: Optional[Checkpoint]) -> Result:
        sc = self.scaling_config
        n = sc.num_workers
        bundle = sc.worker_resources()
        pg = placement_group([dict(bundle) for _ in range(n)], strategy=sc.strategy())
        if not pg.ready(timeout=60):
            remove_placement_group(pg)
            return Result(metrics={}, error=PlacementInfeasibleError(
                f"placement group infeasible: {n} x {bundle}"))
        queue = Queue()
        shards = self._make_dataset_shards(n)
        workers: List[Any] = []
        try:
            workers = [
                TrainWorker.options(
                    placement_group=pg, placement_group_bundle_index=i,
                    resources=dict(bundle),
                ).remote(i, n, queue, use_gpu=sc.use_gpu)
                for i in range(n)
            ]
            run_refs = [
                w.run.remote(self._train_loop, self._config, checkpoint,
                             shards[i] if shards else None)
                for i, w in enumerate(workers)
            ]
            return self._collect(queue, run_refs)
        finally:
            for w in workers:
                try:
                    ray_tpu_torch.kill(w)
                except Exception:
                    pass
            remove_placement_group(pg)

    def _make_dataset_shards(self, n: int) -> Optional[List[dict]]:
        if not self._datasets:
            return None
        shards: List[dict] = [dict() for _ in range(n)]
        for name, ds in self._datasets.items():
            if hasattr(ds, "streaming_split"):
                for i, it in enumerate(ds.streaming_split(n)):
                    shards[i][name] = it
            else:
                for i in range(n):
                    shards[i][name] = ds
        return shards

    def _collect(self, queue: Queue, run_refs) -> Result:
        ckpt_cfg = self.run_config.checkpoint_config
        history: List[Dict[str, Any]] = []
        checkpoints: List[tuple] = []  # (score, Checkpoint)
        latest_ckpt: Optional[Checkpoint] = None
        pending = list(run_refs)
        error: Optional[Exception] = None
        while pending:
            done, pending = ray_tpu_torch.wait(pending, num_returns=1, timeout=0.2)
            for entry in queue.get_batch(1000):
                if "metrics" in entry and entry["rank"] == 0:
                    history.append(entry["metrics"])
                    _update_train_gauges(entry["metrics"])
                if "checkpoint" in entry:
                    latest_ckpt = entry["checkpoint"]
                    score = None
                    if ckpt_cfg.checkpoint_score_attribute:
                        score = entry.get("metrics", {}).get(
                            ckpt_cfg.checkpoint_score_attribute)
                    checkpoints.append((score, latest_ckpt))
                    if ckpt_cfg.num_to_keep:
                        checkpoints = self._prune(checkpoints, ckpt_cfg)
            for ref in done:
                try:
                    status = ray_tpu_torch.get(ref)
                    if status.get("status") == "error":
                        error = RuntimeError(status["error"])
                except Exception as e:
                    error = e
        # drain any remaining reports
        for entry in queue.get_batch(10000):
            if "metrics" in entry and entry["rank"] == 0:
                history.append(entry["metrics"])
            if "checkpoint" in entry:
                latest_ckpt = entry["checkpoint"]
        best = self._best_checkpoint(checkpoints, ckpt_cfg) or latest_ckpt
        return Result(
            metrics=history[-1] if history else {},
            checkpoint=best,
            error=error,
            metrics_history=history,
        )

    @staticmethod
    def _prune(checkpoints: List[tuple], cfg: CheckpointConfig) -> List[tuple]:
        if cfg.checkpoint_score_attribute is None:
            return checkpoints[-cfg.num_to_keep:]
        reverse = cfg.checkpoint_score_order == "max"
        ranked = sorted([c for c in checkpoints if c[0] is not None],
                        key=lambda t: t[0], reverse=reverse)
        unscored = [c for c in checkpoints if c[0] is None]
        return (ranked + unscored)[:cfg.num_to_keep]

    def _best_checkpoint(self, checkpoints, cfg) -> Optional[Checkpoint]:
        if not checkpoints:
            return None
        scored = [c for c in checkpoints if c[0] is not None]
        if cfg.checkpoint_score_attribute and scored:
            reverse = cfg.checkpoint_score_order == "max"
            return sorted(scored, key=lambda t: t[0], reverse=reverse)[0][1]
        return checkpoints[-1][1]


class MeshTrainer(DataParallelTrainer):
    """DataParallelTrainer whose workers drive their cards through one
    torch.distributed world (the reference's `JaxTrainer`,
    `ray_tpu/train/trainer.py:296`).

    The torch-era `TorchTrainer` equivalent (reference
    `python/ray/train/torch/torch_trainer.py`): instead of wrapping models
    in DDP, the train loop builds a `DeviceMesh` over the group's cards via
    `ray_tpu_torch.parallel` and runs the sharded step; `prepare_mesh()`
    below is the analog of `prepare_model`: it joins the group's NCCL world
    (`initialize_from_session`) if no world is up yet, and returns the mesh
    over it.
    """

    @staticmethod
    def prepare_mesh(mesh_config=None, *, device="cuda"):
        from ray_tpu_torch.parallel import (MeshConfig,
                                            initialize_from_session,
                                            make_mesh)
        from ray_tpu_torch.parallel import distributed

        if distributed._initialized_group is None:
            initialize_from_session(device=device)
        cfg = mesh_config or MeshConfig()
        return make_mesh(cfg, device=device)
