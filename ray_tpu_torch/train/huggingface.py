"""TransformersTrainer: HuggingFace transformers.Trainer on the worker group.

Reference parity: python/ray/train/huggingface/huggingface_trainer.py — the
user supplies `trainer_init_per_worker(train_dataset, eval_dataset,
**config) -> transformers.Trainer`; each worker actor joins the torch gloo
process group (TorchTrainer machinery), materializes its Datastream shard
as a torch Dataset, builds the HF Trainer (HF's own code then drives DDP),
and a reporting callback forwards HF logs to `session.report` so Tune
schedulers see them. Rank 0 checkpoints the model state_dict at the end.

The port's own models train through `MeshTrainer`; this exists, like
TorchTrainer, so reference users' HF fine-tuning scripts port over
unchanged: on gloo by default, on NCCL and the grant's card with
`ScalingConfig(use_gpu=True)` (TorchTrainer's rule).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air import Checkpoint
from ray_tpu_torch.air import session as air_session
from ray_tpu_torch.train.torch import TorchConfig, TorchTrainer


def _shard_to_torch_dataset(shard):
    """Materialize a DataIterator / Datastream shard into an in-memory
    torch map-style dataset of row dicts."""
    if shard is None:
        return None
    import torch.utils.data as tud

    rows = list(shard.iter_rows())

    class _RowsDataset(tud.Dataset):
        def __len__(self):
            return len(rows)

        def __getitem__(self, i):
            return rows[i]

    return _RowsDataset()


def _make_loop(trainer_init_per_worker: Callable):
    def loop(config: Dict[str, Any]):
        import transformers

        train_ds = _shard_to_torch_dataset(
            air_session.get_dataset_shard("train"))
        eval_ds = _shard_to_torch_dataset(
            air_session.get_dataset_shard("evaluation"))
        hf_trainer = trainer_init_per_worker(train_ds, eval_ds, **config)

        class _ReportCallback(transformers.TrainerCallback):
            def on_log(self, args, state, control, logs=None, **kwargs):
                if logs:
                    air_session.report(
                        {**logs, "step": state.global_step,
                         "epoch": state.epoch})

        hf_trainer.add_callback(_ReportCallback())
        result = hf_trainer.train()
        final = dict(result.metrics or {})
        ckpt = None
        if air_session.get_world_rank() == 0:
            model = hf_trainer.model
            # unwrap DDP if HF wrapped it
            state_dict = getattr(model, "module", model).state_dict()
            ckpt = Checkpoint.from_dict({
                "state_dict": {k: v.cpu().numpy()
                               for k, v in state_dict.items()},
            })
        air_session.report(final, checkpoint=ckpt)

    return loop


class TransformersTrainer(TorchTrainer):
    """(reference `HuggingFaceTrainer`, huggingface_trainer.py)."""

    def __init__(self, trainer_init_per_worker: Callable, *,
                 trainer_init_config: Optional[Dict[str, Any]] = None,
                 torch_config: Optional[TorchConfig] = None, **kwargs):
        super().__init__(
            _make_loop(trainer_init_per_worker),
            train_loop_config=trainer_init_config,
            torch_config=torch_config, **kwargs)
