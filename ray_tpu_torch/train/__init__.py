"""Training: the step (one device, or sharded over a mesh), its optimizers
and checkpoints; the trainers that run a loop on a worker group
(`DataParallelTrainer`, `MeshTrainer`, `TorchTrainer`'s module
`train.torch`, `TransformersTrainer`, `SklearnTrainer`, the GBDT trainers)
and the predictors that serve a checkpoint (`TorchPredictor`,
`BatchPredictor`)."""

from ray_tpu_torch.train.checkpointing import (abstract_like, gc_checkpoints,
                                               latest_checkpoint,
                                               load_checkpoint,
                                               restore_sharded,
                                               save_checkpoint, save_sharded)
from ray_tpu_torch.train.gbdt import (GBDTPredictor, GBDTTrainer,
                                      LightGBMPredictor, LightGBMTrainer,
                                      XGBoostPredictor, XGBoostTrainer)
from ray_tpu_torch.train.huggingface import TransformersTrainer
from ray_tpu_torch.train.predictor import (BatchPredictor, Predictor,
                                           TorchPredictor)
from ray_tpu_torch.train.sklearn import SklearnPredictor, SklearnTrainer
from ray_tpu_torch.train.step import (AdamWState, TrainState,
                                      batch_sharding, default_optimizer,
                                      fused_adamw_optimizer, make_init_fn,
                                      make_train_step, shard_batch,
                                      shard_state, state_shardings,
                                      to_local,
                                      warmup_cosine_decay_schedule)
from ray_tpu_torch.train.trainer import DataParallelTrainer, MeshTrainer

__all__ = ["AdamWState", "BatchPredictor", "DataParallelTrainer",
           "GBDTPredictor", "GBDTTrainer", "LightGBMPredictor",
           "LightGBMTrainer", "MeshTrainer", "Predictor",
           "SklearnPredictor", "SklearnTrainer", "TorchPredictor",
           "TrainState", "TransformersTrainer", "XGBoostPredictor",
           "XGBoostTrainer", "abstract_like", "batch_sharding",
           "default_optimizer", "fused_adamw_optimizer", "gc_checkpoints",
           "latest_checkpoint", "load_checkpoint", "make_init_fn",
           "make_train_step", "restore_sharded", "save_checkpoint",
           "save_sharded", "shard_batch", "shard_state", "state_shardings",
           "to_local", "warmup_cosine_decay_schedule"]
