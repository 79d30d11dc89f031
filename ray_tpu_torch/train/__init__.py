"""Training: the single-device step, its optimizer and checkpoints."""

from ray_tpu_torch.train.checkpointing import (abstract_like, gc_checkpoints,
                                               latest_checkpoint,
                                               load_checkpoint,
                                               restore_sharded,
                                               save_checkpoint, save_sharded)
from ray_tpu_torch.train.step import (AdamWState, TrainState,
                                      default_optimizer,
                                      fused_adamw_optimizer, make_init_fn,
                                      make_train_step,
                                      warmup_cosine_decay_schedule)

__all__ = ["AdamWState", "TrainState", "abstract_like", "default_optimizer",
           "fused_adamw_optimizer", "gc_checkpoints", "latest_checkpoint",
           "load_checkpoint", "make_init_fn", "make_train_step",
           "restore_sharded", "save_checkpoint", "save_sharded",
           "warmup_cosine_decay_schedule"]
