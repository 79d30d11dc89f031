"""Training: the step (one device, or sharded dp x fsdp over a mesh), its
optimizers and checkpoints."""

from ray_tpu_torch.train.checkpointing import (abstract_like, gc_checkpoints,
                                               latest_checkpoint,
                                               load_checkpoint,
                                               restore_sharded,
                                               save_checkpoint, save_sharded)
from ray_tpu_torch.train.step import (AdamWState, TrainState,
                                      batch_sharding, default_optimizer,
                                      fused_adamw_optimizer, make_init_fn,
                                      make_train_step, shard_batch,
                                      shard_state, state_shardings,
                                      to_local,
                                      warmup_cosine_decay_schedule)

__all__ = ["AdamWState", "TrainState", "abstract_like", "batch_sharding",
           "default_optimizer", "fused_adamw_optimizer", "gc_checkpoints",
           "latest_checkpoint", "load_checkpoint", "make_init_fn",
           "make_train_step", "restore_sharded", "save_checkpoint",
           "save_sharded", "shard_batch", "shard_state", "state_shardings",
           "to_local", "warmup_cosine_decay_schedule"]
