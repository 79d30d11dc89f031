"""Training: the single-device step and its optimizer."""

from ray_tpu_torch.train.step import (AdamWState, TrainState,
                                      default_optimizer,
                                      fused_adamw_optimizer, make_init_fn,
                                      make_train_step,
                                      warmup_cosine_decay_schedule)

__all__ = ["AdamWState", "TrainState", "default_optimizer",
           "fused_adamw_optimizer", "make_init_fn", "make_train_step",
           "warmup_cosine_decay_schedule"]
