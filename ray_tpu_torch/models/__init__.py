"""Models: the flagship decoder-only transformer, its serving and training
paths."""

from ray_tpu_torch.models.transformer import (ModelConfig, count_params,
                                              forward, init_params, loss_fn)

__all__ = ["ModelConfig", "count_params", "forward", "init_params",
           "loss_fn"]
