"""Models: the flagship decoder-only transformer's serving path."""

from ray_tpu_torch.models.transformer import (ModelConfig, count_params,
                                              init_params)

__all__ = ["ModelConfig", "count_params", "init_params"]
