"""Device ops: elementwise/normalization layers and hand-written kernels."""

from ray_tpu_torch.ops.layers import (apply_rotary, rms_norm,
                                      rotary_embedding, swiglu)

__all__ = ["apply_rotary", "rms_norm", "rotary_embedding", "swiglu"]
