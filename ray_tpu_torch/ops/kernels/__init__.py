"""Hand-written CUDA kernels for Hopper (sm_90a), one module per TPU kernel
file of ray_tpu/ops/pallas. Sources live in ``csrc/`` and are built by
``_util.build`` at first use; nothing is compiled at import."""

from ray_tpu_torch.ops.kernels.quant import dequantize_int8, quantize_int8

__all__ = ["dequantize_int8", "quantize_int8"]
