"""Hand-written CUDA kernels for Hopper (sm_90a), one module per TPU kernel
file of ray_tpu/ops/pallas. Sources live in ``csrc/`` and are built by
``_util.build`` at first use; nothing is compiled at import.

The public entries `flash_attention_packed`, `rms_norm_fused` and
`softmax_cross_entropy` are the twins of ray_tpu.ops.pallas's entries of the
first name, `rms_norm_pallas` and `softmax_cross_entropy_pallas`.
"""

from ray_tpu_torch.ops.kernels.adamw import adamw_update
from ray_tpu_torch.ops.kernels.flash_attention import (flash_attention_packed,
                                                       flash_bwd,
                                                       flash_bwd_dkv,
                                                       flash_bwd_dq,
                                                       flash_fwd)
from ray_tpu_torch.ops.kernels.fused_ffn import dgateup, dw_down, dw_gateup
from ray_tpu_torch.ops.kernels.quant import dequantize_int8, quantize_int8
from ray_tpu_torch.ops.kernels.rmsnorm import (rms_norm_bwd_dx, rms_norm_fused,
                                               rms_norm_fwd)
from ray_tpu_torch.ops.kernels.xent import (softmax_cross_entropy, xent_bwd,
                                            xent_fwd)

__all__ = ["adamw_update", "dequantize_int8", "dgateup", "dw_down",
           "dw_gateup", "flash_attention_packed", "flash_bwd",
           "flash_bwd_dkv", "flash_bwd_dq", "flash_fwd", "quantize_int8", "rms_norm_bwd_dx", "rms_norm_fused",
           "rms_norm_fwd", "softmax_cross_entropy", "xent_bwd", "xent_fwd"]
