"""Elementwise/normalization building blocks (twin of ray_tpu/ops/layers.py).

Plain PyTorch: statistics and rotations are computed in float32 and cast
back to the input dtype, exactly where the JAX reference casts.
"""

from __future__ import annotations

from typing import Tuple

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm: x * w / sqrt(mean(x^2)). Computed in fp32, cast back."""
    dtype = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * weight.float()).to(dtype)


def rotary_embedding(positions: torch.Tensor, head_dim: int,
                     theta: float = 500000.0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE cos/sin tables [..., seq, hd/2] for the given positions."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=positions.device) / head_dim
    freqs = 1.0 / (theta ** exps)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """Apply RoPE (half-split rotate) to [..., seq, heads, head_dim] given
    [..., seq, hd/2] tables."""
    x1, x2 = x.float().chunk(2, dim=-1)
    cos = cos[..., :, None, :]  # broadcast over the heads axis
    sin = sin[..., :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x_gate: torch.Tensor, x_up: torch.Tensor) -> torch.Tensor:
    """SwiGLU activation: silu(gate) * up, with silu(x) = x * logistic(x)
    and logistic(x) = 1 / (1 + exp(-x)) written out op by op, so a bfloat16
    input rounds after each op as the reference's jax.nn.silu does (a fused
    silu rounds once and lands up to 2 ulp away)."""
    sig = 1.0 / (1.0 + torch.exp(-x_gate))
    return x_gate * sig * x_up
