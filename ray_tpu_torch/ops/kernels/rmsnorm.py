"""Fused RMSNorm, forward and backward (twin of
ray_tpu/ops/pallas/rmsnorm.py).

  * `rms_norm_fwd(x2d, w, eps)` -> (out, rstd):
    out = x·rsqrt(mean(x²)+eps)·w computed in float32 and rounded once to
    x's dtype; rstd is stored `[rows]` float32 (the reference stores
    `[rows, 1]`);
  * `rms_norm_bwd_dx(x2d, w, rstd, g2d)` ->
    dx = rstd·(w·g − x·rstd²·Σ(w·g·x)/d);
  * `RMSNorm`, the autograd.Function around the pair; dw stays a plain
    float32 reduction over the rows, as the reference leaves it to XLA;
  * `rms_norm_fused(x, weight, eps)`, the twin of `rms_norm_pallas`: any
    leading shape, eps not differentiable.

On a CUDA tensor each wrapper launches its hand-written kernel
(csrc/rmsnorm.cu) or raises; the plain PyTorch versions beside them run only
for tensors on the CPU. x and w are float32 or bfloat16, each on its own.
Like the reference's, the entry is called by no model path:
`ops.layers.rms_norm` and the fused blocks' norms stay plain.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ray_tpu_torch.ops.kernels._util import (check, check_cuda,
                                             load_library, rows_vectorized,
                                             stream_handle)

_P, _I64, _INT, _F = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                      ctypes.c_float)
_SIGNATURES = {
    "rt_rmsnorm_fwd": ([_P, _P, _P, _P, _INT, _INT, _INT, _I64, _I64, _F,
                        _P], _INT),
    "rt_rmsnorm_bwd_dx": ([_P, _P, _P, _P, _P, _INT, _INT, _INT, _I64, _I64,
                           _P], _INT),
}
_FLOAT_TYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    return load_library("rmsnorm", _SIGNATURES)


def rms_norm_fwd_plain(x2d: torch.Tensor, w: torch.Tensor, eps: float
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel."""
    xf = x2d.float()
    rstd = torch.rsqrt((xf * xf).mean(dim=-1) + eps)
    return (xf * rstd[:, None] * w.float()).to(x2d.dtype), rstd


def rms_norm_bwd_dx_plain(x2d: torch.Tensor, w: torch.Tensor,
                          rstd: torch.Tensor, g2d: torch.Tensor
                          ) -> torch.Tensor:
    """Plain PyTorch version of the dx kernel, in the reference's order."""
    xf = x2d.float()
    wg = w.float() * g2d.float()
    proj = (wg * xf).sum(dim=-1, keepdim=True) / x2d.shape[-1]
    r = rstd[:, None]
    return (r * (wg - xf * r * r * proj)).to(x2d.dtype)


def _check_args(x2d, w, what: str) -> None:
    if x2d.dim() != 2 or x2d.shape[-1] == 0 or w.shape != x2d.shape[-1:]:
        raise ValueError(f"{what}: needs x [rows, d] with d > 0 and w [d], "
                         f"got {tuple(x2d.shape)}, {tuple(w.shape)}")
    if x2d.dtype not in _FLOAT_TYPES or w.dtype not in _FLOAT_TYPES:
        raise TypeError(f"{what}: x and w must be in {_FLOAT_TYPES}, got "
                        f"{x2d.dtype}, {w.dtype}")


def rms_norm_fwd(x2d: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [rows, d], w [d] -> (out [rows, d] in x's dtype, rstd [rows]
    float32)."""
    _check_args(x2d, w, "rms_norm_fwd")
    if x2d.device.type == "cpu" and w.device.type == "cpu":
        return rms_norm_fwd_plain(x2d, w, eps)
    check_cuda((x2d, w), "rms_norm_fwd")
    rows, d = x2d.shape
    out = torch.empty_like(x2d)
    rstd = torch.empty((rows,), dtype=torch.float32, device=x2d.device)
    if rows:
        lib = _lib()
        check(lib, lib.rt_rmsnorm_fwd(
            x2d.data_ptr(), w.data_ptr(), out.data_ptr(), rstd.data_ptr(),
            int(x2d.dtype == torch.bfloat16), int(w.dtype == torch.bfloat16),
            int(rows_vectorized(x2d, w, out)), rows, d, float(eps),
            stream_handle(x2d)), "rms_norm_fwd")
        rms_norm_fwd.launches += 1
    return out, rstd


def rms_norm_bwd_dx(x2d: torch.Tensor, w: torch.Tensor, rstd: torch.Tensor,
                    g2d: torch.Tensor) -> torch.Tensor:
    """dx [rows, d] in x's dtype from x, w, the forward's rstd [rows]
    float32 and the output cotangent g [rows, d] of x's dtype."""
    _check_args(x2d, w, "rms_norm_bwd_dx")
    if g2d.shape != x2d.shape or rstd.shape != x2d.shape[:1]:
        raise ValueError(f"rms_norm_bwd_dx: g {tuple(g2d.shape)} and rstd "
                         f"{tuple(rstd.shape)} do not match x "
                         f"{tuple(x2d.shape)}")
    if g2d.dtype != x2d.dtype or rstd.dtype != torch.float32:
        raise TypeError(f"rms_norm_bwd_dx: needs g of x's dtype and float32 "
                        f"rstd, got {g2d.dtype}, {rstd.dtype}")
    tensors = (x2d, w, rstd, g2d)
    if all(t.device.type == "cpu" for t in tensors):
        return rms_norm_bwd_dx_plain(x2d, w, rstd, g2d)
    check_cuda(tensors, "rms_norm_bwd_dx")
    rows, d = x2d.shape
    dx = torch.empty_like(x2d)
    if rows:
        lib = _lib()
        check(lib, lib.rt_rmsnorm_bwd_dx(
            x2d.data_ptr(), w.data_ptr(), rstd.data_ptr(), g2d.data_ptr(),
            dx.data_ptr(), int(x2d.dtype == torch.bfloat16),
            int(w.dtype == torch.bfloat16),
            int(rows_vectorized(x2d, w, g2d, dx)), rows, d,
            stream_handle(x2d)), "rms_norm_bwd_dx")
        rms_norm_bwd_dx.launches += 1
    return dx


def rms_norm_dw(x2d: torch.Tensor, rstd: torch.Tensor, g2d: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """dw = Σ_rows g·x·rstd in float32, cast to the weight's dtype (plain
    PyTorch on every device, as the reference leaves it to XLA)."""
    return (g2d.float() * x2d.float() * rstd[:, None]).sum(dim=0).to(dtype)


class RMSNorm(torch.autograd.Function):
    """out = rms_norm(x2d, w) with the fused kernels in both directions
    (twin of `rms_norm_pallas`'s custom VJP); eps gets no gradient."""

    @staticmethod
    def forward(ctx, x2d, weight, eps: float):
        out, rstd = rms_norm_fwd(x2d, weight, eps)
        ctx.save_for_backward(x2d, weight, rstd)
        return out

    @staticmethod
    def backward(ctx, g):
        x2d, weight, rstd = ctx.saved_tensors
        g2d = g.contiguous()
        dx = (rms_norm_bwd_dx(x2d, weight, rstd, g2d)
              if ctx.needs_input_grad[0] else None)
        dw = (rms_norm_dw(x2d, rstd, g2d, weight.dtype)
              if ctx.needs_input_grad[1] else None)
        return dx, dw, None


def rms_norm_fused(x: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Fused RMSNorm over the last axis, any leading shape (twin of
    `rms_norm_pallas`)."""
    if x.dim() == 0:
        raise ValueError("rms_norm_fused: x needs a last axis to normalise")
    shape = x.shape
    x2d = x.reshape(-1, shape[-1]).contiguous()
    return RMSNorm.apply(x2d, weight.contiguous(), float(eps)).reshape(shape)


# Launch counts: each wrapper adds one where it launches its kernel, and
# nowhere else (the CPU path launches nothing).
rms_norm_fwd.launches = 0
rms_norm_bwd_dx.launches = 0
KERNELS = (rms_norm_fwd, rms_norm_bwd_dx)
