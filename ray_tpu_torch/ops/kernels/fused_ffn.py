"""Fused FFN block (twin of ray_tpu/ops/pallas/fused_ffn.py:150-306):
rmsnorm -> gate/up -> swiglu -> down + residual, with a hand-written
backward.

`ffn_block` is an autograd.Function that saves `x2d, rstd, gate, up` (the
set the reference saves) and re-runs no forward matmul in its backward.
Of the reference's three Pallas kernels only K3 is on by default
(`USE_K3 = True`, `USE_K1/K2 = False`), so the port has K3 alone:

  K3  dW_gate = hᵀ·dgate, dW_up = hᵀ·dup  with h = x·rstd·norm_w
      recomputed per tile and never stored — `dw_gateup`, the CUDA kernel
      in csrc/fused_ffn.cu;

and computes the rest in plain torch, as the reference's defaults do:
dW_down = swiglu(gate, up)ᵀ·dy, d_s = dy·W_downᵀ with the swiglu VJP, dh
through the gate/up weights and the rmsnorm VJP.

On a CUDA tensor `dw_gateup` launches its kernel or raises (bfloat16 only);
`dw_gateup_plain` runs for tensors on the CPU. The kernel masks ragged
edges itself, so no (T, d, d_ff) tiling guard exists on either side.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ray_tpu_torch.ops.kernels._util import check, load_library, stream_handle

_P, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "rt_dw_gateup": ([_P, _P, _P, _P, _P, _P, _P, _INT, _INT, _INT, _P],
                     _INT),
}


def _lib() -> ctypes.CDLL:
    return load_library("fused_ffn", _SIGNATURES)


def _silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def _dsilu(x: torch.Tensor) -> torch.Tensor:
    s = torch.sigmoid(x)
    return s * (1.0 + x * (1.0 - s))


def normed(x2d: torch.Tensor, rstd: torch.Tensor,
           norm_w: torch.Tensor) -> torch.Tensor:
    """h = (x·rstd)·norm_w in float32, rounded to x's dtype."""
    return (x2d.float() * rstd * norm_w.float()).to(x2d.dtype)


def rms_normed(x: torch.Tensor, norm_w: torch.Tensor, eps: float):
    """(rstd in float32 [..., 1], h = normed(x, rstd, norm_w)): the rmsnorm
    both fused blocks open with."""
    xf = x.float()
    rstd = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return rstd, normed(x, rstd, norm_w)


def dw_gateup_plain(x2d, rstd, norm_w, dgate, dup
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K3: float32 products of the rounded h."""
    h = normed(x2d, rstd, norm_w).float()
    dwg = torch.matmul(h.T, dgate.float()).to(dgate.dtype)
    dwu = torch.matmul(h.T, dup.float()).to(dup.dtype)
    return dwg, dwu


def dw_gateup(x2d: torch.Tensor, rstd: torch.Tensor, norm_w: torch.Tensor,
              dgate: torch.Tensor, dup: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x2d [T, d], rstd [T, 1] float32, norm_w [d], dgate/dup [T, d_ff] ->
    (dW_gate, dW_up), each [d, d_ff] in dgate's dtype."""
    T, d = x2d.shape
    dff = dgate.shape[1]
    if rstd.shape != (T, 1) or norm_w.shape != (d,) \
            or dgate.shape != (T, dff) or dup.shape != (T, dff):
        raise ValueError(
            f"dw_gateup: shapes x {tuple(x2d.shape)}, rstd "
            f"{tuple(rstd.shape)}, norm_w {tuple(norm_w.shape)}, dgate "
            f"{tuple(dgate.shape)}, dup {tuple(dup.shape)} do not match")
    tensors = (x2d, rstd, norm_w, dgate, dup)
    if all(t.device.type == "cpu" for t in tensors):
        return dw_gateup_plain(x2d, rstd, norm_w, dgate, dup)
    dev = x2d.device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"dw_gateup: every tensor must be on one CUDA "
                             f"device (the plain version serves the CPU), "
                             f"got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("dw_gateup: tensors must be contiguous and "
                             "16-byte aligned")
    if any(t.dtype != torch.bfloat16 for t in (x2d, norm_w, dgate, dup)) \
            or rstd.dtype != torch.float32:
        raise TypeError(f"dw_gateup: the CUDA kernel takes bfloat16 x, "
                        f"norm_w, dgate, dup and float32 rstd, got "
                        f"{[t.dtype for t in tensors]}")
    dwg = torch.empty((d, dff), dtype=dgate.dtype, device=dev)
    dwu = torch.empty((d, dff), dtype=dup.dtype, device=dev)
    if d and dff:  # T == 0 runs no token step and writes zeros
        lib = _lib()
        check(lib, lib.rt_dw_gateup(
            x2d.data_ptr(), rstd.data_ptr(), norm_w.data_ptr(),
            dgate.data_ptr(), dup.data_ptr(), dwg.data_ptr(), dwu.data_ptr(),
            T, d, dff, stream_handle(x2d)), "dw_gateup")
        dw_gateup.launches += 1
    return dwg, dwu


# ---------------------------------------------------------------- block


def _fwd_impl(x2d, nw, wg, wu, wd, eps):
    rstd, h = rms_normed(x2d, nw, eps)
    gate = h @ wg
    up = h @ wu
    out = (_silu(gate.float()).to(x2d.dtype) * up) @ wd
    return x2d + out.to(x2d.dtype), rstd, gate, up


def _rmsnorm_vjp(x2d, rstd, nw, dh, dy2d):
    """(dx, dnw) of y = x + f(rmsnorm(x)) given dh = ∂L/∂rmsnorm(x) in
    float32 and the residual cotangent dy2d."""
    d = x2d.shape[-1]
    xf = x2d.float()
    wdh = dh * nw.float()
    proj = (wdh * xf).sum(dim=-1, keepdim=True) / d
    dx = (rstd * (wdh - xf * rstd * rstd * proj) + dy2d.float()).to(x2d.dtype)
    dnw = (dh * xf * rstd).sum(dim=0).to(nw.dtype)
    return dx, dnw


class FFNBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, norm_w, w_gate, w_up, w_down, eps):
        shape = x.shape
        x2d = x.reshape(-1, shape[-1])
        y, rstd, gate, up = _fwd_impl(x2d, norm_w, w_gate, w_up, w_down, eps)
        ctx.save_for_backward(x2d, rstd, gate, up, norm_w, w_gate, w_up,
                              w_down)
        ctx.shape = shape
        return y.reshape(shape)

    @staticmethod
    def backward(ctx, dy):
        x2d, rstd, gate, up, nw, wg, wu, wd = ctx.saved_tensors
        shape = ctx.shape
        dy2d = dy.reshape(-1, shape[-1])
        gf, uf = gate.float(), up.float()
        # dW_down and d_s (the reference's defaults, USE_K1/K2 = False)
        s_act = (_silu(gf) * uf).to(gate.dtype)
        dwd = (s_act.T @ dy2d).to(wd.dtype)
        ds = (dy2d @ wd.T).float()
        dgate = (ds * uf * _dsilu(gf)).to(gate.dtype)
        dup = (ds * _silu(gf)).to(up.dtype)
        del ds, s_act
        # K3
        dwg, dwu = dw_gateup(x2d.contiguous(), rstd.contiguous(),
                             nw.contiguous(), dgate, dup)
        # dh through the gate/up projections, then the rmsnorm VJP
        dh = (dgate @ wg.T).float() + (dup @ wu.T).float()
        dx, dnw = _rmsnorm_vjp(x2d, rstd, nw, dh, dy2d)
        return dx.reshape(shape), dnw, dwg.to(wg.dtype), dwu.to(wu.dtype), \
            dwd, None


def ffn_block(x: torch.Tensor, norm_w: torch.Tensor, w_gate: torch.Tensor,
              w_up: torch.Tensor, w_down: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """x [..., d] -> x + W_down(swiglu(Wg(rmsnorm(x)), Wu(rmsnorm(x)))).
    The swiglu is `silu(gate in float32)` rounded to x's dtype, times up."""
    return FFNBlock.apply(x, norm_w, w_gate, w_up, w_down, eps)


# Launch count: the wrapper adds one where it launches its kernel, and
# nowhere else (the CPU path launches nothing).
dw_gateup.launches = 0
KERNELS = (dw_gateup,)
