"""Fused FFN block (twin of ray_tpu/ops/pallas/fused_ffn.py:150-306):
rmsnorm -> gate/up -> swiglu -> down + residual, with a hand-written
backward.

`ffn_block` is an autograd.Function that saves `x2d, rstd, gate, up` (the
set the reference saves) and re-runs no forward matmul in its backward. The
backward has the reference's three kernels (csrc/fused_ffn.cu), each behind
its module flag, read at every call:

  K1  dW_down = swiglu(gate, up)ᵀ·dy with the swiglu computed in registers
      as the product's operand — `dw_down` (USE_K1, default off);
  K2  d_s = dy·W_downᵀ accumulated in float32 and never stored, then
      dgate = d_s·up·silu'(gate), dup = d_s·silu(gate) — `dgateup` (USE_K2,
      default off);
  K3  dW_gate = hᵀ·dgate, dW_up = hᵀ·dup with h = x·rstd·norm_w recomputed
      per tile and never stored — `dw_gateup` (USE_K3, default on);

the defaults are the reference's (`fused_ffn.py:59-61`). A flag that is off
runs the reference's own XLA-side math in plain torch (as the reference's
`_vjp_bwd` does); dh through the gate/up weights and the rmsnorm VJP are
always plain torch, as in the reference.

On a CUDA tensor each kernel wrapper launches its kernel or raises: the
kernels take bfloat16 or float32 tensors of one dtype (`KERNEL_DTYPES`, the
reference keeps the model's dtype; rstd is always float32), and each
wrapper counts its launches in `.launches` and the float32 kernel's share
in `.f32_launches`. Its `*_plain` twin runs for tensors on the CPU. The
kernels mask ragged edges themselves, so no (T, d, d_ff) tiling guard
exists on either side. The float32 K1, K2 and K3 also take a plan from the
shape (`f32_plan`: the output tile, and a split of the reduction where the
tiles alone would leave most of the card idle) and, when split, a float32
workspace the wrapper allocates; the split is summed in a fixed order, so
every call gives the same bits. The float32 K3 writes dW_gate and dW_up as
the two halves of one [2, d, d_ff] tensor.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Tuple

import torch

from ray_tpu_torch.ops.kernels._util import (KERNEL_DTYPES, WAVE_BLOCKS,
                                             cdiv, check, count_launch,
                                             dtype_entry, stream_handle,
                                             with_f32)
from ray_tpu_torch.parallel.tensor import all_reduce_

_P, _INT = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    **with_f32({
        "rt_dw_gateup": ([_P, _P, _P, _P, _P, _P, _P, _INT, _INT, _INT, _P],
                         _INT),
        "rt_dw_down": ([_P, _P, _P, _P, _INT, _INT, _INT, _P], _INT),
        "rt_dgateup": ([_P, _P, _P, _P, _P, _P, _INT, _INT, _INT, _P], _INT),
    }),
    # the float32 kernels also take their plan's workspace, tile and
    # splits (`f32_plan`)
    "rt_dw_gateup_f32": ([_P, _P, _P, _P, _P, _P, _P, _P, _INT, _INT, _INT,
                          _INT, _INT, _P], _INT),
    "rt_dw_down_f32": ([_P, _P, _P, _P, _P, _INT, _INT, _INT, _INT, _INT,
                        _P], _INT),
    "rt_dgateup_f32": ([_P, _P, _P, _P, _P, _P, _P, _INT, _INT, _INT, _INT,
                        _INT, _P], _INT),
}

# Which backward kernels run (the reference's defaults, fused_ffn.py:59-61);
# FFNBlock.backward reads them at every call.
USE_K1 = False
USE_K2 = False
USE_K3 = True


def _entry(name: str, dtype: torch.dtype):
    return dtype_entry("fused_ffn", _SIGNATURES, name, dtype)


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


def swiglu_act(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """bf16(silu(gate in float32) · up in float32): the activation that
    W_down multiplies, rounded to gate's dtype."""
    return (_silu(gate.float()) * up.float()).to(gate.dtype)


class F32Plan(NamedTuple):
    """How the float32 K1, K2 and K3 cut an M x N product over K: `tile`
    x `tile` output tiles, the reduction in `splits` slices of whole stages
    (csrc/fused_ffn.cu, "float32 K1, K2, K3")."""
    tile: int
    splits: int


F32_TILES = (128, 64)  # the block tiles the float32 mainloop takes
F32_STAGE = 16         # of the reduction a stage of its ring holds


def f32_plan(M: int, N: int, K: int, outputs: int = 1) -> F32Plan:
    """The largest tile whose output tiles alone make a wave (S = 1); where
    none does, 64 x 64 tiles and the reduction split into as many slices as
    bring the grid to a wave, each at least one stage long. `outputs`
    products of this shape run side by side (K3's two: a block each)."""
    for tile in F32_TILES:
        if cdiv(M, tile) * cdiv(N, tile) * outputs >= WAVE_BLOCKS:
            return F32Plan(tile, 1)
    tile = F32_TILES[-1]
    tiles = cdiv(M, tile) * cdiv(N, tile) * outputs
    return F32Plan(tile, max(1, min(cdiv(WAVE_BLOCKS, tiles),
                                    cdiv(K, F32_STAGE))))


def f32_slices(K: int, splits: int) -> List[Tuple[int, int]]:
    """[k0, k1) of each slice of the reduction, in slice order: slice s
    takes stages [s·n // S, (s + 1)·n // S) of the n = cdiv(K, 16) (as the
    kernels' `f32_slice` does)."""
    n = cdiv(K, F32_STAGE)
    return [(s * n // splits * F32_STAGE,
             min(K, (s + 1) * n // splits * F32_STAGE))
            for s in range(splits)]


def f32_launch_plan(M: int, N: int, K: int, device, outputs: int = 1,
                    plan: Optional[F32Plan] = None
                    ) -> Tuple[F32Plan, Optional[torch.Tensor]]:
    """The plan of `outputs` M x N products over K (`f32_plan`'s, unless
    `plan` is given) and the float32 workspace their partial tiles go to,
    [splits, M, N] (one output) or [splits, outputs, M, N] (None when
    splits is 1)."""
    plan = plan or f32_plan(M, N, K, outputs)
    shape = (M, N) if outputs == 1 else (outputs, M, N)
    ws = (torch.empty((plan.splits, *shape), dtype=torch.float32,
                      device=device) if plan.splits > 1 else None)
    return plan, ws


def _launch(what: str, dtype, pointers, dims, plan_dims, stream,
            outputs: int = 1) -> None:
    """Calls the C entry `rt_<what>` for `dtype`: the float32 kernels
    take their plan's workspace, tile and splits after the tensors
    (plan_dims: that product's M, N, K; `outputs` such products)."""
    lib, fn = _entry(f"rt_{what}", dtype)
    if dtype == torch.float32:
        plan, ws = f32_launch_plan(*plan_dims, pointers[0].device, outputs)
        args = (*(t.data_ptr() for t in pointers),
                None if ws is None else ws.data_ptr(), *dims, plan.tile,
                plan.splits, stream)
    else:
        args = (*(t.data_ptr() for t in pointers), *dims, stream)
    check(lib, fn(*args), what)


def _kernel_path(what: str, tensors) -> bool:
    """False when every tensor lies on the CPU (the plain version runs);
    True when the kernel can take them (one CUDA device, contiguous, 16-byte
    aligned), else raises."""
    if all(t.device.type == "cpu" for t in tensors):
        return False
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: every tensor must be on one CUDA "
                             f"device (the plain version serves the CPU), "
                             f"got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: tensors must be contiguous and "
                             f"16-byte aligned")
    return True


def _require_dtype(what: str, tensors) -> None:
    """All of `tensors` in one dtype that the kernels take."""
    dtype = tensors[0].dtype
    if dtype not in KERNEL_DTYPES or any(t.dtype != dtype for t in tensors):
        raise TypeError(f"{what}: the CUDA kernels take bfloat16 or float32 "
                        f"tensors of one dtype, got "
                        f"{[t.dtype for t in tensors]}")


def dw_down_plain(gate, up, dy) -> torch.Tensor:
    """Plain PyTorch version of K1: a float32 product of the rounded
    swiglu."""
    s = swiglu_act(gate, up).float()
    return torch.matmul(s.T, dy.float()).to(dy.dtype)


def dw_down(gate: torch.Tensor, up: torch.Tensor,
            dy: torch.Tensor) -> torch.Tensor:
    """gate/up [T, d_ff], dy [T, d] -> dW_down [d_ff, d] in dy's dtype."""
    T, dff = gate.shape
    d = dy.shape[1]
    if up.shape != (T, dff) or dy.shape != (T, d):
        raise ValueError(f"dw_down: shapes gate {tuple(gate.shape)}, up "
                         f"{tuple(up.shape)}, dy {tuple(dy.shape)} do not "
                         f"match")
    tensors = (gate, up, dy)
    if not _kernel_path("dw_down", tensors):
        return dw_down_plain(gate, up, dy)
    _require_dtype("dw_down", tensors)
    out = torch.empty((dff, d), dtype=dy.dtype, device=dy.device)
    if dff and d:  # T == 0 runs no token step and writes zeros
        _launch("dw_down", dy.dtype, (gate, up, dy, out), (T, d, dff),
                (dff, d, T), stream_handle(dy))
        count_launch(dw_down, dy.dtype)
    return out


def dgateup_plain(dy, w_down, gate, up) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2: d_s in float32, then the swiglu VJP."""
    ds = torch.matmul(dy.float(), w_down.float().T)
    gf, uf = gate.float(), up.float()
    return ((ds * uf * _dsilu(gf)).to(gate.dtype),
            (ds * _silu(gf)).to(up.dtype))


def dgateup(dy: torch.Tensor, w_down: torch.Tensor, gate: torch.Tensor,
            up: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """dy [T, d], w_down [d_ff, d], gate/up [T, d_ff] -> (dgate, dup), each
    [T, d_ff] in gate's dtype."""
    T, d = dy.shape
    dff = w_down.shape[0]
    if w_down.shape != (dff, d) or gate.shape != (T, dff) \
            or up.shape != (T, dff):
        raise ValueError(f"dgateup: shapes dy {tuple(dy.shape)}, w_down "
                         f"{tuple(w_down.shape)}, gate {tuple(gate.shape)}, "
                         f"up {tuple(up.shape)} do not match")
    tensors = (dy, w_down, gate, up)
    if not _kernel_path("dgateup", tensors):
        return dgateup_plain(dy, w_down, gate, up)
    _require_dtype("dgateup", tensors)
    dgate = torch.empty((T, dff), dtype=gate.dtype, device=gate.device)
    dup = torch.empty((T, dff), dtype=up.dtype, device=up.device)
    if T and dff:  # d == 0 gives d_s = 0
        _launch("dgateup", dy.dtype, (dy, w_down, gate, up, dgate, dup),
                (T, d, dff), (T, dff, d), stream_handle(dy))
        count_launch(dgateup, dy.dtype)
    return dgate, dup


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
    if not _kernel_path("dw_gateup", tensors):
        return dw_gateup_plain(x2d, rstd, norm_w, dgate, dup)
    dev = x2d.device
    _require_dtype("dw_gateup", (x2d, norm_w, dgate, dup))
    if rstd.dtype != torch.float32:
        raise TypeError(f"dw_gateup: the CUDA kernels take float32 rstd, got "
                        f"{rstd.dtype}")
    if x2d.dtype == torch.float32:  # one [2, d, d_ff] for the split's sum
        dwg, dwu = torch.empty((2, d, dff), dtype=dgate.dtype, device=dev)
    else:
        dwg = torch.empty((d, dff), dtype=dgate.dtype, device=dev)
        dwu = torch.empty((d, dff), dtype=dup.dtype, device=dev)
    if d and dff:  # T == 0 runs no token step and writes zeros
        _launch("dw_gateup", x2d.dtype,
                (x2d, rstd, norm_w, dgate, dup, dwg, dwu), (T, d, dff),
                (d, dff, T), stream_handle(x2d), outputs=2)
        count_launch(dw_gateup, x2d.dtype)
    return dwg, dwu


# ---------------------------------------------------------------- block


def _fwd_impl(x2d, nw, wg, wu, wd, eps, tp_group=None):
    rstd, h = rms_normed(x2d, nw, eps)
    gate = h @ wg
    up = h @ wu
    out = all_reduce_((_silu(gate.float()).to(x2d.dtype) * up) @ wd,
                      tp_group)
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
    def forward(ctx, x, norm_w, w_gate, w_up, w_down, eps, tp_group=None):
        shape = x.shape
        x2d = x.reshape(-1, shape[-1])
        y, rstd, gate, up = _fwd_impl(x2d, norm_w, w_gate, w_up, w_down, eps,
                                      tp_group)
        ctx.save_for_backward(x2d, rstd, gate, up, norm_w, w_gate, w_up,
                              w_down)
        ctx.shape = shape
        ctx.tp_group = tp_group
        return y.reshape(shape)

    @staticmethod
    def backward(ctx, dy):
        x2d, rstd, gate, up, nw, wg, wu, wd = ctx.saved_tensors
        shape = ctx.shape
        dy2d = dy.reshape(-1, shape[-1]).contiguous()
        # each flag off: the reference's XLA-side math (fused_ffn.py:200-262)
        if USE_K1:
            dwd = dw_down(gate, up, dy2d)
        else:
            dwd = swiglu_act(gate, up).T @ dy2d
        if USE_K2:
            dgate, dup = dgateup(dy2d, wd.contiguous(), gate, up)
        else:
            gf, uf = gate.float(), up.float()
            ds = (dy2d @ wd.T).float()
            dgate = (ds * uf * _dsilu(gf)).to(gate.dtype)
            dup = (ds * _silu(gf)).to(up.dtype)
            del ds, gf, uf
        if USE_K3:
            dwg, dwu = dw_gateup(x2d.contiguous(), rstd.contiguous(),
                                 nw.contiguous(), dgate, dup)
        else:
            h = normed(x2d, rstd, nw)
            dwg, dwu = h.T @ dgate, h.T @ dup
            del h
        # dh through the gate/up projections, then the rmsnorm VJP
        dh = (dgate @ wg.T).float() + (dup @ wu.T).float()
        all_reduce_(dh, ctx.tp_group)
        dx, dnw = _rmsnorm_vjp(x2d, rstd, nw, dh, dy2d)
        return dx.reshape(shape), dnw, dwg.to(wg.dtype), dwu.to(wu.dtype), \
            dwd.to(wd.dtype), None, None


def ffn_block(x: torch.Tensor, norm_w: torch.Tensor, w_gate: torch.Tensor,
              w_up: torch.Tensor, w_down: torch.Tensor,
              eps: float = 1e-5, tp_group=None) -> torch.Tensor:
    """x [..., d] -> x + W_down(swiglu(Wg(rmsnorm(x)), Wu(rmsnorm(x)))).
    The swiglu is `silu(gate in float32)` rounded to x's dtype, times up.
    Under `tp_group` (a process group; None is the unsplit block) the
    weights are this rank's d_ff/tp columns of w_gate/w_up and rows of
    w_down: the W_down product is all-reduced over the group before `x` is
    added, and the gradient of the normed input before the RMSNorm VJP, so
    K1-K3 run at the local width and dx, dnorm_w are the same on every
    rank."""
    return FFNBlock.apply(x, norm_w, w_gate, w_up, w_down, eps, tp_group)


# Launch counts: each wrapper adds one to `.launches` where it launches its
# kernel, and nowhere else (the CPU path launches nothing); `.f32_launches`
# counts the float32 kernel's share.
KERNELS = (dw_gateup, dw_down, dgateup)
for _wrapper in KERNELS:
    _wrapper.launches = 0
    _wrapper.f32_launches = 0
