"""Flash attention, forward and backward (twin of
ray_tpu/ops/pallas/flash_attention.py:38-364).

Over `[b·h, s, head_dim]` tensors, causal or not, with the causal mask
aligned to the END of the key axis (row r sees keys <= r + sk - sq, the
KV-cache convention):

  * `flash_fwd` -> (out, lse): online-softmax attention; lse is the per-row
    logsumexp, stored `[b·h, sq]` float32 (the reference broadcasts it over
    8 sublanes, `[b·h, 8, sq]`, only for the TPU's tiling);
  * `flash_bwd` -> (dq, dk, dv): the FlashAttention-2 recompute backward.
    Δ = rowsum(dO ⊙ O) is plain torch here, as in the reference; then
    `flash_bwd_dkv` accumulates dk/dv per key tile and `flash_bwd_dq`
    accumulates dq per query tile, each recomputing p from lse;
  * `FlashAttention`: the autograd.Function over the pair (the twin of
    `flash_attention_pallas`).

On a CUDA tensor each of the three wrappers launches its hand-written kernel
(csrc/flash_attention.cu) or raises: the kernels take bfloat16 and head_dim
32, 64 or 128. The plain PyTorch versions beside them run for tensors on the
CPU; they compute densely in float32 with the kernels' masking and
roundings (p and ds rounded to the input dtype before the products they
feed). GQA is the caller's: K/V come in repeated per query head.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ray_tpu_torch.ops.kernels._util import check, load_library, stream_handle

_NEG_INF = -1e30
HEAD_DIMS = (32, 64, 128)

_P, _INT, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "rt_flash_fwd": ([_P, _P, _P, _P, _P, _INT, _INT, _INT, _INT, _F, _INT,
                      _P], _INT),
    "rt_flash_bwd_dkv": ([_P, _P, _P, _P, _P, _P, _P, _P, _INT, _INT, _INT,
                          _INT, _F, _INT, _P], _INT),
    "rt_flash_bwd_dq": ([_P, _P, _P, _P, _P, _P, _P, _INT, _INT, _INT, _INT,
                         _F, _INT, _P], _INT),
}


def _lib() -> ctypes.CDLL:
    return load_library("flash_attention", _SIGNATURES)


# ---------------------------------------------------------------- plain


def _valid(sq: int, sk: int, causal: bool, device) -> torch.Tensor:
    """[sq, sk] bool: the entries a row may attend (end-aligned causal)."""
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    if causal:
        return cols <= rows + (sk - sq)
    return torch.ones((sq, sk), dtype=torch.bool, device=device)


def _scores(q, k, scale, causal):
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    valid = _valid(q.shape[-2], k.shape[-2], causal, q.device)
    return s, valid


def flash_fwd_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, causal: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel."""
    s, valid = _scores(q, k, scale, causal)
    s = torch.where(valid, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    acc = torch.matmul(p.to(q.dtype).float(), v.float())
    out = (acc / l).to(q.dtype)
    return out, (m + torch.log(l))[..., 0]


def _p_ds_plain(q, k, v, do, lse, delta, scale, causal):
    s, valid = _scores(q, k, scale, causal)
    p = torch.where(valid, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.matmul(do.float(), v.float().transpose(-1, -2))
    ds = torch.where(valid, p * (dp - delta[..., None]) * scale, 0.0)
    return p.to(q.dtype).float(), ds.to(q.dtype).float()


def flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale: float,
                        causal: bool = True
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the dk/dv kernel."""
    p, ds = _p_ds_plain(q, k, v, do, lse, delta, scale, causal)
    dv = torch.matmul(p.transpose(-1, -2), do.float())
    dk = torch.matmul(ds.transpose(-1, -2), q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_dq_plain(q, k, v, do, lse, delta, scale: float,
                       causal: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the dq kernel."""
    _, ds = _p_ds_plain(q, k, v, do, lse, delta, scale, causal)
    return torch.matmul(ds, k.float()).to(q.dtype)


# ---------------------------------------------------------------- kernels


def _check(q, k, v, what: str) -> None:
    if q.dim() != 3 or k.shape != v.shape or k.dim() != 3:
        raise ValueError(f"{what}: needs q [bh, sq, d] and k/v [bh, sk, d], "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[0] != k.shape[0] or q.shape[2] != k.shape[2]:
        raise ValueError(f"{what}: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"differ in b·h or head_dim")


def _check_cuda(tensors, what: str) -> None:
    """The kernels' contract: CUDA, one device, contiguous, 16-byte
    aligned; bf16 operands and head_dim in HEAD_DIMS (checked by callers)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{what}: every tensor must be on one CUDA "
                             f"device (the plain version serves the CPU), "
                             f"got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: tensors must be contiguous and "
                             f"16-byte aligned")


def _check_operands(q, k, v, what: str) -> None:
    for t in (q, k, v):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{what}: the CUDA kernel takes bfloat16, got "
                            f"{t.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{what}: the CUDA kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {q.shape[-1]}")
    if q.shape[0] > 65535:
        raise ValueError(f"{what}: b·h = {q.shape[0]} exceeds 65535")


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              scale: float, causal: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [bh, sq, d], k/v [bh, sk, d] -> (out [bh, sq, d] in q's dtype, lse
    [bh, sq] float32)."""
    _check(q, k, v, "flash_fwd")
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_fwd_plain(q, k, v, scale, causal)
    _check_cuda((q, k, v), "flash_fwd")
    _check_operands(q, k, v, "flash_fwd")
    bh, sq, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((bh, sq), dtype=torch.float32, device=q.device)
    if bh and sq:
        lib = _lib()
        check(lib, lib.rt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), bh, sq, k.shape[1], d, float(scale), int(causal),
            stream_handle(q)), "flash_fwd")
        flash_fwd.launches += 1
    return out, lse


def _check_bwd(q, k, v, do, lse, delta, what):
    _check(q, k, v, what)
    bh, sq, _ = q.shape
    if do.shape != q.shape or lse.shape != (bh, sq) or delta.shape != (bh, sq):
        raise ValueError(f"{what}: dO {tuple(do.shape)}, lse "
                         f"{tuple(lse.shape)} and delta {tuple(delta.shape)} "
                         f"do not match q {tuple(q.shape)}")
    tensors = (q, k, v, do, lse, delta)
    if all(t.device.type == "cpu" for t in tensors):
        return True
    _check_cuda(tensors, what)
    _check_operands(q, k, v, what)
    if do.dtype != torch.bfloat16 or lse.dtype != torch.float32 \
            or delta.dtype != torch.float32:
        raise TypeError(f"{what}: needs bfloat16 dO and float32 lse/delta")
    return False


def flash_bwd_dkv(q, k, v, do, lse, delta, scale: float,
                  causal: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), each [bh, sk, d] in k's dtype."""
    if _check_bwd(q, k, v, do, lse, delta, "flash_bwd_dkv"):
        return flash_bwd_dkv_plain(q, k, v, do, lse, delta, scale, causal)
    bh, sq, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if bh and k.shape[1]:
        lib = _lib()
        check(lib, lib.rt_flash_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            bh, sq, k.shape[1], d, float(scale), int(causal),
            stream_handle(q)), "flash_bwd_dkv")
        flash_bwd_dkv.launches += 1
    return dk, dv


def flash_bwd_dq(q, k, v, do, lse, delta, scale: float,
                 causal: bool = True) -> torch.Tensor:
    """dq [bh, sq, d] in q's dtype."""
    if _check_bwd(q, k, v, do, lse, delta, "flash_bwd_dq"):
        return flash_bwd_dq_plain(q, k, v, do, lse, delta, scale, causal)
    bh, sq, d = q.shape
    dq = torch.empty_like(q)
    if bh and sq:
        lib = _lib()
        check(lib, lib.rt_flash_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), bh, sq,
            k.shape[1], d, float(scale), int(causal), stream_handle(q)),
            "flash_bwd_dq")
        flash_bwd_dq.launches += 1
    return dq


def flash_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """Δ = rowsum(dO ⊙ O) in float32, [bh, sq] (plain torch, as the
    reference's preprocess step)."""
    return (do.float() * o.float()).sum(dim=-1)


def flash_bwd(q, k, v, o, lse, do, scale: float, causal: bool = True
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of attention at (q, k, v) given the forward's out `o`
    and `lse` and the output cotangent `do`."""
    delta = flash_delta(o, do)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, scale, causal)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """out = attention(q, k, v) over [bh, s, d] with the flash kernels in
    both directions (twin of `flash_attention_pallas`)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, causal: bool = True):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        out, lse = flash_fwd(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, do.contiguous(), ctx.scale,
                               ctx.causal)
        return dq, dk, dv, None, None


# Launch counts: each wrapper adds one where it launches its kernel, and
# nowhere else (the CPU path launches nothing).
flash_fwd.launches = 0
flash_bwd_dkv.launches = 0
flash_bwd_dq.launches = 0
KERNELS = (flash_fwd, flash_bwd_dkv, flash_bwd_dq)
