"""Fused attention block (twin of ray_tpu/ops/pallas/fused_attn.py:85-181):
rmsnorm -> q/k/v -> rotary -> flash attention -> Wo + residual, as an
autograd.Function whose backward re-runs no forward.

The forward saves `x, rstd, q, k, v, out, lse`: the post-rotary q/k
(`[b, h, s, hd]` and `[b, kv_heads, s, hd]`), v, the attention output and
the flash kernel's logsumexp (None on the einsum route below). K/V are
saved UNREPEATED and expanded per query head at the core's entry in both
directions; dk/dv are summed back over the repeat groups. The backward goes
straight to the core's backward (the flash backward kernels), un-rotates dq/dk by the rotation's transpose (rotary with -sin), and
finishes with the dW and dh products in torch and the rmsnorm VJP. cos/sin
get zero gradients, as in the reference.

The attention core follows the reference's `_use_kernel` gate
(ray_tpu/ops/pallas/fused_attn.py:42-43), decided by `use_flash`: on a
CUDA tensor the flash pair (`flash_fwd`/`flash_bwd`, bfloat16 or float32)
runs only at head_dim >= 128 and seq >= 128, and launches or raises there;
below either the block takes the reference's einsum route,
`causal_attention_reference` forward and its autograd VJP in the backward
(the reference's `_core_fwd`/`_core_bwd`, :46-82). On the CPU the core is
the flash pair's plain versions at every shape (the reference takes its
einsum route off the TPU); both compute the same function.

In bfloat16, dh is the float32 sum of three products each rounded to
bfloat16 (the reference sums float32 products); in float32 the two agree.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.ops.attention import _repeat_kv, causal_attention_reference
from ray_tpu_torch.ops.kernels.flash_attention import flash_bwd, flash_fwd
from ray_tpu_torch.ops.kernels.fused_ffn import (_rmsnorm_vjp, normed,
                                                 rms_normed)
from ray_tpu_torch.ops.layers import apply_rotary


def _flat(t: torch.Tensor) -> torch.Tensor:
    b, h, s, hd = t.shape
    return t.reshape(b * h, s, hd).contiguous()


def use_flash(s: int, hd: int, cuda: bool) -> bool:
    """Whether the attention core is the flash pair: on a CUDA tensor the
    reference's `_use_kernel` rule (head_dim >= 128 and seq >= 128, taken on
    the TPU), elsewhere always (the flash pair's plain versions)."""
    return not cuda or (hd >= 128 and s >= 128)


def _einsum_vjp(q4, kr, vr, do4, scale):
    """(dq, dk, dv) of the einsum reference at (q4, kr, vr), k/v repeated
    per query head, as the reference's `_core_bwd` takes them."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (q4, kr, vr)]
        out = causal_attention_reference(*leaves, sm_scale=scale,
                                         causal=True)
        return torch.autograd.grad(out, leaves, do4)


def _fwd_impl(x, nw, wq, wk, wv, wo, cos, sin, n_heads, n_kv_heads, eps):
    b, s, d = x.shape
    hd = d // n_heads
    rstd, h = rms_normed(x, nw, eps)
    q = (h @ wq).reshape(b, s, n_heads, hd)
    k = (h @ wk).reshape(b, s, n_kv_heads, hd)
    v = (h @ wv).reshape(b, s, n_kv_heads, hd)
    q = apply_rotary(q, cos, sin).transpose(1, 2).contiguous()  # [b,h,s,hd]
    k = apply_rotary(k, cos, sin).transpose(1, 2).contiguous()
    v = v.transpose(1, 2).contiguous()
    n_rep = n_heads // n_kv_heads
    kr, vr = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
    if use_flash(s, hd, x.is_cuda):
        out, lse = flash_fwd(_flat(q), _flat(kr), _flat(vr), hd ** -0.5,
                             True)
        out = out.reshape(b, n_heads, s, hd)
    else:  # the reference's einsum route; no lse to save
        out = causal_attention_reference(q, kr, vr, sm_scale=hd ** -0.5,
                                         causal=True)
        lse = None
    attn_flat = out.transpose(1, 2).reshape(b, s, n_heads * hd)
    y = x + (attn_flat @ wo).to(x.dtype)
    return y, (rstd, q, k, v, out, lse)


class AttnBlock(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, norm_w, wq, wk, wv, wo, cos, sin, n_heads,
                n_kv_heads, eps):
        y, (rstd, q, k, v, out, lse) = _fwd_impl(
            x, norm_w, wq, wk, wv, wo, cos, sin, n_heads, n_kv_heads, eps)
        ctx.save_for_backward(x, rstd, q, k, v, out, lse, norm_w, wq, wk, wv,
                              wo, cos, sin)
        ctx.heads = (n_heads, n_kv_heads)
        return y

    @staticmethod
    def backward(ctx, dy):
        (x, rstd, q, k, v, out, lse, nw, wq, wk, wv, wo, cos,
         sin) = ctx.saved_tensors
        n_heads, n_kv_heads = ctx.heads
        b, s, d = x.shape
        hd = d // n_heads
        n_rep = n_heads // n_kv_heads
        dy2d = dy.reshape(b * s, d)

        # output projection
        attn_flat = out.transpose(1, 2).reshape(b * s, n_heads * hd)
        dwo = (attn_flat.T @ dy2d).to(wo.dtype)
        do4 = (dy2d @ wo.T).reshape(b, s, n_heads, hd).transpose(1, 2)
        do4 = do4.to(out.dtype)

        # the core's backward on the saved tensors: the flash kernels (no
        # forward re-run), or the einsum route's VJP where the forward took it
        kr, vr = _repeat_kv(k, n_rep), _repeat_kv(v, n_rep)
        if lse is not None:
            dq4, dkr, dvr = flash_bwd(_flat(q), _flat(kr), _flat(vr),
                                      _flat(out), lse, _flat(do4),
                                      hd ** -0.5, True)
        else:
            dq4, dkr, dvr = _einsum_vjp(q, kr, vr, do4, hd ** -0.5)
        dq4 = dq4.reshape(b, n_heads, s, hd)
        dkr = dkr.reshape(b, n_kv_heads, n_rep, s, hd).sum(dim=2)
        dvr = dvr.reshape(b, n_kv_heads, n_rep, s, hd).sum(dim=2)

        # un-rotate: the rotation is orthogonal, so the VJP is rotation by -θ
        dq_pre = apply_rotary(dq4.transpose(1, 2), cos, -sin)
        dk_pre = apply_rotary(dkr.transpose(1, 2), cos, -sin)
        dv_pre = dvr.transpose(1, 2)
        dq2d = dq_pre.reshape(b * s, n_heads * hd).to(x.dtype)
        dk2d = dk_pre.reshape(b * s, n_kv_heads * hd).to(x.dtype)
        dv2d = dv_pre.reshape(b * s, n_kv_heads * hd).to(x.dtype)

        # dW for the three projections; h recomputed elementwise (one pass)
        x2d = x.reshape(b * s, d)
        rstd2d = rstd.reshape(b * s, 1)
        h2d = normed(x2d, rstd2d, nw)
        dwq = (h2d.T @ dq2d).to(wq.dtype)
        dwk = (h2d.T @ dk2d).to(wk.dtype)
        dwv = (h2d.T @ dv2d).to(wv.dtype)

        # dh back through the projections, then the rmsnorm VJP
        dh = ((dq2d @ wq.T).float() + (dk2d @ wk.T).float()
              + (dv2d @ wv.T).float())
        dx, dnw = _rmsnorm_vjp(x2d, rstd2d, nw, dh, dy2d)
        return (dx.reshape(b, s, d), dnw, dwq, dwk, dwv, dwo,
                torch.zeros_like(cos), torch.zeros_like(sin), None, None,
                None)


def attn_block(x: torch.Tensor, norm_w: torch.Tensor, wq: torch.Tensor,
               wk: torch.Tensor, wv: torch.Tensor, wo: torch.Tensor,
               cos: torch.Tensor, sin: torch.Tensor, n_heads: int,
               n_kv_heads: int, eps: float = 1e-5) -> torch.Tensor:
    """x [b, s, d] -> x + Wo(flash_attn(rotary(qkv(rmsnorm(x)))))."""
    return AttnBlock.apply(x, norm_w, wq, wk, wv, wo, cos, sin, n_heads,
                           n_kv_heads, eps)
