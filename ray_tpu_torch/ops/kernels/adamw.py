"""Fused AdamW + global-norm-clip update (twin of ray_tpu/ops/pallas/adamw.py).

One pass per leaf reads p, g, mu, nu and writes p', mu', nu' (22 bytes a
bf16 parameter, the least the update can move), with the clip factor, the
learning rate and the bias corrections as scalars. `adamw_update` launches
the hand-written kernel (csrc/adamw.cu) on CUDA tensors or raises;
`adamw_update_plain`, the same arithmetic op for op in PyTorch, runs for
tensors on the CPU. Both write p, mu and nu in place: the port's training
step updates its state in place (JAX donates it instead).

`FusedAdamW` is the optimizer around it, with the reference's semantics
(`adamw.py:97-158`): mu and nu both float32, the clip factor
min(1, clip_norm / max(gnorm, 1e-12)) formed on the device, the learning
rate read at the count before the increment, bias corrections 1 - b^t in
float32 at t = count + 1, decoupled weight decay. The reference sends only
its 16 largest leaves whose size tiles by 1024 to the kernel
(`PALLAS_LEAVES`, a TPU toolchain workaround); the port runs the kernel on
every leaf.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, Callable, Union

import numpy as np
import torch

from ray_tpu_torch.ops.kernels._util import (check, load_library,
                                             stream_handle, tree_leaves)

_P, _I64, _INT, _F = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                      ctypes.c_float)
_SIGNATURES = {
    "rt_adamw": ([_P, _P, _P, _P, _P, _I64, *[_F] * 9, _INT, _INT, _P],
                 _INT),
}
_PARAM_TYPES = (torch.bfloat16, torch.float32)


def _lib() -> ctypes.CDLL:
    return load_library("adamw", _SIGNATURES)


def bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in float32 (optax's and the reference's)."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def adamw_update_plain(p, g, mu, nu, lr: float, clip: torch.Tensor,
                       c1: float, c2: float, *, b1: float, b2: float,
                       eps: float, wd: float) -> None:
    """Plain PyTorch version of the kernel, in the reference's order
    (`adamw.py:45-52`); updates p, mu and nu in place."""
    # c1 and c2 as float32 tensors on the device: a CUDA division by a host
    # scalar is a multiply by its reciprocal, which is not the reference's
    # division
    c1, c2 = (torch.tensor(c, dtype=torch.float32, device=p.device)
              for c in (c1, c2))
    gf = g.float() * clip
    mu.copy_(b1 * mu + (1 - b1) * gf)
    nu.copy_(b2 * nu + (1 - b2) * gf * gf)
    del gf
    pf = p.float()
    update = lr * ((mu / c1) / (torch.sqrt(nu / c2) + eps) + wd * pf)
    p.copy_((pf - update).to(p.dtype))


def adamw_update(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor,
                 nu: torch.Tensor, lr: float, clip: torch.Tensor, c1: float,
                 c2: float, *, b1: float, b2: float, eps: float,
                 wd: float) -> None:
    """One leaf's update in place: p (bfloat16 or float32) and g of p's
    dtype and shape, mu and nu float32 of p's size, clip one float32 on
    p's device; lr, c1 = 1 - b1^t and c2 = 1 - b2^t from the host."""
    tensors = (p, g, mu, nu, clip)
    n = p.numel()
    if g.shape != p.shape or mu.numel() != n or nu.numel() != n \
            or clip.numel() != 1:
        raise ValueError(f"adamw_update: shapes p {tuple(p.shape)}, g "
                         f"{tuple(g.shape)}, mu {tuple(mu.shape)}, nu "
                         f"{tuple(nu.shape)}, clip {tuple(clip.shape)} do "
                         f"not match")
    if p.dtype not in _PARAM_TYPES or g.dtype != p.dtype \
            or any(t.dtype != torch.float32 for t in (mu, nu, clip)):
        raise TypeError(f"adamw_update: needs p and g of one dtype in "
                        f"{_PARAM_TYPES} and float32 mu, nu and clip, got "
                        f"{[t.dtype for t in tensors]}")
    if all(t.device.type == "cpu" for t in tensors):
        adamw_update_plain(p, g, mu, nu, lr, clip, c1, c2, b1=b1, b2=b2,
                           eps=eps, wd=wd)
        return
    for t in tensors:
        if t.device.type != "cuda" or t.device != p.device:
            raise ValueError(f"adamw_update: every tensor must be on one "
                             f"CUDA device (the plain version serves the "
                             f"CPU), got {t.device}")
        if not t.is_contiguous():
            raise ValueError("adamw_update: tensors must be contiguous")
    if n:
        vec = all(t.data_ptr() % 16 == 0 for t in (p, g, mu, nu))
        lib = _lib()
        check(lib, lib.rt_adamw(
            p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
            clip.data_ptr(), n, lr, c1, c2, b1, 1 - b1, b2, 1 - b2, eps, wd,
            int(p.dtype == torch.float32), int(vec), stream_handle(p)),
            "adamw_update")
        adamw_update.launches += 1


@dataclasses.dataclass
class FusedAdamWState:
    count: int   # updates applied so far
    mu: Any      # float32 first moments, one per parameter leaf
    nu: Any      # float32 second moments


def _zeros_f32(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _zeros_f32(v) for k, v in tree.items()}
    return torch.zeros_like(tree, dtype=torch.float32)


class FusedAdamW:
    """optax.chain(clip_by_global_norm, adamw) with one fused pass per leaf.

    `apply(grads, state, params, grad_norm)` updates the params and the
    moments in place and returns the state with its count advanced (any
    dataclass state with count, mu and nu: `FusedAdamWState`, or the
    training step's `AdamWState` carried over from JAX). It runs on the
    params' device and never waits for it: the clip factor stays a device
    scalar and the count lives on the host."""

    def __init__(self, learning_rate: Union[float, Callable[[int], float]],
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, clip_norm: float = 1.0):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm

    def init(self, params: Any) -> FusedAdamWState:
        return FusedAdamWState(count=0, mu=_zeros_f32(params),
                               nu=_zeros_f32(params))

    @torch.no_grad()
    def apply(self, grads: Any, state: Any, params: Any,
              grad_norm: torch.Tensor) -> Any:
        gn = grad_norm.to(torch.float32)
        clip = torch.full_like(gn, self.clip_norm).div_(
            gn.clamp_min(1e-12)).clamp_max_(1.0)
        lr = (self.learning_rate(state.count)
              if callable(self.learning_rate) else self.learning_rate)
        count = state.count + 1
        c1 = bias_correction(self.b1, count)
        c2 = bias_correction(self.b2, count)
        for p, g, mu, nu in zip(tree_leaves(params), tree_leaves(grads),
                                tree_leaves(state.mu), tree_leaves(state.nu),
                                strict=True):
            adamw_update(p, g, mu, nu, lr, clip, c1, c2, b1=self.b1,
                         b2=self.b2, eps=self.eps, wd=self.weight_decay)
        return dataclasses.replace(state, count=count)


# Launch count: the wrapper adds one where it launches its kernel, and
# nowhere else (the CPU path launches nothing).
adamw_update.launches = 0
KERNELS = (adamw_update,)
