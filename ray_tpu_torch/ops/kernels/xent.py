"""Blockwise softmax cross-entropy (twin of ray_tpu/ops/pallas/xent.py).

  * `xent_fwd(logits, labels)` -> (loss, lse), both `[N]` float32: a
    streaming max/sum-of-exp per row, lse = m + log(max(l, 1e-30)) and
    loss = lse − logits[row, label];
  * `xent_bwd(logits, labels, lse, g)` -> dx = (exp(x − lse) − onehot)·g
    in the logits' dtype, recomputed from lse: no softmax tensor is stored;
  * `SoftmaxCrossEntropy`, the autograd.Function around the pair (no
    gradient for the labels);
  * `softmax_cross_entropy(logits, labels)`, the twin of
    `softmax_cross_entropy_pallas`: logits [N, V] float32 or bfloat16,
    integer labels [N] cast to int32, the float32 loss [N].

A label outside [0, V) adds no correct-logit term (loss = lse) and no
one-hot to the gradient; the reference agrees for a negative label and for
one at or past its padded vocabulary, and takes −1e30 for a label in
[V, round_up(V, 2048)). Labels are not checked on the host: that would wait
for the device.

On a CUDA tensor each wrapper launches its hand-written kernel
(csrc/xent.cu) or raises; the plain PyTorch versions beside them run only
for tensors on the CPU. Like the reference's, the entry is called by no
model path: `models.transformer.token_nll` keeps its logsumexp.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ray_tpu_torch.ops.kernels._util import (check, check_cuda,
                                             load_library, rows_vectorized,
                                             stream_handle)

_NEG_INF = -1e30
_P, _I64, _INT = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_SIGNATURES = {
    "rt_xent_fwd": ([_P, _P, _P, _P, _INT, _INT, _I64, _I64, _P], _INT),
    "rt_xent_bwd": ([_P, _P, _P, _P, _P, _INT, _INT, _I64, _I64, _P], _INT),
}
_FLOAT_TYPES = (torch.float32, torch.bfloat16)


def _lib() -> ctypes.CDLL:
    return load_library("xent", _SIGNATURES)


def _label_terms(labels: torch.Tensor, vocab: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(labels clamped into [0, V) as int64 [N, 1], float32 [N, 1] that is 1
    where the label lies in [0, V) and 0 elsewhere)."""
    valid = (labels >= 0) & (labels < vocab)
    return (labels.clamp(0, vocab - 1).long()[:, None],
            valid.float()[:, None])


def xent_fwd_plain(logits: torch.Tensor, labels: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the forward kernel."""
    x = logits.float()
    m = x.amax(dim=-1).clamp_min(_NEG_INF)
    l = torch.exp(x - m[:, None]).sum(dim=-1)
    lse = m + torch.log(l.clamp_min(1e-30))
    idx, valid = _label_terms(labels, logits.shape[-1])
    c = (x.gather(1, idx) * valid)[:, 0]
    return lse - c, lse


def xent_bwd_plain(logits: torch.Tensor, labels: torch.Tensor,
                   lse: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the backward kernel."""
    p = torch.exp(logits.float() - lse[:, None])
    idx, valid = _label_terms(labels, logits.shape[-1])
    p.scatter_add_(1, idx, -valid)  # p - onehot; -0 where there is none
    return (p * g.float()[:, None]).to(logits.dtype)


def _check_args(logits, labels, what: str) -> None:
    if logits.dim() != 2 or logits.shape[-1] == 0 \
            or labels.shape != logits.shape[:1]:
        raise ValueError(f"{what}: needs logits [N, V] with V > 0 and "
                         f"labels [N], got {tuple(logits.shape)}, "
                         f"{tuple(labels.shape)}")
    if logits.dtype not in _FLOAT_TYPES:
        raise TypeError(f"{what}: logits must be in {_FLOAT_TYPES}, got "
                        f"{logits.dtype}")
    if labels.dtype.is_floating_point or labels.dtype.is_complex \
            or labels.dtype == torch.bool:
        raise TypeError(f"{what}: labels must be integers, got "
                        f"{labels.dtype}")


def _require_int32(labels: torch.Tensor, what: str) -> None:
    if labels.dtype != torch.int32:
        raise TypeError(f"{what}: the CUDA kernel takes int32 labels, got "
                        f"{labels.dtype}")


def xent_fwd(logits: torch.Tensor, labels: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [N, V], labels [N] -> (loss [N], lse [N]), float32."""
    _check_args(logits, labels, "xent_fwd")
    if logits.device.type == "cpu" and labels.device.type == "cpu":
        return xent_fwd_plain(logits, labels)
    check_cuda((logits, labels), "xent_fwd")
    _require_int32(labels, "xent_fwd")
    n, v = logits.shape
    loss = torch.empty((n,), dtype=torch.float32, device=logits.device)
    lse = torch.empty_like(loss)
    if n:
        lib = _lib()
        check(lib, lib.rt_xent_fwd(
            logits.data_ptr(), labels.data_ptr(), loss.data_ptr(),
            lse.data_ptr(), int(logits.dtype == torch.bfloat16),
            int(rows_vectorized(logits)), n, v, stream_handle(logits)),
            "xent_fwd")
        xent_fwd.launches += 1
    return loss, lse


def xent_bwd(logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor,
             g: torch.Tensor) -> torch.Tensor:
    """dx [N, V] in the logits' dtype from the forward's lse [N] and the
    loss cotangent g [N], both float32."""
    _check_args(logits, labels, "xent_bwd")
    if lse.shape != labels.shape or g.shape != labels.shape:
        raise ValueError(f"xent_bwd: lse {tuple(lse.shape)} and g "
                         f"{tuple(g.shape)} do not match labels "
                         f"{tuple(labels.shape)}")
    if lse.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"xent_bwd: needs float32 lse and g, got "
                        f"{lse.dtype}, {g.dtype}")
    tensors = (logits, labels, lse, g)
    if all(t.device.type == "cpu" for t in tensors):
        return xent_bwd_plain(logits, labels, lse, g)
    check_cuda(tensors, "xent_bwd")
    _require_int32(labels, "xent_bwd")
    n, v = logits.shape
    dx = torch.empty_like(logits)
    if n:
        lib = _lib()
        check(lib, lib.rt_xent_bwd(
            logits.data_ptr(), labels.data_ptr(), lse.data_ptr(),
            g.data_ptr(), dx.data_ptr(), int(logits.dtype == torch.bfloat16),
            int(rows_vectorized(logits, dx)), n, v, stream_handle(logits)),
            "xent_bwd")
        xent_bwd.launches += 1
    return dx


class SoftmaxCrossEntropy(torch.autograd.Function):
    """loss = softmax_cross_entropy(logits, labels) with the kernels in both
    directions (twin of the reference's custom VJP); labels get no
    gradient."""

    @staticmethod
    def forward(ctx, logits, labels):
        loss, lse = xent_fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return xent_bwd(logits, labels, lse, g.float().contiguous()), None


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Per-example cross-entropy: logits [N, V] (float32 or bfloat16),
    integer labels [N] -> the float32 loss [N]. The gradient flows to the
    logits only."""
    _check_args(logits, labels, "softmax_cross_entropy")
    return SoftmaxCrossEntropy.apply(logits.contiguous(),
                                     labels.to(torch.int32).contiguous())


# Launch counts: each wrapper adds one where it launches its kernel, and
# nowhere else (the CPU path launches nothing).
xent_fwd.launches = 0
xent_bwd.launches = 0
KERNELS = (xent_fwd, xent_bwd)
