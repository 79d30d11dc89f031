"""Named values for selective rematerialization (the port's counterpart of
`jax.ad_checkpoint.checkpoint_name` and the `jax.checkpoint_policies` the
reference's `maybe_remat` uses).

torch's selective activation checkpointing asks a policy, op by op as the
dispatcher sees them, whether the recompute reuses that op's output. A name
kept on the Python side would be invisible to it, so the named values go
through two ops registered with `torch.library`, whose name argument the
policy reads:

  * `named_matmul(a, b, name)`: `a [..., k] @ b [k, n]`, for the
    contractions without batch dimensions (what the reference's `dots`
    policy saves). A saved one is not recomputed: the recompute gets its
    output back instead of running the product again;
  * `checkpoint_name(x, name)`: the identity (an alias of `x`), for a value
    that is not such a product.

`selective_checkpoint(fn, names)` wraps `fn` in non-reentrant
`torch.utils.checkpoint.checkpoint` with `selective_policy(names)`: the
outputs of these two ops whose name is in `names` are kept, everything else
is recomputed in the backward. Nothing else is ever marked saved, so a
hand-written kernel's output buffer (a `torch.empty` the kernel fills
through ctypes, out of the dispatcher's sight) is always recomputed with
its launch.
"""

from __future__ import annotations

import functools
from typing import Callable, Iterable

import torch
import torch.utils.checkpoint
from torch.utils.checkpoint import (CheckpointPolicy,
                                    create_selective_checkpoint_contexts)


@torch.library.custom_op("ray_tpu_torch::named_matmul", mutates_args=())
def _named_matmul(a: torch.Tensor, b: torch.Tensor,
                  name: str) -> torch.Tensor:
    return torch.matmul(a, b)


@_named_matmul.register_fake
def _(a, b, name):
    return a.new_empty((*a.shape[:-1], b.shape[-1]))


def _matmul_setup(ctx, inputs, output):
    a, b, _ = inputs
    ctx.save_for_backward(a, b)


def _matmul_backward(ctx, grad):
    a, b = ctx.saved_tensors
    da = db = None
    if ctx.needs_input_grad[0]:
        da = grad @ b.t()
    if ctx.needs_input_grad[1]:
        db = a.reshape(-1, a.shape[-1]).t() @ grad.reshape(-1,
                                                          grad.shape[-1])
    return da, db, None


_named_matmul.register_autograd(_matmul_backward, setup_context=_matmul_setup)

_LIB = torch.library.Library("ray_tpu_torch", "FRAGMENT")
_LIB.define("checkpoint_name(Tensor(a) x, str name) -> Tensor(a)")
_LIB.impl("checkpoint_name", lambda x, name: torch.ops.aten.alias(x),
          "CompositeExplicitAutograd")
_CHECKPOINT_NAME = torch.ops.ray_tpu_torch.checkpoint_name.default


class _Identity(torch.autograd.Function):
    """The autograd side of `checkpoint_name`: the op below autograd
    forward, the gradient passed through."""

    @staticmethod
    def forward(ctx, x, name):
        with torch._C._AutoDispatchBelowAutograd():
            return _CHECKPOINT_NAME(x, name)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


_LIB.impl("checkpoint_name", _Identity.apply, "Autograd")

NAMED_OPS = (torch.ops.ray_tpu_torch.named_matmul.default, _CHECKPOINT_NAME)


def named_matmul(a: torch.Tensor, b: torch.Tensor,
                 name: str) -> torch.Tensor:
    """`a [..., k] @ b [k, n]` under `name` (a contraction without batch
    dimensions)."""
    return _named_matmul(a, b, name)


def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """`x` under `name` (twin of `jax.ad_checkpoint.checkpoint_name`)."""
    return _CHECKPOINT_NAME(x, name)


def selective_policy(names: Iterable[str]):
    """The policy that keeps the named values in `names` and recomputes
    everything else."""
    names = frozenset(names)

    def policy(ctx, func, *args, **kwargs):
        if func in NAMED_OPS and args[-1] in names:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def selective_checkpoint(fn: Callable, names: Iterable[str]) -> Callable:
    """`fn` under non-reentrant checkpointing that keeps the values named
    in `names` for the backward and recomputes the rest."""

    def context():
        return create_selective_checkpoint_contexts(selective_policy(names))

    return functools.partial(torch.utils.checkpoint.checkpoint, fn,
                             use_reentrant=False, context_fn=context)
