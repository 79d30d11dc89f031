"""The single-device training step (twin of ray_tpu/train/step.py:32-165).

`make_train_step(cfg, optimizer, device)` returns `(step_fn, init_fn)`:
`init_fn(seed)` builds a `TrainState` on the device and
`step_fn(state, batch)` runs the loss, its gradients and one optimizer
update, returning `(state, metrics)` with the metrics `loss`, `grad_norm` (of
the unclipped gradients), `moe_aux` (the layers' summed load-balancing loss,
which the loss includes times `moe_aux_weight`; 0 for a dense model) and
`step` (the count before this step).

`default_optimizer` is optax's `clip_by_global_norm(1.0)` followed by
`adamw(warmup_cosine_decay_schedule(0, lr, warmup, total), b1=0.9,
b2=0.95, weight_decay=wd, mu_dtype=float32)`, written as plain functions on
tensors with the same arithmetic: the first moment in float32, the second
in the parameter's dtype (as optax keeps it), bias correction at count + 1,
decoupled weight decay lr·wd·p on every leaf, the learning rate read at the
count before the increment, the new parameter `p + update` cast back to the
parameter's dtype. The global norm is summed in float32 (optax sums in the
gradients' dtype). JAX donates the state to its jitted step; here the
update writes the state's tensors in place, so the state passed in and the
one returned share them.

`fused_adamw_optimizer` is the same schedule and hyperparameters through
`FusedAdamW` (ops/kernels/adamw.py): one kernel pass per leaf, mu and nu
in float32, the clip factor kept on the device, so the step never waits
for it.

The mesh and its shardings wait for their port (ROADMAP.md queue A item 7).
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Any, Callable, Dict, Iterator, NamedTuple, Optional,
                    Tuple)

import torch

from ray_tpu_torch.models.transformer import (ModelConfig, init_params,
                                              loss_fn, tree_leaves)
from ray_tpu_torch.ops.kernels._util import require_cuda
from ray_tpu_torch.ops.kernels.adamw import FusedAdamW, bias_correction


@dataclasses.dataclass
class AdamWState:
    count: int   # updates applied so far (optax's ScaleByAdamState.count)
    mu: Any      # float32 first moments, one per parameter leaf
    nu: Any      # second moments: the parameter's dtype under optax,
                 # float32 under FusedAdamW


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: AdamWState
    step: int


class Optimizer(NamedTuple):
    """What the step calls (`FusedAdamW` has the same two methods)."""
    init: Callable[[Any], AdamWState]
    # apply(grads, opt_state, params, grad_norm) -> opt_state; updates the
    # params and moments in place
    apply: Callable[..., AdamWState]


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _unflatten(template: Any, leaves: Iterator[Any]) -> Any:
    """The inverse of `tree_leaves` (sorted-key order) for `template`'s
    structure. (A module-level recursion: a recursive closure would keep
    the leaves alive in a reference cycle until the next garbage
    collection, holding a whole step's gradients.)"""
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    return next(leaves)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0
                                 ) -> Callable[[int], float]:
    """optax's schedule: linear warmup from init_value to peak_value over
    warmup_steps, then cosine decay to end_value at decay_steps (which
    counts the warmup)."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed "
                         f"warmup_steps {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - max(count, 0) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, decay_steps - warmup_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t
                                       / (decay_steps - warmup_steps)))
        return peak_value * ((1.0 - alpha) * cosine ** exponent + alpha)

    return schedule


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt(sum of squares over every leaf), in float32."""
    return torch.stack([
        torch.linalg.vector_norm(g, dtype=torch.float32).square()
        for g in tree_leaves(tree)]).sum().sqrt()


def default_optimizer(learning_rate: float = 3e-4,
                      weight_decay: float = 0.1,
                      warmup_steps: int = 100,
                      total_steps: int = 10000, *, b1: float = 0.9,
                      b2: float = 0.95, eps: float = 1e-8,
                      clip_norm: float = 1.0) -> Optimizer:
    sched = warmup_cosine_decay_schedule(
        0.0, learning_rate, warmup_steps, max(total_steps, warmup_steps + 1))

    def init(params) -> AdamWState:
        return AdamWState(
            count=0,
            mu=_tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         params),
            nu=_tree_map(torch.zeros_like, params))

    @torch.no_grad()
    def apply(grads, state: AdamWState, params,
              grad_norm: Optional[torch.Tensor] = None) -> AdamWState:
        if grad_norm is None:
            grad_norm = global_norm(grads)
        # one host sync per step: the clipped branch then runs alone
        clip = bool(grad_norm >= clip_norm)
        count = state.count + 1
        bc1 = bias_correction(b1, count)
        bc2 = bias_correction(b2, count)
        lr = sched(state.count)
        # optax's arithmetic, op for op, written in place where the result
        # is the same (a + b = b + a) so one leaf's temporaries stay small
        for g, p, mu, nu in zip(tree_leaves(grads), tree_leaves(params),
                                tree_leaves(state.mu), tree_leaves(state.nu)):
            if clip:
                g = g / grad_norm.to(g.dtype) * clip_norm
            mu.mul_(b1).add_((1 - b1) * g)                   # float32
            nu.mul_(b2).add_((1 - b2) * (g * g))             # param dtype
            del g
            u = mu / bc1
            # optax casts the correction to the moment's dtype first
            denom = nu / torch.tensor(bc2, dtype=nu.dtype).item()
            u.div_(denom.sqrt_().add_(eps))
            del denom
            u.add_(weight_decay * p).mul_(-lr)
            p.copy_(u.add_(p))
        return AdamWState(count=count, mu=state.mu, nu=state.nu)

    return Optimizer(init=init, apply=apply)


def fused_adamw_optimizer(learning_rate: float = 3e-4,
                          weight_decay: float = 0.1,
                          warmup_steps: int = 100,
                          total_steps: int = 10000) -> FusedAdamW:
    """default_optimizer's schedule and hyperparameters with the fused
    AdamW + clip update (one kernel pass per leaf over params, grads and
    moments)."""
    sched = warmup_cosine_decay_schedule(
        0.0, learning_rate, warmup_steps, max(total_steps, warmup_steps + 1))
    return FusedAdamW(sched, b1=0.9, b2=0.95, weight_decay=weight_decay,
                      clip_norm=1.0)


def make_init_fn(cfg: ModelConfig, optimizer: Optimizer,
                 device="cuda") -> Callable[[int], TrainState]:
    """init_fn(seed) -> TrainState with params from `init_params` on the
    device and zero moments."""
    dev = require_cuda(device)

    def init(seed: int = 0) -> TrainState:
        params = init_params(cfg, seed=seed, device=dev)
        return TrainState(params=params, opt_state=optimizer.init(params),
                          step=0)

    return init


def make_train_step(cfg: ModelConfig, optimizer: Optional[Optimizer] = None,
                    device="cuda", *,
                    on_phase: Optional[Callable[[str], None]] = None
                    ) -> Tuple[Callable[[TrainState, Dict[str, torch.Tensor]],
                                        Tuple[TrainState, Dict[str, Any]]],
                               Callable[[int], TrainState]]:
    """Returns (step_fn, init_fn). step_fn(state, batch) -> (state,
    metrics); the metrics are device tensors. Under `default_optimizer`
    the step waits for the device once, when it reads the global norm to
    decide on clipping; under `fused_adamw_optimizer` it never waits.
    `on_phase(name)`, if given, is called on the host as each phase of the
    step is launched ("forward", "backward", "optimizer": the global norm
    and the update) and once after the last ("end");
    `planning.measure_phase_eff` records a CUDA event there."""
    optimizer = optimizer or default_optimizer()
    dev = require_cuda(device)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        params = _tree_map(lambda t: t.detach().requires_grad_(True),
                           state.params)
        if on_phase:
            on_phase("forward")
        loss, aux = loss_fn(params, batch, cfg)
        if on_phase:
            on_phase("backward")
        leaves = list(tree_leaves(params))
        grads = _unflatten(params, iter(torch.autograd.grad(loss, leaves)))
        del params, leaves
        if on_phase:
            on_phase("optimizer")
        grad_norm = global_norm(grads)
        opt_state = optimizer.apply(grads, state.opt_state, state.params,
                                    grad_norm)
        if on_phase:
            on_phase("end")
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm,
                   "moe_aux": aux["moe_aux"].detach(), "step": state.step}
        return TrainState(state.params, opt_state, state.step + 1), metrics

    return step, make_init_fn(cfg, optimizer, dev)
