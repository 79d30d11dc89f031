"""The training step (twin of ray_tpu/train/step.py), on one device or
sharded dp x fsdp x tp x sp over a mesh.

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

With `mesh=` (a `parallel.make_mesh` DeviceMesh) the state is sharded by
`state_shardings`: each leaf a DTensor with the rules' placements, the
optimizer moments sharded like the params, the ints replicated. `init_fn`
draws each leaf as the unsharded init does and keeps this rank's block as
soon as it is drawn (the gathered state equals the unsharded one bit for
bit); `step_fn` takes this rank's block of the global batch
(`shard_batch`: rows over (dp, fsdp), dp-major as JAX splits them, the
sequence over sp) and runs the collectives of `parallel/fsdp.py` around
the model, whose tp and sp collectives sit inside it
(`parallel/tensor.py`, ops/ring_attention.py, ops/ulysses.py); the loss
and the optimizers run on the local blocks. MoE runs on any such mesh:
the experts are split over fsdp and stay local (`parallel/fsdp.py`), and
the router sees the global batch (`ops/moe.py`, `parallel/expert.py`), so
`moe_aux` is the global load-balancing loss on every rank. The metrics
are global and the same on every rank. On a mesh with pp > 1 the step
runs replicated over pp, as the reference's does (its rules leave the
layer stack whole): the batch goes over (dp, fsdp) and no collective
crosses pp; `parallel.pipeline.make_pp_train_step` is the step that
splits the layers over pp. A layout tp does not split (ROADMAP.md queue A
item 7.5) and an fsdp that does not divide the experts raise.
`mesh=None` is the single-device step.
"""

from __future__ import annotations

import dataclasses
import math
from typing import (Any, Callable, Dict, Iterator, NamedTuple, Optional,
                    Tuple)

import torch

from ray_tpu_torch.models.transformer import (ModelConfig, init_params,
                                              loss_fn, param_logical_axes,
                                              split_batch, tree_leaves)
from ray_tpu_torch.ops.kernels._util import require_cuda
from ray_tpu_torch.ops.kernels.adamw import FusedAdamW, bias_correction
from ray_tpu_torch.parallel.fsdp import FSDP, tree_paths
from ray_tpu_torch.parallel.mesh import (DEFAULT_RULES, AxisRules,
                                         NamedSharding, P, logical_sharding)
from ray_tpu_torch.parallel.tensor import Parallel, check_split


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


# ---------------------------------------------------------------- sharding


def state_shardings(cfg: ModelConfig, mesh, optimizer: Any,
                    rules: AxisRules = DEFAULT_RULES) -> TrainState:
    """A TrainState of NamedShardings (the state's tree, its ints
    replicated): the params by the rules, the optimizer's moments like the
    params."""
    p_sh = logical_sharding(mesh, param_logical_axes(cfg), rules)
    params_shape = init_params(cfg, device="meta")
    opt_shape = optimizer.init(params_shape)
    replicated = NamedSharding(mesh, P())
    opt_sh = _shard_opt_like_params(opt_shape, params_shape, p_sh,
                                    replicated)
    return TrainState(params=p_sh, opt_state=opt_sh, step=replicated)


def _same_tree(a: Any, b: Any) -> bool:
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_same_tree(a[k], b[k])
                                             for k in a)
    return isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)


def _shard_opt_like_params(opt_shape, params_shape, p_sh, replicated):
    """Optimizer states embed param-shaped subtrees (adam mu/nu); shard those
    like the params and replicate everything else (counts, schedules)."""

    def recurse(node):
        if _same_tree(node, params_shape):
            return p_sh
        if isinstance(node, dict):
            return {k: recurse(v) for k, v in node.items()}
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{
                f.name: recurse(getattr(node, f.name))
                for f in dataclasses.fields(node)})
        return replicated

    return recurse(opt_shape)


def batch_sharding(mesh) -> Dict[str, NamedSharding]:
    """inputs/targets [b, s]: batch over (dp, fsdp), seq over sp."""
    s = NamedSharding(mesh, P(("dp", "fsdp"), "sp"))
    return {"inputs": s, "targets": s}


def shard_batch(batch: Dict[str, torch.Tensor], mesh
                ) -> Dict[str, torch.Tensor]:
    """This rank's block of a global batch (every key, "tokens" and
    "loss_mask" too, laid out as `batch_sharding`'s inputs): rank (dp_i,
    fsdp_j, sp_k) gets row block dp_i * fsdp + fsdp_j of sequence block
    sp_k; tp ranks get the same block."""
    s = batch_sharding(mesh)["inputs"]
    return {k: s.local(v) for k, v in batch.items()}


def _map_sharded(fn, tree: Any, shardings: Any) -> Any:
    """fn(tensor, sharding) over the tensors of `tree` and the
    NamedShardings of `shardings` (the same tree); ints pass through."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_sharded(fn, getattr(tree, f.name),
                                 getattr(shardings, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map_sharded(fn, v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return fn(tree, shardings)
    return tree


def shard_state(state: TrainState, shardings: TrainState) -> TrainState:
    """A whole TrainState, held by every rank (from the bridge, or an
    unsharded init), as the sharded state of `shardings`
    (`state_shardings`): each rank keeps its blocks, no communication."""
    return _map_sharded(lambda t, s: s.distribute(t), state, shardings)


@torch.no_grad()
def to_local(tree: Any) -> Any:
    """The local blocks of a tree of DTensors (views: an in-place update of
    one updates the DTensor); anything else as it is."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: to_local(getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: to_local(v) for k, v in tree.items()}
    return tree.to_local() if hasattr(tree, "to_local") else tree


def _check_mesh(cfg: ModelConfig, mesh, dev: torch.device) -> None:
    """Raise for what the sharded step does not run: experts that fsdp
    does not divide, a layout tp does not split, sp without a
    sequence-parallel attention, a mesh of another device, no NCCL on the
    card."""
    import torch.distributed as dist

    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    if cfg.n_experts > 0 and cfg.n_experts % sizes["fsdp"]:
        raise ValueError(
            f"fsdp={sizes['fsdp']} does not divide n_experts="
            f"{cfg.n_experts}: the expert leaves layers/w_gate, "
            f"layers/w_up and layers/w_down split their expert dim over "
            f"fsdp in equal blocks")
    check_split(cfg, sizes["tp"])
    if sizes["sp"] > 1 and not (cfg.seq_parallel or cfg.use_ring_attention):
        raise ValueError(
            f"sp={sizes['sp']} needs seq_parallel='ring' or 'ulysses': "
            f"plain attention would need every rank's K/V")
    if mesh.device_type != dev.type:
        raise ValueError(f"a mesh of {mesh.device_type} ranks for a step "
                         f"on {dev}")
    if dev.type == "cuda" and dist.get_backend() != "nccl":
        raise RuntimeError(f"collectives on the card go through NCCL, not "
                           f"{dist.get_backend()}")


def make_init_fn(cfg: ModelConfig, optimizer: Optimizer,
                 device="cuda", *, mesh=None,
                 rules: AxisRules = DEFAULT_RULES
                 ) -> Callable[[int], TrainState]:
    """init_fn(seed) -> TrainState with params from `init_params` on the
    device and zero moments; with `mesh`, each leaf this rank's block of
    the same draw, as a DTensor of `state_shardings`."""
    dev = require_cuda(device)
    if mesh is None:
        def init(seed: int = 0) -> TrainState:
            params = init_params(cfg, seed=seed, device=dev)
            return TrainState(params=params,
                              opt_state=optimizer.init(params), step=0)

        return init

    _check_mesh(cfg, mesh, dev)
    sh = state_shardings(cfg, mesh, optimizer, rules)

    def place(path: str, leaf: torch.Tensor):
        node = sh.params
        for key in path.split("/"):
            node = node[key]
        return node.distribute(leaf)

    def sharded_init(seed: int = 0) -> TrainState:
        params = init_params(cfg, seed=seed, device=dev, place=place)
        opt_state = optimizer.init(to_local(params))
        return TrainState(params=params,
                          opt_state=_map_sharded(
                              lambda t, s: s.from_local(t), opt_state,
                              sh.opt_state),
                          step=0)

    return sharded_init


def make_train_step(cfg: ModelConfig, optimizer: Optional[Optimizer] = None,
                    device="cuda", *,
                    on_phase: Optional[Callable[[str], None]] = None,
                    mesh=None, rules: AxisRules = DEFAULT_RULES
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
    `planning.measure_phase_eff` records a CUDA event there. With `mesh`,
    the sharded step (module docstring): `batch` is this rank's rows."""
    optimizer = optimizer or default_optimizer()
    dev = require_cuda(device)
    if mesh is not None:
        return (_sharded_step(cfg, optimizer, dev, on_phase, mesh, rules,
                              loss_fn),
                make_init_fn(cfg, optimizer, dev, mesh=mesh, rules=rules))

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


def _sharded_step(cfg: ModelConfig, optimizer: Any, dev: torch.device,
                  on_phase: Optional[Callable[[str], None]], mesh,
                  rules: AxisRules, loss_of: Callable[..., Any]):
    """The sharded step: the unsharded step's phases on the local blocks,
    with parallel/fsdp.py's collectives around the model and
    parallel/tensor.py's inside it. `loss_of(params, batch, cfg, par=)`
    is `loss_fn`, or the pipeline's `pp_loss_fn` (parallel/pipeline.py)."""
    _check_mesh(cfg, mesh, dev)
    sh = state_shardings(cfg, mesh, optimizer, rules)
    fsdp = FSDP(mesh, sh.params, param_logical_axes(cfg))
    par = Parallel.from_mesh(mesh, fsdp.gather)
    paths = [path for path, _ in tree_paths(sh.params)]

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
        # this rank's share of the global token count: its loss (a mean over
        # its tokens) times the share sums to the global mean over ranks
        _, targets, mask = split_batch(batch)
        count = (mask.float().sum() if mask is not None else torch.full(
            (), float(targets.numel()), device=dev))
        scale = count / fsdp.data_sum(count.clone()).clamp_min(1.0)
        local = to_local(state.params)
        params = _tree_map(lambda t: t.detach().requires_grad_(True), local)
        if on_phase:
            on_phase("forward")
        with fsdp.saved_tensor_hooks():
            loss, aux = loss_of(params, batch, cfg, par=par)
            loss = loss * scale
        if on_phase:
            on_phase("backward")
        leaves = list(tree_leaves(params))
        grads = list(torch.autograd.grad(loss, leaves))
        del params, leaves
        fsdp.reduce_grads(paths, grads)
        if on_phase:
            on_phase("optimizer")
        grad_norm = fsdp.global_norm(paths, grads)
        grads = _unflatten(local, iter(grads))
        opt_state = optimizer.apply(grads, to_local(state.opt_state), local,
                                    grad_norm)
        if on_phase:
            on_phase("end")
        metrics = {"loss": fsdp.data_sum(loss.detach()),
                   "grad_norm": grad_norm,
                   "moe_aux": aux["moe_aux"].detach(), "step": state.step}
        return TrainState(state.params, dataclasses.replace(
            state.opt_state, count=opt_state.count), state.step + 1), metrics

    return step
