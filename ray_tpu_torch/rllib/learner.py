"""Learner / LearnerGroup: the RL update stack on torch.

The port of ray_tpu/rllib/learner.py, which mirrors the reference's new
training stack (`rllib/core/learner/learner.py:100` — `compute_gradients:409`,
`update:773` — and `learner_group.py:52`):

* `Learner` owns one module's params and optimizer state on one device
  (`device`, the card by default) and runs an eager update: the loss on
  the params as leaf tensors, `torch.autograd.grad`, then the optimizer
  transform (`rllib/optim.py`, optax's arithmetic) without autograd. Given
  a `DeviceMesh` (`parallel/mesh.py`) every rank calls `update` with the
  same batch; each dp rank takes its contiguous block of rows, and the
  gradients are all-reduced as a mean over dp — GSPMD's global mean in the
  reference, since the blocks are equal. Scalar aux metrics are averaged
  the same way; per-sample aux (DQN's `td`) is gathered in row order. A
  loss that is not a mean of per-row terms (`per_row_loss = False`) runs
  on the whole batch on every rank instead.
* `LearnerGroup` scales a Learner out: `backend="mesh"` (default) is one
  update sharded over a mesh of the process group (a world of 1 on the
  card when no group is up); `backend="actors"` runs N learner actors,
  each holding a card when its device is one, that all-reduce gradients
  through `ray_tpu_torch.util.collective`'s host backend.

Subclass contract (the reference's): implement `init_params(seed)` (numpy
arrays; the learner moves them to its device) and
`loss(params, batch, extra, rng) -> (loss, aux_metrics_dict)` over torch
tensors (`rng` is the learner's `torch.Generator` on its device);
optionally keep `extra` state (a target network) via `make_extra()` and
`post_update(params, extra)`, and override `make_optimizer()` for
per-submodule optimizers (`optim.multi_transform`, `delayed`).
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib import optim

logger = logging.getLogger(__name__)

__all__ = ["Learner", "LearnerGroup", "broadcast_weights", "clone_tree",
           "delayed"]


def broadcast_weights(weights, handles, method: str = "set_weights"):
    """Fan a weights pytree out to worker actors as ONE plasma object with
    an owner-directed push broadcast (`ray_tpu_torch.push`, reference
    push_manager.h:29): N workers on other nodes read a pre-pushed local
    copy instead of N pulls serializing on this owner. Small (inlined)
    weights skip the push. Blocks until every worker applied them."""
    ref = ray_tpu_torch.put(weights)
    try:
        ray_tpu_torch.push(ref)
    except ValueError:
        pass  # inlined small object: nothing to push, args ship it inline
    except Exception:
        # push is an optimization; the pull path still works
        logging.getLogger(__name__).debug("weight push failed", exc_info=True)
    return ray_tpu_torch.get([getattr(h, method).remote(ref) for h in handles])


def delayed(tx, period: int):
    """Wrap an optimizer transform so it applies only every `period`-th
    step, with its inner state FROZEN on skipped steps (true delayed
    updates — zeroing gradients instead would still decay Adam's moments).
    This is how TD3's delayed actor rides a single update: compose under
    `optim.multi_transform({"actor": delayed(adam, d), ...})`."""
    def init(params):
        return (tx.init(params), 0)

    def update(grads, state, params=None):
        inner, count = state
        if count % period == 0:
            updates, inner = tx.update(grads, inner, params)
        else:
            updates = optim.tree_map(torch.zeros_like, grads)
        return updates, (inner, count + 1)

    return optim.GradientTransformation(init, update)


def _resolve_device(device, mesh):
    """The learner's torch.device: the mesh's when one is given, else
    `device` ("cuda" alone names this process's current card). Raises when
    the card is asked for and there is none."""
    from ray_tpu_torch.ops.kernels._util import require_cuda

    if mesh is not None:
        device = mesh.device_type
    dev = require_cuda(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _to_tensors(tree, device):
    """numpy (or tensor) leaves of nested dicts as torch tensors on
    `device`, with the dtypes jax gives them (float64 -> float32, int64 ->
    int32)."""

    def one(v):
        if isinstance(v, torch.Tensor):
            return v.to(device)
        a = np.asarray(v)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        elif a.dtype == np.int64:
            a = a.astype(np.int32)
        if not (a.flags.writeable and a.flags.c_contiguous):
            a = np.array(a)   # e.g. a read-only view of the object store
        return torch.from_numpy(a).to(device)

    return optim.tree_map(one, tree)


def _to_host(tree):
    """Tensor leaves of nested dicts as numpy arrays on the host."""
    return optim.tree_map(lambda t: t.detach().cpu().numpy(), tree)


def clone_tree(tree):
    """A copy of a params tree that no optimizer step writes: a target
    network (the reference aliases its immutable arrays instead)."""
    return optim.tree_map(lambda v: v.detach().clone(), tree)


def host_scalars(aux: Dict[str, Any]) -> Dict[str, float]:
    """The 0-d entries of an aux dict as Python floats (the reference's
    `jax.device_get` then `np.ndim(v) == 0` filter)."""
    return {k: float(v) for k, v in aux.items() if np.ndim(v) == 0}


class Learner:
    # a loss that is a mean of per-row terms runs on this dp rank's rows
    # under a mesh; one that is not (a statistic over the whole batch, as
    # APPO's advantage normalization) runs on the whole batch on every rank
    per_row_loss = True

    def __init__(self, *, lr: float = 1e-3, optimizer=None, mesh=None,
                 seed: int = 0, device="cuda"):
        self.mesh = mesh
        self.device = _resolve_device(device, mesh)
        self._lr = lr
        self.optimizer = (optimizer if optimizer is not None
                          else self.make_optimizer())
        self.params = _to_tensors(self.init_params(seed), self.device)
        self.opt_state = self.optimizer.init(self.params)
        # the reference's PRNGKey(seed), split once an update: SAC's
        # reparameterized samples and TD3's target smoothing draw from it
        # (`draw_normal`); the other losses ignore it
        self._rng = torch.Generator(device=self.device)
        self._rng.manual_seed(seed)
        self._dp, self._dp_rank, self._dp_group = self._dp_axis()
        self.extra = self.make_extra()

    # ------------------------------------------------------ subclass hooks
    def init_params(self, seed: int):
        raise NotImplementedError

    def loss(self, params, batch, extra, rng):
        """Return (scalar_loss, aux_metrics_dict). `rng` is the learner's
        torch.Generator (stochastic losses: target smoothing,
        reparameterized sampling); deterministic losses just ignore it."""
        raise NotImplementedError

    def make_optimizer(self):
        """Optimizer transform for the whole params tree. Override for
        per-submodule optimizers via `optim.multi_transform` (the moral
        equivalent of the reference's configure_optimizers_for_module,
        learner.py:253) — see `delayed()` for TD3-style update periods."""
        return optim.adam(self._lr)

    def make_extra(self):
        """Extra (non-optimized) tree threaded through the update, e.g. a
        target network. None by default."""
        return None

    def post_update(self, params, extra):
        """Hook after the optimizer step: return the next `extra` (e.g.
        polyak target sync — the reference's additional_update_for_module).
        Default: unchanged."""
        return extra

    # ---------------------------------------------------------------- mesh
    # sharded batch layout: the leading axis splits over dp — sample-major
    # losses on axis 0; sequence losses (vtrace) store batches batch-major
    # [N, T] so dp still splits SAMPLES
    batch_shard_axis = "dp"

    def _dp_axis(self):
        """(size, this rank's index, group) of the mesh's batch axis."""
        if self.mesh is None:
            return 1, 0, None
        names = self.mesh.mesh_dim_names
        i = names.index(self.batch_shard_axis)
        return (self.mesh.size(i), self.mesh.get_local_rank(i),
                self.mesh.get_group(i))

    def _fit_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """Meshed updates need the leading dim divisible by dp: trim the
        ragged tail (standard RL practice for remainder minibatches) rather
        than crash on an uneven split."""
        if self.mesh is None:
            return batch
        dp = self._dp
        n = len(next(iter(batch.values())))
        r = n % dp
        if r == 0:
            return batch
        if n < dp:
            # wrap-pad tiny batches up to dp (mirrors the actor backend's
            # shard padding) — a ragged SGD tail must not crash training
            idx = np.arange(dp) % n
            return {k: v[idx] for k, v in batch.items()}
        return {k: v[:n - r] for k, v in batch.items()}

    def _local_rows(self, batch):
        """This dp rank's contiguous block of every leaf's leading axis."""
        if self._dp == 1 or not self.per_row_loss:
            return batch
        n = len(next(iter(batch.values())))
        per = n // self._dp
        lo = self._dp_rank * per
        return {k: v[lo:lo + per] for k, v in batch.items()}

    def _mean_over_dp(self, flat):
        """Each tensor of `flat` averaged over dp, in one all-reduce."""
        import torch.distributed as dist

        if self._dp == 1 or not self.per_row_loss or not flat:
            return flat
        buf = torch.cat([t.reshape(-1).float() for t in flat])
        dist.all_reduce(buf, group=self._dp_group)
        buf /= self._dp
        out, at = [], 0
        for t in flat:
            out.append(buf[at:at + t.numel()].reshape(t.shape).to(t.dtype))
            at += t.numel()
        return out

    def _gather_rows(self, t):
        """Per-row aux from every dp rank, in row order."""
        import torch.distributed as dist

        if self._dp == 1 or not self.per_row_loss:
            return t
        parts = [torch.empty_like(t) for _ in range(self._dp)]
        dist.all_gather(parts, t.contiguous(), group=self._dp_group)
        return torch.cat(parts)

    def draw_normal(self, rng, shape):
        """A standard normal draw of `shape` ([rows, ...]) from `rng` on
        the learner's device for this dp rank's rows: under a mesh every
        rank draws the whole batch's rows (each rank's generator holds the
        same seed) and keeps its own block, so the meshed update sees the
        noise one device would, as the reference's one key under GSPMD."""
        rows, *rest = shape
        dp = self._dp if self.per_row_loss else 1
        full = torch.randn((rows * dp, *rest), generator=rng,
                           device=self.device)
        if dp == 1:
            return full
        return full[self._dp_rank * rows:(self._dp_rank + 1) * rows]

    # -------------------------------------------------------------- update
    def _grads(self, batch):
        """(grads, aux) of the loss at the current params on `batch` (on
        the host), reduced over dp under a mesh."""
        batch = _to_tensors(self._local_rows(self._fit_batch(batch)),
                            self.device)
        leaves = optim.tree_map(
            lambda p: p.detach().requires_grad_(True), self.params)
        loss, aux = self.loss(leaves, batch, self.extra, self._rng)
        flat = [p for _, p in optim.tree_items(leaves)]
        grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(flat, grads)]
        aux = {k: v.detach() for k, v in dict(aux).items()}
        aux["total_loss"] = loss.detach()
        scalars = [k for k, v in aux.items() if v.ndim == 0]
        reduced = self._mean_over_dp(grads + [aux[k] for k in scalars])
        grads, means = reduced[:len(grads)], reduced[len(grads):]
        aux.update(zip(scalars, means))
        for k, v in aux.items():
            if v.ndim:
                aux[k] = self._gather_rows(v)
        paths = [p for p, _ in optim.tree_items(self.params)]
        return optim.tree_from_items(dict(zip(paths, grads))), aux

    def _step(self, grads) -> None:
        with torch.no_grad():
            updates, self.opt_state = self.optimizer.update(
                grads, self.opt_state, self.params)
            self.params = optim.apply_updates(self.params, updates)

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """One optimizer step on `batch` (sharded over dp when meshed);
        returns aux metrics as tensors (reference Learner.update:773)."""
        grads, aux = self._grads(batch)
        self._step(grads)
        with torch.no_grad():
            self.extra = self.post_update(self.params, self.extra)
        return aux

    def compute_gradients(self, batch: Dict[str, np.ndarray]):
        """(grads, aux) without applying (reference compute_gradients:409)."""
        return self._grads(batch)

    def apply_gradients(self, grads) -> None:
        """One optimizer step on `grads` (tensors, or numpy arrays from
        another process)."""
        self._step(_to_tensors(grads, self.device))

    # ------------------------------------------------------------- weights
    def get_weights(self):
        """Host copy of the params tree as numpy float32 (any nesting, not
        just flat dicts)."""
        return _to_host(self.params)

    def set_weights(self, weights) -> None:
        """The weights copied onto the learner's device; the optimizer
        state starts again, as in the reference."""
        self.params = _to_tensors(weights, self.device)
        self.opt_state = self.optimizer.init(self.params)


@ray_tpu_torch.remote
class _LearnerActor:
    """One member of an actor-backed LearnerGroup: computes gradients
    locally and all-reduces them through the host collective backend
    (reference learner workers with gloo DDP). On the card, its learner
    sits on the actor's granted card (the runtime's current device)."""

    def __init__(self, learner_blob: bytes, kwargs: dict,
                 world_size: int, rank: int, group_name: str):
        import cloudpickle

        cls = cloudpickle.loads(learner_blob)
        self._learner: Learner = cls(**kwargs)
        self._world = world_size
        self._rank = rank
        self._group = group_name
        if world_size > 1:
            from ray_tpu_torch.util import collective

            collective.init_collective_group(
                world_size, rank, backend="host", group_name=group_name)

    def update_shard(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        grads, aux = self._learner.compute_gradients(batch)
        if self._world > 1:
            from ray_tpu_torch.util import collective

            grads = optim.tree_map(
                lambda g: collective.allreduce(
                    g.detach().cpu().numpy(), self._group) / self._world,
                grads)
        self._learner.apply_gradients(grads)
        return host_scalars(aux)

    def device(self) -> Dict[str, Any]:
        """This learner's device and the runtime's card grant."""
        return {"device": str(self._learner.device),
                "gpu_ids": ray_tpu_torch.get_gpu_ids()}

    def get_weights(self):
        return self._learner.get_weights()

    def set_weights(self, weights) -> bool:
        self._learner.set_weights(weights)
        return True


class LearnerGroup:
    """Scale a Learner to many devices/processes
    (reference learner_group.py:52)."""

    def __init__(self, learner_cls: Callable[..., Learner],
                 learner_kwargs: Optional[dict] = None, *,
                 backend: str = "mesh",
                 mesh=None,
                 num_learners: int = 1,
                 scheduling=None):
        self.backend = backend
        kwargs = dict(learner_kwargs or {})
        if backend == "mesh":
            if mesh is None:
                mesh = _default_mesh(kwargs.get("device", "cuda"))
            kwargs["mesh"] = mesh
            self.mesh = mesh
            self._learner = learner_cls(**kwargs)
            self._actors: List[Any] = []
        elif backend == "actors":
            import cloudpickle
            import uuid

            self.mesh = None
            self._learner = None
            blob = cloudpickle.dumps(learner_cls)
            # uuid, NOT id(self): a GC'd group's id can be reused and would
            # collide with the previous group's named rendezvous actor
            group = f"learner-group-{uuid.uuid4().hex[:12]}"
            self._group_name = group
            opts: dict = {}
            if scheduling is not None:
                opts["scheduling_strategy"] = scheduling
            if _on_card(kwargs.get("device", "cuda")):
                opts["num_gpus"] = 1
            actor_cls = (_LearnerActor.options(**opts)
                         if opts else _LearnerActor)
            self._actors = [
                actor_cls.remote(blob, kwargs, num_learners, rank, group)
                for rank in range(num_learners)]
            # materialize construction errors early
            ray_tpu_torch.get([a.get_weights.remote() for a in self._actors])
        else:
            raise ValueError(f"unknown LearnerGroup backend {backend!r}")

    @property
    def num_learners(self) -> int:
        return len(self._actors) if self._actors else 1

    def update(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        """One synchronized update across the group: mesh backend shards the
        batch over dp; actor backend splits it across learners which
        all-reduce gradients."""
        if self._learner is not None:
            return host_scalars(self._learner.update(batch))
        n = len(self._actors)
        size = len(next(iter(batch.values())))
        # Wrap-pad so every sample trains and every rank gets a non-empty
        # shard (all ranks MUST participate in the all-reduce; an empty
        # shard would also mean NaN means).
        idx = np.arange(size)
        pad = (-size) % n
        if pad:
            idx = np.concatenate([idx, idx[:pad]])
        per = len(idx) // n
        shards = [{k: v[idx[i * per:(i + 1) * per]] for k, v in batch.items()}
                  for i in range(n)]
        stats = ray_tpu_torch.get([a.update_shard.remote(s)
                                   for a, s in zip(self._actors, shards)])
        return {k: float(np.mean([s[k] for s in stats]))
                for k in stats[0]} if stats else {}

    def update_minibatches(self, flat: Dict[str, np.ndarray],
                           num_epochs: int, minibatch_size: int,
                           rng: np.random.Generator) -> Dict[str, float]:
        """Epoch/shuffle/minibatch SGD driven through group update()s —
        one loop serving both backends (reference LearnerGroup.update with
        minibatching)."""
        n = len(next(iter(flat.values())))
        stats: Dict[str, float] = {}
        for _ in range(num_epochs):
            idx = rng.permutation(n)
            for start in range(0, n, minibatch_size):
                mb = {k: v[idx[start:start + minibatch_size]]
                      for k, v in flat.items()}
                stats = self.update(mb)
        return stats

    def get_weights(self) -> Dict[str, np.ndarray]:
        if self._learner is not None:
            return self._learner.get_weights()
        return ray_tpu_torch.get(self._actors[0].get_weights.remote())

    def set_weights(self, weights: Dict[str, np.ndarray]) -> None:
        if self._learner is not None:
            self._learner.set_weights(weights)
        else:
            broadcast_weights(weights, self._actors)

    def shutdown(self) -> None:
        """Tear down learner actors + the collective rendezvous (the group
        does not auto-clean: like the reference's LearnerGroup.shutdown)."""
        if self._actors:
            if len(self._actors) > 1:
                try:
                    from ray_tpu_torch.util import collective

                    collective.destroy_collective_group(self._group_name)
                except (ValueError, KeyError, ConnectionError) as e:
                    logger.debug("collective group already gone: %s", e)
            from ray_tpu_torch.rllib.algorithm import Algorithm

            Algorithm._kill_workers(self._actors)
            self._actors = []


def _on_card(device) -> bool:

    return torch.device(device).type == "cuda"


def _default_mesh(device):
    """The reference takes every local device (`make_mesh` over
    `jax.devices()`); here, a dp mesh over the process group, after
    starting a world of 1 on `device` when no group is up."""
    import torch.distributed as dist

    from ray_tpu_torch.parallel import (MeshConfig, initialize_group,
                                        make_mesh)
    from ray_tpu_torch.ops.kernels._util import require_cuda

    dev = require_cuda(device)
    if not dist.is_initialized():
        initialize_group(0, 1, device=dev.type)
    return make_mesh(MeshConfig(dp=-1, fsdp=1, tp=1, sp=1), device=dev.type)
