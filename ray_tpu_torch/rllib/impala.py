"""IMPALA: asynchronous sampling with V-trace off-policy correction.

Mirrors the reference's IMPALA control flow (`rllib/algorithms/impala/`):
rollout workers sample continuously with whatever weights they last saw;
the learner consumes batches as they land (`ray.wait` on in-flight sample
futures) and corrects the policy lag with V-trace (Espeholt et al. 2018):

    rho_t = min(rho_bar, pi(a|s)/mu(a|s))
    v_s   = V(s) + sum_k gamma^k (prod c) rho delta_k

The learner update is one eager torch update on the learner's device (the
card by default); the V-trace recursion is a loop from T-1 down to 0 (the
reference's reversed `lax.scan`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.env import CartPoleEnv
from ray_tpu_torch.rllib.learner import Learner
from ray_tpu_torch.rllib.ppo import RolloutWorker


def vtrace_targets(behavior_logp, target_logp, rewards, values, last_value,
                   dones, gamma: float, rho_bar: float = 1.0,
                   c_bar: float = 1.0):
    """V-trace value targets + policy-gradient advantages over [T, N].

    torch tensors; the reference's reversed `lax.scan` as a loop from T-1
    down to 0, the same body each step.
    """
    import torch

    rho = torch.clamp(torch.exp(target_logp - behavior_logp), max=rho_bar)
    c = torch.clamp(torch.exp(target_logp - behavior_logp), max=c_bar)
    next_values = torch.cat([values[1:], last_value[None]], dim=0)
    nonterminal = 1.0 - dones
    deltas = rho * (rewards + gamma * next_values * nonterminal - values)

    acc = torch.zeros_like(last_value)
    vs_minus_v = [None] * len(deltas)
    for t in range(len(deltas) - 1, -1, -1):
        acc = deltas[t] + gamma * c[t] * nonterminal[t] * acc
        vs_minus_v[t] = acc
    vs = torch.stack(vs_minus_v) + values
    next_vs = torch.cat([vs[1:], last_value[None]], dim=0)
    pg_adv = rho * (rewards + gamma * next_vs * nonterminal - values)
    return vs, pg_adv


class _VTraceLearner(Learner):
    """Shared base for the v-trace family (APPO/IMPALA) on the Learner
    stack. Batches are stored BATCH-MAJOR [N, T, ...] so a mesh dp-shard of
    the leading axis splits ENV TRAJECTORIES, never the time axis the
    v-trace recursion runs over; the loss transposes back to time-major
    internally."""

    def __init__(self, obs_dim: int, num_actions: int, lr: float,
                 gamma: float, vf_coeff: float, entropy_coeff: float,
                 seed: int = 0, mesh=None, module=None, device="cuda"):
        from ray_tpu_torch.rllib.rl_module import DiscreteActorCriticModule

        self.module = module or DiscreteActorCriticModule(obs_dim, num_actions)
        self._gamma = gamma
        self._vf_coeff = vf_coeff
        self._entropy_coeff = entropy_coeff
        super().__init__(lr=lr, mesh=mesh, seed=seed, device=device)

    def init_params(self, seed: int):
        return self.module.init_params(seed)

    def _policy_terms(self, params, batch):
        """Time-major logp/values/entropy + v-trace targets; unmeshed
        batches arrive time-major already (no relayout round trip)."""
        keys = ("obs", "actions", "logp", "rewards", "dones")
        if self.mesh is None:
            tm = {k: batch[k] for k in keys}
        else:
            tm = {k: batch[k].movedim(0, 1) for k in keys}
        out = self.module.forward_train(params, {"obs": tm["obs"]})
        dist = self.module.action_dist(out)
        logp = dist.logp(tm["actions"])
        values = out["vf"]
        vs, pg_adv = vtrace_targets(
            tm["logp"], logp.detach(), tm["rewards"],
            values.detach(), batch["last_value"],
            tm["dones"], self._gamma)
        return tm, dist, logp, values, vs, pg_adv

    def update_batch(self, batch_tn: Dict[str, np.ndarray]) -> Dict[str, float]:
        """Accepts the rollout layout [T, N, ...]; relayouts batch-major
        ONLY when meshed (the dp shard must split env trajectories)."""
        if self.mesh is None:
            batch = batch_tn
        else:
            batch = {k: (np.moveaxis(v, 0, 1) if np.ndim(v) >= 2 else v)
                     for k, v in batch_tn.items()}
        aux = self.update(batch)
        return {k: float(v) for k, v in aux.items()}


class ImpalaLearner(_VTraceLearner):
    """Plain v-trace policy gradient (no surrogate clipping) with the
    paper's RMSProp, on the Learner stack (reference
    rllib/algorithms/impala via core/learner)."""

    def make_optimizer(self):
        from ray_tpu_torch.rllib import optim

        return optim.rmsprop(self._lr, decay=0.99, eps=0.1)

    def loss(self, params, batch, extra, rng):
        tm, dist, logp, values, vs, pg_adv = self._policy_terms(params, batch)
        pg_loss = -(logp * pg_adv.detach()).mean()
        vf_loss = 0.5 * ((values - vs.detach()) ** 2).mean()
        entropy = dist.entropy().mean()
        total = (pg_loss + self._vf_coeff * vf_loss
                 - self._entropy_coeff * entropy)
        return total, {"policy_loss": pg_loss, "vf_loss": vf_loss,
                       "entropy": entropy}


class ImpalaConfig:
    def __init__(self):
        self.env_maker: Callable[[int], Any] = lambda seed: CartPoleEnv(seed)
        self.obs_dim = CartPoleEnv.observation_dim
        self.num_actions = CartPoleEnv.num_actions
        self.num_rollout_workers = 2
        self.num_envs_per_worker = 4
        self.rollout_fragment_length = 64
        self.lr = 1e-3
        self.gamma = 0.99
        self.vf_coeff = 0.5
        self.entropy_coeff = 0.01
        self.max_inflight = 2          # sample futures in flight per worker
        self.broadcast_interval = 1    # learner updates between weight pushes
        self.seed = 0
        self.device = "cuda"           # the learner's; "cpu" for the CPU

    def environment(self, env_maker=None, *, obs_dim=None, num_actions=None):
        if env_maker is not None:
            self.env_maker = env_maker
        if obs_dim is not None:
            self.obs_dim = obs_dim
        if num_actions is not None:
            self.num_actions = num_actions
        return self

    def rollouts(self, *, num_rollout_workers=None, num_envs_per_worker=None,
                 rollout_fragment_length=None):
        if num_rollout_workers is not None:
            self.num_rollout_workers = num_rollout_workers
        if num_envs_per_worker is not None:
            self.num_envs_per_worker = num_envs_per_worker
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, **kw):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown IMPALA option {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "IMPALA":
        return IMPALA({"impala_config": self})


class IMPALA(Algorithm):
    """Async actor-learner: keeps `max_inflight` sample calls outstanding
    per worker; each training_step consumes whatever has landed."""

    def setup(self, config: Dict[str, Any]) -> None:
        cfg: ImpalaConfig = config.get("impala_config") or ImpalaConfig()
        self.cfg = cfg
        self.learner = ImpalaLearner(
            cfg.obs_dim, cfg.num_actions, cfg.lr, cfg.gamma, cfg.vf_coeff,
            cfg.entropy_coeff, cfg.seed, device=cfg.device)
        self.workers = [
            RolloutWorker.options(num_cpus=1).remote(
                cfg.env_maker, cfg.num_envs_per_worker,
                cfg.seed + 1000 * (i + 1), cfg.obs_dim, cfg.num_actions)
            for i in range(cfg.num_rollout_workers)]
        w = self.learner.get_weights()
        ray_tpu_torch.get([wk.set_weights.remote(w) for wk in self.workers])
        self._inflight: Dict[Any, int] = {}   # future -> worker index
        for i, wk in enumerate(self.workers):
            for _ in range(cfg.max_inflight):
                self._inflight[wk.sample.remote(cfg.rollout_fragment_length)] = i
        self._reward_history: List[float] = []
        self._total_steps = 0
        self._updates_since_broadcast = 0
        # always-present loss keys so callers never KeyError on a quiet step
        self._last_stats: Dict[str, float] = {
            "total_loss": float("nan"), "policy_loss": float("nan"),
            "vf_loss": float("nan"), "entropy": float("nan")}

    def training_step(self) -> Dict[str, Any]:
        cfg = self.cfg
        done, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1,
                               timeout=30.0)
        n_steps = 0
        for ref in done:
            widx = self._inflight.pop(ref)
            wk = self.workers[widx]
            try:
                batch = ray_tpu_torch.get(ref)
            except Exception:
                # worker died mid-sample (reference FaultAwareApply): push
                # current weights (it may have restarted) and resubmit
                wk.set_weights.remote(self.learner.get_weights())
                self._inflight[wk.sample.remote(cfg.rollout_fragment_length)] = widx
                continue
            self._reward_history.extend(batch.pop("episode_returns").tolist())
            batch.pop("values", None)  # learner recomputes values on-device
            self._last_stats = self.learner.update_batch(batch)
            n_steps += batch["actions"].size
            self._total_steps += int(batch["actions"].size)
            self._updates_since_broadcast += 1
            if self._updates_since_broadcast >= cfg.broadcast_interval:
                # push fresh weights only to the worker we're about to relaunch
                wk.set_weights.remote(self.learner.get_weights())
                self._updates_since_broadcast = 0
            self._inflight[wk.sample.remote(cfg.rollout_fragment_length)] = widx
        stats = self._last_stats
        self._reward_history = self._reward_history[-100:]
        mean_reward = float(np.mean(self._reward_history)) \
            if self._reward_history else 0.0
        return {
            "episode_reward_mean": mean_reward,
            "num_env_steps_sampled": self._total_steps,
            **stats,
        }

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, weights) -> None:
        self.learner.set_weights(weights)
        w = self.learner.get_weights()
        ray_tpu_torch.get([wk.set_weights.remote(w) for wk in self.workers])

    def stop(self) -> None:
        self._kill_workers(self.workers)
