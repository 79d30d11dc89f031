"""A2C: synchronous advantage actor-critic.

Mirrors the reference's A2C (`rllib/algorithms/a2c/a2c.py`): the PPO
anatomy minus the surrogate clipping — one parallel sample round, GAE
advantages, a single on-policy gradient step per iteration. Reuses the PPO
rollout fleet (same actor, same policy net); the learner is one
policy-gradient + value + entropy update on its device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.env import CartPoleEnv
from ray_tpu_torch.rllib.learner import Learner
from ray_tpu_torch.rllib.ppo import RolloutWorker, compute_gae


class A2CLearner(Learner):
    """Single pg + vf + entropy update (no clipping, no epochs) on the
    Learner stack (reference A2C via core/learner); the network is a
    swappable RLModule. Pass `mesh=` to dp-shard batches."""

    def __init__(self, obs_dim: int, num_actions: int, lr: float,
                 vf_coeff: float = 0.5, entropy_coeff: float = 0.01,
                 seed: int = 0, mesh=None, module=None, device="cuda"):
        from ray_tpu_torch.rllib.rl_module import DiscreteActorCriticModule

        self.module = module or DiscreteActorCriticModule(obs_dim, num_actions)
        self._vf_coeff = vf_coeff
        self._entropy_coeff = entropy_coeff
        super().__init__(lr=lr, mesh=mesh, seed=seed, device=device)

    def init_params(self, seed: int):
        return self.module.init_params(seed)

    def loss(self, params, batch, extra, rng):
        out = self.module.forward_train(params, batch)
        dist = self.module.action_dist(out)
        logp = dist.logp(batch["actions"])
        pg = -(logp * batch["advantages"]).mean()
        vf = 0.5 * ((out["vf"] - batch["returns"]) ** 2).mean()
        entropy = dist.entropy().mean()
        total = pg + self._vf_coeff * vf - self._entropy_coeff * entropy
        return total, {"policy_loss": pg, "vf_loss": vf, "entropy": entropy}

    def update_once(self, batch: Dict[str, np.ndarray]) -> Dict[str, float]:
        aux = self.update(batch)
        return {k: float(v) for k, v in aux.items()}


class A2CConfig:
    def __init__(self):
        self.env_maker: Callable[[int], Any] = lambda seed: CartPoleEnv(seed)
        self.obs_dim = CartPoleEnv.observation_dim
        self.num_actions = CartPoleEnv.num_actions
        self.num_rollout_workers = 2
        self.num_envs_per_worker = 4
        self.rollout_fragment_length = 32
        self.lr = 1e-3
        self.gamma = 0.99
        self.lambda_ = 1.0
        self.vf_coeff = 0.5
        self.entropy_coeff = 0.01
        self.seed = 0
        self.device = "cuda"         # the learner's; "cpu" for the CPU

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
                raise ValueError(f"unknown A2C option {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "A2C":
        return A2C({"a2c_config": self})


class A2C(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        cfg: A2CConfig = config.get("a2c_config") or A2CConfig()
        self.cfg = cfg
        self.learner = A2CLearner(
            cfg.obs_dim, cfg.num_actions, cfg.lr, cfg.vf_coeff,
            cfg.entropy_coeff, cfg.seed, device=cfg.device)
        self.workers = [
            RolloutWorker.options(num_cpus=1).remote(
                cfg.env_maker, cfg.num_envs_per_worker,
                cfg.seed + 1000 * (i + 1), cfg.obs_dim, cfg.num_actions)
            for i in range(cfg.num_rollout_workers)]
        self._broadcast_weights()
        self._reward_history: List[float] = []
        self._total_steps = 0

    def _broadcast_weights(self) -> None:
        from ray_tpu_torch.rllib.learner import broadcast_weights

        broadcast_weights(self.learner.get_weights(), self.workers)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.cfg
        samples = ray_tpu_torch.get([
            wk.sample.remote(cfg.rollout_fragment_length) for wk in self.workers])
        flats, episode_returns = [], []
        for batch in samples:
            adv, ret = compute_gae(batch, cfg.gamma, cfg.lambda_)
            T, N = batch["actions"].shape
            flats.append({
                "obs": batch["obs"].reshape(T * N, -1),
                "actions": batch["actions"].reshape(-1),
                "advantages": adv.reshape(-1),
                "returns": ret.reshape(-1),
            })
            episode_returns.extend(batch["episode_returns"].tolist())
        flat = {k: np.concatenate([f[k] for f in flats]) for k in flats[0]}
        adv = flat["advantages"]
        flat["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
        self._total_steps += int(flat["actions"].size)
        stats = self.learner.update_once(flat)
        self._broadcast_weights()
        if episode_returns:
            self._reward_history.extend(episode_returns)
            self._reward_history = self._reward_history[-100:]
        return {
            "episode_reward_mean": (float(np.mean(self._reward_history))
                                    if self._reward_history else 0.0),
            "num_env_steps_sampled": self._total_steps,
            **stats,
        }

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, weights) -> None:
        self.learner.set_weights(weights)
        self._broadcast_weights()

    def stop(self) -> None:
        self._kill_workers(self.workers)
