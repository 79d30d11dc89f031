"""RandomAgent: the uniform-random baseline.

Mirrors the reference's RandomAgent (`rllib/algorithms/random_agent.py`):
acts uniformly at random, reports episode-reward statistics — the sanity
floor every learning curve is compared against. Rides the same module +
connector contract as real algorithms (RandomActions is the whole
module-to-env pipeline).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.env import CartPoleEnv, VectorEnv


class RandomAgentConfig:
    def __init__(self):
        self.env_maker: Callable[[int], Any] = lambda seed: CartPoleEnv(seed)
        self.num_actions = CartPoleEnv.num_actions
        self.num_envs = 4
        self.rollouts_per_iter = 64
        self.seed = 0

    def environment(self, env_maker=None, *, num_actions=None):
        if env_maker is not None:
            self.env_maker = env_maker
        if num_actions is not None:
            self.num_actions = num_actions
        return self

    def training(self, **kw):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown RandomAgent option {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "RandomAgent":
        return RandomAgent({"random_agent_config": self})


class RandomAgent(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        cfg = config.get("random_agent_config") or RandomAgentConfig()
        self.cfg = cfg
        self.vec = VectorEnv(cfg.env_maker, cfg.num_envs, cfg.seed)
        self.obs = self.vec.reset()
        self._rng = np.random.default_rng(cfg.seed)
        self._ep_returns = np.zeros(cfg.num_envs, np.float32)
        self._reward_history: List[float] = []
        self._total_steps = 0

    def training_step(self) -> Dict[str, Any]:
        cfg = self.cfg
        for _ in range(cfg.rollouts_per_iter):
            actions = self._rng.integers(0, cfg.num_actions, cfg.num_envs)
            self.obs, rewards, dones, _ = self.vec.step(actions)
            self._total_steps += cfg.num_envs
            self._ep_returns += rewards
            for i, d in enumerate(dones):
                if d:
                    self._reward_history.append(float(self._ep_returns[i]))
                    self._ep_returns[i] = 0.0
        self._reward_history = self._reward_history[-100:]
        return {
            "episode_reward_mean": (float(np.mean(self._reward_history))
                                    if self._reward_history else 0.0),
            "num_env_steps_sampled": self._total_steps,
        }

    def get_weights(self):
        return {}

    def set_weights(self, weights) -> None:
        pass
