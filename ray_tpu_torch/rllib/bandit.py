"""Contextual bandits: LinUCB and Linear Thompson Sampling.

Mirrors the reference's bandit algorithms (`rllib/algorithms/bandit/`):
per-arm linear models over context features with closed-form ridge
updates — no gradient descent, exact posterior. `training_step` pulls a
batch of arms from the env, observes rewards, and does the rank-1
Sherman-Morrison update per observation.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.algorithm import Algorithm


class LinearBanditEnv:
    """Contexts x ~ N(0,1)^d, reward = theta_a . x + noise. For tests."""

    def __init__(self, num_arms: int = 5, context_dim: int = 8,
                 noise: float = 0.1, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.theta = rng.standard_normal((num_arms, context_dim)) / np.sqrt(context_dim)
        self.num_arms = num_arms
        self.context_dim = context_dim
        self.noise = noise
        self._rng = np.random.default_rng(seed + 1)

    def observation(self) -> np.ndarray:
        return self._rng.standard_normal(self.context_dim).astype(np.float32)

    def reward(self, context: np.ndarray, arm: int) -> float:
        return float(self.theta[arm] @ context
                     + self._rng.normal(0, self.noise))

    def best_reward(self, context: np.ndarray) -> float:
        return float((self.theta @ context).max())


class _LinearBandit(Algorithm):
    """Shared ridge-regression state: per-arm A^-1 (precision) and b."""

    _explore: str = "ucb"

    def setup(self, config: Dict[str, Any]) -> None:
        self.env: LinearBanditEnv = config.get("env") or LinearBanditEnv()
        self.num_arms = self.env.num_arms
        self.d = self.env.context_dim
        self.alpha = float(config.get("alpha", 1.0))
        self.batch_size = int(config.get("batch_size", 32))
        self._rng = np.random.default_rng(int(config.get("seed", 0)))
        # A_inv starts at identity (ridge lambda=1), b at zero
        self.A_inv = np.stack([np.eye(self.d) for _ in range(self.num_arms)])
        self.b = np.zeros((self.num_arms, self.d))
        self._cumulative_regret = 0.0
        self._steps = 0

    def _select_arm(self, x: np.ndarray) -> int:
        theta_hat = np.einsum("adk,ak->ad", self.A_inv, self.b)
        if self._explore == "ucb":
            means = theta_hat @ x
            widths = np.sqrt(np.einsum("d,adk,k->a", x, self.A_inv, x))
            return int(np.argmax(means + self.alpha * widths))
        # Thompson: sample theta ~ N(theta_hat, alpha^2 A^-1)
        scores = np.empty(self.num_arms)
        for a in range(self.num_arms):
            sample = self._rng.multivariate_normal(
                theta_hat[a], self.alpha**2 * self.A_inv[a])
            scores[a] = sample @ x
        return int(np.argmax(scores))

    def _observe(self, x: np.ndarray, arm: int, reward: float) -> None:
        # Sherman-Morrison rank-1 update of A^-1
        Ainv = self.A_inv[arm]
        Ax = Ainv @ x
        self.A_inv[arm] = Ainv - np.outer(Ax, Ax) / (1.0 + x @ Ax)
        self.b[arm] += reward * x

    def training_step(self) -> Dict[str, Any]:
        rewards = []
        for _ in range(self.batch_size):
            x = self.env.observation()
            arm = self._select_arm(x)
            r = self.env.reward(x, arm)
            self._observe(x, arm, r)
            self._cumulative_regret += self.env.best_reward(x) - r
            self._steps += 1
            rewards.append(r)
        return {
            "episode_reward_mean": float(np.mean(rewards)),
            "cumulative_regret": float(self._cumulative_regret),
            "regret_per_step": float(self._cumulative_regret / self._steps),
            "num_env_steps_sampled": self._steps,
        }

    def compute_action(self, context: np.ndarray) -> int:
        return self._select_arm(np.asarray(context, np.float64))

    def get_weights(self):
        return {"A_inv": self.A_inv.copy(), "b": self.b.copy()}

    def set_weights(self, weights) -> None:
        self.A_inv = np.asarray(weights["A_inv"]).copy()
        self.b = np.asarray(weights["b"]).copy()


class BanditLinUCB(_LinearBandit):
    """UCB exploration: argmax mean + alpha * confidence width."""

    _explore = "ucb"


class BanditLinTS(_LinearBandit):
    """Posterior (Thompson) sampling over the per-arm linear model."""

    _explore = "ts"
