"""Evolution Strategies (Salimans et al. 2017).

Mirrors the reference's ES (`rllib/algorithms/es/es.py`): a fleet of
evaluation actors, each episode scored under a seed-indexed antithetic
parameter perturbation; the driver reconstructs every perturbation from
its integer seed (only seeds and returns travel) and applies the
rank-normalized ES gradient estimate.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.env import CartPoleEnv


def _flatten(params: Dict[str, np.ndarray]) -> Tuple[np.ndarray, List]:
    keys = sorted(params)
    shapes = [(k, params[k].shape) for k in keys]
    flat = np.concatenate([params[k].ravel() for k in keys])
    return flat.astype(np.float32), shapes


def _unflatten(flat: np.ndarray, shapes: List) -> Dict[str, np.ndarray]:
    out, i = {}, 0
    for k, shape in shapes:
        n = int(np.prod(shape))
        out[k] = flat[i:i + n].reshape(shape).astype(np.float32)
        i += n
    return out


from ray_tpu_torch.rllib.models import init_mlp, mlp_forward_np


def _mlp_policy(obs_dim: int, num_actions: int, hidden=(32, 32), seed=0):
    return init_mlp(np.random.default_rng(seed), (obs_dim, *hidden, num_actions))


def _act(params: Dict[str, np.ndarray], obs: np.ndarray) -> int:
    return int(np.argmax(mlp_forward_np(params, obs)))


@ray_tpu_torch.remote
class ESEvalWorker:
    """Evaluates perturbed policies; perturbations regenerate from seeds."""

    def __init__(self, env_maker, hidden: tuple, noise_std: float):
        self.env_maker = env_maker
        self.noise_std = noise_std

    def evaluate(self, flat: np.ndarray, shapes: List,
                 noise_seeds: List[int], max_steps: int) -> List[Tuple[int, float, float]]:
        """For each seed: antithetic pair of episode returns (+eps, -eps)."""
        out = []
        for s in noise_seeds:
            eps = np.random.default_rng(s).standard_normal(len(flat)).astype(np.float32)
            r_pos = self._rollout(flat + self.noise_std * eps, shapes, max_steps, s)
            r_neg = self._rollout(flat - self.noise_std * eps, shapes, max_steps, s + 1)
            out.append((s, r_pos, r_neg))
        return out

    def _rollout(self, flat, shapes, max_steps: int, ep_seed: int) -> float:
        params = _unflatten(flat, shapes)
        env = self.env_maker(ep_seed)
        obs = env.reset()
        total = 0.0
        for _ in range(max_steps):
            obs, r, done, _ = env.step(_act(params, obs))
            total += r
            if done:
                break
        return total


class ESConfig:
    def __init__(self):
        self.env_maker: Callable[[int], Any] = lambda seed: CartPoleEnv(seed)
        self.obs_dim = CartPoleEnv.observation_dim
        self.num_actions = CartPoleEnv.num_actions
        self.hidden = (32, 32)
        self.num_workers = 2
        self.episodes_per_batch = 16     # perturbation pairs per iteration
        self.noise_std = 0.05
        self.lr = 0.02
        self.max_episode_steps = 500
        self.seed = 0

    def training(self, **kw):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown ES option {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "ES":
        return ES({"es_config": self})


class ES(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        cfg: ESConfig = config.get("es_config") or ESConfig()
        self.cfg = cfg
        params = _mlp_policy(cfg.obs_dim, cfg.num_actions, cfg.hidden, cfg.seed)
        self.flat, self.shapes = _flatten(params)
        self.workers = [
            ESEvalWorker.options(num_cpus=1).remote(
                cfg.env_maker, cfg.hidden, cfg.noise_std)
            for i in range(cfg.num_workers)]
        self._seed_counter = 1000

    def training_step(self) -> Dict[str, Any]:
        cfg = self.cfg
        seeds = [self._seed_counter + 2 * i
                 for i in range(cfg.episodes_per_batch)]
        self._seed_counter += 2 * cfg.episodes_per_batch + 2
        chunks = np.array_split(np.asarray(seeds), len(self.workers))
        futures = [
            w.evaluate.remote(self.flat, self.shapes, c.tolist(),
                              cfg.max_episode_steps)
            for w, c in zip(self.workers, chunks) if len(c)]
        results = [r for chunk in ray_tpu_torch.get(futures) for r in chunk]

        returns = np.array([[rp, rn] for _, rp, rn in results], np.float32)
        # rank normalization (reference es.py compute_centered_ranks)
        flat_ranks = returns.ravel().argsort().argsort().astype(np.float32)
        ranks = flat_ranks.reshape(returns.shape)
        ranks = ranks / (ranks.size - 1) - 0.5
        grad = np.zeros_like(self.flat)
        for (s, _, _), (w_pos, w_neg) in zip(results, ranks):
            eps = np.random.default_rng(s).standard_normal(
                len(self.flat)).astype(np.float32)
            grad += (w_pos - w_neg) * eps
        grad /= (len(results) * cfg.noise_std)
        self.flat = self.flat + cfg.lr * grad
        return {
            "episode_reward_mean": float(returns.mean()),
            "episode_reward_max": float(returns.max()),
            "num_episodes": int(returns.size),
        }

    def get_weights(self):
        return {"flat": self.flat.copy(), "shapes": self.shapes}

    def set_weights(self, weights) -> None:
        self.flat = np.asarray(weights["flat"], np.float32).copy()
        self.shapes = weights["shapes"]

    def stop(self) -> None:
        self._kill_workers(self.workers)
