"""ARS: Augmented Random Search (Mania et al. 2018).

Mirrors the reference's ARS (`rllib/algorithms/ars/ars.py`): antithetic
random directions evaluated by a worker fleet, but — unlike plain ES —
only the top-k directions by max(r+, r-) contribute to the update, the
step is normalized by the std of the selected returns, and observations
are normalized with a running mean/std filter shared across workers (the
reference's MeanStdFilter, synchronized each iteration).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.env import CartPoleEnv
from ray_tpu_torch.rllib.es import _act, _flatten, _mlp_policy, _unflatten


class _RunningStat:
    """Welford-style mergeable observation statistics."""

    def __init__(self, dim: int):
        self.n = 0
        self.sum = np.zeros(dim, np.float64)
        self.sumsq = np.zeros(dim, np.float64)

    def update_batch(self, obs: np.ndarray) -> None:
        self.n += len(obs)
        self.sum += obs.sum(0)
        self.sumsq += (obs ** 2).sum(0)

    def merge(self, other: Tuple[int, np.ndarray, np.ndarray]) -> None:
        n, s, sq = other
        self.n += n
        self.sum += s
        self.sumsq += sq

    def snapshot(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.n < 2:
            return np.zeros_like(self.sum), np.ones_like(self.sum)
        mean = self.sum / self.n
        var = np.maximum(self.sumsq / self.n - mean ** 2, 1e-8)
        return mean, np.sqrt(var)


@ray_tpu_torch.remote
class ARSEvalWorker:
    """Evaluates antithetic perturbation pairs with obs normalization."""

    def __init__(self, env_maker, obs_dim: int, noise_std: float):
        self.env_maker = env_maker
        self.noise_std = noise_std
        self.stats = _RunningStat(obs_dim)

    def evaluate(self, flat, shapes, noise_seeds: List[int], max_steps: int,
                 obs_mean, obs_std):
        out = []
        for s in noise_seeds:
            eps = np.random.default_rng(s).standard_normal(
                len(flat)).astype(np.float32)
            r_pos = self._rollout(flat + self.noise_std * eps, shapes,
                                  max_steps, s, obs_mean, obs_std)
            r_neg = self._rollout(flat - self.noise_std * eps, shapes,
                                  max_steps, s + 1, obs_mean, obs_std)
            out.append((s, r_pos, r_neg))
        stat = (self.stats.n, self.stats.sum.copy(), self.stats.sumsq.copy())
        self.stats = _RunningStat(len(self.stats.sum))
        return out, stat

    def _rollout(self, flat, shapes, max_steps, ep_seed, mean, std) -> float:
        params = _unflatten(flat, shapes)
        env = self.env_maker(ep_seed)
        obs = env.reset()
        total, seen = 0.0, []
        for _ in range(max_steps):
            seen.append(obs)
            a = _act(params, (obs - mean) / std)
            obs, r, done, _ = env.step(a)
            total += r
            if done:
                break
        self.stats.update_batch(np.asarray(seen, np.float64))
        return total


class ARSConfig:
    def __init__(self):
        self.env_maker: Callable[[int], Any] = lambda seed: CartPoleEnv(seed)
        self.obs_dim = CartPoleEnv.observation_dim
        self.num_actions = CartPoleEnv.num_actions
        self.hidden = (32, 32)
        self.num_workers = 2
        self.num_directions = 16         # perturbation pairs per iteration
        self.top_directions = 8          # directions kept for the update
        self.noise_std = 0.03
        self.lr = 0.02
        self.max_episode_steps = 500
        self.seed = 0

    def training(self, **kw):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown ARS option {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "ARS":
        return ARS({"ars_config": self})


class ARS(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        cfg: ARSConfig = config.get("ars_config") or ARSConfig()
        assert cfg.top_directions <= cfg.num_directions
        self.cfg = cfg
        params = _mlp_policy(cfg.obs_dim, cfg.num_actions, cfg.hidden, cfg.seed)
        self.flat, self.shapes = _flatten(params)
        self.obs_stats = _RunningStat(cfg.obs_dim)
        self.workers = [
            ARSEvalWorker.options(num_cpus=1).remote(
                cfg.env_maker, cfg.obs_dim, cfg.noise_std)
            for _ in range(cfg.num_workers)]
        self._seed_counter = 5000

    def training_step(self) -> Dict[str, Any]:
        cfg = self.cfg
        mean, std = self.obs_stats.snapshot()
        seeds = [self._seed_counter + 2 * i for i in range(cfg.num_directions)]
        self._seed_counter += 2 * cfg.num_directions + 2
        chunks = np.array_split(np.asarray(seeds), len(self.workers))
        futures = [
            w.evaluate.remote(self.flat, self.shapes, c.tolist(),
                              cfg.max_episode_steps, mean, std)
            for w, c in zip(self.workers, chunks) if len(c)]
        results: List[Tuple[int, float, float]] = []
        for pairs, stat in ray_tpu_torch.get(futures):
            results.extend(pairs)
            self.obs_stats.merge(stat)

        # keep the top-k directions by best-of-pair return
        results.sort(key=lambda t: max(t[1], t[2]), reverse=True)
        kept = results[:cfg.top_directions]
        used = np.array([[rp, rn] for _, rp, rn in kept], np.float32)
        sigma_r = float(used.std()) or 1.0

        grad = np.zeros_like(self.flat)
        for s, rp, rn in kept:
            eps = np.random.default_rng(s).standard_normal(
                len(self.flat)).astype(np.float32)
            grad += (rp - rn) * eps
        self.flat = self.flat + cfg.lr / (len(kept) * sigma_r) * grad

        all_returns = np.array([[rp, rn] for _, rp, rn in results], np.float32)
        return {
            "episode_reward_mean": float(all_returns.mean()),
            "episode_reward_max": float(all_returns.max()),
            "num_episodes": int(all_returns.size),
            "sigma_r": sigma_r,
        }

    def get_weights(self):
        return {"flat": self.flat.copy(), "shapes": self.shapes,
                "obs_stats": (self.obs_stats.n, self.obs_stats.sum.copy(),
                              self.obs_stats.sumsq.copy())}

    def set_weights(self, weights) -> None:
        self.flat = np.asarray(weights["flat"], np.float32).copy()
        self.shapes = weights["shapes"]
        if "obs_stats" in weights:
            self.obs_stats = _RunningStat(len(self.obs_stats.sum))
            self.obs_stats.merge(weights["obs_stats"])

    def stop(self) -> None:
        self._kill_workers(self.workers)
