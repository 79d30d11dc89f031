"""APPO: asynchronous PPO (IMPALA-style sampling + clipped surrogate).

Mirrors the reference's APPO (`rllib/algorithms/appo/appo.py`): the IMPALA
async actor-learner control flow, but the learner optimizes the PPO
clipped-surrogate objective against the *behavior* policy's log-probs,
with V-trace value targets correcting policy lag. One update on the
learner's device.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.env import CartPoleEnv
from ray_tpu_torch.rllib.impala import _VTraceLearner
from ray_tpu_torch.rllib.ppo import RolloutWorker


class APPOLearner(_VTraceLearner):
    """Clipped-surrogate loss on v-trace advantages (reference
    rllib/algorithms/appo)."""

    # the advantages are normalized over the whole batch: under a mesh
    # every rank runs the loss on all of it (GSPMD's global statistics)
    per_row_loss = False

    def __init__(self, obs_dim: int, num_actions: int, lr: float,
                 gamma: float, clip: float, vf_coeff: float,
                 entropy_coeff: float, seed: int = 0, mesh=None, module=None,
                 device="cuda"):
        self._clip = clip
        super().__init__(obs_dim, num_actions, lr, gamma, vf_coeff,
                         entropy_coeff, seed=seed, mesh=mesh, module=module,
                         device=device)

    def loss(self, params, batch, extra, rng):
        import torch

        tm, dist, logp, values, vs, pg_adv = self._policy_terms(params, batch)
        adv = pg_adv.detach()
        # jnp's std is the population's (ddof 0); torch's defaults to ddof 1
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        ratio = torch.exp(logp - tm["logp"])
        pg = -torch.minimum(
            ratio * adv,
            torch.clip(ratio, 1 - self._clip, 1 + self._clip) * adv).mean()
        vf = 0.5 * ((values - vs.detach()) ** 2).mean()
        entropy = dist.entropy().mean()
        total = pg + self._vf_coeff * vf - self._entropy_coeff * entropy
        return total, {"policy_loss": pg, "vf_loss": vf, "entropy": entropy}


class APPOConfig:
    def __init__(self):
        self.env_maker: Callable[[int], Any] = lambda seed: CartPoleEnv(seed)
        self.obs_dim = CartPoleEnv.observation_dim
        self.num_actions = CartPoleEnv.num_actions
        self.num_rollout_workers = 2
        self.num_envs_per_worker = 4
        self.rollout_fragment_length = 64
        self.lr = 5e-4
        self.gamma = 0.99
        self.clip_param = 0.2
        self.vf_coeff = 0.5
        self.entropy_coeff = 0.01
        self.max_inflight = 2
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
                raise ValueError(f"unknown APPO option {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "APPO":
        return APPO({"appo_config": self})


class APPO(Algorithm):
    """Async actor-learner with PPO-clip updates on stale batches."""

    def setup(self, config: Dict[str, Any]) -> None:
        cfg: APPOConfig = config.get("appo_config") or APPOConfig()
        self.cfg = cfg
        self.learner = APPOLearner(
            cfg.obs_dim, cfg.num_actions, cfg.lr, cfg.gamma, cfg.clip_param,
            cfg.vf_coeff, cfg.entropy_coeff, cfg.seed, device=cfg.device)
        self.workers = [
            RolloutWorker.options(num_cpus=1).remote(
                cfg.env_maker, cfg.num_envs_per_worker,
                cfg.seed + 1000 * (i + 1), cfg.obs_dim, cfg.num_actions)
            for i in range(cfg.num_rollout_workers)]
        w = self.learner.get_weights()
        ray_tpu_torch.get([wk.set_weights.remote(w) for wk in self.workers])
        self._inflight: Dict[Any, int] = {}
        for i, wk in enumerate(self.workers):
            for _ in range(cfg.max_inflight):
                self._inflight[wk.sample.remote(
                    cfg.rollout_fragment_length)] = i
        self._reward_history: List[float] = []
        self._total_steps = 0

    def training_step(self) -> Dict[str, Any]:
        cfg = self.cfg
        ready, _ = ray_tpu_torch.wait(
            list(self._inflight), num_returns=1, timeout=None)
        stats: Dict[str, float] = {}
        steps = 0
        for fut in ready:
            widx = self._inflight.pop(fut)
            batch = ray_tpu_torch.get(fut)
            self._reward_history.extend(batch["episode_returns"].tolist())
            self._reward_history = self._reward_history[-100:]
            stats = self.learner.update_batch({
                k: batch[k] for k in
                ("obs", "actions", "logp", "rewards", "dones", "last_value")})
            steps += int(batch["actions"].size)
            self._total_steps += int(batch["actions"].size)
            wk = self.workers[widx]
            wk.set_weights.remote(self.learner.get_weights())
            self._inflight[wk.sample.remote(cfg.rollout_fragment_length)] = widx
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

    def stop(self) -> None:
        self._kill_workers(self.workers)
