"""A3C: asynchronous advantage actor-critic.

Mirrors the reference's A3C (`rllib/algorithms/a3c/a3c.py`:
`training_step` harvests `compute_gradients` futures from workers and
applies them centrally, sending fresh weights only to the worker whose
gradient was consumed): each worker SAMPLES AND DIFFERENTIATES locally
(module + connector acting, then the A2C loss on its own CPU: a worker
holds no card, so its learner runs on the CPU, asked for explicitly), the
driver applies gradients hogwild-style as they arrive on the central
learner (the card by default) — no synchronous barrier, stale gradients by
design.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.env import CartPoleEnv
from ray_tpu_torch.rllib.ppo import RolloutWorkerImpl, compute_gae


class A3CWorkerImpl(RolloutWorkerImpl):
    """Rollout worker that also computes the A2C gradient on its own batch
    (reference a3c.py:186 `sample_and_compute_grads`)."""

    def init_learner(self, lr: float, vf_coeff: float, entropy_coeff: float,
                     gamma: float, lambda_: float, seed: int) -> bool:
        from ray_tpu_torch.rllib.a2c import A2CLearner

        # the worker holds num_cpus=1 and no card: its learner is the CPU's
        self._learner = A2CLearner(self.obs_dim, self.num_actions, lr,
                                   vf_coeff, entropy_coeff, seed,
                                   module=self.module, device="cpu")
        self._gamma = gamma
        self._lambda = lambda_
        return True

    def sample_and_grads(self, num_steps: int):
        from ray_tpu_torch.rllib.learner import _to_host, _to_tensors

        batch = self.sample(num_steps)
        adv, ret = compute_gae(batch, self._gamma, self._lambda)
        T, N = batch["actions"].shape
        flat = {
            "obs": batch["obs"].reshape(T * N, -1),
            "actions": batch["actions"].reshape(-1),
            "advantages": adv.reshape(-1),
            "returns": ret.reshape(-1),
        }
        a = flat["advantages"]
        flat["advantages"] = (a - a.mean()) / (a.std() + 1e-8)
        self._learner.params = _to_tensors(self.params, self._learner.device)
        grads, aux = self._learner.compute_gradients(flat)
        grads = _to_host(grads)
        return {
            "grads": grads,
            "episode_returns": batch["episode_returns"],
            "num_steps": T * N,
            "loss": float(aux["total_loss"]),
        }


A3CWorker = ray_tpu_torch.remote(A3CWorkerImpl)


class A3CConfig:
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
        self.grads_per_step = 4        # gradients harvested per train()
        self.seed = 0
        self.device = "cuda"         # the central learner's; "cpu" for the CPU

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
                raise ValueError(f"unknown A3C option {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "A3C":
        return A3C({"a3c_config": self})


class A3C(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        from ray_tpu_torch.rllib.a2c import A2CLearner

        cfg: A3CConfig = config.get("a3c_config") or A3CConfig()
        self.cfg = cfg
        # central copy: owns the canonical params + optimizer state; worker
        # gradients are applied as they land
        self.learner = A2CLearner(cfg.obs_dim, cfg.num_actions, cfg.lr,
                                  cfg.vf_coeff, cfg.entropy_coeff, cfg.seed,
                                  device=cfg.device)
        self.workers = [
            A3CWorker.options(num_cpus=1).remote(
                cfg.env_maker, cfg.num_envs_per_worker,
                cfg.seed + 1000 * (i + 1), cfg.obs_dim, cfg.num_actions)
            for i in range(cfg.num_rollout_workers)]
        ray_tpu_torch.get([wk.init_learner.remote(
            cfg.lr, cfg.vf_coeff, cfg.entropy_coeff, cfg.gamma, cfg.lambda_,
            cfg.seed) for wk in self.workers])
        w = self.learner.get_weights()
        ray_tpu_torch.get([wk.set_weights.remote(w) for wk in self.workers])
        self._inflight: Dict[Any, int] = {}
        for i, wk in enumerate(self.workers):
            self._inflight[wk.sample_and_grads.remote(
                cfg.rollout_fragment_length)] = i
        self._reward_history: List[float] = []
        self._total_steps = 0

    def training_step(self) -> Dict[str, Any]:
        cfg = self.cfg
        losses = []
        harvested = 0
        while harvested < cfg.grads_per_step:
            ready, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1,
                                    timeout=60)
            if not ready:
                break
            fut = ready[0]
            widx = self._inflight.pop(fut)
            wk = self.workers[widx]
            try:
                out = ray_tpu_torch.get(fut)
            except Exception:
                # worker died mid-sample: reissue on the (restarted) actor
                self._inflight[wk.sample_and_grads.remote(
                    cfg.rollout_fragment_length)] = widx
                continue
            harvested += 1
            # hogwild apply: the gradient is stale by however many applies
            # happened since this worker last synced — A3C's defining trait
            self.learner.apply_gradients(out["grads"])
            losses.append(out["loss"])
            self._total_steps += out["num_steps"]
            self._reward_history.extend(out["episode_returns"].tolist())
            # refresh ONLY this worker, then put it back to work
            wk.set_weights.remote(self.learner.get_weights())
            self._inflight[wk.sample_and_grads.remote(
                cfg.rollout_fragment_length)] = widx
        self._reward_history = self._reward_history[-100:]
        return {
            "episode_reward_mean": (float(np.mean(self._reward_history))
                                    if self._reward_history else 0.0),
            "num_env_steps_sampled": self._total_steps,
            "num_grads_applied": harvested,
            "loss": float(np.mean(losses)) if losses else float("nan"),
        }

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, weights) -> None:
        self.learner.set_weights(weights)
        w = self.learner.get_weights()
        ray_tpu_torch.get([wk.set_weights.remote(w) for wk in self.workers])

    def stop(self) -> None:
        self._kill_workers(self.workers)
