"""PPO: rollout-worker actor fleet + torch learner on the card.

Mirrors the reference's PPO anatomy (SURVEY §3.6): `training_step` =
parallel `RolloutWorker.sample` actor calls -> concat to a train batch ->
learner update -> weight broadcast (`rllib/algorithms/algorithm.py:1336`,
`rollout_worker.py:879`, `core/learner/learner.py:409,773`); the port of
ray_tpu/rllib/ppo.py. The learner is an eager clipped-surrogate update
with minibatched SGD epochs on the learner's device (the card by default;
`PPOConfig.learners(device=)`), mesh-ready; rollout workers run CPU envs
as actors with numpy acting, exactly the reference's split of env hosts
vs learner chips.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.env import CartPoleEnv, VectorEnv
from ray_tpu_torch.rllib.evaluation import EvalConfigMixin
from ray_tpu_torch.rllib.learner import Learner


# ------------------------------------------------------------- policy model


from ray_tpu_torch.rllib.models import init_mlp, mlp_hidden


def init_policy_params(rng_seed: int, obs_dim: int, num_actions: int,
                       hidden: Tuple[int, ...] = (64, 64)) -> Dict[str, Any]:
    rng = np.random.default_rng(rng_seed)
    params = init_mlp(rng, (obs_dim, *hidden))
    params["w_pi"] = (rng.standard_normal((hidden[-1], num_actions)) * 0.01).astype(np.float32)
    params["b_pi"] = np.zeros(num_actions, np.float32)
    params["w_v"] = (rng.standard_normal((hidden[-1], 1)) * 1.0).astype(np.float32)
    params["b_v"] = np.zeros(1, np.float32)
    return params


def policy_apply(params, obs, n_hidden: int = 2):
    """Returns (logits, value). Works under numpy AND torch."""
    x = mlp_hidden(params, obs, n_hidden)
    logits = x @ params["w_pi"] + params["b_pi"]
    value = (x @ params["w_v"] + params["b_v"])[..., 0]
    return logits, value


# ---------------------------------------------------------------- rollouts


class RolloutWorkerImpl:
    """Env-stepping actor (reference rollout_worker.py:166; `sample:879`).

    Acting is MODULE + CONNECTORS (reference EnvRunner + connector
    pipelines): the worker owns an RLModule and two pipelines —
    env_to_module preprocesses observations, module_to_env turns forward
    outputs into env actions. Exploration/postprocessing changes are
    pipeline edits, not worker forks."""

    def __init__(self, env_maker, num_envs: int, seed: int,
                 obs_dim: int, num_actions: int,
                 module=None, env_to_module=None, module_to_env=None):
        from ray_tpu_torch.rllib.connectors import (CastObsFloat32,
                                              ConnectorPipeline, SampleAction)
        from ray_tpu_torch.rllib.rl_module import DiscreteActorCriticModule

        self.vec = VectorEnv(env_maker, num_envs, seed)
        self.obs = self.vec.reset()
        self.rng = np.random.default_rng(seed)
        self.params: Optional[dict] = None
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.module = module or DiscreteActorCriticModule(obs_dim, num_actions)
        self.env_to_module = env_to_module or ConnectorPipeline(
            [CastObsFloat32()])
        self.module_to_env = module_to_env or ConnectorPipeline(
            [SampleAction()])
        self._timestep = 0
        # per-env running episode returns for metrics
        self._ep_returns = np.zeros(num_envs, np.float32)
        self._completed: List[float] = []

    def set_weights(self, params: dict) -> bool:
        self.params = {k: np.asarray(v) for k, v in params.items()}
        return True

    def eval_episodes(self, num_episodes: int, seed: int = 0):
        """Deterministic evaluation on a FRESH env (training episode state
        untouched) — reference Algorithm.evaluate's worker-side role."""
        from ray_tpu_torch.rllib.evaluation import run_eval_episodes

        return run_eval_episodes(self.vec.env_maker, self.module,
                                 self.params, num_episodes, seed)

    def _act(self) -> Dict[str, Any]:
        data = {"obs": self.obs, "rng": self.rng, "module": self.module,
                "params": self.params, "timestep": self._timestep}
        data = self.env_to_module(data)
        data["fwd_out"] = self.module.forward_inference(self.params,
                                                        data["obs"])
        return self.module_to_env(data)

    def sample(self, num_steps: int) -> Dict[str, np.ndarray]:
        """Collect num_steps transitions per env; returns flat arrays plus
        bootstrap values for GAE."""
        assert self.params is not None, "set_weights before sample"
        T, N = num_steps, self.vec.num_envs
        obs_buf = np.zeros((T, N, self.obs_dim), np.float32)
        act_buf = np.zeros((T, N), np.int32)
        logp_buf = np.zeros((T, N), np.float32)
        val_buf = np.zeros((T, N), np.float32)
        rew_buf = np.zeros((T, N), np.float32)
        done_buf = np.zeros((T, N), np.float32)
        for t in range(T):
            data = self._act()
            obs_buf[t] = data["obs"]
            act_buf[t] = data["actions"]
            logp_buf[t] = data.get("logp", 0.0)
            val_buf[t] = np.asarray(data["fwd_out"]["vf"], np.float32)
            self.obs, rewards, dones, _ = self.vec.step(data["actions"])
            self._timestep += N
            rew_buf[t] = rewards
            done_buf[t] = dones
            self._ep_returns += rewards
            for i, d in enumerate(dones):
                if d:
                    self._completed.append(float(self._ep_returns[i]))
                    self._ep_returns[i] = 0.0
        last_value = self.module.forward_inference(
            self.params, np.asarray(self.obs, np.float32))["vf"]
        episode_returns, self._completed = self._completed, []
        return {
            "obs": obs_buf, "actions": act_buf, "logp": logp_buf,
            "values": val_buf, "rewards": rew_buf, "dones": done_buf,
            "last_value": np.asarray(last_value),
            "episode_returns": np.array(episode_returns, np.float32),
        }


# the remote actor form (plain impl kept importable so subclasses — A3C's
# gradient-computing worker — can extend the sample loop)
RolloutWorker = ray_tpu_torch.remote(RolloutWorkerImpl)


def compute_gae(batch: Dict[str, np.ndarray], gamma: float, lam: float):
    """Generalized advantage estimation over [T, N] arrays."""
    rewards, values, dones = batch["rewards"], batch["values"], batch["dones"]
    T, N = rewards.shape
    adv = np.zeros((T, N), np.float32)
    last_gae = np.zeros(N, np.float32)
    next_value = batch["last_value"]
    for t in reversed(range(T)):
        nonterminal = 1.0 - dones[t]
        delta = rewards[t] + gamma * next_value * nonterminal - values[t]
        last_gae = delta + gamma * lam * nonterminal * last_gae
        adv[t] = last_gae
        next_value = values[t]
    returns = adv + values
    return adv, returns


# ----------------------------------------------------------------- learner


class PPOLearner(Learner):
    """Clipped-surrogate update on the Learner stack (reference
    core/learner/learner.py); the network is a swappable RLModule
    (reference PPOTorchRLModule). Pass `mesh=` to shard minibatches over
    the dp axis with a gradient all-reduce (LearnerGroup mesh backend);
    `device` is the learner's (the card by default)."""

    def __init__(self, obs_dim: int, num_actions: int, lr: float,
                 clip: float = 0.2, vf_coeff: float = 0.5,
                 entropy_coeff: float = 0.01, seed: int = 0, mesh=None,
                 module=None, device="cuda"):
        from ray_tpu_torch.rllib.rl_module import DiscreteActorCriticModule

        self.module = module or DiscreteActorCriticModule(obs_dim, num_actions)
        self._clip = clip
        self._vf_coeff = vf_coeff
        self._entropy_coeff = entropy_coeff
        super().__init__(lr=lr, mesh=mesh, seed=seed, device=device)

    def init_params(self, seed: int):
        return self.module.init_params(seed)

    def loss(self, params, batch, extra, rng):
        import torch

        out = self.module.forward_train(params, batch)
        dist = self.module.action_dist(out)
        logp = dist.logp(batch["actions"])
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["advantages"]
        pg = -torch.minimum(
            ratio * adv,
            torch.clip(ratio, 1 - self._clip, 1 + self._clip) * adv).mean()
        vf = 0.5 * ((out["vf"] - batch["returns"]) ** 2).mean()
        entropy = dist.entropy().mean()
        total = pg + self._vf_coeff * vf - self._entropy_coeff * entropy
        return total, {"policy_loss": pg, "vf_loss": vf, "entropy": entropy}

    def update_minibatches(self, flat: Dict[str, np.ndarray],
                           num_epochs: int, minibatch_size: int,
                           rng: np.random.Generator) -> Dict[str, float]:
        n = len(flat["obs"])
        stats: Dict[str, Any] = {}
        for _ in range(num_epochs):
            idx = rng.permutation(n)
            for start in range(0, n, minibatch_size):
                mb = {k: v[idx[start:start + minibatch_size]] for k, v in flat.items()}
                stats = self.update(mb)
        return {k: float(v) for k, v in stats.items()}


# --------------------------------------------------------------- algorithm


class PPOConfig(EvalConfigMixin):
    """Builder-pattern config (reference rllib/algorithms/ppo/ppo.py)."""

    def __init__(self):
        self.env_maker: Callable[[int], Any] = lambda seed: CartPoleEnv(seed)
        self.obs_dim = CartPoleEnv.observation_dim
        self.num_actions = CartPoleEnv.num_actions
        self.num_rollout_workers = 2
        self.num_envs_per_worker = 4
        self.rollout_fragment_length = 128
        self.lr = 3e-4
        self.gamma = 0.99
        self.lambda_ = 0.95
        self.clip_param = 0.2
        self.entropy_coeff = 0.01
        self.vf_coeff = 0.5
        self.num_sgd_iter = 4
        self.sgd_minibatch_size = 256
        self.seed = 0
        # LearnerGroup scaling (reference AlgorithmConfig.resources /
        # learner settings): backend None = plain local learner;
        # "mesh" = one update dp-sharded over a DeviceMesh;
        # "actors" = num_learners gradient-allreducing learner actors.
        self.learner_backend: Optional[str] = None
        self.num_learners = 1
        self.learner_mesh = None
        # the learner's device: the card unless the caller asks for the CPU
        self.device = "cuda"

    def environment(self, env_maker=None, *, obs_dim=None, num_actions=None) -> "PPOConfig":
        if env_maker is not None:
            self.env_maker = env_maker
        if obs_dim is not None:
            self.obs_dim = obs_dim
        if num_actions is not None:
            self.num_actions = num_actions
        return self

    def rollouts(self, *, num_rollout_workers=None, num_envs_per_worker=None,
                 rollout_fragment_length=None) -> "PPOConfig":
        if num_rollout_workers is not None:
            self.num_rollout_workers = num_rollout_workers
        if num_envs_per_worker is not None:
            self.num_envs_per_worker = num_envs_per_worker
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, *, lr=None, gamma=None, lambda_=None, clip_param=None,
                 entropy_coeff=None, num_sgd_iter=None,
                 sgd_minibatch_size=None) -> "PPOConfig":
        for k, v in [("lr", lr), ("gamma", gamma), ("lambda_", lambda_),
                     ("clip_param", clip_param), ("entropy_coeff", entropy_coeff),
                     ("num_sgd_iter", num_sgd_iter),
                     ("sgd_minibatch_size", sgd_minibatch_size)]:
            if v is not None:
                setattr(self, k, v)
        return self

    def learners(self, *, backend=None, num_learners=None,
                 mesh=None, device=None) -> "PPOConfig":
        """Scale the update with a LearnerGroup (reference
        AlgorithmConfig.learners): backend "mesh" or "actors"; `device`
        is the learners' ("cuda" or "cpu")."""
        if backend is not None:
            self.learner_backend = backend
        if num_learners is not None:
            self.num_learners = num_learners
        if mesh is not None:
            self.learner_mesh = mesh
        if device is not None:
            self.device = device
        return self

    def build(self) -> "PPO":
        return PPO({"ppo_config": self})


class PPO(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        cfg: PPOConfig = config.get("ppo_config") or PPOConfig()
        self.cfg = cfg
        lk = dict(obs_dim=cfg.obs_dim, num_actions=cfg.num_actions,
                  lr=cfg.lr, clip=cfg.clip_param, vf_coeff=cfg.vf_coeff,
                  entropy_coeff=cfg.entropy_coeff, seed=cfg.seed,
                  device=cfg.device)
        self.learner_group = None
        if cfg.learner_backend is not None:
            from ray_tpu_torch.rllib.learner import LearnerGroup

            self.learner_group = LearnerGroup(
                PPOLearner, lk, backend=cfg.learner_backend,
                mesh=cfg.learner_mesh, num_learners=cfg.num_learners)
            self.learner = None
        else:
            self.learner = PPOLearner(**lk)
        self.workers = [
            RolloutWorker.options(num_cpus=1).remote(
                cfg.env_maker, cfg.num_envs_per_worker, cfg.seed + 1000 * (i + 1),
                cfg.obs_dim, cfg.num_actions)
            for i in range(cfg.num_rollout_workers)
        ]
        self._rng = np.random.default_rng(cfg.seed)
        self._broadcast_weights()
        self._reward_history: List[float] = []
        self._total_steps = 0

    def _broadcast_weights(self) -> None:
        from ray_tpu_torch.rllib.learner import broadcast_weights

        w = (self.learner_group.get_weights() if self.learner_group is not None
             else self.learner.get_weights())
        broadcast_weights(w, self.workers)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.cfg
        # 1. parallel sampling
        samples = ray_tpu_torch.get([
            wk.sample.remote(cfg.rollout_fragment_length) for wk in self.workers])
        # 2. GAE per worker batch, then concat + flatten [T,N]->[T*N]
        flats: List[Dict[str, np.ndarray]] = []
        episode_returns: List[float] = []
        for batch in samples:
            adv, ret = compute_gae(batch, cfg.gamma, cfg.lambda_)
            T, N = batch["actions"].shape
            flats.append({
                "obs": batch["obs"].reshape(T * N, -1),
                "actions": batch["actions"].reshape(-1),
                "logp": batch["logp"].reshape(-1),
                "advantages": adv.reshape(-1),
                "returns": ret.reshape(-1),
            })
            episode_returns.extend(batch["episode_returns"].tolist())
        flat = {k: np.concatenate([f[k] for f in flats]) for k in flats[0]}
        adv = flat["advantages"]
        flat["advantages"] = (adv - adv.mean()) / (adv.std() + 1e-8)
        self._total_steps += int(flat["actions"].size)
        # 3. learner update (group-scaled when configured: reference
        # training_step -> LearnerGroup.update, learner_group.py:52)
        target = self.learner_group if self.learner_group is not None else self.learner
        stats = target.update_minibatches(
            flat, cfg.num_sgd_iter, cfg.sgd_minibatch_size, self._rng)
        # 4. broadcast new weights
        self._broadcast_weights()
        if episode_returns:
            self._reward_history.extend(episode_returns)
            self._reward_history = self._reward_history[-100:]
        mean_reward = float(np.mean(self._reward_history)) if self._reward_history else 0.0
        return {
            "episode_reward_mean": mean_reward,
            "num_env_steps_sampled": self._total_steps,
            **stats,
        }

    def get_weights(self):
        if self.learner_group is not None:
            return self.learner_group.get_weights()
        return self.learner.get_weights()

    def set_weights(self, weights) -> None:
        if self.learner_group is not None:
            self.learner_group.set_weights(weights)
        else:
            self.learner.set_weights(weights)
        self._broadcast_weights()

    def stop(self) -> None:
        if self.learner_group is not None:
            self.learner_group.shutdown()
        self._kill_workers(self.workers)
