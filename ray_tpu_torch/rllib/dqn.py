"""DQN: epsilon-greedy sampling fleet + replay buffer + double-DQN learner.

Mirrors the reference's DQN anatomy (`rllib/algorithms/dqn/dqn.py`:
sample → store → replay-sample → TD update → target sync) with the learner
as a single torch update on the learner's device (double-DQN targets,
optional prioritized replay with importance weights). The target network
is a clone of the online params taken at each sync: the reference aliases
them (`make_extra`, `sync_target`, `set_weights`), safe only with JAX's
immutable arrays.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.env import CartPoleEnv, VectorEnv
from ray_tpu_torch.rllib.evaluation import EvalConfigMixin
from ray_tpu_torch.rllib.learner import Learner, clone_tree
from ray_tpu_torch.rllib.replay_buffers import PrioritizedReplayBuffer, ReplayBuffer


from ray_tpu_torch.rllib.models import init_mlp, mlp_forward


def init_q_params(rng_seed: int, obs_dim: int, num_actions: int,
                  hidden: Tuple[int, ...] = (64, 64)) -> Dict[str, Any]:
    return init_mlp(np.random.default_rng(rng_seed),
                    (obs_dim, *hidden, num_actions),
                    final_scale=np.sqrt(2.0 / hidden[-1]))


def q_apply(params, obs, n_layers: int = 3):
    return mlp_forward(params, obs, n_layers)


@ray_tpu_torch.remote
class EpsilonGreedyWorker:
    """Env-stepping actor collecting transitions under epsilon-greedy.

    Acting is MODULE + CONNECTORS (reference EnvRunner + connector
    pipelines): the worker owns a `QModule` and the `EpsilonGreedy`
    module-to-env connector — no hand-rolled action selection. The
    algorithm's per-iteration epsilon schedule is forwarded per sample
    call as an override on the connector."""

    def __init__(self, env_maker, num_envs: int, seed: int, obs_dim: int,
                 num_actions: int, module=None, env_to_module=None,
                 module_to_env=None):
        from ray_tpu_torch.rllib.connectors import (CastObsFloat32,
                                              ConnectorPipeline,
                                              EpsilonGreedy)
        from ray_tpu_torch.rllib.rl_module import QModule

        self.vec = VectorEnv(env_maker, num_envs, seed)
        self.obs = self.vec.reset()
        self.rng = np.random.default_rng(seed)
        self.params = None
        self.num_actions = num_actions
        self.module = module or QModule(obs_dim, num_actions)
        self.env_to_module = env_to_module or ConnectorPipeline(
            [CastObsFloat32()])
        self.module_to_env = module_to_env or ConnectorPipeline(
            [EpsilonGreedy(num_actions)])
        self._ep_returns = np.zeros(num_envs, np.float32)
        self._completed: List[float] = []

    def set_weights(self, params) -> bool:
        self.params = {k: np.asarray(v) for k, v in params.items()}
        return True

    def eval_episodes(self, num_episodes: int, seed: int = 0):
        from ray_tpu_torch.rllib.evaluation import run_eval_episodes

        return run_eval_episodes(self.vec.env_maker, self.module,
                                 self.params, num_episodes, seed)

    def sample(self, num_steps: int, epsilon: float) -> Dict[str, np.ndarray]:
        cols = {k: [] for k in ("obs", "actions", "rewards", "next_obs", "dones")}
        for _ in range(num_steps):
            data = {"obs": self.obs, "rng": self.rng, "module": self.module,
                    "params": self.params, "epsilon_override": epsilon}
            data = self.env_to_module(data)
            data["fwd_out"] = self.module.forward_inference(self.params,
                                                            data["obs"])
            data = self.module_to_env(data)
            actions = data["actions"]
            prev_obs = self.obs
            self.obs, rewards, dones, _ = self.vec.step(actions)
            cols["obs"].append(prev_obs)
            cols["actions"].append(actions)
            cols["rewards"].append(rewards)
            cols["next_obs"].append(self.obs)
            cols["dones"].append(dones.astype(np.float32))
            self._ep_returns += rewards
            for i, d in enumerate(dones):
                if d:
                    self._completed.append(float(self._ep_returns[i]))
                    self._ep_returns[i] = 0.0
        out = {k: np.concatenate(v) if v[0].ndim > 1 else np.stack(v).reshape(-1)
               for k, v in cols.items()}
        ep, self._completed = self._completed, []
        out["episode_returns"] = np.array(ep, np.float32)
        return out


class DQNLearner(Learner):
    """Double-DQN TD update on the Learner stack; the target network rides
    through the update as the Learner's `extra` tree. Pass `mesh=` to shard
    batches over dp (LearnerGroup mesh backend)."""

    def __init__(self, obs_dim: int, num_actions: int, lr: float,
                 gamma: float, seed: int = 0, mesh=None,
                 double_q: bool = True, device="cuda"):
        self._obs_dim = obs_dim
        self._num_actions = num_actions
        self._gamma = gamma
        self._double_q = double_q
        super().__init__(lr=lr, mesh=mesh, seed=seed, device=device)

    def init_params(self, seed: int):
        return init_q_params(seed, self._obs_dim, self._num_actions)

    def make_extra(self):
        return clone_tree(self.params)

    def loss(self, params, batch, extra, rng):
        import torch

        target_params = extra
        q = q_apply(params, batch["obs"])
        q_taken = torch.gather(
            q, -1, batch["actions"][:, None].long())[:, 0]
        next_target = q_apply(target_params, batch["next_obs"])
        if self._double_q:
            # double DQN: online net picks argmax, target net evaluates
            next_online = q_apply(params, batch["next_obs"])
            next_a = torch.argmax(next_online, dim=-1)
            next_q = torch.gather(next_target, -1, next_a[:, None])[:, 0]
        else:
            # SimpleQ: plain max over the target net
            next_q = next_target.amax(-1)
        target = batch["rewards"] + self._gamma * (1.0 - batch["dones"]) * \
            next_q.detach()
        td = q_taken - target
        w = batch.get("weights")
        if w is None:
            w = torch.ones_like(td)
        loss = (w * td ** 2).mean()
        return loss, {"td": td}

    def update_batch(self, batch: Dict[str, np.ndarray]):
        aux = self.update(batch)
        return (float(aux["total_loss"]),
                aux["td"].detach().cpu().numpy())

    def sync_target(self) -> None:
        self.extra = clone_tree(self.params)

    def set_weights(self, weights):
        super().set_weights(weights)
        self.extra = clone_tree(self.params)

    # kept for callers that referenced the old attribute name
    @property
    def target_params(self):
        return self.extra


class DQNConfig(EvalConfigMixin):
    def __init__(self):
        self.env_maker: Callable[[int], Any] = lambda seed: CartPoleEnv(seed)
        self.obs_dim = CartPoleEnv.observation_dim
        self.num_actions = CartPoleEnv.num_actions
        self.num_rollout_workers = 2
        self.num_envs_per_worker = 2
        self.rollout_fragment_length = 32
        self.lr = 5e-4
        self.gamma = 0.99
        self.double_q = True
        self.buffer_capacity = 50_000
        self.prioritized_replay = False
        self.train_batch_size = 64
        self.num_updates_per_step = 8
        self.target_update_interval = 4     # in training_steps
        self.epsilon_start = 1.0
        self.epsilon_end = 0.05
        self.epsilon_decay_steps = 50
        self.learning_starts = 200           # min transitions before updates
        self.seed = 0
        self.device = "cuda"                 # the learner's; "cpu" for the CPU

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
                raise ValueError(f"unknown DQN option {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "DQN":
        return DQN({"dqn_config": self})


class DQN(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        cfg: DQNConfig = config.get("dqn_config") or DQNConfig()
        self.cfg = cfg
        self.learner = DQNLearner(cfg.obs_dim, cfg.num_actions, cfg.lr,
                                  cfg.gamma, cfg.seed,
                                  double_q=getattr(cfg, "double_q", True),
                                  device=cfg.device)
        if cfg.prioritized_replay:
            self.buffer = PrioritizedReplayBuffer(cfg.buffer_capacity,
                                                  seed=cfg.seed)
        else:
            self.buffer = ReplayBuffer(cfg.buffer_capacity, seed=cfg.seed)
        self.workers = [
            EpsilonGreedyWorker.options(num_cpus=1).remote(
                cfg.env_maker, cfg.num_envs_per_worker,
                cfg.seed + 1000 * (i + 1), cfg.obs_dim, cfg.num_actions)
            for i in range(cfg.num_rollout_workers)]
        self._broadcast()
        self._reward_history: List[float] = []
        self._total_steps = 0

    def _broadcast(self) -> None:
        from ray_tpu_torch.rllib.learner import broadcast_weights

        broadcast_weights(self.learner.get_weights(), self.workers)

    def _epsilon(self) -> float:
        cfg = self.cfg
        frac = min(1.0, self.iteration / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_start + frac * (cfg.epsilon_end - cfg.epsilon_start)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.cfg
        eps = self._epsilon()
        samples = ray_tpu_torch.get([
            wk.sample.remote(cfg.rollout_fragment_length, eps)
            for wk in self.workers])
        n_new = 0
        for s in samples:
            ep = s.pop("episode_returns")
            self._reward_history.extend(ep.tolist())
            self.buffer.add_batch(s)
            n_new += len(s["actions"])
            self._total_steps += len(s["actions"])
        self._reward_history = self._reward_history[-100:]

        losses = []
        if len(self.buffer) >= cfg.learning_starts:
            for _ in range(cfg.num_updates_per_step):
                batch = self.buffer.sample(cfg.train_batch_size)
                idx = batch.pop("batch_indexes", None)
                loss, td = self.learner.update_batch(batch)
                losses.append(loss)
                if idx is not None:
                    self.buffer.update_priorities(idx, td)
            if self.iteration % cfg.target_update_interval == 0:
                self.learner.sync_target()
            self._broadcast()
        mean_reward = float(np.mean(self._reward_history)) \
            if self._reward_history else 0.0
        return {
            "episode_reward_mean": mean_reward,
            "epsilon": eps,
            "buffer_size": len(self.buffer),
            "num_env_steps_sampled": self._total_steps,
            "loss": float(np.mean(losses)) if losses else float("nan"),
        }

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, weights) -> None:
        self.learner.set_weights(weights)
        self._broadcast()

    def stop(self) -> None:
        self._kill_workers(self.workers)
