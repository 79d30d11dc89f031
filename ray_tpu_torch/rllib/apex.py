"""Ape-X DQN: distributed prioritized experience replay.

Mirrors the reference's APEX anatomy (`rllib/algorithms/apex_dqn/`):
a fleet of epsilon-greedy rollout workers with a *per-worker epsilon
ladder* (worker i explores at eps^(1 + i/(N-1)*alpha)), transitions flow
into a replay *actor* (off the driver — the reference shards replay across
`num_replay_buffer_shards` actors), the learner samples from replay,
updates, and pushes new priorities back; weights broadcast periodically
rather than synchronously every step. The port of ray_tpu/rllib/apex.py:
replay actors and rollout workers stay in numpy on the CPU; the learner
(DQN's, or DDPG's for Ape-X DDPG) is on its device, the card by default
(`.training(device=)`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.dqn import DQNLearner, EpsilonGreedyWorker
from ray_tpu_torch.rllib.env import CartPoleEnv
from ray_tpu_torch.rllib.replay_buffers import PrioritizedReplayBuffer


@ray_tpu_torch.remote
class ReplayActor:
    """One prioritized replay shard living in its own process."""

    def __init__(self, capacity: int, alpha: float, seed: int):
        self.buffer = PrioritizedReplayBuffer(capacity, alpha=alpha, seed=seed)

    def add_batch(self, batch: Dict[str, np.ndarray]) -> int:
        self.buffer.add_batch(batch)
        return len(self.buffer)

    def sample(self, batch_size: int, beta: float):
        if len(self.buffer) < batch_size:
            return None
        return self.buffer.sample(batch_size, beta=beta)

    def update_priorities(self, idx, td) -> bool:
        self.buffer.update_priorities(idx, td)
        return True

    def size(self) -> int:
        return len(self.buffer)


class ApexDQNConfig:
    def __init__(self):
        self.env_maker: Callable[[int], Any] = lambda seed: CartPoleEnv(seed)
        self.obs_dim = CartPoleEnv.observation_dim
        self.num_actions = CartPoleEnv.num_actions
        self.num_rollout_workers = 3
        self.num_envs_per_worker = 2
        self.rollout_fragment_length = 32
        self.num_replay_shards = 1
        self.lr = 5e-4
        self.gamma = 0.99
        self.buffer_capacity = 50_000
        self.replay_alpha = 0.6
        self.replay_beta = 0.4
        self.train_batch_size = 64
        self.num_updates_per_step = 8
        self.target_update_interval = 4      # in training_steps
        self.broadcast_interval = 1          # weight push cadence
        self.base_epsilon = 0.4              # ladder: eps^(1 + i/(N-1)*7)
        self.epsilon_alpha = 7.0
        self.learning_starts = 200
        self.seed = 0
        self.device = "cuda"         # the learner's; "cpu" for the CPU

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
                raise ValueError(f"unknown ApexDQN option {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "ApexDQN":
        return ApexDQN({"apex_config": self})


class ApexDQN(Algorithm):
    """The Ape-X anatomy as an extensible template: `_make_learner`,
    `_make_workers`, `_issue_sample`, `_learner_update`, and
    `_maybe_sync_target` are the algorithm-specific seams ApexDDPG
    overrides (the reference derives apex_ddpg from apex_dqn the same
    way)."""

    def setup(self, config: Dict[str, Any]) -> None:
        cfg = config.get("apex_config") or ApexDQNConfig()
        self.cfg = cfg
        self.learner = self._make_learner(cfg)
        self.replays = [
            ReplayActor.options(num_cpus=1).remote(
                cfg.buffer_capacity // cfg.num_replay_shards,
                cfg.replay_alpha, cfg.seed + i)
            for i in range(cfg.num_replay_shards)]
        self.workers = self._make_workers(cfg)
        self._broadcast()
        self._reward_history: List[float] = []
        self._total_steps = 0
        self._buffered = 0
        self._pending: Dict[Any, int] = {}  # sample future -> worker index

    # ------------------------------------------------------- subclass seams
    def _make_learner(self, cfg):
        return DQNLearner(cfg.obs_dim, cfg.num_actions, cfg.lr,
                          cfg.gamma, cfg.seed, device=cfg.device)

    def _make_workers(self, cfg) -> List[Any]:
        self._epsilons = self._epsilon_ladder(cfg.num_rollout_workers)
        return [
            EpsilonGreedyWorker.options(num_cpus=1).remote(
                cfg.env_maker, cfg.num_envs_per_worker,
                cfg.seed + 1000 * (i + 1), cfg.obs_dim, cfg.num_actions)
            for i in range(cfg.num_rollout_workers)]

    def _issue_sample(self, i: int, wk):
        return wk.sample.remote(self.cfg.rollout_fragment_length,
                                self._epsilons[i])

    def _learner_update(self, batch):
        """One update; returns (loss, |td| priorities)."""
        loss, td = self.learner.update_batch(batch)
        return loss, np.abs(td)

    def _maybe_sync_target(self) -> None:
        if self.iteration % self.cfg.target_update_interval == 0:
            self.learner.sync_target()

    def _extra_stats(self) -> Dict[str, Any]:
        return {"epsilons": list(self._epsilons)}

    # -------------------------------------------------------------- driver
    def _epsilon_ladder(self, n: int) -> List[float]:
        cfg = self.cfg
        if n == 1:
            return [cfg.base_epsilon]
        return [cfg.base_epsilon ** (1.0 + i / (n - 1) * cfg.epsilon_alpha)
                for i in range(n)]

    def _broadcast(self) -> None:
        from ray_tpu_torch.rllib.learner import broadcast_weights

        broadcast_weights(self.learner.get_weights(), self.workers)

    def _shard_for(self, i: int):
        return self.replays[i % len(self.replays)]

    def training_step(self) -> Dict[str, Any]:
        cfg = self.cfg
        # keep one in-flight sample per worker; harvest only what is ready
        # so rollout collection overlaps with the learner's update loop
        for i, wk in enumerate(self.workers):
            if not any(w == i for w in self._pending.values()):
                self._pending[self._issue_sample(i, wk)] = i
        sizes = ray_tpu_torch.get([r.size.remote() for r in self.replays])
        ready, _ = ray_tpu_torch.wait(list(self._pending),
                                num_returns=len(self._pending), timeout=0.05)
        if not ready and sum(sizes) < cfg.learning_starts:
            # nothing buffered yet: block for the first fragment
            ready, _ = ray_tpu_torch.wait(list(self._pending), num_returns=1,
                                    timeout=30)
        store_futs = []
        n_stored = 0
        for fut in ready:
            i = self._pending.pop(fut)
            s = ray_tpu_torch.get(fut)
            ep = s.pop("episode_returns")
            self._reward_history.extend(ep.tolist())
            self._total_steps += len(s["actions"])
            n_stored += len(s["actions"])
            store_futs.append(self._shard_for(i).add_batch.remote(s))
        ray_tpu_torch.get(store_futs)
        self._reward_history = self._reward_history[-100:]

        self._buffered = int(sum(sizes) + n_stored)
        losses = []
        if self._buffered >= cfg.learning_starts:
            for u in range(cfg.num_updates_per_step):
                shard = self.replays[u % len(self.replays)]
                batch = ray_tpu_torch.get(shard.sample.remote(
                    cfg.train_batch_size, cfg.replay_beta))
                if batch is None:
                    continue
                idx = batch.pop("batch_indexes")
                loss, priorities = self._learner_update(batch)
                losses.append(loss)
                shard.update_priorities.remote(idx, priorities)
            self._maybe_sync_target()
            if self.iteration % cfg.broadcast_interval == 0:
                self._broadcast()
        return {
            "episode_reward_mean": (float(np.mean(self._reward_history))
                                    if self._reward_history else 0.0),
            "buffer_size": self._buffered,
            "num_env_steps_sampled": self._total_steps,
            "loss": float(np.mean(losses)) if losses else float("nan"),
            **self._extra_stats(),
        }

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, weights) -> None:
        self.learner.set_weights(weights)
        self._broadcast()

    def stop(self) -> None:
        self._kill_workers(self.workers + self.replays)


class ApexDDPGConfig:
    """Ape-X architecture around the DDPG learner
    (reference `rllib/algorithms/apex_ddpg/apex_ddpg.py`)."""

    def __init__(self):
        from ray_tpu_torch.rllib.env import PendulumEnv

        self.env_maker: Callable[[int], Any] = lambda seed: PendulumEnv(seed)
        self.obs_dim = PendulumEnv.observation_dim
        self.action_dim = PendulumEnv.action_dim
        self.max_action = PendulumEnv.max_action
        self.num_rollout_workers = 3
        self.num_envs_per_worker = 1
        self.rollout_fragment_length = 32
        self.num_replay_shards = 1
        self.actor_lr = 1e-3
        self.critic_lr = 1e-3
        self.gamma = 0.99
        self.tau = 0.005
        self.twin_q = False
        self.buffer_capacity = 100_000
        self.replay_alpha = 0.6
        self.replay_beta = 0.4
        self.train_batch_size = 128
        self.num_updates_per_step = 8
        self.broadcast_interval = 1
        # per-worker exploration-noise ladder (the continuous analog of
        # Ape-X's epsilon ladder): worker i explores at base^(1+i/(N-1)*a)
        self.base_noise = 0.4
        self.noise_alpha = 3.0
        self.learning_starts = 256
        self.seed = 0
        self.device = "cuda"         # the learner's; "cpu" for the CPU

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
                raise ValueError(f"unknown ApexDDPG option {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "ApexDDPG":
        return ApexDDPG({"apex_config": self})


class ApexDDPG(ApexDQN):
    """Distributed prioritized replay + DDPG: noise-laddered continuous
    actors feed replay shards; the learner polyak-syncs its targets inside
    its update, so there is no explicit target-sync step."""

    def _make_learner(self, cfg):
        from ray_tpu_torch.rllib.ddpg import DDPGLearner

        return DDPGLearner(
            cfg.obs_dim, cfg.action_dim, cfg.max_action, cfg.actor_lr,
            cfg.critic_lr, cfg.gamma, cfg.tau, cfg.twin_q,
            smooth_target_policy=False, target_noise=0.0,
            target_noise_clip=0.0, seed=cfg.seed, device=cfg.device)

    def _make_workers(self, cfg) -> List[Any]:
        from ray_tpu_torch.rllib.ddpg import NoisyActorWorker

        if cfg.num_rollout_workers == 1:
            noises = [cfg.base_noise]
        else:
            n = cfg.num_rollout_workers
            noises = [cfg.base_noise ** (1.0 + i / (n - 1) * cfg.noise_alpha)
                      for i in range(n)]
        self._noises = noises
        return [
            NoisyActorWorker.options(num_cpus=1).remote(
                cfg.env_maker, cfg.num_envs_per_worker,
                cfg.seed + 1000 * (i + 1), cfg.obs_dim, cfg.action_dim,
                cfg.max_action, noises[i])
            for i in range(cfg.num_rollout_workers)]

    def _issue_sample(self, i: int, wk):
        random_phase = self._buffered < self.cfg.learning_starts
        return wk.sample.remote(self.cfg.rollout_fragment_length,
                                random_phase)

    def _learner_update(self, batch):
        keys = ("obs", "actions", "rewards", "next_obs", "dones", "weights")
        aux = self.learner.update({k: batch[k] for k in keys if k in batch})
        return (float(aux["total_loss"]),
                np.abs(aux["td"].detach().cpu().numpy()))

    def _maybe_sync_target(self) -> None:
        pass  # polyak sync rides the post_update hook

    def _broadcast(self) -> None:
        from ray_tpu_torch.rllib.learner import broadcast_weights

        broadcast_weights(self.learner.get_weights()["actor"], self.workers)

    def _extra_stats(self) -> Dict[str, Any]:
        return {"noise_scales": list(self._noises)}
