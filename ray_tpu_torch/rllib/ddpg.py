"""DDPG + TD3: deterministic-policy off-policy continuous control.

Mirrors the reference's DDPG/TD3 (`rllib/algorithms/ddpg/`,
`rllib/algorithms/td3/`): deterministic tanh actor with exploration noise,
Q critic(s) with polyak targets. TD3 adds the three tricks — twin critics,
target policy smoothing, delayed actor updates — as config flags on the
same learner, exactly how the reference derives TD3 from DDPG. The port
of ray_tpu/rllib/ddpg.py: the learner is one eager torch update on its
device (the card by default; `.training(device=)`), its targets copies
there.

TD3's target smoothing draws its standard normals from the learner's
`torch.Generator` on its device (`Learner.draw_normal`); a caller that
must match the reference passes them in the batch as `target_eps`
([rows, action_dim], before the scale by `target_noise`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.env import PendulumEnv
from ray_tpu_torch.rllib.models import init_mlp, mlp_forward
from ray_tpu_torch.rllib.replay_buffers import ReplayBuffer
from ray_tpu_torch.rllib.learner import Learner, clone_tree, delayed
from ray_tpu_torch.rllib.sac import (ContinuousWorkerBase, frozen, polyak,
                                     q_value)


def init_ddpg_params(seed: int, obs_dim: int, action_dim: int,
                     twin_q: bool,
                     hidden: Tuple[int, ...] = (256, 256)) -> Dict[str, Any]:
    rng = np.random.default_rng(seed)
    params = {
        "actor": init_mlp(rng, (obs_dim, *hidden, action_dim),
                          final_scale=0.01),
        "q1": init_mlp(rng, (obs_dim + action_dim, *hidden, 1)),
    }
    if twin_q:
        params["q2"] = init_mlp(rng, (obs_dim + action_dim, *hidden, 1))
    return params


def actor_apply(actor_params, obs, max_action: float):
    import torch

    return torch.tanh(
        mlp_forward(actor_params, obs, len(actor_params) // 2)) * max_action


@ray_tpu_torch.remote
class NoisyActorWorker(ContinuousWorkerBase):
    """Env actor for DDPG/TD3: DeterministicPolicyModule + the
    SampleAction -> GaussianNoise connector pipeline (exploration is a
    pipeline edit, not worker code)."""

    def __init__(self, env_maker, num_envs: int, seed: int, obs_dim: int,
                 action_dim: int, max_action: float, noise_scale: float):
        self.noise_scale = noise_scale
        super().__init__(env_maker, num_envs, seed, obs_dim, action_dim,
                         max_action)

    def _make_module(self, obs_dim, action_dim, max_action):
        from ray_tpu_torch.rllib.rl_module import DeterministicPolicyModule

        return DeterministicPolicyModule(obs_dim, action_dim, max_action)

    def _make_module_to_env(self):
        from ray_tpu_torch.rllib.connectors import (ConnectorPipeline,
                                              GaussianNoise, SampleAction)

        return ConnectorPipeline([
            SampleAction(record_logp=False),
            GaussianNoise(self.noise_scale * self.max_action,
                          -self.max_action, self.max_action)])


class DDPGLearner(Learner):
    """Critic + (optionally delayed) actor update with polyak sync, on the
    Learner stack: ONE combined loss whose per-term detaches route
    gradients (critic <- TD, actor <- Q through FROZEN critic), per-group
    optimizers via `optim.multi_transform` (the reference's
    configure_optimizers_for_module), the TD3 actor delay as a `delayed`
    transform with frozen inner state, and the polyak target sync as the
    post_update hook."""

    def __init__(self, obs_dim: int, action_dim: int, max_action: float,
                 actor_lr: float, critic_lr: float, gamma: float, tau: float,
                 twin_q: bool, smooth_target_policy: bool,
                 target_noise: float, target_noise_clip: float,
                 seed: int = 0, policy_delay: int = 1, mesh=None,
                 device="cuda"):
        self._obs_dim = obs_dim
        self._action_dim = action_dim
        self._max_action = max_action
        self._actor_lr = actor_lr
        self._critic_lr = critic_lr
        self._gamma = gamma
        self._tau = tau
        self.twin_q = twin_q
        self._smooth = smooth_target_policy
        self._tnoise = target_noise
        self._tclip = target_noise_clip
        self._policy_delay = max(1, policy_delay)
        super().__init__(mesh=mesh, seed=seed, device=device)

    def init_params(self, seed: int):
        return init_ddpg_params(seed, self._obs_dim, self._action_dim,
                                self.twin_q)

    def make_optimizer(self):
        from ray_tpu_torch.rllib import optim

        actor_tx = optim.adam(self._actor_lr)
        if self._policy_delay > 1:
            actor_tx = delayed(actor_tx, self._policy_delay)

        def labeler(params):
            return {k: optim.tree_map(
                        lambda _, lbl=("actor" if k == "actor" else "critic"):
                        lbl, v)
                    for k, v in params.items()}

        return optim.multi_transform(
            {"actor": actor_tx, "critic": optim.adam(self._critic_lr)},
            labeler)

    def make_extra(self):
        return clone_tree(self.params)

    def post_update(self, params, extra):
        return polyak(self._tau, extra, params)

    def loss(self, params, batch, extra, rng):
        import torch

        next_a = actor_apply(extra["actor"], batch["next_obs"],
                             self._max_action)
        if self._smooth:
            eps = batch.get("target_eps")
            if eps is None:
                eps = self.draw_normal(rng, tuple(next_a.shape))
            noise = torch.clamp(eps * self._tnoise,
                                -self._tclip, self._tclip)
            next_a = torch.clamp(next_a + noise,
                                 -self._max_action, self._max_action)
        tq = q_value(extra["q1"], batch["next_obs"], next_a)
        if self.twin_q:
            tq = torch.minimum(
                tq, q_value(extra["q2"], batch["next_obs"], next_a))
        backup = (batch["rewards"] + self._gamma
                  * (1 - batch["dones"]) * tq).detach()
        # importance weights from prioritized replay (Ape-X), 1 otherwise
        w = batch.get("weights", 1.0)
        c_loss = (w * (q_value(params["q1"], batch["obs"], batch["actions"])
                       - backup) ** 2).mean()
        if self.twin_q:
            c_loss += (w * (q_value(params["q2"], batch["obs"],
                                    batch["actions"])
                            - backup) ** 2).mean()

        a = actor_apply(params["actor"], batch["obs"], self._max_action)
        a_loss = -q_value(frozen(params["q1"]), batch["obs"], a).mean()

        total = c_loss + a_loss
        td = q_value(params["q1"], batch["obs"], batch["actions"]) - backup
        return total, {"critic_loss": c_loss, "actor_loss": a_loss,
                       "td": td}

    def update_batch(self, batch) -> Dict[str, float]:
        from ray_tpu_torch.rllib.learner import host_scalars

        return host_scalars(self.update(batch))

    def set_weights(self, weights):
        super().set_weights(weights)
        self.extra = self.make_extra()


class DDPGConfig:
    _algo_cls_name = "DDPG"

    def __init__(self):
        self.env_maker: Callable[[int], Any] = lambda seed: PendulumEnv(seed)
        self.obs_dim = PendulumEnv.observation_dim
        self.action_dim = PendulumEnv.action_dim
        self.max_action = PendulumEnv.max_action
        self.num_rollout_workers = 1
        self.num_envs_per_worker = 1
        self.rollout_fragment_length = 64
        self.actor_lr = 1e-3
        self.critic_lr = 1e-3
        self.gamma = 0.99
        self.tau = 0.005
        self.exploration_noise = 0.1
        self.buffer_size = 100_000
        self.train_batch_size = 256
        self.num_updates_per_step = 8
        self.learning_starts = 256
        # TD3 tricks (off for plain DDPG)
        self.twin_q = False
        self.smooth_target_policy = False
        self.target_noise = 0.2
        self.target_noise_clip = 0.5
        self.policy_delay = 1
        self.seed = 0
        self.device = "cuda"         # the learner's; "cpu" for the CPU

    def environment(self, env_maker=None, *, obs_dim=None, action_dim=None,
                    max_action=None):
        if env_maker is not None:
            self.env_maker = env_maker
        if obs_dim is not None:
            self.obs_dim = obs_dim
        if action_dim is not None:
            self.action_dim = action_dim
        if max_action is not None:
            self.max_action = max_action
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
                raise ValueError(f"unknown option {k!r}")
            setattr(self, k, v)
        return self

    def build(self):
        return DDPG({"ddpg_config": self})


class TD3Config(DDPGConfig):
    """DDPG config with the TD3 defaults switched on
    (reference `rllib/algorithms/td3/td3.py`)."""

    def __init__(self):
        super().__init__()
        self.twin_q = True
        self.smooth_target_policy = True
        self.policy_delay = 2

    def build(self):
        return TD3({"ddpg_config": self})


class DDPG(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        cfg: DDPGConfig = config.get("ddpg_config") or DDPGConfig()
        self.cfg = cfg
        self.learner = DDPGLearner(
            cfg.obs_dim, cfg.action_dim, cfg.max_action, cfg.actor_lr,
            cfg.critic_lr, cfg.gamma, cfg.tau, cfg.twin_q,
            cfg.smooth_target_policy, cfg.target_noise,
            cfg.target_noise_clip, cfg.seed, policy_delay=cfg.policy_delay,
            device=cfg.device)
        self.buffer = ReplayBuffer(cfg.buffer_size, seed=cfg.seed)
        self.workers = [
            NoisyActorWorker.options(num_cpus=1).remote(
                cfg.env_maker, cfg.num_envs_per_worker,
                cfg.seed + 1000 * (i + 1), cfg.obs_dim, cfg.action_dim,
                cfg.max_action, cfg.exploration_noise)
            for i in range(cfg.num_rollout_workers)]
        self._broadcast_weights()
        self._reward_history: List[float] = []
        self._total_steps = 0

    def _broadcast_weights(self) -> None:
        from ray_tpu_torch.rllib.learner import broadcast_weights

        broadcast_weights(self.learner.get_weights()["actor"], self.workers)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.cfg
        random_phase = self._total_steps < cfg.learning_starts
        samples = ray_tpu_torch.get([
            w.sample.remote(cfg.rollout_fragment_length, random_phase)
            for w in self.workers])
        for batch in samples:
            self.buffer.add_batch({
                k: batch[k] for k in
                ("obs", "actions", "rewards", "next_obs", "dones")})
            self._total_steps += int(batch["actions"].shape[0])
            self._reward_history.extend(batch["episode_returns"].tolist())
        self._reward_history = self._reward_history[-100:]
        stats: Dict[str, float] = {}
        if len(self.buffer) >= cfg.train_batch_size:
            for _ in range(cfg.num_updates_per_step):
                mb = self.buffer.sample(cfg.train_batch_size)
                # the actor's update period lives INSIDE the optimizer (a
                # `delayed` transform), so every call is the same step
                stats = self.learner.update_batch(
                    {k: mb[k] for k in
                     ("obs", "actions", "rewards", "next_obs", "dones")})
            self._broadcast_weights()
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


class TD3(DDPG):
    """TD3 = DDPG + twin critics + target smoothing + delayed actor
    (reference rllib/algorithms/td3)."""
