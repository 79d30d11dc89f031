"""SAC: soft actor-critic for continuous control.

Mirrors the reference's SAC (`rllib/algorithms/sac/sac.py`): off-policy
replay, twin soft Q critics with target networks, a tanh-squashed Gaussian
policy, and automatic entropy-temperature tuning; the port of
ray_tpu/rllib/sac.py. Sampling runs on env actors in numpy; the learner is
one eager torch update on its device (the card by default; critic + actor
+ alpha in a single step, polyak target sync).

The reparameterized samples draw their standard normals from the
learner's `torch.Generator` on its device (`Learner.draw_normal`): a JAX
key stream cannot be reproduced in torch, so a caller that must match the
reference passes the draws in the batch instead (`next_eps` and `eps`,
[rows, action_dim] each, in the order the reference's `jax.random.split`
keys take them).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.env import ContinuousVectorEnv, PendulumEnv
from ray_tpu_torch.rllib.models import init_mlp, mlp_forward
from ray_tpu_torch.rllib.learner import Learner, clone_tree
from ray_tpu_torch.rllib.replay_buffers import ReplayBuffer

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0


def init_sac_params(seed: int, obs_dim: int, action_dim: int,
                    hidden: Tuple[int, ...] = (256, 256)) -> Dict[str, Any]:
    rng = np.random.default_rng(seed)
    return {
        "actor": init_mlp(rng, (obs_dim, *hidden, 2 * action_dim),
                          final_scale=0.01),
        "q1": init_mlp(rng, (obs_dim + action_dim, *hidden, 1)),
        "q2": init_mlp(rng, (obs_dim + action_dim, *hidden, 1)),
    }


def actor_dist(actor_params, obs, action_dim: int):
    """Returns (mean, log_std) of the pre-squash Gaussian."""
    import torch

    out = mlp_forward(actor_params, obs, len(actor_params) // 2)
    mean, log_std = out[..., :action_dim], out[..., action_dim:]
    log_std = torch.clamp(log_std, LOG_STD_MIN, LOG_STD_MAX)
    return mean, log_std


def sample_action(actor_params, obs, eps, action_dim: int, max_action: float):
    """Reparameterized tanh-Gaussian sample with log-prob correction;
    `eps` is the standard normal draw, of the mean's shape."""
    import torch
    import torch.nn.functional as F

    mean, log_std = actor_dist(actor_params, obs, action_dim)
    std = torch.exp(log_std)
    pre = mean + std * eps
    a = torch.tanh(pre)
    # log N(pre; mean, std) - sum log(1 - tanh^2) [change of variables]
    logp = (-0.5 * (eps**2 + 2 * log_std + math.log(2 * math.pi))).sum(-1)
    logp = logp - (2 * (math.log(2.0) - pre - F.softplus(-2 * pre))).sum(-1)
    return a * max_action, logp


def q_value(q_params, obs, action):
    import torch

    x = torch.cat([obs, action], dim=-1)
    return mlp_forward(q_params, x, len(q_params) // 2)[..., 0]


def frozen(tree):
    """The leaves of a params subtree cut from autograd (the reference's
    `stop_gradient` on a pytree)."""
    return {k: v.detach() for k, v in tree.items()}


def polyak(tau: float, target, online):
    """(1 - tau)·t + tau·p leaf by leaf, the reference's order of the
    arithmetic (a `lerp` rounds differently)."""
    from ray_tpu_torch.rllib import optim

    return optim.tree_map(lambda t, p: (1 - tau) * t + tau * p, target,
                          online)


class ContinuousWorkerBase:
    """Shared env-actor loop for continuous control: random warmup phase,
    transition collection, episode-return bookkeeping.

    Acting is MODULE + CONNECTORS (reference EnvRunner + connector
    pipelines): subclasses provide `_make_module` and `_make_module_to_env`
    — the exploration policy is a pipeline edit (SampleAction for SAC's
    stochastic actor; SampleAction+GaussianNoise for DDPG/TD3), and the
    warmup phase is the RandomActions connector, not worker code."""

    def __init__(self, env_maker, num_envs: int, seed: int,
                 obs_dim: int, action_dim: int, max_action: float):
        from ray_tpu_torch.rllib.connectors import (CastObsFloat32,
                                                    ConnectorPipeline,
                                                    RandomActions)

        self.vec = ContinuousVectorEnv(env_maker, num_envs, seed)
        self.obs = self.vec.reset()
        self.rng = np.random.default_rng(seed)
        self.params = None
        self.action_dim = action_dim
        self.max_action = max_action
        self.module = self._make_module(obs_dim, action_dim, max_action)
        self.env_to_module = ConnectorPipeline([CastObsFloat32()])
        self.module_to_env = self._make_module_to_env()
        self.random_warmup = ConnectorPipeline(
            [RandomActions(action_dim, -max_action, max_action)])
        self._ep_returns = np.zeros(num_envs, np.float32)
        self._completed: List[float] = []

    def set_weights(self, actor) -> bool:
        self.params = {k: np.asarray(v) for k, v in actor.items()}
        return True

    def _make_module(self, obs_dim: int, action_dim: int, max_action: float):
        raise NotImplementedError

    def _make_module_to_env(self):
        raise NotImplementedError

    def _act(self, random_policy: bool) -> np.ndarray:
        data = {"obs": self.obs, "rng": self.rng, "module": self.module,
                "params": self.params}
        data = self.env_to_module(data)
        if random_policy or self.params is None:
            data = self.random_warmup(data)
        else:
            data["fwd_out"] = self.module.forward_inference(self.params,
                                                            data["obs"])
            data = self.module_to_env(data)
        return np.asarray(data["actions"], np.float32)

    def sample(self, num_steps: int, random_policy: bool = False):
        cols = {k: [] for k in ("obs", "actions", "rewards", "next_obs", "dones")}
        for _ in range(num_steps):
            actions = self._act(random_policy)
            prev = self.obs
            self.obs, rewards, dones, _ = self.vec.step(actions)
            cols["obs"].append(prev)
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


@ray_tpu_torch.remote
class ContinuousSampleWorker(ContinuousWorkerBase):
    """Env actor for SAC: SquashedGaussianModule + SampleAction."""

    def _make_module(self, obs_dim, action_dim, max_action):
        from ray_tpu_torch.rllib.rl_module import SquashedGaussianModule

        return SquashedGaussianModule(obs_dim, action_dim, max_action)

    def _make_module_to_env(self):
        from ray_tpu_torch.rllib.connectors import (ConnectorPipeline,
                                                    SampleAction)

        return ConnectorPipeline([SampleAction(record_logp=False)])


class SACLearner(Learner):
    """Twin-Q soft policy iteration with auto-alpha, as ONE combined loss
    on the Learner stack: per-term detaches give each parameter group
    exactly its own gradients (critic <- TD, actor <- reparameterized Q
    through FROZEN critics, log_alpha <- entropy temperature), and the
    polyak target sync is the post_update hook (reference SAC via
    core/learner + additional_update_for_module). The target critics are
    copies on the learner's device."""

    def __init__(self, obs_dim: int, action_dim: int, max_action: float,
                 lr: float, gamma: float, tau: float,
                 target_entropy: float, seed: int = 0, mesh=None,
                 device="cuda"):
        self._obs_dim = obs_dim
        self._action_dim = action_dim
        self._max_action = max_action
        self._gamma = gamma
        self._tau = tau
        self._target_entropy = target_entropy
        super().__init__(lr=lr, mesh=mesh, seed=seed, device=device)

    def init_params(self, seed: int):
        p = init_sac_params(seed, self._obs_dim, self._action_dim)
        p["log_alpha"] = np.zeros((), np.float32)
        return p

    def make_extra(self):
        return clone_tree({"q1": self.params["q1"], "q2": self.params["q2"]})

    def post_update(self, params, extra):
        return polyak(self._tau, extra,
                      {"q1": params["q1"], "q2": params["q2"]})

    def _eps(self, batch, key, rng):
        """The batch's standard normals under `key` if a caller passed
        them, else a draw from the learner's generator."""
        eps = batch.get(key)
        if eps is None:
            eps = self.draw_normal(rng, (batch["obs"].shape[0],
                                         self._action_dim))
        return eps

    def loss(self, params, batch, extra, rng):
        import torch

        alpha = torch.exp(params["log_alpha"])

        # critic: TD toward entropy-regularized target-Q backup
        next_a, next_logp = sample_action(
            params["actor"], batch["next_obs"],
            self._eps(batch, "next_eps", rng),
            self._action_dim, self._max_action)
        tq = torch.minimum(q_value(extra["q1"], batch["next_obs"], next_a),
                           q_value(extra["q2"], batch["next_obs"], next_a))
        backup = (batch["rewards"] + self._gamma * (1 - batch["dones"])
                  * (tq - alpha * next_logp)).detach()
        q1 = q_value(params["q1"], batch["obs"], batch["actions"])
        q2 = q_value(params["q2"], batch["obs"], batch["actions"])
        c_loss = ((q1 - backup) ** 2).mean() + ((q2 - backup) ** 2).mean()

        # actor: reparameterized sample through FROZEN critics
        a, logp = sample_action(
            params["actor"], batch["obs"],
            self._eps(batch, "eps", rng),
            self._action_dim, self._max_action)
        q_pi = torch.minimum(q_value(frozen(params["q1"]), batch["obs"], a),
                             q_value(frozen(params["q2"]), batch["obs"], a))
        a_loss = (alpha.detach() * logp - q_pi).mean()

        # temperature toward the target entropy
        alpha_loss = (-torch.exp(params["log_alpha"])
                      * (logp + self._target_entropy).detach()).mean()

        total = c_loss + a_loss + alpha_loss
        return total, {"critic_loss": c_loss, "actor_loss": a_loss,
                       "alpha": alpha.detach(),
                       "entropy": -logp.detach().mean()}

    def update_batch(self, batch) -> Dict[str, float]:
        aux = self.update(batch)
        return {k: float(v) for k, v in aux.items()}

    def set_weights(self, weights):
        super().set_weights(weights)
        self.extra = self.make_extra()


class SACConfig:
    def __init__(self):
        self.env_maker: Callable[[int], Any] = lambda seed: PendulumEnv(seed)
        self.obs_dim = PendulumEnv.observation_dim
        self.action_dim = PendulumEnv.action_dim
        self.max_action = PendulumEnv.max_action
        self.num_rollout_workers = 1
        self.num_envs_per_worker = 1
        self.rollout_fragment_length = 64
        self.lr = 3e-4
        self.gamma = 0.99
        self.tau = 0.005
        self.target_entropy = None   # default: -action_dim
        self.buffer_size = 100_000
        self.train_batch_size = 256
        self.num_updates_per_step = 8
        self.learning_starts = 256
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
                raise ValueError(f"unknown SAC option {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "SAC":
        return SAC({"sac_config": self})


class SAC(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        cfg: SACConfig = config.get("sac_config") or SACConfig()
        self.cfg = cfg
        target_entropy = (cfg.target_entropy if cfg.target_entropy is not None
                          else -float(cfg.action_dim))
        self.learner = SACLearner(
            cfg.obs_dim, cfg.action_dim, cfg.max_action, cfg.lr, cfg.gamma,
            cfg.tau, target_entropy, cfg.seed, device=cfg.device)
        self.buffer = ReplayBuffer(cfg.buffer_size, seed=cfg.seed)
        self.workers = [
            ContinuousSampleWorker.options(num_cpus=1).remote(
                cfg.env_maker, cfg.num_envs_per_worker,
                cfg.seed + 1000 * (i + 1), cfg.obs_dim, cfg.action_dim,
                cfg.max_action)
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
                stats = self.learner.update_batch({
                    k: mb[k] for k in
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
