"""MADDPG: multi-agent DDPG with centralized critics (Lowe et al. 2017).

Reference parity: rllib/algorithms/maddpg/ (SURVEY §2.3 algorithm list).
Each agent owns a decentralized actor mu_i(o_i) but a *centralized* critic
Q_i(o_1..o_N, a_1..a_N) trained off a shared replay buffer — the standard
fix for non-stationarity in continuous multi-agent control. The port of
ray_tpu/rllib/maddpg.py: actors, critics, their targets and Adam states
live on the config's device (the card by default; `.training(device=)`)
and update eagerly; rollouts step a cooperative continuous env in-process
(the env is cheap; the fleet pattern lives in ddpg.py), each agent's
action a forward of its actor on that device.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.learner import clone_tree
from ray_tpu_torch.rllib.models import init_mlp, mlp_forward
from ray_tpu_torch.rllib.replay_buffers import ReplayBuffer


class SpreadEnv:
    """Cooperative continuous env: N agents on a line must cover N distinct
    landmarks. obs_i = [own pos, all landmark offsets]; action_i = velocity
    in [-1, 1]. Shared reward = -sum_k min_i |pos_i - landmark_k| — a 1-D
    simple-spread (the MADDPG paper's benchmark family)."""

    def __init__(self, seed: int = 0, n_agents: int = 2,
                 episode_len: int = 25):
        self.n = n_agents
        self.rng = np.random.default_rng(seed)
        self.episode_len = episode_len
        self.obs_dim = 1 + n_agents  # own pos + landmark offsets
        self.action_dim = 1
        self.max_action = 1.0
        self.agents = [f"agent_{i}" for i in range(n_agents)]

    def _obs(self) -> Dict[str, np.ndarray]:
        return {
            a: np.concatenate(
                [[self.pos[i]], self.landmarks - self.pos[i]]
            ).astype(np.float32)
            for i, a in enumerate(self.agents)
        }

    def reset(self) -> Dict[str, np.ndarray]:
        self.pos = self.rng.uniform(-1, 1, self.n)
        self.landmarks = np.sort(self.rng.uniform(-1, 1, self.n))
        self.t = 0
        return self._obs()

    def step(self, actions: Dict[str, np.ndarray]):
        for i, a in enumerate(self.agents):
            self.pos[i] = np.clip(
                self.pos[i] + 0.1 * float(np.asarray(actions[a]).ravel()[0]),
                -2, 2)
        # each landmark scored by its nearest agent
        dists = np.abs(self.pos[:, None] - self.landmarks[None, :])
        reward = -float(dists.min(axis=0).sum())
        self.t += 1
        done = self.t >= self.episode_len
        obs = self._obs()
        rewards = {a: reward for a in self.agents}
        dones = {a: done for a in self.agents}
        dones["__all__"] = done
        return obs, rewards, dones, {}


class MADDPGConfig:
    def __init__(self):
        self.env_maker = lambda seed: SpreadEnv(seed)
        self.n_agents = 2
        self.obs_dim = 3  # SpreadEnv(n=2)
        self.action_dim = 1
        self.max_action = 1.0
        self.lr_actor = 1e-3
        self.lr_critic = 1e-3
        self.gamma = 0.95
        self.tau = 0.01
        self.buffer_size = 50_000
        self.batch_size = 256
        self.warmup_steps = 500
        self.expl_noise = 0.3
        self.episodes_per_iter = 10
        self.updates_per_iter = 50
        self.seed = 0
        self.device = "cuda"         # nets and Adam states; "cpu" for the CPU

    def environment(self, env_maker=None, *, n_agents=None, obs_dim=None,
                    action_dim=None, max_action=None) -> "MADDPGConfig":
        for k, v in [("env_maker", env_maker), ("n_agents", n_agents),
                     ("obs_dim", obs_dim), ("action_dim", action_dim),
                     ("max_action", max_action)]:
            if v is not None:
                setattr(self, k, v)
        return self

    def training(self, **kw) -> "MADDPGConfig":
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown option {k!r}")
            if v is not None:
                setattr(self, k, v)
        return self

    def build(self) -> "MADDPG":
        return MADDPG({"maddpg_config": self})


def actor_apply(params, obs, max_action: float):
    import torch

    return max_action * torch.tanh(mlp_forward(params, obs, 3))


def critic_apply(params, joint_in):
    return mlp_forward(params, joint_in, 3)[..., 0]


def critic_loss(cp, joint_in, target_q):
    q = critic_apply(cp, joint_in)
    return ((q - target_q) ** 2).mean()


def actor_loss(ap, cp, obs_all, act_all, i: int, max_action: float):
    """Agent i's action re-substituted with its current policy's output."""
    import torch

    my_act = actor_apply(ap, obs_all[:, i], max_action)
    act = torch.cat([act_all[:, :i], my_act[:, None], act_all[:, i + 1:]],
                    dim=1)
    B = obs_all.shape[0]
    joint_in = torch.cat(
        [obs_all.reshape(B, -1), act.reshape(B, -1)], dim=1)
    return -critic_apply(cp, joint_in).mean()


def _step(loss_fn, params, optimizer, opt_state, *args):
    """One optimizer step of `loss_fn(params, *args)`: (params, state,
    loss)."""
    import torch

    from ray_tpu_torch.rllib import optim

    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss = loss_fn(leaves, *args)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    with torch.no_grad():
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optim.apply_updates(params, updates)
    return params, opt_state, loss.detach()


class MADDPG(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        from ray_tpu_torch.rllib import optim
        from ray_tpu_torch.rllib.learner import _resolve_device, _to_tensors

        cfg: MADDPGConfig = config.get("maddpg_config") or MADDPGConfig()
        self.cfg = cfg
        self.device = _resolve_device(cfg.device, None)
        N, D, A = cfg.n_agents, cfg.obs_dim, cfg.action_dim
        rng = np.random.default_rng(cfg.seed)
        joint = N * (D + A)
        self.actors = [_to_tensors(init_mlp(rng, [D, 64, 64, A],
                                            final_scale=0.01), self.device)
                       for _ in range(N)]
        # centralized critics: Q_i over ALL obs + ALL actions
        self.critics = [_to_tensors(init_mlp(rng, [joint, 64, 64, 1],
                                             final_scale=0.01), self.device)
                        for _ in range(N)]
        self.t_actors = [clone_tree(p) for p in self.actors]
        self.t_critics = [clone_tree(p) for p in self.critics]
        self.opt_a = optim.adam(cfg.lr_actor)
        self.opt_c = optim.adam(cfg.lr_critic)
        self.os_a = [self.opt_a.init(p) for p in self.actors]
        self.os_c = [self.opt_c.init(p) for p in self.critics]
        self.rng = rng
        self.env = cfg.env_maker(cfg.seed)
        self.buffer = ReplayBuffer(cfg.buffer_size, seed=cfg.seed)
        self._total_steps = 0
        self._reward_history: List[float] = []

    def _actor_apply(self, params, obs: np.ndarray) -> np.ndarray:
        """An agent's action for host observations (no gradient)."""
        import torch

        with torch.no_grad():
            return actor_apply(params, torch.from_numpy(obs).to(self.device),
                               self.cfg.max_action).cpu().numpy()

    # ------------------------------------------------------------- rollout
    def _collect_episode(self, noise: float, store: bool = True) -> float:
        """store=False rolls out without touching the replay buffer or the
        sampled-step counter (pure evaluation)."""
        cfg = self.cfg
        env = self.env
        obs = env.reset()
        total = 0.0
        while True:
            obs_arr = np.stack([obs[a] for a in env.agents])
            acts = {}
            for i, a in enumerate(env.agents):
                mu = self._actor_apply(self.actors[i], obs_arr[i][None])[0]
                act = mu + noise * self.rng.standard_normal(cfg.action_dim)
                acts[a] = np.clip(act, -cfg.max_action, cfg.max_action)
            nxt, rewards, dones, _ = env.step(acts)
            nxt_arr = np.stack([nxt[a] for a in env.agents])
            act_arr = np.stack([acts[a] for a in env.agents])
            rew_arr = np.array([rewards[a] for a in env.agents], np.float32)
            if store:
                self.buffer.add_batch({
                    "obs": obs_arr[None], "actions": act_arr[None],
                    "rewards": rew_arr[None], "next_obs": nxt_arr[None],
                    "dones": np.array([float(dones["__all__"])],
                                      np.float32)})
                self._total_steps += 1
            total += rew_arr[0]
            obs = nxt
            if dones["__all__"]:
                return total

    def _update_once(self) -> Dict[str, float]:
        import torch

        from ray_tpu_torch.rllib.learner import _to_tensors
        from ray_tpu_torch.rllib.sac import polyak

        cfg = self.cfg
        sample = _to_tensors(self.buffer.sample(cfg.batch_size), self.device)
        obs_all = sample["obs"]  # [B,N,D]
        act_all = sample["actions"]
        rew_all = sample["rewards"]  # [B,N]
        nxt_all = sample["next_obs"]
        done = sample["dones"]

        B = cfg.batch_size
        with torch.no_grad():
            nxt_acts = torch.stack(
                [actor_apply(p, nxt_all[:, i], cfg.max_action)
                 for i, p in enumerate(self.t_actors)], dim=1)
        nxt_joint = torch.cat(
            [nxt_all.reshape(B, -1), nxt_acts.reshape(B, -1)], dim=1)
        joint_in = torch.cat(
            [obs_all.reshape(B, -1), act_all.reshape(B, -1)], dim=1)

        losses = []
        for i in range(cfg.n_agents):
            with torch.no_grad():
                tq = mlp_forward(self.t_critics[i], nxt_joint, 3)[:, 0]
                target_q = rew_all[:, i] + cfg.gamma * (1 - done) * tq
            self.critics[i], self.os_c[i], closs = _step(
                critic_loss, self.critics[i], self.opt_c, self.os_c[i],
                joint_in, target_q)
            self.actors[i], self.os_a[i], aloss = _step(
                actor_loss, self.actors[i], self.opt_a, self.os_a[i],
                self.critics[i], obs_all, act_all, i, cfg.max_action)
            with torch.no_grad():
                self.t_actors[i] = polyak(cfg.tau, self.t_actors[i],
                                          self.actors[i])
                self.t_critics[i] = polyak(cfg.tau, self.t_critics[i],
                                           self.critics[i])
            losses += [(f"critic_loss_{i}", closs), (f"actor_loss_{i}", aloss)]
        # one read of the card's losses, after every agent's update
        values = torch.stack([v for _, v in losses]).cpu().tolist()
        return {k: v for (k, _), v in zip(losses, values)}

    def training_step(self) -> Dict[str, Any]:
        cfg = self.cfg
        returns = [self._collect_episode(cfg.expl_noise)
                   for _ in range(cfg.episodes_per_iter)]
        stats: Dict[str, float] = {}
        if self._total_steps >= cfg.warmup_steps:
            for _ in range(cfg.updates_per_iter):
                stats = self._update_once()
        self._reward_history.extend(returns)
        self._reward_history = self._reward_history[-50:]
        return {"episode_reward_mean": float(np.mean(self._reward_history)),
                "num_env_steps_sampled": self._total_steps, **stats}

    def greedy_return(self, episodes: int = 5) -> float:
        totals = []
        for _ in range(episodes):
            totals.append(self._collect_episode(0.0, store=False))
        return float(np.mean(totals))

    def get_weights(self):
        from ray_tpu_torch.rllib.learner import _to_host

        return {"actors": [_to_host(p) for p in self.actors],
                "critics": [_to_host(p) for p in self.critics]}

    def set_weights(self, weights) -> None:
        from ray_tpu_torch.rllib.learner import _to_tensors

        self.actors = [_to_tensors(p, self.device) for p in weights["actors"]]
        self.critics = [_to_tensors(p, self.device)
                        for p in weights["critics"]]
        self.t_actors = [clone_tree(p) for p in self.actors]
        self.t_critics = [clone_tree(p) for p in self.critics]
