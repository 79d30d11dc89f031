"""Multi-agent RL: env API, policy mapping, and QMIX value mixing.

Mirrors the reference's multi-agent stack (`rllib/env/multi_agent_env.py`,
policy mapping in `rllib/policy/policy_map.py`, and the QMIX algorithm
`rllib/algorithms/qmix/`): dict-keyed observations/actions/rewards per
agent, a `policy_mapping_fn` routing agents onto shared or independent
policies, and centralized-training/decentralized-execution via a monotonic
mixing network (Rashid et al. 2018) — per-agent Q-values are mixed with
state-conditioned non-negative weights so the argmax factorizes per agent
while training uses the joint reward.

The port of ray_tpu/rllib/multi_agent.py: QMIX's params and Adam state live
on the config's device (the card by default; `.training(device=)`) and
update eagerly; its envs, replay and epsilon-greedy acting stay on the
host.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.learner import clone_tree
from ray_tpu_torch.rllib.models import init_mlp, mlp_forward
from ray_tpu_torch.rllib.replay_buffers import ReplayBuffer


class MultiAgentEnv:
    """reset() -> {agent: obs}; step({agent: act}) ->
    (obs, rewards, dones incl '__all__', infos) — the reference's contract
    (`rllib/env/multi_agent_env.py`)."""

    agent_ids: List[str] = []

    def reset(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def step(self, actions: Dict[str, int]):
        raise NotImplementedError


class TwoStepCooperativeEnv(MultiAgentEnv):
    """The QMIX paper's two-step cooperative matrix game: agent 1's first
    action selects the second-step payoff matrix; the optimal joint return
    (8) requires coordination that independent greedy learning misses.
    State is one-hot over {start, state2A, state2B}."""

    agent_ids = ["agent_0", "agent_1"]
    observation_dim = 3
    num_actions = 2
    PAYOFF_2A = np.array([[7.0, 7.0], [7.0, 7.0]])
    PAYOFF_2B = np.array([[0.0, 1.0], [1.0, 8.0]])

    def __init__(self, seed: int = 0):
        self._state = 0

    def _obs(self):
        o = np.zeros(3, np.float32)
        o[self._state] = 1.0
        return {a: o.copy() for a in self.agent_ids}

    def reset(self):
        self._state = 0
        return self._obs()

    def step(self, actions: Dict[str, int]):
        if self._state == 0:
            self._state = 1 if actions["agent_0"] == 0 else 2
            return self._obs(), {a: 0.0 for a in self.agent_ids}, \
                {"__all__": False}, {}
        payoff = self.PAYOFF_2A if self._state == 1 else self.PAYOFF_2B
        r = float(payoff[actions["agent_0"], actions["agent_1"]])
        self._state = 0
        return self._obs(), {a: r for a in self.agent_ids}, \
            {"__all__": True}, {}


# ------------------------------------------------------------------- QMIX


class QMixConfig:
    def __init__(self):
        self.env_maker: Callable[[int], MultiAgentEnv] = TwoStepCooperativeEnv
        self.obs_dim = TwoStepCooperativeEnv.observation_dim
        self.state_dim = TwoStepCooperativeEnv.observation_dim
        self.num_actions = TwoStepCooperativeEnv.num_actions
        self.n_agents = 2
        self.hidden = 32
        self.mix_hidden = 16
        self.lr = 5e-3
        self.gamma = 0.99
        self.buffer_capacity = 5000
        self.train_batch_size = 32
        self.episodes_per_iter = 16
        self.epsilon_start = 1.0
        self.epsilon_end = 0.05
        self.epsilon_decay_iters = 30
        self.target_update_interval = 5
        self.max_episode_steps = 10
        self.seed = 0
        self.device = "cuda"         # params and Adam state; "cpu" for the CPU

    def training(self, **kw):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown QMIX option {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "QMix":
        return QMix({"qmix_config": self})


def agent_q(p, obs_aug):
    """The shared per-agent Q net: [..., obs + A] -> [..., num_actions]."""
    return mlp_forward(p["q"], obs_aug, 2)


def qmix_mix(p, qs, state, mix_hidden: int):
    """qs [B, A] -> Q_tot [B] with monotone (|w|) mixing."""
    import torch

    B, A = qs.shape
    w1 = torch.abs(state @ p["hw1"] + p["hb1"]).reshape(B, A, mix_hidden)
    b1 = state @ p["vb1"]
    hidden = torch.einsum("ba,bam->bm", qs, w1) + b1
    hidden = torch.nn.functional.elu(hidden)
    w2 = torch.abs(state @ p["hw2"] + p["hb2"])
    v = (state @ p["vb2"])[:, 0]
    return (hidden * w2).sum(-1) + v


def qmix_loss(p, tp, batch, cfg):
    """batch tensors: obs [B,A,obs+A], actions [B,A], state [B,S], next_*
    likewise, reward [B], done [B]; `tp` the target params."""
    import torch

    qs = agent_q(p, batch["obs"])                   # [B,A,num_actions]
    q_taken = torch.gather(
        qs, -1, batch["actions"][..., None].long())[..., 0]   # [B,A]
    q_tot = qmix_mix(p, q_taken, batch["state"], cfg.mix_hidden)
    next_qs = agent_q(tp, batch["next_obs"])
    next_max = next_qs.amax(-1)                     # [B,A]
    next_tot = qmix_mix(tp, next_max, batch["next_state"], cfg.mix_hidden)
    target = batch["reward"] + cfg.gamma * (1 - batch["done"]) * \
        next_tot.detach()
    return torch.mean((q_tot - target) ** 2)


class QMix(Algorithm):
    """Single-process QMIX (the reference runs it as a Trainable too);
    episode collection is in-process because the envs are toy-scale — the
    rollout-actor pattern of DQN/Ape-X applies unchanged if scaled up."""

    def setup(self, config: Dict[str, Any]) -> None:
        from ray_tpu_torch.rllib import optim
        from ray_tpu_torch.rllib.learner import _resolve_device, _to_tensors

        cfg: QMixConfig = config.get("qmix_config") or QMixConfig()
        self.cfg = cfg
        self.device = _resolve_device(cfg.device, None)
        self.env = cfg.env_maker(cfg.seed)
        rng = np.random.default_rng(cfg.seed)
        self._np_rng = rng

        def glorot(rng, m, n):
            return (rng.standard_normal((m, n)) *
                    np.sqrt(2.0 / (m + n))).astype(np.float32)

        h, mh = cfg.hidden, cfg.mix_hidden
        A = cfg.n_agents
        # shared per-agent Q net (agent id one-hot appended to obs): the
        # catalog MLP, same as DQN/PPO/ES (models.init_mlp)
        self.params = {
            "q": init_mlp(rng, (cfg.obs_dim + A, h, cfg.num_actions)),
            # hypernetwork: state -> non-negative mixing weights
            "hw1": glorot(rng, cfg.state_dim, A * mh),
            "hb1": np.zeros(A * mh, np.float32),
            "hw2": glorot(rng, cfg.state_dim, mh),
            "hb2": np.zeros(mh, np.float32),
            "vb1": glorot(rng, cfg.state_dim, mh),  # state-dep biases
            "vb2": glorot(rng, cfg.state_dim, 1),
        }
        self.params = _to_tensors(self.params, self.device)
        self.target = clone_tree(self.params)
        self.optimizer = optim.adam(cfg.lr)
        self.opt_state = self.optimizer.init(self.params)
        self.buffer = ReplayBuffer(cfg.buffer_capacity, seed=cfg.seed)
        self._reward_hist: List[float] = []

    def _update(self, batch) -> float:
        """One Adam step on `batch` (host arrays); returns the loss."""
        import torch

        from ray_tpu_torch.rllib import optim
        from ray_tpu_torch.rllib.learner import _to_tensors

        leaves = optim.tree_map(lambda p: p.detach().requires_grad_(True),
                                self.params)
        loss = qmix_loss(leaves, self.target,
                         _to_tensors(batch, self.device), self.cfg)
        flat = [p for _, p in optim.tree_items(leaves)]
        grads = torch.autograd.grad(loss, flat)
        paths = [p for p, _ in optim.tree_items(leaves)]
        grads = optim.tree_from_items(dict(zip(paths, grads)))
        with torch.no_grad():
            updates, self.opt_state = self.optimizer.update(
                grads, self.opt_state, self.params)
            self.params = optim.apply_updates(self.params, updates)
        return float(loss.detach())

    # ----------------------------------------------------------- rollouts
    def _augment(self, obs: Dict[str, np.ndarray]) -> np.ndarray:
        """[A, obs_dim + A]: per-agent obs with agent-id one-hot."""
        A = self.cfg.n_agents
        out = np.zeros((A, self.cfg.obs_dim + A), np.float32)
        for i, a in enumerate(self.env.agent_ids):
            out[i, :self.cfg.obs_dim] = obs[a]
            out[i, self.cfg.obs_dim + i] = 1.0
        return out

    def _act(self, obs_aug: np.ndarray, epsilon: float) -> Dict[str, int]:
        import torch

        with torch.no_grad():
            qs = agent_q(self.params, torch.from_numpy(obs_aug).to(
                self.device)).cpu().numpy()
        acts = {}
        for i, a in enumerate(self.env.agent_ids):
            # no rng draw at epsilon<=0 so greedy eval leaves the training
            # sampling stream untouched
            if epsilon > 0 and self._np_rng.random() < epsilon:
                acts[a] = int(self._np_rng.integers(self.cfg.num_actions))
            else:
                acts[a] = int(qs[i].argmax())
        return acts

    def _epsilon(self) -> float:
        cfg = self.cfg
        frac = min(1.0, self.iteration / max(1, cfg.epsilon_decay_iters))
        return cfg.epsilon_start + frac * (cfg.epsilon_end - cfg.epsilon_start)

    def _collect_episode(self, epsilon: float, store: bool = True) -> float:
        env, cfg = self.env, self.cfg
        obs = env.reset()
        total = 0.0
        rows: List[dict] = []
        for _ in range(cfg.max_episode_steps):
            state = obs[env.agent_ids[0]]  # toy envs: state == shared obs
            obs_aug = self._augment(obs)
            acts = self._act(obs_aug, epsilon)
            next_obs, rewards, dones, _ = env.step(acts)
            done = bool(dones.get("__all__"))
            r = float(sum(rewards.values()) / len(rewards))
            if store:
                rows.append({
                    "obs": obs_aug,
                    "actions": np.array([acts[a] for a in env.agent_ids],
                                        np.int32),
                    "state": state.astype(np.float32),
                    "reward": np.float32(r),
                    "next_obs": self._augment(next_obs),
                    "next_state": next_obs[env.agent_ids[0]].astype(np.float32),
                    "done": np.float32(done),
                })
            total += r
            obs = next_obs
            if done:
                break
        if rows:
            self.buffer.add_batch(
                {k: np.stack([row[k] for row in rows]) for k in rows[0]})
        return total

    # --------------------------------------------------------------- train
    def training_step(self) -> Dict[str, Any]:
        cfg = self.cfg
        eps = self._epsilon()
        returns = [self._collect_episode(eps)
                   for _ in range(cfg.episodes_per_iter)]
        self._reward_hist.extend(returns)
        self._reward_hist = self._reward_hist[-200:]

        losses = []
        if len(self.buffer) >= cfg.train_batch_size:
            for _ in range(4):
                batch = self.buffer.sample(cfg.train_batch_size)
                losses.append(self._update(batch))
            if self.iteration % cfg.target_update_interval == 0:
                self.target = clone_tree(self.params)
        return {
            "episode_reward_mean": float(np.mean(self._reward_hist)),
            "epsilon": eps,
            "loss": float(np.mean(losses)) if losses else float("nan"),
        }

    def greedy_joint_return(self, episodes: int = 10) -> float:
        """Eval-only rollouts: nothing is stored, no rng consumed."""
        return float(np.mean([self._collect_episode(0.0, store=False)
                              for _ in range(episodes)]))

    def get_weights(self):
        from ray_tpu_torch.rllib.learner import _to_host

        return _to_host(self.params)

    def set_weights(self, weights) -> None:
        from ray_tpu_torch.rllib.learner import _to_tensors

        self.params = _to_tensors(weights, self.device)
        self.target = clone_tree(self.params)


# ------------------------------------------------- policy-mapped rollouts


def policy_mapping_rollout(env: MultiAgentEnv,
                           policies: Dict[str, Callable[[np.ndarray], int]],
                           policy_mapping_fn: Callable[[str], str],
                           max_steps: int = 100
                           ) -> Tuple[Dict[str, float], List[dict]]:
    """Run one episode routing each agent through its mapped policy
    (reference policy_mapping_fn contract). Returns (per-agent returns,
    per-step transition dicts keyed by agent)."""
    obs = env.reset()
    totals = {a: 0.0 for a in env.agent_ids}
    trajectory: List[dict] = []
    for _ in range(max_steps):
        acts = {a: policies[policy_mapping_fn(a)](obs[a])
                for a in env.agent_ids}
        next_obs, rewards, dones, _ = env.step(acts)
        trajectory.append({"obs": obs, "actions": acts, "rewards": rewards})
        for a, r in rewards.items():
            totals[a] += r
        obs = next_obs
        if dones.get("__all__"):
            break
    return totals, trajectory
