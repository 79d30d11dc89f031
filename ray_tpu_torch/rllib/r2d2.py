"""R2D2: recurrent replay distributed DQN (Kapturowski et al. 2019).

Mirrors the reference's R2D2 (`rllib/algorithms/r2d2/`): an LSTM-style
recurrent Q network trained on stored *sequences* with burn-in — the first
`burn_in` steps of each sampled sequence only rebuild the recurrent state
(no gradient), the remainder takes double-DQN TD updates.

The network is a `RecurrentQModule` (GRU with explicit state in/out) and
BOTH paths ride it: acting steps `forward_inference(params, obs, state)`
through the EpsilonGreedy connector pipeline, training unrolls the same
cell (a loop over time in torch) inside an `R2D2Learner` on the Learner
stack — the recurrent proof that the module/connector contract is not
MLP-only. The port of ray_tpu/rllib/r2d2.py: the learner is on the
config's device (the card by default; `.training(device=)`), its target
net a copy there; acting steps a host copy of the params.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.learner import Learner, clone_tree


class MemoryCorridorEnv:
    """Cue at t=0 (one of two), corridor of `length` blank steps, then a
    binary choice; reward +1 for matching the cue, -1 otherwise."""

    def __init__(self, seed: int = 0, length: int = 4):
        self.length = length
        self.observation_dim = 3  # [cue_a, cue_b, blank]
        self.num_actions = 2
        self._rng = np.random.default_rng(seed)
        self._t = 0
        self._cue = 0

    def reset(self) -> np.ndarray:
        self._t = 0
        self._cue = int(self._rng.integers(2))
        obs = np.zeros(3, np.float32)
        obs[self._cue] = 1.0
        return obs

    def step(self, action: int):
        self._t += 1
        obs = np.zeros(3, np.float32)
        obs[2] = 1.0
        if self._t <= self.length:
            return obs, 0.0, False, {}
        r = 1.0 if action == self._cue else -1.0
        return obs, r, True, {}


class R2D2Learner(Learner):
    """Burn-in double-DQN sequence loss over `RecurrentQModule.unroll`
    (reference r2d2_torch_policy.py `r2d2_loss`): the first `burn_in`
    steps rebuild hidden state without gradient, then one EXTENDED unroll
    [obs[bi:], final next_obs] yields both taken-action and next-state Q
    values with non-stale hidden state. The target net rides as the
    Learner's `extra` tree, a copy of the online params taken at each sync
    (the reference aliases them, safe only with JAX's immutable arrays)."""

    def __init__(self, module, lr: float, gamma: float, burn_in: int,
                 seed: int = 0, mesh=None, device="cuda"):
        self.module = module
        self._gamma = gamma
        self._burn_in = burn_in
        super().__init__(lr=lr, mesh=mesh, seed=seed, device=device)

    def init_params(self, seed: int):
        return self.module.init_params(seed)

    def make_extra(self):
        return clone_tree(self.params)

    def loss(self, params, batch, extra, rng):
        import torch

        m, bi, tp = self.module, self._burn_in, extra
        B = batch["obs"].shape[0]
        h0 = torch.zeros((B, m.hidden), device=batch["obs"].device)
        # burn-in: rebuild recurrent state without gradients
        with torch.no_grad():
            _, h_start = m.unroll(params, batch["obs"][:, :bi], h0)
            _, ht_start = m.unroll(tp, batch["obs"][:, :bi], h0)
        # one extended pass: [obs[bi:], final next_obs]. Since
        # next_obs[t] == obs[t+1], q_ext[:, 1:] are the next-state values
        # evaluated with the CORRECT (non-stale) hidden state.
        ext = torch.cat(
            [batch["obs"][:, bi:], batch["next_obs"][:, -1:]], dim=1)
        q_ext, _ = m.unroll(params, ext, h_start)       # [B, T'+1, A]
        q_taken = torch.gather(
            q_ext[:, :-1], -1,
            batch["actions"][:, bi:, None].long())[..., 0]
        # double DQN: online picks the argmax, target evaluates
        a_star = torch.argmax(q_ext[:, 1:], dim=-1)
        q_ext_t, _ = m.unroll(tp, ext, ht_start)
        next_q = torch.gather(q_ext_t[:, 1:], -1, a_star[..., None])[..., 0]
        target = batch["rewards"][:, bi:] + self._gamma * \
            (1 - batch["dones"][:, bi:]) * next_q.detach()
        mask = batch["mask"][:, bi:]
        td = (q_taken - target) * mask
        loss = (td ** 2).sum() / torch.clamp(mask.sum(), min=1.0)
        return loss, {}

    def sync_target(self) -> None:
        self.extra = self.make_extra()

    def set_weights(self, weights):
        super().set_weights(weights)
        self.extra = self.make_extra()


class R2D2Config:
    def __init__(self):
        self.env_maker: Callable[[int], Any] = MemoryCorridorEnv
        self.obs_dim = 3
        self.num_actions = 2
        self.hidden = 32
        self.lr = 2e-3
        self.gamma = 0.997
        self.seq_len = 8            # stored sequence length
        self.burn_in = 2            # steps that only rebuild hidden state
        self.buffer_capacity = 2000  # sequences
        self.train_batch_size = 32
        self.episodes_per_iter = 16
        self.updates_per_iter = 4
        self.epsilon_start = 1.0
        self.epsilon_end = 0.05
        self.epsilon_decay_iters = 40
        self.target_update_interval = 5
        self.max_episode_steps = 16
        self.seed = 0
        self.device = "cuda"         # the learner's; "cpu" for the CPU

    def training(self, **kw):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown R2D2 option {k!r}")
            setattr(self, k, v)
        return self

    def build(self) -> "R2D2":
        if not 0 <= self.burn_in < self.seq_len:
            raise ValueError(
                f"burn_in ({self.burn_in}) must be in [0, seq_len"
                f"={self.seq_len})")
        return R2D2({"r2d2_config": self})


class R2D2(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        from ray_tpu_torch.rllib.connectors import (CastObsFloat32,
                                              ConnectorPipeline,
                                              EpsilonGreedy)
        from ray_tpu_torch.rllib.rl_module import RecurrentQModule

        cfg: R2D2Config = config.get("r2d2_config") or R2D2Config()
        self.cfg = cfg
        self.env = cfg.env_maker(cfg.seed)
        self._np_rng = np.random.default_rng(cfg.seed)
        self.module = RecurrentQModule(cfg.obs_dim, cfg.num_actions,
                                       cfg.hidden)
        self.learner = R2D2Learner(self.module, cfg.lr, cfg.gamma,
                                   cfg.burn_in, cfg.seed, device=cfg.device)
        self.env_to_module = ConnectorPipeline([CastObsFloat32()])
        self.module_to_env = ConnectorPipeline(
            [EpsilonGreedy(cfg.num_actions)])
        # host-side numpy copy of the params for env-stepping
        self._acting_params = self.learner.get_weights()
        # sequence-major replay: each row is one [seq_len] slice
        self._sequences: List[dict] = []
        self._reward_hist: List[float] = []

    # ----------------------------------------------------------- rollouts
    def _epsilon(self) -> float:
        cfg = self.cfg
        frac = min(1.0, self.iteration / max(1, cfg.epsilon_decay_iters))
        return cfg.epsilon_start + frac * (cfg.epsilon_end - cfg.epsilon_start)

    def _collect_episode(self, epsilon: float, store: bool = True) -> float:
        cfg = self.cfg
        env = self.env
        obs = env.reset()
        state = self.module.get_initial_state(1)
        rows = {k: [] for k in ("obs", "actions", "rewards", "next_obs",
                                "dones")}
        total = 0.0
        for _ in range(cfg.max_episode_steps):
            data = {"obs": np.asarray(obs, np.float32)[None],
                    "rng": self._np_rng, "module": self.module,
                    "params": self._acting_params,
                    "epsilon_override": epsilon}
            data = self.env_to_module(data)
            fwd = self.module.forward_inference(
                self._acting_params, data["obs"], state=state)
            data["fwd_out"] = fwd
            data = self.module_to_env(data)
            a = int(data["actions"][0])
            state = np.asarray(fwd["state_out"])
            nxt, r, done, _ = env.step(a)
            rows["obs"].append(obs)
            rows["actions"].append(a)
            rows["rewards"].append(r)
            rows["next_obs"].append(nxt)
            rows["dones"].append(float(done))
            total += r
            obs = nxt
            if done:
                break
        if store:
            self._store_episode(rows)
        return total

    def _store_episode(self, rows: Dict[str, list]) -> None:
        """Chop the episode into fixed seq_len windows (zero-padded, with a
        validity mask) — R2D2's stored-sequence format."""
        cfg = self.cfg
        T = len(rows["actions"])
        for start in range(0, T, cfg.seq_len - cfg.burn_in or 1):
            end = min(start + cfg.seq_len, T)
            n = end - start
            seq = {
                "obs": np.zeros((cfg.seq_len, cfg.obs_dim), np.float32),
                "next_obs": np.zeros((cfg.seq_len, cfg.obs_dim), np.float32),
                "actions": np.zeros(cfg.seq_len, np.int32),
                "rewards": np.zeros(cfg.seq_len, np.float32),
                "dones": np.ones(cfg.seq_len, np.float32),
                "mask": np.zeros(cfg.seq_len, np.float32),
            }
            seq["obs"][:n] = rows["obs"][start:end]
            seq["next_obs"][:n] = rows["next_obs"][start:end]
            seq["actions"][:n] = rows["actions"][start:end]
            seq["rewards"][:n] = rows["rewards"][start:end]
            seq["dones"][:n] = rows["dones"][start:end]
            seq["mask"][:n] = 1.0
            self._sequences.append(seq)
            if start == 0 and end == T:
                break
        if len(self._sequences) > cfg.buffer_capacity:
            self._sequences = self._sequences[-cfg.buffer_capacity:]

    # --------------------------------------------------------------- train
    def training_step(self) -> Dict[str, Any]:
        cfg = self.cfg
        eps = self._epsilon()
        returns = [self._collect_episode(eps)
                   for _ in range(cfg.episodes_per_iter)]
        self._reward_hist.extend(returns)
        self._reward_hist = self._reward_hist[-200:]

        losses = []
        if len(self._sequences) >= cfg.train_batch_size:
            for _ in range(cfg.updates_per_iter):
                idx = self._np_rng.integers(0, len(self._sequences),
                                            cfg.train_batch_size)
                rows = [self._sequences[i] for i in idx]
                batch = {k: np.stack([r[k] for r in rows])
                         for k in rows[0]}
                aux = self.learner.update(batch)
                losses.append(float(aux["total_loss"]))
            if self.iteration % cfg.target_update_interval == 0:
                self.learner.sync_target()
            self._acting_params = self.learner.get_weights()
        return {
            "episode_reward_mean": float(np.mean(self._reward_hist)),
            "epsilon": eps,
            "loss": float(np.mean(losses)) if losses else float("nan"),
            "num_sequences": len(self._sequences),
        }

    def greedy_return(self, episodes: int = 20) -> float:
        return float(np.mean([self._collect_episode(0.0, store=False)
                              for _ in range(episodes)]))

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, weights) -> None:
        self.learner.set_weights(weights)
        self._acting_params = self.learner.get_weights()
