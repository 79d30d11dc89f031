"""Offline RL: BC, MARWIL, and discrete CQL over logged transitions.

Mirrors the reference's offline stack (`rllib/offline/`,
`rllib/algorithms/{bc,marwil,cql}/`): algorithms that learn from a fixed
dataset of logged episodes instead of live rollouts.

- BC: behavior cloning — maximize log pi(a_logged | s).
- MARWIL: advantage-weighted BC (exponentially weighted by a monte-carlo
  advantage against a learned value baseline), beta=0 reduces to BC —
  same derivation as the reference's `marwil.py`.
- CQL (discrete): double-DQN TD loss + conservative penalty
  E[logsumexp Q(s,.) - Q(s, a_logged)] (Kumar et al. 2020), the
  reference's `cql.py` adapted to the discrete Q-learner.

Datasets are columnar dicts (obs/actions/rewards/dones [+ next_obs]) —
what `collect_episodes` below records from any policy, and what
`ray_tpu_torch.data.Datastream.from_items` rows convert to via `from_rows`.

The port of ray_tpu/rllib/offline.py: the learners are eager torch updates
on their device (the card by default; `.training(device=)`), their target
networks copies there; the data layer rides the port's `data`.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.env import CartPoleEnv
from ray_tpu_torch.rllib.models import init_mlp, mlp_forward
from ray_tpu_torch.rllib.learner import Learner, clone_tree


# ------------------------------------------------------------- data layer


def collect_episodes(env_maker: Callable[[int], Any], policy_fn,
                     num_episodes: int, seed: int = 0,
                     max_steps: int = 500) -> Dict[str, np.ndarray]:
    """Roll a behavior policy to build an offline dataset.

    policy_fn(obs[np], rng) -> action. Returns columnar transitions with
    monte-carlo returns precomputed per episode (for MARWIL).
    """
    rng = np.random.default_rng(seed)
    cols: Dict[str, List] = {k: [] for k in
                             ("obs", "actions", "rewards", "next_obs",
                              "dones", "mc_returns")}
    for ep in range(num_episodes):
        env = env_maker(seed + ep)
        obs = env.reset()
        ep_obs, ep_act, ep_rew, ep_next, ep_done = [], [], [], [], []
        for _ in range(max_steps):
            a = policy_fn(obs, rng)
            nxt, r, done, _ = env.step(a)
            ep_obs.append(obs)
            ep_act.append(a)
            ep_rew.append(r)
            ep_next.append(nxt)
            ep_done.append(float(done))
            obs = nxt
            if done:
                break
        # per-episode discount-free MC return-to-go (gamma applied by algos
        # that want it; MARWIL in the reference uses gamma inside GAE — we
        # precompute undiscounted-to-go then let the algo rescale)
        ret = np.cumsum(np.asarray(ep_rew, np.float32)[::-1])[::-1]
        cols["obs"].extend(ep_obs)
        cols["actions"].extend(ep_act)
        cols["rewards"].extend(ep_rew)
        cols["next_obs"].extend(ep_next)
        cols["dones"].extend(ep_done)
        cols["mc_returns"].extend(ret.tolist())
    return {
        "obs": np.asarray(cols["obs"], np.float32),
        "actions": np.asarray(cols["actions"], np.int32),
        "rewards": np.asarray(cols["rewards"], np.float32),
        "next_obs": np.asarray(cols["next_obs"], np.float32),
        "dones": np.asarray(cols["dones"], np.float32),
        "mc_returns": np.asarray(cols["mc_returns"], np.float32),
    }


def from_rows(rows: List[Dict[str, Any]]) -> Dict[str, np.ndarray]:
    """Columnarize a list of transition dicts (e.g. Datastream rows)."""
    keys = rows[0].keys()
    return {k: np.asarray([r[k] for r in rows]) for k in keys}


def write_experiences(dataset: Dict[str, np.ndarray], path: str, *,
                      num_shards: int = 4) -> List[str]:
    """Persist logged transitions as sharded parquet THROUGH the Data
    plane (reference rllib/offline/json_writer.py role, riding
    `Datastream.write_parquet` instead of a bespoke writer). Tensor
    columns ([N, obs_dim] observations) round-trip via the parquet
    writer's FixedSizeList encoding."""
    from ray_tpu_torch import data as rdata

    return rdata.from_numpy(dataset,
                            parallelism=num_shards).write_parquet(path)


def read_experiences(path) -> Dict[str, np.ndarray]:
    """Load an experience dataset from parquet shards through
    `ray_tpu_torch.data.read_parquet` (reference rllib/offline/dataset_reader.py):
    shards load in parallel as Data tasks, then concatenate columnwise."""
    import glob
    import os

    from ray_tpu_torch import data as rdata

    if isinstance(path, str) and os.path.isdir(path):
        paths = sorted(glob.glob(os.path.join(path, "*.parquet")))
    else:
        paths = path
    ds = rdata.read_parquet(paths)
    batches = list(ds.iter_batches(batch_size=1 << 30))
    return {k: np.concatenate([b[k] for b in batches]) for k in batches[0]}


# ------------------------------------------------------------- algorithms


def discounted_returns_to_go(rewards: np.ndarray, dones: np.ndarray,
                             gamma: float) -> np.ndarray:
    """Per-episode discounted return-to-go over flat transition columns;
    episode boundaries come from the dones flags."""
    out = np.zeros_like(rewards, dtype=np.float32)
    acc = 0.0
    for t in reversed(range(len(rewards))):
        if dones[t]:
            acc = 0.0
        acc = rewards[t] + gamma * acc
        out[t] = acc
    return out


class MARWILLearner(Learner):
    """Advantage-weighted BC on the Learner stack (reference marwil.py via
    core/learner); beta=0 reduces to plain BC. The policy is a swappable
    RLModule."""

    def __init__(self, obs_dim: int, num_actions: int, lr: float,
                 beta: float, vf_coeff: float, seed: int = 0, mesh=None,
                 module=None, device="cuda"):
        from ray_tpu_torch.rllib.rl_module import DiscreteActorCriticModule

        self.module = module or DiscreteActorCriticModule(obs_dim, num_actions)
        self._beta = beta
        self._vf_coeff = vf_coeff
        super().__init__(lr=lr, mesh=mesh, seed=seed, device=device)

    def init_params(self, seed: int):
        return self.module.init_params(seed)

    def loss(self, params, batch, extra, rng):
        import torch

        out = self.module.forward_train(params, batch)
        dist = self.module.action_dist(out)
        logp = dist.logp(batch["actions"])
        value = out["vf"]
        adv = batch["mc_returns"] - value.detach()
        # normalize advantage scale (moving-average-free variant of the
        # reference's `update_averaged_advantage_norm`)
        adv_norm = adv / (torch.sqrt(torch.mean(adv ** 2)) + 1e-8)
        if self._beta > 0.0:
            weight = torch.exp(self._beta * torch.clip(adv_norm, -10, 10))
        else:
            weight = torch.ones_like(adv_norm)
        bc = -(weight.detach() * logp).mean()
        vf = ((value - batch["mc_returns"]) ** 2).mean()
        total = bc + self._vf_coeff * vf
        return total, {"bc_loss": bc, "vf_loss": vf}


class CQLLearner(Learner):
    """Discrete conservative Q-learning on the Learner stack: double-DQN TD
    target + alpha * (logsumexp_a Q - Q(s, a_logged)); the target net rides
    `extra` like DQN's."""

    def __init__(self, obs_dim: int, num_actions: int, lr: float,
                 gamma: float, cql_alpha: float, seed: int = 0, mesh=None,
                 module=None, device="cuda"):
        from ray_tpu_torch.rllib.rl_module import QModule

        self.module = module or QModule(obs_dim, num_actions)
        self._gamma = gamma
        self._alpha = cql_alpha
        super().__init__(lr=lr, mesh=mesh, seed=seed, device=device)

    def init_params(self, seed: int):
        return self.module.init_params(seed)

    def make_extra(self):
        return clone_tree(self.params)

    def sync_target(self) -> None:
        self.extra = self.make_extra()

    def set_weights(self, weights):
        super().set_weights(weights)
        self.sync_target()  # a restored net must not TD against a stale target

    def loss(self, params, batch, extra, rng):
        import torch

        out = self.module.forward_train(params, batch)
        q, next_online = out["q"], out["q_next"]
        acts = batch["actions"][:, None].long()
        q_taken = torch.gather(q, -1, acts)[:, 0]
        next_a = torch.argmax(next_online, dim=-1)
        next_target = self.module.forward_train(extra, batch)["q_next"]
        next_q = torch.gather(next_target, -1, next_a[:, None])[:, 0]
        backup = (batch["rewards"] + self._gamma * (1 - batch["dones"])
                  * next_q).detach()
        td = ((q_taken - backup) ** 2).mean()
        conservative = (torch.logsumexp(q, dim=-1) - q_taken).mean()
        total = td + self._alpha * conservative
        return total, {"td_loss": td, "cql_penalty": conservative}


class CRRLearner(Learner):
    """Critic-Regularized Regression on the Learner stack: expected-SARSA
    critic + advantage-weighted BC policy in one combined loss; target Q in
    `extra` with periodic hard sync."""

    def __init__(self, obs_dim: int, num_actions: int, lr: float,
                 gamma: float, beta: float, weight_type: str,
                 seed: int = 0, mesh=None, device="cuda"):
        self._obs_dim = obs_dim
        self._num_actions = num_actions
        self._gamma = gamma
        self._beta = beta
        self._wtype = weight_type
        super().__init__(lr=lr, mesh=mesh, seed=seed, device=device)

    def init_params(self, seed: int):
        rng = np.random.default_rng(seed)
        hidden = (64, 64)
        return {
            "pi": init_mlp(rng, (self._obs_dim, *hidden, self._num_actions),
                           final_scale=0.01),
            "q": init_mlp(rng, (self._obs_dim, *hidden, self._num_actions),
                          final_scale=np.sqrt(2.0 / hidden[-1])),
        }

    def make_extra(self):
        return clone_tree(self.params["q"])

    def sync_target(self) -> None:
        self.extra = self.make_extra()

    def set_weights(self, weights):
        super().set_weights(weights)
        self.sync_target()  # a restored net must not TD against a stale target

    def loss(self, params, batch, extra, rng):
        import torch

        target_q = extra
        acts = batch["actions"][:, None].long()
        q = mlp_forward(params["q"], batch["obs"], 3)
        q_taken = torch.gather(q, -1, acts)[:, 0]
        # expected-SARSA backup under the current policy
        next_logits = mlp_forward(params["pi"], batch["next_obs"], 3)
        next_pi = torch.softmax(next_logits.detach(), dim=-1)
        next_q = mlp_forward(target_q, batch["next_obs"], 3)
        backup = (batch["rewards"] + self._gamma * (1 - batch["dones"])
                  * (next_pi * next_q).sum(-1)).detach()
        td = ((q_taken - backup) ** 2).mean()

        logits = mlp_forward(params["pi"], batch["obs"], 3)
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = torch.gather(logp_all, -1, acts)[:, 0]
        pi = torch.softmax(logits.detach(), dim=-1)
        adv = (q_taken - (pi * q.detach()).sum(-1)).detach()
        weight = ((adv > 0).to(adv.dtype) if self._wtype == "binary"
                  else torch.clamp(torch.exp(adv / self._beta), max=20.0))
        bc = -(weight * logp).mean()
        total = td + bc
        return total, {"td_loss": td, "crr_bc_loss": bc,
                       "mean_weight": weight.mean()}


def _resolve_offline_input(dataset, input_path):
    """Config-side input resolution: a columnar dict passes through, a
    Datastream materializes columnwise, a path reads parquet shards
    through the Data plane (reference AlgorithmConfig.offline_data
    `input_` handling, rllib/offline/dataset_reader.py)."""
    if input_path is not None:
        return read_experiences(input_path)
    if hasattr(dataset, "iter_batches"):
        batches = list(dataset.iter_batches(batch_size=1 << 30))
        return {k: np.concatenate([b[k] for b in batches])
                for k in batches[0]}
    return dataset


class _OfflineBase(Algorithm):
    """Shared setup: dataset + minibatch iterator."""

    _cfg_key = "offline_config"

    def setup(self, config: Dict[str, Any]) -> None:
        cfg = config.get(self._cfg_key) or self._default_config()
        self.cfg = cfg
        self.dataset: Dict[str, np.ndarray] = config["dataset"] \
            if "dataset" in config else cfg.dataset
        assert self.dataset is not None, "offline algorithms need a dataset"
        # Recompute return-to-go with THIS algorithm's gamma (the dataset's
        # precomputed column is undiscounted; reference MARWIL discounts).
        gamma = getattr(cfg, "gamma", 1.0)
        if gamma < 1.0 and "rewards" in self.dataset and "dones" in self.dataset:
            self.dataset = dict(self.dataset)
            self.dataset["mc_returns"] = discounted_returns_to_go(
                self.dataset["rewards"], self.dataset["dones"], gamma)
        self._rng = np.random.default_rng(cfg.seed)
        self._build_learner()

    def _minibatches(self):
        n = len(self.dataset["obs"])
        idx = self._rng.permutation(n)
        bs = self.cfg.train_batch_size
        for start in range(0, n, bs):
            sel = idx[start:start + bs]
            yield {k: v[sel] for k, v in self.dataset.items()}

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, weights) -> None:
        self.learner.set_weights(weights)


class BCConfig:
    def __init__(self):
        self.obs_dim = CartPoleEnv.observation_dim
        self.num_actions = CartPoleEnv.num_actions
        self.lr = 1e-3
        self.train_batch_size = 256
        self.dataset: Optional[Dict[str, np.ndarray]] = None
        self.seed = 0
        self.device = "cuda"         # the learner's; "cpu" for the CPU
        # MARWIL knobs (BC is beta=0)
        self.beta = 0.0
        self.vf_coeff = 1.0
        self.gamma = 0.99

    def offline_data(self, dataset=None, *, input_path=None) -> "BCConfig":
        self.dataset = _resolve_offline_input(dataset, input_path)
        return self

    def training(self, **kw):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown option {k!r}")
            setattr(self, k, v)
        return self

    def build(self):
        return BC({"offline_config": self})


class MARWILConfig(BCConfig):
    def __init__(self):
        super().__init__()
        self.beta = 1.0

    def build(self):
        return MARWIL({"offline_config": self})


class MARWIL(_OfflineBase):
    """Advantage-weighted BC: loss = -exp(beta * A_norm) * log pi(a|s) +
    vf_coeff * (V - R_mc)^2. beta=0 → plain BC."""

    @staticmethod
    def _default_config():
        return MARWILConfig()

    def _build_learner(self) -> None:
        cfg = self.cfg
        self.learner = MARWILLearner(
            cfg.obs_dim, cfg.num_actions, cfg.lr, cfg.beta, cfg.vf_coeff,
            seed=cfg.seed, device=cfg.device)

    def training_step(self) -> Dict[str, Any]:
        aux = {}
        n = 0
        for mb in self._minibatches():
            aux = self.learner.update(mb)
            n += len(mb["obs"])
        out = {k: float(v) for k, v in aux.items()}
        out["num_samples_trained"] = n
        return out

    def compute_actions(self, obs: np.ndarray) -> np.ndarray:
        """Greedy policy eval for offline-trained policies."""
        fwd = self.learner.module.forward_inference(
            self.learner.get_weights(), np.asarray(obs, np.float32))
        return self.learner.module.action_dist(fwd).argmax()


class BC(MARWIL):
    """Behavior cloning = MARWIL with beta=0
    (reference rllib/algorithms/bc/bc.py)."""

    @staticmethod
    def _default_config():
        return BCConfig()


class CQLConfig:
    def __init__(self):
        self.obs_dim = CartPoleEnv.observation_dim
        self.num_actions = CartPoleEnv.num_actions
        self.lr = 1e-3
        self.gamma = 0.99
        self.cql_alpha = 1.0
        self.target_update_freq = 8
        self.train_batch_size = 256
        self.dataset: Optional[Dict[str, np.ndarray]] = None
        self.seed = 0
        self.device = "cuda"         # the learner's; "cpu" for the CPU

    def offline_data(self, dataset=None, *, input_path=None) -> "CQLConfig":
        self.dataset = _resolve_offline_input(dataset, input_path)
        return self

    def training(self, **kw):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown option {k!r}")
            setattr(self, k, v)
        return self

    def build(self):
        return CQL({"offline_config": self})


class CQL(_OfflineBase):
    """Discrete conservative Q-learning: double-DQN TD target + alpha *
    (logsumexp_a Q(s,a) - Q(s, a_logged))."""

    @staticmethod
    def _default_config():
        return CQLConfig()

    def _build_learner(self) -> None:
        cfg = self.cfg
        self.learner = CQLLearner(cfg.obs_dim, cfg.num_actions, cfg.lr,
                                  cfg.gamma, cfg.cql_alpha, seed=cfg.seed,
                                  device=cfg.device)
        self._step_count = 0

    def training_step(self) -> Dict[str, Any]:
        aux = {}
        n = 0
        for mb in self._minibatches():
            aux = self.learner.update(mb)
            self._step_count += 1
            if self._step_count % self.cfg.target_update_freq == 0:
                self.learner.sync_target()
            n += len(mb["obs"])
        out = {k: float(v) for k, v in aux.items()}
        out["num_samples_trained"] = n
        return out

    def compute_actions(self, obs: np.ndarray) -> np.ndarray:
        fwd = self.learner.module.forward_inference(
            self.learner.get_weights(), np.asarray(obs, np.float32))
        return self.learner.module.action_dist(fwd).argmax()


class CRRConfig:
    def __init__(self):
        self.obs_dim = CartPoleEnv.observation_dim
        self.num_actions = CartPoleEnv.num_actions
        self.lr = 1e-3
        self.gamma = 0.99
        self.weight_type = "exp"  # "exp" | "binary" (paper's f variants)
        self.beta = 1.0           # exp weight temperature
        self.target_update_freq = 8
        self.train_batch_size = 256
        self.dataset: Optional[Dict[str, np.ndarray]] = None
        self.seed = 0
        self.device = "cuda"         # the learner's; "cpu" for the CPU

    def offline_data(self, dataset=None, *, input_path=None) -> "CRRConfig":
        self.dataset = _resolve_offline_input(dataset, input_path)
        return self

    def training(self, **kw):
        for k, v in kw.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown option {k!r}")
            setattr(self, k, v)
        return self

    def build(self):
        return CRR({"offline_config": self})


class CRR(_OfflineBase):
    """Critic-Regularized Regression (Wang et al. 2020; reference
    rllib/algorithms/crr): a Q critic trained by expected-SARSA TD under the
    learned policy, and a policy trained by advantage-weighted BC with
    weight f(A) = exp(A/beta) or 1[A>0], where
    A(s,a) = Q(s,a) - E_{a'~pi}Q(s,a')."""

    @staticmethod
    def _default_config():
        return CRRConfig()

    def _build_learner(self) -> None:
        cfg = self.cfg
        self.learner = CRRLearner(cfg.obs_dim, cfg.num_actions, cfg.lr,
                                  cfg.gamma, cfg.beta, cfg.weight_type,
                                  seed=cfg.seed, device=cfg.device)
        self._step_count = 0

    def training_step(self) -> Dict[str, Any]:
        aux = {}
        n = 0
        for mb in self._minibatches():
            aux = self.learner.update(mb)
            self._step_count += 1
            if self._step_count % self.cfg.target_update_freq == 0:
                self.learner.sync_target()
            n += len(mb["obs"])
        out = {k: float(v) for k, v in aux.items()}
        out["num_samples_trained"] = n
        return out

    def compute_actions(self, obs: np.ndarray) -> np.ndarray:
        p = self.learner.get_weights()["pi"]
        return np.asarray(mlp_forward(p, np.asarray(obs, np.float32),
                                      3)).argmax(-1)
