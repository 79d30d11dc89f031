"""DT: Decision Transformer — offline RL as return-conditioned sequence
modeling (Chen et al. 2021).

Reference parity: rllib/algorithms/dt/ (SURVEY §2.3's algorithm list). The
port of ray_tpu/rllib/dt.py: the model is a small causal transformer
written in plain torch ops (the reference's is `jnp` ops, its attention a
`jnp.tril`-masked softmax, no Pallas kernel) — interleaved
(return-to-go, state, action) tokens, action predicted from each state
token's output — its params and AdamW state on the config's device (the
card by default; `.training(device=)`), updated eagerly. Training samples
fixed-K windows from logged episodes on the host; evaluation rolls the
policy autoregressively conditioned on a target return.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.env import CartPoleEnv


# ------------------------------------------------------------------ model


def _init_dt_params(seed: int, obs_dim: int, num_actions: int, d: int,
                    n_layers: int, max_ep_len: int) -> Dict[str, Any]:
    rng = np.random.default_rng(seed)

    def dense(shape, scale=0.02):
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    p: Dict[str, Any] = {
        "rtg_w": dense((1, d)), "rtg_b": np.zeros(d, np.float32),
        "obs_w": dense((obs_dim, d)), "obs_b": np.zeros(d, np.float32),
        "act_emb": dense((num_actions + 1, d)),  # last row: "no action" pad
        "time_emb": dense((max_ep_len + 1, d)),
        "head_w": dense((d, num_actions)),
        "head_b": np.zeros(num_actions, np.float32),
        "lnf_s": np.ones(d, np.float32), "lnf_b": np.zeros(d, np.float32),
    }
    for i in range(n_layers):
        p[f"l{i}"] = {
            "ln1_s": np.ones(d, np.float32), "ln1_b": np.zeros(d, np.float32),
            "qkv_w": dense((d, 3 * d)), "qkv_b": np.zeros(3 * d, np.float32),
            "proj_w": dense((d, d)), "proj_b": np.zeros(d, np.float32),
            "ln2_s": np.ones(d, np.float32), "ln2_b": np.zeros(d, np.float32),
            "fc1_w": dense((d, 4 * d)), "fc1_b": np.zeros(4 * d, np.float32),
            "fc2_w": dense((4 * d, d)), "fc2_b": np.zeros(d, np.float32),
        }
    return p


def _dt_forward(params, rtg, obs, actions, timesteps, pad_mask,
                n_layers: int, n_heads: int):
    """rtg [B,K,1], obs [B,K,D], actions [B,K] (num_actions = pad),
    timesteps [B,K], pad_mask [B,K] (1=real), torch tensors on the params'
    device. Returns action logits [B,K,A] predicted at each state token."""
    import torch
    import torch.nn.functional as F

    def ln(x, s, b):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * s + b

    B, K = actions.shape
    d = params["obs_w"].shape[1]
    te = params["time_emb"][timesteps.long()]  # [B,K,d]
    tok_r = rtg @ params["rtg_w"] + params["rtg_b"] + te
    tok_s = obs @ params["obs_w"] + params["obs_b"] + te
    tok_a = params["act_emb"][actions.long()] + te
    # interleave -> [B, 3K, d] in order (R_t, s_t, a_t)
    x = torch.stack([tok_r, tok_s, tok_a], dim=2).reshape(B, 3 * K, d)

    T = 3 * K
    causal = torch.tril(torch.ones((T, T), dtype=torch.bool,
                                   device=x.device))
    keep = torch.repeat_interleave(pad_mask, 3, dim=1).bool()  # [B,T]
    mask = causal[None] & keep[:, None, :]  # [B,T,T]

    hd = d // n_heads
    for i in range(n_layers):
        lp = params[f"l{i}"]
        h = ln(x, lp["ln1_s"], lp["ln1_b"])
        qkv = h @ lp["qkv_w"] + lp["qkv_b"]
        q, k, v = torch.split(qkv, d, dim=-1)
        q = q.reshape(B, T, n_heads, hd).permute(0, 2, 1, 3)
        k = k.reshape(B, T, n_heads, hd).permute(0, 2, 1, 3)
        v = v.reshape(B, T, n_heads, hd).permute(0, 2, 1, 3)
        att = (q @ k.permute(0, 1, 3, 2)) / np.float32(np.sqrt(hd))
        att = torch.where(mask[:, None], att, torch.full_like(att, -1e9))
        att = torch.softmax(att, dim=-1)
        out = (att @ v).permute(0, 2, 1, 3).reshape(B, T, d)
        x = x + out @ lp["proj_w"] + lp["proj_b"]
        h = ln(x, lp["ln2_s"], lp["ln2_b"])
        # jax.nn.gelu's default: the tanh approximation
        h = F.gelu(h @ lp["fc1_w"] + lp["fc1_b"], approximate="tanh")
        x = x + h @ lp["fc2_w"] + lp["fc2_b"]

    x = ln(x, params["lnf_s"], params["lnf_b"])
    state_out = x.reshape(B, K, 3, d)[:, :, 1]  # output above each s_t
    return state_out @ params["head_w"] + params["head_b"]


# ----------------------------------------------------------------- dataset


def _split_episodes(dataset: Dict[str, np.ndarray]) -> List[Dict[str, np.ndarray]]:
    """Columnar transitions (offline.collect_episodes format) -> episode
    list with per-step return-to-go."""
    n = len(dataset["dones"])
    bounds = (np.flatnonzero(dataset["dones"] > 0.5) + 1).tolist()
    if not bounds or bounds[-1] != n:  # trailing truncated episode
        bounds.append(n)
    episodes, start = [], 0
    for end in bounds:
        sl = slice(start, end)
        rew = dataset["rewards"][sl]
        episodes.append({
            "obs": dataset["obs"][sl],
            "actions": dataset["actions"][sl],
            "rtg": np.cumsum(rew[::-1])[::-1].astype(np.float32),
        })
        start = end
    return episodes


# --------------------------------------------------------------- algorithm


class DTConfig:
    def __init__(self):
        self.obs_dim = CartPoleEnv.observation_dim
        self.num_actions = CartPoleEnv.num_actions
        self.context_len = 20
        self.embed_dim = 64
        self.n_layers = 2
        self.n_heads = 2
        self.max_ep_len = 500
        self.return_scale = 100.0
        self.lr = 1e-3
        self.batch_size = 64
        self.updates_per_iter = 50
        self.target_return = 150.0
        self.seed = 0
        self.dataset: Optional[Dict[str, np.ndarray]] = None
        self.device = "cuda"         # params and AdamW state; "cpu" for the CPU

    def environment(self, *, obs_dim=None, num_actions=None) -> "DTConfig":
        if obs_dim is not None:
            self.obs_dim = obs_dim
        if num_actions is not None:
            self.num_actions = num_actions
        return self

    def offline_data(self, dataset: Dict[str, np.ndarray]) -> "DTConfig":
        self.dataset = dataset
        return self

    def training(self, *, lr=None, batch_size=None, context_len=None,
                 updates_per_iter=None, embed_dim=None, n_layers=None,
                 target_return=None, return_scale=None,
                 seed=None, device=None) -> "DTConfig":
        for k, v in [("lr", lr), ("batch_size", batch_size),
                     ("context_len", context_len),
                     ("updates_per_iter", updates_per_iter),
                     ("embed_dim", embed_dim), ("n_layers", n_layers),
                     ("target_return", target_return),
                     ("return_scale", return_scale), ("seed", seed),
                     ("device", device)]:
            if v is not None:
                setattr(self, k, v)
        return self

    def build(self) -> "DT":
        return DT({"dt_config": self})


def dt_loss(params, batch, n_layers: int, n_heads: int):
    """Masked mean NLL of the logged actions under the model."""
    import torch

    logits = _dt_forward(
        params, batch["rtg"], batch["obs"], batch["actions_in"],
        batch["timesteps"], batch["mask"], n_layers, n_heads)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, batch["actions"][..., None].long())[..., 0]
    m = batch["mask"]
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)


class DT(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        from ray_tpu_torch.rllib import optim
        from ray_tpu_torch.rllib.learner import _resolve_device, _to_tensors

        cfg: DTConfig = config.get("dt_config") or DTConfig()
        if cfg.dataset is None:
            raise ValueError("DTConfig.offline_data(dataset) is required")
        self.cfg = cfg
        self.device = _resolve_device(cfg.device, None)
        self.episodes = _split_episodes(cfg.dataset)
        self._ep_lens = np.array([len(e["actions"]) for e in self.episodes])
        self.params = _to_tensors(_init_dt_params(
            cfg.seed, cfg.obs_dim, cfg.num_actions, cfg.embed_dim,
            cfg.n_layers, cfg.max_ep_len), self.device)
        self.optimizer = optim.adamw(cfg.lr, weight_decay=1e-4)
        self.opt_state = self.optimizer.init(self.params)
        self.rng = np.random.default_rng(cfg.seed)

    def _update(self, batch) -> float:
        """One AdamW step on `batch` (host arrays); returns the loss."""
        import torch

        from ray_tpu_torch.rllib import optim
        from ray_tpu_torch.rllib.learner import _to_tensors

        leaves = optim.tree_map(lambda p: p.detach().requires_grad_(True),
                                self.params)
        loss = dt_loss(leaves, _to_tensors(batch, self.device),
                       self.cfg.n_layers, self.cfg.n_heads)
        flat = [p for _, p in optim.tree_items(leaves)]
        grads = torch.autograd.grad(loss, flat)
        paths = [p for p, _ in optim.tree_items(leaves)]
        grads = optim.tree_from_items(dict(zip(paths, grads)))
        with torch.no_grad():
            updates, self.opt_state = self.optimizer.update(
                grads, self.opt_state, self.params)
            self.params = optim.apply_updates(self.params, updates)
        return float(loss.detach())

    def _forward(self, *arrays):
        """Logits of host inputs (rtg, obs, actions, timesteps, mask)."""
        import torch

        from ray_tpu_torch.rllib.learner import _to_tensors

        with torch.no_grad():
            args = [_to_tensors(a, self.device) for a in arrays]
            return _dt_forward(self.params, *args, self.cfg.n_layers,
                               self.cfg.n_heads).cpu().numpy()

    def _sample_batch(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        B, K, D = cfg.batch_size, cfg.context_len, cfg.obs_dim
        probs = self._ep_lens / self._ep_lens.sum()
        batch = {
            "rtg": np.zeros((B, K, 1), np.float32),
            "obs": np.zeros((B, K, D), np.float32),
            "actions": np.zeros((B, K), np.int32),
            "actions_in": np.full((B, K), cfg.num_actions, np.int32),
            "timesteps": np.zeros((B, K), np.int32),
            "mask": np.zeros((B, K), np.float32),
        }
        for b in range(B):
            ep = self.episodes[self.rng.choice(len(self.episodes), p=probs)]
            L = len(ep["actions"])
            end = self.rng.integers(1, L + 1)  # exclusive
            start = max(0, end - K)
            n = end - start
            batch["rtg"][b, K - n:, 0] = ep["rtg"][start:end] / cfg.return_scale
            batch["obs"][b, K - n:] = ep["obs"][start:end]
            batch["actions"][b, K - n:] = ep["actions"][start:end]
            batch["actions_in"][b, K - n:] = ep["actions"][start:end]
            batch["timesteps"][b, K - n:] = np.arange(start, end).clip(
                0, cfg.max_ep_len)
            batch["mask"][b, K - n:] = 1.0
        return batch

    def training_step(self) -> Dict[str, Any]:
        losses = []
        for _ in range(self.cfg.updates_per_iter):
            batch = self._sample_batch()
            losses.append(self._update(batch))
        return {"loss": float(np.mean(losses)),
                "num_updates": self.iteration * self.cfg.updates_per_iter}

    # ------------------------------------------------------------- rollout
    def compute_action(self, history: Dict[str, List], obs: np.ndarray,
                       rtg: float) -> int:
        """Greedy action from the trailing context window."""
        cfg = self.cfg
        K = cfg.context_len
        hist_obs = (history["obs"] + [obs])[-K:]
        hist_rtg = (history["rtg"] + [rtg])[-K:]
        hist_act = history["actions"][-(K - 1):] if K > 1 else []
        n = len(hist_obs)
        rtg_in = np.zeros((1, K, 1), np.float32)
        obs_in = np.zeros((1, K, cfg.obs_dim), np.float32)
        act_in = np.full((1, K), cfg.num_actions, np.int32)
        ts = np.zeros((1, K), np.int32)
        mask = np.zeros((1, K), np.float32)
        rtg_in[0, K - n:, 0] = np.asarray(hist_rtg) / cfg.return_scale
        obs_in[0, K - n:] = np.asarray(hist_obs)
        if hist_act:
            act_in[0, K - len(hist_act) - 1:K - 1] = hist_act
        t0 = len(history["obs"]) - n + 1
        ts[0, K - n:] = (np.arange(t0, t0 + n)).clip(0, cfg.max_ep_len)
        mask[0, K - n:] = 1.0
        logits = self._forward(rtg_in, obs_in, act_in, ts, mask)
        return int(np.argmax(np.asarray(logits)[0, -1]))

    def evaluate(self, env_maker: Callable[[int], Any],
                 num_episodes: int = 5,
                 target_return: Optional[float] = None,
                 max_steps: int = 500, seed: int = 10_000) -> float:
        """Mean achieved return rolling out conditioned on target_return."""
        target = (target_return if target_return is not None
                  else self.cfg.target_return)
        totals = []
        for ep in range(num_episodes):
            env = env_maker(seed + ep)
            obs = env.reset()
            history = {"obs": [], "rtg": [], "actions": []}
            rtg, total = float(target), 0.0
            for _ in range(max_steps):
                a = self.compute_action(history, np.asarray(obs), rtg)
                history["obs"].append(np.asarray(obs))
                history["rtg"].append(rtg)
                history["actions"].append(a)
                obs, r, done, _ = env.step(a)
                total += r
                rtg = max(rtg - r, 1.0)
                if done:
                    break
            totals.append(total)
        return float(np.mean(totals))

    def get_weights(self):
        from ray_tpu_torch.rllib.learner import _to_host

        return _to_host(self.params)

    def set_weights(self, weights) -> None:
        from ray_tpu_torch.rllib.learner import _to_tensors

        self.params = _to_tensors(weights, self.device)
        self.opt_state = self.optimizer.init(self.params)
