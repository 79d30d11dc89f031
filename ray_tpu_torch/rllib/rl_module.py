"""RLModule: the swappable params + forward-functions unit of RLlib.

Mirrors the reference's `rllib/core/rl_module/rl_module.py`: an algorithm's
neural network is a MODULE — parameter initialization, the train/inference
forward passes, and the action distribution — separable from the update rule
(Learner) and from env plumbing (connectors). Swapping the architecture
means swapping the module; the learner's loss and the rollout loop don't
change.

Modules are PURE-FUNCTION bundles over dicts of arrays (init -> numpy
params; forwards are `f(params, obs)` usable on torch tensors under
autograd AND under plain numpy for CPU env-stepping actors), not stateful
nn.Module objects, as in the reference (ray_tpu/rllib/rl_module.py). Each
function that computes takes an explicit numpy path for numpy inputs and a
torch path otherwise (the reference's `_xp` duck typing, `:34-42`, does
not carry over: torch's reductions name `keepdim` and `max` returns a
pair).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np

from ray_tpu_torch.rllib.models import init_mlp, mlp_forward, mlp_hidden

__all__ = [
    "Categorical", "SquashedGaussian", "Deterministic", "RLModule",
    "DiscreteActorCriticModule", "QModule", "SquashedGaussianModule",
    "DeterministicPolicyModule", "RecurrentQModule",
]


# ------------------------------------------------------------ distributions


def _is_np(arr) -> bool:
    """True for numpy inputs (CPU rollout actors), False for torch tensors
    (learner losses) — modules and distributions run in BOTH worlds."""
    return isinstance(arr, np.ndarray)


def _host(arr) -> np.ndarray:
    """A numpy view of `arr` (a torch tensor copied to the host)."""
    if _is_np(arr):
        return arr
    import torch

    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


class Categorical:
    """Action distribution over logits (reference TorchCategorical,
    rllib/models/distributions.py) — numpy-or-torch depending on input."""

    def __init__(self, logits):
        self.logits = logits

    def _log_probs(self):
        if _is_np(self.logits):
            z = self.logits - self.logits.max(-1, keepdims=True)
            return z - np.log(np.exp(z).sum(-1, keepdims=True))
        import torch

        z = self.logits - self.logits.amax(-1, keepdim=True)
        return z - torch.log(torch.exp(z).sum(-1, keepdim=True))

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        """Host-side sampling for rollout actors (gumbel trick: one vector
        op per step instead of a per-env np.choice loop)."""
        logp = _host(self._log_probs())
        g = rng.gumbel(size=logp.shape)
        return (logp + g).argmax(-1).astype(np.int32)

    def logp(self, actions):
        logp_all = self._log_probs()
        if _is_np(logp_all):
            return np.take_along_axis(
                logp_all, np.asarray(actions)[..., None], axis=-1)[..., 0]
        import torch

        idx = torch.as_tensor(actions, device=logp_all.device).long()
        return torch.gather(logp_all, -1, idx[..., None])[..., 0]

    def entropy(self):
        logp_all = self._log_probs()
        if _is_np(logp_all):
            return -(np.exp(logp_all) * logp_all).sum(-1)
        import torch

        return -(torch.exp(logp_all) * logp_all).sum(-1)

    def argmax(self) -> np.ndarray:
        return _host(self.logits).argmax(-1).astype(np.int32)


class SquashedGaussian:
    """tanh-squashed diagonal Gaussian over `concat([mean, log_std])`
    inputs, scaled to [-max_action, max_action] (SAC's acting policy;
    reference rllib/models/tf/tf_distributions.py TfSquashedGaussian).
    The learner's reparameterized path keeps its own sampler (it
    needs the pre-squash value for the exact log-prob); this distribution
    serves the HOST-SIDE acting path."""

    LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0

    def __init__(self, inputs, max_action: float = 1.0):
        inputs = np.asarray(inputs)
        d = inputs.shape[-1] // 2
        self.mean = inputs[..., :d]
        self.log_std = np.clip(inputs[..., d:],
                               self.LOG_STD_MIN, self.LOG_STD_MAX)
        self.max_action = max_action

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        pre = self.mean + np.exp(self.log_std) \
            * rng.standard_normal(self.mean.shape)
        return (np.tanh(pre) * self.max_action).astype(np.float32)

    def argmax(self) -> np.ndarray:
        """Mode: the squashed mean (evaluation-time deterministic act)."""
        return (np.tanh(self.mean) * self.max_action).astype(np.float32)

    def logp(self, actions) -> np.ndarray:
        """Change-of-variables log-prob; recovers the pre-squash value by
        atanh (clipped away from the +-1 boundary)."""
        a = np.clip(np.asarray(actions) / self.max_action,
                    -1.0 + 1e-6, 1.0 - 1e-6)
        pre = np.arctanh(a)
        std = np.exp(self.log_std)
        z = (pre - self.mean) / std
        logp = (-0.5 * (z ** 2 + 2 * self.log_std + np.log(2 * np.pi))).sum(-1)
        # d tanh(x)/dx = 1 - tanh(x)^2; stable softplus form
        logp -= (2 * (np.log(2.0) - pre
                      - np.logaddexp(0.0, -2.0 * pre))).sum(-1)
        return logp.astype(np.float32)

    def entropy(self) -> np.ndarray:
        """Pre-squash Gaussian entropy (the squash correction has no closed
        form; this is the standard surrogate)."""
        return (self.log_std + 0.5 * np.log(2 * np.pi * np.e)).sum(-1)


class Deterministic:
    """Point-mass distribution: DDPG/TD3 actors emit the action directly;
    exploration noise is a CONNECTOR, not part of the distribution
    (reference rllib/models/distributions.py Deterministic)."""

    def __init__(self, actions):
        self.actions = actions

    def sample(self, rng: np.random.Generator) -> np.ndarray:
        return np.asarray(self.actions, np.float32)

    def argmax(self) -> np.ndarray:
        return np.asarray(self.actions, np.float32)

    def logp(self, actions) -> np.ndarray:
        return np.zeros(np.asarray(actions).shape[:-1], np.float32)

    def entropy(self) -> np.ndarray:
        return np.zeros(np.asarray(self.actions).shape[:-1], np.float32)


# ----------------------------------------------------------------- modules


class RLModule:
    """Base module contract (reference rl_module.py: `_forward_inference`,
    `_forward_train`, `get_initial_state`)."""

    def init_params(self, seed: int):
        raise NotImplementedError

    def forward_inference(self, params, obs) -> Dict[str, Any]:
        """Outputs needed to ACT (runs in rollout workers; must accept
        numpy params + obs and stay numpy)."""
        raise NotImplementedError

    def forward_train(self, params, batch) -> Dict[str, Any]:
        """Outputs needed by the learner's loss (torch, under autograd)."""
        raise NotImplementedError

    def action_dist(self, fwd_out: Dict[str, Any]):
        """Distribution over actions from forward outputs."""
        raise NotImplementedError


class DiscreteActorCriticModule(RLModule):
    """Two-head MLP: categorical policy + value baseline — the module under
    PPO / A2C / APPO / IMPALA / MARWIL (reference PPOTorchRLModule)."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hidden: Tuple[int, ...] = (64, 64)):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hidden = tuple(hidden)

    def init_params(self, seed: int) -> Dict[str, Any]:
        rng = np.random.default_rng(seed)
        params = init_mlp(rng, (self.obs_dim, *self.hidden))
        h = self.hidden[-1]
        params["w_pi"] = (rng.standard_normal((h, self.num_actions))
                          * 0.01).astype(np.float32)
        params["b_pi"] = np.zeros(self.num_actions, np.float32)
        params["w_v"] = rng.standard_normal((h, 1)).astype(np.float32)
        params["b_v"] = np.zeros(1, np.float32)
        return params

    def _apply(self, params, obs):
        x = mlp_hidden(params, obs, len(self.hidden))
        logits = x @ params["w_pi"] + params["b_pi"]
        value = (x @ params["w_v"] + params["b_v"])[..., 0]
        return logits, value

    def forward_inference(self, params, obs) -> Dict[str, Any]:
        logits, value = self._apply(params, obs)
        return {"action_dist_inputs": logits, "vf": value}

    def forward_train(self, params, batch) -> Dict[str, Any]:
        logits, value = self._apply(params, batch["obs"])
        return {"action_dist_inputs": logits, "vf": value}

    def action_dist(self, fwd_out) -> Categorical:
        return Categorical(fwd_out["action_dist_inputs"])


class QModule(RLModule):
    """Q-value MLP — the module under DQN / CQL (greedy/eps-greedy action
    selection lives in connectors, not here)."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hidden: Tuple[int, ...] = (64, 64)):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hidden = tuple(hidden)

    def init_params(self, seed: int) -> Dict[str, Any]:
        rng = np.random.default_rng(seed)
        return init_mlp(rng, (self.obs_dim, *self.hidden, self.num_actions),
                        final_scale=np.sqrt(2.0 / self.hidden[-1]))

    def _apply(self, params, obs):
        # depth inferred from params (w0/b0 ... pairs), so a learner with a
        # different hidden stack than the module default still applies fully
        return mlp_forward(params, obs, len(params) // 2)

    def forward_inference(self, params, obs) -> Dict[str, Any]:
        return {"action_dist_inputs": self._apply(params, obs)}

    def forward_train(self, params, batch) -> Dict[str, Any]:
        return {"q": self._apply(params, batch["obs"]),
                "q_next": self._apply(params, batch["next_obs"])}

    def action_dist(self, fwd_out) -> Categorical:
        return Categorical(fwd_out["action_dist_inputs"])


class SquashedGaussianModule(RLModule):
    """Continuous stochastic actor: MLP -> concat(mean, log_std), squashed
    tanh-Gaussian — SAC's acting module (reference SACTorchRLModule). The
    SAC learner keeps its own reparameterized sampler over the SAME
    params; this module is the worker-side acting contract."""

    def __init__(self, obs_dim: int, action_dim: int, max_action: float,
                 hidden: Tuple[int, ...] = (256, 256)):
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.max_action = max_action
        self.hidden = tuple(hidden)

    def init_params(self, seed: int) -> Dict[str, Any]:
        rng = np.random.default_rng(seed)
        return init_mlp(rng, (self.obs_dim, *self.hidden, 2 * self.action_dim),
                        final_scale=0.01)

    def forward_inference(self, params, obs) -> Dict[str, Any]:
        # depth from params, matching sac.actor_dist's len(params)//2 rule
        out = mlp_forward(params, obs, len(params) // 2)
        return {"action_dist_inputs": out}

    def forward_train(self, params, batch) -> Dict[str, Any]:
        return self.forward_inference(params, batch["obs"])

    def action_dist(self, fwd_out) -> SquashedGaussian:
        return SquashedGaussian(fwd_out["action_dist_inputs"],
                                self.max_action)


class DeterministicPolicyModule(RLModule):
    """Deterministic continuous actor: tanh(MLP) * max_action — the module
    under DDPG/TD3 (reference DDPGTorchModel); exploration noise is the
    GaussianNoise connector, not baked into the network."""

    def __init__(self, obs_dim: int, action_dim: int, max_action: float,
                 hidden: Tuple[int, ...] = (256, 256)):
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.max_action = max_action
        self.hidden = tuple(hidden)

    def init_params(self, seed: int) -> Dict[str, Any]:
        rng = np.random.default_rng(seed)
        return init_mlp(rng, (self.obs_dim, *self.hidden, self.action_dim),
                        final_scale=0.01)

    def forward_inference(self, params, obs) -> Dict[str, Any]:
        out = mlp_forward(params, obs, len(params) // 2)
        if _is_np(out):
            return {"action_dist_inputs": np.tanh(out) * self.max_action}
        import torch

        return {"action_dist_inputs": torch.tanh(out) * self.max_action}

    def forward_train(self, params, batch) -> Dict[str, Any]:
        return self.forward_inference(params, batch["obs"])

    def action_dist(self, fwd_out) -> Deterministic:
        return Deterministic(fwd_out["action_dist_inputs"])


class RecurrentQModule(RLModule):
    """GRU Q-network with EXPLICIT state in/out — the recurrent module
    R2D2 acts and trains through (reference rllib/algorithms/r2d2/
    r2d2_torch_policy.py; get_initial_state per rl_module.py). A GRU over
    LSTM: one gate fewer, same episodic memory, and all gates are two fused
    matmuls — friendlier to the MXU.

    Acting calls `forward_inference(params, obs, state=h)` one step at a
    time (numpy on env hosts); training calls `unroll` over [B, T]
    sequences (a loop over time in torch, the reference's lax.scan). Both
    run the SAME cell math."""

    def __init__(self, obs_dim: int, num_actions: int, hidden: int = 32):
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.hidden = hidden

    def init_params(self, seed: int) -> Dict[str, Any]:
        rng = np.random.default_rng(seed)
        d, h, A = self.obs_dim, self.hidden, self.num_actions

        def glorot(m, n):
            return (rng.standard_normal((m, n))
                    * np.sqrt(2.0 / (m + n))).astype(np.float32)

        return {
            "wxz": glorot(d, h), "whz": glorot(h, h),
            "bz": np.zeros(h, np.float32),
            "wxr": glorot(d, h), "whr": glorot(h, h),
            "br": np.zeros(h, np.float32),
            "wxn": glorot(d, h), "whn": glorot(h, h),
            "bn": np.zeros(h, np.float32),
            "wq": glorot(h, A), "bq": np.zeros(A, np.float32),
        }

    def get_initial_state(self, batch_size: int = 1) -> np.ndarray:
        return np.zeros((batch_size, self.hidden), np.float32)

    def _cell(self, params, h, x):
        """One GRU step — numpy or torch by input type."""
        if _is_np(x):
            exp, tanh = np.exp, np.tanh
        else:
            import torch

            exp, tanh = torch.exp, torch.tanh

        def sigmoid(v):
            return 1.0 / (1.0 + exp(-v))

        z = sigmoid(x @ params["wxz"] + h @ params["whz"] + params["bz"])
        r = sigmoid(x @ params["wxr"] + h @ params["whr"] + params["br"])
        n = tanh(x @ params["wxn"] + (r * h) @ params["whn"]
                 + params["bn"])
        return (1 - z) * n + z * h

    def forward_inference(self, params, obs, state=None) -> Dict[str, Any]:
        if state is None:
            state = self.get_initial_state(len(obs))
        h = self._cell(params, state, obs)
        return {"action_dist_inputs": h @ params["wq"] + params["bq"],
                "state_out": h}

    def unroll(self, params, obs_seq, h0):
        """obs_seq [B, T, d], h0 [B, h] -> (q [B, T, A], h_T). torch only
        (training path): the reference's `lax.scan` (`:368`) as a loop
        over time, the same cell each tick."""
        import torch

        hc, hs = h0, []
        for t in range(obs_seq.shape[1]):
            hc = self._cell(params, hc, obs_seq[:, t])
            hs.append(hc)
        if not hs:   # T = 0 (R2D2 without burn-in): no tick, h0 back
            return h0.new_zeros((h0.shape[0], 0, params["wq"].shape[1])), hc
        hs = torch.stack(hs, dim=1)                  # [B, T, h]
        return hs @ params["wq"] + params["bq"], hc

    def forward_train(self, params, batch) -> Dict[str, Any]:
        import torch

        h0 = batch.get("state_in")
        if h0 is None:
            obs = batch["obs"]
            h0 = torch.zeros((obs.shape[0], self.hidden), dtype=obs.dtype,
                             device=obs.device)
        q, hT = self.unroll(params, batch["obs"], h0)
        return {"action_dist_inputs": q, "state_out": hT}

    def action_dist(self, fwd_out) -> Categorical:
        return Categorical(fwd_out["action_dist_inputs"])
