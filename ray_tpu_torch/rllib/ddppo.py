"""DD-PPO: decentralized distributed PPO.

Reference parity: rllib/algorithms/ddppo/ddppo.py:90,182,261-281 — rollout
workers do their own SGD and synchronize by allreducing *gradients* among
themselves (torch.distributed gloo/nccl there), so no train batch and no
weights ever travel through the driver.

The port of ray_tpu/rllib/ddppo.py: each worker pairs a vector env (numpy
acting from a host copy of its params) with a local eager torch learner
on its `device`; gradient sync rides `ray_tpu_torch.util.collective`
(host backend — rendezvous actor), one flat float32 vector a minibatch
in the params' fixed leaf order. Identical seeds make the initial params
equal, and because every worker applies the same averaged gradient with
the same optimizer, params stay bit-identical without any broadcast — the
invariant the reference relies on too.

The ranks' learners run on the card by default (`DDPPOConfig.device`),
each rank granted `num_gpus=1/num_workers`: no NCCL group is formed, since
the gradient crosses the host anyway, so the ranks share one card as well
as they spread over several.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.env import CartPoleEnv, VectorEnv
from ray_tpu_torch.rllib.ppo import (
    compute_gae,
    init_policy_params,
    policy_apply,
)
from ray_tpu_torch.rllib.learner import (_on_card, _resolve_device,
                                         _to_host, _to_tensors)
from ray_tpu_torch.util import collective


@ray_tpu_torch.remote
class _DDPPOWorker:
    """Sampler + local learner, one per rank."""

    def __init__(self, rank: int, world_size: int, group_name: str,
                 env_maker, num_envs: int, seed: int,
                 obs_dim: int, num_actions: int, lr: float, clip: float,
                 vf_coeff: float, entropy_coeff: float, device="cpu"):
        from ray_tpu_torch.rllib import optim

        self.rank = rank
        self.world = world_size
        self.group = group_name
        self.vec = VectorEnv(env_maker, num_envs, seed + 1000 * (rank + 1))
        self.obs = self.vec.reset()
        self.obs_dim = obs_dim
        self.num_actions = num_actions
        self.device = _resolve_device(device, None)
        # identical across ranks: same init seed
        self.params = _to_tensors(
            init_policy_params(seed, obs_dim, num_actions), self.device)
        self._acting = _to_host(self.params)
        self.optimizer = optim.adam(lr)
        self.opt_state = self.optimizer.init(self.params)
        self.rng = np.random.default_rng(seed + 77 * (rank + 1))
        self._ep_returns = np.zeros(num_envs, np.float32)
        self._completed: List[float] = []
        self._clip, self._vf_coeff = clip, vf_coeff
        self._entropy_coeff = entropy_coeff

    def _loss(self, params, batch):
        import torch

        clip = self._clip
        logits, value = policy_apply(params, batch["obs"])
        logp_all = torch.log_softmax(logits, dim=-1)
        logp = torch.gather(logp_all, -1,
                            batch["actions"][:, None].long())[:, 0]
        ratio = torch.exp(logp - batch["logp"])
        adv = batch["advantages"]
        pg = -torch.minimum(
            ratio * adv,
            torch.clip(ratio, 1 - clip, 1 + clip) * adv).mean()
        vf = 0.5 * ((value - batch["returns"]) ** 2).mean()
        entropy = -(torch.exp(logp_all) * logp_all).sum(-1).mean()
        total = pg + self._vf_coeff * vf - self._entropy_coeff * entropy
        return total, {"policy_loss": pg, "vf_loss": vf,
                       "entropy": entropy}

    def _grads(self, mb):
        """(loss, aux, grads as host arrays in the params' leaf order)."""
        import torch

        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in self.params.items()}
        loss, aux = self._loss(leaves, _to_tensors(mb, self.device))
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return loss, aux, [g.detach().cpu().numpy() for g in grads]

    def _apply(self, grads) -> None:
        import torch

        from ray_tpu_torch.rllib import optim

        with torch.no_grad():
            updates, self.opt_state = self.optimizer.update(
                grads, self.opt_state, self.params)
            self.params = optim.apply_updates(self.params, updates)
        self._acting = _to_host(self.params)

    def init_collective(self) -> bool:
        collective.init_collective_group(
            self.world, self.rank, backend="host", group_name=self.group)
        return True

    def _sample(self, num_steps: int) -> Dict[str, np.ndarray]:
        T, N = num_steps, self.vec.num_envs
        bufs = {k: np.zeros((T, N), np.float32)
                for k in ("logp", "values", "rewards", "dones")}
        obs_buf = np.zeros((T, N, self.obs_dim), np.float32)
        act_buf = np.zeros((T, N), np.int32)
        for t in range(T):
            logits, value = policy_apply(self._acting, self.obs)
            logits, value = np.asarray(logits), np.asarray(value)
            z = logits - logits.max(-1, keepdims=True)
            probs = np.exp(z) / np.exp(z).sum(-1, keepdims=True)
            actions = np.array(
                [self.rng.choice(self.num_actions, p=p) for p in probs])
            obs_buf[t] = self.obs
            act_buf[t] = actions
            bufs["logp"][t] = np.log(probs[np.arange(N), actions] + 1e-10)
            bufs["values"][t] = value
            self.obs, rewards, dones, _ = self.vec.step(actions)
            bufs["rewards"][t] = rewards
            bufs["dones"][t] = dones
            self._ep_returns += rewards
            for i, d in enumerate(dones):
                if d:
                    self._completed.append(float(self._ep_returns[i]))
                    self._ep_returns[i] = 0.0
        _, last_value = policy_apply(self._acting, self.obs)
        return {"obs": obs_buf, "actions": act_buf, **bufs,
                "last_value": np.asarray(last_value)}

    def train_step(self, num_steps: int, gamma: float, lam: float,
                   num_sgd_iter: int, minibatch_size: int) -> Dict[str, Any]:
        batch = self._sample(num_steps)
        adv, ret = compute_gae(batch, gamma, lam)
        T, N = batch["actions"].shape
        flat = {
            "obs": batch["obs"].reshape(T * N, -1),
            "actions": batch["actions"].reshape(-1).astype(np.int32),
            "logp": batch["logp"].reshape(-1),
            "advantages": adv.reshape(-1),
            "returns": ret.reshape(-1),
        }
        a = flat["advantages"]
        flat["advantages"] = (a - a.mean()) / (a.std() + 1e-8)

        n = len(flat["obs"])
        stats: Dict[str, Any] = {}
        for _ in range(num_sgd_iter):
            # same permutation seed schedule across ranks is NOT required:
            # each rank trains on its own local minibatches, only the
            # gradient is shared
            idx = self.rng.permutation(n)
            for start in range(0, n, minibatch_size):
                mb = {k: v[idx[start:start + minibatch_size]]
                      for k, v in flat.items()}
                loss, aux, leaves = self._grads(mb)
                # decentralized sync point (reference ddppo.py:261-281):
                # one fused allreduce over the flattened gradient vector,
                # its leaves in the params' order (the same on every rank)
                sizes = np.cumsum([g.size for g in leaves])[:-1]
                flat_g = np.concatenate([g.ravel() for g in leaves])
                summed = collective.allreduce(flat_g, group_name=self.group)
                parts = np.split(summed / self.world, sizes)
                mean_grads = _to_tensors(
                    {k: p.reshape(g.shape).astype(g.dtype)
                     for k, p, g in zip(self.params, parts, leaves)},
                    self.device)
                self._apply(mean_grads)
                stats = {k: float(v.detach()) for k, v in aux.items()}
                stats["total_loss"] = float(loss.detach())
        completed, self._completed = self._completed, []
        return {"episode_returns": completed,
                "num_env_steps": T * N, **stats}

    def get_weights(self) -> Dict[str, np.ndarray]:
        return _to_host(self.params)

    def device_of(self) -> str:
        """Where this rank's params live."""
        return str(self.device)

    def set_weights(self, weights) -> bool:
        self.params = _to_tensors(weights, self.device)
        self._acting = _to_host(self.params)
        self.opt_state = self.optimizer.init(self.params)
        return True


class DDPPOConfig:
    def __init__(self):
        self.env_maker: Callable[[int], Any] = lambda seed: CartPoleEnv(seed)
        self.obs_dim = CartPoleEnv.observation_dim
        self.num_actions = CartPoleEnv.num_actions
        self.num_workers = 2
        self.num_envs_per_worker = 4
        self.rollout_fragment_length = 64
        self.lr = 3e-4
        self.gamma = 0.99
        self.lambda_ = 0.95
        self.clip_param = 0.2
        self.entropy_coeff = 0.01
        self.vf_coeff = 0.5
        self.num_sgd_iter = 2
        self.sgd_minibatch_size = 128
        self.seed = 0
        self.device = "cuda"         # the ranks' learners; "cpu" for the CPU

    def environment(self, env_maker=None, *, obs_dim=None,
                    num_actions=None) -> "DDPPOConfig":
        if env_maker is not None:
            self.env_maker = env_maker
        if obs_dim is not None:
            self.obs_dim = obs_dim
        if num_actions is not None:
            self.num_actions = num_actions
        return self

    def rollouts(self, *, num_workers=None,
                 num_envs_per_worker=None,
                 rollout_fragment_length=None) -> "DDPPOConfig":
        if num_workers is not None:
            self.num_workers = num_workers
        if num_envs_per_worker is not None:
            self.num_envs_per_worker = num_envs_per_worker
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = rollout_fragment_length
        return self

    def training(self, *, lr=None, num_sgd_iter=None,
                 sgd_minibatch_size=None, device=None) -> "DDPPOConfig":
        for k, v in [("lr", lr), ("num_sgd_iter", num_sgd_iter),
                     ("sgd_minibatch_size", sgd_minibatch_size),
                     ("device", device)]:
            if v is not None:
                setattr(self, k, v)
        return self

    def build(self) -> "DDPPO":
        return DDPPO({"ddppo_config": self})


class DDPPO(Algorithm):
    def setup(self, config: Dict[str, Any]) -> None:
        import os
        import uuid

        cfg: DDPPOConfig = config.get("ddppo_config") or DDPPOConfig()
        self.cfg = cfg
        # unique across drivers sharing a cluster — a plain counter would
        # collide when a second driver restarts the sequence
        self._group = f"ddppo-{os.getpid()}-{uuid.uuid4().hex[:8]}"
        opts = {"num_cpus": 1}
        if _on_card(cfg.device):
            opts["num_gpus"] = 1 / cfg.num_workers
        self.workers = [
            _DDPPOWorker.options(**opts).remote(
                i, cfg.num_workers, self._group, cfg.env_maker,
                cfg.num_envs_per_worker, cfg.seed, cfg.obs_dim,
                cfg.num_actions, cfg.lr, cfg.clip_param, cfg.vf_coeff,
                cfg.entropy_coeff, cfg.device)
            for i in range(cfg.num_workers)
        ]
        ray_tpu_torch.get([w.init_collective.remote() for w in self.workers])
        self._reward_history: List[float] = []
        self._total_steps = 0

    def training_step(self) -> Dict[str, Any]:
        cfg = self.cfg
        outs = ray_tpu_torch.get([
            w.train_step.remote(
                cfg.rollout_fragment_length, cfg.gamma, cfg.lambda_,
                cfg.num_sgd_iter, cfg.sgd_minibatch_size)
            for w in self.workers])
        for out in outs:
            self._reward_history.extend(out.pop("episode_returns"))
            self._total_steps += out.pop("num_env_steps")
        self._reward_history = self._reward_history[-100:]
        mean_reward = (float(np.mean(self._reward_history))
                       if self._reward_history else 0.0)
        stats = {k: float(np.mean([o[k] for o in outs])) for k in outs[0]}
        return {"episode_reward_mean": mean_reward,
                "num_env_steps_sampled": self._total_steps, **stats}

    def get_weights(self):
        return ray_tpu_torch.get(self.workers[0].get_weights.remote())

    def set_weights(self, weights) -> None:
        ray_tpu_torch.get([w.set_weights.remote(weights) for w in self.workers])

    def stop(self) -> None:
        self._kill_workers(self.workers)
        # the rendezvous actor was created inside rank 0's process, so the
        # driver-side registry doesn't know it — kill it by name
        try:
            ray_tpu_torch.kill(ray_tpu_torch.get_actor(f"_collective:{self._group}"))
        except (ValueError, KeyError, ConnectionError):
            pass  # group actor already gone (normal teardown order)
