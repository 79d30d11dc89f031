"""Periodic deterministic evaluation (reference `Algorithm.evaluate`,
`rllib/algorithms/algorithm.py:847`, driven by `evaluation_interval` at
`:775`).

The reference runs a dedicated evaluation WorkerSet; here evaluation rides
the existing rollout workers (the reference's
`evaluation_num_workers=0` in-place mode): each worker runs greedy
episodes on a FRESH env instance (its training envs and episode state are
untouched), so no extra actors sit idle between eval rounds.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


def run_eval_episodes(env_maker, module, params, num_episodes: int,
                      seed: int, max_steps_per_episode: int = 1000
                      ) -> Dict[str, Any]:
    """Greedy (deterministic) episodes with the module's inference path.
    Returns per-episode returns and lengths."""
    from ray_tpu_torch.rllib.connectors import (ArgmaxAction,
                                                CastObsFloat32,
                                                ConnectorPipeline)
    from ray_tpu_torch.rllib.env import VectorEnv

    vec = VectorEnv(env_maker, 1, seed)
    to_module = ConnectorPipeline([CastObsFloat32()])
    to_env = ConnectorPipeline([ArgmaxAction()])
    returns, lengths = [], []
    rng = np.random.default_rng(seed)  # pipeline contract; unused greedily
    for _ in range(num_episodes):
        obs = vec.reset()
        total, steps = 0.0, 0
        for _ in range(max_steps_per_episode):
            data = {"obs": obs, "module": module, "params": params,
                    "rng": rng}
            data = to_module(data)
            data["fwd_out"] = module.forward_inference(params, data["obs"])
            data = to_env(data)
            obs, rewards, dones, _ = vec.step(data["actions"])
            total += float(rewards[0])
            steps += 1
            if dones[0]:
                break
        returns.append(total)
        lengths.append(steps)
    return {"episode_returns": np.asarray(returns, np.float32),
            "episode_lengths": np.asarray(lengths, np.int32)}


class EvalConfigMixin:
    """Builder surface for evaluation settings (reference
    `AlgorithmConfig.evaluation`). Class-level defaults so config
    __init__s need no change."""

    evaluation_interval: Optional[int] = None   # iterations between evals
    evaluation_duration: int = 5                # episodes per eval

    def evaluation(self, *, evaluation_interval: Optional[int] = None,
                   evaluation_duration: Optional[int] = None):
        if evaluation_interval is not None:
            self.evaluation_interval = evaluation_interval
        if evaluation_duration is not None:
            self.evaluation_duration = evaluation_duration
        return self


def summarize_eval(parts) -> Dict[str, Any]:
    rets = np.concatenate([p["episode_returns"] for p in parts])
    lens = np.concatenate([p["episode_lengths"] for p in parts])
    return {
        "episode_reward_mean": float(rets.mean()),
        "episode_reward_min": float(rets.min()),
        "episode_reward_max": float(rets.max()),
        "episode_len_mean": float(lens.mean()),
        "num_episodes": int(len(rets)),
    }
