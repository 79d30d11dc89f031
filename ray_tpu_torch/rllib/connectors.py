"""Connector pipelines: composable env<->module data transforms.

Mirrors the reference's connector architecture (`rllib/connectors/`): the
glue between raw env observations and module inputs (env-to-module) and
between module outputs and env actions (module-to-env) is a PIPELINE of
small, swappable steps instead of logic hard-coded into each rollout
worker. An algorithm changes exploration (greedy vs. sampled vs.
eps-greedy), obs preprocessing, or action postprocessing by editing its
pipeline, not by forking the worker.

Connectors run HOST-SIDE in env-stepping actors (numpy), so steps stay
vectorized-numpy; the module's jitted forwards remain untouched.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

__all__ = [
    "Connector", "ConnectorPipeline", "CastObsFloat32", "SampleAction",
    "ArgmaxAction", "EpsilonGreedy", "GaussianNoise", "ClipAction",
    "RandomActions",
]


class Connector:
    """One transform over the rollout context dict. Mutates/returns `data`.

    Keys by convention: "obs", "fwd_out" (module forward outputs),
    "actions", "logp", "rng" (np.random.Generator), "module", "params",
    "timestep"."""

    def __call__(self, data: Dict[str, Any]) -> Dict[str, Any]:
        raise NotImplementedError


class ConnectorPipeline(Connector):
    """Ordered composition (reference ConnectorPipelineV2). Supports
    insertion for customization: `pipeline.prepend(...)` / `append(...)`."""

    def __init__(self, steps: Optional[List[Connector]] = None):
        self.steps = list(steps or [])

    def __call__(self, data: Dict[str, Any]) -> Dict[str, Any]:
        for step in self.steps:
            data = step(data)
        return data

    def append(self, step: Connector) -> "ConnectorPipeline":
        self.steps.append(step)
        return self

    def prepend(self, step: Connector) -> "ConnectorPipeline":
        self.steps.insert(0, step)
        return self


# ------------------------------------------------------------ env-to-module


class CastObsFloat32(Connector):
    def __call__(self, data):
        data["obs"] = np.asarray(data["obs"], np.float32)
        return data


# ------------------------------------------------------------ module-to-env


class SampleAction(Connector):
    """Sample from the module's action distribution; records "logp" (what
    on-policy losses need). Off-policy pipelines that never consume logp
    (SAC/DDPG replay) pass record_logp=False to keep it off the per-step
    hot path."""

    def __init__(self, record_logp: bool = True):
        self.record_logp = record_logp

    def __call__(self, data):
        dist = data["module"].action_dist(data["fwd_out"])
        actions = dist.sample(data["rng"])
        data["actions"] = actions
        if self.record_logp:
            data["logp"] = np.asarray(dist.logp(actions), np.float32)
        return data


class ArgmaxAction(Connector):
    """Greedy action (evaluation / deterministic policies)."""

    def __call__(self, data):
        dist = data["module"].action_dist(data["fwd_out"])
        data["actions"] = dist.argmax()
        return data


class EpsilonGreedy(Connector):
    """Annealed eps-greedy over the module's argmax (DQN-family
    exploration; reference rllib/utils/exploration/epsilon_greedy.py)."""

    def __init__(self, num_actions: int, eps_start: float = 1.0,
                 eps_end: float = 0.02, anneal_steps: int = 10_000):
        self.eps_start = eps_start
        self.eps_end = eps_end
        self.anneal_steps = max(1, anneal_steps)
        self.num_actions = num_actions

    def epsilon(self, t: int) -> float:
        frac = min(1.0, t / self.anneal_steps)
        return self.eps_start + frac * (self.eps_end - self.eps_start)

    def __call__(self, data):
        dist = data["module"].action_dist(data["fwd_out"])
        greedy = dist.argmax()
        rng: np.random.Generator = data["rng"]
        # algorithms that schedule epsilon centrally (DQN anneals per
        # training iteration, not per env timestep) force it per call
        if "epsilon_override" in data:
            eps = float(data["epsilon_override"])
        else:
            eps = self.epsilon(int(data.get("timestep", 0)))
        explore = rng.random(len(greedy)) < eps
        randoms = rng.integers(0, self.num_actions, size=len(greedy))
        data["actions"] = np.where(explore, randoms, greedy).astype(np.int32)
        data["epsilon"] = eps
        return data


class GaussianNoise(Connector):
    """Additive exploration noise for continuous deterministic policies
    (DDPG/TD3)."""

    def __init__(self, scale: float, low: float, high: float):
        self.scale = scale
        self.low = low
        self.high = high

    def __call__(self, data):
        a = np.asarray(data["actions"], np.float32)
        a = a + data["rng"].normal(0.0, self.scale, a.shape).astype(np.float32)
        data["actions"] = np.clip(a, self.low, self.high)
        return data


class ClipAction(Connector):
    def __init__(self, low: float, high: float):
        self.low = low
        self.high = high

    def __call__(self, data):
        data["actions"] = np.clip(np.asarray(data["actions"]),
                                  self.low, self.high)
        return data


class RandomActions(Connector):
    """Uniform random actions — the warmup phase of off-policy continuous
    algorithms (SAC/DDPG learning_starts), run INSTEAD of the module
    forward (reference Random exploration,
    rllib/utils/exploration/random.py)."""

    def __init__(self, action_dim: int, low: float, high: float):
        self.action_dim = action_dim
        self.low = low
        self.high = high

    def __call__(self, data):
        n = len(data["obs"])
        data["actions"] = data["rng"].uniform(
            self.low, self.high, (n, self.action_dim)).astype(np.float32)
        return data
