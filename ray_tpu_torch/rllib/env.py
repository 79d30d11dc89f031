"""Environments: a dependency-free CartPole + vectorization.

The reference wraps gym (`rllib/env/vector_env.py`); this build ships a
numpy CartPole (classic Barto-Sutton dynamics, the same the reference's CI
learning tests train on) so the RL stack is testable with zero external
env deps. Any object with reset()->obs / step(a)->(obs, r, done, info)
works as an env.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np


class CartPoleEnv:
    """CartPole-v1 dynamics (max 500 steps, solved ~475)."""

    GRAVITY = 9.8
    CART_MASS = 1.0
    POLE_MASS = 0.1
    POLE_HALF_LEN = 0.5
    FORCE = 10.0
    DT = 0.02
    THETA_LIMIT = 12 * 2 * np.pi / 360
    X_LIMIT = 2.4
    MAX_STEPS = 500

    observation_dim = 4
    num_actions = 2

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._state = None
        self._steps = 0

    def reset(self) -> np.ndarray:
        self._state = self._rng.uniform(-0.05, 0.05, size=4)
        self._steps = 0
        return self._state.astype(np.float32)

    def step(self, action: int) -> Tuple[np.ndarray, float, bool, dict]:
        x, x_dot, theta, theta_dot = self._state
        force = self.FORCE if action == 1 else -self.FORCE
        costheta, sintheta = np.cos(theta), np.sin(theta)
        total_mass = self.CART_MASS + self.POLE_MASS
        polemass_length = self.POLE_MASS * self.POLE_HALF_LEN
        temp = (force + polemass_length * theta_dot**2 * sintheta) / total_mass
        theta_acc = (self.GRAVITY * sintheta - costheta * temp) / (
            self.POLE_HALF_LEN * (4.0 / 3.0 - self.POLE_MASS * costheta**2 / total_mass))
        x_acc = temp - polemass_length * theta_acc * costheta / total_mass
        x += self.DT * x_dot
        x_dot += self.DT * x_acc
        theta += self.DT * theta_dot
        theta_dot += self.DT * theta_acc
        self._state = np.array([x, x_dot, theta, theta_dot])
        self._steps += 1
        done = bool(
            abs(x) > self.X_LIMIT or abs(theta) > self.THETA_LIMIT
            or self._steps >= self.MAX_STEPS)
        return self._state.astype(np.float32), 1.0, done, {}


class PendulumEnv:
    """Pendulum-v1 dynamics: continuous torque control, reward in [-16.27, 0].

    The continuous-control counterpart to CartPole for SAC/DDPG/TD3 learning
    tests (the reference trains these on gym Pendulum in
    rllib/tuned_examples/sac, ddpg).
    """

    MAX_SPEED = 8.0
    MAX_TORQUE = 2.0
    DT = 0.05
    G = 10.0
    M = 1.0
    L = 1.0
    MAX_STEPS = 200

    observation_dim = 3
    action_dim = 1
    max_action = MAX_TORQUE

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)
        self._theta = 0.0
        self._theta_dot = 0.0
        self._steps = 0

    def _obs(self) -> np.ndarray:
        return np.array(
            [np.cos(self._theta), np.sin(self._theta), self._theta_dot],
            np.float32)

    def reset(self) -> np.ndarray:
        self._theta = self._rng.uniform(-np.pi, np.pi)
        self._theta_dot = self._rng.uniform(-1.0, 1.0)
        self._steps = 0
        return self._obs()

    def step(self, action) -> Tuple[np.ndarray, float, bool, dict]:
        u = float(np.clip(np.asarray(action).reshape(-1)[0],
                          -self.MAX_TORQUE, self.MAX_TORQUE))
        th, thdot = self._theta, self._theta_dot
        norm_th = ((th + np.pi) % (2 * np.pi)) - np.pi
        cost = norm_th**2 + 0.1 * thdot**2 + 0.001 * u**2
        thdot = thdot + (
            3 * self.G / (2 * self.L) * np.sin(th)
            + 3.0 / (self.M * self.L**2) * u) * self.DT
        thdot = float(np.clip(thdot, -self.MAX_SPEED, self.MAX_SPEED))
        th = th + thdot * self.DT
        self._theta, self._theta_dot = th, thdot
        self._steps += 1
        done = self._steps >= self.MAX_STEPS
        return self._obs(), -float(cost), done, {}


class VectorEnv:
    """N independent env copies stepped together (reference vector_env.py).

    `discrete` controls the per-env action cast: int for discrete envs,
    pass-through arrays for continuous ones.
    """

    def __init__(self, env_fn: Callable[[int], Any], num_envs: int,
                 seed: int = 0, discrete: bool = True):
        self.envs = [env_fn(seed + i) for i in range(num_envs)]
        self.env_maker = env_fn  # evaluation spins fresh envs from this
        self.num_envs = num_envs
        self._cast = int if discrete else (lambda a: a)

    def reset(self) -> np.ndarray:
        return np.stack([e.reset() for e in self.envs])

    def step(self, actions) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[dict]]:
        obs, rews, dones, infos = [], [], [], []
        for e, a in zip(self.envs, actions):
            o, r, d, i = e.step(self._cast(a))
            if d:
                o = e.reset()
            obs.append(o)
            rews.append(r)
            dones.append(d)
            infos.append(i)
        return np.stack(obs), np.array(rews, np.float32), np.array(dones), infos


class ContinuousVectorEnv(VectorEnv):
    """VectorEnv without the int() action cast, for continuous control."""

    def __init__(self, env_fn: Callable[[int], Any], num_envs: int, seed: int = 0):
        super().__init__(env_fn, num_envs, seed, discrete=False)
