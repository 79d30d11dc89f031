"""Shared policy/value network building blocks (numpy init, torch/numpy
apply); the port of ray_tpu/rllib/models.py.

One He-init MLP implementation used by PPO (two-head), DQN (Q head), and
ES (argmax policy) — the reference's catalog/model zoo analog
(`rllib/models/catalog.py`) collapsed to the MLP family the in-tree
learning tests need. Initialization is numpy's, so both packages start
from the same parameters for a seed.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np


def init_mlp(rng: np.random.Generator, sizes: Sequence[int],
             final_scale: float = 1.0, prefix: str = "w") -> Dict[str, Any]:
    """He-initialized MLP weights: w0/b0 ... w{L-1}/b{L-1}."""
    params: Dict[str, Any] = {}
    for i in range(len(sizes) - 1):
        scale = final_scale if i == len(sizes) - 2 else np.sqrt(2.0 / sizes[i])
        params[f"w{i}"] = (rng.standard_normal((sizes[i], sizes[i + 1]))
                           * scale).astype(np.float32)
        params[f"b{i}"] = np.zeros(sizes[i + 1], np.float32)
    return params


def mlp_hidden(params: Dict[str, Any], x, n_hidden: int):
    """tanh trunk through the first n_hidden layers. Dispatches on the
    INPUT type: numpy stays numpy (env-stepping actors never touch torch
    on their per-step hot path), torch tensors go through torch (learner
    losses under autograd)."""
    if isinstance(x, np.ndarray):
        tanh = np.tanh
    else:
        import torch

        tanh = torch.tanh
    for i in range(n_hidden):
        x = tanh(x @ params[f"w{i}"] + params[f"b{i}"])
    return x


def mlp_forward(params: Dict[str, Any], x, n_layers: int):
    """Full MLP with linear final layer. torch or numpy inputs."""
    x = mlp_hidden(params, x, n_layers - 1)
    i = n_layers - 1
    return x @ params[f"w{i}"] + params[f"b{i}"]


def mlp_forward_np(params: Dict[str, Any], x: np.ndarray) -> np.ndarray:
    """Pure-numpy full forward (for env-stepping actors without torch)."""
    n = len(params) // 2
    for i in range(n - 1):
        x = np.tanh(x @ params[f"w{i}"] + params[f"b{i}"])
    return x @ params[f"w{n-1}"] + params[f"b{n-1}"]
