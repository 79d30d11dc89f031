"""SimpleQ: the minimal Q-learning baseline.

Mirrors the reference's SimpleQ (`rllib/algorithms/simple_q/simple_q.py`):
DQN stripped to its core — plain max-over-target-net TD backup (no double
estimation), uniform replay, one update per round. Implemented as the DQN
anatomy with `double_q=False` and the reference's SimpleQ defaults, the
same way the reference derives DQN by EXTENDING SimpleQ.
"""

from __future__ import annotations

from ray_tpu_torch.rllib.dqn import DQN, DQNConfig


class SimpleQConfig(DQNConfig):
    def __init__(self):
        super().__init__()
        self.double_q = False
        self.prioritized_replay = False
        self.num_updates_per_step = 1
        self.target_update_interval = 8

    def build(self) -> "SimpleQ":
        return SimpleQ({"dqn_config": self})


class SimpleQ(DQN):
    """SimpleQ = DQN minus the double-Q estimator (reference simple_q)."""
