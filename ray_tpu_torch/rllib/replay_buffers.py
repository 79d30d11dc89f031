"""Replay buffers: uniform + prioritized (proportional).

Capability parity with the reference's `rllib/utils/replay_buffers/`
(`replay_buffer.py`, `prioritized_replay_buffer.py`). Storage is columnar
numpy ring buffers — samples leave as ready-to-device batches.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class ReplayBuffer:
    """Uniform-sampling ring buffer over transition columns."""

    def __init__(self, capacity: int, seed: int = 0):
        self.capacity = capacity
        self._store: Optional[Dict[str, np.ndarray]] = None
        self._idx = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(next(iter(batch.values())))
        if self._store is None:
            self._store = {
                k: np.zeros((self.capacity, *np.asarray(v).shape[1:]),
                            np.asarray(v).dtype)
                for k, v in batch.items()}
        if n >= self.capacity:  # keep only the newest `capacity` rows
            for k in self._store:
                self._store[k][:] = np.asarray(batch[k])[n - self.capacity:]
            self._idx, self._size = 0, self.capacity
            return
        head = min(n, self.capacity - self._idx)
        for k in self._store:
            v = np.asarray(batch[k])
            self._store[k][self._idx:self._idx + head] = v[:head]
            if head < n:  # wrapped tail
                self._store[k][:n - head] = v[head:]
        self._idx = (self._idx + n) % self.capacity
        self._size = min(self._size + n, self.capacity)

    def sample(self, batch_size: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, self._size, size=batch_size)
        return {k: v[idx] for k, v in self._store.items()}


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritization (reference
    `prioritized_replay_buffer.py`): P(i) ∝ p_i^alpha, importance weights
    w_i = (N * P(i))^-beta normalized by max."""

    def __init__(self, capacity: int, alpha: float = 0.6, seed: int = 0):
        super().__init__(capacity, seed)
        self.alpha = alpha
        self._priorities = np.zeros(capacity, np.float64)
        self._max_priority = 1.0

    def add_batch(self, batch: Dict[str, np.ndarray]) -> None:
        n = len(next(iter(batch.values())))
        start = self._idx
        super().add_batch(batch)
        for j in range(n):
            self._priorities[(start + j) % self.capacity] = \
                self._max_priority ** self.alpha

    def sample(self, batch_size: int, beta: float = 0.4) -> Dict[str, np.ndarray]:
        p = self._priorities[:self._size]
        probs = p / p.sum()
        idx = self._rng.choice(self._size, size=batch_size, p=probs)
        weights = (self._size * probs[idx]) ** (-beta)
        weights = weights / weights.max()
        out = {k: v[idx] for k, v in self._store.items()}
        out["weights"] = weights.astype(np.float32)
        out["batch_indexes"] = idx.astype(np.int64)
        return out

    def update_priorities(self, idx: np.ndarray, td_errors: np.ndarray) -> None:
        p = (np.abs(td_errors) + 1e-6)
        self._priorities[idx] = p ** self.alpha
        self._max_priority = max(self._max_priority, float(p.max()))
