"""Exponential backoff with full jitter.

One policy for every reconnect/retry loop in the runtime (reference
`exponential_backoff.h` + the AWS "full jitter" scheme): the delay for
attempt `n` is drawn uniformly from `[0, min(cap, base * factor**n)]`.
Full jitter decorrelates a thundering herd — after a head replacement
every raylet, worker and driver reconnects at once, and fixed sleeps
would re-synchronize them against the new address forever.

Used by `rpc.ReconnectingClient` (control-plane links, owner links),
`ResultBuffer`'s owner-down requeue, and the serve controller's
checkpoint restore. Pass a seeded `random.Random` as `rng` for
deterministic tests.
"""

from __future__ import annotations

import random
import time
from typing import Optional


class ExponentialBackoff:
    """Stateful attempt counter + full-jitter delay schedule."""

    def __init__(self, base_s: float = 0.1, cap_s: float = 10.0,
                 factor: float = 2.0,
                 rng: Optional[random.Random] = None):
        if base_s <= 0:
            raise ValueError("base_s must be > 0")
        self.base_s = base_s
        self.cap_s = max(base_s, cap_s)
        self.factor = factor
        self._rng = rng or random
        self._attempt = 0

    @property
    def attempt(self) -> int:
        return self._attempt

    def delay_for(self, attempt: int) -> float:
        """Full-jitter delay for a given attempt number (stateless)."""
        ceiling = min(self.cap_s, self.base_s * (self.factor ** max(0, attempt)))
        return self._rng.uniform(0.0, ceiling)

    def next_delay(self) -> float:
        """Delay for the current attempt; advances the counter."""
        d = self.delay_for(self._attempt)
        self._attempt += 1
        return d

    def sleep(self) -> float:
        """Sleep for the next delay; returns the slept duration."""
        d = self.next_delay()
        if d > 0:
            time.sleep(d)
        return d

    def reset(self) -> None:
        self._attempt = 0
