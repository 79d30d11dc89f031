"""Stoppers: experiment/trial stop criteria (reference `ray.tune.Stopper`,
`python/ray/tune/stopper/` — maximum-iteration, plateau, timeout, combined,
function, and the dict shorthand accepted by `RunConfig(stop=...)`).
"""

from __future__ import annotations

import time
from collections import defaultdict, deque
from typing import Any, Callable, Dict, Optional


class Stopper:
    """`__call__(trial_id, result)` -> stop THIS trial;
    `stop_all()` -> stop the whole experiment."""

    def __call__(self, trial_id: str, result: Dict[str, Any]) -> bool:
        raise NotImplementedError

    def stop_all(self) -> bool:
        return False

    def reset(self) -> None:
        """Clear accumulated state (plateau windows, armed deadlines).
        Called by Tuner.restore so a resumed experiment re-arms the
        CRITERIA without inheriting pre-crash state."""


class MaximumIterationStopper(Stopper):
    def __init__(self, max_iter: int):
        self.max_iter = max_iter

    def __call__(self, trial_id, result) -> bool:
        return result.get("training_iteration", 0) >= self.max_iter


class TimeoutStopper(Stopper):
    """Stops the whole experiment `timeout` seconds after it STARTS
    running (the clock arms on first use, not at construction — a script
    that builds its RunConfig long before fit() must not burn the budget
    on data prep)."""

    def __init__(self, timeout: float):
        self.timeout = timeout
        self._deadline: Optional[float] = None

    def _armed_deadline(self) -> float:
        if self._deadline is None:
            self._deadline = time.monotonic() + self.timeout
        return self._deadline

    def __call__(self, trial_id, result) -> bool:
        return self.stop_all()

    def stop_all(self) -> bool:
        return time.monotonic() >= self._armed_deadline()

    def reset(self) -> None:
        self._deadline = None  # monotonic clocks don't survive restarts


class TrialPlateauStopper(Stopper):
    """Stop a trial when `metric`'s std over the last `num_results` results
    falls to `std` or below (after `grace_period` results)."""

    def __init__(self, metric: str, std: float = 0.01, num_results: int = 4,
                 grace_period: int = 4,
                 metric_threshold: Optional[float] = None,
                 mode: str = "min"):
        self.metric = metric
        self.std = std
        self.num_results = num_results
        self.grace_period = grace_period
        self.metric_threshold = metric_threshold
        self.mode = mode
        self._window: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=num_results))
        self._seen: Dict[str, int] = defaultdict(int)

    def __call__(self, trial_id, result) -> bool:
        v = result.get(self.metric)
        if v is None:
            return False
        self._seen[trial_id] += 1
        self._window[trial_id].append(float(v))
        if self._seen[trial_id] < max(self.grace_period, self.num_results):
            return False
        if self.metric_threshold is not None:
            ok = (v >= self.metric_threshold if self.mode == "max"
                  else v <= self.metric_threshold)
            if not ok:
                return False
        w = self._window[trial_id]
        mean = sum(w) / len(w)
        var = sum((x - mean) ** 2 for x in w) / len(w)
        return var ** 0.5 <= self.std

    def reset(self) -> None:
        self._window.clear()
        self._seen.clear()


class FunctionStopper(Stopper):
    def __init__(self, fn: Callable[[str, Dict[str, Any]], bool]):
        self.fn = fn

    def __call__(self, trial_id, result) -> bool:
        return bool(self.fn(trial_id, result))


class CombinedStopper(Stopper):
    def __init__(self, *stoppers: Stopper):
        self.stoppers = list(stoppers)

    def __call__(self, trial_id, result) -> bool:
        # no short-circuit: stateful stoppers (plateau windows) must see
        # every result
        return any([s(trial_id, result) for s in self.stoppers])

    def stop_all(self) -> bool:
        return any(s.stop_all() for s in self.stoppers)

    def reset(self) -> None:
        for s in self.stoppers:
            s.reset()


class _DictStopper(Stopper):
    """Reference dict shorthand: stop a trial when ANY named metric
    reaches its threshold (`result[k] >= v`)."""

    def __init__(self, criteria: Dict[str, float]):
        self.criteria = dict(criteria)

    def __call__(self, trial_id, result) -> bool:
        return any(result.get(k) is not None and result[k] >= v
                   for k, v in self.criteria.items())


def make_stopper(stop: Any) -> Optional[Stopper]:
    """RunConfig(stop=...) accepts a Stopper, a dict of metric thresholds,
    or a callable(trial_id, result) -> bool (reference tune.run stop)."""
    if stop is None or isinstance(stop, Stopper):
        return stop
    if isinstance(stop, dict):
        return _DictStopper(stop)
    if callable(stop):
        return FunctionStopper(stop)
    raise TypeError(f"stop must be a Stopper, dict, or callable; got "
                    f"{type(stop).__name__}")
