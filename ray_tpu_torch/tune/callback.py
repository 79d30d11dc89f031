"""User callback hooks for Tune experiments (reference
`python/ray/tune/callback.py`: Callback with on_trial_result/complete/error
invoked from the TrialRunner loop).

Callbacks ride in `RunConfig(callbacks=[...])`; the TrialRunner invokes each
hook synchronously in list order. A raising callback is logged and disabled
rather than killing the sweep (matching the reference's stance that user
observability code must not take down the experiment).
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


class Callback:
    """Base class; override any subset of hooks.

    `trial` is the runner's Trial record (trial_id, config, last_result,
    state); `result` is the raw reported metrics dict for this iteration.
    """

    def setup(self, experiment_dir: Optional[str]) -> None:
        """Once, before the first trial starts."""

    def on_trial_start(self, trial) -> None:
        pass

    def on_trial_result(self, trial, result: Dict[str, Any]) -> None:
        pass

    def on_trial_complete(self, trial) -> None:
        pass

    def on_trial_error(self, trial) -> None:
        pass

    def on_checkpoint(self, trial, checkpoint) -> None:
        pass

    def on_experiment_end(self, trials: List[Any]) -> None:
        pass


class CallbackList:
    """Invokes a list of callbacks, isolating failures per callback."""

    def __init__(self, callbacks: Optional[List[Callback]] = None):
        self._callbacks = list(callbacks or [])
        self._dead: set = set()

    def __bool__(self):
        return bool(self._callbacks)

    def _fire(self, hook: str, *args) -> None:
        for cb in self._callbacks:
            if id(cb) in self._dead:
                continue
            try:
                getattr(cb, hook)(*args)
            except Exception:
                logger.exception(
                    "callback %s.%s failed; disabling this callback",
                    type(cb).__name__, hook)
                self._dead.add(id(cb))

    def setup(self, experiment_dir):
        self._fire("setup", experiment_dir)

    def on_trial_start(self, trial):
        self._fire("on_trial_start", trial)

    def on_trial_result(self, trial, result):
        self._fire("on_trial_result", trial, result)

    def on_trial_complete(self, trial):
        self._fire("on_trial_complete", trial)

    def on_trial_error(self, trial):
        self._fire("on_trial_error", trial)

    def on_checkpoint(self, trial, checkpoint):
        self._fire("on_checkpoint", trial, checkpoint)

    def on_experiment_end(self, trials):
        self._fire("on_experiment_end", trials)
