"""Algorithm base: the Tune Trainable contract for RL.

Mirrors the reference's `Algorithm` (rllib/algorithms/algorithm.py:149):
`train()` runs one `training_step` iteration and returns metrics;
save/restore expose checkpoints so Tune schedulers (ASHA/PBT) drive RL
experiments unchanged.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint


class Algorithm:
    def __init__(self, config: Dict[str, Any]):
        self.config = dict(config)
        self.iteration = 0
        self.setup(self.config)

    # -- subclass hooks --
    def setup(self, config: Dict[str, Any]) -> None:
        raise NotImplementedError

    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def get_weights(self) -> Any:
        raise NotImplementedError

    def set_weights(self, weights: Any) -> None:
        raise NotImplementedError

    # -- Trainable contract --
    def train(self) -> Dict[str, Any]:
        self.iteration += 1
        metrics = self.training_step()
        metrics["training_iteration"] = self.iteration
        interval = getattr(getattr(self, "cfg", None),
                           "evaluation_interval", None)
        if interval and self.iteration % interval == 0:
            metrics["evaluation"] = self.evaluate()
        return metrics

    def evaluate(self, num_episodes: Optional[int] = None) -> Dict[str, Any]:
        """Deterministic evaluation episodes spread over the rollout
        workers (reference Algorithm.evaluate, algorithm.py:847; the
        in-place evaluation_num_workers=0 mode — workers run fresh envs,
        training state untouched)."""
        import ray_tpu_torch
        from ray_tpu_torch.rllib.evaluation import summarize_eval

        workers = getattr(self, "workers", None)
        if not workers:
            raise NotImplementedError(
                f"{type(self).__name__} has no rollout workers to evaluate "
                "with; override evaluate()")
        n = num_episodes or getattr(getattr(self, "cfg", None),
                                    "evaluation_duration", 5)
        per = [n // len(workers)] * len(workers)
        for i in range(n % len(workers)):
            per[i] += 1
        refs = [w.eval_episodes.remote(k, seed=1000 + 7 * i)
                for i, (w, k) in enumerate(zip(workers, per)) if k > 0]
        return summarize_eval(ray_tpu_torch.get(refs))

    def save(self) -> Checkpoint:
        return Checkpoint.from_dict({
            "weights": self.get_weights(), "iteration": self.iteration})

    def restore(self, checkpoint: Checkpoint) -> None:
        data = checkpoint.to_dict()
        self.set_weights(data["weights"])
        self.iteration = data.get("iteration", 0)

    def stop(self) -> None:
        pass

    @staticmethod
    def _kill_workers(workers) -> None:
        """Best-effort teardown of a worker-actor fleet: an already-dead or
        unreachable worker is the expected case during shutdown and is
        logged, not raised — but programming errors still propagate."""
        import logging

        import ray_tpu_torch

        for w in workers:
            try:
                ray_tpu_torch.kill(w)
            except (OSError, TimeoutError, ValueError, KeyError,
                    RuntimeError) as e:
                logging.getLogger(__name__).debug(
                    "stop(): worker already gone (%s)", e)
