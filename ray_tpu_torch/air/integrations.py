"""Experiment-tracking integrations (reference
`python/ray/air/integrations/{wandb,mlflow}.py`): Tune callbacks that mirror
every trial's reported results into an external tracker.

Neither wandb nor mlflow is baked into this image, so both adapters import
lazily at setup() and degrade to a logged warning when the package is absent
(the sweep itself must never depend on a tracker being installed). Tests
inject fake modules through sys.modules.
"""

from __future__ import annotations

import importlib
import logging
from typing import Any, Dict, List, Optional

from ray_tpu_torch.tune.callback import Callback
from ray_tpu_torch.tune.logger import _scrub

logger = logging.getLogger(__name__)


class WandbLoggerCallback(Callback):
    """One wandb run per trial (reference WandbLoggerCallback): config =
    trial config, metrics logged per iteration with the training_iteration
    step, run finished on complete/error."""

    def __init__(self, project: str = "ray_tpu_torch", group: Optional[str] = None,
                 **init_kwargs: Any):
        self._project = project
        self._group = group
        self._init_kwargs = init_kwargs
        self._wandb = None
        self._runs: Dict[str, Any] = {}

    def setup(self, experiment_dir: Optional[str]) -> None:
        try:
            self._wandb = importlib.import_module("wandb")
        except ImportError:
            logger.warning("wandb not installed; WandbLoggerCallback inactive")
            self._wandb = None

    def on_trial_start(self, trial) -> None:
        if self._wandb is None or trial.trial_id in self._runs:
            return
        kw = dict(project=self._project, group=self._group,
                  name=trial.trial_id, config=_scrub(dict(trial.config)),
                  **self._init_kwargs)
        # reinit="create_new": concurrent trials need independent run
        # handles (reinit=True would finish the previous trial's run).
        # Older wandb versions reject the string value — fall back to
        # reinit=True rather than silently disabling tracking.
        try:
            run = self._wandb.init(reinit="create_new", **kw)
        except (TypeError, ValueError):
            run = self._wandb.init(reinit=True, **kw)
        self._runs[trial.trial_id] = run

    def on_trial_result(self, trial, result: Dict[str, Any]) -> None:
        run = self._runs.get(trial.trial_id)
        if run is None:
            return
        metrics = {k: v for k, v in _scrub(result).items()
                   if isinstance(v, (int, float)) and not isinstance(v, bool)}
        run.log(metrics, step=int(result.get("training_iteration", 0)))

    def _finish(self, trial) -> None:
        run = self._runs.pop(trial.trial_id, None)
        if run is not None:
            run.finish()

    on_trial_complete = _finish
    on_trial_error = _finish

    def on_experiment_end(self, trials: List[Any]) -> None:
        for run in self._runs.values():
            run.finish()
        self._runs.clear()


class MLflowLoggerCallback(Callback):
    """One mlflow run per trial (reference MLflowLoggerCallback): params from
    the trial config, per-iteration metrics, run status on terminate."""

    def __init__(self, experiment_name: str = "ray_tpu_torch",
                 tracking_uri: Optional[str] = None,
                 tags: Optional[Dict[str, str]] = None):
        self._experiment_name = experiment_name
        self._tracking_uri = tracking_uri
        self._tags = tags or {}
        self._mlflow = None
        self._client = None
        self._experiment_id = None
        self._runs: Dict[str, Any] = {}

    def setup(self, experiment_dir: Optional[str]) -> None:
        # MlflowClient (not the fluent mlflow.start_run/end_run API): the
        # fluent API tracks ONE active run per process, so concurrent
        # trials would end each other's runs. The client API addresses
        # every call by run_id.
        try:
            mlflow = importlib.import_module("mlflow")
        except ImportError:
            logger.warning("mlflow not installed; MLflowLoggerCallback inactive")
            return
        if self._tracking_uri:
            mlflow.set_tracking_uri(self._tracking_uri)
        self._client = mlflow.tracking.MlflowClient(
            tracking_uri=self._tracking_uri)
        exp = self._client.get_experiment_by_name(self._experiment_name)
        self._experiment_id = (exp.experiment_id if exp is not None else
                               self._client.create_experiment(
                                   self._experiment_name))
        self._mlflow = mlflow

    def on_trial_start(self, trial) -> None:
        if self._mlflow is None or trial.trial_id in self._runs:
            return
        run = self._client.create_run(
            self._experiment_id, tags={**self._tags,
                                       "mlflow.runName": trial.trial_id})
        self._runs[trial.trial_id] = run
        for k, v in _scrub(dict(trial.config)).items():
            self._client.log_param(run.info.run_id, k, v)

    def on_trial_result(self, trial, result: Dict[str, Any]) -> None:
        run = self._runs.get(trial.trial_id)
        if run is None:
            return
        step = int(result.get("training_iteration", 0))
        for k, v in _scrub(result).items():
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                self._client.log_metric(run.info.run_id, k, float(v),
                                        step=step)

    def _finish(self, trial, status: str) -> None:
        run = self._runs.pop(trial.trial_id, None)
        if run is not None:
            self._client.set_terminated(run.info.run_id, status=status)

    def on_trial_complete(self, trial) -> None:
        self._finish(trial, "FINISHED")

    def on_trial_error(self, trial) -> None:
        self._finish(trial, "FAILED")

    def on_experiment_end(self, trials: List[Any]) -> None:
        if self._mlflow is None:
            return
        for run in self._runs.values():
            self._client.set_terminated(run.info.run_id, status="FINISHED")
        self._runs.clear()
