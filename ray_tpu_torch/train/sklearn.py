"""SklearnTrainer + SklearnPredictor: CPU estimator training as a trial.

Reference parity: python/ray/train/sklearn/sklearn_trainer.py (fit an
estimator on AIR datasets in a remote task, optionally cross-validate,
checkpoint the fitted model) and sklearn_predictor.py. Training runs as a
single remote CPU task — there is nothing to shard onto chips, so unlike
DataParallelTrainer no worker group or mesh is involved.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.air import Checkpoint, Result, RunConfig
from ray_tpu_torch.train.predictor import Predictor

MODEL_KEY = "estimator"


def _dataset_to_xy(ds, label_column: str,
                   feature_cols: Optional[List[str]] = None):
    rows = ds.take_all()
    if not rows:
        raise ValueError("empty dataset")
    if feature_cols is None:
        feature_cols = [c for c in rows[0] if c != label_column]
    X = np.asarray([[row[c] for c in feature_cols] for row in rows])
    y = np.asarray([row[label_column] for row in rows])
    return X, y, feature_cols


@ray_tpu_torch.remote
def _fit_task(estimator, label_column: str, datasets: Dict[str, Any],
              cv: Optional[int], scoring: Optional[str],
              fit_params: Dict[str, Any]) -> dict:
    X, y, feature_cols = _dataset_to_xy(datasets["train"], label_column)
    metrics: Dict[str, Any] = {}
    if cv:
        from sklearn.model_selection import cross_val_score

        scores = cross_val_score(estimator, X, y, cv=cv, scoring=scoring)
        metrics["cv/mean_score"] = float(scores.mean())
        metrics["cv/std_score"] = float(scores.std())
    estimator.fit(X, y, **fit_params)
    metrics["train/score"] = float(estimator.score(X, y))
    for name, ds in datasets.items():
        if name == "train":
            continue
        Xv, yv, _ = _dataset_to_xy(ds, label_column, feature_cols)
        metrics[f"{name}/score"] = float(estimator.score(Xv, yv))
    return {"metrics": metrics, "estimator": estimator,
            "feature_cols": feature_cols}


class SklearnTrainer:
    """Fits a scikit-learn estimator on the "train" dataset in a remote CPU
    task; extra datasets are scored as validation sets."""

    def __init__(self, *, estimator, label_column: str,
                 datasets: Dict[str, Any],
                 cv: Optional[int] = None,
                 scoring: Optional[str] = None,
                 fit_params: Optional[Dict[str, Any]] = None,
                 run_config: Optional[RunConfig] = None):
        if "train" not in datasets:
            raise ValueError("datasets must contain a 'train' key")
        self._estimator = estimator
        self._label = label_column
        self._datasets = datasets
        self._cv = cv
        self._scoring = scoring
        self._fit_params = dict(fit_params or {})
        self.run_config = run_config or RunConfig()

    def fit(self) -> Result:
        try:
            out = ray_tpu_torch.get(_fit_task.remote(
                self._estimator, self._label, self._datasets,
                self._cv, self._scoring, self._fit_params))
        except Exception as e:  # surface as Result like other trainers
            return Result(metrics={}, error=e)
        checkpoint = Checkpoint.from_dict({
            MODEL_KEY: out["estimator"],
            "feature_cols": out["feature_cols"]})
        return Result(metrics=out["metrics"], checkpoint=checkpoint)


class SklearnPredictor(Predictor):
    """Predicts with a fitted estimator restored from a checkpoint."""

    def __init__(self, estimator,
                 feature_cols: Optional[List[str]] = None):
        super().__init__()
        self._estimator = estimator
        self._feature_cols = feature_cols

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint) -> "SklearnPredictor":
        data = checkpoint.to_dict()
        return cls(data[MODEL_KEY], data.get("feature_cols"))

    def predict(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        # reorder by the training-time feature columns — dict insertion
        # order of the caller's batch must not matter
        if self._feature_cols is not None and all(
                c in batch for c in self._feature_cols):
            cols = [np.asarray(batch[c]) for c in self._feature_cols]
        else:
            cols = [np.asarray(v) for v in batch.values()]
        X = np.stack(cols, axis=1) if cols[0].ndim == 1 else cols[0]
        return {"predictions": np.asarray(self._estimator.predict(X))}
