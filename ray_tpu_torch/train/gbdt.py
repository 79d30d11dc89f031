"""GBDT trainers: distributed XGBoost / LightGBM on the worker group.

Reference parity: `python/ray/train/xgboost/xgboost_trainer.py:17` and
`python/ray/train/lightgbm/lightgbm_trainer.py` (both built on xgboost-ray
/ lightgbm-ray).

Distribution choice (and why): each library's OWN collective protocol over
this framework's worker task group — xgboost's RabitTracker + allreduce'd
histograms, LightGBM's socket machines-list — exactly the reference's
xgboost-ray architecture. The alternative (single-node-per-trial, scaled
via Tune) wastes the libraries' built-in data parallelism and caps dataset
size at one host's memory; with tracker-based training the framework only
has to shard rows and hand out rendezvous env vars, which the existing
task/actor machinery already does. With ONE worker no tracker is started
and training is the library's plain `train()`.

The scaffolding (row sharding, rendezvous, result/checkpoint plumbing) is
library-agnostic and test-covered via an in-repo "mock" backend; the
xgboost/lightgbm backends import their library lazily IN the worker, so
this module imports (and the trainers raise a clear error) on images
without them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.air import Checkpoint, Result, RunConfig
from ray_tpu_torch.train.sklearn import _dataset_to_xy

MODEL_KEY = "gbdt_model"
BACKEND_KEY = "gbdt_backend"


# ---------------------------------------------------------------- backends


class _XGBoostBackend:
    """xgboost.collective (rabit) training; histogram allreduce across the
    worker group."""

    name = "xgboost"

    @staticmethod
    def check_available() -> None:
        try:
            import xgboost  # noqa: F401
        except ImportError:
            raise ImportError(
                "XGBoostTrainer requires the xgboost package; it is not "
                "installed in this environment") from None

    @staticmethod
    def start_tracker(world: int) -> Tuple[Any, Dict[str, Any]]:
        """RabitTracker rendezvous (driver-side); returns (tracker,
        per-worker env). API differs across xgboost versions — handled by
        feature probes."""
        from xgboost.tracker import RabitTracker

        tracker = RabitTracker(host_ip="127.0.0.1", n_workers=world)
        tracker.start(world) if _wants_arg(tracker.start) else tracker.start()
        if hasattr(tracker, "worker_args"):
            env = dict(tracker.worker_args())
        else:
            env = dict(tracker.worker_envs())
        return tracker, env

    @staticmethod
    def finish_tracker(tracker) -> None:
        for meth in ("wait_for", "join"):
            fn = getattr(tracker, meth, None)
            if fn is not None:
                try:
                    fn()
                except Exception:  # third-party tracker teardown: best-effort
                    pass
                return

    @staticmethod
    def train_shard(rank: int, world: int, tracker_env: Dict[str, Any],
                    X, y, Xv, yv, params: dict, num_rounds: int):
        import xgboost as xgb

        def _run():
            evals_result: Dict[str, Any] = {}
            dtrain = xgb.DMatrix(X, label=y)
            evals = [(dtrain, "train")]
            if Xv is not None:
                evals.append((xgb.DMatrix(Xv, label=yv), "valid"))
            bst = xgb.train(params, dtrain, num_boost_round=num_rounds,
                            evals=evals, evals_result=evals_result,
                            verbose_eval=False)
            return bytes(bst.save_raw()), evals_result

        if world == 1:
            return _run()
        from xgboost import collective

        env = dict(tracker_env)
        env.setdefault("DMLC_TASK_ID", str(rank))
        with collective.CommunicatorContext(**env):
            model, evals_result = _run()
            return (model, evals_result) if collective.get_rank() == 0 \
                else (None, evals_result)

    @staticmethod
    def predict(model_bytes: bytes, X) -> np.ndarray:
        import xgboost as xgb

        bst = xgb.Booster()
        bst.load_model(bytearray(model_bytes))
        return np.asarray(bst.predict(xgb.DMatrix(X)))


class _LightGBMBackend:
    """LightGBM socket machines-list training."""

    name = "lightgbm"

    @staticmethod
    def check_available() -> None:
        try:
            import lightgbm  # noqa: F401
        except ImportError:
            raise ImportError(
                "LightGBMTrainer requires the lightgbm package; it is not "
                "installed in this environment") from None

    @staticmethod
    def start_tracker(world: int) -> Tuple[Any, Dict[str, Any]]:
        import socket

        ports = []
        socks = []
        for _ in range(world):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
            socks.append(s)
        for s in socks:  # free them for lightgbm to rebind
            s.close()
        machines = ",".join(f"127.0.0.1:{p}" for p in ports)
        return None, {"machines": machines, "ports": ports}

    @staticmethod
    def finish_tracker(tracker) -> None:
        pass

    @staticmethod
    def train_shard(rank: int, world: int, tracker_env: Dict[str, Any],
                    X, y, Xv, yv, params: dict, num_rounds: int):
        import lightgbm as lgb

        params = dict(params)
        evals_result: Dict[str, Any] = {}
        if world > 1:
            params.update({
                "num_machines": world,
                "machines": tracker_env["machines"],
                "local_listen_port": tracker_env["ports"][rank],
                "tree_learner": params.get("tree_learner", "data"),
            })
        dtrain = lgb.Dataset(X, label=y)
        valid_sets = [dtrain]
        valid_names = ["train"]
        if Xv is not None:
            valid_sets.append(lgb.Dataset(Xv, label=yv, reference=dtrain))
            valid_names.append("valid")
        bst = lgb.train(params, dtrain, num_boost_round=num_rounds,
                        valid_sets=valid_sets, valid_names=valid_names,
                        callbacks=[lgb.record_evaluation(evals_result)])
        model = bst.model_to_string().encode() if rank == 0 else None
        return model, evals_result

    @staticmethod
    def predict(model_bytes: bytes, X) -> np.ndarray:
        import lightgbm as lgb

        bst = lgb.Booster(model_str=model_bytes.decode())
        return np.asarray(bst.predict(X))


class _MockBackend:
    """In-repo scaffolding backend: a constant-mean 'model' whose training
    exercises the exact shard/rendezvous/aggregate path, so the trainer
    machinery stays test-covered on images without xgboost/lightgbm."""

    name = "mock"

    @staticmethod
    def check_available() -> None:
        pass

    @staticmethod
    def start_tracker(world: int):
        return None, {"world": world}

    @staticmethod
    def finish_tracker(tracker) -> None:
        pass

    @staticmethod
    def train_shard(rank, world, tracker_env, X, y, Xv, yv, params,
                    num_rounds):
        import pickle

        if world > 1:  # rendezvous env only exists with a tracker
            assert tracker_env.get("world") == world
        model = pickle.dumps({"mean": float(np.mean(y)),
                              "n": len(y), "rank": rank}) \
            if rank == 0 else None
        metrics = {"train": {"rmse": [float(np.std(y))] * num_rounds}}
        return model, metrics

    @staticmethod
    def predict(model_bytes: bytes, X) -> np.ndarray:
        import pickle

        return np.full(len(X), pickle.loads(model_bytes)["mean"])


_BACKENDS = {b.name: b for b in
             (_XGBoostBackend, _LightGBMBackend, _MockBackend)}


def _wants_arg(fn) -> bool:
    import inspect

    try:
        return len(inspect.signature(fn).parameters) >= 1
    except (TypeError, ValueError):
        return False


# ----------------------------------------------------------------- trainer


@ray_tpu_torch.remote
def _gbdt_train_task(backend_name: str, rank: int, world: int,
                     tracker_env: Dict[str, Any], X, y, Xv, yv,
                     params: dict, num_rounds: int):
    return _BACKENDS[backend_name].train_shard(
        rank, world, tracker_env, X, y, Xv, yv, params, num_rounds)


class GBDTTrainer:
    """Distributed gradient-boosted-tree training over the task group:
    rows shard across `num_workers`, the library's own collective syncs
    tree construction, rank 0's serialized model becomes the Checkpoint."""

    _backend_name = "mock"

    def __init__(self, *, label_column: str, params: Optional[dict] = None,
                 datasets: Dict[str, Any], num_workers: int = 2,
                 num_boost_round: int = 10,
                 run_config: Optional[RunConfig] = None):
        if "train" not in datasets:
            raise ValueError("datasets must contain a 'train' key")
        _BACKENDS[self._backend_name].check_available()
        self._label = label_column
        self._params = dict(params or {})
        self._datasets = datasets
        self._num_workers = max(1, num_workers)
        self._num_rounds = num_boost_round
        self.run_config = run_config or RunConfig()

    def fit(self) -> Result:
        backend = _BACKENDS[self._backend_name]
        try:
            X, y, feature_cols = _dataset_to_xy(
                self._datasets["train"], self._label)
            Xv = yv = None
            if "valid" in self._datasets:
                Xv, yv, _ = _dataset_to_xy(self._datasets["valid"],
                                           self._label, feature_cols)
            world = min(self._num_workers, len(y))
            tracker = None
            tracker_env: Dict[str, Any] = {}
            if world > 1:
                tracker, tracker_env = backend.start_tracker(world)
            shards = [(X[i::world], y[i::world]) for i in range(world)]
            futs = [_gbdt_train_task.options(num_cpus=1).remote(
                self._backend_name, rank, world, tracker_env,
                Xs, ys, Xv, yv, self._params, self._num_rounds)
                for rank, (Xs, ys) in enumerate(shards)]
            results = ray_tpu_torch.get(futs, timeout=600)
            backend.finish_tracker(tracker)
        except Exception as e:
            return Result(metrics={}, error=e)
        model = next((m for m, _ in results if m is not None), None)
        if model is None:
            return Result(metrics={}, error=RuntimeError(
                "no worker produced a model"))
        evals = results[0][1]
        metrics = {f"{ds}/{k}": v[-1] for ds, series in evals.items()
                   for k, v in series.items() if v}
        checkpoint = Checkpoint.from_dict({
            MODEL_KEY: model, BACKEND_KEY: self._backend_name,
            "feature_cols": feature_cols})
        return Result(metrics=metrics, checkpoint=checkpoint)


class XGBoostTrainer(GBDTTrainer):
    """Reference `python/ray/train/xgboost/xgboost_trainer.py:17`."""

    _backend_name = "xgboost"


class LightGBMTrainer(GBDTTrainer):
    """Reference `python/ray/train/lightgbm/lightgbm_trainer.py`."""

    _backend_name = "lightgbm"


# --------------------------------------------------------------- predictor


class GBDTPredictor:
    """Predicts with a serialized booster from a GBDT checkpoint
    (reference xgboost_predictor.py / lightgbm_predictor.py)."""

    def __init__(self, model_bytes: bytes, backend_name: str,
                 feature_cols: Optional[List[str]] = None):
        self._model = model_bytes
        self._backend = _BACKENDS[backend_name]
        self._feature_cols = feature_cols

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint) -> "GBDTPredictor":
        data = checkpoint.to_dict()
        return cls(data[MODEL_KEY], data[BACKEND_KEY],
                   data.get("feature_cols"))

    def predict(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        if self._feature_cols is not None and all(
                c in batch for c in self._feature_cols):
            cols = [np.asarray(batch[c]) for c in self._feature_cols]
        else:
            cols = [np.asarray(v) for v in batch.values()]
        X = np.stack(cols, axis=1) if cols[0].ndim == 1 else cols[0]
        return {"predictions": self._backend.predict(self._model, X)}


XGBoostPredictor = GBDTPredictor
LightGBMPredictor = GBDTPredictor
