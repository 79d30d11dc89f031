"""Tuner + TrialRunner: experiment execution over trial actors.

Mirrors the reference's anatomy (`python/ray/tune/tuner.py:53,340` ->
`TrialRunner.step` loop `execution/trial_runner.py:1178,1355` ->
`RayTrialExecutor` launching each trial as an actor). Each trial is a
`_TrialActor` running the user function with a tune session; the runner
polls `next_result` futures, feeds results to the scheduler, and stops /
exploits trials per its decisions. PBT exploit = save donor checkpoint,
kill the trial actor, restart it with the mutated config and the donor's
checkpoint — exactly the Trainable save/restore contract the reference's
schedulers rely on (SURVEY §K).

On the GPU: `resources_per_trial={"GPU": f}` grants each trial actor `f`
of a card (`num_gpus=f`, fractions included). The trial's own thread makes
its grant's first card current before the user function runs, as the
runtime does for each task and actor call; a trial granted no GPU never
touches CUDA. Results leave a trial with tensor scalars as Python numbers,
and checkpoints cross to this driver with their CUDA tensors as CPU
tensors (`air.Checkpoint`), so the driver, which holds no card, never
receives a CUDA tensor.
"""

from __future__ import annotations

import logging
import queue as _queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set

import ray_tpu_torch
from ray_tpu_torch.air.checkpoint import Checkpoint, host_metrics
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.tune import session as tune_session
from ray_tpu_torch.tune.stopper import Stopper, make_stopper


def _restored_stop(spec):
    if isinstance(spec, Stopper):
        spec.reset()
    return spec
from ray_tpu_torch.tune.schedulers import CONTINUE, FIFOScheduler, STOP
from ray_tpu_torch.tune.search import generate_configs

logger = logging.getLogger(__name__)


@ray_tpu_torch.remote
class _TrialActor:
    """Hosts one trial; the user function runs on a private thread and its
    reports stream out through `next_result` (max_concurrency=2 so control
    calls interleave with the blocking poll)."""

    def __init__(self, fn: Callable, config: Dict[str, Any],
                 checkpoint: Optional[Checkpoint],
                 start_iteration: int = 0):
        # the card this worker was granted: a new thread starts on card 0,
        # so the trainable's thread makes it current itself
        self._gpu_ids = ray_tpu_torch.get_gpu_ids()
        self._fn = fn
        self._config = config
        self._reports: "_queue.Queue" = _queue.Queue()
        self._last_checkpoint = checkpoint
        # retried/restored trials CONTINUE the iteration clock: resetting it
        # would corrupt time-based scheduler decisions (ASHA max_t, PBT
        # perturbation intervals) and collide history entries
        self._iteration = start_iteration
        self._done = False
        self._error: Optional[str] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        from ray_tpu_torch.core.worker import _select_granted_gpu

        def report_fn(metrics, ckpt):
            if ckpt is not None:
                self._last_checkpoint = ckpt
            self._iteration += 1
            m = host_metrics(metrics)
            m["training_iteration"] = self._iteration
            if ckpt is not None:
                # the runner needs mid-flight checkpoints for trial retries
                # and durable experiment snapshots, not just at trial end
                m["__checkpoint__"] = ckpt
            self._reports.put(m)

        tune_session._set(report_fn, self._last_checkpoint)
        try:
            _select_granted_gpu(self._gpu_ids)
            self._fn(self._config)
        except Exception:
            self._error = traceback.format_exc()
        finally:
            tune_session._clear()
            self._done = True
            self._reports.put(None)  # sentinel

    def next_result(self):
        item = self._reports.get()
        if item is None:
            return {"__done__": True, "__error__": self._error}
        return item

    def save(self):
        return self._last_checkpoint

    def config(self):
        return self._config


@dataclass
class Trial:
    trial_id: str
    config: Dict[str, Any]
    state: str = "PENDING"            # PENDING/RUNNING/TERMINATED/ERROR
    actor: Any = None
    pending: Any = None               # in-flight next_result ref
    last_result: Dict[str, Any] = field(default_factory=dict)
    last_checkpoint: Optional[Checkpoint] = None
    error: Optional[str] = None
    num_failures: int = 0             # FailureConfig retry accounting
    rung_values: Dict[int, float] = field(default_factory=dict)  # ASHA bookkeeping
    last_perturb: int = 0                               # PBT bookkeeping
    history: List[Dict[str, Any]] = field(default_factory=list)

    def snapshot(self) -> Dict[str, Any]:
        """Durable view (no actor handles / refs)."""
        return {
            "trial_id": self.trial_id, "config": self.config,
            "state": self.state, "last_result": self.last_result,
            "last_checkpoint": self.last_checkpoint, "error": self.error,
            "num_failures": self.num_failures,
            "rung_values": self.rung_values,
            "last_perturb": self.last_perturb, "history": self.history,
        }

    @classmethod
    def from_snapshot(cls, snap: Dict[str, Any],
                      resume_errored: bool = False) -> "Trial":
        t = cls(trial_id=snap["trial_id"], config=snap["config"])
        t.last_result = snap.get("last_result", {})
        t.last_checkpoint = snap.get("last_checkpoint")
        t.error = snap.get("error")
        t.num_failures = snap.get("num_failures", 0)
        t.rung_values = snap.get("rung_values", {})
        t.last_perturb = snap.get("last_perturb", 0)
        t.history = snap.get("history", [])
        state = snap["state"]
        if state == "RUNNING":
            state = "PENDING"  # the crashed driver's in-flight trials re-run
        elif state == "ERROR" and resume_errored:
            state, t.error = "PENDING", None
        t.state = state
        return t


@dataclass
class TuneConfig:
    num_samples: int = 1
    max_concurrent_trials: int = 4
    metric: str = "score"
    mode: str = "max"
    scheduler: Any = None
    search_alg: Any = None            # Searcher (tune.searchers); None = variants
    resources_per_trial: Optional[Dict[str, float]] = None
    seed: int = 0


class ResultGrid:
    def __init__(self, results: List[Result],
                 default_metric: str = "score",
                 default_mode: str = "max"):
        self._results = results
        self._default_metric = default_metric
        self._default_mode = default_mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        """Defaults to the TuneConfig's metric/mode (reference ResultGrid)."""
        metric = metric or self._default_metric
        mode = mode or self._default_mode
        scored = [r for r in self._results if metric in r.metrics]
        if not scored:
            raise ValueError(f"no trial reported metric '{metric}'")
        return (max if mode == "max" else min)(
            scored, key=lambda r: r.metrics[metric])

    @property
    def errors(self):
        return [r.error for r in self._results if r.error]


def _trials_running_gauge():
    from ray_tpu_torch.util.metrics import get_or_create

    return get_or_create("gauge", "ray_tpu_torch_tune_trials_running",
                         "trials currently running")


class TrialRunner:
    def __init__(self, fn: Callable, configs: List[Dict[str, Any]],
                 tune_config: TuneConfig,
                 experiment_dir: Optional[str] = None,
                 failure_config=None,
                 restored_trials: Optional[List[Trial]] = None,
                 stopper=None, stop_spec=None, callbacks=None):
        from ray_tpu_torch.tune.callback import CallbackList

        self.callbacks = (callbacks if isinstance(callbacks, CallbackList)
                          else CallbackList(callbacks))
        self.fn = fn
        if restored_trials is not None:
            self.trials = restored_trials
        else:
            self.trials = [Trial(trial_id=f"trial_{i:05d}", config=c)
                           for i, c in enumerate(configs)]
        self.cfg = tune_config
        self.scheduler = tune_config.scheduler or FIFOScheduler()
        self.searcher = tune_config.search_alg
        # with a searcher, trials are created adaptively up to num_samples
        self._target = (tune_config.num_samples if self.searcher is not None
                        else len(self.trials))
        self.experiment_dir = experiment_dir
        self.failure_config = failure_config
        self.stopper = stopper
        # raw RunConfig.stop, persisted so Tuner.restore re-arms the same
        # criteria (stateful stopper WINDOWS reset; criteria do not)
        self.stop_spec = stop_spec
        self._last_snapshot = 0.0
        # persisted-checkpoint cache: trial_id -> (id of in-memory ckpt,
        # directory-backed Checkpoint written under the experiment dir)
        self._persisted_ckpts: Dict[str, Any] = {}

    # -------------------------------------------------- experiment state
    SNAPSHOT_FILE = "experiment_state.pkl"
    _SNAPSHOT_PERIOD_S = 1.0

    def _snapshot(self, force: bool = False) -> None:
        """Durable experiment state (reference
        tune/execution/experiment_state.py): trial table + searcher +
        scheduler, written atomically so a driver crash at any instant
        leaves a loadable file. Restore completes the sweep without
        re-running finished trials (Tuner.restore)."""
        if self.experiment_dir is None:
            return
        now = time.monotonic()
        if not force and now - self._last_snapshot < self._SNAPSHOT_PERIOD_S:
            return
        self._last_snapshot = now
        import os
        import cloudpickle

        trials = []
        for t in self.trials:
            snap = t.snapshot()
            # snapshots reference checkpoint DIRECTORIES, not payloads: a
            # sweep checkpointing large model states must not rewrite every
            # byte of every trial's checkpoint into the state file each
            # second (reference persists paths the same way)
            snap["last_checkpoint"] = self._persist_checkpoint(t)
            trials.append(snap)
        state = {
            "trials": trials,
            # the whole TuneConfig rides along (scheduler + searcher state
            # included), so restore resumes mid-sweep search/scheduling
            "tune_config": self.cfg,
            "scheduler": self.scheduler,
            "failure_config": self.failure_config,
            "stop": self.stop_spec,
            "target": self._target,
        }
        os.makedirs(self.experiment_dir, exist_ok=True)
        path = os.path.join(self.experiment_dir, self.SNAPSHOT_FILE)
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                cloudpickle.dump(state, f)
            os.replace(tmp, path)
        except Exception:
            logger.exception("experiment snapshot failed")

    def _persist_checkpoint(self, trial: Trial):
        """Write a trial's in-memory checkpoint under the experiment dir
        once per distinct checkpoint; return the directory-backed handle
        for the snapshot (already-on-disk checkpoints pass through)."""
        import os
        import shutil

        ck = trial.last_checkpoint
        if ck is None:
            return None
        if getattr(ck, "_directory", None):
            return ck  # already durable
        cached = self._persisted_ckpts.get(trial.trial_id)
        # identity via a STRONG reference, not id(): a freed checkpoint's
        # address can be reused by its successor, which must not cache-hit
        if cached is not None and cached[0] is ck:
            return cached[1]
        path = os.path.join(self.experiment_dir, "checkpoints",
                            trial.trial_id)
        tmp = path + ".tmp"
        try:
            shutil.rmtree(tmp, ignore_errors=True)
            ck.to_directory(tmp)
            old = path + ".old"
            shutil.rmtree(old, ignore_errors=True)
            if os.path.exists(path):
                os.rename(path, old)
            os.rename(tmp, path)
            shutil.rmtree(old, ignore_errors=True)
        except Exception:
            logger.exception("checkpoint persist failed for %s",
                             trial.trial_id)
            return ck  # fall back to pickling the payload
        persisted = Checkpoint.from_directory(path)
        self._persisted_ckpts[trial.trial_id] = (ck, persisted)
        return persisted

    @classmethod
    def load_snapshot(cls, experiment_dir: str) -> Dict[str, Any]:
        import os
        import cloudpickle

        with open(os.path.join(experiment_dir, cls.SNAPSHOT_FILE), "rb") as f:
            return cloudpickle.load(f)

    def _maybe_suggest_trials(self) -> None:
        """Ask the searcher for new configs while slots are free."""
        if self.searcher is None:
            return
        running = sum(1 for t in self.trials if t.state == "RUNNING")
        pending = sum(1 for t in self.trials if t.state == "PENDING")
        while (len(self.trials) < self._target
               and running + pending < self.cfg.max_concurrent_trials):
            trial_id = f"trial_{len(self.trials):05d}"
            config = self.searcher.suggest(trial_id)
            if config is None:
                break  # e.g. ConcurrencyLimiter saturated
            self.trials.append(Trial(trial_id=trial_id, config=config))
            pending += 1

    # ----------------------------------------------------------- lifecycle
    def _start_trial(self, trial: Trial,
                     checkpoint: Optional[Checkpoint] = None) -> None:
        opts = {"max_concurrency": 2}
        if self.cfg.resources_per_trial:
            opts["resources"] = dict(self.cfg.resources_per_trial)
        else:
            opts["num_cpus"] = 1
        trial.actor = _TrialActor.options(**opts).remote(
            self.fn, trial.config, checkpoint or trial.last_checkpoint,
            trial.last_result.get("training_iteration", 0))
        trial.state = "RUNNING"
        trial.pending = trial.actor.next_result.remote()
        self.callbacks.on_trial_start(trial)

    def _stop_trial(self, trial: Trial, state: str = "TERMINATED") -> None:
        trial.state = state
        trial.pending = None
        if trial.actor is not None:
            try:
                ray_tpu_torch.kill(trial.actor)
            except (ValueError, RuntimeError, OSError):
                pass  # actor already dead / runtime shutting down
            trial.actor = None
        if state == "TERMINATED":
            self.callbacks.on_trial_complete(trial)
        elif state == "ERROR":
            self.callbacks.on_trial_error(trial)

    def exploit(self, trial: Trial, donor: Trial, new_config: Dict[str, Any]) -> None:
        """PBT: clone donor's checkpoint into `trial` and restart it with the
        mutated config."""
        try:
            ckpt = ray_tpu_torch.get(donor.actor.save.remote(), timeout=30) \
                if donor.actor is not None else donor.last_checkpoint
        except Exception:
            ckpt = donor.last_checkpoint
        logger.info("PBT exploit: %s <- %s", trial.trial_id, donor.trial_id)
        self._stop_trial(trial, state="PENDING")
        trial.config = new_config
        trial.last_checkpoint = ckpt
        trial.rung_values = {}

    # ----------------------------------------------------------- main loop
    def run(self) -> None:
        self.callbacks.setup(self.experiment_dir)
        try:
            self._run_loop()
        finally:
            self.callbacks.on_experiment_end(self.trials)

    def _run_loop(self) -> None:
        idle_retries = 0
        while True:
            if self.stopper is not None and self.stopper.stop_all():
                for t in list(self.trials):
                    if t.state in ("RUNNING", "PENDING"):
                        self._finalize_checkpoint(t)
                        self._stop_trial(t, "TERMINATED")
                self._snapshot(force=True)
                return
            self._maybe_suggest_trials()
            running = [t for t in self.trials if t.state == "RUNNING"]
            pending = [t for t in self.trials if t.state == "PENDING"]
            _trials_running_gauge().set(float(len(running)))
            if not running and not pending:
                if (self.searcher is not None
                        and len(self.trials) < self._target
                        and idle_retries < 100):
                    # searcher declined to suggest right now (limiter); retry
                    idle_retries += 1
                    time.sleep(0.02)
                    continue
                self._snapshot(force=True)
                return
            idle_retries = 0
            while pending and len(running) < self.cfg.max_concurrent_trials:
                t = pending.pop(0)
                self._start_trial(t)
                running.append(t)
            refs = [t.pending for t in running if t.pending is not None]
            if not refs:
                time.sleep(0.02)
                continue
            done, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=1.0)
            for ref in done:
                trial = next(t for t in running if t.pending == ref)
                self._process(trial, ref)
            self._snapshot()

    def _fail_or_retry(self, trial: Trial, error: str) -> None:
        """FailureConfig(max_failures): a failed trial restarts from its
        last checkpoint while retry budget remains (reference
        tune trial-level fault tolerance, tune/tuner.py FailureConfig)."""
        budget = getattr(self.failure_config, "max_failures", 0) \
            if self.failure_config is not None else 0
        if trial.num_failures < budget:
            trial.num_failures += 1
            logger.warning("trial %s failed (%d/%d retries); restarting "
                           "from last checkpoint", trial.trial_id,
                           trial.num_failures, budget)
            self._stop_trial(trial, state="PENDING")
            return
        trial.error = error
        self._stop_trial(trial, "ERROR")
        self._notify_searcher(trial)

    def _process(self, trial: Trial, ref) -> None:
        try:
            result = ray_tpu_torch.get(ref)
        except Exception as e:
            self._fail_or_retry(trial, str(e))
            return
        if result.get("__done__"):
            if result.get("__error__"):
                self._fail_or_retry(trial, result["__error__"])
            else:
                self._finalize_checkpoint(trial)
                self._stop_trial(trial, "TERMINATED")
                self._notify_searcher(trial)
            return
        ckpt = result.pop("__checkpoint__", None)
        if ckpt is not None:
            trial.last_checkpoint = ckpt
            self.callbacks.on_checkpoint(trial, ckpt)
        trial.last_result = result
        trial.history.append(result)
        self.callbacks.on_trial_result(trial, result)
        if self.stopper is not None and self.stopper(trial.trial_id, result):
            # stop criteria trump the scheduler entirely: a trial at the
            # stop bar must terminate even if PBT would have exploited it
            # on this same result
            self._finalize_checkpoint(trial)
            self._stop_trial(trial, "TERMINATED")
            self._notify_searcher(trial)
            return
        decision = self.scheduler.on_trial_result(self, trial, result)
        if trial.state != "RUNNING":
            return  # scheduler exploited/restarted this trial
        if decision == STOP:
            self._finalize_checkpoint(trial)
            self._stop_trial(trial, "TERMINATED")
            self._notify_searcher(trial)
        else:
            trial.pending = trial.actor.next_result.remote()

    def _notify_searcher(self, trial: Trial) -> None:
        if self.searcher is not None:
            try:
                self.searcher.on_trial_complete(
                    trial.trial_id, trial.last_result or None)
            except Exception:
                logger.exception("searcher on_trial_complete failed")

    def _finalize_checkpoint(self, trial: Trial) -> None:
        if trial.actor is not None:
            try:
                ckpt = ray_tpu_torch.get(trial.actor.save.remote(), timeout=30)
                if ckpt is not None:
                    trial.last_checkpoint = ckpt
            except Exception:
                pass


class Tuner:
    """`Tuner(trainable, param_space=..., tune_config=...).fit()`
    (reference `python/ray/tune/tuner.py:53`).

    Experiment-level fault tolerance: with a `run_config`
    (`air.RunConfig(name=..., storage_path=...)`) the runner snapshots
    durable experiment state continuously, and `Tuner.restore(path,
    trainable)` resumes a crashed driver's sweep — finished trials keep
    their results without re-running, interrupted trials restart from
    their last checkpoints, and `FailureConfig(max_failures)` gives each
    trial a retry budget."""

    def __init__(self, trainable: Callable, *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config=None):
        self._fn = trainable
        self._space = dict(param_space or {})
        self._cfg = tune_config or TuneConfig()
        self._run_config = run_config
        self._restored_trials: Optional[List[Trial]] = None

    def experiment_dir(self) -> Optional[str]:
        import os
        import tempfile

        rc = self._run_config
        if rc is None:
            return None
        root = (getattr(rc, "storage_path", None)
                or os.path.join(tempfile.gettempdir(), "ray_tpu_torch_results"))
        name = getattr(rc, "name", None) or "tune_experiment"
        return os.path.join(os.path.expanduser(root), name)

    @classmethod
    def restore(cls, path: str, trainable: Callable, *,
                resume_errored: bool = False) -> "Tuner":
        """Resume a sweep from its experiment directory (reference
        `Tuner.restore`, tuner.py:53): finished trials are NOT re-run;
        PENDING/RUNNING (and, opted-in, ERRORED) trials resume from their
        last checkpoints; searcher and scheduler state carry over."""
        import os

        state = TrialRunner.load_snapshot(path)
        t = cls(trainable)
        t._cfg = state["tune_config"]
        t._cfg.scheduler = state["scheduler"]  # mid-sweep scheduler state
        t._cfg.num_samples = state.get("target", 1)
        from ray_tpu_torch.air.config import FailureConfig, RunConfig

        t._run_config = RunConfig(
            name=os.path.basename(path.rstrip("/")),
            storage_path=os.path.dirname(path.rstrip("/")),
            # the retry budget must survive the crash it exists for
            failure_config=state.get("failure_config") or FailureConfig(),
            # so must the stop criteria; stateful stopper internals
            # (plateau windows, armed deadlines) are explicitly reset
            stop=_restored_stop(state.get("stop")))
        t._restored_trials = [Trial.from_snapshot(s, resume_errored)
                              for s in state["trials"]]
        return t

    def fit(self) -> ResultGrid:
        if self._restored_trials is not None or self._cfg.search_alg is not None:
            # restored sweeps carry their trial table; adaptive search
            # creates every config through the searcher
            configs: List[Dict[str, Any]] = []
        else:
            configs = generate_configs(self._space, self._cfg.num_samples,
                                       self._cfg.seed)
        exp_dir = self.experiment_dir()
        callbacks = getattr(self._run_config, "callbacks", None)
        if exp_dir is not None:
            # User callbacks EXTEND the default loggers, not replace them
            # (reference tune: DEFAULT_LOGGERS are always installed unless a
            # logger of that kind is already present) — passing only, say,
            # WandbLoggerCallback must not silently drop progress.csv /
            # result.json / TB event files.
            from ray_tpu_torch.tune.logger import DEFAULT_LOGGERS

            callbacks = list(callbacks) if callbacks is not None else []
            callbacks += [cls() for cls in DEFAULT_LOGGERS
                          if not any(isinstance(cb, cls) for cb in callbacks)]
        runner = TrialRunner(
            self._fn, configs, self._cfg,
            experiment_dir=exp_dir,
            failure_config=getattr(self._run_config, "failure_config", None),
            stopper=make_stopper(getattr(self._run_config, "stop", None)),
            stop_spec=getattr(self._run_config, "stop", None),
            restored_trials=self._restored_trials,
            callbacks=callbacks)
        runner.run()
        results = []
        for t in runner.trials:
            err = RuntimeError(t.error) if t.error else None
            metrics = dict(t.last_result)
            metrics["config"] = t.config
            results.append(Result(metrics=metrics, checkpoint=t.last_checkpoint,
                                  error=err, metrics_history=t.history))
        return ResultGrid(results, default_metric=self._cfg.metric,
                          default_mode=self._cfg.mode)


def with_parameters(trainable: Callable, **kwargs):
    """Bind large constant objects to a trainable via the object store
    (reference `tune.with_parameters`): each bound value is `put()` once
    and every trial resolves the same ref instead of re-pickling the
    payload into each trial actor's spec."""
    refs = {k: ray_tpu_torch.put(v) for k, v in kwargs.items()}

    def wrapped(config):
        resolved = {k: ray_tpu_torch.get(r) for k, r in refs.items()}
        return trainable(config, **resolved)

    wrapped.__name__ = getattr(trainable, "__name__", "trainable")
    return wrapped
