"""Trial schedulers: FIFO, ASHA, PBT.

Reference mechanics replicated (SURVEY appendix K):
  - ASHA (`python/ray/tune/schedulers/async_hyperband.py:17`): rungs at
    r, r*eta, r*eta^2, ...; at each rung keep the top 1/eta of recorded
    results and stop trials below the cutoff (`on_trial_result:138`).
  - PBT (`python/ray/tune/schedulers/pbt.py`): every perturbation_interval,
    bottom-quantile trials exploit (clone a top-quantile trial's checkpoint)
    then explore (mutate hyperparams; `_explore:48`): both rest on the
    Trainable save/restore contract, which the trial actor provides.
"""

from __future__ import annotations

import random
import statistics
from typing import Any, Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


class FIFOScheduler:
    def on_trial_result(self, runner, trial, result) -> str:
        return CONTINUE


class ASHAScheduler:
    def __init__(self, metric: str = "score", mode: str = "max",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 4, time_attr: str = "training_iteration"):
        self.metric = metric
        self.mode = mode
        self.time_attr = time_attr
        self.max_t = max_t
        self.rf = reduction_factor
        # rung milestones: grace, grace*rf, grace*rf^2 ... < max_t
        self.rungs: List[int] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(t)
            t *= reduction_factor
        self._rung_results: Dict[int, List[float]] = {r: [] for r in self.rungs}

    def _val(self, result) -> float:
        v = float(result[self.metric])
        return v if self.mode == "max" else -v

    def on_trial_result(self, runner, trial, result) -> str:
        t = int(result.get(self.time_attr, 0))
        if t >= self.max_t:
            return STOP
        if self.metric not in result:
            return CONTINUE  # checkpoint-only / heterogeneous report
        # Record the trial's value at the highest rung it has crossed.
        for rung in reversed(self.rungs):
            if t >= rung and rung not in trial.rung_values:
                trial.rung_values[rung] = self._val(result)
                self._rung_results[rung].append(trial.rung_values[rung])
                break
        # Re-evaluate the trial's highest recorded rung on EVERY report, not
        # just at the crossing (`async_hyperband.py:138`): under lockstep
        # execution the first reporter lands in an empty rung and would never
        # see a cutoff. Comparing recorded same-rung values is the
        # synchronous-ASHA criterion — fair across trials at equal budget.
        if trial.rung_values:
            rung = max(trial.rung_values)
            recorded = self._rung_results[rung]
            if len(recorded) >= self.rf:
                keep = max(1, len(recorded) // self.rf)
                cutoff = sorted(recorded, reverse=True)[keep - 1]
                if trial.rung_values[rung] < cutoff:
                    return STOP
        return CONTINUE


class PopulationBasedTraining:
    def __init__(self, metric: str = "score", mode: str = "max",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25, seed: int = 0,
                 time_attr: str = "training_iteration"):
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.time_attr = time_attr
        self._rng = random.Random(seed)

    def _score(self, trial) -> float:
        v = trial.last_result.get(self.metric)
        if v is None:
            return float("-inf")
        return float(v) if self.mode == "max" else -float(v)

    def on_trial_result(self, runner, trial, result) -> str:
        t = int(result.get(self.time_attr, 0))
        if t - trial.last_perturb < self.interval:
            return CONTINUE
        trial.last_perturb = t
        trials = [tr for tr in runner.trials if tr.last_result]
        if len(trials) < 2:
            return CONTINUE
        ranked = sorted(trials, key=self._score, reverse=True)
        k = max(1, int(len(ranked) * self.quantile))
        top, bottom = ranked[:k], ranked[-k:]
        if trial in bottom and trial not in top:
            donor = self._rng.choice(top)
            new_config = self._explore(dict(donor.config))
            runner.exploit(trial, donor, new_config)
        return CONTINUE

    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        """Mutate each listed hyperparam (reference pbt.py `_explore:48`):
        resample from a domain/list, or scale numeric values by 0.8/1.2."""
        from ray_tpu_torch.tune.search import Domain

        for key, spec in self.mutations.items():
            if key not in config:
                continue
            if isinstance(spec, Domain):
                config[key] = spec.sample(self._rng)
            elif isinstance(spec, list):
                config[key] = self._rng.choice(spec)
            elif callable(spec):
                config[key] = spec()
            else:
                factor = self._rng.choice([0.8, 1.2])
                config[key] = type(config[key])(config[key] * factor)
        return config


class MedianStoppingRule:
    """Stop a trial at step t when its running-average metric falls below
    the median of other trials' running averages at comparable steps
    (reference `schedulers/median_stopping_rule.py`)."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 grace_period: int = 4, min_samples_required: int = 3,
                 time_attr: str = "training_iteration"):
        self.metric = metric
        self.mode = mode
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self.time_attr = time_attr
        # trial_id -> (sum, count) of reported values
        self._running: Dict[str, List[float]] = {}

    def _val(self, result) -> Optional[float]:
        if self.metric not in result:
            return None
        v = float(result[self.metric])
        return v if self.mode == "max" else -v

    def on_trial_result(self, runner, trial, result) -> str:
        v = self._val(result)
        if v is None:
            return CONTINUE
        acc = self._running.setdefault(trial.trial_id, [0.0, 0])
        acc[0] += v
        acc[1] += 1
        t = int(result.get(self.time_attr, 0))
        if t < self.grace_period:
            return CONTINUE
        others = [s / c for tid, (s, c) in self._running.items()
                  if tid != trial.trial_id and c > 0]
        if len(others) < self.min_samples:
            return CONTINUE
        median = statistics.median(others)
        my_avg = acc[0] / acc[1]
        return STOP if my_avg < median else CONTINUE


class HyperBandScheduler:
    """Bracketed successive halving: trials are assigned round-robin to
    brackets with staggered grace periods (the HyperBand s-sweep,
    reference `schedulers/hyperband.py`), and each bracket runs the ASHA
    halving rule at its own rung ladder — the asynchronous formulation of
    HyperBand the reference recommends in practice."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 max_t: int = 81, reduction_factor: int = 3,
                 num_brackets: int = 3,
                 time_attr: str = "training_iteration"):
        self.brackets = []
        grace = 1
        for _ in range(max(1, num_brackets)):
            self.brackets.append(ASHAScheduler(
                metric=metric, mode=mode, max_t=max_t,
                grace_period=grace, reduction_factor=reduction_factor,
                time_attr=time_attr))
            grace *= reduction_factor
        self._assignment: Dict[str, int] = {}
        self._next = 0

    def _bracket_for(self, trial) -> "ASHAScheduler":
        idx = self._assignment.get(trial.trial_id)
        if idx is None:
            idx = self._next % len(self.brackets)
            self._assignment[trial.trial_id] = idx
            self._next += 1
        return self.brackets[idx]

    def on_trial_result(self, runner, trial, result) -> str:
        return self._bracket_for(trial).on_trial_result(runner, trial, result)


class PB2(PopulationBasedTraining):
    """Population Based Bandits (Parker-Holder et al. 2020; reference
    `python/ray/tune/schedulers/pb2.py`): PBT where *explore* is not a
    random perturbation but a GP-bandit suggestion. A small RBF-kernel GP is
    fit on (normalized hyperparams -> recent reward improvement) across the
    population's history, and the next config maximizes UCB over sampled
    candidates inside `hyperparam_bounds`.
    """

    def __init__(self, metric: str = "score", mode: str = "max",
                 perturbation_interval: int = 4,
                 hyperparam_bounds: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25, seed: int = 0,
                 time_attr: str = "training_iteration",
                 ucb_kappa: float = 2.0, n_candidates: int = 64):
        super().__init__(metric=metric, mode=mode,
                         perturbation_interval=perturbation_interval,
                         hyperparam_mutations={},
                         quantile_fraction=quantile_fraction, seed=seed,
                         time_attr=time_attr)
        self.bounds = {k: (float(lo), float(hi))
                       for k, (lo, hi) in (hyperparam_bounds or {}).items()}
        self.kappa = ucb_kappa
        self.n_candidates = n_candidates
        # (normalized config vector, reward delta) observations
        self._obs_x: List[List[float]] = []
        self._obs_y: List[float] = []
        self._last_scores: Dict[str, float] = {}  # trial_id -> last score

    def _normalize(self, config: Dict[str, Any]) -> List[float]:
        return [(float(config[k]) - lo) / max(hi - lo, 1e-12)
                for k, (lo, hi) in self.bounds.items()]

    def on_trial_result(self, runner, trial, result) -> str:
        import math

        # record the reward delta for the GP before the PBT bookkeeping;
        # results without the metric (checkpoint-only) are skipped like in
        # the other schedulers
        score = self._score(trial) if trial.last_result else None
        if score is not None and math.isfinite(score) and \
                all(k in trial.config for k in self.bounds):
            prev = self._last_scores.get(trial.trial_id)
            if prev is not None:
                self._obs_x.append(self._normalize(trial.config))
                self._obs_y.append(score - prev)
            self._last_scores[trial.trial_id] = score
        config_before = trial.config
        decision = super().on_trial_result(runner, trial, result)
        if trial.config is not config_before:
            # exploited: the next score comes from the donor's checkpoint,
            # not this config — don't credit the jump to the new coords
            self._last_scores.pop(trial.trial_id, None)
        return decision

    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        import numpy as np

        if len(self._obs_y) < 3:  # cold start: uniform in bounds
            for k, (lo, hi) in self.bounds.items():
                config[k] = type(config.get(k, lo))(
                    lo + self._rng.random() * (hi - lo))
            return config

        X = np.asarray(self._obs_x[-100:])
        y = np.asarray(self._obs_y[-100:])
        y = (y - y.mean()) / (y.std() + 1e-9)

        def kern(a, b):
            d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
            return np.exp(-d2 / (2 * 0.2 ** 2))

        K = kern(X, X) + 1e-4 * np.eye(len(X))
        K_inv = np.linalg.inv(K)
        cand = np.asarray([[self._rng.random() for _ in self.bounds]
                           for _ in range(self.n_candidates)])
        Ks = kern(cand, X)
        mu = Ks @ K_inv @ y
        var = np.clip(1.0 - (Ks * (Ks @ K_inv)).sum(-1), 1e-9, None)
        best = cand[int(np.argmax(mu + self.kappa * np.sqrt(var)))]
        for i, (k, (lo, hi)) in enumerate(self.bounds.items()):
            config[k] = type(config.get(k, lo))(lo + best[i] * (hi - lo))
        return config


class BOHBScheduler(HyperBandScheduler):
    """HyperBand bracket allocation for BOHB (reference
    `schedulers/hb_bohb.py HyperBandForBOHB`): identical rung/halting
    mechanics; the model-based half lives in `searchers.TuneBOHB`, which
    fits its TPE on the highest budget with enough completed results — the
    combination reproduces BOHB's behavior under this framework's
    asynchronous trial runner."""
