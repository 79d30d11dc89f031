"""Adaptive search algorithms: random, TPE, and GP Bayesian optimization.

Mirrors the reference's searcher plugins (`python/ray/tune/search/`:
basic_variant, hyperopt, bayesopt, ...) behind one `Searcher` protocol —
`suggest(trial_id) -> config | None` and
`on_trial_complete(trial_id, result)` — driven adaptively by the
TrialRunner. The reference delegates TPE to hyperopt and GP-EI to
scikit-optimize; this build implements both natively in numpy (no
external searcher deps in the image), same algorithmic content:

- TPESearcher: Tree-structured Parzen Estimator (Bergstra et al. 2011) —
  split observations into good/bad by quantile, model each per-dimension
  with a KDE, pick the candidate maximizing l(x)/g(x).
- BayesOptSearcher: Gaussian-process regression (RBF kernel, Cholesky
  solve) with Expected Improvement acquisition over random candidates.
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.tune.search import (
    Choice, Domain, LogUniform, RandInt, Uniform, _GridSearch)


class Searcher:
    """suggest/observe protocol (reference `search/searcher.py`)."""

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]]) -> None:
        pass


def _check_no_grid(space: Dict[str, Any]) -> None:
    for k, v in space.items():
        if isinstance(v, _GridSearch):
            raise ValueError(
                f"grid_search ({k}) is not supported with adaptive searchers; "
                "use the default variant generator")


class RandomSearcher(Searcher):
    """Independent random sampling of every Domain (basic_variant without
    grid crossing)."""

    def __init__(self, space: Dict[str, Any], seed: int = 0):
        _check_no_grid(space)
        self.space = dict(space)
        self._rng = random.Random(seed)

    def suggest(self, trial_id: str) -> Dict[str, Any]:
        return {k: v.sample(self._rng) if isinstance(v, Domain) else v
                for k, v in self.space.items()}


class ConcurrencyLimiter(Searcher):
    """Caps in-flight suggestions (reference `search/concurrency_limiter.py`)."""

    def __init__(self, searcher: Searcher, max_concurrent: int):
        self.searcher = searcher
        self.max_concurrent = max_concurrent
        self._live: set = set()

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if len(self._live) >= self.max_concurrent:
            return None
        cfg = self.searcher.suggest(trial_id)
        if cfg is not None:
            self._live.add(trial_id)
        return cfg

    def on_trial_complete(self, trial_id, result) -> None:
        self._live.discard(trial_id)
        self.searcher.on_trial_complete(trial_id, result)


class _HistorySearcher(Searcher):
    """Shared bookkeeping: completed (config, score) pairs, maximize-internal
    score convention, random fallback for unsupported dims."""

    def __init__(self, space: Dict[str, Any], metric: str = "score",
                 mode: str = "max", n_startup: int = 8, seed: int = 0):
        _check_no_grid(space)
        self.space = dict(space)
        self.metric = metric
        self.mode = mode
        self.n_startup = n_startup
        self._rng = random.Random(seed)
        self._np_rng = np.random.default_rng(seed)
        self._history: List[Tuple[Dict[str, Any], float]] = []
        self._pending: Dict[str, Dict[str, Any]] = {}

    def on_trial_complete(self, trial_id, result) -> None:
        cfg = self._pending.pop(trial_id, None)
        if cfg is None or not result or self.metric not in result:
            return
        score = float(result[self.metric])
        if self.mode == "min":
            score = -score
        if math.isfinite(score):
            self._history.append((cfg, score))

    def _random_config(self) -> Dict[str, Any]:
        return {k: v.sample(self._rng) if isinstance(v, Domain) else v
                for k, v in self.space.items()}

    def suggest(self, trial_id: str) -> Dict[str, Any]:
        if len(self._history) < self.n_startup:
            cfg = self._random_config()
        else:
            cfg = self._model_suggest()
        self._pending[trial_id] = cfg
        return cfg

    def _model_suggest(self) -> Dict[str, Any]:
        raise NotImplementedError


def _to_unit(v: float, dom: Domain) -> float:
    """Map a domain value into [0,1] (log-warped for LogUniform)."""
    if isinstance(dom, LogUniform):
        return (math.log(v) - math.log(dom.low)) / (
            math.log(dom.high) - math.log(dom.low))
    if isinstance(dom, Uniform):
        return (v - dom.low) / (dom.high - dom.low)
    if isinstance(dom, RandInt):
        return (v - dom.low) / max(1, dom.high - 1 - dom.low)
    raise TypeError(dom)


def _from_unit(u: float, dom: Domain):
    u = min(1.0, max(0.0, u))
    if isinstance(dom, LogUniform):
        return math.exp(math.log(dom.low)
                        + u * (math.log(dom.high) - math.log(dom.low)))
    if isinstance(dom, Uniform):
        return dom.low + u * (dom.high - dom.low)
    if isinstance(dom, RandInt):
        return int(round(dom.low + u * max(0, dom.high - 1 - dom.low)))
    raise TypeError(dom)


_NUMERIC = (Uniform, LogUniform, RandInt)


class TPESearcher(_HistorySearcher):
    """Per-dimension TPE: numeric dims via Gaussian KDE over the good/bad
    split, categorical dims via smoothed counts."""

    def __init__(self, space, metric="score", mode="max", n_startup=8,
                 gamma: float = 0.25, n_candidates: int = 24, seed: int = 0):
        super().__init__(space, metric, mode, n_startup, seed)
        self.gamma = gamma
        self.n_candidates = n_candidates

    @staticmethod
    def _kde_logpdf(x: np.ndarray, samples: np.ndarray) -> np.ndarray:
        n = len(samples)
        bw = max(1e-3, float(np.std(samples)) * n ** -0.2 + 1e-3)
        # log mean of gaussians centered at samples
        z = (x[:, None] - samples[None, :]) / bw
        log_k = -0.5 * z**2 - math.log(bw * math.sqrt(2 * math.pi))
        m = log_k.max(axis=1)
        return m + np.log(np.exp(log_k - m[:, None]).mean(axis=1))

    def _model_suggest(self) -> Dict[str, Any]:
        hist = sorted(self._history, key=lambda cs: -cs[1])
        n_good = max(1, int(self.gamma * len(hist)))
        good, bad = hist[:n_good], hist[n_good:] or hist[-1:]
        cfg: Dict[str, Any] = {}
        for k, dom in self.space.items():
            if not isinstance(dom, Domain):
                cfg[k] = dom
                continue
            if isinstance(dom, Choice):
                # smoothed categorical l/g ratio
                opts = dom.options
                g_counts = np.ones(len(opts))
                b_counts = np.ones(len(opts))
                for c, _ in good:
                    g_counts[opts.index(c[k])] += 1
                for c, _ in bad:
                    b_counts[opts.index(c[k])] += 1
                ratio = (g_counts / g_counts.sum()) / (b_counts / b_counts.sum())
                cfg[k] = opts[int(np.argmax(ratio))]
                continue
            if isinstance(dom, _NUMERIC):
                g = np.array([_to_unit(c[k], dom) for c, _ in good])
                b = np.array([_to_unit(c[k], dom) for c, _ in bad])
                # candidates drawn from the good KDE
                centers = self._np_rng.choice(g, size=self.n_candidates)
                bw = max(1e-3, float(np.std(g)) * len(g) ** -0.2 + 1e-3)
                cand = np.clip(
                    centers + self._np_rng.normal(0, bw, self.n_candidates),
                    0.0, 1.0)
                score = self._kde_logpdf(cand, g) - self._kde_logpdf(cand, b)
                cfg[k] = _from_unit(float(cand[int(np.argmax(score))]), dom)
                continue
            cfg[k] = dom.sample(self._rng)
        return cfg


class BayesOptSearcher(_HistorySearcher):
    """GP-EI over the numeric dims (RBF kernel, unit-cube warp); categorical
    dims fall back to random sampling, like the reference's bayesopt
    integration which only handles box domains."""

    def __init__(self, space, metric="score", mode="max", n_startup=8,
                 n_candidates: int = 256, length_scale: float = 0.2,
                 noise: float = 1e-4, xi: float = 0.01, seed: int = 0):
        super().__init__(space, metric, mode, n_startup, seed)
        self.n_candidates = n_candidates
        self.length_scale = length_scale
        self.noise = noise
        self.xi = xi
        self._num_keys = [k for k, v in space.items()
                          if isinstance(v, _NUMERIC)]

    def _model_suggest(self) -> Dict[str, Any]:
        if not self._num_keys:
            return self._random_config()
        X = np.array([[_to_unit(c[k], self.space[k]) for k in self._num_keys]
                      for c, _ in self._history])
        y = np.array([s for _, s in self._history])
        y_mean, y_std = float(y.mean()), float(y.std()) + 1e-9
        yn = (y - y_mean) / y_std

        def rbf(A, B):
            d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
            return np.exp(-0.5 * d2 / self.length_scale**2)

        K = rbf(X, X) + self.noise * np.eye(len(X))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))

        cand = self._np_rng.uniform(0, 1, (self.n_candidates, len(self._num_keys)))
        Ks = rbf(cand, X)
        mu = Ks @ alpha
        v = np.linalg.solve(L, Ks.T)
        var = np.maximum(1e-12, 1.0 - (v**2).sum(axis=0))
        sigma = np.sqrt(var)
        best = yn.max()
        # expected improvement
        z = (mu - best - self.xi) / sigma
        Phi = 0.5 * (1 + np.vectorize(math.erf)(z / math.sqrt(2)))
        phi = np.exp(-0.5 * z**2) / math.sqrt(2 * math.pi)
        ei = (mu - best - self.xi) * Phi + sigma * phi
        x = cand[int(np.argmax(ei))]

        cfg = self._random_config()  # categorical/constant dims
        for i, k in enumerate(self._num_keys):
            cfg[k] = _from_unit(float(x[i]), self.space[k])
        return cfg


class TuneBOHB(TPESearcher):
    """BOHB's model component (Falkner et al. 2018; reference
    `python/ray/tune/search/bohb/`): a TPE fit only on results from the
    LARGEST budget that has enough observations, falling back to pooled
    history before that. Pair with `BOHBScheduler` (HyperBand brackets) for
    the full algorithm — the scheduler allocates budgets, this model picks
    configs."""

    def __init__(self, space, metric="score", mode="max", n_startup=8,
                 budget_attr: str = "training_iteration",
                 min_points: Optional[int] = None, **kw):
        self._full_history: List[Tuple[Dict[str, Any], float, float]] = []
        self._budget_attr = budget_attr
        self._min_points = min_points or max(len(space) + 1, 4)
        super().__init__(space, metric, mode, n_startup, **kw)

    def on_trial_complete(self, trial_id, result) -> None:
        cfg = self._pending.pop(trial_id, None)
        if cfg is None or not result or self.metric not in result:
            return
        score = float(result[self.metric])
        if self.mode == "min":
            score = -score
        if math.isfinite(score):
            budget = float(result.get(self._budget_attr, 1))
            self._full_history.append((cfg, score, budget))
        self._refresh()

    def _refresh(self) -> None:
        by_budget: Dict[float, List[Tuple[Dict[str, Any], float]]] = {}
        for cfg, score, b in self._full_history:
            by_budget.setdefault(b, []).append((cfg, score))
        for b in sorted(by_budget, reverse=True):
            if len(by_budget[b]) >= self._min_points:
                self._history = by_budget[b]
                return
        self._history = [(c, s) for c, s, _ in self._full_history]
