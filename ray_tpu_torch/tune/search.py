"""Search spaces: grid + random distributions, resolved per sample.

Mirrors the reference's basic-variant generator
(`python/ray/tune/search/basic_variant.py`): `grid_search` values are
crossed; distribution objects are sampled per trial.
"""

from __future__ import annotations

import itertools
import random
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence


@dataclass
class _GridSearch:
    values: List[Any]


def grid_search(values: Sequence[Any]) -> _GridSearch:
    return _GridSearch(list(values))


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


@dataclass
class Uniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


@dataclass
class LogUniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))


@dataclass
class Choice(Domain):
    options: List[Any]

    def sample(self, rng):
        return rng.choice(self.options)


@dataclass
class RandInt(Domain):
    low: int
    high: int

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def choice(options: Sequence[Any]) -> Choice:
    return Choice(list(options))


def randint(low: int, high: int) -> RandInt:
    return RandInt(low, high)


def generate_configs(param_space: Dict[str, Any], num_samples: int,
                     seed: int = 0) -> List[Dict[str, Any]]:
    """Cross grid axes; sample distributions `num_samples` times per cross."""
    rng = random.Random(seed)
    grid_keys = [k for k, v in param_space.items() if isinstance(v, _GridSearch)]
    grids = [param_space[k].values for k in grid_keys]
    configs: List[Dict[str, Any]] = []
    crosses = list(itertools.product(*grids)) if grid_keys else [()]
    for cross in crosses:
        for _ in range(num_samples):
            cfg = {}
            for k, v in param_space.items():
                if isinstance(v, _GridSearch):
                    cfg[k] = cross[grid_keys.index(k)]
                elif isinstance(v, Domain):
                    cfg[k] = v.sample(rng)
                else:
                    cfg[k] = v
            configs.append(cfg)
    return configs
