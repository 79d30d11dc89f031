from ray_tpu_torch.tune.search import choice, grid_search, loguniform, randint, uniform
from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler, BOHBScheduler, FIFOScheduler, HyperBandScheduler,
    MedianStoppingRule, PB2, PopulationBasedTraining)
from ray_tpu_torch.tune.searchers import (
    BayesOptSearcher, ConcurrencyLimiter, RandomSearcher, Searcher,
    TPESearcher, TuneBOHB)
from ray_tpu_torch.tune.stopper import (CombinedStopper, FunctionStopper,
                                  MaximumIterationStopper, Stopper,
                                  TimeoutStopper, TrialPlateauStopper)
from ray_tpu_torch.tune.tuner import TuneConfig, Tuner, ResultGrid, with_parameters
from ray_tpu_torch.tune.session import report, get_checkpoint
from ray_tpu_torch.tune.callback import Callback
from ray_tpu_torch.tune.logger import (CSVLoggerCallback, JsonLoggerCallback,
                                 TensorBoardLoggerCallback)

__all__ = [
    "Tuner", "TuneConfig", "ResultGrid", "report", "get_checkpoint",
    "grid_search", "uniform", "loguniform", "choice", "randint",
    "FIFOScheduler", "ASHAScheduler", "HyperBandScheduler",
    "MedianStoppingRule", "PopulationBasedTraining", "PB2",
    "Searcher", "RandomSearcher", "TPESearcher", "BayesOptSearcher",
    "ConcurrencyLimiter", "TuneBOHB", "BOHBScheduler",
    "Stopper", "MaximumIterationStopper", "TimeoutStopper",
    "TrialPlateauStopper", "FunctionStopper", "CombinedStopper",
    "with_parameters",
    "Callback", "CSVLoggerCallback", "JsonLoggerCallback",
    "TensorBoardLoggerCallback",
]
