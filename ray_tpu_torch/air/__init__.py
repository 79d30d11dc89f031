from ray_tpu_torch.air.config import (
    ScalingConfig,
    RunConfig,
    CheckpointConfig,
    FailureConfig,
)
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.air import session
