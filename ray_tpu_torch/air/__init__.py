"""AIR core: the shared vocabulary of Train/Tune/Serve/Data.

Reference: `python/ray/air/` — `Checkpoint`
(`air/checkpoint.py:63`), the unified train/tune `session` (`air/session.py:43`),
and the config dataclasses (`air/config.py`: `ScalingConfig`, `RunConfig`,
`FailureConfig`, `CheckpointConfig`).

GPU deltas: `ScalingConfig(use_gpu=True)` gives each worker `GPU`
resources, and `Checkpoint` lowers torch tensors to CPU tensors on save.
"""

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.air import session

__all__ = [
    "Checkpoint",
    "CheckpointConfig",
    "FailureConfig",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "session",
]
