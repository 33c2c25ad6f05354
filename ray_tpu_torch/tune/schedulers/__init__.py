from ray_tpu_torch.tune.schedulers.trial_scheduler import (
    FIFOScheduler,
    TrialScheduler,
)
from ray_tpu_torch.tune.schedulers.async_hyperband import AsyncHyperBandScheduler
from ray_tpu_torch.tune.schedulers.median_stopping import MedianStoppingRule
from ray_tpu_torch.tune.schedulers.pbt import PopulationBasedTraining

ASHAScheduler = AsyncHyperBandScheduler

__all__ = [
    "ASHAScheduler",
    "AsyncHyperBandScheduler",
    "FIFOScheduler",
    "MedianStoppingRule",
    "PopulationBasedTraining",
    "TrialScheduler",
]
