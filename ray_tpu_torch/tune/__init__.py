"""Tune: distributed hyperparameter search over the ray_tpu_torch runtime.

Reference: `python/ray/tune/` (P17 in SURVEY.md §2) — `Tuner`, the trial event
loop (`execution/trial_runner.py:1181`, `step():1358`), trial executor
(`execution/ray_trial_executor.py:185`), search spaces (`tune/search/`), and
schedulers (`tune/schedulers/`: ASHA, PBT, FIFO).

Architecture here: every trial runs its function trainable inside one actor
(reusing Train's thread-based session for report streaming), and the
`TrialRunner` multiplexes `next_result` futures across live trials with
`ray_tpu_torch.wait` — the same actor-substrate design the reference uses, minus
the legacy class-Trainable RPC surface.
"""

from ray_tpu_torch.tune.search.sample import (
    choice,
    grid_search,
    lograndint,
    loguniform,
    qrandint,
    quniform,
    randint,
    randn,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.callback import Callback
from ray_tpu_torch.tune.stopper import (
    CombinedStopper,
    FunctionStopper,
    MaximumIterationStopper,
    Stopper,
    TrialPlateauStopper,
)
from ray_tpu_torch.tune.result_grid import ResultGrid
from ray_tpu_torch.tune.tune_config import TuneConfig
from ray_tpu_torch.tune.tuner import Tuner, with_parameters
from ray_tpu_torch.tune.experiment.trial import Trial

# `tune.report` parity alias: inside a function trainable, air session is live.
from ray_tpu_torch.air.session import report, get_checkpoint

__all__ = [
    "Callback",
    "CombinedStopper",
    "FunctionStopper",
    "MaximumIterationStopper",
    "Stopper",
    "TrialPlateauStopper",
    "with_parameters",
    "ResultGrid",
    "Trial",
    "TuneConfig",
    "Tuner",
    "choice",
    "get_checkpoint",
    "grid_search",
    "lograndint",
    "loguniform",
    "qrandint",
    "quniform",
    "randint",
    "randn",
    "report",
    "sample_from",
    "uniform",
]
