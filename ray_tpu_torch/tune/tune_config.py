"""TuneConfig: search/schedule settings for a Tuner run.

Reference: `python/ray/tune/tune_config.py` — metric/mode, num_samples,
max_concurrent_trials, scheduler, and (here) per-trial resources.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: Optional[str] = None
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    scheduler: Optional[Any] = None  # TrialScheduler
    # Adaptive search algorithm (Searcher, e.g. TPESearcher); None = the
    # up-front BasicVariantGenerator expansion.
    search_alg: Optional[Any] = None
    search_seed: int = 0
    resources_per_trial: Dict[str, float] = field(default_factory=lambda: {"CPU": 1.0})

    def __post_init__(self):
        if self.mode is not None and self.mode not in ("min", "max"):
            raise ValueError("mode must be 'min' or 'max'")
        if self.num_samples < 1:
            raise ValueError("num_samples must be >= 1")
