"""MedianStoppingRule: stop trials whose running-average objective falls
below the median of prior trials' running averages at the same step.

Reference: `python/ray/tune/schedulers/median_stopping_rule.py` (Golovin et
al., "Google Vizier"). A trial is gated only after `grace_period` results and
once `min_samples_required` trials have reported at that step.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ray_tpu_torch.tune.schedulers.trial_scheduler import CONTINUE, STOP, TrialScheduler


class MedianStoppingRule(TrialScheduler):
    def __init__(
        self,
        metric: str = None,
        mode: str = None,
        grace_period: int = 1,
        min_samples_required: int = 3,
        hard_stop: bool = True,
    ):
        self.metric = metric
        self.mode = mode
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self.hard_stop = hard_stop
        # trial_id -> list of objective values (sign-normalized: higher=better)
        self._history: Dict[str, List[float]] = {}

    def set_objective(self, metric, mode) -> None:
        # Constructor values win over TuneConfig's (same rule as ASHA/PBT).
        self.metric = self.metric or metric
        self.mode = self.mode or mode or "max"

    def _obj(self, result: Dict[str, Any]) -> float:
        v = float(result[self.metric])
        return v if self.mode == "max" else -v

    def on_trial_result(self, runner, trial, result: Dict[str, Any]) -> str:
        if not self.metric or self.metric not in result:
            return CONTINUE
        hist = self._history.setdefault(trial.trial_id, [])
        hist.append(self._obj(result))
        step = len(hist)
        if step <= self.grace_period:
            return CONTINUE
        # Running averages of OTHER trials up to this step. Peers count with
        # WHATEVER history they have so far (truncated to `step`), matching
        # the reference rule's running-average-at-time-t: requiring peers to
        # have reached the same step let a trial that ran ahead of the pack
        # (uncontended worker while the rest were still spawning) escape
        # stopping entirely — every check saw too few same-step peers.
        peers = [
            float(np.mean(h[:step]))
            for tid, h in self._history.items()
            if tid != trial.trial_id and len(h) > 0
        ]
        if len(peers) < self.min_samples:
            return CONTINUE
        my_avg = float(np.mean(hist))
        if my_avg < float(np.median(peers)):
            return STOP if self.hard_stop else CONTINUE
        return CONTINUE
