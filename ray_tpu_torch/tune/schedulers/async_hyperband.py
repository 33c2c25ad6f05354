"""ASHA: asynchronous successive halving.

Reference: `python/ray/tune/schedulers/async_hyperband.py`
(`AsyncHyperBandScheduler`): rungs at grace_period * reduction_factor^k; a
trial reaching a rung is stopped unless it is in the top 1/reduction_factor
of results recorded at that rung so far (asynchronous: judged against what
has been seen, never waiting for stragglers).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List

from ray_tpu_torch.tune.schedulers.trial_scheduler import CONTINUE, STOP, TrialScheduler


class _Rung:
    def __init__(self, milestone: float):
        self.milestone = milestone
        self.recorded: Dict[str, float] = {}  # trial_id -> metric

    def cutoff(self, reduction_factor: float) -> float:
        """The score needed to be in the top 1/rf fraction (in max terms)."""
        vals = sorted(self.recorded.values())
        if not vals:
            return float("-inf")
        k = int(len(vals) * (1 - 1 / reduction_factor))
        return vals[min(k, len(vals) - 1)]


class AsyncHyperBandScheduler(TrialScheduler):
    def __init__(
        self,
        time_attr: str = "training_iteration",
        metric: str = None,
        mode: str = None,
        max_t: float = 100,
        grace_period: float = 1,
        reduction_factor: float = 4,
    ):
        if grace_period <= 0 or reduction_factor <= 1 or max_t < grace_period:
            raise ValueError("invalid ASHA parameters")
        self._time_attr = time_attr
        self.metric = metric
        self.mode = mode
        self._rf = reduction_factor
        rungs: List[_Rung] = []
        t = grace_period
        while t < max_t:
            rungs.append(_Rung(t))
            t *= reduction_factor
        # Judged from the largest milestone downward (reference behavior).
        self._rungs = list(reversed(rungs))

    def set_objective(self, metric: str, mode: str) -> None:
        self.metric = self.metric or metric
        self.mode = self.mode or mode
        if self.metric is None or self.mode is None:
            raise ValueError(
                "ASHA needs a metric and mode (set them on the scheduler or in "
                "TuneConfig)"
            )

    def on_trial_result(self, runner, trial, result: Dict[str, Any]) -> str:
        t = result.get(self._time_attr)
        raw = result.get(self.metric)
        if t is None or raw is None:
            return CONTINUE
        value = float(raw) if self.mode == "max" else -float(raw)
        decision = CONTINUE
        for rung in self._rungs:
            if t < rung.milestone or trial.trial_id in rung.recorded:
                continue
            cutoff = rung.cutoff(self._rf)
            rung.recorded[trial.trial_id] = value
            if value < cutoff and not math.isinf(cutoff):
                decision = STOP
            break  # only the highest newly-reached rung judges this result
        return decision
