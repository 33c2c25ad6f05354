"""Stoppers: programmatic trial/experiment stopping conditions.

Reference: `python/ray/tune/stopper/` (`Stopper` ABC — `__call__(trial_id,
result) -> bool` stops one trial, `stop_all() -> bool` ends the experiment —
plus MaximumIterationStopper / TrialPlateauStopper / FunctionStopper),
accepted by `RunConfig(stop=...)` alongside the metric-threshold dict.
"""

from __future__ import annotations

from collections import defaultdict, deque
from typing import Any, Callable, Dict


class Stopper:
    """Interface: return True from __call__ to stop that trial; True from
    stop_all() to end the whole experiment after the current step."""

    def __call__(self, trial_id: str, result: Dict[str, Any]) -> bool:
        raise NotImplementedError

    def stop_all(self) -> bool:
        return False


class FunctionStopper(Stopper):
    """Adapts a plain `(trial_id, result) -> bool` callable."""

    def __init__(self, fn: Callable[[str, Dict[str, Any]], bool]):
        self._fn = fn

    def __call__(self, trial_id: str, result: Dict[str, Any]) -> bool:
        return bool(self._fn(trial_id, result))


class MaximumIterationStopper(Stopper):
    """Stop each trial after `max_iter` reported results (reference:
    `stopper/maximum_iteration.py`)."""

    def __init__(self, max_iter: int):
        self._max_iter = int(max_iter)

    def __call__(self, trial_id: str, result: Dict[str, Any]) -> bool:
        return result.get("training_iteration", 0) >= self._max_iter


class TrialPlateauStopper(Stopper):
    """Stop a trial whose `metric` stopped moving: the last `num_results`
    values' stddev fell below `std` after at least `grace_period` results
    (reference: `stopper/trial_plateau.py`)."""

    def __init__(self, metric: str, std: float = 0.01, num_results: int = 4,
                 grace_period: int = 4):
        self._metric = metric
        self._std = float(std)
        self._num_results = int(num_results)
        self._grace = int(grace_period)
        self._window: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=self._num_results)
        )
        self._count: Dict[str, int] = defaultdict(int)

    def __call__(self, trial_id: str, result: Dict[str, Any]) -> bool:
        if self._metric not in result:
            return False
        self._count[trial_id] += 1
        w = self._window[trial_id]
        w.append(float(result[self._metric]))
        if self._count[trial_id] < self._grace or len(w) < self._num_results:
            return False
        import numpy as np

        return float(np.std(w)) <= self._std


class CombinedStopper(Stopper):
    """OR over several stoppers (reference: `stopper/__init__.py`)."""

    def __init__(self, *stoppers: Stopper):
        self._stoppers = stoppers

    def __call__(self, trial_id: str, result: Dict[str, Any]) -> bool:
        return any(s(trial_id, result) for s in self._stoppers)

    def stop_all(self) -> bool:
        return any(s.stop_all() for s in self._stoppers)


def coerce_stopper(stop: Any):
    """RunConfig.stop accepts: None, a metric-threshold dict (handled by the
    TrialRunner directly), a Stopper, or a (trial_id, result) callable."""
    if stop is None or isinstance(stop, dict) or isinstance(stop, Stopper):
        return stop
    if callable(stop):
        return FunctionStopper(stop)
    raise TypeError(
        f"stop must be a dict, Stopper, or callable; got {type(stop)}"
    )
