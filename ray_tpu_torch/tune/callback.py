"""Tune Callback API: experiment-lifecycle hooks.

Reference: `python/ray/tune/callback.py` (`Callback` — on_trial_start /
on_trial_result / on_trial_complete / on_trial_error / on_checkpoint /
on_experiment_end, invoked by the TrialRunner event loop) wired through
`RunConfig(callbacks=[...])`.

Hooks run in the DRIVER's event loop between scheduling decisions — keep
them cheap (a slow callback stalls every trial's next dispatch, exactly as
in the reference). Exceptions propagate and abort the experiment.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class Callback:
    """Base class; subclass and override the hooks you need."""

    def setup(self, **info) -> None:
        """Once, before the experiment's first trial launches."""

    def on_trial_start(self, iteration: int, trials: List, trial, **info) -> None:
        """A trial's actor was launched (also after RESTART relaunches)."""

    def on_trial_result(self, iteration: int, trials: List, trial,
                        result: Dict[str, Any], **info) -> None:
        """A trial reported metrics (before the scheduler's decision)."""

    def on_checkpoint(self, iteration: int, trials: List, trial,
                      checkpoint, **info) -> None:
        """A trial report carried a checkpoint (after registration)."""

    def on_trial_complete(self, iteration: int, trials: List, trial, **info) -> None:
        """A trial finished or was scheduler-stopped (not errored)."""

    def on_trial_error(self, iteration: int, trials: List, trial, **info) -> None:
        """A trial errored (actor death or user exception)."""

    def on_experiment_end(self, trials: List, **info) -> None:
        """The event loop drained: every trial is terminal."""


class CallbackList:
    """Fan-out helper the TrialRunner drives."""

    def __init__(self, callbacks: Optional[List[Callback]]):
        self._callbacks = list(callbacks or [])

    def __bool__(self) -> bool:
        return bool(self._callbacks)

    def __iter__(self):
        return iter(self._callbacks)

    def fire(self, hook: str, *args, **kwargs) -> None:
        for cb in self._callbacks:
            getattr(cb, hook)(*args, **kwargs)
