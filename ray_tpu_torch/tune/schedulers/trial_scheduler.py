"""Scheduler interface: per-report trial decisions.

Reference: `python/ray/tune/schedulers/trial_scheduler.py` — the runner asks
the scheduler after every result; CONTINUE keeps the trial running, STOP
terminates it (ASHA pruning), RESTART tears the actor down and relaunches
from `trial.restore_checkpoint` with (possibly mutated) `trial.config` (the
PBT exploit/explore path).
"""

from __future__ import annotations

from typing import Any, Dict

CONTINUE = "CONTINUE"
STOP = "STOP"
RESTART = "RESTART"


class TrialScheduler:
    CONTINUE = CONTINUE
    STOP = STOP
    RESTART = RESTART

    def on_trial_add(self, runner, trial) -> None:
        pass

    def on_trial_result(self, runner, trial, result: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, runner, trial) -> None:
        pass


class FIFOScheduler(TrialScheduler):
    """Run every trial to completion in submission order."""
