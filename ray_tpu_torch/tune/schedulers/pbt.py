"""Population Based Training.

Reference: `python/ray/tune/schedulers/pbt.py` (`PopulationBasedTraining`):
every `perturbation_interval` units of `time_attr`, trials in the bottom
quantile EXPLOIT a top-quantile trial (clone its latest checkpoint) and
EXPLORE its hyperparameters (resample or perturb by 1.2x / 0.8x). The runner
executes the decision by restarting the trial's actor from
`trial.restore_checkpoint` with the mutated `trial.config`.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List, Union

from ray_tpu_torch.tune.schedulers.trial_scheduler import CONTINUE, RESTART, TrialScheduler
from ray_tpu_torch.tune.search.sample import Domain


class PopulationBasedTraining(TrialScheduler):
    def __init__(
        self,
        time_attr: str = "training_iteration",
        metric: str = None,
        mode: str = None,
        perturbation_interval: float = 10,
        hyperparam_mutations: Dict[str, Union[List, Domain, Callable]] = None,
        quantile_fraction: float = 0.25,
        resample_probability: float = 0.25,
        seed: int = 0,
    ):
        if not hyperparam_mutations:
            raise ValueError("hyperparam_mutations is required for PBT")
        if not 0 < quantile_fraction <= 0.5:
            raise ValueError("quantile_fraction must be in (0, 0.5]")
        self._time_attr = time_attr
        self.metric = metric
        self.mode = mode
        self._interval = perturbation_interval
        self._mutations = hyperparam_mutations
        self._quantile = quantile_fraction
        self._resample_prob = resample_probability
        self._rng = random.Random(seed)
        self._last_perturb: Dict[str, float] = {}

    def set_objective(self, metric: str, mode: str) -> None:
        self.metric = self.metric or metric
        self.mode = self.mode or mode
        if self.metric is None or self.mode is None:
            raise ValueError(
                "PBT needs a metric and mode (set them on the scheduler or in "
                "TuneConfig)"
            )

    # ------------------------------------------------------------------ explore
    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        new = dict(config)
        for key, spec in self._mutations.items():
            if key not in new:
                continue
            if isinstance(spec, list):
                if self._rng.random() < self._resample_prob or new[key] not in spec:
                    new[key] = self._rng.choice(spec)
                else:  # shift to a neighboring value
                    i = spec.index(new[key])
                    new[key] = spec[max(0, min(len(spec) - 1, i + self._rng.choice([-1, 1])))]
            elif isinstance(spec, Domain):
                if self._rng.random() < self._resample_prob:
                    new[key] = spec.sample(self._rng)
                else:
                    new[key] = new[key] * self._rng.choice([0.8, 1.2])
            elif callable(spec):
                if self._rng.random() < self._resample_prob:
                    new[key] = spec()
                else:
                    new[key] = new[key] * self._rng.choice([0.8, 1.2])
        return new

    # ------------------------------------------------------------------- decide
    def on_trial_result(self, runner, trial, result: Dict[str, Any]) -> str:
        t = result.get(self._time_attr)
        if t is None or self.metric not in result:
            return CONTINUE
        last = self._last_perturb.get(trial.trial_id, 0.0)
        if t - last < self._interval:
            return CONTINUE
        self._last_perturb[trial.trial_id] = t

        sign = 1.0 if self.mode == "max" else -1.0
        population = [
            tr for tr in runner.trials
            if tr.last_result and self.metric in tr.last_result
        ]
        if len(population) < 2:
            return CONTINUE
        ranked = sorted(
            population, key=lambda tr: sign * tr.metric(self.metric), reverse=True
        )
        k = max(1, int(len(ranked) * self._quantile))
        top, bottom = ranked[:k], ranked[-k:]
        if trial not in bottom or trial in top:
            return CONTINUE
        donors = [tr for tr in top if tr.checkpoint is not None]
        if not donors:
            return CONTINUE
        donor = self._rng.choice(donors)
        trial.restore_checkpoint = donor.checkpoint
        trial.config = self._explore(donor.config)
        return RESTART
