"""Tuner: the user-facing sweep API.

Reference: `python/ray/tune/tuner.py` (`Tuner(trainable, param_space,
tune_config, run_config)`, `.fit() -> ResultGrid`). Accepts a plain function
trainable `fn(config)` (reporting via `ray_tpu_torch.air.session.report`) or a
`BaseTrainer` (its `as_trainable()`; `param_space["train_loop_config"]`
overrides the trainer's loop config per trial — the reference's Trainer+Tuner
composition, `base_trainer.py:557`).

GPU delta: `fit()` bounds the trials that run at once by every resource of
one trial's footprint (`trial_footprint`: its `resources_per_trial`, plus a
Trainer's whole gang), where the reference counts CPU alone, and refuses a
trial that cannot fit the cluster at all. `TrialRunner._launch` blocks until
a trial's actor is placed, so one trial whose GPU share cannot be placed
would stop the event loop, and with it the running trials' results and the
shares they would free.
"""

from __future__ import annotations

import os
import time
from typing import Any, Callable, Dict, Optional, Union

from ray_tpu_torch.air.config import RunConfig
from ray_tpu_torch.train.base_trainer import BaseTrainer, default_storage_path
from ray_tpu_torch.tune.execution.trial_runner import TrialRunner, trial_actor_options
from ray_tpu_torch.tune.experiment.trial import Trial
from ray_tpu_torch.tune.result_grid import ResultGrid
from ray_tpu_torch.tune.search.basic_variant import BasicVariantGenerator
from ray_tpu_torch.tune.tune_config import TuneConfig


class Tuner:
    def __init__(
        self,
        trainable: Union[Callable[[Dict[str, Any]], None], BaseTrainer],
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
    ):
        from ray_tpu_torch._private import usage

        usage.record_library_usage("tune")
        self._trainable = trainable
        self._param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        # Set by Tuner.restore(): resume journaled trials instead of starting
        # fresh ones.
        self._restore_dir: Optional[str] = None
        self._resume_errored = False

    @classmethod
    def restore(
        cls,
        path: str,
        trainable: Optional[Union[Callable, BaseTrainer]] = None,
        *,
        resume_errored: bool = False,
    ) -> "Tuner":
        """Resume a killed/interrupted experiment from its directory
        (reference: `python/ray/tune/tuner.py:175 Tuner.restore`).

        Finished trials keep their journaled results and checkpoints;
        unfinished trials re-run, resuming from their latest checkpoint;
        errored trials re-run only with `resume_errored=True`. `trainable`
        may be re-supplied (required if the saved one fails to load)."""
        import pickle

        path = os.path.expanduser(path)
        state_file = os.path.join(path, "experiment_state.json")
        if not os.path.exists(state_file):
            raise FileNotFoundError(
                f"no experiment journal at {state_file}; was this experiment "
                "run by Tuner.fit()?"
            )
        spec: Dict[str, Any] = {}
        try:
            with open(os.path.join(path, "tuner.pkl"), "rb") as f:
                spec = pickle.load(f)
        except Exception:  # noqa: BLE001 — trainable may be passed anew
            if trainable is None:
                raise ValueError(
                    "could not load the saved tuner spec; pass `trainable=`"
                ) from None
            import warnings

            warnings.warn(
                "tuner.pkl could not be loaded: restoring with DEFAULT "
                "TuneConfig/RunConfig (metric/mode/num_samples/stop from the "
                "original run are lost)",
                stacklevel=2,
            )
        if trainable is None:
            trainable = spec.get("trainable")
        if trainable is None:
            raise ValueError("saved spec has no trainable; pass `trainable=`")
        tuner = cls(
            trainable,
            param_space=spec.get("param_space"),
            tune_config=spec.get("tune_config"),
            run_config=spec.get("run_config"),
        )
        tuner.run_config.name = os.path.basename(path.rstrip("/"))
        tuner.run_config.storage_path = os.path.dirname(path.rstrip("/"))
        tuner._restore_dir = path
        tuner._resume_errored = resume_errored
        return tuner

    @staticmethod
    def can_restore(path: str) -> bool:
        return os.path.exists(
            os.path.join(os.path.expanduser(path), "experiment_state.json")
        )

    def _resolve_trainable(self) -> Callable[[Dict[str, Any]], None]:
        if isinstance(self._trainable, BaseTrainer):
            return self._trainable.as_trainable()
        if callable(self._trainable):
            return self._trainable
        raise TypeError(f"invalid trainable: {type(self._trainable)}")

    def fit(self) -> ResultGrid:
        import ray_tpu_torch
        from ray_tpu_torch._private.worker import _auto_init

        _auto_init()
        # Don't oversubscribe: bound by what the cluster can actually run
        # (a trial that cannot fit at all raises here, before any starts).
        fits = trials_that_fit(
            trial_footprint(self._trainable, self.tune_config.resources_per_trial),
            ray_tpu_torch.cluster_resources(),
        )
        max_conc = min(self.tune_config.max_concurrent_trials or fits, fits)
        name = self.run_config.name or f"tune_{int(time.time())}"
        base = self.run_config.storage_path or default_storage_path()
        experiment_dir = os.path.join(os.path.expanduser(base), name)
        os.makedirs(experiment_dir, exist_ok=True)
        self._save_spec(experiment_dir)

        searcher = self.tune_config.search_alg
        if self._restore_dir is not None:
            trials = self._restored_trials(name)
            if searcher is not None:
                # Journaled trials carry their configs; the searcher (fresh
                # state — observations are not replayed) suggests only the
                # remaining num_samples - len(trials) samples.
                searcher.set_search_properties(
                    self.tune_config.metric,
                    self.tune_config.mode,
                    self._param_space,
                    seed=self.tune_config.search_seed,
                )
        elif searcher is not None:
            searcher.set_search_properties(
                self.tune_config.metric,
                self.tune_config.mode,
                self._param_space,
                seed=self.tune_config.search_seed,
            )
            trials = []
        else:
            gen = BasicVariantGenerator(seed=self.tune_config.search_seed)
            configs = list(
                gen.generate(self._param_space, self.tune_config.num_samples)
            )
            if not configs:
                configs = [{}]
            trials = [
                Trial(cfg, experiment_dir, i, experiment_name=name)
                for i, cfg in enumerate(configs)
            ]

        scheduler = self.tune_config.scheduler
        if scheduler is not None and hasattr(scheduler, "set_objective"):
            scheduler.set_objective(self.tune_config.metric, self.tune_config.mode)

        runner = TrialRunner(
            self._resolve_trainable(),
            trials,
            scheduler=scheduler,
            max_concurrent=max_conc,
            resources_per_trial=self.tune_config.resources_per_trial,
            stop=self.run_config.stop,
            experiment_name=name,
            searcher=searcher,
            num_samples=self.tune_config.num_samples if searcher is not None else 0,
            trial_factory=lambda i: Trial({}, experiment_dir, i, experiment_name=name),
            experiment_dir=experiment_dir,
            callbacks=self.run_config.callbacks,
        )
        runner.run()
        return ResultGrid(
            runner.results(), metric=self.tune_config.metric, mode=self.tune_config.mode
        )

    # ---------------------------------------------------------------- resume
    def _save_spec(self, experiment_dir: str) -> None:
        """Persist the tuner spec so `Tuner.restore(path)` can rebuild it."""
        from ray_tpu_torch._private import serialization

        try:
            blob = serialization.dumps_to_host({
                "trainable": self._trainable,
                "param_space": self._param_space,
                "tune_config": self.tune_config,
                "run_config": self.run_config,
            })
            tmp = os.path.join(experiment_dir, f"tuner.pkl.tmp.{os.getpid()}")
            with open(tmp, "wb") as f:
                f.write(blob)
            os.replace(tmp, os.path.join(experiment_dir, "tuner.pkl"))
        except Exception:  # noqa: BLE001 — unpicklable trainable: restore
            pass  # will require re-passing trainable=

    def _restored_trials(self, name: str):
        """Rebuild trials from the experiment journal: finished trials keep
        results/checkpoints; unfinished ones go PENDING and resume from their
        latest persisted checkpoint."""
        import json

        from ray_tpu_torch.tune.experiment import trial as trial_mod

        with open(os.path.join(self._restore_dir, "experiment_state.json")) as f:
            states = json.load(f)["trials"]
        trials = []
        for st in states:
            t = Trial.from_state(st, self._restore_dir, experiment_name=name)
            rerun = t.status in (trial_mod.PENDING, trial_mod.RUNNING) or (
                t.status == trial_mod.ERROR and self._resume_errored
            )
            if rerun:
                t.status = trial_mod.PENDING
                t.error = None
                t.restore_checkpoint = t.checkpoint  # latest persisted, if any
            trials.append(t)
        return trials


def trial_footprint(trainable, resources_per_trial: Dict[str, float]) -> Dict[str, float]:
    """What one trial holds while it runs: its actor's ``resources_per_trial``
    (CPU 1 when unset or 0, as the reference counts it), plus, for a
    ``BaseTrainer``, its gang's ``num_workers x ScalingConfig._resources``.
    A ``TPU`` key raises (``trial_actor_options``)."""
    trial_actor_options(resources_per_trial)
    need = {k: float(v) for k, v in resources_per_trial.items()}
    need["CPU"] = need.get("CPU", 1.0) or 1.0
    if isinstance(trainable, BaseTrainer):
        scaling = trainable.scaling_config
        for k, v in scaling._resources.items():
            need[k] = need.get(k, 0.0) + scaling.num_workers * float(v)
    return need


def trials_that_fit(footprint: Dict[str, float], cluster: Dict[str, float]) -> int:
    """How many trials of ``footprint`` the ``cluster`` holds at once: the
    smallest ``floor(cluster[k] / footprint[k])``, at least 1. Raises
    ``ValueError`` naming both amounts when one trial does not fit at all."""
    fits = []
    for k, need in footprint.items():
        if need <= 0:
            continue
        have = float(cluster.get(k, 0.0))
        if need > have + 1e-9:
            raise ValueError(
                f"one trial needs {k} {need} (resources_per_trial, plus a Trainer's "
                f"gang), but the cluster has {k} {have}"
            )
        fits.append(int(have / need + 1e-9))
    return max(1, min(fits, default=1))


def with_parameters(trainable, **kwargs):
    """Bind large objects to a trainable via the object store (reference:
    `python/ray/tune/trainable/util.py with_parameters`): each value is put
    ONCE and fetched zero-copy per trial, instead of pickling into every
    trial's config/spec."""
    import ray_tpu_torch

    refs = {k: ray_tpu_torch.put(v) for k, v in kwargs.items()}

    def inner(config):
        resolved = {k: ray_tpu_torch.get(r) for k, r in refs.items()}
        return trainable(config, **resolved)

    inner.__name__ = getattr(trainable, "__name__", "trainable")
    return inner
