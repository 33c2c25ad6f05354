"""BaseTrainer: configs + the fit() contract.

Reference: `python/ray/train/base_trainer.py` (`BaseTrainer.fit:557`). In the
reference every fit routes through Tune as a single trial; here `fit()` runs
the training loop directly and `as_trainable()` exposes the same loop to
`ray_tpu_torch.tune.Tuner` for sweeps (same seam, inverted layering — Tune drives
Train when asked rather than always sitting between).
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.air.result import Result


class TrainingFailedError(RuntimeError):
    """Training did not finish within the FailureConfig retry budget."""


def default_storage_path() -> str:
    return os.environ.get(
        "RAY_TPU_TORCH_RESULTS_DIR", os.path.expanduser("~/ray_tpu_torch_results")
    )


class BaseTrainer:
    def __init__(
        self,
        *,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        metadata: Optional[Dict[str, Any]] = None,
    ):
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.resume_from_checkpoint = resume_from_checkpoint
        self.metadata = metadata or {}

    # Implemented by subclasses: run the whole training job, return a Result.
    def _fit_impl(self, trial_info: Optional[Dict[str, str]] = None) -> Result:
        raise NotImplementedError

    def fit(self) -> Result:
        result = self._fit_impl()
        if result.error is not None:
            raise TrainingFailedError(str(result.error)) from result.error
        return result

    def run_dir(self) -> str:
        name = self.run_config.name or f"{type(self).__name__}_{int(time.time())}"
        # Cache: a trainer maps to exactly one run directory across restarts.
        if self.run_config.name is None:
            self.run_config.name = name
        base = self.run_config.storage_path or default_storage_path()
        return os.path.join(os.path.expanduser(base), name)

    def as_trainable(self):
        """A Tune function-trainable wrapping this trainer (param_space's
        'train_loop_config' key overrides the trainer's loop config per trial).
        Its gang runs from the trial actor, so ``Tuner.fit`` counts the gang's
        ``num_workers x ScalingConfig._resources`` in each trial's footprint."""
        trainer = self

        def _trainable(config: Dict[str, Any]):
            import copy

            t = copy.copy(trainer)
            if "train_loop_config" in config and hasattr(t, "_train_loop_config"):
                merged = dict(getattr(t, "_train_loop_config") or {})
                merged.update(config["train_loop_config"])
                t._train_loop_config = merged
            from ray_tpu_torch.air import session

            t._inside_tune = True
            result = t._fit_impl(
                trial_info={
                    "trial_name": session.get_trial_name(),
                    "trial_id": session.get_trial_id(),
                    "trial_dir": session.get_trial_dir(),
                    "experiment_name": session.get_experiment_name(),
                }
            )
            if result.error is not None:
                raise result.error

        _trainable.__name__ = type(self).__name__
        return _trainable
