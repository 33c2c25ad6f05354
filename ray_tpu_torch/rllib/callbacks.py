"""RLlib callbacks: user hooks into the algorithm + sampling lifecycle.

Reference: `rllib/algorithms/callbacks.py` (`DefaultCallbacks` —
on_algorithm_init / on_train_result / on_evaluate_start / on_evaluate_end
driver-side; on_episode_end / on_sample_end inside the rollout workers),
configured via `AlgorithmConfig.callbacks(callbacks_class)`.

Driver hooks fire in the training loop; episode/sample hooks fire INSIDE
each EnvRunner actor (the class ships to runners and instantiates there —
state mutated in a runner hook lives in that runner's process, exactly like
the reference's worker-side callbacks).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict


@dataclass
class Episode:
    """What a completed episode looks like to `on_episode_end`."""

    episode_return: float
    episode_length: int


class DefaultCallbacks:
    """Subclass and override; every hook is a no-op by default."""

    # ----------------------------------------------------------- driver-side
    def on_algorithm_init(self, *, algorithm, **kwargs) -> None:
        """After AlgorithmConfig.build() fully constructed the algorithm."""

    def on_train_result(self, *, algorithm, result: Dict[str, Any],
                        **kwargs) -> None:
        """After each train() iteration, with its metrics dict (mutable —
        additions show up in the returned result, as in the reference)."""

    def on_evaluate_start(self, *, algorithm, **kwargs) -> None:
        """Before a dedicated evaluation pass."""

    def on_evaluate_end(self, *, algorithm,
                        evaluation_metrics: Dict[str, Any], **kwargs) -> None:
        """After evaluation, with {"evaluation": metrics}."""

    # ----------------------------------------------------------- runner-side
    def on_episode_end(self, *, episode: Episode, **kwargs) -> None:
        """In the EnvRunner actor, when any env finishes an episode."""

    def on_sample_end(self, *, samples: Dict[str, Any], **kwargs) -> None:
        """In the EnvRunner actor, after each rollout fragment (the batch
        dict about to ship to the driver; mutations are visible there)."""
