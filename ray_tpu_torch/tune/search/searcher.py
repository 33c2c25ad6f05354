"""Searcher: the adaptive search-algorithm seam of Tune.

Reference: `python/ray/tune/search/searcher.py` (`Searcher` —
`suggest(trial_id) -> config`, `on_trial_complete(trial_id, result)`), the
interface behind HyperOpt/Optuna/BayesOpt integrations. Unlike
BasicVariantGenerator (which expands all configs up front), a Searcher is
consulted as capacity frees, so later trials condition on earlier results.
"""

from __future__ import annotations

import random
from typing import Any, Dict, Optional

from ray_tpu_torch.tune.search.basic_variant import _find_axes, _materialize, _set_path
from ray_tpu_torch.tune.search.sample import Function


class Searcher:
    def __init__(self, metric: Optional[str] = None, mode: Optional[str] = None):
        self.metric = metric
        self.mode = mode
        self._space: Optional[Dict[str, Any]] = None
        self._rng = random.Random(0)

    def set_search_properties(
        self, metric: Optional[str], mode: Optional[str], space: Dict[str, Any],
        seed: int = 0,
    ) -> None:
        self.metric = self.metric or metric
        self.mode = self.mode or mode
        self._space = space
        self._rng = random.Random(seed)
        grids, _ = _find_axes(space)
        if grids:
            raise ValueError(
                "grid_search axes are exhaustive, not adaptive — use "
                "BasicVariantGenerator (no search_alg) for grids"
            )

    # ------------------------------------------------------------- interface
    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        """Next config to try (None = no more suggestions)."""
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: Dict[str, Any]) -> None:
        """Intermediate result (optional hook)."""

    def on_trial_complete(
        self, trial_id: str, result: Optional[Dict[str, Any]] = None,
        error: bool = False,
    ) -> None:
        """Terminal result for a suggested trial."""

    # --------------------------------------------------------------- helpers
    def _random_config(self) -> Dict[str, Any]:
        _, samples = _find_axes(self._space)
        cfg = _materialize(self._space) or {}
        for path, domain in samples:
            if isinstance(domain, Function):
                _set_path(cfg, path, domain.sample(self._rng, cfg))
            else:
                _set_path(cfg, path, domain.sample(self._rng))
        return cfg

    def _objective(self, result: Dict[str, Any]) -> Optional[float]:
        if not self.metric or self.metric not in result:
            return None
        v = float(result[self.metric])
        return -v if self.mode == "max" else v


class RandomSearcher(Searcher):
    """Independent random sampling through the adaptive seam (the baseline
    any model-based searcher must beat)."""

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        return self._random_config()
