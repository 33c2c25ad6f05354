"""ResultGrid: the indexed outcome of a Tuner run.

Reference: `python/ray/tune/result_grid.py` — per-trial `Result`s plus
`get_best_result(metric, mode)`.
"""

from __future__ import annotations

from typing import List, Optional

from ray_tpu_torch.air.result import Result


class ResultGrid:
    def __init__(self, results: List[Result], metric: Optional[str] = None,
                 mode: Optional[str] = None):
        self._results = results
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i: int) -> Result:
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def errors(self) -> List[Exception]:
        return [r.error for r in self._results if r.error is not None]

    def get_best_result(
        self, metric: Optional[str] = None, mode: Optional[str] = None
    ) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode or "max"
        if metric is None:
            raise ValueError("metric is required (set it here or in TuneConfig)")
        scored = [
            r for r in self._results
            if r.metrics is not None and metric in r.metrics
        ]
        if not scored:
            raise RuntimeError("no trial reported the requested metric")
        key = lambda r: r.metrics[metric]  # noqa: E731
        return max(scored, key=key) if mode == "max" else min(scored, key=key)

    def get_dataframe(self):
        import pandas as pd

        return pd.DataFrame([r.metrics or {} for r in self._results])
