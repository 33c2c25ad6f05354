"""Observation connectors (env -> module seam).

Reference: `rllib/connectors/agent/*` — obs preprocessing that runs in the
runner before the policy forward: flattening, clipping, running-moment
normalization (`MeanStdFilter` in `rllib/utils/filter.py`).
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from ray_tpu_torch.rllib.connectors.connector import Connector


class FlattenObs(Connector):
    """Ravel each observation row to 1-D float32 (dict/tensor obs -> MLP)."""

    def __call__(self, data: np.ndarray) -> np.ndarray:
        data = np.asarray(data, np.float32)
        return data.reshape(data.shape[0], -1)


class ClipObs(Connector):
    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = float(low), float(high)

    def __call__(self, data: np.ndarray) -> np.ndarray:
        return np.clip(data, self.low, self.high)

    def __repr__(self):
        return f"ClipObs({self.low}, {self.high})"


class NormalizeObs(Connector):
    """Running mean/std normalization (reference: `MeanStdFilter`,
    `rllib/utils/filter.py` — Welford accumulation). Stats update on every
    batch seen during exploration; `frozen` stops accumulation (evaluation
    uses the training stats without polluting them)."""

    def __init__(self, clip: float = 10.0, epsilon: float = 1e-8):
        self.clip = float(clip)
        self.epsilon = float(epsilon)
        self.count = 0.0
        self.mean: Any = None
        self.m2: Any = None
        self.frozen = False

    def __call__(self, data: np.ndarray) -> np.ndarray:
        data = np.asarray(data, np.float32)
        if not self.frozen:
            self._update(data)
        if self.count < 2:
            return data
        std = np.sqrt(self.m2 / max(self.count - 1, 1.0)) + self.epsilon
        return np.clip((data - self.mean) / std, -self.clip, self.clip)

    def _update(self, batch: np.ndarray) -> None:
        # Chan et al. parallel Welford merge of the batch's moments.
        n = float(len(batch))
        if n == 0:
            return
        b_mean = batch.mean(axis=0)
        b_m2 = ((batch - b_mean) ** 2).sum(axis=0)
        if self.mean is None:
            self.count, self.mean, self.m2 = n, b_mean, b_m2
            return
        delta = b_mean - self.mean
        tot = self.count + n
        self.mean = self.mean + delta * (n / tot)
        self.m2 = self.m2 + b_m2 + np.square(delta) * self.count * n / tot
        self.count = tot

    def state(self) -> Dict[str, Any]:
        return {
            "count": self.count,
            "mean": None if self.mean is None else self.mean.copy(),
            "m2": None if self.m2 is None else self.m2.copy(),
        }

    def set_state(self, state: Dict[str, Any]) -> None:
        self.count = state.get("count", 0.0)
        self.mean = state.get("mean")
        self.m2 = state.get("m2")

    def __repr__(self):
        return f"NormalizeObs(count={int(self.count)})"
