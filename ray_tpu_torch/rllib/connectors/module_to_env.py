"""Action connectors (module -> env seam).

Reference: `rllib/connectors/action/*` (`ClipActionsConnector`,
`NormalizeActionsConnector` / unsquash) — transforms applied to the module's
action before the env sees it. The training batch keeps the MODULE's action
(losses live in module action space); only the env receives the transform.
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.rllib.connectors.connector import Connector


class ClipActions(Connector):
    """Clip module actions to the env's Box bounds (reference:
    `ClipActionsConnector`)."""

    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)

    def __call__(self, data: np.ndarray) -> np.ndarray:
        return np.clip(data, self.low, self.high)

    def __repr__(self):
        return "ClipActions"


class UnsquashActions(Connector):
    """Affine-map module actions from (-1, 1) onto the env's Box bounds
    (reference: `NormalizeActionsConnector` inverse / `unsquash_action`).
    For modules that emit normalized actions while the env wants raw units."""

    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)
        self.center = (self.high + self.low) / 2.0
        self.scale = (self.high - self.low) / 2.0

    def __call__(self, data: np.ndarray) -> np.ndarray:
        return self.center + self.scale * np.clip(data, -1.0, 1.0)

    def __repr__(self):
        return "UnsquashActions"
