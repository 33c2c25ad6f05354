"""InputReader: the offline-data input seam.

The counterpart of ``ray_tpu/rllib/offline/input_reader.py``; reference:
`rllib/offline/input_reader.py` — `next()` returns one batch of experience.
Implementations: `JsonReader`, or any callable the user passes to
`config.offline_data(input_=...)` returning a reader.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class InputReader:
    def next(self) -> Dict[str, np.ndarray]:
        """Return the next batch of experiences (numpy columns over
        transitions; at minimum `obs` and `actions`)."""
        raise NotImplementedError
