"""BC: Behavioral Cloning — MARWIL with beta forced to 0.

The counterpart of ``ray_tpu/rllib/algorithms/bc.py``; reference:
`rllib/algorithms/bc/bc.py` — `BCConfig(MARWILConfig)` pins `beta = 0.0` (no
advantage weighting, no value loss; the loss degenerates to
-mean log pi(a|s) over the offline batch) and `validate()` rejects any other
beta.
"""

from __future__ import annotations

from ray_tpu_torch.rllib.algorithms.marwil import MARWIL, MARWILConfig


class BCConfig(MARWILConfig):
    def __init__(self):
        super().__init__()
        self.beta = 0.0
        self.lr = 1e-3
        self._algo_cls = BC

    def training(self, **kwargs) -> "BCConfig":
        super().training(**kwargs)
        if self.beta != 0.0:
            raise ValueError("For behavioral cloning, `beta` must be 0.0")
        return self


class BC(MARWIL):
    pass
