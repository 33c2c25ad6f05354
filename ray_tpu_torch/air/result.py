"""Result: the terminal record of one trial/run.

Reference: `python/ray/air/result.py` — metrics + best checkpoint + error,
returned by `Trainer.fit()` and held in Tune's `ResultGrid`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.air.checkpoint import Checkpoint


@dataclass
class Result:
    metrics: Optional[Dict[str, Any]]
    checkpoint: Optional[Checkpoint]
    error: Optional[Exception] = None
    path: Optional[str] = None
    metrics_dataframe: Optional[Any] = None
    best_checkpoints: List[Tuple[Checkpoint, Dict[str, Any]]] = field(
        default_factory=list
    )

    @property
    def config(self) -> Optional[Dict[str, Any]]:
        return (self.metrics or {}).get("config")
