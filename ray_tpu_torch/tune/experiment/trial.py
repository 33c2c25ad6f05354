"""Trial: one hyperparameter configuration's lifecycle record.

Reference: `python/ray/tune/experiment/trial.py` — status machine
(PENDING/RUNNING/PAUSED/TERMINATED/ERROR), per-trial directory, last result,
and checkpoint bookkeeping.
"""

from __future__ import annotations

import os
import uuid
from typing import Any, Dict, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.train._internal.checkpoint_manager import CheckpointManager

PENDING = "PENDING"
RUNNING = "RUNNING"
PAUSED = "PAUSED"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


class Trial:
    def __init__(self, config: Dict[str, Any], experiment_dir: str, index: int,
                 experiment_name: str = "", trial_id: Optional[str] = None):
        self.trial_id = trial_id or f"{uuid.uuid4().hex[:8]}"
        self.index = index
        self.config = config
        self.experiment_name = experiment_name
        self.name = f"trial_{index:04d}_{self.trial_id}"
        self.local_dir = os.path.join(experiment_dir, self.name)
        os.makedirs(self.local_dir, exist_ok=True)
        self.status = PENDING
        self.last_result: Optional[Dict[str, Any]] = None
        self.error: Optional[str] = None
        self.num_results = 0
        self.restarts = 0
        self.checkpoint_manager = CheckpointManager(self.local_dir)
        # Set when (re)starting with a donor checkpoint (PBT exploit / resume).
        self.restore_checkpoint: Optional[Checkpoint] = None

    # ------------------------------------------------------- journal (resume)
    def to_state(self) -> Dict[str, Any]:
        """JSON-serializable snapshot for the experiment journal (reference:
        `Trial.get_json_state`). Configs may hold arbitrary objects
        (functions, arrays), so the exact config rides as pickled hex; a
        scalar-filtered copy stays for human inspection. Torch tensors in
        the config land as CPU tensors (``serialization.dumps_to_host``), so
        a driver without the trial's device can restore the journal."""
        from ray_tpu_torch._private import serialization

        return {
            "trial_id": self.trial_id,
            "index": self.index,
            "config": {
                k: v for k, v in (self.config or {}).items()
                if isinstance(v, (int, float, str, bool))
            },
            "config_pkl": serialization.dumps_to_host(dict(self.config or {})).hex(),
            "status": self.status,
            "num_results": self.num_results,
            "last_result": {
                k: v for k, v in (self.last_result or {}).items()
                if isinstance(v, (int, float, str, bool))
            } or None,
            "error": self.error,
        }

    @classmethod
    def from_state(cls, state: Dict[str, Any], experiment_dir: str,
                   experiment_name: str = "") -> "Trial":
        from ray_tpu_torch._private import serialization

        if state.get("config_pkl"):
            config = serialization.loads(bytes.fromhex(state["config_pkl"]))
        else:
            config = dict(state.get("config") or {})
        t = cls(
            config,
            experiment_dir,
            int(state["index"]),
            experiment_name=experiment_name,
            trial_id=state["trial_id"],
        )
        t.status = state.get("status", PENDING)
        t.num_results = int(state.get("num_results", 0))
        t.last_result = state.get("last_result")
        t.error = state.get("error")
        t.checkpoint_manager.restore_from_disk()
        return t

    @property
    def checkpoint(self) -> Optional[Checkpoint]:
        return self.checkpoint_manager.latest_checkpoint

    def metric(self, name: str, default: float = float("nan")) -> float:
        if not self.last_result:
            return default
        v = self.last_result.get(name, default)
        try:
            return float(v)
        except (TypeError, ValueError):
            return default

    def __repr__(self):
        return f"Trial({self.name}, {self.status}, results={self.num_results})"
