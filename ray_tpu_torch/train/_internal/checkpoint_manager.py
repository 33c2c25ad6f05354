"""Checkpoint persistence + retention for a training run.

Reference: `python/ray/train/_internal/checkpoint.py` +
`tune/execution/checkpoint_manager.py` — persist reported checkpoints under
the run directory, track latest and best (by `checkpoint_score_attribute`),
prune to `num_to_keep`.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import CheckpointConfig


class CheckpointManager:
    def __init__(self, run_dir: str, config: Optional[CheckpointConfig] = None):
        self.run_dir = run_dir
        self.config = config or CheckpointConfig()
        self._count = 0
        # [(path, metrics)] in registration order; best tracked separately.
        self._kept: List[Tuple[str, Dict[str, Any]]] = []
        os.makedirs(run_dir, exist_ok=True)

    @property
    def latest_checkpoint(self) -> Optional[Checkpoint]:
        return Checkpoint.from_directory(self._kept[-1][0]) if self._kept else None

    def register(self, checkpoint: Checkpoint, metrics: Dict[str, Any]) -> Checkpoint:
        """Persist a reported checkpoint; returns the durable directory form.
        The persist is a "checkpoint_persist" span on the run's timeline (the
        driver-side half of the checkpoint phase; the goodput ledger accounts
        its wall time into the checkpoint bucket)."""
        from ray_tpu_torch._private.config import get_config
        from ray_tpu_torch.util import tracing

        span = None
        if get_config().enable_timeline or tracing.is_enabled():
            span = tracing.start_span(
                "checkpoint_persist", "train",
                attributes={"index": str(self._count + 1)},
            )
        try:
            self._count += 1
            path = os.path.join(self.run_dir, f"checkpoint_{self._count:06d}")
            # Crash-safe persist: materialize into a .tmp sibling, then one
            # atomic rename. A crash mid-write leaves only a .tmp directory,
            # which restore_from_disk ignores (and sweeps) — latest_checkpoint
            # can never point at a torn entry.
            tmp = path + ".tmp"
            shutil.rmtree(tmp, ignore_errors=True)
            checkpoint.to_directory(tmp)
            from ray_tpu_torch._private import failpoints

            if failpoints.ENABLED:
                # Chaos seam between write and publish: a crash/error here is
                # the torn-persist case the atomic rename protects against.
                failpoints.maybe_crash("ckpt.persist")
            os.rename(tmp, path)
            self._kept.append((path, dict(metrics or {})))
            self._prune()
            self._write_manifest()
            return Checkpoint.from_directory(path)
        finally:
            if span is not None:
                tracing.end_span(span)

    def _manifest_path(self) -> str:
        # One hidden manifest for the whole run (never matches checkpoint_*
        # globs, and checkpoint dirs stay pure user data for to_dict()).
        return os.path.join(self.run_dir, ".tune_checkpoint_metrics.json")

    def _write_manifest(self) -> None:
        """Persist {checkpoint basename: metrics} so a restored experiment
        (Tuner.restore) can rebuild rankings from disk."""
        import json

        entries = {}
        for path, metrics in self._kept:
            entries[os.path.basename(path)] = {
                k: v for k, v in metrics.items()
                if isinstance(k, str) and isinstance(v, (int, float, str, bool))
            }
        try:
            tmp = self._manifest_path() + ".tmp"
            with open(tmp, "w") as f:
                json.dump(entries, f)
            os.replace(tmp, self._manifest_path())
        except (OSError, TypeError):
            pass

    def restore_from_disk(self) -> None:
        """Rediscover checkpoints already persisted under run_dir (experiment
        resume: the in-memory book is gone, the directories are not)."""
        import json
        import re

        manifest: Dict[str, Any] = {}
        try:
            with open(self._manifest_path()) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            pass
        found = []
        for entry in sorted(os.listdir(self.run_dir)):
            path = os.path.join(self.run_dir, entry)
            if entry.endswith(".tmp") and re.fullmatch(r"checkpoint_\d+\.tmp", entry):
                # Torn persist from a crash mid-write: never a valid resume
                # point (the atomic rename did not happen). Sweep it.
                shutil.rmtree(path, ignore_errors=True)
                continue
            m = re.fullmatch(r"checkpoint_(\d+)", entry)
            if m is None or not os.path.isdir(path):
                continue
            metrics = manifest.get(entry, {})
            if not isinstance(metrics, dict):
                metrics = {}
            found.append((int(m.group(1)), path, metrics))
        found.sort()
        self._kept = [(p, m) for _, p, m in found]
        self._count = found[-1][0] if found else 0

    def best_checkpoint(self) -> Optional[Checkpoint]:
        attr = self.config.checkpoint_score_attribute
        if not self._kept:
            return None
        if attr is None:
            return self.latest_checkpoint
        scored = [(m.get(attr), p) for p, m in self._kept if attr in m]
        if not scored:
            return self.latest_checkpoint
        best = (max if self.config.checkpoint_score_order == "max" else min)(scored)
        return Checkpoint.from_directory(best[1])

    def best_checkpoints(self) -> List[Tuple[Checkpoint, Dict[str, Any]]]:
        return [(Checkpoint.from_directory(p), m) for p, m in self._kept]

    def _prune(self):
        keep = self.config.num_to_keep
        if keep is None:
            return
        attr = self.config.checkpoint_score_attribute
        while len(self._kept) > keep:
            if attr is None:
                victim = 0  # FIFO: oldest goes first
            else:
                # Drop the worst-scoring; never drop the most recent (resume).
                # A checkpoint missing the score attribute counts as worst, so
                # unscored checkpoints are pruned before any scored one.
                order = self.config.checkpoint_score_order
                candidates = list(enumerate(self._kept[:-1]))
                victim = (
                    min(candidates, key=lambda kv: kv[1][1].get(attr, float("-inf")))
                    if order == "max"
                    else max(candidates, key=lambda kv: kv[1][1].get(attr, float("inf")))
                )[0]
            path, _ = self._kept.pop(victim)
            shutil.rmtree(path, ignore_errors=True)
