"""DataParallelTrainer: SPMD training over a gang of worker actors.

Reference: `python/ray/train/data_parallel_trainer.py:56` +
`training_loop:385`. The driver loop consumes per-round results from the gang
(`BackendExecutor.get_next_results`), persists rank-0 checkpoints, and
restarts the whole gang from the last checkpoint on worker failure
(`FailureConfig.max_failures`, `air/config.py:512`) — gang restarts are
all-or-nothing because a process group cannot resize in place.
"""

from __future__ import annotations

import itertools
import os
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.config import RunConfig, ScalingConfig
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.air import session as air_session
from ray_tpu_torch.train._internal.backend_executor import (
    BackendExecutor,
    GangResizeNeeded,
    TrainingWorkerError,
)
from ray_tpu_torch.train._internal.checkpoint_manager import CheckpointManager
from ray_tpu_torch.train._internal.ledger import GoodputLedger
from ray_tpu_torch.train.backend import BackendConfig
from ray_tpu_torch.train.base_trainer import BaseTrainer

# Distinguishes concurrent/successive fits from one driver when there is no
# Tune trial id to serve as the gang id.
_GANG_SEQ = itertools.count()


class DataParallelTrainer(BaseTrainer):
    _default_backend_config: Callable[[], BackendConfig] = BackendConfig

    def __init__(
        self,
        train_loop_per_worker: Callable[[Dict[str, Any]], None],
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        backend_config: Optional[BackendConfig] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        metadata: Optional[Dict[str, Any]] = None,
    ):
        from ray_tpu_torch._private import usage

        usage.record_library_usage("train")
        super().__init__(
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint,
            metadata=metadata,
        )
        if not callable(train_loop_per_worker):
            raise TypeError("train_loop_per_worker must be callable")
        self._train_fn = train_loop_per_worker
        self._train_loop_config = dict(train_loop_config or {})
        self.backend_config = backend_config or type(self)._default_backend_config()
        self._inside_tune = False

    # ------------------------------------------------------------- data ingest
    def _dataset_shards(
        self, num_workers: Optional[int] = None
    ) -> Optional[List[Dict[str, Any]]]:
        """Pipelined per-worker iterators over each provided dataset (Data
        P18 ingest seam; reference: `streaming_split` feeding
        `session.get_dataset_shard`, `python/ray/data/dataset.py:1134`).

        ray_tpu_torch.data Datasets become `DataIterator`s over ONE shared
        executing stream — blocks are produced DURING training and assigned
        to workers on demand, so epoch ingest overlaps the train loop and
        nothing materializes up front. Anything else is replicated to every
        worker.
        """
        if not self.datasets:
            return None
        n = num_workers or self.scaling_config.num_workers
        shards: List[Dict[str, Any]] = [{} for _ in range(n)]
        for name, ds in self.datasets.items():
            if hasattr(ds, "streaming_split"):
                parts = ds.streaming_split(n, equal=True)
                for i in range(n):
                    shards[i][name] = parts[i]
            else:
                for i in range(n):
                    shards[i][name] = ds
        return shards

    # ------------------------------------------------------------- elastic path
    def _resize_and_resume(
        self,
        executor: BackendExecutor,
        reason: str,
        grow: bool,
        ledger,
        gang_id: str,
        ckpt_mgr: CheckpointManager,
        latest_ckpt: Optional[Checkpoint],
    ) -> Optional[Checkpoint]:
        """Re-form an elastic gang in place and restart its sessions from the
        newest checkpoint. Returns the checkpoint resumed from; raises
        TrainingWorkerError (budgeted, whole-gang restart) when the gang
        cannot re-form at min_workers."""
        info = executor.resize_gang(reason, grow=grow)
        resume_ckpt = (
            info["checkpoint"] or ckpt_mgr.latest_checkpoint or latest_ckpt
        )
        executor.start_training(
            self._train_fn,
            self._train_loop_config,
            checkpoint=resume_ckpt,
            dataset_shards=self._dataset_shards(info["new_world"]),
        )
        # Everything since the last round fold — detection, drain, respawn,
        # re-rendezvous, session re-init — is the resize badput window; its
        # length is the per-event time-to-recover.
        resize_s = ledger.account("resize") if ledger is not None else 0.0
        direction = "grow" if info["new_world"] > info["old_world"] else "shrink"
        from ray_tpu_torch._private.events import emit_event
        from ray_tpu_torch._private.telemetry import metrics_enabled, train_metrics

        emit_event(
            "train_gang_resize",
            f"gang {gang_id}: re-formed {info['old_world']} -> "
            f"{info['new_world']} workers ({reason}; {resize_s:.2f}s, "
            f"resumed from {info['ckpt_source']} checkpoint)",
            severity="warning",
            source="train-driver",
            gang=gang_id,
            old_world=info["old_world"],
            new_world=info["new_world"],
            direction=direction,
            reason=reason,
            resize_s=round(resize_s, 6),
            ckpt_source=info["ckpt_source"],
            step=info["recovered_step"],
        )
        if metrics_enabled():
            train_metrics()["resize_total"].inc(
                1, {"gang": gang_id, "direction": direction}
            )
        if ledger is not None:
            ledger.note_resize(
                info["old_world"], info["new_world"], reason, resize_s,
                info["ckpt_source"],
            )
        return resume_ckpt

    # ---------------------------------------------------------------- fit loop
    def _fit_impl(self, trial_info: Optional[Dict[str, str]] = None) -> Result:
        # Inside a Tune sweep each trial must checkpoint into its own trial
        # directory, never the shared trainer run_dir (concurrent trials would
        # overwrite/prune each other's checkpoint_NNNNNN entries).
        run_dir = (trial_info or {}).get("trial_dir") or self.run_dir()
        ckpt_mgr = CheckpointManager(run_dir, self.run_config.checkpoint_config)
        max_failures = self.run_config.failure_config.max_failures
        latest_ckpt = self.resume_from_checkpoint
        last_metrics: Optional[Dict[str, Any]] = None
        failures = 0
        tune_session = air_session._get_session() if self._inside_tune else None

        # One gang id (and one goodput ledger) per fit: restarts keep both so
        # recovery shows up as badput of the same run, not a fresh ledger.
        gang_id = (trial_info or {}).get("trial_id") or (
            f"train-{os.getpid()}-{next(_GANG_SEQ)}"
        )
        from ray_tpu_torch._private.telemetry import metrics_enabled

        ledger = (
            GoodputLedger(gang_id, self.scaling_config.num_workers)
            if metrics_enabled()
            else None
        )

        while True:
            executor = BackendExecutor(
                self.backend_config, self.scaling_config, trial_info,
                gang_id=gang_id, ledger=ledger,
            )
            try:
                recovering = failures > 0
                executor.start()
                executor.start_training(
                    self._train_fn,
                    self._train_loop_config,
                    checkpoint=latest_ckpt,
                    dataset_shards=self._dataset_shards(),
                )
                if ledger is not None:
                    if recovering:
                        # Detection + full gang restart: all recover badput.
                        recover_s = ledger.account("recover")
                        from ray_tpu_torch._private.events import emit_event

                        emit_event(
                            "train_gang_recover",
                            f"gang {gang_id}: restarted after worker failure "
                            f"#{failures} ({recover_s:.2f}s to recover)",
                            severity="warning",
                            source="train-driver",
                            gang=gang_id,
                            failures=failures,
                            recover_s=round(recover_s, 6),
                        )
                    else:
                        ledger.account_init(executor.gang_rendezvous_seconds())
                while True:
                    try:
                        results = executor.get_next_results()
                    except GangResizeNeeded as sig:
                        # Elastic membership change: re-form in place, resume
                        # from the newest checkpoint (in-memory replica when
                        # it beats the last disk persist). NOT a failure.
                        latest_ckpt = self._resize_and_resume(
                            executor, sig.reason, sig.grow, ledger, gang_id,
                            ckpt_mgr, latest_ckpt,
                        )
                        continue
                    if results is None:
                        break
                    rank0 = results[0]
                    last_metrics = rank0.metrics
                    ckpt = next(
                        (r.checkpoint for r in results if r.checkpoint is not None),
                        None,
                    )
                    if ckpt is not None:
                        latest_ckpt = ckpt_mgr.register(ckpt, rank0.metrics)
                        executor.note_persisted_checkpoint()
                        if ledger is not None:
                            # Driver-side persist rides the checkpoint bucket.
                            ledger.account("checkpoint")
                    if tune_session is not None:
                        # Forward to Tune so schedulers/search see every report.
                        tune_session.report(
                            dict(last_metrics or {}),
                            checkpoint=ckpt if ckpt is not None else None,
                        )
                    if executor.should_grow():
                        # Capacity returned: re-expand toward the target.
                        latest_ckpt = self._resize_and_resume(
                            executor, "capacity returned", True, ledger,
                            gang_id, ckpt_mgr, latest_ckpt,
                        )
                executor.shutdown()
                if ledger is not None:
                    ledger.finalize("done")
                return Result(
                    metrics=last_metrics,
                    checkpoint=ckpt_mgr.best_checkpoint(),
                    error=None,
                    path=run_dir,
                    best_checkpoints=ckpt_mgr.best_checkpoints(),
                )
            except TrainingWorkerError as e:
                executor.shutdown()
                failures += 1
                if ledger is not None:
                    ledger.failures = failures
                if max_failures >= 0 and failures > max_failures:
                    if ledger is not None:
                        ledger.finalize("failed")
                    return Result(
                        metrics=last_metrics,
                        checkpoint=ckpt_mgr.best_checkpoint(),
                        error=e,
                        path=run_dir,
                    )
                # Retry the whole gang from the most recent checkpoint.
                latest_ckpt = ckpt_mgr.latest_checkpoint or latest_ckpt
            except BaseException as e:  # driver-side bug: no retry
                executor.shutdown()
                if ledger is not None:
                    ledger.finalize("failed")
                if not isinstance(e, Exception):
                    raise  # KeyboardInterrupt/SystemExit must propagate
                return Result(
                    metrics=last_metrics,
                    checkpoint=ckpt_mgr.best_checkpoint(),
                    error=e if isinstance(e, Exception) else RuntimeError(str(e)),
                    path=run_dir,
                )
