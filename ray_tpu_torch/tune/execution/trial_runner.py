"""The Tune event loop: multiplexes live trials, applies scheduler decisions.

Reference: `python/ray/tune/execution/trial_runner.py:1181` (`TrialRunner`,
event loop `step():1358`) + `ray_trial_executor.py:185`. Each trial's function
trainable runs inside one actor (Train's thread-session streams its reports);
the loop waits on the outstanding `next_result` futures of all running trials
(`ray_tpu_torch.wait`), so a slow trial never blocks a fast one — the property
ASHA's asynchronous pruning depends on.

GPU delta: a trial's ``resources_per_trial`` names ``GPU`` where the
reference names ``TPU`` (``trial_actor_options``); the trial actor then holds
that share and sees its device id in ``CUDA_VISIBLE_DEVICES`` (fractions pack
onto one id). And a restored trial reads its checkpoint in place
(``_by_uri``), where the reference ships the directory to it as bytes.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.air.checkpoint import Checkpoint
from ray_tpu_torch.air.result import Result
from ray_tpu_torch.train._internal.session import DONE, ERROR, REPORT, SessionArgs
from ray_tpu_torch.train._internal.worker_group import RayTrainWorker
from ray_tpu_torch.tune.experiment import trial as trial_mod
from ray_tpu_torch.tune.experiment.trial import Trial
from ray_tpu_torch.tune.schedulers.trial_scheduler import (
    CONTINUE,
    RESTART,
    STOP,
    FIFOScheduler,
    TrialScheduler,
)


def trial_actor_options(resources: Dict[str, float]) -> Dict[str, Any]:
    """The trial actor's options from ``resources_per_trial``: ``CPU`` ->
    ``num_cpus``, ``GPU`` -> ``num_gpus``, anything else a custom resource.
    A ``TPU`` key raises: no node of this runtime has one, so the trial
    would never be placed."""
    res = dict(resources)
    if "TPU" in res:
        raise ValueError(
            f"resources_per_trial={resources} asks for TPU, which no node of this "
            "runtime has: ask for a share of a card as GPU instead, e.g. "
            "{'CPU': 1, 'GPU': 0.5}"
        )
    opts: Dict[str, Any] = {"num_cpus": res.pop("CPU", 1.0)}
    if "GPU" in res:
        opts["num_gpus"] = res.pop("GPU")
    if res:
        opts["resources"] = res
    return opts


def _by_uri(checkpoint: Optional[Checkpoint]) -> Optional[Checkpoint]:
    """A checkpoint persisted under the experiment directory, as a ``file://``
    URI: the trial reads it in place. Pickled as a directory, it would cross
    to the trial actor as one in-band tar of the whole directory, extracted
    into a temporary directory that nothing removes (an exploit of GPT-2
    small's params and AdamW state moves 1.5 GB that way). The experiment
    directory is storage the trials share, as the workflow root is; a
    trial's checkpoint manager keeps every checkpoint, so none is pruned
    before the trial reads it."""
    if checkpoint is None or not (checkpoint.uri or "").startswith("file://"):
        return checkpoint
    return Checkpoint(uri=checkpoint.uri)


class TrialRunner:
    def __init__(
        self,
        train_fn: Callable[[Dict[str, Any]], None],
        trials: List[Trial],
        scheduler: Optional[TrialScheduler] = None,
        max_concurrent: Optional[int] = None,
        resources_per_trial: Optional[Dict[str, float]] = None,
        stop: Any = None,  # metric-threshold dict | Stopper | callable
        experiment_name: str = "",
        searcher=None,
        num_samples: int = 0,
        trial_factory=None,
        experiment_dir: Optional[str] = None,
        callbacks=None,
    ):
        from ray_tpu_torch.tune.callback import CallbackList

        self._callbacks = CallbackList(callbacks)
        # Monotonic event-loop step count passed to every callback hook
        # (reference: Callback `iteration` argument).
        self._iteration = 0
        self._train_fn = train_fn
        self.trials = trials
        # Adaptive mode: `searcher.suggest()` creates trials as capacity
        # frees (up to num_samples), so later configs condition on earlier
        # results (the reference's SearchGenerator behavior).
        self._searcher = searcher
        self._num_samples = num_samples
        self._trial_factory = trial_factory
        self._scheduler = scheduler or FIFOScheduler()
        self._max_concurrent = max_concurrent or 8
        self._resources = dict(resources_per_trial or {"CPU": 1.0})
        from ray_tpu_torch.tune.stopper import Stopper, coerce_stopper

        stop = coerce_stopper(stop)
        self._stopper: Optional[Stopper] = (
            stop if isinstance(stop, Stopper) else None
        )
        self._stop = dict(stop or {}) if isinstance(stop, (dict, type(None))) else {}
        self._stop_all = False
        self._experiment_name = experiment_name
        self._actors: Dict[str, Any] = {}  # trial_id -> actor handle
        self._refs: Dict[Any, Trial] = {}  # outstanding next_result ref -> trial
        self._experiment_dir = experiment_dir
        for t in trials:
            self._scheduler.on_trial_add(self, t)

    def _save_state(self, force: bool = False) -> None:
        """Journal every trial's state to <experiment_dir>/experiment_state.json
        (atomic replace) so a killed driver can `Tuner.restore` (reference:
        `TrialRunner.checkpoint`, throttled like the reference's
        `checkpoint_period`). Lifecycle transitions force a write; per-report
        writes are rate-limited — the journal is O(all trials) JSON."""
        if self._experiment_dir is None:
            return
        now = time.time()
        if not force and now - getattr(self, "_last_journal", 0.0) < 2.0:
            return
        self._last_journal = now
        import json
        import os

        path = os.path.join(self._experiment_dir, "experiment_state.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump({"trials": [t.to_state() for t in self.trials]}, f)
            os.replace(tmp, path)
        except Exception:  # noqa: BLE001 — journaling must never kill the run
            try:
                os.unlink(tmp)
            except OSError:
                pass

    # ------------------------------------------------------------------ launch
    def _actor_options(self) -> Dict[str, Any]:
        return trial_actor_options(self._resources)

    def _launch(self, trial: Trial) -> None:
        actor = ray_tpu_torch.remote(RayTrainWorker).options(**self._actor_options()).remote()
        args = SessionArgs(
            train_fn=self._train_fn,
            config=dict(trial.config),
            world_rank=0,
            world_size=1,
            local_rank=0,
            local_world_size=1,
            node_rank=0,
            trial_name=trial.name,
            trial_id=trial.trial_id,
            trial_dir=trial.local_dir,
            experiment_name=self._experiment_name,
            checkpoint=_by_uri(trial.restore_checkpoint or trial.checkpoint),
        )
        ray_tpu_torch.get(actor.init_session.remote(args))
        trial.restore_checkpoint = None
        trial.status = trial_mod.RUNNING
        self._actors[trial.trial_id] = actor
        self._refs[actor.next_result.remote()] = trial
        self._save_state(force=True)
        self._callbacks.fire(
            "on_trial_start", self._iteration, self.trials, trial
        )

    def _teardown(self, trial: Trial) -> None:
        actor = self._actors.pop(trial.trial_id, None)
        if actor is not None:
            try:
                ray_tpu_torch.kill(actor)
            except Exception:
                pass
        for ref, t in list(self._refs.items()):
            if t is trial:
                del self._refs[ref]

    # -------------------------------------------------------------------- run
    def _suggest_more(self) -> None:
        while (
            self._searcher is not None
            and len(self.trials) < self._num_samples
            and len(self._actors) < self._max_concurrent
        ):
            index = len(self.trials)
            trial = self._trial_factory(index)
            cfg = self._searcher.suggest(trial.trial_id)
            if cfg is None:
                self._num_samples = len(self.trials)
                return
            trial.config = dict(cfg)
            self.trials.append(trial)
            self._scheduler.on_trial_add(self, trial)
            self._launch(trial)

    def _complete(self, trial: Trial, error: bool = False) -> None:
        self._save_state(force=True)
        self._scheduler.on_trial_complete(self, trial)
        if self._searcher is not None:
            self._searcher.on_trial_complete(
                trial.trial_id, trial.last_result, error=error
            )
        self._callbacks.fire(
            "on_trial_error" if error else "on_trial_complete",
            self._iteration, self.trials, trial,
        )

    def run(self) -> None:
        self._callbacks.fire("setup")
        pending = [t for t in self.trials if t.status == trial_mod.PENDING]
        while pending or self._refs or (
            self._searcher is not None and len(self.trials) < self._num_samples
        ):
            if self._stop_all:
                # A Stopper ended the experiment: terminate everything live.
                for t in list(self._refs.values()):
                    t.status = trial_mod.TERMINATED
                    self._teardown(t)
                    self._complete(t)
                for t in pending:
                    t.status = trial_mod.TERMINATED
                pending.clear()
                self._num_samples = len(self.trials)
                continue
            while pending and len(self._actors) < self._max_concurrent:
                self._launch(pending.pop(0))
            self._suggest_more()
            if not self._refs:
                continue
            ready, _ = ray_tpu_torch.wait(
                list(self._refs.keys()), num_returns=1, timeout=5.0
            )
            self._iteration += 1
            for ref in ready:
                trial = self._refs.pop(ref)
                try:
                    tr = ray_tpu_torch.get(ref)
                except Exception as e:  # actor died
                    trial.status = trial_mod.ERROR
                    trial.error = str(e)
                    self._teardown(trial)
                    self._complete(trial, error=True)
                    continue
                if tr.type == ERROR:
                    trial.status = trial_mod.ERROR
                    trial.error = tr.error
                    self._teardown(trial)
                    self._complete(trial, error=True)
                elif tr.type == DONE:
                    trial.status = trial_mod.TERMINATED
                    self._teardown(trial)
                    self._complete(trial)
                else:  # REPORT
                    trial.num_results += 1
                    metrics = dict(tr.metrics or {})
                    metrics.setdefault("training_iteration", trial.num_results)
                    metrics.setdefault("trial_id", trial.trial_id)
                    metrics["config"] = dict(trial.config)
                    trial.last_result = metrics
                    if tr.checkpoint is not None:
                        trial.checkpoint_manager.register(tr.checkpoint, metrics)
                        self._callbacks.fire(
                            "on_checkpoint", self._iteration, self.trials,
                            trial, tr.checkpoint,
                        )
                    self._save_state()
                    self._callbacks.fire(
                        "on_trial_result", self._iteration, self.trials,
                        trial, metrics,
                    )
                    if self._should_stop(trial, metrics):
                        decision = STOP
                    else:
                        decision = self._scheduler.on_trial_result(self, trial, metrics)
                    if self._searcher is not None:
                        self._searcher.on_trial_result(trial.trial_id, metrics)
                    if decision == STOP:
                        trial.status = trial_mod.TERMINATED
                        self._teardown(trial)
                        self._complete(trial)
                    elif decision == RESTART:
                        trial.restarts += 1
                        self._teardown(trial)
                        self._launch(trial)
                    else:
                        actor = self._actors[trial.trial_id]
                        self._refs[actor.next_result.remote()] = trial
        self._callbacks.fire("on_experiment_end", self.trials)

    def _should_stop(self, trial: Trial, metrics: Dict[str, Any]) -> bool:
        if self._stopper is not None:
            should = self._stopper(trial.trial_id, metrics)
            # stop_all is consulted on EVERY result — even one that also
            # stops its own trial — or an experiment-wide stop could be
            # missed whenever the per-trial check fires first.
            if self._stopper.stop_all():
                self._stop_all = True
                return True
            if should:
                return True
        for k, v in self._stop.items():
            if k in metrics and metrics[k] >= v:
                return True
        return False

    # ----------------------------------------------------------------- results
    def results(self) -> List[Result]:
        out = []
        for t in self.trials:
            err = None
            if t.status == trial_mod.ERROR:
                err = RuntimeError(t.error or "trial failed")
            out.append(
                Result(
                    metrics=t.last_result,
                    checkpoint=t.checkpoint_manager.best_checkpoint(),
                    error=err,
                    path=t.local_dir,
                    best_checkpoints=t.checkpoint_manager.best_checkpoints(),
                )
            )
        return out
