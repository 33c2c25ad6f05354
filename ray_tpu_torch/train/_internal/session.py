"""Per-worker training session: runs the user loop in a thread and streams
results to the driver.

Reference: `python/ray/train/_internal/session.py` (the thread-based
`_TrainSession`): `session.report` enqueues a `TrainingResult`; the driver's
`BackendExecutor.get_next_results` round-robins `next_result()` across the
gang. The queue is bounded at 1 so training naturally backpressures on the
driver consuming results (and a checkpoint is fully handed off before the
loop continues — the property PBT-style mutation relies on).
"""

from __future__ import annotations

import queue
import threading
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.air import session as air_session
from ray_tpu_torch.air.checkpoint import Checkpoint

REPORT = "report"
DONE = "done"
ERROR = "error"
# The session was stopped at a step boundary by an elastic drain — not an
# error, not a completion. Emitted to unblock any in-flight next_result.
DRAINED = "drained"


class SessionDrained(BaseException):
    """Raised inside `session.report` when the driver drained this rank at a
    step boundary (elastic resize). Derives from BaseException so a user
    loop's `except Exception` cannot swallow the gang's stop request."""


@dataclass
class TrainingResult:
    type: str  # REPORT | DONE | ERROR
    metrics: Optional[Dict[str, Any]] = None
    checkpoint: Optional[Checkpoint] = None
    error: Optional[str] = None
    world_rank: int = 0
    # Step-clock payload (train/_internal/telemetry.py): per-step phase split
    # on REPORT, cumulative totals on DONE. None when observability is off.
    telemetry: Optional[Dict[str, Any]] = None


@dataclass
class SessionArgs:
    train_fn: Callable
    config: Dict[str, Any]
    world_rank: int
    world_size: int
    local_rank: int
    local_world_size: int
    node_rank: int
    trial_name: str = ""
    trial_id: str = ""
    trial_dir: str = ""
    experiment_name: str = ""
    checkpoint: Optional[Checkpoint] = None
    dataset_shards: Dict[str, Any] = field(default_factory=dict)
    # () -> DeviceMesh, run in the session thread the first time the loop
    # asks for the mesh (session.get_mesh()).
    mesh_builder: Optional[Callable] = None
    # Stable id shared by every rank (and every restart) of one fit() — the
    # `gang` tag on train metrics and the training_report KV key.
    gang_id: str = ""


class _TrainSession:
    def __init__(self, args: SessionArgs):
        self.args = args
        self.world_rank = args.world_rank
        self.world_size = args.world_size
        self.local_rank = args.local_rank
        self.local_world_size = args.local_world_size
        self.node_rank = args.node_rank
        self.trial_name = args.trial_name
        self.trial_id = args.trial_id
        self.trial_dir = args.trial_dir
        self.experiment_name = args.experiment_name
        self.loaded_checkpoint = args.checkpoint
        self.dataset_shards = args.dataset_shards
        self._mesh = None
        self.gang_id = args.gang_id or args.trial_id or "default"
        self._clock = None  # StepClock, built in-thread by _run
        self._q: "queue.Queue[TrainingResult]" = queue.Queue(maxsize=1)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._finished = threading.Event()
        # Elastic drain: set by the driver (via the worker actor) to stop the
        # loop at the next step boundary; `drained` records a clean stop.
        self._stop = threading.Event()
        self.drained = False
        self._reported_steps = 0

    @property
    def mesh(self):
        """The run's ``DeviceMesh``: built by the backend's mesh builder the
        first time the loop asks (in this session's thread, on the gang's
        process group), then kept. None without a builder."""
        if self._mesh is None and self.args.mesh_builder is not None:
            if self._clock is not None:
                self._clock.mark("compile")
            self._mesh = self.args.mesh_builder()
            if self._clock is not None:
                self._clock.mark("step_exec")
        return self._mesh

    # ----------------------------------------------------------- thread side
    def _run(self):
        from ray_tpu_torch.train._internal.telemetry import make_clock

        air_session._set_session(self)
        try:
            # Built here, not in __init__: the train_step span must live in
            # this thread so collective spans auto-parent under it.
            self._clock = make_clock(self.gang_id, self.world_rank)
            self.args.train_fn(self.args.config)
            done = TrainingResult(DONE, world_rank=self.world_rank)
            if self._clock is not None:
                totals = self._clock.finalize()
                if self._clock.metrics_on:
                    done.telemetry = totals
                    # The driver kills gang workers right after DONE — don't
                    # let a short run's step samples die in the 1 Hz flusher.
                    try:
                        from ray_tpu_torch.util.metrics import flush_metrics

                        flush_metrics()
                    except Exception:  # noqa: BLE001
                        pass
            self._q.put(done)
        except SessionDrained:
            # Elastic stop at a step boundary: clean, no result to forward
            # (the driver is not reading this queue any more — it is mid
            # resize and will re-init the session on the re-formed gang).
            self.drained = True
            if self._clock is not None:
                self._clock.finalize()
        except BaseException as e:  # noqa: BLE001 - forwarded to the driver
            if self._clock is not None:
                self._clock.finalize()
            self._q.put(
                TrainingResult(
                    ERROR,
                    error=f"{type(e).__name__}: {e}\n{traceback.format_exc()}",
                    world_rank=self.world_rank,
                )
            )
        finally:
            self._finished.set()
            air_session._set_session(None)

    def mark_phase(self, phase: str) -> None:
        """Explicit phase seam from the user loop (air.session.mark_phase).
        No-op when observability is off — marking costs nothing then."""
        if self._clock is not None:
            self._clock.mark(phase)

    def report(self, metrics: Dict[str, Any], *, checkpoint: Optional[Checkpoint] = None):
        from ray_tpu_torch._private import failpoints

        if self._stop.is_set():
            raise SessionDrained()
        if failpoints.ENABLED:
            # Injection point for straggler (delay) and mid-step crash
            # (recover accounting) scenarios: fires on the session thread
            # with the step still open, like a real slow/dying rank.
            failpoints.maybe_crash("train.step")
        result = TrainingResult(
            REPORT, metrics=dict(metrics), checkpoint=checkpoint,
            world_rank=self.world_rank,
        )
        clock = self._clock
        if clock is None:
            self._q.put(result)
            self._reported_steps += 1
            if self._stop.is_set():
                raise SessionDrained()
            return
        telem = clock.close_step(checkpoint=checkpoint is not None)
        if clock.metrics_on:
            result.telemetry = telem
        # The bounded-queue put is driver backpressure: accrue it as the
        # report (or checkpoint) phase of the step now opening.
        clock.mark("checkpoint" if checkpoint is not None else "report")
        try:
            self._q.put(result)
        finally:
            clock.mark("step_exec")
        self._reported_steps += 1
        # Second seam: the drain request may have landed while this thread
        # was blocked in the bounded-queue put above.
        if self._stop.is_set():
            raise SessionDrained()

    def stash_checkpoint(self, state: Any, *, rules=None,
                         step: Optional[int] = None) -> None:
        """In-memory checkpoint stash + peer mirror (elastic recovery). The
        state (this rank's shard under ``rules``, or the whole replicated
        state without them) is snapshot with its torch tensors on the CPU;
        the mirror push is fire-and-forget (see train/_internal/elastic.py)."""
        from ray_tpu_torch.air.checkpoint import _tree_to_host
        from ray_tpu_torch.train._internal import elastic

        elastic.stash(
            rank=self.world_rank,
            step=self._reported_steps if step is None else int(step),
            world_size=self.world_size,
            state=_tree_to_host(state),
            rules=rules,
        )

    # ----------------------------------------------------------- driver side
    def start(self):
        self._thread.start()

    def next_result(self, timeout: Optional[float] = None) -> TrainingResult:
        # Polling get, not a bare blocking get: a drained session puts nothing
        # more, and the actor thread parked here must unwind (the driver has
        # abandoned the ref) instead of pinning a concurrency slot forever.
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            try:
                return self._q.get(timeout=0.2)
            except queue.Empty:
                if self._finished.is_set() and self._q.empty():
                    return TrainingResult(DRAINED, world_rank=self.world_rank)
                if deadline is not None and time.monotonic() >= deadline:
                    raise

    def request_stop(self) -> None:
        self._stop.set()

    def drain(self, timeout: float = 10.0) -> bool:
        """Stop the session at the next step boundary and unblock a put-
        blocked report by consuming the queue. Returns True when the loop
        thread actually finished within the timeout (a False return means the
        rank is stuck mid-step — collective hang, very long step — and the
        caller should treat it as dead). Once the loop has stopped, or
        halfway through the timeout (at most 5 s), this rank's process
        groups are aborted: a rank blocked in a collective whose peer is gone
        or already stopped never returns from it otherwise (NCCL waits on
        the peer for good; gloo waits on a live peer that stopped), and an
        aborted NCCL group fails its peers' pending collectives too (gloo's
        abort does not: a gloo rank blocked on a live peer waits out the
        group's timeout). The gang makes new groups after a drain."""
        self._stop.set()
        start = time.monotonic()
        deadline, abort_at = start + timeout, start + min(timeout / 2, 5.0)
        aborted = False
        while True:
            if not aborted and (self._finished.is_set() or time.monotonic() >= abort_at):
                aborted = True
                _abort_collectives()
            if self._finished.is_set() or time.monotonic() >= deadline:
                return self._finished.is_set()
            try:
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass

    def telemetry_snapshot(self) -> Optional[Dict[str, Any]]:
        """Cumulative phase totals so far (driver-pollable, no step close).
        Benign cross-thread read of monotone floats; None with obs off."""
        clock = self._clock
        if clock is None or not clock.metrics_on:
            return None
        return clock.snapshot()

    def finished(self) -> bool:
        return self._finished.is_set()


def _abort_collectives() -> None:
    """Abort this process's torch.distributed groups, so that the collectives
    waiting in them fail and the loop thread can finish (the backend's
    ``on_shutdown`` and ``on_start`` make the next group)."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return
    from torch.distributed.distributed_c10d import _abort_process_group

    try:
        _abort_process_group()
    except Exception:  # noqa: BLE001 - a backend without abort: the drain times out
        traceback.print_exc()


# Bound in the worker process by init_session / torn down by shutdown_session.
_session: Optional[_TrainSession] = None


def init_session(args: SessionArgs) -> None:
    global _session
    if _session is not None and not _session.finished():
        raise RuntimeError("a training session is already running in this worker")
    _session = _TrainSession(args)
    _session.start()


def get_session() -> _TrainSession:
    if _session is None:
        raise RuntimeError("no training session in this worker")
    return _session


def shutdown_session() -> None:
    global _session
    _session = None
