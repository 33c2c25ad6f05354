"""Preemption chaos lab: seeded, deterministic preemption schedules for
elastic gang training. The counterpart of ``ray_tpu/util/preemption.py``.

Accelerator hosts get preempted three ways, and the simulator models each:

  kill        SIGKILL the rank's worker process — the no-warning capacity
              loss (what `util.chaos.NodeKiller` does to whole nodes).
  notice      the SIGTERM-with-grace contract: the worker gets a preemption
              notice, flushes its newest checkpoint stash to its peer mirror
              (`RayTrainWorker.preemption_notice`), then exits before the
              grace window closes.
  step_crash  arm the `train.step` crash failpoint on the rank, so the
              death lands mid-step on the session thread (the failpoint-
              driven flavor of the same loss).
  node        remove the rank's whole node via a `cluster_utils.Cluster`
              (requires passing `cluster=`; the NodeKiller-style loss).

Schedules are *round*-indexed, not time-indexed: the driver consumes one
result round per lockstep step, so "preempt rank 2 at round 12" is exactly
reproducible — same seed, same schedule, same resize event sequence. The
simulator installs itself as a BackendExecutor round hook and fires due
events right after the round completes, i.e. the loss lands while the next
round is in flight, like a real preemption.
"""

from __future__ import annotations

import os
import random
import signal
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

MODES = ("kill", "notice", "step_crash", "node")


@dataclass
class PreemptionEvent:
    at_round: int
    rank: int
    mode: str = "kill"
    grace_s: float = 1.0

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")


@dataclass
class PreemptionSchedule:
    """An ordered list of preemption events; `seeded` derives one
    deterministically from a seed (same seed -> same schedule)."""

    events: List[PreemptionEvent] = field(default_factory=list)

    @classmethod
    def seeded(
        cls,
        seed: int,
        *,
        n_events: int = 2,
        min_round: int = 5,
        max_round: int = 40,
        world_size: int = 4,
        notice_frac: float = 0.5,
        grace_s: float = 1.0,
    ) -> "PreemptionSchedule":
        rng = random.Random(seed)
        events = [
            PreemptionEvent(
                at_round=rng.randrange(min_round, max_round),
                rank=rng.randrange(world_size),
                mode="notice" if rng.random() < notice_frac else "kill",
                grace_s=grace_s,
            )
            for _ in range(n_events)
        ]
        events.sort(key=lambda e: (e.at_round, e.rank))
        return cls(events)


def _arm_step_crash():
    """Runs on the target worker: arm a one-shot mid-step crash failpoint."""
    from ray_tpu_torch._private import failpoints

    failpoints.arm("train.step", "crash", trigger="once")


class PreemptionSimulator:
    """Fires a PreemptionSchedule against a live elastic gang.

    Install as a round hook (`backend_executor.register_round_hook`) so the
    schedule advances with the driver's result rounds; `fired` records what
    actually happened, `(round, rank, mode, pid)` per event, for determinism
    assertions (same seed -> same fired sequence).
    """

    def __init__(self, schedule: PreemptionSchedule, cluster=None):
        self.schedule = schedule
        self._cluster = cluster
        self._pending = sorted(
            schedule.events, key=lambda e: (e.at_round, e.rank)
        )
        self.fired: List[Dict[str, Any]] = []
        self._installed = False

    # ------------------------------------------------------------- lifecycle
    def install(self) -> "PreemptionSimulator":
        from ray_tpu_torch.train._internal import backend_executor

        backend_executor.register_round_hook(self.on_round)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            from ray_tpu_torch.train._internal import backend_executor

            backend_executor.unregister_round_hook(self.on_round)
            self._installed = False

    def __enter__(self) -> "PreemptionSimulator":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # --------------------------------------------------------------- firing
    def on_round(self, executor, round_idx: int) -> None:
        while self._pending and self._pending[0].at_round <= round_idx:
            self._fire(executor, self._pending.pop(0), round_idx)

    def _fire(self, executor, event: PreemptionEvent, round_idx: int) -> None:
        group = executor.worker_group
        if group is None or len(group) == 0:
            return
        idx = event.rank % len(group)
        meta = group.metadata
        pid = meta[idx].pid if idx < len(meta) else None
        record = {
            "round": round_idx,
            "at_round": event.at_round,
            "rank": idx,
            "mode": event.mode,
            "pid": pid,
        }
        try:
            if event.mode == "kill":
                if pid is not None:
                    os.kill(pid, signal.SIGKILL)
            elif event.mode == "notice":
                group.workers[idx].preemption_notice.remote(event.grace_s)
            elif event.mode == "step_crash":
                group.workers[idx].execute.remote(_arm_step_crash)
            elif event.mode == "node":
                if self._cluster is None:
                    raise ValueError("node-mode preemption needs cluster=")
                self._kill_node(pid)
        except ProcessLookupError:
            record["mode"] += ":already-dead"
        self.fired.append(record)

    def _kill_node(self, pid: Optional[int]) -> None:
        """Remove the cluster node hosting `pid` (NodeKiller-style loss: the
        whole host goes, not just the rank's process)."""
        import ray_tpu_torch
        from ray_tpu_torch._private.ids import NodeID

        for n in ray_tpu_torch.nodes():
            if not n.get("alive") or n.get("labels", {}).get("head") == "1":
                continue
            if any(w.get("pid") == pid for w in n.get("workers", [])):
                self._cluster.remove_node(NodeID.from_hex(n["node_id"]))
                return
