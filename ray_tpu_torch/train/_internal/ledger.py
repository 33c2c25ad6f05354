"""Goodput ledger: classifies a training gang's wall time into productive
step time vs badput buckets, driver-side.

Every second of a fit() is claimed by exactly one bucket:

  productive      gang-mean step compute + collective time (real training)
  init            first gang bring-up (placement group, actors, backend
                  on_start) minus the rendezvous share below
  compile         gang-mean time in the "compile" phase (cold jit, mesh build)
  rendezvous_wait blocked joining the gang (a backend's process-group init,
                  collective KV rendezvous) — from the workers' rendezvous
                  wait accumulators
  checkpoint      gang-mean "checkpoint" phase + driver-side persist
                  (CheckpointManager.register)
  recover         failure detection + full gang restart after a
                  TrainingWorkerError
  resize          elastic membership change: drain at the step boundary,
                  re-rendezvous at the new world size, session re-init
                  (resizes are not failures and not recover)
  idle            everything else: data_wait, report backpressure, driver
                  overhead between rounds

Accounting is interval-chained: the ledger keeps one monotonic mark and every
account_*/fold_round call classifies exactly the wall time since the previous
mark, so the buckets sum to the observed wall time by construction (coverage
~= 1.0; worker-reported phase splits are scaled down if clock skew makes them
exceed the driver-observed interval, never up).

The current report is published to the GCS KV under `train::<gang_id>` so
`state.training_report()`, the dashboard `/api/train`, and
`python -m ray_tpu_torch train` can all read it without new wire plumbing.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional

BUCKETS = (
    "productive", "init", "compile", "rendezvous_wait",
    "checkpoint", "recover", "resize", "idle",
)

# Worker step-phase -> ledger bucket for the per-round fold. data_wait and
# report are driver/input-bound, not chip work: badput (idle).
_PHASE_BUCKET = {
    "step_exec": "productive",
    "collective": "productive",
    "compile": "compile",
    "checkpoint": "checkpoint",
    "data_wait": "idle",
    "report": "idle",
}

# Publish throttle: at most one KV write per this many seconds mid-run
# (finalize always publishes).
_PUBLISH_INTERVAL_S = 0.5

KV_PREFIX = b"train::"


def report_key(gang: str) -> bytes:
    return KV_PREFIX + gang.encode()


class GoodputLedger:
    """One per fit(); survives gang restarts (recover is a bucket, not a new
    ledger). Driver-thread only."""

    def __init__(self, gang: str, world_size: int):
        self.gang = gang
        self.world_size = world_size
        self._wall_t0 = time.perf_counter()
        self._mark = self._wall_t0
        self.buckets: Dict[str, float] = {b: 0.0 for b in BUCKETS}
        self.steps = 0
        self.failures = 0
        # Elastic membership changes (not failures): count + last transition.
        self.resizes = 0
        self.last_resize: Optional[Dict[str, Any]] = None
        self.proactive_checkpoints = 0
        self.status = "running"
        self.max_skew_s = 0.0
        self.last_skew_s = 0.0
        self.per_rank: Dict[str, Dict[str, Any]] = {}
        # Straggler naming is modal, not max: the rank that is slowest in the
        # most rounds. A single noisy round (gang bring-up stagger inflates
        # everyone's first step differently) must not name the straggler for
        # the whole run.
        self._slow_rounds: Dict[int, int] = {}
        self._slow_last: Dict[int, Dict[str, Any]] = {}
        self._last_publish = 0.0

    # ------------------------------------------------------------- intervals
    def _take(self) -> float:
        now = time.perf_counter()
        dt = max(0.0, now - self._mark)
        self._mark = now
        return dt

    def account(self, bucket: str) -> float:
        """Classify everything since the last mark into one bucket."""
        dt = self._take()
        self.buckets[bucket] += dt
        return dt

    def account_init(self, rendezvous_s: float) -> None:
        """First bring-up window: the gang-join blocking the workers measured
        is rendezvous_wait; the rest (PG, actor spawn, backend) is init."""
        dt = self._take()
        r = min(max(0.0, rendezvous_s), dt)
        self.buckets["rendezvous_wait"] += r
        self.buckets["init"] += dt - r
        self.publish()

    def fold_round(self, telems: List[Dict[str, Any]]) -> None:
        """Classify one result round from the gang's per-step telemetry dicts
        (one per rank; may be empty when observability is off)."""
        dt = self._take()
        if not telems:
            self.buckets["idle"] += dt
            return
        self.steps += 1
        n = len(telems)
        means: Dict[str, float] = {}
        for t in telems:
            for p, v in (t.get("phases") or {}).items():
                means[p] = means.get(p, 0.0) + v / n
        total = sum(means.values())
        # Worker clocks can drift past the driver-observed interval; scale
        # down so the round never claims more wall time than it occupied.
        scale = min(1.0, dt / total) if total > 0.0 else 0.0
        for p, v in means.items():
            self.buckets[_PHASE_BUCKET.get(p, "idle")] += v * scale
        self.buckets["idle"] += dt - total * scale
        self.publish()

    def note_skew(self, skew_s: float, straggler: Optional[Dict[str, Any]],
                  per_rank: Dict[str, Dict[str, Any]]) -> None:
        self.last_skew_s = skew_s
        self.max_skew_s = max(self.max_skew_s, skew_s)
        if straggler is not None:
            rank = straggler["rank"]
            self._slow_rounds[rank] = self._slow_rounds.get(rank, 0) + 1
            self._slow_last[rank] = straggler
        self.per_rank = per_rank

    def note_resize(self, old_world: int, new_world: int, reason: str,
                    resize_s: float, ckpt_source: str) -> None:
        """Record one elastic membership change; the wall time was already
        accounted into the resize bucket by the trainer."""
        self.resizes += 1
        self.world_size = new_world
        self.last_resize = {
            "old_world": old_world,
            "new_world": new_world,
            "direction": "grow" if new_world > old_world else "shrink",
            "reason": reason,
            "resize_s": round(resize_s, 6),
            "ckpt_source": ckpt_source,
        }
        self.publish(force=True)

    @property
    def straggler(self) -> Optional[Dict[str, Any]]:
        """The modal slow rank with its latest round's phase attribution,
        plus how many rounds it was the slowest."""
        if not self._slow_rounds:
            return None
        rank = max(self._slow_rounds, key=self._slow_rounds.get)
        out = dict(self._slow_last[rank])
        out["slow_rounds"] = self._slow_rounds[rank]
        out["rounds"] = sum(self._slow_rounds.values())
        return out

    # --------------------------------------------------------------- report
    def wall_s(self) -> float:
        return time.perf_counter() - self._wall_t0

    def report(self) -> Dict[str, Any]:
        wall = self.wall_s()
        accounted = sum(self.buckets.values())
        return {
            "gang": self.gang,
            "world_size": self.world_size,
            "status": self.status,
            "updated_at": time.time(),
            "wall_s": round(wall, 6),
            "buckets": {b: round(v, 6) for b, v in self.buckets.items()},
            "coverage": round(accounted / wall, 4) if wall > 0 else 1.0,
            "goodput_frac": round(self.buckets["productive"] / wall, 4)
            if wall > 0 else 0.0,
            "steps": self.steps,
            "failures": self.failures,
            "resizes": self.resizes,
            "last_resize": self.last_resize,
            "proactive_checkpoints": self.proactive_checkpoints,
            "skew_s": round(self.last_skew_s, 6),
            "max_skew_s": round(self.max_skew_s, 6),
            "straggler": self.straggler,
            "per_rank": self.per_rank,
        }

    def publish(self, force: bool = False) -> None:
        """Best-effort KV write of the current report (throttled mid-run).
        Gated on the observability knob; never raises."""
        try:
            from ray_tpu_torch._private.telemetry import obs_enabled

            if not obs_enabled():
                return
            now = time.monotonic()
            if not force and now - self._last_publish < _PUBLISH_INTERVAL_S:
                return
            self._last_publish = now
            from ray_tpu_torch._private.worker import global_worker

            ctx = global_worker.context
            if ctx is None:
                return
            ctx.kv("put", report_key(self.gang),
                   json.dumps(self.report()).encode())
        except Exception:  # noqa: BLE001 — shutdown races, head gone
            pass

    def finalize(self, status: str) -> Dict[str, Any]:
        """Sweep the tail into idle, stamp final status, publish."""
        self.account("idle")
        self.status = status
        self.publish(force=True)
        return self.report()
