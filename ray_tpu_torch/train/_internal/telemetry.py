"""Worker-side step clock for training-gang observability.

Every training step is split into named phases. The user loop marks the
explicit seams (`air.session.mark_phase("data_wait")` before pulling a batch,
`"compile"` around a cold jit, ...); the framework fills in the automatic
ones: collective time is folded out of the enclosing phase using the
`util.collective` per-process accumulators, and the result hand-off to the
driver (the bounded-queue put in `session.report`, i.e. driver backpressure)
is accrued as the "report" phase — "checkpoint" when a checkpoint rides the
report.

Per step the clock emits one `ray_tpu_train_step_seconds{phase,gang,rank}`
histogram sample per non-empty phase (behind `enable_metrics`) and one
"train_step" span (behind `enable_timeline`/tracing). The span is started
non-detached in the session thread, so collective/transfer spans opened by
the step body parent under it automatically. The per-step telemetry dict is
attached to each REPORT `TrainingResult`; the driver's BackendExecutor folds
gang-wide dicts into the skew report and goodput ledger.

Phase accounting is conservation-exact within a step: phases partition the
step wall time (collective time is *moved* from the phase it accrued inside,
never double-counted), so the driver can ledger gang wall time to >=95%
without guessing.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

# Step phases, in rough step order. "step_exec" is the default bucket: time
# not explicitly marked (and not claimed by an automatic seam) is compute.
PHASES = ("data_wait", "compile", "step_exec", "collective", "report", "checkpoint")

# Phases collective time can have accrued inside (same thread, so it is a
# slice of whatever phase was current when the op ran).
_COLLECTIVE_DONORS = ("step_exec", "data_wait", "compile", "checkpoint")


def _coll_snap():
    """Process totals of the seconds spent in ``ray_tpu_torch.util.collective``
    ops and of their arrival offsets. A bare ``torch.distributed`` call in the
    loop (a DDP or mesh step's own collectives) is not timed: its time stays
    in the phase that issued it."""
    from ray_tpu_torch.util.collective import collective

    return (
        collective._STATS["time_s"],
        collective._STATS["arrival_offset_s"],
    )


def _rdzv_snap() -> float:
    from ray_tpu_torch.util.collective import rendezvous

    return rendezvous._WAIT_STATS["wait_s"]


class StepClock:
    """Accrues wall time into the current phase; closed once per report.

    Thread discipline: construct and drive from the session thread only (the
    thread running train_fn) — the train_step span relies on that thread's
    tracing context, and the collective accumulators it diffs are bumped by
    the same thread.
    """

    def __init__(self, gang: str, rank: int):
        from ray_tpu_torch._private.config import get_config
        from ray_tpu_torch.util import tracing

        cfg = get_config()
        self.gang = gang or "default"
        self.rank = str(rank)
        self.metrics_on = bool(cfg.enable_metrics)
        self._want_span = bool(cfg.enable_timeline) or tracing.is_enabled()
        now = time.perf_counter()
        self._wall_t0 = now
        self._steps = 0
        self._totals: Dict[str, float] = {p: 0.0 for p in PHASES}
        self._total_rdzv = 0.0
        self._total_offset = 0.0
        self._span = None
        self._closed = False
        self._begin_step(now)

    # ------------------------------------------------------------ internals
    def _begin_step(self, now: float) -> None:
        self._step_t0 = now
        self._phase = "step_exec"
        self._phase_t0 = now
        self._acc: Dict[str, float] = {p: 0.0 for p in PHASES}
        self._coll_t0, self._off_t0 = _coll_snap()
        self._rdzv_t0 = _rdzv_snap()
        if self._want_span:
            from ray_tpu_torch.util import tracing

            self._span = tracing.start_span(
                "train_step",
                "train",
                attributes={
                    "gang": self.gang,
                    "rank": self.rank,
                    "step": str(self._steps),
                },
            )

    def _accrue(self, now: float) -> None:
        self._acc[self._phase] += now - self._phase_t0
        self._phase_t0 = now

    def _fold_collective(self) -> None:
        """Move collective wall time out of the phase(s) it ran inside."""
        coll_t, _ = _coll_snap()
        coll_d = max(0.0, coll_t - self._coll_t0)
        if coll_d <= 0.0:
            return
        donor = max(_COLLECTIVE_DONORS, key=lambda p: self._acc[p])
        take = min(self._acc[donor], coll_d)
        self._acc[donor] -= take
        self._acc["collective"] += take

    # ------------------------------------------------------------ public
    def mark(self, phase: str) -> None:
        if phase not in PHASES:
            raise ValueError(
                f"unknown training phase {phase!r}; one of {PHASES}"
            )
        self._accrue(time.perf_counter())
        self._phase = phase

    def close_step(self, *, checkpoint: bool = False) -> Dict[str, Any]:
        """Close the current step and return its telemetry dict. The caller
        hands the result to the driver afterwards, bracketed by
        mark("report"/"checkpoint") ... mark("step_exec"): the queue-put wait
        (driver backpressure) lands in the next step's report phase, keeping
        totals exact without racing the driver for the result object."""
        now = time.perf_counter()
        self._accrue(now)
        self._fold_collective()
        step_wall = now - self._step_t0
        _, off_t = _coll_snap()
        rdzv_d = max(0.0, _rdzv_snap() - self._rdzv_t0)
        off_d = max(0.0, off_t - self._off_t0)
        self._steps += 1
        for p, v in self._acc.items():
            self._totals[p] += v
        self._total_rdzv += rdzv_d
        self._total_offset += off_d
        telem = {
            "step": self._steps,
            "step_wall_s": step_wall,
            "phases": {p: v for p, v in self._acc.items() if v > 0.0},
            "rendezvous_wait_s": rdzv_d,
            "arrival_offset_s": off_d,
        }
        if self.metrics_on:
            from ray_tpu_torch._private.telemetry import train_metrics

            hist = train_metrics()["step_seconds"]
            for p, v in self._acc.items():
                if v > 0.0:
                    hist.observe(v, {"phase": p, "gang": self.gang, "rank": self.rank})
        if self._span is not None:
            from ray_tpu_torch.util import tracing

            tracing.end_span(self._span)
            self._span = None
        self._begin_step(now)
        return telem

    def snapshot(self) -> Dict[str, Any]:
        """Live cumulative view (driver-pollable; does not close anything)."""
        return {
            "gang": self.gang,
            "rank": int(self.rank),
            "steps": self._steps,
            "wall_s": time.perf_counter() - self._wall_t0,
            "phases": dict(self._totals),
            "rendezvous_wait_s": self._total_rdzv,
            "arrival_offset_s": self._total_offset,
        }

    def finalize(self) -> Dict[str, Any]:
        """Close out the session: accrue the tail, end any open span, return
        cumulative totals. Safe to call once from the session thread's
        finally block; later calls return the frozen totals."""
        if self._closed:
            return self.snapshot()
        self._closed = True
        now = time.perf_counter()
        self._accrue(now)
        self._fold_collective()
        for p, v in self._acc.items():
            self._totals[p] += v
        self._acc = {p: 0.0 for p in PHASES}
        if self._span is not None:
            from ray_tpu_torch.util import tracing

            tracing.end_span(self._span)
            self._span = None
        out = self.snapshot()
        out["wall_s"] = now - self._wall_t0
        # Process-lifetime rendezvous seconds: includes gang-join waits that
        # happened before this clock existed (a backend's gang join runs in
        # on_start, ahead of init_session) — the ledger wants those too.
        out["rendezvous_wait_total_s"] = _rdzv_snap()
        return out


def make_clock(gang: str, rank: int) -> Optional[StepClock]:
    """A StepClock when any observability sink is on, else None (the session
    skips all bookkeeping so knob-off training pays nothing)."""
    from ray_tpu_torch._private.config import get_config
    from ray_tpu_torch.util import tracing

    cfg = get_config()
    if not (cfg.enable_metrics or cfg.enable_timeline or tracing.is_enabled()):
        return None
    return StepClock(gang, rank)
