"""Per-process sampling profiler over ``sys._current_frames()``.

The reference exposes per-worker profiling through py-spy and the dashboard's
"CPU flame graph" button; this build keeps the capability dependency-free: a
background thread samples every thread's Python stack at ``profiler_hz`` and
aggregates **folded stacks** (`root;...;leaf` semicolon chains -> sample
count, the flamegraph.pl / speedscope input format). The scheduler
broadcasts ("profile_start", hz) / ("profile_stop", token) so one
`ray_tpu_torch.util.state.profile(duration_s)` call profiles the whole cluster and
merges the per-process folds.

Zero overhead when off (the same contract as failpoints/invariants): no
sampler thread exists unless a profile is running, nothing on the task hot
path ever consults this module, and `Config.enable_profiler=False` stops the
scheduler from ever broadcasting the start/stop messages.

Sampling cost while ON is bounded by `hz` x thread count: each tick formats
frame identifiers only (no line-text I/O), skipping the sampler thread
itself.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Dict

MAX_DEPTH = 64

# Hard ceiling on one sampling session. A profile_stop can get lost (the
# requesting driver dies mid-profile, a partition eats the broadcast): the
# sampler must not run forever on every process in the cluster. The folded
# data survives the auto-stop for a late profile_stop to collect.
MAX_SESSION_S = 120.0


class _Sampler:
    def __init__(self, hz: float):
        self.hz = max(1.0, min(1000.0, float(hz)))
        self.folded: Dict[str, int] = {}
        self.samples = 0
        self.started_at = time.time()
        self._stop = threading.Event()
        self.thread = threading.Thread(
            target=self._run, daemon=True, name="profiler-sample"
        )
        self.thread.start()

    def _run(self) -> None:
        period = 1.0 / self.hz
        me = threading.get_ident()
        deadline = self.started_at + MAX_SESSION_S
        while not self._stop.wait(period):
            if time.time() > deadline:
                return  # orphaned session (stop broadcast lost): self-bound
            self._sample_once(me)

    def _sample_once(self, me: int) -> None:
        names = {t.ident: t.name for t in threading.enumerate()}
        frames = sys._current_frames()
        self.samples += 1
        for tid, frame in frames.items():
            if tid == me:
                continue  # never profile the profiler
            parts = []
            f = frame
            while f is not None and len(parts) < MAX_DEPTH:
                code = f.f_code
                parts.append(
                    f"{code.co_name} ({os.path.basename(code.co_filename)}"
                    f":{f.f_lineno})"
                )
                f = f.f_back
            parts.reverse()  # folded format is root-first
            key = names.get(tid, f"thread-{tid}") + ";" + ";".join(parts)
            self.folded[key] = self.folded.get(key, 0) + 1

    def finish(self) -> Dict[str, Any]:
        self._stop.set()
        self.thread.join(timeout=2.0)
        return {
            "folded": dict(self.folded),
            "samples": self.samples,
            "duration_s": time.time() - self.started_at,
            "hz": self.hz,
            "pid": os.getpid(),
            "started_at": self.started_at,
        }


_lock = threading.Lock()
_sampler: _Sampler | None = None


def start(hz: float) -> None:
    """Start (or restart, discarding the running session's samples) this
    process's sampler."""
    global _sampler
    with _lock:
        if _sampler is not None:
            _sampler._stop.set()
        _sampler = _Sampler(hz)


def stop() -> Dict[str, Any]:
    """Stop the sampler and return its folded stacks; an empty payload when
    none is running (e.g. a worker spawned mid-profile that never saw the
    start broadcast)."""
    global _sampler
    with _lock:
        s, _sampler = _sampler, None
    if s is None:
        return {"folded": {}, "samples": 0, "duration_s": 0.0, "hz": 0.0,
                "pid": os.getpid(), "started_at": None}
    return s.finish()


def is_running() -> bool:
    return _sampler is not None
