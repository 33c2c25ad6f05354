"""DataContext: execution knobs for the streaming executor.

Reference: `python/ray/data/context.py` (`DataContext`, `DEFAULT_*` resource
budgets). A process-wide singleton read at plan-execution time; tests and
applications mutate it via `DataContext.get_current()`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import ClassVar, Optional


@dataclass
class DataContext:
    # Max concurrently-running tasks per physical operator (None = #CPUs).
    max_tasks_per_operator: Optional[int] = None
    # Global cap on bytes of produced-but-unconsumed blocks across the whole
    # pipeline. Upstream dispatch (and generator producers, via the core's
    # stream throttle) pauses when the pipeline is over budget.
    max_bytes_in_flight: int = 512 * 1024 * 1024
    # Per-operator cap on queued (completed, not yet consumed downstream)
    # output bundles.
    max_output_queue_blocks: int = 16
    # Producer-side window for streaming read tasks: a read generator may run
    # at most this many ITEMS (2 per block: block + meta) ahead of the
    # executor's consumption.
    read_generator_backpressure_blocks: int = 4
    # Executor poll quantum while waiting for task completions.
    scheduling_poll_s: float = 0.02

    _current: ClassVar[Optional["DataContext"]] = None

    @staticmethod
    def get_current() -> "DataContext":
        if DataContext._current is None:
            DataContext._current = DataContext()
        return DataContext._current
