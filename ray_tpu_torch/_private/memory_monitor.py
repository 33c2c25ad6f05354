"""Memory monitor + OOM worker-killing policies.

Reference: `src/ray/common/memory_monitor.h:52` (periodic host-usage snapshot
with cgroup awareness, callback above a usage threshold) and
`src/ray/raylet/worker_killing_policy.h` (pluggable victim selection:
retriable-FIFO / retriable-LIFO / group-by-owner). The scheduler samples on
its loop; a node daemon samples its own host and reports pressure upstream —
either way the kill decision runs in the single-owner scheduler, which knows
every worker's running task and retry budget.

Test seam: `RAY_TPU_TORCH_FAKE_MEMORY_USAGE_FILE` points at a file holding
"<used_bytes> <total_bytes>"; chaos tests drive pressure deterministically
without risking the host. Writers MUST replace the file atomically
(write-temp + os.replace) — a torn read like "100 1" would parse as
10,000% usage and kill an innocent worker.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

FAKE_USAGE_ENV = "RAY_TPU_TORCH_FAKE_MEMORY_USAGE_FILE"

_CGROUP_PATHS = (
    # (limit, usage, stat file, inactive-file key) — v2 then v1, like the
    # reference. Reclaimable page cache (inactive_file) is subtracted from
    # usage: a streaming workload fills cache to the limit without real
    # pressure, and counting it would shoot innocent workers.
    (
        "/sys/fs/cgroup/memory.max",
        "/sys/fs/cgroup/memory.current",
        "/sys/fs/cgroup/memory.stat",
        "inactive_file",
    ),
    (
        "/sys/fs/cgroup/memory/memory.limit_in_bytes",
        "/sys/fs/cgroup/memory/memory.usage_in_bytes",
        "/sys/fs/cgroup/memory/memory.stat",
        "total_inactive_file",
    ),
)


def _read_stat_key(path: str, key: str) -> int:
    try:
        with open(path) as fh:
            for line in fh:
                parts = line.split()
                if len(parts) == 2 and parts[0] == key:
                    return int(parts[1])
    except (OSError, ValueError):
        pass
    return 0


@dataclass
class MemorySnapshot:
    used_bytes: int
    total_bytes: int

    @property
    def used_fraction(self) -> float:
        return self.used_bytes / self.total_bytes if self.total_bytes else 0.0


def _read_int(path: str) -> Optional[int]:
    try:
        with open(path) as fh:
            raw = fh.read().strip()
        if raw in ("max", ""):
            return None
        return int(raw)
    except (OSError, ValueError):
        return None


def _proc_meminfo() -> Tuple[int, int]:
    total = avail = 0
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith("MemTotal:"):
                total = int(line.split()[1]) * 1024
            elif line.startswith("MemAvailable:"):
                avail = int(line.split()[1]) * 1024
            if total and avail:
                break
    return total - avail, total


def get_memory_snapshot() -> MemorySnapshot:
    """Host usage, constrained by a cgroup limit when one applies (the
    reference takes min(host, cgroup) the same way)."""
    fake = os.environ.get(FAKE_USAGE_ENV)
    if fake:
        try:
            with open(fake) as fh:
                used, total = (int(x) for x in fh.read().split()[:2])
            return MemorySnapshot(used, total)
        except (OSError, ValueError):
            pass  # fall through to real sampling
    used, total = _proc_meminfo()
    for limit_path, usage_path, stat_path, inactive_key in _CGROUP_PATHS:
        limit = _read_int(limit_path)
        if limit is not None and 0 < limit < total:
            cg_used = _read_int(usage_path)
            if cg_used is not None:
                cg_used = max(0, cg_used - _read_stat_key(stat_path, inactive_key))
                return MemorySnapshot(cg_used, limit)
    return MemorySnapshot(used, total)


def process_rss_bytes(pid: int) -> int:
    """Resident set size of one process (0 if gone)."""
    try:
        with open(f"/proc/{pid}/statm") as fh:
            return int(fh.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return 0


# --------------------------------------------------------------------- policy
@dataclass
class KillCandidate:
    """One killable worker as the policy sees it (decoupled from scheduler
    internals so policies unit-test without a cluster)."""

    worker_key: object          # opaque handle returned to the caller
    retriable: bool             # running task has retries left
    started_at: float           # running task's start time
    owner: str = ""             # submitting holder (group-by-owner)


def select_worker_to_kill(
    candidates: List[KillCandidate], policy: str
) -> Optional[KillCandidate]:
    """Pick the victim per the named policy; None if no candidates.

    - retriable_lifo (reference default): retriable first, newest task first.
    - retriable_fifo: retriable first, oldest task first.
    - group_by_owner: among owner-groups (retriable groups first, larger
      groups first), kill the newest task of the chosen group — shrinks the
      biggest submitter's footprint while losing the least progress.
    """
    if not candidates:
        return None
    if policy == "retriable_fifo":
        return sorted(
            candidates, key=lambda c: (not c.retriable, c.started_at)
        )[0]
    if policy == "retriable_lifo":
        return sorted(
            candidates, key=lambda c: (not c.retriable, -c.started_at)
        )[0]
    if policy == "group_by_owner":
        groups: dict = {}
        for c in candidates:
            groups.setdefault((c.retriable, c.owner), []).append(c)
        # Retriable groups first; then larger groups; tie-break newest task.
        key, members = sorted(
            groups.items(),
            key=lambda kv: (not kv[0][0], -len(kv[1])),
        )[0]
        return sorted(members, key=lambda c: -c.started_at)[0]
    raise ValueError(f"unknown worker_killing_policy {policy!r}")
