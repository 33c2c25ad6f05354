"""Autoscaler SDK: explicit resource requests.

Reference: `python/ray/autoscaler/sdk.py` `request_resources` — set a demand
floor the autoscaler satisfies even with no pending tasks (pre-warming).
Applies to the process's active Monitor (set by `Monitor.start`)."""

from __future__ import annotations

from typing import Dict, List, Optional

_active_monitor = None


def _set_active_monitor(monitor) -> None:
    global _active_monitor
    _active_monitor = monitor


def request_resources(bundles: Optional[List[Dict[str, float]]] = None) -> None:
    if _active_monitor is None:
        raise RuntimeError("no autoscaler Monitor is running in this process")
    _active_monitor.autoscaler.request_resources(bundles or [])
