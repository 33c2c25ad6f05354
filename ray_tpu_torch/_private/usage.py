"""Usage stats (reference: `_private/usage/usage_lib.py`): opt-out counters of
which subsystems a session touched. This build records to a LOCAL file only —
there is no phone-home; the file exists so operators can see exactly what
would ever be reported.

Opt out with RAY_TPU_TORCH_USAGE_STATS_ENABLED=0 (mirrors RAY_USAGE_STATS_ENABLED).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict

_lock = threading.Lock()
_counters: Dict[str, int] = {}

USAGE_FILE = os.path.expanduser("~/.ray_tpu_torch/usage_stats.json")


def enabled() -> bool:
    return os.environ.get("RAY_TPU_TORCH_USAGE_STATS_ENABLED", "1") not in ("0", "false")


def record_library_usage(name: str) -> None:
    """Called by library entry points (train/tune/serve/data/rllib/...)."""
    if not enabled():
        return
    with _lock:
        _counters[name] = _counters.get(name, 0) + 1


def flush() -> None:
    if not enabled() or not _counters:
        return
    try:
        os.makedirs(os.path.dirname(USAGE_FILE), exist_ok=True)
        existing = {}
        try:
            with open(USAGE_FILE) as f:
                existing = json.load(f)
        except (OSError, ValueError):
            pass
        with _lock:
            for k, v in _counters.items():
                existing[k] = existing.get(k, 0) + v
            _counters.clear()
        existing["last_updated"] = time.time()
        tmp = f"{USAGE_FILE}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(existing, f, indent=2)
        os.replace(tmp, USAGE_FILE)
    except OSError:
        pass
