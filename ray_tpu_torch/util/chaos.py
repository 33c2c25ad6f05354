"""Chaos testing: kill nodes/workers on an interval while a workload runs.

Reference: `python/ray/_private/test_utils.py:1355 get_and_run_node_killer` —
a NodeKillerActor SIGKILLs raylets on a schedule; `tests/test_chaos.py` and
the nightly chaos suites assert workloads survive. Here the killer is a
driver-side thread targeting `cluster_utils.Cluster` nodes (virtual or real
daemon processes — killing a real daemon exercises the genuine
connection-drop failure path).
"""

from __future__ import annotations

import random
import threading
import time
from typing import List, Optional


class NodeKiller:
    """Kills a random non-head node every `interval_s` until stopped.

    With `respawn=True` each killed node is replaced with an identical one
    (resources copied, its `GPU` given back as `num_gpus`), emulating a
    flaky-but-recovering fleet.

    Every kill is emitted as a `ray_tpu_torch.timeline()` event (a zero-duration
    "chaos"-kind tracing span carrying the node id and kill index), so chaos
    runs can correlate kills with detection latency and recovery in one
    trace. `max_concurrent_dead` bounds how many killed nodes may be awaiting
    replacement at once: when respawns lag (or fail), the killer pauses
    instead of silently grinding the whole fleet down.
    """

    def __init__(
        self,
        cluster,
        interval_s: float = 2.0,
        respawn: bool = True,
        max_kills: Optional[int] = None,
        seed: int = 0,
        max_concurrent_dead: int = 1,
    ):
        self._cluster = cluster
        self._interval = interval_s
        self._respawn = respawn
        self._max_kills = max_kills
        self._rng = random.Random(seed)
        self._max_dead = max(1, int(max_concurrent_dead))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.kills: List[str] = []
        # Node ids whose replacement node came up (len(kills) - len(respawns)
        # = currently-dead count the guard caps).
        self.respawns: List[str] = []

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True, name="node-killer")
        self._thread.start()
        return self

    def _loop(self):
        import ray_tpu_torch

        from ray_tpu_torch.util import tracing

        while not self._stop.wait(self._interval):
            if self._max_kills is not None and len(self.kills) >= self._max_kills:
                return
            if len(self.kills) - len(self.respawns) >= self._max_dead:
                # Respawn lag guard: enough of the fleet is already down and
                # unreplaced — pausing here keeps a slow (or failing) respawn
                # path from letting the killer take out every node.
                continue
            victims = [
                n for n in ray_tpu_torch.nodes() if n["alive"] and n["labels"].get("head") != "1"
            ]
            if not victims:
                continue
            victim = self._rng.choice(victims)
            resources = {
                k: v for k, v in victim["resources"].items() if k != "memory"
            }
            from ray_tpu_torch._private.ids import NodeID

            try:
                self._cluster.remove_node(NodeID.from_hex(victim["node_id"]))
            except Exception:
                continue
            self.kills.append(victim["node_id"])
            # Timeline correlation: the kill lands in ray_tpu_torch.timeline() as a
            # "chaos" span, so detection latency and recovery intervals line
            # up against it in one trace.
            span = tracing.start_span(
                "node_kill", "chaos",
                attributes={
                    "node_id": victim["node_id"],
                    "kill_index": len(self.kills),
                },
            )
            tracing.end_span(span)
            if self._respawn and not self._stop.is_set():
                cpus = resources.pop("CPU", 1)
                gpus = resources.pop("GPU", 0)
                try:
                    self._cluster.add_node(
                        num_cpus=cpus, num_gpus=gpus, resources=resources
                    )
                    self.respawns.append(victim["node_id"])
                except Exception:
                    pass

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10)
