"""StandardAutoscaler + Monitor.

Reference: `python/ray/autoscaler/_private/autoscaler.py:172`
(`StandardAutoscaler.update`: read load metrics -> bin-pack pending demand
onto node types -> launch/terminate via the provider) and
`_private/monitor.py:127` (the loop). Same decomposition, and the same
decisions as the JAX package's; the load source is the scheduler's
`autoscaler_state` snapshot instead of GCS load metrics, read through the
driver's context, so a Monitor runs in an in-process driver or in a client
driver joined to a head.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class NodeTypeConfig:
    resources: Dict[str, float]
    max_workers: int = 10
    min_workers: int = 0
    labels: Dict[str, str] = field(default_factory=dict)
    # Provider-specific extras (e.g. machine_type for GPU instances).
    extra: Dict[str, Any] = field(default_factory=dict)

    def node_config(self) -> Dict[str, Any]:
        return {"resources": dict(self.resources), "labels": dict(self.labels), **self.extra}


@dataclass
class AutoscalerConfig:
    node_types: Dict[str, NodeTypeConfig] = field(default_factory=dict)
    idle_timeout_s: float = 60.0
    # Max new nodes per update pass (the reference's upscaling_speed throttle).
    max_launches_per_update: int = 5


def _fits(capacity: Dict[str, float], demand: Dict[str, float]) -> bool:
    return all(capacity.get(k, 0.0) + 1e-9 >= v for k, v in demand.items())


def _consume(capacity: Dict[str, float], demand: Dict[str, float]) -> None:
    for k, v in demand.items():
        capacity[k] = capacity.get(k, 0.0) - v


class StandardAutoscaler:
    def __init__(self, config: AutoscalerConfig, provider):
        self.config = config
        self.provider = provider
        # provider node id -> node type
        self.launched: Dict[str, str] = {}
        self._explicit_demand: List[Dict[str, float]] = []

    # ------------------------------------------------------------------ sdk
    def request_resources(self, bundles: List[Dict[str, float]]) -> None:
        """Explicit demand floor (reference: `autoscaler.sdk.request_resources`)."""
        self._explicit_demand = [dict(b) for b in bundles]

    # ---------------------------------------------------------------- update
    def update(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """One reconcile pass over a scheduler `autoscaler_state` snapshot.
        Returns {"launched": [(type, id)], "terminated": [id]}."""
        launched, terminated = [], []

        # 1) Unmet demand: pending shapes that fit on no node's AVAILABLE
        #    capacity right now (scratch-consumed so N identical pending tasks
        #    need N slots, not one).
        scratch = [dict(n["available"]) for n in state["nodes"] if n["alive"]]
        unmet: List[Dict[str, float]] = []
        demands = (
            list(state["pending_tasks"])
            + list(state["pending_bundles"])
            + list(self._explicit_demand)
        )
        for d in demands:
            if not d:
                continue
            placed = False
            for cap in scratch:
                if _fits(cap, d):
                    _consume(cap, d)
                    placed = True
                    break
            if not placed:
                unmet.append(d)

        # 2) Bin-pack unmet demand onto launchable node types.
        counts = self._count_by_type()
        to_launch: List[str] = []
        for d in unmet:
            if len(to_launch) >= self.config.max_launches_per_update:
                break
            for name, nt in self.config.node_types.items():
                pending_of_type = counts.get(name, 0) + sum(1 for t in to_launch if t == name)
                if pending_of_type >= nt.max_workers:
                    continue
                if _fits(dict(nt.resources), d):
                    to_launch.append(name)
                    break
        # min_workers floor.
        for name, nt in self.config.node_types.items():
            have = counts.get(name, 0) + sum(1 for t in to_launch if t == name)
            for _ in range(max(0, nt.min_workers - have)):
                to_launch.append(name)

        for name in to_launch:
            nid = self.provider.create_node(name, self.config.node_types[name].node_config())
            self.launched[nid] = name
            launched.append((name, nid))

        # 3) Scale down: autoscaler-launched nodes idle past the timeout
        #    (never below min_workers, never nodes hosting actors).
        by_id = {n["node_id"]: n for n in state["nodes"]}
        counts = self._count_by_type()
        for nid, ntype in list(self.launched.items()):
            info = by_id.get(nid)
            if info is None:
                continue  # not registered yet (or already gone)
            nt = self.config.node_types[ntype]
            if counts.get(ntype, 0) <= nt.min_workers:
                continue
            if info["actors"] > 0 or info["busy_workers"] > 0:
                continue
            if info["idle_s"] < self.config.idle_timeout_s:
                continue
            self.provider.terminate_node(nid)
            del self.launched[nid]
            counts[ntype] -= 1
            terminated.append(nid)

        # Scale decisions land in the cluster event log (no-op with metrics
        # off; never raises — a full event ring must not stall scaling).
        if launched:
            from ray_tpu_torch._private.events import emit_event

            emit_event(
                "autoscaler_scale_up",
                f"autoscaler launched {len(launched)} node(s): "
                + ", ".join(f"{t}:{nid[:8]}" for t, nid in launched),
                source="autoscaler", launched=[t for t, _ in launched],
                unmet_demands=len(unmet),
            )
        if terminated:
            from ray_tpu_torch._private.events import emit_event

            emit_event(
                "autoscaler_scale_down",
                f"autoscaler terminated {len(terminated)} idle node(s)",
                source="autoscaler",
                terminated=[nid[:8] for nid in terminated],
            )
        return {"launched": launched, "terminated": terminated}

    def _count_by_type(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for ntype in self.launched.values():
            counts[ntype] = counts.get(ntype, 0) + 1
        return counts


class Monitor:
    """Background loop driving StandardAutoscaler off live scheduler state
    (the reference's monitor process, colocated in the driver)."""

    def __init__(self, config: AutoscalerConfig, provider, interval_s: float = 1.0):
        self.autoscaler = StandardAutoscaler(config, provider)
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        from ray_tpu_torch.autoscaler.sdk import _set_active_monitor

        _set_active_monitor(self)
        self._thread = threading.Thread(target=self._loop, daemon=True, name="autoscaler")
        self._thread.start()

    def _loop(self) -> None:
        from ray_tpu_torch._private.worker import global_worker

        while not self._stop.wait(self.interval_s):
            try:
                state = global_worker.context.autoscaler_state()
                self.autoscaler.update(state)
            except Exception:
                pass  # cluster shutting down / transient; next tick retries

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
