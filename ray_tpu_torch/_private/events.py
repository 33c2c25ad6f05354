"""Cluster event log: the severity-tagged "what changed" stream.

Reference: the GCS-backed event/error tables the reference dashboard tails
(`gcs_task_manager` + the `errors` pubsub channel). Metrics answer "how
much"; this answers "what happened and when": node lifecycle transitions,
worker crashes, autoscaler decisions, Serve deploys/drains, object spills,
and alert fire/resolve edges — appended into a bounded GCS ring
(`GCS.cluster_events`, persisted under head `--persist`) and queryable via
`state.list_cluster_events()`, dashboard `/api/events`, and
`python -m ray_tpu_torch events`.

Emission is gated by `enable_metrics` (the observability master knob): knob
off means no event is recorded anywhere and no emit ever touches the
protocol. Head-side seams (scheduler/heartbeat detector/object store) append
directly via `Scheduler._emit_event`; other processes (Serve controller,
autoscaler monitor, proxies) route through the existing KV command
(`ctx.kv("event", payload)` -> `GCS.kv_event`) so no new wire tag is needed.

Every kind used anywhere in the tree must be registered in EVENT_KINDS *and*
documented in the COMPONENTS.md Observability events table — the rt-lint
metrics pass cross-checks both (an unregistered or undocumented kind fails
the run, mirroring the failpoint-table discipline).
"""

from __future__ import annotations

import time
from typing import Optional

# Machine-readable registry (pure literal: rt-lint parses it with
# ast.literal_eval, never by importing the runtime). Keep sorted.
EVENT_KINDS = (
    "alert_firing",
    "alert_resolved",
    "autoscaler_scale_down",
    "autoscaler_scale_up",
    "job_finished",
    "job_started",
    "node_added",
    "node_dead",
    "node_removed",
    "node_suspect",
    "object_spilled",
    "serve_delete",
    "serve_deploy",
    "serve_proxy_drain",
    "serve_proxy_failover",
    "serve_replica_failover",
    "serve_scale",
    "train_gang_recover",
    "train_gang_resize",
    "train_preempt_notice",
    "train_straggler",
    "worker_dead",
    "worker_started",
    "worker_suspect",
)

SEVERITIES = ("debug", "info", "warning", "error", "critical")


def emit_event(kind: str, message: str, severity: str = "info",
               source: Optional[str] = None, **data) -> None:
    """Record one cluster event from ANY process. No-op (and zero traffic)
    when enable_metrics is off; never raises — observability must not take
    down the thing it observes. Head-side code on the scheduler loop should
    call `Scheduler._emit_event` instead (direct append, no command hop)."""
    from ray_tpu_torch._private.telemetry import obs_enabled

    try:
        if not obs_enabled():
            return
        from ray_tpu_torch._private.worker import global_worker

        ctx = global_worker.context
        if ctx is None:
            return
        if source is None:
            import os

            source = f"pid:{os.getpid()}"
        ctx.kv("event", (kind, message, severity, source, data, time.time()))
    except Exception:  # noqa: BLE001 — cluster shutting down / head gone
        pass
