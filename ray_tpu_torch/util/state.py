"""State API: programmatic cluster introspection.

Reference: `python/ray/experimental/state/api.py` (+ `state_cli.py`,
`dashboard/state_aggregator.py:133 StateAPIManager`): `ray list
tasks/actors/objects/nodes`, `ray timeline`. Same surface here, served from
the scheduler's live tables over the driver connection.

Task records carry a per-stage timestamp pipeline
(submit -> queued -> lease_granted -> args_fetched -> exec_start ->
exec_end -> result_stored); `list_tasks` surfaces per-stage durations,
`summarize()` rolls them into p50/p95 queue-wait and exec latencies, and
`timeline()` merges stage intervals with tracing spans (submit/execute/
custom/collective) into one chrome trace on shared trace ids.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional

from ray_tpu_torch._private.gcs import TASK_STAGES
from ray_tpu_torch._private.worker import _auto_init, global_worker

# Interval names between consecutive stages (len(TASK_STAGES) - 1).
STAGE_INTERVALS = (
    "submit", "queue_wait", "args_fetch", "prepare", "exec", "store_results",
)


def list_nodes(include_postmortems: bool = False) -> List[Dict[str, Any]]:
    """Node table with per-worker health and any flight-recorder stack dump
    the heartbeat detector captured at a SUSPECT transition.
    `include_postmortems` appends entries for daemon nodes the detector
    declared DEAD (alive=False, postmortem=True) with the dump captured
    before they vanished."""
    _auto_init()
    return global_worker.context.nodes(
        {"include_postmortems": True} if include_postmortems else None
    )


def list_actors(job: Optional[str] = None) -> List[Dict[str, Any]]:
    """Actor table; each entry carries the owning ``job_id`` (recovered from
    the actor id's embedded job prefix). ``job=`` filters to one tenant."""
    _auto_init()
    return global_worker.context.list_actors({"job": job} if job else None)


# ------------------------------------------------------------- introspection
def stacks(timeout_s: float | None = None) -> Dict[str, Dict[str, Any]]:
    """All-thread stacks from every live process RIGHT NOW — the `ray stack`
    analogue. Returns {"head": payload, "worker:<id>": payload,
    "daemon:<node>": payload}; each payload carries per-thread formatted
    stacks with the task/actor-method the thread is executing. Workers whose
    reader thread can't answer (GIL wedged) are retried out-of-band via a
    SIGUSR1 faulthandler dump (transport="oob"); processes that can't even
    do that come back as transport="unavailable" with the reason."""
    _auto_init()
    return global_worker.context.dump_stacks(timeout_s)


def transfer_stats() -> Dict[str, Any]:
    """Data-plane counters from the head: cumulative relay pulls/bytes (zero
    for peer-served workloads — the head answers location queries only),
    locality-placement hits/misses, and live replica-directory size. When
    job accounting is on, ``per_job_bytes`` maps job hex -> cumulative
    data-plane bytes (relay pulls + replica fan-out) attributed via each
    object's embedded owner-task job prefix."""
    _auto_init()
    return global_worker.context.transfer_stats()


# ------------------------------------------------------------ observability
def query_series(name: str, labels: Optional[Dict[str, str]] = None,
                 since: Optional[float] = None, until: Optional[float] = None,
                 step: Optional[float] = None, agg: str = "sum",
                 q: Optional[float] = None,
                 group_by_pid: bool = False) -> Dict[str, Any]:
    """Windowed history from the head's time-series store (fed by the
    per-process metric flushes at `internal_metrics_interval_s`/flush
    cadence). Counters come back as per-second RATES per step window, gauges
    as sampled levels (agg across processes: "sum"|"max"|"avg"), histograms
    with `q` as the q-quantile of the observations that landed in each
    window (p95-over-time = `q=0.95`). Raises when `enable_metrics` is off.

    Returns ``{"name", "kind", "step", "series": [{"labels", "points"}]}``
    with points as ``[window_end_ts, value]`` pairs."""
    _auto_init()
    payload: Dict[str, Any] = {"name": name}
    if labels:
        payload["labels"] = dict(labels)
    if since is not None:
        payload["since"] = float(since)
    if until is not None:
        payload["until"] = float(until)
    if step is not None:
        payload["step"] = float(step)
    if agg != "sum":
        payload["agg"] = agg
    if q is not None:
        payload["q"] = float(q)
    if group_by_pid:
        payload["group_by_pid"] = True
    return global_worker.context.query_series(payload)


def list_cluster_events(limit: Optional[int] = None, kind: Optional[str] = None,
                        severity: Optional[str] = None,
                        since: Optional[float] = None) -> List[Dict[str, Any]]:
    """The cluster event log (newest last): severity-tagged runtime
    transitions — node ALIVE->SUSPECT->DEAD edges, worker crash/respawn,
    autoscaler decisions, Serve deploy/drain/failover, object spills, alert
    fire/resolve — from the bounded GCS ring (survives head restart under
    --persist). Each entry: {ts, severity, kind, source, message, data}."""
    _auto_init()
    payload: Dict[str, Any] = {}
    if limit is not None:
        payload["limit"] = int(limit)
    if kind is not None:
        payload["kind"] = kind
    if severity is not None:
        payload["severity"] = severity
    if since is not None:
        payload["since"] = float(since)
    return global_worker.context.cluster_events(payload or None)


def list_alerts() -> List[Dict[str, Any]]:
    """Every alert rule with its live state (ok|pending|firing), last
    evaluated value, and thresholds. Empty when `enable_metrics` is off."""
    _auto_init()
    return global_worker.context.list_alerts()


def list_jobs() -> List[Dict[str, Any]]:
    """Per-job ledger summaries: every live driver (state=LIVE) plus the
    bounded finished-jobs ring (state=FINISHED, survives head restart under
    --persist). Each entry: {job, driver, source, started_at, totals} with
    totals = {cpu_seconds, tasks{submitted,finished,failed,cancelled},
    queue_wait_seconds, object_byte_seconds, object_bytes, transfer_bytes,
    serve_requests}. Raises when job accounting is off
    (`enable_metrics=False` or `enable_obs=False`)."""
    _auto_init()
    return global_worker.context.list_jobs()


def job_report(job: str) -> Dict[str, Any]:
    """One job's full ledger record by job hex (live or finished). Raises
    KeyError for unknown jobs and RuntimeError when accounting is off."""
    _auto_init()
    return global_worker.context.job_report(job)


def on_alert(callback) -> None:
    """Register `callback(rule_payload, transition)` for alert transitions
    ("firing"|"resolved"). Head-side only: the engine lives in the scheduler
    process, so this works from an in-process driver (plain `init()`), not a
    client-mode one. Callbacks run on the scheduler loop — keep them cheap
    and never block."""
    _auto_init()
    sched = getattr(global_worker, "node", None)
    obs = getattr(sched, "obs", None)
    if obs is None:
        raise RuntimeError(
            "alert callbacks need the in-process head with enable_metrics on "
            "(client-mode drivers poll state.list_alerts() instead)"
        )
    obs.engine.add_callback(callback)


def training_report(gang: Optional[str] = None) -> Dict[str, Any]:
    """Goodput ledgers of training gangs (train/_internal/ledger.py),
    published by each fit()'s driver under the `train::<gang_id>` KV keys.

    Per gang: wall_s, buckets (productive|init|compile|rendezvous_wait|
    checkpoint|recover|resize|idle — they partition wall time, coverage
    ~1.0), goodput_frac, steps, failures, elastic membership history
    (resizes, last_resize {old_world, new_world, direction, reason,
    resize_s, ckpt_source}, proactive_checkpoints), the current skew and
    the named straggler ({rank, phase, skew_s}), and the last round's
    per-rank phase split.

    Returns ``{"gangs": {gang_id: report}}`` (one entry when `gang` given;
    empty when `enable_metrics` is off — nothing is published then)."""
    import json

    _auto_init()
    ctx = global_worker.context
    gangs: Dict[str, Any] = {}
    if gang is not None:
        keys = [b"train::" + gang.encode()]
    else:
        keys = ctx.kv("keys", b"train::") or []
    for key in keys:
        raw = ctx.kv("get", key)
        if not raw:
            continue
        try:
            gangs[key[len(b"train::"):].decode()] = json.loads(raw.decode())
        except (ValueError, UnicodeDecodeError):
            continue
    return {"gangs": gangs}


# ---------------------------------------------------------------- tracing
def _trace_inputs(trace_id: Optional[str] = None):
    """(spans, {task_id_hex: stages}) joined from the head's trace-span ring
    and the task-event ring — the two halves critical-path attribution
    needs. Flushes this process's span buffer first."""
    from ray_tpu_torch.util import tracing

    _auto_init()
    tracing.flush_spans()
    ctx = global_worker.context
    payload = {"trace_id": trace_id} if trace_id else None
    spans = ctx.list_spans(payload)
    stages: Dict[str, Dict[str, float]] = {}
    for ev in ctx.task_events():
        if getattr(ev, "stages", None):
            stages[ev.task_id] = ev.stages
    return spans, stages


def list_traces(limit: int = 50) -> List[Dict[str, Any]]:
    """Newest-last trace summaries from the head's span ring: root span,
    wall time, span count, status, and whether the trace survived sampling
    by tail-keep (a slow outlier)."""
    from ray_tpu_torch._private import critical_path

    spans, _stages = _trace_inputs()
    traces = critical_path.group_traces(spans)
    out = sorted(
        (critical_path.trace_summary(tid, ss) for tid, ss in traces.items()),
        key=lambda t: t["start"],
    )
    limit = max(0, int(limit))
    return out[-limit:] if limit else []


def get_trace(trace_id: str) -> Dict[str, Any]:
    """One trace end-to-end: its spans (parent-linked), the joined per-task
    stage stamps, and the critical-path attribution (which component owns
    each slice of the trace's wall time)."""
    from ray_tpu_torch._private import critical_path

    spans, stages = _trace_inputs(trace_id)
    if not spans:
        raise KeyError(f"no spans recorded for trace {trace_id!r}")
    summary = critical_path.trace_summary(trace_id, spans)
    attribution = critical_path.attribute(spans, stages)
    task_ids = {
        (s.get("attributes") or {}).get("task_id")
        for s in spans
    } - {None}
    return {
        **summary,
        "spans": sorted(spans, key=lambda s: s["start"]),
        "stages": {t: stages[t] for t in task_ids if t in stages},
        "attribution": attribution,
    }


def latency_report(limit: int = 200) -> Dict[str, Any]:
    """'Where does p95 actually go': critical-path attribution aggregated
    over the newest `limit` traces — per-component totals and shares
    (submit / head_loop / arg_transfer / exec / store_results /
    done_delivery / proxy_queue / route), plus p50/p95 of per-trace wall
    time. head_loop is the open-item-1 instrument: the time every dispatch
    still spends transiting the head loop."""
    from ray_tpu_torch._private import critical_path

    spans, stages = _trace_inputs()
    return critical_path.latency_report(spans, stages, limit=limit)


def memory_summary(job: Optional[str] = None) -> Dict[str, Any]:
    """`ray memory` analogue: per-object owner/refcount/location/size from
    the scheduler's ownership tables joined with the on-disk store state,
    grouped by creation site, with leak suspects (objects whose only
    references live on dead processes) and a store-dir scan flagging bytes
    no live object references (e.g. results stored by a worker that crashed
    before reporting them). Each object entry carries its owning ``job_id``
    and the result includes a ``by_job`` rollup ({job: {count, bytes}});
    ``job=`` narrows the per-object listing to one tenant (aggregates stay
    cluster-wide)."""
    _auto_init()
    return global_worker.context.memory_summary({"job": job} if job else None)


# Chrome-trace events of the most recent profile() run, merged into
# timeline() so one trace shows tasks, spans, collectives AND samples.
# Stamped with the session generation: a shutdown()/init() cycle must not
# leak a previous session's samples into the new session's timeline.
_last_profile_chrome: List[Dict[str, Any]] = []
_last_profile_session: Optional[int] = None


def profile(duration_s: float = 1.0, hz: float | None = None) -> Dict[str, Any]:
    """Cluster-wide sampling profile: start per-process samplers everywhere,
    wait `duration_s`, collect and merge. Returns {"folded": {stack: count}
    keyed "<process>;<thread>;frame;...;frame" (flamegraph.pl / speedscope
    input), "flamegraph": the same as text lines, "chrome_trace": chrome
    events (also merged into the next timeline() call), "per_process": raw
    payloads}. Requires Config.enable_profiler (default on; when off this
    raises and no profiling traffic is ever sent)."""
    import time as _time

    from ray_tpu_torch._private.config import get_config

    _auto_init()
    ctx = global_worker.context
    hz = float(hz or get_config().profiler_hz)
    ctx.profile_start(hz)
    _time.sleep(max(0.0, float(duration_s)))
    per_process = ctx.profile_collect()

    merged: Dict[str, int] = {}
    chrome: List[Dict[str, Any]] = []
    total_samples = 0
    for proc_key in sorted(per_process):
        payload = per_process[proc_key]
        if not isinstance(payload, dict):
            continue
        folded = payload.get("folded") or {}
        total_samples += int(payload.get("samples") or 0)
        started = payload.get("started_at")
        proc_hz = float(payload.get("hz") or hz)
        for stack, count in folded.items():
            key = f"{proc_key};{stack}"
            merged[key] = merged.get(key, 0) + count
            if started:
                frames = stack.split(";")
                chrome.append(
                    {
                        "name": frames[-1] if frames else stack,
                        "cat": "profile",
                        "ph": "X",
                        "ts": int(started * 1e6),
                        "dur": max(1, int(count / proc_hz * 1e6)),
                        "pid": proc_key,
                        "tid": frames[0] if frames else "?",
                        "args": {"stack": stack, "samples": count},
                    }
                )
    global _last_profile_chrome, _last_profile_session
    _last_profile_chrome = chrome
    _last_profile_session = global_worker._session_gen
    return {
        "folded": merged,
        "flamegraph": "\n".join(
            f"{k} {v}" for k, v in sorted(merged.items())
        ),
        "chrome_trace": chrome,
        "samples": total_samples,
        "hz": hz,
        "duration_s": float(duration_s),
        "per_process": per_process,
    }


def _monotonic_stages(stages: Dict[str, float]) -> Dict[str, float]:
    """Stage stamps in canonical order, clamped non-decreasing. Stamps come
    from three clocks (caller, scheduler, worker — one machine, but time()
    is not cross-process monotonic); sub-ms skew must not produce negative
    durations."""
    out: Dict[str, float] = {}
    last = None
    for name in TASK_STAGES:
        t = stages.get(name)
        if t is None:
            continue
        if last is not None and t < last:
            t = last
        out[name] = last = t
    return out


def _stage_durations(stages: Dict[str, float]) -> Dict[str, float]:
    """Seconds spent between consecutive present stages."""
    mono = _monotonic_stages(stages)
    out: Dict[str, float] = {}
    for i in range(len(TASK_STAGES) - 1):
        a, b = TASK_STAGES[i], TASK_STAGES[i + 1]
        if a in mono and b in mono:
            out[STAGE_INTERVALS[i]] = mono[b] - mono[a]
    return out


def list_tasks(limit: int = 1000,
               job: Optional[str] = None) -> List[Dict[str, Any]]:
    """Task table (live + recently-GCed summaries); each entry carries the
    owning ``job_id`` recovered from the task id's embedded job prefix.
    ``job=`` filters to one tenant before the ``limit`` tail is taken."""
    _auto_init()
    payload: Any = {"limit": limit, "job": job} if job else limit
    out = global_worker.context.list_tasks(payload)
    for t in out:
        stages = t.get("stages") or {}
        if stages:
            t["stage_durations"] = _stage_durations(stages)
    return out


def list_objects(limit: int = 1000) -> List[Dict[str, Any]]:
    _auto_init()
    return global_worker.context.list_objects(limit)


def summarize() -> Dict[str, Any]:
    """`ray status`-style rollup: resources + entity counts + task-latency
    percentiles from the per-stage event pipeline. The percentile reduction
    happens scheduler-side (`task_latency`) so a full event ring is never
    shipped just to compute two rollups.

    `task_events_max_num_task_in_gcs` is the rollup's listing budget too:
    tasks_by_state/objects count at most that many entries per call, so
    shrinking the event ring deliberately shrinks this summary's scan (the
    knob is the cluster's observability-retention budget, not just the
    ring size)."""
    from ray_tpu_torch._private.config import get_config

    _auto_init()
    ctx = global_worker.context
    # The GCS task-event store is a ring of task_events_max_num_task_in_gcs;
    # reading more than that is wasted work by construction.
    cap = max(1, int(get_config().task_events_max_num_task_in_gcs))
    tasks = ctx.list_tasks(cap)
    by_state: Dict[str, int] = {}
    for t in tasks:
        by_state[t["state"]] = by_state.get(t["state"], 0) + 1
    latency: Dict[str, Any] = ctx.task_latency()
    return {
        "cluster_resources": ctx.cluster_resources(),
        "available_resources": ctx.available_resources(),
        "nodes": len(ctx.nodes()),
        "actors": len(ctx.list_actors()),
        "tasks_by_state": by_state,
        "objects": len(ctx.list_objects(cap)),
        "task_latency": latency,
    }


def _task_timeline_events(events) -> List[Dict[str, Any]]:
    """Chrome events from the task-event log: stage-aware tasks emit one
    umbrella "task" event (args carry all stage stamps) plus one
    "task_stage" event per non-empty interval; tasks recorded without
    stages (enable_timeline toggled mid-run, legacy events) fall back to
    RUNNING -> terminal pairing."""
    trace: List[Dict[str, Any]] = []
    open_ts: Dict[str, float] = {}
    for ev in events:
        stages = _monotonic_stages(getattr(ev, "stages", None) or {})
        if ev.state in ("FINISHED", "FAILED", "CANCELLED") and len(stages) >= 2:
            ordered = [(s, stages[s]) for s in TASK_STAGES if s in stages]
            first, last = ordered[0][1], ordered[-1][1]
            tid = ev.task_id[:8]
            if last > first:
                trace.append(
                    {
                        "name": ev.name,
                        "cat": "task",
                        "ph": "X",
                        "ts": int(first * 1e6),
                        "dur": max(1, int((last - first) * 1e6)),
                        "pid": "cluster",
                        "tid": tid,
                        "args": {
                            "state": ev.state,
                            "task_id": ev.task_id,
                            "stages": stages,
                        },
                    }
                )
            for i in range(len(ordered) - 1):
                (a, ta), (b, tb) = ordered[i], ordered[i + 1]
                dur = int((tb - ta) * 1e6)
                if dur <= 0:
                    continue
                idx = TASK_STAGES.index(a)
                trace.append(
                    {
                        "name": f"{ev.name}:{STAGE_INTERVALS[idx]}",
                        "cat": "task_stage",
                        "ph": "X",
                        "ts": int(ta * 1e6),
                        "dur": dur,
                        "pid": "cluster",
                        "tid": tid,
                        "args": {"task_id": ev.task_id, "from": a, "to": b},
                    }
                )
            continue
        if ev.state == "RUNNING":
            open_ts[ev.task_id] = ev.timestamp
        elif ev.state in ("FINISHED", "FAILED", "CANCELLED"):
            start = open_ts.pop(ev.task_id, None)
            if start is not None and ev.timestamp > start:
                trace.append(
                    {
                        "name": ev.name,
                        "cat": "task",
                        "ph": "X",
                        "ts": int(start * 1e6),
                        "dur": max(1, int((ev.timestamp - start) * 1e6)),
                        "pid": "cluster",
                        "tid": ev.task_id[:8],
                        "args": {"state": ev.state, "task_id": ev.task_id},
                    }
                )
    return trace


def timeline(filename: Optional[str] = None) -> List[Dict[str, Any]]:
    """Unified chrome trace (reference: `GlobalState.chrome_tracing_dump`,
    `_private/state.py:435` / `ray timeline`): per-stage task lifecycle
    intervals from the GCS task-event log MERGED with tracing spans —
    submit/execute pairs on shared trace ids (so the caller->worker parent
    link is visible), custom application spans, and collective-op intervals.
    Returns the event list sorted by start time; writes JSON if `filename`."""
    from ray_tpu_torch.util import tracing

    _auto_init()
    events = _task_timeline_events(global_worker.context.task_events())
    events.extend(tracing.chrome_trace())
    # Samples from the most recent profile() run ride the same trace, so
    # task intervals and where-the-CPU-went line up on one timeline —
    # same-session runs only (the stamp goes stale on shutdown/init).
    if _last_profile_session == global_worker._session_gen:
        events.extend(_last_profile_chrome)
    events.sort(key=lambda e: (e["ts"], e.get("dur", 0)))
    if filename:
        with open(filename, "w") as f:
            json.dump(events, f)
    return events
