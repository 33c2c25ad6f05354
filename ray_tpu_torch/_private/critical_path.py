"""Critical-path attribution: where did one request's wall time go?

Input: the spans of ONE trace (util/tracing.py dicts, connected by
trace_id/parent_id) joined with the per-task stage-timestamp pipeline
(the submit -> queued -> lease_granted -> args_fetched -> exec_start ->
exec_end -> result_stored stamps, keyed by the task_id each submit span
carries in its attributes). Output: the trace's wall time attributed to
NAMED COMPONENTS — the "where does p95 actually go" instrument the
direct-dispatch work (ROADMAP open item 1) is measured with.

Components:
  proxy_queue   Serve HTTP request-span time not covered by anything deeper
                (admission wait, response write, proxy-side queueing)
  route         router-span time (replica pick + submit) beyond its children
  submit        caller-side submit span + the submit -> queued interval
                (the hop onto the head loop)
  head_loop     queued -> lease_granted: time the task sat in the head
                loop's pending queue waiting for a lease — THE open-item-1
                number (every dispatch still transits the head loop)
  arg_transfer  lease_granted -> args_fetched, plus explicit "transfer"
                spans (peer-to-peer pulls): moving argument bytes
  exec          exec_start -> exec_end (user code) / execute-span remainder
  store_results exec_end -> result_stored (sealing return values)
  done_delivery result_stored -> the enclosing request/router span's end
                (completion propagating back to the caller)
  collective    collective-op spans
  app           custom application spans
  untracked     trace wall time no span or stage interval covers

Algorithm: every span and stage interval becomes (start, end, depth,
component); a single sweep over the trace window assigns each instant to
the DEEPEST covering interval. Parents therefore keep only the time their
children don't explain — attribution sums exactly to the trace wall time.

Pure functions over plain dicts: the driver computes this from
`spans_list` + `task_events` (util/state.py glue); nothing here touches
the scheduler loop.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

# Span kind -> component (when no deeper interval explains the time).
KIND_COMPONENT = {
    "request": "proxy_queue",
    "router": "route",
    "submit": "submit",
    "execute": "exec",
    "transfer": "arg_transfer",
    "collective": "collective",
    "custom": "app",
    "chaos": "app",
}

# Stage-interval components, in pipeline order (stage_a, stage_b, component).
STAGE_COMPONENTS = (
    ("submit", "queued", "submit"),
    ("queued", "lease_granted", "head_loop"),
    ("lease_granted", "args_fetched", "arg_transfer"),
    ("exec_start", "exec_end", "exec"),
    ("exec_end", "result_stored", "store_results"),
)

COMPONENTS = (
    "proxy_queue", "route", "submit", "head_loop", "arg_transfer", "exec",
    "store_results", "done_delivery", "collective", "app", "untracked",
)


def _monotonic(stages: Dict[str, float]) -> Dict[str, float]:
    """Clamp stage stamps non-decreasing in pipeline order (three clocks)."""
    order = ("submit", "queued", "lease_granted", "args_fetched",
             "exec_start", "exec_end", "result_stored")
    out: Dict[str, float] = {}
    last = None
    for name in order:
        t = stages.get(name)
        if t is None:
            continue
        if last is not None and t < last:
            t = last
        out[name] = last = t
    return out


def _span_depths(spans: List[dict]) -> Dict[str, int]:
    """Tree depth per span_id (roots = 0); orphan parents count as roots."""
    by_id = {s["span_id"]: s for s in spans}
    depths: Dict[str, int] = {}

    def depth_of(sid: str, guard: int = 0) -> int:
        if sid in depths:
            return depths[sid]
        s = by_id.get(sid)
        if s is None or guard > 64:
            return -1
        parent = s.get("parent_id")
        d = 0 if not parent or parent not in by_id else (
            depth_of(parent, guard + 1) + 1
        )
        depths[sid] = d
        return d

    for s in spans:
        depth_of(s["span_id"])
    return depths


def trace_intervals(spans: List[dict],
                    task_stages: Dict[str, Dict[str, float]]) -> List[tuple]:
    """(start, end, depth, component, label) intervals of one trace:
    completed spans plus the stage decomposition of every task whose submit
    span carries a task_id with recorded stages. Stage intervals sit BELOW
    their span (depth + 1000) so the sweep prefers the finer-grained
    explanation."""
    spans = [s for s in spans if s.get("end")]
    depths = _span_depths(spans)
    intervals: List[tuple] = []
    seen_tasks: set = set()
    for s in spans:
        d = depths.get(s["span_id"], 0)
        comp = KIND_COMPONENT.get(s.get("kind"), "app")
        intervals.append((s["start"], s["end"], d, comp, s.get("name", "")))
        task_id = (s.get("attributes") or {}).get("task_id")
        if task_id and s.get("kind") in ("submit", "execute"):
            if task_id in seen_tasks:
                continue
            stages = _monotonic(task_stages.get(task_id) or {})
            if len(stages) < 2:
                continue
            seen_tasks.add(task_id)
            for a, b, comp_name in STAGE_COMPONENTS:
                ta, tb = stages.get(a), stages.get(b)
                if ta is not None and tb is not None and tb > ta:
                    intervals.append(
                        (ta, tb, d + 1000, comp_name, f"{task_id[:8]}:{comp_name}")
                    )
    # done_delivery: completion propagating back up — the window between the
    # LAST result_stored and the end of the enclosing request/router span.
    enclosing = [s for s in spans if s.get("kind") in ("request", "router")]
    done_ts = [
        _monotonic(task_stages.get(t) or {}).get("result_stored")
        for t in seen_tasks
    ]
    done_ts = [t for t in done_ts if t is not None]
    if enclosing and done_ts:
        t_done = max(done_ts)
        t_end = max(s["end"] for s in enclosing)
        if t_end > t_done:
            intervals.append((t_done, t_end, 5000, "done_delivery",
                              "done_delivery"))
    return intervals


def attribute(spans: List[dict],
              task_stages: Dict[str, Dict[str, float]]) -> Dict[str, Any]:
    """Sweep the trace window, attributing every instant to the deepest
    covering interval's component. Returns totals, shares, the attributed
    coverage (named / total), and the critical-path segment list."""
    intervals = trace_intervals(spans, task_stages)
    if not intervals:
        return {"total_s": 0.0, "components": {}, "coverage": 0.0,
                "critical_path": []}
    t0 = min(i[0] for i in intervals)
    t1 = max(i[1] for i in intervals)
    edges = sorted({i[0] for i in intervals} | {i[1] for i in intervals})
    components: Dict[str, float] = {}
    path: List[dict] = []
    for a, b in zip(edges, edges[1:]):
        if b <= a:
            continue
        best = None
        for (s, e, d, comp, label) in intervals:
            if s <= a and e >= b and (best is None or d > best[0]):
                best = (d, comp, label)
        comp = best[1] if best else "untracked"
        label = best[2] if best else ""
        components[comp] = components.get(comp, 0.0) + (b - a)
        if path and path[-1]["component"] == comp and path[-1]["label"] == label:
            path[-1]["end"] = b
        else:
            path.append({"start": a, "end": b, "component": comp,
                         "label": label})
    total = t1 - t0
    named = sum(v for k, v in components.items() if k != "untracked")
    return {
        "total_s": total,
        "components": {
            k: round(v, 6) for k, v in
            sorted(components.items(), key=lambda kv: kv[1], reverse=True)
        },
        "coverage": (named / total) if total > 0 else 0.0,
        "critical_path": [
            {**seg, "duration_s": round(seg["end"] - seg["start"], 6)}
            for seg in path
        ],
    }


def group_traces(spans: List[dict]) -> Dict[str, List[dict]]:
    out: Dict[str, List[dict]] = {}
    for s in spans:
        out.setdefault(s.get("trace_id", "?"), []).append(s)
    return out


def trace_summary(trace_id: str, spans: List[dict]) -> Dict[str, Any]:
    done = [s for s in spans if s.get("end")]
    starts = [s["start"] for s in done] or [0.0]
    ends = [s["end"] for s in done] or [0.0]
    roots = [s for s in done if not s.get("parent_id")]
    root = min(roots, key=lambda s: s["start"]) if roots else (
        min(done, key=lambda s: s["start"]) if done else None
    )
    return {
        "trace_id": trace_id,
        "root": root.get("name") if root else None,
        "root_kind": root.get("kind") if root else None,
        "start": min(starts),
        "duration_s": round(max(ends) - min(starts), 6),
        "spans": len(spans),
        "status": ("ERROR" if any(s.get("status") == "ERROR" for s in done)
                   else "OK"),
        "tail_kept": any(s.get("keep") == "tail" for s in spans),
    }


def latency_report(spans: List[dict],
                   task_stages: Dict[str, Dict[str, float]],
                   limit: int = 200) -> Dict[str, Any]:
    """Aggregate attribution over the newest `limit` complete traces: per
    component, total seconds + share of all attributed wall time, plus
    p50/p95 of per-trace totals — the 'where does p95 actually go' table."""
    traces = group_traces(spans)
    limit = max(0, int(limit))
    summaries = sorted(
        (trace_summary(tid, ss) for tid, ss in traces.items()),
        key=lambda t: t["start"],
    )[-limit:] if limit else []
    comp_totals: Dict[str, float] = {}
    totals: List[float] = []
    coverages: List[float] = []
    n = 0
    for summ in summaries:
        attr = attribute(traces[summ["trace_id"]], task_stages)
        if attr["total_s"] <= 0:
            continue
        n += 1
        totals.append(attr["total_s"])
        coverages.append(attr["coverage"])
        for comp, secs in attr["components"].items():
            comp_totals[comp] = comp_totals.get(comp, 0.0) + secs
    totals.sort()
    grand = sum(comp_totals.values())

    def pct(vals: List[float], q: float) -> Optional[float]:
        if not vals:
            return None
        return vals[min(len(vals) - 1, int(q * len(vals)))]

    return {
        "traces": n,
        "total_s": round(sum(totals), 6),
        "trace_p50_s": pct(totals, 0.5),
        "trace_p95_s": pct(totals, 0.95),
        "coverage": (sum(coverages) / len(coverages)) if coverages else 0.0,
        "components": {
            comp: {
                "total_s": round(secs, 6),
                "share": round(secs / grand, 4) if grand > 0 else 0.0,
            }
            for comp, secs in sorted(comp_totals.items(),
                                     key=lambda kv: kv[1], reverse=True)
        },
    }
