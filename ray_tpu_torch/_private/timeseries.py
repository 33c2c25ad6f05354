"""Head-side time-series store + declarative alert engine.

Reference: the reference's stats pipeline keeps per-process OpenCensus
metrics flowing to a node agent that Prometheus scrapes *over time*
(`src/ray/stats/`, `metric_defs.cc`); the dashboard charts history and the
operator alarms on it. This build already lands every process's metrics
snapshot in the GCS KV (`metrics::<pid>`, util/metrics.py flush) — this
module is the watch-it-over-time layer on that existing seam:

* **TimeSeriesStore** — the scheduler's `_cmd_kv` hands every `metrics::`
  put to `ObsState.ingest_kv`, which folds the snapshot into bounded
  ring-buffer series keyed `(name, tags+pid)`. Counters store per-interval
  DELTAS (so rates are queryable without a cursor at read time), gauges
  store samples, histograms store cumulative-bucket rows (so p50/p95/p99
  over time falls out of row differencing at query time). Knobs:
  `obs_series_step_s` (sample spacing), `obs_series_retention_s` (ring
  depth), `obs_max_series` (label-set cap). Series of dead processes are
  pruned by the scheduler's death hooks (`prune_process`).

* **AlertEngine** — DEFAULT_ALERT_RULES (a pure literal: rt-lint
  cross-checks every referenced metric name and rule name against
  COMPONENTS.md) evaluated on the scheduler loop at `alert_eval_interval_s`
  cadence. A rule is `(metric expr, threshold, for_s)` with hysteresis both
  ways: the condition must hold for `for_s` before FIRING and must clear
  for `for_s` before RESOLVING (flapping signals never spam the event log).
  Transitions append `alert_firing`/`alert_resolved` cluster events, drive
  the `ray_tpu_alerts_firing{rule}` gauge, and invoke registered callbacks.

Everything here exists only when `enable_metrics` is on: the scheduler
creates no ObsState, evaluates nothing, and `state.query_series()` raises —
knob-off parity with zero extra work or traffic.
"""

from __future__ import annotations

import json
import threading
import time

from ray_tpu_torch._private import lifecycle
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Default alert pack. PURE LITERAL on purpose: the rt-lint metrics pass
# parses this with ast.literal_eval (never importing the runtime) and fails
# the run if a rule name or referenced metric is missing from the
# COMPONENTS.md Observability tables — a rule you cannot look up is a rule
# you cannot act on.
#
# Rule fields:
#   name         unique id (events + ray_tpu_alerts_firing{rule} tag)
#   metric       series name in the store
#   kind         "rate" (counter deltas/s over window) | "gauge" (freshest
#                sample per series, aggregated) | "quantile" (histogram
#                row-diff over window -> q)
#   labels       optional tag subset the series must match
#   agg          "sum" | "max" | "avg" across matching series
#   window_s     evaluation lookback
#   q            quantile for kind="quantile"
#   op           ">" | "<"
#   threshold    static threshold, OR
#   threshold_config_frac  [config_field, frac]: threshold = frac * cfg value
#   for_s        hysteresis: condition must hold this long to fire, and
#                clear this long to resolve
#   severity     event severity on fire
#   summary      operator-facing one-liner
# ---------------------------------------------------------------------------
DEFAULT_ALERT_RULES = [
    {
        "name": "serve_route_wait_p95_slo",
        "metric": "ray_tpu_serve_route_wait_p95_s",
        "kind": "gauge", "agg": "max", "window_s": 30.0,
        "op": ">", "threshold": 0.5, "for_s": 5.0,
        "severity": "warning",
        "summary": "Serve route-wait p95 is burning the 500ms SLO",
    },
    {
        # 5s window: sheds are a fast, high-rate signal — a short window
        # both detects a burst quickly and lets the alert resolve within
        # seconds of the overload clearing (for_s still debounces flaps).
        "name": "serve_shed_rate",
        "metric": "ray_tpu_serve_shed_total",
        "kind": "rate", "agg": "sum", "window_s": 5.0,
        "op": ">", "threshold": 1.0, "for_s": 2.0,
        "severity": "warning",
        "summary": "Serve admission control is shedding requests",
    },
    {
        "name": "scheduler_queue_depth",
        "metric": "ray_tpu_scheduler_pending_tasks",
        "kind": "gauge", "agg": "sum", "window_s": 15.0,
        "op": ">", "threshold": 5000.0, "for_s": 10.0,
        "severity": "warning",
        "summary": "Scheduler task queue is deep and not draining",
    },
    {
        "name": "object_store_near_cap",
        "metric": "ray_tpu_object_store_bytes",
        "kind": "gauge", "agg": "sum", "window_s": 15.0,
        "op": ">", "threshold_config_frac": ["object_store_memory", 0.9],
        "for_s": 5.0,
        "severity": "critical",
        "summary": "Object store is within 10% of its byte cap",
    },
    {
        "name": "suspect_nodes",
        "metric": "ray_tpu_cluster_suspect_nodes",
        "kind": "gauge", "agg": "max", "window_s": 15.0,
        "op": ">", "threshold": 0.0, "for_s": 0.0,
        "severity": "critical",
        "summary": "At least one node is heartbeat-SUSPECT",
    },
    {
        # Training-gang straggler: the BackendExecutor publishes per-round
        # step-time skew (slowest minus fastest rank) as a gauge per gang;
        # sustained skew above the config knob means one rank is holding
        # every collective hostage. The driver additionally emits a
        # train_straggler event that NAMES the slow rank and its dominant
        # phase (data the head-side engine does not have).
        "name": "train_straggler",
        "metric": "ray_tpu_train_step_skew_seconds",
        "kind": "gauge", "agg": "max", "window_s": 15.0,
        "op": ">", "threshold_config_frac": ["train_straggler_skew_s", 1.0],
        "for_s": 2.0,
        "severity": "warning",
        "summary": "A training-gang rank is straggling its steps",
    },
    {
        # Starved tenant (jobs.py): some job's per-task queue-wait p95 over
        # the window exceeds the config knob — its tasks sit queued while
        # (typically) another job's flood holds every lease. agg=max: the
        # WORST job is the signal, whichever one it is.
        "name": "job_starved",
        "metric": "ray_tpu_job_queue_wait_seconds",
        "kind": "quantile", "agg": "max", "window_s": 10.0, "q": 0.95,
        "op": ">", "threshold_config_frac": ["job_starved_wait_s", 1.0],
        "for_s": 3.0,
        "severity": "warning",
        "summary": "A job's queue-wait p95 says it is being starved",
    },
    {
        # Runaway tenant: one job owns more than half the object-store byte
        # budget — the usual prelude to object_store_near_cap, but with a
        # name attached (the job label on the breaching series).
        "name": "job_runaway_object_bytes",
        "metric": "ray_tpu_job_object_bytes",
        "kind": "gauge", "agg": "max", "window_s": 15.0,
        "op": ">", "threshold_config_frac": ["object_store_memory", 0.5],
        "for_s": 5.0,
        "severity": "warning",
        "summary": "One job owns over half the object-store byte budget",
    },
]


TagsKey = Tuple[Tuple[str, str], ...]


class _Series:
    """One bounded ring of samples for a (name, tags) pair.

    Point shapes by kind:
      counter    (ts, delta)            delta since the previous sample
      gauge      (ts, value)
      histogram  (ts, counts, sum, count)  CUMULATIVE per-process rows;
                 consumers diff consecutive rows (ring eviction is safe:
                 the oldest retained row is the diff baseline)
    """

    __slots__ = ("name", "kind", "tags", "points", "boundaries",
                 "last_cum", "last_ts", "exemplars", "last_exemplar_ts")

    def __init__(self, name: str, kind: str, tags: TagsKey, maxlen: int,
                 boundaries: Optional[tuple] = None):
        self.name = name
        self.kind = kind
        self.tags = tags
        self.points: deque = deque(maxlen=maxlen)
        self.boundaries = boundaries
        self.last_cum: Any = None  # counter/hist cursor (cumulative)
        self.last_ts = 0.0
        # Trace exemplars: (ts, value, trace_id) observations that carried a
        # trace id (util/metrics exemplar support). Bounded; the flusher
        # re-sends its rolling window, so ingestion dedups by timestamp.
        self.exemplars: deque = deque(maxlen=8)
        self.last_exemplar_ts = 0.0


class TimeSeriesStore:
    """Bounded in-memory TSDB fed by the per-process KV metric flushes.

    Thread-safety: ingestion and pruning happen on the scheduler loop
    thread; queries arrive from driver command handlers on the same thread
    in-process, but the store takes its own lock anyway so dashboards / CLI
    readers in other threads (in-proc LocalContext goes through the loop,
    remote readers too) stay correct if that routing ever changes."""

    def __init__(self, step_s: float = 1.0, retention_s: float = 600.0,
                 max_series: int = 4000):
        self.step_s = max(0.05, float(step_s))
        self.retention_s = max(self.step_s, float(retention_s))
        self.max_series = max(1, int(max_series))
        self._maxlen = max(2, int(self.retention_s / self.step_s))
        self._series: Dict[Tuple[str, TagsKey], _Series] = {}
        self._lock = threading.Lock()
        self.ingested_snapshots = 0
        self.dropped_series = 0

    # ----------------------------------------------------------------- ingest
    def ingest(self, pid: str, snapshot: List[dict],
               now: Optional[float] = None) -> None:
        """Fold one process's registry snapshot (util/metrics.py `_snapshot`
        shapes) into the store. Unknown/malformed entries are skipped — a
        bad metric must never take down ingestion for the rest."""
        now = time.time() if now is None else float(now)
        with self._lock:
            self.ingested_snapshots += 1
            for m in snapshot:
                try:
                    self._ingest_metric(pid, m, now)
                except Exception:  # noqa: BLE001 — skip malformed entries
                    continue

    def _ingest_metric(self, pid: str, m: dict, now: float) -> None:
        name, kind = m["name"], m["type"]
        boundaries = tuple(m["buckets"]) if kind == "histogram" else None
        for tags, value in m["series"]:
            tkey = tuple(sorted(
                [(str(k), str(v)) for k, v in tags] + [("pid", pid)]
            ))
            s = self._series.get((name, tkey))
            if s is None:
                if len(self._series) >= self.max_series:
                    self.dropped_series += 1
                    continue
                s = _Series(name, kind, tkey, self._maxlen, boundaries)
                self._series[(name, tkey)] = s
            if kind == "counter":
                self._ingest_counter(s, float(value), now)
            elif kind == "gauge":
                self._ingest_gauge(s, float(value), now)
            else:
                self._ingest_hist(s, value, now)
        for tags, samples in m.get("exemplars") or ():
            tkey = tuple(sorted(
                [(str(k), str(v)) for k, v in tags] + [("pid", pid)]
            ))
            s = self._series.get((name, tkey))
            if s is None:
                continue
            # The per-process flusher re-sends its rolling exemplar window
            # every second: dedup by timestamp cursor.
            for ts, val, trace_id in samples:
                if ts > s.last_exemplar_ts:
                    s.exemplars.append((float(ts), float(val), str(trace_id)))
                    s.last_exemplar_ts = float(ts)

    def _ingest_counter(self, s: _Series, cum: float, now: float) -> None:
        if s.last_cum is None:
            # First sight: set the cursor WITHOUT a point — emitting the
            # whole cumulative value as one delta would spike every rate
            # query by the process's lifetime total.
            s.last_cum, s.last_ts = cum, now
            return
        delta = cum - s.last_cum
        if delta < 0:
            delta = cum  # counter reset (process restarted under one pid)
        s.last_cum = cum
        if delta == 0 and now - s.last_ts < self.step_s:
            return
        if s.points and now - s.points[-1][0] < self.step_s:
            ts0, d0 = s.points[-1]
            s.points[-1] = (ts0, d0 + delta)
        else:
            s.points.append((now, delta))
            s.last_ts = now

    def _ingest_gauge(self, s: _Series, value: float, now: float) -> None:
        if s.points and now - s.points[-1][0] < self.step_s:
            s.points[-1] = (s.points[-1][0], value)
        else:
            s.points.append((now, value))
            s.last_ts = now

    def _ingest_hist(self, s: _Series, data: dict, now: float) -> None:
        counts = tuple(data.get("bucket_counts") or ())
        row = (now, counts, float(data.get("sum") or 0.0),
               int(data.get("count") or 0))
        if s.points and now - s.points[-1][0] < self.step_s:
            s.points[-1] = (s.points[-1][0],) + row[1:]
        else:
            s.points.append(row)
            s.last_ts = now

    # ------------------------------------------------------------------ prune
    def prune_process(self, pid: str) -> int:
        """Drop every series the given process exported (its worker/daemon
        was removed): dead processes must not leave frozen series behind."""
        with self._lock:
            gone = [k for k, s in self._series.items()
                    if dict(s.tags).get("pid") == pid]
            for k in gone:
                del self._series[k]
            return len(gone)

    # ------------------------------------------------------------------ query
    def _matching(self, name: str,
                  labels: Optional[Dict[str, str]]) -> List[_Series]:
        out = []
        for (n, _t), s in self._series.items():
            if n != name:
                continue
            if labels:
                tags = dict(s.tags)
                if any(tags.get(k) != str(v) for k, v in labels.items()):
                    continue
            out.append(s)
        return out

    def query(self, name: str, labels: Optional[Dict[str, str]] = None,
              since: Optional[float] = None, until: Optional[float] = None,
              step: Optional[float] = None, agg: str = "sum",
              q: Optional[float] = None,
              group_by_pid: bool = False) -> Dict[str, Any]:
        """Windowed series readout.

        Returns ``{"name", "kind", "step", "series": [{"labels", "points"}]}``
        with one entry per distinct label set (processes merge unless
        `group_by_pid`). Point values by kind: counters -> RATE per second
        over each step window; gauges -> agg of the freshest sample per
        window (carried forward across empty windows); histograms with `q`
        -> the q-quantile of observations that landed in each window (None
        where the window saw no observations; interpolated within buckets,
        the Prometheus histogram_quantile convention)."""
        now = time.time()
        until = now if until is None else float(until)
        # Clamp the window to retention: no older point can exist, and an
        # unclamped far-past `since` (e.g. /api/series?since=0) would build
        # tens of thousands of windows ON THE SCHEDULER LOOP — each window
        # rescans the matching rings — stalling dispatch and heartbeats.
        floor = until - self.retention_s
        since = floor if since is None else max(float(since), floor)
        step = self.step_s if not step else max(self.step_s, float(step))
        if until <= since:
            return {"name": name, "kind": None, "step": step, "series": []}
        with self._lock:
            matching = self._matching(name, labels)
            if not matching:
                return {"name": name, "kind": None, "step": step, "series": []}
            kind = matching[0].kind
            groups: Dict[TagsKey, List[_Series]] = {}
            for s in matching:
                gtags = s.tags if group_by_pid else tuple(
                    t for t in s.tags if t[0] != "pid"
                )
                groups.setdefault(gtags, []).append(s)
            edges = self._edges(since, until, step)
            out = []
            for gtags, members in sorted(groups.items()):
                if kind == "counter":
                    pts = self._query_counter(members, edges, step)
                elif kind == "gauge":
                    pts = self._query_gauge(members, edges, agg)
                else:
                    pts = self._query_hist(members, edges,
                                           0.95 if q is None else float(q))
                entry = {"labels": dict(gtags), "points": pts}
                ex = sorted(
                    (e for s in members for e in s.exemplars
                     if since <= e[0] <= until),
                    key=lambda e: e[1], reverse=True,
                )[:8]
                if ex:
                    # Largest-value traced observations in the window: the
                    # "which trace paid this" link for dashboards/alerts.
                    entry["exemplars"] = [
                        {"ts": ts, "value": val, "trace_id": tid}
                        for ts, val, tid in ex
                    ]
                out.append(entry)
            return {"name": name, "kind": kind, "step": step, "series": out}

    @staticmethod
    def _edges(since: float, until: float, step: float) -> List[float]:
        edges = []
        t = since
        while t < until and len(edges) < 100_000:
            edges.append(t)
            t += step
        edges.append(until)
        return edges

    @staticmethod
    def _query_counter(members: List[_Series], edges: List[float],
                       step: float) -> List[List[float]]:
        # One ordered pass per member (points and edges are both sorted):
        # rescanning every ring per window is O(windows x points) and this
        # runs on the scheduler loop.
        sums = [0.0] * (len(edges) - 1)
        for s in members:
            wi = 0
            for ts, d in s.points:
                if ts <= edges[0]:
                    continue
                while wi < len(sums) and ts > edges[wi + 1]:
                    wi += 1
                if wi >= len(sums):
                    break
                sums[wi] += d
        pts = []
        for i, total in enumerate(sums):
            width = edges[i + 1] - edges[i]
            pts.append([edges[i + 1], total / (width if width > 0 else step)])
        return pts

    @staticmethod
    def _query_gauge(members: List[_Series], edges: List[float],
                     agg: str) -> List[List[float]]:
        pts: List[List[float]] = []
        # Per-member cursor: the freshest sample at-or-before each window
        # end, carried forward across empty windows.
        cursors = [list(s.points) for s in members]
        idx = [0] * len(members)
        last_val: List[Optional[float]] = [None] * len(members)
        for i in range(len(edges) - 1):
            hi = edges[i + 1]
            vals = []
            for mi, series_pts in enumerate(cursors):
                while (idx[mi] < len(series_pts)
                       and series_pts[idx[mi]][0] <= hi):
                    last_val[mi] = series_pts[idx[mi]][1]
                    idx[mi] += 1
                if last_val[mi] is not None:
                    vals.append(last_val[mi])
            if not vals:
                continue
            if agg == "max":
                v = max(vals)
            elif agg == "avg":
                v = sum(vals) / len(vals)
            else:
                v = sum(vals)
            pts.append([hi, v])
        return pts

    @staticmethod
    def _hist_window_delta(members: List[_Series], lo: float, hi: float):
        """Summed (bucket_deltas, count_delta, boundaries) of observations
        landing in (lo, hi] across members, by differencing each member's
        newest cumulative row at-or-before each edge."""
        boundaries = None
        bucket_delta: Optional[List[float]] = None
        count_delta = 0
        for s in members:
            if s.boundaries is None:
                continue
            row_lo = row_hi = None
            for row in s.points:
                if row[0] <= lo:
                    row_lo = row
                if row[0] <= hi:
                    row_hi = row
                else:
                    break
            if row_hi is None:
                continue
            base_counts = row_lo[1] if row_lo else ()
            base_count = row_lo[3] if row_lo else 0
            if boundaries is None:
                boundaries = s.boundaries
                bucket_delta = [0.0] * len(boundaries)
            if s.boundaries != boundaries:
                continue  # mismatched boundary sets don't merge
            for bi in range(min(len(bucket_delta), len(row_hi[1]))):
                prev = base_counts[bi] if bi < len(base_counts) else 0
                bucket_delta[bi] += row_hi[1][bi] - prev
            count_delta += row_hi[3] - base_count
        return bucket_delta, count_delta, boundaries

    @classmethod
    def _query_hist(cls, members: List[_Series], edges: List[float],
                    q: float) -> List[List[Optional[float]]]:
        pts: List[List[Optional[float]]] = []
        for i in range(len(edges) - 1):
            lo, hi = edges[i], edges[i + 1]
            bucket_delta, count_delta, boundaries = cls._hist_window_delta(
                members, lo, hi
            )
            if boundaries is None or count_delta <= 0:
                continue
            pts.append([hi, _bucket_quantile(boundaries, bucket_delta,
                                             count_delta, q)])
        return pts

    def exemplars_for(self, name: str, labels: Optional[Dict[str, str]] = None,
                      since: Optional[float] = None) -> List[dict]:
        """The window's traced observations for `name` (largest first):
        the alert engine attaches these to firing transitions so an alert
        links to concrete slow traces."""
        now = time.time()
        since = (now - self.retention_s) if since is None else float(since)
        with self._lock:
            ex = sorted(
                (e for s in self._matching(name, labels) for e in s.exemplars
                 if e[0] >= since),
                key=lambda e: e[1], reverse=True,
            )[:8]
        return [{"ts": ts, "value": val, "trace_id": tid}
                for ts, val, tid in ex]

    # ------------------------------------------------------------------ intro
    def series_count(self) -> int:
        with self._lock:
            return len(self._series)

    def names(self) -> List[str]:
        with self._lock:
            return sorted({n for (n, _t) in self._series})

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "series": len(self._series),
                "max_series": self.max_series,
                "dropped_series": self.dropped_series,
                "ingested_snapshots": self.ingested_snapshots,
                "step_s": self.step_s,
                "retention_s": self.retention_s,
            }


def _bucket_quantile(boundaries: tuple, bucket_counts: List[float],
                     total: int, q: float) -> float:
    """Quantile from per-bucket observation counts (observe() puts a value
    into the FIRST bucket whose boundary >= value; overflow beyond the last
    boundary appears only in `total`). Linear interpolation inside the
    winning bucket — the histogram_quantile convention; values past the last
    boundary clamp to it (the histogram can't resolve further)."""
    target = max(0.0, min(1.0, q)) * total
    acc = 0.0
    for i, b in enumerate(boundaries):
        c = bucket_counts[i] if i < len(bucket_counts) else 0
        if acc + c >= target and c > 0:
            lo = boundaries[i - 1] if i > 0 else 0.0
            frac = (target - acc) / c
            return lo + (b - lo) * frac
        acc += c
    return float(boundaries[-1]) if boundaries else 0.0


# ---------------------------------------------------------------------------
# Alert engine
# ---------------------------------------------------------------------------
class AlertRule:
    __slots__ = ("name", "metric", "kind", "labels", "agg", "window_s", "q",
                 "op", "threshold", "for_s", "severity", "summary",
                 "state", "pending_since", "clear_since", "last_value",
                 "fired_at", "exemplars")

    def __init__(self, spec: dict, config=None):
        self.name = spec["name"]
        self.metric = spec["metric"]
        self.kind = spec.get("kind", "gauge")
        self.labels = dict(spec.get("labels") or {})
        self.agg = spec.get("agg", "sum")
        self.window_s = float(spec.get("window_s", 15.0))
        self.q = spec.get("q")
        self.op = spec.get("op", ">")
        if "threshold_config_frac" in spec:
            field, frac = spec["threshold_config_frac"]
            base = float(getattr(config, field)) if config is not None else 0.0
            self.threshold = float(frac) * base
        else:
            self.threshold = float(spec["threshold"])
        self.for_s = float(spec.get("for_s", 0.0))
        self.severity = spec.get("severity", "warning")
        self.summary = spec.get("summary", self.name)
        # ok -> pending -> firing, with symmetric clear hysteresis.
        self.state = "ok"
        self.pending_since: Optional[float] = None
        self.clear_since: Optional[float] = None
        self.last_value: Optional[float] = None
        self.fired_at: Optional[float] = None
        # Trace exemplars captured at the last FIRING transition: concrete
        # slow traces behind the alert (state.get_trace them).
        self.exemplars: List[dict] = []

    def payload(self) -> Dict[str, Any]:
        return {
            "name": self.name, "metric": self.metric, "kind": self.kind,
            "labels": dict(self.labels), "op": self.op,
            "threshold": self.threshold, "for_s": self.for_s,
            "severity": self.severity, "summary": self.summary,
            "state": self.state, "value": self.last_value,
            "fired_at": self.fired_at,
            "exemplars": list(self.exemplars),
        }


class AlertEngine:
    """Evaluates rules against the store; tracks per-rule hysteresis state;
    reports transitions to an event sink and registered callbacks."""

    def __init__(self, store: TimeSeriesStore, rules: List[dict],
                 config=None,
                 event_sink: Optional[Callable[..., None]] = None):
        self.store = store
        self.rules = [AlertRule(spec, config) for spec in rules]
        self._event_sink = event_sink
        self._callbacks: List[Callable[[dict, str], None]] = []
        # RLock: transition callbacks run under the lock (evaluate holds it)
        # and may legitimately read engine state back (list_alerts).
        self._lock = threading.RLock()

    def add_rule(self, spec: dict, config=None) -> None:
        with self._lock:
            self.rules.append(AlertRule(spec, config))

    def add_callback(self, cb: Callable[[dict, str], None]) -> None:
        """cb(rule_payload, transition) with transition "firing"|"resolved".
        Runs on the evaluating thread (the scheduler loop): keep it cheap."""
        self._callbacks.append(cb)

    def firing(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [r.payload() for r in self.rules if r.state == "firing"]

    def payload(self) -> List[Dict[str, Any]]:
        with self._lock:
            return [r.payload() for r in self.rules]

    # ------------------------------------------------------------------ eval
    def _rule_value(self, rule: AlertRule, now: float) -> Optional[float]:
        res = self.store.query(
            rule.metric, labels=rule.labels or None,
            since=now - rule.window_s, until=now, step=rule.window_s,
            agg=rule.agg, q=rule.q,
        )
        vals = [p[1] for series in res["series"] for p in series["points"]
                if p[1] is not None]
        if not vals:
            return None
        if rule.kind == "rate":
            return sum(vals)
        if rule.agg == "max":
            return max(vals)
        if rule.agg == "avg":
            return sum(vals) / len(vals)
        return sum(vals)

    def evaluate(self, now: Optional[float] = None) -> None:
        now = time.time() if now is None else float(now)
        with self._lock:
            for rule in self.rules:
                try:
                    self._evaluate_rule(rule, now)
                except Exception:  # noqa: BLE001 — a broken rule stays quiet
                    continue

    def _evaluate_rule(self, rule: AlertRule, now: float) -> None:
        value = self._rule_value(rule, now)
        rule.last_value = value
        breach = (
            value is not None
            and (value > rule.threshold if rule.op == ">"
                 else value < rule.threshold)
        )
        if rule.state in ("ok", "pending"):
            if breach:
                if rule.pending_since is None:
                    rule.pending_since = now
                    rule.state = lifecycle.step("alert", rule.state, "pending")
                if now - rule.pending_since >= rule.for_s:
                    rule.state = lifecycle.step("alert", rule.state, "firing")
                    rule.fired_at = now
                    rule.clear_since = None
                    self._transition(rule, "firing", value)
            else:
                rule.state = lifecycle.step("alert", rule.state, "ok")
                rule.pending_since = None
        else:  # firing
            if breach:
                rule.clear_since = None
            else:
                if rule.clear_since is None:
                    rule.clear_since = now
                if now - rule.clear_since >= rule.for_s:
                    rule.state = lifecycle.step("alert", rule.state, "ok")
                    rule.pending_since = None
                    rule.clear_since = None
                    self._transition(rule, "resolved", value)

    def _transition(self, rule: AlertRule, transition: str,
                    value: Optional[float]) -> None:
        if transition == "firing":
            # Link the alert to concrete traces: the window's traced
            # observations of the rule's metric (exemplars ride the metric
            # flushes into the store; empty when nothing was traced).
            try:
                rule.exemplars = self.store.exemplars_for(
                    rule.metric, rule.labels or None,
                    since=time.time() - max(rule.window_s, 60.0),
                )
            except Exception:  # noqa: BLE001 — linkage is best-effort
                rule.exemplars = []
        if self._event_sink is not None:
            kind = "alert_firing" if transition == "firing" else "alert_resolved"
            sev = rule.severity if transition == "firing" else "info"
            self._event_sink(
                kind,
                f"alert {rule.name} {transition}: {rule.summary} "
                f"(value={value!r}, threshold {rule.op} {rule.threshold:g})",
                severity=sev, rule=rule.name, value=value,
                threshold=rule.threshold,
                exemplar_trace_ids=[e["trace_id"] for e in rule.exemplars],
            )
        payload = rule.payload()
        for cb in list(self._callbacks):
            try:
                cb(payload, transition)
            except Exception:  # noqa: BLE001 — user callback must not break eval
                pass


# ---------------------------------------------------------------------------
# ObsState: what the scheduler owns when enable_metrics is on
# ---------------------------------------------------------------------------
class ObsState:
    """Store + engine + the layer's own metrics, attached to the scheduler
    (`sched.obs`). None when enable_metrics is off — the knob-off contract is
    the absence of this object."""

    def __init__(self, config, gcs):
        self.config = config
        self.gcs = gcs
        self.store = TimeSeriesStore(
            step_s=config.obs_series_step_s,
            retention_s=config.obs_series_retention_s,
            max_series=config.obs_max_series,
        )
        gcs.set_cluster_event_cap(config.cluster_event_cap)
        self.engine = AlertEngine(
            self.store, DEFAULT_ALERT_RULES, config=config,
            event_sink=self._sink_event,
        )
        self._eval_interval = max(0.05, float(config.alert_eval_interval_s))
        self._last_eval = 0.0
        self._metrics: Optional[dict] = None
        self._last_events_total = 0
        # Optional parsed-snapshot tap (JobLedger.ingest_snapshot): runs on
        # the same already-parsed JSON this ingest pays for — per-job Serve
        # request attribution costs no second parse and no new traffic.
        self.snapshot_hook: Optional[Callable[[str, list], None]] = None
        # Standalone head servers have no driver context, so their registry
        # flusher can't reach the KV the normal way — give it a direct sink
        # into THIS process's GCS + store (no-op in in-proc drivers, whose
        # context path already lands in _cmd_kv).
        from ray_tpu_torch.util import metrics as _metrics_mod

        _metrics_mod.set_local_sink(self._local_flush)

    def _local_flush(self, key: bytes, value: bytes) -> None:
        self.gcs.kv_put(key, value)
        self.ingest_kv(key, value)

    def close(self) -> None:
        from ray_tpu_torch.util import metrics as _metrics_mod

        _metrics_mod.set_local_sink(None)

    def _sink_event(self, kind: str, message: str, severity: str = "info",
                    **data) -> None:
        self.gcs.append_cluster_event(kind, message, severity=severity,
                                      source="head", data=data)

    # ---------------------------------------------------------------- ingest
    def ingest_kv(self, key: bytes, value: bytes) -> None:
        """Called by the scheduler's kv handler for every `metrics::<pid>`
        put — the per-process registry flush IS the ingestion cadence, so
        history costs no extra protocol traffic.

        Known limitation (inherited from the KV metrics-snapshot scheme, which this
        store keys consistently with): `metrics::<pid>` assumes one pid
        namespace. Two processes on DIFFERENT hosts sharing a pid would
        already overwrite each other's KV snapshot before this layer ever
        saw them; fixing that means a `<node>:<pid>` key at the flush seam,
        which is a metrics-pipeline change, not a store change."""
        try:
            pid = key.decode().split("::", 1)[1]
            snapshot = json.loads(value)
            self.store.ingest(pid, snapshot)
            if self.snapshot_hook is not None:
                self.snapshot_hook(pid, snapshot)
        except Exception:  # noqa: BLE001 — malformed snapshot: skip
            pass

    def prune_process(self, pid: str) -> int:
        return self.store.prune_process(str(pid))

    # ------------------------------------------------------------------ tick
    def on_iteration(self, sched, now: float) -> None:
        """Scheduler-loop hook, self-gated by alert_eval_interval_s."""
        if now - self._last_eval < self._eval_interval:
            return
        self._last_eval = now
        self.engine.evaluate(now)
        m = self._metrics
        if m is None:
            m = self._metrics = self._create_metrics()
        for rule in self.engine.rules:
            m["firing"].set(1.0 if rule.state == "firing" else 0.0,
                            {"rule": rule.name})
        m["series_count"].set(float(self.store.series_count()))
        total = self.gcs.cluster_events_total
        d = total - self._last_events_total
        if d > 0:
            m["events_total"].inc(d)
        self._last_events_total = total

    def _create_metrics(self) -> dict:
        from ray_tpu_torch.util.metrics import Counter, Gauge

        return {
            "firing": Gauge(
                "ray_tpu_alerts_firing",
                "1 while the named alert rule is firing", ("rule",)),
            "series_count": Gauge(
                "ray_tpu_obs_series_count",
                "distinct series tracked by the head time-series store"),
            "events_total": Counter(
                "ray_tpu_obs_events_total",
                "cluster events appended to the GCS event ring"),
        }

    # ----------------------------------------------------------------- query
    def query(self, payload: Optional[dict]) -> Dict[str, Any]:
        payload = dict(payload or {})
        name = payload.pop("name", None)
        if not name:
            raise ValueError("query_series needs a metric name")
        return self.store.query(name, **payload)

    def stats(self) -> Dict[str, Any]:
        out = self.store.stats()
        out["alerts"] = self.engine.payload()
        out["events_total"] = self.gcs.cluster_events_total
        return out
