"""Runtime-internal telemetry: the glue between hot paths and util/metrics.

Reference: the C++ OpenCensus stats pipeline (`src/ray/stats/metric_defs.cc`
defines the scheduler/object-store/task counters the dashboard charts). Here
the same role is filled by the existing `util/metrics.py` registry, with one
hard rule: **hot paths never touch Metric objects**. They bump plain ints and
append to plain lists; materialization into Counters/Gauges/Histograms
happens at snapshot cadence — once per scheduler-loop tick (SchedulerTelemetry)
or once per registry flush (the register_collector hooks used by the batching
layer and the object-store read path).

Every metric name exported by the runtime is listed in COMPONENTS.md
(Observability section); keep the two in sync.
"""

from __future__ import annotations

from typing import Dict, List, Optional


def metrics_enabled() -> bool:
    from ray_tpu_torch._private.config import get_config

    return bool(get_config().enable_metrics)


def obs_enabled() -> bool:
    """The over-time layer (time-series store / cluster events / alerts):
    enable_metrics is the master switch, enable_obs the sub-knob."""
    from ray_tpu_torch._private.config import get_config

    cfg = get_config()
    return bool(cfg.enable_metrics and cfg.enable_obs)


# Bucket boundaries for control-plane latency histograms: sub-ms to tens of
# seconds (queue waits under load can be long).
_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


class SchedulerTelemetry:
    """Scheduler-side counters + gauges.

    The event loop calls `on_iteration(scheduler, now)` every pass; raw
    increments come from the dispatch/completion/spill paths as plain
    attribute bumps. Metric objects are created lazily on the first tick so
    a metrics-off runtime never registers them (and never starts the
    registry flusher thread)."""

    def __init__(self, config):
        self.enabled = bool(config.enable_metrics)
        self._interval = float(config.internal_metrics_interval_s)
        self._last_tick = 0.0
        self._metrics = None
        # Hot-path accumulators (plain ints/lists; loop-thread only).
        self.submitted = 0
        self.dispatched = 0
        self.finished = 0
        self.failed = 0
        self.retried = 0
        self.loop_iterations = 0
        self.spill_ops = 0
        self.spilled_bytes = 0
        self.dispatch_waits: List[float] = []
        self.exec_times: List[float] = []
        # Scheduler-side outbound coalescing (_send_to/_flush_outbound).
        self.out_msgs = 0
        self.out_frames = 0
        # Heartbeat detector transitions (_check_heartbeats): plain ints,
        # materialized into the tagged counters below per tick.
        self.hb_suspect_daemon = 0
        self.hb_suspect_worker = 0
        self.hb_dead_daemon = 0
        # Live-introspection traffic (stack dumps / profiler sessions):
        # bumped by the scheduler's fan-out machinery, materialized per tick.
        self.stack_dump_requests = 0
        self.stack_dumps_inband = 0
        self.stack_dumps_oob = 0
        self.stack_dumps_unavailable = 0
        self.profile_sessions = 0
        # Data-plane cursor: sched._transfer_stats is CUMULATIVE (the
        # transfer_stats() introspection reads it directly), so the tick
        # exports deltas against this snapshot.
        self._last_transfer: Dict[str, int] = {}

    # ---------------------------------------------------------------- ticks
    def on_iteration(self, sched, now: float) -> None:
        self.loop_iterations += 1
        if not self.enabled or now - self._last_tick < self._interval:
            return
        self._last_tick = now
        m = self._metrics
        if m is None:
            m = self._metrics = self._create_metrics()
        m["pending"].set(len(sched.pending))
        leased = [wh for lst in sched._leases.values() for wh in lst]
        m["lease_workers"].set(len(leased))
        m["lease_occupancy"].set(sum(len(wh.inflight_tasks) for wh in leased))
        m["objects"].set(len(sched.object_table))
        m["object_bytes"].set(float(sum(sched.node_usage.values())))
        m["tasks"].set(len(sched.tasks))
        # Live SUSPECT count (not the cumulative transition counter): the
        # suspect_nodes alert rule needs a level, not an edge count.
        m["suspect_nodes"].set(float(sum(
            1 for n in sched.nodes.values()
            if n.alive and n.health == "SUSPECT"
        )))
        self._drain_counter(m["submitted"], "submitted")
        self._drain_counter(m["dispatched"], "dispatched")
        self._drain_counter(m["retried"], "retried")
        self._drain_counter(m["loop_iters"], "loop_iterations")
        self._drain_counter(m["spill_ops"], "spill_ops")
        self._drain_counter(m["spilled_bytes"], "spilled_bytes")
        self._drain_counter(m["out_msgs"], "out_msgs")
        self._drain_counter(m["out_frames"], "out_frames")
        self._drain_counter(m["stack_dump_requests"], "stack_dump_requests")
        self._drain_counter(m["profile_sessions"], "profile_sessions")
        for attr, transport in (
            ("stack_dumps_inband", "inband"),
            ("stack_dumps_oob", "oob"),
            ("stack_dumps_unavailable", "unavailable"),
        ):
            v = getattr(self, attr)
            if v:
                m["stack_dumps"].inc(v, {"transport": transport})
                setattr(self, attr, 0)
        if self.hb_suspect_daemon:
            m["hb_suspect"].inc(self.hb_suspect_daemon, {"kind": "daemon"})
            self.hb_suspect_daemon = 0
        if self.hb_suspect_worker:
            m["hb_suspect"].inc(self.hb_suspect_worker, {"kind": "worker"})
            self.hb_suspect_worker = 0
        if self.hb_dead_daemon:
            m["hb_dead"].inc(self.hb_dead_daemon, {"kind": "daemon"})
            self.hb_dead_daemon = 0
        ts = sched._transfer_stats
        last = self._last_transfer
        for attr, metric in (("locality_hits", "locality_hits"),
                             ("relay_pulls", "relay_pulls"),
                             ("relay_bytes", "relay_bytes")):
            d = ts[attr] - last.get(attr, 0)
            if d:
                m[metric].inc(d)
                last[attr] = ts[attr]
        if self.finished:
            m["terminal"].inc(self.finished, {"state": "FINISHED"})
            self.finished = 0
        if self.failed:
            m["terminal"].inc(self.failed, {"state": "FAILED"})
            self.failed = 0
        if self.dispatch_waits:
            waits, self.dispatch_waits = self.dispatch_waits, []
            for w in waits:
                m["dispatch_wait"].observe(w)
        if self.exec_times:
            execs, self.exec_times = self.exec_times, []
            for e in execs:
                m["exec_time"].observe(e)

    def _drain_counter(self, metric, attr: str) -> None:
        v = getattr(self, attr)
        if v:
            metric.inc(v)
            setattr(self, attr, 0)

    def _create_metrics(self) -> Dict[str, object]:
        from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

        return {
            "pending": Gauge("ray_tpu_scheduler_pending_tasks",
                             "tasks queued in the scheduler (all dispatch classes)"),
            "lease_workers": Gauge("ray_tpu_scheduler_leased_workers",
                                   "workers currently holding a dispatch-class lease"),
            "lease_occupancy": Gauge("ray_tpu_scheduler_lease_occupancy",
                                     "in-flight tasks across leased workers (pipeline fill)"),
            "tasks": Gauge("ray_tpu_scheduler_task_records",
                           "live task records in the scheduler table"),
            "objects": Gauge("ray_tpu_object_store_objects",
                             "objects registered in the cluster object table"),
            "object_bytes": Gauge("ray_tpu_object_store_bytes",
                                  "bytes of sealed shared-memory segments across nodes"),
            "submitted": Counter("ray_tpu_scheduler_tasks_submitted_total",
                                 "task submissions registered"),
            "dispatched": Counter("ray_tpu_scheduler_tasks_dispatched_total",
                                  "tasks dispatched to workers"),
            "retried": Counter("ray_tpu_scheduler_tasks_retried_total",
                               "task retries after worker death/OOM"),
            "terminal": Counter("ray_tpu_scheduler_tasks_terminal_total",
                                "tasks reaching a terminal state", ("state",)),
            "loop_iters": Counter("ray_tpu_scheduler_loop_iterations_total",
                                  "scheduler event-loop iterations"),
            "spill_ops": Counter("ray_tpu_object_store_spill_ops_total",
                                 "objects relocated to the disk spill dir"),
            "spilled_bytes": Counter("ray_tpu_object_store_spilled_bytes_total",
                                     "bytes relocated to the disk spill dir"),
            "out_msgs": Counter("ray_tpu_scheduler_outbound_msgs_total",
                                "control messages coalesced by the scheduler loop"),
            "out_frames": Counter("ray_tpu_scheduler_outbound_frames_total",
                                  "frames the scheduler loop actually wrote"),
            "suspect_nodes": Gauge(
                "ray_tpu_cluster_suspect_nodes",
                "nodes currently heartbeat-SUSPECT (level, not edge count)"),
            "hb_suspect": Counter("ray_tpu_heartbeat_suspect_total",
                                  "peers marked SUSPECT by the heartbeat "
                                  "staleness detector", ("kind",)),
            "hb_dead": Counter("ray_tpu_heartbeat_dead_total",
                               "peers declared DEAD by the heartbeat "
                               "staleness detector", ("kind",)),
            "stack_dump_requests": Counter(
                "ray_tpu_stack_dump_requests_total",
                "per-process stack-dump requests fanned out by the head"),
            "stack_dumps": Counter(
                "ray_tpu_stack_dumps_total",
                "stack-dump outcomes by transport "
                "(inband/oob/unavailable)", ("transport",)),
            "profile_sessions": Counter(
                "ray_tpu_profile_sessions_total",
                "cluster-wide sampling-profiler sessions started"),
            "locality_hits": Counter(
                "ray_tpu_locality_hits_total",
                "tasks with byte-heavy args placed on a node already "
                "holding them (those transfers never happen)"),
            "relay_pulls": Counter(
                "ray_tpu_transfer_relay_total",
                "cross-node pulls that fell back to relaying bytes through "
                "the head (peer-direct is the expected route)"),
            "relay_bytes": Counter(
                "ray_tpu_transfer_relay_bytes_total",
                "object bytes relayed through the head's control plane"),
            "dispatch_wait": Histogram(
                "ray_tpu_scheduler_dispatch_wait_s",
                "queued -> lease_granted wait per task",
                boundaries=_LATENCY_BUCKETS),
            "exec_time": Histogram(
                "ray_tpu_task_exec_time_s",
                "exec_start -> exec_end wall time per task (worker-reported)",
                boundaries=_LATENCY_BUCKETS),
        }


# ------------------------------------------------------------------ batching
_batching_installed = False


def ensure_batching_metrics() -> None:
    """Install the collector that publishes batching-layer stats. Called
    lazily from the first BatchedSender in a metrics-enabled process."""
    global _batching_installed
    if _batching_installed:
        return
    _batching_installed = True
    from ray_tpu_torch._private import batching
    from ray_tpu_torch.util.metrics import Counter, Histogram, register_collector

    # Single source of truth: the histogram's boundaries ARE the counting
    # buckets the send path increments (positional zip in collect()).
    BATCH_FLUSH_BOUNDS = batching._FLUSH_SIZE_BOUNDS

    msgs = Counter("ray_tpu_batch_messages_total",
                   "control messages that went through BatchedSenders")
    frames = Counter("ray_tpu_batch_frames_total",
                     "wire frames written by BatchedSenders (coalesce ratio = messages/frames)")
    bytes_total = Counter("ray_tpu_batch_bytes_total",
                          "approximate payload bytes through BatchedSenders")
    stragglers = Counter("ray_tpu_batch_straggler_flushes_total",
                         "flushes delivered by the straggler backstop timer")
    flush_size = Histogram("ray_tpu_batch_flush_size",
                           "messages per BatchedSender flush",
                           boundaries=BATCH_FLUSH_BOUNDS)
    last = {"msgs": 0, "frames": 0, "bytes": 0, "straggler_fires": 0,
            "sizes": [0] * (len(BATCH_FLUSH_BOUNDS))}

    def collect():
        # Snapshot ONCE, then diff and advance the cursor from the same
        # snapshot: re-reading the live dict when updating `last` would skip
        # any bumps that landed in between, losing them forever.
        s = dict(batching._STATS)
        sizes = list(batching._FLUSH_SIZE_COUNTS)
        d_msgs = s["msgs"] - last["msgs"]
        d_frames = s["frames"] - last["frames"]
        d_bytes = s["bytes"] - last["bytes"]
        d_strag = s["straggler_fires"] - last["straggler_fires"]
        if d_msgs:
            msgs.inc(d_msgs)
        if d_frames:
            frames.inc(d_frames)
        if d_bytes:
            bytes_total.inc(d_bytes)
        if d_strag:
            stragglers.inc(d_strag)
        deltas = [sizes[i] - last["sizes"][i] for i in range(len(last["sizes"]))]
        if d_frames or any(deltas):
            flush_size._merge_counts(deltas, d_frames, float(d_msgs))
        last.update(msgs=s["msgs"], frames=s["frames"], bytes=s["bytes"],
                    straggler_fires=s["straggler_fires"], sizes=sizes)

    register_collector(collect)


# ---------------------------------------------------------------- log shipper
_logshipper_installed = False


def ensure_logshipper_metrics() -> None:
    """Expose the _LogShipper overflow counter (worker_main._LOG_STATS —
    previously only surfaced as a '...dropped' text line in the log stream)
    as ray_tpu_log_lines_dropped_total. Installed once per worker process
    when the output tee goes in and metrics are enabled."""
    global _logshipper_installed
    if _logshipper_installed:
        return
    _logshipper_installed = True
    from ray_tpu_torch._private import worker_main
    from ray_tpu_torch.util.metrics import Counter, register_collector

    dropped = Counter(
        "ray_tpu_log_lines_dropped_total",
        "worker log lines dropped by the bounded shipper queue "
        "(backpressure on the out-of-band log channel)",
    )
    last = {"dropped": 0}

    def collect():
        # Snapshot once; diff and advance the cursor from the snapshot (see
        # the batching collector for why).
        s = worker_main._LOG_STATS["dropped"]
        d = s - last["dropped"]
        if d:
            dropped.inc(d)
        last["dropped"] = s

    register_collector(collect)


# -------------------------------------------------------------------- tracing
_tracing_installed = False


def ensure_tracing_metrics() -> None:
    """Expose the span-buffer overflow counter (util/tracing._DROPPED) as
    ray_tpu_trace_spans_dropped_total. Installed once per process when
    tracing turns on in a metrics-enabled runtime — the bounded buffer
    (enable-before-init, flush failures) must drop VISIBLY."""
    global _tracing_installed
    if _tracing_installed:
        return
    _tracing_installed = True
    from ray_tpu_torch.util import tracing
    from ray_tpu_torch.util.metrics import Counter, register_collector

    dropped = Counter(
        "ray_tpu_trace_spans_dropped_total",
        "trace spans dropped by the bounded per-process buffer "
        "(no runtime to flush into, or flush failures past the cap)",
    )
    last = {"spans": 0}

    def collect():
        # Snapshot once; diff and advance the cursor from the snapshot (see
        # the batching collector for why).
        s = tracing._DROPPED["spans"]
        d = s - last["spans"]
        if d:
            dropped.inc(d)
        last["spans"] = s

    register_collector(collect)


# --------------------------------------------------------------- object store
_objectstore_installed = False


def ensure_objectstore_client_metrics() -> None:
    """Publish the reader-side hit/pull counters accumulated in
    object_store.resolve_for_read (per process)."""
    global _objectstore_installed
    if _objectstore_installed:
        return
    _objectstore_installed = True
    from ray_tpu_torch._private import object_store
    from ray_tpu_torch.util.metrics import Counter, register_collector

    reads = Counter("ray_tpu_object_store_reads_total",
                    "segment reads by locality outcome", ("outcome",))
    pull_bytes = Counter("ray_tpu_object_store_pull_bytes_total",
                         "bytes transferred by cross-node object pulls")
    last = {"local_hits": 0, "cache_hits": 0, "pulls": 0, "pull_bytes": 0}

    def collect():
        # Snapshot once; diff and advance the cursor from the snapshot (see
        # the batching collector for why).
        s = dict(object_store._READ_STATS)
        for key, tag in (("local_hits", "local"), ("cache_hits", "cached"),
                         ("pulls", "pulled")):
            d = s[key] - last[key]
            if d:
                reads.inc(d, {"outcome": tag})
        d = s["pull_bytes"] - last["pull_bytes"]
        if d:
            pull_bytes.inc(d)
        last.update({k: s[k] for k in last})

    register_collector(collect)


# ------------------------------------------------------------- data plane
_transfer_installed = False


def ensure_transfer_metrics() -> None:
    """Publish the peer-transfer counters accumulated in
    object_transfer._STATS (per process): chunk/byte flow by direction and
    the PullManager's queue/in-flight gauges."""
    global _transfer_installed
    if _transfer_installed:
        return
    _transfer_installed = True
    from ray_tpu_torch._private import object_transfer
    from ray_tpu_torch.util.metrics import Counter, Gauge, register_collector

    bytes_total = Counter("ray_tpu_transfer_bytes_total",
                          "object bytes moved by peer-direct transfers",
                          ("direction",))
    chunks_total = Counter("ray_tpu_transfer_chunks_total",
                           "transfer_chunk frames moved by peer-direct "
                           "transfers", ("direction",))
    pulls_total = Counter("ray_tpu_transfer_pulls_total",
                          "PullManager transfers by outcome "
                          "(completed/failed/cancelled/deduped)", ("outcome",))
    queue_depth = Gauge("ray_tpu_pull_queue_depth",
                        "pulls waiting for an in-flight slot "
                        "(transfer_max_inflight_pulls)")
    inflight = Gauge("ray_tpu_pull_inflight",
                     "pulls currently streaming chunks")
    last = {"bytes_in": 0, "bytes_out": 0, "chunks_in": 0, "chunks_out": 0,
            "pulls_completed": 0, "pulls_failed": 0, "pulls_cancelled": 0,
            "pulls_deduped": 0}

    def collect():
        # Snapshot once; diff and advance the cursor from the snapshot (see
        # the batching collector for why).
        s = dict(object_transfer._STATS)
        for key, metric, tag in (
            ("bytes_in", bytes_total, {"direction": "in"}),
            ("bytes_out", bytes_total, {"direction": "out"}),
            ("chunks_in", chunks_total, {"direction": "in"}),
            ("chunks_out", chunks_total, {"direction": "out"}),
            ("pulls_completed", pulls_total, {"outcome": "completed"}),
            ("pulls_failed", pulls_total, {"outcome": "failed"}),
            ("pulls_cancelled", pulls_total, {"outcome": "cancelled"}),
            ("pulls_deduped", pulls_total, {"outcome": "deduped"}),
        ):
            d = s[key] - last[key]
            if d:
                metric.inc(d, tag)
            last[key] = s[key]
        queue_depth.set(float(s["queue_depth"]))
        inflight.set(float(s["inflight"]))

    register_collector(collect)


# ---------------------------------------------------------------- collectives
_collective_hist = None


def collective_histogram():
    """Lazy per-op wall-time histogram (tags: op, group, rank, status).
    `rank` names which gang member observed the time; `status` is "ok" or
    "error" — a collective that raises records a sample too (a hung/failed
    collective must not be invisible)."""
    global _collective_hist
    if _collective_hist is None:
        from ray_tpu_torch.util.metrics import Histogram

        _collective_hist = Histogram(
            "ray_tpu_collective_op_seconds",
            "collective op wall time", boundaries=_LATENCY_BUCKETS,
            tag_keys=("op", "group", "rank", "status"),
        )
    return _collective_hist


_rendezvous_hist = None


def rendezvous_wait_histogram():
    """Lazy rendezvous-wait histogram: how long a rank blocked in
    rendezvous.wait_for before the key appeared (count = number of waits,
    sum = wait-seconds — the gang-formation stall signal the goodput
    ledger's rendezvous_wait bucket reads)."""
    global _rendezvous_hist
    if _rendezvous_hist is None:
        from ray_tpu_torch.util.metrics import Histogram

        _rendezvous_hist = Histogram(
            "ray_tpu_collective_rendezvous_wait_seconds",
            "time blocked waiting on a collective rendezvous key",
            boundaries=_LATENCY_BUCKETS,
        )
    return _rendezvous_hist


# ------------------------------------------------------------------ training
_train_metrics: Optional[dict] = None


def train_metrics() -> dict:
    """Lazy training-gang metric set. The per-step phase histogram is
    observed by each worker's _TrainSession step clock (tags: phase, gang,
    rank); the skew gauge is set by the driver-side BackendExecutor per
    result round (tag: gang) and is what the `train_straggler` alert rule
    watches."""
    global _train_metrics
    if _train_metrics is None:
        from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

        _train_metrics = {
            "resize_total": Counter(
                "ray_tpu_train_resize_total",
                "elastic gang membership changes (resize-in-place), "
                "incremented by the driver per re-formation",
                ("gang", "direction"),
            ),
            "step_seconds": Histogram(
                "ray_tpu_train_step_seconds",
                "training-step phase wall time per rank "
                "(data_wait/compile/step_exec/collective/report/checkpoint)",
                boundaries=_LATENCY_BUCKETS,
                tag_keys=("phase", "gang", "rank"),
            ),
            "step_skew": Gauge(
                "ray_tpu_train_step_skew_seconds",
                "per-round step-time skew across a training gang "
                "(slowest rank minus fastest rank)",
                ("gang",),
            ),
        }
    return _train_metrics


# --------------------------------------------------------------- serve router
_router_metrics: Optional[dict] = None


def router_metrics() -> dict:
    """Lazy Serve-router metric set (tags: deployment)."""
    global _router_metrics
    if _router_metrics is None:
        from ray_tpu_torch.util.metrics import Counter, Gauge, Histogram

        _router_metrics = {
            "requests": Counter("ray_tpu_serve_router_requests_total",
                                "requests routed to replicas", ("deployment",)),
            "route_wait": Histogram("ray_tpu_serve_router_route_wait_s",
                                    "time spent picking a replica and submitting",
                                    boundaries=_LATENCY_BUCKETS,
                                    tag_keys=("deployment",)),
            "saturation": Gauge("ray_tpu_serve_replica_saturation",
                                "in-flight requests / total replica concurrency capacity",
                                ("deployment",)),
            "inflight": Gauge("ray_tpu_serve_router_inflight",
                              "requests in flight through this router",
                              ("deployment",)),
            "resubmits": Counter("ray_tpu_serve_resubmit_total",
                                 "requests resubmitted to another replica "
                                 "after a replica death", ("deployment",)),
            "slo_p95": Gauge("ray_tpu_serve_route_wait_p95_s",
                             "windowed route-wait p95 this router reports to "
                             "the controller (the SLO autoscaling signal)",
                             ("deployment",)),
        }
    return _router_metrics


# ---------------------------------------------------------- serve ingress tier
_ingress_metrics: Optional[dict] = None


def serve_ingress_metrics() -> dict:
    """Lazy Serve front-door metric set. ONE shared object set per process:
    the proxy (app_queue/draining sheds) and the router (replica_inflight
    sheds) both count into the same ray_tpu_serve_shed_total series."""
    global _ingress_metrics
    if _ingress_metrics is None:
        from ray_tpu_torch.util.metrics import Counter, Gauge

        _ingress_metrics = {
            "shed": Counter("ray_tpu_serve_shed_total",
                            "requests shed by admission control, by app and "
                            "reason (app_queue/replica_inflight/batch_queue/"
                            "draining)", ("app", "reason")),
            "proxy_requests": Counter("ray_tpu_serve_proxy_requests_total",
                                      "HTTP requests admitted by this proxy",
                                      ("app",)),
            "proxy_queue_depth": Gauge("ray_tpu_serve_proxy_queue_depth",
                                       "admitted-but-unfinished requests at "
                                       "this proxy (per-app admission gauge)",
                                       ("app",)),
        }
    return _ingress_metrics
