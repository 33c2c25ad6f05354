"""Central typed configuration, the analogue of the reference's RAY_CONFIG system
(`src/ray/common/ray_config_def.h` — 195 `RAY_CONFIG(type, name, default)`
entries, each overridable by a `RAY_<name>` env var or a `_system_config` dict at init).

Here every entry is a dataclass field; overrides come from `RAY_TPU_TORCH_<NAME>` env vars or
the `_system_config` dict passed to `ray_tpu_torch.init`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import typing
from typing import Any, Optional


# Environment keys the runtime honors BESIDE the `RAY_TPU_TORCH_<Config field>`
# override form. Machine-readable on purpose: the rt-lint config pass
# (ray_tpu.devtools) checks every RAY_TPU_TORCH_* environ access in the tree
# against Config's fields plus this registry, so a typo'd or undeclared env
# knob fails lint. Add the key here (with its one-line doc) when introducing
# one.
ENV_VARS = {
    "RAY_TPU_TORCH_ADDRESS": "head TCP address exported to tasks' subprocesses / CLI",
    "RAY_TPU_TORCH_AUTHKEY_HEX": "cluster auth key, inherited by workers/daemons",
    "RAY_TPU_TORCH_CONTAINER_BINARY": "explicit podman/docker binary for container envs",
    "RAY_TPU_TORCH_DAEMON_RECONNECT_S": "node-daemon head-rejoin grace (0 disables)",
    "RAY_TPU_TORCH_DEBUG_INVARIANTS": "1 = runtime thread-affinity/lock guard asserts",
    "RAY_TPU_TORCH_FAILPOINTS": "armed fault-injection schedule (name=kind[:arg][@trigger];...)",
    "RAY_TPU_TORCH_FAKE_MEMORY_USAGE_FILE": "test hook: fake /proc memory sampling",
    "RAY_TPU_TORCH_IN_CONTAINER": "marker set inside containerized workers",
    "RAY_TPU_TORCH_JOB_ID": "job id a driver attributes its tasks to",
    "RAY_TPU_TORCH_LOG_TO_DRIVER": "worker-side marker for stdout/stderr shipping",
    "RAY_TPU_TORCH_RESULTS_DIR": "root dir for train/tune results",
    "RAY_TPU_TORCH_RUNTIME_ENV_CACHE": "cache dir for provisioned runtime envs",
    "RAY_TPU_TORCH_RUNTIME_ENV_PLUGINS": "extra runtime_env plugin entry points",
    "RAY_TPU_TORCH_TRACING": "1 = enable util/tracing span collection",
    "RAY_TPU_TORCH_USAGE_STATS_ENABLED": "0 disables the usage-stats stamp",
    "RAY_TPU_TORCH_WORKER_PROFILE": "debug: cProfile worker dispatch loops, dump to this dir",
    "RAY_TPU_TORCH_WORKFLOW_ROOT": "workflow storage root directory",
}


def _coerce(value: str, typ: type) -> Any:
    if typ is bool:
        return value.lower() in ("1", "true", "yes", "on")
    if typ in (dict, list):
        return json.loads(value)
    return typ(value)


@dataclasses.dataclass
class Config:
    # --- object store ---
    # Objects whose serialized size is below this are stored inline in the owner's
    # in-process memory store (reference: `memory_store.h`); larger ones go to the
    # shared-memory store (reference: plasma, `object_manager/plasma/store.cc`).
    max_direct_call_object_size: int = 100 * 1024
    # Cap on the total bytes of shared-memory objects per node before puts raise
    # ObjectStoreFullError (plasma's footprint limit).
    object_store_memory: int = 2 * 1024 * 1024 * 1024
    # Ceiling on one inter-node object pull (relay through the head).
    object_pull_timeout_s: float = 300.0
    # Store large objects in the node's native C++ shm arena (ray_tpu_torch/_native/
    # shm_arena.cpp — one mapping, offset allocations, no per-object file
    # create/unlink) instead of one file per object. Falls back to files
    # automatically when no toolchain / arena full. None = auto: arena only
    # where reads can export zero-copy pinned buffers (PEP-688, py3.12+) —
    # older interpreters must COPY every arena read (freed blocks recycle,
    # unlike unlinked file mmaps), which turns ~138 GB/s same-node 10MB gets
    # into ~10 GB/s. True forces the arena on regardless (tests).
    use_native_object_arena: Optional[bool] = None
    # Native arena size per node; 0 = same as object_store_memory. Objects
    # that don't fit the arena overflow to per-object file segments.
    object_arena_bytes: int = 0
    # Framed wire codec for control-plane messages (_private/wire.py +
    # _native/wire_native.c): specialized pack/unpack for the fixed-shape
    # hot tags (submit/exec/done/batch/ref ops) instead of pickling every
    # frame. None = auto: send wire frames iff the C extension builds/loads
    # on this host (the arena knob's pattern). True forces the format
    # (pure-Python codec without a toolchain); False sends pickle only.
    # Receivers accept BOTH formats regardless (magic-byte dispatch).
    use_native_protocol: Optional[bool] = None
    # Hard ceiling on one framed wire message (decode side, both codecs).
    # Control frames are small (batches cap at control_plane_batch_max_bytes;
    # large object bytes ride the data plane as RAW chunk frames, never the
    # codec), so a frame claiming more than this is malformed or hostile and
    # is rejected with a typed WireDecodeError BEFORE any length field is
    # trusted into an allocation. Interior length/count fields are further
    # validated against the actual remaining bytes of the frame.
    wire_max_frame_bytes: int = 256 * 1024 * 1024
    # When a put would exceed object_store_memory, relocate the just-written
    # (not yet visible) object to the disk spill directory instead of raising —
    # the analogue of plasma's fallback allocations to /tmp
    # (`object_manager/plasma/plasma_allocator.cc` fallback path). Disable to
    # get hard ObjectStoreFullError behavior.
    object_spilling: bool = True
    # Disk directory for spilled objects; "" = <tmpdir>/<session>_spill.
    object_spill_dir: str = ""
    # Testing hook: treat every segment sealed on another node as remote even if
    # its path happens to be readable (single-machine multi-daemon clusters share
    # a filesystem), so the inter-node pull path is exercised.
    force_object_pulls: bool = False
    # Fail cross-node pulls that would relay through the head instead of the
    # peer-direct daemon data plane (testing/ops guard for the head NIC).
    disable_pull_relay: bool = False

    # --- peer-to-peer data plane (object_transfer.py) ---
    # Cross-node object bytes stream node->node over dedicated data
    # connections (PullManager/PushManager); the head answers location
    # queries only. False falls back to relaying every byte through the head
    # (the pre-data-plane behavior; also the bench baseline).
    enable_peer_transfer: bool = True
    # Chunk size for peer transfers: each transfer_chunk frame carries this
    # many bytes, sliced straight out of the segment/arena file.
    transfer_chunk_bytes: int = 1 * 1024 * 1024
    # Bound on concurrently-executing pulls per reader process; further
    # pulls queue in priority order (task-args > explicit get > prefetch).
    transfer_max_inflight_pulls: int = 4
    # Pusher-side backpressure: at most this many unacked chunks in flight
    # per transfer (bounds socket backlog and the puller's reorder buffer).
    transfer_window_chunks: int = 8

    # --- scheduling ---
    # Hybrid policy threshold: pack onto the best node until its utilization
    # exceeds this, then spread (reference: `hybrid_scheduling_policy.cc`).
    scheduler_spread_threshold: float = 0.5
    # Locality-aware placement: argument objects at least this large pull a
    # task toward the node holding them (reference: LocalityAwareLeasePolicy,
    # `lease_policy.h:56`).
    scheduler_locality_min_bytes: int = 100_000
    # Max stateless workers started per node beyond num_cpus (oversubscription to
    # break ray.get deadlocks, reference worker_pool prestart behaviour).
    maximum_startup_concurrency: int = 4
    # Memory monitor (reference: memory_monitor.h + worker_killing_policy.h):
    # kill a worker by policy when host/cgroup usage crosses the threshold.
    # refresh_ms = 0 disables monitoring.
    memory_usage_threshold: float = 0.95
    memory_monitor_refresh_ms: int = 500
    # "retriable_fifo" | "retriable_lifo" | "group_by_owner"
    worker_killing_policy: str = "retriable_fifo"
    # Delay before re-queuing an OOM-killed retriable task (reference:
    # task_oom_retry_delay_ms) — immediate redispatch under sustained
    # pressure would burn every retry in under a second.
    task_oom_retry_delay_ms: int = 1000
    # Burst coalescing for fire-and-forget scheduler commands (submits,
    # inline put registrations): while they stream in faster than ~3k/s and
    # NO blocking command is waiting, the scheduler loop stays parked for up
    # to this budget so the submitting thread keeps the core — processing
    # mid-burst would steal exactly the CPU the burst is timed on (one-core
    # hosts timeshare the driver, the loop, and the workers). Any blocking
    # call (get/wait/kv/...) cancels the deferral immediately, so sync
    # round-trip latency is unaffected; a pure fire-and-forget stream sees
    # dispatch start at most this many ms after its first submit. 0 = off.
    scheduler_burst_coalesce_ms: float = 50.0
    # Max tasks in flight per leased stateless worker (1 = no pipelining).
    # When a dispatch class saturates the node, further same-class tasks
    # queue directly on the class's busy workers — the reference's
    # lease-based pipelined submission (`direct_task_transport.h:75`).
    # 16 pairs with control-plane micro-batching: a worker's completion
    # batch covers its whole in-flight window, so deeper pipelines mean
    # fewer scheduler round trips per task.
    worker_pipeline_depth: int = 16

    # --- control-plane micro-batching (batching.py) ---
    # Coalesce small control-plane messages (task submissions, actor-call
    # ExecRequests, put_meta registrations, completions, stream items, ref
    # ops) into one ("batch", [msgs]) frame per connection, flushed on a
    # count/byte threshold or a sub-millisecond timer. Blocking ops (get/
    # wait/any request) always flush first, so sync latency never waits on
    # the timer. False restores one frame per message with identical
    # observable semantics.
    control_plane_batching: bool = True
    # Flush a connection's buffer once it holds this many messages...
    control_plane_batch_max_msgs: int = 128
    # ...or once its (approximate) serialized payload reaches this many bytes.
    control_plane_batch_max_bytes: int = 1 * 1024 * 1024
    # Client-side coalescing window + safety-net timer: messages arriving
    # closer together than this batch; a buffered message never waits longer
    # than ~this before hitting the wire. Must sit BELOW the sync-roundtrip
    # period (~0.4ms on small hosts) so request/response traffic takes the
    # immediate-send path and never pays a timer wakeup. (The scheduler side
    # flushes every event-loop iteration instead and ignores this knob.)
    control_plane_batch_flush_interval_s: float = 0.0002

    # --- fault tolerance ---
    task_max_retries: int = 3
    # Default restart budget for actors created without an explicit
    # max_restarts option (-1 = infinite, like the per-actor option).
    actor_max_restarts: int = 0
    # Heartbeat/health-check channel (reference: health_check_* in
    # ray_config_def.h): node daemons and workers beat every period over
    # their control connections; a peer silent for TWO periods (at least one
    # genuinely missed beat — one period would flap on delivery jitter) is
    # marked SUSPECT, for period * threshold it is declared DEAD. Daemons: the node
    # is removed (tasks fail over; a SIGSTOP'd/hung daemon is detected, not
    # just a closed socket — it rejoins as a fresh node when it wakes).
    # Workers: SUSPECT is surfaced for observability only; process liveness
    # and connection EOF stay the kill signals (a GIL-bound compile must not
    # get its worker shot). 0 disables the channel.
    health_check_period_ms: int = 1000
    health_check_failure_threshold: int = 5
    # Unified retry/backoff policy (_private/retry.py): exponential backoff
    # with deterministic jitter + deadline budget, adopted by object
    # reconstruct, Serve resubmit, daemon rejoin, and collective rendezvous.
    retry_backoff_base_ms: int = 50
    retry_backoff_max_ms: int = 2000
    # Attempt budget for the lost-segment path: reconstruct-from-lineage
    # retries before a typed ObjectLostError surfaces at the API boundary.
    object_reconstruct_attempts: int = 3
    # Bounded dead-replica resubmits per Serve request (was hard-coded 1).
    serve_resubmit_attempts: int = 2

    # --- Serve ingress tier (admission control / shedding / drain / SLO) ---
    # Per-app admitted-but-unfinished request cap at EACH HTTP proxy; above
    # it the proxy sheds with a fast `503 + Retry-After` instead of queueing
    # toward collapse (reference: max_queued_requests on the proxy router).
    # A deployment's `max_queued_requests` option overrides per app; 0 here
    # disables proxy admission control entirely.
    serve_queue_cap_default: int = 256
    # Router-side overload guard: when EVERY live replica's in-flight load
    # reaches max_concurrent_queries * this factor, route() sheds instead of
    # queueing deeper (reason="replica_inflight"). 0 disables (default: the
    # handle API keeps its unbounded-queue semantics; HTTP ingress is capped
    # by the proxy's per-app admission control above).
    serve_replica_inflight_cap_factor: float = 0.0
    # Bounded per-proxy forwarding pipeline: at most this many requests per
    # proxy hop to replicas concurrently (the ASGI-worker / envoy
    # max_concurrent analogue). Requests over the bound wait as parked
    # coroutines (cheap) until a slot frees — the per-app queue cap above
    # sheds the true excess. Keeps the proxy event loop responsive under
    # saturation (sheds stay FAST) and makes single-proxy capacity a
    # per-proxy resource, so adding proxies adds ingress throughput.
    # 0 = auto: 4 x cpu count, floor 4.
    serve_proxy_max_concurrent: int = 0
    # Retry-After seconds returned with shed 503s (clients use it to back
    # off; the bench's open-loop generator ignores it on purpose).
    serve_retry_after_s: float = 1.0
    # Graceful-drain ceiling: a stopping replica/proxy gets this long to
    # finish its in-flight window after the routing table stops sending it
    # new work; whatever still runs at the deadline is killed with the actor.
    serve_drain_timeout_s: float = 30.0
    # Sliding window over which routers compute the route-wait p95 they
    # report to the controller (the SLO-aware autoscaling signal).
    serve_slo_window_s: float = 30.0

    # --- distributed tracing (util/tracing.py; reference: tracing_helper.py) ---
    # Head-sampling rate for ROOT spans minted while tracing rides the
    # RAY_TPU_TORCH_TRACING env knob (the always-on mode): each new trace keeps or
    # drops ALL its spans at the root, so sampled traces stay connected and
    # unsampled ones cost one RNG draw. Programmatic tracing.enable() defaults
    # to full fidelity (rate 1.0) unless told otherwise — debug mode records
    # everything.
    trace_sample_rate: float = 0.1
    # Deterministic sampling: a non-zero seed makes every process's
    # keep/drop sequence replayable (seeded RNG per process, same order of
    # root spans -> same decisions). 0 = seed from urandom.
    trace_sample_seed: int = 0
    # Tail-keep: a span created with tail-keep eligibility (Serve request
    # roots, object-transfer pulls) whose wall time reaches this threshold
    # is flushed even when its trace lost the head-sampling draw (marked
    # keep="tail"), so the SLOW outliers survive any sample rate. 0 disables.
    trace_keep_latency_s: float = 1.0
    # Bound on the head-side trace-span ring AND each process's local span
    # buffer: a process that can't flush (enable-before-init) drops the
    # overflow (counted in ray_tpu_trace_spans_dropped_total) instead of
    # growing without bound.
    trace_spans_cap: int = 20000

    # --- task events / tracing (reference: task_event_buffer.h, gcs_task_manager.h) ---
    # Ring-buffer capacity of the GCS task-event store; oldest events drop
    # first. Doubles as state.summarize()'s listing budget (its task/object
    # counts scan at most this many records per call) — the knob is the
    # observability-retention budget, so shrinking it shrinks both.
    task_events_max_num_task_in_gcs: int = 100000
    # Per-stage task lifecycle events (submit -> queued -> lease_granted ->
    # args_fetched -> exec_start -> exec_end -> result_stored) and the
    # ray_tpu_torch.timeline() chrome trace built from them. Worker-side stages
    # ride back on the existing done/batch messages (no extra round trips).
    enable_timeline: bool = True

    # --- live introspection (introspection.py / profiler.py / util/state) ---
    # Cluster-wide sampling profiler (state.profile(duration_s)): per-process
    # background samplers over sys._current_frames(), folded-stack output.
    # False disables the whole surface — state.profile errors, the scheduler
    # never broadcasts profile_start/stop, and no process ever starts a
    # sampler thread (zero overhead, same contract as failpoints).
    enable_profiler: bool = True
    # Default sampling rate for state.profile (overridable per call).
    profiler_hz: int = 99
    # How long a cluster stack-dump / profile-collect fan-out waits for every
    # peer before falling back (stacks: SIGUSR1 faulthandler out-of-band
    # dump; both: "unavailable: <reason>" entries for silent peers).
    introspection_timeout_s: float = 5.0

    # --- internal runtime metrics (util/metrics.py registry) ---
    # Instrument the scheduler loop (queue depth, dispatch wait, lease
    # occupancy), control-plane batching (flush sizes, coalesce ratio,
    # straggler fires), the object store (bytes/objects/spills, hit rate),
    # collectives (per-op wall time), and the Serve router (queue wait,
    # saturation). Recorded off the hot path: hot paths bump plain ints;
    # gauges/histograms materialize once per scheduler-loop tick / registry
    # flush. False skips all instrumentation (knob-off parity).
    enable_metrics: bool = True
    # Scheduler-side gauge refresh floor: the loop snapshots its telemetry at
    # most this often even when iterating per-message under load.
    internal_metrics_interval_s: float = 0.25

    # --- watch-it-over-time layer (_private/timeseries.py, gated by
    # enable_metrics: knob off = no store, no alert evaluation, no cluster
    # events, zero extra protocol traffic) ---
    # Sub-knob under enable_metrics: keep instantaneous metrics but drop the
    # history/alerting layer (no ObsState, no event recording). Effective
    # only while enable_metrics is on; also the bench seam that prices THIS
    # layer alone (task_throughput_obs_ratio) instead of re-pricing the
    # whole metrics pipeline.
    enable_obs: bool = True
    # Minimum spacing between stored samples per series. Samples arriving
    # faster (per-process registries flush at ~1 Hz each) merge into the
    # newest stored point instead of appending.
    obs_series_step_s: float = 1.0
    # How far back the head keeps samples; the per-series ring holds
    # retention/step points and evicts the oldest beyond that.
    obs_series_retention_s: float = 600.0
    # Label-set cap: total distinct (name, tags, pid) series the store will
    # track. New series beyond the cap are dropped (and counted) instead of
    # growing head memory without bound.
    obs_max_series: int = 4000
    # Bounded cluster-event ring in the GCS (persisted with --persist, so the
    # event history survives a head restart).
    cluster_event_cap: int = 10000
    # Alert-rule evaluation cadence on the scheduler loop (the flush-cadence
    # analogue; rules see samples ingested from the per-process KV flushes).
    alert_eval_interval_s: float = 1.0

    # --- per-job accounting (_private/jobs.py, sub-layer of enable_obs:
    # the ledger exists exactly when sched.obs does) ---
    # Queue-wait p95 above which a job counts as starved. Drives the
    # `job_starved` alert rule on ray_tpu_job_queue_wait_seconds via
    # threshold_config_frac (same pattern as train_straggler_skew_s).
    job_starved_wait_s: float = 2.0
    # Bounded ring of finalized job ledgers (dead drivers); persisted in the
    # GCS snapshot so `state.list_jobs()` history survives a head restart.
    finished_jobs_cap: int = 256

    # --- collective ---
    # Rendezvous wait ceiling for collective group formation (KV-based
    # barrier in util/collective/rendezvous.py).
    collective_timeout_s: float = 120.0

    # --- training-gang observability (train/_internal, gated by
    # enable_metrics like everything else) ---
    # Per-round step-time skew (slowest rank minus fastest rank) above which
    # a gang is considered to have a straggler. Drives both the driver-side
    # `train_straggler` cluster event and, via threshold_config_frac, the
    # `train_straggler` alert rule on ray_tpu_train_step_skew_seconds.
    train_straggler_skew_s: float = 1.0
    # How long the skew must stay above the threshold before the driver
    # emits the train_straggler event (hysteresis mirror of the alert
    # rule's for_s, evaluated per result round on the BackendExecutor).
    train_straggler_for_s: float = 2.0

    # --- elastic gang training (ScalingConfig.elastic) ---
    # Step-boundary drain budget per surviving rank at resize: a rank that
    # cannot reach its next report within this window (collective hang,
    # multi-minute step) is treated as dead and replaced.
    elastic_drain_timeout_s: float = 10.0
    # Liveness probe timeout when re-forming membership after a loss.
    elastic_probe_timeout_s: float = 5.0
    # How long a shrunken gang waits before trying to re-expand toward
    # ScalingConfig.num_workers: preempted capacity rarely returns instantly,
    # and eager re-expansion right after a kill would thrash the gang.
    elastic_grow_after_s: float = 30.0

    # --- worker process ---
    # Stream worker stdout/stderr to subscribed drivers (init(log_to_driver=)).
    log_to_driver: bool = True

    def apply_overrides(self, system_config: dict | None = None) -> "Config":
        # PEP 563 (future annotations) makes every f.type a STRING, so env
        # coercion must resolve the real annotation — the type of the default
        # value is wrong for tri-state fields (type(None) isn't callable).
        hints = typing.get_type_hints(type(self))
        for f in dataclasses.fields(self):
            env_key = f"RAY_TPU_TORCH_{f.name}"
            if env_key not in os.environ:
                continue
            typ = hints.get(f.name, str)
            optional = typing.get_origin(typ) is typing.Union
            if optional:
                args = [a for a in typing.get_args(typ) if a is not type(None)]
                typ = args[0] if args else str
            raw = os.environ[env_key]
            if optional and raw.lower() in ("", "none", "auto"):
                setattr(self, f.name, None)
            else:
                setattr(self, f.name, _coerce(raw, typ))
        if system_config:
            for k, v in system_config.items():
                if not hasattr(self, k):
                    raise ValueError(f"Unknown system config key: {k}")
                setattr(self, k, v)
        return self


_global_config: Config | None = None


def get_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config().apply_overrides()
    return _global_config


def set_config(cfg: Config) -> None:
    global _global_config
    _global_config = cfg
    # The wire codec caches its send-knob resolution; a new config (init,
    # worker startup, client connect) must re-resolve it.
    from ray_tpu_torch._private import wire

    wire.refresh()
